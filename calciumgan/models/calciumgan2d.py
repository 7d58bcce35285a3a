"""CalciumGAN-2D: treats (time, neuron) as an image plane.

Architecture parity with reference ``gan/models/calciumgan2d.py``:

Generator (``calciumgan2d.py:22-110``): noise reshaped to
(seq/strides^5, num_neurons//2, noise_dim); 5 x Conv2DTranspose with
square kernel (k, k), strides (s, 1) except layer 3 which uses (s, 2) to
double the neuron axis back to num_neurons; filters [5u, 3u, 2u, u, C]
(note: a different ladder than the 1-D model's [5u,4u,3u,2u,C] — preserved).

Discriminator (``calciumgan2d.py:156-213``): 5 x Conv2D kernel (16, 16)
strides (4, 1); 2-D phase shuffle (m temporal, n neuron) after layers 1-3;
layer 4 uses m=0 (only the neuron shift) — a reference quirk preserved
verbatim (``calciumgan2d.py:198``).

Used with ``--conv2d`` datasets where signals are (seq, neurons, 1|2).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from calciumgan.models import base
from calciumgan.models.registry import register
from calciumgan.ops.phase_shuffle import phase_shuffle_2d


@dataclasses.dataclass(frozen=True)
class Generator2D(base.Module):
    sequence_length: int
    num_neurons: int
    num_channels: int
    noise_dim: int = 32
    num_units: int = 32
    kernel_size: int = 24
    strides: int = 2
    activation: str = "leakyrelu"
    batch_norm: bool = False
    layer_norm: bool = False
    normalize: bool = True
    dtype: base.Dtype = jnp.float32

    def forward(self, scope: base.Scope, z, training: bool = True):
        act = base.activation(self.activation)
        w0 = base.noise_width(self.sequence_length, self.strides)
        c0 = self.num_neurons // 2
        k = (self.kernel_size, self.kernel_size)

        x = base.dense(scope.child("Dense_0"), z, w0 * c0 * self.noise_dim,
                       self.dtype)
        x = act(x)
        x = x.reshape((x.shape[0], w0, c0, self.noise_dim))

        filters = [self.num_units * 5, self.num_units * 3,
                   self.num_units * 2, self.num_units, self.num_channels]
        for i, f in enumerate(filters):
            strides = (self.strides, 2 if i == 2 else 1)
            x = base.conv_transpose(scope.child(f"ConvTranspose_{i}"), x, f,
                                    k, strides, self.dtype)
            x = base.norm(scope.child(f"Norm_{i}"), x, training,
                          self.batch_norm, self.layer_norm, self.dtype)
            x = act(x)

        x = base.dense(scope.child("Dense_1"), x, self.num_channels,
                       self.dtype)
        x = x.astype(jnp.float32)
        return jax.nn.sigmoid(x) if self.normalize else x


@dataclasses.dataclass(frozen=True)
class Discriminator2D(base.Module):
    num_units: int = 32
    m: int = 2
    n: int = 2
    activation: str = "leakyrelu"
    dtype: base.Dtype = jnp.float32

    def forward(self, scope: base.Scope, x, training: bool = True):
        act = base.activation(self.activation)
        for i, k in enumerate((1, 2, 3, 4, 5)):
            x = base.conv(scope.child(f"Conv_{i}"), x, self.num_units * k,
                          (16, 16), (4, 1), self.dtype)
            x = act(x)
            if i < 4:
                m = self.m if i < 3 else 0  # reference calciumgan2d.py:198
                # no fallback — see calciumgan.Discriminator
                if m > 0 or self.n > 0:
                    x = phase_shuffle_2d(x, scope.make_rng("phase"), m,
                                         self.n)
        x = x.reshape((x.shape[0], -1))
        x = base.dense(scope.child("Dense_0"), x, 1, self.dtype)
        return x.astype(jnp.float32)


@register("calciumgan2d")
def build(config):
    if config.signal_shape[1] % 2:
        # the generator seeds the neuron axis at num_neurons // 2 and
        # doubles it with a stride-2 layer — an odd count would silently
        # emit one neuron short and fail with an opaque concat shape error
        # deep inside the first train step
        raise ValueError(
            f"calciumgan2d requires an even neuron count, got "
            f"{config.signal_shape[1]}")
    dtype = jnp.bfloat16 if config.mixed_precision else jnp.float32
    gen = Generator2D(
        sequence_length=config.signal_shape[0],
        num_neurons=config.signal_shape[1],
        num_channels=config.num_channels,
        noise_dim=config.noise_dim,
        num_units=config.num_units,
        kernel_size=config.kernel_size,
        strides=config.strides,
        activation=config.activation,
        batch_norm=config.batch_norm,
        layer_norm=config.layer_norm,
        normalize=config.normalize,
        dtype=dtype)
    dis = Discriminator2D(
        num_units=config.num_units,
        m=config.m,
        n=config.n,
        activation=config.activation,
        dtype=dtype)
    return gen, dis
