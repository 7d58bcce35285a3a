"""CalciumGAN (1-D WaveGAN-style) generator and discriminator.

Architecture parity with the paper model (reference
``gan/models/calciumgan.py``):

Generator (``calciumgan.py:22-103``):
  noise (noise_dim,) -> Dense(w0*noise_dim) -> act -> reshape (w0, noise_dim)
  -> 5 x [ConvTranspose1D(filters, kernel, stride, SAME) -> norm -> act]
     with filters [5u, 4u, 3u, 2u, C]
  -> Dense(C) -> sigmoid (normalised data) else linear, output float32.

Discriminator (``calciumgan.py:141-192``):
  5 x [Conv1D(filters [u, 2u, 3u, 4u, 5u], kernel, stride, SAME) -> act
       -> PhaseShuffle(m) (layers 1-4 only)]
  -> Flatten -> Dense(1), output float32.

Native 1-D ConvTranspose (no 2-D emulation), bf16 compute dtype under
mixed precision, phase shuffle from an explicit 'phase' RNG stream.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from calciumgan.models import base
from calciumgan.models.registry import register
from calciumgan.ops.phase_shuffle import phase_shuffle


@dataclasses.dataclass(frozen=True)
class Generator(base.Module):
    sequence_length: int
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

        x = base.dense(scope.child("Dense_0"), z, w0 * self.noise_dim,
                       self.dtype)
        x = act(x)
        x = x.reshape((x.shape[0], w0, self.noise_dim))

        filters = [self.num_units * k for k in (5, 4, 3, 2)]
        filters.append(self.num_channels)
        for i, f in enumerate(filters):
            x = base.conv_transpose(scope.child(f"ConvTranspose_{i}"), x, f,
                                    (self.kernel_size,), (self.strides,),
                                    self.dtype)
            x = base.norm(scope.child(f"Norm_{i}"), x, training,
                          self.batch_norm, self.layer_norm, self.dtype)
            x = act(x)

        x = base.dense(scope.child("Dense_1"), x, self.num_channels,
                       self.dtype)
        x = x.astype(jnp.float32)
        return jax.nn.sigmoid(x) if self.normalize else x


@dataclasses.dataclass(frozen=True)
class Discriminator(base.Module):
    num_units: int = 32
    kernel_size: int = 24
    strides: int = 2
    m: int = 2
    activation: str = "leakyrelu"
    dtype: base.Dtype = jnp.float32

    def forward(self, scope: base.Scope, x, training: bool = True):
        act = base.activation(self.activation)
        for i, k in enumerate((1, 2, 3, 4, 5)):
            x = base.conv(scope.child(f"Conv_{i}"), x, self.num_units * k,
                          (self.kernel_size,), (self.strides,), self.dtype)
            x = act(x)
            if i < 4 and self.m > 0:
                # no fallback: a caller that forgets the 'phase' rng must
                # get the missing-RNG error, not a silently shuffle-free
                # discriminator
                x = phase_shuffle(x, scope.make_rng("phase"), self.m, axis=1)
        x = x.reshape((x.shape[0], -1))
        x = base.dense(scope.child("Dense_0"), x, 1, self.dtype)
        return x.astype(jnp.float32)


@register("calciumgan")
def build(config):
    dtype = jnp.bfloat16 if config.mixed_precision else jnp.float32
    gen = Generator(
        sequence_length=config.signal_shape[0],
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
    dis = Discriminator(
        num_units=config.num_units,
        kernel_size=config.kernel_size,
        strides=config.strides,
        m=config.m,
        activation=config.activation,
        dtype=dtype)
    return gen, dis
