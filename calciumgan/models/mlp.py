"""MLP generator/discriminator (reference ``gan/models/mlp.py``).

Generator (``mlp.py:15-47``): Dense(seq*noise_dim) -> act -> reshape
(seq, noise_dim) -> 3 x [Dense(u*{1,2,3}) -> act -> dropout] -> Dense(C)
-> sigmoid/linear float32.

Discriminator (``mlp.py:50-77``): 4 x [Dense(u*{4,3,2,1}) -> act -> dropout]
-> Flatten -> Dense(1) float32. Dropout uses the 'dropout' RNG stream and
is disabled when not training.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from calciumgan.models import base
from calciumgan.models.registry import register


@dataclasses.dataclass(frozen=True)
class GeneratorMLP(base.Module):
    sequence_length: int
    num_channels: int
    noise_dim: int = 32
    num_units: int = 32
    dropout: float = 0.2
    activation: str = "leakyrelu"
    normalize: bool = True
    dtype: base.Dtype = jnp.float32

    def forward(self, scope: base.Scope, z, training: bool = True):
        act = base.activation(self.activation)
        x = base.dense(scope.child("Dense_0"), z,
                       self.sequence_length * self.noise_dim, self.dtype)
        x = act(x)
        x = x.reshape((x.shape[0], self.sequence_length, self.noise_dim))
        for i, k in enumerate((1, 2, 3), start=1):
            x = base.dense(scope.child(f"Dense_{i}"), x, self.num_units * k,
                           self.dtype)
            x = act(x)
            x = base.dropout(scope, x, self.dropout, training)
        x = base.dense(scope.child("Dense_4"), x, self.num_channels,
                       self.dtype)
        x = x.astype(jnp.float32)
        return jax.nn.sigmoid(x) if self.normalize else x


@dataclasses.dataclass(frozen=True)
class DiscriminatorMLP(base.Module):
    num_units: int = 32
    dropout: float = 0.2
    activation: str = "leakyrelu"
    dtype: base.Dtype = jnp.float32

    def forward(self, scope: base.Scope, x, training: bool = True):
        act = base.activation(self.activation)
        for i, k in enumerate((4, 3, 2, 1)):
            x = base.dense(scope.child(f"Dense_{i}"), x, self.num_units * k,
                           self.dtype)
            x = act(x)
            x = base.dropout(scope, x, self.dropout, training)
        x = x.reshape((x.shape[0], -1))
        x = base.dense(scope.child("Dense_4"), x, 1, self.dtype)
        return x.astype(jnp.float32)


@register("mlp")
def build(config):
    dtype = jnp.bfloat16 if config.mixed_precision else jnp.float32
    gen = GeneratorMLP(
        sequence_length=config.signal_shape[0],
        num_channels=config.num_channels,
        noise_dim=config.noise_dim,
        num_units=config.num_units,
        dropout=config.dropout,
        activation=config.activation,
        normalize=config.normalize,
        dtype=dtype)
    dis = DiscriminatorMLP(
        num_units=config.num_units,
        dropout=config.dropout,
        activation=config.activation,
        dtype=dtype)
    return gen, dis
