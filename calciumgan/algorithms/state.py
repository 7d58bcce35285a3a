"""Train-state pytrees.

The reference keeps training state implicitly inside Keras objects (model
variables + optimizer slots, checkpointed as weight pickles —
``gan/utils/utils.py:116-152``). Here the FULL state is one explicit pytree:
parameters, BatchNorm running stats, optax optimizer state and step counters
for both networks — so a train step is ``state, logs = step(state, batch,
rng)`` and checkpoint/restore is just (de)serialising the pytree.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp


class _Replace:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NetState(_Replace):
    params: Any
    batch_stats: Any          # {} when the net has no BatchNorm
    opt_state: Any
    step: jnp.ndarray         # optimizer iteration counter

    def variables(self) -> dict:
        v = {"params": self.params}
        if self.batch_stats:
            v["batch_stats"] = self.batch_stats
        return v


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GANState(_Replace):
    generator: NetState
    discriminator: NetState
    # exponential moving average of the generator params (``--ema``);
    # None when disabled, so the pytree structure (and every checkpoint
    # written before the feature existed) is unchanged unless opted in
    ema_params: Any = None


def make_net_state(variables: dict, tx) -> NetState:
    params = variables["params"]
    return NetState(
        params=params,
        batch_stats=variables.get("batch_stats", {}),
        opt_state=tx.init(params),
        step=jnp.zeros((), jnp.int32))
