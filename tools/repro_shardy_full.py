"""Repro: Shardy miscompiles the model-parallel WGAN-GP train step.

Runs the repo's real step (tiny config, model_parallelism=2) jitted
directly — bypassing ``parallel/mesh.py``'s scoped GSPMD fallback — once
under classic GSPMD and once under Shardy, at ``learning_rate=0`` so every
optimizer update is a value-no-op and ALL logged losses must agree bitwise
between partitioners.

Observed with jax 0.9.0: ``loss/gradient_penalty`` and the signal metrics
match, but the Wasserstein means inflate by exactly the data-axis size (4)
under Shardy. Bisect (2026-08, round 3):

- ``eval_step`` is clean under Shardy; so are the critic loss + GP + grad,
  the generator grad, and each forward in isolation.
- The scan vs unrolled critic, buffer donation, the generator, and phase
  shuffle are all irrelevant.
- The minimal trigger inside repo code is {GP-bearing critic grad} +
  {optax update} + {a further forward through the updated model-sharded
  discriminator} compiled in ONE program: every batch mean downstream of
  the update comes out data_axis_size times too large.
- A distilled 60-line toy (conv + model-sharded head + GP + adam + post
  forward) partitions CORRECTLY — the full model stack is somehow load-
  bearing, so this script IS the minimal known repro.

While this prints MISMATCH, ``parallel/mesh.py:make_step_fns`` must keep
running model-parallel step functions under its thread-local GSPMD scope.
When it prints MATCH, the upstream bug is fixed and the scope can go.

    python tools/repro_shardy_full.py   # any machine, 8 virtual CPU devices
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from calciumgan.algorithms import get_algorithm  # noqa: E402
from calciumgan.config import Config  # noqa: E402
from calciumgan.models import get_models  # noqa: E402
from calciumgan.parallel import (batch_sharding, create_mesh,  # noqa: E402
                                     state_shardings)


def run(use_shardy: bool):
    jax.config.update("jax_use_shardy_partitioner", use_shardy)
    cfg = Config(
        model="calciumgan", algorithm="wgan-gp", sequence_length=64,
        num_neurons=6, num_channels=6, signal_shape=(64, 6), noise_dim=8,
        num_units=4, kernel_size=4, strides=2, m=2, batch_size=8,
        n_critic=1, normalize=True, layer_norm=True, signals_min=0.0,
        signals_max=1.0, model_parallelism=2,
        learning_rate=0.0)  # lr=0: updates are value-no-ops, losses must match
    gen, dis = get_models(cfg)
    algo = get_algorithm(cfg, gen, dis)
    state = algo.init_state(jax.random.PRNGKey(0))
    real = np.random.default_rng(0).random(
        (8,) + tuple(cfg.signal_shape)).astype(np.float32)

    mesh = create_mesh(data_parallelism=4, model_parallelism=2)
    ss = state_shardings(mesh, state)
    rep = NamedSharding(mesh, P())
    train = jax.jit(algo.train_step,
                    in_shardings=(ss, batch_sharding(mesh, 3), rep),
                    out_shardings=(ss, rep))
    state = jax.device_put(state, ss)
    sharded_real = jax.device_put(real, batch_sharding(mesh, 3))
    _, logs = train(state, sharded_real, jax.device_put(jax.random.PRNGKey(0)))
    return {k: float(np.asarray(v)) for k, v in logs.items()}


if __name__ == "__main__":
    gspmd = run(use_shardy=False)
    shardy = run(use_shardy=True)
    bad = []
    for k in gspmd:
        r = shardy[k] / gspmd[k] if gspmd[k] else float("nan")
        flag = "" if abs(r - 1.0) < 1e-3 else "   <-- MISMATCH"
        print(f"{k:32s} gspmd={gspmd[k]:+.6f} shardy={shardy[k]:+.6f} "
              f"ratio={r:.4f}{flag}")
        if abs(r - 1.0) >= 1e-3:
            bad.append(k)
    print("RESULT:", "MISMATCH in " + ", ".join(bad) if bad else
          "MATCH — Shardy is clean on this step now; the GSPMD scope in "
          "parallel/mesh.py can be removed")
