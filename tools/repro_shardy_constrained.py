"""Experiment: can sharding constraints make Shardy compile the
model-parallel WGAN-GP step correctly?

``tools/repro_shardy_full.py`` pins the miscompile (batch means downstream
of the optax update inflate by the data-axis size under Shardy). This
variant re-runs the same A/B with the two mitigations the round-3 verdict
asked to try:

1. ``with_sharding_constraint`` on the critic scan carry — the
   discriminator NetState (params + Adam state) is pinned to its intended
   sharding on entry to every scan iteration and again after the optax
   update, so Shardy's propagation cannot drift through the loop-carried
   dependency;
2. the same constraint on the post-update generator NetState.

Run it to see whether a constrained formulation is Shardy-clean:

    python tools/repro_shardy_constrained.py   # 8 virtual CPU devices

Result with jax 0.9.0 (recorded 2026-08-18, round 4): the fully
constrained formulation **MATCHES** — Shardy compiles it correctly.
Ablation (``--variant``):

- ``entry``  — pin only the carry on scan entry
- ``update`` — pin only the post-update states (dis in scan + gen)
- ``outer``  — pin only outside the scan (state in, new state out)
- ``all``    — every pin (the original experiment)

    python tools/repro_shardy_constrained.py [--variant all]
"""

import argparse
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import sys  # noqa: E402

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from calciumgan.algorithms import get_algorithm  # noqa: E402
from calciumgan.config import Config  # noqa: E402
from calciumgan.models import get_models  # noqa: E402
from calciumgan.parallel import (batch_sharding, create_mesh,  # noqa: E402
                                     state_shardings)


def run(use_shardy: bool, variant: str = "all"):
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

    def constrained_step(st, batch, key):
        import jax.numpy as jnp
        from jax import lax

        from calciumgan.algorithms.gan import _apply_updates
        from calciumgan.algorithms.state import GANState

        def pin(kind, tree, shardings):
            if variant in (kind, "all"):
                return jax.lax.with_sharding_constraint(tree, shardings)
            return tree

        if variant == "outer":
            st = jax.lax.with_sharding_constraint(st, ss)
        keys = jax.random.split(key, algo.n_critic + 1)
        critic_keys, gen_key = keys[:-1], keys[-1]

        def critic_step(carry, step_key):
            dis_net, gen_bs = carry
            dis_net = pin("entry", dis_net, ss.discriminator)
            k_noise, k_gen, k_both, k_gp = jax.random.split(step_key, 4)
            noise = algo.get_noise(k_noise, batch.shape[0])
            fake, gen_bs = algo.gen_apply(
                st.generator.params, gen_bs, noise, k_gen, True)

            def dis_loss_fn(dp):
                both = jnp.concatenate(
                    [batch, fake.astype(batch.dtype)], axis=0)
                out, dis_bs = algo.dis_apply(
                    dp, dis_net.batch_stats, both, k_both, True)
                real_out = out[:batch.shape[0]]
                fake_out = out[batch.shape[0]:]
                gp = algo.gradient_penalty(dp, dis_bs, k_gp, batch, fake,
                                           True)
                loss = (algo.wasserstein_dis_loss(real_out, fake_out)
                        + algo.penalty * gp)
                return loss, (gp, dis_bs)

            (dis_loss, (gp, dis_bs)), grads = jax.value_and_grad(
                dis_loss_fn, has_aux=True)(dis_net.params)
            dis_net = _apply_updates(dis_net, grads, algo.tx_dis, dis_bs)
            dis_net = pin("update", dis_net, ss.discriminator)
            return (dis_net, gen_bs), (dis_loss, gp)

        (dis_net, gen_bs), (dis_losses, gps) = lax.scan(
            critic_step, (st.discriminator, st.generator.batch_stats),
            critic_keys)

        k_noise, k_gen, k_fake = jax.random.split(gen_key, 3)
        noise = algo.get_noise(k_noise, batch.shape[0])

        def gen_loss_fn(gp_):
            fake, new_gen_bs = algo.gen_apply(gp_, gen_bs, noise, k_gen,
                                              True)
            fake_out, _ = algo.dis_apply(
                dis_net.params, dis_net.batch_stats, fake, k_fake, True)
            return algo.generator_loss(fake_out), (fake, new_gen_bs)

        (gen_loss, (fake, gen_bs)), g_grads = jax.value_and_grad(
            gen_loss_fn, has_aux=True)(st.generator.params)
        gen_net = _apply_updates(st.generator, g_grads, algo.tx_gen, gen_bs)
        gen_net = pin("update", gen_net, ss.generator)

        logs = {
            "loss/generator": gen_loss,
            "loss/discriminator": jnp.mean(dis_losses),
            "loss/gradient_penalty": jnp.mean(gps),
        }
        logs.update(algo.metrics(batch, fake))
        out = GANState(generator=gen_net, discriminator=dis_net)
        if variant == "outer":
            out = jax.lax.with_sharding_constraint(out, ss)
        return out, logs

    rep = NamedSharding(mesh, P())
    train = jax.jit(constrained_step,
                    in_shardings=(ss, batch_sharding(mesh, 3), rep),
                    out_shardings=(ss, rep))
    state = jax.device_put(state, ss)
    sharded_real = jax.device_put(real, batch_sharding(mesh, 3))
    _, logs = train(state, sharded_real,
                    jax.device_put(jax.random.PRNGKey(0)))
    return {k: float(np.asarray(v)) for k, v in logs.items()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="all",
                    choices=["entry", "update", "outer", "all", "none"])
    va = ap.parse_args().variant
    gspmd = run(use_shardy=False, variant=va)
    shardy = run(use_shardy=True, variant=va)
    bad = []
    for k in gspmd:
        r = shardy[k] / gspmd[k] if gspmd[k] else float("nan")
        flag = "" if abs(r - 1.0) < 1e-3 else "   <-- MISMATCH"
        print(f"{k:32s} gspmd={gspmd[k]:+.6f} shardy={shardy[k]:+.6f} "
              f"ratio={r:.4f}{flag}")
        if abs(r - 1.0) >= 1e-3:
            bad.append(k)
    print("RESULT:", "MISMATCH in " + ", ".join(bad) if bad else
          "MATCH — the constrained formulation is Shardy-clean; consider "
          "wiring the constraints into wgan_gp.train_step and dropping the "
          "GSPMD scope")
