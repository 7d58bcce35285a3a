"""WGAN-GP: Wasserstein GAN with gradient penalty.

Functional re-design of the reference ``gan/algorithms/wgan_gp.py`` (losses
at 19-20/52-62, penalty at 38-50, critic loop at 82-95), with the paper's
semantics preserved exactly (SURVEY.md §7 "n_critic semantics"):

- the SAME real batch feeds all ``n_critic`` discriminator steps and the
  generator step; fresh noise per critic step,
- uniform per-sample alpha interpolation between real and fake (alpha rank
  matches the data rank, covering the conv2d case — ``wgan_gp.py:38-41``),
- penalty = mean((||dD/dx_hat||_2 - 1)^2) via ``jax.grad`` through the
  discriminator — one fused XLA computation instead of TF's nested tapes;
  the norm is per-sample so a batch-sharded mesh needs no cross-shard
  communication beyond the final mean (inserted automatically under jit),
- the critic loop is a ``lax.scan`` over the discriminator train-state, so
  compile time stays flat in ``n_critic``.

Under bf16 mixed precision the gradient-norm is accumulated in float32; no
loss scaling is needed (unlike the reference's fp16 LossScaleOptimizer —
``optimizer.py:10-12``).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from calciumgan.algorithms.gan import GAN, _apply_updates
from calciumgan.algorithms.registry import register
from calciumgan.algorithms.state import GANState
from calciumgan.ops import signal_metrics


@register("wgan-gp")
class WGAN_GP(GAN):

    has_gradient_penalty = True

    def __init__(self, config, generator, discriminator):
        super().__init__(config, generator, discriminator)
        self.penalty = float(config.gradient_penalty)
        self.n_critic = int(config.n_critic)
        if self.n_critic < 1:
            # zero iterations would log NaN means of empty scan outputs
            # (and crash under --unroll_critic: lax.scan unroll=0)
            raise ValueError(f"n_critic must be >= 1, got {self.n_critic}")
        self.unroll_critic = bool(getattr(config, "unroll_critic", False))

    # ---- losses -------------------------------------------------------
    def generator_loss(self, fake_output, mask=None):
        return -signal_metrics.batch_weighted_mean(
            fake_output.astype(jnp.float32), mask)

    def wasserstein_dis_loss(self, real_output, fake_output, mask=None):
        return (-signal_metrics.batch_weighted_mean(
                    real_output.astype(jnp.float32), mask) +
                signal_metrics.batch_weighted_mean(
                    fake_output.astype(jnp.float32), mask))

    def interpolate(self, key, real, fake):
        alpha_shape = (real.shape[0],) + (1,) * (real.ndim - 1)
        alpha = jax.random.uniform(key, alpha_shape, jnp.float32)
        return alpha * real + (1.0 - alpha) * fake

    def gradient_penalty(self, dparams, batch_stats, key, real, fake,
                         training: bool, mask=None):
        k_alpha, k_phase = jax.random.split(key)
        x_hat = self.interpolate(k_alpha, real,
                                 lax.stop_gradient(fake).astype(real.dtype))

        def d_sum(x):
            out, _ = self.dis_apply(dparams, batch_stats, x, k_phase,
                                    training)
            return jnp.sum(out.astype(jnp.float32))

        grad = jax.grad(d_sum)(x_hat).astype(jnp.float32)
        norm = jnp.sqrt(
            jnp.sum(jnp.square(grad.reshape(grad.shape[0], -1)), axis=1)
            + 1e-12)
        return signal_metrics.batch_weighted_mean(
            jnp.square(norm - 1.0), mask)

    # ---- steps --------------------------------------------------------
    def train_step(self, state: GANState, real, key,
                   shardings=None) -> Tuple[GANState, dict]:
        """``shardings`` (a GANState of NamedShardings, supplied by
        ``parallel.mesh.make_step_fns`` on model-parallel meshes) pins the
        critic scan carry and the post-update states with
        ``with_sharding_constraint``. Required for correctness under the
        Shardy partitioner (jax 0.9 default): without the pins, batch means
        downstream of the optax update come out data-axis-size times too
        large — ``tools/repro_shardy_full.py`` is the pinned repro, and
        ``tools/repro_shardy_constrained.py``'s ablation shows ALL the pins
        below are needed (each alone still miscompiles)."""
        def pin(tree, s):
            if shardings is None:
                return tree
            return jax.lax.with_sharding_constraint(tree, s)

        keys = jax.random.split(key, self.n_critic + 1)
        critic_keys, gen_key = keys[:-1], keys[-1]

        # ---- n_critic discriminator updates (lax.scan) ----
        def critic_step(carry, step_key):
            dis_net, gen_bs = carry
            dis_net = pin(dis_net, shardings and shardings.discriminator)
            k_noise, k_gen, k_both, k_gp = jax.random.split(step_key, 4)
            noise = self.get_noise(k_noise, real.shape[0])
            fake, gen_bs = self.gen_apply(
                state.generator.params, gen_bs, noise, k_gen, True)

            def dis_loss_fn(dp):
                # real and fake ride ONE discriminator pass (concatenated
                # batch) instead of two passes; the
                # phase-shuffle shift is consequently shared between the
                # halves (the reference draws one per call), which only
                # perturbs the regularisation noise
                both = jnp.concatenate(
                    [real, fake.astype(real.dtype)], axis=0)
                out, dis_bs = self.dis_apply(
                    dp, dis_net.batch_stats, both, k_both, True)
                real_out, fake_out = out[:real.shape[0]], out[real.shape[0]:]
                gp = self.gradient_penalty(dp, dis_bs, k_gp, real, fake, True)
                loss = (self.wasserstein_dis_loss(real_out, fake_out)
                        + self.penalty * gp)
                return loss, (gp, dis_bs)

            (dis_loss, (gp, dis_bs)), grads = jax.value_and_grad(
                dis_loss_fn, has_aux=True)(dis_net.params)
            dis_net = _apply_updates(dis_net, grads, self.tx_dis, dis_bs)
            dis_net = pin(dis_net, shardings and shardings.discriminator)
            return (dis_net, gen_bs), (dis_loss, gp)

        (dis_net, gen_bs), (dis_losses, gps) = lax.scan(
            critic_step, (state.discriminator, state.generator.batch_stats),
            critic_keys, unroll=self.n_critic if self.unroll_critic else 1)

        # ---- one generator update ----
        k_noise, k_gen, k_fake = jax.random.split(gen_key, 3)
        noise = self.get_noise(k_noise, real.shape[0])

        def gen_loss_fn(gp_):
            fake, new_gen_bs = self.gen_apply(gp_, gen_bs, noise, k_gen, True)
            fake_out, _ = self.dis_apply(
                dis_net.params, dis_net.batch_stats, fake, k_fake, True)
            return self.generator_loss(fake_out), (fake, new_gen_bs)

        (gen_loss, (fake, gen_bs)), g_grads = jax.value_and_grad(
            gen_loss_fn, has_aux=True)(state.generator.params)
        gen_net = _apply_updates(state.generator, g_grads, self.tx_gen,
                                 gen_bs)
        gen_net = pin(gen_net, shardings and shardings.generator)

        logs = {
            "loss/generator": gen_loss,
            "loss/discriminator": jnp.mean(dis_losses),
            "loss/gradient_penalty": jnp.mean(gps),
        }
        logs.update(self.metrics(real, fake))
        return GANState(generator=gen_net, discriminator=dis_net,
                        ema_params=self.update_ema(state, gen_net.params)), \
            logs

    def eval_step(self, state: GANState, real, key, mask=None):
        """``mask`` (B,) zero-weights padded tail-batch rows so every logged
        mean reduces exactly over the real rows (None = all rows real)."""
        k_noise, k_gen, k_real, k_fake, k_gp = jax.random.split(key, 5)
        noise = self.get_noise(k_noise, real.shape[0])
        fake, _ = self.gen_apply(
            self.eval_gen_params(state), state.generator.batch_stats, noise,
            k_gen, False)
        real_out, _ = self.dis_apply(
            state.discriminator.params, state.discriminator.batch_stats,
            real, k_real, False)
        fake_out, _ = self.dis_apply(
            state.discriminator.params, state.discriminator.batch_stats,
            fake, k_fake, False)
        gp = self.gradient_penalty(
            state.discriminator.params, state.discriminator.batch_stats,
            k_gp, real, fake, False, mask=mask)
        logs = {
            "loss/generator": self.generator_loss(fake_out, mask),
            "loss/discriminator":
                self.wasserstein_dis_loss(real_out, fake_out, mask)
                + self.penalty * gp,
            "loss/gradient_penalty": gp,
        }
        logs.update(self.metrics(real, fake, mask))
        # GLOBAL real-row count of this batch (mask sums over the whole
        # sharded batch): the host epoch loop weights the cross-batch
        # average with it — a process-local count would under-weight ragged
        # multi-host tail batches whose real rows split unevenly
        logs["batch/real_rows"] = (
            jnp.asarray(real.shape[0], jnp.float32) if mask is None
            else jnp.sum(mask))
        return fake, logs
