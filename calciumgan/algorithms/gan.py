"""Vanilla (non-saturating) GAN with BCE-from-logits losses.

Functional re-design of the reference ``gan/algorithms/gan.py``:
- the reference's ``@tf.function`` methods over hidden Keras state become
  pure ``(state, batch, key) -> (state, logs)`` functions, jitted (and
  sharded) by the training driver,
- simultaneous G/D update semantics preserved: both gradients are taken from
  the SAME forward pass (same noise, same phase-shuffle shifts — reference
  ``gan.py:72-85`` records one ``_step`` under two tapes),
- per-batch signal metrics on denormalised data (``gan.py:32-41``).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import optax

from calciumgan.algorithms.registry import register
from calciumgan.algorithms.state import GANState, NetState, make_net_state
from calciumgan.ops import signal_metrics


def bce_with_logits(logits: jnp.ndarray, label: int,
                    mask=None) -> jnp.ndarray:
    """Keras BinaryCrossentropy(from_logits=True) against a constant label.
    A (B,) ``mask`` zero-weights padded validation rows (exact tail-batch
    reduction)."""
    logits = logits.astype(jnp.float32)
    per = (jax.nn.softplus(-logits) if label == 1
           else jax.nn.softplus(logits))
    return signal_metrics.batch_weighted_mean(per, mask)


@register("gan")
class GAN:
    """Holds static config + modules + optax transforms; all step methods are
    pure in (state, data, key) and safe to ``jax.jit``."""

    has_gradient_penalty = False

    def __init__(self, config, generator, discriminator):
        self.config = config
        self.generator = generator
        self.discriminator = discriminator
        self.noise_shape = (config.noise_dim,)
        self.signal_shape = tuple(config.signal_shape)
        self.normalize = bool(config.normalize)
        self.signals_min = config.signals_min if self.normalize else 0.0
        self.signals_max = config.signals_max if self.normalize else 1.0
        # Keras Adam epsilon is 1e-7 (optax default is 1e-8)
        self.tx_gen = optax.adam(config.learning_rate, eps=1e-7)
        self.tx_dis = optax.adam(config.learning_rate, eps=1e-7)
        # generator-EMA decay per generator update (0 = off). GAN training
        # (the reference included) evaluates the raw generator, whose sample
        # quality oscillates with the adversarial game; an EMA smooths the
        # trajectory so eval/generate track the average generator instead
        # of wherever this step's game left it (round-4 fft runs showed a
        # post-optimum KL rebound of exactly that character).
        self.ema = float(getattr(config, "ema", 0.0) or 0.0)
        if not 0.0 <= self.ema < 1.0:
            raise ValueError(f"--ema must be in [0, 1), got {self.ema}")

    # ------------------------------------------------------------------
    def init_state(self, rng: jax.Array) -> GANState:
        kg, kd, kp, kr = jax.random.split(rng, 4)
        noise = jnp.zeros((1,) + self.noise_shape, jnp.float32)
        signal = jnp.zeros((1,) + self.signal_shape, jnp.float32)
        gvars = self.generator.init(
            {"params": kg, "dropout": kr}, noise, training=False)
        dvars = self.discriminator.init(
            {"params": kd, "phase": kp, "dropout": kr}, signal,
            training=False)
        gen_net = make_net_state(gvars, self.tx_gen)
        # the EMA seed must be a COPY: aliasing the params buffers makes the
        # donated train step see the same buffer twice ("Attempt to donate
        # the same buffer twice in Execute()")
        ema = (jax.tree_util.tree_map(jnp.copy, gen_net.params)
               if self.ema > 0 else None)
        return GANState(
            generator=gen_net,
            discriminator=make_net_state(dvars, self.tx_dis),
            ema_params=ema)

    # ------------------------------------------------------------------
    def get_noise(self, key: jax.Array, batch_size: int) -> jnp.ndarray:
        return jax.random.normal(
            key, (batch_size,) + self.noise_shape, jnp.float32)

    def eval_gen_params(self, state: GANState):
        """Generator params for eval/generate: the EMA when enabled."""
        return (state.ema_params if state.ema_params is not None
                else state.generator.params)

    def update_ema(self, state: GANState, new_gen_params):
        """Post-update EMA of the generator params (None stays None)."""
        if state.ema_params is None:
            return None
        return jax.tree_util.tree_map(
            lambda e, p: self.ema * e + (1.0 - self.ema) * p,
            state.ema_params, new_gen_params)

    def denormalize(self, x):
        if not self.normalize:
            return x
        return x * (self.signals_max - self.signals_min) + self.signals_min

    def metrics(self, real, fake, mask=None) -> dict:
        return signal_metrics.all_signal_metrics(
            self.denormalize(real), self.denormalize(fake), mask)

    # ---- module application helpers ----------------------------------
    def gen_apply(self, params, batch_stats, noise, key, training: bool):
        """Returns (fake, new_batch_stats)."""
        variables = {"params": params}
        if batch_stats:
            variables["batch_stats"] = batch_stats
        rngs = {"dropout": jax.random.fold_in(key, 1)}
        if training and batch_stats:
            fake, mut = self.generator.apply(
                variables, noise, training=True, rngs=rngs,
                mutable=["batch_stats"])
            return fake, mut["batch_stats"]
        fake = self.generator.apply(variables, noise, training=training,
                                    rngs=rngs)
        return fake, batch_stats

    def dis_apply(self, params, batch_stats, x, key, training: bool):
        variables = {"params": params}
        if batch_stats:
            variables["batch_stats"] = batch_stats
        rngs = {"phase": jax.random.fold_in(key, 2),
                "dropout": jax.random.fold_in(key, 3)}
        if training and batch_stats:
            out, mut = self.discriminator.apply(
                variables, x, training=True, rngs=rngs,
                mutable=["batch_stats"])
            return out, mut["batch_stats"]
        out = self.discriminator.apply(variables, x, training=training,
                                       rngs=rngs)
        return out, batch_stats

    # ---- losses -------------------------------------------------------
    def generator_loss(self, fake_output, mask=None):
        return bce_with_logits(fake_output, 1, mask)

    def discriminator_loss(self, real_output, fake_output, mask=None):
        return (bce_with_logits(real_output, 1, mask) +
                bce_with_logits(fake_output, 0, mask))

    # ---- steps --------------------------------------------------------
    def _forward(self, gparams, dparams, state: GANState, real, key,
                 training: bool, mask=None):
        """One shared forward pass; deterministic in ``key`` so the two
        gradient evaluations see identical randomness (and XLA CSEs them).
        Real and fake ride ONE discriminator pass (concatenated batch) for
        better tensor-core utilisation; the phase-shuffle shift is shared between
        the halves."""
        k_noise, k_gen, k_both = jax.random.split(key, 3)
        noise = self.get_noise(k_noise, real.shape[0])
        fake, gen_bs = self.gen_apply(
            gparams, state.generator.batch_stats, noise, k_gen, training)
        both = jnp.concatenate([real, fake.astype(real.dtype)], axis=0)
        out, dis_bs = self.dis_apply(
            dparams, state.discriminator.batch_stats, both, k_both, training)
        real_out, fake_out = out[:real.shape[0]], out[real.shape[0]:]
        gen_loss = self.generator_loss(fake_out, mask)
        dis_loss = self.discriminator_loss(real_out, fake_out, mask)
        return gen_loss, dis_loss, fake, gen_bs, dis_bs

    def train_step(self, state: GANState, real, key,
                   shardings=None) -> Tuple[GANState, dict]:
        """``shardings`` (GANState of NamedShardings): optional pins applied
        to the post-update states on model-parallel meshes — see
        ``wgan_gp.train_step`` for the Shardy rationale. Vanilla GAN has no
        post-update forward (the known miscompile trigger), so this is a
        defensive no-op-cost pin for symmetry."""
        gparams, dparams = state.generator.params, state.discriminator.params

        def gen_loss_fn(gp):
            gen_loss, _, fake, gen_bs, _ = self._forward(
                gp, dparams, state, real, key, True)
            return gen_loss, (fake, gen_bs)

        def dis_loss_fn(dp):
            _, dis_loss, _, _, dis_bs = self._forward(
                gparams, dp, state, real, key, True)
            return dis_loss, dis_bs

        (gen_loss, (fake, gen_bs)), g_grads = jax.value_and_grad(
            gen_loss_fn, has_aux=True)(gparams)
        (dis_loss, dis_bs), d_grads = jax.value_and_grad(
            dis_loss_fn, has_aux=True)(dparams)

        new_gen = _apply_updates(state.generator, g_grads, self.tx_gen, gen_bs)
        new_dis = _apply_updates(state.discriminator, d_grads, self.tx_dis,
                                 dis_bs)
        if shardings is not None:
            new_gen = jax.lax.with_sharding_constraint(
                new_gen, shardings.generator)
            new_dis = jax.lax.with_sharding_constraint(
                new_dis, shardings.discriminator)
        logs = {"loss/generator": gen_loss, "loss/discriminator": dis_loss}
        logs.update(self.metrics(real, fake))
        return GANState(generator=new_gen, discriminator=new_dis,
                        ema_params=self.update_ema(state, new_gen.params)), \
            logs

    def eval_step(self, state: GANState, real, key, mask=None):
        """``mask`` (B,) zero-weights padded tail-batch rows so every logged
        mean reduces exactly over the real rows (None = all rows real)."""
        gen_loss, dis_loss, fake, _, _ = self._forward(
            self.eval_gen_params(state), state.discriminator.params, state,
            real, key, False, mask=mask)
        logs = {"loss/generator": gen_loss, "loss/discriminator": dis_loss}
        logs.update(self.metrics(real, fake, mask))
        # see wgan_gp.eval_step: global real-row count for exact cross-batch
        # weighting on ragged multi-host tails
        logs["batch/real_rows"] = (
            jnp.asarray(real.shape[0], jnp.float32) if mask is None
            else jnp.sum(mask))
        return fake, logs

    def generate(self, state: GANState, noise, key=None, denorm: bool = False):
        key = key if key is not None else jax.random.PRNGKey(0)
        fake, _ = self.gen_apply(
            self.eval_gen_params(state), state.generator.batch_stats, noise,
            key, training=False)
        return self.denormalize(fake) if denorm else fake


def _apply_updates(net: NetState, grads, tx, batch_stats) -> NetState:
    updates, opt_state = tx.update(grads, net.opt_state, net.params)
    params = optax.apply_updates(net.params, updates)
    return NetState(params=params, batch_stats=batch_stats,
                    opt_state=opt_state, step=net.step + 1)
