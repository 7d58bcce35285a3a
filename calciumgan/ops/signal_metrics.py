"""Train-time signal fidelity metrics (on-device).

Parity with ``gan/utils/signals_metrics.py``: squared errors between real and
fake of the per-position min/max/mean/std reduced over the LAST axis (for NWC
signals that is the channel/neuron axis — the reference's convention,
``signals_metrics.py:9-28``), plus KL divergence and per-row cross
correlation (``signals_metrics.py:31-44``, which the reference computed via a
``tf.py_function`` into numpy — here it is a pure jnp expression that stays
in the XLA computation).
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-7


def batch_weighted_mean(x: jnp.ndarray, mask=None) -> jnp.ndarray:
    """Mean of ``x`` with optional per-row (dim 0) weights.

    ``mask=None`` is a plain mean; a (B,) mask makes padded validation rows
    weightless so tail batches reduce exactly over their real rows."""
    if mask is None:
        return jnp.mean(x)
    w = mask.reshape((mask.shape[0],) + (1,) * (x.ndim - 1))
    w = w.astype(jnp.float32)
    per_row = x.size // x.shape[0]
    return jnp.sum(x.astype(jnp.float32) * w) / (jnp.sum(w) * per_row)


def kl_divergence(real: jnp.ndarray, fake: jnp.ndarray,
                  mask=None) -> jnp.ndarray:
    """Keras KLD semantics: sum over last axis of y_true*log(y_true/y_pred),
    clipped to [eps, 1], then mean.

    NOT the same recipe as :func:`calciumgan.ops.spike_metrics.\
kl_divergence` (30-bin histogram KL with zeros replaced by 1e-10, plain
    sum) — they share a name because each mirrors its reference counterpart
    (``signals_metrics.py:31-35`` vs ``compute_metrics.py:89-112``); don't
    swap one for the other. Defined for reference-surface parity; the train
    loop logs only the min/max/mean/std errors (``gan.py:36-41``), as the
    reference does."""
    p = jnp.clip(real, _EPS, 1.0)
    q = jnp.clip(fake, _EPS, 1.0)
    return batch_weighted_mean(jnp.sum(p * jnp.log(p / q), axis=-1), mask)


def min_signals_error(real, fake, mask=None):
    return batch_weighted_mean(
        jnp.square(jnp.min(real, -1) - jnp.min(fake, -1)), mask)


def max_signals_error(real, fake, mask=None):
    return batch_weighted_mean(
        jnp.square(jnp.max(real, -1) - jnp.max(fake, -1)), mask)


def mean_signals_error(real, fake, mask=None):
    return batch_weighted_mean(
        jnp.square(jnp.mean(real, -1) - jnp.mean(fake, -1)), mask)


def std_signals_error(real, fake, mask=None):
    return batch_weighted_mean(
        jnp.square(jnp.std(real, -1) - jnp.std(fake, -1)), mask)


def cross_correlation(real: jnp.ndarray, fake: jnp.ndarray) -> jnp.ndarray:
    """Mean Pearson correlation between matching rows of real and fake after
    flattening (batch, seq) into rows of length num_channels."""
    x = real.reshape((-1, real.shape[-1]))
    y = fake.reshape((-1, fake.shape[-1]))
    xc = x - x.mean(-1, keepdims=True)
    yc = y - y.mean(-1, keepdims=True)
    num = jnp.sum(xc * yc, -1)
    den = jnp.sqrt(jnp.sum(xc * xc, -1) * jnp.sum(yc * yc, -1))
    return jnp.mean(num / (den + _EPS))


def all_signal_metrics(real, fake, mask=None) -> dict:
    """The metric dict logged per step (reference gan.py:32-41)."""
    return {
        "signals_metrics/min": min_signals_error(real, fake, mask),
        "signals_metrics/max": max_signals_error(real, fake, mask),
        "signals_metrics/mean": mean_signals_error(real, fake, mask),
        "signals_metrics/std": std_signals_error(real, fake, mask),
    }
