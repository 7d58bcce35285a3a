"""Spike-train statistics in JAX (on-device, batched).

The reference wraps **Elephant + Neo** on the host, per train, across a
``multiprocessing.Pool`` (``/root/reference/gan/utils/spike_metrics.py:6-61``,
``spike_helper.py:8-20``, ``compute_metrics.py:45-49``). Here the same five
statistics are closed-form array programs over binary (train, time) matrices
on the fixed 24 Hz frame grid, so a whole population evaluates as one XLA
computation:

- mean firing rate: spike count / duration (elephant.statistics semantics,
  t_start=0, t_stop=T/framerate),
- binned correlation / covariance: 500 ms bins (12 frames at 24 Hz,
  truncating the ragged tail exactly like elephant.conversion
  .BinnedSpikeTrain), then corrcoef / cov (ddof=1) over bin counts,
- van Rossum distance: exponential-kernel inner products as ONE matmul
  against the (T, T) decay kernel (applied as two scans) instead of per-pair spike
  loops; normalisation such that one non-coincident spike costs 1, matching
  elephant.spike_train_dissimilarity.van_rossum_dist (tau=1 s default),
- Victor-Purpura distance: O(n*m) edit-distance DP per pair, expressed as a
  ``lax.scan`` over padded spike-time rows and vmapped over pairs (q=1/s
  default),
- histogram KL divergence: 30 right-closed equal-width bins over the joint
  range, zeros -> 1e-10 (the reference's pandas.cut recipe —
  ``compute_metrics.py:82-112``).

All public functions accept either one set (full pairwise/joint result) or
two sets, returning the (real x fake) cross block — the reference's
"concatenate and slice" pattern.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

FRAMERATE = 24  # Hz — reference summary_helper.py:66, spike_helper.py:8


# ---------------------------------------------------------------------------
# firing rate
# ---------------------------------------------------------------------------

def mean_firing_rate(spikes: jnp.ndarray,
                     framerate: int = FRAMERATE) -> jnp.ndarray:
    """(..., T) binary -> (...,) rate in Hz."""
    spikes = jnp.asarray(spikes)
    duration = spikes.shape[-1] / framerate
    return (jnp.sum(spikes, axis=-1) / duration).astype(jnp.float32)


# ---------------------------------------------------------------------------
# binned correlation / covariance
# ---------------------------------------------------------------------------

def bin_spike_counts(spikes: jnp.ndarray, framerate: int = FRAMERATE,
                     binsize: float = 0.5) -> jnp.ndarray:
    """(..., T) -> (..., B) counts in ``binsize``-second bins; the ragged
    tail beyond B*binsize is dropped (BinnedSpikeTrain semantics)."""
    spikes = jnp.asarray(spikes)
    frames_per_bin = int(round(binsize * framerate))
    n_bins = spikes.shape[-1] // frames_per_bin
    trimmed = spikes[..., :n_bins * frames_per_bin]
    return trimmed.reshape(spikes.shape[:-1] + (n_bins, frames_per_bin)).sum(
        axis=-1)


# Float32 contractions run at full float32 precision: a GPU would otherwise
# take them in TF32 (about three decimal digits) and move the statistics.
_HIGHEST = lax.Precision.HIGHEST


def _cov(m: jnp.ndarray) -> jnp.ndarray:
    """``jnp.cov`` (rows are variables, ddof 1) at full float32 precision."""
    m = jnp.asarray(m, jnp.float32)
    x = m - m.mean(axis=1, keepdims=True)
    return jnp.matmul(x, x.T, precision=_HIGHEST) / (m.shape[1] - 1)


def _corrcoef(m: jnp.ndarray) -> jnp.ndarray:
    c = _cov(m)
    d = jnp.sqrt(jnp.diag(c))
    return c / jnp.outer(d, d)


def _pair_or_cross(fn, spikes1, spikes2):
    if spikes2 is None:
        return fn(jnp.asarray(spikes1))
    n1 = len(spikes1)
    full = fn(jnp.concatenate([jnp.asarray(spikes1),
                               jnp.asarray(spikes2)], axis=0))
    # reference slice: result[len(s1):, :len(s2)] (spike_metrics.py:23,37)
    return full[n1:, :len(spikes2)]


def correlation_coefficients(spikes1, spikes2=None,
                             framerate: int = FRAMERATE,
                             binsize: float = 0.5) -> jnp.ndarray:
    """Pearson correlation of 500 ms bin counts; rows with zero variance
    yield NaN (filtered downstream with remove_nan, as in the reference)."""
    return _pair_or_cross(
        lambda s: _corrcoef(bin_spike_counts(s, framerate, binsize)),
        spikes1, spikes2)


def covariance(spikes1, spikes2=None, framerate: int = FRAMERATE,
               binsize: float = 0.5) -> jnp.ndarray:
    return _pair_or_cross(
        lambda s: _cov(bin_spike_counts(s, framerate, binsize)),
        spikes1, spikes2)


# ---------------------------------------------------------------------------
# van Rossum distance
# ---------------------------------------------------------------------------

def _apply_decay_kernel(y: jnp.ndarray, rho: float) -> jnp.ndarray:
    """(K @ y^T)^T for K[a, b] = rho^|a-b| WITHOUT materialising the (T, T)
    kernel: K = F + F^T - I where F is the causal decay, so
    (K y)_t = fwd_t + bwd_t - y_t with fwd/bwd the first-order recurrences
    fwd_t = y_t + rho*fwd_{t-1} — two log-depth ``associative_scan``s.
    O(T) work per trace instead of the O(T^2) matmul row."""
    from calciumgan.ops.oasis import first_order_recurrence

    rho = jnp.asarray(rho, y.dtype)
    decay = jnp.broadcast_to(rho, y.shape)
    _, fwd = first_order_recurrence(decay, y, axis=-1)
    _, bwd = first_order_recurrence(decay, y, axis=-1, reverse=True)
    return fwd + bwd - y


def van_rossum_distance(spikes1, spikes2=None, tau: float = 1.0,
                        framerate: int = FRAMERATE) -> jnp.ndarray:
    """Pairwise van Rossum distances.

    D(u, v)^2 = u^T K u + v^T K v - 2 u^T K v with
    K[a, b] = exp(-|a - b| / (framerate * tau)) over the frame grid. The
    kernel application exploits the exponential structure (scan instead of a
    (T, T) matmul); the pairwise cross terms remain one matmul.
    """
    if spikes2 is None:
        x = y = jnp.asarray(spikes1, jnp.float32)
    else:
        x = jnp.asarray(spikes2, jnp.float32)  # rows: fake (reference slice)
        y = jnp.asarray(spikes1, jnp.float32)
    rho = float(np.exp(-1.0 / (framerate * tau)))
    xK = _apply_decay_kernel(x, rho)
    self_x = jnp.sum(xK * x, axis=-1)          # diag(x K x^T)
    if spikes2 is None:
        yK, self_y = xK, self_x
    else:
        yK = _apply_decay_kernel(y, rho)
        self_y = jnp.sum(yK * y, axis=-1)
    cross = jnp.matmul(xK, y.T, precision=_HIGHEST)
    d2 = self_x[:, None] + self_y[None, :] - 2.0 * cross
    return jnp.sqrt(jnp.maximum(d2, 0.0))


# ---------------------------------------------------------------------------
# Victor-Purpura distance
# ---------------------------------------------------------------------------

def _spike_times_padded(spikes: np.ndarray, framerate: int,
                        bucket: int = 1):
    """Binary (N, T) -> (times (N, M) float32 padded with +inf, counts (N,)).

    M is the GLOBAL max spike count, so one dense train inflates the
    O(M^2) DP for every pair. Acceptable behind ``--victor_purpura``
    (spiking data is sparse and uniform); revisit with per-chunk padding if
    VP is ever run over heterogeneous populations. ``bucket`` rounds M up to
    a multiple (the chunked batch path uses 32 so each chunk's max count
    does not mint a fresh XLA program)."""
    spikes = np.asarray(spikes)
    counts = spikes.astype(bool).sum(axis=-1)
    M = max(1, int(counts.max()) if counts.size else 1)
    M = -(-M // bucket) * bucket
    times = np.full((spikes.shape[0], M), np.inf, np.float32)
    for i, row in enumerate(spikes):
        t = np.nonzero(row)[0] / framerate
        times[i, :len(t)] = t
    return jnp.asarray(times), jnp.asarray(counts, jnp.int32)


def _vp_pair(tu, nu, tv, nv, q):
    """VP edit distance between padded spike-time rows via the standard DP,
    rolled as a scan over u's spikes (rows of the DP table)."""
    M = tv.shape[0]
    j = jnp.arange(M + 1, dtype=jnp.float32)
    row0 = j  # cost of inserting j spikes of v

    def step(prev_row, args):
        i, t_ui = args
        valid_u = i < nu

        def inner(carry, k):
            left = carry            # current_row[k-1]
            tv_k = tv[k - 1]
            valid_v = (k - 1) < nv
            move = jnp.where(valid_u & valid_v,
                             q * jnp.abs(t_ui - tv_k), jnp.inf)
            best = jnp.minimum(
                jnp.minimum(prev_row[k] + 1.0, left + 1.0),
                prev_row[k - 1] + move)
            return best, best

        first = prev_row[0] + 1.0
        _, rest = lax.scan(inner, first, jnp.arange(1, M + 1))
        row = jnp.concatenate([first[None], rest])
        return jnp.where(valid_u, row, prev_row), None

    idx = jnp.arange(tu.shape[0])
    final, _ = lax.scan(step, row0, (idx, tu))
    return final[nv]


def _vp_matrix_impl(tx, nx, ty, ny, q: float):
    f = lambda tu, nu: jax.vmap(lambda tv, nv: _vp_pair(tu, nu, tv, nv, q))(
        ty, ny)
    return jax.vmap(f)(tx, nx)


_vp_matrix = functools.partial(jax.jit, static_argnames=("q",))(
    _vp_matrix_impl)


@functools.partial(jax.jit, static_argnames=("q",))
def _vp_matrix_batch(t, n, q: float):
    """(B, N, M) padded times + (B, N) counts -> (B, N, N) VP matrices."""
    return jax.vmap(lambda tb, nb: _vp_matrix_impl(tb, nb, tb, nb, q))(t, n)


def victor_purpura_distance(spikes1, spikes2=None, q: float = 1.0,
                            framerate: int = FRAMERATE) -> jnp.ndarray:
    """Pairwise Victor-Purpura distances (cost ``q`` per second of shift)."""
    if spikes2 is None:
        t, n = _spike_times_padded(np.asarray(spikes1), framerate)
        return _vp_matrix(t, n, t, n, q)
    s1, s2 = np.asarray(spikes1), np.asarray(spikes2)
    both = np.concatenate([s1, s2], axis=0)
    t, n = _spike_times_padded(both, framerate)
    full = _vp_matrix(t, n, t, n, q)
    return full[len(s1):, :len(s2)]


def victor_purpura_distance_batch(spikes, q: float = 1.0,
                                  framerate: int = FRAMERATE) -> jnp.ndarray:
    """Trial-batched pairwise VP: (B, N, T) binary spikes -> (B, N, N)
    matrices in ONE dispatch (vmap over trials) — the eval driver's chunked
    path; ~BxNxN DP lanes keep an accelerator busy where the per-trial API
    serialises B dispatches. Spike-count padding is per call (bucketed to
    32) so a dense outlier only inflates its own chunk."""
    spikes = np.asarray(spikes)
    B, N, T = spikes.shape
    t, n = _spike_times_padded(spikes.reshape(B * N, T), framerate,
                               bucket=32)
    return _vp_matrix_batch(t.reshape(B, N, -1), n.reshape(B, N), q)


# ---------------------------------------------------------------------------
# histogram KL divergence
# ---------------------------------------------------------------------------

def kl_divergence(p: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """sum(p * log(p / q)) with zero entries replaced by 1e-10
    (``compute_metrics.py:82-86``)."""
    p = jnp.where(p == 0, 1e-10, p)
    q = jnp.where(q == 0, 1e-10, q)
    return jnp.sum(p * jnp.log(p / q))


def histogram_kl(real, fake, num_bins: int = 30) -> jnp.ndarray:
    """30-bin histogram KL(real || fake) over the joint range — the
    reference's pandas.cut recipe (right-closed equal-width bins with the
    left edge extended 0.1% so the minimum lands in bin 0 —
    ``compute_metrics.py:89-112``)."""
    real = jnp.asarray(real, jnp.float32).ravel()
    fake = jnp.asarray(fake, jnp.float32).ravel()
    both = jnp.concatenate([real, fake])
    lo, hi = jnp.min(both), jnp.max(both)
    span = jnp.where(hi > lo, hi - lo, 1.0)
    edges = lo + span * jnp.arange(num_bins + 1) / num_bins
    edges = edges.at[0].add(-0.001 * span)

    def pdf(x):
        # right-closed bins: count of edges[i] < x <= edges[i+1]
        bin_idx = jnp.searchsorted(edges, x, side="left") - 1
        bin_idx = jnp.clip(bin_idx, 0, num_bins - 1)
        counts = jnp.zeros(num_bins, jnp.float32).at[bin_idx].add(1.0)
        return counts / x.shape[0]

    return kl_divergence(pdf(real), pdf(fake))


def pairs_kl_divergence(pairs) -> np.ndarray:
    """[(real, fake), ...] -> per-pair KL (``compute_metrics.py:89-112``);
    NaN for pairs where either side is empty (e.g. all-NaN correlations of
    silent trains filtered by remove_nan)."""
    out = np.full(len(pairs), np.nan, np.float32)
    for i, (r, f) in enumerate(pairs):
        if np.size(r) and np.size(f):
            out[i] = histogram_kl(r, f)
    return out
