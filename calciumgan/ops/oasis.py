"""OASIS AR(1) spike deconvolution on device (JAX).

The reference calls the external Cython ``oasisAR1`` per neuron per trial from
host Python, fanned out over a ``multiprocessing.Pool``
(``/root/reference/gan/utils/spike_helper.py:23-54``,
``compute_metrics.py:45-49``). The same pool-adjacency algorithm (see
:mod:`calciumgan.ops.oasis_ref` for the spec and provenance) runs here
two ways:

- :func:`oasis_spikes`: the CUDA kernel of ``native/oasis_cuda.cu`` through
  ``jax.ffi``, one GPU thread per trace running the float64 routine that
  the C++ host kernel also runs (``native/oasis_ar1.h``), so its spikes
  equal the host's. This is the eval path on a GPU.
- :func:`oasis_ar1_jax`: the plain XLA version, a fixed-trip-count state
  machine under ``lax.while_loop`` vmapped over traces (time is the
  sequential dimension, at most ``2T-1`` iterations; pool reconstruction is
  parallel: cumsum + searchsorted + gather). It is float32 and is the
  in-graph reference (:func:`deconvolve_signals`).

Also provides :func:`ar1_filter` — spikes->calcium synthesis as an
``associative_scan`` (log-depth first-order recurrence), the inverse
direction used by the DG data generators
(``/root/reference/dataset/generate_dg_data.py:54-70``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["oasis_ar1_jax", "deconvolve_signals", "oasis_spikes",
           "ar1_filter", "first_order_recurrence"]


def _oasis_single(y: jnp.ndarray, g: float, lam: float, s_min: float):
    """Single-trace OASIS AR(1). y: (T,) float32. Returns (c, s)."""
    T = y.shape[0]
    dtype = y.dtype
    g = jnp.asarray(g, dtype)
    log_g = jnp.log(g)
    s_min_ = jnp.asarray(s_min, dtype)

    yy = y - lam * (1.0 - g)
    yy = yy.at[T - 1].set(y[T - 1] - lam)

    def gpow(e):
        # g**e for a traced integer exponent; underflows cleanly to 0.
        return jnp.exp(e.astype(dtype) * log_g)

    def violation(v, w, ln, p):
        pm1 = jnp.maximum(p - 1, 0)
        top = v[p] / w[p]
        prev = gpow(ln[pm1]) * (v[pm1] / w[pm1]) + s_min_
        return (p > 0) & (top < prev)

    def cond(state):
        v, w, ln, t, p = state
        return (t < T) | violation(v, w, ln, p)

    def body(state):
        v, w, ln, t, p = state
        viol = violation(v, w, ln, p)
        pm1 = jnp.maximum(p - 1, 0)

        # merge top pool into its left neighbour
        gl = gpow(ln[pm1])
        v_m = v.at[pm1].add(gl * v[p])
        w_m = w.at[pm1].add(gl * gl * w[p])
        l_m = ln.at[pm1].add(ln[p])

        # push a new singleton pool at p+1 (clipped: inactive lanes under
        # vmap may reach t == T; their state is masked out by the batched
        # while_loop select)
        tc = jnp.minimum(t, T - 1)
        pp1 = jnp.minimum(p + 1, T - 1)
        v_p = v.at[pp1].set(yy[tc])
        w_p = w.at[pp1].set(jnp.asarray(1.0, dtype))
        l_p = ln.at[pp1].set(1)

        v2 = jnp.where(viol, v_m, v_p)
        w2 = jnp.where(viol, w_m, w_p)
        l2 = jnp.where(viol, l_m, l_p)
        t2 = jnp.where(viol, t, t + 1)
        p2 = jnp.where(viol, p - 1, p + 1)
        return (v2, w2, l2, t2, p2)

    v0 = jnp.zeros((T,), dtype).at[0].set(yy[0])
    w0 = jnp.zeros((T,), dtype).at[0].set(1.0)
    l0 = jnp.zeros((T,), jnp.int32).at[0].set(1)
    state = (v0, w0, l0, jnp.int32(1), jnp.int32(0))

    v, w, ln, _, p = lax.while_loop(cond, body, state)

    # ---- parallel reconstruction ----
    n_pools = p + 1
    idx = jnp.arange(T, dtype=jnp.int32)
    valid = idx < n_pools
    l_masked = jnp.where(valid, ln, 0)
    starts = jnp.cumsum(l_masked) - l_masked      # inclusive start per pool
    # invalid tail pools all start at T, after every time index
    starts = jnp.where(valid, starts, T)
    pool_id = jnp.searchsorted(starts, idx, side="right") - 1
    h = jnp.maximum(v / w, 0.0)
    c = h[pool_id] * jnp.exp(
        (idx - starts[pool_id]).astype(dtype) * log_g)
    s = jnp.concatenate([jnp.zeros((1,), dtype), c[1:] - g * c[:-1]])
    return c, s


@functools.partial(jax.jit, static_argnames=("g", "lam", "s_min"))
def oasis_ar1_jax(signals: jnp.ndarray, g: float = 0.95, lam: float = 0.0,
                  s_min: float = 0.0):
    """Batched OASIS AR(1): signals (..., T) -> (c, s) of the same shape."""
    signals = jnp.asarray(signals, jnp.float32)
    batch_shape = signals.shape[:-1]
    flat = signals.reshape((-1, signals.shape[-1]))
    c, s = jax.vmap(lambda tr: _oasis_single(tr, g, lam, s_min))(flat)
    return c.reshape(signals.shape), s.reshape(batch_shape + (s.shape[-1],))


@functools.partial(jax.jit, static_argnames=("g", "s_min", "threshold"))
def deconvolve_signals(signals: jnp.ndarray, g: float = 0.95,
                       s_min: float = 0.55, threshold: float = 0.5):
    """Binary spike trains (float32) for a (..., T) batch, in-graph, through
    the plain XLA machine :func:`oasis_ar1_jax`.

    Parity with the reference's ``spike_helper.deconvolve_signals`` /
    ``oasis_function`` (g=0.95, s_min=0.55, binarise at 0.5 —
    ``spike_helper.py:23-29``), minus the host pool. The machine runs in
    float32, so a merge decision whose margin lies within float32 rounding
    can differ from the float64 kernels (:func:`oasis_spikes` and the host
    kernel)."""
    _, s = oasis_ar1_jax(signals, g=g, lam=0.0, s_min=s_min)
    return (s > threshold).astype(jnp.float32)


# Threads per block of the CUDA kernel (kBlock in native/oasis_cuda.cu).
# The wrapper pads the trace count to a multiple, so every block is full and
# batches whose sizes differ by less than a block share one program.
CUDA_BLOCK = 32
# Pool-stack scratch per (trace, frame): v and w in float64, len in int32.
_SCRATCH_BYTES = 2 * 8 + 4


def _cuda_spikes_tn(yt: jnp.ndarray, g: float, s_min: float,
                    threshold: float) -> jnp.ndarray:
    """(T, N) float32 time-major signals -> (T, N) int8 spikes through the
    CUDA kernel. The pool stacks live in a scratch result the call asks
    XLA for, so the kernel allocates nothing."""
    from calciumgan import native
    target = native.register_cuda()
    T, n = yt.shape
    spikes, _ = jax.ffi.ffi_call(target, (
        jax.ShapeDtypeStruct((T, n), jnp.int8),
        jax.ShapeDtypeStruct((n * T * _SCRATCH_BYTES,), jnp.uint8),
    ))(yt, g=np.float64(g), s_min=np.float64(s_min),
       threshold=np.float64(threshold))
    return spikes


@functools.partial(jax.jit, static_argnames=("g", "s_min", "threshold"))
def oasis_spikes(signals: jnp.ndarray, g: float = 0.95, s_min: float = 0.55,
                 threshold: float = 0.5) -> jnp.ndarray:
    """Binary spike trains (int8) for a (..., T) batch through the CUDA
    kernel: exact float64 OASIS, the host kernel's result bit for bit.

    Needs a CUDA device; the library is built on first use
    (:func:`calciumgan.native.register_cuda`)."""
    signals = jnp.asarray(signals, jnp.float32)
    T = signals.shape[-1]
    flat = signals.reshape((-1, T))
    n = flat.shape[0]
    if n == 0 or T == 0:
        return jnp.zeros(signals.shape, jnp.int8)
    flat = jnp.pad(flat, ((0, -n % CUDA_BLOCK), (0, 0)))
    # time-major in and out, so the kernel's per-frame accesses coalesce
    spikes = _cuda_spikes_tn(flat.T, g, s_min, threshold)
    return spikes.T[:n].reshape(signals.shape)


def first_order_recurrence(a: jnp.ndarray, b: jnp.ndarray, axis: int = -1,
                           reverse: bool = False):
    """Solve ``c[t] = a[t] * c[t-1] + b[t]`` (with ``c`` before the first
    element = 0; time flipped when ``reverse``) as a log-depth
    ``associative_scan`` over the composition of affine maps
    ``x -> x*a + b``. Returns ``(a_prod, c)``. Shared by :func:`ar1_filter`
    and the van Rossum decay kernel
    (:mod:`calciumgan.ops.spike_metrics`)."""
    def combine(lhs, rhs):
        a1, b1 = lhs
        a2, b2 = rhs
        return a1 * a2, b1 * a2 + b2

    if reverse and axis < 0:  # associative_scan(reverse) needs axis >= 0
        axis += b.ndim
    return lax.associative_scan(combine, (a, b), axis=axis, reverse=reverse)


def ar1_filter(spikes: jnp.ndarray, g=(0.95,), axis: int = -1) -> jnp.ndarray:
    """Spikes -> calcium via the AR recurrence, as a log-depth parallel scan.

    AR(1): c[t] = s[t] + g*c[t-1] for t >= 2, with c[0]=s[0], c[1]=s[1]
    (the DG generators start the recurrence at t=2 — reference
    ``dataset/generate_dg_data.py:54-70`` — so the g*c[0] term is absent at
    t=1; we reproduce that by pre-subtracting g*s[0] from s[1] and running
    the full recurrence). AR(2) falls back to ``lax.scan``.

    Implemented with ``lax.associative_scan`` over the composition of affine
    maps (a, b) -> x*a + b, so the sequential dimension costs O(log T) depth
    instead of O(T).
    """
    spikes = jnp.asarray(spikes)
    if not jnp.issubdtype(spikes.dtype, jnp.floating):
        # int/bool spike trains (e.g. the int8 `spikes` h5 datasets) would
        # truncate g to 0 in the affine maps and silently skip the decay
        spikes = spikes.astype(jnp.float32)
    g = tuple(float(x) for x in (g if hasattr(g, "__len__") else (g,)))
    x = jnp.moveaxis(spikes, axis, -1)

    if len(g) == 1:
        if x.shape[-1] >= 2:
            x = x.at[..., 1].add(-g[0] * x[..., 0])
        a = jnp.full(x.shape, g[0], x.dtype)
        _, c = first_order_recurrence(a, x, axis=-1)
    else:
        g1, g2 = g

        def step(carry, s_t):
            c1, c2 = carry
            c = s_t + g1 * c1 + g2 * c2
            return (c, c1), c

        xt = jnp.moveaxis(x, -1, 0)
        # reference semantics: first two samples are passed through unchanged
        init = (xt[1], xt[0])
        _, tail = lax.scan(step, init, xt[2:])
        c = jnp.moveaxis(jnp.concatenate([xt[:2], tail], axis=0), 0, -1)

    return jnp.moveaxis(c, -1, axis)
