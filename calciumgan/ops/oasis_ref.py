"""Reference (numpy) implementation of OASIS AR(1) spike deconvolution.

This is the golden model used to validate the XLA machine
(:mod:`calciumgan.ops.oasis`) and the float64 routine that the C++ host
kernel and the CUDA kernel share (``calciumgan/native/oasis_ar1.h``).

Algorithm: Friedrich, Zhou & Paninski, "Fast online deconvolution of calcium
imaging data", PLoS Comput Biol 2017 — Algorithm 1 (pool adjacency / PAVA
style) for the AR(1) model with an optional minimum-spike-size constraint
``s_min`` and sparsity penalty ``lam``.

The reference pipeline calls the Cython ``oasisAR1(y, g=0.95, s_min=0.55)``
and binarises the returned spike vector at 0.5
(``/root/reference/gan/utils/spike_helper.py:23-29``,
``/root/reference/dataset/spike_train_inference.py:26-27``). This module
implements the same mathematical algorithm from the paper (not a port of the
Cython source):

Maintain a stack of pools ``(v, w, t0, len)``. For each new sample push a
singleton pool; while the top pool violates the constraint

    c[t0_top] >= g**len_prev * c[t0_prev] + s_min

(with pool height ``c[t0] = v / w``), merge it into its left neighbour:

    v_prev += g**len_prev * v_top
    w_prev += g**(2*len_prev) * w_top
    len_prev += len_top

Finally each pool contributes ``c[t0+k] = max(v/w, 0) * g**k`` and the spike
vector is ``s[t] = c[t] - g*c[t-1]`` with ``s[0] = 0``.
"""

from __future__ import annotations

import numpy as np


def oasis_ar1(y: np.ndarray, g: float = 0.95, lam: float = 0.0,
              s_min: float = 0.0):
    """Deconvolve a single fluorescence trace.

    Args:
        y: float array of shape (T,).
        g: AR(1) decay coefficient.
        lam: sparsity penalty (the reference pipeline always uses 0).
        s_min: minimum spike size.

    Returns:
        (c, s): denoised calcium trace and spike train, both shape (T,).
    """
    y = np.asarray(y, dtype=np.float64)
    T = y.shape[0]
    if T == 0:
        return y.copy(), y.copy()

    # lam shifts the target: y - lam*(1-g), except the last sample (y - lam).
    yy = y - lam * (1.0 - g)
    yy[-1] = y[-1] - lam

    v = np.empty(T, dtype=np.float64)
    w = np.empty(T, dtype=np.float64)
    t0 = np.empty(T, dtype=np.int64)
    ln = np.empty(T, dtype=np.int64)

    p = -1  # stack top
    for t in range(T):
        p += 1
        v[p], w[p], t0[p], ln[p] = yy[t], 1.0, t, 1
        while p > 0 and (v[p] / w[p] <
                         g ** ln[p - 1] * (v[p - 1] / w[p - 1]) + s_min):
            gl = g ** ln[p - 1]
            v[p - 1] += gl * v[p]
            w[p - 1] += gl * gl * w[p]
            ln[p - 1] += ln[p]
            p -= 1

    c = np.empty(T, dtype=np.float64)
    for i in range(p + 1):
        h = max(v[i] / w[i], 0.0)
        c[t0[i]:t0[i] + ln[i]] = h * g ** np.arange(ln[i], dtype=np.float64)

    s = np.empty(T, dtype=np.float64)
    s[0] = 0.0
    s[1:] = c[1:] - g * c[:-1]
    return c, s


def synth_ar1_traces(rng, n: int, T: int, g: float = 0.95,
                     rate: float = 0.02, sn: float = 0.3) -> np.ndarray:
    """Noisy AR(1) calcium traces from a Bernoulli spike train — the shared
    host-side (numpy) input synthesizer for the OASIS benchmarks and checks,
    kept in one place so bench.py, tools/time_oasis.py and chip_smoke.py
    measure identical inputs."""
    spikes = (rng.random((n, T)) < rate).astype(np.float32)
    traces = np.empty_like(spikes)
    acc = np.zeros(n, np.float32)
    for t in range(T):
        acc = g * acc + spikes[:, t]
        traces[:, t] = acc
    return traces + sn * rng.standard_normal(traces.shape).astype(np.float32)


def deconvolve_signals_ref(signals: np.ndarray, g: float = 0.95,
                           s_min: float = 0.55,
                           threshold: float = 0.5) -> np.ndarray:
    """Binary spike trains for a (N, T) batch (reference spike_helper.py:32-54
    semantics: per-trace oasisAR1 then ``s > threshold``)."""
    signals = np.asarray(signals)
    assert signals.ndim == 2
    out = np.zeros(signals.shape, dtype=np.float32)
    for i in range(signals.shape[0]):
        _, s = oasis_ar1(signals[i], g=g, s_min=s_min)
        out[i] = (s > threshold).astype(np.float32)
    return out
