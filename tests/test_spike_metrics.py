"""Spike statistics vs independent numpy/scipy oracles."""

import numpy as np
import pytest

from calciumgan.ops import spike_metrics as sm


@pytest.fixture
def spikes(rng):
    return (rng.uniform(size=(6, 480)) < 0.08).astype(np.float32)


def test_mean_firing_rate(spikes):
    out = np.asarray(sm.mean_firing_rate(spikes))
    expected = spikes.sum(-1) / (spikes.shape[-1] / 24)
    np.testing.assert_allclose(out, expected, rtol=1e-6)


def test_bin_spike_counts_truncates_tail():
    s = np.zeros((1, 30), np.float32)
    s[0, [0, 11, 12, 25]] = 1       # 30 frames -> 2 bins of 12, 6 dropped
    out = np.asarray(sm.bin_spike_counts(s))
    # bin0: frames 0-11 (2 spikes); bin1: frames 12-23 (1); frame 25 dropped
    np.testing.assert_array_equal(out, [[2, 1]])


def test_correlation_matches_numpy(spikes):
    binned = spikes[:, :480 // 12 * 12].reshape(6, -1, 12).sum(-1)
    expected = np.corrcoef(binned)
    out = np.asarray(sm.correlation_coefficients(spikes))
    np.testing.assert_allclose(out, expected, rtol=1e-4, atol=1e-5)


def test_covariance_matches_numpy(spikes):
    binned = spikes[:, :480 // 12 * 12].reshape(6, -1, 12).sum(-1)
    np.testing.assert_allclose(np.asarray(sm.covariance(spikes)),
                               np.cov(binned), rtol=1e-4, atol=1e-5)


def test_cross_block_slicing(spikes, rng):
    other = (rng.uniform(size=(4, 480)) < 0.08).astype(np.float32)
    cross = np.asarray(sm.correlation_coefficients(list(spikes), list(other)))
    # reference: full[len(s1):, :len(s2)] -> shape (len(s2), len(s2))
    assert cross.shape == (4, 4)
    both = np.concatenate([spikes, other])
    binned = both[:, :480 // 12 * 12].reshape(10, -1, 12).sum(-1)
    np.testing.assert_allclose(cross, np.corrcoef(binned)[6:, :4],
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# van Rossum
# ---------------------------------------------------------------------------

def _vr_oracle(u_times, v_times, tau=1.0):
    """Direct double-sum closed form over spike times in seconds."""
    def term(a, b):
        if len(a) == 0 or len(b) == 0:
            return 0.0
        return np.sum(np.exp(-np.abs(a[:, None] - b[None, :]) / tau))
    return np.sqrt(max(term(u_times, u_times) + term(v_times, v_times)
                       - 2 * term(u_times, v_times), 0.0))


def test_van_rossum_matches_closed_form(spikes):
    D = np.asarray(sm.van_rossum_distance(spikes))
    times = [np.nonzero(s)[0] / 24.0 for s in spikes]
    for i in range(len(spikes)):
        for j in range(len(spikes)):
            assert D[i, j] == pytest.approx(_vr_oracle(times[i], times[j]),
                                            abs=2e-2)
    # metric properties
    np.testing.assert_allclose(np.diag(D), 0.0, atol=2e-2)
    np.testing.assert_allclose(D, D.T, atol=1e-5)


def test_van_rossum_single_spike_normalisation():
    """One spike vs empty train -> distance 1 (elephant convention)."""
    u = np.zeros((1, 100), np.float32)
    u[0, 50] = 1
    v = np.zeros((1, 100), np.float32)
    D = np.asarray(sm.van_rossum_distance(list(u), list(v)))
    assert D[0, 0] == pytest.approx(1.0, abs=1e-4)


def test_van_rossum_tau_limit_counts_spikes():
    """tau -> 0: distance^2 -> number of non-coincident spikes."""
    u = np.zeros((1, 200), np.float32)
    v = np.zeros((1, 200), np.float32)
    u[0, [10, 50, 90]] = 1
    v[0, [10, 120]] = 1            # one coincident, 1 + 2 unique
    D = np.asarray(sm.van_rossum_distance(list(u), list(v), tau=1e-4))
    assert D[0, 0] ** 2 == pytest.approx(3.0, abs=1e-2)


# ---------------------------------------------------------------------------
# Victor-Purpura
# ---------------------------------------------------------------------------

def _vp_oracle(u, v, q=1.0):
    """Textbook O(nm) DP in plain python."""
    n, m = len(u), len(v)
    G = np.zeros((n + 1, m + 1))
    G[:, 0] = np.arange(n + 1)
    G[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            G[i][j] = min(G[i - 1][j] + 1, G[i][j - 1] + 1,
                          G[i - 1][j - 1] + q * abs(u[i - 1] - v[j - 1]))
    return G[n][m]


def test_victor_purpura_matches_dp(rng):
    spikes = (rng.uniform(size=(5, 240)) < 0.06).astype(np.float32)
    D = np.asarray(sm.victor_purpura_distance(spikes))
    times = [np.nonzero(s)[0] / 24.0 for s in spikes]
    for i in range(5):
        for j in range(5):
            assert D[i, j] == pytest.approx(_vp_oracle(times[i], times[j]),
                                            abs=1e-4), (i, j)


def test_victor_purpura_batch_matches_per_trial(rng):
    # the eval driver's trial-batched path must equal B per-trial dispatches
    spikes = (rng.uniform(size=(3, 6, 240)) < 0.05).astype(np.float32)
    batched = np.asarray(sm.victor_purpura_distance_batch(spikes))
    assert batched.shape == (3, 6, 6)
    for b in range(3):
        single = np.asarray(sm.victor_purpura_distance(spikes[b]))
        np.testing.assert_allclose(batched[b], single, atol=1e-5)


def test_victor_purpura_empty_trains():
    a = np.zeros((1, 50), np.float32)
    b = np.zeros((1, 50), np.float32)
    b[0, [3, 7]] = 1
    D = np.asarray(sm.victor_purpura_distance(list(a), list(b)))
    assert D[0, 0] == pytest.approx(2.0)  # insert 2 spikes


# ---------------------------------------------------------------------------
# histogram KL
# ---------------------------------------------------------------------------

def _pandas_kl_oracle(real, fake, num_bins=30):
    import pandas as pd
    df = pd.DataFrame({
        "data": np.concatenate([real, fake]),
        "is_real": [True] * len(real) + [False] * len(fake)})
    df["bins"] = pd.cut(df.data, bins=num_bins, labels=np.arange(num_bins))
    rp = np.array([((df.bins == i) & df.is_real).sum()
                   for i in range(num_bins)], np.float32) / len(real)
    fp = np.array([((df.bins == i) & ~df.is_real).sum()
                   for i in range(num_bins)], np.float32) / len(fake)
    rp = np.where(rp == 0, 1e-10, rp)
    fp = np.where(fp == 0, 1e-10, fp)
    return np.sum(rp * np.log(rp / fp))


def test_histogram_kl_matches_pandas_recipe(rng):
    real = rng.normal(size=400).astype(np.float32)
    fake = rng.normal(loc=0.3, size=300).astype(np.float32)
    ours = float(sm.histogram_kl(real, fake))
    oracle = _pandas_kl_oracle(real, fake)
    assert ours == pytest.approx(oracle, rel=1e-4)


def test_kl_identical_is_zero(rng):
    x = rng.normal(size=200).astype(np.float32)
    assert float(sm.histogram_kl(x, x)) == pytest.approx(0.0, abs=1e-5)


def test_decay_kernel_scan_matches_dense_matmul(rng):
    """The scan-based K-apply must equal the explicit (T, T) decay matmul."""
    import jax.numpy as jnp
    T, rho = 200, float(np.exp(-1.0 / 24.0))
    y = rng.normal(size=(5, T)).astype(np.float32)
    idx = np.arange(T)
    K = rho ** np.abs(idx[:, None] - idx[None, :])
    expected = y @ K.astype(np.float32)
    out = np.asarray(sm._apply_decay_kernel(jnp.asarray(y), rho))
    np.testing.assert_allclose(out, expected, rtol=2e-4, atol=2e-4)
