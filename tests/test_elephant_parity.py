"""Pin the Elephant conventions the published KL numbers depend on.

The reference's statistics ARE Elephant calls over Neo SpikeTrains built at
24 Hz (``/root/reference/gan/utils/spike_metrics.py:6-61``,
``spike_helper.py:8-20``). Elephant cannot be installed in this environment
(zero egress), so these tests pin the conventions with *literal* golden
values hand-derived from Elephant's definitions (elephant 0.6-0.9 era API —
the reference uses the pre-rename ``binsize=`` / ``corrcoef`` surface):

- ``train_to_neo``: spike times = frame/24 s, t_start=0, t_stop=T/24 s
  (duration from the array length, NOT the last spike).
- ``mean_firing_rate`` = n_spikes / (t_stop - t_start).
- ``BinnedSpikeTrain(binsize=500ms)``: floor(T_s/0.5) bins of 12 frames;
  spikes in the ragged tail are dropped. ``corrcoef``/``covariance`` are
  plain Pearson / np.cov (ddof=1) over the bin-count matrix.
- ``van_rossum_dist`` (tau=1 s default): D^2 = sum_uu + sum_vv - 2 sum_uv
  of exp(-|dt|/tau) over spike pairs, with NO 1/2 factor — Elephant's own
  tau=0 special case returns sqrt(n_u + n_v), i.e. one non-coincident spike
  costs exactly 1.
- ``victor_purpura_dist`` (cost factor q=1 Hz default): edit-distance DP,
  per-spike insert/delete cost 1, shift cost q*|dt| (capped at 2 by the DP).
"""

import numpy as np

from calciumgan.ops import spike_metrics as sm


def train(T, frames):
    out = np.zeros(T, np.float32)
    out[list(frames)] = 1.0
    return out


# ---------------------------------------------------------------------------
# firing rate — duration is T/framerate, not the last spike time
# ---------------------------------------------------------------------------

def test_mean_firing_rate_literal():
    spikes = train(240, [0, 10, 100])  # 10 s at 24 Hz, 3 spikes
    rate = float(sm.mean_firing_rate(spikes[None])[0])
    np.testing.assert_allclose(rate, 0.3, rtol=1e-6)  # 3 / 10 s

    # duration from array length: moving the last spike does not change it
    rate2 = float(sm.mean_firing_rate(train(240, [0, 10, 239])[None])[0])
    np.testing.assert_allclose(rate2, 0.3, rtol=1e-6)


# ---------------------------------------------------------------------------
# 500 ms binning — 12 frames/bin at 24 Hz, ragged tail dropped
# ---------------------------------------------------------------------------

def test_binning_literal():
    # T=30 frames = 1.25 s -> exactly 2 bins; frames 24..29 are dropped
    spikes = train(30, [0, 11, 12, 25])
    counts = np.asarray(sm.bin_spike_counts(spikes[None]))[0]
    np.testing.assert_array_equal(counts, [2, 1])  # spike at 25 dropped


def test_binned_correlation_literal():
    # bins A=[2,1], B=[1,3] -> Pearson r = -1 (two points, opposite slopes)
    a = train(30, [0, 11, 12])
    b = train(30, [3, 13, 14, 15])
    r = np.asarray(sm.correlation_coefficients(np.stack([a, b])))
    np.testing.assert_allclose(r, [[1.0, -1.0], [-1.0, 1.0]], atol=1e-6)


def test_binned_covariance_literal():
    # cov(A=[2,1], B=[1,3]) with ddof=1: var A=0.5, var B=2, cov=-1
    a = train(30, [0, 11, 12])
    b = train(30, [3, 13, 14, 15])
    c = np.asarray(sm.covariance(np.stack([a, b])))
    np.testing.assert_allclose(c, [[0.5, -1.0], [-1.0, 2.0]], atol=1e-6)


# ---------------------------------------------------------------------------
# van Rossum — tau=1 s default, NO 1/2 factor, times on the 24 Hz grid
# ---------------------------------------------------------------------------

def test_van_rossum_single_spike_costs_one():
    u = train(48, [0])
    v = train(48, [])
    d = float(sm.van_rossum_distance(np.stack([u, v]))[0, 1])
    np.testing.assert_allclose(d, 1.0, atol=1e-6)


def test_van_rossum_one_second_apart_literal():
    # spikes 1 s apart: D = sqrt(2 - 2 e^{-1}) = 1.1243848
    u = train(72, [0])
    v = train(72, [24])
    d = float(sm.van_rossum_distance(np.stack([u, v]))[0, 1])
    np.testing.assert_allclose(d, np.sqrt(2.0 - 2.0 * np.exp(-1.0)),
                               atol=1e-6)


def test_van_rossum_small_tau_matches_elephant_tau0_convention():
    # Elephant's tau=0 special case: D = sqrt(n_u + n_v)
    u = train(48, [0, 20])
    v = train(48, [10])
    d = float(sm.van_rossum_distance(np.stack([u, v]), tau=1e-4)[0, 1])
    np.testing.assert_allclose(d, np.sqrt(3.0), atol=1e-4)


def test_van_rossum_identical_trains_zero():
    u = train(48, [3, 17, 40])
    d = np.asarray(sm.van_rossum_distance(np.stack([u, u])))
    np.testing.assert_allclose(d, 0.0, atol=1e-4)


# ---------------------------------------------------------------------------
# Victor-Purpura — q = 1/s default
# ---------------------------------------------------------------------------

def test_victor_purpura_literals():
    T = 96  # 4 s
    u0 = train(T, [0])
    shift_half = train(T, [12])   # 0.5 s away: shift cost 0.5
    empty = train(T, [])          # delete cost 1
    far = train(T, [60])          # 2.5 s away: insert+delete = 2 < q*dt
    two = train(T, [0, 24])       # extra spike: delete cost 1

    batch = np.stack([u0, shift_half, empty, far, two])
    d = np.asarray(sm.victor_purpura_distance(batch))
    np.testing.assert_allclose(d[0, 1], 0.5, atol=1e-6)
    np.testing.assert_allclose(d[0, 2], 1.0, atol=1e-6)
    np.testing.assert_allclose(d[0, 3], 2.0, atol=1e-6)
    np.testing.assert_allclose(d[0, 4], 1.0, atol=1e-6)
    np.testing.assert_allclose(np.diag(d), 0.0, atol=1e-6)


# ---------------------------------------------------------------------------
# the reference's concatenate-and-slice cross-block pattern
# ---------------------------------------------------------------------------

def test_cross_block_slice_matches_reference_pattern(rng):
    # the reference always compares equal-sized real/fake trial sets; its
    # slice result[len(s1):, :len(s2)] is (fake rows x real cols) then
    real = (rng.random((3, 48)) < 0.1).astype(np.float32)
    fake = (rng.random((3, 48)) < 0.1).astype(np.float32)
    both = np.concatenate([real, fake], axis=0)
    full = np.asarray(sm.van_rossum_distance(both))
    cross = np.asarray(sm.van_rossum_distance(real, fake))
    np.testing.assert_allclose(cross, full[len(real):, :len(fake)], atol=1e-5)
