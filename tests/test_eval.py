"""End-to-end post-hoc evaluation over a tiny trained run."""

import os

import numpy as np
import pytest

from calciumgan.config import Config
from calciumgan.eval import spike_eval
from calciumgan.utils import h5
from calciumgan.utils.summary import Summary


@pytest.fixture
def fake_run(tmp_path, rng):
    """A fabricated run dir: validation cache + one generated epoch file."""
    cfg = Config(output_dir=str(tmp_path / "run"), dpi=50,
                 sequence_length=96, num_neurons=4, num_channels=4,
                 signal_shape=(96, 4), validation_size=12, batch_size=4,
                 verbose=0)
    gen_dir = os.path.join(cfg.output_dir, "generated")
    os.makedirs(gen_dir)
    cfg.generated_dir = gen_dir
    cfg.validation_cache = os.path.join(gen_dir, "validation.h5")

    def signals_with_spikes(n):
        # AR(1)-looking traces with random transients
        spikes = (rng.uniform(size=(n, 96, 4)) < 0.05).astype(np.float32)
        sig = np.zeros_like(spikes)
        for t in range(1, 96):
            sig[:, t] = 0.95 * sig[:, t - 1] + spikes[:, t]
        sig += 0.05 * rng.normal(size=sig.shape).astype(np.float32)
        return sig.astype(np.float32), spikes

    real_sig, real_spk = signals_with_spikes(12)
    h5.write(cfg.validation_cache, {"signals": real_sig,
                                    "spikes": real_spk.astype(np.int8)})
    fake_sig, _ = signals_with_spikes(12)
    epoch_file = os.path.join(gen_dir, "epoch005_signals.h5")
    h5.write(epoch_file, {"signals": fake_sig})

    cfg.num_samples = 12
    cfg.neurons = [0, 1, 2, 3]
    cfg.trials = [0, 1]
    cfg.num_neuron_plots = 4
    cfg.plots_per_row = 2
    return cfg, epoch_file


def test_compute_epoch_spike_metrics(fake_run, rng):
    cfg, epoch_file = fake_run
    summary = Summary(cfg, spike_metrics=True)
    results = spike_eval.compute_epoch_spike_metrics(
        cfg, summary, epoch_file, epoch=5, rng=rng, with_covariance=True)

    # deconvolution appended int8 spikes in NWC
    assert h5.contains(epoch_file, "spikes")
    spikes = h5.get(epoch_file, "spikes")
    assert spikes.shape == (12, 96, 4)
    assert set(np.unique(spikes)).issubset({0, 1})

    for key in ("firing_rate_kl", "correlation_kl", "van_rossum_kl",
                "covariance_kl"):
        assert key in results

    # metrics-mode plots produced
    plots = os.listdir(os.path.join(cfg.output_dir, "metrics", "plots"))
    names = {p.split(".")[0] for p in plots}
    assert {"firing_rate", "raster_plot", "van_rossum",
            "real_traces", "fake_traces"} <= names


def test_ensure_spikes_redoes_truncated_dataset(fake_run):
    """A 'spikes' dataset shorter than 'signals' (legacy run killed
    mid-append) must be dropped and fully re-deconvolved, never silently
    mis-joined."""
    cfg, epoch_file = fake_run
    short = np.zeros((5, 96, 4), np.int8)
    h5.write(epoch_file, {"spikes": short})
    spike_eval.ensure_spikes(cfg, epoch_file)
    assert h5.get_dataset_length(epoch_file, "spikes") == 12
    assert not any(k.startswith("_spikes_partial")
                   for k in h5.keys(epoch_file))
    # and a complete dataset is left untouched
    marker = h5.get(epoch_file, "spikes")
    spike_eval.ensure_spikes(cfg, epoch_file)
    np.testing.assert_array_equal(h5.get(epoch_file, "spikes"), marker)


def test_deconvolve_file_resumes_from_partial_chunks(fake_run):
    """A staged partial dataset resumes at the previous chunk boundary —
    the LAST staged chunk is always redone (an interrupted h5 append can
    leave a chunk-aligned length whose tail reads back as fill zeros)."""
    cfg, epoch_file = fake_run
    sentinel = np.full((8, 96, 4), 1, np.int8)  # two complete chunks of 4
    h5.write(epoch_file, {"_spikes_partial_c4": sentinel})
    spike_eval.deconvolve_file(cfg, epoch_file, chunk=4)
    spikes = h5.get(epoch_file, "spikes")
    assert spikes.shape == (12, 96, 4)
    # chunk 1 was kept verbatim (resume, not redo)
    np.testing.assert_array_equal(spikes[:4], sentinel[:4])
    # chunk 2 (possibly torn) and chunk 3 were actually deconvolved
    assert not np.all(spikes[4:] == 1)
    assert not h5.contains(epoch_file, "_spikes_partial_c4")


def test_deconvolve_file_restarts_on_chunk_mismatch(fake_run):
    """A partial staged under a different chunk size (e.g. a run resumed
    with another chunk) has unsound chunk boundaries and must restart."""
    cfg, epoch_file = fake_run
    h5.write(epoch_file,
             {"_spikes_partial_c16": np.full((8, 96, 4), 1, np.int8)})
    spike_eval.deconvolve_file(cfg, epoch_file, chunk=4)
    spikes = h5.get(epoch_file, "spikes")
    assert spikes.shape == (12, 96, 4)
    assert not np.all(spikes[:8] == 1)  # sentinel rows were NOT reused
    assert not h5.contains(epoch_file, "_spikes_partial_c16")


def test_compute_metrics_cli_writes_metrics_json(fake_run):
    """compute_metrics.main persists epoch -> KL scalars and the best epoch
    per metric to metrics/metrics.json (sweep tooling consumes the JSON)."""
    import json
    import pickle

    import compute_metrics

    cfg, epoch_file = fake_run
    cfg.save()  # main() re-attaches hparams.json
    with open(os.path.join(cfg.generated_dir, "info.pkl"), "wb") as f:
        pickle.dump({5: {"global_step": 50, "filename": epoch_file}}, f)
    cfg.all_epochs = True
    results = compute_metrics.main(cfg, no_plots=True)
    assert 5 in results
    path = os.path.join(cfg.output_dir, "metrics", "metrics.json")
    with open(path) as f:
        saved = json.load(f)
    assert saved["epochs"]["5"]["correlation_kl"] == pytest.approx(
        results[5]["correlation_kl"])
    assert saved["best_epoch"]["van_rossum_kl"] == 5


def test_sort_heatmap_minimum_top_left(rng):
    m = rng.uniform(size=(6, 6)).astype(np.float32)
    heatmap, rows, cols = spike_eval.sort_heatmap(m)
    assert heatmap[0, 0] == m.min()
    # every row/column used exactly once
    assert sorted(rows) == list(range(6))
    assert sorted(cols) == list(range(6))
    # reconstruction: heatmap[i] is matrix[rows[i]] permuted by cols
    np.testing.assert_array_equal(heatmap[2], m[rows[2]][cols])


def test_chunked_matches_unchunked(rng):
    import jax.numpy as jnp
    x = rng.normal(size=(37, 8)).astype(np.float32)
    out = spike_eval.chunked(lambda a: jnp.asarray(a) * 2.0, x, chunk=16)
    np.testing.assert_allclose(out, x * 2.0, rtol=1e-6)
