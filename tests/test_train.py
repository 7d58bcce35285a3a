"""End-to-end driver tests on a tiny synthetic dataset (8-device CPU mesh)."""

import glob
import os

import numpy as np
import pytest

from calciumgan import train as train_lib
from calciumgan.config import Config
from calciumgan.data import segments
from calciumgan.utils import h5, io


def make_dataset_dir(tmp_path, rng, n_neurons=4, T=800, sl=32, stride=8):
    data = {"signals": rng.random((n_neurons, T)).astype(np.float32),
            "oasis": (rng.random((n_neurons, T)) < 0.05).astype(np.float32)}
    signals, spikes, meta = segments.preprocess(
        data, sl, stride, do_normalize=True, is_dg_data=True)
    out = str(tmp_path / "records")
    segments.write_dataset(out, signals, spikes, meta, sl, stride,
                           validation_size=16, do_normalize=True,
                           apply_fft=False, conv2d=False, verbose=0)
    return out


def tiny_config(tmp_path, rng, **kw):
    from main import parse_args
    input_dir = make_dataset_dir(tmp_path, rng)
    argv = ["--input_dir", input_dir,
            "--output_dir", str(tmp_path / "run"),
            "--batch_size", "8", "--num_units", "2", "--kernel_size", "4",
            "--noise_dim", "4", "--epochs", "2", "--n_critic", "2",
            "--model", "calciumgan", "--algorithm", "wgan-gp",
            "--save_generated", "all", "--verbose", "0"]
    for k, v in kw.items():
        argv += [f"--{k}", str(v)]
    return parse_args(argv)


def test_main_end_to_end_and_resume(tmp_path, rng):
    cfg = tiny_config(tmp_path, rng)
    train_lib.main(cfg)

    # checkpoints written at epoch 0 and final epoch
    ckpts = glob.glob(os.path.join(cfg.output_dir, "checkpoints",
                                   "epoch-*.npz"))
    assert len(ckpts) == 2
    # hparams.json contract persisted
    assert os.path.exists(os.path.join(cfg.output_dir, "hparams.json"))
    # event files for train + validation writers
    assert glob.glob(os.path.join(cfg.output_dir, "events.out.tfevents.*"))
    assert glob.glob(os.path.join(cfg.output_dir, "validation",
                                  "events.out.tfevents.*"))
    # generated signals saved per --save_generated all (epoch 0 + last)
    gen_dir = os.path.join(cfg.output_dir, "generated")
    files = sorted(glob.glob(os.path.join(gen_dir, "epoch*_signals.h5")))
    assert [os.path.basename(f) for f in files] == [
        "epoch000_signals.h5", "epoch001_signals.h5"]
    # generated info.pkl maps epochs to files
    info = io.load_generated_info(cfg)
    assert set(info.keys()) == {0, 1}
    # validation cache with real signals + spikes
    cache = os.path.join(gen_dir, "validation.h5")
    assert h5.contains(cache, "signals") and h5.contains(cache, "spikes")
    assert h5.get_dataset_length(cache, "signals") == 16
    # saved generation matches validation size and NWC shape
    fake = h5.get(files[-1], "signals")
    assert fake.shape == (16,) + tuple(cfg.signal_shape)
    assert np.isfinite(fake).all()

    # ---- resume: 2 more epochs continue from epoch 2 ----
    from main import parse_args
    cfg2 = parse_args(["--input_dir", cfg.input_dir,
                       "--output_dir", cfg.output_dir,
                       "--batch_size", "8", "--num_units", "2",
                       "--kernel_size", "4", "--noise_dim", "4",
                       "--epochs", "4", "--n_critic", "2",
                       "--model", "calciumgan", "--algorithm", "wgan-gp",
                       "--save_generated", "all", "--verbose", "0"])
    train_lib.main(cfg2)
    assert cfg2.start_epoch == 2
    ckpts = glob.glob(os.path.join(cfg.output_dir, "checkpoints",
                                   "epoch-*.npz"))
    assert len(ckpts) == 3  # epochs 0, 1(final of run 1), 3(final of run 2)


def test_main_return_metrics(tmp_path, rng):
    cfg = tiny_config(tmp_path, rng)
    cfg.epochs = 1
    cfg.save_generated = ""
    cfg.skip_checkpoints = True
    metrics = train_lib.main(cfg, return_metrics=True)
    assert "signals_metrics/min" in metrics
    assert all(np.isfinite(v) for v in metrics.values())


def test_device_store_matches_streaming(tmp_path, rng):
    """--device_store stages signals on device and gathers batches in-graph
    (pipeline.DeviceStore); training must be bit-identical to the streaming
    DevicePrefetcher path — same shuffle source, same repeat-last-row
    filler on the ragged validation tail."""
    from main import parse_args
    data = {"signals": rng.random((4, 800)).astype(np.float32),
            "oasis": (rng.random((4, 800)) < 0.05).astype(np.float32)}
    signals, spikes, meta = segments.preprocess(
        data, 32, 8, do_normalize=True, is_dg_data=True)
    input_dir = str(tmp_path / "records")
    # validation_size 12 with batch 8 -> a ragged 4-row tail batch
    segments.write_dataset(input_dir, signals, spikes, meta, 32, 8,
                           validation_size=12, do_normalize=True,
                           apply_fft=False, conv2d=False, verbose=0)
    fakes = {}
    for mode in ("off", "on"):
        cfg = parse_args([
            "--input_dir", input_dir,
            "--output_dir", str(tmp_path / f"run_{mode}"),
            "--batch_size", "8", "--num_units", "2", "--kernel_size", "4",
            "--noise_dim", "4", "--epochs", "2", "--n_critic", "2",
            "--model", "calciumgan", "--algorithm", "wgan-gp",
            "--save_generated", "all", "--skip_checkpoints",
            "--device_store", mode, "--verbose", "0"])
        train_lib.main(cfg)
        fakes[mode] = h5.get(os.path.join(
            cfg.output_dir, "generated", "epoch001_signals.h5"), "signals")
    assert fakes["on"].shape == (12, 32, 4)
    np.testing.assert_array_equal(fakes["on"], fakes["off"])


def make_variant_dataset(tmp_path, rng, apply_fft=False, conv2d=False,
                         n_neurons=4, T=800, sl=32, stride=8,
                         fft_norm="global"):
    data = {"signals": rng.random((n_neurons, T)).astype(np.float32),
            "oasis": (rng.random((n_neurons, T)) < 0.05).astype(np.float32)}
    signals, spikes, meta = segments.preprocess(
        data, sl, stride, apply_fft=apply_fft, conv2d=conv2d,
        do_normalize=True, is_dg_data=True, fft_norm=fft_norm)
    out = str(tmp_path / "records")
    segments.write_dataset(out, signals, spikes, meta, sl, stride,
                           validation_size=16, do_normalize=True,
                           apply_fft=apply_fft, conv2d=conv2d, verbose=0,
                           fft_norm=fft_norm)
    return out


@pytest.mark.slow
def test_main_conv2d_dataset(tmp_path, rng):
    from main import parse_args
    input_dir = make_variant_dataset(tmp_path, rng, conv2d=True)
    cfg = parse_args([
        "--input_dir", input_dir, "--output_dir", str(tmp_path / "run2d"),
        "--batch_size", "8", "--num_units", "2", "--kernel_size", "4",
        "--noise_dim", "4", "--epochs", "1", "--n_critic", "1",
        "--model", "calciumgan2d", "--algorithm", "wgan-gp", "--m", "1",
        "--n", "1", "--save_generated", "last", "--skip_checkpoints",
        "--verbose", "0"])
    train_lib.main(cfg)
    assert cfg.conv2d
    fake = h5.get(os.path.join(cfg.output_dir, "generated",
                               "epoch000_signals.h5"), "signals")
    # reverse_preprocessing squeezes the conv2d channel: back to (N, W, C)
    assert fake.shape == (16, 32, 4)
    assert np.isfinite(fake).all()


def test_main_fft_dataset(tmp_path, rng):
    from main import parse_args
    input_dir = make_variant_dataset(tmp_path, rng, apply_fft=True)
    cfg = parse_args([
        "--input_dir", input_dir, "--output_dir", str(tmp_path / "runfft"),
        "--batch_size", "8", "--num_units", "2", "--kernel_size", "4",
        "--noise_dim", "4", "--epochs", "1", "--n_critic", "1",
        "--model", "calciumgan", "--algorithm", "gan",
        "--save_generated", "last", "--skip_checkpoints", "--verbose", "0"])
    train_lib.main(cfg)
    assert cfg.fft and cfg.num_channels == 8   # concat(real, imag)
    fake = h5.get(os.path.join(cfg.output_dir, "generated",
                               "epoch000_signals.h5"), "signals")
    # reverse_preprocessing applies the inverse FFT: back to (N, W, neurons)
    assert fake.shape == (16, 32, 4)
    assert np.isfinite(fake).all()


def test_main_fft_per_channel_dataset(tmp_path, rng):
    """End-to-end train on an --fft_norm per_channel dataset: the array
    (min, max) pair must thread through the in-graph metric denorm, the
    reverse-preprocessing on saved samples, and the hparams.json round-trip
    that the eval CLIs rely on."""
    from calciumgan.config import Config
    from main import parse_args
    input_dir = make_variant_dataset(tmp_path, rng, apply_fft=True,
                                     fft_norm="per_channel")
    cfg = parse_args([
        "--input_dir", input_dir, "--output_dir", str(tmp_path / "runfftpc"),
        "--batch_size", "8", "--num_units", "2", "--kernel_size", "4",
        "--noise_dim", "4", "--epochs", "1", "--n_critic", "1",
        "--model", "calciumgan", "--algorithm", "gan",
        "--save_generated", "last", "--skip_checkpoints", "--verbose", "0"])
    train_lib.main(cfg)
    assert cfg.fft and cfg.fft_norm == "per_channel"
    assert np.shape(cfg.signals_min) == tuple(cfg.signal_shape)
    fake = h5.get(os.path.join(cfg.output_dir, "generated",
                               "epoch000_signals.h5"), "signals")
    assert fake.shape == (16, 32, 4)
    assert np.isfinite(fake).all()
    # eval-CLI contract: hparams.json restores the ARRAY min/max
    reloaded = Config(output_dir=cfg.output_dir).load()
    assert reloaded.fft_norm == "per_channel"
    assert isinstance(reloaded.signals_min, np.ndarray)
    np.testing.assert_allclose(reloaded.signals_min,
                               np.asarray(cfg.signals_min), atol=1e-6)


def test_profiler_window_writes_trace(tmp_path, rng):
    from main import parse_args
    input_dir = make_variant_dataset(tmp_path, rng)
    cfg = parse_args([
        "--input_dir", input_dir, "--output_dir", str(tmp_path / "runprof"),
        "--batch_size", "8", "--num_units", "2", "--kernel_size", "4",
        "--noise_dim", "4", "--epochs", "2", "--n_critic", "1",
        "--model", "mlp", "--algorithm", "gan", "--profile",
        "--skip_checkpoints", "--verbose", "0"])
    train_lib.main(cfg)
    prof_dir = os.path.join(cfg.output_dir, "profiler")
    assert os.path.isdir(prof_dir)
    found = []
    for root, _, files in os.walk(prof_dir):
        found += files
    assert found, "profiler window produced no trace files"


def test_checkpoint_every_flag(tmp_path, rng):
    from main import parse_args
    input_dir = make_variant_dataset(tmp_path, rng)
    cfg = parse_args([
        "--input_dir", input_dir, "--output_dir", str(tmp_path / "runck"),
        "--batch_size", "8", "--num_units", "2", "--kernel_size", "4",
        "--noise_dim", "4", "--epochs", "3", "--n_critic", "1",
        "--model", "mlp", "--algorithm", "gan", "--checkpoint_every", "1",
        "--verbose", "0"])
    train_lib.main(cfg)
    ckpts = glob.glob(os.path.join(cfg.output_dir, "checkpoints",
                                   "epoch-*.npz"))
    assert len(ckpts) == 3


def test_mean_logs_weighted():
    logs = [{"a": np.float32(1.0)}, {"a": np.float32(3.0)}]
    out = train_lib._mean_logs(logs, weights=[3, 1])
    assert out["a"] == pytest.approx(1.5)
    out = train_lib._mean_logs(logs)
    assert out["a"] == pytest.approx(2.0)


@pytest.mark.slow
def test_conv2d_train_then_eval_cli(tmp_path, rng):
    """The 2-D model path end-to-end INCLUDING post-hoc evaluation."""
    from main import parse_args
    import compute_metrics
    input_dir = make_variant_dataset(tmp_path, rng, conv2d=True)
    cfg = parse_args([
        "--input_dir", input_dir, "--output_dir", str(tmp_path / "run2de"),
        "--batch_size", "8", "--num_units", "2", "--kernel_size", "4",
        "--noise_dim", "4", "--epochs", "1", "--n_critic", "1",
        "--model", "calciumgan2d", "--algorithm", "wgan-gp", "--m", "1",
        "--n", "1", "--mixed_precision", "--save_generated", "last",
        "--skip_checkpoints", "--verbose", "0"])
    train_lib.main(cfg)

    eval_cfg = Config(output_dir=cfg.output_dir, num_neuron_plots=2,
                      num_trial_plots=2, plots_per_row=2, dpi=50,
                      format="png", verbose=0, seed=12)
    results = compute_metrics.main(eval_cfg)
    (epoch,) = results.keys()
    assert {"firing_rate_kl", "correlation_kl",
            "van_rossum_kl"} <= set(results[epoch])


def test_generate_cli(tmp_path, rng):
    """Standalone generation from a checkpoint (serving path)."""
    import generate as generate_mod
    cfg = tiny_config(tmp_path, rng)
    cfg.epochs = 1
    cfg.save_generated = ""
    train_lib.main(cfg)

    gen_cfg = Config(output_dir=cfg.output_dir, verbose=0)
    out = str(tmp_path / "samples.h5")
    generate_mod.main(gen_cfg, num_samples=40, out=out, batch_size=16,
                      with_spikes=True)
    signals = h5.get(out, "signals")
    spikes = h5.get(out, "spikes")
    assert signals.shape == (40,) + tuple(cfg.signal_shape)
    assert spikes.shape == signals.shape and spikes.dtype == np.int8
    assert np.isfinite(signals).all()
    # specific-epoch restore
    generate_mod.main(Config(output_dir=cfg.output_dir, verbose=0),
                      num_samples=8, out=str(tmp_path / "s2.h5"),
                      batch_size=8, epoch=0)


def test_ab_raw_ema_view(tmp_path, rng):
    """tools/ab_raw_ema.build_raw_view produces a scoreable sibling run
    whose signals come from the RAW generator (--ema 0 override)."""
    import json
    import pickle

    from tools.ab_raw_ema import build_raw_view

    cfg = tiny_config(tmp_path, rng, ema="0.5", checkpoint_every="1")
    train_lib.main(cfg)

    out_dir = build_raw_view(cfg.output_dir, epochs=[1], num_samples=16,
                             batch_size=8)
    # the view is eval-ready: rewritten hparams + validation cache + info.pkl
    with open(os.path.join(out_dir, "hparams.json")) as f:
        hp = json.load(f)
    assert hp["output_dir"] == out_dir and hp["ema"] == 0.0
    assert os.path.exists(os.path.join(out_dir, "generated", "validation.h5"))
    with open(os.path.join(out_dir, "generated", "info.pkl"), "rb") as f:
        info = pickle.load(f)
    assert set(info.keys()) == {1}

    raw = h5.get(os.path.join(out_dir, "generated", "epoch001_signals.h5"),
                 "signals")
    # same epoch + same generation seed through the EMA (hparams) view: the
    # only difference from the raw view is averaged vs instantaneous params
    import generate as generate_mod
    ema_out = str(tmp_path / "ema_s0.h5")
    generate_mod.main(Config(output_dir=cfg.output_dir, verbose=0),
                      num_samples=16, out=ema_out, batch_size=8, epoch=1)
    ema = h5.get(ema_out, "signals")
    assert raw.shape == ema.shape
    assert np.abs(raw.astype(np.float64) - ema.astype(np.float64)).max() > 0


def test_plot_weights_path(tmp_path, rng):
    from main import parse_args
    input_dir = make_variant_dataset(tmp_path, rng)
    cfg = parse_args([
        "--input_dir", input_dir, "--output_dir", str(tmp_path / "runpw"),
        "--batch_size", "8", "--num_units", "2", "--kernel_size", "4",
        "--noise_dim", "4", "--epochs", "1", "--n_critic", "1",
        "--model", "mlp", "--algorithm", "gan", "--plot_weights",
        "--skip_checkpoints", "--verbose", "0"])
    train_lib.main(cfg)
    from calciumgan.utils.tb_reader import read_scalars
    series = read_scalars(cfg.output_dir)
    weight_tags = [t for t in series if t.startswith("plots_generator/")]
    assert weight_tags, "per-parameter weight stats missing"
