"""Tests for the infrastructure layer: h5 IO, TensorBoard event writing,
checkpoint/resume, array-format conversion, summary plots."""

import glob
import os
import struct

import numpy as np
import pytest

from calciumgan.config import Config
from calciumgan.data.tfrecord import read_records, _walk
from calciumgan.utils import arrays, checkpoint, h5
from calciumgan.utils.summary import Summary
from calciumgan.utils.tb import EventWriter


# ---------------------------------------------------------------------------
# h5
# ---------------------------------------------------------------------------

def test_h5_write_append_get(tmp_path):
    path = str(tmp_path / "x.h5")
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    h5.write(path, {"signals": a})
    h5.write(path, {"signals": a + 100})  # append
    out = h5.get(path, "signals")
    assert out.shape == (4, 3, 4)
    np.testing.assert_array_equal(out[:2], a)
    np.testing.assert_array_equal(out[2:], a + 100)
    assert h5.get_dataset_length(path, "signals") == 4
    assert h5.contains(path, "signals")
    assert not h5.contains(path, "nope")
    # neuron / trial slicing (NWC)
    np.testing.assert_array_equal(
        h5.get(path, "signals", neuron=1), out[:, :, 1])
    np.testing.assert_array_equal(
        h5.get(path, "signals", trial=3), out[3])
    h5.overwrite(path, "signals", a)
    assert h5.get(path, "signals").shape == (2, 3, 4)
    with pytest.raises(KeyError):
        h5.get(path, "missing")


# ---------------------------------------------------------------------------
# TensorBoard event files
# ---------------------------------------------------------------------------

def _read_scalars(logdir):
    """Parse scalar events back out of the event file with the proto codec."""
    files = glob.glob(os.path.join(logdir, "events.out.tfevents.*"))
    assert len(files) == 1
    scalars = {}
    for record in read_records(files[0], check_crc=True):
        step, pairs = 0, []
        for field, wire, v in _walk(record):
            if field == 2 and wire == 0:
                step = v
            elif field == 5 and wire == 2:  # Summary
                for f2, _, val_buf in _walk(v):
                    if f2 != 1:
                        continue
                    # tag/value are PER Summary.Value item — resetting per
                    # record would cross-pair a later tag with an earlier
                    # value in multi-value events
                    tag, value = None, None
                    for f3, w3, item in _walk(val_buf):
                        if f3 == 1:
                            tag = item.decode()
                        elif f3 == 2 and w3 == 5:
                            (value,) = struct.unpack("<f", item)
                    if tag is not None and value is not None:
                        pairs.append((tag, value))
        for tag, value in pairs:
            scalars[(tag, step)] = value
    return scalars


def test_event_writer_scalars_roundtrip(tmp_path):
    logdir = str(tmp_path / "logs")
    w = EventWriter(logdir)
    w.scalar("loss/generator", 1.5, step=3)
    w.scalar("loss/discriminator", -2.25, step=4)
    w.histogram("weights", np.random.default_rng(0).normal(size=100), step=1)
    w.image("fig", b"\x89PNG fake", height=4, width=5, step=2)
    w.close()
    scalars = _read_scalars(logdir)
    assert scalars[("loss/generator", 3)] == pytest.approx(1.5)
    assert scalars[("loss/discriminator", 4)] == pytest.approx(-2.25)


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------

def _tiny_state():
    import jax
    from calciumgan.algorithms.registry import get_algorithm
    from calciumgan.models.registry import get_models
    cfg = Config(model="mlp", algorithm="gan", noise_dim=4, num_units=4,
                 sequence_length=8, num_neurons=2, num_channels=2,
                 signal_shape=(8, 2), normalize=True, signals_min=0.0,
                 signals_max=1.0)
    gen, dis = get_models(cfg)
    algo = get_algorithm(cfg, gen, dis)
    return cfg, algo, algo.init_state(jax.random.PRNGKey(0))


def test_checkpoint_roundtrip_and_resume(tmp_path):
    import jax
    cfg, algo, state = _tiny_state()
    cfg.output_dir = str(tmp_path)
    cfg.ckpt_dir = str(tmp_path / "checkpoints")
    cfg.global_step = 42

    checkpoint.save(cfg.ckpt_dir, 9, state, config=cfg, verbose=0)
    assert checkpoint.latest_epoch(cfg.ckpt_dir) == 9

    # mutate, then restore into the template
    zeroed = jax.tree_util.tree_map(lambda x: x * 0, state)
    restored, epoch = checkpoint.restore(cfg.ckpt_dir, zeroed, verbose=0)
    assert epoch == 9
    orig = jax.tree_util.tree_leaves(jax.device_get(state))
    rest = jax.tree_util.tree_leaves(jax.device_get(restored))
    for a, b in zip(orig, rest):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    cfg.global_step = 0
    cfg.start_epoch = 0
    resumed = checkpoint.resume(cfg, zeroed)
    assert cfg.start_epoch == 10
    assert cfg.global_step == 42
    rest = jax.tree_util.tree_leaves(jax.device_get(resumed))
    for a, b in zip(orig, rest):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _strip_ema_key(path):
    """Rewrite a checkpoint as an ema-less file (no ema_params leaves)."""
    with np.load(path) as archive:
        d = {k: archive[k] for k in archive.files
             if not k.startswith("ema_params/")}
    with open(path, "wb") as f:
        np.savez(f, **d)


@pytest.mark.parametrize("pre_feature", [False, True])
def test_resume_seeds_ema_from_ema_less_checkpoint(tmp_path, pre_feature):
    """Enabling --ema on a run checkpointed without it (either an ema-off
    run of the current code or a pre-feature checkpoint with no ema_params
    key at all) must resume by seeding the EMA from the restored generator
    params, not crash on the structure mismatch."""
    import jax
    cfg, algo, state = _tiny_state()
    assert state.ema_params is None
    cfg.output_dir = str(tmp_path)
    cfg.ckpt_dir = str(tmp_path / "checkpoints")
    cfg.global_step = 7
    checkpoint.save(cfg.ckpt_dir, 3, state, config=cfg, verbose=0)
    if pre_feature:
        _strip_ema_key(checkpoint.checkpoint_path(cfg.ckpt_dir, 3))

    cfg.ema = 0.999
    from calciumgan.algorithms.registry import get_algorithm
    algo2 = get_algorithm(cfg, algo.generator, algo.discriminator)
    template = algo2.init_state(jax.random.PRNGKey(1))
    assert template.ema_params is not None
    cfg.start_epoch = 0
    resumed = checkpoint.resume(cfg, template)
    assert cfg.start_epoch == 4
    for a, b in zip(jax.tree_util.tree_leaves(resumed.ema_params),
                    jax.tree_util.tree_leaves(resumed.generator.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # and the restored params are the checkpointed ones, not the template's
    for a, b in zip(jax.tree_util.tree_leaves(resumed.generator.params),
                    jax.tree_util.tree_leaves(state.generator.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_restore_pre_ema_checkpoint_with_ema_off(tmp_path):
    """The conv2d/fft runs' existing checkpoints (written before the ema
    field existed) must keep restoring byte-identically with ema off."""
    import jax
    cfg, algo, state = _tiny_state()
    cfg.ckpt_dir = str(tmp_path / "checkpoints")
    checkpoint.save(cfg.ckpt_dir, 0, state, config=cfg, verbose=0)
    _strip_ema_key(checkpoint.checkpoint_path(cfg.ckpt_dir, 0))
    zeroed = jax.tree_util.tree_map(lambda x: x * 0, state)
    restored, epoch = checkpoint.restore(cfg.ckpt_dir, zeroed, verbose=0)
    assert epoch == 0 and restored.ema_params is None
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(restored)),
                    jax.tree_util.tree_leaves(jax.device_get(state))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_restore_ema_checkpoint_with_ema_off(tmp_path):
    """Disabling --ema on resume drops the stored average (raw params are
    the state) instead of failing the structural restore."""
    import jax
    cfg, algo, state = _tiny_state()
    cfg.ema = 0.9
    from calciumgan.algorithms.registry import get_algorithm
    algo2 = get_algorithm(cfg, algo.generator, algo.discriminator)
    ema_state = algo2.init_state(jax.random.PRNGKey(2))
    cfg.ckpt_dir = str(tmp_path / "checkpoints")
    checkpoint.save(cfg.ckpt_dir, 0, ema_state, config=cfg, verbose=0)
    restored, epoch = checkpoint.restore(cfg.ckpt_dir, state, verbose=0)
    assert epoch == 0 and restored.ema_params is None


def test_resume_without_checkpoint(tmp_path):
    cfg, algo, state = _tiny_state()
    cfg.output_dir = str(tmp_path)
    cfg.ckpt_dir = None
    out = checkpoint.resume(cfg, state)
    assert cfg.start_epoch == 0
    assert out is state


# ---------------------------------------------------------------------------
# array formats
# ---------------------------------------------------------------------------

def test_array_format_roundtrip():
    cfg = Config(sequence_length=16, num_neurons=3, validation_size=5)
    x = np.random.default_rng(0).normal(size=(5, 16, 3))
    assert arrays.get_array_format(x.shape, cfg) == "NWC"
    cnw = arrays.set_array_format(x, "CNW", cfg)
    assert cnw.shape == (3, 5, 16)
    back = arrays.set_array_format(cnw, "NWC", cfg)
    np.testing.assert_array_equal(back, x)
    # neuron-major swap
    y = np.zeros((5, 3, 7))
    assert arrays.swap_neuron_major(cfg, y).shape == (3, 5, 7)


def test_array_format_rejects_colliding_batch_dim():
    """A batch/trial dim equal to num_neurons (or sequence_length) makes the
    layout inference ambiguous — it must raise, not silently transpose."""
    cfg = Config(sequence_length=16, num_neurons=3, validation_size=3)
    with pytest.raises(ValueError, match="ambiguous"):
        arrays.get_array_format((3, 16, 3), cfg)  # N == C == 3


def test_save_fake_signals_replaces_on_epoch_rerun(tmp_path):
    """A crash-resumed run that re-validates an already-saved epoch must
    REPLACE the epoch file (h5 writes append): append=False on the first
    batch, append=True within the epoch."""
    from calciumgan.utils import io as io_utils

    cfg = Config(output_dir=str(tmp_path), normalize=False, fft=False,
                 conv2d=False, global_step=10)
    cfg.generated_dir = str(tmp_path / "generated")
    os.makedirs(cfg.generated_dir)
    x = np.random.default_rng(0).random((4, 8, 2)).astype(np.float32)
    io_utils.save_fake_signals(cfg, 3, x, append=False)
    io_utils.save_fake_signals(cfg, 3, x, append=True)  # same-epoch batch 2
    path = os.path.join(cfg.generated_dir, "epoch003_signals.h5")
    assert len(h5.get(path, "signals")) == 8
    cfg.global_step = 20  # resumed run re-validates the epoch
    io_utils.save_fake_signals(cfg, 3, x, append=False)
    assert len(h5.get(path, "signals")) == 4  # replaced, not 12
    info = io_utils.load_generated_info(cfg)
    assert info[3]["global_step"] == 20  # stale entry refreshed


def test_remove_nan():
    a = np.array([1.0, np.nan, 2.0])
    np.testing.assert_array_equal(arrays.remove_nan(a), [1.0, 2.0])


# ---------------------------------------------------------------------------
# config load semantics
# ---------------------------------------------------------------------------

def test_config_load_fills_unset_and_defaults(tmp_path):
    train_cfg = Config(output_dir=str(tmp_path), verbose=0, batch_size=128,
                       sequence_length=2048)
    train_cfg.save()
    eval_cfg = Config(output_dir=str(tmp_path))
    eval_cfg.load()
    # None fields and default-holding fields are filled from the file
    assert eval_cfg.sequence_length == 2048
    assert eval_cfg.batch_size == 128
    assert eval_cfg.verbose == 0


def test_config_load_never_clobbers_explicit_cli_flags(tmp_path):
    """Eval flags always win — even when the typed value equals the default
    (reference contract: gan/utils/utils.py:78-84)."""
    import argparse
    train_cfg = Config(output_dir=str(tmp_path), verbose=0, dpi=300)
    train_cfg.save()

    parser = argparse.ArgumentParser()
    parser.add_argument("--output_dir", default=argparse.SUPPRESS)
    parser.add_argument("--verbose", default=argparse.SUPPRESS, type=int)
    parser.add_argument("--dpi", default=argparse.SUPPRESS, type=int)
    # user explicitly types --verbose 1 (the dataclass default!)
    args = parser.parse_args(
        ["--output_dir", str(tmp_path), "--verbose", "1"])
    cfg = Config.from_args(args)
    cfg.load()
    assert cfg.verbose == 1      # explicit flag survives
    assert cfg.dpi == 300        # untyped flag restored from the run


def test_generate_ema_override_survives_load(tmp_path):
    """``generate.py --ema`` marks the value explicit so ``load()`` cannot
    clobber it with the run's trained value — the raw/EMA eval A/B knob."""
    train_cfg = Config(output_dir=str(tmp_path), ema=0.999)
    train_cfg.save()

    # no override: the run's trained --ema is restored
    cfg = Config(output_dir=str(tmp_path))
    cfg.load()
    assert cfg.ema == 0.999

    # --ema 0 typed at generation time (generate.py:109-111) wins, even
    # though 0.0 is the dataclass default
    cfg = Config(output_dir=str(tmp_path))
    cfg.ema = 0.0
    cfg._explicit.add("ema")
    cfg.load()
    assert cfg.ema == 0.0


# ---------------------------------------------------------------------------
# h5 staging helpers
# ---------------------------------------------------------------------------

def test_h5_delete_truncate_rename(tmp_path):
    path = str(tmp_path / "x.h5")
    a = np.arange(24, dtype=np.float32).reshape(6, 4)
    h5.write(path, {"stage": a, "old": a[:2]})
    h5.truncate(path, "stage", 4)
    assert h5.get_dataset_length(path, "stage") == 4
    h5.rename(path, "stage", "old")  # replaces existing dst
    np.testing.assert_array_equal(h5.get(path, "old"), a[:4])
    assert not h5.contains(path, "stage")
    h5.delete(path, "old")
    assert not h5.contains(path, "old")
    h5.delete(path, "old")  # no-op when absent


# ---------------------------------------------------------------------------
# summary plots (smoke: files are produced and parse as events)
# ---------------------------------------------------------------------------

def test_summary_plots_smoke(tmp_path):
    cfg = Config(output_dir=str(tmp_path / "run"), dpi=60)
    os.makedirs(cfg.output_dir, exist_ok=True)
    s = Summary(cfg)
    rng = np.random.default_rng(0)
    signals = rng.normal(size=(4, 64))
    spikes = (rng.uniform(size=(4, 64)) > 0.9).astype(np.float32)
    s.scalar("loss/generator", 1.0, step=0)
    s.plot_traces("traces", signals, spikes, indexes=[0, 1, 2])
    s.raster_plot("raster", spikes, spikes, legend_labels=["r", "f"])
    s.plot_histogram("hist", (signals[0], signals[1]))
    s.plot_histograms_grid("grid", [(signals[0], signals[1])] * 2,
                           titles=["a", "b"], legend_labels=["r", "f"])
    s.plot_heatmaps_grid("heat", [np.abs(rng.normal(size=(6, 6)))] * 2,
                         titles=["a", "b"])
    s.plot_distribution("dist", signals[0])
    s.flush()
    assert glob.glob(os.path.join(cfg.output_dir, "events.out.tfevents.*"))
    assert glob.glob(os.path.join(cfg.output_dir, "plots", "*.png"))


def test_summary_pool_mode_renders_figures(tmp_path):
    """workers>0 renders in a spawn pool; close() collects every figure."""
    cfg = Config(output_dir=str(tmp_path / "run"), dpi=60)
    os.makedirs(cfg.output_dir, exist_ok=True)
    s = Summary(cfg, spike_metrics=True, workers=2)
    rng = np.random.default_rng(0)
    s.plot_distribution("dist_a", rng.uniform(size=50), step=1)
    s.plot_histograms_grid("grid", [(rng.normal(size=20),
                                     rng.normal(size=20))] * 2,
                           titles=["a", "b"], step=1)
    s.scalar("kl", 0.5, step=1)
    s.close()
    plots_dir = os.path.join(cfg.output_dir, "metrics", "plots")
    names = {p.split("_step")[0] for p in os.listdir(plots_dir)
             if p.endswith(".png")}
    assert {"dist_a", "grid"} <= names
    # vector sidecars too
    assert os.path.exists(os.path.join(plots_dir, "dist_a.pdf"))


def test_summary_no_plots_mode(tmp_path):
    cfg = Config(output_dir=str(tmp_path / "run"), dpi=60)
    os.makedirs(cfg.output_dir, exist_ok=True)
    s = Summary(cfg, spike_metrics=True, no_plots=True)
    s.plot_distribution("dist", np.random.default_rng(0).uniform(size=50))
    s.scalar("kl", 0.5, step=1)
    s.close()
    assert not glob.glob(
        os.path.join(cfg.output_dir, "metrics", "plots", "*.png"))
    assert glob.glob(
        os.path.join(cfg.output_dir, "metrics", "events.out.tfevents.*"))


def test_summary_metrics_mode(tmp_path):
    cfg = Config(output_dir=str(tmp_path / "run"), dpi=60)
    os.makedirs(cfg.output_dir, exist_ok=True)
    cfg.extras["format"] = "pdf"
    s = Summary(cfg, spike_metrics=True)
    s.scalar("spike_metrics/firing_rate", 0.5, step=1)
    s.plot_distribution("fr", np.random.default_rng(0).uniform(size=50))
    s.flush()
    assert os.path.isdir(os.path.join(cfg.output_dir, "metrics", "plots"))


def test_event_files_readable_by_real_tensorboard(tmp_path):
    """Cross-validation against the actual TensorBoard reader (skipped when
    the tensorboard package is not installed)."""
    ea = pytest.importorskip(
        "tensorboard.backend.event_processing.event_accumulator")
    logdir = str(tmp_path / "tb")
    w = EventWriter(logdir)
    w.scalar("a/b", 1.5, step=3)
    w.histogram("h", np.random.default_rng(0).normal(size=200), step=1)
    w.image("img/0", b"\x89PNG-not-really", height=4, width=5, step=2)
    w.close()
    acc = ea.EventAccumulator(logdir, size_guidance={
        "scalars": 0, "histograms": 0, "images": 0})
    acc.Reload()
    assert acc.Tags()["scalars"] == ["a/b"]
    s = acc.Scalars("a/b")[0]
    assert (s.step, s.value) == (3, 1.5)
    assert acc.Histograms("h")[0].histogram_value.num == 200.0
    img = acc.Images("img/0")[0]
    assert (img.width, img.height) == (5, 4)


def test_tb_reader_roundtrip(tmp_path):
    from calciumgan.utils import tb_reader
    logdir = str(tmp_path / "r")
    w = EventWriter(logdir)
    w.scalar("loss", 2.0, step=1)
    w.scalar("loss", 1.0, step=2)
    w.scalar("acc", 0.5, step=2)
    w.close()
    series = tb_reader.read_scalars(logdir)
    assert series["loss"] == {1: 2.0, 2: 1.0}
    assert tb_reader.last_value(logdir, "loss") == (2, 1.0)
    with pytest.raises(KeyError):
        tb_reader.last_value(logdir, "nope")


def test_hparams_plugin_protos_parse_with_tensorboard(tmp_path):
    pd = pytest.importorskip("tensorboard.plugins.hparams.plugin_data_pb2")
    from calciumgan.data.tfrecord import read_records, _walk
    logdir = str(tmp_path / "hp")
    w = EventWriter(logdir)
    w.hparams_config({"noise_dim": [4, 8], "model": ["mlp"],
                      "layer_norm": [True]}, ["test/m"])
    w.hparams({"noise_dim": 8, "model": "mlp", "layer_norm": True},
              group_name="001")
    w.close()
    found = {}
    for rec in read_records(glob.glob(logdir + "/events.*")[0],
                            check_crc=True):
        for field, _, v in _walk(rec):
            if field != 5:
                continue
            for f2, _, vb in _walk(v):
                if f2 != 1:
                    continue
                tag, content = None, None
                for f3, _, item in _walk(vb):
                    if f3 == 1:
                        tag = item.decode()
                    elif f3 == 9:
                        for f4, _, pdata in _walk(item):
                            if f4 == 1:
                                for f5, _, x in _walk(pdata):
                                    if f5 == 2:
                                        content = x
                if tag and content is not None:
                    found[tag] = content
    exp = pd.HParamsPluginData.FromString(found["_hparams_/experiment"])
    names = {h.name: h.type for h in exp.experiment.hparam_infos}
    assert names == {"noise_dim": 3, "model": 1, "layer_norm": 2}
    assert [m.name.tag for m in exp.experiment.metric_infos] == ["test/m"]
    ssi = pd.HParamsPluginData.FromString(
        found["_hparams_/session_start_info"]).session_start_info
    assert ssi.group_name == "001"
    assert ssi.hparams["noise_dim"].number_value == 8.0
    assert ssi.hparams["model"].string_value == "mlp"
    assert ssi.hparams["layer_norm"].bool_value is True
