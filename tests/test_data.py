"""Data layer: TFRecord codec (incl. TensorFlow cross-validation),
segmentation golden tests against the reference logic, pipeline loading."""

import os

import numpy as np
import pytest

from calciumgan.config import Config
from calciumgan.data import pipeline, segments, tfrecord


# ---- crc32c / framing ----------------------------------------------------

def test_crc32c_known_vectors():
    # RFC 3720 test vector: 32 bytes of zeros -> 0x8A9136AA
    assert tfrecord.crc32c(b"\x00" * 32) == 0x8A9136AA
    assert tfrecord.crc32c(b"123456789") == 0xE3069283


def test_record_roundtrip(tmp_path):
    path = str(tmp_path / "x.record")
    payloads = [b"hello", b"world" * 100, b""]
    with tfrecord.TFRecordWriter(path) as w:
        for p in payloads:
            w.write(p)
    assert list(tfrecord.read_records(path, check_crc=True)) == payloads


def test_example_roundtrip():
    sig = np.arange(12, dtype=np.float32).tobytes()
    spk = np.ones(12, dtype=np.float32).tobytes()
    buf = tfrecord.encode_example({"signal": sig, "spike": spk})
    out = tfrecord.decode_example(buf)
    assert out["signal"][0] == sig
    assert out["spike"][0] == spk


def test_tensorflow_can_parse_our_records(tmp_path):
    """Byte-compatibility proof: TF parses our records and protos."""
    tf = pytest.importorskip("tensorflow")
    path = str(tmp_path / "tf.record")
    signals = np.random.default_rng(0).random((3, 8, 2)).astype(np.float32)
    spikes = (signals > 0.5).astype(np.float32)
    tfrecord.write_signal_records(path, signals, spikes, range(3))

    ds = tf.data.TFRecordDataset(path)
    desc = {"signal": tf.io.FixedLenFeature([], tf.string),
            "spike": tf.io.FixedLenFeature([], tf.string)}
    for i, raw in enumerate(ds):
        parsed = tf.io.parse_single_example(raw, desc)
        sig = np.frombuffer(parsed["signal"].numpy(),
                            np.float32).reshape(8, 2)
        np.testing.assert_array_equal(sig, signals[i])


def test_we_can_parse_tensorflow_records(tmp_path):
    tf = pytest.importorskip("tensorflow")
    path = str(tmp_path / "ref.record")
    signal = np.random.default_rng(1).random((8, 2)).astype(np.float32)
    spike = (signal > 0.5).astype(np.float32)

    def bf(v):
        return tf.train.Feature(bytes_list=tf.train.BytesList(value=[v]))

    example = tf.train.Example(features=tf.train.Features(feature={
        "signal": bf(signal.tobytes()), "spike": bf(spike.tobytes())}))
    with tf.io.TFRecordWriter(path) as w:
        w.write(example.SerializeToString())

    out = list(tfrecord.read_signal_records(path, (8, 2), (8, 2)))
    np.testing.assert_array_equal(out[0][0], signal)
    np.testing.assert_array_equal(out[0][1], spike)


# ---- segmentation --------------------------------------------------------

def test_segment_recording_matches_reference_loop(rng):
    raw = rng.random((101, 3)).astype(np.float32)
    spk = (raw > 0.5).astype(np.float32)
    sl, stride = 20, 7
    got_s, got_k = segments.segment_recording(raw, spk, sl, stride)
    # reference generate_tfrecords.py:81-89
    exp_s, exp_k, i = [], [], 0
    while i + sl < raw.shape[0]:
        exp_s.append(raw[i:i + sl])
        exp_k.append(spk[i:i + sl])
        i += stride
    np.testing.assert_array_equal(got_s, np.array(exp_s))
    np.testing.assert_array_equal(got_k, np.array(exp_k))


def test_preprocess_matches_segment_recording(rng):
    """The chunk-streaming preprocess and the small-array reference
    implementation gather through the shared window_starts — identical
    segments, so neither copy of the windowing can drift."""
    raw = rng.random((5, 301)).astype(np.float32)  # neuron-major
    spk = (raw > 0.5).astype(np.float32)
    sl, stride = 40, 9
    got_s, got_k, _ = segments.preprocess(
        {"signals": raw, "oasis": spk}, sl, stride, is_dg_data=True)
    exp_s, exp_k = segments.segment_recording(raw.T, spk.T, sl, stride)
    np.testing.assert_array_equal(got_s, exp_s)
    np.testing.assert_array_equal(got_k, exp_k)


def test_fft_roundtrip(rng):
    x = rng.random((4, 16, 3)).astype(np.float32)
    spec = segments.fft_signals(x)
    assert spec.shape == (4, 16, 6)
    back = segments.ifft_signals(spec)
    np.testing.assert_allclose(back, x, atol=1e-5)


def test_fft_per_channel_norm_roundtrip(tmp_path, rng):
    """--fft_norm per_channel: each coefficient position gets its own
    (min, max); the stored records invert back to the original calcium
    signals through the SAME reverse_preprocessing path as global norm,
    including the zero-span imaginary DC bin."""
    data = {"signals": 3 + 2 * rng.random((4, 600)).astype(np.float32),
            "oasis": np.zeros((4, 600), np.float32)}
    signals, spikes, meta = segments.preprocess(
        data, 32, 8, apply_fft=True, do_normalize=True, is_dg_data=True,
        fft_norm="per_channel")
    assert meta["signals_min"].shape == (32, 8)  # per coefficient position
    assert meta["fft_norm"] == "per_channel"
    # imag(DC) is identically 0 -> zero span; normalize must not NaN
    assert np.isfinite(signals).all()
    assert signals.min() >= 0.0 and signals.max() <= 1.0 + 1e-6

    out = str(tmp_path / "recs_pc")
    segments.write_dataset(out, signals, spikes, meta, 32, 8,
                           validation_size=8, do_normalize=True,
                           apply_fft=True, conv2d=False, verbose=0,
                           fft_norm="per_channel")
    cfg = Config(input_dir=out, batch_size=8)
    train, _ = pipeline.get_datasets(cfg)
    assert cfg.fft_norm == "per_channel"
    assert np.shape(cfg.signals_min) == (32, 8)

    # invert a stored record back to raw calcium and find it in the source
    raw = np.swapaxes(np.asarray(data["signals"]), 0, 1)
    restored = pipeline.reverse_preprocessing(
        cfg, np.asarray(train.signals[:3], np.float32))
    windows = np.lib.stride_tricks.sliding_window_view(
        raw, 32, axis=0)[::8].transpose(0, 2, 1)
    for r in restored:
        err = np.abs(windows - r[None]).max(axis=(1, 2))
        assert err.min() < 1e-3, err.min()


def test_preprocess_fft_norm_validation(rng):
    data = {"signals": rng.random((3, 200)).astype(np.float32),
            "oasis": np.zeros((3, 200), np.float32)}
    with pytest.raises(ValueError, match="per_channel"):
        segments.preprocess(data, 16, 4, do_normalize=True, is_dg_data=True,
                            fft_norm="per_channel")  # without --fft
    with pytest.raises(ValueError, match="fft_norm"):
        segments.preprocess(data, 16, 4, apply_fft=True, do_normalize=True,
                            is_dg_data=True, fft_norm="bogus")


def test_preprocess_drops_first_two_neurons(rng):
    data = {"signals": rng.random((5, 64)).astype(np.float32),
            "oasis": np.zeros((5, 64), np.float32)}
    signals, spikes, meta = segments.preprocess(
        data, sequence_length=16, stride=4, is_dg_data=False)
    assert meta["num_neurons"] == 3
    signals2, _, meta2 = segments.preprocess(
        data, sequence_length=16, stride=4, is_dg_data=True)
    assert meta2["num_neurons"] == 5


def test_preprocess_normalize_records_minmax(rng):
    data = {"signals": 3 + 2 * rng.random((4, 64)).astype(np.float32),
            "oasis": np.zeros((4, 64), np.float32)}
    signals, _, meta = segments.preprocess(
        data, 16, 4, do_normalize=True, is_dg_data=True)
    assert 0.0 <= signals.min() and signals.max() <= 1.0
    assert meta["signals_max"] > meta["signals_min"] > 0


# ---- end-to-end dataset write + load -------------------------------------

def make_dataset_dir(tmp_path, rng, n_neurons=4, T=600, sl=32, stride=8):
    data = {"signals": rng.random((n_neurons, T)).astype(np.float32),
            "oasis": (rng.random((n_neurons, T)) < 0.05).astype(np.float32)}
    signals, spikes, meta = segments.preprocess(
        data, sl, stride, do_normalize=True, is_dg_data=True)
    out = str(tmp_path / "records")
    segments.write_dataset(out, signals, spikes, meta, sl, stride,
                           validation_size=10, do_normalize=True,
                           apply_fft=False, conv2d=False, verbose=0)
    return out, signals, spikes


def test_write_and_load_roundtrip(tmp_path, rng):
    out, signals, spikes = make_dataset_dir(tmp_path, rng)
    cfg = Config(input_dir=out, batch_size=8)
    train, val = pipeline.get_datasets(cfg)
    assert cfg.train_size == len(signals) - 10
    assert len(train) == cfg.train_size
    assert len(val) == 10
    assert cfg.signal_shape == (32, 4)
    assert cfg.normalize and cfg.signals_max is not None
    assert cfg.train_steps == int(np.ceil(cfg.train_size / 8))
    # every loaded segment exists in the source tensor
    src = {signals[i].tobytes() for i in range(len(signals))}
    for s in train.signals[:5]:
        assert s.astype(np.float32).tobytes() in src


def test_batches_shuffle_and_remainder(tmp_path, rng):
    out, _, _ = make_dataset_dir(tmp_path, rng)
    cfg = Config(input_dir=out, batch_size=8)
    train, _ = pipeline.get_datasets(cfg)
    batches = list(train.batches(8, shuffle=True,
                                 rng=np.random.default_rng(0)))
    assert sum(len(b[0]) for b in batches) == len(train)
    b2 = list(train.batches(8, drop_remainder=True))
    assert all(len(b[0]) == 8 for b in b2)


def test_reverse_preprocessing_roundtrip(rng):
    cfg = Config(normalize=True, signals_min=-1.0, signals_max=3.0,
                 fft=False, conv2d=False)
    x = rng.random((2, 16, 3)).astype(np.float32)
    out = pipeline.reverse_preprocessing(cfg, x)
    np.testing.assert_allclose(out, x * 4.0 - 1.0, atol=1e-6)


def test_device_prefetcher(tmp_path, rng):
    import jax
    from calciumgan.parallel import create_mesh
    from calciumgan.parallel.mesh import put_batch
    out, _, _ = make_dataset_dir(tmp_path, rng)
    cfg = Config(input_dir=out, batch_size=8)
    train, _ = pipeline.get_datasets(cfg)
    mesh = create_mesh(data_parallelism=8)
    pf = pipeline.DevicePrefetcher(
        train.batches(8, drop_remainder=True),
        lambda a: put_batch(mesh, a))
    count = 0
    for sig, spk in pf:
        assert sig.shape == (8, 32, 4)
        count += 1
    assert count == len(train) // 8


def test_device_store_smaller_than_data_axis(rng):
    """Datasets with fewer rows than the mesh's batch-shard divisor must
    tile their pad filler (a plain ``signals[:pad]`` comes up short and
    device_put fails with an opaque shard-shape error)."""
    from calciumgan.parallel import create_mesh

    mesh = create_mesh(data_parallelism=8)
    signals = rng.random((3, 16, 2)).astype(np.float32)
    store = pipeline.DeviceStore(mesh, signals)
    assert store.rows == 3
    batch = np.asarray(store.batch(np.array([2, 0, 1, 2, 0, 1, 2, 0])))
    np.testing.assert_array_equal(
        batch, signals[[2, 0, 1, 2, 0, 1, 2, 0]])


def test_device_prefetcher_propagates_worker_errors():
    def bad_iterator():
        yield np.zeros((2, 4), np.float32)
        raise RuntimeError("boom in worker")

    import jax
    pf = pipeline.DevicePrefetcher(
        bad_iterator(), lambda a: jax.device_put(a))
    next(pf)
    with pytest.raises(RuntimeError, match="boom in worker"):
        next(pf)


def test_write_dataset_rejects_oversized_validation(tmp_path, rng):
    """A validation split larger than the dataset used to write 0 train
    segments with a NEGATIVE train_size in info.pkl (found by the round-5
    sweep prep); it must fail loudly instead."""
    import pytest
    from calciumgan.data import segments
    data = {"signals": rng.random((4, 400)).astype(np.float32),
            "oasis": (rng.random((4, 400)) < 0.05).astype(np.float32)}
    s, sp, m = segments.preprocess(data, 64, 8, do_normalize=True,
                                   is_dg_data=True)
    with pytest.raises(ValueError, match="validation_size"):
        segments.write_dataset(str(tmp_path), s, sp, m, 64, 8,
                               validation_size=10 ** 6, do_normalize=True,
                               apply_fft=False, conv2d=False, verbose=0)
