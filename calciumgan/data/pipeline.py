"""Input pipeline: dataset loading and device prefetch.

Replaces the reference's tf.data graph (``gan/utils/dataset_helper.py``):
interleave(TFRecord) -> parse -> cache -> shuffle -> batch -> prefetch(4).
The reference caches the decoded dataset in host RAM anyway, so here shards
are decoded once into contiguous numpy arrays (sharded per host process for
multi-host meshes), shuffled with an explicit numpy RNG per epoch, and
batches are staged onto the device mesh by a double-buffered background
prefetcher (the host->device copy of batch k+1 overlaps step k).
"""

from __future__ import annotations

import glob
import os
import pickle
import queue
import threading
from math import ceil
from typing import Iterator, Optional, Tuple

import jax
import numpy as np

from calciumgan.data import segments as seg
from calciumgan.data import tfrecord


class ArrayDataset:
    """An in-memory (signals, spikes) dataset with epoch iteration."""

    def __init__(self, signals: np.ndarray, spikes: np.ndarray):
        assert len(signals) == len(spikes)
        self.signals = signals
        self.spikes = spikes

    def __len__(self):
        return len(self.signals)

    def batches(self, batch_size: int, shuffle: bool = False,
                rng: Optional[np.random.Generator] = None,
                drop_remainder: bool = False
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self)
        order = np.arange(n)
        if shuffle:
            (rng or np.random.default_rng()).shuffle(order)
        end = n - n % batch_size if drop_remainder else n
        for i in range(0, end, batch_size):
            idx = order[i:i + batch_size]
            yield self.signals[idx], self.spikes[idx]

    def steps(self, batch_size: int, drop_remainder: bool = False) -> int:
        if drop_remainder:
            return len(self) // batch_size
        return ceil(len(self) / batch_size)


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------

def load_info(input_dir: str) -> dict:
    with open(os.path.join(input_dir, "info.pkl"), "rb") as f:
        return pickle.load(f)


def apply_dataset_info(config, info: dict) -> None:
    """Copy dataset metadata onto the config
    (parity: ``dataset_helper.py:113-144``)."""
    config.train_files = os.path.join(config.input_dir, "train-*.record")
    config.validation_files = os.path.join(config.input_dir,
                                           "validation-*.record")
    for key in ("train_size", "validation_size", "sequence_length",
                "num_neurons", "num_channels", "num_train_shards",
                "num_validation_shards", "buffer_size", "normalize", "fft",
                "conv2d"):
        setattr(config, key, info[key])
    config.signal_shape = tuple(info["signal_shape"])
    config.spike_shape = tuple(info["spike_shape"])
    config.fft_norm = info.get("fft_norm", "global")
    if config.normalize:
        # per-channel fft norm stores one (min, max) PER coefficient
        # position — arrays shaped like signal_shape; global norm scalars
        if np.ndim(info["signals_min"]):
            config.signals_min = np.asarray(info["signals_min"], np.float32)
            config.signals_max = np.asarray(info["signals_max"], np.float32)
        else:
            config.signals_min = float(info["signals_min"])
            config.signals_max = float(info["signals_max"])
    if config.save_generated:
        config.generated_dir = os.path.join(config.output_dir, "generated")
        os.makedirs(config.generated_dir, exist_ok=True)
        config.validation_cache = os.path.join(config.generated_dir,
                                               "validation.h5")


def _read_shards(pattern: str, signal_shape, spike_shape,
                 process_index: int = 0, process_count: int = 1
                 ) -> ArrayDataset:
    all_files = sorted(glob.glob(pattern))
    if not all_files:
        raise FileNotFoundError(f"no record files match {pattern}")

    # decoded-array cache (the tf.data cache() analog — the reference
    # decodes records once per run and caches in RAM,
    # ``dataset_helper.py:171``): first decode persists signals/spikes as
    # .npy next to the records; later runs (e.g. checkpoint resumes) memmap
    # them instantly instead of re-decoding gigabytes of protobuf
    newest = max(os.path.getmtime(f) for f in all_files)
    tag = os.path.basename(pattern).split("-")[0].rstrip("*")
    cache_base = os.path.join(
        os.path.dirname(pattern),
        f".{tag}.cache-{process_index:03d}-of-{process_count:03d}")
    sig_npy, spk_npy = cache_base + ".signals.npy", cache_base + ".spikes.npy"
    if (os.path.exists(sig_npy) and os.path.exists(spk_npy)
            # BOTH files must postdate the records: a run killed between
            # the two os.replace calls below leaves fresh signals paired
            # with stale spikes, which lengths alone would not catch
            and min(os.path.getmtime(sig_npy),
                    os.path.getmtime(spk_npy)) >= newest):
        return ArrayDataset(np.load(sig_npy, mmap_mode="r"),
                            np.load(spk_npy, mmap_mode="r"))
    # multi-host: record-level interleaving over ALL shards — every process
    # holds floor(global/P) or floor+1 records, which is what the uniform
    # per-process step count in train._epoch_steps relies on. (A shard-level
    # split would be cheaper to decode but can mis-balance by a whole shard
    # — or starve a process entirely when shards < processes — and a starved
    # process deadlocks the collectives. The decoded subset is cached per
    # process, so the redundant decode is one-time.)
    signals, spikes = [], []
    i = 0
    for path in all_files:
        for signal, spike in tfrecord.read_signal_records(
                path, signal_shape, spike_shape):
            if i % process_count == process_index:
                signals.append(signal)
                spikes.append(spike)
            i += 1
    if not signals:
        raise ValueError(
            f"process {process_index}/{process_count} received no records "
            f"for {pattern}")
    signals, spikes = np.stack(signals), np.stack(spikes)
    try:  # best-effort cache write (atomic; tmp names unique per writer —
        # search.py --parallel threads decode concurrently and a shared tmp
        # path could promote a torn file)
        uid = f".tmp.{os.getpid()}.{threading.get_ident()}.npy"
        np.save(sig_npy + uid, signals)
        np.save(spk_npy + uid, spikes)
        os.replace(sig_npy + uid, sig_npy)
        os.replace(spk_npy + uid, spk_npy)
    except OSError:
        pass
    return ArrayDataset(signals, spikes)


def load_tfrecord_datasets(config) -> Tuple[ArrayDataset, ArrayDataset]:
    if not os.path.exists(config.input_dir):
        raise FileNotFoundError(
            f"input directory {config.input_dir} cannot be found")
    info = load_info(config.input_dir)
    apply_dataset_info(config, info)
    train = _read_shards(config.train_files, config.signal_shape,
                         config.spike_shape, jax.process_index(),
                         jax.process_count())
    validation = _read_shards(config.validation_files, config.signal_shape,
                              config.spike_shape, jax.process_index(),
                              jax.process_count())
    return train, validation


def load_surrogate_datasets(config) -> Tuple[ArrayDataset, ArrayDataset]:
    """Surrogate pickle path (parity: ``dataset_helper.py:54-110``):
    transpose to (trial, time, neuron), min-max normalise, split at 8192."""
    filename = os.path.join(config.input_dir, "training.pkl")
    if not os.path.exists(filename):
        raise FileNotFoundError(f"training dataset {filename} not found")
    with open(filename, "rb") as f:
        data = pickle.load(f)

    signals = np.transpose(data["signals"], (0, 2, 1)).astype(np.float32)
    config.signals_min = float(np.min(signals))
    config.signals_max = float(np.max(signals))
    signals = (signals - config.signals_min) / (
        config.signals_max - config.signals_min)
    spikes = np.asarray(data["spikes"], np.float32)

    # reference splits at 8192 but records the ACTUAL split length
    # (dataset_helper.py:78-82: train_size = len(signals[:8192])) — a
    # smaller pickle must not inflate train_size past the data
    train_size = min(8192, len(signals))
    config.train_size = train_size
    config.validation_size = len(signals) - train_size

    # multi-host: each process keeps an interleaved subset of rows (config
    # sizes above stay GLOBAL — the driver derives step counts from them)
    pi, pc = jax.process_index(), jax.process_count()
    train = ArrayDataset(signals[:train_size][pi::pc],
                         spikes[:train_size][pi::pc])
    validation = ArrayDataset(signals[train_size:][pi::pc],
                              spikes[train_size:][pi::pc])
    config.signal_shape = train.signals.shape[1:]
    config.spike_shape = spikes.shape[1:]
    config.sequence_length = train.signals.shape[1]
    config.num_neurons = train.signals.shape[-1]
    config.num_channels = train.signals.shape[-1]
    config.normalize = True
    config.fft = False
    config.conv2d = False
    if config.save_generated:
        config.generated_dir = os.path.join(config.output_dir, "generated")
        os.makedirs(config.generated_dir, exist_ok=True)
        config.validation_cache = os.path.join(config.generated_dir,
                                               "validation.h5")
    return train, validation


def get_datasets(config) -> Tuple[ArrayDataset, ArrayDataset]:
    """Top-level dispatch (parity: ``dataset_helper.py:185-206``)."""
    config.noise_shape = (config.noise_dim,)
    if config.surrogate_ds:
        train, validation = load_surrogate_datasets(config)
    else:
        train, validation = load_tfrecord_datasets(config)
    config.train_steps = ceil(config.train_size / config.batch_size)
    config.validation_steps = ceil(
        config.validation_size / config.batch_size)
    return train, validation


# ---------------------------------------------------------------------------
# reverse preprocessing (parity: utils.py:49-63)
# ---------------------------------------------------------------------------

def denormalize(x, x_min, x_max):
    return x * (x_max - x_min) + x_min


def reverse_preprocessing(config, x: np.ndarray) -> np.ndarray:
    x = np.asarray(x)
    if config.normalize:
        x = denormalize(x, config.signals_min, config.signals_max)
    if config.conv2d:
        if config.fft:
            x = np.concatenate((x[..., 0], x[..., 1]), axis=-1)
        else:
            x = np.squeeze(x, axis=-1)
    if config.fft:
        x = seg.ifft_signals(x)
    return x


# ---------------------------------------------------------------------------
# device-resident signal store
# ---------------------------------------------------------------------------

class DeviceStore:
    """Device-resident training signals with on-device batch gather.

    Staging the signals array on device ONCE and gathering each batch
    in-graph cuts host->device traffic to one upload per run plus a tiny
    int32 index vector per step, instead of a ~100 MB batch crossing the
    host link every step (the recipe's 128 x 2048 x 102 float32). Rows are padded to the mesh's batch-shard
    divisor (pad rows are never indexed); the gather's output carries the
    exact batch sharding the jitted steps expect, so no resharding happens
    at step boundaries.

    Used when the array fits ``config.device_store_mb`` on a single
    process; the streaming :class:`DevicePrefetcher` remains the fallback
    (multi-host feeds per-process rows, which a global device gather does
    not compose with).
    """

    def __init__(self, mesh, signals: np.ndarray):
        from calciumgan.parallel import mesh as mesh_lib

        signals = np.asarray(signals)
        self.rows = len(signals)
        pad = -self.rows % mesh_lib.data_extent(mesh)
        if pad:  # tile: datasets smaller than the data axis need repeats
            reps = -(-pad // self.rows)
            filler = np.concatenate([signals] * reps, axis=0)[:pad]
            signals = np.concatenate([signals, filler], axis=0)
        sharding = mesh_lib.batch_sharding(mesh, signals.ndim)
        self._store = jax.device_put(signals, sharding)
        self._gather = jax.jit(lambda store, idx: store[idx],
                               out_shardings=sharding)

    @property
    def nbytes(self) -> int:
        return self._store.nbytes

    def batch(self, idx: np.ndarray):
        """Device batch ``signals[idx]`` (batch-sharded, dispatch is
        async so consecutive calls pipeline with the training steps)."""
        return self._gather(self._store, np.asarray(idx, np.int32))


def device_store_enabled(config, nbytes: int) -> bool:
    """``auto``: single process + default backend is a real accelerator +
    the arrays fit the configured HBM budget. ``on``/``off`` force it."""
    mode = getattr(config, "device_store", "auto")
    if mode == "off":
        return False
    if jax.process_count() > 1:
        if mode == "on":
            raise ValueError("--device_store on requires a single process "
                             "(multi-host feeds per-process rows)")
        return False
    if mode == "on":
        return True
    budget = int(getattr(config, "device_store_mb", 4096)) * 2**20
    return jax.default_backend() != "cpu" and nbytes <= budget


# ---------------------------------------------------------------------------
# device prefetch
# ---------------------------------------------------------------------------

class DevicePrefetcher:
    """Stages host batches onto the mesh from a background thread.

    Wraps a numpy batch iterator; ``device_put`` of batch k+1 overlaps the
    computation consuming batch k (the reference used tf.data
    ``prefetch(4)`` — ``dataset_helper.py:174``).
    """

    def __init__(self, iterator, put, depth: int = 2):
        """``put``: callable array -> on-device Array (e.g. a closure over
        :func:`calciumgan.parallel.mesh.put_batch`), or a Sharding for a
        plain ``device_put``."""
        self._iterator = iterator
        self._put_fn = put
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, a):
        a = np.asarray(a)
        if callable(self._put_fn):
            return self._put_fn(a)
        return jax.device_put(a, self._put_fn)

    def _worker(self):
        try:
            for item in self._iterator:
                if isinstance(item, tuple):
                    put = tuple(self._put(a) for a in item)
                else:
                    put = self._put(item)
                self._q.put(put)
        except Exception as e:  # surface worker errors to the consumer
            self._q.put(e)
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item
