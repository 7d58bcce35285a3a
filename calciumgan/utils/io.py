"""Generated-sample artefacts and hparams persistence.

Contract parity with ``/root/reference/gan/utils/utils.py:93-113``: per saved
epoch an ``epoch{E:03d}_signals.h5`` file (denormalised NWC float32 signals)
plus ``generated/info.pkl`` mapping epoch -> {global_step, filename}, consumed
by the metrics CLIs.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from calciumgan.data.pipeline import reverse_preprocessing
from calciumgan.utils import h5


def save_fake_signals(config, epoch: int, signals, append: bool = True) -> str:
    """``append=False`` on an epoch's FIRST batch: a crash-resumed run that
    re-validates an already-saved epoch must replace the file — h5.write
    appends to existing datasets, which would silently double every row."""
    import jax
    signals = reverse_preprocessing(config, np.asarray(signals))
    # multi-host: each process appends its rows to its own shard file so
    # concurrent writers never clobber each other on a shared filesystem
    suffix = (f".{jax.process_index():03d}"
              if jax.process_count() > 1 else "")
    filename = os.path.join(config.generated_dir,
                            f"epoch{epoch:03d}_signals.h5{suffix}")
    if not append and os.path.exists(filename):
        os.remove(filename)
    h5.write(filename, {"signals": signals.astype(np.float32)})

    # info.pkl is maintained by process 0 only (a shared-filesystem
    # read-modify-write from every host would race); it references process
    # 0's shard, which the eval CLIs consume
    if jax.process_index() == 0:
        info_filename = os.path.join(config.generated_dir, "info.pkl")
        info = {}
        if os.path.exists(info_filename):
            with open(info_filename, "rb") as f:
                info = pickle.load(f)
        entry = {"global_step": config.global_step, "filename": filename}
        if info.get(epoch) != entry:  # new epoch, or re-run after resume
            info[epoch] = entry
            tmp = info_filename + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(info, f)
            os.replace(tmp, info_filename)
    return filename


def load_generated_info(config) -> dict:
    """epoch -> {global_step, filename} for every saved generation epoch."""
    path = os.path.join(config.output_dir, "generated", "info.pkl")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found — train with --save_generated first")
    with open(path, "rb") as f:
        return pickle.load(f)


def cache_validation_set(config, validation) -> None:
    """One-time dump of the denormalised validation set (signals float32,
    spikes int8) to ``generated/validation.h5`` so the metrics CLIs can read
    real data cheaply (``dataset_helper.py:12-30``).

    Multi-host: process 0 is the single writer and caches its local record
    shard (a uniform subset of the validation set — records are interleaved
    across processes by the data layer); concurrent appends to one h5 from
    many hosts would corrupt it."""
    import jax
    if jax.process_index() != 0:
        return
    if config.validation_cache is None or \
            os.path.exists(config.validation_cache):
        return
    # stage + atomic rename: the batch loop appends incrementally, and a
    # run killed mid-loop must not leave a truncated cache that the
    # exists() guard above would silently reuse forever
    tmp = config.validation_cache + ".tmp"
    if os.path.exists(tmp):
        os.remove(tmp)
    for signals, spikes in validation.batches(config.batch_size):
        h5.write(tmp, {
            "signals": reverse_preprocessing(config, signals).astype(
                np.float32),
            "spikes": spikes.astype(np.int8),
        })
    os.replace(tmp, config.validation_cache)
