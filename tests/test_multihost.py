"""Real multi-host execution: 2 jax.distributed processes on CPU.

Every ``process_count() > 1`` branch would otherwise be dead code in CI.
This test spawns two subprocesses that initialise ``jax.distributed``
over a localhost coordinator (4 virtual CPU devices each -> one 8-device
global mesh) and run the training driver + generation CLI end-to-end
(tests/multihost_worker.py). The parent asserts the single-writer and
per-process-shard artifact contracts.

The reference has no distributed support at all (SURVEY.md §2.10, §5.8).
"""

import glob
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from calciumgan.data import segments
from calciumgan.utils import h5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_training(tmp_path, rng):
    # dataset built once by the parent; both workers read it
    data = {"signals": rng.random((4, 800)).astype(np.float32),
            "oasis": (rng.random((4, 800)) < 0.05).astype(np.float32)}
    signals, spikes, meta = segments.preprocess(
        data, 32, 8, do_normalize=True, is_dg_data=True)
    data_dir = str(tmp_path / "records")
    segments.write_dataset(data_dir, signals, spikes, meta, 32, 8,
                           validation_size=16, do_normalize=True,
                           apply_fft=False, conv2d=False, verbose=0)
    out_dir = str(tmp_path / "run")

    # long-sequence dataset for the multi-host x time-parallel composition
    lc_data = {"signals": rng.random((3, 6000)).astype(np.float32),
               "oasis": (rng.random((3, 6000)) < 0.05).astype(np.float32)}
    lc_signals, lc_spikes, lc_meta = segments.preprocess(
        lc_data, 1024, 512, do_normalize=True, is_dg_data=True)
    lc_data_dir = str(tmp_path / "lc_records")
    segments.write_dataset(lc_data_dir, lc_signals, lc_spikes, lc_meta,
                           1024, 512, validation_size=8, do_normalize=True,
                           apply_fft=False, conv2d=False, verbose=0)
    lc_out_dir = str(tmp_path / "lc_run")

    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}

    def launch():
        port = _free_port()
        procs = [
            subprocess.Popen(
                [sys.executable, worker, str(pid), "2", str(port), data_dir,
                 out_dir, lc_data_dir, lc_out_dir],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env)
            for pid in range(2)
        ]
        # one shared deadline (not 900 s PER worker), and ALWAYS reap both
        # processes — a deadlocked collective would otherwise leak workers
        # that hold the rendezvous port for the rest of the session
        deadline = time.monotonic() + 900
        try:
            return [p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0]
                for p in procs], procs
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()

    outputs, procs = launch()
    if any(p.returncode != 0 for p in procs) and any(
            "Gloo context initialization failed" in o for o in outputs):
        # Gloo's cross-worker rendezvous has a fixed ~30 s deadline with no
        # user-exposed knob; on a heavily loaded shared host one worker can
        # miss it while the other is still compiling. Retry once for that
        # specific environment failure only — real breakage still fails.
        import shutil
        for d in (out_dir, lc_out_dir):
            shutil.rmtree(d, ignore_errors=True)
        outputs, procs = launch()
    for pid, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"worker {pid} ok" in out
        assert f"worker {pid} lc ok" in out

    # --- single-writer artifacts: exactly one of each --------------------
    # hparams.json (process 0 only, atomic)
    assert os.path.exists(os.path.join(out_dir, "hparams.json"))
    assert not glob.glob(os.path.join(out_dir, "hparams.json.tmp"))
    # checkpoints: one file per epoch, no leftover tmp
    ckpts = sorted(glob.glob(os.path.join(out_dir, "checkpoints",
                                          "epoch-*.npz")))
    assert [os.path.basename(c) for c in ckpts] == [
        "epoch-000.npz", "epoch-001.npz"]
    assert not glob.glob(os.path.join(out_dir, "checkpoints", "*.tmp"))
    # events: only the chief writes (one train + one validation file)
    assert len(glob.glob(os.path.join(out_dir, "events.out.tfevents.*"))) == 1
    assert len(glob.glob(os.path.join(out_dir, "validation",
                                      "events.out.tfevents.*"))) == 1
    # validation cache: single h5
    assert os.path.exists(os.path.join(out_dir, "generated", "validation.h5"))

    # --- per-process shards ----------------------------------------------
    gen_dir = os.path.join(out_dir, "generated")
    for epoch in (0, 1):
        shards = sorted(glob.glob(
            os.path.join(gen_dir, f"epoch{epoch:03d}_signals.h5.*")))
        assert [s.rsplit(".", 1)[1] for s in shards] == ["000", "001"], shards
        for s in shards:  # every shard holds real rows
            assert h5.get_dataset_length(s, "signals") > 0
    # info.pkl single-writer, references process 0's shard
    import pickle
    with open(os.path.join(gen_dir, "info.pkl"), "rb") as f:
        info = pickle.load(f)
    assert set(info.keys()) == {0, 1}
    assert info[1]["filename"].endswith("epoch001_signals.h5.000")

    # generation CLI shards
    for pid in range(2):
        shard = os.path.join(out_dir, f"samples.h5.{pid:03d}")
        assert os.path.exists(shard), shard
        assert h5.get_dataset_length(shard, "signals") == 4  # 8 rows / 2

    # --- long-context (data=2 x time=4) run across both hosts ------------
    lc_ckpts = glob.glob(os.path.join(lc_out_dir, "checkpoints",
                                      "epoch-*.npz"))
    assert len(lc_ckpts) == 1
    lc_shards = sorted(glob.glob(
        os.path.join(lc_out_dir, "generated", "epoch000_signals.h5.*")))
    assert [s.rsplit(".", 1)[1] for s in lc_shards] == ["000", "001"]
    for s in lc_shards:
        fake = h5.get(s, "signals")
        # time-sharded outputs reassembled into complete sequences
        assert fake.shape[1:] == (1024, 3)
        assert np.isfinite(fake).all()

    # --- both processes trained the same number of steps ------------------
    # (mismatched step counts would deadlock a collective and time out above;
    # reaching here with rc=0 on both is the proof)
