"""Worker process for the 2-process multi-host CPU test.

Launched by tests/test_multihost.py: each worker initialises
``jax.distributed`` over a localhost coordinator with 4 virtual CPU devices
(2 processes x 4 devices = one 8-device mesh), runs the full training driver
end-to-end, then exercises the standalone generation CLI — executing every
``process_count() > 1`` branch (record interleave, put_batch /
make_array_from_process_local_data, local_rows replica dedup, per-process
generation shards, single-writer info.pkl / hparams / checkpoints / events).

Usage: python multihost_worker.py <pid> <nproc> <port> <data_dir> <out_dir>
           [<lc_data_dir> <lc_out_dir>]

When the optional long-context args are given, the worker additionally runs
``--time_parallelism`` training over the (data=2, time=4) mesh spanning both
processes — the multi-host x sequence-parallel composition (each process
feeds (rows x full-time) blocks; its devices hold the time slices).
"""

import os
import sys

# force the virtual CPU platform BEFORE jax initialises (tests/conftest.py
# has the same recipe)
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    data_dir, out_dir = sys.argv[4], sys.argv[5]

    jax.distributed.initialize(f"localhost:{port}", num_processes=nproc,
                               process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.device_count() == 4 * nproc
    assert jax.local_device_count() == 4

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from main import parse_args
    from calciumgan import train as train_lib
    from calciumgan.parallel import mesh as mesh_lib

    cfg = parse_args([
        "--input_dir", data_dir, "--output_dir", out_dir,
        "--batch_size", "8", "--num_units", "2", "--kernel_size", "4",
        "--noise_dim", "4", "--epochs", "2", "--n_critic", "2",
        "--model", "calciumgan", "--algorithm", "wgan-gp",
        "--save_generated", "all", "--verbose", "0"])

    # global batch 8 -> 4 local rows per process
    assert mesh_lib.local_batch_size(cfg.batch_size) == 4

    train_lib.main(cfg)

    # the data layer must have given this process a strict subset
    from calciumgan.data import pipeline
    train_ds, _ = pipeline.get_datasets(cfg)
    assert len(train_ds) < cfg.train_size, \
        f"process holds {len(train_ds)} of {cfg.train_size} records"

    # local_rows must dedup model-axis replicas and preserve row order
    mesh = mesh_lib.create_mesh(-1, 1)
    rows = np.arange(8, dtype=np.float32)[:, None]
    arr = mesh_lib.put_batch(mesh, rows[pid * 4:(pid + 1) * 4])
    back = mesh_lib.local_rows(arr)
    np.testing.assert_array_equal(back[:, 0], rows[pid * 4:(pid + 1) * 4, 0])

    # standalone generation CLI: per-process output shards
    import generate as generate_cli
    out_h5 = os.path.join(out_dir, "samples.h5")
    written = generate_cli.main(cfg, num_samples=8, out=out_h5,
                                batch_size=8)
    assert written.endswith(f".{pid:03d}"), written

    # optional: long-context (time-parallel) training across both hosts
    if len(sys.argv) > 7:
        lc_data_dir, lc_out_dir = sys.argv[6], sys.argv[7]
        lc_cfg = parse_args([
            "--input_dir", lc_data_dir, "--output_dir", lc_out_dir,
            "--batch_size", "4", "--num_units", "2", "--kernel_size", "24",
            "--noise_dim", "8", "--epochs", "1", "--n_critic", "1",
            "--model", "calciumgan", "--algorithm", "wgan-gp", "--m", "0",
            "--layer_norm", "--time_parallelism", "4",
            "--data_parallelism", "2", "--save_generated", "last",
            "--verbose", "0"])
        train_lib.main(lc_cfg)
        print(f"worker {pid} lc ok", flush=True)

    print(f"worker {pid} ok", flush=True)


if __name__ == "__main__":
    main()
