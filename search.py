"""Hyper-parameter grid search.

Parity with ``/root/reference/search.py:83-187``: same default grid
(noise_dim x num_units x kernel_size x phase_shuffle), per-experiment
isolation (a failure logs and continues), resume by skipping existing output
dirs, and per-experiment ``test/*`` metrics written to a ``test`` event-file
dir. Fixes two reference defects (SURVEY.md §2.11.2): the grid's model name
(``wavegan`` was renamed ``calciumgan``) and the never-applied
``phase_shuffle`` value (now wired to ``m``/``n``). Results are additionally
appended to ``<output_dir>/results.jsonl`` for machine consumption.
"""

import argparse
import itertools
import json
import os
import threading
import traceback
import warnings
from shutil import rmtree
from time import time

from calciumgan.config import Config
from calciumgan.utils.tb import EventWriter

DEFAULT_GRID = {
    "algorithm": ["wgan-gp"],
    "model": ["calciumgan"],
    "activation": ["leakyrelu"],
    "noise_dim": [4, 8, 16],
    "num_units": [8, 16, 32],
    "kernel_size": [2, 3, 4],
    "strides": [1],
    "phase_shuffle": [0, 1],
    "gradient_penalty": [10.0],
    "n_critic": [5],
}


def experiment_config(args, session: int, params: dict) -> Config:
    cfg = Config(
        input_dir=args.input_dir,
        output_dir=os.path.join(
            args.output_dir,
            "{:03d}_{}_units{}_kl{}_strides{}_ps{}_{}_nd{}".format(
                session, params["model"], params["num_units"],
                params["kernel_size"], params["strides"],
                params["phase_shuffle"], params["activation"],
                params["noise_dim"])),
        batch_size=args.batch_size,
        num_units=params["num_units"],
        kernel_size=params["kernel_size"],
        strides=params["strides"],
        m=params["phase_shuffle"],
        n=params["phase_shuffle"],
        epochs=args.epochs,
        dropout=0.2,
        learning_rate=1e-4,
        noise_dim=params["noise_dim"],
        gradient_penalty=params["gradient_penalty"],
        model=params["model"],
        activation=params["activation"],
        layer_norm=True,
        algorithm=params["algorithm"],
        n_critic=params["n_critic"],
        save_generated="last",
        mixed_precision=args.mixed_precision,
        verbose=args.verbose,
    )
    cfg.surrogate_ds = "surrogate" in args.input_dir
    return cfg


def run_experiment(config: Config, session: int, params: dict,
                   devices=None) -> dict:
    from calciumgan.train import main as train

    print(f"\nExperiment {session:03d}\n"
          "-----------------------------------------")
    for key, value in params.items():
        print(f"\t{key}: {value}")

    metrics = train(config, return_metrics=True, devices=devices)

    writer = EventWriter(os.path.join(config.output_dir, "test"))
    # per-trial values for the TensorBoard HParams dashboard
    # (reference search.py:78 hp.hparams(...))
    writer.hparams(params, group_name=f"{session:03d}")
    for key, item in metrics.items():
        writer.scalar(f"test/{key}", item, step=config.epochs + 1)
    writer.close()
    return metrics


def _run_one(args, results_path, lock, session, params, devices=None):
    config = experiment_config(args, session, params)
    if os.path.exists(config.output_dir):
        print(f"Experiment {config.output_dir} already exists")
        return
    try:
        start = time()
        metrics = run_experiment(config, session, params, devices=devices)
        elapse = time() - start
        print(f"\nExperiment {session:03d} completed "
              f"in {elapse / 3600:.2f}hrs\n")
        with lock, open(results_path, "a") as f:
            f.write(json.dumps({
                "session": session, "params": params,
                "metrics": {k: float(v) for k, v in metrics.items()},
                "elapse": elapse}) + "\n")
    except Exception as e:
        print(f"\nExperiment {session:03d} ERROR: {e}")
        if args.verbose:
            traceback.print_exc()


def search(args):
    if args.clear_output_dir and os.path.exists(args.output_dir):
        rmtree(args.output_dir)
    os.makedirs(args.output_dir, exist_ok=True)

    grid = dict(DEFAULT_GRID)
    if getattr(args, "grid", None):
        overrides = json.loads(args.grid)
        unknown = set(overrides) - set(grid)
        if unknown:
            raise ValueError(f"--grid keys not in the sweep space: "
                             f"{sorted(unknown)} (valid: {sorted(grid)})")
        grid.update(overrides)
    results_path = os.path.join(args.output_dir, "results.jsonl")

    # sweep schema for the TensorBoard HParams dashboard
    # (reference search.py:98-112 hp.hparams_config(...))
    schema_writer = EventWriter(args.output_dir)
    schema_writer.hparams_config(grid, [
        "test/signals_metrics/min", "test/signals_metrics/max",
        "test/signals_metrics/mean", "test/signals_metrics/std"])
    schema_writer.close()

    lock = threading.Lock()
    names = list(grid.keys())
    sessions = [(s, dict(zip(names, values))) for s, values in enumerate(
        itertools.product(*grid.values()), start=1)]

    parallel = getattr(args, "parallel", 1)
    if parallel <= 1:
        for session, params in sessions:
            _run_one(args, results_path, lock, session, params)
    else:
        # experiment parallelism over the device mesh:
        # the sweep is split over `parallel` worker threads, each training
        # on its own contiguous slice of the visible devices; jax dispatch
        # releases the GIL so experiments overlap on-chip
        import jax
        devices = jax.devices()
        if len(devices) % parallel:
            raise ValueError(f"{len(devices)} devices not divisible by "
                             f"--parallel {parallel}")
        per = len(devices) // parallel
        queue_lock = threading.Lock()
        it = iter(sessions)

        def worker(idx):
            subset = devices[idx * per:(idx + 1) * per]
            while True:
                with queue_lock:
                    item = next(it, None)
                if item is None:
                    return
                _run_one(args, results_path, lock, item[0], item[1],
                         devices=subset)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(parallel)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    print(f"\nExperiment completed, TensorBoard log at {args.output_dir}")


def summarize(output_dir: str, sort_by: str = "signals_metrics/mean",
              top: int = 20):
    """Print the sweep ranked by a test metric (ascending)."""
    path = os.path.join(output_dir, "results.jsonl")
    if not os.path.exists(path):
        print(f"{path} not found")
        return []
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    rows.sort(key=lambda r: r["metrics"].get(sort_by, float("inf")))
    print(f"{'session':>7}  {sort_by:>24}  params")
    for r in rows[:top]:
        changing = {k: v for k, v in r["params"].items()
                    if k in ("noise_dim", "num_units", "kernel_size",
                             "phase_shuffle", "strides")}
        print(f"{r['session']:>7}  {r['metrics'].get(sort_by, float('nan')):>24.6f}  "
              f"{changing}")
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_dir", default="dataset/")
    parser.add_argument("--output_dir", default="runs/hparams_turning")
    parser.add_argument("--batch_size", default=64, type=int)
    parser.add_argument("--epochs", default=400, type=int)
    parser.add_argument("--clear_output_dir", action="store_true")
    parser.add_argument("--mixed_precision", action="store_true")
    parser.add_argument("--parallel", default=1, type=int,
                        help="run N experiments concurrently, each on its "
                             "own 1/N slice of the visible devices")
    parser.add_argument("--grid", default=None, type=str,
                        help="JSON dict overriding DEFAULT_GRID entries, "
                             "e.g. '{\"noise_dim\": [4, 8]}' (unlisted keys "
                             "keep their defaults; the reference hard-codes "
                             "its grid — search.py:24-38)")
    parser.add_argument("--verbose", default=0, type=int)
    parser.add_argument("--summarize", action="store_true",
                        help="print the sweep ranked by --sort_by and exit")
    parser.add_argument("--sort_by", default="signals_metrics/mean", type=str)
    args = parser.parse_args()

    if args.verbose == 0:
        warnings.simplefilter(action="ignore", category=UserWarning)
        warnings.simplefilter(action="ignore", category=RuntimeWarning)

    if args.summarize:
        summarize(args.output_dir, sort_by=args.sort_by)
    else:
        search(args)
