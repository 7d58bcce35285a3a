"""Post-hoc spike-metric evaluation of a trained run.

CLI parity with ``/root/reference/compute_metrics.py:549-571`` (same flags),
re-designed for accelerators: spike deconvolution and all four statistics run as
batched on-device computations; ``--num_processors`` sizes the matplotlib
render pool instead of a metric-computation pool (figures were the real
host bottleneck), and ``--no_plots`` skips figures entirely for sweeps.
"""

import argparse
import json
import os
from time import time

import numpy as np

from calciumgan.config import Config
from calciumgan.eval import spike_eval
from calciumgan.utils import h5, io
from calciumgan.utils.summary import Summary


def main(config, with_covariance: bool = False,
         with_victor_purpura: bool = False, no_plots: bool = False):
    if not os.path.exists(config.output_dir):
        print(f"{config.output_dir} not found")
        raise SystemExit(1)

    rng = np.random.default_rng(config.seed)
    config.load()  # re-attach the training run's hparams.json
    info = io.load_generated_info(config)

    epochs = sorted(info.keys())

    # epochs whose h5 file is gone (deleted / moved run dir) can't be
    # evaluated — drop them BEFORE the default last-epoch slice so a
    # missing newest file falls back to the newest evaluable one, and
    # fail loudly when nothing remains
    missing = [e for e in epochs if not os.path.exists(info[e]["filename"])]
    if missing:
        for e in missing:
            print(f"warning: skipping epoch {e}: "
                  f"{info[e]['filename']} does not exist")
        epochs = [e for e in epochs if e not in set(missing)]
    if not epochs:
        raise FileNotFoundError(
            f"no generated epoch files found under {config.output_dir} — "
            "was the run trained with --save_generated?")
    if not config.all_epochs:
        epochs = [epochs[-1]]  # only the last generated file by default

    # clamp to the SHORTEST file in play: a crash-interrupted re-validation
    # (or a multi-host chief holding a floor+1 validation shard) can leave
    # an epoch file with fewer trials than the validation cache; indexing
    # real rows against missing fake rows would crash mid-metric
    epoch_lengths = [
        h5.get_dataset_length(info[e]["filename"], "signals") for e in epochs]
    config.num_samples = min(
        h5.get_dataset_length(config.validation_cache, "signals"),
        min(epoch_lengths), 1000)

    # randomly select neurons and trials to plot (compute_metrics.py:519-525)
    if config.num_neuron_plots >= config.num_neurons:
        config.neurons = list(range(config.num_neurons))
    else:
        config.neurons = [int(i) for i in rng.choice(
            config.num_neurons, config.num_neuron_plots, replace=False)]
    config.trials = [int(i) for i in rng.choice(
        config.num_samples, min(config.num_trial_plots, config.num_samples),
        replace=False)]

    # figures render in a process pool (the reference used its pool for
    # metric computation — compute_metrics.py:45-49; here metrics are
    # on-device and matplotlib is the bottleneck worth fanning out). On a
    # single-core host the pool only adds spawn + pickling overhead
    # (measured: 129 s pooled vs 116 s inline for 3 warm epochs at
    # 200x102x2048), so the worker count adapts to the cores available.
    workers = 0 if no_plots else min(config.num_processors,
                                     max(0, (os.cpu_count() or 1) - 1))
    summary = Summary(config, spike_metrics=True, no_plots=no_plots,
                      workers=workers)

    # real spikes are epoch-invariant: load the validation cache once
    real_spikes = spike_eval._load_spikes(config, config.validation_cache,
                                          config.num_samples)
    all_results = {}
    for epoch in epochs:
        start = time()
        if config.verbose:
            print(f"\nCompute metrics for {info[epoch]['filename']}")
        all_results[epoch] = spike_eval.compute_epoch_spike_metrics(
            config, summary, filename=info[epoch]["filename"], epoch=epoch,
            rng=rng, with_covariance=with_covariance,
            with_victor_purpura=with_victor_purpura,
            real_spikes=real_spikes)
        elapse = time() - start
        summary.scalar("elapse/spike_metrics", elapse, step=epoch)
        if config.verbose:
            print(f"{info[epoch]['filename']} took {elapse / 60:.02f} mins")
    summary.close()  # collect pooled figures into the event files

    # persist epoch -> KL scalars (the event files hold the same numbers,
    # but a JSON is what sweep tooling and notebooks actually consume) and
    # point at the best epoch per metric — WGAN KLs oscillate epoch to
    # epoch, so the argmin over the checkpointed history is the number a
    # user publishes
    metrics_path = os.path.join(config.output_dir, "metrics",
                                "metrics.json")
    os.makedirs(os.path.dirname(metrics_path), exist_ok=True)
    best = {k: min(all_results, key=lambda e: all_results[e][k])
            for k in next(iter(all_results.values()))}
    with open(metrics_path + ".tmp", "w") as f:
        json.dump({"epochs": {str(e): r for e, r in all_results.items()},
                   "best_epoch": {k: int(e) for k, e in best.items()}},
                  f, indent=2)
    os.replace(metrics_path + ".tmp", metrics_path)
    if config.verbose:
        print(f"\nwrote {metrics_path}")
        for k, e in best.items():
            print(f"\tbest {k}: epoch {e} ({all_results[e][k]:.4f})")
    return all_results


if __name__ == "__main__":
    # Defaults are SUPPRESS so Config.from_args sees exactly the flags the
    # user typed; Config.load then never clobbers them with the training
    # run's persisted values (reference contract: eval flags always win,
    # gan/utils/utils.py:78-84). Untyped flags fall back to the Config
    # dataclass defaults (same values as annotated below).
    S = argparse.SUPPRESS
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="auto",
                        choices=["cpu", "auto"],
                        help="'cpu' forces the host CPU backend")
    parser.add_argument("--output_dir", default=S, help="(default: runs)")
    parser.add_argument("--num_processors", default=S, type=int,
                        help="max worker processes for the matplotlib "
                             "render pool (metrics themselves run "
                             "on-device); capped to the available cores")
    parser.add_argument("--all_epochs", action="store_true", default=S)
    parser.add_argument("--no_plots", action="store_true", default=False,
                        help="skip all matplotlib figures; compute and "
                             "record the KL scalars only (fast sweep mode)")
    parser.add_argument("--covariance", action="store_true", default=False,
                        help="also compute covariance metrics (the "
                             "reference implements but disables these)")
    parser.add_argument("--victor_purpura", action="store_true",
                        default=False,
                        help="also compute Victor-Purpura distance metrics "
                             "(the reference implements but never calls "
                             "these)")
    parser.add_argument("--num_neuron_plots", default=S, type=int,
                        help="(default: 6)")
    parser.add_argument("--num_trial_plots", default=S, type=int,
                        help="(default: 6)")
    parser.add_argument("--plots_per_row", default=S, type=int,
                        help="(default: 3)")
    parser.add_argument("--dpi", default=S, type=int, help="(default: 120)")
    parser.add_argument("--format", default=S, choices=["pdf", "png"],
                        help="(default: pdf)")
    parser.add_argument("--verbose", default=S, type=int,
                        help="(default: 1)")
    parser.add_argument("--seed", default=12, type=int)
    args = parser.parse_args()
    if args.device == "cpu":
        import jax
        jax.config.update("jax_platforms", "cpu")
    del args.device
    # persistent XLA cache: repeat evals (e.g. per-epoch sweeps re-run after
    # a stall) skip the one-time per-shape compiles of the deconvolution and
    # metric programs
    from calciumgan.train import enable_compilation_cache
    enable_compilation_cache()

    with_covariance = args.covariance
    with_victor_purpura = args.victor_purpura
    no_plots = args.no_plots
    del args.covariance, args.victor_purpura, args.no_plots
    config = Config.from_args(args)
    main(config, with_covariance=with_covariance,
         with_victor_purpura=with_victor_purpura, no_plots=no_plots)
