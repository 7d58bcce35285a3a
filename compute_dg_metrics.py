"""DG-experiment fidelity metrics: firing rate + covariance of real vs
generated data, MAE / RMSE / MAPE summary.

CLI parity with ``/root/reference/compute_dg_metrics.py:204-216`` (same
flags); statistics are computed on-device for all trials at once instead of a
tqdm loop with Neo conversions (``:40-58``).
"""

import argparse
import os
import warnings

import jax
import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

from calciumgan.config import Config  # noqa: E402
from calciumgan.ops import spike_metrics as sm  # noqa: E402
from calciumgan.eval.spike_eval import ensure_spikes  # noqa: E402
from calciumgan.utils import h5, io  # noqa: E402

REAL_COLOR, FAKE_COLOR = "dodgerblue", "orangered"


def get_data_statistics(config, filename):
    """(num_neurons, num_trials) firing rates and (P, num_trials) binned
    upper-triangle covariances (k=0), NaN -> 0
    (parity: ``compute_dg_metrics.py:40-58``)."""
    from calciumgan.utils import arrays
    # infer the on-disk layout from metadata, then read only the
    # num_trials rows actually used when the trial axis leads — reading
    # the whole dataset to keep 5 trials costs GBs on production runs
    fmt = arrays.get_array_format(h5.get_shape(filename, "spikes"), config)
    if fmt[0] == "N":
        raw = h5.get(filename, "spikes", start=0, stop=config.num_trials)
    else:
        raw = h5.get(filename, "spikes")
    perm = [fmt.index(s) for s in "NWC"]
    spikes = np.transpose(np.asarray(raw, np.float32), perm)
    spikes = spikes[:config.num_trials]                   # (N, W, C)
    spikes_ncw = np.transpose(spikes, (0, 2, 1))          # (N, C, W)
    rates = np.asarray(jax.device_get(
        jax.vmap(sm.mean_firing_rate)(spikes_ncw)))       # (N, C)

    iu = np.triu_indices(config.num_neurons)

    def one_cov(trial_cw):
        return sm.covariance(trial_cw)[iu]

    covs = np.asarray(jax.device_get(jax.vmap(one_cov)(spikes_ncw)))
    return rates.T.astype(np.float32), np.nan_to_num(covs.T).astype(
        np.float32)


def _scatter_plot(config, filename, real, fake, order, xlabel, ylabel,
                  tick_step, legend=None):
    real = real[order].flatten("F")
    fake = fake[order].flatten("F")
    x = np.tile(np.arange(len(order)), config.num_trials)

    fig = plt.figure(figsize=(8, 6))
    fig.patch.set_facecolor("white")
    ax = plt.gca()
    ax.scatter(x, real, marker="o", color=REAL_COLOR, alpha=0.6)
    ax.scatter(x, fake, marker="x", color=FAKE_COLOR, alpha=0.6)
    ax.set_xticks(list(range(0, len(order), tick_step)))
    ax.set_xticklabels(order[::tick_step], rotation=90)
    ax.spines["top"].set_visible(False)
    ax.spines["right"].set_visible(False)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    if legend:
        ax.legend(labels=legend, loc="upper left", frameon=False)
    plt.tight_layout()
    plt.savefig(filename, dpi=120, format=config.format, transparent=True)
    plt.close()
    print(f"saved figure to {filename}")


def plot_firing_rate(config, filename, real, fake):
    order = np.argsort(np.mean(real, axis=-1))
    _scatter_plot(config, filename, real, fake, order,
                  xlabel="Neuron", ylabel="Firing rate", tick_step=5,
                  legend=["DG", "CalciumGAN"])


def plot_covariance(config, filename, real, fake):
    order = np.argsort(np.mean(real, axis=-1))[::10]  # every 10th pair
    _scatter_plot(config, filename, real, fake, order,
                  xlabel="Neuron Pair", ylabel="Covariance", tick_step=20)


def percentage_error(y_true, y_pred):
    """Reference semantics: zero targets fall back to y_pred / mean(y_true)
    (``compute_dg_metrics.py:148-156``)."""
    error = np.empty(y_true.shape)
    nonzero = y_true != 0.0
    error[nonzero] = (y_true[nonzero] - y_pred[nonzero]) / y_true[nonzero]
    error[~nonzero] = y_pred[~nonzero] / np.mean(y_true)
    return error


def mean_absolute_percentage_error(y_true, y_pred):
    errors = np.stack([percentage_error(y_true[..., i], y_pred[..., i])
                       for i in range(y_true.shape[1])], axis=-1)
    return float(np.mean(np.mean(np.abs(errors), axis=0), axis=0)) * 100


def main(config):
    if not os.path.exists(config.output_dir):
        print(f"{config.output_dir} not found")
        raise SystemExit(1)

    config.load()
    info = io.load_generated_info(config)
    epochs = sorted(info.keys())
    fake_file = info[epochs[-1]]["filename"]

    config.num_samples = h5.get_dataset_length(config.validation_cache,
                                               "signals")
    ensure_spikes(config, fake_file)

    real_fr, real_cov = get_data_statistics(config, config.validation_cache)
    fake_fr, fake_cov = get_data_statistics(config, fake_file)

    if config.save_plots:
        os.makedirs("diagrams", exist_ok=True)
        plot_firing_rate(
            config, os.path.join("diagrams",
                                 f"dg_firing_rate.{config.format}"),
            real=real_fr, fake=fake_fr)
        plot_covariance(
            config, os.path.join("diagrams",
                                 f"dg_covariance.{config.format}"),
            real=real_cov, fake=fake_cov)

    fr_mae = np.mean(np.abs(real_fr - fake_fr))
    fr_rmse = np.sqrt(np.mean(np.square(real_fr - fake_fr)))
    fr_mape = mean_absolute_percentage_error(real_fr, fake_fr)
    print(f"\nmean firing rate\n\tMAE\t{fr_mae:.02f}"
          f"\n\tRMSE\t{fr_rmse:.02f}\n\tMAPE\t{fr_mape:.02f}%")

    cov_mae = np.mean(np.abs(real_cov - fake_cov))
    cov_mse = np.mean(np.square(real_cov - fake_cov))
    cov_mape = mean_absolute_percentage_error(real_cov, fake_cov)
    print(f"\ncovariance\n\tMAE\t{cov_mae:.02f}\n\tMSE\t{cov_mse:.02f}"
          f"\n\tMAPE\t{cov_mape:.02f}%")

    return {"firing_rate": {"mae": float(fr_mae), "rmse": float(fr_rmse),
                            "mape": fr_mape},
            "covariance": {"mae": float(cov_mae), "mse": float(cov_mse),
                           "mape": cov_mape}}


if __name__ == "__main__":
    # SUPPRESS defaults: only typed flags reach Config.from_args, so
    # Config.load never clobbers them (eval flags always win)
    S = argparse.SUPPRESS
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="auto",
                        choices=["cpu", "auto"],
                        help="'cpu' forces the host CPU backend")
    parser.add_argument("--output_dir", default=S, type=str,
                        help="(default: runs)")
    parser.add_argument("--num_trials", default=S, type=int,
                        help="(default: 5)")
    parser.add_argument("--save_plots", action="store_true", default=S)
    parser.add_argument("--format", default=S, choices=["pdf", "png"],
                        help="(default: pdf)")
    args = parser.parse_args()
    if args.device == "cpu":
        import jax
        jax.config.update("jax_platforms", "cpu")
    del args.device

    warnings.simplefilter(action="ignore", category=UserWarning)
    warnings.simplefilter(action="ignore", category=RuntimeWarning)

    main(Config.from_args(args))
