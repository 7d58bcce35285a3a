"""Epoch-file spike-metric evaluation, batched on device.

Re-design of the reference's ``compute_metrics.py`` pipeline (``:35-502``):
every ``multiprocessing.Pool`` fan-out (deconvolution per neuron, firing
rate per neuron, correlation per trial, van Rossum per neuron/trial) becomes
ONE vmapped XLA computation over the whole population tensor; the host only
does h5 IO, the greedy heatmap sort, and matplotlib.
"""

from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from calciumgan.ops import spike_metrics as sm
from calciumgan.utils import arrays, h5


# ---------------------------------------------------------------------------
# deconvolution
# ---------------------------------------------------------------------------

def oasis_backend() -> str:
    """The one deconvolution backend for this process's default platform:
    ``'cuda'`` (:func:`calciumgan.ops.oasis.oasis_spikes`) on a GPU,
    ``'host'`` (the C++ OpenMP kernel) on a CPU. Both run the float64
    routine of ``native/oasis_ar1.h``, so their spikes are equal."""
    platform = jax.default_backend()
    if platform == "gpu":
        return "cuda"
    if platform == "cpu":
        return "host"
    raise RuntimeError(f"no OASIS kernel for platform {platform!r}")


def deconvolve_traces(traces: np.ndarray, device_flat=None) -> np.ndarray:
    """Binary int8 spikes for (..., T) float traces through
    :func:`oasis_backend`'s kernel. A kernel that cannot be built raises;
    there is no fallback to another backend.

    ``device_flat``: optional ``(N, T)`` device copy of the flattened traces
    already in flight (see :func:`deconvolve_file`'s one-chunk-ahead
    staging); used by the CUDA backend."""
    shape = traces.shape
    flat = np.ascontiguousarray(traces.reshape(-1, shape[-1]), np.float32)
    if oasis_backend() == "cuda":
        from calciumgan.ops.oasis import oasis_spikes
        out = np.asarray(jax.device_get(oasis_spikes(
            flat if device_flat is None else device_flat)))
    else:
        from calciumgan import native
        out = native.deconvolve_batch(flat)
        if out is None:
            raise RuntimeError("the native OASIS host kernel is unavailable: "
                               + native.load_error)
        out = out.astype(np.int8)
    return out.reshape(shape)


# Traces per deconvolution dispatch in deconvolve_file. On an H100 the CUDA
# kernel's host-to-host rate grows with the chunk up to ~32k traces of 2048
# frames (179-191k traces/s at 1024, 328-382k at 16384, 494-538k at 32768,
# 521-553k at 65536 in two sweeps): a fixed cost per call and the
# host->device copy dominate the kernel itself.
DECONVOLVE_CHUNK = 32768


def deconvolve_file(config, filename: str, chunk: int = 0) -> None:
    """Append an int8 ``spikes`` dataset to an epoch h5 file by deconvolving
    all (trial, neuron) traces in batched calls (reference fans a Pool
    per neuron — ``compute_metrics.py:41-57``).

    ``chunk`` counts trials per dispatch (0 = auto: about
    ``DECONVOLVE_CHUNK`` traces).

    Crash safety: chunks append to a ``_spikes_partial`` staging dataset
    that is promoted to ``spikes`` only once every trial is done, so a run
    killed mid-file resumes from the last complete chunk instead of leaving
    a silently-truncated ``spikes`` dataset behind.
    """
    if config.verbose:
        print(f"\tDeconvolve {filename}")
    n = h5.get_dataset_length(filename, "signals")
    if chunk <= 0:
        per_trial = max(1, int(getattr(config, "num_neurons", 1) or 1))
        chunk = max(1, DECONVOLVE_CHUNK // per_trial)
    # the chunk size rides in the staging name: chunk-boundary arithmetic
    # below is only sound against appends of the SAME size, so a resume
    # with another chunk size restarts cleanly
    staging = f"_spikes_partial_c{chunk}"
    for stale in h5.keys(filename):
        if stale.startswith("_spikes_partial") and stale != staging:
            h5.delete(filename, stale)
    if n == 0:
        # an empty signals dataset has nothing to stage; write an empty
        # spikes dataset directly instead of promoting a never-created one
        h5.write(filename, {"spikes": np.zeros(
            (0,) + tuple(h5.get(filename, "signals").shape[1:]), np.int8)})
        return
    done = 0
    if h5.contains(filename, staging):
        # resume; unconditionally re-do the LAST chunk: h5 appends resize
        # before writing data, so a kill can leave a chunk-ALIGNED length
        # whose final chunk reads back as fill-value zeros
        done = max(0, (h5.get_dataset_length(filename, staging) // chunk - 1)
                   * chunk)
        h5.truncate(filename, staging, done)

    on_device = oasis_backend() == "cuda"

    def load(start):
        """Read one chunk and START its host->device transfer.

        ``jax.device_put`` is asynchronous, so issuing chunk k+1's upload
        BEFORE blocking on chunk k's kernel overlaps the transfer with the
        kernel + h5 write of chunk k. Done on the main thread rather than a
        DevicePrefetcher worker because HDF5 handles are not safe to read
        from a thread while this loop appends to the same file."""
        signals = h5.get(filename, "signals", start=start,
                         stop=start + chunk)
        # NWC -> (N, C, W) so time is the trailing axis
        traces = np.ascontiguousarray(
            np.transpose(signals, (0, 2, 1)), np.float32)
        flat = traces.reshape(-1, traces.shape[-1])
        return traces, (jax.device_put(flat) if on_device else None)

    starts = list(range(done, n, chunk))
    pending = load(starts[0]) if starts else None
    for i, start in enumerate(starts):
        traces, dev = pending
        if i + 1 < len(starts):
            pending = load(starts[i + 1])  # overlaps this chunk's kernel
        spikes = deconvolve_traces(traces, device_flat=dev)
        h5.write(filename, {staging: np.transpose(spikes, (0, 2, 1))})
    h5.rename(filename, staging, "spikes")


def ensure_spikes(config, filename: str) -> None:
    """Deconvolve unless a COMPLETE ``spikes`` dataset already exists; a
    short one (from a legacy run killed mid-append) is dropped and redone
    rather than silently mis-joined against ``signals``."""
    if h5.contains(filename, "spikes"):
        if (h5.get_dataset_length(filename, "spikes")
                == h5.get_dataset_length(filename, "signals")):
            return
        h5.delete(filename, "spikes")
    deconvolve_file(config, filename)


# ---------------------------------------------------------------------------
# batched statistics (device side)
# ---------------------------------------------------------------------------

@jax.jit
def _firing_rates_nwc(spikes_nwc: jnp.ndarray) -> jnp.ndarray:
    """(N, W, C) -> (N, C) rates in Hz."""
    return sm.mean_firing_rate(jnp.moveaxis(spikes_nwc, 1, -1))


@jax.jit
def _per_trial_upper_corr(spikes_nwc: jnp.ndarray) -> jnp.ndarray:
    """(N, W, C) -> (N, P) upper-triangle correlation per trial."""
    def one(trial):                       # (W, C) -> (P,)
        corr = sm.correlation_coefficients(trial.T)
        iu = jnp.triu_indices(trial.shape[1], k=1)
        return corr[iu]
    return jax.vmap(one)(spikes_nwc)


@jax.jit
def _per_trial_upper_cov(spikes_nwc: jnp.ndarray) -> jnp.ndarray:
    def one(trial):
        cov = sm.covariance(trial.T)
        iu = jnp.triu_indices(trial.shape[1], k=1)
        return cov[iu]
    return jax.vmap(one)(spikes_nwc)


@functools.partial(jax.jit, static_argnames=("tau",))
def _per_trial_upper_van_rossum(spikes_nwc: jnp.ndarray,
                                tau: float = 1.0) -> jnp.ndarray:
    """(N, W, C) -> (N, P) upper-triangle pairwise van Rossum per trial."""
    def one(trial):                       # (W, C)
        d = sm.van_rossum_distance(trial.T, tau=tau)
        iu = jnp.triu_indices(trial.shape[1], k=1)
        return d[iu]
    return jax.vmap(one)(spikes_nwc)


def chunked(fn, array: np.ndarray, chunk: int = 128) -> np.ndarray:
    """Apply a jitted per-batch fn over dim 0 in fixed-size chunks (pads the
    tail so only two XLA programs are ever compiled)."""
    outs = []
    n = len(array)
    for start in range(0, n, chunk):
        part = array[start:start + chunk]
        if len(part) < chunk and start > 0:
            pad = chunk - len(part)
            padded = np.concatenate([part, part[-1:].repeat(pad, 0)])
            outs.append(np.asarray(jax.device_get(fn(padded)))[:len(part)])
        else:
            outs.append(np.asarray(jax.device_get(fn(part))))
    return np.concatenate(outs, axis=0)


# ---------------------------------------------------------------------------
# per-metric drivers (host orchestration + plots)
# ---------------------------------------------------------------------------

def _load_spikes(config, filename: str, num_samples: int) -> np.ndarray:
    """Load spikes as NWC regardless of on-disk layout (the surrogate path
    stores them neuron-major — reference normalises by dim matching,
    ``utils.py:155-184``). Dim 0 is trial-major in both layouts, so the
    range read happens before the transpose."""
    spikes = np.asarray(
        h5.get(filename, "spikes", start=0, stop=num_samples), np.float32)
    return arrays.set_array_format(spikes, "NWC", config)


def firing_rate_metrics(config, summary, real_spikes, fake_spikes,
                        epoch: int) -> np.ndarray:
    """Per-neuron firing-rate histograms + KL
    (parity: ``compute_metrics.py:195-252``)."""
    if config.verbose:
        print("\tComputing firing rate")
    real_rates = chunked(_firing_rates_nwc, real_spikes)   # (N, C)
    fake_rates = chunked(_firing_rates_nwc, fake_spikes)
    pairs = [(real_rates[:, n], fake_rates[:, n])
             for n in range(config.num_neurons)]
    summary.plot_histograms_grid(
        "firing_rate", data=[pairs[n] for n in config.neurons],
        xlabel="Hz", ylabel="Count",
        titles=[f"Neuron #{n:03d}" for n in config.neurons],
        step=epoch, legend_labels=["recorded", "synthetic"],
        plots_per_row=config.plots_per_row)
    kl = sm.pairs_kl_divergence(pairs)
    summary.plot_distribution("firing_rate_kl", data=kl,
                              xlabel="KL divergence", ylabel="Count",
                              title="Firing Rate", step=epoch)
    if config.verbose:
        message = f"\t\tKL mean: {np.mean(kl):.04f}\n"
        for n in config.neurons:
            message += f"\t\tneuron {n:03d}: {kl[n]:.02f}\n"
        print(message)
    return kl


def _plot_pairs_and_kl(config, summary, pairs, epoch, tag: str, title: str,
                       xlabel: str) -> np.ndarray:
    """Per-trial histogram grid + KL distribution (the shared tail of every
    pairwise statistic)."""
    summary.plot_histograms_grid(
        f"{tag}", data=[pairs[i] for i in config.trials],
        xlabel=xlabel, ylabel="Count",
        titles=[f"Sample #{i:03d}" for i in config.trials],
        step=epoch, legend_labels=["recorded", "synthetic"],
        plots_per_row=config.plots_per_row)
    kl = sm.pairs_kl_divergence(pairs)
    summary.plot_distribution(f"{tag}_kl", data=kl, xlabel="KL divergence",
                              ylabel="Count", title=title, step=epoch)
    return kl


def _pairwise_metric(config, summary, real_spikes, fake_spikes, epoch,
                     device_fn, tag: str, title: str,
                     xlabel: str) -> np.ndarray:
    real = chunked(device_fn, real_spikes)  # (N, P)
    fake = chunked(device_fn, fake_spikes)
    pairs = [(arrays.remove_nan(real[i]), arrays.remove_nan(fake[i]))
             for i in range(len(real))]
    return _plot_pairs_and_kl(config, summary, pairs, epoch, tag, title,
                              xlabel)


def correlation_metrics(config, summary, real_spikes, fake_spikes,
                        epoch: int) -> np.ndarray:
    """Per-trial binned-correlation histograms + KL
    (parity: ``compute_metrics.py:308-356``)."""
    if config.verbose:
        print("\tComputing correlation coefficient")
    kl = _pairwise_metric(config, summary, real_spikes, fake_spikes, epoch,
                          _per_trial_upper_corr, "correlation", "Correlation",
                          "Correlation")
    if config.verbose:
        print(f"\t\tmean: {np.nanmean(kl):.04f}")
    return kl


def covariance_metrics(config, summary, real_spikes, fake_spikes,
                       epoch: int) -> np.ndarray:
    """Per-trial binned-covariance histograms + KL (present but disabled in
    the reference main — ``compute_metrics.py:272-304,498``)."""
    if config.verbose:
        print("\tComputing covariance")
    kl = _pairwise_metric(config, summary, real_spikes, fake_spikes, epoch,
                          _per_trial_upper_cov, "covariance_histogram",
                          "Covariance", "Covariance")
    if config.verbose:
        print(f"\t\tmin: {np.min(kl):.04f}, max: {np.max(kl):.04f}, "
              f"mean: {np.mean(kl):.04f}, "
              f"num below 1.5: {np.count_nonzero(kl < 1.5)}")
    return kl


def victor_purpura_metrics(config, summary, real_spikes, fake_spikes,
                           epoch: int) -> np.ndarray:
    """Per-trial pairwise Victor-Purpura distance KL (the reference exposes
    the statistic in ``spike_metrics.py:54-61`` but never wires it into
    compute_metrics; available here behind ``--victor_purpura``)."""
    if config.verbose:
        print("\tComputing Victor-Purpura distance")
    iu = np.triu_indices(config.num_neurons, k=1)
    # (trials, T, neurons) NWC -> (trials, neurons, T); trials chunked so
    # each dispatch carries chunk x N x N DP lanes (vs one trial per
    # dispatch) and a dense outlier only pads its own chunk. On CPU the
    # batched DP's scan carry (chunk x N^2 x M floats) blows the cache
    # (2.6x slower at 6% spike rate on a 1-core host), so the batch is
    # for accelerators only; the 16 was never measured on a GPU
    real_nmt = np.asarray(real_spikes).transpose(0, 2, 1)
    fake_nmt = np.asarray(fake_spikes).transpose(0, 2, 1)
    pairs = []
    chunk = 16 if jax.default_backend() != "cpu" else 1
    for start in range(0, len(real_nmt), chunk):
        r = np.asarray(jax.device_get(sm.victor_purpura_distance_batch(
            real_nmt[start:start + chunk])))
        f = np.asarray(jax.device_get(sm.victor_purpura_distance_batch(
            fake_nmt[start:start + chunk])))
        for i in range(len(r)):
            pairs.append((arrays.remove_nan(r[i][iu]),
                          arrays.remove_nan(f[i][iu])))
    kl = _plot_pairs_and_kl(config, summary, pairs, epoch, "victor_purpura",
                            "Victor-Purpura distance",
                            "Victor-Purpura distance")
    if config.verbose:
        print(f"\t\tmean: {np.nanmean(kl):.04f}")
    return kl


def sort_heatmap(matrix: np.ndarray):
    """Greedy sort so the minimum lands top-left
    (parity: ``compute_metrics.py:359-382``)."""
    num_trials = len(matrix)
    matrix_copy = np.copy(matrix)
    heatmap = np.full(matrix.shape, np.nan, np.float32)
    min_index = np.unravel_index(np.argmin(matrix), matrix.shape)
    row_order = np.full((num_trials,), -1, np.int64)
    row_order[0] = min_index[0]
    column_order = np.argsort(matrix[min_index[0]])
    for i in range(num_trials):
        if i != 0:
            row_order[i] = np.argsort(matrix_copy[:, column_order[i]])[0]
        heatmap[i] = matrix[row_order[i]][column_order]
        matrix_copy[row_order[i]][:] = np.inf
    return heatmap, row_order, column_order


def van_rossum_metrics(config, summary, real_spikes, fake_spikes,
                       epoch: int, heatmap_trials: int = 45) -> np.ndarray:
    """Greedy-sorted real-vs-fake distance heatmaps per focus neuron + KL of
    per-trial pairwise distances (parity: ``compute_metrics.py:385-485``)."""
    if config.verbose:
        print("\tComputing van-rossum distance")

    # heatmaps: per selected neuron, distances between real & fake trials
    # (figure-only — skipped entirely in --no_plots mode)
    if not getattr(summary, "no_plots", False):
        k = min(heatmap_trials, len(real_spikes), len(fake_spikes))
        heatmaps, xticks, yticks, titles = [], [], [], []
        for n in config.neurons:
            D = np.asarray(jax.device_get(sm.van_rossum_distance(
                list(real_spikes[:k, :, n]), list(fake_spikes[:k, :, n]))))
            heatmap, rows, cols = sort_heatmap(D)
            heatmaps.append(heatmap)
            xticks.append(rows)
            yticks.append(cols)
            titles.append(f"Neuron #{n:03d}")
        summary.plot_heatmaps_grid(
            "van_rossum", matrix=heatmaps, xlabel="synthetic trial",
            ylabel="recorded trial", xticklabels=xticks, yticklabels=yticks,
            titles=titles, step=epoch, plots_per_row=config.plots_per_row)

    kl = _pairwise_metric(config, summary, real_spikes, fake_spikes, epoch,
                          _per_trial_upper_van_rossum, "van_rossum",
                          "van-Rossum distance", "van-Rossum distance")
    if config.verbose:
        print(f"\t\tmean: {np.mean(kl):.04f}")
    return kl


# ---------------------------------------------------------------------------
# trace / raster plots
# ---------------------------------------------------------------------------

def plot_signals(config, summary, filename: str, epoch: int,
                 rng: np.random.Generator) -> None:
    """Real-vs-fake traces for one random trial with shared per-neuron ylims
    (parity: ``compute_metrics.py:115-172``; fixes the inclusive randint
    off-by-one — SURVEY.md §2.11.5)."""
    trial = int(rng.integers(0, config.num_samples))
    if config.verbose:
        print(f"\tPlotting traces for trial #{trial}")

    def load(fn):
        signals = arrays.set_array_format(
            h5.get(fn, "signals", trial=trial), "CW", config)
        spikes = arrays.set_array_format(
            h5.get(fn, "spikes", trial=trial), "CW", config)
        return signals, spikes

    real_signals, real_spikes = load(config.validation_cache)
    fake_signals, fake_spikes = load(filename)
    assert real_signals.shape == fake_signals.shape
    ylims = [[min(rs.min(), fs.min()), max(rs.max(), fs.max())]
             for rs, fs in zip(real_signals, fake_signals)]

    idx = config.neurons[:config.num_neuron_plots]
    summary.plot_traces("real_traces", real_signals, real_spikes,
                        indexes=idx, ylims=ylims, step=epoch, is_real=True,
                        signal_label="recorded signal",
                        spike_label="inferred spike",
                        plots_per_row=config.plots_per_row)
    summary.plot_traces("fake_traces", fake_signals, fake_spikes,
                        indexes=idx, ylims=ylims, step=epoch, is_real=False,
                        signal_label="synthetic signal",
                        spike_label="inferred spike",
                        plots_per_row=config.plots_per_row)


def raster_plots(config, summary, filename: str, epoch: int,
                 trial: int = 100) -> None:
    trial = min(trial, config.num_samples - 1)
    if config.verbose:
        print(f"\tPlotting raster plot for trial #{trial}")
    real = arrays.set_array_format(
        h5.get(config.validation_cache, "spikes", trial=trial), "CW", config)
    fake = arrays.set_array_format(
        h5.get(filename, "spikes", trial=trial), "CW", config)
    summary.raster_plot("raster_plot", real_spikes=real, fake_spikes=fake,
                        xlabel="Time (s)", ylabel="Neuron",
                        legend_labels=["recorded", "synthetic"], step=epoch)


# ---------------------------------------------------------------------------
# per-epoch entry
# ---------------------------------------------------------------------------

def compute_epoch_spike_metrics(config, summary, filename: str, epoch: int,
                                rng: np.random.Generator,
                                with_covariance: bool = False,
                                with_victor_purpura: bool = False,
                                real_spikes=None) -> Dict[str, float]:
    """Everything the reference runs per epoch file
    (``compute_metrics.py:488-502``). Returns mean KL per statistic.
    ``real_spikes`` may be passed in to amortise loading the validation
    cache across epochs (``--all_epochs``)."""
    ensure_spikes(config, filename)
    if not getattr(summary, "no_plots", False):
        plot_signals(config, summary, filename, epoch, rng)
        raster_plots(config, summary, filename, epoch)

    if real_spikes is None:
        real_spikes = _load_spikes(config, config.validation_cache,
                                   config.num_samples)
    fake_spikes = _load_spikes(config, filename, config.num_samples)

    results = {}
    kl = firing_rate_metrics(config, summary, real_spikes, fake_spikes, epoch)
    results["firing_rate_kl"] = float(np.nanmean(kl))
    if with_covariance:
        kl = covariance_metrics(config, summary, real_spikes, fake_spikes,
                                epoch)
        results["covariance_kl"] = float(np.nanmean(kl))
    kl = correlation_metrics(config, summary, real_spikes, fake_spikes, epoch)
    results["correlation_kl"] = float(np.nanmean(kl))
    kl = van_rossum_metrics(config, summary, real_spikes, fake_spikes, epoch)
    results["van_rossum_kl"] = float(np.nanmean(kl))
    if with_victor_purpura:
        kl = victor_purpura_metrics(config, summary, real_spikes,
                                    fake_spikes, epoch)
        results["victor_purpura_kl"] = float(np.nanmean(kl))
    for tag, value in results.items():
        if np.isfinite(value):
            summary.scalar(f"spike_metrics/{tag}", value, step=epoch)
    return results
