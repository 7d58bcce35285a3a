"""Observability: scalars / histograms / images to TensorBoard event files
plus the composite matplotlib plots of the reference.

Capability parity with ``/root/reference/gan/utils/summary_helper.py:21-588``
(three writer modes: train -> ``output_dir``, validation ->
``output_dir/validation``, spike-metrics -> ``output_dir/metrics`` with a
vector-plot dir), re-designed on a dependency-free event writer
(:mod:`calciumgan.utils.tb`) and plain matplotlib (the reference's
seaborn ``distplot``/positional-``JointGrid`` calls are long deprecated).
Figures are additionally saved as PNGs under ``<logdir>/plots`` so runs are
inspectable without TensorBoard.

Rendering is decoupled from figure description: every plot method builds a
picklable job and either renders it inline or submits it to a ``spawn``
process pool (:mod:`calciumgan.utils.plots`), so eval CLIs overlap
matplotlib with device compute instead of serialising behind it (the
reference's pool fanned out metric *computation*, not plotting —
``compute_metrics.py:45-49``). Construct with ``workers=N`` to enable the
pool and call :meth:`close` (or :meth:`drain`) to collect the figures.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Optional

import numpy as np

from calciumgan.utils import plots
from calciumgan.utils.plots import FAKE_COLOR, FRAMERATE, REAL_COLOR
from calciumgan.utils.tb import EventWriter

# matplotlib rcParams are process-global; concurrent sweep experiments
# (search.py --parallel) serialise their inline rendering
_PLT_LOCK = threading.RLock()


class Summary:

    def __init__(self, config, spike_metrics: bool = False,
                 workers: int = 0, no_plots: bool = False):
        self._config = config
        self.spike_metrics = spike_metrics
        self.dpi = getattr(config, "dpi", 120)
        self.framerate = FRAMERATE
        self.real_color = REAL_COLOR
        self.fake_color = FAKE_COLOR
        self._plot_weights = getattr(config, "plot_weights", False)
        self.no_plots = no_plots
        self._workers = max(0, int(workers))
        self._pool = None
        self._pending = []

        # multi-host: TensorBoard chief-only writes — non-zero processes
        # would race on event filenames (same host + second) and duplicate
        # every figure; they keep a fully inert Summary
        import jax
        self._noop = jax.process_index() != 0

        if spike_metrics:
            self._metrics_dir = os.path.join(config.output_dir, "metrics")
            self.format = getattr(config, "format", "pdf")
            self._vector_dir = os.path.join(self._metrics_dir, "plots")
            if not self._noop:
                self.metrics_writer = EventWriter(self._metrics_dir)
                # a --no_plots refresh of the KL scalars must not wipe the
                # figures a previous full run rendered
                if not self.no_plots:
                    if os.path.exists(self._vector_dir):
                        shutil.rmtree(self._vector_dir)
                    os.makedirs(self._vector_dir)
        else:
            self.profiler_dir = os.path.join(config.output_dir, "profiler")
            if not self._noop:
                self.train_writer = EventWriter(config.output_dir)
                self.val_writer = EventWriter(
                    os.path.join(config.output_dir, "validation"))

        if not self.no_plots and not plots.available():
            # figures are optional artefacts: scalars still go to the
            # event files
            print("matplotlib is not installed: no figures are drawn")
            self.no_plots = True

    # ------------------------------------------------------------------
    def _writer(self, training: bool) -> EventWriter:
        if self.spike_metrics:
            return self.metrics_writer
        return self.train_writer if training else self.val_writer

    def scalar(self, tag, value, step=0, training=True):
        if self._noop:
            return
        self._writer(training).scalar(tag, float(np.asarray(value)), step)

    def histogram(self, tag, values, step=0, training=True):
        if self._noop:
            return
        self._writer(training).histogram(tag, np.asarray(values), step)

    def flush(self):
        if self._noop:
            return
        self.drain()
        if self.spike_metrics:
            self.metrics_writer.flush()
        else:
            self.train_writer.flush()
            self.val_writer.flush()

    # ------------------------------------------------------------------
    # figure dispatch
    # ------------------------------------------------------------------
    def _meta(self, tag, step, training):
        logdir = (self._metrics_dir if self.spike_metrics else
                  (self._config.output_dir if training else
                   os.path.join(self._config.output_dir, "validation")))
        safe = tag.replace("/", "_")
        meta = {"dpi": self.dpi,
                "png_path": os.path.join(logdir, "plots",
                                         f"{safe}_step{step:06d}.png")}
        if self.spike_metrics:
            meta["vector_path"] = os.path.join(self._vector_dir,
                                               f"{safe}.{self.format}")
            meta["vector_format"] = self.format
        return meta

    def _dispatch(self, kind, payload, tag, step, training):
        if self._noop or self.no_plots:
            return
        meta = self._meta(tag, step, training)
        if self._workers:
            if self._pool is None:
                import multiprocessing
                from concurrent.futures import ProcessPoolExecutor
                # spawn: workers import only plots.py's matplotlib/numpy and
                # never inherit the parent's JAX/accelerator client state
                self._pool = ProcessPoolExecutor(
                    max_workers=self._workers,
                    mp_context=multiprocessing.get_context("spawn"))
            fut = self._pool.submit(plots.render_and_save, kind, payload,
                                    meta)
            self._pending.append((fut, tag, step, training))
        else:
            with _PLT_LOCK:
                result = plots.render_and_save(kind, payload, meta)
            self._write_image(result, tag, step, training)

    def _write_image(self, result, tag, step, training):
        png, w, h = result
        self._writer(training).image(f"{tag}/image/0", png, height=h,
                                     width=w, step=step)

    def drain(self):
        """Collect every pending pooled figure into the event files."""
        pending, self._pending = self._pending, []
        for fut, tag, step, training in pending:
            self._write_image(fut.result(), tag, step, training)

    def close(self):
        """Drain pooled figures, shut the pool down, flush event files."""
        self.flush()
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    # ------------------------------------------------------------------
    def plot_traces(self, tag, signals, spikes, indexes, ylims=None,
                    xlabel="Time (s)", ylabel=r"$\Delta F/F$", step=0,
                    training=True, is_real=True, signal_label="signal",
                    spike_label="spike", plots_per_row=3):
        """Signal traces + spike rasters per neuron
        (parity: ``summary_helper.py:121-206``)."""
        signals, spikes = np.asarray(signals), np.asarray(spikes)
        assert signals.ndim == 2 and spikes.ndim == 2
        self._dispatch("traces", dict(
            signals=signals, spikes=spikes, indexes=list(indexes),
            ylims=ylims, xlabel=xlabel, ylabel=ylabel, is_real=is_real,
            signal_label=signal_label, spike_label=spike_label,
            plots_per_row=plots_per_row), tag, step, training)

    def raster_plot(self, tag, real_spikes, fake_spikes, xlabel="",
                    ylabel="", legend_labels=None, step=0, training=True):
        """Joint raster with marginal histograms
        (parity: ``summary_helper.py:208-315``)."""
        self._dispatch("raster", dict(
            real_spikes=np.asarray(real_spikes),
            fake_spikes=np.asarray(fake_spikes), xlabel=xlabel,
            ylabel=ylabel, legend_labels=legend_labels), tag, step, training)

    def plot_distribution(self, tag, data, xlabel="", ylabel="", title="",
                          bins=30, step=0, training=False):
        self._dispatch("distribution", dict(
            data=np.asarray(data), xlabel=xlabel, ylabel=ylabel,
            title=title, bins=bins), tag, step, training)

    def plot_histogram(self, tag, data, xlabel="", ylabel="", step=0,
                       training=False, legend_labels=None):
        """Real-vs-fake overlaid histogram (range bug fixed vs reference —
        SURVEY.md §2.11.4)."""
        assert isinstance(data, tuple)
        self._dispatch("histogram", dict(
            data=tuple(np.asarray(d) for d in data), xlabel=xlabel,
            ylabel=ylabel, legend_labels=legend_labels), tag, step, training)

    def plot_histograms_grid(self, tag, data, xlabel="", ylabel="",
                             titles=None, step=0, training=False,
                             legend_labels=None, plots_per_row=3):
        assert isinstance(data, list) and isinstance(data[0], tuple)
        self._dispatch("histograms_grid", dict(
            data=[tuple(np.asarray(x) for x in pair) for pair in data],
            xlabel=xlabel, ylabel=ylabel, titles=titles,
            legend_labels=legend_labels, plots_per_row=plots_per_row),
            tag, step, training)

    def plot_heatmaps_grid(self, tag, matrix, xlabel="", ylabel="",
                           xticklabels=None, yticklabels=None, titles=None,
                           step=0, training=False, plots_per_row=3):
        assert isinstance(matrix, list)
        self._dispatch("heatmaps_grid", dict(
            matrix=[np.asarray(m) for m in matrix], xlabel=xlabel,
            ylabel=ylabel, xticklabels=xticklabels, yticklabels=yticklabels,
            titles=titles, plots_per_row=plots_per_row), tag, step, training)

    # ------------------------------------------------------------------
    def variable_summary(self, variable, name, step=0, training=True):
        v = np.asarray(variable)
        self.scalar(f"{name}/0_mean", v.mean(), step, training)
        self.scalar(f"{name}/1_stddev", v.std(), step, training)
        self.scalar(f"{name}/2_min", v.min(), step, training)
        self.scalar(f"{name}/3_max", v.max(), step, training)
        self.histogram(name, v, step, training)

    def plot_weights(self, state, step=0, training=True):
        """Per-parameter stats for both nets (``summary_helper.py:542-557``);
        operates on the train-state pytree rather than Keras variables."""
        import jax
        for prefix, params in (("plots_generator", state.generator.params),
                               ("plots_discriminator",
                                state.discriminator.params)):
            flat = jax.tree_util.tree_flatten_with_path(params)[0]
            for i, (path, leaf) in enumerate(flat):
                name = "/".join(
                    str(getattr(p, "key", p)) for p in path)
                self.variable_summary(
                    jax.device_get(leaf), f"{prefix}/{i + 1:02d}/{name}",
                    step=step, training=training)

    def log(self, logs: dict, elapse: Optional[float] = None, state=None,
            step: int = 0, training: bool = True):
        """Consolidated per-epoch-half scalar dump
        (``summary_helper.py:559-588``)."""
        for tag, value in logs.items():
            self.scalar(tag, value, step=step, training=training)
        if elapse is not None:
            self.scalar("elapse", elapse, step=step, training=training)
        if state is not None and self._plot_weights:
            self.plot_weights(state, step=step, training=training)
        self.flush()
