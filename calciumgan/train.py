"""Training driver: epoch loop, validation, sampling, checkpointing.

Functional re-design of the reference driver (``/root/reference/main.py:22-224``):
same epoch structure (train pass, validation pass, every-10-epoch sample +
plot + checkpoint, profiler window at epoch 1 batches 2-6, per-epoch elapse
scalars, final surrogate-set generation) over a jitted, mesh-sharded train
step. Differences by design:

- the train step is ONE ``jax.jit`` computation per algorithm (critic loop
  and gradient penalty fused), compiled once for a fixed batch shape,
- batches ride a background :class:`DevicePrefetcher` onto the mesh,
- the PRNG stream is explicit: the step key is ``fold_in(run_key,
  global_step)`` so resume reproduces the exact randomness,
- generated-sample deconvolution (OASIS) runs on the accelerator (the CUDA
  kernel on a GPU) instead of crossing into Cython on the host
  (``main.py:147`` -> :mod:`calciumgan.eval.spike_eval`).
"""

from __future__ import annotations

import os
from shutil import rmtree
from time import time
from typing import Dict, Optional, Tuple

import jax
import numpy as np

from calciumgan.algorithms.registry import get_algorithm
from calciumgan.data import pipeline
from calciumgan.models.registry import get_models
from calciumgan.models.base import count_params, param_table
from calciumgan.parallel import mesh as mesh_lib
from calciumgan.utils import arrays, checkpoint, io
from calciumgan.utils.summary import Summary


def _progress(iterable, desc, total, verbose):
    """tqdm progress bar when verbose and tqdm is installed."""
    if not verbose:
        return iterable
    try:
        from tqdm import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable, desc=desc, total=total)


def _mean_logs(all_logs, weights=None) -> Dict[str, float]:
    """Average per-batch log dicts, optionally weighted by real rows. The
    eval step's row mask already zero-weights padded filler rows inside
    each batch's on-device mean, so the real_count-weighted average here is
    exact over the whole validation set."""
    out: Dict[str, float] = {}
    if not all_logs:
        return out
    host = [jax.device_get(l) for l in all_logs]
    w = None if weights is None else np.asarray(weights, np.float64)
    for key in host[0]:
        vals = np.asarray([np.asarray(l[key]) for l in host], np.float64)
        out[key] = float(np.average(vals, weights=w))
    return out


def _epoch_steps(global_size: int, local_bs: int,
                 drop_remainder: bool) -> int:
    """Per-process steps per epoch, identical on every process: derived from
    the guaranteed-minimum local dataset size (record-level interleave gives
    each process floor(global/P) or one more)."""
    min_local = global_size // jax.process_count()
    if drop_remainder:
        return min_local // local_bs
    return -(-min_local // local_bs)


def focus_neurons(config):
    """Reference hard-codes 9 indices assuming >=91 neurons
    (``main.py:190``); clamp to the dataset's neuron count."""
    idx = [i for i in config.focus_neurons if i < config.num_neurons]
    if not idx:
        idx = list(range(min(9, config.num_neurons)))
    return idx


# ---------------------------------------------------------------------------
# epoch passes
# ---------------------------------------------------------------------------

def train_epoch(config, dataset, train_fn, state, summary: Summary,
                epoch: int, run_key, mesh, store=None) -> Tuple:
    """One pass over the training set (parity: ``main.py:33-75``)."""
    import itertools

    rng = np.random.default_rng(config.seed + epoch)
    # multi-host: each process feeds its rows of the global batch; the step
    # count derives from the GLOBAL train size so every process dispatches
    # the same number of collectives even when record shards split unevenly
    local_bs = mesh_lib.local_batch_size(config.batch_size)
    steps = _epoch_steps(config.train_size, local_bs, drop_remainder=True)
    if store is not None:
        # device-resident signals: gather each batch in-graph. The shuffle
        # consumes `rng` exactly like ArrayDataset.batches, so batch
        # composition is bit-identical to the streaming path.
        order = np.arange(len(dataset))
        rng.shuffle(order)
        prefetch = (store.batch(order[i * local_bs:(i + 1) * local_bs])
                    for i in range(steps))
    else:
        batches = dataset.batches(local_bs, shuffle=True, rng=rng,
                                  drop_remainder=True)
        signals_only = itertools.islice((s for s, _ in batches), steps)
        prefetch = pipeline.DevicePrefetcher(
            signals_only, lambda a: mesh_lib.put_batch(mesh, a))

    all_logs = []
    start = time()
    profiling = False
    for batch_count, signal in enumerate(
            _progress(prefetch, "Train", steps, config.verbose)):
        if config.profile and epoch == 1 and batch_count == 2:
            jax.profiler.start_trace(summary.profiler_dir)
            profiling = True
        step_key = jax.random.fold_in(run_key, config.global_step)
        state, logs = train_fn(state, signal, step_key)
        all_logs.append(logs)
        config.global_step += 1
        if profiling and batch_count == 6:
            jax.block_until_ready(logs)
            jax.profiler.stop_trace()
            profiling = False
    jax.block_until_ready(state)
    if profiling:  # profile window extends past a tiny epoch
        jax.profiler.stop_trace()
    elapse = time() - start

    logs = _mean_logs(all_logs)
    summary.log(logs, elapse=elapse, state=state, step=epoch, training=True)
    return state, logs


def _validation_batches(dataset, mesh, local_bs: int, steps: int,
                        store=None):
    """(sharded signal batch, local real_count) pairs for one validation
    pass — in-graph device-store gathers when staged, host streaming
    otherwise. Tail batches pad by repeating the last real row (identical
    filler on both paths)."""
    import itertools

    if store is not None:
        n = len(dataset)
        for i in range(steps):
            lo = i * local_bs
            hi = min(n, lo + local_bs)
            idx = np.concatenate(
                [np.arange(lo, hi),
                 np.full(local_bs - (hi - lo), hi - 1, np.int64)])
            yield store.batch(idx), hi - lo
    else:
        inner = itertools.islice(dataset.batches(local_bs), steps)
        for signal, _ in inner:
            signal, real_count = mesh_lib.pad_to_multiple(signal, local_bs)
            yield mesh_lib.shard_batch(mesh, signal), real_count


def validate_epoch(config, dataset, eval_fn, state, summary: Summary,
                   epoch: int, run_key, mesh, store=None) -> Dict[str, float]:
    """One validation pass; saves generated signals per the
    ``--save_generated`` policy (parity: ``main.py:78-122``)."""
    # same cadence knob as sampling/checkpointing (--checkpoint_every;
    # reference hard-codes 10 for both — main.py:103,141)
    every = max(1, config.checkpoint_every)
    save_generated = (
        (config.save_generated == "all" and
         (epoch % every == 0 or epoch == config.epochs - 1)) or
        (config.save_generated == "last" and epoch == config.epochs - 1))

    all_logs, weights = [], []
    start = time()
    local_bs = mesh_lib.local_batch_size(config.batch_size)
    steps = _epoch_steps(config.validation_size, local_bs,
                         drop_remainder=False)
    it = _validation_batches(dataset, mesh, local_bs, steps, store=store)
    for i, (signal, real_count) in enumerate(
            _progress(it, "Validate", steps, config.verbose)):
        # row mask zero-weights the padded filler so every logged mean
        # reduces exactly over the real rows (local_bs local rows per
        # process in both staging paths)
        row_mask = np.zeros((local_bs,), np.float32)
        row_mask[:real_count] = 1.0
        row_mask = mesh_lib.shard_batch(mesh, row_mask)
        step_key = jax.random.fold_in(run_key, 10**9 + epoch * steps + i)
        fake, logs = eval_fn(state, signal, step_key, row_mask)
        # weight the cross-batch average by the GLOBAL real-row count the
        # step computed from its mask (the local count under-weights ragged
        # multi-host tail batches whose real rows split unevenly)
        weights.append(logs.pop("batch/real_rows"))
        all_logs.append(logs)
        if save_generated:
            # each process writes its own rows of the global batch; the
            # first batch replaces any file left by a pre-crash run of the
            # same epoch (h5 writes append)
            local = mesh_lib.local_rows(fake)
            io.save_fake_signals(config, epoch, local[:real_count],
                                 append=i > 0)
    elapse = time() - start

    logs = _mean_logs(all_logs, weights=weights)
    summary.log(logs, elapse=elapse, step=epoch, training=False)
    return logs


def sample_and_plot(config, algo, generate_fn, state, summary: Summary,
                    epoch: int, test_noise) -> None:
    """Generate from the fixed test noise, deconvolve on device, plot traces
    (parity: ``main.py:141-156``)."""
    # every process joins the collective generate; the rows are all copies of
    # the same test-noise sample, so each process's local rows suffice and
    # only the chief does the host-side plotting work
    fake = generate_fn(state, test_noise, jax.random.PRNGKey(epoch))
    local = mesh_lib.local_rows(fake)
    if jax.process_index() != 0:
        return
    fake = pipeline.reverse_preprocessing(config, local)
    signals = arrays.set_array_format(fake[0], "CW", config)  # (neuron, time)
    # the eval path's backend choice (CUDA kernel on a GPU, C++ on a CPU)
    from calciumgan.eval.spike_eval import deconvolve_traces
    spikes = deconvolve_traces(signals).astype(np.float32)
    summary.plot_traces("fake_traces", signals, spikes,
                        indexes=focus_neurons(config), step=epoch,
                        training=False)


def plot_real_signals(config, summary: Summary, dataset) -> None:
    """First validation batch traces at step 0
    (parity: ``dataset_helper.py:33-51``)."""
    signal, spike = next(dataset.batches(config.batch_size))
    signal = pipeline.reverse_preprocessing(config, signal)
    signals = arrays.set_array_format(signal[0], "CW", config)
    spikes = arrays.set_array_format(spike[0], "CW", config)
    summary.plot_traces("real_traces", signals, spikes,
                        indexes=focus_neurons(config), step=0,
                        training=False)


def train_and_validate(config, train_ds, validation_ds, algo, fns, state,
                       summary: Summary, mesh):
    """Epoch loop (parity: ``main.py:125-165``)."""
    train_fn, eval_fn, generate_fn = fns
    run_key = jax.random.PRNGKey(config.seed)

    # stage the signals on device once so batches gather in-graph instead
    # of crossing the host link every step (pipeline.DeviceStore); spikes
    # are never consumed by the train/eval steps, so signals suffice
    train_store = val_store = None
    total_bytes = train_ds.signals.nbytes + validation_ds.signals.nbytes
    if pipeline.device_store_enabled(config, total_bytes):
        train_store = pipeline.DeviceStore(mesh, train_ds.signals)
        val_store = pipeline.DeviceStore(mesh, validation_ds.signals)
        if config.verbose:
            print(f"device store: {total_bytes / 2**20:.0f} MB of signals "
                  f"staged on the mesh (batches gather in-graph)")
    # fixed test noise (reference uses batch 1 — ``main.py:127``); padded to
    # the data-axis size so the jitted generate's batch sharding divides,
    # row 0 is the plotted sample
    n_dev = mesh_lib.data_extent(mesh)
    one = np.asarray(
        jax.device_get(algo.get_noise(jax.random.fold_in(run_key, 2**31 - 1),
                                      1)))
    local_rows = max(1, n_dev // jax.process_count())
    test_noise = mesh_lib.put_batch(mesh, np.repeat(one, local_rows, axis=0))

    for epoch in range(config.start_epoch, config.epochs):
        if config.verbose:
            print(f"Epoch {epoch:03d}/{config.epochs:03d}")
        start = time()

        state, train_logs = train_epoch(config, train_ds, train_fn, state,
                                        summary, epoch, run_key, mesh,
                                        store=train_store)
        val_logs = validate_epoch(config, validation_ds, eval_fn, state,
                                  summary, epoch, run_key, mesh,
                                  store=val_store)

        # reference hard-codes a 10-epoch cadence (main.py:141);
        # --checkpoint_every makes it configurable
        every = max(1, config.checkpoint_every)
        if epoch % every == 0 or epoch == config.epochs - 1:
            sample_and_plot(config, algo, generate_fn, state, summary, epoch,
                            test_noise)
            if not config.skip_checkpoints:
                checkpoint.save(config.ckpt_dir, epoch, state, config=config,
                                verbose=config.verbose)

        if config.verbose:
            print("Train: generator loss {:.04f} discriminator loss {:.04f}\n"
                  "Eval: generator loss {:.04f} discriminator loss {:.04f}\n"
                  "Elapse: {:.02f} mins\n".format(
                      train_logs.get("loss/generator", float("nan")),
                      train_logs.get("loss/discriminator", float("nan")),
                      val_logs.get("loss/generator", float("nan")),
                      val_logs.get("loss/discriminator", float("nan")),
                      (time() - start) / 60))
    return state, val_store


def test(config, validation_ds, eval_fn, state, mesh,
         store=None) -> Dict[str, float]:
    """Final metric aggregation for hparam search (parity:
    ``main.py:168-181``). Reuses the validation DeviceStore when one was
    staged, instead of re-uploading the validation set per experiment."""
    key = jax.random.PRNGKey(config.seed + 777)
    local_bs = mesh_lib.local_batch_size(config.batch_size)
    steps = _epoch_steps(config.validation_size, local_bs,
                         drop_remainder=False)
    all_logs, weights = [], []
    for i, (signal, real_count) in enumerate(_validation_batches(
            validation_ds, mesh, local_bs, steps, store=store)):
        row_mask = np.zeros((local_bs,), np.float32)
        row_mask[:real_count] = 1.0
        row_mask = mesh_lib.shard_batch(mesh, row_mask)
        _, logs = eval_fn(state, signal, jax.random.fold_in(key, i),
                          row_mask)
        weights.append(logs.pop("batch/real_rows"))  # global real rows
        all_logs.append(logs)
    return _mean_logs(all_logs, weights=weights)


def generate_surrogate_dataset(config, generate_fn, algo, state, mesh,
                               num_samples: int = 2 * 10**6) -> str:
    """Generate a denormalised sample set to ``generated.pkl``
    (parity: ``utils.py:191-207``), batched at 1000 on device."""
    import pickle
    n_dev = mesh_lib.data_extent(mesh)
    batch_size = -(-1000 // n_dev) * n_dev  # reference batches at ~1000
    num_samples = -(-num_samples // batch_size) * batch_size
    key = jax.random.PRNGKey(config.seed + 999)
    # multi-host: each process generates and persists its own rows; the
    # files shard the global sample set (single host: one file, all rows)
    proc, nproc = jax.process_index(), jax.process_count()
    local_bs = batch_size // nproc
    local_total = num_samples // nproc
    generated = np.zeros((local_total,) + tuple(config.signal_shape),
                         np.float32)
    for step, i in enumerate(_progress(
            range(0, num_samples, batch_size), "Surrogate",
            num_samples // batch_size, config.verbose)):
        k = jax.random.fold_in(key, i)
        noise = np.asarray(jax.device_get(algo.get_noise(k, batch_size)))
        noise = mesh_lib.put_batch(
            mesh, noise[proc * local_bs:(proc + 1) * local_bs])
        fake = generate_fn(state, noise, k)
        rows = algo.denormalize(mesh_lib.local_rows(fake))
        generated[step * local_bs:(step + 1) * local_bs] = rows
    suffix = f".{proc:03d}" if nproc > 1 else ""
    filename = os.path.join(config.output_dir, f"generated.pkl{suffix}")
    with open(filename, "wb") as f:
        pickle.dump({"signals": generated}, f)
    if config.verbose:
        print(f"save {local_total} samples to {filename}")
    return filename


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compilation_cache() -> str:
    """Persistent XLA compilation cache, so a resumed run or a rerun CLI
    skips recompiling the train step. Where ``JAX_COMPILATION_CACHE_DIR`` is
    set, JAX already keeps its cache there and nothing is changed;
    otherwise the cache goes to ``<checkout>/.jax_cache``. Returns the
    directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    cache_dir = os.path.join(_REPO, ".jax_cache")
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return cache_dir


def main(config, return_metrics: bool = False,
         devices=None) -> Optional[Dict[str, float]]:
    """End-to-end wiring (parity: ``main.py:184-224``).

    ``devices`` optionally restricts the run's mesh to a device subset —
    used by search.py to run sweep experiments concurrently, each on its own
    slice of the chip mesh.
    """
    enable_compilation_cache()
    if config.clear_output_dir and os.path.exists(config.output_dir):
        rmtree(config.output_dir)
    os.makedirs(config.output_dir, exist_ok=True)

    summary = Summary(config)
    train_ds, validation_ds = pipeline.get_datasets(config)
    config.validate_model_shapes()

    generator, discriminator = get_models(config)

    time_par = int(getattr(config, "time_parallelism", 1) or 1)
    if time_par > 1:
        # long-context (context-parallel) training: sequence frames sharded
        # over a 'time' mesh axis (parallel/long_context.py)
        from calciumgan.parallel import long_context as lc
        n_dev = len(devices if devices is not None else jax.devices())
        if time_par > n_dev or n_dev % time_par:
            raise ValueError(
                f"time_parallelism {time_par} must divide the device count "
                f"({n_dev} device(s) visible)")
        data_par = config.data_parallelism
        if data_par in (-1, 0, None):
            data_par = n_dev // time_par
        if jax.process_count() > 1:
            # multi-host: each process feeds its (batch-rows x full-time)
            # block and make_array_from_process_local_data carves the time
            # slices onto its devices — valid only when no data-parallel
            # row straddles a process boundary
            local = jax.local_device_count()
            if local % time_par:
                raise ValueError(
                    f"multi-host time_parallelism requires the time axis to "
                    f"fit within each host: {local} local device(s) is not "
                    f"divisible by time_parallelism {time_par}")
            if data_par * time_par != n_dev:
                raise ValueError(
                    f"multi-host time_parallelism must use every device: "
                    f"data {data_par} x time {time_par} != {n_dev}")
        mesh = lc.create_time_mesh(data_par, time_par, devices=devices)
        algo, *fns_lc = lc.make_long_context_algorithm(
            config, mesh, generator, discriminator)
        fns_lc = tuple(fns_lc)
        state = algo.init_state(jax.random.PRNGKey(config.seed))
        from jax.sharding import NamedSharding, PartitionSpec as P
        state = jax.device_put(state, NamedSharding(mesh, P()))
    else:
        algo = get_algorithm(config, generator, discriminator)
        mesh = mesh_lib.create_mesh(config.data_parallelism,
                                    config.model_parallelism, devices=devices,
                                    slices=getattr(config, "dcn_slices", 1))
        state = algo.init_state(jax.random.PRNGKey(config.seed))
        # place the initial state with its mesh shardings before compiling
        state = jax.device_put(state, mesh_lib.state_shardings(mesh, state))

    if config.verbose:
        print(f"mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))} "
              f"on {mesh.devices.size} {mesh.devices.flat[0].platform} "
              f"device(s)")
        print(f"generator parameters: "
              f"{count_params(state.generator.params):,}")
        print(f"discriminator parameters: "
              f"{count_params(state.discriminator.params):,}")
    if config.verbose >= 2:
        # parameter tables (the reference registry printed Keras
        # summaries — models/registry.py:16-33)
        print(param_table(state.generator.params))
        print(param_table(state.discriminator.params))
    summary.scalar("model/trainable_parameters/generator",
                   count_params(state.generator.params))
    summary.scalar("model/trainable_parameters/discriminator",
                   count_params(state.discriminator.params))

    config.save()

    config.ckpt_dir = config.ckpt_dir or os.path.join(config.output_dir,
                                                      "checkpoints")
    state = checkpoint.resume(config, state)

    if config.save_generated:
        io.cache_validation_set(config, validation_ds)
    plot_real_signals(config, summary, validation_ds)

    fns = fns_lc if time_par > 1 else mesh_lib.make_step_fns(
        algo, mesh, state)

    start = time()
    state, val_store = train_and_validate(config, train_ds, validation_ds,
                                          algo, fns, state, summary, mesh)
    summary.scalar("elapse/total", time() - start)

    if config.surrogate_ds:
        generate_surrogate_dataset(config, fns[2], algo, state, mesh)

    if return_metrics:
        return test(config, validation_ds, fns[1], state, mesh,
                    store=val_store)
    return None
