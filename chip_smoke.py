"""Smoke test of the main path on a CUDA GPU, end to end, against references.

    python chip_smoke.py [--seed N]     # one card
    python chip_smoke.py --chips 4      # the multi-card paths

One card: writes a synthetic record set (102 neurons, sl2048) from the seed,
trains the paper recipe through ``main.py``'s parser and ``train.main`` (one
epoch of a few steps, validation, checkpoint, then a resumed second epoch),
compares one float32 train step with the same step on the in-process CPU
backend, deconvolves ~1,000 generated and 1,000 recorded trials through the
eval path's kernel and computes the spike statistics on the card against the
float64 host kernel and numpy, deconvolves 20,000-frame recordings through
``dataset/spike_train_inference.py`` against the host kernel, and checks the
OASIS kernel against the host kernel on the sl2048 corpus at 2% and 6% spike
rates.

``--chips 4``: only a data=4 train step against the same global batch on one
card, and a data=1 x time=4 long-context step against the unsharded step.

Every phase that fails makes the exit code non-zero. Without a GPU the
script exits non-zero before any phase. The last line of standard output is
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

NEURONS = 102
SL = 2048


class Phases:
    """Runs named phases, prints each one's time beside the card, and
    remembers failures."""

    def __init__(self, card_line: str):
        self.card = card_line
        self.failed = []

    def run(self, name, fn, *args):
        start = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:
            traceback.print_exc()
            self.failed.append(name)
            out = None
        status = "FAILED" if name in self.failed else "ok"
        print(f"[{name}] {status} in {time.perf_counter() - start:.1f} s "
              f"on {self.card}", flush=True)
        return out


def check_all(pairs, rtols):
    """check_close every ``name: (got, want)`` pair at ``rtols[name]``,
    printing all of them before raising for any."""
    failed = []
    for name, (got, want) in pairs.items():
        try:
            check_close(name, got, want, rtols[name])
        except AssertionError as e:
            failed.append(str(e))
    if failed:
        raise AssertionError("; ".join(failed))


# Relative tolerances for losses of one train step against another run of
# the same step whose float32 sums go in another order. The step's logged
# losses come after five Adam updates of the critic, and Adam's first step
# moves each weight by about lr * sign(g), so a gradient component whose
# sign is decided by rounding flips its weight's update: 1e-2 for the
# critic's mean loss and penalty, which average over the five updates, and
# 5e-2 for the generator loss, taken against the fifth-updated critic (the
# tolerance tests/test_long_context.py uses for the same quantity).
STEP_RTOLS = {"loss/discriminator": 1e-2, "loss/gradient_penalty": 1e-2,
              "loss/generator": 5e-2}


def check_close(name, got, want, rtol, atol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    both_nan = np.isnan(got) & np.isnan(want)
    err = np.where(both_nan, 0.0, np.abs(got - want))
    bound = atol + rtol * np.abs(want)
    worst = float(np.nanmax(err / np.maximum(bound, 1e-300))) if err.size else 0
    print(f"  {name}: max |diff| {float(np.nanmax(err)) if err.size else 0:.3e}"
          f" ({worst:.3f} of the bound rtol={rtol:g} atol={atol:g})")
    if not (np.all(np.isfinite(err)) and worst <= 1.0):
        raise AssertionError(f"{name} differs beyond rtol={rtol} atol={atol}")


def assert_spikes_equal(name, got, want):
    got, want = np.asarray(got, np.int8), np.asarray(want, np.int8)
    rows = (got != want).reshape(-1, got.shape[-1]).any(axis=1)
    print(f"  {name}: {got.reshape(-1, got.shape[-1]).shape[0]} traces, "
          f"{int(want.sum())} spikes, {int(rows.sum())} traces differ")
    if rows.any():
        raise AssertionError(f"{name}: {int(rows.sum())} traces differ")


# ---------------------------------------------------------------------------
# one card
# ---------------------------------------------------------------------------

def write_records(out_dir, seed):
    """512 training + 128 validation windows of a synthetic 102-neuron
    recording, sl2048, stride 8."""
    from calciumgan import native
    from calciumgan.data import segments
    from calciumgan.ops.oasis_ref import synth_ar1_traces
    signals = synth_ar1_traces(np.random.default_rng(seed), NEURONS,
                               SL + 640 * 8)
    data = {"signals": signals, "oasis": native.deconvolve_batch(signals)}
    signals, spikes, meta = segments.preprocess(
        data, SL, 8, do_normalize=True, is_dg_data=True)
    segments.write_dataset(out_dir, signals, spikes, meta, SL, 8,
                           validation_size=128, do_normalize=True,
                           apply_fft=False, conv2d=False, seed=seed,
                           verbose=0)


def recipe_argv(input_dir, output_dir, epochs, seed):
    from __graft_entry__ import _flagship_config
    cfg = _flagship_config()
    argv = ["--input_dir", input_dir, "--output_dir", output_dir,
            "--model", cfg.model, "--algorithm", cfg.algorithm,
            "--batch_size", "128", "--num_units", str(cfg.num_units),
            "--kernel_size", str(cfg.kernel_size),
            "--strides", str(cfg.strides), "--noise_dim", str(cfg.noise_dim),
            "--m", str(cfg.m), "--n_critic", str(cfg.n_critic),
            "--epochs", str(epochs), "--checkpoint_every", "1",
            "--seed", str(seed), "--verbose", "1"]
    if cfg.layer_norm:
        argv.append("--layer_norm")
    if cfg.mixed_precision:
        argv.append("--mixed_precision")
    return argv


def phase_train(work, seed):
    """Train, validate, checkpoint; then resume for a second epoch."""
    import main as main_cli
    from calciumgan import train
    from calciumgan.utils import checkpoint, tb_reader

    records = os.path.join(work, "records")
    run = os.path.join(work, "run")
    write_records(records, seed)
    for epochs in (1, 2):
        config = main_cli.parse_args(recipe_argv(records, run, epochs, seed))
        metrics = train.main(config, return_metrics=True)
        print(f"  epochs={epochs}: validation {metrics}")
        assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert config.start_epoch == 1, "the second run did not resume"
    assert checkpoint.latest_epoch(config.ckpt_dir) == 1
    scalars = tb_reader.read_scalars(run)
    losses = {k: v for k, v in scalars.items() if k.startswith("loss/")}
    print(f"  train losses by epoch: {losses}")
    assert losses and all(np.isfinite(x) for v in losses.values()
                          for x in v.values()), losses
    assert all(set(v) == {0, 1} for v in losses.values()), losses
    return config


def phase_memory(config):
    """``memory_analysis()`` of the recipe's compiled train step."""
    from calciumgan.algorithms.registry import get_algorithm
    from calciumgan.models.registry import get_models
    from calciumgan.parallel import mesh as mesh_lib
    gen, dis = get_models(config)
    algo = get_algorithm(config, gen, dis)
    mesh = mesh_lib.create_mesh(1, 1, devices=jax.devices()[:1])
    state = algo.init_state(jax.random.PRNGKey(0))
    state = jax.device_put(state, mesh_lib.state_shardings(mesh, state))
    train_fn, _, _ = mesh_lib.make_step_fns(algo, mesh, state)
    batch = jax.ShapeDtypeStruct((config.batch_size,)
                                 + tuple(config.signal_shape), jnp.float32,
                                 sharding=mesh_lib.batch_sharding(mesh, 3))
    compiled = train_fn.lower(state, batch, jax.random.PRNGKey(1)).compile()
    print(f"  train step memory_analysis: {compiled.memory_analysis()}")


def _f32_recipe(batch_size):
    from __graft_entry__ import _flagship_config
    return _flagship_config(batch_size=batch_size, mixed_precision=False,
                            data_parallelism=1)


def _step_quantities(algo, state, real, key):
    """Critic and generator losses and gradient norms at the initial state,
    then one full train step's logged losses."""
    import optax

    def critic(state, real, key):
        k_noise, k_gen, k_both, k_gp = jax.random.split(key, 4)
        noise = algo.get_noise(k_noise, real.shape[0])
        fake, _ = algo.gen_apply(state.generator.params, {}, noise, k_gen,
                                 True)

        def loss(dp):
            both = jnp.concatenate([real, fake], axis=0)
            out, _ = algo.dis_apply(dp, {}, both, k_both, True)
            gp = algo.gradient_penalty(dp, {}, k_gp, real, fake, True)
            return (algo.wasserstein_dis_loss(out[:len(real)],
                                              out[len(real):])
                    + algo.penalty * gp)

        value, grads = jax.value_and_grad(loss)(state.discriminator.params)
        return value, optax.global_norm(grads)

    def generator(state, key):
        k_noise, k_gen, k_fake = jax.random.split(key, 3)
        noise = algo.get_noise(k_noise, real.shape[0])

        def loss(gp):
            fake, _ = algo.gen_apply(gp, {}, noise, k_gen, True)
            out, _ = algo.dis_apply(state.discriminator.params, {}, fake,
                                    k_fake, True)
            return algo.generator_loss(out)

        value, grads = jax.value_and_grad(loss)(state.generator.params)
        return value, optax.global_norm(grads)

    value, norm = jax.jit(critic)(state, real, key)
    g_value, g_norm = jax.jit(generator)(state, key)
    _, logs = jax.jit(algo.train_step)(state, real, key)
    out = {"critic_loss": value, "critic_grad_norm": norm,
           "generator_loss": g_value, "generator_grad_norm": g_norm}
    out.update({k: logs[k] for k in ("loss/generator", "loss/discriminator",
                                     "loss/gradient_penalty")})
    return {k: float(v) for k, v in jax.device_get(out).items()}


def phase_reference_step(seed):
    """One float32 train step at full widths, batch 8, on the GPU and on
    the in-process CPU backend, both at matmul precision "highest".

    rtol 1e-3 for the losses and gradient norms at the initial state: the
    two backends sum in other orders and pick other convolution algorithms,
    which leaves float32 rounding differences (~1e-6 relative per op) that
    the double backward of the gradient penalty compounds. ``STEP_RTOLS``
    for the step's logged losses."""
    from calciumgan.algorithms.registry import get_algorithm
    from calciumgan.models.registry import get_models
    cfg = _f32_recipe(8)
    gen, dis = get_models(cfg)
    algo = get_algorithm(cfg, gen, dis)
    cpu = jax.devices("cpu")[0]
    gpu = jax.devices()[0]
    with jax.default_device(cpu):
        state = algo.init_state(jax.random.PRNGKey(seed))
    real = np.random.default_rng(seed).random(
        (8, SL, NEURONS)).astype(np.float32)
    key = jax.random.PRNGKey(seed + 1)
    out = {}
    with jax.default_matmul_precision("highest"):
        for dev in (gpu, cpu):
            out[dev.platform] = _step_quantities(
                algo, jax.device_put(state, dev),
                jax.device_put(real, dev), jax.device_put(key, dev))
    check_all({k: (out["gpu"][k], want) for k, want in out["cpu"].items()},
              {k: STEP_RTOLS.get(k, 1e-3) for k in out["cpu"]})


def _numpy_stats(spikes_nwc):
    """Firing rate, upper-triangle correlation / covariance of 500 ms bin
    counts, and upper-triangle van Rossum distances (tau 1 s), in float64
    numpy, per trial."""
    from calciumgan.ops.spike_metrics import FRAMERATE
    x = np.asarray(spikes_nwc, np.float64)          # (N, T, C)
    n, T, C = x.shape
    rate = x.sum(axis=1) / (T / FRAMERATE)
    fpb = int(round(0.5 * FRAMERATE))
    bins = x[:, :T // fpb * fpb].reshape(n, T // fpb, fpb, C).sum(axis=2)
    iu = np.triu_indices(C, k=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        corr = np.stack([np.corrcoef(b.T)[iu] for b in bins])
    cov = np.stack([np.cov(b.T)[iu] for b in bins])
    rho = np.exp(-1.0 / FRAMERATE)
    fwd = np.zeros_like(x)
    bwd = np.zeros_like(x)
    acc = np.zeros((n, C))
    for t in range(T):
        acc = rho * acc + x[:, t]
        fwd[:, t] = acc
    acc[:] = 0.0
    for t in range(T - 1, -1, -1):
        acc = rho * acc + x[:, t]
        bwd[:, t] = acc
    xk = fwd + bwd - x                                 # K x along time
    self_term = np.einsum("ntc,ntc->nc", xk, x)
    cross = np.einsum("ntc,ntd->ncd", xk, x)
    d2 = self_term[:, :, None] + self_term[:, None, :] - 2 * cross
    vr = np.sqrt(np.maximum(d2, 0.0))[:, iu[0], iu[1]]
    return {"firing_rate": rate, "correlation": corr, "covariance": cov,
            "van_rossum": vr}


def _device_stats(spikes_nwc):
    from calciumgan.eval import spike_eval as se
    return {"firing_rate": se.chunked(se._firing_rates_nwc, spikes_nwc),
            "correlation": se.chunked(se._per_trial_upper_corr, spikes_nwc),
            "covariance": se.chunked(se._per_trial_upper_cov, spikes_nwc),
            "van_rossum": se.chunked(se._per_trial_upper_van_rossum,
                                     spikes_nwc)}


def _deconvolve_trials(signals_nwc):
    """Spikes for (trials, T, neurons) signals through the eval path's
    dispatch (``deconvolve_traces``), in the trial chunks deconvolve_file
    uses."""
    from calciumgan.eval.spike_eval import DECONVOLVE_CHUNK, deconvolve_traces
    traces = np.ascontiguousarray(np.transpose(signals_nwc, (0, 2, 1)))
    chunk = max(1, DECONVOLVE_CHUNK // traces.shape[1])
    spikes = np.concatenate([deconvolve_traces(traces[i:i + chunk])
                             for i in range(0, len(traces), chunk)])
    return np.transpose(spikes, (0, 2, 1)), traces


def phase_eval(config, seed, trials=1000):
    """Deconvolution and spike statistics of generated and recorded
    trials on the card, against the host kernel and numpy.

    Tolerances for the statistics (device float32 vs numpy float64 on the
    same spikes): firing rate rtol 1e-6 (one float32 sum of 0/1 values);
    correlation and covariance atol 1e-5 + rtol 1e-5 (float32 bin counts
    and full-precision float32 matmuls); van Rossum atol 1e-3 on distances
    of order 1-10: float32 self terms of order 1e2-1e3 lose ~1e-4 in the
    a + b - 2c cancellation, and the square root of a cancelled d^2 near
    zero amplifies that."""
    from calciumgan import native
    from calciumgan.algorithms.registry import get_algorithm
    from calciumgan.data import pipeline
    from calciumgan.models.registry import get_models
    from calciumgan.utils import checkpoint

    gen, dis = get_models(config)
    algo = get_algorithm(config, gen, dis)
    state, epoch = checkpoint.restore(
        config.ckpt_dir, algo.init_state(jax.random.PRNGKey(0)), verbose=0)
    assert epoch == 1, epoch
    generate = jax.jit(algo.generate)
    fake = []
    for i in range(0, trials, 200):
        noise = algo.get_noise(jax.random.PRNGKey(seed + i),
                               min(200, trials - i))
        fake.append(np.asarray(generate(state, noise)))
    fake = pipeline.reverse_preprocessing(config, np.concatenate(fake))
    _, validation = pipeline.get_datasets(config)
    real = np.concatenate([validation.signals] * -(-trials // len(
        validation.signals)))[:trials]
    real = pipeline.reverse_preprocessing(config, real)

    tol = {"firing_rate": (1e-6, 0.0), "correlation": (1e-5, 1e-5),
           "covariance": (1e-5, 1e-5), "van_rossum": (0.0, 1e-3)}
    for name, signals in (("generated", fake), ("recorded", real)):
        spikes, traces = _deconvolve_trials(signals.astype(np.float32))
        host = native.deconvolve_batch(traces.reshape(-1, SL))
        assert_spikes_equal(f"{name} spikes vs host kernel", np.transpose(
            spikes, (0, 2, 1)).reshape(-1, SL), host)
        got = _device_stats(spikes.astype(np.float32))
        want = _numpy_stats(spikes)
        for stat, (rtol, atol) in tol.items():
            check_close(f"{name} {stat}", got[stat], want[stat], rtol, atol)


def phase_oasis_corpus(seed):
    """The CUDA kernel against the float64 host kernel on 16384 x 2048
    traces at 2% and 6% spike rates, host array to host array."""
    from calciumgan import native
    from calciumgan.eval.spike_eval import deconvolve_traces
    from calciumgan.ops.oasis_ref import synth_ar1_traces
    rng = np.random.default_rng(seed)
    if not native.available():  # built here, not inside the first timing
        raise RuntimeError(native.load_error)
    for rate in (0.02, 0.06):
        y = synth_ar1_traces(rng, 16384, SL, rate=rate)
        deconvolve_traces(y)  # compile this shape
        start = time.perf_counter()
        got = deconvolve_traces(y)
        t_dev = time.perf_counter() - start
        start = time.perf_counter()
        want = native.deconvolve_batch(y)
        t_host = time.perf_counter() - start
        print(f"  rate {rate}: kernel {t_dev * 1e3:.1f} ms, host kernel "
              f"({os.cpu_count()} cores) {t_host * 1e3:.1f} ms")
        assert_spikes_equal(f"16384x{SL} at {rate}", got, want)


def phase_recordings(work, seed):
    """20,000-frame recordings through spike_train_inference's path."""
    from calciumgan import native
    from calciumgan.ops.oasis_ref import synth_ar1_traces
    spec = importlib.util.spec_from_file_location(
        "spike_train_inference",
        os.path.join(REPO, "dataset", "spike_train_inference.py"))
    sti = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sti)
    rng = np.random.default_rng(seed + 7)
    raw = os.path.join(work, "raw")
    os.makedirs(raw)
    recordings = []
    for i in range(4):
        signals = synth_ar1_traces(rng, 128, 20000)
        recordings.append(signals)
        with open(os.path.join(raw, f"rec{i}.pkl"), "wb") as f:
            pickle.dump({"signals": signals}, f)
    args = argparse.Namespace(input_dir=raw, overwrite=False, clean=False)
    start = time.perf_counter()
    sti.main(args)
    print(f"  spike_train_inference over 4 x 128 x 20000: "
          f"{time.perf_counter() - start:.2f} s")
    for i, signals in enumerate(recordings):
        with open(os.path.join(raw, f"rec{i}.pkl"), "rb") as f:
            got = pickle.load(f)["oasis"]
        assert_spikes_equal(f"recording {i}", got,
                            native.deconvolve_batch(signals))


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def phase_data_parallel(seed):
    """A data=4 train step against the same global batch on one card,
    float32 at matmul precision "highest". The runs differ in how the
    batch means and the gradient all-reduce are summed; ``STEP_RTOLS``."""
    from calciumgan.algorithms.registry import get_algorithm
    from calciumgan.models.registry import get_models
    from calciumgan.parallel import mesh as mesh_lib
    cfg = _f32_recipe(32)
    gen, dis = get_models(cfg)
    algo = get_algorithm(cfg, gen, dis)
    host_state = jax.device_get(algo.init_state(jax.random.PRNGKey(seed)))
    real = np.random.default_rng(seed).random(
        (32, SL, NEURONS)).astype(np.float32)
    key = jax.random.PRNGKey(seed + 1)
    logs = {}
    with jax.default_matmul_precision("highest"):
        for n in (4, 1):
            mesh = mesh_lib.create_mesh(n, 1, devices=jax.devices()[:n])
            state = jax.device_put(host_state,
                                   mesh_lib.state_shardings(mesh, host_state))
            train_fn, _, _ = mesh_lib.make_step_fns(algo, mesh, state)
            _, out = train_fn(state, mesh_lib.shard_batch(mesh, real), key)
            logs[n] = jax.device_get(out)
    check_all({k: (logs[4][k], logs[1][k]) for k in STEP_RTOLS}, STEP_RTOLS)


def phase_long_context(seed):
    """A data=1 x time=4 long-context step against the unsharded step on
    one card, float32 at matmul precision "highest", phase shuffle off (the
    sharded and unsharded discriminators draw their shifts from different
    key splits). The sharded step re-partitions the same sums;
    ``STEP_RTOLS``."""
    from calciumgan.algorithms.registry import get_algorithm
    from calciumgan.models.registry import get_models
    from calciumgan.parallel.long_context import (
        create_time_mesh, make_long_context_algorithm)
    from jax.sharding import NamedSharding, PartitionSpec as P
    cfg = _f32_recipe(8)
    cfg.m = 0
    gen, dis = get_models(cfg)
    mesh = create_time_mesh(1, 4, devices=jax.devices()[:4])
    algo, train_fn, _, _ = make_long_context_algorithm(cfg, mesh, gen, dis)
    std = get_algorithm(cfg, gen, dis)
    host_state = jax.device_get(std.init_state(jax.random.PRNGKey(seed)))
    real = np.random.default_rng(seed).random(
        (8, SL, NEURONS)).astype(np.float32)
    key = jax.random.PRNGKey(seed + 1)
    with jax.default_matmul_precision("highest"):
        state = jax.device_put(host_state, NamedSharding(mesh, P()))
        sharded = jax.device_put(real, NamedSharding(mesh,
                                                     P("data", "time", None)))
        _, lc_logs = train_fn(state, sharded, jax.device_put(key))
        _, std_logs = jax.jit(std.train_step)(
            jax.device_put(host_state, jax.devices()[0]),
            jax.device_put(real, jax.devices()[0]), key)
    lc_logs, std_logs = jax.device_get((lc_logs, std_logs))
    check_all({k: (lc_logs[k], std_logs[k]) for k in STEP_RTOLS}, STEP_RTOLS)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--chips", type=int, default=1, choices=[1, 4])
    args = parser.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    if len(jax.devices()) < args.chips:
        print(f"--chips {args.chips} needs {args.chips} GPUs, JAX found "
              f"{len(jax.devices())}", file=sys.stderr)
        return 2
    from bench import card
    from calciumgan.train import enable_compilation_cache
    print(f"compile cache: {enable_compilation_cache()}")
    card_line = card()
    if not card_line:
        print("nvidia-smi named no card", file=sys.stderr)
        return 2
    phases = Phases(card_line)
    if args.chips == 4:
        phases.run("data-parallel step, 4 cards vs 1", phase_data_parallel,
                   args.seed)
        phases.run("long-context step, time=4 vs unsharded",
                   phase_long_context, args.seed)
    else:
        work = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            phases.run("oasis kernel vs host kernel, sl2048 corpus",
                       phase_oasis_corpus, args.seed)
            config = phases.run("train, validate, checkpoint, resume",
                                phase_train, work, args.seed)
            if config is not None:
                phases.run("train step memory", phase_memory, config)
                phases.run("eval: deconvolution + spike statistics",
                           phase_eval, config, args.seed)
            phases.run("reference step, GPU vs CPU", phase_reference_step,
                       args.seed)
            phases.run("whole recordings, 20000 frames", phase_recordings,
                       work, args.seed)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    if phases.failed:
        print(f"failed phases: {phases.failed}", file=sys.stderr)
        return 1
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
