"""Benchmark: train-step throughput, an MFU estimate, and OASIS throughput.

Both headline numbers are measured on the attached accelerator:

1. **WGAN-GP train steps/sec** on the paper recipe
   (``/root/reference/README.md:88-93``): sl2048, batch 128, num_units 64,
   kernel 24, strides 2, m=10, layer_norm, bf16. One jitted step = 5 critic
   updates (incl. fused gradient penalty) + 1 generator update.
2. **OASIS deconvolution traces/sec** at sl2048 through the path the eval
   pipeline uses (:func:`calciumgan.eval.spike_eval.deconvolve_traces`:
   the CUDA kernel on a GPU), timed host to host as ``deconvolve_file``
   pays it, on spiky (2%) and dense (6%) traces.

MFU is derived from XLA's compiled cost analysis for the train step against
the device's dense bf16 peak, looked up by ``device_kind`` in
``PEAK_BF16_TFLOPS``; an unknown device gets ``mfu_pct: null``.

``vs_baseline`` divides by a DERIVED bound on the reference's GPU step
throughput (the reference publishes no numbers — its README has commands
only). Derivation (constants + arithmetic in ``_reference_band`` below):
the recipe step is measured at ~11.08 TFLOP by XLA cost analysis with the
critic loop unrolled, and the reference executes the same per-step math — 5
critic iterations of D-forward + D-backward + second-order gradient penalty
plus one generator update over identical conv stacks
(``/root/reference/gan/algorithms/wgan_gp.py:82-95``). The reference targets
one CUDA-10.1 / TF-2.2-era GPU; the strongest plausible card is a V100 (15.7
fp32 / 125 fp16-tensor-core peak TFLOP/s). Assuming 20-40% fp32 MFU (or
10-25% on fp16 tensor cores, where 1-D convs tile poorly) gives a band of
~0.3-2.8 steps/s. ``vs_baseline`` uses the BEST edge of that band; the full
band rides in the JSON.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...extras},
with the device as JAX reports it and, on a GPU, the card's name and power
limit from ``nvidia-smi``.
"""

import json
import subprocess
import time

import jax
import numpy as np

# Dense bf16 tensor-core peaks in TFLOP/s by jax device_kind (NVIDIA H100
# SXM data sheet: 989 without sparsity, at the 700 W power limit).
PEAK_BF16_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,
}

# CUDA-10.1-era upper-bound card (V100 SXM2) peaks and assumed achievable
# MFU bands for the reference's TF2 conv1d(-transpose) stacks
REF_GPU_FP32_PEAK_TFLOPS = 15.7
REF_GPU_FP16_PEAK_TFLOPS = 125.0
REF_FP32_MFU_BAND = (0.20, 0.40)
REF_FP16_MFU_BAND = (0.10, 0.25)


def _reference_band(tflop_per_step: float):
    """(worst, best) plausible reference steps/s for this recipe's FLOPs."""
    lo = REF_GPU_FP32_PEAK_TFLOPS * REF_FP32_MFU_BAND[0] / tflop_per_step
    hi = max(REF_GPU_FP32_PEAK_TFLOPS * REF_FP32_MFU_BAND[1],
             REF_GPU_FP16_PEAK_TFLOPS * REF_FP16_MFU_BAND[1]) / tflop_per_step
    return lo, hi


def mfu_pct(tflop_per_step, steps_per_sec, n_dev, device_kind):
    """Model FLOP/s utilisation in percent, or None when the FLOP count or
    the device's peak is unknown (never an assumed peak)."""
    peak = PEAK_BF16_TFLOPS.get(device_kind)
    if not tflop_per_step or peak is None:
        return None
    return 100.0 * tflop_per_step * steps_per_sec / (peak * n_dev)


def card() -> str:
    """``name, power.limit`` of the first GPU from nvidia-smi, or "" where
    there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def bench_train_step():
    from calciumgan.algorithms.registry import get_algorithm
    from calciumgan.models.registry import get_models
    from calciumgan.parallel import mesh as mesh_lib
    from __graft_entry__ import _flagship_config

    n_dev = len(jax.devices())
    batch_size = 128
    # unroll_critic: identical math, but XLA's cost analysis counts every
    # critic iteration — a lax.scan body is counted ONCE, which understates
    # the step's FLOPs (and the MFU) n_critic-fold
    cfg = _flagship_config(batch_size=batch_size, data_parallelism=n_dev,
                           model_parallelism=1, unroll_critic=True)

    generator, discriminator = get_models(cfg)
    algo = get_algorithm(cfg, generator, discriminator)
    mesh = mesh_lib.create_mesh(n_dev, 1)
    state = algo.init_state(jax.random.PRNGKey(0))
    state = jax.device_put(state, mesh_lib.state_shardings(mesh, state))
    train_fn, _, _ = mesh_lib.make_step_fns(algo, mesh, state)

    batch = np.random.default_rng(0).random(
        (batch_size,) + tuple(cfg.signal_shape)).astype(np.float32)
    batch = mesh_lib.shard_batch(mesh, batch)
    key = jax.random.PRNGKey(1)

    def sync(logs):
        # a fresh scalar that depends on the whole step
        return float(np.asarray(jax.device_get(logs["loss/generator"])))

    # compile + warmup
    for i in range(3):
        state, logs = train_fn(state, batch, jax.random.fold_in(key, i))
        sync(logs)

    # FLOPs of the compiled step, for the MFU estimate
    tflop_per_step = None
    try:
        cost = train_fn.lower(state, batch, key).compile().cost_analysis()
        if isinstance(cost, (list, tuple)):
            cost = cost[0]
        tflop_per_step = float(cost["flops"]) / 1e12
    except Exception:
        pass

    # pipelined throughput: chain `steps` dispatches and sync once on the
    # final step's logs (whose value depends on the whole state chain) —
    # this is how the training loop actually runs. Median of 3 repetitions.
    steps = 20
    times = []
    for r in range(3):
        start = time.perf_counter()
        for i in range(steps):
            state, logs = train_fn(
                state, batch, jax.random.fold_in(key, 100 + steps * r + i))
        sync(logs)
        times.append((time.perf_counter() - start) / steps)

    steps_per_sec = 1.0 / float(np.median(times))
    mfu = mfu_pct(tflop_per_step, steps_per_sec, n_dev,
                  jax.devices()[0].device_kind)
    return steps_per_sec, n_dev, tflop_per_step, mfu


def bench_oasis(T: int = 2048, n_traces: int = 0, rate: float = 0.02):
    """Deconvolution traces/s through the eval path's backend
    (:func:`calciumgan.eval.spike_eval.deconvolve_traces`), host array in,
    host spikes out, as ``deconvolve_file`` pays per chunk. ``n_traces``
    defaults to the eval chunk (``spike_eval.DECONVOLVE_CHUNK``). Median of
    5 after one warm-up call; each call gets a fresh perturbation of the
    input."""
    from calciumgan.eval.spike_eval import DECONVOLVE_CHUNK, deconvolve_traces
    from calciumgan.ops.oasis_ref import synth_ar1_traces

    n_traces = n_traces or DECONVOLVE_CHUNK
    traces = synth_ar1_traces(np.random.default_rng(1), n_traces, T,
                              rate=rate)
    deconvolve_traces(traces)  # compile / build
    times = []
    for i in range(5):
        y = traces + np.float32(1e-6 * (i + 1))
        start = time.perf_counter()
        deconvolve_traces(y)
        times.append(time.perf_counter() - start)
    return n_traces / float(np.median(times))


def main():
    from calciumgan.eval.spike_eval import oasis_backend
    from calciumgan.train import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]
    steps_per_sec, n_dev, tflop, mfu = bench_train_step()
    traces_per_sec = bench_oasis()
    dense_traces_per_sec = bench_oasis(rate=0.06)

    ref_lo, ref_hi = _reference_band(tflop or 11.08)
    print(json.dumps({
        "metric": "wgan_gp_train_steps_per_sec_sl2048_bs128",
        "value": round(steps_per_sec, 4),
        "unit": "steps/sec",
        "vs_baseline": round(steps_per_sec / ref_hi, 4),
        "vs_baseline_note": "ratio vs the BEST edge of a derived band for "
                            "the reference GPU step rate (same measured "
                            f"{tflop or 11.08:.2f} TFLOP/step on a V100 at "
                            "assumed 20-40% fp32 / 10-25% fp16-TC MFU).",
        "reference_steps_per_sec_band": [round(ref_lo, 3), round(ref_hi, 3)],
        "vs_baseline_band": [round(steps_per_sec / ref_hi, 2),
                             round(steps_per_sec / ref_lo, 2)],
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": n_dev},
        "card": card(),
        "steps_per_sec_per_chip": round(steps_per_sec / n_dev, 4),
        "train_step_tflop": round(tflop, 3) if tflop else None,
        "mfu_pct": round(mfu, 2) if mfu is not None else None,
        "oasis_traces_per_sec_sl2048": round(traces_per_sec, 1),
        "oasis_dense_traces_per_sec_sl2048": round(dense_traces_per_sec, 1),
        "oasis_backend": oasis_backend(),
    }))


if __name__ == "__main__":
    main()
