"""Time OASIS deconvolution three ways on the attached GPU, host array in,
host spikes out (what ``spike_eval.deconvolve_file`` pays per chunk):

(a) the CUDA kernel (``ops.oasis.oasis_spikes``),
(b) the plain XLA ``lax.while_loop`` machine (``ops.oasis.deconvolve_signals``),
(c) the C++ OpenMP host kernel on all of this machine's cores,

at 16384 x 2048 traces (2% and 6% spike rates) and 512 x 20,000 frames, then
the kernel alone at several trace counts per call (the eval chunk). Prints
JSON lines; the first names the card and its power limit.

    python tools/time_oasis.py [--reps 3] [--skip-while]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from bench import card as read_card  # noqa: E402
from calciumgan import native  # noqa: E402
from calciumgan.ops import oasis  # noqa: E402
from calciumgan.ops.oasis_ref import synth_ar1_traces  # noqa: E402


def best_of(fn, reps):
    fn()  # compile / build / warm
    times = []
    for _ in range(reps):
        start = time.perf_counter()
        fn()
        times.append(time.perf_counter() - start)
    return min(times), times


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--skip-while", action="store_true")
    args = parser.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU; JAX found {dev.platform}")
    card = read_card()
    print(json.dumps({"card": card, "device_kind": dev.device_kind,
                      "host_cores": len(os.sched_getaffinity(0))}))
    rng = np.random.default_rng(0)
    for n, T, rate in [(16384, 2048, 0.02), (16384, 2048, 0.06),
                       (512, 20000, 0.02)]:
        y = synth_ar1_traces(rng, n, T, rate=rate)
        ref = native.deconvolve_batch(y).astype(np.int8)
        kernel = lambda: np.asarray(jax.device_get(  # noqa: E731
            oasis.oasis_spikes(jax.device_put(y))))
        row = {"traces": n, "frames": T, "rate": rate, "card": card}
        row["kernel_s"], _ = best_of(kernel, args.reps)
        row["kernel_equals_host"] = bool(np.array_equal(kernel(), ref))
        on_device = jax.device_put(y)
        row["kernel_device_resident_s"], _ = best_of(
            lambda: oasis.oasis_spikes(on_device).block_until_ready(),
            args.reps)
        row["host_s"], _ = best_of(lambda: native.deconvolve_batch(y),
                                   args.reps)
        if not args.skip_while:
            xla = lambda: np.asarray(jax.device_get(  # noqa: E731
                oasis.deconvolve_signals(jax.device_put(y))))
            row["xla_while_s"], _ = best_of(xla, 1)
            row["xla_while_traces_differ"] = int(
                (xla().astype(np.int8) != ref).any(axis=1).sum())
        print(json.dumps(row), flush=True)
    y = synth_ar1_traces(rng, 65536, 2048, rate=0.02)
    for n in (1024, 4096, 16384, 32768, 65536):
        part = y[:n]
        t, _ = best_of(lambda: np.asarray(jax.device_get(
            oasis.oasis_spikes(jax.device_put(part)))), args.reps)
        print(json.dumps({"chunk_traces": n, "kernel_s": t,
                          "traces_per_s": n / t, "card": card}), flush=True)


if __name__ == "__main__":
    main()
