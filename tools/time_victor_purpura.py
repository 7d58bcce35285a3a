"""Measure Victor-Purpura cost at the demo eval scale (the statistic
behind ``--victor_purpura``).

Times one (neurons x neurons) pairwise VP matrix per trial — exactly what
``eval/spike_eval.victor_purpura_metrics`` computes twice per trial
(real + fake) — on the attached backend, then extrapolates the full
200-trial demo. The DP is O(M^2) per pair (M = max spikes/trace), so the
cost scales with rate^2; both the bench rate (2%) and a dense 6% variant
are timed.

    python tools/time_victor_purpura.py [trials] [neurons] [T] [device]

``device`` defaults to ``cpu`` (the offline-CLI convention); pass ``gpu``
to time the attached accelerator.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if (len(sys.argv) > 4 and sys.argv[4] or "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np

from calciumgan.ops import spike_metrics as sm


def main(trials: int = 4, neurons: int = 102, T: int = 2048) -> None:
    print("backend:", jax.default_backend(), flush=True)
    rng = np.random.default_rng(7)
    for rate in (0.02, 0.06):
        spikes = (rng.random((trials, T, neurons)) < rate).astype(np.float32)
        m = int(spikes.sum(axis=1).max())
        # compile
        d = sm.victor_purpura_distance(spikes[0].T)
        jax.block_until_ready(d)
        times = []
        for i in range(trials):
            t0 = time.perf_counter()
            d = sm.victor_purpura_distance(spikes[i].T)
            jax.block_until_ready(d)
            times.append(time.perf_counter() - t0)
        per_trial = float(np.median(times))
        # the eval driver computes real AND fake matrices per trial
        full = 2 * 200 * per_trial
        print(f"rate={rate:.0%}: max spikes/trace {m}; "
              f"{per_trial * 1e3:.0f} ms per ({neurons}x{neurons}) VP "
              f"matrix -> demo (200 trials, real+fake) ~{full / 60:.1f} min",
              flush=True)

        # the chunked batch path the eval driver actually uses (chunk 16)
        nmt = spikes.transpose(0, 2, 1)
        d = sm.victor_purpura_distance_batch(nmt)  # compile
        jax.block_until_ready(d)
        t0 = time.perf_counter()
        d = sm.victor_purpura_distance_batch(nmt)
        jax.block_until_ready(d)
        per_batch = (time.perf_counter() - t0) / trials
        print(f"  batched (B={trials}): {per_batch * 1e3:.0f} ms/trial -> "
              f"demo ~{2 * 200 * per_batch / 60:.1f} min", flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:4]))
