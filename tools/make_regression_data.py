"""Synthesize the correlated-population recording used by the end-to-end
regression runs: N neurons driven by a shared latent rate so
the population has real pairwise correlation structure, spikes pushed
through the AR(1) calcium kernel + noise.

Writes the raw pickle ``{"signals": (N, T), "oasis": (N, T)}`` that
``dataset/generate_tfrecords.py`` consumes (neuron-major, is_dg_data
layout).

    python tools/make_regression_data.py /tmp/reg/data.pkl [neurons] [frames]
"""

import os
import pickle
import sys

import jax

# host-side synthesis: keep the accelerator free
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from calciumgan.ops.oasis import ar1_filter  # noqa: E402


def main(out: str, neurons: int = 50, frames: int = 20000,
         seed: int = 7) -> str:
    rng = np.random.default_rng(seed)
    # shared latent drive (slow AR(1)) + per-neuron gain -> correlated rates
    latent = np.zeros(frames, np.float32)
    for t in range(1, frames):
        latent[t] = 0.98 * latent[t - 1] + 0.2 * rng.standard_normal()
    gains = rng.uniform(0.3, 1.0, size=(neurons, 1)).astype(np.float32)
    base = rng.uniform(0.003, 0.02, size=(neurons, 1)).astype(np.float32)
    rates = np.clip(base * (1.0 + gains * latent[None, :]), 0.0, 0.2)
    spikes = (rng.random((neurons, frames)) < rates).astype(np.float32)

    # np.array (copy): np.asarray of a CPU-backend jax array is read-only
    calcium = np.array(ar1_filter(spikes, g=(0.95,)))
    calcium += 0.2 * rng.standard_normal(calcium.shape).astype(np.float32)

    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "wb") as f:
        pickle.dump({"signals": calcium.astype(np.float32),
                     "oasis": spikes}, f)
    print(f"wrote {out}: {neurons} neurons x {frames} frames, "
          f"mean rate {spikes.mean():.4f}")
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "/tmp/reg/data.pkl",
         *(int(a) for a in sys.argv[2:]))
