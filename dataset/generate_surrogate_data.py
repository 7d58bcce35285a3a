"""Generate the 2-neuron toy-DG surrogate datasets.

Parity with ``/root/reference/dataset/generate_surrogate_data.py:17-91``:
hard-coded mean [0.6, 0.8] and covariance [[1, .3], [.3, 1]], three pickles
(surrogate, ground_truth, training with AR(1) signals). The reference samples
each of the 2e6 sequences in a python loop (one scipy rvs per sample); here
the whole (num_samples, sequence_length, 2) tensor is drawn in a few batched
device calls.
"""

import os as _os
import sys as _sys

_sys.path.insert(
    0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import os
import pickle
import shutil

import jax
import numpy as np

from calciumgan.ops.dg import DichotGauss
from calciumgan.ops.oasis import ar1_filter


def generate_dg_spikes(args, sampler, key, num_samples,
                       batch: int = 100_000) -> np.ndarray:
    """(num_samples, num_neurons, sequence_length) binary spike tensor."""
    out = np.zeros((num_samples, args.num_neurons, args.sequence_length),
                   np.float32)
    for i in range(0, num_samples, batch):
        n = min(batch, num_samples - i)
        # timebins = sequence_length, repeats = n samples
        k = jax.random.fold_in(key, i)
        spikes = sampler.sample(k, repeats=n)      # (seq, n, neurons)
        out[i:i + n] = np.transpose(np.asarray(spikes), (1, 2, 0))
    return out


def spikes_to_signals(spikes, key, g=(0.95,), sn=0.3, b=0.0) -> np.ndarray:
    calcium = np.asarray(jax.device_get(
        ar1_filter(spikes.astype(np.float32), g=g, axis=-1)))
    noise = np.asarray(jax.random.normal(key, spikes.shape, np.float32))
    return (b + calcium + sn * noise).astype(np.float32)


def main(args):
    if os.path.exists(args.output_dir):
        shutil.rmtree(args.output_dir)
    os.makedirs(args.output_dir)

    args.num_neurons = 2
    mean = np.array([[0.6, 0.8]], np.float32)
    covariance = np.array([[1.0, 0.3], [0.3, 1.0]], np.float32)
    # mean is per-timebin: broadcast to sequence_length timebins
    mean_t = np.repeat(mean, args.sequence_length, axis=0)
    sampler = DichotGauss(args.num_neurons, mean=mean_t, corr=covariance,
                          make_pd=True)
    key = jax.random.PRNGKey(args.seed)
    k_surr, k_truth, k_noise = jax.random.split(key, 3)

    surrogate = generate_dg_spikes(args, sampler, k_surr, args.num_samples)
    print(f"save surrogate dataset to {args.surrogate_path}")
    with open(args.surrogate_path, "wb") as f:
        pickle.dump({"spikes": surrogate}, f)

    ground_truth = generate_dg_spikes(args, sampler, k_truth,
                                      args.num_samples)
    with open(args.ground_truth_path, "wb") as f:
        pickle.dump({"spikes": ground_truth}, f)

    rng = np.random.default_rng(args.seed)
    indices = rng.choice(len(ground_truth), size=args.training_size)
    training_spikes = ground_truth[indices]
    training_signals = spikes_to_signals(training_spikes, k_noise)
    with open(args.training_path, "wb") as f:
        pickle.dump({"spikes": training_spikes,
                     "signals": training_signals}, f)
    print(f"save training dataset to {args.training_path}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cpu",
                        choices=["cpu", "auto"],
                        help="offline prep defaults to the host CPU "
                             "backend; 'auto' uses the default platform")
    parser.add_argument("--output_dir", default="surrogate", type=str)
    parser.add_argument("--num_samples", default=2 * 10**6, type=int)
    parser.add_argument("--training_size", default=9192, type=int)
    parser.add_argument("--sequence_length", default=6, type=int)
    parser.add_argument("--seed", default=1234, type=int)
    args = parser.parse_args()
    if args.device == "cpu":
        jax.config.update("jax_platforms", "cpu")

    args.surrogate_path = os.path.join(args.output_dir, "surrogate.pkl")
    args.ground_truth_path = os.path.join(args.output_dir, "ground_truth.pkl")
    args.training_path = os.path.join(args.output_dir, "training.pkl")
    main(args)
