"""Fit a DG model to a recorded pickle and sample a synthetic recording.

Parity with ``/root/reference/dataset/generate_dg_data.py:15-101``: drop the
first 2 neurons, fit gauss_mean (Φ⁻¹) + fixed-rate covariance, sample spike
trains of the same duration, convolve spikes -> calcium with the AR(1)
kernel + Gaussian noise (sn=0.3), save ``{signals, oasis, mean, covariance}``.
On device: the DG fit solves all neuron pairs in one vmapped bisection, the
sampler and the AR synthesis are single device computations
(:func:`calciumgan.ops.oasis.ar1_filter` — a log-depth associative scan).
"""

import os as _os
import sys as _sys

_sys.path.insert(
    0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import os
import pickle

import jax
import numpy as np

from calciumgan.ops.dg import DichotGauss, DGOptimise
from calciumgan.ops.oasis import ar1_filter


def get_recorded_data_statistics(args):
    if not os.path.exists(args.input):
        print(f"Input {args.input} does not exists")
        raise SystemExit(1)
    with open(args.input, "rb") as f:
        data = pickle.load(f)

    spike_trains = np.asarray(data["oasis"], np.float32)[2:]
    args.num_neurons = spike_trains.shape[0]
    args.duration = spike_trains.shape[1]

    # (timebins=1, trials=duration, neurons)
    spike_trains = np.expand_dims(np.transpose(spike_trains), axis=0)
    dg_optimizer = DGOptimise(spike_trains)

    print("measuring mean...")
    mean = dg_optimizer.gauss_mean
    print("measuring covariance...")
    covariance = dg_optimizer.data_tfix_covariance
    return mean, covariance


def generate_dg_spikes(args, mean, corr, key):
    print("sample spike trains")
    sampler = DichotGauss(args.num_neurons, mean=mean, corr=corr,
                          make_pd=True)
    spikes = np.asarray(sampler.sample(key, repeats=args.duration))
    # (1, duration, neurons) -> (neurons, duration)
    return np.transpose(np.squeeze(spikes, axis=0)).astype(np.float32)


def spikes_to_signals(args, spike_trains, key, g=(0.95,), sn=0.3, b=0.0):
    """AR(1) synthesis + noise (the recurrence the reference ports from the
    OASIS package — ``generate_dg_data.py:54-70``)."""
    print("transformation from spikes to signals")
    calcium = np.asarray(jax.device_get(
        ar1_filter(spike_trains.astype(np.float32), g=g, axis=-1)))
    noise = np.asarray(jax.random.normal(
        key, (args.num_neurons, args.duration), np.float32))
    return (b + calcium + sn * noise).astype(np.float32)


def main(args):
    key = jax.random.PRNGKey(args.seed)
    k_sample, k_noise = jax.random.split(key)

    mean, covariance = get_recorded_data_statistics(args)
    dg_spikes = generate_dg_spikes(args, mean, covariance, k_sample)
    dg_signals = spikes_to_signals(args, dg_spikes, k_noise)

    if os.path.exists(args.output):
        os.remove(args.output)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "wb") as f:
        pickle.dump({"signals": dg_signals, "oasis": dg_spikes,
                     "mean": mean, "covariance": covariance}, f)
    print(f"Saved {len(dg_signals)} DG signals and spikes to {args.output}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cpu",
                        choices=["cpu", "auto"],
                        help="offline prep defaults to the host CPU "
                             "backend; 'auto' uses the default platform")
    parser.add_argument("--input",
                        default="raw_data/ST260_Day4_signals4Bryan.pkl")
    parser.add_argument("--output", default="dg/data.pkl")
    parser.add_argument("--seed", default=1234, type=int)
    args = parser.parse_args()
    if args.device == "cpu":
        jax.config.update("jax_platforms", "cpu")
    main(args)
