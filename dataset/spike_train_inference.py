"""Infer ground-truth spike trains for raw calcium pickles with OASIS AR(1).

Parity with ``/root/reference/dataset/spike_train_inference.py:12-65``:
per pickle in ``--input_dir``, deconvolve every neuron with
oasisAR1(g=0.95, s_min=0.55), binarise at 0.5, store under key ``'oasis'``;
``--clean`` removes the key. The whole (neurons, T) matrix is deconvolved in
one batched call through the eval pipeline's backend
(:func:`calciumgan.eval.spike_eval.deconvolve_traces`: the CUDA kernel on
a GPU, the C++ OpenMP kernel on the host; both exact float64 OASIS).
"""

import os as _os
import sys as _sys

_sys.path.insert(
    0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import os
import pickle
from glob import glob

import jax
import numpy as np

from calciumgan.eval.spike_eval import deconvolve_traces


def generate_spike_train(args, filename):
    print(f"processing file {filename}...")
    with open(filename, "rb") as f:
        data = pickle.load(f)

    if "oasis" in data:
        print(f"oasis spike train already existed in {filename}")
        if args.overwrite:
            print("overwriting...")
        else:
            return

    signals = np.asarray(data["signals"], np.float32)
    # the eval pipeline's backend choice — one policy for the eval pipeline
    # and this CLI, so backend changes reach both
    oasis = deconvolve_traces(signals)
    data["oasis"] = oasis.astype(np.float32)

    with open(filename, "wb") as f:
        pickle.dump(data, f)


def remove_oasis(filename):
    print(f"cleaning file {filename}...")
    with open(filename, "rb") as f:
        data = pickle.load(f)
    if "oasis" in data:
        del data["oasis"]
        with open(filename, "wb") as f:
            pickle.dump(data, f)


def main(args):
    filenames = sorted(glob(os.path.join(args.input_dir, "*.pkl")))
    for filename in filenames:
        if args.clean:
            remove_oasis(filename)
        else:
            generate_spike_train(args, filename)
    print("process completed")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cpu",
                        choices=["cpu", "auto"],
                        help="'cpu' deconvolves on the host (C++ OpenMP "
                             "kernel); 'auto' uses the default platform "
                             "(the CUDA kernel on a GPU)")
    parser.add_argument("--input_dir", default="raw_data", type=str)
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--clean", action="store_true")
    args = parser.parse_args()
    if args.device == "cpu":
        jax.config.update("jax_platforms", "cpu")
    from calciumgan.train import enable_compilation_cache
    enable_compilation_cache()  # rerun CLIs skip the per-shape compiles
    main(args)
