"""HDF5 helpers with the reference's NWC storage contract.

API parity with ``/root/reference/gan/utils/h5_helper.py:5-69``: datasets are
stored NWC (trial, time, neuron); ``write`` appends when the dataset exists;
``get`` supports per-neuron / per-trial slicing without loading the rest.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def _file(filename: str, mode: str):
    """``h5py.File``; h5py is imported here, so the package imports (and
    trains without h5 output) where h5py is not installed."""
    import h5py
    return h5py.File(filename, mode=mode)


def append(ds, value: np.ndarray) -> None:
    ds.resize(ds.shape[0] + value.shape[0], axis=0)
    ds[-value.shape[0]:] = value


def write(filename: str, content: Dict[str, np.ndarray]) -> None:
    """Write or append arrays keyed by dataset name (NWC format)."""
    assert isinstance(content, dict)
    with _file(filename, "a") as f:
        for name, value in content.items():
            value = np.asarray(value)
            if name in f:
                append(f[name], value)
            else:
                f.create_dataset(
                    name, shape=value.shape, dtype=value.dtype, data=value,
                    chunks=True, maxshape=(None,) + value.shape[1:])


def overwrite(filename: str, name: str, value: np.ndarray) -> None:
    with _file(filename, "r+") as f:
        if name not in f:
            raise KeyError(f"no dataset '{name}' in {filename}")
        del f[name]
        f.create_dataset(name, shape=value.shape, dtype=value.dtype,
                         data=value)


def delete(filename: str, name: str) -> None:
    """Drop a dataset if present (no-op when absent)."""
    with _file(filename, "r+") as f:
        if name in f:
            del f[name]


def truncate(filename: str, name: str, length: int) -> None:
    """Shrink a resizable dataset to ``length`` rows along dim 0."""
    with _file(filename, "r+") as f:
        ds = f[name]
        if length < ds.shape[0]:
            ds.resize(length, axis=0)


def rename(filename: str, src: str, dst: str) -> None:
    """Move ``src`` to ``dst`` inside the file, replacing any existing
    ``dst`` (used to promote a complete staging dataset in one step)."""
    with _file(filename, "r+") as f:
        if dst in f:
            del f[dst]
        f.move(src, dst)


def get(filename: str, name: str, neuron: Optional[int] = None,
        trial: Optional[int] = None, start: Optional[int] = None,
        stop: Optional[int] = None) -> np.ndarray:
    """Read a dataset; ``neuron`` slices NWC -> (N, W), ``trial`` -> (W, C),
    ``start``/``stop`` range-read dim 0 without loading the rest."""
    assert not (neuron is not None and trial is not None)
    with _file(filename, "r") as f:
        if name not in f:
            raise KeyError(f"no dataset '{name}' in {filename}")
        ds = f[name]
        if neuron is not None:
            return ds[:, :, neuron]
        if trial is not None:
            return ds[trial, :, :]
        if start is not None or stop is not None:
            return ds[start:stop]
        return ds[:]


def get_shape(filename: str, name: str) -> tuple:
    """Dataset shape from metadata only (no data read)."""
    with _file(filename, "r") as f:
        return tuple(f[name].shape)


def get_dataset_length(filename: str, name: str) -> int:
    with _file(filename, "r") as f:
        return len(f[name])


def keys(filename: str) -> list:
    """Top-level dataset names (empty when the file does not exist)."""
    if not os.path.exists(filename):
        return []
    with _file(filename, "r") as f:
        return list(f.keys())


def contains(filename: str, name: str) -> bool:
    with _file(filename, "r") as f:
        return name in f
