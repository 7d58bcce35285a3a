"""Checkpoint / resume.

The reference pickles Keras weight lists to ``checkpoints/epoch-{E:03d}.pkl``
every 10th epoch and auto-resumes from the latest on start
(``/root/reference/gan/utils/utils.py:116-152``, ``main.py:141-156,204``).

Here the FULL train state is one pytree (params G/D, optax states, step
counters — :class:`calciumgan.algorithms.state.GANState`), written as one
numpy ``.npz`` archive whose keys are the leaves' tree paths
(``generator/params/Dense_0/kernel``, ``discriminator/opt_state/0/mu/...``).
Restore is resharding-safe: the stored host arrays are ``device_put`` back
with whatever shardings the caller's template state carries, so a run
checkpointed on one mesh can resume on another.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Optional, Tuple

import jax
import numpy as np

_EPOCH_RE = re.compile(r"epoch-(\d+)\.npz$")
_EMA = "ema_params/"


def checkpoint_path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, f"epoch-{epoch:03d}.npz")


def _leaf_key(path) -> str:
    return jax.tree_util.keystr(path, simple=True, separator="/")


def flatten(state: Any) -> dict:
    """{tree path: host array} for every leaf of ``state``."""
    leaves = jax.tree_util.tree_flatten_with_path(state)[0]
    return {_leaf_key(path): np.asarray(leaf) for path, leaf in leaves}


def save(ckpt_dir: str, epoch: int, state: Any, config=None,
         verbose: int = 1) -> str:
    """Serialise the train-state pytree (gathered to host) for ``epoch``.

    Multi-host: process 0 is the single writer (every process owns a full
    replica of the data-parallel state; concurrent writers would race on the
    shared tmp file). Model-parallel state is device_get-able too: the
    sharding rules in ``parallel/mesh.py`` keep the model axis within one
    process's devices for every supported config."""
    path = checkpoint_path(ckpt_dir, epoch)
    if jax.process_index() != 0:
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = flatten(jax.device_get(state))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic: a preempted save never corrupts resume
    meta = {"epoch": epoch}
    if config is not None:
        meta["global_step"] = int(config.global_step)
    # same tmp+replace discipline as the archive: a crash mid-write must
    # not leave truncated JSON that blocks every future auto-resume
    latest = os.path.join(ckpt_dir, "latest.json")
    with open(latest + ".tmp", "w") as f:
        json.dump(meta, f)
    os.replace(latest + ".tmp", latest)
    if verbose:
        print(f"Saved checkpoint to {path}")
    return path


def latest_epoch(ckpt_dir: str) -> Optional[int]:
    epochs = []
    for path in glob.glob(os.path.join(ckpt_dir, "epoch-*.npz")):
        m = _EPOCH_RE.search(path)
        if m:
            epochs.append(int(m.group(1)))
    return max(epochs) if epochs else None


def _reconcile_ema(template: Any, stored: dict, verbose: int) -> None:
    """Make ``GANState.ema_params`` optional across checkpoints.

    An ema-off run stores no ``ema_params/...`` keys. Resuming with ema ON
    from such a checkpoint seeds the average from the stored generator
    params; resuming with ema OFF ignores any stored average (the raw
    params are the state)."""
    if getattr(template, "ema_params", None) is None:
        return
    if any(k.startswith(_EMA) for k in stored):
        return
    prefix = "generator/params/"
    for key in [k for k in stored if k.startswith(prefix)]:
        stored[_EMA + key[len(prefix):]] = stored[key]
    if verbose:
        print("Checkpoint has no generator EMA: seeded --ema from the "
              "restored params")


def restore(ckpt_dir: str, template: Any, epoch: Optional[int] = None,
            verbose: int = 1) -> Tuple[Any, Optional[int]]:
    """Restore the latest (or a specific) checkpoint into ``template``'s
    structure and shardings. Returns (state, epoch) — (template, None) when
    no checkpoint exists. A leaf the archive lacks, or whose shape differs
    from the template's, is an error."""
    if epoch is None:
        epoch = latest_epoch(ckpt_dir)
    if epoch is None:
        return template, None
    filename = checkpoint_path(ckpt_dir, epoch)
    with np.load(filename) as archive:
        stored = {k: archive[k] for k in archive.files}
    _reconcile_ema(template, stored, verbose)

    def put(path, tmpl):
        key = _leaf_key(path)
        if key not in stored:
            raise KeyError(f"{filename} has no leaf {key!r}")
        host = stored[key]
        if host.shape != tuple(tmpl.shape):
            raise ValueError(f"{filename}: {key!r} has shape {host.shape}, "
                             f"the state expects {tuple(tmpl.shape)}")
        host = host.astype(tmpl.dtype)
        sharding = getattr(tmpl, "sharding", None)
        if sharding is not None:
            return jax.device_put(host, sharding)
        return host

    state = jax.tree_util.tree_map_with_path(put, template)
    if verbose:
        print(f"Restored checkpoint at {filename}")
    return state, epoch


def resume(config, template: Any) -> Any:
    """Reference auto-resume semantics: scan ``ckpt_dir``, restore the newest
    checkpoint and set ``config.start_epoch = epoch + 1``
    (``utils.py:135-152``)."""
    if config.ckpt_dir is None:
        config.ckpt_dir = os.path.join(config.output_dir, "checkpoints")
    config.start_epoch = 0
    if not os.path.isdir(config.ckpt_dir):
        return template
    state, epoch = restore(config.ckpt_dir, template,
                           verbose=config.verbose)
    if epoch is not None:
        config.start_epoch = epoch + 1
        meta_path = os.path.join(config.ckpt_dir, "latest.json")
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as f:
                    config.global_step = json.load(f).get(
                        "global_step", config.global_step)
            except (json.JSONDecodeError, OSError):
                pass  # pre-fix files could be truncated; resume still works
    return state
