"""Mesh construction, sharding rules, and jitted step factories."""

from __future__ import annotations

import functools
from typing import Any, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"
SLICE_AXIS = "slice"


def create_mesh(data_parallelism: int = -1, model_parallelism: int = 1,
                devices: Optional[Sequence[jax.Device]] = None,
                slices: int = 1) -> Mesh:
    """(data, model) mesh, optionally with an outer ``slice`` axis.

    ``data_parallelism=-1`` uses every visible device. ``slices > 1``
    prepends a 'slice' axis restricted to DATA parallelism: the batch
    shards over (slice, data) jointly, params stay replicated, and the only
    traffic across slices is the per-step gradient all-reduce. Model
    sharding never crosses a slice boundary. Devices are taken in
    ``jax.devices()`` order.
    """
    devices = list(devices if devices is not None else jax.devices())
    if slices > 1 and len(devices) % slices:
        raise ValueError(
            f"{len(devices)} devices not divisible by {slices} slices")
    per_slice = len(devices) // slices
    if data_parallelism == -1:
        if per_slice % model_parallelism:
            raise ValueError(
                f"{per_slice} devices/slice not divisible by "
                f"model_parallelism {model_parallelism}")
        data_parallelism = per_slice // model_parallelism
    n = slices * data_parallelism * model_parallelism
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    if slices > 1:
        # each slice group draws from one contiguous block of per_slice
        # devices: a flat devices[:n] reshape with a smaller data extent
        # would build groups that straddle two blocks
        group = data_parallelism * model_parallelism  # <= per_slice: the
        # "mesh needs N devices" check above already bounds slices * group
        blocks = [devices[s * per_slice:s * per_slice + group]
                  for s in range(slices)]
        mesh_devices = np.array(blocks).reshape(
            (slices, data_parallelism, model_parallelism))
        return Mesh(mesh_devices, (SLICE_AXIS, DATA_AXIS, MODEL_AXIS))
    mesh_devices = np.array(devices[:n]).reshape(
        (data_parallelism, model_parallelism))
    return Mesh(mesh_devices, (DATA_AXIS, MODEL_AXIS))


def data_extent(mesh: Mesh) -> int:
    """Total batch-sharding width: data axis times any outer slice axis."""
    n = mesh.shape[DATA_AXIS]
    if SLICE_AXIS in mesh.axis_names:
        n *= mesh.shape[SLICE_AXIS]
    return n


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard dim 0 (batch) over the data axis (jointly with the slice
    axis when present); on a long-context mesh the sequence dim (axis 1 of
    NWC signals) additionally shards over 'time'."""
    rest = [None] * (ndim - 1)
    if "time" in mesh.axis_names and ndim >= 3:
        rest[0] = "time"
    batch_axes = ((SLICE_AXIS, DATA_AXIS)
                  if SLICE_AXIS in mesh.axis_names else DATA_AXIS)
    return NamedSharding(mesh, P(batch_axes, *rest))


# ---------------------------------------------------------------------------
# Parameter sharding rules (model parallelism).
#
# Everything is replicated except the two parameter matrices whose size grows
# with sequence length (SURVEY.md §5.7: the discriminator's flatten->Dense(1)
# head is O(seq)):
#   * generator input projection kernel  (noise_dim, w0*noise_dim): shard the
#     output features,
#   * discriminator head kernel (seq/strides^5 * 5u, 1): shard the input
#     features (a psum over 'model' joins the partial dot products).
# ---------------------------------------------------------------------------

def _param_spec(path: tuple, leaf) -> P:
    names = [getattr(p, "key", getattr(p, "name", str(p))) for p in path]
    if "kernel" not in names or getattr(leaf, "ndim", 0) != 2:
        return P()
    if any(n.startswith("Dense_") for n in names):
        din, dout = leaf.shape
        if dout == 1:            # discriminator head: shard input features
            return P(MODEL_AXIS, None)
        if dout >= 8 * din:      # generator/mlp input projection
            return P(None, MODEL_AXIS)
    return P()


def state_shardings(mesh: Mesh, state: Any) -> Any:
    """Sharding pytree for a GANState: params per rules, rest replicated."""
    def to_sharding(path, leaf):
        if mesh.shape[MODEL_AXIS] == 1:
            return NamedSharding(mesh, P())
        spec = _param_spec(path, leaf)
        # only shard if the dimension divides evenly
        for dim, axis in enumerate(spec):
            if axis is not None and leaf.shape[dim] % mesh.shape[MODEL_AXIS]:
                spec = P()
                break
        return NamedSharding(mesh, spec)

    return jax.tree_util.tree_map_with_path(to_sharding, state)


# ---------------------------------------------------------------------------
# Jitted step factories
# ---------------------------------------------------------------------------

def make_step_fns(algo, mesh: Mesh, state: Any):
    """Build jit-compiled (train_step, eval_step, generate) over the mesh.

    The batch is sharded over the data axis; the state keeps its sharding
    (replicated params or model-sharded per the rules); RNG keys are
    replicated so phase-shuffle shifts are replica-identical, matching the
    reference's one-shift-per-batch semantics (SURVEY.md §7).

    On a model-parallel mesh the train step receives the state shardings so
    it can pin its critic scan carry and post-update states with
    ``with_sharding_constraint``. Shardy (the jax 0.9 default partitioner)
    miscompiles the UNCONSTRAINED model-parallel WGAN-GP step -- every batch
    mean downstream of the optax update comes out data-axis-size times too
    large (pinned repro: ``tools/repro_shardy_full.py``; the upstream bug is
    canaried by ``tests/test_algorithms.py::test_model_parallel_shardy_canary``,
    a strict XFAIL that flips when a jax upgrade fixes it). The constrained
    formulation partitions correctly under BOTH Shardy and classic GSPMD
    (``tools/repro_shardy_constrained.py`` -- its ablation shows all three
    pins are required), which replaced round 3's thread-scoped GSPMD
    fallback and its private ``jax._src.config`` import.
    """
    ss = state_shardings(mesh, state)
    rep = replicated(mesh)
    ndim = len(algo.signal_shape) + 1
    data_in = batch_sharding(mesh, ndim)

    train_step = algo.train_step
    if mesh.shape[MODEL_AXIS] > 1:
        train_step = functools.partial(algo.train_step, shardings=ss)

    train = jax.jit(
        train_step,
        in_shardings=(ss, data_in, rep),
        out_shardings=(ss, rep),
        donate_argnums=(0,))

    # eval takes a (B,) row mask so padded tail batches reduce exactly
    evaluate = jax.jit(
        algo.eval_step,
        in_shardings=(ss, data_in, rep, batch_sharding(mesh, 1)),
        out_shardings=(data_in, rep))

    generate = jax.jit(
        lambda state, noise, key: algo.generate(state, noise, key,
                                                denorm=False),
        in_shardings=(ss, batch_sharding(mesh, 2), rep),
        out_shardings=data_in)

    return train, evaluate, generate


def local_batch_size(global_batch: int) -> int:
    """Per-process batch rows for a global batch (multi-host: each process
    feeds its share; single host: the full batch)."""
    count = jax.process_count()
    if global_batch % count:
        raise ValueError(
            f"batch_size {global_batch} not divisible by process count "
            f"{count}")
    return global_batch // count


def put_batch(mesh: Mesh, a: np.ndarray):
    """Assemble a globally-sharded batch from this process's local rows.

    Single host: a plain ``device_put`` with batch sharding. Multi-host:
    ``jax.make_array_from_process_local_data`` so each process contributes
    its own rows instead of every process shipping (and mostly discarding) a
    full global batch."""
    a = np.asarray(a)
    sharding = batch_sharding(mesh, a.ndim)
    if jax.process_count() == 1:
        return jax.device_put(a, sharding)
    global_shape = (a.shape[0] * jax.process_count(),) + a.shape[1:]
    return jax.make_array_from_process_local_data(sharding, a, global_shape)


def local_rows(array) -> np.ndarray:
    """This process's rows of a batch-sharded global array (row order
    preserved, replicas dropped). Single host: the whole array.

    Handles 2-D shardings too (the long-context ``P('data','time',None)``
    layout): shards are reassembled by their global index slices into this
    process's contiguous row block, so time-sharded outputs come back as
    complete sequences."""
    if jax.process_count() == 1:
        return np.asarray(jax.device_get(array))
    # one copy per distinct index block: replica_id > 0 shards hold
    # identical data (e.g. devices along the model axis)
    shards = [s for s in array.addressable_shards if s.replica_id == 0]
    row_start = min((s.index[0].start or 0) for s in shards)
    row_stop = max((s.index[0].stop if s.index[0].stop is not None
                    else array.shape[0]) for s in shards)
    out = np.empty((row_stop - row_start,) + array.shape[1:],
                   dtype=array.dtype)
    # coverage is counted in ELEMENTS per row, not rows: under a 2-D
    # ('data','time') sharding a shard covers only a time-slice of its rows,
    # so a row-level flag could not detect a missing time shard and the gap
    # columns would come back as np.empty garbage
    row_elems = int(np.prod(array.shape[1:], dtype=np.int64))
    covered = np.zeros((row_stop - row_start,), np.int64)
    for s in shards:
        idx = list(s.index)
        r = idx[0]
        rows = slice((r.start or 0) - row_start,
                     (r.stop if r.stop is not None else array.shape[0])
                     - row_start)
        out[(rows,) + tuple(idx[1:])] = np.asarray(jax.device_get(s.data))
        elems = 1
        for dim, sl in enumerate(idx[1:], start=1):
            start = sl.start or 0
            stop = sl.stop if sl.stop is not None else array.shape[dim]
            elems *= stop - start
        covered[rows] += elems
    # guard the coverage assumption: replica_id==0 shards never overlap, so
    # every row must accumulate exactly its full element count — anything
    # less means this process's shards have gaps (non-adjacent row blocks,
    # or a missing time shard); fail loudly instead of returning garbage
    if not (covered == row_elems).all():
        raise AssertionError(
            "local_rows: this process's shards do not cover its row block "
            f"(rows {row_start}:{row_stop}, "
            f"{int((covered != row_elems).sum())} rows with gaps)")
    return out


def shard_batch(mesh: Mesh, *arrays):
    """Stage host arrays as globally-sharded batches (see :func:`put_batch`;
    callers provide per-process rows divisible by the local device count)."""
    out = [put_batch(mesh, a) for a in arrays]
    return out[0] if len(out) == 1 else tuple(out)


def pad_to_multiple(batch: np.ndarray, multiple: int):
    """Pad dim 0 up to a multiple (repeating the last row); returns
    (padded, real_count)."""
    n = batch.shape[0]
    rem = n % multiple
    if rem == 0:
        return batch, n
    pad = multiple - rem
    filler = np.repeat(batch[-1:], pad, axis=0)
    return np.concatenate([batch, filler], axis=0), n
