"""Sequence-parallel (context-parallel) CalciumGAN discriminator forward.

SURVEY.md §5.7: the reference never shards the time axis — long recordings
are windowed offline to sl2048. This module is the long-context
extension: the full 1-D discriminator stack (5 x [SAME strided conv ->
activation -> phase shuffle] -> flatten -> Dense(1), parity with
``gan/models/calciumgan.py:141-192``) over an input whose TIME axis is
sharded across a mesh axis. All cross-shard traffic rides ``lax.ppermute``
ring exchanges between devices:

- each conv exchanges its (K - s)-frame halo
  (:func:`calciumgan.parallel.halo_conv.halo_conv1d_local`),
- phase shuffle exchanges an m-frame halo with *reflect* global edges and
  dynamic-slices at the shifted offset — exactly
  :func:`calciumgan.ops.phase_shuffle.phase_shuffle` on the global
  sequence (one shift for the whole batch; the key must be replicated),
- the O(seq) Dense(1) head is computed as per-shard partial dot products
  over the shard's contiguous rows of the flattened (W, C) activations,
  joined by a ``psum``.

Shard widths must stay divisible by ``strides**5`` (so every layer's local
width divides the stride) and larger than ``m`` after the last shuffled
layer. With the paper recipe (kernel 24, stride 2, m=10) the halos are
max(22, m) frames per layer — negligible against shards of thousands of
frames.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from calciumgan.models import base
from calciumgan.parallel.halo_conv import (exchange_halos,
                                               halo_conv1d_local,
                                               halo_conv_transpose1d_local)


def halo_phase_shuffle_local(x_local: jnp.ndarray, key: jax.Array, m: int,
                             axis: str, n_shards: int) -> jnp.ndarray:
    """Global-sequence phase shuffle on a time-sharded (B, Ws, C) input.

    Must run inside a shard_map over ``axis`` with ``key`` replicated: every
    shard draws the same shift u ~ U{-m..m} and takes
    ``global_x[t + u]`` for its own rows, reflect-indexed at the global
    edges — bit-identical to ``ops.phase_shuffle.phase_shuffle`` applied to
    the gathered sequence.
    """
    if m == 0:
        return x_local
    width = x_local.shape[1]
    if width <= m:
        raise ValueError(f"shard width {width} must exceed m={m}")
    shift = jax.random.randint(key, (), -m, m + 1)
    x_ext = exchange_halos(x_local, m, m, axis, n_shards,
                           edge_mode="reflect")
    return lax.dynamic_slice(
        x_ext, (0, (m + shift).astype(jnp.int32), 0), x_local.shape)


def seq_parallel_discriminator(params, x, phase_keys, mesh: Mesh, axis: str,
                               *, strides: int, m: int,
                               activation: str = "leakyrelu",
                               batch_axis: str | None = None,
                               dtype=jnp.float32):
    """Discriminator forward over a time-sharded batch.

    Args:
        params: the ``Discriminator`` param dict (``Conv_0..Conv_4``,
            ``Dense_0``) — replicated.
        x: (B, W, C) with W sharded over ``axis``.
        phase_keys: one replicated PRNG key per shuffled layer (4 entries),
            or None for m=0 / eval.
        mesh, axis: the mesh and its time axis.
        dtype: compute dtype — mirrors the module ``dtype`` (params stay
            f32, inputs + params are cast before each matmul/conv so the
            bf16 mixed-precision recipe reaches the tensor cores here too).

    Returns:
        (B, 1) float32 critic scores, replicated.
    """
    n_shards = mesh.shape[axis]
    act = base.activation(activation)
    keys = list(phase_keys) if phase_keys is not None else [None] * 4

    def local(x_local, params):
        h = x_local.astype(dtype)
        for i in range(5):
            layer = params[f"Conv_{i}"]
            h = halo_conv1d_local(h, layer["kernel"].astype(dtype), strides,
                                  axis, n_shards)
            h = h + layer["bias"].astype(dtype)
            h = act(h)
            if i < 4 and m > 0 and keys[i] is not None:
                h = halo_phase_shuffle_local(h, keys[i], m, axis, n_shards)
        # flatten is (W, C) row-major, so shard idx owns the contiguous
        # kernel rows [idx*Ws*C, (idx+1)*Ws*C) of the global Dense input
        B, Ws, C = h.shape
        flat = h.reshape(B, Ws * C)
        head = params["Dense_0"]
        idx = lax.axis_index(axis)
        k_slice = lax.dynamic_slice(
            head["kernel"], (idx * Ws * C, 0), (Ws * C, 1))
        partial = flat @ k_slice.astype(dtype)
        out = lax.psum(partial, axis) + head["bias"].astype(dtype)
        return out.astype(jnp.float32)  # (B_local, 1); batch stays sharded

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(batch_axis, axis, None), P()),
        out_specs=P(batch_axis, None),
        check_vma=False)(x, params)


def seq_parallel_generator(params, z, mesh: Mesh, axis: str, *,
                           strides: int, activation: str = "leakyrelu",
                           normalize: bool = True,
                           batch_axis: str | None = None,
                           dtype=jnp.float32):
    """Generator forward producing a TIME-SHARDED (B, W, C) signal.

    The ``Generator`` (``models/calciumgan.py``) maps noise ->
    Dense -> reshape (w0, noise_dim) -> 5 x [SAME ConvTranspose -> norm ->
    act] -> Dense(C) -> sigmoid. Here every stage is shard-local: the input
    projection computes only this shard's ``w0/n`` positions (a column slice
    of the Dense kernel), the transpose convs exchange
    ceil(pad/stride)-frame halos
    (:func:`calciumgan.parallel.halo_conv.halo_conv_transpose1d_local`),
    and LayerNorm / the output Dense are per-position. BatchNorm is
    unsupported (its batch statistics would need cross-shard reduction).

    Args:
        params: the ``Generator`` param dict, replicated.
        z: (B, noise_dim), replicated.
        dtype: compute dtype (module ``dtype`` semantics: params stored f32,
            compute cast; LayerNorm statistics stay f32 exactly like
            ``base.layer_norm`` under a half-precision dtype).

    Returns:
        (B, W, C) float32 with W sharded over ``axis``.
    """
    n_shards = mesh.shape[axis]
    act = base.activation(activation)
    noise_dim = params["Dense_0"]["kernel"].shape[0]
    w0 = params["Dense_0"]["kernel"].shape[1] // noise_dim
    if w0 % n_shards:
        raise ValueError(f"w0={w0} not divisible by {n_shards} shards")
    ws0 = w0 // n_shards

    def local(z, params):
        idx = lax.axis_index(axis)
        d0 = params["Dense_0"]
        k_slice = lax.dynamic_slice(
            d0["kernel"], (0, idx * ws0 * noise_dim),
            (noise_dim, ws0 * noise_dim))
        b_slice = lax.dynamic_slice(
            d0["bias"], (idx * ws0 * noise_dim,), (ws0 * noise_dim,))
        h = act(z.astype(dtype) @ k_slice.astype(dtype)
                + b_slice.astype(dtype))
        h = h.reshape(z.shape[0], ws0, noise_dim)

        for i in range(5):
            layer = params[f"ConvTranspose_{i}"]
            h = halo_conv_transpose1d_local(h, layer["kernel"].astype(dtype),
                                            strides, axis, n_shards)
            h = h + layer["bias"].astype(dtype)
            norm = params.get(f"Norm_{i}", {})
            if "BatchNorm_0" in norm:
                raise ValueError(
                    "sequence-parallel generator does not support BatchNorm")
            if "LayerNorm_0" in norm:
                ln = norm["LayerNorm_0"]
                # base.layer_norm runs the WHOLE normalization in f32
                # under half dtypes (stats, rsqrt, scale, bias) and casts
                # only the result to the compute dtype
                h32 = h.astype(jnp.float32)
                mu = h32.mean(axis=-1, keepdims=True)
                var = ((h32 - mu) ** 2).mean(axis=-1, keepdims=True)
                h32 = (h32 - mu) * lax.rsqrt(var + 1e-3)
                h32 = (h32 * ln["scale"].astype(jnp.float32)
                       + ln["bias"].astype(jnp.float32))
                h = h32.astype(dtype)
            h = act(h)

        out = params["Dense_1"]
        h = h @ out["kernel"].astype(dtype) + out["bias"].astype(dtype)
        h = h.astype(jnp.float32)
        return jax.nn.sigmoid(h) if normalize else h

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(batch_axis, None), P()),
        out_specs=P(batch_axis, axis, None),
        check_vma=False)(z, params)


def make_seq_parallel_discriminator(mesh: Mesh, axis: str, *,
                                    strides: int, m: int,
                                    activation: str = "leakyrelu"):
    """Jitted (params, x, phase_keys) -> (B, 1) with W sharded over ``axis``."""
    def fn(params, x, phase_keys):
        return seq_parallel_discriminator(
            params, x, phase_keys, mesh, axis,
            strides=strides, m=m, activation=activation)

    sharded = NamedSharding(mesh, P(None, axis, None))
    rep = NamedSharding(mesh, P())
    return jax.jit(fn, in_shardings=(rep, sharded, rep), out_shardings=rep)
