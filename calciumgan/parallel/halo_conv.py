"""Sequence-parallel 1-D convolution with halo exchange.

The reference handles long recordings purely offline (windowed segmentation,
``dataset/generate_tfrecords.py:81-89``) and never shards the time axis.
SURVEY.md §5.7 notes the extension: if sequences far beyond
sl2048 are ever needed, shard the time dimension across the mesh and
exchange K-1 frames of halo between neighbours — the convolution analogue of
context parallelism (small halos: kernel 24, 5 layers).

This module implements that primitive: a SAME-padded strided conv1d over an
input whose time axis is sharded across a mesh axis, built from
``shard_map`` + ``lax.ppermute`` ring exchanges between devices. Each shard:

1. sends its right edge to its right neighbour (which needs it as left
   halo) and its left edge to its left neighbour,
2. zero-pads at the global boundaries (SAME semantics),
3. runs a VALID conv over [left_halo | local | right_halo].

Alignment: with global width W, kernel K, stride s, SAME output ceil(W/s)
and total padding P = K - s (for W % s == 0), split L = P // 2. Output
element j reads inputs [j*s - L, j*s - L + K), so a shard of width Ws
(Ws % s == 0) needs a left halo of L and a right halo of K - s - L.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def halo_sizes(kernel: int, stride: int) -> tuple:
    """(left, right) halo frames per shard for SAME conv."""
    if kernel < stride:
        return 0, 0
    total = kernel - stride
    left = total // 2
    return left, total - left


def exchange_halos(x_local: jnp.ndarray, left: int, right: int, axis: str,
                   n_shards: int, edge_mode: str = "zero") -> jnp.ndarray:
    """[left_halo | local | right_halo] via ``ppermute`` ring exchanges.

    Must run inside a ``shard_map`` over mesh axis ``axis``; ``x_local`` is
    (B, Ws, C). Global-boundary halos are zeros (``edge_mode='zero'``, SAME
    conv) or the local reflection (``'reflect'``, phase shuffle — matching
    ``jnp.pad(mode='reflect')``: pad position j maps to x[pad - j]).

    Halos come from the IMMEDIATE neighbour only, so the shard width must
    cover the halo — the long-context regime this primitive exists for.
    (A silent jnp slice-clamp otherwise corrupts the exchange.)
    """
    if x_local.shape[1] < max(left, right) + (1 if edge_mode == "reflect"
                                              else 0):
        raise ValueError(
            f"shard width {x_local.shape[1]} smaller than halo "
            f"({left}, {right}): use fewer shards or longer sequences")
    idx = lax.axis_index(axis)
    parts = []
    if left > 0:
        from_left = lax.ppermute(
            x_local[:, -left:, :], axis,
            [(i, (i + 1) % n_shards) for i in range(n_shards)])
        if edge_mode == "reflect":
            refl = x_local[:, 1:left + 1, :][:, ::-1, :]
            from_left = jnp.where(idx == 0, refl, from_left)
        else:
            from_left = jnp.where(idx == 0, 0.0, from_left)
        parts.append(from_left)
    parts.append(x_local)
    if right > 0:
        from_right = lax.ppermute(
            x_local[:, :right, :], axis,
            [(i, (i - 1) % n_shards) for i in range(n_shards)])
        if edge_mode == "reflect":
            refl = x_local[:, -right - 1:-1, :][:, ::-1, :]
            from_right = jnp.where(idx == n_shards - 1, refl, from_right)
        else:
            from_right = jnp.where(idx == n_shards - 1, 0.0, from_right)
        parts.append(from_right)
    return jnp.concatenate(parts, axis=1)


def halo_conv1d_local(x_local: jnp.ndarray, kernel: jnp.ndarray, stride: int,
                      axis: str, n_shards: int) -> jnp.ndarray:
    """Shard-local body of the SAME strided conv (call inside shard_map)."""
    K = kernel.shape[0]
    if K < stride:
        raise ValueError(f"kernel {K} < stride {stride} is unsupported")
    if x_local.shape[1] % stride:
        # enforce the documented alignment precondition (module doc: SAME
        # output splits evenly only when W_shard % stride == 0) — a silent
        # pass here returns a misaligned, wrong-width conv
        raise ValueError(
            f"shard width {x_local.shape[1]} not divisible by stride "
            f"{stride}: choose n_shards so every shard is stride-aligned")
    left, right = halo_sizes(K, stride)
    x_ext = exchange_halos(x_local, left, right, axis, n_shards)
    return lax.conv_general_dilated(
        x_ext, kernel, window_strides=(stride,), padding="VALID",
        dimension_numbers=("NWC", "WIO", "NWC"))


def _conv_transpose_same_padding(kernel: int, stride: int) -> tuple:
    """(pad_a, pad_b) on the input-dilated array for SAME transpose conv —
    the same split ``lax.conv_transpose`` computes (out = in * stride)."""
    pad_len = kernel + stride - 2
    if stride > kernel - 1:
        pad_a = kernel - 1
    else:
        pad_a = -(-pad_len // 2)
    return pad_a, pad_len - pad_a


def halo_conv_transpose1d_local(x_local: jnp.ndarray, kernel: jnp.ndarray,
                                stride: int, axis: str,
                                n_shards: int) -> jnp.ndarray:
    """Shard-local SAME transpose conv (out width = Ws * stride).

    The global op is a conv over the stride-dilated input padded by
    (pad_a, pad_b); a shard's outputs [t0*s, (t0+Ws)*s) read dilated
    positions [t0*s - pad_a, ...], i.e. input samples from ceil(pad_a/s)
    (left) / ceil(pad_b/s) (right) neighbour frames. Exchange those halos,
    run the dilated conv VALID over the extension, and slice the local
    window at offset hl*s - pad_a. Matches ``flax.linen.ConvTranspose``
    (padding='SAME', NWC/WIO) exactly.
    """
    K = kernel.shape[0]
    pad_a, pad_b = _conv_transpose_same_padding(K, stride)
    hl = -(-pad_a // stride)
    hr = -(-pad_b // stride)
    Ws = x_local.shape[1]
    x_ext = exchange_halos(x_local, hl, hr, axis, n_shards)
    y = lax.conv_general_dilated(
        x_ext, kernel, window_strides=(1,), padding=((0, 0),),
        lhs_dilation=(stride,), dimension_numbers=("NWC", "WIO", "NWC"))
    u0 = hl * stride - pad_a
    return lax.slice_in_dim(y, u0, u0 + Ws * stride, axis=1)


def halo_conv1d(x: jnp.ndarray, kernel: jnp.ndarray, stride: int,
                mesh: Mesh, axis: str) -> jnp.ndarray:
    """SAME strided conv over a time-sharded (B, W, C) input.

    ``x``: W sharded over mesh axis ``axis`` (use via the returned jitted
    callable from :func:`make_halo_conv1d`, or call
    :func:`halo_conv1d_local` inside your own shard_map). ``kernel``:
    (K, C_in, C_out), replicated. Requires W_shard % stride == 0.
    """
    n_shards = mesh.shape[axis]

    def local(x_local, k_full):
        return halo_conv1d_local(x_local, k_full, stride, axis, n_shards)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, axis, None), P()),
        out_specs=P(None, axis, None),
        check_vma=False)(x, kernel)


def make_halo_conv1d(mesh: Mesh, axis: str, stride: int):
    """Jitted (x, kernel) -> y with W sharded over ``axis``."""
    def fn(x, kernel):
        return halo_conv1d(x, kernel, stride, mesh, axis)

    sharded = NamedSharding(mesh, P(None, axis, None))
    rep = NamedSharding(mesh, P())
    return jax.jit(fn, in_shardings=(sharded, rep), out_shardings=sharded)
