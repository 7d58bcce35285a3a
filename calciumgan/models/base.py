"""Shared building blocks for the model zoo, in plain ``jax.numpy``/``lax``.

Keras-parity choices (so architectures train like the reference's):
- glorot_uniform kernel init, zero bias (Keras Dense/Conv defaults),
- LeakyReLU alpha 0.3 (Keras default, used via ``activation_fn('leakyrelu')``
  — reference ``gan/models/utils.py:6-8``),
- LayerNorm/BatchNorm epsilon 1e-3 (Keras defaults),
- generator/discriminator outputs forced float32 under mixed precision
  (reference ``calciumgan.py:99-101,190``).

Departures from the reference:
- a real 1-D SAME conv-transpose instead of the reference's
  expand-dims/Conv2DTranspose/squeeze emulation (``models/utils.py:65-94``,
  needed because TF 2.3 lacked Conv1DTranspose),
- phase shuffle consumes an explicit RNG stream ``'phase'``
  (see :mod:`calciumgan.ops.phase_shuffle`).

Models are small frozen dataclasses over a :class:`Scope`. They keep the
surface and the variable tree of the ``flax.linen`` modules they replace:
``init(rngs, x, training=False)`` returns ``{'params': ...,
'batch_stats': ...}`` with layers named ``Dense_0``, ``Conv_0``,
``ConvTranspose_0``, ``Norm_0/LayerNorm_0`` and so on, and
``apply(variables, x, training, rngs, mutable)`` runs the network. The
layers compute in the module dtype from float32 parameters, as Flax does,
and the normalisation statistics stay in float32.
"""

from __future__ import annotations

import math
import zlib
from typing import Any, Callable, Dict, Optional, Sequence

import jax
import jax.numpy as jnp
from jax import lax

Dtype = Any

glorot = jax.nn.initializers.glorot_uniform


def activation(name: str) -> Callable[[jnp.ndarray], jnp.ndarray]:
    if name == "leakyrelu":
        return lambda x: jax.nn.leaky_relu(x, negative_slope=0.3)
    if name == "linear":
        return lambda x: x
    return getattr(jax.nn, name)


def count_params(params) -> int:
    return sum(int(math.prod(p.shape)) for p in jax.tree.leaves(params))


def param_table(params) -> str:
    """One line per parameter: tree path, shape and size."""
    lines = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = jax.tree_util.keystr(path, simple=True, separator="/")
        lines.append(f"{name:48s} {str(tuple(leaf.shape)):20s} "
                     f"{int(math.prod(leaf.shape)):>12,d}")
    lines.append(f"{'total':69s} {count_params(params):>12,d}")
    return "\n".join(lines)


def noise_width(sequence_length: int, strides: int,
                num_convolutions: int = 5) -> int:
    """Validated initial temporal width for the transpose-conv stack
    (reference ``calculate_noise_shape`` — ``calciumgan.py:15-19``)."""
    w = sequence_length / (strides ** num_convolutions)
    if not float(w).is_integer():
        raise ValueError(
            f"sequence_length {sequence_length} not divisible by "
            f"strides**{num_convolutions} ({strides ** num_convolutions}); "
            f"w={w} is not an integer")
    return int(w)


# ---------------------------------------------------------------------------
# variable scope
# ---------------------------------------------------------------------------

class Scope:
    """Where one network's layers find their variables.

    At init (``init_key`` given) a missing parameter is created from a key
    folded from its path; at apply every parameter must already exist.
    Nested dicts appear only once a layer below them owns a variable, as in
    Flax. ``rngs`` maps a stream name ('phase', 'dropout') to a key; each
    draw folds in a per-stream counter, so every call site gets its own
    key."""

    def __init__(self, params: dict, batch_stats: dict,
                 rngs: Optional[Dict[str, jax.Array]] = None,
                 init_key: Optional[jax.Array] = None,
                 path: tuple = (), root: Optional["Scope"] = None):
        self._params = params
        self._stats = batch_stats
        self.rngs = dict(rngs or {})
        self.init_key = init_key
        self.path = path
        self._root = root or self
        if root is None:
            self.new_stats: dict = {}
            self._draws: Dict[str, int] = {}

    def child(self, name: str) -> "Scope":
        return Scope(self._params, self._stats, self.rngs, self.init_key,
                     self.path + (name,), self._root)

    def _node(self, tree: dict, create: bool) -> Optional[dict]:
        for name in self.path:
            if name not in tree:
                if not create:
                    return None
                tree[name] = {}
            tree = tree[name]
        return tree

    def param(self, name: str, init_fn, shape: Sequence[int]) -> jnp.ndarray:
        node = self._node(self._params, create=self.init_key is not None)
        if node is None or name not in node:
            if self.init_key is None:
                raise KeyError(f"missing parameter {'/'.join(self.path)}/"
                               f"{name}")
            tag = "/".join(self.path + (name,)).encode()
            key = jax.random.fold_in(self.init_key, zlib.crc32(tag))
            node[name] = init_fn(key, tuple(shape), jnp.float32)
        return node[name]

    def stat(self, name: str, init_fn, shape: Sequence[int]) -> jnp.ndarray:
        node = self._node(self._stats, create=self.init_key is not None)
        if node is None or name not in node:
            if self.init_key is None:
                raise KeyError(f"missing batch stat {'/'.join(self.path)}/"
                               f"{name}")
            node[name] = init_fn(tuple(shape), jnp.float32)
        return node[name]

    def set_stat(self, name: str, value: jnp.ndarray) -> None:
        tree = self._root.new_stats
        for part in self.path:
            tree = tree.setdefault(part, {})
        tree[name] = value

    def make_rng(self, stream: str) -> jax.Array:
        if stream not in self.rngs:
            raise ValueError(f"no '{stream}' key given: pass "
                             f"rngs={{'{stream}': key}}")
        count = self._root._draws.get(stream, 0)
        self._root._draws[stream] = count + 1
        return jax.random.fold_in(self.rngs[stream], count)


class Module:
    """A network over a :class:`Scope`; subclasses define ``forward``."""

    def forward(self, scope: Scope, x, training: bool):
        raise NotImplementedError

    def init(self, rngs, x, training: bool = False) -> dict:
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        rngs = dict(rngs)
        scope = Scope({}, {}, rngs=rngs, init_key=rngs.pop("params"))
        self.forward(scope, x, training)
        variables = {"params": scope._params}
        if scope._stats:
            variables["batch_stats"] = scope._stats
        return variables

    def apply(self, variables: dict, x, training: bool = True, rngs=None,
              mutable=False):
        """Run the network. With ``mutable`` (any truthy value, e.g.
        ``['batch_stats']``) also return ``{'batch_stats': updated}``."""
        scope = Scope(variables["params"], variables.get("batch_stats", {}),
                      rngs=rngs)
        out = self.forward(scope, x, training)
        if mutable:
            return out, {"batch_stats": scope.new_stats}
        return out


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _bias_add(y: jnp.ndarray, bias: jnp.ndarray) -> jnp.ndarray:
    return y + bias.astype(y.dtype).reshape((1,) * (y.ndim - 1) + (-1,))


def dense(scope: Scope, x: jnp.ndarray, features: int,
          dtype: Dtype) -> jnp.ndarray:
    kernel = scope.param("kernel", glorot(), (x.shape[-1], features))
    bias = scope.param("bias", jax.nn.initializers.zeros, (features,))
    y = lax.dot_general(x.astype(dtype), kernel.astype(dtype),
                        (((x.ndim - 1,), (0,)), ((), ())))
    return _bias_add(y, bias)


def _spatial_dims(ndim: int):
    names = "HWD"[:ndim - 2] if ndim > 3 else "W"
    return ("N" + names + "C", names + "IO", "N" + names + "C")


def conv(scope: Scope, x: jnp.ndarray, features: int,
         kernel_size: Sequence[int], strides: Sequence[int],
         dtype: Dtype) -> jnp.ndarray:
    """SAME-padded strided convolution over (N, *spatial, C)."""
    kernel = scope.param("kernel", glorot(),
                         tuple(kernel_size) + (x.shape[-1], features))
    bias = scope.param("bias", jax.nn.initializers.zeros, (features,))
    y = lax.conv_general_dilated(
        x.astype(dtype), kernel.astype(dtype), tuple(strides), "SAME",
        dimension_numbers=_spatial_dims(x.ndim))
    return _bias_add(y, bias)


def conv_transpose(scope: Scope, x: jnp.ndarray, features: int,
                   kernel_size: Sequence[int], strides: Sequence[int],
                   dtype: Dtype) -> jnp.ndarray:
    """SAME-padded transposed convolution (``lax.conv_transpose``, kernel
    not flipped), output width = input width x stride."""
    kernel = scope.param("kernel", glorot(),
                         tuple(kernel_size) + (x.shape[-1], features))
    bias = scope.param("bias", jax.nn.initializers.zeros, (features,))
    y = lax.conv_transpose(x.astype(dtype), kernel.astype(dtype),
                           tuple(strides), "SAME",
                           dimension_numbers=_spatial_dims(x.ndim))
    return _bias_add(y, bias)


def _normalize(scope: Scope, x, mean, var, dtype: Dtype) -> jnp.ndarray:
    """(x - mean) * rsqrt(var + eps) * scale + bias, in float32 from
    float32 statistics, cast to ``dtype``."""
    features = (x.shape[-1],)
    scale = scope.param("scale", jax.nn.initializers.ones, features)
    bias = scope.param("bias", jax.nn.initializers.zeros, features)
    y = x.astype(jnp.float32) - mean
    y = y * (lax.rsqrt(var + 1e-3) * scale)
    return (y + bias).astype(dtype)


def _moments(x: jnp.ndarray, axes) -> tuple:
    """Float32 mean and variance as E[x^2] - E[x]^2, clipped at 0."""
    x = x.astype(jnp.float32)
    mean = x.mean(axes, keepdims=True)
    mean2 = jnp.square(x).mean(axes, keepdims=True)
    return mean, jnp.maximum(0.0, mean2 - jnp.square(mean))


def layer_norm(scope: Scope, x: jnp.ndarray, dtype: Dtype) -> jnp.ndarray:
    mean, var = _moments(x, -1)
    return _normalize(scope, x, mean, var, dtype)


def batch_norm(scope: Scope, x: jnp.ndarray, training: bool,
               dtype: Dtype, momentum: float = 0.99) -> jnp.ndarray:
    """Batch statistics in training (running averages updated with
    ``momentum``), running averages otherwise."""
    features = (x.shape[-1],)
    ra_mean = scope.stat("mean", jnp.zeros, features)
    ra_var = scope.stat("var", jnp.ones, features)
    if training:
        mean, var = _moments(x, tuple(range(x.ndim - 1)))
        scope.set_stat("mean", momentum * ra_mean
                       + (1 - momentum) * mean.reshape(features))
        scope.set_stat("var", momentum * ra_var
                       + (1 - momentum) * var.reshape(features))
    else:
        mean, var = ra_mean, ra_var
    return _normalize(scope, x, mean, var, dtype)


def norm(scope: Scope, x: jnp.ndarray, training: bool, batch: bool,
         layer: bool, dtype: Dtype) -> jnp.ndarray:
    """Optional BatchNorm and/or LayerNorm, applied in the reference's order
    (batch_norm then layer_norm — ``calciumgan.py:42-45``).

    Deliberate deviation: LayerNorm is SKIPPED when the feature axis has
    size 1. Normalising a single element yields exactly its (zero-init)
    bias, independent of the input — in the reference this makes the
    ``calciumgan2d`` generator's final layer (filters=num_channels=1 for
    non-fft data, ``calciumgan2d.py:93-103``) emit a trainable constant and
    cuts all gradient flow to the conv stack below, so conv2d + layer_norm
    silently cannot train there. Skipping the no-op norm keeps the model
    trainable; layers with >1 channel are normalised as usual."""
    if batch:
        x = batch_norm(scope.child("BatchNorm_0"), x, training, dtype)
    if layer and x.shape[-1] > 1:
        x = layer_norm(scope.child("LayerNorm_0"), x, dtype)
    return x


def dropout(scope: Scope, x: jnp.ndarray, rate: float,
            training: bool) -> jnp.ndarray:
    """Inverted dropout from the 'dropout' stream; identity when not
    training or at rate 0."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = jax.random.bernoulli(scope.make_rng("dropout"), keep, x.shape)
    return jnp.where(mask, x / keep, jnp.zeros_like(x))
