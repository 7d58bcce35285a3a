"""The plain-JAX layers and models against ``flax.linen``, which the package
no longer uses but which is an independent implementation of the same
layers: identical variable trees, and identical outputs from identical
variables, in float32 and bfloat16."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

nn = pytest.importorskip("flax.linen")

from calciumgan.config import Config  # noqa: E402
from calciumgan.models import base, get_models  # noqa: E402

DTYPES = [jnp.float32, jnp.bfloat16]


def _tol(dtype):
    # same lax ops on the same backend: float32 agrees to rounding; bf16
    # outputs may differ by one bf16 ulp where XLA fuses differently
    return dict(rtol=1e-5, atol=1e-6) if dtype == jnp.float32 else dict(
        rtol=1e-2, atol=1e-2)


def _assert_same_tree(a, b):
    sa = jax.tree_util.tree_map(lambda x: (x.shape, x.dtype), a)
    sb = jax.tree_util.tree_map(lambda x: (x.shape, x.dtype), b)
    assert sa == sb


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **_tol(dtype))


# ---- flax references of the layers --------------------------------------

class FlaxLayer(nn.Module):
    kind: str
    dtype: object

    @nn.compact
    def __call__(self, x, training=False):
        glorot = nn.initializers.glorot_uniform()
        if self.kind == "dense":
            return nn.Dense(5, kernel_init=glorot, dtype=self.dtype)(x)
        if self.kind == "conv1d":
            return nn.Conv(5, (4,), (2,), padding="SAME", kernel_init=glorot,
                           dtype=self.dtype)(x)
        if self.kind == "conv2d":
            return nn.Conv(5, (4, 4), (4, 1), padding="SAME",
                           kernel_init=glorot, dtype=self.dtype)(x)
        if self.kind == "conv_transpose1d":
            return nn.ConvTranspose(5, (4,), (2,), padding="SAME",
                                    kernel_init=glorot, dtype=self.dtype)(x)
        if self.kind == "conv_transpose2d":
            return nn.ConvTranspose(5, (3, 3), (2, 2), padding="SAME",
                                    kernel_init=glorot, dtype=self.dtype)(x)
        if self.kind == "layer_norm":
            return nn.LayerNorm(epsilon=1e-3, dtype=self.dtype)(x)
        if self.kind == "batch_norm":
            return nn.BatchNorm(use_running_average=not training,
                                momentum=0.99, epsilon=1e-3,
                                dtype=self.dtype)(x)
        raise ValueError(self.kind)


@dataclasses.dataclass(frozen=True)
class PlainLayer(base.Module):
    kind: str
    dtype: object

    def forward(self, scope, x, training=False):
        if self.kind == "dense":
            return base.dense(scope.child("Dense_0"), x, 5, self.dtype)
        if self.kind == "conv1d":
            return base.conv(scope.child("Conv_0"), x, 5, (4,), (2,),
                             self.dtype)
        if self.kind == "conv2d":
            return base.conv(scope.child("Conv_0"), x, 5, (4, 4), (4, 1),
                             self.dtype)
        if self.kind == "conv_transpose1d":
            return base.conv_transpose(scope.child("ConvTranspose_0"), x, 5,
                                       (4,), (2,), self.dtype)
        if self.kind == "conv_transpose2d":
            return base.conv_transpose(scope.child("ConvTranspose_0"), x, 5,
                                       (3, 3), (2, 2), self.dtype)
        if self.kind == "layer_norm":
            return base.layer_norm(scope.child("LayerNorm_0"), x, self.dtype)
        if self.kind == "batch_norm":
            return base.batch_norm(scope.child("BatchNorm_0"), x, training,
                                   self.dtype)
        raise ValueError(self.kind)


_SHAPES = {"dense": (4, 7, 3), "conv1d": (2, 16, 3), "conv2d": (2, 16, 6, 3),
           "conv_transpose1d": (2, 8, 3), "conv_transpose2d": (2, 4, 3, 3),
           "layer_norm": (4, 9, 6), "batch_norm": (4, 9, 6)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", sorted(_SHAPES))
def test_layer_matches_flax(kind, dtype):
    x = jax.random.normal(jax.random.PRNGKey(0), _SHAPES[kind]) * 2 + 0.5
    ours, theirs = PlainLayer(kind, dtype), FlaxLayer(kind, dtype)
    variables = ours.init(jax.random.PRNGKey(1), x)
    # random (not init-valued) scale, bias and running stats
    variables = jax.tree_util.tree_map(
        lambda v: v + 0.1 * jax.random.normal(jax.random.PRNGKey(2),
                                              v.shape), variables)
    _assert_same_tree(variables, theirs.init(jax.random.PRNGKey(1), x))
    for training in (False, True):
        mutable = ["batch_stats"] if "batch_stats" in variables else False
        got = ours.apply(variables, x, training=training, mutable=mutable)
        want = theirs.apply(variables, x, training=training,
                            mutable=mutable)
        if mutable:
            (got, got_vars), (want, want_vars) = got, want
            for a, b in zip(jax.tree_util.tree_leaves(got_vars),
                            jax.tree_util.tree_leaves(want_vars)):
                _close(a, b, jnp.float32)
        assert got.dtype == want.dtype
        _close(got, want, dtype)


# ---- flax references of the three models --------------------------------

def _act(x):
    return nn.leaky_relu(x, negative_slope=0.3)


class Norm(nn.Module):  # flax names it Norm_i, like the package
    batch_norm: bool
    layer_norm: bool
    dtype: object

    @nn.compact
    def __call__(self, x, training):
        if self.batch_norm:
            x = nn.BatchNorm(use_running_average=not training, momentum=0.99,
                             epsilon=1e-3, dtype=self.dtype)(x)
        if self.layer_norm and x.shape[-1] > 1:
            x = nn.LayerNorm(epsilon=1e-3, dtype=self.dtype)(x)
        return x


def _dense(f, dtype):
    return nn.Dense(f, kernel_init=nn.initializers.glorot_uniform(),
                    dtype=dtype)


class FlaxGenerator(nn.Module):
    cfg: object
    dtype: object
    two_d: bool = False

    @nn.compact
    def __call__(self, z, training=False):
        c = self.cfg
        sl, neurons = c.signal_shape[0], c.signal_shape[1]
        w0 = sl // c.strides ** 5
        glorot = nn.initializers.glorot_uniform()
        if self.two_d:
            k = (c.kernel_size, c.kernel_size)
            x = _act(_dense(w0 * (neurons // 2) * c.noise_dim, self.dtype)(z))
            x = x.reshape((x.shape[0], w0, neurons // 2, c.noise_dim))
            filters = [c.num_units * 5, c.num_units * 3, c.num_units * 2,
                       c.num_units, c.num_channels]
            strides = [(c.strides, 2 if i == 2 else 1) for i in range(5)]
        else:
            k = (c.kernel_size,)
            x = _act(_dense(w0 * c.noise_dim, self.dtype)(z))
            x = x.reshape((x.shape[0], w0, c.noise_dim))
            filters = [c.num_units * m for m in (5, 4, 3, 2)] + [
                c.num_channels]
            strides = [(c.strides,)] * 5
        for f, s in zip(filters, strides):
            x = nn.ConvTranspose(f, k, s, padding="SAME", kernel_init=glorot,
                                 dtype=self.dtype)(x)
            x = Norm(c.batch_norm, c.layer_norm, self.dtype)(x, training)
            x = _act(x)
        x = _dense(c.num_channels, self.dtype)(x).astype(jnp.float32)
        return nn.sigmoid(x)


class FlaxDiscriminator(nn.Module):
    cfg: object
    dtype: object
    two_d: bool = False

    @nn.compact
    def __call__(self, x, training=False):
        c = self.cfg
        glorot = nn.initializers.glorot_uniform()
        k, s = ((16, 16), (4, 1)) if self.two_d else ((c.kernel_size,),
                                                      (c.strides,))
        for m in (1, 2, 3, 4, 5):
            x = _act(nn.Conv(c.num_units * m, k, s, padding="SAME",
                             kernel_init=glorot, dtype=self.dtype)(x))
        x = x.reshape((x.shape[0], -1))
        return _dense(1, self.dtype)(x).astype(jnp.float32)


class FlaxMLPGenerator(nn.Module):
    cfg: object
    dtype: object

    @nn.compact
    def __call__(self, z, training=False):
        c = self.cfg
        x = _act(_dense(c.signal_shape[0] * c.noise_dim, self.dtype)(z))
        x = x.reshape((x.shape[0], c.signal_shape[0], c.noise_dim))
        for m in (1, 2, 3):
            x = _act(_dense(c.num_units * m, self.dtype)(x))
        x = _dense(c.num_channels, self.dtype)(x).astype(jnp.float32)
        return nn.sigmoid(x)


class FlaxMLPDiscriminator(nn.Module):
    cfg: object
    dtype: object

    @nn.compact
    def __call__(self, x, training=False):
        c = self.cfg
        for m in (4, 3, 2, 1):
            x = _act(_dense(c.num_units * m, self.dtype)(x))
        x = x.reshape((x.shape[0], -1))
        return _dense(1, self.dtype)(x).astype(jnp.float32)


def _config(model, dtype, **kw):
    two_d = model == "calciumgan2d"
    cfg = Config(
        model=model, sequence_length=64, num_neurons=6,
        num_channels=1 if two_d else 6,
        signal_shape=(64, 6, 1) if two_d else (64, 6), noise_dim=8,
        num_units=4, kernel_size=4, strides=2, m=0, n=0, normalize=True,
        layer_norm=True, mixed_precision=dtype == jnp.bfloat16, dropout=0.2)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _flax_models(model, cfg, dtype):
    if model == "mlp":
        return FlaxMLPGenerator(cfg, dtype), FlaxMLPDiscriminator(cfg, dtype)
    two_d = model == "calciumgan2d"
    return (FlaxGenerator(cfg, dtype, two_d),
            FlaxDiscriminator(cfg, dtype, two_d))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model,extra", [
    ("calciumgan", {}), ("calciumgan", {"batch_norm": True}),
    ("calciumgan2d", {}), ("mlp", {})])
def test_model_matches_flax(model, extra, dtype):
    """Generator and discriminator: same variable tree as the Flax modules
    (so ``parallel/mesh._param_spec`` and parameter counts hold), same
    outputs from the same variables, and for BatchNorm the same updated
    running statistics."""
    cfg = _config(model, dtype, **extra)
    gen, dis = get_models(cfg)
    fgen, fdis = _flax_models(model, cfg, dtype)
    z = jax.random.normal(jax.random.PRNGKey(0), (4, cfg.noise_dim))
    gvars = gen.init({"params": jax.random.PRNGKey(1)}, z)
    _assert_same_tree(gvars, fgen.init(jax.random.PRNGKey(1), z))
    training = bool(extra.get("batch_norm"))
    if training:
        got, got_stats = gen.apply(gvars, z, training=True,
                                   mutable=["batch_stats"])
        want, want_stats = fgen.apply(gvars, z, training=True,
                                      mutable=["batch_stats"])
        _assert_same_tree(got_stats, want_stats)
        for a, b in zip(jax.tree_util.tree_leaves(got_stats),
                        jax.tree_util.tree_leaves(want_stats)):
            _close(a, b, dtype)
    else:
        got = gen.apply(gvars, z, training=False)
        want = fgen.apply(gvars, z)
    assert got.dtype == want.dtype == jnp.float32
    _close(got, want, dtype)

    x = jnp.asarray(want)
    dvars = dis.init({"params": jax.random.PRNGKey(2)}, x)
    _assert_same_tree(dvars, fdis.init(jax.random.PRNGKey(2), x))
    _close(dis.apply(dvars, x, training=False), fdis.apply(dvars, x), dtype)
