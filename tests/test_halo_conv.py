"""Sequence-parallel halo-exchange conv vs the unsharded SAME conv."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from calciumgan.parallel.halo_conv import make_halo_conv1d
from calciumgan.parallel.mesh import create_mesh, DATA_AXIS


def _reference_conv(x, kernel, stride):
    return lax.conv_general_dilated(
        x, kernel, window_strides=(stride,), padding="SAME",
        dimension_numbers=("NWC", "WIO", "NWC"))


@pytest.mark.parametrize("K,stride,W", [
    (24, 2, 256), (24, 1, 128), (4, 2, 64), (5, 1, 64), (3, 3, 192),
])
def test_halo_conv_matches_unsharded(rng, K, stride, W):
    mesh = create_mesh(8, 1)
    x = rng.normal(size=(2, W, 3)).astype(np.float32)
    kernel = rng.normal(size=(K, 3, 5)).astype(np.float32)

    expected = np.asarray(_reference_conv(jnp.asarray(x),
                                          jnp.asarray(kernel), stride))

    fn = make_halo_conv1d(mesh, DATA_AXIS, stride)
    xs = jax.device_put(x, NamedSharding(mesh, P(None, DATA_AXIS, None)))
    ks = jax.device_put(kernel, NamedSharding(mesh, P()))
    out = np.asarray(jax.device_get(fn(xs, ks)))

    assert out.shape == expected.shape
    np.testing.assert_allclose(out, expected, rtol=1e-5, atol=1e-5)


def test_halo_conv_rejects_kernel_smaller_than_stride(rng):
    mesh = create_mesh(8, 1)
    fn = make_halo_conv1d(mesh, DATA_AXIS, stride=4)
    x = jax.device_put(rng.normal(size=(1, 64, 2)).astype(np.float32),
                       NamedSharding(mesh, P(None, DATA_AXIS, None)))
    k = jax.device_put(rng.normal(size=(2, 2, 2)).astype(np.float32),
                       NamedSharding(mesh, P()))
    with pytest.raises(ValueError, match="unsupported"):
        fn(x, k)


def test_halo_conv_rejects_stride_misaligned_shards(rng):
    """W=240 over 8 shards gives Ws=30, not divisible by stride 4: the
    sharded SAME conv cannot split the output evenly and must raise rather
    than return a silently misaligned result."""
    mesh = create_mesh(8, 1)
    fn = make_halo_conv1d(mesh, DATA_AXIS, stride=4)
    x = jax.device_put(rng.normal(size=(1, 240, 2)).astype(np.float32),
                       NamedSharding(mesh, P(None, DATA_AXIS, None)))
    k = jax.device_put(rng.normal(size=(8, 2, 2)).astype(np.float32),
                       NamedSharding(mesh, P()))
    with pytest.raises(ValueError, match="not divisible by stride"):
        fn(x, k)
