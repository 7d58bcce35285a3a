"""Sequence-parallel discriminator: bit-parity with the unsharded model.

The long-context extension (SURVEY.md §5.7): the whole discriminator stack
runs over a time-sharded input with ppermute halo exchanges. Tests pin
exact equivalence against (a) the flax Discriminator module at m=0 and
(b) a manually-keyed unsharded forward (conv + activation + phase_shuffle)
at m>0, plus the phase-shuffle primitive against ops.phase_shuffle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from calciumgan.models import base
from calciumgan.models.calciumgan import Discriminator
from calciumgan.ops.phase_shuffle import phase_shuffle
from calciumgan.parallel.seq_parallel import (
    make_seq_parallel_discriminator, seq_parallel_discriminator)


def time_mesh(n=8):
    import numpy as _np
    return Mesh(_np.array(jax.devices()[:n]).reshape(n), ("time",))


def shard_time(mesh, x):
    return jax.device_put(x, NamedSharding(mesh, P(None, "time", None)))


@pytest.mark.slow
def test_halo_phase_shuffle_matches_unsharded(rng):
    from calciumgan.parallel.seq_parallel import halo_phase_shuffle_local

    mesh = time_mesh()
    x = rng.standard_normal((2, 512, 3)).astype(np.float32)
    m = 10
    for seed in (0, 1, 2, 3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(phase_shuffle(jnp.asarray(x), key, m, axis=1))

        def local(xl):
            return halo_phase_shuffle_local(xl, key, m, "time", 8)

        got = jax.shard_map(
            local, mesh=mesh, in_specs=P(None, "time", None),
            out_specs=P(None, "time", None),
            check_vma=False)(shard_time(mesh, x))
        np.testing.assert_array_equal(np.asarray(got), want)


def test_matches_flax_discriminator_m0(rng):
    # W/(shards * strides^4) must cover the K-s halo at the deepest layer
    W, C, u, k, s = 4096, 4, 4, 24, 2
    dis = Discriminator(num_units=u, kernel_size=k, strides=s, m=0)
    x = rng.standard_normal((2, W, C)).astype(np.float32)
    variables = dis.init(jax.random.PRNGKey(0), jnp.asarray(x),
                         training=False)
    want = np.asarray(dis.apply(variables, jnp.asarray(x), training=False))

    mesh = time_mesh()
    fn = make_seq_parallel_discriminator(mesh, "time", strides=s, m=0)
    got = fn(variables["params"], shard_time(mesh, x), None)
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-5)


@pytest.mark.slow
def test_matches_manual_forward_with_phase_shuffle(rng):
    W, C, u, k, s, m = 2048, 3, 2, 24, 2, 10
    dis = Discriminator(num_units=u, kernel_size=k, strides=s, m=m)
    x = rng.standard_normal((2, W, C)).astype(np.float32)
    params = dis.init(jax.random.PRNGKey(0), jnp.asarray(x),
                      training=False)["params"]
    keys = [jax.random.PRNGKey(100 + i) for i in range(4)]

    # unsharded reference forward with explicit per-layer keys
    act = base.activation("leakyrelu")
    h = jnp.asarray(x)
    for i in range(5):
        layer = params[f"Conv_{i}"]
        h = lax.conv_general_dilated(
            h, layer["kernel"], window_strides=(s,), padding="SAME",
            dimension_numbers=("NWC", "WIO", "NWC")) + layer["bias"]
        h = act(h)
        if i < 4:
            h = phase_shuffle(h, keys[i], m, axis=1)
    flat = h.reshape(h.shape[0], -1)
    want = np.asarray(flat @ params["Dense_0"]["kernel"]
                      + params["Dense_0"]["bias"])

    mesh = time_mesh()
    got = seq_parallel_discriminator(
        params, shard_time(mesh, x), keys, mesh, "time", strides=s, m=m)
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-4, rtol=2e-5)


def test_rejects_shards_narrower_than_halo(rng):
    import pytest

    mesh = time_mesh()
    x = rng.standard_normal((2, 1024, 4)).astype(np.float32)  # deep layer: 8
    dis = Discriminator(num_units=2, kernel_size=24, strides=2, m=0)
    params = dis.init(jax.random.PRNGKey(0), jnp.asarray(x),
                      training=False)["params"]
    with pytest.raises(ValueError, match="halo"):
        seq_parallel_discriminator(params, shard_time(mesh, x), None, mesh,
                                   "time", strides=2, m=0)


def test_halo_conv_transpose_matches_flax(rng):
    import flax.linen as nn
    from calciumgan.parallel.halo_conv import halo_conv_transpose1d_local

    mesh = time_mesh()
    for K, s in ((24, 2), (4, 2), (3, 4), (5, 1)):
        x = rng.standard_normal((2, 256, 3)).astype(np.float32)
        mod = nn.ConvTranspose(5, kernel_size=(K,), strides=(s,),
                               padding="SAME")
        variables = mod.init(jax.random.PRNGKey(K), jnp.asarray(x))
        want = np.asarray(mod.apply(variables, jnp.asarray(x)))
        kernel = variables["params"]["kernel"]
        bias = variables["params"]["bias"]

        def local(xl):
            return halo_conv_transpose1d_local(xl, kernel, s, "time", 8) \
                + bias

        got = jax.shard_map(
            local, mesh=mesh, in_specs=P(None, "time", None),
            out_specs=P(None, "time", None),
            check_vma=False)(shard_time(mesh, x))
        np.testing.assert_allclose(np.asarray(got), want, atol=2e-5,
                                   err_msg=f"K={K} s={s}")


@pytest.mark.slow
def test_seq_parallel_generator_matches_flax(rng):
    from calciumgan.models.calciumgan import Generator
    from calciumgan.parallel.seq_parallel import seq_parallel_generator

    mesh = time_mesh()
    for layer_norm in (True, False):
        gen = Generator(sequence_length=4096, num_channels=3, noise_dim=8,
                        num_units=2, kernel_size=24, strides=2,
                        layer_norm=layer_norm)
        z = rng.standard_normal((2, 8)).astype(np.float32)
        variables = gen.init(jax.random.PRNGKey(0), jnp.asarray(z),
                             training=False)
        want = np.asarray(gen.apply(variables, jnp.asarray(z),
                                    training=False))
        got = seq_parallel_generator(
            variables["params"], jnp.asarray(z), mesh, "time", strides=2)
        assert got.shape == want.shape == (2, 4096, 3)
        np.testing.assert_allclose(np.asarray(got), want, atol=3e-5,
                                   err_msg=f"layer_norm={layer_norm}")


def test_wgan_gp_gradients_match_through_shard_map(rng):
    """The full WGAN-GP critic loss — including the gradient penalty's
    second-order grad-of-grad — differentiates identically through the
    sequence-parallel discriminator, so a long-context WGAN-GP training
    step needs no new machinery beyond these primitives."""
    W, C, u, k, s = 2048, 3, 2, 24, 2
    dis = Discriminator(num_units=u, kernel_size=k, strides=s, m=0)
    real = rng.standard_normal((2, W, C)).astype(np.float32)
    fake = rng.standard_normal((2, W, C)).astype(np.float32)
    params = dis.init(jax.random.PRNGKey(0), jnp.asarray(real),
                      training=False)["params"]
    alpha = rng.random((2, 1, 1)).astype(np.float32)
    mesh = time_mesh()

    def make_loss(d):
        def loss(p, real, fake):
            apply = lambda x: d(p, x)
            x_hat = alpha * real + (1 - alpha) * fake
            g = jax.grad(lambda x: jnp.sum(apply(x)))(x_hat)
            norm = jnp.sqrt(jnp.sum(g.reshape(g.shape[0], -1) ** 2, 1)
                            + 1e-12)
            gp = jnp.mean((norm - 1.0) ** 2)
            return (-jnp.mean(apply(real)) + jnp.mean(apply(fake))
                    + 10.0 * gp)
        return loss

    l0, g0 = jax.value_and_grad(make_loss(
        lambda p, x: dis.apply({"params": p}, x, training=False)))(
            params, jnp.asarray(real), jnp.asarray(fake))
    l1, g1 = jax.jit(jax.value_and_grad(make_loss(
        lambda p, x: seq_parallel_discriminator(p, x, None, mesh, "time",
                                                strides=s, m=0))))(
            params, shard_time(mesh, real), shard_time(mesh, fake))

    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=5e-5,
                                   rtol=1e-4)
