"""Model zoo: shapes, registry, phase shuffle, divisibility validation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from calciumgan.config import Config
from calciumgan.models import get_models
from calciumgan.models.base import count_params, noise_width
from calciumgan.ops.phase_shuffle import phase_shuffle


def tiny_config(model="calciumgan", **kw):
    cfg = Config(
        model=model, sequence_length=64, num_neurons=6, num_channels=6,
        signal_shape=(64, 6), noise_dim=8, num_units=4, kernel_size=4,
        strides=2, m=2, n=1, normalize=True, layer_norm=True)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def init_and_run(cfg, batch=4):
    gen, dis = get_models(cfg)
    rng = jax.random.PRNGKey(0)
    noise = jnp.zeros((batch, cfg.noise_dim))
    gvars = gen.init({"params": rng, "dropout": rng}, noise, training=False)
    fake = gen.apply(gvars, noise, training=False,
                     rngs={"dropout": rng})
    dvars = dis.init({"params": rng, "phase": rng, "dropout": rng}, fake,
                     training=False)
    out = dis.apply(dvars, fake, training=True,
                    rngs={"phase": rng, "dropout": rng})
    return fake, out, gvars, dvars


def test_calciumgan_shapes():
    cfg = tiny_config()
    fake, out, gvars, dvars = init_and_run(cfg)
    assert fake.shape == (4, 64, 6)
    assert out.shape == (4, 1)
    assert fake.dtype == jnp.float32
    # normalised data -> sigmoid output in [0, 1]
    assert float(fake.min()) >= 0.0 and float(fake.max()) <= 1.0
    assert count_params(gvars["params"]) > 0


def test_calciumgan2d_shapes():
    cfg = tiny_config(model="calciumgan2d", signal_shape=(64, 6, 1),
                      num_channels=1)
    gen, dis = get_models(cfg)
    rng = jax.random.PRNGKey(0)
    noise = jnp.zeros((2, cfg.noise_dim))
    gvars = gen.init({"params": rng, "dropout": rng}, noise, training=False)
    fake = gen.apply(gvars, noise, training=False, rngs={"dropout": rng})
    assert fake.shape == (2, 64, 6, 1)
    dvars = dis.init({"params": rng, "phase": rng, "dropout": rng}, fake,
                     training=False)
    out = dis.apply(dvars, fake, training=True,
                    rngs={"phase": rng, "dropout": rng})
    assert out.shape == (2, 1)


def test_calciumgan2d_layer_norm_keeps_gradient_flow():
    """LayerNorm over the final size-1 channel axis would emit a trainable
    constant (independent of the noise) and zero every gradient below it —
    the reference's conv2d + layer_norm pathology (see base.Norm). The
    size-1 norm is skipped, so the output must depend on the noise and the
    first conv-transpose must receive nonzero gradient."""
    cfg = tiny_config(model="calciumgan2d", signal_shape=(64, 6, 1),
                      num_channels=1)
    gen, _ = get_models(cfg)
    rng = jax.random.PRNGKey(0)
    noise = jax.random.normal(rng, (4, cfg.noise_dim))
    gvars = gen.init({"params": rng, "dropout": rng}, noise, training=False)
    fake = gen.apply(gvars, noise, training=False, rngs={"dropout": rng})
    assert float(jnp.std(fake, axis=0).mean()) > 0.0

    def loss(params):
        out = gen.apply({**gvars, "params": params}, noise, training=True,
                        rngs={"dropout": rng})
        return jnp.sum(jnp.square(out))

    grads = jax.grad(loss)(gvars["params"])
    first_conv = [v for k, v in sorted(grads.items()) if "ConvTranspose" in k]
    assert first_conv, f"no ConvTranspose grads in {list(grads)}"
    assert float(jnp.abs(first_conv[0]["kernel"]).max()) > 0.0


def test_mlp_shapes():
    cfg = tiny_config(model="mlp")
    fake, out, _, _ = init_and_run(cfg)
    assert fake.shape == (4, 64, 6)
    assert out.shape == (4, 1)


def test_wavegan_alias_resolves():
    cfg = tiny_config(model="wavegan")
    fake, _, _, _ = init_and_run(cfg)
    assert fake.shape == (4, 64, 6)


def test_divisibility_error():
    with pytest.raises(ValueError):
        noise_width(100, 3)
    assert noise_width(64, 2) == 2


def test_mixed_precision_outputs_float32():
    cfg = tiny_config(mixed_precision=True)
    fake, out, _, _ = init_and_run(cfg)
    assert fake.dtype == jnp.float32
    assert out.dtype == jnp.float32


# ---- phase shuffle -------------------------------------------------------

def test_phase_shuffle_m0_identity():
    x = jnp.arange(24.0).reshape(1, 12, 2)
    assert (phase_shuffle(x, jax.random.PRNGKey(0), 0) == x).all()


def test_phase_shuffle_matches_reference_semantics():
    """out[i] = x[i+shift] in-range, reflect-padded out of range
    (reference calciumgan.py:117-138)."""
    m, w = 3, 12
    x = np.arange(w, dtype=np.float32)
    xb = jnp.asarray(x)[None, :, None]
    for seed in range(20):
        key = jax.random.PRNGKey(seed)
        shift = int(jax.random.randint(key, (), -m, m + 1))
        out = np.asarray(phase_shuffle(xb, key, m))[0, :, 0]
        if shift > 0:
            padded = np.concatenate([x, x[-2:-2 - shift:-1]])
            expected = padded[shift:w + shift]
        elif shift < 0:
            padded = np.concatenate([x[-shift:0:-1], x])
            expected = padded[:w]
        else:
            expected = x
        np.testing.assert_array_equal(out, expected,
                                      err_msg=f"shift={shift}")


def test_phase_shuffle_shared_across_batch():
    x = jnp.tile(jnp.arange(16.0)[None, :, None], (4, 1, 1))
    out = phase_shuffle(x, jax.random.PRNGKey(7), 3)
    # identical rows stay identical: one shift per batch
    assert np.ptp(np.asarray(out), axis=0).max() == 0


def test_discriminator_without_phase_rng_raises():
    """A caller that forgets the 'phase' key gets an error, not a silently
    shuffle-free discriminator."""
    cfg = tiny_config()
    _, dis = get_models(cfg)
    x = jnp.zeros((2, 64, 6))
    dvars = dis.init({"params": jax.random.PRNGKey(0),
                      "phase": jax.random.PRNGKey(1)}, x)
    with pytest.raises(ValueError, match="no 'phase' key"):
        dis.apply(dvars, x, training=True)


def test_apply_with_missing_parameter_raises():
    cfg = tiny_config()
    gen, _ = get_models(cfg)
    z = jnp.zeros((2, cfg.noise_dim))
    gvars = gen.init(jax.random.PRNGKey(0), z)
    del gvars["params"]["Dense_1"]
    with pytest.raises(KeyError, match="Dense_1/kernel"):
        gen.apply(gvars, z, training=False)
