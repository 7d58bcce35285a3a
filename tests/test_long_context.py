"""Long-context WGAN-GP training over a (data, time) mesh.

The capstone of the sequence-parallel stack (SURVEY.md §5.7): a full
WGAN-GP train step where the batch is sharded over 'data' AND the sequence
over 'time'. At m=0 the step is a pure re-partitioning of the standard
algorithm, so its losses must match the unsharded step exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from calciumgan.algorithms import get_algorithm
from calciumgan.config import Config
from calciumgan.models import get_models
from calciumgan.parallel.long_context import (create_time_mesh,
                                                  make_long_context_algorithm)


def lc_config(**kw):
    # sl1024 over 4 time-shards keeps every layer's shard width above its
    # halo (deepest conv input: 1024/4/16 = 16 >= 11)
    cfg = Config(
        model="calciumgan", algorithm="wgan-gp", sequence_length=1024,
        num_neurons=3, num_channels=3, signal_shape=(1024, 3), noise_dim=8,
        num_units=2, kernel_size=24, strides=2, m=0, epochs=1, batch_size=8,
        n_critic=2, normalize=True, layer_norm=True,
        signals_min=0.0, signals_max=1.0)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


@pytest.mark.slow
def test_matches_standard_step_at_m0(rng):
    cfg = lc_config()
    real = rng.random((8,) + tuple(cfg.signal_shape)).astype(np.float32)
    key = jax.random.PRNGKey(3)

    gen, dis = get_models(cfg)
    std = get_algorithm(cfg, gen, dis)
    state = std.init_state(jax.random.PRNGKey(0))
    _, logs_std = jax.jit(std.train_step)(state, jnp.asarray(real), key)

    mesh = create_time_mesh(data_parallelism=2, time_parallelism=4)
    algo, train, _, _ = make_long_context_algorithm(cfg, mesh)
    state2 = algo.init_state(jax.random.PRNGKey(0))
    from jax.sharding import NamedSharding, PartitionSpec as P
    state2 = jax.device_put(state2, NamedSharding(mesh, P()))
    real_s = jax.device_put(real, NamedSharding(mesh, P("data", "time",
                                                        None)))
    _, logs = train(state2, real_s, jax.device_put(key))

    # at m=0 there is no phase randomness: the sharded step computes the
    # SAME function as the standard one
    for k in ("loss/discriminator", "loss/gradient_penalty"):
        np.testing.assert_allclose(float(logs[k]), float(logs_std[k]),
                                   rtol=2e-4, err_msg=k)
    # the generator loss is post-update; the two Adam trajectories see
    # bit-different partial-sum roundings, so compare loosely
    np.testing.assert_allclose(float(logs["loss/generator"]),
                               float(logs_std["loss/generator"]), rtol=0.05)


@pytest.mark.slow
def test_trains_and_generates_with_phase_shuffle(rng):
    cfg = lc_config(m=10, n_critic=1)
    mesh = create_time_mesh(data_parallelism=2, time_parallelism=4)
    algo, train, evaluate, generate = make_long_context_algorithm(cfg, mesh)
    state = algo.init_state(jax.random.PRNGKey(1))
    from jax.sharding import NamedSharding, PartitionSpec as P
    state = jax.device_put(state, NamedSharding(mesh, P()))
    real = jax.device_put(
        rng.random((8,) + tuple(cfg.signal_shape)).astype(np.float32),
        NamedSharding(mesh, P("data", "time", None)))

    state, logs = train(state, real, jax.device_put(jax.random.PRNGKey(2)))
    assert all(np.isfinite(float(np.asarray(v))) for v in logs.values())

    mask = jax.device_put(np.ones((8,), np.float32),
                          NamedSharding(mesh, P("data")))
    fake, elogs = evaluate(state, real, jax.device_put(jax.random.PRNGKey(3)),
                           mask)
    assert fake.shape == (8, 1024, 3)
    assert all(np.isfinite(float(np.asarray(v))) for v in elogs.values())

    noise = jax.device_put(
        rng.standard_normal((8, cfg.noise_dim)).astype(np.float32),
        NamedSharding(mesh, P("data", None)))
    out = generate(state, noise, jax.device_put(jax.random.PRNGKey(4)))
    assert out.shape == (8, 1024, 3)
    assert np.isfinite(np.asarray(out)).all()


def test_rejects_batch_norm():
    cfg = lc_config(layer_norm=False, batch_norm=True)
    with pytest.raises(ValueError, match="BatchNorm|layer_norm"):
        make_long_context_algorithm(cfg, create_time_mesh(1, 8))


@pytest.mark.slow
def test_main_cli_time_parallelism(tmp_path, rng):
    """End-to-end: the training driver runs with --time_parallelism on a
    long-sequence dataset (no offline windowing down to sl2048 needed)."""
    import glob
    import os

    from calciumgan import train as train_lib
    from calciumgan.data import segments
    from main import parse_args

    data = {"signals": rng.random((3, 6000)).astype(np.float32),
            "oasis": (rng.random((3, 6000)) < 0.05).astype(np.float32)}
    signals, spikes, meta = segments.preprocess(
        data, 1024, 512, do_normalize=True, is_dg_data=True)
    input_dir = str(tmp_path / "records")
    segments.write_dataset(input_dir, signals, spikes, meta, 1024, 512,
                           validation_size=8, do_normalize=True,
                           apply_fft=False, conv2d=False, verbose=0)

    cfg = parse_args([
        "--input_dir", input_dir, "--output_dir", str(tmp_path / "lcrun"),
        "--batch_size", "4", "--num_units", "2", "--kernel_size", "24",
        "--noise_dim", "8", "--epochs", "1", "--n_critic", "1",
        "--model", "calciumgan", "--algorithm", "wgan-gp", "--m", "0",
        "--layer_norm", "--time_parallelism", "4", "--data_parallelism", "2",
        "--save_generated", "last", "--verbose", "0"])
    train_lib.main(cfg)

    ckpts = glob.glob(os.path.join(cfg.output_dir, "checkpoints",
                                   "epoch-*.npz"))
    assert len(ckpts) == 1
    from calciumgan.utils import h5
    fake = h5.get(os.path.join(cfg.output_dir, "generated",
                               "epoch000_signals.h5"), "signals")
    assert fake.shape[1:] == (1024, 3)
    assert np.isfinite(fake).all()
