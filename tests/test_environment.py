"""What the package needs from its environment: the packages it imports,
where the compile cache goes, the device peaks it divides by, and the
checkpoint format it writes."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, **env):
    full = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=full,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def test_trains_and_evaluates_without_optional_packages():
    """flax, h5py, matplotlib and tqdm are not needed to train a step or to
    compute the spike statistics: with their imports blocked, the training
    driver and the eval compute import, one tiny train step runs, and the
    eval path deconvolves and scores."""
    out = _run("""
import sys
for name in ("flax", "h5py", "matplotlib", "tqdm"):
    sys.modules[name] = None
import jax, numpy as np
import calciumgan.train
from calciumgan.eval import spike_eval
from calciumgan.algorithms.registry import get_algorithm
from calciumgan.config import Config
from calciumgan.models.registry import get_models
from calciumgan.parallel import mesh as mesh_lib
import calciumgan.utils.summary
cfg = Config(model="calciumgan", sequence_length=64, num_neurons=6,
             num_channels=6, signal_shape=(64, 6), noise_dim=8, num_units=4,
             kernel_size=4, strides=2, m=2, n_critic=1, normalize=True,
             layer_norm=True, signals_min=0.0, signals_max=1.0)
algo = get_algorithm(cfg, *get_models(cfg))
mesh = mesh_lib.create_mesh(1, 1, devices=jax.devices()[:1])
state = algo.init_state(jax.random.PRNGKey(0))
train_fn, _, _ = mesh_lib.make_step_fns(algo, mesh, state)
real = np.random.default_rng(0).random((2, 64, 6)).astype(np.float32)
state, logs = train_fn(state, mesh_lib.shard_batch(mesh, real),
                       jax.random.PRNGKey(1))
assert all(np.isfinite(float(v)) for v in logs.values()), logs
spikes = spike_eval.deconvolve_traces(np.transpose(real, (0, 2, 1)) * 3)
rates = spike_eval._firing_rates_nwc(np.transpose(spikes, (0, 2, 1))
                                     .astype(np.float32))
assert rates.shape == (2, 6)
print("ok", sorted(n for n in ("flax", "h5py", "matplotlib", "tqdm")
                   if sys.modules.get(n) is not None))
""")
    assert out.strip().endswith("ok []")


def test_compile_cache_follows_env(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the program sets no other
    directory, and compiled programs land in the one the variable names."""
    out = _run("""
import jax
from calciumgan.train import enable_compilation_cache
print(enable_compilation_cache())
print(jax.config.jax_compilation_cache_dir)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: x * 2 + 1)(jax.numpy.arange(3.0)).block_until_ready()
""", JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert out.split() == [str(tmp_path), str(tmp_path)]
    assert os.listdir(tmp_path)


def test_compile_cache_defaults_to_checkout(monkeypatch):
    from calciumgan.train import enable_compilation_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = enable_compilation_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert os.path.isdir(path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("kind,expected", [
    ("NVIDIA H100 80GB HBM3", 100.0 * 9.89 * 10.0 / 989.0),
    ("an unknown accelerator", None)])
def test_mfu_uses_known_peaks_only(kind, expected):
    import bench
    got = bench.mfu_pct(9.89, 10.0, 1, kind)
    assert got == pytest.approx(expected) if expected else got is None
    assert bench.mfu_pct(None, 10.0, 1, "NVIDIA H100 80GB HBM3") is None


def test_checkpoint_keys_are_tree_paths(tmp_path):
    """Checkpoints are plain .npz archives keyed by the state's tree paths,
    readable with numpy alone."""
    from calciumgan.algorithms.registry import get_algorithm
    from calciumgan.config import Config
    from calciumgan.models.registry import get_models
    from calciumgan.utils import checkpoint
    cfg = Config(model="calciumgan", sequence_length=64, num_neurons=6,
                 num_channels=6, signal_shape=(64, 6), noise_dim=8,
                 num_units=4, kernel_size=4, strides=2, m=2, normalize=True,
                 layer_norm=True, signals_min=0.0, signals_max=1.0)
    algo = get_algorithm(cfg, *get_models(cfg))
    state = algo.init_state(jax.random.PRNGKey(0))
    path = checkpoint.save(str(tmp_path), 4, state, verbose=0)
    assert path.endswith("epoch-004.npz")
    with np.load(path) as archive:
        keys = set(archive.files)
        np.testing.assert_array_equal(
            archive["generator/params/Dense_0/kernel"],
            np.asarray(state.generator.params["Dense_0"]["kernel"]))
    assert "discriminator/params/Conv_4/bias" in keys
    assert "generator/params/Norm_0/LayerNorm_0/scale" in keys
    assert "generator/step" in keys
    assert not any(k.startswith("ema_params/") for k in keys)
    # a leaf the state expects but the archive lacks is an error
    bigger = state.replace(generator=state.generator.replace(
        params={**state.generator.params, "Extra_0": {"kernel": np.zeros(2)}}))
    with pytest.raises(KeyError, match="Extra_0"):
        checkpoint.restore(str(tmp_path), bigger, verbose=0)
