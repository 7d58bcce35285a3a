"""Driver-contract checks: entry() compiles, dryrun_multichip(8) executes."""

import os

import jax
import numpy as np
import pytest

# repo root on sys.path: tests/conftest.py bootstraps it for the session


def test_entry_compiles_and_runs():
    from __graft_entry__ import entry
    fn, args = entry()
    fake, score = jax.jit(fn)(*args)
    assert fake.shape == (4, 2048, 102)
    assert score.shape == (4, 1)
    assert np.isfinite(np.asarray(jax.device_get(score))).all()


@pytest.mark.slow
def test_dryrun_multichip_8(capsys):
    from __graft_entry__ import dryrun_multichip
    dryrun_multichip(8)
    out = capsys.readouterr().out
    # all three parallel modes certify, one ok-line each (round-4 verdict)
    assert "dryrun_multichip ok: mesh=(4 data x 2 model)" in out
    assert "dryrun_multichip ok: mesh=(2 slice x 2 data x 2 model)" in out
    assert ("dryrun_multichip ok: mesh=(2 data x 4 time long-context)"
            in out)


@pytest.mark.slow
def test_dryrun_parent_never_initializes_backend(tmp_path):
    """The routing decision must not touch jax.devices()/default_backend():
    on a GPU host that would initialise the GPU backend (and reserve most
    of the card's memory) in a parent whose dry run happens on the CPU.
    Poison both in a fresh parent process whose platform is NOT pinned to
    cpu; the dry run must still complete via the CPU-forced subprocess."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import jax\n"
        "def _poisoned(*a, **k):\n"
        "    raise AssertionError('parent initialized the default backend')\n"
        "jax.devices = _poisoned\n"
        "jax.default_backend = _poisoned\n"
        "import __graft_entry__\n"
        "__graft_entry__.dryrun_multichip(2)\n" % repo)
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    # platform unpinned, as a plain invocation on a GPU host
    # outer bound must exceed the product's inner 600 s child timeout so a
    # wedged child surfaces _dryrun_in_subprocess's diagnostic RuntimeError
    # (with captured stderr) instead of a bare TimeoutExpired here
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=repo,
                          capture_output=True, text=True, timeout=660)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "dryrun_multichip ok" in proc.stdout, proc.stdout


def test_bench_oasis_smoke():
    """bench.py's OASIS benchmark on tiny shapes (the host kernel on this
    CPU) and the derived baseline band."""
    import bench
    tps = bench.bench_oasis(T=64, n_traces=8)
    assert tps > 0
    lo, hi = bench._reference_band(11.08)
    assert 0 < lo < hi < 10
