"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

The sharding/collective paths are validated on a faked 8-device CPU platform
exactly as SURVEY.md §4 prescribes (``xla_force_host_platform_device_count``),
so the suite needs no accelerator. Must run before the first ``import jax``
anywhere in the test session.

Tests marked ``gpu`` need a CUDA device and skip without one; the
``gpu_device`` fixture decides, at test time. To run them on a card, leave
the default platform alone::

    CALCIUMGAN_TEST_GPU=1 python -m pytest tests/ -m gpu
"""

import os
import re
import sys

# the suite requires EXACTLY 8 faked devices: replace (not just append to)
# any pre-existing count in the shell's XLA_FLAGS — a stale =4 from e.g.
# the multihost-worker recipe would fail every mesh test opaquely
_ON_GPU = os.environ.get("CALCIUMGAN_TEST_GPU") == "1"
flags = os.environ.get("XLA_FLAGS", "")
flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "", flags)
if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    flags + " --xla_force_host_platform_device_count=8").strip()

# root scripts (main.py, compute_metrics.py, ...) import as top-level
# modules; one bootstrap here instead of per-test-module copies
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# force the config flag too (it is read at first backend initialisation),
# so a platform plugin cannot take precedence over the env override
if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The first CUDA device, or a skip (see the module docstring)."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a CUDA GPU")
    return devices[0]
