"""Native C++ kernels vs the numpy golden model."""

import numpy as np
import pytest

from calciumgan import native
from calciumgan.ops import oasis_ref

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library unavailable")


def test_native_crc32c():
    assert native.crc32c(b"123456789") == 0xE3069283
    assert native.crc32c(b"") == 0
    assert native.crc32c(b"\x00" * 32) == 0x8A9136AA


def test_native_oasis_matches_golden(rng):
    y = rng.standard_normal((6, 300)) * 0.3
    y[:, 50] += 2.0
    c_n, s_n = native.oasis_batch(y, g=0.95, s_min=0.55)
    for i in range(len(y)):
        c_r, s_r = oasis_ref.oasis_ar1(y[i], g=0.95, s_min=0.55)
        np.testing.assert_allclose(c_n[i], c_r, atol=1e-10)
        np.testing.assert_allclose(s_n[i], s_r, atol=1e-10)


def test_native_deconvolve_matches_golden(rng):
    y = (rng.standard_normal((8, 256)) * 0.3).astype(np.float32)
    y[:, 100] += 2.0
    ref = oasis_ref.deconvolve_signals_ref(y)
    out = native.deconvolve_batch(y)
    np.testing.assert_array_equal(out, ref)


def test_native_ar_filter(rng):
    spikes = (rng.random((4, 120)) < 0.1).astype(np.float32)
    ref = spikes.copy()
    for t in range(2, 120):
        ref[:, t] += 0.95 * ref[:, t - 1]
    out = native.ar_filter_batch(spikes, g=(0.95,))
    np.testing.assert_allclose(out, ref, rtol=1e-5)
