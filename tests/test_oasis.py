"""OASIS AR(1): the plain XLA machine and the float64 routine shared by the
host and CUDA kernels, against the numpy golden model; the CUDA wrapper's
shapes and layout; the eval path's choice of backend.

SURVEY.md §7 names OASIS numerical parity as the main risk: every backend
must match the pool-adjacency algorithm output exactly (g=0.95,
s_min=0.55, threshold 0.5 — the reference's spike_helper.py:28-29 recipe).
The CUDA kernel itself runs only on a card (``-m gpu``); its arithmetic is
the host build's (native/oasis_ar1.h), which the golden tests cover here.
"""

import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from calciumgan import native
from calciumgan.eval import spike_eval
from calciumgan.ops import oasis
from calciumgan.ops import oasis_ref
from calciumgan.ops.oasis import ar1_filter, deconvolve_signals, oasis_ar1_jax


def synth_traces(rng, n=8, T=256, g=0.95, rate=0.02, sn=0.3):
    spikes = (rng.random((n, T)) < rate).astype(np.float64)
    c = np.zeros_like(spikes)
    for t in range(T):
        c[:, t] = spikes[:, t] + (g * c[:, t - 1] if t > 0 else 0.0)
    return c + sn * rng.standard_normal((n, T)), spikes


def test_single_trace_matches_reference(rng):
    y, _ = synth_traces(rng, n=1, T=300)
    c_ref, s_ref = oasis_ref.oasis_ar1(y[0], g=0.95, s_min=0.55)
    c_jax, s_jax = oasis_ar1_jax(y[0][None], g=0.95, s_min=0.55)
    np.testing.assert_allclose(np.asarray(c_jax)[0], c_ref, atol=1e-4)
    np.testing.assert_allclose(np.asarray(s_jax)[0], s_ref, atol=1e-4)


@pytest.mark.parametrize("s_min,lam", [(0.0, 0.0), (0.55, 0.0), (0.0, 1.0)])
def test_batch_matches_reference(rng, s_min, lam):
    y, _ = synth_traces(rng, n=16, T=200)
    c_jax, s_jax = oasis_ar1_jax(y, g=0.95, lam=lam, s_min=s_min)
    for i in range(len(y)):
        c_ref, s_ref = oasis_ref.oasis_ar1(y[i], g=0.95, lam=lam, s_min=s_min)
        np.testing.assert_allclose(np.asarray(c_jax)[i], c_ref, atol=1e-4)
        np.testing.assert_allclose(np.asarray(s_jax)[i], s_ref, atol=1e-4)


def test_binarised_spikes_match(rng):
    y, _ = synth_traces(rng, n=8, T=256)
    ref = oasis_ref.deconvolve_signals_ref(y)
    jx = np.asarray(deconvolve_signals(y))
    # binarisation tolerates tiny float differences except at the threshold;
    # these synthetic traces keep spike sizes away from exactly 0.5
    np.testing.assert_array_equal(jx, ref)


def test_deconvolve_recovers_clean_spikes():
    # noiseless trace: deconvolution must recover the exact spike train
    T, g = 128, 0.95
    spikes = np.zeros(T)
    spikes[[10, 40, 90]] = 1.0
    c = np.zeros(T)
    for t in range(T):
        c[t] = spikes[t] + (g * c[t - 1] if t > 0 else 0.0)
    out = np.asarray(deconvolve_signals(c[None]))[0]
    np.testing.assert_array_equal(out, spikes)


def test_constant_zero_trace():
    out = np.asarray(deconvolve_signals(np.zeros((2, 64))))
    assert out.sum() == 0


def test_ar1_filter_matches_reference_loop(rng):
    # reference generate_dg_data.py:54-70 starts the recurrence at t=2
    spikes = (rng.random((4, 100)) < 0.1).astype(np.float32)
    ref = spikes.copy()
    for t in range(2, 100):
        ref[:, t] += 0.95 * ref[:, t - 1]
    out = np.asarray(ar1_filter(spikes, g=(0.95,)))
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_ar1_filter_casts_integer_spikes(rng):
    """int8/bool spike trains (the on-disk `spikes` dataset dtype) must get
    the same AR(1) decay as float input — without the internal cast the
    affine maps truncate g to 0 and return the spikes unchanged."""
    spikes = (rng.random((3, 64)) < 0.1).astype(np.int8)
    out_int = np.asarray(ar1_filter(spikes, g=0.95))
    out_float = np.asarray(ar1_filter(spikes.astype(np.float32), g=0.95))
    np.testing.assert_allclose(out_int, out_float, atol=1e-6)
    assert out_int.dtype.kind == "f"


def test_ar2_filter_matches_reference_loop(rng):
    spikes = (rng.random((4, 100)) < 0.1).astype(np.float32)
    ref = spikes.copy()
    for t in range(2, 100):
        ref[:, t] += 0.6 * ref[:, t - 1] + 0.2 * ref[:, t - 2]
    out = np.asarray(ar1_filter(spikes, g=(0.6, 0.2)))
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_roundtrip_filter_then_deconvolve(rng):
    # spikes -> calcium -> deconvolved spikes should match for clean data
    spikes = np.zeros((3, 200), np.float32)
    spikes[0, [20, 70, 150]] = 1.0
    spikes[1, [5, 100]] = 1.0
    spikes[2, [60, 61, 120]] = 1.0  # adjacent spikes
    # undo the reference's t=2 start quirk for a true AR(1) trace
    c_full = np.asarray(ar1_filter(np.concatenate(
        [np.zeros((3, 1), np.float32), spikes], axis=1), g=(0.95,)))[:, 1:]
    out = np.asarray(deconvolve_signals(c_full))
    np.testing.assert_array_equal(out, spikes)


def test_jax_matches_native_cpp(rng):
    """Direct cross-check of the two production backends (both are also
    tested against the numpy golden model independently)."""
    from calciumgan import native
    if not native.available():
        pytest.skip("native library unavailable")
    spikes = (rng.uniform(size=(8, 300)) < 0.06).astype(np.float32)
    sig = np.zeros_like(spikes)
    for t in range(1, 300):
        sig[:, t] = 0.95 * sig[:, t - 1] + spikes[:, t]
    sig += 0.1 * rng.normal(size=sig.shape).astype(np.float32)
    ours = np.asarray(deconvolve_signals(sig))
    theirs = native.deconvolve_batch(sig)
    np.testing.assert_array_equal(ours, theirs)


# ---- the shared float64 routine (host build) vs the golden model --------

@pytest.mark.parametrize("T", [300, 2048, 20000])
@pytest.mark.parametrize("rate", [0.02, 0.06])
@pytest.mark.parametrize("lam", [0.0, 0.5])
@pytest.mark.parametrize("s_min", [0.0, 0.55])
def test_shared_routine_matches_golden(s_min, lam, rate, T):
    """native/oasis_ar1.h as the host build runs it (the CUDA kernel runs
    the same routine): calcium, spike amplitudes and binary spikes equal the
    numpy golden model, up to float64 rounding of the pool sums."""
    rng = np.random.default_rng(int(1e6 * rate) + T + int(10 * lam))
    y = oasis_ref.synth_ar1_traces(rng, 2, T, rate=rate).astype(np.float64)
    c, s = native.oasis_batch(y, g=0.95, lam=lam, s_min=s_min)
    for i in range(len(y)):
        c_ref, s_ref = oasis_ref.oasis_ar1(y[i], g=0.95, lam=lam,
                                           s_min=s_min)
        np.testing.assert_allclose(c[i], c_ref, rtol=0, atol=1e-9)
        np.testing.assert_allclose(s[i], s_ref, rtol=0, atol=1e-9)
    if lam == 0.0:
        spikes = native.deconvolve_batch(y.astype(np.float32), s_min=s_min)
        ref = oasis_ref.deconvolve_signals_ref(y.astype(np.float32),
                                               s_min=s_min)
        np.testing.assert_array_equal(spikes, ref)


# ---- the CUDA wrapper, with the FFI call replaced by the XLA machine -----

@pytest.fixture
def fake_cuda(monkeypatch):
    """Stand in for the FFI call with the plain XLA machine on the same
    time-major layout, recording the shapes the kernel would get."""
    calls = []

    def spikes_tn(yt, g, s_min, threshold):
        calls.append(yt.shape)
        s = deconvolve_signals(yt.T, g=g, s_min=s_min, threshold=threshold)
        return s.T.astype(jnp.int8)

    monkeypatch.setattr(oasis, "_cuda_spikes_tn", spikes_tn)
    jax.clear_caches()
    yield calls
    jax.clear_caches()


@pytest.mark.parametrize("shape", [(1, 64), (31, 64), (32, 64), (33, 64),
                                   (3, 5, 64)])
def test_cuda_wrapper_shapes_and_padding(fake_cuda, shape):
    """Traces pad to whole blocks and go in time-major; the result comes
    back in the caller's shape, int8, without the padded rows."""
    rng = np.random.default_rng(sum(shape))
    n = int(np.prod(shape[:-1]))
    y = oasis_ref.synth_ar1_traces(rng, n, shape[-1], rate=0.05)
    out = oasis.oasis_spikes(y.reshape(shape))
    assert out.shape == shape and out.dtype == jnp.int8
    padded = -(-n // oasis.CUDA_BLOCK) * oasis.CUDA_BLOCK
    assert fake_cuda == [(shape[-1], padded)]
    np.testing.assert_array_equal(
        np.asarray(out).reshape(n, -1), native.deconvolve_batch(y))


@pytest.mark.parametrize("shape", [(0, 64), (2, 0, 64)])
def test_cuda_wrapper_empty_batch(fake_cuda, shape):
    out = oasis.oasis_spikes(np.zeros(shape, np.float32))
    assert out.shape == shape and out.dtype == jnp.int8
    assert fake_cuda == []  # nothing to launch


def test_cuda_wrapper_requests_scratch_and_attributes(monkeypatch):
    """The FFI call asks XLA for the (T, N) int8 spikes plus a byte scratch
    big enough for every trace's T-deep pool stack, and passes the
    parameters as float64 attributes."""
    seen = {}

    def fake_ffi_call(target, results):
        seen["target"], seen["results"] = target, results

        def call(yt, **attrs):
            seen["attrs"] = attrs
            return tuple(jnp.zeros(r.shape, r.dtype) for r in results)
        return call

    monkeypatch.setattr(native, "register_cuda", lambda: "target-name")
    monkeypatch.setattr(jax.ffi, "ffi_call", fake_ffi_call)
    out = oasis._cuda_spikes_tn(jnp.zeros((100, 64), jnp.float32), 0.95,
                                0.55, 0.5)
    assert seen["target"] == "target-name"
    spikes, scratch = seen["results"]
    assert (spikes.shape, spikes.dtype) == ((100, 64), jnp.int8)
    assert (scratch.shape, scratch.dtype) == ((100 * 64 * 20,), jnp.uint8)
    assert {k: (type(v), float(v)) for k, v in seen["attrs"].items()} == {
        "g": (np.float64, 0.95), "s_min": (np.float64, 0.55),
        "threshold": (np.float64, 0.5)}
    assert out.shape == (100, 64)


# ---- the eval path's one choice of backend ------------------------------

@pytest.mark.parametrize("platform,backend", [("gpu", "cuda"),
                                              ("cpu", "host")])
def test_backend_choice(monkeypatch, platform, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert spike_eval.oasis_backend() == backend


def test_backend_choice_rejects_other_platforms(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="no OASIS kernel"):
        spike_eval.oasis_backend()


def test_deconvolve_traces_gpu_uses_the_kernel(monkeypatch, fake_cuda):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(native, "deconvolve_batch",
                        lambda *a, **k: pytest.fail("host kernel called"))
    y = oasis_ref.synth_ar1_traces(np.random.default_rng(3), 6, 80,
                                   rate=0.05).reshape(2, 3, 80)
    out = spike_eval.deconvolve_traces(y)
    assert out.shape == (2, 3, 80) and out.dtype == np.int8
    assert fake_cuda == [(80, oasis.CUDA_BLOCK)]


def test_deconvolve_traces_gpu_missing_library_raises(monkeypatch):
    """No fallback to the host or to the XLA machine on a GPU: a CUDA
    library that cannot be built is an error."""
    def no_build():
        raise RuntimeError("building the CUDA OASIS kernel failed: nvcc")

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(native, "register_cuda", no_build)
    monkeypatch.setattr(native, "deconvolve_batch",
                        lambda *a, **k: pytest.fail("host kernel called"))
    jax.clear_caches()
    with pytest.raises(RuntimeError, match="CUDA OASIS kernel failed"):
        spike_eval.deconvolve_traces(np.zeros((2, 64), np.float32))
    jax.clear_caches()


def test_deconvolve_traces_cpu_uses_host_kernel(rng):
    y = oasis_ref.synth_ar1_traces(rng, 6, 120, rate=0.05).reshape(3, 2, 120)
    out = spike_eval.deconvolve_traces(y)
    assert out.shape == (3, 2, 120) and out.dtype == np.int8
    np.testing.assert_array_equal(
        out.reshape(6, 120), oasis_ref.deconvolve_signals_ref(
            y.reshape(6, 120)).astype(np.int8))


def test_deconvolve_traces_cpu_missing_library_raises(monkeypatch):
    monkeypatch.setattr(native, "deconvolve_batch", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="host kernel is unavailable"):
        spike_eval.deconvolve_traces(np.zeros((2, 64), np.float32))


def test_register_cuda_reports_build_failure(monkeypatch):
    def failing_make(*targets, timeout=120):
        raise subprocess.CalledProcessError(2, ["make"], output="",
                                            stderr="nvcc: not found")

    monkeypatch.setattr(native, "_cuda_lib", None)
    monkeypatch.setattr(native, "_make", failing_make)
    with pytest.raises(RuntimeError, match="nvcc: not found"):
        native.register_cuda()


# ---- on a card -----------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("T,rate", [(2048, 0.02), (2048, 0.06), (20000, 0.02)])
def test_cuda_kernel_matches_host(gpu_device, T, rate):
    y = oasis_ref.synth_ar1_traces(np.random.default_rng(T), 257, T,
                                   rate=rate)
    out = oasis.oasis_spikes(jax.device_put(y, gpu_device))
    np.testing.assert_array_equal(np.asarray(out),
                                  native.deconvolve_batch(y).astype(np.int8))
