"""ctypes bindings for the native host kernels (crc32c, OASIS, AR filter),
and the loader of the CUDA OASIS kernel that JAX calls through ``jax.ffi``.

Both libraries are built from the committed sources by ``make`` into the
gitignored ``build/`` directory at first use in a process (``make`` is a
no-op when the build is current). The host entry points return None when
the host library cannot be built, and callers choose what that means; the
CUDA loader raises, since the GPU path has no other kernel to fall to.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "build", "libcalciumgan_native.so")
_CUDA_SO = os.path.join(_DIR, "build", "libcalciumgan_cuda.so")
CUDA_TARGET = "cg_oasis_spikes"

_lib: Optional[ctypes.CDLL] = None
_tried = False
load_error = ""  # why the host library is unavailable, once load() failed
_cuda_lib: Optional[ctypes.CDLL] = None  # kept loaded while JAX holds it
_load_lock = threading.Lock()


def _make(*targets: str, timeout: float = 120) -> None:
    subprocess.run(["make", "-C", _DIR, *targets], check=True,
                   capture_output=True, text=True, timeout=timeout)


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the host library; None if unavailable.

    Serialised by a lock: concurrent first calls (prefetch thread + sweep
    threads) would otherwise race two `make` builds and dlopen a
    half-rewritten .so."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _load_lock:
        if _lib is not None or _tried:
            return _lib
        return _load_locked()


def _load_locked() -> Optional[ctypes.CDLL]:
    global _lib, _tried, load_error
    _tried = True
    try:
        _make()
        lib = ctypes.CDLL(_SO)
    except subprocess.CalledProcessError as e:
        load_error = f"{e}\n{e.stdout}{e.stderr}"
        return None
    except (OSError, subprocess.SubprocessError) as e:
        load_error = str(e)
        return None

    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)

    lib.cg_crc32c.argtypes = [u8p, ctypes.c_uint64]
    lib.cg_crc32c.restype = ctypes.c_uint32
    lib.cg_oasis_ar1.argtypes = [f64p, ctypes.c_int64, ctypes.c_double,
                                 ctypes.c_double, ctypes.c_double, f64p, f64p]
    lib.cg_deconvolve_batch.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, f32p]
    lib.cg_oasis_batch.argtypes = [
        f64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, f64p, f64p]
    lib.cg_ar_filter_batch.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
        ctypes.c_double, ctypes.c_int32]
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def register_cuda() -> str:
    """Build the CUDA OASIS library (nvcc, ``sm_90a``) and register its FFI
    handler with JAX for the CUDA platform. Returns the target name.

    Raises ``RuntimeError`` with the compiler's output when the library
    cannot be built or loaded."""
    global _cuda_lib
    with _load_lock:
        if _cuda_lib is not None:
            return CUDA_TARGET
        import jax
        try:
            _make("cuda", f"FFI_INCLUDE={jax.ffi.include_dir()}",
                  timeout=600)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(
                f"building the CUDA OASIS kernel failed:\n{e.stdout}"
                f"{e.stderr}") from e
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(
                f"building the CUDA OASIS kernel failed: {e}") from e
        lib = ctypes.CDLL(_CUDA_SO)
        jax.ffi.register_ffi_target(
            CUDA_TARGET, jax.ffi.pycapsule(lib.CgOasisSpikes),
            platform="CUDA")
        _cuda_lib = lib
        return CUDA_TARGET


# ---------------------------------------------------------------------------
# typed wrappers
# ---------------------------------------------------------------------------

def crc32c(data: bytes) -> Optional[int]:
    lib = load()
    if lib is None:
        return None
    # zero-copy: the kernel only reads, so hand it the bytes object's own
    # buffer (from_buffer_copy would duplicate every record payload on the
    # shard read/write hot path)
    buf = ctypes.cast(ctypes.c_char_p(data),
                      ctypes.POINTER(ctypes.c_uint8))
    return int(lib.cg_crc32c(buf, len(data)))


def oasis_ar1(y: np.ndarray, g: float = 0.95, lam: float = 0.0,
              s_min: float = 0.0):
    """Single-trace (c, s); None if the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    y = np.ascontiguousarray(y, np.float64)
    c = np.empty_like(y)
    s = np.empty_like(y)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.cg_oasis_ar1(y.ctypes.data_as(f64p), y.shape[0], g, lam, s_min,
                     c.ctypes.data_as(f64p), s.ctypes.data_as(f64p))
    return c, s


def oasis_batch(signals: np.ndarray, g: float = 0.95, lam: float = 0.0,
                s_min: float = 0.0):
    lib = load()
    if lib is None:
        return None
    signals = np.ascontiguousarray(signals, np.float64)
    n, t = signals.shape
    c = np.empty_like(signals)
    s = np.empty_like(signals)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.cg_oasis_batch(signals.ctypes.data_as(f64p), n, t, g, lam, s_min,
                       c.ctypes.data_as(f64p), s.ctypes.data_as(f64p))
    return c, s


def deconvolve_batch(signals: np.ndarray, g: float = 0.95,
                     s_min: float = 0.55, threshold: float = 0.5):
    """Binary spikes for (N, T) float32 signals; None if lib unavailable."""
    lib = load()
    if lib is None:
        return None
    signals = np.ascontiguousarray(signals, np.float32)
    n, t = signals.shape
    out = np.empty((n, t), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.cg_deconvolve_batch(signals.ctypes.data_as(f32p), n, t, g, s_min,
                            threshold, out.ctypes.data_as(f32p))
    return out


def ar_filter_batch(spikes: np.ndarray, g=(0.95,)):
    """In-place-style AR synthesis on a copy; None if lib unavailable."""
    lib = load()
    if lib is None:
        return None
    x = np.array(spikes, np.float32, copy=True, order="C")
    n, t = x.shape
    g = tuple(g)
    g1 = float(g[0])
    g2 = float(g[1]) if len(g) > 1 else 0.0
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.cg_ar_filter_batch(x.ctypes.data_as(f32p), n, t, g1, g2, len(g))
    return x
