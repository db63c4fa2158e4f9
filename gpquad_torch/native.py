"""ctypes binding for the native host-side library; port of
``gpquad/native.py``.

See native/gpquad_native.cc: threaded f64 direct-NUFFT oracles and the
bucket bin-sort used by spread-kernel preprocessing.  The library is
optional — :func:`available` gates use, and tests skip when it is absent.
Build with ``scripts/build_native.sh`` (or :func:`build`).  The oracles
take and return numpy arrays on the host: an independent float64 check of
the port's NUFFT kernels.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

__all__ = ["available", "build", "direct_nufft1_2d", "direct_nufft2_2d",
           "bin_sort_2d"]

_LIB_PATH = Path(__file__).resolve().parents[1] / "native" / \
    "libgpquad_native.so"
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        raise FileNotFoundError(
            f"{_LIB_PATH} not built; run scripts/build_native.sh")
    lib = ctypes.CDLL(str(_LIB_PATH))
    dp = ctypes.POINTER(ctypes.c_double)
    lp = ctypes.POINTER(ctypes.c_int64)
    lib.direct_nufft1_2d.argtypes = [dp, dp, dp, ctypes.c_int64,
                                     ctypes.c_double, ctypes.c_int64,
                                     ctypes.c_int, dp, dp]
    lib.direct_nufft2_2d.argtypes = list(lib.direct_nufft1_2d.argtypes)
    lib.bin_sort_2d.argtypes = [dp, ctypes.c_int64, ctypes.c_double,
                                ctypes.c_double, ctypes.c_double,
                                ctypes.c_double, ctypes.c_int64,
                                ctypes.c_int64, lp, lp]
    lib.gpquad_native_version.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    try:
        return _load().gpquad_native_version() >= 1
    except Exception:
        return False


def build() -> bool:
    """Attempt to compile the library in place."""
    script = _LIB_PATH.parents[1] / "scripts" / "build_native.sh"
    try:
        subprocess.run(["sh", str(script)], check=True,
                       capture_output=True)
        return available()
    except Exception:
        return False


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def direct_nufft1_2d(x, vals, h: float, mtot: int,
                     isign: int = -1) -> np.ndarray:
    """f64 threaded oracle: out[k] = sum_n v_n e^{isign 2 pi i h k.x_n}."""
    lib = _load()
    x = np.ascontiguousarray(np.asarray(x, np.float64))
    n = x.shape[0]
    v = np.asarray(vals, np.complex128)
    vre = np.ascontiguousarray(v.real)
    vim = np.ascontiguousarray(v.imag)
    out_re = np.zeros((mtot, mtot))
    out_im = np.zeros((mtot, mtot))
    lib.direct_nufft1_2d(_dp(x), _dp(vre), _dp(vim), n, h, mtot, isign,
                         _dp(out_re), _dp(out_im))
    return out_re + 1j * out_im


def direct_nufft2_2d(x, fk, h: float, mtot: int,
                     isign: int = 1) -> np.ndarray:
    """f64 threaded oracle: out[n] = sum_k f_k e^{isign 2 pi i h k.x_n}."""
    lib = _load()
    x = np.ascontiguousarray(np.asarray(x, np.float64))
    n = x.shape[0]
    f = np.asarray(fk, np.complex128).reshape(mtot, mtot)
    fre = np.ascontiguousarray(f.real)
    fim = np.ascontiguousarray(f.imag)
    out_re = np.zeros(n)
    out_im = np.zeros(n)
    lib.direct_nufft2_2d(_dp(x), _dp(fre), _dp(fim), n, h, mtot, isign,
                         _dp(out_re), _dp(out_im))
    return out_re + 1j * out_im


def bin_sort_2d(x, lo, bin_size, nbins) -> Tuple[np.ndarray, np.ndarray]:
    """Counting-sort points into spatial buckets.

    Returns (perm, bin_starts): ``x[perm]`` is bucket-ordered and bucket
    ``b`` spans ``perm[bin_starts[b]:bin_starts[b+1]]``.
    """
    lib = _load()
    x = np.ascontiguousarray(np.asarray(x, np.float64))
    n = x.shape[0]
    nb0, nb1 = nbins
    perm = np.zeros(n, np.int64)
    starts = np.zeros(nb0 * nb1 + 1, np.int64)
    lp = ctypes.POINTER(ctypes.c_int64)
    lib.bin_sort_2d(_dp(x), n, float(lo[0]), float(lo[1]),
                    1.0 / float(bin_size[0]), 1.0 / float(bin_size[1]),
                    nb0, nb1,
                    perm.ctypes.data_as(lp), starts.ctypes.data_as(lp))
    return perm, starts
