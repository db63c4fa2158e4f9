"""Hand-written CUDA NUFFT kernels for d=1, d=2 and d=3, their plain
versions, and the NUFFT backend built on them.

Port of ``gpquad/ops/pallas_nufft.py``.  The TPU file fuses the phase
construction with the complex products so that no ``(N, mtot)`` phase matrix
reaches device memory; the kernels in ``csrc/nufft_1d.cu``,
``csrc/nufft_2d.cu`` and ``csrc/nufft_3d.cu`` do the same on Hopper:

- :func:`nufft2_1d` replaces ``pallas_nufft2_1d`` (pallas_nufft.py:549) and
  :func:`nufft1_1d` replaces ``pallas_nufft1_1d`` (:584): any odd ``mtot``,
  one vector or a batch in one launch (gpquad maps the TPU kernel over a
  batch with ``lax.map``).
- :func:`nufft2_2d` replaces ``pallas_nufft2_2d`` (pallas_nufft.py:113) and
  its mode-tiled twin ``_pallas_nufft2_2d_tiled`` (:369): one kernel takes
  any odd ``mtot``, tiling the modes inside.
- :func:`nufft1_2d` replaces ``pallas_nufft1_2d`` (:195) and
  ``_pallas_nufft1_2d_tiled`` (:442): per-block partial sums over chunks of
  2048 points, then a second pass adds the partials in chunk order.
- :func:`nufft2_2d_batched` replaces ``pallas_nufft2_2d_batched`` (:838)
  and :func:`nufft1_2d_batched` replaces ``pallas_nufft1_2d_batched``
  (:914): B vectors against the same points in one launch, the phases made
  once per group of batch elements (the gradient's probe batches).
- :func:`nufft2_3d` replaces ``pallas_nufft2_3d`` (:662) and its
  first-dimension slab-tiled twin ``_pallas_nufft2_3d_tiled`` (:1034), and
  :func:`nufft1_3d` replaces ``pallas_nufft1_3d`` (:750) and
  ``_pallas_nufft1_3d_tiled`` (:1118): one vector or a batch in one launch,
  any odd ``mtot`` up to 255 (the TPU's ``_D3_TILED_MAX``).

All are bound by operations on an H100 (fp32 complex multiply-adds outside
the tensor cores, ~8 mtot^d flops per point and vector, and at d=1 the
phases themselves); the sources say how the designs stage the work.  The
wrappers take a tensor on the CPU to the plain version (``*_ref``, the
phase-matrix backend of ``ops/nufft.py``); on a CUDA tensor they launch the
kernel or raise.

The library is compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/gpquad_torch/`` at the checkout's root (one ``nvcc`` per source, all
started together, then one link), named after a hash of the sources so that
an edit rebuilds it, and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .nufft import CUDA_D3_MAX_MTOT, make_phase_nufft

__all__ = ["nufft1_1d", "nufft2_1d", "nufft1_1d_ref", "nufft2_1d_ref",
           "nufft1_2d", "nufft2_2d", "nufft1_2d_ref", "nufft2_2d_ref",
           "nufft1_2d_batched", "nufft2_2d_batched", "nufft1_2d_batched_ref",
           "nufft2_2d_batched_ref", "nufft1_3d", "nufft2_3d", "nufft1_3d_ref",
           "nufft2_3d_ref", "type1_3d_groups", "CudaNUFFT", "LAUNCHES",
           "LAUNCH_WIDTHS", "build", "library_path"]

# Launches of each kernel since the last reset (a launch is one wrapper call
# on a CUDA tensor; the two stages of type-1 count once).
LAUNCHES = {"nufft1_1d": 0, "nufft2_1d": 0, "nufft1_2d": 0, "nufft2_2d": 0,
            "nufft1_2d_batched": 0, "nufft2_2d_batched": 0, "nufft1_3d": 0,
            "nufft2_3d": 0}
# The same launches by (kernel, mtot), counted at the same place.
LAUNCH_WIDTHS: dict[tuple[str, int], int] = {}

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
# every file the library depends on (hashed); the .cu files are compiled
_SOURCES = ("nufft_common.cuh", "nufft_1d.cu", "nufft_2d.cu", "nufft_3d.cu")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gpquad_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
TYPE1_CHUNK = 2048
# the d=3 type-1 sums its chunks in groups, enough for about this many blocks
TYPE1_3D_BLOCKS = 1056

_lib = None


def library_path() -> Path:
    """Path of the shared library for the current sources."""
    digest = hashlib.sha256()
    for name in _SOURCES:
        digest.update((_CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_DIR / f"libgpquad_nufft_{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or in "
                           "/usr/local/cuda/bin: the CUDA NUFFT kernels "
                           "cannot be built")
    return str(path)


def _run_all(cmds):
    """Run the commands in parallel; wait for every one, then raise on the
    first that failed.  Returns their joined output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs = [proc.communicate() for proc in procs]
    for cmd, proc, (so, se) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{so}\n{se}")
    return "".join(so + se for so, se in outs)


def build() -> tuple[Path, str]:
    """Compile the kernels if the library for these sources is missing: one
    ``nvcc -c`` per ``.cu`` source, all at once, then one link.

    Returns the library's path and the compiler's output (``-Xptxas -v``
    prints each kernel's registers and shared memory); the output is empty
    when the library was already built."""
    out = library_path()
    if out.exists():
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    units = [s for s in _SOURCES if s.endswith(".cu")]
    objs = [out.with_name(f"{out.stem}.{Path(s).stem}.{pid}.o") for s in units]
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(_CSRC / s)]
                    for s, o in zip(units, objs)])
    tmp = out.with_suffix(f".{pid}.tmp")
    log += _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                      "-shared", "-o", str(tmp), *map(str, objs)]])
    for o in objs:
        o.unlink()
    os.replace(tmp, out)
    return out, log


def _library():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for prec, real in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
            o2 = getattr(lib, f"gpq_nufft2_1d_{prec}")
            o2.argtypes = [ptr, ptr, real, i32, i32, i32, i32, ptr, ptr]
            o2.restype = i32
            o1 = getattr(lib, f"gpq_nufft1_1d_{prec}")
            o1.argtypes = [ptr, ptr, real, i32, i32, i32, i32, i32, ptr, ptr,
                           ptr]
            o1.restype = i32
            t2 = getattr(lib, f"gpq_nufft2_2d_{prec}")
            t2.argtypes = [ptr, ptr, real, i32, i32, i32, ptr, ptr]
            t2.restype = i32
            t1 = getattr(lib, f"gpq_nufft1_2d_{prec}")
            t1.argtypes = [ptr, ptr, real, i32, i32, i32, i32, ptr, ptr, ptr]
            t1.restype = i32
            b2 = getattr(lib, f"gpq_nufft2_2d_batched_{prec}")
            b2.argtypes = [ptr, ptr, real, i32, i32, i32, i32, ptr, ptr]
            b2.restype = i32
            b1 = getattr(lib, f"gpq_nufft1_2d_batched_{prec}")
            b1.argtypes = [ptr, ptr, real, i32, i32, i32, i32, i32, ptr, ptr,
                           ptr]
            b1.restype = i32
            d2 = getattr(lib, f"gpq_nufft2_3d_{prec}")
            d2.argtypes = [ptr, ptr, real, i32, i32, i32, i32, ptr, ptr]
            d2.restype = i32
            d1 = getattr(lib, f"gpq_nufft1_3d_{prec}")
            d1.argtypes = [ptr, ptr, real, i32, i32, i32, i32, i32, i32, ptr,
                           ptr, ptr]
            d1.restype = i32
        _lib = lib
    return _lib


def _complex_of(rdtype):
    return torch.complex64 if rdtype == torch.float32 else torch.complex128


def _check(x: torch.Tensor, mtot: int, d: int = 2):
    if x.ndim != 2 or x.shape[1] != d:
        raise ValueError(f"x must be (N, {d}), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"x must be float32 or float64, got {x.dtype}")
    if mtot % 2 != 1 or mtot < 1:
        raise ValueError(f"mtot must be odd and positive, got {mtot}")
    if d == 3 and mtot > CUDA_D3_MAX_MTOT:
        raise ValueError(f"the d=3 kernels take mtot <= {CUDA_D3_MAX_MTOT}, "
                         f"got {mtot}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _check_cuda_operand(name, t, x, cdtype):
    if t.device != x.device or t.dtype != cdtype:
        raise TypeError(f"{name} must be {cdtype} on {x.device}, "
                        f"got {t.dtype} on {t.device}")


def _launch(name: str, x: torch.Tensor, *args, mtot: int):
    """Call ``gpq_<name>_<f32|f64>`` (x's precision) with ``args`` and x's
    current stream; raise on a CUDA error, count the launch (by kernel and
    by kernel and ``mtot``)."""
    prec = "f32" if x.dtype == torch.float32 else "f64"
    fn = getattr(_library(), f"gpq_{name}_{prec}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} "
                           f"({torch.cuda.get_device_name(x.device)})")
    LAUNCHES[name] += 1
    LAUNCH_WIDTHS[name, mtot] = LAUNCH_WIDTHS.get((name, mtot), 0) + 1


# ---------------------------------------------------------------------------
# plain versions: the phase-matrix backend of ops/nufft.py on the same inputs
# ---------------------------------------------------------------------------

def nufft2_1d_ref(x, f, h, *, mtot: int, fft_order: bool = False):
    """Plain d=1 type-2: ``out[b,n] = sum_j f[b,j] e^{+2 pi i h x_n k_j}``;
    ``f`` (mtot,) or (B, mtot) -> complex (N,) or (B, N)."""
    op = make_phase_nufft(x, h, mtot, fft_order=fft_order)
    return op.type2(f)


def nufft1_1d_ref(x, vals, h, *, mtot: int, fft_order: bool = False):
    """Plain d=1 type-1: ``out[b,j] = sum_n v[b,n] e^{-2 pi i h x_n k_j}``;
    ``vals`` (N,) or (B, N) -> complex (mtot,) or (B, mtot)."""
    op = make_phase_nufft(x, h, mtot, fft_order=fft_order)
    return op.type1(vals)


def nufft2_2d_ref(x, f, h, *, mtot: int, fft_order: bool = False):
    """Plain type-2: ``out[n] = sum_jk f[j,k] e^{+2 pi i h (x_n1 k_j +
    x_n2 k_k)}``; complex (N,)."""
    op = make_phase_nufft(x, h, mtot, fft_order=fft_order)
    return op.type2(f.reshape(mtot, mtot))


def nufft1_2d_ref(x, vals, h, *, mtot: int, fft_order: bool = False):
    """Plain type-1: ``out[j,k] = sum_n v_n e^{-2 pi i h (x_n1 k_j +
    x_n2 k_k)}``; complex (mtot, mtot)."""
    op = make_phase_nufft(x, h, mtot, fft_order=fft_order)
    return op.type1(vals)


def nufft2_2d_batched_ref(x, f, h, *, mtot: int, fft_order: bool = False):
    """Plain batched type-2: ``f`` (B, mtot, mtot) or (B, mtot^2) -> complex
    (B, N), one phase-matrix apply per vector."""
    op = make_phase_nufft(x, h, mtot, fft_order=fft_order)
    return op.type2(f.reshape(-1, mtot * mtot))


def nufft1_2d_batched_ref(x, vals, h, *, mtot: int, fft_order: bool = False):
    """Plain batched type-1: ``vals`` (B, N) -> complex (B, mtot, mtot)."""
    op = make_phase_nufft(x, h, mtot, fft_order=fft_order)
    return op.type1(vals.reshape(-1, x.shape[0]))


def nufft2_3d_ref(x, f, h, *, mtot: int, fft_order: bool = False):
    """Plain d=3 type-2: ``out[b,n] = sum f[b,j1,j2,j3] e^{+2 pi i h (x_n1
    k_j1 + x_n2 k_j2 + x_n3 k_j3)}`` with the per-j1 loop of the phase-matrix
    backend; ``f`` as :func:`nufft2_3d` takes it, complex (N,) or (B, N)."""
    op = make_phase_nufft(x, h, mtot, fft_order=fft_order)
    return op.type2(f)


def nufft1_3d_ref(x, vals, h, *, mtot: int, fft_order: bool = False):
    """Plain d=3 type-1: ``out[b,j1,j2,j3] = sum_n v[b,n] e^{-2 pi i h
    (...)}``; ``vals`` (N,) or (B, N) -> complex (mtot,)*3 or
    (B,) + (mtot,)*3."""
    op = make_phase_nufft(x, h, mtot, fft_order=fft_order)
    return op.type1(vals)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def nufft2_1d(x, f, h, *, mtot: int, fft_order: bool = False):
    """Fused d=1 type-2 apply (replaces ``pallas_nufft2_1d``).

    ``x`` (N, 1) real; ``f`` complex (mtot,) for one vector or (B, mtot)
    for a batch of B >= 1; any odd mtot.  Returns complex (N,) or (B, N)
    from one launch.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel."""
    _check(x, mtot, 1)
    if f.ndim not in (1, 2) or f.shape[-1] != mtot:
        raise ValueError(f"f must be ({mtot},) or (B, {mtot}), "
                         f"got {tuple(f.shape)}")
    single = f.ndim == 1
    B = 1 if single else f.shape[0]
    _check_batch(B, mtot, 1)
    if x.device.type == "cpu":
        return nufft2_1d_ref(x, f, h, mtot=mtot, fft_order=fft_order)
    cdtype = _complex_of(x.dtype)
    _check_cuda_operand("f", f, x, cdtype)
    n = x.shape[0]
    out = torch.empty((B, n), dtype=cdtype, device=x.device)
    if n > 0:
        x = x.contiguous()
        f = f.contiguous()
        h = float(torch.as_tensor(h, dtype=x.dtype))
        _launch("nufft2_1d", x, x.data_ptr(), f.data_ptr(), h, n, mtot, B,
                int(fft_order), out.data_ptr(), mtot=mtot)
    return out[0] if single else out


def nufft1_1d(x, vals, h, *, mtot: int, fft_order: bool = False):
    """Fused d=1 type-1 apply (replaces ``pallas_nufft1_1d``).

    ``x`` (N, 1) real; ``vals`` complex (N,) or (B, N), B >= 1; any odd
    mtot.  Returns complex (mtot,) or (B, mtot) from one launch (two
    kernels: per-chunk partials, then the chunk-order sum; scratch of
    nchunk * B * mtot values).  A CPU tensor takes the plain version."""
    _check(x, mtot, 1)
    n = x.shape[0]
    if vals.ndim not in (1, 2) or vals.shape[-1] != n:
        raise ValueError(f"vals must be ({n},) or (B, {n}), "
                         f"got {tuple(vals.shape)}")
    single = vals.ndim == 1
    B = 1 if single else vals.shape[0]
    _check_batch(B, mtot, 1, max(1, -(-n // TYPE1_CHUNK)))
    if x.device.type == "cpu":
        return nufft1_1d_ref(x, vals, h, mtot=mtot, fft_order=fft_order)
    cdtype = _complex_of(x.dtype)
    _check_cuda_operand("vals", vals, x, cdtype)
    if n == 0:
        out = torch.zeros((B, mtot), dtype=cdtype, device=x.device)
    else:
        x = x.contiguous()
        vals = vals.contiguous()
        h = float(torch.as_tensor(h, dtype=x.dtype))
        nchunk = -(-n // TYPE1_CHUNK)
        partial = torch.empty((nchunk, B, mtot), dtype=cdtype,
                              device=x.device)
        out = torch.empty((B, mtot), dtype=cdtype, device=x.device)
        _launch("nufft1_1d", x, x.data_ptr(), vals.data_ptr(), h, n, mtot, B,
                int(fft_order), TYPE1_CHUNK, partial.data_ptr(),
                out.data_ptr(), mtot=mtot)
    return out[0] if single else out


def nufft2_2d(x, f, h, *, mtot: int, fft_order: bool = False):
    """Fused type-2 apply for d=2 (replaces ``pallas_nufft2_2d``).

    ``x`` (N, 2) real, ``f`` complex (mtot, mtot) or (mtot^2,), ``h`` the
    grid spacing; returns complex (N,).  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    _check(x, mtot)
    if x.device.type == "cpu":
        return nufft2_2d_ref(x, f, h, mtot=mtot, fft_order=fft_order)
    cdtype = _complex_of(x.dtype)
    if f.numel() != mtot * mtot:
        raise ValueError(f"f has {f.numel()} entries, expected {mtot}^2")
    _check_cuda_operand("f", f, x, cdtype)
    n = x.shape[0]
    out = torch.empty(n, dtype=cdtype, device=x.device)
    if n == 0:
        return out
    x = x.contiguous()
    f = f.contiguous()
    h = float(torch.as_tensor(h, dtype=x.dtype))
    _launch("nufft2_2d", x, x.data_ptr(), f.data_ptr(), h, n, mtot,
            int(fft_order), out.data_ptr(), mtot=mtot)
    return out


def nufft1_2d(x, vals, h, *, mtot: int, fft_order: bool = False):
    """Fused type-1 apply for d=2 (replaces ``pallas_nufft1_2d``).

    ``x`` (N, 2) real, ``vals`` complex (N,); returns complex
    (mtot, mtot).  A CPU tensor takes the plain version; a CUDA tensor
    launches the two-stage kernel."""
    _check(x, mtot)
    if x.device.type == "cpu":
        return nufft1_2d_ref(x, vals, h, mtot=mtot, fft_order=fft_order)
    cdtype = _complex_of(x.dtype)
    n = x.shape[0]
    if vals.shape != (n,):
        raise ValueError(f"vals must be ({n},), got {tuple(vals.shape)}")
    _check_cuda_operand("vals", vals, x, cdtype)
    if n == 0:
        return torch.zeros((mtot, mtot), dtype=cdtype, device=x.device)
    x = x.contiguous()
    vals = vals.contiguous()
    h = float(torch.as_tensor(h, dtype=x.dtype))
    nchunk = -(-n // TYPE1_CHUNK)
    partial = torch.empty((nchunk, mtot, mtot), dtype=cdtype, device=x.device)
    out = torch.empty((mtot, mtot), dtype=cdtype, device=x.device)
    _launch("nufft1_2d", x, x.data_ptr(), vals.data_ptr(), h, n, mtot,
            int(fft_order), TYPE1_CHUNK, partial.data_ptr(), out.data_ptr(),
            mtot=mtot)
    return out


def _check_batch(B: int, mtot: int, d: int = 2, groups: int = 1):
    """B >= 1, and the B * mtot^d outputs, and the ``groups`` times as many
    partial sums of the d=3 type-1, within the kernels' 32-bit index
    range."""
    if B < 1:
        raise ValueError(f"the batch must hold at least one vector, got {B}")
    size = B * mtot ** d
    if groups * size >= 2 ** 31:
        raise ValueError(f"B * mtot^{d} = {size} (times {groups} partial-sum "
                         "groups) exceeds the kernels' 32-bit index range")


def nufft2_2d_batched(x, f, h, *, mtot: int, fft_order: bool = False):
    """Batched fused type-2 (replaces ``pallas_nufft2_2d_batched``).

    ``f`` complex (B, mtot, mtot) or (B, mtot^2), B >= 1; returns complex
    (B, N) from one launch.  A CPU tensor takes the plain version."""
    _check(x, mtot)
    m = mtot
    if f.ndim not in (2, 3) or tuple(f.shape[1:]) not in ((m * m,), (m, m)):
        raise ValueError(f"f must be (B, {m}, {m}) or (B, {m * m}), "
                         f"got {tuple(f.shape)}")
    B = f.shape[0]
    _check_batch(B, m)
    if x.device.type == "cpu":
        return nufft2_2d_batched_ref(x, f, h, mtot=m, fft_order=fft_order)
    cdtype = _complex_of(x.dtype)
    _check_cuda_operand("f", f, x, cdtype)
    n = x.shape[0]
    out = torch.empty((B, n), dtype=cdtype, device=x.device)
    if n == 0:
        return out
    x = x.contiguous()
    f = f.contiguous()
    h = float(torch.as_tensor(h, dtype=x.dtype))
    _launch("nufft2_2d_batched", x, x.data_ptr(), f.data_ptr(), h, n, m, B,
            int(fft_order), out.data_ptr(), mtot=m)
    return out


def nufft1_2d_batched(x, vals, h, *, mtot: int, fft_order: bool = False):
    """Batched fused type-1 (replaces ``pallas_nufft1_2d_batched``).

    ``vals`` complex (B, N), B >= 1; returns complex (B, mtot, mtot) from
    one launch (two kernels: per-chunk partials, then the chunk-order sum;
    scratch of nchunk * B * mtot^2 values).  A CPU tensor takes the plain
    version."""
    _check(x, mtot)
    n = x.shape[0]
    if vals.ndim != 2 or vals.shape[1] != n:
        raise ValueError(f"vals must be (B, {n}), got {tuple(vals.shape)}")
    B = vals.shape[0]
    _check_batch(B, mtot)
    if x.device.type == "cpu":
        return nufft1_2d_batched_ref(x, vals, h, mtot=mtot,
                                     fft_order=fft_order)
    cdtype = _complex_of(x.dtype)
    _check_cuda_operand("vals", vals, x, cdtype)
    if n == 0:
        return torch.zeros((B, mtot, mtot), dtype=cdtype, device=x.device)
    x = x.contiguous()
    vals = vals.contiguous()
    h = float(torch.as_tensor(h, dtype=x.dtype))
    nchunk = -(-n // TYPE1_CHUNK)
    partial = torch.empty((nchunk, B, mtot, mtot), dtype=cdtype,
                          device=x.device)
    out = torch.empty((B, mtot, mtot), dtype=cdtype, device=x.device)
    _launch("nufft1_2d_batched", x, x.data_ptr(), vals.data_ptr(), h, n, mtot,
            B, int(fft_order), TYPE1_CHUNK, partial.data_ptr(),
            out.data_ptr(), mtot=mtot)
    return out


def type1_3d_groups(n: int, mtot: int, B: int = 1) -> tuple[int, int]:
    """(groups, chunks per group) of the d=3 type-1's sum over points.

    Each block sums its group's 2048-point chunks (each chunk in registers,
    then into the block's running total), and a second kernel adds the
    groups in order.  Enough groups for about :data:`TYPE1_3D_BLOCKS`
    blocks, never an empty one; the scratch holds groups * B * mtot^3
    values."""
    nt = -(-mtot // 16)
    blocks = nt * nt * -(-mtot // 8) * B
    nchunk = max(1, -(-n // TYPE1_CHUNK))
    groups = min(nchunk, max(1, -(-TYPE1_3D_BLOCKS // blocks)))
    cpg = -(-nchunk // groups)
    return -(-nchunk // cpg), cpg


def nufft2_3d(x, f, h, *, mtot: int, fft_order: bool = False):
    """Fused d=3 type-2 apply (replaces ``pallas_nufft2_3d`` and
    ``_pallas_nufft2_3d_tiled``).

    ``x`` (N, 3) real; ``f`` complex (mtot,)*3 or (mtot^3,) for one vector,
    (B, mtot, mtot, mtot) or (B, mtot^3) for a batch of B >= 1; odd
    mtot <= 255.  Returns complex (N,) or (B, N) from one launch.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel."""
    _check(x, mtot, 3)
    m = mtot
    M = m ** 3
    if tuple(f.shape) in ((M,), (m, m, m)):
        single, B = True, 1
    elif f.ndim in (2, 4) and tuple(f.shape[1:]) in ((M,), (m, m, m)):
        single, B = False, f.shape[0]
    else:
        raise ValueError(f"f must be ({m}, {m}, {m}) or ({M},), with an "
                         f"optional leading batch, got {tuple(f.shape)}")
    _check_batch(B, m, 3)
    if x.device.type == "cpu":
        return nufft2_3d_ref(x, f, h, mtot=m, fft_order=fft_order)
    cdtype = _complex_of(x.dtype)
    _check_cuda_operand("f", f, x, cdtype)
    n = x.shape[0]
    out = torch.empty((B, n), dtype=cdtype, device=x.device)
    if n > 0:
        x = x.contiguous()
        f = f.contiguous()
        h = float(torch.as_tensor(h, dtype=x.dtype))
        _launch("nufft2_3d", x, x.data_ptr(), f.data_ptr(), h, n, m, B,
                int(fft_order), out.data_ptr(), mtot=m)
    return out[0] if single else out


def nufft1_3d(x, vals, h, *, mtot: int, fft_order: bool = False):
    """Fused d=3 type-1 apply (replaces ``pallas_nufft1_3d`` and
    ``_pallas_nufft1_3d_tiled``).

    ``x`` (N, 3) real; ``vals`` complex (N,) or (B, N), B >= 1; odd
    mtot <= 255.  Returns complex (mtot,)*3 or (B,) + (mtot,)*3 from one
    launch (two kernels: grouped partial sums, then the group-order sum;
    scratch of :func:`type1_3d_groups` * B * mtot^3 values).  A CPU tensor
    takes the plain version."""
    _check(x, mtot, 3)
    n = x.shape[0]
    if vals.ndim not in (1, 2) or vals.shape[-1] != n:
        raise ValueError(f"vals must be ({n},) or (B, {n}), "
                         f"got {tuple(vals.shape)}")
    single = vals.ndim == 1
    B = 1 if single else vals.shape[0]
    groups, _ = type1_3d_groups(n, mtot, B)
    _check_batch(B, mtot, 3, groups)
    if x.device.type == "cpu":
        return nufft1_3d_ref(x, vals, h, mtot=mtot, fft_order=fft_order)
    cdtype = _complex_of(x.dtype)
    _check_cuda_operand("vals", vals, x, cdtype)
    shape = (B, mtot, mtot, mtot)
    if n == 0:
        out = torch.zeros(shape, dtype=cdtype, device=x.device)
    else:
        x = x.contiguous()
        vals = vals.contiguous()
        h = float(torch.as_tensor(h, dtype=x.dtype))
        partial = torch.empty((groups,) + shape, dtype=cdtype,
                              device=x.device)
        out = torch.empty(shape, dtype=cdtype, device=x.device)
        _launch("nufft1_3d", x, x.data_ptr(), vals.data_ptr(), h, n, mtot, B,
                int(fft_order), TYPE1_CHUNK, groups, partial.data_ptr(),
                out.data_ptr(), mtot=mtot)
    return out[0] if single else out


@dataclasses.dataclass(frozen=True)
class CudaNUFFT:
    """NUFFT backend on the d=1, d=2 and d=3 kernels (replaces
    ``PallasNUFFT``, pallas_nufft.py:245): the same ``type1``/``type2``
    interface as :class:`~gpquad_torch.ops.nufft.NUFFT`, storing only the
    points.  At d=2 a single vector goes to ``nufft1_2d``/``nufft2_2d`` and
    a leading batch of two or more vectors (any shape, flat or block-shaped
    modes) to the batched kernel in one launch; at d=1
    (``nufft1_1d``/``nufft2_1d``) and d=3 (``nufft1_3d``/``nufft2_3d``) one
    kernel takes either in one launch."""
    x: torch.Tensor          # (N, d), d in {1, 2, 3}
    h: float                 # already rounded to x's precision
    mtot: int
    fft_order: bool = False

    @property
    def d(self) -> int:
        return self.x.shape[1]

    @property
    def n(self) -> int:
        return self.x.shape[0]

    def type1(self, vals):
        cdtype = _complex_of(self.x.dtype)
        kw = dict(mtot=self.mtot, fft_order=self.fft_order)
        lead = tuple(vals.shape[:-1])
        flat = vals.reshape(-1, vals.shape[-1]).to(cdtype)
        if self.d == 1:
            out = nufft1_1d(self.x, flat, self.h, **kw)
        elif self.d == 3:
            out = nufft1_3d(self.x, flat, self.h, **kw)
        elif flat.shape[0] == 1:
            out = nufft1_2d(self.x, flat[0], self.h, **kw)
        else:
            out = nufft1_2d_batched(self.x, flat, self.h, **kw)
        return out.reshape(lead + (self.mtot,) * self.d)

    def type2(self, fk):
        cdtype = _complex_of(self.x.dtype)
        m, d = self.mtot, self.d
        M, block = m ** d, (m,) * d
        kw = dict(mtot=m, fft_order=self.fft_order)
        if tuple(fk.shape) in ((M,), block):
            lead = ()
        else:
            lead = tuple(fk.shape[:-1] if fk.shape[-1] == M
                         else fk.shape[:-d])
        flat = fk.reshape((-1,) + block).to(cdtype)
        if d == 1:
            out = nufft2_1d(self.x, flat, self.h, **kw)
        elif d == 3:
            out = nufft2_3d(self.x, flat, self.h, **kw)
        elif flat.shape[0] == 1:
            out = nufft2_2d(self.x, flat[0], self.h, **kw)
        else:
            out = nufft2_2d_batched(self.x, flat, self.h, **kw)
        return out.reshape(lead + (self.n,))
