"""Hand-written CUDA NUFFT kernels for d=1, d=2 and d=3, their plain
versions, and the NUFFT backend built on them.

Port of ``gpquad/ops/pallas_nufft.py``.  The TPU file fuses the phase
construction with the complex products so that no ``(N, mtot)`` phase matrix
reaches device memory; the kernels in ``csrc/nufft_1d.cu``,
``csrc/nufft_2d.cu`` and ``csrc/nufft_3d.cu`` do the same on Hopper:

- :func:`nufft2_1d` replaces ``pallas_nufft2_1d`` (pallas_nufft.py:549) and
  :func:`nufft1_1d` replaces ``pallas_nufft1_1d`` (:584): any odd ``mtot``,
  one vector or a batch in one launch (gpquad maps the TPU kernel over a
  batch with ``lax.map``).  In float32 both run on the tensor cores on a
  split of the mode index, k = K q + r: the type-1 on the d=2 type-1's
  kernel (:func:`type1_1d_geometry`; :func:`nufft1_1d_3xtf32_ref` is its
  plain twin), the type-2, where :func:`type2_1d_geometry` sends it, on
  the d=2 type-2's (:func:`nufft2_1d_3xtf32_ref`).
- :func:`nufft2_2d` replaces ``pallas_nufft2_2d`` (pallas_nufft.py:113) and
  its mode-tiled twin ``_pallas_nufft2_2d_tiled`` (:369), any odd ``mtot``,
  on one of three paths that :func:`type2_2d_single_geometry` picks from
  the shape: in float32 with many points the batched type-2's tensor-core
  kernel at B 1 (:func:`nufft2_2d_batched_3xtf32_ref` is its twin); with
  few points on a wide grid a split of the first mode axis into slabs, a
  grid axis, whose partials a second pass adds in slab order
  (:func:`nufft2_2d_split_ref`); else one thread a point on the CUDA
  cores, tiling the modes inside.
- :func:`nufft1_2d` replaces ``pallas_nufft1_2d`` (:195) and
  ``_pallas_nufft1_2d_tiled`` (:442): in float32 a GEMM over the points on
  the tensor cores with an explicit 3xTF32 split, one partial sum per point
  group (:func:`type1_2d_chunk`), then a second pass adds the partials in
  group order; :func:`nufft1_2d_3xtf32_ref` is its plain twin.  In float64
  per-block partial sums over chunks of 2048 points on the CUDA cores.
- :func:`nufft2_2d_batched` replaces ``pallas_nufft2_2d_batched`` (:838)
  and :func:`nufft1_2d_batched` replaces ``pallas_nufft1_2d_batched``
  (:914): B vectors against the same points in one launch, the phases made
  once per group of batch elements (the gradient's probe batches).  In
  float32 the batched type-2 runs, where :func:`type2_2d_geometry` sends
  it, as a GEMM over the modes on the tensor cores with an explicit 3xTF32
  split and the sum over the first mode axis in its epilogue
  (:func:`nufft2_2d_batched_3xtf32_ref` is its plain twin), elsewhere on
  the CUDA cores.
- :func:`nufft2_3d` replaces ``pallas_nufft2_3d`` (:662) and its
  first-dimension slab-tiled twin ``_pallas_nufft2_3d_tiled`` (:1034), and
  :func:`nufft1_3d` replaces ``pallas_nufft1_3d`` (:750) and
  ``_pallas_nufft1_3d_tiled`` (:1118): one vector or a batch in one launch,
  any odd ``mtot`` up to 255 (the TPU's ``_D3_TILED_MAX``).  In float32
  the type-1 runs, where :func:`type1_3d_geometry` sends it, on the d=2
  type-1's tensor-core kernel with rows (r, j3) and columns (q, j2) of a
  split of the first axis's mode, k1 = S q + r
  (:func:`nufft1_3d_3xtf32_ref` is its plain twin), and the type-2, where
  :func:`type2_3d_geometry` sends it, on the d=2 type-2's tensor-core
  kernel as a GEMM over the pairs (j2, j3) with columns (vector, j1) and
  the sum over j1 in its epilogue (:func:`nufft2_3d_3xtf32_ref`).

All are bound by operations on an H100 (complex multiply-adds, ~8 mtot^d
flops per point and vector, and at d=1 the phases themselves): fp32 outside
the tensor cores, but for the float32 paths on the tensor cores (the type-1
and the type-2 at d=1-3), which take three TF32
products per real product; the sources say how the designs stage the work.  The wrappers take a tensor on the CPU to the plain
version (``*_ref``, the phase-matrix backend of ``ops/nufft.py``); on a
CUDA tensor they launch the kernel or raise.

The library is compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/gpquad_torch/`` at the checkout's root (one ``nvcc`` per source, all
started together, then one link), named after a hash of the sources so that
an edit rebuilds it, and loaded with ``ctypes``.  The same library holds
the SKI interpolation kernels of ``csrc/interp_2d.cu``, whose wrappers are
in ``ops/cuda_interp.py``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..utils import profiling
from .nufft import (CUDA_D3_MAX_MTOT, _k_values, _phase_matrix,
                    make_phase_nufft)

__all__ = ["nufft1_1d", "nufft2_1d", "nufft1_1d_ref", "nufft2_1d_ref",
           "nufft1_2d", "nufft2_2d", "nufft1_2d_ref", "nufft2_2d_ref",
           "nufft1_2d_batched", "nufft2_2d_batched", "nufft1_2d_batched_ref",
           "nufft2_2d_batched_ref", "nufft1_2d_3xtf32_ref",
           "nufft2_2d_batched_3xtf32_ref", "nufft2_2d_split_ref",
           "nufft1_1d_3xtf32_ref", "type1_1d_geometry", "type1_1d_split",
           "nufft2_1d_3xtf32_ref", "type2_1d_geometry",
           "type2_1d_tc_geometry", "type2_1d_scratch_floats",
           "nufft1_3d",
           "nufft2_3d", "nufft1_3d_ref", "nufft2_3d_ref", "type1_2d_chunk",
           "type1_2d_geometry", "type2_2d_geometry",
           "type2_2d_single_geometry",
           "type2_2d_scratch_floats", "type1_3d_groups",
           "type1_3d_geometry", "type1_3d_tc_geometry", "type1_3d_split",
           "nufft1_3d_3xtf32_ref", "nufft2_3d_3xtf32_ref",
           "type2_3d_geometry", "type2_3d_tc_geometry",
           "type2_3d_scratch_floats", "type2_3d_split",
           "CudaNUFFT", "LAUNCHES",
           "LAUNCH_WIDTHS", "LAUNCH_PRECISIONS", "build", "library_path"]

# Launches of each kernel since the last reset (a launch is one wrapper call
# on a CUDA tensor; the two stages of type-1 count once).
LAUNCHES = {"nufft1_1d": 0, "nufft2_1d": 0, "nufft1_2d": 0, "nufft2_2d": 0,
            "nufft1_2d_batched": 0, "nufft2_2d_batched": 0, "nufft1_3d": 0,
            "nufft2_3d": 0}
# The same launches by (kernel, mtot), and by (kernel, "f32" | "f64", mtot),
# counted at the same place.
LAUNCH_WIDTHS: dict[tuple[str, int], int] = {}
LAUNCH_PRECISIONS: dict[tuple[str, str, int], int] = {}

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
# every file the library depends on (hashed); the .cu files are compiled
_SOURCES = ("nufft_common.cuh", "tc_type1.cuh", "tc_type2.cuh", "nufft_1d.cu",
            "nufft_2d.cu", "nufft_3d.cu", "interp_2d.cu")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gpquad_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
TYPE1_CHUNK = 2048
# the card's streaming multiprocessors (an H100 SXM's 132), on which the
# tensor-core geometries below count their waves of blocks
CARD_SMS = 132
# the d=3 type-1 sums its chunks in groups, enough for about this many blocks
TYPE1_3D_BLOCKS = 1056
# The geometry of the float32 d=2 type-1 (csrc/tc_type1.cuh
# type1_tc_kernel on nufft_2d.cu's Type1Grid2D), owned here and passed to
# each launch (type1_2d_geometry), which refuses one it has no instance for:
# output tiles of 64 rows (one vector's 64 modes j, or two vectors' 32) by
# 128 modes k, or by 32 up to mtot 64 (where a wide tile is mostly padding),
# runs of 1024 points, and point groups for about this many blocks (four
# waves of one block on each of the card's CARD_SMS SMs)
TYPE1_2D_ROWS, TYPE1_2D_COLS, TYPE1_2D_RUN = 64, 128, 1024
TYPE1_2D_NARROW_COLS = 32
# points a sum of k-steps in fp32 registers (each k-step of 8 points a chain
# in the tensor cores' accumulators), then added into a run
TYPE1_2D_STAGE = 256
TYPE1_2D_BLOCKS = 4 * CARD_SMS
TYPE1_2D_BATCH_GROUP = 2
# The float32 d=1 type-1 takes the same kernel (csrc/tc_type1.cuh) on a
# split of its mode index (type1_1d_geometry): the tile, stage and batch
# group above, runs of this many points, and point groups for about one
# wave of blocks (one on each of the card's CARD_SMS SMs): at the light
# curve's calls that was 10-14% faster than four waves
# (scripts/time_type1_1d.py)
TYPE1_1D_RUN = 256
# The float32 d=3 type-1 takes the same kernel on nufft_3d.cu's Type1Grid3D
# (type1_3d_geometry): rows (r, j3), columns (q, j2) of the split k1 = S q +
# r, the d=2 type-1's tiles, stage, runs and point groups; its dispatch from
# the times of both kernels on the same inputs: the tensor cores up to this
# mtot (the wide column tiles' table fits to 64), the CUDA cores past it
TYPE1_3D_TC_MAX_MTOT = 64
# its wide column tiles unless they give fewer blocks than one wave on the
# card's CARD_SMS SMs and the narrow ones more (hard3d's F*y at 20 000
# points: 40 blocks of 64 x 128 against 120 of 64 x 32, 0.199 against 0.132
# ms on NVIDIA H100 80GB HBM3, 700 W, scripts/time_type1_3d.py)
# The float32 batched d=2 type-2 on the tensor cores (csrc/tc_type2.cuh
# type2_tc_kernel on nufft_2d.cu's Type2Grid2D), its geometry owned here
# (type2_2d_geometry) and checked by its launch: blocks of 128 points
# walking column tiles of 128 columns (vector, mode j), 32 modes k a stage;
# each vector's columns, and the modes k, padded to a multiple of the stage
# (the epilogue's chunk of modes j at this width)
TYPE2_2D_POINTS, TYPE2_2D_COLS, TYPE2_2D_STAGE = 128, 128, 32
# threads a block of the tensor-core type-2 (four a point in its epilogue,
# each summing a chunk of cols / 4 columns)
TYPE2_TC_THREADS = 512
# The float32 d=1 type-2 takes the same kernel on a split of its mode index
# (type2_1d_geometry): k = K q + r with K = 32, the points, stage and
# column tiles above, or column tiles of this width where they hold whole
# vectors (one vector's 32 columns); the q padded to whole k-steps of 8
TYPE2_1D_K = 32
TYPE2_1D_NARROW_COLS = 32
TYPE2_1D_KSTEP = 8
# The float32 d=1 type-2's dispatch, from the times of both kernels on the
# same inputs (chip_smoke.py phase 3 at the driven shapes, and a sweep of
# mtot 129-2061 by 1 000-20 000 points at B 1 and 10 on NVIDIA H100 80GB
# HBM3, 700 W): the tensor cores from this mtot and this much work n mtot
# a vector, for one vector and for a batch (whose column tiles a block
# walks in turn, where the CUDA cores spread the vectors over blocks); the
# CUDA cores below either
TYPE2_1D_TC_MIN_MTOT = 512
TYPE2_1D_TC_MIN_WORK = {False: 2 ** 20, True: 2 ** 23}
# The float32 batched type-2's dispatch by mtot, from chip_smoke.py phase
# 3's times of both kernels on the same inputs: the tensor cores from this
# mtot on, the CUDA cores below it
TYPE2_2D_TC_MIN_MTOT = 64
# The single type-2's mode split (csrc/nufft_2d.cu nufft2_2d_split_kernel):
# blocks of 64 points by slabs of 16 modes j, checked by its launch
TYPE2_2D_SPLIT_THREADS, TYPE2_2D_SPLIT_ROWS = 64, 16
# The single type-2's dispatch (type2_2d_single_geometry), from the times
# of its paths on the same inputs (chip_smoke.py phase 3 at the driven
# shapes, scripts/time_type2_single.py between them): the mode split from
# this mtot on (three slabs and more) below a number of points by
# precision (in float64 it leads by 5-14% at 60 000 points and ties the
# CUDA cores within 4% at 100 000); in float32 the tensor cores from
# TYPE2_2D_TC_MIN_MTOT and this many points
TYPE2_2D_SPLIT_MIN_MTOT = 45
TYPE2_2D_SPLIT_MAX_POINTS = {torch.float32: 16384, torch.float64: 65536}
TYPE2_2D_SINGLE_TC_MIN_POINTS = 8192
# The float32 d=3 type-2 takes the same kernel on nufft_3d.cu's Type2Grid3D
# (type2_3d_geometry): a GEMM over the pairs (j2, j3), j3 padded to a
# multiple of the stage (one j2 and 32 modes j3 a stage), with columns
# (vector, j1) in tiles of 32 or 64 (at 128 its shared memory would pass
# the block's 227 KB), each vector's j1 padded to a multiple of 32, blocks
# of TYPE2_2D_POINTS points; for few points the
# stages split over a grid axis into at most this many runs, whose partials
# a second pass adds in split order, as many as fill the card's SMs best
TYPE2_3D_WIDTHS = (32, 64)
TYPE2_3D_MAX_SPLITS = 16
# a split's cost beyond its stages, in stages (its first F copy, which no
# stage hides, and its epilogue), in the split's choice
TYPE2_3D_SPLIT_OVERHEAD = 2
# The float32 d=3 type-2's dispatch, from the times of both kernels on the
# same inputs (chip_smoke.py phase 3 at the driven shapes, and
# scripts/time_type2_3d.py's sweep of mtot 21-71 at 1e4-1e5 points and B 1
# and 10 on NVIDIA H100 80GB HBM3, 700 W): the CUDA cores where the tensor
# cores' padding, (mtot rounded up to 32 / mtot)^2 for j1 and j3, passes
# this and the call has this many point-vectors n B (where the CUDA-core
# kernel runs a thread a point): at mtot 21, 23 and 33-39 (padding 2.3,
# 1.9, 2.7-3.8) they took 1.10-1.25x its time at 2e4 x B 10 and 1e5
# points, and at 25 (1.6) 0.79-0.93x; the tensor cores elsewhere.  The
# padding is not the whole story: the CUDA-core kernel's slabs of 8 modes
# j1 step up at 41, so at 41-47 (padding 1.9-2.4) the tensor cores take
# 0.94-0.99x its time, and at 65-71 (1.8-2.2) 0.94-0.95x at 2e4 x B 10 but
# 1.16-1.18x at 1e5 x B 1; the rule keeps all of these on the CUDA cores
# (at most 6% slower than the pick could be; no driven shape is there)
TYPE2_3D_MAX_PADDING = 1.8
TYPE2_3D_FEW_POINTS = 65536

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
            if prec == "f32":
                # the tensor-core forms: the type-2's geometry (points, K,
                # cols, stage) and the split f's scratch and size before
                # the output; the type-1's (rows, cols, group, stage, run,
                # chunk) before the scratch
                o2t = lib.gpq_nufft2_1d_tc_f32
                o2t.argtypes = [ptr, ptr, real, i32, i32, i32, i32, *[i32] * 4,
                                ptr, ctypes.c_longlong, ptr, ptr]
                o2t.restype = i32
                o1t = lib.gpq_nufft1_1d_tc_f32
                o1t.argtypes = [ptr, ptr, real, i32, i32, i32, i32, *[i32] * 6,
                                ptr, ptr, ptr]
                o1t.restype = i32
            t2 = getattr(lib, f"gpq_nufft2_2d_{prec}")
            t2.argtypes = [ptr, ptr, real, i32, i32, i32, ptr, ptr]
            t2.restype = i32
            # the float32 d=2 type-1 also takes its geometry (rows, cols,
            # group, stage, run) before the chunk
            geo = [i32] * 5 if prec == "f32" else []
            t1 = getattr(lib, f"gpq_nufft1_2d_{prec}")
            t1.argtypes = [ptr, ptr, real, i32, i32, i32, *geo, i32, ptr, ptr,
                           ptr]
            t1.restype = i32
            b2 = getattr(lib, f"gpq_nufft2_2d_batched_{prec}")
            b2.argtypes = [ptr, ptr, real, i32, i32, i32, i32, ptr, ptr]
            b2.restype = i32
            if prec == "f32":
                # the tensor-core form: its geometry (points, cols, stage)
                # and the split F's scratch and size before the output
                tc = lib.gpq_nufft2_2d_batched_tc_f32
                tc.argtypes = [ptr, ptr, real, i32, i32, i32, i32, i32, i32,
                               i32, ptr, ctypes.c_longlong, ptr, ptr]
                tc.restype = i32
            # the single type-2's mode split: its geometry (rows, threads),
            # the slabs' partials and the output
            t2s = getattr(lib, f"gpq_nufft2_2d_split_{prec}")
            t2s.argtypes = [ptr, ptr, real, i32, i32, i32, i32, i32, ptr, ptr,
                            ptr]
            t2s.restype = i32
            b1 = getattr(lib, f"gpq_nufft1_2d_batched_{prec}")
            b1.argtypes = [ptr, ptr, real, i32, i32, i32, i32, *geo, i32, ptr,
                           ptr, ptr]
            b1.restype = i32
            d2 = getattr(lib, f"gpq_nufft2_3d_{prec}")
            d2.argtypes = [ptr, ptr, real, i32, i32, i32, i32, ptr, ptr]
            d2.restype = i32
            d1 = getattr(lib, f"gpq_nufft1_3d_{prec}")
            d1.argtypes = [ptr, ptr, real, i32, i32, i32, i32, i32, i32, ptr,
                           ptr, ptr]
            d1.restype = i32
            if prec == "f32":
                # the tensor-core form: its geometry (rows, cols, group,
                # stage, run, chunk) before the scratch
                d1t = lib.gpq_nufft1_3d_tc_f32
                d1t.argtypes = [ptr, ptr, real, i32, i32, i32, i32, *[i32] * 6,
                                ptr, ptr, ptr]
                d1t.restype = i32
                # the type-2's: its geometry (points, cols, stage, splits)
                # and the scratch and its size before the output
                d2t = lib.gpq_nufft2_3d_tc_f32
                d2t.argtypes = [ptr, ptr, real, i32, i32, i32, i32, *[i32] * 4,
                                ptr, ctypes.c_longlong, ptr, ptr]
                d2t.restype = i32
            # the SKI interpolation kernels (ops/cuda_interp.py)
            it = getattr(lib, f"gpq_interp_T_2d_{prec}")
            it.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                           i32, ptr, ptr]
            it.restype = i32
            i64 = ctypes.c_longlong
            ip = getattr(lib, f"gpq_interp_2d_{prec}")
            # the grid and its strides (batch, band, row, column), the rows
            # holding data, 16-byte staging, the tables and the point of
            # each slot (None: band-slot order), B, nbands, cap, G2, n
            ip.argtypes = [ptr, i64, i64, i64, i64, i32, i32, ptr, ptr, ptr,
                           ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr]
            ip.restype = i32
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


def _launch(name: str, x: torch.Tensor, *args, mtot: int,
            symbol: str | None = None):
    """Call ``gpq_<name>_<f32|f64>`` (x's precision), or the C function
    ``symbol`` where given, with ``args`` and x's current stream; raise on a
    CUDA error, count the launch of ``name`` (by kernel, by kernel and
    ``mtot``, and by kernel, precision and ``mtot``)."""
    prec = "f32" if x.dtype == torch.float32 else "f64"
    fn = getattr(_library(), symbol or f"gpq_{name}_{prec}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} "
                           f"({torch.cuda.get_device_name(x.device)})")
    LAUNCHES[name] += 1
    LAUNCH_WIDTHS[name, mtot] = LAUNCH_WIDTHS.get((name, mtot), 0) + 1
    LAUNCH_PRECISIONS[name, prec, mtot] = LAUNCH_PRECISIONS.get(
        (name, prec, mtot), 0) + 1


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


def _tf32(a):
    """``cvt.rna.tf32.f32`` bit for bit: round float32 ``a`` to 10 mantissa
    bits, to nearest with ties away from zero (add half of the dropped 13
    bits' range to the magnitude, then clear them)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split3(a):
    big = _tf32(a)
    return big, _tf32(a - big)


def _type1_3xtf32_sums(A, E, *, chunk: int, run: int, stage: int,
                       passes: int, group_dtype=torch.complex64):
    """The tensor-core type-1's sums (csrc/tc_type1.cuh) in float32 with
    its tiling algebra: ``out[b, r, c] = sum_n A[b, n, r] E[n, c]`` for
    ``A`` (B, N, R) and ``E`` (N, C) complex64, as the real products
    ``Re = Ar^T Er + Ai^T (-Ei)``, ``Im = Ar^T Ei + Ai^T Er`` over k-steps of
    8 points, each operand split into ``big = tf32(a)`` and
    ``small = tf32(a - big)`` (``cvt.rna`` emulated bit for bit) and each
    product taken as small*big + big*small + big*big in that order, the six
    products of a k-step summed from zero (the kernel's chain of mma); the
    k-steps of ``stage`` points added in fp32, those sums of a run of
    ``run`` points added in fp32, the runs into the group's total, the
    groups of ``chunk`` points in group order in ``group_dtype``.
    ``passes=1`` keeps big*big alone: plain TF32.  The tensor cores' own
    rounding inside an 8-point product is not emulated (here a float32
    matmul).  Returns (B, R, C) complex64."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    if chunk % run:
        raise ValueError(f"chunk must be a multiple of {run}")
    B, n, R = A.shape
    C = E.shape[1]
    n8 = -(-n // 8) * 8
    pad = (0, 0, 0, n8 - n)
    A = torch.nn.functional.pad(A, pad + (0, 0))
    E = torch.nn.functional.pad(E, pad)
    steps = n8 // 8
    order = ((1, 0), (0, 1), (0, 0)) if passes == 3 else ((0, 0),)

    def products(s0, s1):
        """The six real 8-point products of each k-step s0..s1-1, in the
        kernel's order, each (B, s1 - s0, R, C) complex (Re and Im parts
        from the split (B, steps, 8, R) and (steps, 8, C) operands; -Ei in
        the real part)."""
        a_, e_ = A[:, s0 * 8:s1 * 8], E[s0 * 8:s1 * 8]
        ar, ai = (_split3(t.reshape(B, s1 - s0, 8, R))
                  for t in (a_.real, a_.imag))
        er, ei = (_split3(t.reshape(s1 - s0, 8, C))
                  for t in (e_.real, e_.imag))
        nei = tuple(-t for t in ei)

        def mm(a, b):
            return torch.matmul(a.transpose(-1, -2), b)
        out_ = []
        for i, j in order:
            out_.append(torch.complex(mm(ar[i], er[j]), mm(ar[i], ei[j])))
            out_.append(torch.complex(mm(ai[i], nei[j]), mm(ai[i], er[j])))
        return out_

    out = torch.zeros((B, R, C), dtype=group_dtype, device=A.device)
    run_steps, group_steps = run // 8, chunk // 8
    stage_steps = stage // 8
    for g0 in range(0, steps, group_steps):
        tot = torch.zeros((B, R, C), dtype=torch.complex64, device=A.device)
        for r0 in range(g0, min(steps, g0 + group_steps), run_steps):
            r1 = min(steps, r0 + run_steps)
            run_sum = torch.zeros_like(tot)
            for st0 in range(r0, r1, stage_steps):
                st1 = min(r1, st0 + stage_steps)
                prods = products(st0, st1)
                acc = torch.zeros_like(tot)
                for s_ in range(st1 - st0):
                    d = prods[0][:, s_]
                    for p in prods[1:]:
                        d = d + p[:, s_]
                    acc = acc + d
                run_sum = run_sum + acc
            tot = tot + run_sum
        out = out + tot.to(group_dtype)
    return out.to(torch.complex64)


def nufft1_2d_3xtf32_ref(x, vals, h, *, mtot: int, fft_order: bool = False,
                         chunk: int | None = None, passes: int = 3):
    """Plain twin of the float32 d=2 type-1 kernel (csrc/tc_type1.cuh
    ``type1_tc_kernel`` on nufft_2d.cu's ``Type1Grid2D``):
    ``out[b,j,k] = sum_n v[b,n] e1(n,j) e2(n,k)`` in the kernel's sums
    (:func:`_type1_3xtf32_sums`: k-steps of 8 points, sums of
    :data:`TYPE1_2D_STAGE` points, runs of :data:`TYPE1_2D_RUN`, groups of
    ``chunk`` points, by default :func:`type1_2d_chunk`'s, in group order
    in float32).  ``passes=1`` keeps big*big alone: plain TF32, the control
    the split is held against.

    ``vals`` (N,) or (B, N); returns complex64 (mtot, mtot) or (B, mtot,
    mtot).  For the tests on the CPU only."""
    x = x.to(torch.float32)
    n = x.shape[0]
    single = vals.ndim == 1
    V = vals.reshape(-1, n).to(torch.complex64)
    if chunk is None:
        chunk = type1_2d_chunk(n, mtot, V.shape[0], batched=not single)
    hq = torch.tensor(h, dtype=torch.float32)
    k = _k_values(mtot, fft_order, torch.float32, x.device)
    e1 = _phase_matrix(x[:, 0] * hq, k, torch.complex64)    # (N, m)
    e2 = _phase_matrix(x[:, 1] * hq, k, torch.complex64)
    out = _type1_3xtf32_sums(V[:, :, None] * e1[None], e2, chunk=chunk,
                             run=TYPE1_2D_RUN, stage=TYPE1_2D_STAGE,
                             passes=passes)
    return out[0] if single else out


def type1_1d_split(mtot: int, K: int) -> tuple[int, int]:
    """The float32 d=1 type-1's split of the mode index, k = K q + r with
    r in 0..K-1: ``(qmin, Q)``, q running over qmin .. qmin + Q - 1, the
    fewest that reach every |k| <= (mtot - 1) / 2 (csrc/nufft_1d.cu
    ``Type1Split1D``)."""
    half = (mtot - 1) // 2
    qmin = -half // K
    return qmin, half // K - qmin + 1


def _split_phases(x, h, modes):
    """e^{-2 pi i t k} for t = x h taken exactly (the float32 x and h
    multiplied in float64, as the kernel carries the rounding of t into the
    phase) at the integer mode values ``modes``, reduced to the nearest
    whole cycle in float64 and rounded to complex64: (N, len(modes))."""
    t = x.to(torch.float64)[:, None] * float(torch.tensor(h,
                                                          dtype=torch.float32))
    cyc = t * modes.to(torch.float64)[None, :]
    cyc = cyc - torch.round(cyc)
    return torch.polar(torch.ones_like(cyc), -2 * torch.pi * cyc).to(
        torch.complex64)


def nufft1_1d_3xtf32_ref(x, vals, h, *, mtot: int, fft_order: bool = False,
                         chunk: int | None = None, passes: int = 3):
    """Plain twin of the float32 d=1 type-1 kernel on the tensor cores
    (csrc/tc_type1.cuh ``type1_tc_kernel`` on nufft_1d.cu's
    ``Type1Split1D``), in float32 with its tiling algebra: each mode split
    as k = K q + r (:func:`type1_1d_split`, K = rows / group of
    :func:`type1_1d_geometry`), ``out[b, r, q] = sum_n (v[b,n] e^{-2 pi i
    r t_n}) e^{-2 pi i K q t_n}`` in the kernel's sums
    (:func:`_type1_3xtf32_sums`: k-steps of 8 points, stage and run sums,
    groups of ``chunk`` points, by default the geometry's, added in group
    order in float64 and rounded once), then cropped to the mtot modes.
    The phases are those of the exact t = x h (:func:`_split_phases`).
    ``passes=1`` keeps big*big alone: plain TF32, the control the split is
    held against.

    ``x`` (N, 1); ``vals`` (N,) or (B, N); returns complex64 (mtot,) or
    (B, mtot).  For the tests on the CPU only."""
    x = x.reshape(-1).to(torch.float32)
    n = x.shape[0]
    single = vals.ndim == 1
    V = vals.reshape(-1, n).to(torch.complex64)
    B = V.shape[0]
    _, rows, _, group, stage, run, geo_chunk = type1_1d_geometry(n, mtot, B)
    K = rows // group
    qmin, Q = type1_1d_split(mtot, K)
    dev = x.device
    e1 = _split_phases(x, h, torch.arange(K, device=dev))
    e2 = _split_phases(x, h, K * (qmin + torch.arange(Q, device=dev)))
    sums = _type1_3xtf32_sums(V[:, :, None] * e1[None], e2,
                              chunk=chunk or geo_chunk, run=run, stage=stage,
                              passes=passes, group_dtype=torch.complex128)
    k = (K * (qmin + torch.arange(Q, device=dev)))[None, :] \
        + torch.arange(K, device=dev)[:, None]              # (K, Q)
    half = (mtot - 1) // 2
    keep = k.abs() <= half
    idx = torch.where(k >= 0, k, k + mtot) if fft_order else k + half
    out = torch.zeros((B, mtot), dtype=torch.complex64, device=dev)
    out[:, idx[keep]] = sums[:, keep]
    return out[0] if single else out


def nufft1_3d_3xtf32_ref(x, vals, h, *, mtot: int, fft_order: bool = False,
                         chunk: int | None = None, passes: int = 3):
    """Plain twin of the float32 d=3 type-1 kernel on the tensor cores
    (csrc/tc_type1.cuh ``type1_tc_kernel`` on nufft_3d.cu's
    ``Type1Grid3D``), in float32 with its tiling algebra: ``out[b, (j1, j2),
    j3] = sum_n (v[b,n] e1(n,j1) e2(n,j2)) e3(n,j3)`` in the kernel's sums
    (:func:`_type1_3xtf32_sums`: k-steps of 8 points, sums of
    :data:`TYPE1_2D_STAGE` points, runs of :data:`TYPE1_2D_RUN`, groups of
    ``chunk`` points, by default :func:`type1_3d_tc_geometry`'s, in group
    order in float32).  Those sums do not depend on where the kernel puts
    an output (its rows (r, j3) and columns (q, j2) of k1 = S q + r); the
    rounding of the phase products inside them does.  ``passes=1`` keeps
    big*big alone: plain TF32, the control the split is held against.

    ``x`` (N, 3); ``vals`` (N,) or (B, N); returns complex64 (mtot,)*3 or
    (B,) + (mtot,)*3.  For the tests on the CPU only."""
    x = x.to(torch.float32)
    n, m = x.shape[0], mtot
    single = vals.ndim == 1
    V = vals.reshape(-1, n).to(torch.complex64)
    B = V.shape[0]
    geo = type1_3d_tc_geometry(n, m, B)
    hq = torch.tensor(h, dtype=torch.float32)
    k = _k_values(m, fft_order, torch.float32, x.device)
    e1, e2, e3 = (_phase_matrix(x[:, i] * hq, k, torch.complex64)
                  for i in range(3))                       # (N, m) each
    e12 = (e1[:, :, None] * e2[:, None, :]).reshape(n, m * m)
    out = _type1_3xtf32_sums(V[:, :, None] * e12[None], e3,
                             chunk=chunk or geo[-1], run=TYPE1_2D_RUN,
                             stage=TYPE1_2D_STAGE, passes=passes)
    out = out.reshape((B,) + (m,) * 3)
    return out[0] if single else out


def nufft2_3d_3xtf32_ref(x, f, h, *, mtot: int, fft_order: bool = False,
                         geometry: tuple | None = None, passes: int = 3):
    """Plain twin of the float32 d=3 type-2 kernel on the tensor cores
    (csrc/tc_type2.cuh ``type2_tc_kernel`` on nufft_3d.cu's
    ``Type2Grid3D``), in float32 with its tiling algebra
    (:func:`_type2_3xtf32_sums`): the modes j3 padded to J3, a multiple of
    32 (:func:`type2_3d_split`), the reduction index k = (jb mtot + j2) 32 +
    j3 % 32 (jb = j3 / 32), ``T[p, b, j1] = sum_k e2(p,j2) e3(p,j3)
    f[b,j1,j2,j3]`` over k-steps of 8 modes (f and e3 zero past mtot), then
    ``out[b, p] = sum_j1 e1(p,j1) T[p,b,j1]`` in chunks of cols / 4 modes
    j1 (the epilogue's four threads a point, each vector's j1 padded to a
    multiple of 32), each in j1 order from zero, added in chunk order; with
    ``splits`` runs of whole stages of 32 modes k, each run's sums so
    taken and the runs' added in split order in float32.  ``geometry`` is
    :func:`type2_3d_tc_geometry`'s (by default that of the shape).
    ``passes=1`` keeps big*big alone: plain TF32, the control the split is
    held against.

    ``x`` (N, 3); ``f`` as :func:`nufft2_3d` takes it; returns complex64
    (N,) or (B, N).  For the tests on the CPU only."""
    x = x.to(torch.float32)
    n, m = x.shape[0], mtot
    single, B = _type2_3d_batch(f, m)
    F = f.reshape(B, m, m, m).to(torch.complex64)      # (B, j1, j2, j3)
    _, points, cols, _, splits = (geometry
                                  or type2_3d_tc_geometry(n, m, B))
    J3, nst = type2_3d_split(m)
    mq = _round_up(m, TYPE2_2D_STAGE)
    hq = torch.tensor(h, dtype=torch.float32)
    k = _k_values(m, fft_order, torch.float32, x.device)
    # e^{+2 pi i}: the conjugates of the type-1's phases
    e1, e2, e3 = (_phase_matrix(x[:, i] * hq, k, torch.complex64).conj()
                  for i in range(3))                   # (N, m) each
    nblk = J3 // TYPE2_2D_STAGE
    e3 = torch.nn.functional.pad(e3, (0, J3 - m)).reshape(n, nblk, 1, -1)
    eA = (e2[:, None, :, None] * e3).reshape(n, nst * TYPE2_2D_STAGE)
    Fk = torch.nn.functional.pad(F, (0, J3 - m, 0, 0, 0, mq - m))
    Fk = Fk.reshape(B, mq, m, nblk, TYPE2_2D_STAGE).permute(3, 2, 4, 0, 1)
    Fk = Fk.reshape(nst * TYPE2_2D_STAGE, B * mq)
    eE = torch.nn.functional.pad(e1, (0, mq - m))
    per = -(-nst // splits) * TYPE2_2D_STAGE
    out = None
    for k0 in range(0, nst * TYPE2_2D_STAGE, per):
        part = _type2_3xtf32_sums(eA[:, k0:k0 + per], Fk[k0:k0 + per], eE,
                                  chunk=cols * points // TYPE2_TC_THREADS,
                                  passes=passes)
        out = part if out is None else out + part
    return out[0] if single else out


def _type2_3xtf32_sums(eA, F, eE, *, chunk: int, passes: int):
    """The tensor-core type-2's sums (csrc/tc_type2.cuh) in float32 with
    its tiling algebra: ``T[p, c] = sum_k eA[p, k] F[k, c]`` as the real
    products ``T_re = C Fr + S (-Fi)``, ``T_im = C Fi + S Fr`` (C, S the
    cos and sin of eA) over k-steps of 8 modes, each operand split into
    ``big = tf32(a)`` and ``small = tf32(a - big)`` (``cvt.rna`` emulated
    bit for bit) and each product taken as small*big + big*small + big*big
    in that order, the six products of a k-step summed from zero (the
    kernel's chain of mma) and the k-steps added in fp32; then
    ``out[b, p] = sum_j eE[p, j] T[p, (b, j)]`` as the kernel's epilogue sums
    it: chunks of ``chunk`` columns j, each summed in j order from zero,
    added in chunk order.  ``passes=1`` keeps big*big alone: plain TF32.

    ``eA`` (N, kq) complex64, kq a multiple of 8; ``F`` (kq, B * mc), columns
    (b, j); ``eE`` (N, mc).  The tensor cores' own rounding inside an
    8-mode product is not emulated (here a float32 matmul).  Returns
    complex64 (B, N)."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    n, kq = eA.shape
    mc = eE.shape[1]
    B = F.shape[1] // mc
    steps = kq // 8
    # A: (steps, N, 8) cos and sin; B: (steps, 8, B mc) Re and Im
    C, S = (_split3(t.contiguous().reshape(n, steps, 8).transpose(0, 1))
            for t in (eA.real, eA.imag))
    Fr, Fi = (_split3(t.contiguous().reshape(steps, 8, B * mc))
              for t in (F.real, F.imag))
    nFi = tuple(-t for t in Fi)
    order = ((1, 0), (0, 1), (0, 0)) if passes == 3 else ((0, 0),)
    t_re = torch.zeros((n, B * mc), dtype=torch.float32, device=eA.device)
    t_im = torch.zeros_like(t_re)
    for s in range(steps):
        d_re = torch.zeros_like(t_re)
        d_im = torch.zeros_like(t_re)
        for i, j in order:
            d_re = d_re + C[i][s] @ Fr[j][s]
            d_im = d_im + C[i][s] @ Fi[j][s]
            d_re = d_re + S[i][s] @ nFi[j][s]
            d_im = d_im + S[i][s] @ Fr[j][s]
        t_re = t_re + d_re
        t_im = t_im + d_im
    W = eE[:, None, :] * torch.complex(t_re, t_im).reshape(n, B, mc)
    out = None
    for j0 in range(0, mc, chunk):
        part = W[:, :, j0]
        for j in range(j0 + 1, min(mc, j0 + chunk)):
            part = part + W[:, :, j]
        out = part if out is None else out + part
    return out.T.contiguous()


def nufft2_2d_batched_3xtf32_ref(x, f, h, *, mtot: int,
                                 fft_order: bool = False, passes: int = 3):
    """Plain twin of the float32 batched d=2 type-2 kernel on the tensor
    cores (csrc/tc_type2.cuh ``type2_tc_kernel`` on nufft_2d.cu's
    ``Type2Grid2D``), in float32 with its tiling algebra
    (:func:`_type2_3xtf32_sums`): ``T[p, b, j] = sum_k e2(p,k) f[b,j,k]``
    over k-steps of 8 modes, then ``out[b, p] = sum_j e1(p,j) T[p,b,j]`` in
    chunks of :data:`TYPE2_2D_STAGE` modes j, each summed in j order from
    zero, added in chunk order.  ``passes=1`` keeps big*big alone: plain
    TF32, the control the split is held against.

    ``f`` (B, mtot, mtot) or (B, mtot^2); returns complex64 (B, N).  For
    the tests on the CPU only."""
    x = x.to(torch.float32)
    m = mtot
    F = f.reshape(-1, m, m).to(torch.complex64)       # (B, j, k)
    B = F.shape[0]
    hq = torch.tensor(h, dtype=torch.float32)
    k = _k_values(m, fft_order, torch.float32, x.device)
    # e^{+2 pi i}: the conjugates of the type-1's phases
    e1 = _phase_matrix(x[:, 0] * hq, k, torch.complex64).conj()   # (N, m)
    e2 = _phase_matrix(x[:, 1] * hq, k, torch.complex64).conj()
    kq = _round_up(m, 8)
    eA = torch.nn.functional.pad(e2, (0, kq - m))
    Fk = torch.nn.functional.pad(F.permute(2, 0, 1), (0, 0, 0, 0, 0, kq - m))
    return _type2_3xtf32_sums(eA, Fk.reshape(kq, B * m), e1,
                              chunk=TYPE2_2D_STAGE, passes=passes)


def nufft2_1d_3xtf32_ref(x, f, h, *, mtot: int, fft_order: bool = False,
                         geometry: tuple | None = None, passes: int = 3):
    """Plain twin of the float32 d=1 type-2 kernel on the tensor cores
    (csrc/tc_type2.cuh ``type2_tc_kernel`` on nufft_1d.cu's
    ``Type2Split1D``), in float32 with its tiling algebra
    (:func:`_type2_3xtf32_sums`): each mode split as k = K q + r
    (:func:`type1_1d_split`), ``T[p, b, r] = sum_q e^{+2 pi i K q t_p}
    f_b[K q + r]`` over k-steps of 8 values of q (f zero past the mtot
    modes), then ``out[b, p] = sum_r e^{+2 pi i r t_p} T[p, b, r]`` in
    chunks of cols / 4 values of r (the epilogue's four threads a point),
    each in r order from zero, added in chunk order.  The phases are those
    of the exact t = x h (:func:`_split_phases`).  ``geometry`` is
    :func:`type2_1d_geometry`'s tensor-core one (by default that of the
    shape).  ``passes=1`` keeps big*big alone: plain TF32, the control the
    split is held against.

    ``x`` (N, 1); ``f`` (mtot,) or (B, mtot); returns complex64 (N,) or
    (B, N).  For the tests on the CPU only."""
    x = x.reshape(-1).to(torch.float32)
    n = x.shape[0]
    single = f.ndim == 1
    F = f.reshape(-1, mtot).to(torch.complex64)
    B = F.shape[0]
    geo = geometry or type2_1d_tc_geometry(B)
    _, points, K, cols, _ = geo
    qmin, Q = type1_1d_split(mtot, K)
    kq = _round_up(Q, TYPE2_1D_KSTEP)
    dev = x.device
    q = qmin + torch.arange(kq, device=dev)
    eA = _split_phases(x, h, K * q).conj()
    eA[:, Q:] = 0
    eE = _split_phases(x, h, torch.arange(K, device=dev)).conj()
    # the coefficients of (q, r): f at mode K q + r, zero past half
    k = K * q[:, None] + torch.arange(K, device=dev)[None, :]   # (kq, K)
    half = (mtot - 1) // 2
    keep = (k.abs() <= half) & (torch.arange(kq, device=dev) < Q)[:, None]
    idx = torch.where(k >= 0, k, k + mtot) if fft_order else k + half
    Fq = torch.where(keep, F[:, idx.clamp(0, mtot - 1)],
                     torch.zeros((), dtype=torch.complex64))   # (B, kq, K)
    out = _type2_3xtf32_sums(eA, Fq.permute(1, 0, 2).reshape(kq, B * K), eE,
                             chunk=cols * points // TYPE2_TC_THREADS,
                             passes=passes)
    return out[0] if single else out


def nufft2_2d_split_ref(x, f, h, *, mtot: int, fft_order: bool = False,
                        rows: int | None = None):
    """Plain twin of the single type-2's mode split (csrc/nufft_2d.cu
    ``nufft2_2d_split_kernel``), in x's precision with its sum order: for
    each slab of ``rows`` modes j (by default the kernel's
    :data:`TYPE2_2D_SPLIT_ROWS`), ``T[n, j] = sum_k f[j,k] e2(n,k)`` (here
    a matmul, not the kernel's k-order chains), then the slab's sum of
    ``e1(n,j) T[n,j]`` in j order from zero; the slabs' sums added in slab
    order.  ``f`` (mtot, mtot) or (mtot^2,); returns complex (N,).  For the
    tests on the CPU only."""
    m = mtot
    rows = rows or TYPE2_2D_SPLIT_ROWS
    cdt = _complex_of(x.dtype)
    F = f.reshape(m, m).to(cdt)
    hq = torch.tensor(h, dtype=x.dtype)
    k = _k_values(m, fft_order, x.dtype, x.device)
    # e^{+2 pi i}: the conjugates of the type-1's phases
    e1 = _phase_matrix(x[:, 0] * hq, k, cdt).conj()      # (N, m)
    e2 = _phase_matrix(x[:, 1] * hq, k, cdt).conj()
    out = None
    for j0 in range(0, m, rows):
        W = e1[:, j0:j0 + rows] * (e2 @ F[j0:j0 + rows].T)
        part = W[:, 0]
        for j in range(1, W.shape[1]):
            part = part + W[:, j]
        out = part if out is None else out + part
    return out


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
    launches the kernel :func:`type2_1d_geometry` picks in float32 (the
    tensor cores on a split of the mode index, with a scratch of
    :func:`type2_1d_scratch_floats` floats, or the CUDA cores), the
    CUDA-core kernel in float64."""
    _check(x, mtot, 1)
    if f.ndim not in (1, 2) or f.shape[-1] != mtot:
        raise ValueError(f"f must be ({mtot},) or (B, {mtot}), "
                         f"got {tuple(f.shape)}")
    single = f.ndim == 1
    B = 1 if single else f.shape[0]
    _check_batch(B, mtot, 1)
    if x.device.type == "cpu":
        return nufft2_1d_ref(x, f, h, mtot=mtot, fft_order=fft_order)
    geo = (type2_1d_geometry(x.shape[0], mtot, B)
           if x.dtype == torch.float32 else ("cuda",))
    out = _nufft2_1d_on(x, f.reshape(B, mtot), h, mtot, fft_order, geo)
    return out[0] if single else out


def type2_1d_geometry(n: int, mtot: int, B: int = 1) -> tuple:
    """The float32 d=1 type-2's path and launch geometry: ``("tc", points,
    K, cols, stage)``, the tensor-core kernel's arguments before its
    scratch, or ``("cuda",)``, the CUDA-core kernel, whose block is fixed
    in its source.

    The tensor-core kernel splits each mode as k = K q + r
    (:func:`type1_1d_split`, K = :data:`TYPE2_1D_K`): a GEMM over the q
    (padded to whole k-steps of 8) in blocks of ``points`` points, walking
    column tiles of ``cols`` columns (vector, r): :data:`TYPE2_1D_NARROW_COLS`
    for one vector, whose K columns are one such tile, else
    :data:`TYPE2_2D_COLS`; ``stage`` modes q a stage.  The dispatch is a
    table from the times of both kernels on the same inputs: the tensor
    cores from :data:`TYPE2_1D_TC_MIN_MTOT` modes and
    :data:`TYPE2_1D_TC_MIN_WORK` n mtot on (2^20 for one vector, 2^23 for a
    batch), where the K + Q phases a point are far fewer than mtot and the
    blocks enough to pay for the split's second launch."""
    if (mtot < TYPE2_1D_TC_MIN_MTOT
            or n * mtot < TYPE2_1D_TC_MIN_WORK[B > 1]):
        return ("cuda",)
    return type2_1d_tc_geometry(B)


def type2_1d_tc_geometry(B: int) -> tuple:
    """The tensor-core d=1 type-2's geometry for a batch of B vectors
    (:func:`type2_1d_geometry`'s ``("tc", ...)``)."""
    cols = TYPE2_1D_NARROW_COLS if B == 1 else TYPE2_2D_COLS
    return ("tc", TYPE2_2D_POINTS, TYPE2_1D_K, cols, TYPE2_2D_STAGE)


def type2_1d_scratch_floats(mtot: int, B: int, geometry: tuple) -> int:
    """Floats of the tensor-core d=1 type-2's split f: big and small, real
    and imaginary parts of each (q, column) cell, the q padded to whole
    k-steps of 8, the B K columns to a whole number of tiles."""
    _, _, K, cols, _ = geometry
    kq = _round_up(type1_1d_split(mtot, K)[1], TYPE2_1D_KSTEP)
    return 4 * kq * _round_up(B * K, cols)


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _nufft2_1d_on(x, f, h, m, fft_order, geo):
    """The d=1 type-2's launch on CUDA tensors, ``f`` (B, m), on the path
    ``geo`` (:func:`type2_1d_geometry`): the tensor cores (float32) or the
    CUDA cores; counted as one launch of ``nufft2_1d`` (chip_smoke.py also
    times both paths through it).  Returns (B, N)."""
    if geo[0] not in ("tc", "cuda") or len(geo) != (5 if geo[0] == "tc"
                                                    else 1):
        raise ValueError(f"no d=1 type-2 path for geometry {geo}")
    if geo[0] == "tc" and x.dtype != torch.float32:
        raise TypeError("the tensor-core d=1 type-2 takes float32")
    cdtype = _complex_of(x.dtype)
    _check_cuda_operand("f", f, x, cdtype)
    B, n = f.shape[0], x.shape[0]
    out = torch.empty((B, n), dtype=cdtype, device=x.device)
    if n == 0:
        return out
    x = x.contiguous()
    f = f.contiguous()
    h = float(torch.as_tensor(h, dtype=x.dtype))
    args = (x.data_ptr(), f.data_ptr(), h, n, m, B, int(fft_order))
    if geo[0] == "tc":
        floats = type2_1d_scratch_floats(m, B, geo)
        scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
        _launch("nufft2_1d", x, *args, *geo[1:], scratch.data_ptr(), floats,
                out.data_ptr(), mtot=m, symbol="gpq_nufft2_1d_tc_f32")
    else:
        _launch("nufft2_1d", x, *args, out.data_ptr(), mtot=m)
    return out


def nufft1_1d(x, vals, h, *, mtot: int, fft_order: bool = False):
    """Fused d=1 type-1 apply (replaces ``pallas_nufft1_1d``).

    ``x`` (N, 1) real; ``vals`` complex (N,) or (B, N), B >= 1; any odd
    mtot.  Returns complex (mtot,) or (B, mtot) from one launch of two
    kernels: point-group partials, then their sum in group order.  In
    float32 the partials come from the tensor cores on a split of the mode
    index (:func:`type1_1d_geometry`; scratch of groups * B * mtot values),
    in float64 from the CUDA cores over 2048-point chunks.  A CPU tensor
    takes the plain version."""
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
    geo = (type1_1d_geometry(n, mtot, B) if x.dtype == torch.float32
           else ("cuda", TYPE1_CHUNK))
    out = _nufft1_1d_on(x, vals.reshape(B, n), h, mtot, fft_order, geo)
    return out[0] if single else out


def type1_1d_geometry(n: int, mtot: int, B: int = 1) -> tuple:
    """The float32 d=1 type-1's path and launch geometry: ``("tc", rows,
    cols, group, stage, run, chunk)``, the tensor-core kernel's arguments
    before its scratch.

    The kernel splits each mode as k = K q + r with K = rows / group
    (:func:`type1_1d_split`): one vector takes K = 64, a batch runs in
    pairs (group 2, K = 32).  Its output tile is :data:`TYPE1_2D_ROWS` rows
    (the group's K values of r each) by ``cols`` values of q:
    :data:`TYPE1_2D_NARROW_COLS`, or :data:`TYPE1_2D_COLS` where the Q
    values of q pass twice that.  A register sum takes ``stage`` points and
    a run ``run`` (:data:`TYPE1_1D_RUN`); the groups of ``chunk`` points
    (whole runs) are as many as fill about :data:`CARD_SMS` blocks
    of column tiles x point groups x batch groups without passing it, never
    an empty one.  The scratch holds ceil(n / chunk) * B * mtot values."""
    g = 1 if B == 1 else TYPE1_2D_BATCH_GROUP
    _, q = type1_1d_split(mtot, TYPE1_2D_ROWS // g)
    cols = (TYPE1_2D_NARROW_COLS if q <= 2 * TYPE1_2D_NARROW_COLS
            else TYPE1_2D_COLS)
    tiles = -(-q // cols) * -(-B // g)
    nrun = max(1, -(-n // TYPE1_1D_RUN))
    groups = min(nrun, max(1, CARD_SMS // tiles))
    chunk = -(-nrun // groups) * TYPE1_1D_RUN
    return ("tc", TYPE1_2D_ROWS, cols, g, TYPE1_2D_STAGE, TYPE1_1D_RUN,
            chunk)


def _nufft1_1d_on(x, vals, h, m, fft_order, geo):
    """The d=1 type-1's launch on CUDA tensors, ``vals`` (B, N), on the
    path ``geo``: ``("tc", ...)`` the tensor cores (float32,
    :func:`type1_1d_geometry`) or ``("cuda", chunk)`` the CUDA cores over
    chunks of ``chunk`` points; counted as one launch of ``nufft1_1d``
    (chip_smoke.py also times both paths through it).  Returns (B, m)."""
    if geo[0] not in ("tc", "cuda") or len(geo) != (7 if geo[0] == "tc"
                                                    else 2):
        raise ValueError(f"no d=1 type-1 path for geometry {geo}")
    if geo[0] == "tc" and x.dtype != torch.float32:
        raise TypeError("the tensor-core d=1 type-1 takes float32")
    cdtype = _complex_of(x.dtype)
    _check_cuda_operand("vals", vals, x, cdtype)
    B, n = vals.shape
    if n == 0:
        return torch.zeros((B, m), dtype=cdtype, device=x.device)
    x = x.contiguous()
    vals = vals.contiguous()
    h = float(torch.as_tensor(h, dtype=x.dtype))
    partial = torch.empty((-(-n // geo[-1]), B, m), dtype=cdtype,
                          device=x.device)
    out = torch.empty((B, m), dtype=cdtype, device=x.device)
    _launch("nufft1_1d", x, x.data_ptr(), vals.data_ptr(), h, n, m, B,
            int(fft_order), *geo[1:], partial.data_ptr(), out.data_ptr(),
            mtot=m, symbol="gpq_nufft1_1d_tc_f32" if geo[0] == "tc" else None)
    return out


def nufft2_2d(x, f, h, *, mtot: int, fft_order: bool = False):
    """Fused type-2 apply for d=2 (replaces ``pallas_nufft2_2d`` and
    ``_pallas_nufft2_2d_tiled``).

    ``x`` (N, 2) real, ``f`` complex (mtot, mtot) or (mtot^2,), ``h`` the
    grid spacing; returns complex (N,).  A CPU tensor takes the plain
    version; a CUDA tensor launches the path
    :func:`type2_2d_single_geometry` picks from the shape: the tensor
    cores (float32; a scratch of :func:`type2_2d_scratch_floats` floats at
    B 1), the mode split (a scratch of ceil(mtot / 16) * N values), or
    one thread a point on the CUDA cores.  Each counts one launch."""
    _check(x, mtot)
    if x.device.type == "cpu":
        return nufft2_2d_ref(x, f, h, mtot=mtot, fft_order=fft_order)
    geo = type2_2d_single_geometry(x.shape[0], mtot, x.dtype)
    return _nufft2_2d_on(x, f, h, mtot, fft_order, geo)


def type2_2d_single_geometry(n: int, mtot: int, dtype) -> tuple:
    """The single d=2 type-2's path and launch geometry for ``n`` points in
    ``dtype``: ``("tc", points, cols, stage)``, the batched type-2's
    tensor-core kernel at B 1 (:func:`type2_2d_geometry`'s geometry);
    ``("split", rows, threads)``, the mode split, slabs of ``rows`` modes j
    by blocks of ``threads`` points; or ``("cuda",)``, one thread a point,
    the block fixed in its source.

    A table from the times of every path on the same inputs (chip_smoke.py
    phase 3 at the driven shapes, scripts/time_type2_single.py between
    them).  Grids below :data:`TYPE2_2D_SPLIT_MIN_MTOT`, the headline's
    mtot 29 among them, stay on the CUDA cores: one or two slabs do not pay
    for the split's second pass.  In float32 the tensor cores take
    :data:`TYPE2_2D_SINGLE_TC_MIN_POINTS` points and more from
    :data:`TYPE2_2D_TC_MIN_MTOT` on.  Otherwise the split takes calls below
    :data:`TYPE2_2D_SPLIT_MAX_POINTS` points, where one thread a point
    leaves the card short of warps to hide its chains of dependent
    multiply-adds (float64 feels them longer); past that the CUDA cores
    keep them (the split makes a point's e2 phases once a slab, the
    one-thread-a-point kernel its e1 phases once a tile of 32 modes k, and
    the card is full either way), and the split's scratch of ceil(mtot / 16) * N values
    stays small."""
    if mtot < TYPE2_2D_SPLIT_MIN_MTOT:
        return ("cuda",)
    if (dtype == torch.float32 and mtot >= TYPE2_2D_TC_MIN_MTOT
            and n >= TYPE2_2D_SINGLE_TC_MIN_POINTS):
        return type2_2d_geometry(mtot)
    if n < TYPE2_2D_SPLIT_MAX_POINTS[dtype]:
        return ("split", TYPE2_2D_SPLIT_ROWS, TYPE2_2D_SPLIT_THREADS)
    return ("cuda",)


def _nufft2_2d_on(x, f, h, m, fft_order, geo):
    """The single type-2's launch on CUDA tensors on the path and geometry
    ``geo`` (:func:`type2_2d_single_geometry`), counted as one launch of
    ``nufft2_2d``; chip_smoke.py also times every path through it."""
    cdtype = _complex_of(x.dtype)
    if f.numel() != m * m:
        raise ValueError(f"f has {f.numel()} entries, expected {m}^2")
    _check_cuda_operand("f", f, x, cdtype)
    n = x.shape[0]
    out = torch.empty(n, dtype=cdtype, device=x.device)
    if n == 0:
        return out
    x = x.contiguous()
    f = f.contiguous()
    h = float(torch.as_tensor(h, dtype=x.dtype))
    args, fo = (x.data_ptr(), f.data_ptr(), h, n, m), int(fft_order)
    if geo[0] == "tc":
        # the batched kernel at B 1
        if x.dtype != torch.float32:
            raise TypeError("the tensor-core single type-2 takes float32")
        floats = type2_2d_scratch_floats(m, 1, geo)
        scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
        _launch("nufft2_2d", x, *args, 1, fo, *geo[1:], scratch.data_ptr(),
                floats, out.data_ptr(), mtot=m,
                symbol="gpq_nufft2_2d_batched_tc_f32")
    elif geo[0] == "split":
        partial = torch.empty((-(-m // geo[1]), n), dtype=cdtype,
                              device=x.device)
        prec = "f32" if x.dtype == torch.float32 else "f64"
        _launch("nufft2_2d", x, *args, fo, *geo[1:], partial.data_ptr(),
                out.data_ptr(), mtot=m, symbol=f"gpq_nufft2_2d_split_{prec}")
    elif geo == ("cuda",):
        _launch("nufft2_2d", x, *args, fo, out.data_ptr(), mtot=m)
    else:
        raise ValueError(f"no single type-2 path for geometry {geo}")
    return out


def nufft1_2d(x, vals, h, *, mtot: int, fft_order: bool = False):
    """Fused type-1 apply for d=2 (replaces ``pallas_nufft1_2d``).

    ``x`` (N, 2) real, ``vals`` complex (N,); returns complex
    (mtot, mtot).  A CPU tensor takes the plain version; a CUDA tensor
    launches the two-stage kernel (float32: point-group partials on the
    tensor cores, scratch of ceil(N / :func:`type1_2d_chunk`) * mtot^2
    values; float64: 2048-point chunk partials)."""
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
    geo = _type1_2d_launch_geometry(x, n, mtot, 1, False)
    partial = torch.empty((-(-n // geo[-1]), mtot, mtot), dtype=cdtype,
                          device=x.device)
    out = torch.empty((mtot, mtot), dtype=cdtype, device=x.device)
    _launch("nufft1_2d", x, x.data_ptr(), vals.data_ptr(), h, n, mtot,
            int(fft_order), *geo, partial.data_ptr(), out.data_ptr(),
            mtot=mtot)
    return out


def type1_2d_geometry(n: int, mtot: int, B: int = 1,
                      batched: bool = False) -> tuple[int, ...]:
    """The float32 d=2 type-1's launch geometry: ``(rows, cols, group,
    stage, run, chunk)``, the arguments its launch takes before the scratch.

    The output tile is :data:`TYPE1_2D_ROWS` rows (``group`` vectors of
    ``rows / group`` modes j) by ``cols`` modes k: :data:`TYPE1_2D_COLS`,
    or :data:`TYPE1_2D_NARROW_COLS` where ``mtot`` is at most twice that.
    A register sum takes ``stage`` points and a run ``run``.  The kernel's
    blocks are output tiles x point groups x batch groups; the groups of
    ``chunk`` points (a multiple of ``run``) are as many as fill about
    :data:`TYPE1_2D_BLOCKS` blocks without passing it, never an empty one.
    The scratch holds ceil(n / chunk) * B * mtot^2 values."""
    g = TYPE1_2D_BATCH_GROUP if batched else 1
    cols = (TYPE1_2D_NARROW_COLS if mtot <= 2 * TYPE1_2D_NARROW_COLS
            else TYPE1_2D_COLS)
    tiles = (-(-mtot // (TYPE1_2D_ROWS // g)) * -(-mtot // cols)
             * -(-B // g))
    nrun = max(1, -(-n // TYPE1_2D_RUN))
    groups = min(nrun, max(1, TYPE1_2D_BLOCKS // tiles))
    chunk = -(-nrun // groups) * TYPE1_2D_RUN
    return TYPE1_2D_ROWS, cols, g, TYPE1_2D_STAGE, TYPE1_2D_RUN, chunk


def type1_2d_chunk(n: int, mtot: int, B: int = 1,
                   batched: bool = False) -> int:
    """Points per group of the float32 d=2 type-1 (:func:`type1_2d_geometry`)."""
    return type1_2d_geometry(n, mtot, B, batched)[-1]


def _type1_2d_launch_geometry(x, n, mtot, B, batched):
    """What the d=2 type-1 launch takes before its scratch, in x's
    precision: the float32 kernel's geometry, or the float64 kernel's
    2048-point chunk.  The last entry is the points a partial sum."""
    if x.dtype == torch.float32:
        return type1_2d_geometry(n, mtot, B, batched)
    return (TYPE1_CHUNK,)


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


def type2_2d_geometry(mtot: int) -> tuple:
    """The float32 batched d=2 type-2's kernel and launch geometry:
    ``("tc", points, cols, stage)`` for the tensor-core kernel (blocks of
    ``points`` points walking column tiles of ``cols`` columns (vector, mode
    j), ``stage`` modes k a stage), or ``("cuda",)`` for the CUDA-core
    kernel, whose block is fixed in its source.

    The dispatch is a table by mtot from chip_smoke.py phase 3's times of
    both kernels on the same inputs: the tensor cores from
    :data:`TYPE2_2D_TC_MIN_MTOT` on (the points and the batch did not change
    the faster kernel at the shapes timed).  The tensor-core kernel's
    scratch is
    :func:`type2_2d_scratch_floats`'s."""
    if mtot >= TYPE2_2D_TC_MIN_MTOT:
        return ("tc", TYPE2_2D_POINTS, TYPE2_2D_COLS, TYPE2_2D_STAGE)
    return ("cuda",)


def type2_2d_scratch_floats(mtot: int, B: int, geometry: tuple) -> int:
    """Floats of the tensor-core batched type-2's split F: big and small,
    real and imaginary parts of each (mode k, column) cell, the modes and
    each vector's columns padded to a multiple of the stage,
    the columns to a whole number of tiles."""
    _, _, cols, stage = geometry
    mq = -(-mtot // stage) * stage
    ncp = -(-B * mq // cols) * cols
    return 4 * mq * ncp


def nufft2_2d_batched(x, f, h, *, mtot: int, fft_order: bool = False):
    """Batched fused type-2 (replaces ``pallas_nufft2_2d_batched``).

    ``f`` complex (B, mtot, mtot) or (B, mtot^2), B >= 1; returns complex
    (B, N) from one launch.  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel :func:`type2_2d_geometry` dispatches it to
    in float32 (the tensor cores, with a scratch of
    :func:`type2_2d_scratch_floats` floats, or the CUDA cores), the
    CUDA-core kernel in float64."""
    _check(x, mtot)
    m = mtot
    if f.ndim not in (2, 3) or tuple(f.shape[1:]) not in ((m * m,), (m, m)):
        raise ValueError(f"f must be (B, {m}, {m}) or (B, {m * m}), "
                         f"got {tuple(f.shape)}")
    B = f.shape[0]
    _check_batch(B, m)
    if x.device.type == "cpu":
        return nufft2_2d_batched_ref(x, f, h, mtot=m, fft_order=fft_order)
    geo = (type2_2d_geometry(m)
           if x.dtype == torch.float32 else ("cuda",))
    return _nufft2_2d_batched_on(x, f, h, m, fft_order, geo)


def _nufft2_2d_batched_on(x, f, h, m, fft_order, geo):
    """The batched type-2's launch on CUDA tensors with the kernel and
    geometry ``geo`` (:func:`type2_2d_geometry`); chip_smoke.py also times
    both kernels through it."""
    cdtype = _complex_of(x.dtype)
    _check_cuda_operand("f", f, x, cdtype)
    B, n = f.shape[0], x.shape[0]
    out = torch.empty((B, n), dtype=cdtype, device=x.device)
    if n == 0:
        return out
    x = x.contiguous()
    f = f.contiguous()
    h = float(torch.as_tensor(h, dtype=x.dtype))
    if geo[0] == "tc":
        if x.dtype != torch.float32:
            raise TypeError("the tensor-core batched type-2 takes float32")
        floats = type2_2d_scratch_floats(m, B, geo)
        scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
        _launch("nufft2_2d_batched", x, x.data_ptr(), f.data_ptr(), h, n, m,
                B, int(fft_order), *geo[1:], scratch.data_ptr(), floats,
                out.data_ptr(), mtot=m,
                symbol="gpq_nufft2_2d_batched_tc_f32")
    elif geo == ("cuda",):
        _launch("nufft2_2d_batched", x, x.data_ptr(), f.data_ptr(), h, n, m,
                B, int(fft_order), out.data_ptr(), mtot=m)
    else:
        raise ValueError(f"no batched type-2 kernel for geometry {geo}")
    return out


def nufft1_2d_batched(x, vals, h, *, mtot: int, fft_order: bool = False):
    """Batched fused type-1 (replaces ``pallas_nufft1_2d_batched``).

    ``vals`` complex (B, N), B >= 1; returns complex (B, mtot, mtot) from
    one launch (two kernels: per-group partials, then the group-order sum;
    scratch of groups * B * mtot^2 values, the groups as
    :func:`nufft1_2d`'s).  A CPU tensor takes the plain version."""
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
    geo = _type1_2d_launch_geometry(x, n, mtot, B, True)
    partial = torch.empty((-(-n // geo[-1]), B, mtot, mtot), dtype=cdtype,
                          device=x.device)
    out = torch.empty((B, mtot, mtot), dtype=cdtype, device=x.device)
    _launch("nufft1_2d_batched", x, x.data_ptr(), vals.data_ptr(), h, n, mtot,
            B, int(fft_order), *geo, partial.data_ptr(), out.data_ptr(),
            mtot=mtot)
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


def _type2_3d_batch(f, m: int) -> tuple[bool, int]:
    """(single, B) of the d=3 type-2's coefficients ``f``: (m,)*3 or (m^3,)
    for one vector, with a leading batch for B >= 1."""
    M = m ** 3
    if tuple(f.shape) in ((M,), (m, m, m)):
        return True, 1
    if f.ndim in (2, 4) and tuple(f.shape[1:]) in ((M,), (m, m, m)):
        return False, f.shape[0]
    raise ValueError(f"f must be ({m}, {m}, {m}) or ({M},), with an "
                     f"optional leading batch, got {tuple(f.shape)}")


def nufft2_3d(x, f, h, *, mtot: int, fft_order: bool = False):
    """Fused d=3 type-2 apply (replaces ``pallas_nufft2_3d`` and
    ``_pallas_nufft2_3d_tiled``).

    ``x`` (N, 3) real; ``f`` complex (mtot,)*3 or (mtot^3,) for one vector,
    (B, mtot, mtot, mtot) or (B, mtot^3) for a batch of B >= 1; odd
    mtot <= 255.  Returns complex (N,) or (B, N) from one launch.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel
    :func:`type2_3d_geometry` picks in float32 (the tensor cores, with a
    scratch of :func:`type2_3d_scratch_floats` floats, or the CUDA cores),
    the CUDA-core kernel in float64."""
    _check(x, mtot, 3)
    m = mtot
    single, B = _type2_3d_batch(f, m)
    _check_batch(B, m, 3)
    if x.device.type == "cpu":
        return nufft2_3d_ref(x, f, h, mtot=m, fft_order=fft_order)
    geo = (type2_3d_geometry(x.shape[0], m, B)
           if x.dtype == torch.float32 else ("cuda",))
    out = _nufft2_3d_on(x, f.reshape(B, m ** 3), h, m, fft_order, geo)
    return out[0] if single else out


def type2_3d_split(mtot: int) -> tuple[int, int]:
    """The float32 d=3 type-2's reduction on the tensor cores
    (csrc/nufft_3d.cu ``Type2Grid3D``): ``(J3, stages)``, the modes j3
    padded to J3, a multiple of the stage's 32 modes, and the stages of 32
    modes k = (jb mtot + j2) 32 + j3 % 32 (jb = j3 / 32), mtot J3 / 32 of
    them; a run of mtot stages holds one block of 32 modes j3."""
    J3 = _round_up(mtot, TYPE2_2D_STAGE)
    return J3, mtot * J3 // TYPE2_2D_STAGE


def type2_3d_geometry(n: int, mtot: int, B: int = 1) -> tuple:
    """The float32 d=3 type-2's path and launch geometry: ``("tc", points,
    cols, stage, splits)``, the tensor-core kernel's arguments before its
    scratch (:func:`type2_3d_tc_geometry`), or ``("cuda",)``, the CUDA-core
    kernel, whose block is fixed in its source.

    A table from the times of both kernels on the same inputs
    (chip_smoke.py phase 3 at the driven shapes, scripts/time_type2_3d.py's
    sweep of mtot 21-71): the CUDA cores where the tensor cores pad j1 and
    j3 by more than :data:`TYPE2_3D_MAX_PADDING` together ((mtot rounded
    up to 32 / mtot)^2: mtot up to 23, 33-47 and 65-71) and the call has
    :data:`TYPE2_3D_FEW_POINTS` point-vectors n B or more (hard3d's
    probe batches, 2e4 x B 10 at mtot 21); the tensor cores elsewhere,
    those few-point calls included (their splits fill the card).  The
    sweep found the rule up to 6% slower than the tensor cores at mtot
    41-47, and at 65-71 with 2e4 points x B 10 (the constant's comment
    says why); past 71 it is timed only at chip_smoke.py's 101 and 255."""
    padding = (_round_up(mtot, TYPE2_2D_STAGE) / mtot) ** 2
    if padding > TYPE2_3D_MAX_PADDING and n * B >= TYPE2_3D_FEW_POINTS:
        return ("cuda",)
    return type2_3d_tc_geometry(n, mtot, B)


def type2_3d_tc_geometry(n: int, mtot: int, B: int = 1) -> tuple:
    """The tensor-core d=3 type-2's geometry (:func:`type2_3d_geometry`'s
    ``("tc", points, cols, stage, splits)``): blocks of
    :data:`TYPE2_2D_POINTS` points, stages of :data:`TYPE2_2D_STAGE` modes
    k; column tiles of ``cols`` columns (vector, j1), the width of
    :data:`TYPE2_3D_WIDTHS` that walks the fewest columns (each vector's j1
    padded to a multiple of 32), the widest of a tie (it makes eA for fewer
    tiles): one vector at mtot 31 takes 32, B 10 at 31 takes 64;
    ``splits`` runs of whole stages, the number up to
    :data:`TYPE2_3D_MAX_SPLITS` that costs least, a split's cost its waves
    of blocks on :data:`CARD_SMS` SMs times its stages and
    :data:`TYPE2_3D_SPLIT_OVERHEAD` (the fewest splits of a tie; one where
    the blocks fill the card), made canonical: none empty."""
    mq = _round_up(mtot, TYPE2_2D_STAGE)
    cols = min(TYPE2_3D_WIDTHS[::-1], key=lambda w: _round_up(B * mq, w))
    nst = type2_3d_split(mtot)[1]
    blocks = -(-n // TYPE2_2D_POINTS)

    def cost(s):
        waves = -(-blocks * s // CARD_SMS)
        return waves * (-(-nst // s) + TYPE2_3D_SPLIT_OVERHEAD)
    splits = min(range(1, min(TYPE2_3D_MAX_SPLITS, nst) + 1), key=cost)
    per = -(-nst // splits)
    return ("tc", TYPE2_2D_POINTS, cols, TYPE2_2D_STAGE, -(-nst // per))


def type2_3d_scratch_floats(n: int, mtot: int, B: int,
                            geometry: tuple) -> int:
    """Floats of the tensor-core d=3 type-2's scratch: the split f (big
    and small, real and imaginary parts of each (mode k, column) cell, mtot
    J3 modes k, the B vectors' columns, each vector's j1 padded to a
    multiple of 32, padded to whole tiles), then, for two splits or more,
    their partial outputs (splits x B x n complex values)."""
    _, _, cols, _, splits = geometry
    kq = type2_3d_split(mtot)[1] * TYPE2_2D_STAGE
    ncp = _round_up(B * _round_up(mtot, TYPE2_2D_STAGE), cols)
    return 4 * kq * ncp + (2 * splits * B * n if splits > 1 else 0)


def _nufft2_3d_on(x, f, h, m, fft_order, geo):
    """The d=3 type-2's launch on CUDA tensors, ``f`` (B, m^3), on the path
    ``geo`` (:func:`type2_3d_geometry`): the tensor cores (float32) or the
    CUDA cores; counted as one launch of ``nufft2_3d`` (a split's second
    pass inside it; chip_smoke.py also times both paths through it).
    Returns (B, N)."""
    if geo[0] not in ("tc", "cuda") or len(geo) != (5 if geo[0] == "tc"
                                                    else 1):
        raise ValueError(f"no d=3 type-2 path for geometry {geo}")
    if geo[0] == "tc" and x.dtype != torch.float32:
        raise TypeError("the tensor-core d=3 type-2 takes float32")
    cdtype = _complex_of(x.dtype)
    _check_cuda_operand("f", f, x, cdtype)
    B, n = f.shape[0], x.shape[0]
    out = torch.empty((B, n), dtype=cdtype, device=x.device)
    if n == 0:
        return out
    x = x.contiguous()
    f = f.contiguous()
    h = float(torch.as_tensor(h, dtype=x.dtype))
    args = (x.data_ptr(), f.data_ptr(), h, n, m, B, int(fft_order))
    if geo[0] == "tc":
        floats = type2_3d_scratch_floats(n, m, B, geo)
        scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
        _launch("nufft2_3d", x, *args, *geo[1:], scratch.data_ptr(), floats,
                out.data_ptr(), mtot=m, symbol="gpq_nufft2_3d_tc_f32")
    else:
        _launch("nufft2_3d", x, *args, out.data_ptr(), mtot=m)
    return out


def nufft1_3d(x, vals, h, *, mtot: int, fft_order: bool = False):
    """Fused d=3 type-1 apply (replaces ``pallas_nufft1_3d`` and
    ``_pallas_nufft1_3d_tiled``).

    ``x`` (N, 3) real; ``vals`` complex (N,) or (B, N), B >= 1; odd
    mtot <= 255.  Returns complex (mtot,)*3 or (B,) + (mtot,)*3 from one
    launch (two kernels: grouped partial sums, then the group-order sum).
    In float32 the partials come from the path :func:`type1_3d_geometry`
    picks: the tensor cores (groups of its ``chunk`` points) or the CUDA
    cores (:func:`type1_3d_groups`), in float64 from the CUDA cores; the
    scratch holds groups * B * mtot^3 values.  A CPU tensor takes the plain
    version."""
    _check(x, mtot, 3)
    n = x.shape[0]
    if vals.ndim not in (1, 2) or vals.shape[-1] != n:
        raise ValueError(f"vals must be ({n},) or (B, {n}), "
                         f"got {tuple(vals.shape)}")
    single = vals.ndim == 1
    B = 1 if single else vals.shape[0]
    geo = (type1_3d_geometry(n, mtot, B) if x.dtype == torch.float32
           else ("cuda",))
    _check_batch(B, mtot, 3, _type1_3d_groups_of(n, mtot, B, geo))
    if x.device.type == "cpu":
        return nufft1_3d_ref(x, vals, h, mtot=mtot, fft_order=fft_order)
    out = _nufft1_3d_on(x, vals.reshape(B, n), h, mtot, fft_order, geo)
    return out[0] if single else out


def type1_3d_geometry(n: int, mtot: int, B: int = 1) -> tuple:
    """The float32 d=3 type-1's path and launch geometry: ``("tc", rows,
    cols, group, stage, run, chunk)``, the tensor-core kernel's arguments
    before its scratch (:func:`type1_3d_tc_geometry`), or ``("cuda",)``,
    the CUDA-core kernel (:func:`type1_3d_groups`).

    A table from the times of both kernels on the same inputs
    (chip_smoke.py phase 3 at the driven shapes, scripts/time_type1_3d.py):
    the tensor cores up to :data:`TYPE1_3D_TC_MAX_MTOT` modes, where the
    column tiles are wide (at mtot 101 and 255 the narrow ones took 1.7x
    the CUDA cores' time)."""
    if mtot > TYPE1_3D_TC_MAX_MTOT:
        return ("cuda",)
    return type1_3d_tc_geometry(n, mtot, B)


def type1_3d_split(mtot: int, rows: int) -> tuple[int, int, int]:
    """The float32 d=3 type-1's split of the first axis's mode, k1 = S q +
    r with r in 0..S-1, for a tile of ``rows`` rows a vector
    (csrc/nufft_3d.cu ``Type1Grid3D``): ``(S, qmin, Q)``, S = rows // mtot
    where that is two or more, else 1; q runs over qmin .. qmin + Q - 1
    (:func:`type1_1d_split` at K = S).  The kernel's rows are (r, j3), S
    mtot of them, and its columns (q, j2), Q mtot."""
    S = rows // mtot if rows >= 2 * mtot else 1
    return (S,) + type1_1d_split(mtot, S)


def type1_3d_tc_geometry(n: int, mtot: int, B: int = 1) -> tuple:
    """The tensor-core d=3 type-1's geometry (:func:`type1_3d_geometry`'s
    ``("tc", ...)``): output tiles of :data:`TYPE1_2D_ROWS` rows (one
    vector's 64, or two vectors' 32: a batch runs in pairs) by
    :data:`TYPE1_2D_COLS` columns (q, j2) up to mtot 64, where the stage's
    phase table holds at most 67 entries a point, and where the columns
    pass twice :data:`TYPE1_2D_NARROW_COLS` and the wide tiles give
    :data:`CARD_SMS` blocks (one wave) or the narrow ones no more; else by
    :data:`TYPE1_2D_NARROW_COLS`.  The d=2
    type-1's register sums, runs and point groups (:func:`type1_2d_geometry`:
    groups for about :data:`TYPE1_2D_BLOCKS` blocks, one where the tiles
    alone pass that); the scratch holds groups * B * mtot^3 values."""
    g = 1 if B == 1 else TYPE1_2D_BATCH_GROUP
    tj = TYPE1_2D_ROWS // g
    S, _, Q = type1_3d_split(mtot, tj)
    ncol = Q * mtot
    nrun = max(1, -(-n // TYPE1_2D_RUN))

    def tiles_groups(cols):
        tiles = -(-S * mtot // tj) * -(-ncol // cols) * -(-B // g)
        return tiles, min(nrun, max(1, TYPE1_2D_BLOCKS // tiles))
    cols = (TYPE1_2D_COLS if mtot <= 64 and ncol > 2 * TYPE1_2D_NARROW_COLS
            else TYPE1_2D_NARROW_COLS)
    if cols == TYPE1_2D_COLS:
        # few points: the narrow tile where the wide one leaves the card
        # short of a wave of blocks and the narrow one gives more
        wide = math.prod(tiles_groups(cols))
        narrow = math.prod(tiles_groups(TYPE1_2D_NARROW_COLS))
        if wide < CARD_SMS and narrow > wide:
            cols = TYPE1_2D_NARROW_COLS
    groups = tiles_groups(cols)[1]
    chunk = -(-nrun // groups) * TYPE1_2D_RUN
    return ("tc", TYPE1_2D_ROWS, cols, g, TYPE1_2D_STAGE, TYPE1_2D_RUN,
            chunk)


def _type1_3d_groups_of(n, mtot, B, geo):
    """The point groups (partial sums) of the d=3 type-1 on path ``geo``."""
    if geo[0] == "tc":
        return max(1, -(-n // geo[-1]))
    return type1_3d_groups(n, mtot, B)[0]


def _nufft1_3d_on(x, vals, h, m, fft_order, geo):
    """The d=3 type-1's launch on CUDA tensors, ``vals`` (B, N), on the
    path ``geo``: ``("tc", ...)`` the tensor cores (float32,
    :func:`type1_3d_geometry`) or ``("cuda",)`` the CUDA cores over groups
    of 2048-point chunks (:func:`type1_3d_groups`); counted as one launch
    of ``nufft1_3d`` (chip_smoke.py also times both paths through it).
    Returns (B, m, m, m)."""
    if geo[0] not in ("tc", "cuda") or len(geo) != (7 if geo[0] == "tc"
                                                    else 1):
        raise ValueError(f"no d=3 type-1 path for geometry {geo}")
    if geo[0] == "tc" and x.dtype != torch.float32:
        raise TypeError("the tensor-core d=3 type-1 takes float32")
    cdtype = _complex_of(x.dtype)
    _check_cuda_operand("vals", vals, x, cdtype)
    B, n = vals.shape
    shape = (B, m, m, m)
    if n == 0:
        return torch.zeros(shape, dtype=cdtype, device=x.device)
    x = x.contiguous()
    vals = vals.contiguous()
    h = float(torch.as_tensor(h, dtype=x.dtype))
    groups = _type1_3d_groups_of(n, m, B, geo)
    partial = torch.empty((groups,) + shape, dtype=cdtype, device=x.device)
    out = torch.empty(shape, dtype=cdtype, device=x.device)
    args = (x.data_ptr(), vals.data_ptr(), h, n, m, B, int(fft_order))
    if geo[0] == "tc":
        _launch("nufft1_3d", x, *args, *geo[1:], partial.data_ptr(),
                out.data_ptr(), mtot=m, symbol="gpq_nufft1_3d_tc_f32")
    else:
        _launch("nufft1_3d", x, *args, TYPE1_CHUNK, groups,
                partial.data_ptr(), out.data_ptr(), mtot=m)
    return out


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
        with profiling.stage("nufft_type1"):
            return self._type1(vals)

    def type2(self, fk):
        with profiling.stage("nufft_type2"):
            return self._type2(fk)

    def _type1(self, vals):
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

    def _type2(self, fk):
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
