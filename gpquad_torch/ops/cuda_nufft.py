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
  the d=2 type-2's (:func:`nufft2_1d_3xtf32_ref`).  In float64 both run on
  the FP64 tensor cores on the same kind of split, the d=2/d=3 float64
  kernels on grid policies of their own (:func:`type1_1d_geometry` and
  :func:`type2_1d_geometry` at float64; :func:`nufft1_1d_f64_tc_ref` and
  :func:`nufft2_1d_f64_tc_ref` their twins), but for the samplers' few
  points at small mtot, which the geometries keep on the CUDA cores.
- :func:`nufft2_2d` replaces ``pallas_nufft2_2d`` (pallas_nufft.py:113) and
  its mode-tiled twin ``_pallas_nufft2_2d_tiled`` (:369), any odd ``mtot``,
  on one of three paths that :func:`type2_2d_single_geometry` picks from
  the shape: the batched type-2's tensor-core kernel at B 1 (in float32
  with many points, :func:`nufft2_2d_batched_3xtf32_ref` its twin; in
  float64 on the FP64 tensor cores for most shapes,
  :func:`nufft2_2d_f64_tc_ref`); with few points on a wide grid a split
  of the first mode axis into slabs, a grid axis, whose partials a second
  pass adds in slab order (:func:`nufft2_2d_split_ref`); else one thread a
  point on the CUDA cores, tiling the modes inside.
- :func:`nufft1_2d` replaces ``pallas_nufft1_2d`` (:195) and
  ``_pallas_nufft1_2d_tiled`` (:442): in float32 a GEMM over the points on
  the tensor cores with an explicit 3xTF32 split, one partial sum per point
  group (:func:`type1_2d_chunk`), then a second pass adds the partials in
  group order; :func:`nufft1_2d_3xtf32_ref` is its plain twin.  In float64
  the same GEMM on the FP64 tensor cores (DMMA, no split of the operands;
  the mode index split so that a point makes few phases a tile;
  :func:`type1_2d_geometry` at float64, and :func:`nufft1_2d_f64_tc_ref`
  its plain twin).  :func:`nufft1_2d_batched` takes the same kernels.
- :func:`nufft2_2d_batched` replaces ``pallas_nufft2_2d_batched`` (:838)
  and :func:`nufft1_2d_batched` replaces ``pallas_nufft1_2d_batched``
  (:914): B vectors against the same points in one launch, the phases made
  once per group of batch elements (the gradient's probe batches).  In
  float32 the batched type-2 runs, where :func:`type2_2d_geometry` sends
  it, as a GEMM over the modes on the tensor cores with an explicit 3xTF32
  split and the sum over the first mode axis in its epilogue
  (:func:`nufft2_2d_batched_3xtf32_ref` is its plain twin), elsewhere on
  the CUDA cores; in float64 always as the same GEMM and epilogue on the
  FP64 tensor cores (DMMA, no split of the operands, the mode index split
  so that a point makes few phases; :func:`type2_2d_geometry` at float64,
  :func:`nufft2_2d_f64_tc_ref` its plain twin).
- :func:`nufft2_3d` replaces ``pallas_nufft2_3d`` (:662) and its
  first-dimension slab-tiled twin ``_pallas_nufft2_3d_tiled`` (:1034), and
  :func:`nufft1_3d` replaces ``pallas_nufft1_3d`` (:750) and
  ``_pallas_nufft1_3d_tiled`` (:1118): one vector or a batch in one launch,
  any odd ``mtot`` up to 255 (the TPU's ``_D3_TILED_MAX``).  In float32
  the type-1 runs up to mtot 64 on the d=2 type-1's tensor-core kernel
  with rows (r, j3) and columns (q, j2) of a split of the first axis's
  mode, k1 = S q + r (:func:`nufft1_3d_3xtf32_ref` is its plain twin), and
  past it on the wide grids' tensor-core kernel, rows the pairs (j1, j2)
  laid end to end and columns j3 (:func:`nufft1_3d_wide_ref`), as
  :func:`type1_3d_geometry` picks; the type-2, where
  :func:`type2_3d_geometry` sends it, on the d=2 type-2's tensor-core
  kernel as a GEMM over the pairs (j2, j3) with columns (vector, j1) and
  the sum over j1 in its epilogue (:func:`nufft2_3d_3xtf32_ref`).  In
  float64 the type-1 runs on the FP64 tensor cores, the d=2 float64
  type-1's kernel on the same rows and columns
  (:func:`type1_3d_geometry` at float64, :func:`nufft1_3d_f64_tc_ref` its
  plain twin), and the type-2 on the d=2 float64 type-2's kernel as the
  same GEMM over the pairs (j2, j3), the modes j3 padded to whole k-steps
  of 8 (:func:`type2_3d_geometry` at float64,
  :func:`nufft2_3d_f64_tc_ref` its plain twin).

All are bound by operations on an H100 (complex multiply-adds, ~8 mtot^d
flops per point and vector, and at d=1 the phases themselves): fp32 outside
the tensor cores, but for the float32 paths on the tensor cores (the type-1
and the type-2 at d=1-3), which take three TF32
products per real product, and for the float64 pairs at d=1-3 on
the FP64 tensor cores; the sources say how the designs stage the work.
The wrappers take a tensor on the CPU to the plain
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
import functools
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..utils import profiling
from .nufft import (CUDA_D3_MAX_MTOT, _k_values, _phase_matrix,
                    make_phase_nufft, span_attrs)

__all__ = ["nufft1_1d", "nufft2_1d", "nufft1_1d_ref", "nufft2_1d_ref",
           "nufft1_2d", "nufft2_2d", "nufft1_2d_ref", "nufft2_2d_ref",
           "nufft1_2d_batched", "nufft2_2d_batched", "nufft1_2d_batched_ref",
           "nufft2_2d_batched_ref", "nufft1_2d_3xtf32_ref",
           "nufft1_2d_f64_tc_ref",
           "nufft2_2d_batched_3xtf32_ref", "nufft2_2d_split_ref",
           "nufft1_1d_3xtf32_ref", "type1_1d_geometry", "type1_1d_split",
           "nufft2_1d_3xtf32_ref", "type2_1d_geometry",
           "type2_1d_tc_geometry", "type2_1d_scratch_floats",
           "nufft1_1d_f64_tc_ref", "nufft2_1d_f64_tc_ref",
           "type1_1d_f64_split", "type2_1d_f64_scratch_doubles",
           "type1_1d_f64_tc_geometry", "type2_1d_f64_tc_geometry",
           "nufft1_3d",
           "nufft2_3d", "nufft1_3d_ref", "nufft2_3d_ref", "type1_2d_chunk",
           "type1_2d_geometry", "type2_2d_geometry",
           "type2_2d_single_geometry",
           "type2_2d_scratch_floats", "type2_2d_f64_scratch_doubles",
           "nufft2_2d_f64_tc_ref",
           "type1_3d_geometry", "type1_3d_tc_geometry", "type1_3d_split",
           "type1_3d_f64_split", "nufft1_3d_f64_tc_ref",
           "nufft1_3d_3xtf32_ref", "nufft2_3d_3xtf32_ref",
           "nufft1_3d_wide_ref", "type1_3d_wide_geometry",
           "type2_3d_geometry", "type2_3d_tc_geometry",
           "type2_3d_scratch_floats", "type2_3d_split",
           "type2_3d_f64_split", "type2_3d_f64_scratch_doubles",
           "nufft2_3d_f64_tc_ref",
           "CudaNUFFT", "LAUNCHES",
           "LAUNCH_WIDTHS", "LAUNCH_PRECISIONS", "LAUNCH_PATHS", "build",
           "library_path"]

# Launches of each kernel since the last reset (a launch is one wrapper call
# on a CUDA tensor; the two stages of type-1 count once).
LAUNCHES = {"nufft1_1d": 0, "nufft2_1d": 0, "nufft1_2d": 0, "nufft2_2d": 0,
            "nufft1_2d_batched": 0, "nufft2_2d_batched": 0, "nufft1_3d": 0,
            "nufft2_3d": 0}
# The same launches by (kernel, mtot), and by (kernel, "f32" | "f64", mtot),
# counted at the same place; the d=3 type-1's also by (kernel, path, mtot),
# its path the kind of geometry it ran: "tc" (float32, mtot up to 64),
# "wide" (float32, the wide grids), "fp64".
LAUNCH_WIDTHS: dict[tuple[str, int], int] = {}
LAUNCH_PRECISIONS: dict[tuple[str, str, int], int] = {}
LAUNCH_PATHS: dict[tuple[str, str, int], int] = {}

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
# every file the library depends on (hashed); the .cu files are compiled
_SOURCES = ("nufft_common.cuh", "tc_type1.cuh", "tc_type1_f64.cuh",
            "tc_type1_wide.cuh",
            "tc_type2.cuh", "tc_type2_f64.cuh", "nufft_1d.cu", "nufft_2d.cu",
            "nufft_3d.cu", "interp_2d.cu")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gpquad_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
TYPE1_CHUNK = 2048
# the card's streaming multiprocessors (an H100 SXM's 132), on which the
# tensor-core geometries below count their waves of blocks
CARD_SMS = 132
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
# The float64 d=2 type-1 on the FP64 tensor cores (csrc/tc_type1_f64.cuh
# type1_f64_kernel), its geometry owned here (type1_2d_geometry at float64)
# and checked by its launch: output tiles of TYPE1_2D_ROWS rows (one
# vector's 64 modes j, or a batch group of two vectors' 32) by 64 modes k,
# or by 32
# where 64 would pad the columns this many times more (mtot up to 32 and
# 65-96: at 2e4 x 93 the narrow tiles took 0.74x the time of the wide, at
# 1e5 x 213, padded 1.14x more, 1.25x; scripts/time_type1_2d_f64.py on
# NVIDIA H100 80GB HBM3, 700 W); runs of TYPE1_2D_F64_RUN points in the
# DMMA accumulators; point groups for about TYPE1_2D_BLOCKS blocks.  The
# mode index is split as (K s - half) + r, r < TYPE1_2D_F64_K (the
# source's T64_K).
TYPE1_2D_F64_COLS, TYPE1_2D_F64_NARROW_COLS = 64, 32
TYPE1_2D_F64_NARROW_PADDING = 1.25
TYPE1_2D_F64_RUN = 512
TYPE1_2D_F64_K = 8
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
# the times of both tensor-core kernels on the same inputs: Type1Grid3D's
# up to this mtot (the wide column tiles' table fits to 64), the wide
# grids' kernel past it
TYPE1_3D_TC_MAX_MTOT = 64
# Past it the float32 d=3 type-1 takes csrc/tc_type1_wide.cuh's kernel
# (type1_3d_wide_geometry): rows the pairs (j1, j2) of a vector laid end to
# end, in tiles of TYPE1_2D_ROWS, columns the modes j3 in tiles of this
# many (the source's TW_COLS, its one instance: where 32 columns pad j3
# less, at mtot 65-95 and 129-191, they took 1.31-1.60x its time, and
# 1.05-2.08x at every width timed, on NVIDIA H100 80GB HBM3, 700 W,
# scripts/time_type1_3d_wide.py --shapes sweep 6b phase3); the d=2
# type-1's register sums and runs; point groups of whole runs, their
# partials at most TYPE1_3D_WIDE_SCRATCH bytes (one group writes the output
# itself).  The kernel takes mtot from TYPE1_3D_WIDE_MIN_MTOT (a row tile
# then reaches at most three values of j1: the source's TW_MIN_MTOT and
# TW_N1).
TYPE1_3D_WIDE_COLS = 128
TYPE1_3D_WIDE_SCRATCH = 64e6
TYPE1_3D_WIDE_MIN_MTOT = 32
# The float64 d=3 type-1 takes the float64 d=2 type-1's kernel
# (csrc/tc_type1_f64.cuh type1_f64_kernel) on nufft_3d.cu's Type1F64Grid3D
# (type1_3d_geometry at float64): rows (r, j3) and columns (q, j2) of the
# split k1 = S q + r, each index's inner mode stride mtot (at least
# TYPE1_2D_F64_K), S in 1 .. this many, the one whose tiles pad least; the
# d=2 float64 type-1's tile rows, batch group and run; the point groups
# whose blocks take the fewest waves on the card's CARD_SMS SMs times runs
# a block (the fewest groups of a tie), their partials at most this many
# bytes (a single group, which writes the output itself, where one group's
# partials would pass it).  At 2e4 x
# 101 one group (270 blocks, three waves, the last of 6) took 8.22 ms and
# three 6.32; at 1e5 x 31 66 groups (four waves of 3 runs) 0.918 and 33
# (two of 6) 0.901 (scripts/time_type1_3d_f64.py --groups on NVIDIA H100
# 80GB HBM3, 700 W)
TYPE1_3D_F64_MAX_SPLIT = 8
TYPE1_3D_F64_SCRATCH = 64e6
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
# The float64 d=1 pair on the FP64 tensor cores, each geometry owned here
# and checked by its launch.  The type-1 (csrc/tc_type1_f64.cuh
# type1_f64_kernel on nufft_1d.cu's Type1F64Split1D; type1_1d_geometry at
# float64): the float64 d=2 type-1's tiles, batch group and runs, and the
# float64 d=3 type-1's rule for the point groups, on the split k = S q + r,
# S the power of two up to this that pads the tiles least.  Its dispatch,
# from the times of both kernels on the same inputs (scripts/
# time_nufft_1d_f64.py at the driven shapes on NVIDIA H100 80GB HBM3,
# 700 W): the CUDA cores where the points make one run (TYPE1_2D_F64_RUN)
# and the output tiles more blocks than the card's CARD_SMS SMs, each
# block then making a tile's factor list and its phases for a few points
# (the samplers' 120 points at B 4 000: 2 000 blocks, 0.1903 ms against
# the CUDA cores' 0.0616; at B 1 0.0140 against 0.0233); else the FP64
# tensor cores (1.7-9.4x the CUDA cores' speed at the other shapes)
TYPE1_1D_F64_MAX_SPLIT = 1024
# The type-2 (csrc/tc_type2_f64.cuh type2_f64_kernel on Type2F64Split1D;
# type2_1d_geometry at float64): the float64 d=2 type-2's blocks, stage and
# column tiles on the split k = K q + r, K the least power of two up to
# this whose values q fit one chunk of A (this many k-steps of 8, the
# source's kChunk: A made once a block), the column tiles split over grid
# axis y into as many runs as bring the blocks to a wave of
# TYPE2_3D_F64_BLOCKS_PER_SM on each of the card's CARD_SMS SMs (the
# samplers' few points at B in the thousands)
# (both the source's Type2F64Split1D kMaxSplit and kChunk)
TYPE2_1D_F64_MAX_K = 32
TYPE2_1D_F64_CHUNK = 6
# Its dispatch, from the times of both kernels on the same inputs (as the
# type-1's): the CUDA cores where K is 1 (mtot up to 47: the split makes no
# fewer phases than the modes) and the point-vectors n B are fewer than
# this (the samplers' 7 and 120 points at B 1 and 4 000: 0.0031-0.0152 ms
# against the tensor cores' 0.0104-0.0198; 25 points at B 30 000, 750 000
# point-vectors, 0.0756 against 0.0356); else the FP64 tensor cores
# (2.1-9.4x the CUDA cores' speed at the light curve's shapes)
TYPE2_1D_F64_CUDA_MAX_WORK = 2 ** 19
# The float32 batched type-2's dispatch by mtot, from chip_smoke.py phase
# 3's times of both kernels on the same inputs: the tensor cores from this
# mtot on, the CUDA cores below it
TYPE2_2D_TC_MIN_MTOT = 64
# The float64 d=2 type-2 on the FP64 tensor cores (csrc/tc_type2_f64.cuh
# type2_f64_kernel), batched and at B 1, its geometry owned here
# (type2_2d_geometry at float64, type2_2d_single_geometry) and checked by
# its launch: blocks of 64 points walking column tiles of 64 columns
# (vector, mode j; the vectors' columns one after another, the last tile
# padded), or of 32 where 64 would pad the columns this many times as far
# (one vector on a narrow grid), F copied 16 modes k a stage; the modes k
# padded to whole k-steps of 8 and split as (8 s - half) + r, r <
# TYPE2_2D_F64_K (the source's k-step)
TYPE2_2D_F64_POINTS, TYPE2_2D_F64_STAGE = 64, 16
TYPE2_2D_F64_COLS, TYPE2_2D_F64_NARROW_COLS = 64, 32
TYPE2_2D_F64_NARROW_PADDING = 1.25
TYPE2_2D_F64_K = 8
# its epilogue takes a tile's T this many columns a pass (the source's
# T2D_EC): a vector's columns in a pass are summed in j order, the passes
# added in order
TYPE2_2D_F64_EPILOGUE = 32
# The single type-2's mode split (csrc/nufft_2d.cu nufft2_2d_split_kernel):
# blocks of 64 points by slabs of 16 modes j, checked by its launch
TYPE2_2D_SPLIT_THREADS, TYPE2_2D_SPLIT_ROWS = 64, 16
# The single type-2's dispatch (type2_2d_single_geometry), from the times
# of its paths on the same inputs (chip_smoke.py phase 3 at the driven
# shapes, scripts/time_type2_single.py and scripts/time_type2_2d_f64.py
# --shapes sweep between them).  In float32: the mode split from this
# mtot on (three slabs and more) below a number of points, the tensor
# cores from TYPE2_2D_TC_MIN_MTOT and this many points
TYPE2_2D_SPLIT_MIN_MTOT = 45
TYPE2_2D_SPLIT_MAX_POINTS = {torch.float32: 16384, torch.float64: 4096}
TYPE2_2D_SINGLE_TC_MIN_POINTS = 8192
# In float64 the FP64 tensor cores from this mtot on, but for the mode
# split on wide grids (this mtot and more) below TYPE2_2D_SPLIT_MAX_POINTS
# points (at 1 000-2 000 points a block of 64 leaves the card short of
# blocks: 0.047-0.18 ms against the tensor cores' 0.065-0.27 from mtot
# 129; at 107 and at 4 000 points the tensor cores tie or lead), and for
# the CUDA cores on narrow grids (up to this mtot) from this many points
# (at 32 000-256 000 points x 17-21 the CUDA cores took 0.74-0.91x the
# tensor cores' time, whose modes pad to 24; from 25 the tensor cores tie
# or lead); scripts/time_type2_2d_f64.py --shapes sweep on NVIDIA H100
# 80GB HBM3, 700 W
TYPE2_2D_F64_SINGLE_MIN_MTOT = 17
TYPE2_2D_F64_SPLIT_MIN_MTOT = 109
TYPE2_2D_F64_CUDA_MAX_MTOT, TYPE2_2D_F64_CUDA_MIN_POINTS = 23, 32768
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
# The float64 d=3 type-2 on the FP64 tensor cores (csrc/tc_type2_f64.cuh
# type2_f64_kernel on nufft_3d.cu's Type2F64Grid3D), its geometry owned here
# (type2_3d_geometry at float64) and checked by its launch: the float64
# d=2 type-2's blocks, column tiles (vector, j1) and stage, a GEMM over the
# pairs (j2, j3) in k-steps of one j2 and 8 modes j3 (j3 padded to whole
# k-steps), A made this many k-steps at a time (the source's kChunk); for
# few points the chunks split over a grid axis into at most this many runs
# of whole chunks, whose partials a second pass adds in split order, as
# many as cost least: a split's cost its waves of blocks (two an SM on the
# card's CARD_SMS) times its k-steps and this many k-steps more (its
# prologue, its first F copy and its epilogue)
TYPE2_3D_F64_CHUNK = 4
TYPE2_3D_F64_MAX_SPLITS = 16
TYPE2_3D_F64_SPLIT_OVERHEAD = 8
TYPE2_3D_F64_BLOCKS_PER_SM = 2

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
            # the tensor-core forms (float64: the FP64 tensor cores): the
            # type-2's geometry (points, K, cols, stage, and in float64 the
            # column tiles' splits) and the split f's scratch and size
            # before the output; the type-1's (rows, cols, group, the
            # float32 stage or the float64 split S, run, chunk) before the
            # scratch
            o2t = getattr(lib, f"gpq_nufft2_1d_tc_{prec}")
            o2t.argtypes = [ptr, ptr, real, i32, i32, i32, i32,
                            *[i32] * (4 if prec == "f32" else 5), ptr,
                            ctypes.c_longlong, ptr, ptr]
            o2t.restype = i32
            o1t = getattr(lib, f"gpq_nufft1_1d_tc_{prec}")
            o1t.argtypes = [ptr, ptr, real, i32, i32, i32, i32, *[i32] * 6,
                            ptr, ptr, ptr]
            o1t.restype = i32
            t2 = getattr(lib, f"gpq_nufft2_2d_{prec}")
            t2.argtypes = [ptr, ptr, real, i32, i32, i32, ptr, ptr]
            t2.restype = i32
            # the d=2 type-1 takes its geometry (rows, cols, group, the
            # float32 kernel's stage, run) before the chunk
            geo = [i32] * (5 if prec == "f32" else 4)
            t1 = getattr(lib, f"gpq_nufft1_2d_{prec}")
            t1.argtypes = [ptr, ptr, real, i32, i32, i32, *geo, i32, ptr, ptr,
                           ptr]
            t1.restype = i32
            if prec == "f32":
                # the batched type-2 on the CUDA cores, then on the tensor
                # cores: its geometry (points, cols, stage) and the split
                # F's scratch and size before the output
                b2 = lib.gpq_nufft2_2d_batched_f32
                b2.argtypes = [ptr, ptr, real, i32, i32, i32, i32, ptr, ptr]
                b2.restype = i32
                tc = lib.gpq_nufft2_2d_batched_tc_f32
                tc.argtypes = [ptr, ptr, real, i32, i32, i32, i32, i32, i32,
                               i32, ptr, ctypes.c_longlong, ptr, ptr]
                tc.restype = i32
            else:
                # the FP64 tensor cores' batched form and its B 1 instance:
                # the geometry (points, cols, stage), then the split F's
                # scratch and its size in doubles before the output
                tc = lib.gpq_nufft2_2d_batched_tc_f64
                tc.argtypes = [ptr, ptr, real, i32, i32, i32, i32, i32, i32,
                               i32, ptr, ctypes.c_longlong, ptr, ptr]
                tc.restype = i32
                t2t = lib.gpq_nufft2_2d_tc_f64
                t2t.argtypes = [ptr, ptr, real, i32, i32, i32, i32, i32, i32,
                                ptr, ctypes.c_longlong, ptr, ptr]
                t2t.restype = i32
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
            # the d=3 type-2: in float32 on the CUDA cores, in float64 on
            # the FP64 tensor cores (points, cols, stage, splits, then the
            # scratch and its size in doubles before the output)
            d2 = getattr(lib, f"gpq_nufft2_3d_{prec}")
            d2.argtypes = ([ptr, ptr, real, i32, i32, i32, i32, ptr, ptr]
                           if prec == "f32" else
                           [ptr, ptr, real, i32, i32, i32, i32, *[i32] * 4,
                            ptr, ctypes.c_longlong, ptr, ptr])
            d2.restype = i32
            if prec == "f64":
                # the d=3 type-1 on the FP64 tensor cores: its geometry
                # (rows, cols, group, split, run, chunk) before the scratch
                d1 = lib.gpq_nufft1_3d_f64
                d1.argtypes = [ptr, ptr, real, i32, i32, i32, i32, *[i32] * 6,
                               ptr, ptr, ptr]
                d1.restype = i32
            else:
                # the tensor-core form: its geometry (rows, cols, group,
                # stage, run, chunk) before the scratch
                d1t = lib.gpq_nufft1_3d_tc_f32
                d1t.argtypes = [ptr, ptr, real, i32, i32, i32, i32, *[i32] * 6,
                                ptr, ptr, ptr]
                d1t.restype = i32
                # the wide grids' tensor-core form: its geometry (rows,
                # cols, stage, run, chunk) before the scratch
                d1w = lib.gpq_nufft1_3d_wide_f32
                d1w.argtypes = [ptr, ptr, real, i32, i32, i32, i32, *[i32] * 5,
                                ptr, ptr, ptr]
                d1w.restype = i32
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
            symbol: str | None = None, path: str | None = None):
    """Call ``gpq_<name>_<f32|f64>`` (x's precision), or the C function
    ``symbol`` where given, with ``args`` and x's current stream; raise on a
    CUDA error, count the launch of ``name`` (by kernel, by kernel and
    ``mtot``, by kernel, precision and ``mtot``, and where ``path`` is
    given by kernel, path and ``mtot``)."""
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
    if path is not None:
        LAUNCH_PATHS[name, path, mtot] = LAUNCH_PATHS.get(
            (name, path, mtot), 0) + 1


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


def _type1_f64_sums(A, E, *, chunk: int, run: int):
    """The float64 tensor-core type-1's sums (csrc/tc_type1_f64.cuh) in
    its order: ``out[b, r, c] = sum_n A[b, n, r] E[n, c]`` for ``A`` (B, N,
    R) and ``E`` (N, C) complex128, as the real products
    ``Re = Ar^T Er + Ai^T (-Ei)``, ``Im = Ar^T Ei + Ai^T Er`` over k-steps
    of 8 points.  A run of ``run`` points starts from zero and takes its
    k-steps in order, each adding Ar Er then Ai (-Ei) into the real part
    and Ar Ei then Ai Er into the imaginary part (the kernel's DMMA
    accumulators; the tensor cores' own order inside a k-step, its 8
    products and the accumulator, is not emulated: here a float64 matmul
    of the 8 points, then one add); the runs of a group of ``chunk`` points
    are added in run order into the group's partial, the groups' partials
    in group order.  Returns (B, R, C) complex128."""
    if chunk % run or run % 8:
        raise ValueError(f"chunk {chunk} must be a multiple of run {run}, "
                         "and run of 8")
    B, n, R = A.shape
    C = E.shape[1]
    n8 = -(-n // 8) * 8
    A = torch.nn.functional.pad(A, (0, 0, 0, n8 - n))
    E = torch.nn.functional.pad(E, (0, 0, 0, n8 - n))
    steps = n8 // 8
    ar, ai = (t.reshape(B, steps, 8, R).transpose(-1, -2)
              for t in (A.real, A.imag))
    er, ei = (t.reshape(steps, 8, C) for t in (E.real, E.imag))
    zeros = A.real.new_zeros((B, R, C))
    out_re, out_im = zeros.clone(), zeros.clone()
    # k-steps whose products are formed at once: ~64 MB of them
    block = max(1, min(64, 2 ** 23 // max(1, B * R * C)))
    run_steps, group_steps = run // 8, chunk // 8
    for g0 in range(0, steps, group_steps):
        g1 = min(steps, g0 + group_steps)
        p_re = p_im = None
        for r0 in range(g0, g1, run_steps):
            r1 = min(g1, r0 + run_steps)
            d_re, d_im = zeros.clone(), zeros.clone()
            for s0 in range(r0, r1, block):
                s1 = min(r1, s0 + block)
                a_r, a_i = ar[:, s0:s1], ai[:, s0:s1]
                e_r, e_i = er[s0:s1], ei[s0:s1]
                prods = (torch.matmul(a_r, e_r), torch.matmul(a_i, -e_i),
                         torch.matmul(a_r, e_i), torch.matmul(a_i, e_r))
                for k in range(s1 - s0):
                    d_re = d_re + prods[0][:, k]
                    d_re = d_re + prods[1][:, k]
                    d_im = d_im + prods[2][:, k]
                    d_im = d_im + prods[3][:, k]
            p_re = d_re if p_re is None else p_re + d_re
            p_im = d_im if p_im is None else p_im + d_im
        out_re = out_re + p_re
        out_im = out_im + p_im
    return torch.complex(out_re, out_im)


def nufft1_2d_f64_tc_ref(x, vals, h, *, mtot: int, fft_order: bool = False,
                         chunk: int | None = None):
    """Plain twin of the float64 d=2 type-1 kernel on the FP64 tensor cores
    (csrc/tc_type1_f64.cuh ``type1_f64_kernel``): ``out[b,j,k] = sum_n
    v[b,n] e1(n,j) e2(n,k)`` with the kernel's operands and sums.  The rows
    and columns are the modes in symmetric order, index i for mode i -
    half, each phase the product of the mode split's two factors
    e(t, K s - half) e(t, r) for i = K s + r (K = :data:`TYPE1_2D_F64_K`;
    ``ops/nufft.py`` ``_phase_matrix`` on t = x h), v folded into e1's
    first factor; then :func:`_type1_f64_sums` (runs of
    :data:`TYPE1_2D_F64_RUN` points, groups of ``chunk`` points, by default
    :func:`type1_2d_geometry`'s at float64), and FFT order where asked.

    ``vals`` (N,) or (B, N); returns complex128 (mtot, mtot) or (B, mtot,
    mtot).  The tests run it on the CPU; chip_smoke.py on the card."""
    x = x.to(torch.float64)
    n = x.shape[0]
    single = vals.ndim == 1
    V = vals.reshape(-1, n).to(torch.complex128)
    B = V.shape[0]
    if chunk is None:
        chunk = type1_2d_geometry(n, mtot, B, not single,
                                  torch.float64)[-1]
    K, half, dev = TYPE1_2D_F64_K, (mtot - 1) // 2, x.device
    i = torch.arange(mtot, device=dev)
    base = (K * torch.arange(-(-mtot // K), device=dev) - half).double()
    r = torch.arange(K, device=dev).double()
    hq = float(h)
    t1, t2 = x[:, 0] * hq, x[:, 1] * hq
    e1 = ((V[:, :, None] * _phase_matrix(t1, base, torch.complex128)[None])
          [:, :, i // K] * _phase_matrix(t1, r, torch.complex128)[None][
              :, :, i % K])                                    # (B, N, m)
    e2 = (_phase_matrix(t2, base, torch.complex128)[:, i // K]
          * _phase_matrix(t2, r, torch.complex128)[:, i % K])  # (N, m)
    out = _type1_f64_sums(e1, e2, chunk=chunk, run=TYPE1_2D_F64_RUN)
    if fft_order:
        idx = torch.where(i >= half, i - half, i + mtot - half)
        fo = torch.empty_like(out)
        fo[:, idx[:, None], idx[None, :]] = out
        out = fo
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


def _type1_3d_wide_rows(x, V, h, m: int, i):
    """The wide kernel's A at its rows ``i`` (centred (j1, j2) pairs, i =
    j1 mtot + j2), from its table's factors (:func:`nufft1_3d_wide_ref`):
    (B, N, len(i)) complex64."""
    t1, t2 = x[:, 0] * h, x[:, 1] * h
    half = (m - 1) // 2
    i0 = i - i % TYPE1_2D_ROWS
    r, b2 = i - i0, i0 % m
    idx = (b2 + r) // m

    def e(t, k):
        return _phase_matrix(t, k.to(torch.float32), torch.complex64)
    a = V[:, :, None] * e(t1, i0 // m + idx - half)[None]
    a = torch.where(idx > 0, a * e(t2, -m * idx)[None], a)
    return (a * e(t2, b2 - half + 8 * (r // 8))[None]
            * e(t2, r % 8)[None])


def _type1_3d_wide_cols(x, h, m: int, cols: int):
    """The wide kernel's E, from its table's factors
    (:func:`nufft1_3d_wide_ref`): (N, mtot) complex64, column j3 centred."""
    t3 = x[:, 2] * h
    half = (m - 1) // 2
    j3 = torch.arange(m, device=x.device)
    k0, c = j3 - j3 % cols, j3 % cols

    def e(k):
        return _phase_matrix(t3, k.to(torch.float32), torch.complex64)
    return e(k0 - half + 8 * (c // 8)) * e(c % 8)


def nufft1_3d_wide_ref(x, vals, h, *, mtot: int, fft_order: bool = False,
                       chunk: int | None = None, passes: int = 3):
    """Plain twin of the wide grids' float32 d=3 type-1 kernel
    (csrc/tc_type1_wide.cuh ``type1_wide_kernel``), in float32 with its
    tiling algebra.  Row i = j1 mtot + j2 (centred indices) of A holds
    ``((v e1(j1)) w) C2 F2`` and column j3 of E ``C3 F3``, the kernel's
    table factors (``ops/nufft.py`` ``_phase_matrix`` on t = x h): for the
    row's tile from i0 = i - i % :data:`TYPE1_2D_ROWS`, r = i - i0,
    b2 = i0 % mtot and idx = (b2 + r) // mtot, e1(j1) = e(t1, i0 // mtot +
    idx - half), w = e(t2, -mtot idx) (none at idx 0), C2 = e(t2, b2 -
    half + 8 (r // 8)), F2 = e(t2, r % 8); for the column's tile from k0
    (:data:`TYPE1_3D_WIDE_COLS` wide), c = j3 - k0, C3 = e(t3, k0 - half +
    8 (c // 8)), F3 = e(t3, c % 8); each product one complex64 multiply,
    in that order.  Then the kernel's sums
    (:func:`_type1_3xtf32_sums`: k-steps of 8 points, sums of
    :data:`TYPE1_2D_STAGE` points, runs of :data:`TYPE1_2D_RUN`, groups of
    ``chunk`` points, by default the geometry's, in group order in
    float32), a slice of rows at a time, and the output in FFT order where
    asked.  ``passes=1`` keeps big*big alone: plain TF32, the control the
    split is held against.

    ``x`` (N, 3); ``vals`` (N,) or (B, N); returns complex64 (mtot,)*3 or
    (B,) + (mtot,)*3.  The tests run it on the CPU; the card-only tests on
    the card at a few thousand points."""
    x = x.to(torch.float32)
    n, m = x.shape[0], mtot
    single = vals.ndim == 1
    V = vals.reshape(-1, n).to(torch.complex64)
    B = V.shape[0]
    chunk = chunk or type1_3d_wide_geometry(n, m, B)[-1]
    hq = torch.tensor(h, dtype=torch.float32)
    E = _type1_3d_wide_cols(x, hq, m, TYPE1_3D_WIDE_COLS)
    out = torch.empty((B, m * m, m), dtype=torch.complex64, device=x.device)
    # a slice of rows at a time: the sums' products are (B, stage / 8,
    # rows, mtot) complex64 values, ~32 MB each at most
    step = TYPE1_2D_ROWS * max(1, 2 ** 17 // (TYPE1_2D_ROWS * B * m))
    for s0 in range(0, m * m, step):
        i = torch.arange(s0, min(m * m, s0 + step), device=x.device)
        out[:, s0:s0 + len(i)] = _type1_3xtf32_sums(
            _type1_3d_wide_rows(x, V, hq, m, i), E, chunk=chunk,
            run=TYPE1_2D_RUN, stage=TYPE1_2D_STAGE, passes=passes)
    out = out.reshape((B,) + (m,) * 3)
    if fft_order:
        half = (m - 1) // 2
        p = torch.arange(m, device=x.device)
        perm = torch.where(p <= half, p + half, p - m + half)
        out = out[:, perm][:, :, perm][:, :, :, perm]
    return out[0] if single else out


def nufft1_3d_f64_tc_ref(x, vals, h, *, mtot: int, fft_order: bool = False,
                         chunk: int | None = None, split: int | None = None):
    """Plain twin of the float64 d=3 type-1 kernel on the FP64 tensor cores
    (csrc/tc_type1_f64.cuh ``type1_f64_kernel`` on nufft_3d.cu's
    ``Type1F64Grid3D``): ``out[b,j1,j2,j3] = sum_n v[b,n] e1(n,j1)
    e2(n,j2) e3(n,j3)`` with the kernel's operands and sums.  The first
    axis's mode is split as k1 = S q + r (:func:`type1_3d_f64_split`, S by
    default the geometry's); row i = r mi + j3 of A holds v e(t1, r)
    e(t3, j3 - half), column c = q mi + j2 of E e(t1, S q) e(t2, j2 - half),
    and each inner phase is the product of the split's two factors,
    e(t, 8 (i // 8) - r mi - half) e(t, i % 8) (:data:`TYPE1_2D_F64_K` = 8;
    ``ops/nufft.py`` ``_phase_matrix`` on t = x h), the outer factor folded
    into the first, v into A's; then :func:`_type1_f64_sums` (runs of
    :data:`TYPE1_2D_F64_RUN` points, groups of ``chunk`` points, by default
    :func:`type1_3d_geometry`'s at float64), the outputs with |k1| past
    half cropped, and FFT order where asked.

    ``x`` (N, 3); ``vals`` (N,) or (B, N); returns complex128 (mtot,)*3 or
    (B,) + (mtot,)*3.  The tests run it on the CPU; chip_smoke.py on the
    card."""
    x = x.to(torch.float64)
    n, m = x.shape[0], mtot
    single = vals.ndim == 1
    V = vals.reshape(-1, n).to(torch.complex128)
    B = V.shape[0]
    geo = type1_3d_geometry(n, m, B, torch.float64)
    S = split or type1_3d_f64_split(m, geo[1] // geo[3], geo[2])[0]
    qmin, Q = type1_1d_split(m, S)
    K, half, dev = TYPE1_2D_F64_K, (m - 1) // 2, x.device
    mi = max(m, K)
    hq = float(h)
    t1, t2, t3 = (x[:, i] * hq for i in range(3))

    def factors(t, o, f):
        """The split's factors at the indices i = o mi + j, j < m, of the
        outer values ``o``: the first, e(t, 8 (i // 8) - o mi - half), times
        ``f`` (N, len(o)), the outer factors, and the second, e(t, i % 8):
        each (N, len(o) m)."""
        i = o[:, None] * mi + torch.arange(m, device=dev)[None, :]
        coarse = (K * (i // K) - o[:, None] * mi - half).reshape(-1)
        c = _phase_matrix(t, coarse.double(), torch.complex128)
        c = (f[:, :, None] * c.reshape(n, len(o), m)).reshape(n, -1)
        return c, _phase_matrix(t, (i % K).reshape(-1).double(),
                                torch.complex128)
    r = torch.arange(S, device=dev)
    q = torch.arange(Q, device=dev)
    ca, fa = factors(t3, r, _phase_matrix(t1, r.double(), torch.complex128))
    ce, fe = factors(t2, q, _phase_matrix(t1, (S * (qmin + q)).double(),
                                        torch.complex128))
    # rows (r, j3) of A with v folded into the first factor; columns (q, j2)
    A = V[:, :, None] * ca[None] * fa[None]                 # (B, N, S m)
    sums = _type1_f64_sums(A, ce * fe, chunk=chunk or geo[-1],
                           run=TYPE1_2D_F64_RUN).reshape(B, S, m, Q, m)
    k1 = S * (qmin + q)[None, :] + r[:, None]               # (S, Q)
    rs, qs = (k1.abs() <= half).nonzero(as_tuple=True)
    k1 = k1[rs, qs]
    out = torch.empty((B, m, m, m), dtype=torch.complex128, device=dev)
    # sums[b, r, j3, q, j2] -> out[b, j1, j2, j3] (j2, j3 symmetric here)
    out[:, torch.where(k1 >= 0, k1, k1 + m) if fft_order else k1 + half] = \
        sums.permute(0, 1, 3, 4, 2)[:, rs, qs]
    if fft_order:
        jj = torch.arange(m, device=dev)
        idx = torch.where(jj >= half, jj - half, jj + m - half)
        fo = torch.empty_like(out)
        fo[:, :, idx[:, None], idx[None, :]] = out
        out = fo
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


def _split_phases_2d(t, mtot: int):
    """e^{+2 pi i t k} at the symmetric-order modes, index i for mode
    i - half, each the product of the mode split's two factors
    e(t, K s - half) e(t, r) for i = K s + r (K = :data:`TYPE2_2D_F64_K`;
    ``ops/nufft.py`` ``_phase_matrix`` on t = x h): complex128 (N, mtot)."""
    K, half, dev = TYPE2_2D_F64_K, (mtot - 1) // 2, t.device
    i = torch.arange(mtot, device=dev)
    base = (K * torch.arange(-(-mtot // K), device=dev) - half).double()
    r = torch.arange(K, device=dev).double()
    return (_phase_matrix(t, base, torch.complex128).conj()[:, i // K]
            * _phase_matrix(t, r, torch.complex128).conj()[:, i % K])


def nufft2_2d_f64_tc_ref(x, f, h, *, mtot: int, fft_order: bool = False,
                         chunk: int = TYPE2_2D_F64_EPILOGUE):
    """Plain twin of the float64 d=2 type-2 kernel on the FP64 tensor cores
    (csrc/tc_type2_f64.cuh ``type2_f64_kernel``), with the kernel's
    operands and sums: the modes in symmetric order (F read through
    ``fft_order``), every phase the product of the mode split's two
    factors (:func:`_split_phases_2d`); ``T[p, (b, j)] = sum_k e2(p, k)
    F_b[j, k]`` over k-steps of 8 modes from zero (the modes padded with
    zeros to whole k-steps), each adding C Fr then S (-Fi) into the real
    part and C Fi then S Fr into the imaginary part (the kernel's DMMA
    accumulators; the tensor cores' own order inside a k-step is not
    emulated: here a float64 matmul of the 8 modes, then one add); then
    ``out[b, p] = sum_j e1(p, j) T[p, (b, j)]`` as the epilogue sums it:
    the columns (b, j) at b mtot + j in passes of ``chunk`` columns
    (:data:`TYPE2_2D_F64_EPILOGUE`, whatever the column tile), a vector's
    columns in a pass in j order from zero, its passes' sums added in
    order.

    ``f`` (B, mtot, mtot) or (B, mtot^2); returns complex128 (B, N).  The
    tests run it on the CPU; chip_smoke.py on the card."""
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    x = x.to(torch.float64)
    m, n = mtot, x.shape[0]
    F = f.reshape(-1, m, m).to(torch.complex128)       # (B, j, k)
    B, dev = F.shape[0], x.device
    half = (m - 1) // 2
    i = torch.arange(m, device=dev)
    if fft_order:
        idx = torch.where(i >= half, i - half, i + m - half)
        F = F[:, idx][:, :, idx]
    hq = float(h)
    e1 = _split_phases_2d(x[:, 0] * hq, m)              # (N, m)
    e2 = _split_phases_2d(x[:, 1] * hq, m)
    kq = _round_up(m, TYPE2_2D_F64_K)
    steps = kq // TYPE2_2D_F64_K
    eA = torch.nn.functional.pad(e2, (0, kq - m))
    C, S = (t.reshape(n, steps, 8).transpose(0, 1) for t in (eA.real,
                                                             eA.imag))
    Fk = torch.nn.functional.pad(F.permute(2, 0, 1), (0, 0, 0, 0, 0, kq - m))
    Fr, Fi = (t.reshape(steps, 8, B * m) for t in (Fk.real, Fk.imag))
    t_re = x.new_zeros((n, B * m))
    t_im = x.new_zeros((n, B * m))
    for s_ in range(steps):
        t_re = t_re + C[s_] @ Fr[s_]
        t_re = t_re + S[s_] @ (-Fi[s_])
        t_im = t_im + C[s_] @ Fi[s_]
        t_im = t_im + S[s_] @ Fr[s_]
    return _type2_f64_epilogue(
        e1[:, None, :] * torch.complex(t_re, t_im).reshape(n, B, m), chunk)


def _type2_f64_epilogue(W, chunk: int):
    """The FP64 tensor-core type-2's epilogue sums (csrc/tc_type2_f64.cuh)
    of ``W[p, b, j] = e1(p, j) T[p, (b, j)]`` (N, B, mtot): the columns
    (b, j) at b mtot + j in passes of ``chunk`` columns, a vector's columns
    in a pass in j order from zero, its passes' sums added in order.
    Returns complex128 (B, N)."""
    n, B, m = W.shape
    dev = W.device
    i = torch.arange(m, device=dev)
    tile = (torch.arange(B, device=dev)[:, None] * m + i[None, :]) // chunk
    out = torch.zeros((n, B), dtype=torch.complex128, device=dev)
    have = torch.zeros(B, dtype=torch.bool, device=dev)
    part = W[:, :, 0]
    for j in range(1, m):
        brk = tile[:, j] != tile[:, j - 1]
        if bool(brk.any()):
            out = torch.where(brk, torch.where(have, out + part, part), out)
            have = have | brk
            part = torch.where(brk, W[:, :, j], part + W[:, :, j])
        else:
            part = part + W[:, :, j]
    out = torch.where(have, out + part, part)
    return out.T.contiguous()


def nufft2_3d_f64_tc_ref(x, f, h, *, mtot: int, fft_order: bool = False,
                         splits: int | None = None,
                         chunk: int = TYPE2_2D_F64_EPILOGUE):
    """Plain twin of the float64 d=3 type-2 kernel on the FP64 tensor cores
    (csrc/tc_type2_f64.cuh ``type2_f64_kernel`` on nufft_3d.cu's
    ``Type2F64Grid3D``), with the kernel's operands and sums: the modes in
    symmetric order (f read through ``fft_order``); the reduction over the
    pairs (j2, j3) in k-steps ks = (j2, s) of the 8 modes j3 = 8 s + r, j3
    padded with zeros to whole k-steps (:func:`type2_3d_f64_split`); A's
    entry the k-step's factor e2(j2) e(t3, 8 s - half) times e(t3, r),
    where e2(j2) = e(t2, 8 (j2 // 8) - half) e(t2, j2 % 8)
    (:func:`_split_phases_2d`; ``ops/nufft.py`` ``_phase_matrix`` on t =
    x h); ``T[p, (b, j1)] = sum_k A[p, k] F_b[j1, k]`` over the k-steps
    from zero, each adding C Fr then S (-Fi) into the real part and C Fi
    then S Fr into the imaginary part (a float64 matmul of the 8 indices
    where the tensor cores keep their own order); with ``splits`` runs of
    whole chunks of :data:`TYPE2_3D_F64_CHUNK` k-steps (by default
    :func:`type2_3d_geometry`'s at float64), each run's T from zero; then
    each run's ``sum_j1 e1(p, j1) T[p, (b, j1)]`` as the epilogue sums it
    (:func:`_type2_f64_epilogue`, passes of ``chunk`` columns), the runs'
    added in split order.

    ``x`` (N, 3); ``f`` as :func:`nufft2_3d` takes it; returns complex128
    (N,) or (B, N).  The tests run it on the CPU; chip_smoke.py on the
    card."""
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    x = x.to(torch.float64)
    n, m = x.shape[0], mtot
    single, B = _type2_3d_batch(f, m)
    F = f.reshape(B, m, m, m).to(torch.complex128)     # (B, j1, j2, j3)
    dev, K, half = x.device, TYPE2_2D_F64_K, (m - 1) // 2
    if fft_order:
        i = torch.arange(m, device=dev)
        idx = torch.where(i >= half, i - half, i + m - half)
        F = F[:, idx][:, :, idx][:, :, :, idx]
    splits = splits or type2_3d_geometry(n, m, B, torch.float64)[-1]
    J3, steps = type2_3d_f64_split(m)
    n3 = J3 // K
    hq = float(h)
    t1, t2, t3 = (x[:, i] * hq for i in range(3))
    e1 = _split_phases_2d(t1, m)                        # (N, m)
    e2 = _split_phases_2d(t2, m)
    c3 = _phase_matrix(t3, (K * torch.arange(n3, device=dev) - half)
                       .double(), torch.complex128).conj()   # (N, n3)
    r3 = _phase_matrix(t3, torch.arange(K, device=dev).double(),
                       torch.complex128).conj()              # (N, 8)
    j3 = K * torch.arange(n3, device=dev)[:, None] + torch.arange(
        K, device=dev)[None, :]
    r3 = torch.where(j3 < m, r3[:, None, :],
                     torch.zeros((), dtype=torch.complex128))  # (N, n3, 8)
    # F as (k-step (j2, s), index r, column (b, j1))
    Fk = torch.nn.functional.pad(F, (0, J3 - m)).reshape(B, m, m, n3, K)
    Fk = Fk.permute(2, 3, 4, 0, 1).reshape(steps, K, B * m)
    Fr, Fi = Fk.real, Fk.imag
    nch = -(-steps // TYPE2_3D_F64_CHUNK)
    per = -(-nch // splits) * TYPE2_3D_F64_CHUNK        # k-steps a split
    out = None
    for kb in range(0, steps, per):
        t_re = x.new_zeros((n, B * m))
        t_im = x.new_zeros((n, B * m))
        for ks in range(kb, min(steps, kb + per)):
            j2, s_ = divmod(ks, n3)
            a = (e2[:, j2] * c3[:, s_])[:, None] * r3[:, s_]   # (N, 8)
            C, S = a.real, a.imag
            t_re = t_re + C @ Fr[ks]
            t_re = t_re + S @ (-Fi[ks])
            t_im = t_im + C @ Fi[ks]
            t_im = t_im + S @ Fr[ks]
        part = _type2_f64_epilogue(
            e1[:, None, :] * torch.complex(t_re, t_im).reshape(n, B, m),
            chunk)
        out = part if out is None else out + part
    return out[0] if single else out


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


def _two_prod_err(a, b):
    """The rounding error of the float64 product ``a * b`` (tensors or
    floats, broadcast), exactly (Dekker: each factor split into halves of
    26 bits with 2^27 + 1, whose products are exact), as ``fma(a, b, -a *
    b)`` gives it on the card."""
    def halves(t):
        big = t * 134217729.0
        hi = big - (big - t)
        return hi, t - hi
    (ah, al), (bh, bl) = halves(a), halves(b)
    return ((ah * bh - a * b) + ah * bl + al * bh) + al * bl


def _phase_split_f64(x, h, scale: int, modes):
    """e^{-2 pi i t k} for t = (scale x) h as the float64 d=1 kernels make
    each phase (csrc/nufft_common.cuh ``torus_split`` and ``phase_split``):
    t rounded to float64 and its rounding error te carried into the
    compensated cycles u k + te k (u = t - round(t)), reduced to |cycles|
    <= 1/2.  ``scale`` is a power of two, so that scale x is exact.  ``x``
    (N,) float64, ``modes`` (M,) integers; returns complex128 (N, M)."""
    xs = x * float(scale)
    h = float(h)
    t = xs * h
    te = _two_prod_err(xs, h)
    u = t - torch.round(t)
    k = modes.to(torch.float64)[None, :]
    p_ = u[:, None] * k
    err = _two_prod_err(u[:, None], k) + te[:, None] * k
    cyc = p_ - torch.round(p_)
    cyc = cyc + err
    cyc = cyc - torch.round(cyc)
    ang = (-2.0 * math.pi) * cyc
    return torch.complex(torch.cos(ang), torch.sin(ang))


def nufft1_1d_f64_tc_ref(x, vals, h, *, mtot: int, fft_order: bool = False,
                         chunk: int | None = None, split: int | None = None):
    """Plain twin of the float64 d=1 type-1 kernel on the FP64 tensor cores
    (csrc/tc_type1_f64.cuh ``type1_f64_kernel`` on nufft_1d.cu's
    ``Type1F64Split1D``): ``out[b, k] = sum_n v[b,n] e^{-2 pi i k t_n}``
    with the kernel's operands and sums.  The mode is split as k = S q + r
    (:func:`type1_1d_f64_split`, S by default the geometry's); row r of A
    holds v e(t, 8 (r // 8)) e(t, r % 8), column q (index qi = q - qmin) of
    E e(S t, 8 (qi // 8) + qmin) e(S t, qi % 8) (:data:`TYPE1_2D_F64_K` =
    8), every phase with the rounding of t carried in
    (:func:`_phase_split_f64`); then :func:`_type1_f64_sums` (runs of
    :data:`TYPE1_2D_F64_RUN` points, groups of ``chunk`` points, by default
    :func:`type1_1d_f64_tc_geometry`'s), the k past half cropped, and
    FFT order where asked.

    ``x`` (N, 1); ``vals`` (N,) or (B, N); returns complex128 (mtot,) or
    (B, mtot).  The tests run it on the CPU; chip_smoke.py on the card."""
    x = x.reshape(-1).to(torch.float64)
    n = x.shape[0]
    single = vals.ndim == 1
    V = vals.reshape(-1, n).to(torch.complex128)
    B = V.shape[0]
    geo = type1_1d_f64_tc_geometry(n, mtot, B)
    S = split or geo[4]
    qmin, Q = type1_1d_split(mtot, S)
    K, dev = TYPE1_2D_F64_K, x.device
    i = torch.arange(S, device=dev)
    c = torch.arange(Q, device=dev)
    fine = torch.arange(K, device=dev)
    coarse_r = _phase_split_f64(x, h, 1, K * torch.arange(-(-S // K),
                                                          device=dev))
    A = ((V[:, :, None] * coarse_r[None][:, :, i // K])
         * _phase_split_f64(x, h, 1, fine)[None][:, :, i % K])  # (B, N, S)
    coarse_c = _phase_split_f64(
        x, h, S, K * torch.arange(-(-Q // K), device=dev) + qmin)
    E = coarse_c[:, c // K] * _phase_split_f64(x, h, S, fine)[:, c % K]
    sums = _type1_f64_sums(A, E, chunk=chunk or geo[-1], run=geo[5])
    k = S * (qmin + c)[None, :] + i[:, None]                 # (S, Q)
    half = (mtot - 1) // 2
    keep = k.abs() <= half
    idx = torch.where(k >= 0, k, k + mtot) if fft_order else k + half
    out = torch.zeros((B, mtot), dtype=torch.complex128, device=dev)
    out[:, idx[keep]] = sums[:, keep]
    return out[0] if single else out


def nufft2_1d_f64_tc_ref(x, f, h, *, mtot: int, fft_order: bool = False,
                         geometry: tuple | None = None,
                         chunk: int = TYPE2_2D_F64_EPILOGUE):
    """Plain twin of the float64 d=1 type-2 kernel on the FP64 tensor cores
    (csrc/tc_type2_f64.cuh ``type2_f64_kernel`` on nufft_1d.cu's
    ``Type2F64Split1D``), with the kernel's operands and sums: the mode
    split as k = K q + r (K of ``geometry``, by default
    :func:`type2_1d_f64_tc_geometry`'s; :func:`type1_1d_split`); A's
    entry at index qi = q - qmin (padded with zeros to whole k-steps of 8)
    e(K t, qmin + 8 (qi // 8)) e(K t, qi % 8), e1's at r e(t, 8 (r // 8))
    e(t, r % 8), all e^{+2 pi i} with the rounding of t carried in
    (:func:`_phase_split_f64`); ``T[p, (b, r)] = sum_qi A[p, qi]
    f_b[K q + r]`` over the k-steps from zero, each adding C Fr then S
    (-Fi) into the real part and C Fi then S Fr into the imaginary part (a
    float64 matmul of the 8 indices where the tensor cores keep their own
    order); then ``out[b, p] = sum_r e1(p, r) T[p, (b, r)]`` as the
    epilogue sums it (:func:`_type2_f64_epilogue`, passes of ``chunk``
    columns).

    ``x`` (N, 1); ``f`` (mtot,) or (B, mtot); returns complex128 (N,) or
    (B, N).  The tests run it on the CPU; chip_smoke.py on the card."""
    x = x.reshape(-1).to(torch.float64)
    n = x.shape[0]
    single = f.ndim == 1
    F = f.reshape(-1, mtot).to(torch.complex128)
    B, dev = F.shape[0], x.device
    geo = geometry or type2_1d_f64_tc_geometry(n, mtot, B)
    K, k8 = geo[2], TYPE2_2D_F64_K
    qmin, Q = type1_1d_split(mtot, K)
    steps = -(-Q // k8)
    q = torch.arange(steps * k8, device=dev)
    r = torch.arange(K, device=dev)
    fine = torch.arange(k8, device=dev)
    zero = torch.zeros((), dtype=torch.complex128, device=dev)
    A = (_phase_split_f64(x, h, K, qmin + k8 * torch.arange(steps,
                                                            device=dev))
         [:, q // k8] * _phase_split_f64(x, h, K, fine)[:, q % k8]).conj()
    A = torch.where(q < Q, A, zero)                      # (N, steps 8)
    e1 = (_phase_split_f64(x, h, 1, k8 * torch.arange(-(-K // k8),
                                                      device=dev))[:, r // k8]
          * _phase_split_f64(x, h, 1, fine)[:, r % k8]).conj()   # (N, K)
    kk = K * (qmin + q)[:, None] + r[None, :]            # (steps 8, K)
    half = (mtot - 1) // 2
    keep = (kk.abs() <= half) & (q < Q)[:, None]
    idx = torch.where(kk >= 0, kk, kk + mtot) if fft_order else kk + half
    Fq = torch.where(keep, F[:, idx.clamp(0, mtot - 1)], zero)  # (B, ., K)
    Fk = Fq.permute(1, 0, 2).reshape(steps, k8, B * K)
    C, S = (t.reshape(n, steps, k8).transpose(0, 1)
            for t in (A.real, A.imag))
    Fr, Fi = Fk.real, Fk.imag
    t_re = x.new_zeros((n, B * K))
    t_im = x.new_zeros((n, B * K))
    for s_ in range(steps):
        t_re = t_re + C[s_] @ Fr[s_]
        t_re = t_re + S[s_] @ (-Fi[s_])
        t_im = t_im + C[s_] @ Fi[s_]
        t_im = t_im + S[s_] @ Fr[s_]
    out = _type2_f64_epilogue(
        e1[:, None, :] * torch.complex(t_re, t_im).reshape(n, B, K), chunk)
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
    launches the kernel :func:`type2_1d_geometry` picks: in float32 the
    tensor cores on a split of the mode index (a scratch of
    :func:`type2_1d_scratch_floats` floats) or the CUDA cores, in float64
    the FP64 tensor cores on a split of the mode index (a scratch of
    :func:`type2_1d_f64_scratch_doubles` doubles) or the CUDA cores."""
    _check(x, mtot, 1)
    if f.ndim not in (1, 2) or f.shape[-1] != mtot:
        raise ValueError(f"f must be ({mtot},) or (B, {mtot}), "
                         f"got {tuple(f.shape)}")
    single = f.ndim == 1
    B = 1 if single else f.shape[0]
    _check_batch(B, mtot, 1)
    if x.device.type == "cpu":
        return nufft2_1d_ref(x, f, h, mtot=mtot, fft_order=fft_order)
    geo = type2_1d_geometry(x.shape[0], mtot, B, x.dtype)
    out = _nufft2_1d_on(x, f.reshape(B, mtot), h, mtot, fft_order, geo)
    return out[0] if single else out


def type2_1d_geometry(n: int, mtot: int, B: int = 1,
                      dtype: torch.dtype = torch.float32) -> tuple:
    """The d=1 type-2's path and launch geometry in ``dtype``: ``("tc",
    points, K, cols, stage)`` in float32 and ``("tc", points, K, cols,
    stage, splits)`` in float64, a tensor-core kernel's arguments before
    its scratch, or ``("cuda",)``, the CUDA-core kernel, whose block is
    fixed in its source.

    In float64 the FP64 tensor cores (:func:`type2_1d_f64_tc_geometry`),
    but for the CUDA cores where that geometry's K is 1 and the call has
    fewer than :data:`TYPE2_1D_F64_CUDA_MAX_WORK` point-vectors n B.
    In float32 the tensor-core kernel splits each mode as k = K q + r
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
    if dtype == torch.float64:
        geo = type2_1d_f64_tc_geometry(n, mtot, B)
        if geo[2] == 1 and n * B < TYPE2_1D_F64_CUDA_MAX_WORK:
            return ("cuda",)
        return geo
    if (mtot < TYPE2_1D_TC_MIN_MTOT
            or n * mtot < TYPE2_1D_TC_MIN_WORK[B > 1]):
        return ("cuda",)
    return type2_1d_tc_geometry(B)


def type2_1d_f64_tc_geometry(n: int, mtot: int, B: int = 1) -> tuple:
    """The FP64 tensor-core d=1 type-2's geometry (:func:`type2_1d_geometry`
    at float64 where it picks them): ``("tc", points, K, cols, stage,
    splits)`` for csrc/tc_type2_f64.cuh on nufft_1d.cu's
    ``Type2F64Split1D``.  The mode split k = K q + r takes the least power
    of two K up to :data:`TYPE2_1D_F64_MAX_K` whose Q values of q
    (:func:`type1_1d_split`) fit :data:`TYPE2_1D_F64_CHUNK` k-steps of 8
    (one vector's K columns r, the GEMM over q: 32 at mtot 919, 1 at the
    samplers' 15 and 17, where the columns are the vectors); blocks of
    :data:`TYPE2_2D_F64_POINTS` points, the float64 d=2 type-2's stage and
    its rule for the column tiles (:func:`type2_2d_geometry` on the B K
    columns); ``splits`` runs of the column tiles over grid axis y, as many
    as bring the blocks to :data:`TYPE2_3D_F64_BLOCKS_PER_SM` a card's
    :data:`CARD_SMS` SMs (one where the points' blocks reach that), made
    canonical: none empty."""
    K = 1
    while (K < TYPE2_1D_F64_MAX_K and type1_1d_split(mtot, K)[1]
           > TYPE2_2D_F64_K * TYPE2_1D_F64_CHUNK):
        K *= 2
    wide, narrow = (_round_up(B * K, c) for c in (
        TYPE2_2D_F64_COLS, TYPE2_2D_F64_NARROW_COLS))
    cols = (TYPE2_2D_F64_NARROW_COLS
            if wide >= TYPE2_2D_F64_NARROW_PADDING * narrow
            else TYPE2_2D_F64_COLS)
    tiles = -(-B * K // cols)
    blocks = -(-n // TYPE2_2D_F64_POINTS)
    slots = TYPE2_3D_F64_BLOCKS_PER_SM * CARD_SMS
    splits = 1 if blocks >= slots else min(tiles, -(-slots // blocks))
    per = -(-tiles // splits)
    return ("tc", TYPE2_2D_F64_POINTS, K, cols, TYPE2_2D_F64_STAGE,
            -(-tiles // per))


def type2_1d_f64_scratch_doubles(mtot: int, B: int, geometry: tuple) -> int:
    """Doubles of the FP64 tensor-core d=1 type-2's F in fragment order:
    the real and imaginary part of each (value q, column) cell, the Q
    values of q padded to whole k-steps of 8, the B K columns (vector, r)
    to whole tiles."""
    _, _, K, cols, _, _ = geometry
    kq = _round_up(type1_1d_split(mtot, K)[1], TYPE2_2D_F64_K)
    return 2 * kq * _round_up(B * K, cols)


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
    ``geo`` (:func:`type2_1d_geometry` in x's precision): the tensor cores
    (float32: 3xTF32; float64: the FP64 tensor cores, K a power of two up
    to :data:`TYPE2_1D_F64_MAX_K`) or the CUDA cores; counted as one launch of ``nufft2_1d``
    (chip_smoke.py also times the paths through it).  Returns (B, N)."""
    f64 = x.dtype == torch.float64
    tc_len = 6 if f64 else 5
    if geo[0] not in ("tc", "cuda") or len(geo) != (tc_len if geo[0] == "tc"
                                                    else 1) or (
            f64 and geo[0] == "tc" and (
                geo[1] != TYPE2_2D_F64_POINTS
                or geo[4] != TYPE2_2D_F64_STAGE
                or geo[3] not in (TYPE2_2D_F64_COLS,
                                  TYPE2_2D_F64_NARROW_COLS)
                or not 1 <= geo[2] <= TYPE2_1D_F64_MAX_K
                or geo[2] & (geo[2] - 1))):
        raise ValueError(f"no d=1 type-2 path for geometry {geo}"
                         + (" in float64" if f64 else ""))
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
    if geo[0] == "tc" and f64:
        doubles = type2_1d_f64_scratch_doubles(m, B, geo)
        scratch = torch.empty(doubles, dtype=torch.float64, device=x.device)
        _launch("nufft2_1d", x, *args, *geo[1:], scratch.data_ptr(), doubles,
                out.data_ptr(), mtot=m, symbol="gpq_nufft2_1d_tc_f64")
    elif geo[0] == "tc":
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
    kernels: point-group partials, then their sum in group order.  The
    partials come from the tensor cores on a split of the mode index
    (:func:`type1_1d_geometry`; scratch of groups * B * mtot values): in
    float32 3xTF32, in float64 the FP64 tensor cores (one group writes the
    output itself), but for the calls the geometry keeps on the CUDA cores
    (2048-point chunks).  A CPU tensor takes the plain version."""
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
    geo = type1_1d_geometry(n, mtot, B, x.dtype)
    out = _nufft1_1d_on(x, vals.reshape(B, n), h, mtot, fft_order, geo)
    return out[0] if single else out


def type1_1d_geometry(n: int, mtot: int, B: int = 1,
                      dtype: torch.dtype = torch.float32) -> tuple:
    """The d=1 type-1's path and launch geometry in ``dtype``: ``("tc",
    rows, cols, group, stage, run, chunk)`` in float32 and ``("tc", rows,
    cols, group, split, run, chunk)`` in float64, a tensor-core kernel's
    arguments before its scratch.

    In float64 the FP64 tensor cores (:func:`type1_1d_f64_tc_geometry`),
    but for ``("cuda", chunk)``, the CUDA cores over chunks of ``chunk``
    points, where the points make one run of :data:`TYPE1_2D_F64_RUN` and
    that geometry's output tiles pass :data:`CARD_SMS`.
    In float32 the kernel splits each mode as k = K q + r with K = rows / group
    (:func:`type1_1d_split`): one vector takes K = 64, a batch runs in
    pairs (group 2, K = 32).  Its output tile is :data:`TYPE1_2D_ROWS` rows
    (the group's K values of r each) by ``cols`` values of q:
    :data:`TYPE1_2D_NARROW_COLS`, or :data:`TYPE1_2D_COLS` where the Q
    values of q pass twice that.  A register sum takes ``stage`` points and
    a run ``run`` (:data:`TYPE1_1D_RUN`); the groups of ``chunk`` points
    (whole runs) are as many as fill about :data:`CARD_SMS` blocks
    of column tiles x point groups x batch groups without passing it, never
    an empty one.  The scratch holds ceil(n / chunk) * B * mtot values."""
    if dtype == torch.float64:
        geo = type1_1d_f64_tc_geometry(n, mtot, B)
        if n <= TYPE1_2D_F64_RUN and _type1_1d_f64_tiles(
                mtot, B, geo) > CARD_SMS:
            return ("cuda", TYPE1_CHUNK)
        return geo
    g = 1 if B == 1 else TYPE1_2D_BATCH_GROUP
    _, q = type1_1d_split(mtot, TYPE1_2D_ROWS // g)
    cols = (TYPE1_2D_NARROW_COLS if q <= 2 * TYPE1_2D_NARROW_COLS
            else TYPE1_2D_COLS)
    tiles = -(-q // cols) * -(-B // g)
    chunk = _type1_chunk(n, TYPE1_1D_RUN, tiles, CARD_SMS)
    return ("tc", TYPE1_2D_ROWS, cols, g, TYPE1_2D_STAGE, TYPE1_1D_RUN,
            chunk)


def type1_1d_f64_split(mtot: int, rows: int, cols: int) -> tuple:
    """The float64 d=1 type-1's split of the mode index, k = S q + r, for
    tiles of ``rows`` rows a vector by ``cols`` columns (csrc/nufft_1d.cu
    ``Type1F64Split1D``): ``(S, qmin, Q)``.  Row r < S, column q from qmin,
    Q values (:func:`type1_1d_split` at K = S); S is the power of two up to
    :data:`TYPE1_1D_F64_MAX_SPLIT` whose S rows and Q columns, each padded
    to whole tiles, make the fewest outputs (the smallest S of a tie)."""
    def padded(S):
        Q = type1_1d_split(mtot, S)[1]
        return _round_up(S, rows) * _round_up(Q, cols)
    splits = [1 << i for i in range(TYPE1_1D_F64_MAX_SPLIT.bit_length())]
    S = min(splits, key=padded)
    return (S, *type1_1d_split(mtot, S))


@functools.lru_cache(maxsize=1024)
def _type1_wave_chunk(n: int, tiles: int, group_bytes: int, run: int,
                      scratch: float) -> int:
    """Points a group of the FP64 tensor-core type-1 (d=1 and d=3) and of
    the wide grids' float32 d=3 type-1: whole runs of ``run`` points, in
    as many groups as make the fewest
    waves of blocks (``tiles`` output tiles x groups) on the card's
    :data:`CARD_SMS` SMs times runs a block, the fewest groups of a tie,
    with at most ``scratch`` bytes of partials (``group_bytes`` a group).
    Kept for the shapes a process calls: the search over the groups takes
    ~0.1 ms of host time at the light curve's 124 runs, more than its
    kernel's 0.055 ms."""
    nrun = max(1, -(-n // run))
    cap = max(1, int(scratch // group_bytes))

    def cost(groups):
        """(waves x runs a block, groups) of ``groups`` point groups."""
        per = -(-nrun // groups)
        return -(-tiles * -(-nrun // per) // CARD_SMS) * per, groups
    groups = min(range(1, min(nrun, cap) + 1), key=cost)
    return -(-nrun // groups) * run


def _type1_1d_f64_tiles(mtot: int, B: int, geo: tuple) -> int:
    """The output tiles (row tiles x column tiles x batch groups) of the
    FP64 tensor-core d=1 type-1 at geometry ``geo``."""
    _, rows, cols, g, S, _, _ = geo
    Q = type1_1d_split(mtot, S)[1]
    return -(-S // (rows // g)) * -(-Q // cols) * -(-B // g)


@functools.lru_cache(maxsize=1024)
def type1_1d_f64_tc_geometry(n: int, mtot: int, B: int = 1) -> tuple:
    """The FP64 tensor-core d=1 type-1's geometry (:func:`type1_1d_geometry`
    at float64 where it picks them), kept for the shapes a process calls
    (its searches take ~30 us of host time, about a kernel's at the
    samplers' sizes): ``("tc", rows, cols, group, split, run, chunk)`` for
    csrc/tc_type1_f64.cuh on nufft_1d.cu's ``Type1F64Split1D``: tiles of :data:`TYPE1_2D_ROWS` rows (one vector's
    64 values r, or a batch group of two vectors' 32) by
    :data:`TYPE1_2D_F64_COLS` values q, or :data:`TYPE1_2D_F64_NARROW_COLS`
    where the wide tiles pad :data:`TYPE1_2D_F64_NARROW_PADDING` times as
    much or more; the split S of :func:`type1_1d_f64_split` for that tile;
    runs of :data:`TYPE1_2D_F64_RUN` points and the point groups of
    :func:`_type1_wave_chunk`.  The output is tiny and the sum long (919
    outputs from 63 480 points: one tile), so the card fills through the
    point groups, their partials (groups x B x mtot values) added in group
    order."""
    g = 1 if B == 1 else TYPE1_2D_BATCH_GROUP
    tj = TYPE1_2D_ROWS // g

    def layout(cols):
        """(split, tiles, padded outputs) of tiles ``cols`` wide."""
        S, _, Q = type1_1d_f64_split(mtot, tj, cols)
        tiles = -(-S // tj) * -(-Q // cols) * -(-B // g)
        return S, tiles, tiles * tj * cols
    cols, lay = TYPE1_2D_F64_COLS, layout(TYPE1_2D_F64_COLS)
    narrow = layout(TYPE1_2D_F64_NARROW_COLS)
    if lay[2] >= TYPE1_2D_F64_NARROW_PADDING * narrow[2]:
        cols, lay = TYPE1_2D_F64_NARROW_COLS, narrow
    S, tiles, _ = lay
    chunk = _type1_wave_chunk(n, tiles, 16 * B * mtot, TYPE1_2D_F64_RUN,
                              TYPE1_3D_F64_SCRATCH)
    return ("tc", TYPE1_2D_ROWS, cols, g, S, TYPE1_2D_F64_RUN, chunk)


def _nufft1_1d_on(x, vals, h, m, fft_order, geo):
    """The d=1 type-1's launch on CUDA tensors, ``vals`` (B, N), on the
    path ``geo``: ``("tc", ...)`` the tensor cores
    (:func:`type1_1d_geometry` in x's precision: 3xTF32 in float32, the
    FP64 tensor cores in float64, S a power of two up to
    :data:`TYPE1_1D_F64_MAX_SPLIT`, runs of :data:`TYPE1_2D_F64_RUN`) or
    ``("cuda", chunk)`` the CUDA cores
    over chunks of ``chunk`` points; counted as one launch of
    ``nufft1_1d`` (chip_smoke.py also times the paths through it).
    Returns (B, m)."""
    f64 = x.dtype == torch.float64
    if geo[0] not in ("tc", "cuda") or len(geo) != (7 if geo[0] == "tc"
                                                    else 2) or (
            f64 and geo[0] == "tc" and (
                geo[1] != TYPE1_2D_ROWS
                or geo[2] not in (TYPE1_2D_F64_COLS,
                                  TYPE1_2D_F64_NARROW_COLS)
                or not 1 <= geo[4] <= TYPE1_1D_F64_MAX_SPLIT
                or geo[4] & (geo[4] - 1) or geo[5] != TYPE1_2D_F64_RUN)):
        raise ValueError(f"no d=1 type-1 path for geometry {geo}"
                         + (" in float64" if f64 else ""))
    cdtype = _complex_of(x.dtype)
    _check_cuda_operand("vals", vals, x, cdtype)
    B, n = vals.shape
    if n == 0:
        return torch.zeros((B, m), dtype=cdtype, device=x.device)
    x = x.contiguous()
    vals = vals.contiguous()
    h = float(torch.as_tensor(h, dtype=x.dtype))
    groups = -(-n // geo[-1])
    out = torch.empty((B, m), dtype=cdtype, device=x.device)
    # the FP64 tensor cores' single group writes the output itself
    partial = (out if f64 and geo[0] == "tc" and groups == 1 else
               torch.empty((groups, B, m), dtype=cdtype, device=x.device))
    prec = "f64" if f64 else "f32"
    _launch("nufft1_1d", x, x.data_ptr(), vals.data_ptr(), h, n, m, B,
            int(fft_order), *geo[1:], partial.data_ptr(), out.data_ptr(),
            mtot=m, symbol=f"gpq_nufft1_1d_tc_{prec}" if geo[0] == "tc"
            else None)
    return out


def nufft2_2d(x, f, h, *, mtot: int, fft_order: bool = False):
    """Fused type-2 apply for d=2 (replaces ``pallas_nufft2_2d`` and
    ``_pallas_nufft2_2d_tiled``).

    ``x`` (N, 2) real, ``f`` complex (mtot, mtot) or (mtot^2,), ``h`` the
    grid spacing; returns complex (N,).  A CPU tensor takes the plain
    version; a CUDA tensor launches the path
    :func:`type2_2d_single_geometry` picks from the shape: the tensor
    cores (float32, a scratch of :func:`type2_2d_scratch_floats` floats at
    B 1; float64, the FP64 tensor cores with a scratch of
    :func:`type2_2d_f64_scratch_doubles` doubles), the mode split (a
    scratch of ceil(mtot / 16) * N values), or one thread a point on the
    CUDA cores.  Each counts one launch."""
    _check(x, mtot)
    if x.device.type == "cpu":
        return nufft2_2d_ref(x, f, h, mtot=mtot, fft_order=fft_order)
    geo = type2_2d_single_geometry(x.shape[0], mtot, x.dtype)
    return _nufft2_2d_on(x, f, h, mtot, fft_order, geo)


def type2_2d_single_geometry(n: int, mtot: int, dtype) -> tuple:
    """The single d=2 type-2's path and launch geometry for ``n`` points in
    ``dtype``: ``("tc", points, cols, stage)``, the batched type-2's
    tensor-core kernel at B 1 (:func:`type2_2d_geometry`'s geometry in
    ``dtype``: 3xTF32 in float32, the FP64 tensor cores in float64);
    ``("split", rows, threads)``, the mode split, slabs of ``rows`` modes j
    by blocks of ``threads`` points; or ``("cuda",)``, one thread a point,
    the block fixed in its source.

    A table from the times of every path on the same inputs (chip_smoke.py
    phase 3 at the driven shapes, scripts/time_type2_single.py and
    scripts/time_type2_2d_f64.py between them).  In float64 the FP64
    tensor cores take every call from
    :data:`TYPE2_2D_F64_SINGLE_MIN_MTOT` on but two kinds: up to
    :data:`TYPE2_2D_F64_CUDA_MAX_MTOT` with
    :data:`TYPE2_2D_F64_CUDA_MIN_POINTS` points or more the CUDA cores
    (no modes padded), and from :data:`TYPE2_2D_F64_SPLIT_MIN_MTOT` below
    ``TYPE2_2D_SPLIT_MAX_POINTS[float64]`` points the split (more blocks
    than the tensor cores' 64 points a block give); narrower grids stay on
    the CUDA cores.  In float32 grids below
    :data:`TYPE2_2D_SPLIT_MIN_MTOT`, the headline's mtot 29 among them,
    stay on the CUDA cores: one or two slabs do not pay for the split's
    second pass.  The tensor cores take
    :data:`TYPE2_2D_SINGLE_TC_MIN_POINTS` points and more from
    :data:`TYPE2_2D_TC_MIN_MTOT` on.  Otherwise the split takes calls below
    ``TYPE2_2D_SPLIT_MAX_POINTS[float32]`` points, where one thread a point
    leaves the card short of warps to hide its chains of dependent
    multiply-adds; past that the CUDA cores keep them (the split makes a
    point's e2 phases once a slab, the one-thread-a-point kernel its e1
    phases once a tile of 32 modes k, and the card is full either way),
    and the split's scratch of ceil(mtot / 16) * N values stays small."""
    if dtype == torch.float64:
        if mtot < TYPE2_2D_F64_SINGLE_MIN_MTOT or (
                mtot <= TYPE2_2D_F64_CUDA_MAX_MTOT
                and n >= TYPE2_2D_F64_CUDA_MIN_POINTS):
            return ("cuda",)
        if (mtot >= TYPE2_2D_F64_SPLIT_MIN_MTOT
                and n < TYPE2_2D_SPLIT_MAX_POINTS[dtype]):
            return ("split", TYPE2_2D_SPLIT_ROWS, TYPE2_2D_SPLIT_THREADS)
        return type2_2d_geometry(mtot, dtype)
    if mtot < TYPE2_2D_SPLIT_MIN_MTOT:
        return ("cuda",)
    if mtot >= TYPE2_2D_TC_MIN_MTOT and n >= TYPE2_2D_SINGLE_TC_MIN_POINTS:
        return type2_2d_geometry(mtot)
    if n < TYPE2_2D_SPLIT_MAX_POINTS[dtype]:
        return ("split", TYPE2_2D_SPLIT_ROWS, TYPE2_2D_SPLIT_THREADS)
    return ("cuda",)


def _nufft2_2d_on(x, f, h, m, fft_order, geo):
    """The single type-2's launch on CUDA tensors on the path and geometry
    ``geo`` (:func:`type2_2d_single_geometry`), counted as one launch of
    ``nufft2_2d``; chip_smoke.py also times every path through it."""
    if geo[0] == "tc" and x.dtype == torch.float64:
        _check_type2_f64_geometry(geo)
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
    if geo[0] == "tc" and x.dtype == torch.float64:
        # the FP64 tensor cores' B 1 instance
        doubles = type2_2d_f64_scratch_doubles(m, 1, geo)
        scratch = torch.empty(doubles, dtype=torch.float64, device=x.device)
        _launch("nufft2_2d", x, *args, fo, *geo[1:], scratch.data_ptr(),
                doubles, out.data_ptr(), mtot=m,
                symbol="gpq_nufft2_2d_tc_f64")
    elif geo[0] == "tc":
        # the batched kernel at B 1
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
    tensor cores, float64: on the FP64 tensor cores; scratch of
    ceil(N / :func:`type1_2d_chunk`) * mtot^2 values)."""
    _check(x, mtot)
    if x.device.type == "cpu":
        return nufft1_2d_ref(x, vals, h, mtot=mtot, fft_order=fft_order)
    n = x.shape[0]
    if vals.shape != (n,):
        raise ValueError(f"vals must be ({n},), got {tuple(vals.shape)}")
    geo = type1_2d_geometry(n, mtot, dtype=x.dtype)
    return _nufft1_2d_on(x, vals[None], h, mtot, fft_order, geo, False)[0]


def type1_2d_geometry(n: int, mtot: int, B: int = 1, batched: bool = False,
                      dtype: torch.dtype = torch.float32) -> tuple[int, ...]:
    """The d=2 type-1's launch geometry in ``dtype``, the arguments its
    launch takes before the scratch: ``(rows, cols, group, stage, run,
    chunk)`` in float32 (csrc/tc_type1.cuh), ``(rows, cols, group, run,
    chunk)`` in float64 (csrc/tc_type1_f64.cuh).

    The output tile is :data:`TYPE1_2D_ROWS` rows (``group`` vectors of
    ``rows / group`` modes j: one for a single vector,
    :data:`TYPE1_2D_BATCH_GROUP` for a batch) by ``cols`` modes k.  In
    float32 ``cols`` is :data:`TYPE1_2D_COLS`, or
    :data:`TYPE1_2D_NARROW_COLS` where ``mtot`` is at most twice that, a
    register sum takes ``stage`` points and a run :data:`TYPE1_2D_RUN`; in
    float64 it is :data:`TYPE1_2D_F64_COLS`, or
    :data:`TYPE1_2D_F64_NARROW_COLS` where the wide tiles would pad the
    columns :data:`TYPE1_2D_F64_NARROW_PADDING` times as far or more, and a
    run takes :data:`TYPE1_2D_F64_RUN` points.  The kernel's blocks are
    output tiles x point groups x batch groups; the groups of ``chunk``
    points (whole runs, :func:`_type1_chunk`) are as many as fill about
    :data:`TYPE1_2D_BLOCKS` blocks without passing it, never an empty one.
    The scratch holds ceil(n / chunk) * B * mtot^2 values."""
    g = TYPE1_2D_BATCH_GROUP if batched else 1
    if dtype == torch.float32:
        cols = (TYPE1_2D_NARROW_COLS if mtot <= 2 * TYPE1_2D_NARROW_COLS
                else TYPE1_2D_COLS)
        run = TYPE1_2D_RUN
    else:
        wide, narrow = (-(-mtot // c) * c for c in (TYPE1_2D_F64_COLS,
                                                    TYPE1_2D_F64_NARROW_COLS))
        cols = (TYPE1_2D_F64_NARROW_COLS
                if wide >= TYPE1_2D_F64_NARROW_PADDING * narrow
                else TYPE1_2D_F64_COLS)
        run = TYPE1_2D_F64_RUN
    tiles = (-(-mtot // (TYPE1_2D_ROWS // g)) * -(-mtot // cols)
             * -(-B // g))
    chunk = _type1_chunk(n, run, tiles, TYPE1_2D_BLOCKS)
    stage = (TYPE1_2D_STAGE,) if dtype == torch.float32 else ()
    return (TYPE1_2D_ROWS, cols, g, *stage, run, chunk)


def _type1_chunk(n: int, run: int, tiles: int, blocks: int) -> int:
    """Points a group of a type-1 on the tensor cores: whole runs of
    ``run`` points, in as many groups as fill about ``blocks`` blocks of
    ``tiles`` output tiles x groups without passing it, never an empty
    one."""
    nrun = max(1, -(-n // run))
    groups = min(nrun, max(1, blocks // tiles))
    return -(-nrun // groups) * run


def type1_2d_chunk(n: int, mtot: int, B: int = 1,
                   batched: bool = False) -> int:
    """Points per group of the float32 d=2 type-1 (:func:`type1_2d_geometry`)."""
    return type1_2d_geometry(n, mtot, B, batched)[-1]


def _nufft1_2d_on(x, vals, h, m, fft_order, geo, batched):
    """The d=2 type-1's launch on CUDA tensors, ``vals`` (B, N), with
    :func:`type1_2d_geometry`'s geometry ``geo`` in x's precision (the
    tensor cores in float32, the FP64 tensor cores in float64).  Counted as
    one launch of ``nufft1_2d_batched`` (``batched``) or ``nufft1_2d``.
    Returns (B, m, m)."""
    name = "nufft1_2d_batched" if batched else "nufft1_2d"
    if len(geo) != (6 if x.dtype == torch.float32 else 5):
        raise ValueError(f"no {x.dtype} d=2 type-1 kernel for geometry {geo}")
    cdtype = _complex_of(x.dtype)
    _check_cuda_operand("vals", vals, x, cdtype)
    B, n = vals.shape
    if n == 0:
        return torch.zeros((B, m, m), dtype=cdtype, device=x.device)
    x = x.contiguous()
    vals = vals.contiguous()
    h = float(torch.as_tensor(h, dtype=x.dtype))
    partial = torch.empty((-(-n // geo[-1]), B, m, m), dtype=cdtype,
                          device=x.device)
    out = torch.empty((B, m, m), dtype=cdtype, device=x.device)
    lead = (n, m, B) if batched else (n, m)
    _launch(name, x, x.data_ptr(), vals.data_ptr(), h, *lead,
            int(fft_order), *geo, partial.data_ptr(), out.data_ptr(), mtot=m)
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


def type2_2d_geometry(mtot: int, dtype: torch.dtype = torch.float32,
                      B: int = 1) -> tuple:
    """The batched d=2 type-2's kernel and launch geometry in ``dtype`` for
    ``B`` vectors: ``("tc", points, cols, stage)`` for a tensor-core kernel
    (blocks of ``points`` points walking column tiles of ``cols`` columns
    (vector, mode j), ``stage`` modes k a stage), or ``("cuda",)`` for the
    CUDA-core kernel, whose block is fixed in its source.

    In float32 a table by mtot from chip_smoke.py phase 3's times of both
    kernels on the same inputs: the tensor cores (3xTF32,
    csrc/tc_type2.cuh) from :data:`TYPE2_2D_TC_MIN_MTOT` on (the points and
    the batch did not change the faster kernel at the shapes timed), with
    the scratch of :func:`type2_2d_scratch_floats`.  In float64 always the
    FP64 tensor cores (csrc/tc_type2_f64.cuh; the single type-2's at B 1),
    with the scratch of :func:`type2_2d_f64_scratch_doubles`: blocks of
    :data:`TYPE2_2D_F64_POINTS` points walking column tiles of
    :data:`TYPE2_2D_F64_COLS` columns (the B vectors' mtot columns one
    after another), or of :data:`TYPE2_2D_F64_NARROW_COLS` where the wide
    tiles would pad the B * mtot columns
    :data:`TYPE2_2D_F64_NARROW_PADDING` times as far or more,
    :data:`TYPE2_2D_F64_STAGE` modes k a stage."""
    if dtype == torch.float64:
        wide, narrow = (_round_up(B * mtot, c) for c in (
            TYPE2_2D_F64_COLS, TYPE2_2D_F64_NARROW_COLS))
        cols = (TYPE2_2D_F64_NARROW_COLS
                if wide >= TYPE2_2D_F64_NARROW_PADDING * narrow
                else TYPE2_2D_F64_COLS)
        return ("tc", TYPE2_2D_F64_POINTS, cols, TYPE2_2D_F64_STAGE)
    if mtot >= TYPE2_2D_TC_MIN_MTOT:
        return ("tc", TYPE2_2D_POINTS, TYPE2_2D_COLS, TYPE2_2D_STAGE)
    return ("cuda",)


def _check_type2_f64_geometry(geo: tuple):
    """Raise unless ``geo`` is an instance of the FP64 tensor-core type-2
    (its launch refuses any other as well)."""
    if (len(geo) != 4 or geo[0] != "tc"
            or geo[1] != TYPE2_2D_F64_POINTS or geo[3] != TYPE2_2D_F64_STAGE
            or geo[2] not in (TYPE2_2D_F64_COLS, TYPE2_2D_F64_NARROW_COLS)):
        raise ValueError(f"no float64 d=2 type-2 kernel for geometry {geo}")


def type2_2d_f64_scratch_doubles(mtot: int, B: int, geometry: tuple) -> int:
    """Doubles of the FP64 tensor-core type-2's F in fragment order: the
    real and imaginary part of each (mode k, column) cell, the modes k
    padded to whole k-steps of 8, the B * mtot columns to whole tiles."""
    cols = geometry[2]
    return 2 * _round_up(mtot, TYPE2_2D_F64_K) * _round_up(B * mtot, cols)


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
    tensor launches the kernel :func:`type2_2d_geometry` dispatches it to:
    in float32 the tensor cores (with a scratch of
    :func:`type2_2d_scratch_floats` floats) or the CUDA cores, in float64
    the FP64 tensor cores (a scratch of
    :func:`type2_2d_f64_scratch_doubles` doubles)."""
    _check(x, mtot)
    m = mtot
    if f.ndim not in (2, 3) or tuple(f.shape[1:]) not in ((m * m,), (m, m)):
        raise ValueError(f"f must be (B, {m}, {m}) or (B, {m * m}), "
                         f"got {tuple(f.shape)}")
    B = f.shape[0]
    _check_batch(B, m)
    if x.device.type == "cpu":
        return nufft2_2d_batched_ref(x, f, h, mtot=m, fft_order=fft_order)
    geo = type2_2d_geometry(m, x.dtype, B)
    return _nufft2_2d_batched_on(x, f, h, m, fft_order, geo)


def _nufft2_2d_batched_on(x, f, h, m, fft_order, geo):
    """The batched type-2's launch on CUDA tensors with the kernel and
    geometry ``geo`` (:func:`type2_2d_geometry`) in x's precision (the
    tensor cores in float32, the FP64 tensor cores in float64);
    chip_smoke.py also times both kernels through it."""
    if geo[0] == "tc" and x.dtype == torch.float64:
        _check_type2_f64_geometry(geo)
    cdtype = _complex_of(x.dtype)
    _check_cuda_operand("f", f, x, cdtype)
    B, n = f.shape[0], x.shape[0]
    out = torch.empty((B, n), dtype=cdtype, device=x.device)
    if n == 0:
        return out
    x = x.contiguous()
    f = f.contiguous()
    h = float(torch.as_tensor(h, dtype=x.dtype))
    if geo[0] == "tc" and x.dtype == torch.float64:
        doubles = type2_2d_f64_scratch_doubles(m, B, geo)
        scratch = torch.empty(doubles, dtype=torch.float64, device=x.device)
        _launch("nufft2_2d_batched", x, x.data_ptr(), f.data_ptr(), h, n, m,
                B, int(fft_order), *geo[1:], scratch.data_ptr(), doubles,
                out.data_ptr(), mtot=m,
                symbol="gpq_nufft2_2d_batched_tc_f64")
    elif geo[0] == "tc":
        floats = type2_2d_scratch_floats(m, B, geo)
        scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
        _launch("nufft2_2d_batched", x, x.data_ptr(), f.data_ptr(), h, n, m,
                B, int(fft_order), *geo[1:], scratch.data_ptr(), floats,
                out.data_ptr(), mtot=m,
                symbol="gpq_nufft2_2d_batched_tc_f32")
    elif geo == ("cuda",) and x.dtype == torch.float32:
        _launch("nufft2_2d_batched", x, x.data_ptr(), f.data_ptr(), h, n, m,
                B, int(fft_order), out.data_ptr(), mtot=m)
    else:
        raise ValueError(f"no {x.dtype} batched type-2 kernel for geometry "
                         f"{geo}")
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
    geo = type1_2d_geometry(n, mtot, B, True, x.dtype)
    return _nufft1_2d_on(x, vals, h, mtot, fft_order, geo, True)


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
    :func:`type2_3d_geometry` picks: in float32 the tensor cores (with a
    scratch of :func:`type2_3d_scratch_floats` floats) or the CUDA cores,
    in float64 the FP64 tensor cores (a scratch of
    :func:`type2_3d_f64_scratch_doubles` doubles)."""
    _check(x, mtot, 3)
    m = mtot
    single, B = _type2_3d_batch(f, m)
    _check_batch(B, m, 3)
    if x.device.type == "cpu":
        return nufft2_3d_ref(x, f, h, mtot=m, fft_order=fft_order)
    geo = type2_3d_geometry(x.shape[0], m, B, x.dtype)
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


def type2_3d_f64_split(mtot: int) -> tuple[int, int]:
    """The float64 d=3 type-2's reduction on the FP64 tensor cores
    (csrc/nufft_3d.cu ``Type2F64Grid3D``): ``(J3, steps)``, the modes j3
    padded to J3, whole k-steps of :data:`TYPE2_2D_F64_K` (21 -> 24), and
    the k-steps ks = (j2, s) = (ks // (J3 / 8), ks % (J3 / 8)) of the modes
    j3 = 8 s + r, mtot J3 / 8 of them."""
    J3 = _round_up(mtot, TYPE2_2D_F64_K)
    return J3, mtot * J3 // TYPE2_2D_F64_K


def type2_3d_geometry(n: int, mtot: int, B: int = 1,
                      dtype: torch.dtype = torch.float32) -> tuple:
    """The d=3 type-2's path and launch geometry in ``dtype``:
    ``("tc", points, cols, stage, splits)``, a tensor-core kernel's
    arguments before its scratch, or ``("cuda",)``, the float32 CUDA-core
    kernel, whose block is fixed in its source.

    In float64 always the FP64 tensor cores (csrc/tc_type2_f64.cuh on
    nufft_3d.cu's ``Type2F64Grid3D``), with the scratch of
    :func:`type2_3d_f64_scratch_doubles`: the float64 d=2 type-2's blocks
    of :data:`TYPE2_2D_F64_POINTS` points and stage, its column tiles
    (:func:`type2_2d_geometry` at float64 on the B * mtot columns (vector,
    j1)); ``splits`` runs of whole chunks of :data:`TYPE2_3D_F64_CHUNK`
    k-steps, the number up to :data:`TYPE2_3D_F64_MAX_SPLITS` that costs
    least, a split's cost its waves of blocks
    (:data:`TYPE2_3D_F64_BLOCKS_PER_SM` on each of :data:`CARD_SMS` SMs)
    times its k-steps and :data:`TYPE2_3D_F64_SPLIT_OVERHEAD` (the fewest
    splits of a tie), made canonical: none empty.

    In float32 the tensor cores' geometry
    (:func:`type2_3d_tc_geometry`) or the CUDA cores, from a table of the
    times of both kernels on the same inputs
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
    if dtype == torch.float64:
        return _type2_3d_f64_geometry(n, mtot, B)
    padding = (_round_up(mtot, TYPE2_2D_STAGE) / mtot) ** 2
    if padding > TYPE2_3D_MAX_PADDING and n * B >= TYPE2_3D_FEW_POINTS:
        return ("cuda",)
    return type2_3d_tc_geometry(n, mtot, B)


def _type2_3d_f64_geometry(n: int, mtot: int, B: int) -> tuple:
    """:func:`type2_3d_geometry`'s float64 branch."""
    cols = type2_2d_geometry(mtot, torch.float64, B)[2]
    nch = -(-type2_3d_f64_split(mtot)[1] // TYPE2_3D_F64_CHUNK)
    blocks = -(-n // TYPE2_2D_F64_POINTS)
    slots = TYPE2_3D_F64_BLOCKS_PER_SM * CARD_SMS

    def cost(s):
        return (-(-blocks * s // slots)
                * (-(-nch // s) * TYPE2_3D_F64_CHUNK
                   + TYPE2_3D_F64_SPLIT_OVERHEAD))
    splits = min(range(1, min(TYPE2_3D_F64_MAX_SPLITS, nch) + 1), key=cost)
    per = -(-nch // splits)
    return ("tc", TYPE2_2D_F64_POINTS, cols, TYPE2_2D_F64_STAGE,
            -(-nch // per))


def type2_3d_f64_scratch_doubles(n: int, mtot: int, B: int,
                                 geometry: tuple) -> int:
    """Doubles of the FP64 tensor-core d=3 type-2's scratch: F in fragment
    order (the real and imaginary part of each (index k, column) cell, the
    mtot J3 indices k of :func:`type2_3d_f64_split`, the B * mtot columns
    padded to whole tiles), then, for two splits or more, their partial
    outputs (splits x B x n complex values)."""
    _, _, cols, _, splits = geometry
    kq = TYPE2_2D_F64_K * type2_3d_f64_split(mtot)[1]
    return (2 * kq * _round_up(B * mtot, cols)
            + (2 * splits * B * n if splits > 1 else 0))


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
    ``geo`` of :func:`type2_3d_geometry` in x's precision: in float32 the
    tensor cores or the CUDA cores, in float64 the FP64 tensor cores
    (tiles 32 or 64 columns wide, 1 .. :data:`TYPE2_3D_F64_MAX_SPLITS`
    splits); counted as one launch of ``nufft2_3d`` (a split's second pass
    inside it; chip_smoke.py also times the paths through it).  Returns
    (B, N)."""
    if x.dtype == torch.float64:
        if (len(geo) != 5 or geo[0] != "tc"
                or geo[1] != TYPE2_2D_F64_POINTS
                or geo[3] != TYPE2_2D_F64_STAGE
                or geo[2] not in (TYPE2_2D_F64_COLS,
                                  TYPE2_2D_F64_NARROW_COLS)
                or not 1 <= geo[4] <= TYPE2_3D_F64_MAX_SPLITS):
            raise ValueError(f"no d=3 type-2 path for geometry {geo} in "
                             "float64")
    elif geo[0] not in ("tc", "cuda") or len(geo) != (5 if geo[0] == "tc"
                                                      else 1):
        raise ValueError(f"no d=3 type-2 path for geometry {geo}")
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
    if x.dtype == torch.float64:
        doubles = type2_3d_f64_scratch_doubles(n, m, B, geo)
        scratch = torch.empty(doubles, dtype=torch.float64, device=x.device)
        _launch("nufft2_3d", x, *args, *geo[1:], scratch.data_ptr(), doubles,
                out.data_ptr(), mtot=m)
    elif geo[0] == "tc":
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
    The partials come from the path :func:`type1_3d_geometry` picks: in
    float32 the tensor cores (groups of its ``chunk`` points; past mtot
    :data:`TYPE1_3D_TC_MAX_MTOT` the wide grids' kernel, one group of
    which writes the output itself), in float64 the FP64 tensor cores
    (groups of its ``chunk`` points; one group writes the output itself);
    the scratch holds groups * B * mtot^3 values.  A CPU tensor takes the
    plain version."""
    _check(x, mtot, 3)
    n = x.shape[0]
    if vals.ndim not in (1, 2) or vals.shape[-1] != n:
        raise ValueError(f"vals must be ({n},) or (B, {n}), "
                         f"got {tuple(vals.shape)}")
    single = vals.ndim == 1
    B = 1 if single else vals.shape[0]
    geo = type1_3d_geometry(n, mtot, B, x.dtype)
    _check_batch(B, mtot, 3, _type1_3d_groups_of(n, geo))
    if x.device.type == "cpu":
        return nufft1_3d_ref(x, vals, h, mtot=mtot, fft_order=fft_order)
    out = _nufft1_3d_on(x, vals.reshape(B, n), h, mtot, fft_order, geo)
    return out[0] if single else out


def type1_3d_geometry(n: int, mtot: int, B: int = 1,
                      dtype: torch.dtype = torch.float32) -> tuple:
    """The d=3 type-1's path and launch geometry in ``dtype``.

    In float32: ``("tc", rows, cols, group, stage, run, chunk)``, the
    tensor-core kernel's arguments before its scratch
    (:func:`type1_3d_tc_geometry`), up to :data:`TYPE1_3D_TC_MAX_MTOT`
    modes, where its column tiles are wide (at mtot 101 and 255 its narrow
    ones took 2.8x the wide grids' kernel's time); past it ``("wide",
    rows, cols, stage, run, chunk)``, the wide grids' tensor-core kernel
    (:func:`type1_3d_wide_geometry`), from a table of the times of both
    kernels on the same inputs (chip_smoke.py phase 3 at 57 and 61,
    scripts/time_type1_3d_wide.py past 64).

    In float64: ``("tc", rows, cols, group, split, run, chunk)``, the FP64
    tensor-core kernel's arguments before its scratch (csrc/tc_type1_f64.cuh
    on nufft_3d.cu's ``Type1F64Grid3D``): tiles of :data:`TYPE1_2D_ROWS`
    rows (one vector's 64, or a batch group of two vectors' 32) by
    :data:`TYPE1_2D_F64_COLS` columns, or :data:`TYPE1_2D_F64_NARROW_COLS`
    where the wide tiles pad :data:`TYPE1_2D_F64_NARROW_PADDING` times as
    much or more, or give fewer blocks than one wave on the card's
    :data:`CARD_SMS` SMs and the narrow ones more; the split S of
    :func:`type1_3d_f64_split` for that tile; runs of
    :data:`TYPE1_2D_F64_RUN` points, and point groups of ``chunk`` points,
    as many as make the fewest waves of blocks on the card's
    :data:`CARD_SMS` SMs times runs a block (the fewest groups of a tie)
    with at most :data:`TYPE1_3D_F64_SCRATCH` bytes of partials (one group,
    which writes the output itself, where a group's pass that: the widest
    grids, 265 MB of output a vector at mtot 255, take no scratch)."""
    if dtype == torch.float64:
        return _type1_3d_f64_geometry(n, mtot, B)
    if mtot > TYPE1_3D_TC_MAX_MTOT:
        return type1_3d_wide_geometry(n, mtot, B)
    return type1_3d_tc_geometry(n, mtot, B)


def type1_3d_wide_geometry(n: int, mtot: int, B: int = 1) -> tuple:
    """The wide grids' tensor-core d=3 type-1's geometry
    (csrc/tc_type1_wide.cuh; :func:`type1_3d_geometry`'s float32 pick past
    :data:`TYPE1_3D_TC_MAX_MTOT`): ``("wide", rows, cols, stage, run,
    chunk)``, the kernel's arguments before its scratch.  Tiles of
    :data:`TYPE1_2D_ROWS` rows (pairs (j1, j2) of one vector, mtot^2 of
    them end to end) by :data:`TYPE1_3D_WIDE_COLS` modes j3; the d=2
    type-1's register sums (:data:`TYPE1_2D_STAGE` points) and runs
    (:data:`TYPE1_2D_RUN`); whole runs a point group, in as many groups
    as
    make the fewest waves of blocks on the card's :data:`CARD_SMS` SMs
    times runs a block (the fewest of a tie), their partials, groups * B *
    mtot^3 complex64 values, within :data:`TYPE1_3D_WIDE_SCRATCH` bytes;
    one group writes the output itself (at 2e4 x 101 six groups of 960
    blocks took 4.09 ms and three of 480 4.48; NVIDIA H100 80GB HBM3, 700
    W, scripts/time_type1_3d_wide.py)."""
    if mtot < TYPE1_3D_WIDE_MIN_MTOT:
        raise ValueError(f"the wide d=3 type-1 takes mtot >= "
                         f"{TYPE1_3D_WIDE_MIN_MTOT}, got {mtot}")
    cols = TYPE1_3D_WIDE_COLS
    tiles = -(-mtot * mtot // TYPE1_2D_ROWS) * -(-mtot // cols) * B
    chunk = _type1_wave_chunk(n, tiles, 8 * B * mtot ** 3, TYPE1_2D_RUN,
                              TYPE1_3D_WIDE_SCRATCH)
    return ("wide", TYPE1_2D_ROWS, cols, TYPE1_2D_STAGE, TYPE1_2D_RUN, chunk)


def type1_3d_f64_split(mtot: int, rows: int, cols: int) -> tuple:
    """The float64 d=3 type-1's split of the first axis's mode, k1 = S q +
    r, for tiles of ``rows`` rows a vector by ``cols`` columns
    (csrc/nufft_3d.cu ``Type1F64Grid3D``): ``(S, qmin, Q, mi)``.  Row i of
    a vector is (r, j3) = (i // mi, i % mi) and column c is (q, j2) =
    (c // mi, c % mi), mi = max(mtot, :data:`TYPE1_2D_F64_K`), r < S and
    q from qmin, Q values (:func:`type1_1d_split` at K = S); S is the one
    in 1 .. :data:`TYPE1_3D_F64_MAX_SPLIT` whose S mi rows and Q mi
    columns, each padded to whole tiles, make the fewest outputs (the
    smallest S of a tie)."""
    mi = max(mtot, TYPE1_2D_F64_K)

    def padded(S):
        Q = type1_1d_split(mtot, S)[1]
        return -(-S * mi // rows) * rows * (-(-Q * mi // cols) * cols)
    S = min(range(1, TYPE1_3D_F64_MAX_SPLIT + 1), key=padded)
    return (S, *type1_1d_split(mtot, S), mi)


def _type1_3d_f64_geometry(n: int, mtot: int, B: int) -> tuple:
    """:func:`type1_3d_geometry`'s float64 branch."""
    g = 1 if B == 1 else TYPE1_2D_BATCH_GROUP
    tj = TYPE1_2D_ROWS // g

    def layout(cols):
        """(split, tiles, padded outputs) of tiles ``cols`` wide."""
        S, _, Q, mi = type1_3d_f64_split(mtot, tj, cols)
        tiles = -(-S * mi // tj) * -(-Q * mi // cols) * -(-B // g)
        return S, tiles, tiles * tj * cols
    cols = TYPE1_2D_F64_COLS
    wide = layout(TYPE1_2D_F64_COLS)
    narrow = layout(TYPE1_2D_F64_NARROW_COLS)
    if wide[2] >= TYPE1_2D_F64_NARROW_PADDING * narrow[2]:
        cols, wide = TYPE1_2D_F64_NARROW_COLS, narrow
    S, tiles = wide[:2]
    chunk = _type1_wave_chunk(n, tiles, 16 * B * mtot ** 3,
                              TYPE1_2D_F64_RUN, TYPE1_3D_F64_SCRATCH)
    return ("tc", TYPE1_2D_ROWS, cols, g, S, TYPE1_2D_F64_RUN, chunk)


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


def _type1_3d_groups_of(n, geo):
    """The point groups (partial sums) of the d=3 type-1 on path ``geo``."""
    return max(1, -(-n // geo[-1]))


def _nufft1_3d_on(x, vals, h, m, fft_order, geo):
    """The d=3 type-1's launch on CUDA tensors, ``vals`` (B, N), on the
    path ``geo`` of :func:`type1_3d_geometry` in x's precision: in float32
    ``("tc", ...)`` the tensor cores or ``("wide", ...)`` the wide grids'
    tensor-core kernel (one group writes the output itself), in float64
    ``("tc", ...)`` the FP64 tensor cores (tiles 32 or 64 columns wide, a
    split of 1 .. :data:`TYPE1_3D_F64_MAX_SPLIT`); counted as one launch
    of ``nufft1_3d`` (chip_smoke.py also times the paths through it).
    Returns (B, m, m, m)."""
    if x.dtype == torch.float64:
        if (len(geo) != 7 or geo[0] != "tc" or geo[2] not in (
                TYPE1_2D_F64_COLS, TYPE1_2D_F64_NARROW_COLS)
                or not 1 <= geo[4] <= TYPE1_3D_F64_MAX_SPLIT):
            raise ValueError(f"no d=3 type-1 path for geometry {geo} in "
                             "float64")
    elif geo[0] not in ("tc", "wide") or len(geo) != {
            "tc": 7, "wide": 6}[geo[0]]:
        raise ValueError(f"no d=3 type-1 path for geometry {geo}")
    cdtype = _complex_of(x.dtype)
    _check_cuda_operand("vals", vals, x, cdtype)
    B, n = vals.shape
    shape = (B, m, m, m)
    if n == 0:
        return torch.zeros(shape, dtype=cdtype, device=x.device)
    x = x.contiguous()
    vals = vals.contiguous()
    h = float(torch.as_tensor(h, dtype=x.dtype))
    groups = _type1_3d_groups_of(n, geo)
    out = torch.empty(shape, dtype=cdtype, device=x.device)
    args = (x.data_ptr(), vals.data_ptr(), h, n, m, B, int(fft_order))
    if x.dtype == torch.float64:
        # one group writes the output itself
        partial = (out if groups == 1 else
                   torch.empty((groups,) + shape, dtype=cdtype,
                               device=x.device))
        _launch("nufft1_3d", x, *args, *geo[1:], partial.data_ptr(),
                out.data_ptr(), mtot=m, path="fp64")
        return out
    if geo[0] == "wide":
        # one group writes the output itself
        partial = (out if groups == 1 else
                   torch.empty((groups,) + shape, dtype=cdtype,
                               device=x.device))
        _launch("nufft1_3d", x, *args, *geo[1:], partial.data_ptr(),
                out.data_ptr(), mtot=m, symbol="gpq_nufft1_3d_wide_f32",
                path="wide")
        return out
    partial = torch.empty((groups,) + shape, dtype=cdtype, device=x.device)
    _launch("nufft1_3d", x, *args, *geo[1:], partial.data_ptr(),
            out.data_ptr(), mtot=m, symbol="gpq_nufft1_3d_tc_f32", path="tc")
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
        with profiling.stage("nufft_type1", span_attrs, 1, self, vals,
                             self.x.dtype):
            return self._type1(vals)

    def type2(self, fk):
        with profiling.stage("nufft_type2", span_attrs, 2, self, fk,
                             self.x.dtype):
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
