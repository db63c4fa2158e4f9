#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gpquad_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
  1. torch and the card (nvidia-smi name and power limit);
  2. build the CUDA kernels from gpquad_torch/csrc (timed);
  3. each kernel against its float64 plain version on the card, at every
     shape that phases 4, 5 and 10 give it, in float32 (1e-4 of max|ref|)
     and float64 (1e-10), with CUDA-event times of kernel and plain
     version; for the batched pair also the time of B single-vector
     launches of the single kernels on the same inputs; the float32 d=2
     type-1 (tensor cores, 3xTF32) also within max(2x the float32 plain
     version's error, 1e-6), with its 3xTF32 bound beside the fp32 one,
     its output tile and its scratch (the peak allocated in the call less
     the output; under 256 MB); the float32 batched d=2 type-2 on both of
     its kernels, the tensor cores (3xTF32) and the CUDA cores, on the same
     inputs, each held to the bars above and bit for bit against a second
     launch, with both times, the 3xTF32 bound beside the fp32 one, the
     tensor-core kernel's scratch and the kernel
     cuda_nufft.type2_2d_geometry dispatches the shape to; the single d=2
     type-2 on each of its paths at every driven shape, the tensor cores
     (float32, 3xTF32, the batched kernel at B 1), the mode split and the
     CUDA cores, on the same inputs: the split and the tensor cores in
     float32 within max(2x the float32 plain version's error, 1e-6), every
     path in float64 within 1e-13, each bit for bit against a second
     launch, timed, with its scratch, the tensor cores' 3xTF32 bound and
     the split's bound with its partials, the path
     cuda_nufft.type2_2d_single_geometry picks, and a check that the pick
     was the fastest path measured there (within DISPATCH_TIE); the
     float32 d=1 type-1 on both of its kernels, the tensor cores (3xTF32
     on a split of the mode index, the wrapper's path) and the CUDA cores,
     on the same inputs: each bit for bit against a second launch, the
     tensor cores within max(2x the float32 plain version's error, 1e-6)
     and within twice that of their twin nufft1_1d_3xtf32_ref, the card's
     time of both in alternating rounds, the 3xTF32 bound beside the fp32
     one, and a check that the tensor cores were the faster (within
     DISPATCH_TIE); likewise the float32 d=1 type-2 on both of its kernels
     (the tensor cores on a split of the mode index, nufft2_1d_3xtf32_ref
     its twin, with the padding of its geometry) and the float32 d=3
     type-1 and type-2 on both of their kernels (the tensor cores on
     Type1Grid3D and Type2Grid3D, nufft1_3d_3xtf32_ref and
     nufft2_3d_3xtf32_ref their twins, run where the operand stays under
     1e9 values, with both scratches, the card's times with the host
     ahead), each checked that the path cuda_nufft.type2_1d_geometry /
     type1_3d_geometry / type2_3d_geometry picks was the fastest measured
     there (within DISPATCH_TIE);
  4. the headline configuration (bench.py: n=1e5 points in [0,1]^2, SE
     l=0.1, sigmasq=0.01, eps=1e-6, 10 000 targets, 256 variance probes,
     10 trace samples): the serving slice fit -> predict_mean ->
     predict_var(stochastic), then the hyper-gradient on the fit's state,
     then the fused fit_predict_grad (the north-star workload), each in
     float32 on the kernels with its launch counts, held against the port's
     own float64 run on the plain path with the same probes; the float32
     gradient's error over three probe seeds, for the fused call on the
     kernels and on the plain path and for the gradient with the fit's
     state and its own NUFFTs each from the kernels or the plain path;
  5. the CG tier at bench.py's hard configuration (l=0.02, mtot=107): fit +
     predict_mean with Jacobi PCG and with the Kronecker preconditioner,
     then gradient_with_grid(state=...) on the Jacobi fit, with their own
     launch counts, against float64;
  6. d3, the fused fit_predict_grad on 3-D data (n=1e5 in [0,1]^3, SE
     l=0.1 -> mtot 31, M 29 791; 10 000 targets, 256 variance probes, 10
     trace samples) with Jacobi PCG (one timed call) and with kron (median
     of 3 warm calls, one profile): launches per call, against the port's
     float64 run on the plain path with the same generator seed;
  7. hard3d (bench.py:363-438: n=2e4, l=0.2 -> mtot 21, M 9261): the fit
     with the deflation preconditioner (rank 2048) and the mean, then the
     stochastic variance and gradient_with_grid(state=fit) reusing its
     block, against float64;
  8. the d=1 facade on Kepler long-cadence photometry (examples/
     lightcurve.py's series at the real 29.4-min cadence, n=63 480; SE
     l=0.0015, eps 1e-4 -> mtot 919, rung 1031): EFGP, 50 Adam iterations,
     the mean and the stochastic variance at 5 000 points, with the
     example's assertions; the f32 gradient against float64 with the same
     probes at the starting hypers;
  9. the facade at the headline (bench.py:969-988): EFGP(x, y, "SE",
     sigmasq=0.01, eps=1e-6) and 20 Adam iterations, warmed on the same
     trajectory, against a float64 run of that trajectory;
 10. the scale configuration (bench.py:441-603: n=1e6, SE l=0.006 ->
     mtot 339, M 114 921) with kron and smooth FFT pads: fit + mean at
     2 000 targets, the stochastic variance (256 probes, 1 000 targets),
     the gradient and a 20-iteration fixed-plan Adam loop;
 11. ski, the SKI baseline at the size gpquad timed its interpolation
     kernels (pallas_interp.py:21-25, scripts/time_ski_interp.py): n=2e5
     points in [-1,1]^2, SE, grid 512^2 (516^2 extended, 65 bands of cap
     4200): fit_ski_gp with gpquad's defaults and 20 Adam iterations (50
     cut to 20), the mean at 10 000 targets and the variance at 64, with
     the kernels' launches per stage (the mean launches W^T alpha alone:
     its W_* g is a gather on the targets' stencils, as gpquad's); the
     mean's time beside that of a band plan for the targets; the loss and
     gradient at the starting hypers, float32 on the kernels and on the
     plain path against float64 on the plain path with the same probes,
     and the mean and variance at the learned hypers against float64, the
     mean's bar checked against a control with bfloat16-rounded
     interpolation weights;
 11b. examples/temperature_map.py's flow on data/frozen_raster_v1.npz:
     the EFGP facade (15 Adam iterations) and fit_ski_gp (4096 grid
     points, 15 iterations) in float32, with the example's assertions;
 12. the exact variances and the high-precision tier, each call warmed and
     then timed with the launch counts (by kernel, precision and mtot) set
     to 0 just before it: at the headline (phase 4's data) fit_high +
     predict_mean_high, gradient_high with seeded probes, variance_high at
     512 targets and fit_predict_grad_high (host clock and CUDA events),
     predict_var "regular" at all 10 000 targets and "chebyshev" with
     automatic nodes on phase 4's float32 fit and on a float64 fit, and
     the float64 gradient on that fit; at hard (phase 5's data, bench.py:
     270-310) the matrix-free fit_high with deflation 2048, gradient_high
     and variance_high at 256 targets (rank 4096, 4 passes, ir_tol 1e-4);
     Matérn-3/2 (bench.py:645-740: n 2e4, l 0.14, eps 1e-4 -> mtot 93) the
     float32 CG fit and mean, fit_high and gradient_high; at scale (phase
     10's data, n 1e6, mtot 339) fit_high with deflation 2048 and the mean
     at 500 targets; 12e hard3d (phase 7's data, bench.py:416-436 as
     written) fit_high with deflation 2048 and predict_mean_high(slab=256)
     at 1 000 targets.  Each is held against the port's float64 oracles
     (gpquad_torch/utils/f64_oracles.py, on the plain path: dense LU, or a
     float64 Toeplitz PCG at scale and hard3d): the high means within 1e-6
     absolute, gradient_high and variance_high within 1e-6 relative, the
     float32 exact variances within 1e-4 absolute of the float64
     "regular".  The high tier's NUFFTs are all float64 CUDA launches (rows
     1-4, 7-10 of PERF.md's table each at least once), none takes the
     plain path, and it prints a float64 row (kernel, plain and bound ms)
     for every float64 NUFFT shape it launched.
 13. the Polya-Gamma estimators: 13a scripts/pg_scale.py's classifier
     (n=1e5 in [-1,1]^2, labels from sample_bernoulli_gp_spectral as the
     script draws them, l 0.3 at the start -> mtot 21, lag grid 41; 13b's
     from random Fourier features at its positive fraction), the main path
     fit -> predict_proba on examples/classification.py's 30x30 grid -> the
     exact (dense), stochastic and chebyshev variances at 10 000 targets,
     with the counts set to 0 just before it (TPU rows 1, 2, 9 and 10 each
     launched, no plain path), its ms an outer iteration (CUDA events) and
     one profiled iteration; the float64 fit with the same probes (hypers
     and labels against the float32 fit), the float32 core on that fit's
     state against float64 (E-step mean, M-step gradient, the three
     variances), predict_latent_high against the float64 oracles; 13b the
     spatial-transcriptomics plan (n 24 010, l 0.1 at the start -> mtot 43,
     float64 as its script runs), its exact variance dense and by the
     batched PCG; 13c examples/negative_binomial.py at n=1e5, fixed r and
     then r learned (float32 against float64 with the same probes); 13d
     scripts/verify_pg_high.py's SE and Matérn-3/2 configurations
     (pg_predict_high against the float64 oracles); then each (kernel,
     precision, n, mtot, B) shape it launched, held against its plain
     version and timed beside it and its bound, every one a row of
     PERF.md's table (PG_SHAPES).
 14. the spreading NUFFT backends and the samplers: 14a each backend
     ("spread" at d=2, "banded" and "sub" at d=2 and d=3) and type against
     the exact kernels in float64 on the same inputs (the float32 exact
     kernel's own error beside it) at the scale configuration's
     shapes (n 1e6 at mtot 339 and 677, B 5 at 339) and d3's (n 1e5 at
     mtot 31 and 61), float32 within 1e-5 and "banded" in float64 at 339
     within 1e-6 of max|ref|, with the warm and first-call CUDA-event ms
     beside the exact kernel's, the peak memory and equal bits over two
     calls ("banded", "sub"); the adjoint identity and the NaN of a cap too
     small; 14b the scale configuration on nufft_method="banded" as phase
     10 runs it (caps planned on the host, fit + mean, the gradient with
     phase 10's probes, the 20-step Adam loop, one profiled step) beside
     phase 10's numbers: the mean within 5e-4 of phase 10's float64 fit,
     the gradient within 1e-2 of phase 10's; 14c the samplers:
     examples/sampling.py's 1-D flow, 64 spectral draws at n 1e5 (d=2),
     13a's float32 M-step gradient on pg_scale's labels of a second seed
     on the kernels and on the plain path beside the two terms it is the
     difference of (the kernels' error within 1e-4 of the larger),
     tests/test_sampling.py's covariance and pathwise checks at their
     sizes, and the pathwise sampler on the headline state (16 draws at
     10 000 targets at the CG's default cap and with room to converge,
     its iterations and residual, each set's mean within 5 standard
     errors of predict_mean); then each shape 14c launched, held against
     its plain version and timed beside it and its bound, every one a row
     of PERF.md's table (SAMPLER_SHAPES).
 15. the utilities: 15a traces (gpquad_torch.utils.profiling.trace) of
     phase 4's fused call, phase 5's kron CG fit and mean and one
     light-curve Adam iteration, read back: the scopes gpquad names
     (nufft_type1, nufft_type2, toeplitz_matvec, and 4_solve_cg or
     7_batch_cg_solve) each entered with a CUDA kernel launched inside it;
     a StageTimer table of the headline's fit, mean, variance and
     gradient; the host cost of a scope with no profiler, times the
     scope entries of the fused call and of the light-curve iteration,
     under 1% of each path's wall time; 15b phase 9's facade saved with
     save_efgp and restored into a fresh EFGP (another sigmasq): the raw
     hypers equal, predict (mean and stochastic variance) the same bits,
     one more Adam step, and the checkpoint restored on the CPU; 15c
     native/libgpquad_native.so built, the float64 nufft1_2d and
     nufft2_2d at n 2e4, mtot 29 within 1e-10 of max|ref| of its C++
     direct sums; 15d load_synthetic_gp(n=1e5, d=2) twice, the same bits,
     x numpy's draw, each shape it launched held against its plain
     version (LOADER_SHAPES).
Phase 3 also holds the two d=3 kernels at every shape of phases 6 and 7
and at mtot 57, 101 and 255, the two d=1 kernels at phase 8's shapes and
at mtot 8191, and the two SKI interpolation kernels at phase 11's band
tables (B 1, 3, 8 and 64) and the raster's (B 1, 3 and 8), with the
column-sorted index's bytes; both bit for bit against a second launch and
their plain twins (interp_T_2d's column-sorted walk, interp_2d's
point-order sum); interp_2d from the grid to point order, its band-slot
API bit for bit against interp_2d_ref, the whole SKIOperator.interp one
launch of it, timed with the host's enqueue and on the card beside the
library call (the unbanded gather).  Phase 10 prints its ms per Adam
step and the launches of its gradient and Adam loop; phase 11 its ms per
Adam iteration and, beside the f32 variance, the f32 plain path's and the
bfloat16-weight control's.

It prints each phase's wall time, the kernels' JSON line (the eight NUFFT
kernels, the four TPU mode-tiled functions they cover, with the launches
made past the TPU's single-block width, and the two interpolation kernels:
all 14 TPU functions), then the card's nvidia-smi line, then
``{"ok": true, "device": ...}`` as the last line, and writes the full
record to build/chip_smoke.json.  Without a CUDA device, or without the
package beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, fp64 outside the tensor cores, dense TF32 on the tensor cores, HBM3
# bandwidth.
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
# the float32 type-1 on the tensor cores (d=2, and d=1 on a split of its
# mode index): three TF32 products (the 3xTF32 split) per real product, 8
# flops per point, output and vector each
TC_TYPE1 = ("nufft1_2d", "nufft1_2d_batched", "nufft1_1d")
# One phase e^{i 2 pi c} counted at its least cost: a rotation recurrence
# along the modes (one complex multiply, 6 flops) re-anchored every 32 modes
# by an exact sin/cos pair (20 flops: the 10 multiply-adds of the minimax
# pair the TPU kernel evaluates, pallas_nufft.py:61-77).
PHASE_FLOPS = 6 + 20 / 32

REPLACES = {"nufft1_1d": "gpquad/ops/pallas_nufft.py:584",
            "nufft2_1d": "gpquad/ops/pallas_nufft.py:549",
            "nufft1_2d": "gpquad/ops/pallas_nufft.py:195",
            "nufft2_2d": "gpquad/ops/pallas_nufft.py:113",
            "nufft1_2d_batched": "gpquad/ops/pallas_nufft.py:914",
            "nufft2_2d_batched": "gpquad/ops/pallas_nufft.py:838",
            # one kernel per type covers the single-block (mtot <= 56) and
            # the slab-tiled (:1118, :1034) TPU functions
            "nufft1_3d": "gpquad/ops/pallas_nufft.py:750",
            "nufft2_3d": "gpquad/ops/pallas_nufft.py:662",
            # SKI's d=2 interpolation (gpquad_torch/ops/cuda_interp.py)
            "interp_T_2d": "gpquad/ops/pallas_interp.py:104",
            "interp_2d": "gpquad/ops/pallas_interp.py:237"}
KERNELS_INTERP = ("interp_T_2d", "interp_2d")
KERNELS_NUFFT = tuple(k for k in REPLACES if k not in KERNELS_INTERP)
KERNELS_2D = ("nufft1_2d", "nufft2_2d", "nufft1_2d_batched",
              "nufft2_2d_batched")
KERNELS_3D = ("nufft1_3d", "nufft2_3d")
KERNELS_1D = ("nufft1_1d", "nufft2_1d")
SINGLE = ("nufft1_2d", "nufft2_2d")
# bench.py's settings for the fused call (bench.py:870-875)
FUSED_KW = dict(trace_samples=10, var_probes=256, cg_tol=1e-6,
                var_cg_tol=1e-4, grad_cg_tol=1e-4, max_cg_iter=1000,
                var_max_cg_iter=400)
# d3 runs them with the variance's PCG allowed to converge: its Jacobi
# solves need ~2100 iterations at 1e-4, and at 400 no probe converges (phase
# 6 measures both), so the answer there is an unconverged iterate
D3_VAR_MAX_CG_ITER = 3000
FUSED3_KW = dict(FUSED_KW, var_max_cg_iter=D3_VAR_MAX_CG_ITER)
# examples/lightcurve.py: the gaps (days), the noise, the model and its loop
LC_GAPS = ((330, 360), (700, 745), (1050, 1080))
LC_NOISE = 5e-4
LC_OPT = dict(max_iters=50, lr=0.05, trace_samples=1, cg_tol=1e-6,
              noise_floor=1e-4, min_lengthscale=2e-4)
# How much slower than the fastest path measured at a shape the single d=2
# type-2's pick may be in phase 3, relative and in ms, whichever is larger:
# device times of one shape spread by up to 4% between runs (PERF.md
# section 2), and by a microsecond or two for calls of ten; paths that tie
# do not flip the check
DISPATCH_TIE = (0.03, 0.002)
# The card's sleep before a trial of calls timed with the host ahead
# (time_cuda_paths): ~18 ms at the H100's 1.98 GHz boost clock, beyond what the
# host takes to enqueue 50 of the single type-2's calls (~0.05 ms each on
# the slowest host seen); the phase 3 times of the paths are the card's, so
# that a call of tens of microseconds, which is mostly its launches on the
# host, does not decide the path by how busy the host was
HOST_AHEAD_CYCLES = 35_000_000
# rounds of the single type-2's paths in phase 3 (time_cuda_paths), of
# which the median is kept: one slow round of one path, seen once in
# scripts/time_type2_single.py's sweeps, does not decide its order
PATH_TRIALS = 7
# PCG iteration bar of the Kronecker preconditioner (gpquad: 12 on the hard
# configuration, 14 at scale; Jacobi 376-393 and 306)
KRON_MAX_ITERS = 60
# phase 11: gpquad's interpolation timing size (scripts/time_ski_interp.py:
# 31-33) and fit_ski_gp's defaults, 20 Adam iterations instead of 50
SKI_N, SKI_GRID, SKI_ITERS = 200_000, 512, 20
SKI_TARGETS, SKI_VAR_TARGETS = 10_000, 64
SKI_BATCHES = (1, 3, 8, SKI_VAR_TARGETS)
RASTER_BATCHES = (1, 3, 8)
# the float32 mean's bar against float64 at phase 11: the f32 solve of a
# system of condition ~1e7 leaves 2.0e-3 on the kernels and 2.4e-3-3.6e-3 on
# the plain path (its index_add_ atomics reorder its sums between runs);
# bfloat16-rounded interpolation weights must read above it
SKI_MEAN_BAR = 4e-3
# per slot and vector: W^T u 4 products w_row u, then 16 multiply-adds by
# w_col; W v 16 multiply-adds over the stencil and 4 by w_col
INTERP_FLOPS = {"interp_T_2d": 36, "interp_2d": 40}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def sync():
    torch.cuda.synchronize()


def source_of(name):
    if name in KERNELS_INTERP:
        return "gpquad_torch/csrc/interp_2d.cu"
    return f"gpquad_torch/csrc/nufft_{name.split('_')[1]}.cu"


def time_cuda(fn, reps, trials=5, warm=2):
    """Median over ``trials`` of the CUDA-event time of ``reps`` calls (ms
    per call), after ``warm`` warm calls."""
    for _ in range(warm):
        fn()
    sync()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        sync()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def time_cuda_paths(fns, reps, trials=5):
    """The card's time a call (ms) of each function in ``fns`` (a dict):
    the median over ``trials`` rounds of the CUDA-event time of ``reps``
    calls, after two warm calls of each.  Before each timed run the card
    sleeps for HOST_AHEAD_CYCLES, so that the host has enqueued the calls
    before the first one starts: the time is the card's alone, not the
    host's enqueue of calls shorter than their launches.  Each round times
    every function in turn, so that a drift of the card's clock over the
    rounds falls on all of them alike."""
    for fn in fns.values():
        fn()
        fn()
    sync()
    times = {r: [] for r in fns}
    for _ in range(trials):
        for r, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(HOST_AHEAD_CYCLES)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            sync()
            times[r].append(start.elapsed_time(end) / reps)
    return {r: statistics.median(t) for r, t in times.items()}


def profile_run(fn, top=8):
    """Run ``fn`` once under torch.profiler: host wall time, device busy
    time (union of the intervals of the kernels and memory copies on the
    device), idle share, and the kernels with the most device time.  The
    device spans of ``record_function`` scopes (the port's own, as
    ``profiling.stage`` opens them, and torch's) are left out: each runs
    from the first kernel inside it to the last and so covers the idle gaps
    between them.  Device numbers are None when the profiler saw no CUDA
    kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from gpquad_torch.utils import profiling
    scopes = set(SCOPES) | set(profiling.STAGES)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.name in scopes):
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        by_name[e.name] = by_name.get(e.name, 0.0) + (end - start) / 1e3
    if not spans:
        return dict(wall_ms=wall_ms, busy_ms=None, idle_share=None, top=[])
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy_ms = (busy + cur_e - cur_s) / 1e3
    own_ms = sum(by_name.values())
    assert busy_ms <= own_ms * (1 + 1e-9) + 1e-6, (
        f"device busy {busy_ms} ms exceeds the kernels' own {own_ms} ms")
    assert busy_ms <= wall_ms, (
        f"device busy {busy_ms} ms exceeds the wall time {wall_ms} ms")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / wall_ms,
                top=[(name[:90], ms) for name, ms in ranked])


def print_profile(tag, prof, card):
    if prof["busy_ms"] is None:
        print(f"{tag} wall {prof['wall_ms']:.2f} ms; device time not "
              f"measured (the profiler saw no CUDA event) {card}")
        return
    print(f"{tag} wall {prof['wall_ms']:.2f} ms, device busy "
          f"{prof['busy_ms']:.2f} ms, idle share {prof['idle_share']:.3f} "
          f"{card}")
    for name, ms in prof["top"]:
        print(f"{tag}   {ms:8.3f} ms  {name}")


def kernel_work(name, n, m, dtype, B=1):
    """(flops, bytes) the function needs for B vectors (B = 1 for the single
    kernels), d = 1, 2 or 3 from the name.  Per point and vector: mtot^d
    complex multiply-adds at 8 flops; then the outer axes' products,
    multiply-adds at 8 flops for type-2 (mtot^(d-1) + ... + mtot of them:
    sum_j e1 t_j, and at d=3 sum_k e2 t_jk; none at d=1) and plain complex
    multiplies at 6 for type-1 (at d=3 the mtot^2 products (v e1) e2; the
    mtot products v e1).  Phases at PHASE_FLOPS once per point, dimension
    and mode, also for a batch; the points, the B inputs and the B outputs
    read or written once."""
    d = int(name.split("_")[1][0])
    s = 4 if dtype == torch.float32 else 8
    phases = d * n * m * PHASE_FLOPS
    outer = 8 if name.startswith("nufft2") else 6
    outer_products = sum(m ** k for k in range(1, d))
    flops = B * n * (8 * m ** d + outer * outer_products) + phases
    nbytes = d * n * s + B * (2 * m ** d * s + 2 * n * s)
    return flops, nbytes


def interp_work(name, nbands, G1, G2, dtype, B, listed):
    """(flops, bytes) of an interpolation kernel on a band plan, at
    INTERP_FLOPS a slot and vector, over the ``listed`` slots of the column
    index (the valid ones, one a point); bytes of their tables (three int32
    and eight weights a slot), the B inputs read once and the B outputs
    written once.  W^T u reads the slots' values and the index itself (a
    slot number each, G2 + 1 column starts a band) and writes the band
    slabs; W v reads the G1 x G2 grid and its tables' point of each slot
    and writes the points."""
    s = 4 if dtype == torch.float32 else 8
    tables = listed * (3 * 4 + 8 * s)
    if name == "interp_T_2d":
        tables += nbands * (G2 + 1) * 4
        io = B * listed * s + nbands * B * 11 * G2 * s
    else:
        io = B * G1 * G2 * s + B * listed * s
    return INTERP_FLOPS[name] * B * listed, tables + io


def bound_ms(name, n, m, dtype, B=1, work=None):
    flops, nbytes = work or kernel_work(name, n, m, dtype, B)
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bound_3xtf32_ms(name, n, m, B=1, split=None):
    """A float32 kernel's bound on the tensor cores (the type-1 at d=1, 2
    and 3, the d=2 type-2's tensor-core kernel, batched or at B 1 for the
    single, and the d=1 and d=3 type-2's): 3 x 8 flops per point, mode
    (pair or triple) and vector at the dense TF32 rate, plus the rest of
    kernel_work's operations (the phases, once per point, dimension and
    mode, and the products v e1 or e1 T) at the fp32 rate; against its
    bytes.  The d=3 type-2 contracts the pairs (j2, j3) in the GEMM, so its
    rest is the phases, the mtot^2 products e2 e3 once a point (6 flops)
    and the epilogue's mtot multiply-adds e1 T a point and vector (8).  At
    d=1 ``split`` = (K, Q) of the mode split k = K q + r
    (cuda_nufft.type1_1d_split) sets the rest: K + Q phases a point, and
    the K products a point and vector (the type-1's v e^{-2 pi i r t}, 6
    flops; the type-2's epilogue multiply-adds e^{+2 pi i r t} T, 8)."""
    d = int(name.split("_")[1][0])
    flops, nbytes = kernel_work(name, n, m, torch.float32, B)
    tc = 3 * 8 * B * n * m ** d
    rest = flops - 8 * B * n * m ** d
    if name == "nufft2_3d":
        rest = d * n * m * PHASE_FLOPS + 6 * n * m ** 2 + 8 * B * n * m
    if split is not None:
        K, Q = split
        outer = 8 if name.startswith("nufft2") else 6
        rest = n * (K + Q) * PHASE_FLOPS + outer * B * n * K
    t_ops = (tc / PEAK_TF32 + rest / PEAK_FLOPS[torch.float32]) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bound_split_ms(n, m, dtype, rows):
    """The single type-2's bound on its mode split: kernel_work's, plus the
    slabs' partials (ceil(m / rows) x n values written once and read once)
    and their sum (a complex add a partial)."""
    flops, nbytes = kernel_work("nufft2_2d", n, m, dtype)
    slabs = -(-m // rows)
    s = 4 if dtype == torch.float32 else 8
    return bound_ms("nufft2_2d", n, m, dtype, work=(
        flops + 2 * slabs * n, nbytes + 2 * slabs * n * 2 * s))


# The TPU's mode-tiled functions (rows 3, 4, 11, 12 of PERF.md's table): the
# port's kernel that covers each, and the widest grid the TPU's single-block
# function takes
TILED = {"_pallas_nufft2_2d_tiled": ("nufft2_2d",
                                     "gpquad/ops/pallas_nufft.py:369", 256),
         "_pallas_nufft1_2d_tiled": ("nufft1_2d",
                                     "gpquad/ops/pallas_nufft.py:442", 256),
         "_pallas_nufft2_3d_tiled": ("nufft2_3d",
                                     "gpquad/ops/pallas_nufft.py:1034", 56),
         "_pallas_nufft1_3d_tiled": ("nufft1_3d",
                                     "gpquad/ops/pallas_nufft.py:1118", 56)}


def tiled_counts(widths):
    """Per TPU mode-tiled function, the launches in ``widths`` (the
    wrappers' LAUNCH_WIDTHS: launches by kernel and mtot since the last
    reset) of the kernel that covers it at mode widths past that function's
    single-block limit (at d=2 a batched launch too: gpquad maps the tiled
    function over a batch that wide)."""
    counts = {}
    for row, (kernel, _, limit) in TILED.items():
        names = (kernel, kernel + "_batched") if "_2d" in kernel else (kernel,)
        counts[row] = sum(c for (name, m), c in widths.items()
                          if name in names and m > limit)
    return counts


def reset_counts(*counters):
    for counter in counters:
        for k in counter:
            counter[k] = 0


def headline_data(n, targets, seed=0):
    """bench.py:836-845: points, targets and y from numpy seed 0."""
    rng = np.random.default_rng(seed)
    xh = rng.uniform(0, 1, size=(n, 2))
    fh = (np.sin(3 * np.pi * xh[:, 0]) * np.cos(2 * np.pi * xh[:, 1])
          + 0.5 * np.sin(7 * xh[:, 0] + 5 * xh[:, 1]))
    yh = fh + 0.1 * rng.normal(size=n)
    xnew = rng.uniform(0, 1, size=(targets, 2))
    return xh, yh, xnew


def scale_data(n, seed=10):
    """Phase 10's data (bench.py:441-470, the scale configuration): points
    uniform in [0,1]^2, the headline's field plus noise of sd 0.1, then
    2 000 targets, from numpy seed ``seed``."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0, 1, size=(n, 2))
    ys = (np.sin(3 * np.pi * xs[:, 0]) * np.cos(2 * np.pi * xs[:, 1])
          + 0.5 * np.sin(7 * xs[:, 0] + 5 * xs[:, 1])
          + 0.1 * rng.normal(size=n))
    return xs, ys, rng.uniform(0, 1, size=(2000, 2))


def data_3d(n, targets, seed):
    """bench.py:378-381 (hard3d_config): points uniform in [0,1]^3,
    y = sin(3 pi x0) cos(2 pi x1) cos(pi x2) + 0.1 N(0,1), then the targets,
    from numpy seed ``seed``."""
    rng = np.random.default_rng(seed)
    xh = rng.uniform(0, 1, size=(n, 3))
    fh = (np.sin(3 * np.pi * xh[:, 0]) * np.cos(2 * np.pi * xh[:, 1])
          * np.cos(np.pi * xh[:, 2]))
    yh = fh + 0.1 * rng.normal(size=n)
    xnew = rng.uniform(0, 1, size=(targets, 3))
    return xh, yh, xnew


def lightcurve_data(seed=7):
    """examples/lightcurve.py:44-73 at the real 29.4-min Kepler long
    cadence (the example thins it to 0.49 d): a quasi-periodic spot signal
    (rotation 12.26 d), three downlink gaps, noise 5e-4; t and flux
    normalised as the example does them."""
    rng = np.random.default_rng(seed)
    t_all = np.arange(0.0, 1400.0, 0.0204)
    P = 12.26
    amp = 1.0 + 0.35 * np.sin(2 * np.pi * t_all / 290.0)
    phase = 0.25 * np.sin(2 * np.pi * t_all / 410.0)
    f_full = (0.01 * amp * np.sin(2 * np.pi * (t_all / P + phase))
              + 0.004 * np.sin(4 * np.pi * (t_all / P + phase) + 0.7))
    keep = np.ones(len(t_all), bool)
    for lo, hi in LC_GAPS:
        keep &= ~((t_all > lo) & (t_all < hi))
    t = t_all[keep]
    y_raw = 1.0 + f_full[keep] + LC_NOISE * rng.normal(size=len(t))
    x = (t - t.min()) / (t.max() - t.min())
    y_mean, y_std = y_raw.mean(), y_raw.std()
    return dict(t_all=t_all, f_full=f_full, t=t, x=x,
                y=(y_raw - y_mean) / y_std, y_mean=y_mean, y_std=y_std,
                period=P)


def ski_data(n, targets, seed=0):
    """Phase 11's data: points uniform in [-1,1]^2 as
    scripts/time_ski_interp.py draws them, y a smooth field plus noise of sd
    0.1, then the targets, from numpy seed ``seed``."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(n, 2))
    f = (np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1])
         + 0.5 * np.sin(2 * x[:, 0] + 3 * x[:, 1]))
    y = f + 0.1 * rng.normal(size=n)
    xq = rng.uniform(-1, 1, size=(targets, 2))
    return x, y, xq


def launch_counts(**nonzero):
    """The LAUNCHES dict a path should leave: every kernel 0 but those
    named."""
    return {k: nonzero.get(k, 0) for k in KERNELS_NUFFT}


# phase 12: the exact variances and the high-precision tier (bench.py's
# headline :836-975, hard :270-310, Matérn :645-740 and scale :609-620)
HIGH_MEAN_BAR = 1e-6        # absolute, against the float64 oracle
HIGH_REL_BAR = 1e-6         # gradient_high and variance_high, relative
VAR_ABS_BAR = 1e-4          # the f32 regular and chebyshev variances
# BENCH_r05's rel_err_var_cheb (2.1e-4 of max|var|, ROADMAP A.1)
CHEB_REL_BAR = 2.1e-4
HIGH_RANK = 2048            # bench.py --hard-precond-rank
STAGE_CALLS = 3             # timed calls of each phase 12 item (median)
MATERN_N, MATERN_L, MATERN_EPS, MATERN_TARGETS = 20_000, 0.14, 1e-4, 1_000
# the float64 functions phase 12 launches, by PERF.md's table rows: the
# kernel, and whether the launch is past the TPU's single-block width (None:
# either); d=3 from 12e, hard3d's mtot 21 and lag grid 41, both within it
ROWS_F64 = {"1": ("nufft2_2d", False), "3": ("nufft2_2d", True),
            "2": ("nufft1_2d", False), "4": ("nufft1_2d", True),
            "9": ("nufft2_2d_batched", None),
            "10": ("nufft1_2d_batched", None),
            "7": ("nufft2_3d", False), "8": ("nufft1_3d", False)}
# the TPU's single-block width of each kernel's function (TILED's limits)
BLOCK_LIMIT = {kernel: limit for kernel, _, limit in TILED.values()}


def matern_data(n, targets, seed=12):
    """bench.py:664-670 (matern_config): points uniform in [0,1]^2, the
    headline's field plus noise of sd 0.1, then the targets, from numpy
    seed ``seed``."""
    rng = np.random.default_rng(seed)
    xh = rng.uniform(0, 1, size=(n, 2))
    fh = (np.sin(3 * np.pi * xh[:, 0]) * np.cos(2 * np.pi * xh[:, 1])
          + 0.5 * np.sin(7 * xh[:, 0] + 5 * xh[:, 1]))
    yh = fh + 0.1 * rng.normal(size=n)
    return xh, yh, rng.uniform(0, 1, size=(targets, 2))


def rademacher(seed, T, n, M, device):
    """(Z, V): +-1 probes of shapes (T, n) and (T, M) from numpy seed
    ``seed`` (bench.py draws them so, :908-913)."""
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.integers(0, 2, (T, k)) * 2.0 - 1,
                                 dtype=torch.float32, device=device)
                 for k in (n, M))


def precision_counts(counter, prec=None):
    """{kernel: launches} of one precision ("f32" / "f64", or both) in
    ``LAUNCH_PRECISIONS``."""
    out = {}
    for (name, p, _), c in counter.items():
        if c and (prec is None or p == prec):
            out[name] = out.get(name, 0) + c
    return out


def phase_high(c):
    """Phase 12.  ``c``: a namespace of main()'s dev, card, counters,
    gpquad_torch and its modules, phase 3's rows and plain versions, and
    the headline, hard and scale configurations.  Returns the phase's
    record."""
    gt, orc, nm, cn = c.gt, c.orc, c.nufft_mod, c.cuda_nufft
    dev, card, sig = c.dev, c.card, c.sigmasq
    rec = {"f64_launches": {}}
    totals = {}                     # (name, precision, mtot) -> launches

    def stage(tag, fn, *, all_f64=True):
        """One warm call, then STAGE_CALLS timed calls: ``ms`` is the median
        of their CUDA-event times, ``host_ms`` the first one's host clock.
        The counts are set to 0 just before the first and read just after
        it."""
        fn()
        sync()
        times = []
        for i in range(STAGE_CALLS):
            if i == 0:
                reset_counts(*c.counters)
                t = time.perf_counter()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            r = fn()
            end.record()
            sync()
            times.append(start.elapsed_time(end))
            if i == 0:
                host_ms = (time.perf_counter() - t) * 1e3
                prec = dict(cn.LAUNCH_PRECISIONS)
                picks = dict(nm.BACKEND_PICKS)
        ms = statistics.median(times)
        check(picks["matmul"] == 0, f"{tag}: the plain path was taken {picks}")
        if all_f64:
            check(not precision_counts(prec, "f32"),
                  f"{tag}: float32 NUFFTs launched {precision_counts(prec)}")
        for key, n_ in prec.items():
            if n_:
                totals[key] = totals.get(key, 0) + n_
        info = dict(ms=ms, host_ms=host_ms, cuda_ms_calls=times,
                    f32=precision_counts(prec, "f32"),
                    f64=precision_counts(prec, "f64"),
                    f64_widths={f"{k}@{m}": n_ for (k, p, m), n_ in
                                sorted(prec.items()) if n_ and p == "f64"},
                    picks=picks)
        print(f"[12] {tag}: {ms:.2f} ms (CUDA events, median of "
              f"{STAGE_CALLS} warm calls {[round(t_, 2) for t_ in times]}; "
              f"host clock of the first {host_ms:.2f}) {card}; float64 "
              f"launches {info['f64']} (by mtot {info['f64_widths']}), "
              f"float32 {info['f32']}; backend_picks={picks}")
        return r, info

    def rel_max(got, want):
        return float(((got.double() - want).abs() / want.abs()).max())

    def high_config(tag, x, y, xq, kern, h, mtot, *, fit_kw, mean_kw=None,
                    probes=None, grad_kw=None, var_x=None, var_kw=None,
                    oracle="dense", oracle_maxiter=8000):
        """fit_high + mean, gradient_high and variance_high in turn, each a
        stage, then the float64 oracle on the plain path and the bars."""
        out = {}
        (hs, mh), out["fit_high+mean"] = stage(
            f"{tag} fit_high + predict_mean_high", lambda: (
                lambda hs_: (hs_, gt.predict_mean_high(
                    hs_, xq, **(mean_kw or {}))))(
                gt.fit_high(x, y, kern, sig, h, mtot, device=dev, **fit_kw)))
        out["residual"] = float(hs.residual)
        out["inner_iters"] = int(hs.state.mean_cg_iters)
        gh = vh = None
        if probes is not None:
            gh, out["gradient_high"] = stage(
                f"{tag} gradient_high", lambda: gt.gradient_high(
                    x, y, kern, sig, h, mtot, probes=probes, device=dev,
                    **(grad_kw or {})))
        if var_x is not None:
            vh, out["variance_high"] = stage(
                f"{tag} variance_high ({len(var_x)} targets)",
                lambda: gt.variance_high(x, kern, sig, h, mtot, var_x,
                                         device=dev, **(var_kw or {})))
        t = time.perf_counter()
        obj = None
        if oracle == "dense":
            obj = orc.efgp_f64_objects_kernel(x, y, kern, sig, h, mtot,
                                              device=dev)
            mean64 = orc.mean_f64(obj, xq)
        else:
            mean64, iters, res = orc.toeplitz_cg_oracle_f64(
                x, y, kern, sig, h, mtot, xq, tol=1e-10,
                maxiter=oracle_maxiter, device=dev)
            out["oracle_cg_iters"], out["oracle_residual"] = iters, res
        out["err_mean_high"] = float((mh - mean64).abs().max())
        line = (f"[12] {tag} vs the float64 oracle ({oracle}, plain path): "
                f"mean_high max abs err {out['err_mean_high']:.3e} (bar "
                f"{HIGH_MEAN_BAR:.0e}), fit_high + mean "
                f"{out['fit_high+mean']['ms']:.2f} ms (CUDA events, median "
                f"of {STAGE_CALLS}), refit residual {out['residual']:.3e}"
                f", inner iterations {out['inner_iters']}")
        if oracle != "dense":
            line += (f", oracle PCG iterations {out['oracle_cg_iters']} "
                     f"(residual {float(out['oracle_residual']):.3e})")
        check(out["err_mean_high"] <= HIGH_MEAN_BAR,
              f"{tag}: high mean error {out['err_mean_high']:.3e}")
        if gh is not None:
            g64 = orc.gradient_f64(obj, *probes)
            out["grad_high_rel_err"] = rel_max(gh.grad, g64)
            out["grad_high"], out["grad_f64"] = gh.grad.tolist(), \
                g64.tolist()
            line += (f"; gradient_high rel err {out['grad_high_rel_err']:.3e}"
                     f" (bar {HIGH_REL_BAR:.0e}) {gh.grad.tolist()}")
            check(out["grad_high_rel_err"] <= HIGH_REL_BAR,
                  f"{tag}: gradient_high error {out['grad_high_rel_err']}")
        if vh is not None:
            out["var_high_rel_err"] = rel_max(vh, orc.regular_var_f64(
                obj, var_x))
            line += (f"; variance_high rel err {out['var_high_rel_err']:.3e}"
                     f" (bar {HIGH_REL_BAR:.0e})")
            check(out["var_high_rel_err"] <= HIGH_REL_BAR,
                  f"{tag}: variance_high error {out['var_high_rel_err']}")
        out["oracle_s"] = time.perf_counter() - t
        print(line + f"; oracle {out['oracle_s']:.1f} s {card}")
        return out, obj, mean64

    T = FUSED_KW["trace_samples"]

    # 12a: the headline (phase 4's data, the dense tier)
    x, y, xq, kern = c.x32, c.y32, c.xq32, c.kernel32
    h, mtot = c.h_head, c.mtot_head
    probes = rademacher(12, T, x.shape[0], mtot ** 2, dev)
    head, obj, mean64 = high_config(
        "headline", x, y, xq, kern, h, mtot, fit_kw={}, probes=probes,
        var_x=xq[:512], var_kw=dict(slab=256))

    def fpgh():
        return gt.fit_predict_grad_high(
            x, y, xq, kern, sig, h, torch.Generator(device=dev).manual_seed(0),
            mtot=mtot, device=dev, **FUSED_KW)
    fres, head["fit_predict_grad_high"] = stage(
        "headline fit_predict_grad_high", fpgh, all_f64=False)
    info = head["fit_predict_grad_high"]
    # the fused f32 pass as phase 4's, then the refit's F*y and lag table
    # and the float64 mean
    check(info["f32"] == {"nufft1_2d": 3, "nufft2_2d": 3,
                          "nufft1_2d_batched": 1, "nufft2_2d_batched": 2}
          and info["f64"] == {"nufft1_2d": 2, "nufft2_2d": 1},
          f"fit_predict_grad_high launches {info}")
    head["fpgh_cuda_event_ms"] = info["ms"]
    head["fpgh_err_mean_high"] = float((fres.mean_high - mean64).abs().max())
    head["fpgh_err_mean_f32"] = float((fres.fused.mean.double()
                                       - mean64).abs().max())
    print(f"[12] headline fit_predict_grad_high: {info['host_ms']:.2f} ms "
          f"host clock, {head['fpgh_cuda_event_ms']:.2f} ms CUDA events "
          f"(median of {STAGE_CALLS} warm calls) {card}; mean_high err "
          f"{head['fpgh_err_mean_high']:.3e} (bar {HIGH_MEAN_BAR:.0e}), the "
          f"f32 pass's mean {head['fpgh_err_mean_f32']:.3e} (bar 5e-4), "
          f"refit residual {float(fres.high_residual):.3e}")
    check(head["fpgh_err_mean_high"] <= HIGH_MEAN_BAR
          and head["fpgh_err_mean_f32"] <= 5e-4,
          "fit_predict_grad_high: mean errors over their bars")

    # the exact variances at all 10 000 targets: float32 on phase 4's fit,
    # float64 on a float64 fit (the kernels' float64 instances), against
    # the oracle's "regular"
    var64 = orc.regular_var_f64(obj, xq)
    scale64 = float(var64.abs().max())
    auto = c.efgp_mod._auto_chebyshev_nodes(c.st, xq)
    check(int(np.prod(auto)) < xq.shape[0],
          f"chebyshev: automatic nodes {auto} fall back to regular")
    st64, head["fit_f64"] = stage(
        "headline float64 fit on the kernels (cg_tol 1e-12)",
        lambda: gt.fit(x.double(), y.double(), kern, sig, eps=c.eps,
                       cg_tol=1e-12, device=dev))
    for state, prec in ((c.st, "f32"), (st64, "f64")):
        for method in ("regular", "chebyshev"):
            v, info = stage(
                f"headline predict_var {method} {prec} ({len(xq)} targets)",
                lambda: gt.predict_var(state, xq, method=method,
                                       cg_tol=1e-5, max_cg_iter=600),
                all_f64=False)
            check(not precision_counts(cn.LAUNCH_PRECISIONS),
                  f"predict_var {method} launched a NUFFT")
            err = float((v.double() - var64).abs().max())
            head[f"var_{method}_{prec}"] = dict(info, max_abs_err=err,
                                                rel_to_max=err / scale64)
            # float32: 1e-4 absolute and phase 4's 5e-2 of max|var64| (the
            # variance is ~4e-4 here, so the absolute bar alone is loose;
            # the f32 solve at condition ~6e5 sits at ~2e-3 of it)
            bar = (min(VAR_ABS_BAR, 5e-2 * scale64) if prec == "f32" else
                   (1e-8 * scale64 if method == "regular"
                    else CHEB_REL_BAR * scale64))
            print(f"[12] headline {method} {prec} vs the oracle's regular: "
                  f"max abs err {err:.3e} ({err / scale64:.3e} of max|var| "
                  f"{scale64:.3e}; bar {bar:.3e})"
                  + (f"; nodes {auto}" if method == "chebyshev" else ""))
            check(err <= bar, f"{method} {prec} variance error {err:.3e}")
    head["cheb_nodes"] = auto
    g64k, head["gradient_f64_kernels"] = stage(
        "headline gradient_with_grid float64 (state=float64 fit, cg_tol "
        "1e-10)", lambda: gt.gradient_with_grid(
            x.double(), y.double(), kern, sig, st64.h, mtot=st64.mtot,
            probes=probes, cg_tol=1e-10, state=st64, device=dev))
    g64 = orc.gradient_f64(obj, *probes)
    head["grad_f64_kernels_rel_err"] = rel_max(g64k.grad, g64)
    print(f"[12] headline float64 gradient on the kernels vs the oracle: rel "
          f"err {head['grad_f64_kernels_rel_err']:.3e} (bar "
          f"{HIGH_REL_BAR:.0e})")
    check(head["grad_f64_kernels_rel_err"] <= HIGH_REL_BAR,
          "float64 gradient on the kernels over its bar")
    rec["headline"] = head
    del obj, var64, st64
    torch.cuda.empty_cache()

    # 12b: hard (phase 5's data, mtot 107, the matrix-free refinement)
    x, y, xq = c.x2, c.y2, c.xq2
    probes = rademacher(13, T, x.shape[0], c.mtot_hard ** 2, dev)
    rank_var = min(2 * HIGH_RANK, c.mtot_hard ** 2)
    rec["hard"], obj, _ = high_config(
        "hard", x, y, xq, c.kern_hard, c.h_hard, c.mtot_hard,
        fit_kw=dict(solver="iterative", precond_rank=HIGH_RANK),
        probes=probes, grad_kw=dict(precond_rank=HIGH_RANK),
        var_x=xq[:256], var_kw=dict(precond_rank=rank_var, passes=4,
                                    ir_tol=1e-4))
    del obj
    torch.cuda.empty_cache()

    # 12c: Matérn-3/2 (bench.py:645-740): the f32 CG tier, then the high
    # tier
    xm, ym, xqm = matern_data(MATERN_N, MATERN_TARGETS)
    x = torch.as_tensor(xm, dtype=torch.float32, device=dev)
    y = torch.as_tensor(ym, dtype=torch.float32, device=dev)
    xq = torch.as_tensor(xqm, dtype=torch.float32, device=dev)
    kern = gt.make_kernel("Matern32", 2, lengthscale=np.float32(MATERN_L),
                          variance=np.float32(1.0))
    _, h, mtot = gt.spectral_grid(kern, MATERN_EPS, 1.0)
    check(mtot == 93, f"Matérn planned mtot {mtot}, not bench.py's 93")
    rank = min(HIGH_RANK, mtot ** 2)
    (sm, mm), f32_info = stage("matern f32 fit (CG, deflation) + mean",
                               lambda: (lambda s_: (s_, gt.predict_mean(
                                   s_, xq)))(gt.fit_with_grid(
                                       x, y, kern, sig, h, mtot, cg_tol=1e-6,
                                       max_cg_iter=2000, solver="cg",
                                       precond_rank=rank, device=dev)),
                               all_f64=False)
    check(f32_info["f32"] == {"nufft1_2d": 2, "nufft2_2d": 1}
          and not f32_info["f64"], f"Matérn f32 launches {f32_info}")
    probes = rademacher(14, T, x.shape[0], mtot ** 2, dev)
    mat, obj, mean64 = high_config(
        "matern", x, y, xq, kern, h, mtot,
        fit_kw=dict(solver="iterative", precond_rank=rank), probes=probes,
        grad_kw=dict(precond_rank=rank))
    mat["f32_fit_mean"] = f32_info
    mat["f32_cg_iters"] = int(sm.mean_cg_iters)
    mat["err_mean_f32"] = float((mm.double() - mean64).abs().max())
    print(f"[12] matern mtot {mtot} M {mtot ** 2}: f32 mean max abs err vs "
          f"the oracle {mat['err_mean_f32']:.3e} (bar 5e-4), PCG iterations "
          f"{mat['f32_cg_iters']}")
    check(mat["err_mean_f32"] <= 5e-4, "Matérn f32 mean over its bar")
    rec["matern"] = dict(mat, mtot=mtot, h=h)
    del obj, x, y, xq, sm
    torch.cuda.empty_cache()

    # 12d: scale (phase 10's data, n 1e6, mtot 339): the float64 type-1 at
    # 339 and 677; the oracle is a float64 Toeplitz PCG
    xs, ys, xqs = scale_data(c.n10)
    x = torch.as_tensor(xs, dtype=torch.float32, device=dev)
    y = torch.as_tensor(ys, dtype=torch.float32, device=dev)
    xq = torch.as_tensor(xqs[:500], dtype=torch.float32, device=dev)
    del xs, ys
    rec["scale"], _, _ = high_config(
        "scale", x, y, xq, c.kern10, c.h10, c.mtot10,
        fit_kw=dict(solver="iterative", precond_rank=HIGH_RANK),
        oracle="toeplitz")
    del x, y
    torch.cuda.empty_cache()

    # 12e: hard3d (bench.py:416-436 as written: phase 7's data, fit_high
    # with deflation 2048, predict_mean_high(slab=256) at 1 000 targets;
    # no gradient_high or variance_high there): the float64 d=3 type-1 at
    # 21 and 41 and type-2 at 21; the oracle a float64 Toeplitz PCG, given
    # bench.py's 12 000 iterations
    x = torch.as_tensor(c.xh3, dtype=torch.float32, device=dev)
    y = torch.as_tensor(c.yh3, dtype=torch.float32, device=dev)
    xq = torch.as_tensor(c.xqh3, dtype=torch.float32, device=dev)
    rec["hard3d"], _, _ = high_config(
        "hard3d", x, y, xq, c.kern_h3, c.h_h3, c.mtot_h3,
        fit_kw=dict(solver="iterative", precond_rank=HIGH_RANK),
        mean_kw=dict(slab=256), oracle="toeplitz", oracle_maxiter=12_000)
    del x, y
    torch.cuda.empty_cache()

    # every float64 function the phase launched, by PERF.md's rows
    for row, (name, wide) in ROWS_F64.items():
        limit = BLOCK_LIMIT[name.replace("_batched", "")]
        n_ = sum(v for (k, p, m), v in totals.items() if k == name and
                 p == "f64" and (wide is None or (m > limit) == wide))
        rec["f64_launches"][row] = n_
        check(n_ > 0, f"row {row} ({name}) had no float64 launch")
    rec["launches"] = {f"{k}/{p}@{m}": v for (k, p, m), v in
                       sorted(totals.items())}
    print(f"[12] float64 launches by TPU row {rec['f64_launches']}; all "
          f"launches by kernel/precision@mtot {rec['launches']}")
    rec["f64_shapes"] = f64_shape_table(c, totals, rec["matern"]["h"])
    return rec


def f64_shape_table(c, totals, h_matern):
    """The float64 calls phase 12 made, with the kernel's, the plain
    version's and the bound's ms: phase 3's float64 row where phase 3 ran
    the shape, else timed here the way phase 3 times (CUDA events, the
    kernel and the plain version on the same inputs, the kernel held within
    1e-10 of max|ref| of the plain version)."""
    head, hard = (c.h_head, c.mtot_head), (c.h_hard, c.mtot_hard)
    m29, m107, m339 = head[1], hard[1], c.mtot10
    shapes = [  # (name, n, mtot, B, h, serves)
        ("nufft1_2d", 100_000, m29, 1, head[0], "headline F*y"),
        ("nufft1_2d", 100_000, 2 * m29 - 1, 1, head[0],
         "headline lag table"),
        ("nufft2_2d", 10_000, m29, 1, head[0], "headline mean_high"),
        ("nufft2_2d", 100_000, m29, 1, head[0],
         "headline f64 gradient F(D beta)"),
        ("nufft1_2d_batched", 100_000, m29, 10, head[0],
         "headline gradient_high F*Z"),
        ("nufft2_2d_batched", 100_000, m29, 10, head[0],
         "headline f64 gradient F(D'F*Z), F(D Beta)"),
        ("nufft1_2d", 100_000, m107, 1, hard[0], "hard F*y"),
        ("nufft1_2d", 100_000, 2 * m107 - 1, 1, hard[0], "hard lag table"),
        ("nufft2_2d", 2_000, m107, 1, hard[0], "hard mean_high"),
        ("nufft1_2d_batched", 100_000, m107, 10, hard[0],
         "hard gradient_high F*Z"),
        ("nufft1_2d", MATERN_N, 93, 1, h_matern, "matern F*y"),
        ("nufft1_2d", MATERN_N, 185, 1, h_matern, "matern lag table"),
        ("nufft2_2d", MATERN_TARGETS, 93, 1, h_matern, "matern mean_high"),
        ("nufft1_2d_batched", MATERN_N, 93, 10, h_matern,
         "matern gradient_high F*Z"),
        ("nufft1_2d", c.n10, m339, 1, c.h10, "scale F*y"),
        ("nufft1_2d", c.n10, 2 * m339 - 1, 1, c.h10, "scale lag table"),
        ("nufft2_2d", 500, m339, 1, c.h10, "scale mean_high"),
        ("nufft1_3d", 20_000, c.mtot_h3, 1, c.h_h3, "hard3d F*y"),
        ("nufft1_3d", 20_000, 2 * c.mtot_h3 - 1, 1, c.h_h3,
         "hard3d lag table"),
        ("nufft2_3d", 1_000, c.mtot_h3, 1, c.h_h3, "hard3d mean_high"),
    ]
    gen = np.random.default_rng(120)
    rows = []
    for name, n, m, B, h, serves in shapes:
        row = next((r for r in c.phase3 if r["name"] == name and r["n"] == n
                    and r["mtot"] == m and r["B"] == B and not r["fft_order"]
                    and r["dtype"] == "float64"), None)
        if row is not None:
            ms, plain_ms, b_ms, src = (row["ms"], row["plain_ms"],
                                       row["bound_ms"], "phase 3")
            rel = row["rel_err"]
        else:
            d = int(name.split("_")[1][0])
            x = torch.as_tensor(gen.uniform(0, 1, (n, d)), device=c.dev)
            lead = (B,) if B > 1 else ()
            shape = lead + ((n,) if name.startswith("nufft1") else (m,) * d)
            arg = torch.as_tensor(gen.normal(size=shape)
                                  + 1j * gen.normal(size=shape),
                                  device=c.dev)
            hq = float(h)
            got = c.kernels[name](x, arg, hq, mtot=m)
            ref = c.plains[name](x, arg, hq, mtot=m)
            rel = float((got - ref).abs().max() / ref.abs().max())
            check(rel <= 1e-10, f"{name} f64 n={n} mtot={m} B={B}: error "
                  f"{rel:.3e} of max|ref|")
            reps = max(3, min(50, int(2e9 / (B * n * m ** d))))
            ms = time_cuda(lambda: c.kernels[name](x, arg, hq, mtot=m), reps,
                           3)
            plain_ms = time_cuda(lambda: c.plains[name](x, arg, hq, mtot=m),
                                 max(2, reps // 4), 3)
            b_ms, src = bound_ms(name, n, m, torch.float64, B)[0], "phase 12"
            del x, arg, got, ref
        launched = totals.get((name, "f64", m), 0)
        rows.append(dict(name=name, n=n, mtot=m, B=B, serves=serves, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, rel_err=rel,
                         timed_in=src, launches_phase12=launched))
        print(f"[12] float64 {name} n={n} mtot={m} B={B} ({serves}): "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms, "
              f"rel err {rel:.3e} ({src}); phase 12 launched it "
              f"{launched} times at this mtot {c.card}")
    covered = {(r["name"], r["mtot"]) for r in rows}
    missing = sorted(f"{k}@{m}" for (k, p, m), n_ in totals.items()
                     if n_ and p == "f64" and (k, m) not in covered)
    check(not missing, f"phase 12 launched float64 shapes that the table "
          f"does not hold against the plain version: {missing}")
    return rows


# phase 13: the Polya-Gamma estimators.  13a scripts/pg_scale.py:33-45 (n
# 1e5 in [-1,1]^2, labels from sample_bernoulli_gp_spectral at l 0.4,
# variance 4, as the script draws them), 13b
# scripts/pg_spatial_transcriptomics.py (--iters 15, --lengthscale-init 0.1,
# float64 as the script runs it; n_train 24 010 and the positive fraction of
# experiments/pg_spatial_transcriptomics.json, on synthetic labels), 13c
# examples/negative_binomial.py:37-71 at n 1e5 (2 500 in the example), 13d
# scripts/verify_pg_high.py:95-115 (n 2e4, 128 targets)
PG_N, PG_TARGETS, PG_GRID = 100_000, 10_000, 30
PG_CLF = dict(max_iter=10, lengthscale_init=0.3, lr=0.05, n_e_probes=10,
              n_m_probes=10, random_state=0)
ST_N, ST_ITERS, ST_L0, ST_POS, ST_TARGETS = (24_010, 15, 0.1,
                                             0.20857628361043548, 2_000)
NB_N, NB_R = 100_000, 3.0
PGH_N, PGH_TARGETS = 20_000, 128
# the bars (PERF.md section 6): the float32 core on the float64 fit's
# state against float64 (of max|mean|, relative per gradient component, of
# max|var|); the float32 fit against the float64 fit with the same probes
# (hypers relative, the share of equal labels); the high leg against the
# float64 oracles (of max|mean| and max|var|)
PG_BARS = dict(estep_mean=1e-4, mstep_grad=1e-3, var_exact=2e-4,
               var_cheb=2e-4, var_sto=3e-3, hypers=1e-4, labels=0.999,
               high=1e-10)
# PERF.md's rows of the functions the PG path must launch
PG_ROWS = {"1": "nufft2_2d", "2": "nufft1_2d", "9": "nufft2_2d_batched",
           "10": "nufft1_2d_batched"}
# every (kernel, precision, n, mtot, B, FFT order) call phase 13 makes, as
# PERF.md's kernel table lists them: 13c's mtot 17 and lag grid 33, 13d's
# mtot 15 and 29 (lag grid 57) and 128 targets, 13a's float64 fit, its
# labels' draw (1e5 x 15) and 13b beside the main path's
PG_SHAPES = frozenset([
    ('nufft1_2d', 'f32', 100000, 17, 1, False),
    ('nufft1_2d', 'f32', 100000, 21, 1, False),
    ('nufft1_2d', 'f32', 100000, 33, 1, False),
    ('nufft1_2d', 'f32', 100000, 41, 1, False),
    ('nufft1_2d', 'f64', 20000, 15, 1, False),
    ('nufft1_2d', 'f64', 20000, 29, 1, False),
    ('nufft1_2d', 'f64', 20000, 57, 1, False),
    ('nufft1_2d', 'f64', 24010, 43, 1, False),
    ('nufft1_2d', 'f64', 24010, 85, 1, False),
    ('nufft1_2d', 'f64', 100000, 17, 1, False),
    ('nufft1_2d', 'f64', 100000, 21, 1, False),
    ('nufft1_2d', 'f64', 100000, 33, 1, False),
    ('nufft1_2d', 'f64', 100000, 41, 1, False),
    ('nufft1_2d_batched', 'f32', 100000, 17, 10, False),
    ('nufft1_2d_batched', 'f32', 100000, 17, 11, False),
    ('nufft1_2d_batched', 'f32', 100000, 21, 10, False),
    ('nufft1_2d_batched', 'f32', 100000, 21, 11, False),
    ('nufft1_2d_batched', 'f64', 24010, 43, 10, False),
    ('nufft1_2d_batched', 'f64', 24010, 43, 11, False),
    ('nufft1_2d_batched', 'f64', 100000, 17, 10, False),
    ('nufft1_2d_batched', 'f64', 100000, 17, 11, False),
    ('nufft1_2d_batched', 'f64', 100000, 21, 10, False),
    ('nufft1_2d_batched', 'f64', 100000, 21, 11, False),
    ('nufft2_2d', 'f32', 900, 21, 1, False),
    ('nufft2_2d', 'f32', 10000, 21, 1, False),
    ('nufft2_2d', 'f32', 10000, 41, 1, True),
    ('nufft2_2d', 'f32', 100000, 15, 1, False),
    ('nufft2_2d', 'f64', 128, 15, 1, False),
    ('nufft2_2d', 'f64', 128, 21, 1, False),
    ('nufft2_2d', 'f64', 128, 29, 1, False),
    ('nufft2_2d', 'f64', 2000, 43, 1, False),
    ('nufft2_2d', 'f64', 10000, 21, 1, False),
    ('nufft2_2d', 'f64', 10000, 41, 1, True),
    ('nufft2_2d_batched', 'f32', 100000, 17, 11, False),
    ('nufft2_2d_batched', 'f32', 100000, 21, 11, False),
    ('nufft2_2d_batched', 'f64', 24010, 43, 11, False),
    ('nufft2_2d_batched', 'f64', 100000, 17, 11, False),
    ('nufft2_2d_batched', 'f64', 100000, 21, 11, False),
])


def rff_latent(x, lengthscale, variance, seed, dev, features=4096):
    """A latent drawn from the SE prior (lengthscale, variance) at the
    points x (n, d) by random Fourier features: frequencies N(0, 1/l^2),
    phases U(0, 2 pi), weights N(0, 1) from numpy seed ``seed``, evaluated
    in float64 on the card (13b's labels, at a positive fraction that
    needs an offset the sampler does not take)."""
    rng = np.random.default_rng(seed)
    W = rng.normal(scale=1.0 / lengthscale, size=(x.shape[1], features))
    b = rng.uniform(0, 2 * np.pi, features)
    a = rng.normal(size=features)
    def t(v):
        return torch.as_tensor(v, dtype=torch.float64, device=dev)
    f = torch.cos(t(x) @ t(W) + t(b)) @ t(a)
    return (f * (2.0 * variance / features) ** 0.5).cpu().numpy()


def pg_scale_data(gt, n, seed, dev):
    """scripts/pg_scale.py:36-39's data: n points uniform in [-1,1]^2 from
    numpy seed 0, Bernoulli labels from sample_bernoulli_gp_spectral (l
    0.4, variance 4) on the points in float32, drawn from a CPU generator
    seeded ``seed`` (0 as pg_scale.py's key) so that any card draws the
    same normals.  Returns (points, labels, latent) as numpy."""
    x = np.random.default_rng(0).uniform(-1, 1, size=(n, 2))
    y, f = gt.sample_bernoulli_gp_spectral(
        torch.Generator().manual_seed(seed),
        torch.as_tensor(x, dtype=torch.float32, device=dev),
        lengthscale=0.4, variance=4.0, device=dev)
    return x, y.cpu().numpy().astype(int), f.double().cpu().numpy()


def pg_class_data(n, lengthscale, variance, seed, dev, pos_frac=None):
    """Points uniform in [-1,1]^2 from numpy seed ``seed``, the latent of
    rff_latent and Bernoulli labels of sigmoid(latent + c): c is 0, or with
    ``pos_frac`` the offset whose mean probability is that fraction."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(n, 2))
    f = rff_latent(x, lengthscale, variance, seed + 1, dev)
    c = 0.0
    if pos_frac is not None:
        lo, hi = -20.0, 20.0
        for _ in range(60):
            c = 0.5 * (lo + hi)
            if np.mean(1 / (1 + np.exp(-(f + c)))) > pos_frac:
                hi = c
            else:
                lo = c
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(f + c)))).astype(int)
    return x, y, f + c


def timed(fn):
    """``fn()`` once on the host clock, the card synchronised on both
    sides: (result, ms)."""
    sync()
    t = time.perf_counter()
    r = fn()
    sync()
    return r, (time.perf_counter() - t) * 1e3


def cg_iters(history):
    """PCG iterations of a fit's E-steps and M-steps and of its final
    E-step and beta solve (store_history=True)."""
    loop = [r for r in history if "e_iters_used" in r]
    return dict(estep=[int(r["e_cg_iters"]) for r in loop],
                mstep=[int(r["m_cg_iters"]) for r in loop],
                final_estep=int(history[-1]["e_cg_iters"]),
                beta=int(history[-1]["m_cg_iters"]))


def rel_of_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def recorder(cn, shapes, names):
    """Wrap the kernels ``names`` of ``cn`` to count each (kernel,
    precision, n, mtot, B, FFT order) launched on the card in ``shapes``;
    returns the originals."""
    originals = {k: getattr(cn, k) for k in names}

    def wrap(name, fn):
        def launch(x, arg, h, *, mtot, fft_order=False):
            if x.is_cuda:
                B = (arg.shape[0] if name.endswith("batched")
                     or (name in KERNELS_1D and arg.ndim == 2) else 1)
                key = (name, "f32" if x.dtype == torch.float32 else "f64",
                       x.shape[0], mtot, B, bool(fft_order))
                shapes[key] = shapes.get(key, 0) + 1
            return fn(x, arg, h, mtot=mtot, fft_order=fft_order)
        return launch
    for k, fn in originals.items():
        setattr(cn, k, wrap(k, fn))
    return originals


def phase_pg(c):
    """Phase 13.  ``c``: a namespace of main()'s dev, card, counters,
    gpquad_torch and its modules, and phase 3's kernels and plain
    versions.  Returns the phase's record."""
    gt, cn, nm, dev, card = c.gt, c.cuda_nufft, c.nufft_mod, c.dev, c.card
    from gpquad_torch.models import pg_core
    from gpquad_torch.utils import f64_oracles as orc
    rec = {}
    shapes = {}   # (kernel, precision, n, mtot, B, fft_order) -> launches

    steps = []                      # CUDA events around each outer step
    orig_step = pg_core.outer_step

    def timed_step(*a, **k):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        r = orig_step(*a, **k)
        e.record()
        steps.append((s, e))
        return r

    def step_ms(first):
        """The CUDA-event ms of the outer steps from index ``first`` on,
        and the median of all but the first."""
        sync()
        ms = [s.elapsed_time(e) for s, e in steps[first:]]
        return ms, statistics.median(ms[1:] if len(ms) > 1 else ms)

    def clf(dtype, **kw):
        return gt.PolyagammaGPClassifier(
            dtype=dtype, device=dev, store_history=True,
            **dict(PG_CLF, **kw))

    originals = recorder(cn, shapes, KERNELS_2D)
    pg_core.outer_step = timed_step
    try:
        # -- 13a: the main path, counts set to 0 just before it ----------
        a = rec["13a"] = {}
        x, y, f = pg_scale_data(gt, PG_N, 0, dev)
        # the accuracy of the true latent's sign: the labels' noise floor
        a["bayes_acc"] = float(np.mean((f > 0) == (y == 1)))
        rng = np.random.default_rng(130)
        xq = rng.uniform(-1, 1, size=(PG_TARGETS, 2))
        g1 = np.linspace(-1, 1, PG_GRID)
        Xg = np.stack(np.meshgrid(g1, g1), -1).reshape(-1, 2)
        # warm: cuFFT plans, the cuBLAS and cuSOLVER handles, at the main
        # path's shapes
        clf("float32", max_iter=1).fit(x, y)
        reset_counts(*c.counters)
        first = len(steps)
        est, a["fit_ms"] = timed(lambda: clf("float32").fit(x, y))
        a["step_ms"], a["step_median_ms"] = step_ms(first)
        sp = est._spectral_state_
        check(sp.mtot == 21, f"13a planned mtot {sp.mtot}, not 21")
        proba, a["predict_proba_ms"] = timed(lambda: est.predict_proba(Xg))
        var32 = {}
        a["var_ms"] = {}
        for method in ("exact", "stochastic", "chebyshev"):
            est.predictive_variance_method = method
            var32[method], ms = timed(lambda: est.predictive_variance(xq))
            _, ms2 = timed(lambda: est.predictive_variance(xq))
            a["var_ms"][method] = dict(cold=ms, warm=ms2)
        a["launches"] = dict(cn.LAUNCHES)
        a["picks"] = dict(nm.BACKEND_PICKS)
        a["rows"] = {r: a["launches"][k] for r, k in PG_ROWS.items()}
        est.predictive_variance_method = "exact"
        labels32 = est.predict(xq)
        a["train_acc"] = float(np.mean(est.predict(x) == y))
        a["pcg_iters"] = it = cg_iters(est.history_)
        a.update(mtot=sp.mtot, hm=est._hm_, lengthscale=est.lengthscale_,
                 variance=est.variance_)
        print(f"[13a] pg_scale n={PG_N} mtot {sp.mtot} (lag grid "
              f"{2 * sp.mtot - 1}): fit {a['fit_ms']:.1f} ms host clock, "
              f"{a['step_median_ms']:.2f} ms an outer iteration (CUDA "
              f"events, median of the warm "
              f"{[round(s_, 2) for s_ in a['step_ms']]}) {card}")
        print(f"[13a] learned l {est.lengthscale_:.6f} variance "
              f"{est.variance_:.6f}; train accuracy {a['train_acc']:.4f} "
              f"(the true latent's sign {a['bayes_acc']:.4f}); "
              f"PCG iterations E-step {it['estep']} M-step {it['mstep']} "
              f"final E-step {it['final_estep']} beta {it['beta']}")
        print(f"[13a] predict_proba 30x30 {a['predict_proba_ms']:.2f} ms; "
              f"variance at {PG_TARGETS} targets (cold / warm ms): "
              + ", ".join(f"{m} {v['cold']:.2f} / {v['warm']:.2f}"
                          for m, v in a["var_ms"].items()) + f" {card}")
        print(f"[13a] main path launches {a['launches']} (TPU rows "
              f"{a['rows']}), backend_picks {a['picks']}")
        check(a["picks"]["matmul"] == 0,
              f"13a: the plain path was taken {a['picks']}")
        check(all(v > 0 for v in a["rows"].values()),
              f"13a: a PG row had no launch {a['rows']}")
        check(np.all(np.isfinite(proba)) and proba.shape == (PG_GRID ** 2, 2)
              and np.allclose(proba.sum(1), 1.0), "13a: predict_proba")
        for method, v in var32.items():
            check(v.shape == (PG_TARGETS,) and np.all(np.isfinite(v))
                  and np.all(v >= 0), f"13a: {method} variance")
        check(a["train_acc"] >= a["bayes_acc"] - 0.02,
              f"13a: training accuracy {a['train_acc']}")

        # one outer iteration at the fitted state, profiled
        yt = torch.as_tensor((y == est.classes_[1]).astype(np.float64),
                             dtype=torch.float32, device=dev)
        lik = est._make_likelihood()
        kappa, pg_b = lik.kappa(yt), lik.pg_b(yt)
        kern, h, mtot, mask, _ = est._plan_grid(
            est._X_train_t_, est.lengthscale_, est.variance_)
        e_pr = est._draw_probes(17, (10, PG_N))
        m_pr = est._draw_probes(10_009, (10, PG_N))

        def one_step():
            raw = torch.log(torch.tensor(
                [est.lengthscale_, est.variance_], dtype=torch.float32,
                device=dev))
            return orig_step(est._X_train_t_, kern, h, mask, est._delta_t_,
                             kappa, pg_b, e_pr, m_pr, raw,
                             torch.optim.Adam([raw], lr=0.05), mtot=mtot,
                             e_iters=1, rho0=0.7, gamma=1e-3, e_tol=1e-4,
                             cg_tol=1e-6)
        one_step()
        a["profile"] = prof = profile_run(one_step)
        print_profile("[13a] profiled outer iteration:", prof, card)

        # the float64 fit with the same probes
        est64, a["fit64_ms"] = timed(lambda: clf("float64").fit(x, y))
        hyp32 = np.array([est.lengthscale_, est.variance_])
        hyp64 = np.array([est64.lengthscale_, est64.variance_])
        a["hypers_rel"] = float(np.max(np.abs(hyp32 - hyp64) / hyp64))
        labels64 = est64.predict(xq)
        a["labels_equal"] = float(np.mean(labels32 == labels64))
        print(f"[13a] float32 fit vs float64 fit (same probes, "
              f"{a['fit64_ms']:.1f} ms): hypers {hyp32.tolist()} vs "
              f"{hyp64.tolist()}, rel {a['hypers_rel']:.3e} (bar "
              f"{PG_BARS['hypers']:.0e}); predict labels equal on "
              f"{a['labels_equal']:.5f} of {PG_TARGETS} targets (bar "
              f"{PG_BARS['labels']})")
        check(a["hypers_rel"] <= PG_BARS["hypers"], "13a: hypers")
        check(a["labels_equal"] >= PG_BARS["labels"], "13a: labels")
        a["fixed_state"] = pg_fixed_state(gt, pg_core, est64, yt, xq, dev)
        fs = a["fixed_state"]
        print(f"[13a] float32 core on the float64 fit's state vs float64: "
              + ", ".join(f"{k} {v:.3e} (bar {PG_BARS[k]:.0e})"
                          for k, v in fs.items()))
        for k, v in fs.items():
            check(v <= PG_BARS[k], f"13a fixed state: {k} {v:.3e}")

        # predict_latent_high on the float32 fit against the oracles
        # the targets as the estimator takes them, in its float32
        xh = xq[:PGH_TARGETS].astype(np.float32).astype(np.float64)
        (mh, vh), a["latent_high_ms"] = timed(
            lambda: est.predict_latent_high(xh))
        obj = orc.pg_f64_objects(est._X_train_t_, est._delta_t_,
                                 est._make_kernel_obj(est.lengthscale_,
                                                      est.variance_, 2),
                                 float(sp.h), sp.mtot, est._hm_, device=dev)
        beta64 = orc.pg_beta_mean_f64(obj, est._kappa_t_)
        a["latent_high_mean_rel"] = rel_of_max(
            mh, orc.pg_mean_f64(obj, xh, beta64).cpu())
        a["latent_high_var_rel"] = rel_of_max(
            vh, orc.pg_var_f64(obj, xh).cpu())
        print(f"[13a] predict_latent_high ({PGH_TARGETS} targets, "
              f"{a['latent_high_ms']:.1f} ms) vs the float64 oracle: mean "
              f"{a['latent_high_mean_rel']:.3e}, var "
              f"{a['latent_high_var_rel']:.3e} of max (bar "
              f"{PG_BARS['high']:.0e})")
        check(max(a["latent_high_mean_rel"], a["latent_high_var_rel"])
              <= PG_BARS["high"], "13a: predict_latent_high")
        del est, est64, obj
        torch.cuda.empty_cache()

        rec["13b"] = pg_spatial(clf, step_ms, steps, dev, card)
        rec["13c"] = pg_negative_binomial(gt, step_ms, steps, dev, card)
        rec["13d"] = pg_high_leg(gt, orc, dev, card)
    finally:
        for k, fn in originals.items():
            setattr(cn, k, fn)
        pg_core.outer_step = orig_step
    rec["shapes"] = shape_table(c, shapes, PG_SHAPES, "13")
    return rec


def pg_fixed_state(gt, pg_core, est64, yt, xq, dev):
    """The float32 core against the float64 core on the float64 fit's
    state: its delta, hypers, grid and the fit's probes (the E-step's,
    the last M-step's, the stochastic variance's etas), errors as PG_BARS
    reads them."""
    out = {}
    sp64, X64 = est64._spectral_state_, est64._X_train_t_
    kern32 = est64._make_kernel_obj(est64.lengthscale_, est64.variance_, 2)
    mask = gt.quadrature.flat_grid_mask(sp64.mtot, 2, est64._hm_,
                                        device=dev)
    X32 = X64.float()
    sp32 = pg_core.build_pg_spectral_state(X32, kern32, float(sp64.h),
                                           mtot=sp64.mtot, ws_mask=mask)
    lik = est64._make_likelihood()
    e_pr = est64._draw_probes(17, (10, X64.shape[0]))
    m_pr = est64._draw_probes(10_000 + PG_CLF["max_iter"] - 1,
                              (10, X64.shape[0]))
    etas = est64._draw_probes(2_000_000, (16, sp64.M))
    res = {}
    for tag, sp, X, tol in (("f32", sp32, X32, 1e-6),
                            ("f64", sp64, X64, 1e-12)):
        rd = X.dtype
        y_ = yt.to(rd)
        kappa, pg_b = lik.kappa(y_), lik.pg_b(y_)
        delta = est64._delta_t_.to(rd)
        e = pg_core.estep_pass(sp, X, delta, kappa, pg_b, e_pr.to(rd),
                               max_iters=1, rho0=0.7, gamma=1e-3,
                               cg_tol=tol)
        m = pg_core.mstep_gradient(sp, X, delta, kappa, m_pr.to(rd),
                                   cg_tol=tol)
        xt = torch.as_tensor(xq, dtype=rd, device=dev)
        system = pg_core.dense_feature_system(sp, X, delta)
        v_ex = pg_core.predictive_variance_exact_dense(sp, X, delta, xt,
                                                       system=system)
        sums = pg_core.stochastic_variance_sums(sp, X, delta, etas.to(rd),
                                                cg_tol=tol)
        v_st = pg_core.evaluate_variance_sums(sp, sums, xt)
        v_ch = pg_core.predictive_variance_chebyshev(
            sp, X, delta, xt, n_nodes_per_dim=7, cg_tol=tol,
            solver="dense", system=system)
        res[tag] = [t.double().cpu().numpy() for t in
                    (e.mean, m.grad, v_ex, v_st, v_ch)]
    a, b = res["f32"], res["f64"]
    out["estep_mean"] = rel_of_max(a[0], b[0])
    out["mstep_grad"] = float(np.max(np.abs(a[1] - b[1]) / np.abs(b[1])))
    out["var_exact"] = rel_of_max(a[2], b[2])
    out["var_sto"] = rel_of_max(a[3], b[3])
    out["var_cheb"] = rel_of_max(a[4], b[4])
    return out


def pg_spatial(clf, step_ms, steps, dev, card):
    """13b: the spatial-transcriptomics plan (mtot 43, lag grid 85) in
    float64, its exact variance by the dense tier and by the batched
    PCG."""
    out = {}
    x, y, _ = pg_class_data(ST_N, 0.09, 2.0, 2, dev, pos_frac=ST_POS)
    xv = np.random.default_rng(131).uniform(-1, 1, size=(ST_TARGETS, 2))
    first = len(steps)
    est, out["fit_ms"] = timed(lambda: clf(
        "float64", max_iter=ST_ITERS, lengthscale_init=ST_L0,
        n_e_probes=10, n_m_probes=10, lr=0.05).fit(x, y))
    out["step_ms"], out["step_median_ms"] = step_ms(first)
    sp = est._spectral_state_
    check(sp.mtot == 43, f"13b planned mtot {sp.mtot}, not 43")
    p, out["predict_proba_ms"] = timed(lambda: est.predict_proba(xv))
    v = {}
    for solver in ("dense", "cg"):
        est.prediction_solver = solver
        est._dense_system_ = None
        v[solver], out[f"var_{solver}_ms"] = timed(
            lambda: est.predictive_variance(xv))
    out["var_dense_vs_cg"] = rel_of_max(v["cg"], v["dense"])
    out["pcg_iters"] = it = cg_iters(est.history_)
    out.update(mtot=sp.mtot, hm=est._hm_, lengthscale=est.lengthscale_,
               variance=est.variance_, pos_frac=float(np.mean(y)),
               train_acc=float(np.mean(est.predict(x) == y)))
    print(f"[13b] spatial n={ST_N} float64 mtot {sp.mtot} (lag grid "
          f"{2 * sp.mtot - 1}), positive fraction {out['pos_frac']:.4f}: "
          f"fit {out['fit_ms']:.1f} ms, {out['step_median_ms']:.2f} ms an "
          f"outer iteration (CUDA events, median of the warm "
          f"{[round(s_, 2) for s_ in out['step_ms']]}) {card}")
    print(f"[13b] learned l {est.lengthscale_:.6f} variance "
          f"{est.variance_:.6f}, train accuracy {out['train_acc']:.4f}; PCG "
          f"iterations E-step {it['estep']} M-step {it['mstep']} beta "
          f"{it['beta']}; predict_proba ({ST_TARGETS}) "
          f"{out['predict_proba_ms']:.1f} ms; exact variance dense "
          f"{out['var_dense_ms']:.1f} ms, cg (batches of 64) "
          f"{out['var_cg_ms']:.1f} ms, cg vs dense "
          f"{out['var_dense_vs_cg']:.3e} of max {card}")
    check(np.all(np.isfinite(p)) and out["var_dense_vs_cg"] <= 1e-4,
          "13b: predictions")
    return out


def pg_negative_binomial(gt, step_ms, steps, dev, card):
    """13c: examples/negative_binomial.py at n 1e5, float32: the fixed-r
    fit and the learned dispersion, with the example's assertions."""
    out = {}
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, size=(NB_N, 2))
    f = 0.9 * np.sin(2.2 * X[:, 0]) * np.cos(1.7 * X[:, 1]) - 0.3
    p = 1.0 / (1.0 + np.exp(-f))
    y = rng.negative_binomial(NB_R, 1.0 - p)
    common = dict(lengthscale_init=0.5, lr=0.05, n_e_probes=10,
                  n_m_probes=10, random_state=0, dtype="float32",
                  device=dev, store_history=True)
    first = len(steps)
    reg, out["fit_ms"] = timed(lambda: gt.PolyagammaGPNegativeBinomialRegressor(
        total_count=NB_R, max_iter=12, **common).fit(X, y))
    out["step_ms"], out["step_median_ms"] = step_ms(first)
    mu = reg.predict(X)
    rate = NB_R * np.exp(f)
    out["corr"] = float(np.corrcoef(mu, rate)[0, 1])
    out["mtot"] = reg._spectral_state_.mtot
    first = len(steps)
    reg2, out["fit2_ms"] = timed(
        lambda: gt.PolyagammaGPNegativeBinomialRegressor(
            total_count=1.0, learn_total_count=True, total_count_lr=0.1,
            total_count_update_frequency=1, max_iter=30, **common).fit(X, y))
    out["step2_ms"], out["step2_median_ms"] = step_ms(first)
    out["learned_r"] = reg2.total_count_
    out["r_path"] = [r["total_count"] for r in reg2.history_]
    # the same learned dispersion in float64 with the same probes
    reg64, out["fit2_f64_ms"] = timed(
        lambda: gt.PolyagammaGPNegativeBinomialRegressor(
            total_count=1.0, learn_total_count=True, total_count_lr=0.1,
            total_count_update_frequency=1, max_iter=30,
            **dict(common, dtype="float64")).fit(X, y))
    out["learned_r_f64"] = reg64.total_count_
    out["r_rel_f32_f64"] = abs(reg2.total_count_ - reg64.total_count_) \
        / reg64.total_count_
    print(f"[13c] negative binomial n={NB_N} mtot {out['mtot']}: fixed r "
          f"{NB_R} fit {out['fit_ms']:.1f} ms ({out['step_median_ms']:.2f} "
          f"ms an outer iteration), corr(mean count, true rate) "
          f"{out['corr']:.4f} (example's bar 0.8); learned r "
          f"{out['learned_r']:.4f} beside r {NB_R} (from 1, 30 iterations, "
          f"{out['fit2_ms']:.1f} ms, {out['step2_median_ms']:.2f} ms an "
          f"outer iteration; float64 with the same probes "
          f"{out['learned_r_f64']:.6f}, rel {out['r_rel_f32_f64']:.3e}, bar "
          f"{PG_BARS['hypers']:.0e}) {card}")
    print(f"[13c] learned r by iteration "
          f"{[round(r, 4) for r in out['r_path']]}")
    check(out["corr"] > 0.8, "13c: the rate is not tracked")
    check(np.isfinite(out["learned_r"]) and out["learned_r"] > 0
          and out["r_rel_f32_f64"] <= PG_BARS["hypers"],
          "13c: learned dispersion")
    return out


def pg_high_leg(gt, orc, dev, card):
    """13d: pg_predict_high against the float64 oracles at
    scripts/verify_pg_high.py's two configurations."""
    out = {}
    rng = np.random.default_rng(0)
    for tag, name, ls, var, eps in (("se", "SE", 0.25, 2.0, 1e-4),
                                    ("matern32", "Matern32", 0.3, 1.5,
                                     1e-3)):
        x = rng.uniform(0, 1, size=(PGH_N, 2)).astype(np.float32)
        kern = gt.make_kernel(name, 2, lengthscale=np.float32(ls),
                              variance=np.float32(var))
        _, h, mtot = gt.spectral_grid(kern, eps, 1.0)
        delta = (0.1 + 0.15 * rng.uniform(size=PGH_N)).astype(np.float32)
        kappa = (rng.integers(0, 2, PGH_N) - 0.5).astype(np.float32)
        xt = rng.uniform(0.1, 0.9, size=(PGH_TARGETS, 2)).astype(np.float32)
        xd = torch.as_tensor(x, device=dev)

        def run():
            return gt.pg_predict_high(xd, kern, h, mtot, delta, kappa, xt,
                                      device=dev)
        run()
        res, ms = timed(run)
        obj = orc.pg_f64_objects(xd, delta, kern, h, mtot, device=dev)
        beta64 = orc.pg_beta_mean_f64(obj, kappa)
        r = dict(mtot=mtot, ms=ms,
                 mean_rel=rel_of_max(res.mean.cpu(),
                                     orc.pg_mean_f64(obj, xt, beta64).cpu()),
                 var_rel=rel_of_max(res.var.cpu(),
                                    orc.pg_var_f64(obj, xt).cpu()),
                 solve_iters=int(res.solve_iters),
                 residual=float(res.residual))
        out[tag] = r
        print(f"[13d] {tag} n={PGH_N} mtot {mtot}: pg_predict_high "
              f"{ms:.1f} ms (warm), mean {r['mean_rel']:.3e} and var "
              f"{r['var_rel']:.3e} of max vs the float64 oracle (bar "
              f"{PG_BARS['high']:.0e}), inner iterations "
              f"{r['solve_iters']} {card}")
        check(mtot == {"se": 15, "matern32": 29}[tag],
              f"13d {tag}: planned mtot {mtot}")
        check(max(r["mean_rel"], r["var_rel"]) <= PG_BARS["high"],
              f"13d {tag}: over the bar")
    return out


def shape_table(c, shapes, known, tag):
    """Each (kernel, precision, n, mtot, B, FFT order) call that phase
    ``tag`` launched (``shapes``: launches by key) with the kernel's, the
    plain version's and the bound's ms on inputs of that shape (CUDA
    events; the kernel within 1e-4 of max|ref| of the float64 plain version
    in float32, 1e-10 in float64).  Fails on a launched shape that
    ``known``, the code's copy of PERF.md's rows, lacks."""
    gen = np.random.default_rng(132)
    rows = []
    for (name, prec, n, m, B, fo), launched in sorted(shapes.items()):
        d = int(name.split("_")[1][0])
        dtype = torch.float32 if prec == "f32" else torch.float64
        x = torch.as_tensor(gen.uniform(-1, 1, (n, d)), dtype=dtype,
                            device=c.dev)
        lead = ((B,) if name.endswith("batched") or name in KERNELS_1D
                else ())
        shape = lead + ((n,) if name.startswith("nufft1") else (m,) * d)
        arg = torch.as_tensor(gen.normal(size=shape)
                              + 1j * gen.normal(size=shape),
                              device=c.dev).to(c.cuda_nufft._complex_of(dtype))
        hq = 0.4
        got = c.kernels[name](x, arg, hq, mtot=m, fft_order=fo)
        ref = c.plains[name](x.double(), arg.to(torch.complex128), hq,
                             mtot=m, fft_order=fo)
        rel = float((got - ref).abs().max() / ref.abs().max())
        check(rel <= (1e-4 if prec == "f32" else 1e-10),
              f"[{tag}] {name} {prec} n={n} mtot={m} B={B}: error {rel:.3e}")
        reps = max(3, min(50, int(2e9 / (B * n * m ** d))))
        ms = time_cuda(lambda: c.kernels[name](x, arg, hq, mtot=m,
                                               fft_order=fo), reps, 3)
        def plain():
            return c.plains[name](x, arg, hq, mtot=m, fft_order=fo)
        _, once = timed(plain)
        # a plain version past 50 ms (the d=1 ones at B in the thousands):
        # one more call, timed alone
        plain_ms = (time_cuda(plain, 1, 1, warm=0) if once > 50 else
                    time_cuda(plain, max(2, reps // 4), 3))
        b_ms, b_by = bound_ms(name, n, m, dtype, B)
        if prec == "f32":
            cn = c.cuda_nufft
            if name == "nufft1_1d":
                geo = cn.type1_1d_geometry(n, m, B)[1:]
                K = geo[0] // geo[2]
                b_ms, b_by = bound_3xtf32_ms(
                    name, n, m, B, (K, cn.type1_1d_split(m, K)[1]))
            elif name == "nufft2_1d":
                if cn.type2_1d_geometry(n, m, B)[0] == "tc":
                    K = cn.TYPE2_1D_K
                    b_ms, b_by = bound_3xtf32_ms(
                        name, n, m, B, (K, cn.type1_1d_split(m, K)[1]))
            elif (name in TC_TYPE1 or (
                    name == "nufft2_2d_batched"
                    and cn.type2_2d_geometry(m)[0] == "tc") or (
                    name == "nufft2_2d" and cn.type2_2d_single_geometry(
                        n, m, dtype)[0] == "tc")):
                b_ms, b_by = bound_3xtf32_ms(name, n, m, B)
        rows.append(dict(name=name, precision=prec, n=n, mtot=m, B=B,
                         fft_order=fo, launches=launched, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         rel_err=rel))
        print(f"[{tag}] {name} {prec} n={n} mtot={m} B={B}"
              f"{' fft_order' if fo else ''}: {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), rel err "
              f"{rel:.3e}; launched {launched} times in phase {tag} {c.card}")
        del x, arg, got, ref
    missing = sorted(set(shapes) - known)
    check(not missing, f"phase {tag} launched shapes that PERF.md's table "
          f"lacks: {missing}")
    return rows


# phase 14: the spreading NUFFT backends and the samplers.  14a holds each
# backend against the exact CUDA kernels in float64 on the same inputs (the
# float32 exact kernel's own error at n 1e6, ~1.5e-5-4e-5 of max|ref| from
# its sums over the points, is printed beside it) at the scale
# configuration's d=2 shapes (n 1e6 at mtot 339 and its lag grid 677, and
# the batched pair at B 5 on 339) and d3's (n 1e5 at mtot 31 and 61); 14b
# runs bench.py's scale configuration (bench.py:441-603) on
# nufft_method="banded"; 14c drives the samplers (examples/sampling.py's
# 1-D sizes, a 64-draw spectral sample at n 1e5, the pathwise sampler on
# the headline state, and tests/test_sampling.py's statistical checks).
SPREAD_BAR = {torch.float32: 1e-5, torch.float64: 1e-6}
SPREAD_ADJOINT_BAR = {torch.float32: 1e-4, torch.float64: 1e-9}
# 14b: the mean against the float64 kron fit (phase 10's bar) and the
# gradient against phase 10's, same probes, relative to max|grad|
SCALE_MEAN_BAR, SCALE_GRAD_BAR = 5e-4, 1e-2
# the pathwise sampler's CG: its default cap, and room to converge (the
# float32 headline solve needs ~1 500 iterations, ROADMAP section C)
PATHWISE_MAX_ITER, PATHWISE_ROOM = 1000, 4000
# every (kernel, precision, n, mtot, B, FFT order) call 14c makes, as
# PERF.md's kernel table lists them: examples/sampling.py's 1-D sizes, the
# 64 draws at n 1e5, the headline's pathwise draws and its mean, the
# second seed's float64 PG fit and M-step, tests/test_sampling.py's sizes
SAMPLER_SHAPES = frozenset([
    ('nufft1_1d', 'f32', 400, 17, 1, False),
    ('nufft1_1d', 'f32', 400, 17, 512, False),
    ('nufft1_1d', 'f32', 400, 33, 1, False),
    ('nufft1_1d', 'f64', 120, 17, 1, False),
    ('nufft1_1d', 'f64', 120, 17, 4000, False),
    ('nufft1_1d', 'f64', 120, 33, 1, False),
    ('nufft1_2d', 'f32', 100000, 21, 1, False),
    ('nufft1_2d', 'f32', 100000, 41, 1, False),
    ('nufft1_2d', 'f64', 100000, 21, 1, False),
    ('nufft1_2d', 'f64', 100000, 41, 1, False),
    ('nufft1_2d_batched', 'f32', 100000, 21, 10, False),
    ('nufft1_2d_batched', 'f32', 100000, 29, 16, False),
    ('nufft1_2d_batched', 'f64', 100000, 21, 10, False),
    ('nufft1_2d_batched', 'f64', 100000, 21, 11, False),
    ('nufft2_1d', 'f32', 50, 17, 1, False),
    ('nufft2_1d', 'f32', 50, 17, 512, False),
    ('nufft2_1d', 'f32', 400, 15, 1, False),
    ('nufft2_1d', 'f32', 400, 17, 1, False),
    ('nufft2_1d', 'f32', 400, 17, 512, False),
    ('nufft2_1d', 'f64', 7, 17, 1, False),
    ('nufft2_1d', 'f64', 7, 17, 4000, False),
    ('nufft2_1d', 'f64', 25, 15, 30000, False),
    ('nufft2_1d', 'f64', 120, 17, 4000, False),
    ('nufft2_2d', 'f32', 10000, 29, 1, False),
    ('nufft2_2d', 'f32', 100000, 15, 1, False),
    ('nufft2_2d_batched', 'f32', 10000, 29, 16, False),
    ('nufft2_2d_batched', 'f32', 100000, 23, 64, False),
    ('nufft2_2d_batched', 'f32', 100000, 29, 16, False),
    ('nufft2_2d_batched', 'f64', 100000, 21, 11, False),
])
# 14c: the float32 M-step gradient's error relative to the larger of the
# two terms it is the difference of (per component)
MSTEP_TERM_BAR = 1e-4


def spread_backend_case(c, x, h, mtot, B, kind, methods):
    """Each backend of ``methods`` against the exact kernels on the same
    inputs: the error relative to max|ref| of the float64 exact kernel
    (points as given, h rounded to their precision, as the backends take
    it), beside the float32 exact kernel's own error and the backend's
    difference from it; the first call's CUDA-event ms (its plan included)
    and the warm call's, the exact kernel's, the peak memory of the first
    call and equal bits over two calls.  Returns the rows."""
    d = x.shape[1]
    gen = np.random.default_rng(140 + mtot + B)
    cdtype = torch.complex64 if x.dtype == torch.float32 else torch.complex128
    shape = ((B,) if B > 1 else ()) + (
        (x.shape[0],) if kind == 1 else (mtot,) * d)
    arg = torch.complex(*(torch.as_tensor(gen.standard_normal(shape),
                                          dtype=x.dtype, device=c.dev)
                          for _ in range(2))).to(cdtype)
    apply = (lambda op, a: op.type1(a)) if kind == 1 else \
        (lambda op, a: op.type2(a))
    h_in = float(torch.as_tensor(h, dtype=x.dtype))
    ref = apply(c.nufft_mod.make_nufft(x.double(), h_in, mtot),
                arg.to(torch.complex128))
    scale = float(ref.abs().max())
    exact = c.nufft_mod.make_nufft(x, h, mtot)
    ref_in = apply(exact, arg)
    exact_err = float((ref_in - ref).abs().max()) / scale
    exact_ms = time_cuda(lambda: apply(exact, arg), 1, 3)
    rows = []
    for method in methods:
        sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        op = c.nufft_mod.make_nufft(x, h, mtot, method=method)
        make_ms = (time.perf_counter() - t) * 1e3
        s_, e_ = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s_.record()
        out1 = apply(op, arg)
        e_.record()
        sync()
        first_ms = s_.elapsed_time(e_)
        peak = torch.cuda.max_memory_allocated() - base
        err = float((out1 - ref).abs().max()) / scale
        vs_exact = float((out1 - ref_in).abs().max()) / scale
        ms = time_cuda(lambda: apply(op, arg), 1, 3)
        same = bool(torch.equal(apply(op, arg), out1))
        prec = "f32" if x.dtype == torch.float32 else "f64"
        row = dict(method=method, type=kind, d=d, n=x.shape[0], mtot=mtot,
                   B=B, precision=prec, rel_err=err, exact_rel_err=exact_err,
                   rel_diff_exact=vs_exact, ms=ms, first_ms=first_ms,
                   make_ms=make_ms, exact_ms=exact_ms,
                   peak_mb=peak / 2 ** 20, equal_bits=same,
                   cap=getattr(op, "cap", None))
        rows.append(row)
        print(f"[14a] {method} type-{kind} d={d} {prec} n={x.shape[0]} "
              f"mtot={mtot} B={B}"
              f"{'' if row['cap'] is None else ' cap ' + str(row['cap'])}: "
              f"rel err {err:.3e} (bar {SPREAD_BAR[x.dtype]:.0e}; the exact "
              f"kernel {exact_err:.3e}, the two apart {vs_exact:.3e}); "
              f"{ms:.3f} ms warm, {first_ms:.3f} ms first call with its "
              f"plan (make_nufft {make_ms:.2f} ms host), exact kernel "
              f"{exact_ms:.3f} ms; peak {peak / 2 ** 20:.1f} MB; equal "
              f"bits over two calls {same} {c.card}")
        check(err <= SPREAD_BAR[x.dtype], f"14a {method} type-{kind} d={d} "
              f"mtot={mtot} B={B} {prec}: error {err:.3e}")
        check(same or method == "spread", f"14a {method} type-{kind} d={d} "
              f"mtot={mtot} B={B}: two calls differ")
        del op, out1
    return rows


def spread_checks(c, x, h, mtot):
    """The adjoint identity of the banded pair and the NaN poison of a cap
    set too small, at one shape."""
    out = {}
    gen = np.random.default_rng(141)
    for dtype in (torch.float32, torch.float64):
        xd = x.to(dtype)
        cdtype = (torch.complex64 if dtype == torch.float32
                  else torch.complex128)

        def rnd(*shape):
            return torch.complex(
                *(torch.as_tensor(gen.standard_normal(shape), dtype=dtype,
                                  device=c.dev) for _ in range(2))).to(cdtype)
        v, f = rnd(x.shape[0]), rnd(mtot, mtot)
        op = c.nufft_mod.make_nufft(xd, h, mtot, method="banded")
        lhs = complex(torch.sum(op.type1(v).conj().to(torch.complex128)
                                * f.to(torch.complex128)))
        rhs = complex(torch.sum(v.conj().to(torch.complex128)
                                * op.type2(f).to(torch.complex128)))
        rel = abs(lhs - rhs) / abs(lhs)
        out[f"adjoint_rel_{dtype}".replace("torch.", "")] = rel
        print(f"[14a] banded adjoint <F* v, f> vs <v, F f> ({dtype}, n="
              f"{x.shape[0]}, mtot {mtot}): rel {rel:.3e} (bar "
              f"{SPREAD_ADJOINT_BAR[dtype]:.0e})")
        check(rel <= SPREAD_ADJOINT_BAR[dtype], f"14a adjoint {dtype}: {rel}")
    from gpquad_torch.ops.spread_banded import BandedNUFFT
    small = BandedNUFFT(x, h, mtot, cap=8)
    poison = (bool(torch.isnan(small.type1(v.to(torch.complex64))).all()),
              bool(torch.isnan(small.type2(f.to(torch.complex64))).all()))
    out["nan_poison"] = poison
    print(f"[14a] banded with cap 8 at n={x.shape[0]}, mtot {mtot}: type-1 "
          f"all NaN {poison[0]}, type-2 all NaN {poison[1]}")
    check(all(poison), "14a: a cap too small did not poison the output")
    return out


def phase_spread(c):
    """Phase 14.  ``c``: a namespace of main()'s dev, card, counters,
    gpquad_torch and its modules, phase 10's configuration, record and
    results (its mean against float64, its gradient), phase 4's headline
    fit and data, and phase 6's d=3 grid.  Returns the phase's record."""
    gt, nm, cn, dev, card = c.gt, c.nufft_mod, c.cuda_nufft, c.dev, c.card
    rec = {}
    t0 = time.perf_counter()
    # -- 14a: the backends against the exact kernels -----------------------
    xs, ys, xqs = scale_data(c.n10)
    x2 = torch.as_tensor(xs, dtype=torch.float32, device=dev)
    xd3 = torch.as_tensor(data_3d(c.n_d3, 10_000, seed=3)[0],
                          dtype=torch.float32, device=dev)
    rows = []
    d2 = ("spread", "banded", "sub")
    for mtot, B in ((c.mtot10, 1), (2 * c.mtot10 - 1, 1), (c.mtot10, 5)):
        for kind in (1, 2):
            rows += spread_backend_case(c, x2, c.h10, mtot, B, kind, d2)
    for mtot in (c.mtot_d3, 2 * c.mtot_d3 - 1):
        for kind in (1, 2):
            rows += spread_backend_case(c, xd3, c.h_d3, mtot, 1, kind,
                                        ("banded", "sub"))
    for kind in (1, 2):
        rows += spread_backend_case(c, x2.double(), c.h10, c.mtot10, 1, kind,
                                    ("banded",))
    rec["14a"] = dict(rows=rows, **spread_checks(c, x2, c.h10, c.mtot10))
    del xd3
    torch.cuda.empty_cache()
    rec["14a_s"] = time.perf_counter() - t0

    # -- 14b: the scale configuration on nufft_method="banded" -------------
    t1 = time.perf_counter()
    y2 = torch.as_tensor(ys, dtype=torch.float32, device=dev)
    xq2 = torch.as_tensor(xqs, dtype=torch.float32, device=dev)
    kw = dict(solver="cg", precond="kron", fft_smooth=True,
              nufft_method="banded", device=dev)
    reset_counts(*c.counters)
    t = time.perf_counter()
    caps = gt.models.efgp.plan_nufft_caps(x2, c.h10, c.mtot10)
    plan_ms = (time.perf_counter() - t) * 1e3
    kw["nufft_caps"] = caps

    def fit_mean():
        st_ = gt.fit_with_grid(x2, y2, c.kern10, c.sigmasq, c.h10, c.mtot10,
                               cg_tol=1e-6, max_cg_iter=2000, **kw)
        return st_, gt.predict_mean(st_, xq2)

    (st, mean), fit_ms = timed(fit_mean)
    err = float((mean.double() - c.mean10_64).abs().max())
    picks_fit = dict(nm.BACKEND_PICKS)

    def grad(kern, s2, gen, **gkw):
        return gt.gradient_with_grid(x2, y2, kern, s2, c.h10, gen,
                                     mtot=c.mtot10, **kw, **gkw)

    gr, grad_ms = timed(lambda: grad(c.kern10, c.sigmasq, c.seeded(),
                                     trace_samples=10, cg_tol=1e-4,
                                     max_cg_iter=1000))
    grad_rel = float((gr.grad - c.grad10).abs().max()
                     / c.grad10.abs().max())
    params = gt.HyperState.create(c.kern10, c.sigmasq)
    raw = params.raw.to(dev).clone()
    adam = torch.optim.Adam([raw], lr=0.05)
    gen10 = c.seeded()

    def hyper_iter():
        p = params.replace_raw(raw.detach())
        res = grad(p.kernel_of(c.kern10), p.sig2, gen10, trace_samples=5,
                   cg_tol=1e-3, max_cg_iter=500)
        raw.grad = res.grad.to(raw.dtype) * torch.exp(raw.detach())
        adam.step()
        return res

    hyper_iter()                                           # warm
    raw.data.copy_(params.raw.to(dev))
    adam = torch.optim.Adam([raw], lr=0.05)
    t = time.perf_counter()
    loop_iters = [int(hyper_iter().trace_cg_iters) for _ in range(20)]
    sync()
    step_ms = (time.perf_counter() - t) / 20 * 1e3
    picks = dict(nm.BACKEND_PICKS)
    prof = profile_run(hyper_iter)
    p10 = c.scale_rec
    rec["14b"] = b = dict(
        caps=list(caps), plan_caps_ms=plan_ms, fit_mean_ms=fit_ms,
        kron_iters=int(st.mean_cg_iters), err_mean=err,
        grad_ms=grad_ms, grad_rel_vs_exact=grad_rel,
        grad_trace_iters=int(gr.trace_cg_iters),
        grad_mean_iters=int(gr.mean_cg_iters), loop_trace_iters=loop_iters,
        ms_per_adam_step=step_ms, picks_fit=picks_fit, picks=picks,
        profile=prof, learned_raw=raw.detach().tolist(),
        exact=dict(fit_mean_ms=p10["stages_s"]["fit_mean_s"] * 1e3,
                   kron_iters=p10["kron_iters"], err_mean=p10["err_mean"],
                   grad_ms=p10["stages_s"]["grad_s"] * 1e3,
                   ms_per_adam_step=p10["ms_per_adam_step"],
                   loop_trace_iters=p10["loop_trace_iters"]))
    print(f"[14b] scale n={c.n10} mtot={c.mtot10} on banded: caps "
          f"{list(caps)} planned in {plan_ms:.1f} ms (host); fit + mean "
          f"{fit_ms:.1f} ms (exact kernels, phase 10: "
          f"{b['exact']['fit_mean_ms']:.1f} ms), kron PCG iters "
          f"{b['kron_iters']} (phase 10: {p10['kron_iters']}); max|mean err| "
          f"vs the f64 kron fit {err:.3e} (bar {SCALE_MEAN_BAR:.0e}; phase "
          f"10: {p10['err_mean']:.3e}) {card}")
    print(f"[14b] gradient (T=10, phase 10's probes) {grad_ms:.1f} ms "
          f"(phase 10: {b['exact']['grad_ms']:.1f} ms), rel to phase 10's "
          f"{grad_rel:.3e} (bar {SCALE_GRAD_BAR:.0e}), trace PCG iters "
          f"{b['grad_trace_iters']}, mean {b['grad_mean_iters']}; 20 Adam "
          f"iterations {step_ms:.1f} ms per Adam step (host clock; phase 10 "
          f"on the exact kernels {p10['ms_per_adam_step']:.1f} ms), trace "
          f"iters {loop_iters}; backend_picks {picks} {card}")
    print_profile("[14b] profiled Adam step on banded:", prof, card)
    check(err <= SCALE_MEAN_BAR, f"14b: mean error {err:.3e}")
    check(grad_rel <= SCALE_GRAD_BAR, f"14b: gradient rel {grad_rel:.3e}")
    check(picks_fit["banded"] == 2 and picks["banded"] >= 2 + 2 * 21,
          f"14b: banded did not run {picks_fit} {picks}")
    check(b["kron_iters"] <= KRON_MAX_ITERS, "14b: kron iterations")
    check(all(bool(torch.isfinite(t_).all()) for t_ in (mean, gr.grad, raw)),
          "14b: non-finite output")
    del st, gr, x2, y2, xq2
    torch.cuda.empty_cache()
    rec["14b_s"] = time.perf_counter() - t1

    # -- 14c: the samplers ---------------------------------------------------
    t2 = time.perf_counter()
    shapes = {}
    originals = recorder(cn, shapes, KERNELS_2D + KERNELS_1D)
    try:
        rec["14c"] = sampler_checks(c)
    finally:
        for k, fn in originals.items():
            setattr(cn, k, fn)
    rec["14c"]["shapes"] = shape_table(c, shapes, SAMPLER_SHAPES, "14c")
    rec["14c_s"] = time.perf_counter() - t2
    return rec


def mstep_cancellation(c, seed):
    """13a's fixed-state M-step gradient (the float64 fit's state and
    final M-step probes) on pg_scale's labels from ``seed``: float32 on the
    kernels and on the plain path against float64, per component beside
    term1 and term2, whose half difference it is.  Holds the kernels'
    error to MSTEP_TERM_BAR of the larger term."""
    gt, dev, nm = c.gt, c.dev, c.nufft_mod
    from gpquad_torch.models import pg_core
    from gpquad_torch.ops import operators
    x, y, _ = pg_scale_data(gt, PG_N, seed, dev)
    est64 = gt.PolyagammaGPClassifier(dtype="float64", device=dev,
                                      **PG_CLF).fit(x, y)
    yt = torch.as_tensor((y == est64.classes_[1]).astype(np.float64),
                         device=dev)
    sp64, X64 = est64._spectral_state_, est64._X_train_t_
    kern = est64._make_kernel_obj(est64.lengthscale_, est64.variance_, 2)
    mask = gt.quadrature.flat_grid_mask(sp64.mtot, 2, est64._hm_,
                                        device=dev)
    lik = est64._make_likelihood()
    m_pr = est64._draw_probes(10_000 + PG_CLF["max_iter"] - 1,
                              (10, X64.shape[0]))
    make = nm.make_nufft
    res = {}
    try:
        for tag, rd, tol, method in (("f64", torch.float64, 1e-12, "auto"),
                                     ("kernels", torch.float32, 1e-6, "auto"),
                                     ("plain", torch.float32, 1e-6,
                                      "matmul")):
            def pick(*a, _m=method, **k):
                return make(*a, **dict(k, method=_m))
            pg_core.make_nufft = operators.make_nufft = pick
            X = X64.to(rd)
            sp = sp64 if rd == torch.float64 else \
                pg_core.build_pg_spectral_state(X, kern, float(sp64.h),
                                                mtot=sp64.mtot, ws_mask=mask)
            m = pg_core.mstep_gradient(sp, X, est64._delta_t_.to(rd),
                                       lik.kappa(yt.to(rd)), m_pr.to(rd),
                                       cg_tol=tol)
            res[tag] = [t.double().cpu().numpy()
                        for t in (m.grad, m.term1, m.term2)]
    finally:
        pg_core.make_nufft = operators.make_nufft = make
    g, t1, t2 = res["f64"]
    terms = np.maximum(np.abs(t1), np.abs(t2))
    out = dict(seed=seed, lengthscale=est64.lengthscale_,
               variance=est64.variance_, grad=g.tolist(), term1=t1.tolist(),
               term2=t2.tolist())
    for tag in ("kernels", "plain"):
        err = np.abs(res[tag][0] - g)
        out[f"{tag}_of_grad"] = (err / np.abs(g)).tolist()
        out[f"{tag}_of_terms"] = (err / terms).tolist()
    print(f"[14c] 13a's M-step gradient on pg_scale's labels of seed {seed} "
          f"(float64 fit l {est64.lengthscale_:.4f}, variance "
          f"{est64.variance_:.4f}): float64 grad {g.tolist()}, term1 "
          f"{t1.tolist()}, term2 {t2.tolist()}; float32 error per component "
          f"of |grad| on the kernels {out['kernels_of_grad']} and the plain "
          f"path {out['plain_of_grad']} (13a's bar {PG_BARS['mstep_grad']:.0e}"
          f", not held here); of the larger term: kernels "
          f"{out['kernels_of_terms']}, plain {out['plain_of_terms']} (bar "
          f"{MSTEP_TERM_BAR:.0e})")
    check(max(out["kernels_of_terms"]) <= MSTEP_TERM_BAR,
          f"14c: the float32 M-step gradient of seed {seed} is "
          f"{max(out['kernels_of_terms']):.3e} of its terms")
    return out


def sampler_checks(c):
    """14c's sampler runs and checks."""
    gt, dev, card = c.gt, c.dev, c.card
    from gpquad_torch.models import sampling
    out = {}

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # examples/sampling.py's 1-D sizes, float32 as the example runs there
    x1 = torch.as_tensor(np.sort(np.random.default_rng(0).uniform(0, 1, 400)),
                         dtype=torch.float32, device=dev)[:, None]
    kern1 = gt.make_kernel("SE", 1, lengthscale=0.15, variance=1.0)
    y_dense = gt.sample_gp_dense(gen(1), x1, kern1, noise_variance=0.01,
                                 device=dev)
    y_spec, ms_spec = timed(lambda: gt.sample_gp_spectral(
        gen(2), x1, lengthscale=0.15, variance=1.0, device=dev))
    y_mat = gt.sample_gp_matern(gen(3), x1, nu=1.5, lengthscale=0.2,
                                noise_variance=0.01, device=dev)
    labels, _ = gt.sample_bernoulli_gp_spectral(gen(4), x1, lengthscale=0.2,
                                                variance=2.0, device=dev)
    model = gt.EFGP(x1, y_spec, kern1, sigmasq=0.01, eps=1e-4,
                    estimate_params=False, device=dev)
    xq1 = torch.linspace(0.1, 0.9, 50, device=dev)[:, None]
    mu, _ = model.predict(xq1, return_variance=False)
    st1 = model.state
    (pw1, it1, _), ms_pw1 = timed(lambda: sampling._pathwise_draw(
        x1, y_spec, st1.ws, st1.sigmasq, st1.toeplitz, st1.h, xq1, gen(11),
        mtot=st1.mtot, num_samples=512, cg_tol=1e-8,
        max_cg_iter=PATHWISE_MAX_ITER))
    dev1 = float((pw1.mean(0) - mu).abs().max())
    out["1d"] = dict(spectral_ms=ms_spec, pathwise_ms=ms_pw1,
                     pathwise_iters=int(it1), mtot=st1.mtot,
                     pathwise_mean_dev=dev1,
                     positive_rate=float(labels.mean()))
    print(f"[14c] examples/sampling.py (n 400, d=1, float32): dense sd "
          f"{float(y_dense.std()):.3f}, spectral sd {float(y_spec.std()):.3f}"
          f" ({ms_spec:.2f} ms), matern sd {float(y_mat.std()):.3f}, "
          f"bernoulli positive rate {float(labels.mean()):.2f}; pathwise 512 "
          f"draws at 50 targets (mtot {st1.mtot}) {ms_pw1:.2f} ms, CG "
          f"{int(it1)} iterations (cap {PATHWISE_MAX_ITER}), mean vs "
          f"predict max dev {dev1:.3f} (the example's bar 0.2) {card}")
    check(all(bool(torch.isfinite(t_).all())
              for t_ in (y_dense, y_spec, y_mat, pw1)), "14c: 1-D samples")
    check(dev1 < 0.2, f"14c: pathwise mean deviates {dev1:.3f}")

    # 64 spectral draws at n 1e5 in 2-D (the batched type-2)
    s64, ms64 = timed(lambda: gt.sample_gp_spectral(
        gen(5), c.x32, lengthscale=0.1, variance=1.0, num_samples=64,
        device=dev))
    out["2d_64"] = dict(ms=ms64, shape=list(s64.shape),
                        sd=float(s64.std()))
    print(f"[14c] sample_gp_spectral n={c.x32.shape[0]} d=2, 64 draws (l "
          f"0.1): {ms64:.2f} ms host clock, shape {tuple(s64.shape)}, sd "
          f"{float(s64.std()):.3f} {card}")
    check(tuple(s64.shape) == (c.x32.shape[0], 64)
          and bool(torch.isfinite(s64).all()), "14c: 2-D spectral draws")
    del s64

    # 13a's float32 M-step gradient on pg_scale's labels from the second
    # seed, on the kernels and on the plain path, beside its terms
    out["mstep_seed1"] = mstep_cancellation(c, 1)

    # tests/test_sampling.py:33-44 on the card
    rng = np.random.default_rng(0)
    x25 = torch.as_tensor(rng.uniform(0, 1, size=(25, 1)), device=dev)
    k25 = gt.make_kernel("SE", 1, lengthscale=0.3, variance=1.0)
    S = gt.sample_gp_spectral(gen(2), x25, lengthscale=0.3, variance=1.0,
                              num_samples=30000, spectral_eps=1e-6,
                              trunc_eps=1e-6, device=dev)
    cov_err = float((S @ S.T / 30000 - k25.kernel_matrix(x25, x25)).abs()
                    .max())
    out["covariance_err"] = cov_err
    print(f"[14c] spectral covariance (25 points, 30 000 draws, float64): "
          f"max err {cov_err:.4f} (bar 0.05)")
    check(cov_err < 0.05, f"14c: spectral covariance {cov_err:.4f}")

    # the pathwise sampler on the headline state: 16 draws at 10 000
    # targets at the sampler's default CG cap, then with room to converge;
    # each set's mean against predict_mean within 5 standard errors of the
    # exact ("regular") variance
    st = c.st
    mu = gt.predict_mean(st, c.xq32).double()
    var = gt.predict_var(st, c.xq32, method="regular", cg_tol=1e-5,
                         max_cg_iter=600).double()
    out["headline"] = {}
    for cap in (PATHWISE_MAX_ITER, PATHWISE_ROOM):
        (pw, it, rel), ms_pw = timed(lambda: sampling._pathwise_draw(
            c.x32, c.y32, st.ws, st.sigmasq, st.toeplitz, st.h, c.xq32,
            gen(6), mtot=st.mtot, num_samples=16, cg_tol=1e-6,
            max_cg_iter=cap))
        z = float(((pw.double().mean(0) - mu).abs()
                   / torch.sqrt(var / 16)).max())
        r = out["headline"][cap] = dict(
            ms=ms_pw, iters=int(it), rel_resid=float(rel.max()),
            converged=bool((rel < 1e-6).all()), mean_z=z, mtot=st.mtot)
        print(f"[14c] sample_posterior_pathwise on the headline state (n "
              f"{c.x32.shape[0]}, mtot {st.mtot}, float32): 16 draws at "
              f"{c.xq32.shape[0]} targets {ms_pw:.1f} ms host clock, CG "
              f"{r['iters']} iterations (cap {cap}, cg_tol 1e-6), largest "
              f"relative residual {r['rel_resid']:.3e} (converged "
              f"{r['converged']}); mean within {z:.2f} standard errors of "
              f"predict_mean (bar 5) {card}")
        check(tuple(pw.shape) == (16, c.xq32.shape[0])
              and bool(torch.isfinite(pw).all()), "14c: headline pathwise")
        check(z < 5, f"14c: headline pathwise mean {z:.2f} standard errors "
              f"from predict_mean (cap {cap})")
    check(out["headline"][PATHWISE_ROOM]["converged"],
          f"14c: the headline pathwise CG did not converge in "
          f"{PATHWISE_ROOM} iterations")

    # tests/test_sampling.py:64-88 on the card
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(0, 1, (120, 1)), device=dev)
    y = torch.sin(6 * x[:, 0]) + 0.2 * torch.as_tensor(
        rng.normal(size=120), device=dev)
    kern = gt.make_kernel("SE", 1, lengthscale=0.2, variance=1.0)
    st = gt.fit(x, y, kern, 0.05, eps=1e-5, cg_tol=1e-10, device=dev)
    xq = torch.as_tensor(np.linspace(0.05, 0.95, 7)[:, None], device=dev)
    mean = gt.predict_mean(st, xq)
    var = gt.predict_var(st, xq, method="regular", cg_tol=1e-10)
    S = 4000
    samp = gt.sample_posterior_pathwise(x, y, st, xq, gen(0), num_samples=S,
                                        cg_tol=1e-10)
    z = ((samp.mean(0) - mean).abs() / torch.sqrt(var / S)).max()
    rel = ((samp.var(0) - var).abs() / var).max()
    out["pathwise_stats"] = dict(mean_z=float(z), var_rel=float(rel),
                                 var_bar=6 * (2.0 / S) ** 0.5)
    print(f"[14c] pathwise statistics (n 120, 4 000 draws, float64): mean "
          f"within {float(z):.2f} standard errors (bar 5), variance rel "
          f"{float(rel):.4f} (bar {6 * (2.0 / S) ** 0.5:.4f})")
    check(float(z) < 5 and float(rel) < 6 * (2.0 / S) ** 0.5,
          "14c: pathwise statistics")
    return out


# phase 15: the utilities.  15a the profiling scopes that gpquad names
# (ops/nufft.py:93,157, ops/toeplitz.py:65, ops/cg.py:70) in traces of phase
# 4's fused call (the dense tier: no PCG), phase 5's kron CG fit and mean
# and one light-curve Adam iteration (with the facade's refit), each scope
# with a CUDA kernel launched inside it, and what a scope costs with no
# profiler; 15b phase 9's facade saved and restored; 15c the native C++
# float64 oracles against the float64 d=2 pair; 15d the synthetic-GP
# loader.
SCOPES = ("nufft_type1", "nufft_type2", "toeplitz_matvec", "4_solve_cg",
          "7_batch_cg_solve")
STAGE_SHARE_BAR = 0.01      # the scopes' host cost with no profiler
STAGE_ENTRIES_TIMED = 200_000
NATIVE_N, NATIVE_MTOT = 20_000, 29
# the float64 type-2 of load_synthetic_gp(n=1e5, d=2): l 0.5 and
# spectral_eps 1e-4 on [0,1]^2 plan mtot 11
LOADER_SHAPES = frozenset([("nufft2_2d", "f64", 100000, 11, 1, False)])


def trace_scopes(log_dir, names):
    """Per scope name in ``names``: its entries in the Chrome trace that
    ``profiling.trace`` wrote to ``log_dir``, and the CUDA kernels launched
    inside them (a launch on the scope's thread within its span, matched
    to its kernel by correlation id) with their names."""
    from gpquad_torch.utils import profiling
    events = json.loads((log_dir / profiling.TRACE_FILE).read_text())[
        "traceEvents"]
    kernels = {e["args"]["correlation"]: e["name"] for e in events
               if e.get("cat") == "kernel"
               and "correlation" in e.get("args", {})}
    launches = [e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("args", {}).get("correlation") in kernels]
    out = {name: dict(entries=0, kernels=0, names={}) for name in names}
    for e in events:
        r = out.get(e.get("name"))
        if r is not None and e.get("cat") == "user_annotation":
            r["entries"] += 1
            t0, t1 = e["ts"], e["ts"] + e.get("dur", 0)
            for launch in launches:
                if (launch.get("pid"), launch.get("tid")) == (
                        e.get("pid"), e.get("tid")) and \
                        t0 <= launch["ts"] <= t1:
                    r["kernels"] += 1
                    k = kernels[launch["args"]["correlation"]]
                    r["names"][k] = r["names"].get(k, 0) + 1
    return out


def phase_utils(c):
    """Phase 15.  ``c``: a namespace of main()'s dev, card, gpquad_torch,
    cuda_nufft, phase 3's kernels and plain versions, phase 4's data, fit
    settings, fused call and its ms, phase 5's kron CG fit, phase 8's
    facade maker and its ms an iteration, and phase 9's facade.  Returns
    the phase's record."""
    from gpquad_torch import native
    from gpquad_torch.utils import checkpoint, loaders, profiling
    gt, dev, card = c.gt, c.dev, c.card
    rec = {}
    out_dir = ROOT / "build" / "phase15"
    shutil.rmtree(out_dir, ignore_errors=True)

    # -- 15a: the profiling scopes ----------------------------------------
    t_a = time.perf_counter()
    traces = {}
    for tag, fn in (("fused", c.fused), ("cg_kron", c.cg_kron),
                    ("lightcurve_iteration", c.lc_iteration)):
        fn()
        sync()
        with profiling.trace(out_dir / tag) as log_dir:
            fn()
        traces[tag] = trace_scopes(log_dir, SCOPES + profiling.STAGES)
        for name in SCOPES:
            r = traces[tag][name]
            top = sorted(r["names"].items(), key=lambda kv: -kv[1])[:3]
            print(f"[15a] {tag} trace: scope {name}: {r['entries']} entries,"
                  f" {r['kernels']} CUDA kernels launched inside; kernels "
                  f"{[(k[:60], n_) for k, n_ in top]}")

    def held(name):
        return any(tr[name]["kernels"] > 0 for tr in traces.values())
    for name in ("nufft_type1", "nufft_type2", "toeplitz_matvec"):
        check(held(name), f"15a: no trace holds scope {name} with a CUDA "
              f"kernel inside it")
    check(held("4_solve_cg") or held("7_batch_cg_solve"),
          "15a: no trace holds a PCG scope with a CUDA kernel inside it")
    rec["traces"] = {tag: {k: dict(v, names=dict(sorted(
        v["names"].items(), key=lambda kv: -kv[1])[:8]))
        for k, v in tr.items() if v["entries"]} for tag, tr in
        traces.items()}

    # StageTimer on the headline serving path and gradient (phase 4's
    # settings), three rounds
    timer = profiling.StageTimer()
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(3):
        with timer.time("fit", sync=c.x32):
            st = gt.fit(c.x32, c.y32, c.kernel32, c.sigmasq, eps=c.eps,
                        cg_tol=1e-6, device=dev)
        with timer.time("mean", sync=c.x32):
            gt.predict_mean(st, c.xq32)
        with timer.time("variance", sync=c.x32):
            gt.predict_var(st, c.xq32, method="stochastic", probes=256,
                           cg_tol=1e-4, generator=gen)
        with timer.time("gradient", sync=c.x32):
            gt.gradient_with_grid(
                c.x32, c.y32, c.kernel32, c.sigmasq, st.h, gen,
                mtot=st.mtot, trace_samples=FUSED_KW["trace_samples"],
                cg_tol=FUSED_KW["grad_cg_tol"],
                max_cg_iter=FUSED_KW["max_cg_iter"], beta0=st.beta, state=st)
    print(f"[15a] StageTimer, the headline (phase 4's data), host clock "
          f"with the card synchronised, {card}:")
    for line in timer.table().splitlines():
        print(f"[15a]   {line}")
    rec["stage_timer_s"] = timer.records

    # a scope with no profiler, on the host, against the paths' wall time
    t = time.perf_counter()
    for _ in range(STAGE_ENTRIES_TIMED):
        with profiling.stage("toeplitz_matvec"):
            pass
    stage_us = (time.perf_counter() - t) / STAGE_ENTRIES_TIMED * 1e6
    rec["stage_us"] = stage_us
    rec["share"] = {}
    for tag, wall_ms in (("fused", c.fused_ms),
                         ("lightcurve_iteration", c.lc_iter_ms)):
        entries = sum(v["entries"] for v in traces[tag].values())
        share = stage_us * entries / (wall_ms * 1e3)
        rec["share"][tag] = dict(entries=entries, wall_ms=wall_ms,
                                 share=share)
        print(f"[15a] stage() with no profiler: {stage_us:.3f} us an entry "
              f"(host); {tag}: {entries} scope entries x {stage_us:.3f} us "
              f"= {stage_us * entries:.1f} us of {wall_ms:.2f} ms, share "
              f"{share:.2e} (bar {STAGE_SHARE_BAR}) {card}")
        check(share < STAGE_SHARE_BAR, f"15a: the scopes take {share:.2e} "
              f"of the {tag} path")
    rec["15a_s"] = time.perf_counter() - t_a

    # -- 15b: checkpoint ----------------------------------------------------
    t_b = time.perf_counter()
    m9, ck = c.m9, out_dir / "ckpt"
    checkpoint.save_efgp(m9, ck)
    m2 = gt.EFGP(c.x32, c.y32, "SE", sigmasq=0.5, eps=c.eps, device=dev)
    checkpoint.restore_efgp(m2, ck)
    raw_equal = torch.equal(m2.params.raw, m9.params.raw)
    mean1, var1 = m9.predict(c.xq32, hutchinson_probes=256)
    mean2, var2 = m2.predict(c.xq32, hutchinson_probes=256)
    same = torch.equal(mean1, mean2) and torch.equal(var1, var2)
    (_, step_ms) = timed(lambda: m2.optimize_hyperparameters(
        max_iters=1, lr=0.05, trace_samples=10))
    cpu_tree = checkpoint.restore_checkpoint(ck, device="cpu")
    cpu_equal = (cpu_tree["raw"].device.type == "cpu"
                 and torch.equal(cpu_tree["raw"], m9.params.raw.cpu()))
    rec["15b"] = dict(raw_equal=raw_equal, predict_same_bits=same,
                      step_ms=step_ms, cpu_raw_equal=cpu_equal,
                      raw=m9.params.raw.tolist(),
                      raw_after_step=m2.params.raw.tolist(),
                      files={p_.name: p_.stat().st_size
                             for p_ in sorted(ck.iterdir())})
    print(f"[15b] save_efgp of phase 9's facade, restore_efgp into an EFGP "
          f"built with sigmasq 0.5: raw equal {raw_equal}; predict at "
          f"{c.xq32.shape[0]} targets (mean and the 256-probe stochastic "
          f"variance) the same bits {same}; one more Adam step "
          f"{step_ms:.1f} ms host clock, raw {m2.params.raw.tolist()}; "
          f"restored with device='cpu': raw equal {cpu_equal}; files "
          f"{rec['15b']['files']} {card}")
    check(raw_equal and same and cpu_equal,
          "15b: the restored facade differs")
    check(bool(torch.isfinite(m2.params.raw).all()),
          "15b: the resumed Adam step is not finite")
    rec["15b_s"] = time.perf_counter() - t_b

    # -- 15c: the native float64 oracles ------------------------------------
    t_c = time.perf_counter()
    check(native.build(), "15c: native/libgpquad_native.so did not build "
          "(scripts/build_native.sh)")
    g = np.random.default_rng(150)
    xn = g.uniform(0, 1, (NATIVE_N, 2))
    vn = g.normal(size=NATIVE_N) + 1j * g.normal(size=NATIVE_N)
    fn_ = (g.normal(size=(NATIVE_MTOT,) * 2)
           + 1j * g.normal(size=(NATIVE_MTOT,) * 2))
    h, m = float(c.h_head), NATIVE_MTOT
    xt = torch.as_tensor(xn, device=dev)
    rec["15c"] = {}
    for name, arg, direct in (("nufft1_2d", vn, native.direct_nufft1_2d),
                              ("nufft2_2d", fn_, native.direct_nufft2_2d)):
        at = torch.as_tensor(arg, device=dev)
        got = c.kernels[name](xt, at, h, mtot=m).cpu().numpy()
        plain = c.plains[name](xt, at, h, mtot=m).cpu().numpy()
        t = time.perf_counter()
        ref = direct(xn, arg, h, m)
        ms = (time.perf_counter() - t) * 1e3
        scale = float(np.abs(ref).max())
        rel = float(np.abs(got - ref).max()) / scale
        rel_plain = float(np.abs(plain - ref).max()) / scale
        rec["15c"][name] = dict(rel_err=rel, plain_rel_err=rel_plain,
                                native_ms=ms)
        print(f"[15c] float64 {name} (n {NATIVE_N}, mtot {m}) against the "
              f"C++ oracle: rel err {rel:.3e} of max|ref| (bar 1e-10); the "
              f"plain version {rel_plain:.3e}; the oracle {ms:.1f} ms host "
              f"{card}")
        check(rel <= 1e-10, f"15c: {name} f64 vs the C++ oracle {rel:.3e}")
    rec["15c_s"] = time.perf_counter() - t_c

    # -- 15d: the synthetic-GP loader ---------------------------------------
    t_d = time.perf_counter()
    shapes = {}
    originals = recorder(c.cuda_nufft, shapes, KERNELS_2D)
    try:
        (xa, ya), load_ms = timed(lambda: loaders.load_synthetic_gp(
            n=100_000, d=2, seed=0, device=dev))
        xb, yb = loaders.load_synthetic_gp(n=100_000, d=2, seed=0,
                                           device=dev)
    finally:
        for k, fn in originals.items():
            setattr(c.cuda_nufft, k, fn)
    x_numpy = np.array_equal(
        xa, np.random.default_rng(0).uniform(0, 1, (100_000, 2)))
    twice = np.array_equal(xa, xb) and np.array_equal(ya, yb)
    rec["15d"] = dict(ms=load_ms, x_is_numpys=x_numpy, same_bits=twice,
                      y_sd=float(np.std(ya)),
                      launches={"/".join(map(str, k)): v
                                for k, v in shapes.items()})
    print(f"[15d] load_synthetic_gp(n=100000, d=2, seed=0): {load_ms:.1f} "
          f"ms host clock {card}; x equals numpy's draw {x_numpy}; two calls"
          f" the same bits {twice}; y sd {np.std(ya):.4f}; launches "
          f"{rec['15d']['launches']}")
    check(xa.shape == (100_000, 2) and ya.shape == (100_000,)
          and bool(np.isfinite(ya).all()), "15d: the loader's draw")
    check(x_numpy and twice, "15d: the loader is not reproducible")
    check(any(k[0].startswith("nufft2_2d") for k in shapes),
          f"15d: the loader launched no d=2 type-2 {shapes}")
    rec["15d"]["shapes"] = shape_table(c, shapes, LOADER_SHAPES, "15d")
    rec["15d_s"] = time.perf_counter() - t_d
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "gpquad_torch" / "csrc").is_dir():
        print(f"chip_smoke: gpquad_torch not found beside {__file__}",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))
    import gpquad_torch
    from gpquad_torch.models import efgp as efgp_mod
    from gpquad_torch import quadrature
    from gpquad_torch.ops import cuda_nufft, nufft as nufft_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record = {"phases": {}}
    phase_s = {}
    t_run = time.perf_counter()

    # -- phase 1: the card -------------------------------------------------
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip()
    card = f"[{smi_line}]"
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"[1] device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()} cc "
          f"{torch.cuda.get_device_capability(0)}")
    print(f"[1] nvidia-smi: {smi_line}")
    record["card"] = smi_line

    # -- phase 2: build ------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, log = cuda_nufft.build()
    build_s = time.perf_counter() - t0
    print(f"[2] built {lib_path.relative_to(ROOT)} in {build_s:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print(f"[2] ptxas: {line.strip()}")
    record["phases"]["build_s"] = build_s
    phase_s["1-2"] = time.perf_counter() - t_run

    # -- phase 3: kernels against their plain versions ----------------------
    t_phase = time.perf_counter()
    xh, yh, xnew = headline_data(100_000, 10_000)
    xh2, yh2, xnew2 = headline_data(100_000, 2_000, seed=1)
    xd3, yd3, xqd3 = data_3d(100_000, 10_000, seed=3)
    xh3, yh3, xqh3 = data_3d(20_000, 1_000, seed=4)
    kernel32 = gpquad_torch.make_kernel("SE", 2, lengthscale=np.float32(0.1),
                                        variance=np.float32(1.0))
    kern_hard = gpquad_torch.make_kernel("SE", 2, lengthscale=np.float32(0.02),
                                         variance=np.float32(1.0))
    kern_d3 = gpquad_torch.make_kernel("SE", 3, lengthscale=np.float32(0.1),
                                       variance=np.float32(1.0))
    kern_h3 = gpquad_torch.make_kernel("SE", 3, lengthscale=np.float32(0.2),
                                       variance=np.float32(1.0))

    def path_grid_eps(kern, xs, eps):
        """(h, mtot) as fit plans them for the float32 points ``xs``."""
        x = torch.as_tensor(xs, dtype=torch.float32)
        L = float((x.max(dim=0).values - x.min(dim=0).values).max())
        _, h, mtot = gpquad_torch.spectral_grid(kern, eps, L)
        return h, mtot

    def path_grid(kern, xs):
        return path_grid_eps(kern, xs, 1e-6)

    h_head, mtot_head = path_grid(kernel32, xh)
    h_hard, mtot_hard = path_grid(kern_hard, xh2)
    # the d=3 paths take bench.py's grid for [0,1]^3 (bench.py:387)
    _, h_d3, mtot_d3 = gpquad_torch.spectral_grid(kern_d3, 1e-6, 1.0)
    _, h_h3, mtot_h3 = gpquad_torch.spectral_grid(kern_h3, 1e-6, 1.0)
    check((mtot_d3, mtot_h3) == (31, 21),
          f"d=3 grids planned mtot {mtot_d3} and {mtot_h3}, not 31 and 21")
    # phase 8: the light curve's grid at its starting hypers and the rung
    # its gradient steps run on
    lc = lightcurve_data()
    kern_lc = gpquad_torch.make_kernel("SE", 1, lengthscale=np.float32(0.0015),
                                       variance=np.float32(1.0))
    h_lc, mtot_lc = path_grid_eps(kern_lc, lc["x"][:, None], 1e-4)
    rung_lc = quadrature.bucket_mtot(mtot_lc)
    check((len(lc["x"]), mtot_lc, rung_lc) == (63_480, 919, 1031),
          f"light curve: n {len(lc['x'])}, mtot {mtot_lc}, rung {rung_lc}")
    # phase 10: bench.py's scale configuration on [0,1]^2
    kern10 = gpquad_torch.make_kernel("SE", 2, lengthscale=np.float32(0.006),
                                      variance=np.float32(1.0))
    _, h10, mtot10 = gpquad_torch.spectral_grid(kern10, 1e-6, 1.0)
    check(mtot10 == 339, f"scale configuration planned mtot {mtot10}")
    m_lag = 2 * mtot_head - 1
    gen = np.random.default_rng(1)
    # (kernel, n, mtot, fft_order, h, what it serves, B): every call of the
    # driven paths, at its shape
    shapes = [
        ("nufft1_2d", 100_000, mtot_head, False, h_head, "F*y", 1),
        ("nufft1_2d", 100_000, m_lag, False, h_head, "lag table", 1),
        ("nufft2_2d", 10_000, mtot_head, False, h_head, "mean", 1),
        ("nufft2_2d", 10_000, m_lag, True, h_head, "variance evaluation", 1),
        ("nufft2_2d", 100_000, mtot_head, False, h_head, "gradient F(D beta)",
         1),
        ("nufft1_2d_batched", 100_000, mtot_head, False, h_head,
         "gradient F*Z", 10),
        ("nufft2_2d_batched", 100_000, mtot_head, False, h_head,
         "gradient F(D'F*Z), F(D Beta)", 10),
        ("nufft1_2d", 100_000, mtot_hard, False, h_hard, "CG tier F*y", 1),
        ("nufft1_2d", 100_000, 2 * mtot_hard - 1, False, h_hard,
         "CG tier lag table", 1),
        ("nufft2_2d", 2_000, mtot_hard, False, h_hard, "CG tier mean", 1),
        ("nufft2_2d", 100_000, mtot_hard, False, h_hard,
         "CG tier gradient F(D beta)", 1),
        ("nufft1_2d_batched", 100_000, mtot_hard, False, h_hard,
         "CG tier gradient F*Z", 10),
        ("nufft2_2d_batched", 100_000, mtot_hard, False, h_hard,
         "CG tier gradient F(D'F*Z), F(D Beta)", 10),
    ]
    # the scale path (phase 10, n = 1e6) at its own shapes, past the TPU's
    # 256-mode block: the fit's F*y and lag table, the mean and the variance
    # evaluation, the gradient's F(D beta) and probe batches (B 10, and B 5
    # in its Adam loop)
    n10, lag10 = 1_000_000, 2 * mtot10 - 1
    shapes += [
        ("nufft1_2d", n10, mtot10, False, h10, "scale F*y", 1),
        ("nufft1_2d", n10, lag10, False, h10, "scale lag table", 1),
        ("nufft2_2d", 2_000, mtot10, False, h10, "scale mean", 1),
        ("nufft2_2d", 1_000, lag10, True, h10, "scale variance evaluation",
         1),
        ("nufft2_2d", n10, mtot10, False, h10, "scale gradient F(D beta)", 1),
    ]
    for B in (10, 5):
        shapes += [
            ("nufft1_2d_batched", n10, mtot10, False, h10,
             "scale gradient F*Z", B),
            ("nufft2_2d_batched", n10, mtot10, False, h10,
             "scale gradient F(D'F*Z), F(D Beta)", B),
        ]
    for tag, n, nq, m, h in (("d3", 100_000, 10_000, mtot_d3, h_d3),
                             ("hard3d", 20_000, 1_000, mtot_h3, h_h3)):
        shapes += [
            ("nufft1_3d", n, m, False, h, f"{tag} F*y", 1),
            ("nufft1_3d", n, 2 * m - 1, False, h, f"{tag} lag table", 1),
            ("nufft2_3d", nq, m, False, h, f"{tag} mean", 1),
            ("nufft2_3d", nq, 2 * m - 1, True, h,
             f"{tag} variance evaluation", 1),
            ("nufft2_3d", n, m, False, h, f"{tag} gradient F(D beta)", 1),
            ("nufft1_3d", n, m, False, h, f"{tag} gradient F*Z", 10),
            ("nufft2_3d", n, m, False, h,
             f"{tag} gradient F(D'F*Z), F(D Beta)", 10),
        ]
    for name in KERNELS_3D:
        for m in (57, 101, 255):
            shapes.append((name, 20_000, m, False, 0.97, "slab-tiled mtot",
                           1))
    n_lc, lag_lc = len(lc["x"]), 2 * rung_lc - 1
    shapes += [
        ("nufft1_1d", n_lc, rung_lc, False, h_lc, "light curve F*y", 1),
        ("nufft1_1d", n_lc, lag_lc, False, h_lc, "light curve lag table", 1),
        ("nufft2_1d", 5_000, rung_lc, False, h_lc, "light curve mean", 1),
        ("nufft2_1d", 5_000, lag_lc, True, h_lc,
         "light curve variance evaluation", 1),
        ("nufft2_1d", n_lc, rung_lc, False, h_lc,
         "light curve gradient F(D beta)", 1),
        ("nufft1_1d", n_lc, rung_lc, False, h_lc, "light curve F*Z", 10),
        ("nufft2_1d", n_lc, rung_lc, False, h_lc,
         "light curve F(D'F*Z), F(D Beta)", 10),
    ]
    for name in KERNELS_1D:
        # the dense tier's widest lag table (M <= 4096)
        shapes.append((name, 20_000, 8191, False, 0.97, "mtot 8191", 1))
    kernels = {k: getattr(cuda_nufft, k) for k in KERNELS_NUFFT}
    plains = {k: getattr(cuda_nufft, k + "_ref") for k in KERNELS_NUFFT}

    def plain64(name, x, arg, h, kw, chunk=200_000):
        """The float64 plain version over chunks of at most ``chunk`` points
        (their (chunk, mtot) phase matrices; at n = 1e6 and mtot 677 the
        whole would take 33 GB): type-1 adds the chunks' sums, type-2 joins
        their outputs."""
        x, arg = x.double(), arg.to(torch.complex128)
        type1 = name.startswith("nufft1")
        parts = [plains[name](x[i:i + chunk],
                              arg[..., i:i + chunk] if type1 else arg, h,
                              **kw)
                 for i in range(0, x.shape[0], chunk)]
        return sum(parts) if type1 else torch.cat(parts, dim=-1)

    def type2_both(x, f, hq, m, fo, n, B, ref, scale, got, split_bar, reps,
                   trials):
        """The float32 batched type-2 on both of its kernels, the tensor
        cores ("tc") and the CUDA cores ("cuda"), on the same inputs: each
        within 1e-4 of max|ref| (the tensor cores also within
        ``split_bar``), bit for bit against a second launch, timed; the
        wrapper's result bit for bit that of the kernel type2_2d_geometry
        dispatches the shape to.  Returns the row's fields and a line for
        the log."""
        dispatch = cuda_nufft.type2_2d_geometry(m)[0]
        geos = {"tc": ("tc", cuda_nufft.TYPE2_2D_POINTS,
                       cuda_nufft.TYPE2_2D_COLS, cuda_nufft.TYPE2_2D_STAGE),
                "cuda": ("cuda",)}
        out = {"dispatch": dispatch}
        for r, geo in geos.items():
            def call():
                return cuda_nufft._nufft2_2d_batched_on(x, f, hq, m, fo, geo)
            what = f"nufft2_2d_batched ({r}) B={B} n={n} mtot={m}"
            sync()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            o = call()
            sync()
            scratch = (torch.cuda.max_memory_allocated() - base
                       - o.numel() * o.element_size())
            rel = float((o.to(torch.complex128) - ref).abs().max()) / scale
            check(np.isfinite(rel) and rel <= 1e-4,
                  f"{what}: error {rel:.3e} of max|ref| > 1e-4")
            if r == "tc":
                check(rel <= split_bar,
                      f"{what}: error {rel:.3e} over max(2 x the plain "
                      f"version's, 1e-6) = {split_bar:.3e}")
                check(scratch < 256e6, f"{what}: scratch {scratch} bytes "
                      f">= 256 MB")
                out["tc_scratch_bytes"] = scratch
                out["split_bar"] = split_bar
            check(torch.equal(call(), o), f"{what}: a second launch differs")
            if r == dispatch:
                check(torch.equal(got, o),
                      f"{what}: the wrapper's result is not this kernel's")
            key = "tc" if r == "tc" else "cuda_core"
            out[f"{key}_rel_err"] = rel
            out[f"{key}_ms"] = time_cuda(call, reps, trials)
        out["bound_3xtf32_ms"] = bound_3xtf32_ms("nufft2_2d_batched", n, m,
                                                 B)[0]
        faster = "tc" if out["tc_ms"] < out["cuda_core_ms"] else "cuda"
        out["dispatch_is_faster"] = faster == dispatch
        line = (f" dispatch {dispatch} (faster here: {faster}); tensor cores "
                f"ms={out['tc_ms']:.4f} rel={out['tc_rel_err']:.3e} scratch "
                f"{out['tc_scratch_bytes'] / 1e6:.3f} MB (measured) "
                f"bound_3xtf32_ms={out['bound_3xtf32_ms']:.4f}; CUDA cores "
                f"ms={out['cuda_core_ms']:.4f} "
                f"rel={out['cuda_core_rel_err']:.3e}")
        return out, line

    def type1_1d_both(x, v, hq, m, fo, n, B, ref, scale, got, split_bar,
                      reps):
        """The float32 d=1 type-1 on its two kernels on the same inputs:
        the tensor cores ("tc", the wrapper's path; type1_1d_geometry) and
        today's CUDA-core kernel ("cuda", 2048-point chunks), each within
        1e-4 of max|ref| (the tensor cores also within ``split_bar`` and
        within twice that of their twin nufft1_1d_3xtf32_ref, run on the
        card), bit for bit against a second launch; the card's time of
        each (time_cuda_paths, the paths in turn each round).  Returns the
        row's fields and a line for the log."""
        geos = {"tc": cuda_nufft.type1_1d_geometry(n, m, B),
                "cuda": ("cuda", cuda_nufft.TYPE1_CHUNK)}
        vb = v.reshape(B, n)
        calls = {r: (lambda geo=geo: cuda_nufft._nufft1_1d_on(
            x, vb, hq, m, fo, geo)) for r, geo in geos.items()}
        out = {"dispatch": "tc"}
        for r, call in calls.items():
            what = f"nufft1_1d ({r}) B={B} n={n} mtot={m}"
            o = call()
            sync()
            rel = float((o.reshape(got.shape).to(torch.complex128)
                         - ref).abs().max()) / scale
            check(np.isfinite(rel) and rel <= 1e-4,
                  f"{what}: error {rel:.3e} of max|ref| > 1e-4")
            check(torch.equal(call(), o), f"{what}: a second launch differs")
            if r == "tc":
                check(rel <= split_bar,
                      f"{what}: error {rel:.3e} over max(2 x the plain "
                      f"version's, 1e-6) = {split_bar:.3e}")
                check(torch.equal(o.reshape(got.shape), got),
                      f"{what}: the wrapper's result is not this kernel's")
                twin = cuda_nufft.nufft1_1d_3xtf32_ref(x, vb, hq, mtot=m,
                                                       fft_order=fo)
                diff = float((o - twin).abs().max())
                check(diff <= 2 * split_bar * scale,
                      f"{what}: {diff / scale:.3e} of max|ref| from its "
                      f"twin, over 2 x {split_bar:.3e}")
                out["twin_rel_diff"] = diff / scale
            key = "tc" if r == "tc" else "cuda_core"
            out[f"{key}_rel_err"] = rel
        ms = time_cuda_paths(calls, reps, PATH_TRIALS)
        out["tc_ms"], out["cuda_core_ms"] = ms["tc"], ms["cuda"]
        out["geometry"] = list(geos["tc"][1:])
        faster = min(ms, key=ms.get)
        check(faster == "tc" or ms["tc"] <= max(
            ms[faster] * (1 + DISPATCH_TIE[0]), ms[faster] + DISPATCH_TIE[1]),
            f"nufft1_1d B={B} n={n} mtot={m}: the tensor cores take "
            f"{ms['tc']:.4f} ms, the CUDA cores {ms['cuda']:.4f}")
        line = (f" on the card: tensor cores ms={ms['tc']:.4f} rel="
                f"{out['tc_rel_err']:.3e} (twin {out['twin_rel_diff']:.3e} "
                f"apart), CUDA cores ms={ms['cuda']:.4f} rel="
                f"{out['cuda_core_rel_err']:.3e}; geometry {geos['tc']}")
        return out, line

    def type2_1d_both(x, f, hq, m, fo, n, B, ref, scale, got, split_bar,
                      reps):
        """The float32 d=1 type-2 on its two kernels on the same inputs:
        the tensor cores ("tc", 3xTF32 on the split k = K q + r, with the
        tensor-core geometry of type2_1d_geometry's table) and the CUDA
        cores ("cuda"), each within 1e-4 of max|ref| (the tensor cores also
        within ``split_bar`` and within twice that of their twin
        nufft2_1d_3xtf32_ref, run on the card), bit for bit against a
        second launch; the wrapper's result bit for bit that of the path
        type2_1d_geometry picks, and that path the fastest on the card
        (time_cuda_paths, the paths in turn each round) within
        DISPATCH_TIE.  Returns the row's fields and a line for the log."""
        pick = cuda_nufft.type2_1d_geometry(n, m, B)
        tc_geo = cuda_nufft.type2_1d_tc_geometry(B)
        geos = {"tc": tc_geo, "cuda": ("cuda",)}
        fb = f.reshape(B, m)
        calls = {r: (lambda geo=geo: cuda_nufft._nufft2_1d_on(
            x, fb, hq, m, fo, geo)) for r, geo in geos.items()}
        out = {"dispatch": pick[0]}
        for r, call in calls.items():
            what = f"nufft2_1d ({r}) B={B} n={n} mtot={m}"
            o = call()
            sync()
            rel = float((o.reshape(got.shape).to(torch.complex128)
                         - ref).abs().max()) / scale
            check(np.isfinite(rel) and rel <= 1e-4,
                  f"{what}: error {rel:.3e} of max|ref| > 1e-4")
            check(torch.equal(call(), o), f"{what}: a second launch differs")
            if r == pick[0]:
                check(torch.equal(o.reshape(got.shape), got),
                      f"{what}: the wrapper's result is not this kernel's")
            if r == "tc":
                check(rel <= split_bar,
                      f"{what}: error {rel:.3e} over max(2 x the plain "
                      f"version's, 1e-6) = {split_bar:.3e}")
                twin = cuda_nufft.nufft2_1d_3xtf32_ref(
                    x, fb, hq, mtot=m, fft_order=fo, geometry=tc_geo)
                diff = float((o - twin).abs().max())
                check(diff <= 2 * split_bar * scale,
                      f"{what}: {diff / scale:.3e} of max|ref| from its "
                      f"twin, over 2 x {split_bar:.3e}")
                out["twin_rel_diff"] = diff / scale
            key = "tc" if r == "tc" else "cuda_core"
            out[f"{key}_rel_err"] = rel
        ms = time_cuda_paths(calls, reps, PATH_TRIALS)
        out["tc_ms"], out["cuda_core_ms"] = ms["tc"], ms["cuda"]
        out["geometry"] = list(tc_geo[1:])
        _, points, K, cols, _ = tc_geo
        Q = cuda_nufft.type1_1d_split(m, K)[1]
        kq = -(-Q // cuda_nufft.TYPE2_1D_KSTEP) * cuda_nufft.TYPE2_1D_KSTEP
        ncp = -(-B * K // cols) * cols
        # products made a point against the B mtot needed
        out["padding"] = kq * ncp / (B * m)
        out["bound_3xtf32_ms"] = bound_3xtf32_ms("nufft2_1d", n, m, B,
                                                 (K, Q))[0]
        faster = min(ms, key=ms.get)
        check(ms[pick[0]] <= max(ms[faster] * (1 + DISPATCH_TIE[0]),
                                 ms[faster] + DISPATCH_TIE[1]),
              f"nufft2_1d B={B} n={n} mtot={m}: the pick {pick[0]} takes "
              f"{ms[pick[0]]:.4f} ms, {faster} {ms[faster]:.4f}")
        line = (f" pick {pick[0]} (fastest on the card: {faster}); tensor "
                f"cores ms={ms['tc']:.4f} rel={out['tc_rel_err']:.3e} (twin "
                f"{out['twin_rel_diff']:.3e} apart), padding "
                f"x{out['padding']:.3f}, bound_3xtf32_ms="
                f"{out['bound_3xtf32_ms']:.4f}; CUDA cores ms={ms['cuda']:.4f}"
                f" rel={out['cuda_core_rel_err']:.3e}; geometry {tc_geo}")
        return out, line

    def tc_3d_both(name, x, arg, hq, m, fo, n, B, ref, scale, got,
                   split_bar, reps, trials, twin_ok):
        """A float32 d=3 function (``name``: nufft1_3d or nufft2_3d) on its
        two kernels on the same inputs: the tensor cores ("tc", 3xTF32 on
        Type1Grid3D or Type2Grid3D with the geometry of
        type1_3d_tc_geometry or type2_3d_tc_geometry) and the CUDA-core
        kernel ("cuda"), each within 1e-4 of max|ref| (the tensor cores
        also within ``split_bar`` and, where ``twin_ok``, within twice that
        of their twin nufft1_3d_3xtf32_ref or nufft2_3d_3xtf32_ref, run on
        the card), bit for bit against a second launch, with its scratch
        (the peak allocated in the call less the output); the wrapper's
        result bit for bit that of the path type1_3d_geometry or
        type2_3d_geometry picks, and that path the fastest on the card
        (time_cuda_paths, the host ahead) within DISPATCH_TIE.  Returns the
        row's fields and a line for the log."""
        kind = name.split("_")[0][-1]               # "1" or "2"
        pick = getattr(cuda_nufft, f"type{kind}_3d_geometry")(n, m, B)
        tc_geo = getattr(cuda_nufft, f"type{kind}_3d_tc_geometry")(n, m, B)
        geos = {"tc": tc_geo, "cuda": ("cuda",)}
        on = getattr(cuda_nufft, f"_{name}_on")
        ab = arg.reshape(B, n if kind == "1" else m ** 3)
        calls = {r: (lambda geo=geo: on(x, ab, hq, m, fo, geo))
                 for r, geo in geos.items()}
        out = {"dispatch": pick[0], "twin_rel_diff": None}
        for r, call in calls.items():
            what = f"{name} ({r}) B={B} n={n} mtot={m}"
            sync()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            o = call()
            sync()
            scratch = (torch.cuda.max_memory_allocated() - base
                       - o.numel() * o.element_size())
            rel = float((o.reshape(got.shape).to(torch.complex128)
                         - ref).abs().max()) / scale
            check(np.isfinite(rel) and rel <= 1e-4,
                  f"{what}: error {rel:.3e} of max|ref| > 1e-4")
            check(torch.equal(call(), o), f"{what}: a second launch differs")
            # under 256 MB; the tensor-core type-2's split f (268 MB at
            # mtot 255 and B 1, growing with B) and partials under 300 MB
            # at the driven shapes, and no more than its geometry counts
            limit = 256e6
            if r == "tc" and kind == "2":
                limit = 300e6
                counted = 4 * cuda_nufft.type2_3d_scratch_floats(
                    n, m, B, tc_geo) + 2 ** 21
                check(scratch < counted, f"{what}: scratch {scratch} bytes "
                      f">= its geometry's {counted:.0f}")
            check(scratch < limit,
                  f"{what}: scratch {scratch} bytes >= {limit:.0f}")
            if r == pick[0]:
                check(torch.equal(o.reshape(got.shape), got),
                      f"{what}: the wrapper's result is not this kernel's")
            if r == "tc":
                check(rel <= split_bar,
                      f"{what}: error {rel:.3e} over max(2 x the plain "
                      f"version's, 1e-6) = {split_bar:.3e}")
                if twin_ok:
                    twin = (cuda_nufft.nufft1_3d_3xtf32_ref(
                        x, ab, hq, mtot=m, fft_order=fo) if kind == "1"
                        else cuda_nufft.nufft2_3d_3xtf32_ref(
                            x, ab, hq, mtot=m, fft_order=fo,
                            geometry=tc_geo))
                    diff = float((o - twin).abs().max())
                    del twin
                    check(diff <= 2 * split_bar * scale,
                          f"{what}: {diff / scale:.3e} of max|ref| from its "
                          f"twin, over 2 x {split_bar:.3e}")
                    out["twin_rel_diff"] = diff / scale
            key = "tc" if r == "tc" else "cuda_core"
            out[f"{key}_rel_err"] = rel
            out[f"{key}_scratch_bytes"] = scratch
            del o
        ms = time_cuda_paths(calls, reps, max(trials, 3))
        out["tc_ms"], out["cuda_core_ms"] = ms["tc"], ms["cuda"]
        out["geometry"] = list(tc_geo[1:])
        out["bound_3xtf32_ms"] = bound_3xtf32_ms(name, n, m, B)[0]
        faster = min(ms, key=ms.get)
        check(ms[pick[0]] <= max(ms[faster] * (1 + DISPATCH_TIE[0]),
                                 ms[faster] + DISPATCH_TIE[1]),
              f"{name} B={B} n={n} mtot={m}: the pick {pick[0]} takes "
              f"{ms[pick[0]]:.4f} ms, {faster} {ms[faster]:.4f}")
        twin = ("not run (its float32 phase products past 1e9 values)"
                if out["twin_rel_diff"] is None
                else f"{out['twin_rel_diff']:.3e} apart")
        line = (f" pick {pick[0]} (fastest on the card: {faster}); tensor "
                f"cores ms={ms['tc']:.4f} rel={out['tc_rel_err']:.3e} (twin "
                f"{twin}) scratch {out['tc_scratch_bytes'] / 1e6:.3f} MB, "
                f"bound_3xtf32_ms={out['bound_3xtf32_ms']:.4f}; CUDA cores "
                f"ms={ms['cuda']:.4f} rel={out['cuda_core_rel_err']:.3e} "
                f"scratch {out['cuda_core_scratch_bytes'] / 1e6:.3f} MB; "
                f"geometry {tc_geo}")
        return out, line

    def type2_single(x, f, hq, m, fo, n, dtype, ref, scale, got, split_bar,
                     reps, trials):
        """The single type-2 on each of its paths, the tensor cores ("tc",
        float32), the mode split ("split") and the CUDA cores ("cuda"), on
        the same inputs: float32 within 1e-4 of max|ref| (the tensor cores
        and the split also within ``split_bar``), float64 within 1e-13, bit
        for bit against a second launch, timed, with its scratch (the peak
        allocated in the call less the output); the wrapper's result bit for
        bit that of the path type2_2d_single_geometry picks, and that path
        the fastest measured (the card's time, the paths in alternation:
        time_cuda_paths), within DISPATCH_TIE.  Returns the row's fields
        and a line for the log."""
        pick = cuda_nufft.type2_2d_single_geometry(n, m, dtype)[0]
        rows = cuda_nufft.TYPE2_2D_SPLIT_ROWS
        geos = {"split": ("split", rows, cuda_nufft.TYPE2_2D_SPLIT_THREADS),
                "cuda": ("cuda",)}
        if dtype == torch.float32:
            geos["tc"] = ("tc", cuda_nufft.TYPE2_2D_POINTS,
                          cuda_nufft.TYPE2_2D_COLS, cuda_nufft.TYPE2_2D_STAGE)
        out = {"dispatch": pick}
        calls = {}
        for r, geo in geos.items():
            def call(geo=geo):
                return cuda_nufft._nufft2_2d_on(x, f, hq, m, fo, geo)
            calls[r] = call
            what = f"nufft2_2d ({r}) {dtype} n={n} mtot={m}"
            sync()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            o = call()
            sync()
            scratch = (torch.cuda.max_memory_allocated() - base
                       - o.numel() * o.element_size())
            rel = float((o.to(torch.complex128) - ref).abs().max()) / scale
            bar = (1e-13 if dtype == torch.float64
                   else 1e-4 if r == "cuda" else split_bar)
            check(np.isfinite(rel) and rel <= bar,
                  f"{what}: error {rel:.3e} of max|ref| > {bar:.3e}")
            check(torch.equal(call(), o), f"{what}: a second launch differs")
            if r == pick:
                check(torch.equal(got, o),
                      f"{what}: the wrapper's result is not this path's")
            out[f"{r}_rel_err"] = rel
            out[f"{r}_scratch_bytes"] = scratch
        for r, ms in time_cuda_paths(calls, reps,
                                     max(trials, PATH_TRIALS)).items():
            out[f"{r}_ms"] = ms
        out["split_bound_ms"] = bound_split_ms(n, m, dtype, rows)[0]
        if "tc" in geos:
            out["tc_bound_3xtf32_ms"] = bound_3xtf32_ms("nufft2_2d", n, m)[0]
        fastest = min(geos, key=lambda r: out[f"{r}_ms"])
        out["fastest"] = fastest
        out["dispatch_is_fastest"] = fastest == pick
        tie_rel, tie_ms = DISPATCH_TIE
        check(out[f"{pick}_ms"] <= out[f"{fastest}_ms"]
              + max(tie_rel * out[f"{fastest}_ms"], tie_ms),
              f"nufft2_2d {dtype} n={n} mtot={m}: the pick {pick} takes "
              f"{out[f'{pick}_ms']:.4f} ms, {fastest} "
              f"{out[f'{fastest}_ms']:.4f}")
        line = f" pick {pick} (fastest on the card: {fastest});" + "".join(
            f" {r} ms={out[f'{r}_ms']:.4f} rel={out[f'{r}_rel_err']:.3e} "
            f"scratch {out[f'{r}_scratch_bytes'] / 1e6:.3f} MB;"
            for r in geos)
        line += f" split bound_ms={out['split_bound_ms']:.4f}"
        if "tc" in geos:
            line += f" tc bound_3xtf32_ms={out['tc_bound_3xtf32_ms']:.4f}"
        return out, line

    phase3 = []
    for name, n, m, fo, h, what, B in shapes:
        d = int(name.split("_")[1][0])
        batched = name.endswith("_batched")
        lead = (B,) if batched or B > 1 else ()
        x64 = torch.as_tensor(gen.uniform(0, 1, (n, d)), device=dev)
        shape = lead + ((n,) if name.startswith("nufft1") else (m,) * d)
        arg64 = torch.as_tensor(gen.normal(size=shape)
                                + 1j * gen.normal(size=shape), device=dev)
        for dtype in (torch.float32, torch.float64):
            if dtype == torch.float64 and batched and n == n10:
                # the scale path's probe batches run in float32 only (its
                # float64 run is the fit and the mean)
                continue
            cdt = torch.complex64 if dtype == torch.float32 \
                else torch.complex128
            x = x64.to(dtype)
            arg = arg64.to(cdt)
            hq = float(torch.tensor(h, dtype=dtype))
            kw = dict(mtot=m, fft_order=fo)
            # the scratch a type-1 call takes: the peak allocated in the
            # call less what was allocated before it and the output
            sync()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got = kernels[name](x, arg, hq, **kw)
            sync()
            scratch = (torch.cuda.max_memory_allocated() - base
                       - got.numel() * got.element_size())
            ref = plain64(name, x, arg, hq, kw)
            err = float((got.to(torch.complex128) - ref).abs().max())
            scale = float(ref.abs().max())
            rel = err / scale
            # the plain version in the run's precision, for comparison (in
            # float64 it is the reference itself)
            plain_rel = 0.0 if dtype == torch.float64 else float(
                (plains[name](x, arg, hq, **kw).to(torch.complex128)
                 - ref).abs().max()) / scale
            bar = 1e-4 if dtype == torch.float32 else 1e-10
            check(np.isfinite(rel) and rel <= bar,
                  f"{name} {dtype} B={B} n={n} mtot={m}: error {rel:.3e} "
                  f"of max|ref| > {bar:.0e}")
            tc = name in TC_TYPE1 and dtype == torch.float32
            if tc:
                # the 3xTF32 split keeps the float32 plain version's level
                split_bar = max(2 * plain_rel, 1e-6)
                check(rel <= split_bar,
                      f"{name} B={B} n={n} mtot={m}: float32 error {rel:.3e} "
                      f"over max(2 x the plain version's {plain_rel:.3e}, "
                      f"1e-6)")
            if d == 1:
                reps, trials = max(3, min(50, int(2e10 / (B * n * m)))), 5
            elif d == 2:
                reps = max(3, min(50, int(2e9 / (B * n * m * m))))
                trials = 3 if B * n * m * m > 5e11 else 5
            else:
                reps, trials = max(3, min(50, int(5e10 / (B * n * m ** 3)))), 3
            ms = time_cuda(lambda: kernels[name](x, arg, hq, **kw), reps,
                           trials)
            plain_ms = time_cuda(lambda: plains[name](x, arg, hq, **kw),
                                 max(1 if d == 3 else 2, reps // 4), trials)
            b_ms, b_by = bound_ms(name, n, m, dtype, B)
            row = dict(name=name, dtype=str(dtype).split(".")[-1], B=B, n=n,
                       mtot=m, fft_order=fo, h=hq, serves=what,
                       max_abs_err=err, max_abs_ref=scale, rel_err=rel,
                       plain_rel_err=plain_rel, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by)
            extra = ""
            if tc:
                # the kernel's own bound is the tensor cores'; the fp32
                # CUDA-core bound kept beside it
                row["bound_fp32_ms"] = b_ms
                split = None
                if d == 1:
                    geo = cuda_nufft.type1_1d_geometry(n, m, B)[1:]
                    K = geo[0] // geo[2]
                    split = (K, cuda_nufft.type1_1d_split(m, K)[1])
                else:
                    geo = cuda_nufft.type1_2d_geometry(n, m, B, batched)
                row["bound_ms"], row["bound_by"] = bound_3xtf32_ms(
                    name, n, m, B, split)
                groups = -(-n // geo[-1])
                row["scratch_bytes"] = scratch
                check(scratch < 256e6,
                      f"{name} B={B} n={n} mtot={m}: scratch {scratch} bytes "
                      f">= 256 MB")
                row["tile"] = f"{geo[0]}x{geo[1]}"
                row["split_bar"] = split_bar
                extra = (f" tile {row['tile']}, scratch {groups} groups "
                         f"{scratch / 1e6:.3f} MB (measured; partials "
                         f"{groups * B * m ** d * 8 / 1e6:.3f} MB), "
                         f"bound_3xtf32_ms={row['bound_ms']:.4f}")
                b_ms, b_by = row["bound_fp32_ms"], "fp32 operations"
                if d == 1:
                    t1, line = type1_1d_both(x, arg, hq, m, fo, n, B, ref,
                                             scale, got, split_bar, reps)
                    row.update(t1)
                    extra += line
            if name == "nufft2_1d" and dtype == torch.float32:
                t2, line = type2_1d_both(x, arg, hq, m, fo, n, B, ref, scale,
                                         got, max(2 * plain_rel, 1e-6), reps)
                row.update(t2)
                row["split_bar"] = max(2 * plain_rel, 1e-6)
                row["bound_fp32_ms"] = b_ms
                if t2["dispatch"] == "tc":
                    row["bound_ms"], row["bound_by"] = (
                        t2["bound_3xtf32_ms"], "operations")
                    b_by = "fp32 operations"
                extra += line
            if name == "nufft2_2d_batched" and dtype == torch.float32:
                t2, line = type2_both(x, arg, hq, m, fo, n, B, ref, scale,
                                      got, max(2 * plain_rel, 1e-6), reps,
                                      trials)
                row.update(t2)
                if t2["dispatch"] == "tc":
                    row["bound_fp32_ms"] = b_ms
                    row["bound_ms"], row["bound_by"] = (
                        t2["bound_3xtf32_ms"], "operations")
                    b_by = "fp32 operations"
                extra += line
            if name == "nufft2_2d":
                t2, line = type2_single(x, arg, hq, m, fo, n, dtype, ref,
                                        scale, got,
                                        max(2 * plain_rel, 1e-6), reps,
                                        trials)
                row.update(t2)
                if dtype == torch.float32:
                    row["split_bar"] = max(2 * plain_rel, 1e-6)
                if t2["dispatch"] == "tc":
                    row["bound_fp32_ms"] = b_ms
                    row["bound_ms"], row["bound_by"] = bound_3xtf32_ms(
                        name, n, m)
                    b_by = "fp32 operations"
                extra += line
            if batched:
                single = kernels[name.replace("_batched", "")]
                row["singles_ms"] = time_cuda(
                    lambda: [single(x, a, hq, **kw) for a in arg], reps,
                    trials)
                extra += f" {B}x single ms={row['singles_ms']:.4f}"
            if name == "nufft1_3d":
                groups = cuda_nufft._type1_3d_groups_of(
                    n, m, B, cuda_nufft.type1_3d_geometry(n, m, B)
                    if dtype == torch.float32 else ("cuda",))
                row["scratch_bytes"] = scratch
                extra = (f" scratch {groups} groups {scratch / 1e6:.3f} MB "
                         f"(measured)")
            if d == 3 and dtype == torch.float32:
                # both kernels of the d=3 function (the tensor cores' twin
                # where its float32 operand stays under 1e9 values)
                split_bar = max(2 * plain_rel, 1e-6)
                t3, line = tc_3d_both(name, x, arg, hq, m, fo, n, B, ref,
                                      scale, got, split_bar, reps, trials,
                                      B * n * m * m <= 1e9)
                row.update(t3)
                row["split_bar"] = split_bar
                row["bound_fp32_ms"] = b_ms
                if t3["dispatch"] == "tc":
                    row["bound_ms"], row["bound_by"] = (
                        t3["bound_3xtf32_ms"], "operations")
                    b_by = "fp32 operations"
                extra += line
            phase3.append(row)
            print(f"[3] {name} {row['dtype']} B={B} n={n} mtot={m} "
                  f"fft_order={fo} ({what}): max_abs_err={err:.3e} "
                  f"rel={rel:.3e} (plain {row['dtype']}: {plain_rel:.3e}) "
                  f"ms={ms:.4f} plain_ms={plain_ms:.4f}"
                  f"{extra} bound_ms={b_ms:.4f} ({b_by}) {card}")
    del x64, arg64, x, arg, got, ref
    torch.cuda.empty_cache()

    # the SKI interpolation kernels on phase 11's band plan and on the
    # raster's (phase 11b), at the batches their paths give them: the PCG's
    # y plus 2 trace probes (3), the SLQ's 8 probes, the variance's chunk
    # of targets, single vectors (the final solve, the mean)
    from gpquad_torch.models import ski as ski_mod
    from gpquad_torch.ops import cuda_interp
    xs11, ys11, xq11 = ski_data(SKI_N, SKI_TARGETS)
    raster = np.load(ROOT / "data" / "frozen_raster_v1.npz")
    ski_kern = gpquad_torch.make_kernel("SE", 2, lengthscale=0.3,
                                        variance=1.0)
    bounds11 = ski_mod.resolve_grid_bounds(xs11)
    bounds_r = ski_mod.resolve_grid_bounds(raster["x_train"])
    grid_r = ski_mod.resolve_grid_size(num_dims=2, target_grid_points=4096,
                                       grid_bounds=bounds_r)
    plans = {}
    for tag, xs, grid, bounds, batches in (
            ("ski", xs11, (SKI_GRID, SKI_GRID), bounds11, SKI_BATCHES),
            ("raster", raster["x_train"], grid_r, bounds_r, RASTER_BATCHES)):
        ops = {dt: ski_mod.build_ski_operator(
            torch.as_tensor(xs, dtype=dt, device=dev), ski_kern, grid,
            bounds) for dt in (torch.float32, torch.float64)}
        check(ops[torch.float32].banded is not None,
              f"{tag}: the band plan was dropped")
        nb, cap = ops[torch.float32].banded.pidx.shape
        G1, G2 = ops[torch.float32].grid_shape
        n_pts = xs.shape[0]
        t32 = ops[torch.float32].banded
        listed = int(t32.col_start[:, -1].sum())
        index_bytes = (t32.col_slots.numel() * 4
                       + t32.col_start.numel() * 4)
        per_col = (t32.col_start[:, 4:] - t32.col_start[:, :-4]).float()
        plans[tag] = dict(grid=[G1, G2], nbands=nb, cap=cap, n=n_pts,
                          listed=listed, index_bytes=index_bytes,
                          slots_per_column_mean=float(per_col.mean()),
                          slots_per_column_max=int(per_col.max()))
        print(f"[3] {tag} band plan: extended grid {G1}x{G2}, {nb} bands of "
              f"cap {cap} ({nb * cap} slots for n={n_pts}); column-sorted "
              f"index of {listed} slots, {index_bytes / 1e6:.3f} MB "
              f"(col_slots {tuple(t32.col_slots.shape)}, col_start "
              f"{tuple(t32.col_start.shape)} int32), "
              f"{float(per_col.mean()):.1f} slots a column (max "
              f"{int(per_col.max())})")
        for B in batches:
            u64 = torch.as_tensor(gen.normal(size=(B, n_pts)), device=dev)
            v64 = torch.as_tensor(gen.normal(size=(B, G1, G2)), device=dev)
            for dtype in (torch.float32, torch.float64):
                op = ops[dtype]
                t = op.banded
                tabs = (t.i0loc, t.c0, t.w_row, t.w_col)
                tabs64 = (t.i0loc, t.c0, t.w_row.double(), t.w_col.double())
                idx = (t.col_slots, t.col_start)
                u = u64.to(dtype)
                us = (u[:, t.pidx.reshape(-1)].reshape(B, nb, cap)
                      * t.valid.to(dtype))
                vp = F.pad(v64.to(dtype), (0, 0, 0, nb * 8 + 3 - G1))
                vs = vp.as_strided((B, nb, 11, G2),
                                   (vp.stride(0), 8 * G2, G2, 1))
                v = v64.to(dtype).reshape(B, G1 * G2)
                idx_flat = op.idx.reshape(-1)
                ptabs = (*tabs, t.pout)
                ptabs64 = (*tabs64, t.pout)
                pkw = dict(G1=G1, G2=G2, n=n_pts, bh=8)

                def lib_T():
                    z = torch.zeros((B, G1 * G2), dtype=dtype, device=dev)
                    return z.index_add_(1, idx_flat, (u[:, :, None]
                                                      * op.wvals).reshape(
                                                          B, -1))

                def lib_fwd():
                    return torch.sum(v[:, op.idx] * op.wvals, dim=-1)

                calls = {
                    "interp_T_2d": (
                        lambda: cuda_interp.interp_T_2d(us, *tabs, *idx,
                                                        G2=G2, bh=8),
                        lambda: cuda_interp.interp_T_2d_ref(us, *tabs, G2=G2,
                                                            bh=8),
                        lambda: cuda_interp.interp_T_2d_ref(
                            us.double(), *tabs64, G2=G2, bh=8), lib_T),
                    # W v from the grid to point order, one launch (on
                    # the operator's plan, checked when it was made)
                    "interp_2d": (
                        lambda: cuda_interp.interp_2d_points_trusted(
                            v, *ptabs, **pkw),
                        lambda: cuda_interp.interp_2d_points_ref(v, *ptabs,
                                                                 **pkw),
                        lambda: cuda_interp.interp_2d_points_ref(
                            v.double(), *ptabs64, **pkw), lib_fwd)}
                for name, (kern_fn, plain_fn, ref_fn, lib_fn) in \
                        calls.items():
                    got = kern_fn()
                    sync()
                    ref = ref_fn()
                    err = float((got.double() - ref).abs().max())
                    scale = float(ref.abs().max())
                    rel = err / scale
                    bar = 1e-5 if dtype == torch.float32 else 1e-12
                    check(np.isfinite(rel) and rel <= bar,
                          f"{name} {tag} {dtype} B={B}: error {rel:.3e} of "
                          f"max|ref| > {bar:.0e}")
                    # the same sums in the same order: a second launch and
                    # the plain twin (interp_T_2d: its column-sorted walk)
                    twin = (cuda_interp.interp_T_2d_sorted_ref(
                        us, *tabs, *idx, G2=G2, bh=8)
                        if name == "interp_T_2d" else plain_fn())
                    check(torch.equal(kern_fn(), got)
                          and torch.equal(twin, got),
                          f"{name} {tag} {dtype} B={B}: not bit for bit the "
                          "same on a second launch and in its twin")
                    if name == "interp_2d":
                        # the checked entry and the band-slot API on the
                        # same kernel, and the whole operator, one launch
                        check(torch.equal(
                            cuda_interp.interp_2d_points(v, *ptabs, **pkw),
                            got), f"interp_2d_points {tag} {dtype} B={B}: "
                            "not the unchecked launch's result")
                        check(torch.equal(
                            cuda_interp.interp_2d(vs, *tabs, bh=8),
                            cuda_interp.interp_2d_ref(vs, *tabs, bh=8)),
                            f"interp_2d {tag} {dtype} B={B}: the band-slot "
                            "API is not its plain version bit for bit")
                        before = cuda_interp.LAUNCHES["interp_2d"]
                        check(torch.equal(op.interp(v), got)
                              and cuda_interp.LAUNCHES["interp_2d"]
                              == before + 1,
                              f"SKIOperator.interp {tag} {dtype} B={B}: not "
                              "one launch of the kernel")
                    del got, ref, twin
                    # calls of tens of microseconds: 100 a trial for the
                    # kernel and the library call alike, so that neither
                    # median rests on a few calls at a clock still ramping
                    # up after the host's planning
                    ms = time_cuda(kern_fn, 100)
                    plain_ms = library_ms = None
                    if dtype == torch.float32:
                        plain_ms = time_cuda(plain_fn, 3, 3)
                        library_ms = time_cuda(lib_fn, 100)
                    b_ms, b_by = bound_ms(name, 0, 0, dtype, work=interp_work(
                        name, nb, G1, G2, dtype, B, listed))
                    row = dict(name=name, serves=tag, B=B, nbands=nb,
                               cap=cap, G2=G2,
                               dtype=str(dtype).split(".")[-1],
                               max_abs_err=err, max_abs_ref=scale,
                               rel_err=rel, ms=ms, plain_ms=plain_ms,
                               library_ms=library_ms, bound_ms=b_ms,
                               bound_by=b_by)
                    extra = "" if plain_ms is None else (
                        f" plain_ms={plain_ms:.4f} library (unbanded path) "
                        f"ms={library_ms:.4f}")
                    if name == "interp_2d" and dtype == torch.float32:
                        # the whole SKIOperator.interp beside the kernel and
                        # the library call: with the host's enqueue (100
                        # calls a trial), and the card's alone
                        row["interp_ms"] = time_cuda(lambda: op.interp(v),
                                                     100)
                        card_ms = time_cuda_paths(
                            {"kernel": kern_fn,
                             "interp": lambda: op.interp(v),
                             "library": lib_fn}, 100, PATH_TRIALS)
                        row.update({f"{k}_card_ms": t_
                                    for k, t_ in card_ms.items()})
                        extra += (f" SKIOperator.interp ms="
                                  f"{row['interp_ms']:.4f}; on the card: "
                                  + " ".join(f"{k} {t_:.4f}" for k, t_ in
                                             card_ms.items()))
                    phase3.append(row)
                    print(f"[3] {name} {row['dtype']} {tag} B={B}: "
                          f"max_abs_err={err:.3e} rel={rel:.3e} "
                          f"ms={ms:.4f}{extra} bound_ms={b_ms:.4f} ({b_by}) "
                          f"{card}")
        del ops, u64, v64, u, us, vp, vs, v
    torch.cuda.empty_cache()
    record["phases"]["kernels"] = phase3
    record["phases"]["ski_plans"] = plans
    phase_s["3"] = time.perf_counter() - t_phase
    print(f"[3] phase wall time {phase_s['3']:.1f} s")

    # -- phase 4: the headline configuration --------------------------------
    t_phase = time.perf_counter()
    sigmasq, eps, probes = 0.01, 1e-6, 256
    x32 = torch.as_tensor(xh, dtype=torch.float32, device=dev)
    y32 = torch.as_tensor(yh, dtype=torch.float32, device=dev)
    xq32 = torch.as_tensor(xnew, dtype=torch.float32, device=dev)
    etas = torch.as_tensor(
        np.random.default_rng(2).choice([-1.0, 1.0],
                                        size=(probes, mtot_head ** 2)),
        device=dev)
    counters = (cuda_nufft.LAUNCHES, cuda_nufft.LAUNCH_WIDTHS,
                nufft_mod.BACKEND_PICKS)

    def host_ms(fn, reps=5):
        """Median host-clock ms of ``reps`` warm calls, each synchronised."""
        fn()
        sync()
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            sync()
            ts.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts)

    # 4a: the serving slice, stage by stage
    def run_slice(x, y, xq, kern, method):
        times, stages = {}, {}
        t = time.perf_counter()
        st = gpquad_torch.fit(x, y, kern, sigmasq, eps=eps, cg_tol=1e-6,
                              nufft_method=method, device=dev)
        sync()
        times["fit_s"] = time.perf_counter() - t
        stages["fit"] = dict(cuda_nufft.LAUNCHES)
        t = time.perf_counter()
        mean = gpquad_torch.predict_mean(st, xq, nufft_method=method)
        sync()
        times["mean_s"] = time.perf_counter() - t
        stages["mean"] = dict(cuda_nufft.LAUNCHES)
        t = time.perf_counter()
        var = gpquad_torch.predict_var(st, xq, method="stochastic",
                                       probes=probes, cg_tol=1e-4,
                                       etas=etas, nufft_method=method)
        sync()
        times["var_s"] = time.perf_counter() - t
        stages["var"] = dict(cuda_nufft.LAUNCHES)
        return st, mean, var, times, stages

    run_slice(x32, y32, xq32, kernel32, "auto")          # warm
    reset_counts(*counters)
    st, mean, var, times, stages = run_slice(x32, y32, xq32, kernel32,
                                             "auto")
    launches = dict(cuda_nufft.LAUNCHES)
    picks = dict(nufft_mod.BACKEND_PICKS)
    print(f"[4] mtot={st.mtot} M={st.M} solver="
          f"{'dense' if st.P_dense is not None else 'cg'} "
          f"launches={launches} backend_picks={picks} by stage "
          f"(cumulative)={stages}")
    for k in SINGLE:
        check(launches[k] > 0, f"kernel {k} was not launched on the slice")

    def counts(t1, t2):
        return launch_counts(nufft1_2d=t1, nufft2_2d=t2)
    check(stages == {"fit": counts(2, 0), "mean": counts(2, 1),
                     "var": counts(2, 2)},
          f"unexpected launch counts by stage {stages}")
    check(picks["matmul"] == 0, f"the main path took the plain path {picks}")
    print(f"[4] f32 on the kernels: fit {times['fit_s'] * 1e3:.2f} ms, "
          f"mean {times['mean_s'] * 1e3:.2f} ms, "
          f"var {times['var_s'] * 1e3:.2f} ms (warm, host clock) {card}")
    # where the time goes: the host-side grid planner alone, then one more
    # warm run under the profiler
    L = float((x32.max(dim=0).values - x32.min(dim=0).values).max())
    t = time.perf_counter()
    gpquad_torch.spectral_grid(kernel32, eps, L)
    plan_ms = (time.perf_counter() - t) * 1e3
    print(f"[4] grid planning (host, float64) {plan_ms:.2f} ms of the fit")
    prof = profile_run(lambda: run_slice(x32, y32, xq32, kernel32, "auto"))
    print_profile("[4] profiled slice:", prof, card)

    # the same f32-valued hypers; fit casts them to the run's dtype
    st64, mean64, var64, times64, _ = run_slice(
        x32.double(), y32.double(), xq32.double(), kernel32, "matmul")
    check(st64.mtot == st.mtot, "f32 and f64 runs planned different grids")
    check(mean.shape == (10_000,) and var.shape == (10_000,),
          "wrong output shapes")
    check(bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all()),
          "non-finite mean or variance")
    err_mean = float((mean.double() - mean64).abs().max())
    err_var = float((var.double() - var64).abs().max())
    var_scale = float(var64.abs().max())
    # the variance is ~1e-3 here, so an absolute bar alone would let a
    # systematic error of ~10% through; the f32 run sits at ~2% of max|var|
    print(f"[4] vs float64 plain path: max|mean err|={err_mean:.3e} "
          f"(bar 5e-4), max|var err|={err_var:.3e} (bars 1e-4 and "
          f"5e-2*max|var64| = {5e-2 * var_scale:.3e}), "
          f"max|var64|={var_scale:.3e}")
    print(f"[4] f64 plain path: fit {times64['fit_s'] * 1e3:.2f} ms, "
          f"mean {times64['mean_s'] * 1e3:.2f} ms, "
          f"var {times64['var_s'] * 1e3:.2f} ms (cold, host clock) {card}")
    check(err_mean <= 5e-4, f"mean error {err_mean:.3e} > 5e-4")
    check(err_var <= 1e-4, f"variance error {err_var:.3e} > 1e-4")
    check(err_var <= 5e-2 * var_scale,
          f"variance error {err_var:.3e} > 5e-2 * max|var64|")

    # the user's default variance call: probes drawn by the default
    # generator (on the card), no etas; beside the etas call, median of 5
    def var_default():
        return gpquad_torch.predict_var(st, xq32, method="stochastic",
                                        probes=probes, cg_tol=1e-4)

    def var_etas():
        return gpquad_torch.predict_var(st, xq32, method="stochastic",
                                        probes=probes, cg_tol=1e-4, etas=etas)

    var_d = var_default()
    check(var_d.shape == (10_000,) and bool(torch.isfinite(var_d).all()),
          "default-probe variance: wrong shape or non-finite")
    var_default_ms, var_etas_ms = host_ms(var_default), host_ms(var_etas)
    print(f"[4] var, median of 5 warm calls (host clock): default generator "
          f"({probes} probes drawn on the card) {var_default_ms:.2f} ms, "
          f"given etas {var_etas_ms:.2f} ms {card}")

    # 4b: the gradient stage on the fit's state, as the fused call runs it
    def grad_on(s, x, y, method="auto", seed=0):
        return gpquad_torch.gradient_with_grid(
            x, y, kernel32, sigmasq, s.h,
            torch.Generator(device=dev).manual_seed(seed), mtot=s.mtot,
            trace_samples=FUSED_KW["trace_samples"],
            cg_tol=FUSED_KW["grad_cg_tol"],
            max_cg_iter=FUSED_KW["max_cg_iter"], beta0=s.beta, state=s,
            nufft_method=method)

    def grad_stage():
        return grad_on(st, x32, y32)

    grad_ms = host_ms(grad_stage)
    reset_counts(*counters)
    gres = grad_stage()
    sync()
    grad_launches = dict(cuda_nufft.LAUNCHES)
    print(f"[4] gradient stage (state=fit): {grad_ms:.2f} ms median of 5 "
          f"warm calls (host clock) {card}; launches={grad_launches} "
          f"grad={gres.grad.tolist()}")
    check(grad_launches == launch_counts(nufft1_2d=1, nufft2_2d=1,
                                         nufft1_2d_batched=1,
                                         nufft2_2d_batched=2),
          f"unexpected gradient-stage launch counts {grad_launches}")

    # 4c: the fused north-star call, fit_predict_grad, at bench.py's settings
    _, h_fused, mtot_fused = gpquad_torch.spectral_grid(kernel32, eps, 1.0)
    check(mtot_fused == mtot_head, f"bench.py's grid mtot={mtot_fused}")

    def fused(x, y, xq, method, seed=0):
        return gpquad_torch.fit_predict_grad(
            x, y, xq, kernel32, sigmasq, h_fused,
            torch.Generator(device=dev).manual_seed(seed), mtot=mtot_fused,
            nufft_method=method, device=dev, **FUSED_KW)

    fused(x32, y32, xq32, "auto")                          # warm
    reset_counts(*counters)
    out = fused(x32, y32, xq32, "auto")
    sync()
    fused_launches = dict(cuda_nufft.LAUNCHES)
    fused_picks = dict(nufft_mod.BACKEND_PICKS)
    print(f"[4] fused fit_predict_grad launches={fused_launches} "
          f"backend_picks={fused_picks}")
    for k in KERNELS_2D:
        check(fused_launches[k] > 0,
              f"kernel {k} was not launched on the main path")
    # fit: F*y, lag table; mean: 1 type-2; variance: 1 type-2; gradient:
    # F*y again (gpquad recomputes it, gradient.py:213), F(D beta), one
    # batched F*Z and two batched F applies (tk*T = 10 vectors each)
    check(fused_launches == launch_counts(nufft1_2d=3, nufft2_2d=3,
                                          nufft1_2d_batched=1,
                                          nufft2_2d_batched=2),
          f"unexpected fused launch counts {fused_launches}")
    check(fused_picks["matmul"] == 0,
          f"the fused call took the plain path {fused_picks}")
    check(out.grad.dtype == torch.float32 and out.beta.dtype ==
          torch.complex64, f"the f32 run left float32: grad {out.grad.dtype}"
          f", beta {out.beta.dtype}")
    fused_ms = host_ms(lambda: fused(x32, y32, xq32, "auto"))
    prof_fused = profile_run(lambda: fused(x32, y32, xq32, "auto"))
    print(f"[4] fused fit_predict_grad: {fused_ms:.2f} ms median of 5 warm "
          f"calls (host clock) {card}")
    print_profile("[4] profiled fused call:", prof_fused, card)

    out64 = fused(x32.double(), y32.double(), xq32.double(), "matmul")
    # the same float32 call on the plain path: the f32 floor of the card's
    # dense algebra (cuSOLVER, cuBLAS) without the kernels
    out32_plain = fused(x32, y32, xq32, "matmul")
    sync()
    check(out.mean.shape == (10_000,) and out.var.shape == (10_000,)
          and out.grad.shape == (3,), "wrong fused output shapes")
    check(all(bool(torch.isfinite(t).all())
              for t in (out.mean, out.var, out.grad)),
          "non-finite fused output")
    f_err_mean = float((out.mean.double() - out64.mean).abs().max())
    f_err_var = float((out.var.double() - out64.var).abs().max())
    f_var_scale = float(out64.var.abs().max())

    def rel_to(g, g64):
        return ((g.double() - g64).abs() / g64.abs()).tolist()
    grad_rel = rel_to(out.grad, out64.grad)
    grad_rel_plain = rel_to(out32_plain.grad, out64.grad)
    # bars per component (lengthscale, variance, noise variance).  The f32
    # gradient's error against f64 is a cancellation floor (bench.py:
    # 955-958): 1e-2 on the kernel hypers.  The noise-variance component
    # cancels term1 ~ term2 ~ n / sigma^2 = 1e7 down to ~7e3; there the
    # fused f32 call on this card reads 0.90e-2 to 1.20e-2 on the kernels
    # and 0.77e-2 to 0.92e-2 on the plain path over the sweep's three probe
    # seeds below (NVIDIA H100 80GB HBM3, 700 W), and gpquad's own f32
    # gradient reads 2.7e-2 against its f64 one on the CPU (printed by
    # tests/test_torch_gradient.py::
    # test_float32_gradient_no_worse_than_gpquad).  Its bar is 2e-2.
    grad_bars = [1e-2] * (len(grad_rel) - 1) + [2e-2]
    print(f"[4] fused vs float64 plain path (same generator seed): "
          f"max|mean err|={f_err_mean:.3e} (bar 5e-4), "
          f"max|var err|={f_err_var:.3e} (bars 1e-4 and "
          f"{5e-2 * f_var_scale:.3e}), grad rel err per component="
          f"{[f'{r:.3e}' for r in grad_rel]} (bars {grad_bars}); the f32 "
          f"plain path: {[f'{r:.3e}' for r in grad_rel_plain]}; "
          f"grad f32={out.grad.tolist()} f64={out64.grad.tolist()}")

    # the f32 gradient against float64 over three generator seeds (probe
    # sets): the fused call on the kernels and on the plain path, then the
    # gradient stage with the fit's state and the gradient's own NUFFTs each
    # taken from the kernels or from the plain path, which shows where the
    # kernel path's error on the noise component enters
    st32_plain = gpquad_torch.fit(x32, y32, kernel32, sigmasq, eps=eps,
                                  cg_tol=1e-6, nufft_method="matmul",
                                  device=dev)
    x64, y64 = x32.double(), y32.double()
    sweep = []
    for seed in (0, 1, 2):
        if seed == 0:
            o32, o32p, o64 = out, out32_plain, out64
        else:
            o32 = fused(x32, y32, xq32, "auto", seed)
            o32p = fused(x32, y32, xq32, "matmul", seed)
            o64 = fused(x64, y64, xq32.double(), "matmul", seed)
        g64 = grad_on(st64, x64, y64, "matmul", seed).grad
        row = {"fused on kernels": rel_to(o32.grad, o64.grad),
               "fused plain": rel_to(o32p.grad, o64.grad)}
        for fit_tag, s_fit in (("kernels", st), ("plain", st32_plain)):
            for g_tag, method in (("kernels", "auto"), ("plain", "matmul")):
                row[f"fit {fit_tag} + gradient {g_tag}"] = rel_to(
                    grad_on(s_fit, x32, y32, method, seed).grad, g64)
        print(f"[4] f32 gradient rel err vs float64, seed {seed}: "
              + "; ".join(f"{k} [{', '.join(f'{r:.3e}' for r in v)}]"
                          for k, v in row.items()))
        sweep.append(dict(seed=seed, **row))
    check(f_err_mean <= 5e-4, f"fused mean error {f_err_mean:.3e} > 5e-4")
    check(f_err_var <= 1e-4 and f_err_var <= 5e-2 * f_var_scale,
          f"fused variance error {f_err_var:.3e} over its bars")
    for row in sweep:
        check(all(r <= b for r, b in zip(row["fused on kernels"], grad_bars)),
              f"fused gradient relative error {row['fused on kernels']} "
              f"(seed {row['seed']}) over {grad_bars}")
    record["phases"]["headline"] = dict(
        mtot=st.mtot, M=st.M, launches_slice=launches, stages=stages,
        backend_picks=picks, times_f32=times, times_f64_plain_cold=times64,
        var_default_generator_ms=var_default_ms, var_etas_ms=var_etas_ms,
        err_mean=err_mean, err_var=err_var, max_abs_var64=var_scale,
        plan_ms=plan_ms, profile_slice=prof, grad_stage_ms=grad_ms,
        grad_stage_launches=grad_launches, fused_ms=fused_ms,
        fused_launches=fused_launches, fused_picks=fused_picks,
        profile_fused=prof_fused, fused_err_mean=f_err_mean,
        fused_err_var=f_err_var, fused_max_abs_var64=f_var_scale,
        fused_grad_rel_err=grad_rel, grad_rel_err_plain_f32=grad_rel_plain,
        grad_rel_err_sweep=sweep,
        grad_f32=out.grad.tolist(),
        grad_f64=out64.grad.tolist(),
        mean_converged=bool(out.mean_converged))

    phase_s["4"] = time.perf_counter() - t_phase
    print(f"[4] phase wall time {phase_s['4']:.1f} s")

    # -- phase 5: the CG tier ------------------------------------------------
    t_phase = time.perf_counter()
    x2 = torch.as_tensor(xh2, dtype=torch.float32, device=dev)
    y2 = torch.as_tensor(yh2, dtype=torch.float32, device=dev)
    xq2 = torch.as_tensor(xnew2, dtype=torch.float32, device=dev)

    def run_cg(x, y, xq, kern, method, precond="auto"):
        t = time.perf_counter()
        s = gpquad_torch.fit(x, y, kern, sigmasq, eps=eps, cg_tol=1e-6,
                             max_cg_iter=2000, solver="cg", precond=precond,
                             nufft_method=method, device=dev)
        mu = gpquad_torch.predict_mean(s, xq, nufft_method=method)
        sync()
        return s, mu, time.perf_counter() - t

    run_cg(x2, y2, xq2, kern_hard, "auto")                # warm
    reset_counts(*counters)
    s2, mu2, t2 = run_cg(x2, y2, xq2, kern_hard, "auto")
    launches_cg = dict(cuda_nufft.LAUNCHES)
    picks_cg = dict(nufft_mod.BACKEND_PICKS)
    print(f"[5] CG tier launches={launches_cg} backend_picks={picks_cg}")
    # fit: F*y at mtot and the lag table at 2 mtot - 1; mean: one type-2
    check(launches_cg == counts(2, 1),
          f"unexpected CG-tier launch counts {launches_cg}")
    check(picks_cg["matmul"] == 0,
          f"the CG tier took the plain path {picks_cg}")
    prof_cg = profile_run(lambda: run_cg(x2, y2, xq2, kern_hard, "auto"))
    print_profile("[5] profiled CG tier:", prof_cg, card)
    s64, mu64, _ = run_cg(x2.double(), y2.double(), xq2.double(), kern_hard,
                          "matmul")
    err_hard = float((mu2.double() - mu64).abs().max())
    iters = int(s2.mean_cg_iters)
    # pcg stops before max_cg_iter only when every lane met cg_tol
    print(f"[5] CG tier: mtot={s2.mtot} M={s2.M} jacobi PCG iters={iters} "
          f"converged={iters < 2000} "
          f"(f64: {int(s64.mean_cg_iters)}) fit+mean {t2 * 1e3:.2f} ms "
          f"(warm, host clock) {card}; max|mean err| vs f64 "
          f"{err_hard:.3e}")
    check(s2.mtot == 107 == mtot_hard,
          f"hard configuration planned mtot={s2.mtot} (phase 3: {mtot_hard})")
    check(iters < 2000, "the CG-tier fit did not converge in 2000 iterations")
    check(bool(torch.isfinite(mu2).all()), "non-finite CG-tier mean")
    check(err_hard <= 5e-4, f"CG-tier mean error {err_hard:.3e} > 5e-4")

    # the same fit with the Kronecker eigen-preconditioner
    run_cg(x2, y2, xq2, kern_hard, "auto", "kron")        # warm
    reset_counts(*counters)
    s2k, mu2k, t2k = run_cg(x2, y2, xq2, kern_hard, "auto", "kron")
    launches_kron = dict(cuda_nufft.LAUNCHES)
    picks_kron = dict(nufft_mod.BACKEND_PICKS)
    s64k, mu64k, _ = run_cg(x2.double(), y2.double(), xq2.double(),
                            kern_hard, "matmul", "kron")
    iters_k = int(s2k.mean_cg_iters)
    err_kron = float((mu2k.double() - mu64).abs().max())
    err_kron_jac = float((mu2k - mu2).abs().max())
    print(f"[5] CG tier with kron: PCG iters={iters_k} (f64: "
          f"{int(s64k.mean_cg_iters)}; Jacobi {iters}; bar "
          f"{KRON_MAX_ITERS}) fit+mean {t2k * 1e3:.2f} ms (warm, host clock) "
          f"{card}; launches={launches_kron} backend_picks={picks_kron}; "
          f"max|mean err| vs f64 Jacobi {err_kron:.3e} (bar 5e-4), vs the "
          f"f32 Jacobi mean {err_kron_jac:.3e}")
    check(s2k.kron is not None, "the kron fit carries no preconditioner")
    check(launches_kron == counts(2, 1),
          f"unexpected kron CG-tier launch counts {launches_kron}")
    check(picks_kron["matmul"] == 0, f"the kron fit took the plain path "
          f"{picks_kron}")
    check(iters_k <= KRON_MAX_ITERS,
          f"kron CG-tier fit took {iters_k} > {KRON_MAX_ITERS} iterations")
    check(err_kron <= 5e-4 and err_kron_jac <= 5e-4,
          f"kron CG-tier mean error {err_kron:.3e} / {err_kron_jac:.3e}")

    # the gradient on the CG tier's state: trace solves by Jacobi PCG
    def grad_cg(x, y, s, method, seed=0):
        return gpquad_torch.gradient_with_grid(
            x, y, kern_hard, sigmasq, s.h,
            torch.Generator(device=dev).manual_seed(seed), mtot=s.mtot,
            trace_samples=FUSED_KW["trace_samples"],
            cg_tol=FUSED_KW["grad_cg_tol"],
            max_cg_iter=FUSED_KW["max_cg_iter"], beta0=s.beta, state=s,
            nufft_method=method)

    grad_cg(x2, y2, s2, "auto")                           # warm
    reset_counts(*counters)
    t = time.perf_counter()
    g2 = grad_cg(x2, y2, s2, "auto")
    sync()
    t_grad_cg = time.perf_counter() - t
    launches_gcg = dict(cuda_nufft.LAUNCHES)
    picks_gcg = dict(nufft_mod.BACKEND_PICKS)
    g64 = grad_cg(x2.double(), y2.double(), s64, "matmul")
    maxiter = FUSED_KW["max_cg_iter"]
    trace_iters = int(g2.trace_cg_iters)
    converged = bool((g2.trace_conv_iters < maxiter).all())
    grad_rel_cg = ((g2.grad.double() - g64.grad).abs()
                   / g64.grad.abs()).tolist()
    print(f"[5] CG-tier gradient (state=fit, T=10, cg_tol 1e-4, Jacobi): "
          f"trace PCG iters={trace_iters} (f64: {int(g64.trace_cg_iters)}) "
          f"converged={converged} {t_grad_cg * 1e3:.2f} ms (warm, host "
          f"clock) {card}; launches={launches_gcg} backend_picks="
          f"{picks_gcg}; grad f32={g2.grad.tolist()} f64={g64.grad.tolist()}"
          f" rel err={[f'{r:.3e}' for r in grad_rel_cg]} (bar 5e-2)")
    check(launches_gcg == launch_counts(nufft1_2d=1, nufft2_2d=1,
                                        nufft1_2d_batched=1,
                                        nufft2_2d_batched=2),
          f"unexpected CG-tier gradient launch counts {launches_gcg}")
    check(picks_gcg["matmul"] == 0,
          f"the CG-tier gradient took the plain path {picks_gcg}")
    check(converged, "the CG-tier trace solves did not converge")
    check(bool(torch.isfinite(g2.grad).all()), "non-finite CG-tier gradient")
    # both runs stop their PCG at 1e-4 on different iterations
    check(all(r <= 5e-2 for r in grad_rel_cg),
          f"CG-tier gradient relative error {grad_rel_cg} > 5e-2")

    # the f32 gradient against float64 over three generator seeds (probe
    # sets), as phase 4's sweep at mtot 29 but here where the type-2 runs on
    # the tensor cores (the batched one, and the single's F(D beta) at
    # n 1e5): on the kernels, on the kernels with both type-2s sent to their
    # CUDA-core kernel (their route before the tensor cores took mtot 107),
    # and with the gradient's NUFFTs on the plain path; all on the fit's
    # state
    def type2_on_cuda_cores(fn):
        keep = cuda_nufft.TYPE2_2D_TC_MIN_MTOT
        cuda_nufft.TYPE2_2D_TC_MIN_MTOT = s2.mtot + 1
        try:
            check(cuda_nufft.type2_2d_geometry(s2.mtot) == ("cuda",) and
                  cuda_nufft.type2_2d_single_geometry(
                      x2.shape[0], s2.mtot, torch.float32) == ("cuda",),
                  "the type-2s were not sent to the CUDA cores")
            return fn()
        finally:
            cuda_nufft.TYPE2_2D_TC_MIN_MTOT = keep

    check(cuda_nufft.type2_2d_geometry(s2.mtot)[0] == "tc" and
          cuda_nufft.type2_2d_single_geometry(
              x2.shape[0], s2.mtot, torch.float32)[0] == "tc",
          f"mtot {s2.mtot} is not routed to the tensor cores")
    sweep_cg = []
    for seed in (0, 1, 2):
        g64s = grad_cg(x2.double(), y2.double(), s64, "matmul", seed).grad
        row = {"kernels, type-2 on the tensor cores": rel_to(
                   grad_cg(x2, y2, s2, "auto", seed).grad, g64s),
               "kernels, type-2 on the CUDA cores": rel_to(
                   type2_on_cuda_cores(
                       lambda: grad_cg(x2, y2, s2, "auto", seed)).grad,
                   g64s),
               "gradient plain": rel_to(
                   grad_cg(x2, y2, s2, "matmul", seed).grad, g64s)}
        print(f"[5] CG-tier f32 gradient rel err vs float64, seed {seed}: "
              + "; ".join(f"{k} [{', '.join(f'{r:.3e}' for r in v)}]"
                          for k, v in row.items()))
        sweep_cg.append(dict(seed=seed, **row))
    for row in sweep_cg:
        tc_rel = row["kernels, type-2 on the tensor cores"]
        check(all(r <= 5e-2 for r in tc_rel),
              f"CG-tier gradient relative error {tc_rel} (seed "
              f"{row['seed']}) > 5e-2")
    record["phases"]["cg_tier"] = dict(
        mtot=s2.mtot, M=s2.M, iters=iters, launches=launches_cg,
        backend_picks=picks_cg, iters_f64=int(s64.mean_cg_iters),
        fit_mean_s=t2, err_mean=err_hard, profile=prof_cg,
        kron_iters=iters_k, kron_iters_f64=int(s64k.mean_cg_iters),
        kron_fit_mean_s=t2k, kron_launches=launches_kron,
        kron_err_mean=err_kron, kron_err_vs_jacobi=err_kron_jac,
        grad_s=t_grad_cg, grad_launches=launches_gcg,
        grad_trace_iters=trace_iters,
        grad_trace_iters_f64=int(g64.trace_cg_iters),
        grad_converged=converged, grad_rel_err=grad_rel_cg,
        grad_rel_err_sweep=sweep_cg)

    phase_s["5"] = time.perf_counter() - t_phase
    print(f"[5] phase wall time {phase_s['5']:.1f} s")

    # -- phase 6: d3, the fused pass on 3-D data -----------------------------
    t_phase = time.perf_counter()
    x3 = torch.as_tensor(xd3, dtype=torch.float32, device=dev)
    y3 = torch.as_tensor(yd3, dtype=torch.float32, device=dev)
    xq3 = torch.as_tensor(xqd3, dtype=torch.float32, device=dev)

    def type2_3d_on_cuda_cores(fn):
        """fn() with nufft2_3d's float32 calls sent to the CUDA-core kernel
        (the dispatch replaced for the call): the control of the d=3
        gradients' accuracy watch, on the same inputs and probes."""
        keep = cuda_nufft.type2_3d_geometry
        cuda_nufft.type2_3d_geometry = lambda n, mtot, B=1: ("cuda",)
        try:
            return fn()
        finally:
            cuda_nufft.type2_3d_geometry = keep

    def watch_line(tag, rel, rel_cc):
        """The accuracy watch's line: a gradient's relative error per
        component with the type-2 as dispatched and on the CUDA cores, and
        their ratio (a move past 2x is named)."""
        ratio = [a / b if b > 0 else float("inf") for a, b in
                 zip(rel, rel_cc)]
        moved = [i for i, r in enumerate(ratio) if not 0.5 <= r <= 2]
        return (f"{tag} gradient rel err vs float64 per component: type-2 "
                f"as dispatched [{', '.join(f'{r:.3e}' for r in rel)}], on "
                f"the CUDA cores [{', '.join(f'{r:.3e}' for r in rel_cc)}], "
                f"ratio [{', '.join(f'{r:.2f}' for r in ratio)}]"
                + (f"; components {moved} moved past 2x" if moved else ""))

    def fused3(x, y, xq, method, seed=0):
        return gpquad_torch.fit_predict_grad(
            x, y, xq, kern_d3, sigmasq, h_d3,
            torch.Generator(device=dev).manual_seed(seed), mtot=mtot_d3,
            nufft_method=method, device=dev, **FUSED3_KW)

    reset_counts(*counters)
    out3 = fused3(x3, y3, xq3, "auto")
    sync()
    launches_d3 = dict(cuda_nufft.LAUNCHES)
    picks_d3 = dict(nufft_mod.BACKEND_PICKS)
    print(f"[6] d3 fused fit_predict_grad mtot={mtot_d3} M={mtot_d3 ** 3} "
          f"launches={launches_d3} backend_picks={picks_d3}")
    # fit: F*y and the lag table (mtot 61: the slab-tiled branch); mean;
    # variance evaluation (mtot 61, FFT order); gradient: F*y again,
    # F(D beta), one batched F*Z and two batched F applies (10 vectors)
    check(launches_d3 == launch_counts(nufft1_3d=4, nufft2_3d=5),
          f"unexpected d3 launch counts {launches_d3}")
    check(picks_d3["matmul"] == 0, f"the d3 call took the plain path "
          f"{picks_d3}")
    check(out3.grad.dtype == torch.float32 and out3.beta.dtype ==
          torch.complex64, "the f32 d3 run left float32")
    # one timed call: the Jacobi call is seconds long, and kron below is
    # the preconditioner this call should take
    t = time.perf_counter()
    fused3(x3, y3, xq3, "auto")
    sync()
    d3_ms = (time.perf_counter() - t) * 1e3
    print(f"[6] d3 fused fit_predict_grad, Jacobi (var_max_cg_iter "
          f"{D3_VAR_MAX_CG_ITER}): {d3_ms:.2f} ms, one warm call (host "
          f"clock) {card}; mean PCG iters "
          f"{int(out3.mean_cg_iters)} converged {bool(out3.mean_converged)}, "
          f"trace PCG iters {int(out3.trace_cg_iters)}")
    out3_64 = fused3(x3.double(), y3.double(), xq3.double(), "matmul")
    sync()
    check(out3.mean.shape == (10_000,) and out3.var.shape == (10_000,)
          and out3.grad.shape == (3,), "wrong d3 output shapes")
    check(all(bool(torch.isfinite(t).all())
              for t in (out3.mean, out3.var, out3.grad)),
          "non-finite d3 output")
    d3_err_mean = float((out3.mean.double() - out3_64.mean).abs().max())
    d3_err_var = float((out3.var.double() - out3_64.var).abs().max())
    d3_var_scale = float(out3_64.var.abs().max())
    d3_grad_rel = rel_to(out3.grad, out3_64.grad)
    print(f"[6] d3 vs float64 plain path (same generator seed): "
          f"max|mean err|={d3_err_mean:.3e} (bar 5e-4), max|var err|="
          f"{d3_err_var:.3e} (bar 5e-2*max|var64| = {5e-2 * d3_var_scale:.3e})"
          f", grad rel err per component="
          f"{[f'{r:.3e}' for r in d3_grad_rel]} (bar 5e-2); f64 mean PCG "
          f"iters {int(out3_64.mean_cg_iters)}, trace "
          f"{int(out3_64.trace_cg_iters)}; grad f32={out3.grad.tolist()} "
          f"f64={out3_64.grad.tolist()}")
    check(bool(out3.mean_converged), "the d3 mean solve did not converge")
    check(d3_err_mean <= 5e-4, f"d3 mean error {d3_err_mean:.3e} > 5e-4")
    check(d3_err_var <= 5e-2 * d3_var_scale,
          f"d3 variance error {d3_err_var:.3e} > 5e-2 * max|var64|")
    check(all(r <= 5e-2 for r in d3_grad_rel),
          f"d3 gradient relative error {d3_grad_rel} > 5e-2")
    # the variance's probe solves on the same fit, at bench.py's cap and at
    # the one this phase runs: iterations and how many of the 256 converged
    st3 = gpquad_torch.fit_with_grid(x3, y3, kern_d3, sigmasq, h_d3, mtot_d3,
                                     cg_tol=FUSED_KW["cg_tol"],
                                     max_cg_iter=FUSED_KW["max_cg_iter"],
                                     device=dev)
    etas3 = torch.as_tensor(np.random.default_rng(2).choice(
        [-1.0, 1.0], size=(probes, st3.M)), device=dev).float()
    var_solves = {}
    for cap in (FUSED_KW["var_max_cg_iter"], D3_VAR_MAX_CG_ITER):
        res = efgp_mod._solve_var(st3, st3.ws[None, :] * etas3,
                                  cg_tol=FUSED_KW["var_cg_tol"],
                                  max_cg_iter=cap)
        var_solves[cap] = (int(res.iters), int(res.converged.sum()))
        print(f"[6] d3 variance probe solves (Jacobi PCG, cg_tol 1e-4) at "
              f"max_cg_iter {cap}: {var_solves[cap][0]} iterations, "
              f"{var_solves[cap][1]}/{probes} probes converged")
    check(var_solves[D3_VAR_MAX_CG_ITER][1] == probes,
          "the d3 variance solves did not converge")

    # the same call with the Kronecker preconditioner (gpquad's lever for
    # this cell, pipeline.py:93-97): fit, variance and trace solves
    def fused3k(x, y, xq, method, seed=0):
        return gpquad_torch.fit_predict_grad(
            x, y, xq, kern_d3, sigmasq, h_d3,
            torch.Generator(device=dev).manual_seed(seed), mtot=mtot_d3,
            nufft_method=method, precond="kron", device=dev, **FUSED3_KW)

    fused3k(x3, y3, xq3, "auto")                           # warm
    reset_counts(*counters)
    out3k = fused3k(x3, y3, xq3, "auto")
    sync()
    tiled_d3 = tiled_counts(cuda_nufft.LAUNCH_WIDTHS)
    launches_d3k = dict(cuda_nufft.LAUNCHES)
    picks_d3k = dict(nufft_mod.BACKEND_PICKS)
    d3k_ms = host_ms(lambda: fused3k(x3, y3, xq3, "auto"), reps=3)
    prof_d3k = profile_run(lambda: fused3k(x3, y3, xq3, "auto"))
    out3k_64 = fused3k(x3.double(), y3.double(), xq3.double(), "matmul")
    sync()
    st3k = gpquad_torch.fit_with_grid(x3, y3, kern_d3, sigmasq, h_d3,
                                      mtot_d3, cg_tol=FUSED_KW["cg_tol"],
                                      max_cg_iter=FUSED_KW["max_cg_iter"],
                                      solver="cg", precond="kron",
                                      device=dev)
    res_k = efgp_mod._solve_var(st3k, st3k.ws[None, :] * etas3,
                                cg_tol=FUSED_KW["var_cg_tol"],
                                max_cg_iter=D3_VAR_MAX_CG_ITER)
    var_solves_k = (int(res_k.iters), int(res_k.converged.sum()))
    d3k_err_mean = float((out3k.mean.double() - out3k_64.mean).abs().max())
    d3k_err_var = float((out3k.var.double() - out3k_64.var).abs().max())
    d3k_var_scale = float(out3k_64.var.abs().max())
    d3k_grad_rel = rel_to(out3k.grad, out3k_64.grad)
    print(f"[6] d3 fused fit_predict_grad, kron: {d3k_ms:.2f} ms median of "
          f"3 warm calls (host clock) {card} (Jacobi {d3_ms:.2f} ms); "
          f"launches={launches_d3k} backend_picks={picks_d3k}; mean PCG "
          f"iters {int(out3k.mean_cg_iters)} (Jacobi "
          f"{int(out3.mean_cg_iters)}; past 56 modes {tiled_d3}), "
          f"variance probe solves "
          f"{var_solves_k[0]} iterations, {var_solves_k[1]}/{probes} "
          f"converged (Jacobi {var_solves[D3_VAR_MAX_CG_ITER][0]}), trace "
          f"PCG iters {int(out3k.trace_cg_iters)} (Jacobi "
          f"{int(out3.trace_cg_iters)})")
    print(f"[6] d3 kron vs its float64 plain path run: max|mean err|="
          f"{d3k_err_mean:.3e} (bar 5e-4), max|var err|={d3k_err_var:.3e} "
          f"(bar 5e-2*max|var64| = {5e-2 * d3k_var_scale:.3e}), grad rel "
          f"err per component={[f'{r:.3e}' for r in d3k_grad_rel]} (bar "
          f"5e-2); f64 mean PCG iters {int(out3k_64.mean_cg_iters)}, trace "
          f"{int(out3k_64.trace_cg_iters)}")
    print_profile("[6] profiled d3 kron fused call:", prof_d3k, card)
    check(launches_d3k == launch_counts(nufft1_3d=4, nufft2_3d=5),
          f"unexpected d3 kron launch counts {launches_d3k}")
    # the lag table and the variance evaluation (mtot 61) past 56 modes
    check((tiled_d3["_pallas_nufft1_3d_tiled"],
           tiled_d3["_pallas_nufft2_3d_tiled"]) == (1, 1),
          f"unexpected d3 mode-tiled launches {tiled_d3}")
    check(picks_d3k["matmul"] == 0, f"the d3 kron call took the plain path "
          f"{picks_d3k}")
    check(bool(out3k.mean_converged), "the d3 kron mean solve did not "
          "converge")
    check(int(out3k.mean_cg_iters) <= KRON_MAX_ITERS,
          f"d3 kron mean solve took {int(out3k.mean_cg_iters)} iterations")
    check(var_solves_k[1] == probes, "the d3 kron variance solves did not "
          "converge")
    check(all(bool(torch.isfinite(t).all())
              for t in (out3k.mean, out3k.var, out3k.grad)),
          "non-finite d3 kron output")
    check(d3k_err_mean <= 5e-4, f"d3 kron mean error {d3k_err_mean:.3e}")
    check(d3k_err_var <= 5e-2 * d3k_var_scale,
          f"d3 kron variance error {d3k_err_var:.3e} > 5e-2 * max|var64|")
    check(all(r <= 5e-2 for r in d3k_grad_rel),
          f"d3 kron gradient relative error {d3k_grad_rel} > 5e-2")
    # the accuracy watch: both calls' gradients again with the type-2 on
    # the CUDA cores (same inputs, generator seed and float64 runs)
    d3_grad_rel_cc = rel_to(type2_3d_on_cuda_cores(
        lambda: fused3(x3, y3, xq3, "auto")).grad, out3_64.grad)
    d3k_grad_rel_cc = rel_to(type2_3d_on_cuda_cores(
        lambda: fused3k(x3, y3, xq3, "auto")).grad, out3k_64.grad)
    print(watch_line("[6] d3 Jacobi", d3_grad_rel, d3_grad_rel_cc))
    print(watch_line("[6] d3 kron", d3k_grad_rel, d3k_grad_rel_cc))
    record["phases"]["d3"] = dict(
        var_max_cg_iter=D3_VAR_MAX_CG_ITER, var_solves=var_solves,
        mtot=mtot_d3, M=mtot_d3 ** 3, launches=launches_d3,
        backend_picks=picks_d3, fused_ms=d3_ms,
        kron=dict(fused_ms=d3k_ms, launches=launches_d3k, profile=prof_d3k,
                  tiled_launches=tiled_d3,
                  mean_cg_iters=int(out3k.mean_cg_iters),
                  mean_cg_iters_f64=int(out3k_64.mean_cg_iters),
                  trace_cg_iters=int(out3k.trace_cg_iters),
                  var_solves=var_solves_k, err_mean=d3k_err_mean,
                  err_var=d3k_err_var, max_abs_var64=d3k_var_scale,
                  grad_rel_err=d3k_grad_rel,
                  grad_rel_err_type2_cuda_cores=d3k_grad_rel_cc),
        mean_cg_iters=int(out3.mean_cg_iters),
        mean_cg_iters_f64=int(out3_64.mean_cg_iters),
        trace_cg_iters=int(out3.trace_cg_iters),
        trace_cg_iters_f64=int(out3_64.trace_cg_iters),
        err_mean=d3_err_mean, err_var=d3_err_var,
        max_abs_var64=d3_var_scale, grad_rel_err=d3_grad_rel,
        grad_rel_err_type2_cuda_cores=d3_grad_rel_cc,
        grad_f32=out3.grad.tolist(), grad_f64=out3_64.grad.tolist())
    phase_s["6"] = time.perf_counter() - t_phase
    print(f"[6] phase wall time {phase_s['6']:.1f} s")

    # -- phase 7: hard3d, the deflated CG tier -------------------------------
    t_phase = time.perf_counter()
    x4 = torch.as_tensor(xh3, dtype=torch.float32, device=dev)
    y4 = torch.as_tensor(yh3, dtype=torch.float32, device=dev)
    xq4 = torch.as_tensor(xqh3, dtype=torch.float32, device=dev)
    rank = 2048                                  # bench.py:784

    def fit_h3(x, y, xq, method):
        """bench.py:401-405: the deflated CG fit, then the mean."""
        t = time.perf_counter()
        st_ = gpquad_torch.fit_with_grid(
            x, y, kern_h3, sigmasq, h_h3, mtot_h3, cg_tol=1e-6,
            max_cg_iter=2000, solver="cg", precond_rank=rank,
            nufft_method=method, device=dev)
        mu = gpquad_torch.predict_mean(st_, xq, nufft_method=method)
        sync()
        return st_, mu, time.perf_counter() - t

    fit_h3(x4, y4, xq4, "auto")                            # warm
    reset_counts(*counters)
    s4, mu4, t4 = fit_h3(x4, y4, xq4, "auto")
    launches_h3 = dict(cuda_nufft.LAUNCHES)
    picks_h3 = dict(nufft_mod.BACKEND_PICKS)
    s4_64, mu4_64, _ = fit_h3(x4.double(), y4.double(), xq4.double(),
                              "matmul")
    iters_h3 = int(s4.mean_cg_iters)
    err_h3 = float((mu4.double() - mu4_64).abs().max())
    print(f"[7] hard3d deflated fit (rank {rank}) + mean: mtot={s4.mtot} "
          f"M={s4.M} PCG iters={iters_h3} (f64: {int(s4_64.mean_cg_iters)}; "
          f"bar 60) {t4 * 1e3:.2f} ms (warm, host clock) {card}; launches="
          f"{launches_h3} backend_picks={picks_h3}; max|mean err| vs f64 "
          f"{err_h3:.3e} (bar 5e-4)")
    check(launches_h3 == launch_counts(nufft1_3d=2, nufft2_3d=1),
          f"unexpected hard3d fit launch counts {launches_h3}")
    check(picks_h3["matmul"] == 0, f"hard3d took the plain path {picks_h3}")
    check(s4.defl_P is not None and s4.defl_idx.shape == (rank,),
          "the hard3d fit carries no deflation block")
    check(iters_h3 <= 60, f"hard3d deflated fit took {iters_h3} > 60 PCG "
          "iterations")
    check(bool(torch.isfinite(mu4).all()), "non-finite hard3d mean")
    check(err_h3 <= 5e-4, f"hard3d mean error {err_h3:.3e} > 5e-4")

    # the stochastic variance reuses the fit's block (one probe chunk)
    M4 = s4.M
    etas4 = torch.as_tensor(np.random.default_rng(5).choice(
        [-1.0, 1.0], size=(probes, M4)), device=dev)
    var_kw = dict(method="stochastic", probes=probes, cg_tol=1e-4,
                  max_cg_iter=400, etas=etas4)
    gpquad_torch.predict_var(s4, xq4, **var_kw)           # warm
    reset_counts(*counters)
    t = time.perf_counter()
    var4 = gpquad_torch.predict_var(s4, xq4, **var_kw)
    sync()
    t_var4 = time.perf_counter() - t
    launches_var4 = dict(cuda_nufft.LAUNCHES)
    var4_64 = gpquad_torch.predict_var(s4_64, xq4.double(),
                                       nufft_method="matmul", **var_kw)
    res_var = efgp_mod._solve_var(s4, s4.ws[None, :] * etas4.float(),
                                  cg_tol=1e-4, max_cg_iter=400)
    var_conv = bool(res_var.converged.all())
    err_var4 = float((var4.double() - var4_64).abs().max())
    var4_scale = float(var4_64.abs().max())
    print(f"[7] hard3d variance (256 probes, cg_tol 1e-4, the fit's "
          f"deflation block): PCG iters={int(res_var.iters)} converged="
          f"{var_conv} {t_var4 * 1e3:.2f} ms (warm, host clock) {card}; "
          f"launches={launches_var4}; max|var err| vs f64 {err_var4:.3e} "
          f"({err_var4 / var4_scale:.3e} of max|var64| = {var4_scale:.3e})")
    check(launches_var4 == launch_counts(nufft2_3d=1),
          f"unexpected hard3d variance launch counts {launches_var4}")
    check(var_conv, "the hard3d variance solves did not converge")
    check(bool(torch.isfinite(var4).all()), "non-finite hard3d variance")

    # the gradient on the fit's state: trace solves with the same block
    def grad_h3(x, y, st_, method, tol=FUSED_KW["grad_cg_tol"]):
        return gpquad_torch.gradient_with_grid(
            x, y, kern_h3, sigmasq, st_.h,
            torch.Generator(device=dev).manual_seed(0), mtot=st_.mtot,
            trace_samples=FUSED_KW["trace_samples"], cg_tol=tol,
            max_cg_iter=2000, beta0=st_.beta, state=st_,
            nufft_method=method)

    grad_h3(x4, y4, s4, "auto")                           # warm
    reset_counts(*counters)
    t = time.perf_counter()
    g4 = grad_h3(x4, y4, s4, "auto")
    sync()
    t_grad4 = time.perf_counter() - t
    launches_g4 = dict(cuda_nufft.LAUNCHES)
    g4_64 = grad_h3(x4.double(), y4.double(), s4_64, "matmul")
    g4_conv = bool((g4.trace_conv_iters < 2000).all())
    g4_rel = rel_to(g4.grad, g4_64.grad)
    print(f"[7] hard3d gradient (state=fit, T=10, cg_tol 1e-4, deflation): "
          f"trace PCG iters={int(g4.trace_cg_iters)} (f64: "
          f"{int(g4_64.trace_cg_iters)}) converged={g4_conv} "
          f"{t_grad4 * 1e3:.2f} ms (warm, host clock) {card}; launches="
          f"{launches_g4}; grad f32={g4.grad.tolist()} f64="
          f"{g4_64.grad.tolist()} rel err={[f'{r:.3e}' for r in g4_rel]}")
    check(launches_g4 == launch_counts(nufft1_3d=2, nufft2_3d=3),
          f"unexpected hard3d gradient launch counts {launches_g4}")
    check(g4_conv, "the hard3d trace solves did not converge")
    check(bool(torch.isfinite(g4.grad).all()), "non-finite hard3d gradient")
    # how much of the f32-f64 gap is where the trace solves stop: both
    # precisions against a float64 run whose solves go to 1e-10
    g4_ref = grad_h3(x4.double(), y4.double(), s4_64, "matmul", 1e-10).grad
    g4_tight = grad_h3(x4, y4, s4, "auto", 1e-6)
    g4_vs_tight = {"f32 cg_tol 1e-4": rel_to(g4.grad, g4_ref),
                   "f64 cg_tol 1e-4": rel_to(g4_64.grad, g4_ref),
                   "f32 cg_tol 1e-6": rel_to(g4_tight.grad, g4_ref)}
    print(f"[7] hard3d gradient rel err vs float64 solved to 1e-10 "
          f"({g4_ref.tolist()}): " + "; ".join(
              f"{k} [{', '.join(f'{r:.3e}' for r in v)}]"
              for k, v in g4_vs_tight.items())
          + f"; f32 cg_tol 1e-6 trace PCG iters "
          f"{int(g4_tight.trace_cg_iters)}")
    # the accuracy watch: both f32 gradients with the type-2 on the CUDA
    # cores (same state, probes and reference)
    g4_watch = {}
    for tol_tag, g_, tol in (("cg_tol 1e-4", g4, FUSED_KW["grad_cg_tol"]),
                             ("cg_tol 1e-6", g4_tight, 1e-6)):
        g_cc = type2_3d_on_cuda_cores(lambda: grad_h3(x4, y4, s4, "auto",
                                                      tol))
        g4_watch[tol_tag] = (rel_to(g_.grad, g4_ref),
                             rel_to(g_cc.grad, g4_ref))
        print(watch_line(f"[7] hard3d f32 {tol_tag} (against float64 "
                         "solved to 1e-10)", *g4_watch[tol_tag]))
    record["phases"]["hard3d"] = dict(
        mtot=s4.mtot, M=M4, precond_rank=rank, iters=iters_h3,
        iters_f64=int(s4_64.mean_cg_iters), fit_mean_s=t4,
        launches_fit_mean=launches_h3, err_mean=err_h3,
        var_s=t_var4, var_iters=int(res_var.iters), var_converged=var_conv,
        launches_var=launches_var4, err_var=err_var4,
        max_abs_var64=var4_scale, grad_s=t_grad4,
        grad_trace_iters=int(g4.trace_cg_iters),
        grad_trace_iters_f64=int(g4_64.trace_cg_iters),
        grad_converged=g4_conv, launches_grad=launches_g4,
        grad_rel_err=g4_rel, grad_rel_err_vs_tight_f64=g4_vs_tight,
        grad_rel_err_watch=g4_watch)
    phase_s["7"] = time.perf_counter() - t_phase
    print(f"[7] phase wall time {phase_s['7']:.1f} s")

    # -- phase 8: the d=1 facade on a Kepler light curve ---------------------
    t_phase = time.perf_counter()
    x8 = torch.as_tensor(lc["x"], dtype=torch.float32, device=dev)
    y8 = torch.as_tensor(lc["y"], dtype=torch.float32, device=dev)

    def lc_model(x, y, **opts):
        return gpquad_torch.EFGP(x, y, kern_lc, sigmasq=0.01, eps=1e-4,
                                 estimate_params=False, opts=opts or None,
                                 device=dev)

    # the f32 gradient against float64 at the starting hypers, with the
    # same 10 trace probes (the float64 run on the plain path); beside it the
    # f32 plain path, the floor of f32 arithmetic without the kernels
    m32, m64 = lc_model(x8, y8), lc_model(x8.double(), y8.double(),
                                          nufft_method="matmul")
    m32p = lc_model(x8, y8, nufft_method="matmul")
    check(m32._grid_plan(True)[1] == rung_lc, "light-curve rung")
    # the variance component, y.alpha - sigma^2 |alpha|^2 against the trace
    # term, cancels two terms of ~n / 2 (3e4) down to ~50, so a correlated
    # f32 error of ~1e-7 in F*y or the lag table shows there (nufft1_1d sums
    # runs of 32 points for it); three probe seeds, kernels and plain path
    g8_bars = [1e-2, 1e-2, 2e-2]
    g8_sweep = []
    for seed in (8, 9, 10):
        prng = np.random.default_rng(seed)
        Z8 = torch.as_tensor(prng.choice([-1.0, 1.0], size=(10, n_lc)),
                             device=dev)
        V8 = torch.as_tensor(prng.choice([-1.0, 1.0], size=(10, rung_lc)),
                             device=dev)
        gkw = dict(trace_samples=10, cg_tol=LC_OPT["cg_tol"],
                   noise_floor=LC_OPT["noise_floor"], probes=(Z8, V8))
        g8 = m32.compute_gradients(**gkw)
        g8_64 = m64.compute_gradients(**gkw)
        g8_sweep.append(dict(seed=seed, kernels=rel_to(g8, g8_64),
                             plain=rel_to(m32p.compute_gradients(**gkw),
                                          g8_64), grad_raw_f64=g8_64.tolist()))
        print(f"[8] light curve n={n_lc} mtot {mtot_lc} rung {rung_lc}: f32 "
              f"gradient at the start vs float64 (probe seed {seed}, T=10): "
              f"rel err {[f'{r:.3e}' for r in g8_sweep[-1]['kernels']]} "
              f"(bars {g8_bars}); the f32 plain path "
              f"{[f'{r:.3e}' for r in g8_sweep[-1]['plain']]}; grad_raw "
              f"f32={g8.tolist()} f64={g8_64.tolist()}")
    for row in g8_sweep:
        check(all(r <= b for r, b in zip(row["kernels"], g8_bars)),
              f"light-curve f32 gradient error {row['kernels']} (seed "
              f"{row['seed']}) over {g8_bars}")

    # the example's flow: Adam on the hypers, then the posterior at 5 000
    # points; every grid plan is timed (each iteration starts with one)
    model = lc_model(x8, y8)
    plan_t0, plan_ms = [], []
    plan = model._grid_plan

    def timed_plan(bucket):
        t = time.perf_counter()
        out_ = plan(bucket)
        plan_t0.append(t)
        plan_ms.append((time.perf_counter() - t) * 1e3)
        return out_

    model._grid_plan = timed_plan
    xq8 = torch.linspace(0, 1, 5000, device=dev)
    reset_counts(*counters)
    t = time.perf_counter()
    model.optimize_hyperparameters(**LC_OPT)
    sync()
    t_opt = time.perf_counter() - t
    t = time.perf_counter()
    mean8, var8 = model.predict(xq8)
    sync()
    t_pred = time.perf_counter() - t
    launches_lc = dict(cuda_nufft.LAUNCHES)
    picks_lc = dict(nufft_mod.BACKEND_PICKS)
    iter_ms = [(b - a) * 1e3 for a, b in zip(plan_t0, plan_t0[1:])]
    hyp = {k: float(v) for k, v in model.params.as_dict().items()}
    span = lc["t"].max() - lc["t"].min()
    ell_days = hyp["lengthscale"] * span
    flux = mean8.double().cpu().numpy() * lc["y_std"] + lc["y_mean"]
    t_pred_grid = xq8.double().cpu().numpy() * span + lc["t"].min()
    truth = 1.0 + np.interp(t_pred_grid, lc["t_all"], lc["f_full"])
    in_gap = np.zeros(len(t_pred_grid), bool)
    for lo, hi in LC_GAPS:
        in_gap |= (t_pred_grid > lo) & (t_pred_grid < hi)
    rmse_data = float(np.sqrt(np.mean((flux - truth)[~in_gap] ** 2)))
    rmse_gap = float(np.sqrt(np.mean((flux - truth)[in_gap] ** 2)))
    hist = model.training_log
    print(f"[8] 50 Adam iterations: {t_opt * 1e3:.1f} ms in all, "
          f"{statistics.median(iter_ms):.2f} ms per iteration (median, host "
          f"clock), of which the grid plan {statistics.median(plan_ms):.2f} "
          f"ms (host, float64) {card}; last rung "
          f"{model.last_gradient_stats['mtot']}, final fit "
          f"mtot {model._state.mtot}; predict (mean + 1000-probe variance "
          f"at 5 000 points) {t_pred * 1e3:.1f} ms")
    print(f"[8] learned {({k: round(v, 6) for k, v in hyp.items()})}: "
          f"lengthscale {ell_days:.3f} d (bar < {lc['period']} d); "
          f"posterior-mean RMSE on-data {rmse_data:.3e} (bar < {LC_NOISE}), "
          f"in-gap {rmse_gap:.3e}; launches={launches_lc} "
          f"backend_picks={picks_lc}; mean CG iters "
          f"{hist['mean_cg_iters'][:3]}...{hist['mean_cg_iters'][-3:]}")
    check(ell_days < lc["period"], f"the GP must resolve the rotation "
          f"signal: lengthscale {ell_days:.2f} d")
    check(rmse_data < LC_NOISE, f"on-data RMSE {rmse_data:.3e} >= noise")
    for k in KERNELS_1D:
        check(launches_lc[k] > 0, f"kernel {k} was not launched on the "
              "light-curve path")
    check(picks_lc["matmul"] == 0, f"the light-curve path took the plain "
          f"path {picks_lc}")
    check(mean8.shape == (5000,) and var8.shape == (5000,)
          and bool(torch.isfinite(mean8).all())
          and bool(torch.isfinite(var8).all()),
          "light-curve mean or variance: wrong shape or non-finite")
    record["phases"]["lightcurve"] = dict(
        n=n_lc, mtot=mtot_lc, rung=rung_lc, grad_rel_err_start=g8_sweep,
        opt_s=t_opt, iter_ms=iter_ms, plan_ms=plan_ms, predict_s=t_pred,
        learned=hyp, lengthscale_days=ell_days, rmse_on_data=rmse_data,
        rmse_in_gap=rmse_gap, launches=launches_lc, backend_picks=picks_lc,
        final_mtot=model._state.mtot, history=hist)
    phase_s["8"] = time.perf_counter() - t_phase
    print(f"[8] phase wall time {phase_s['8']:.1f} s")

    # -- phase 9: the facade at the headline ---------------------------------
    t_phase = time.perf_counter()
    m9 = gpquad_torch.EFGP(x32, y32, "SE", sigmasq=sigmasq, eps=eps,
                           device=dev)
    raw0 = m9.params.raw.clone()
    opt9 = dict(max_iters=20, lr=0.05, trace_samples=10)

    def seeded():
        return torch.Generator(device=dev).manual_seed(7)

    # warm the same trajectory (bench.py:977-984), then reset and time it
    m9.optimize_hyperparameters(generator=seeded(), **opt9)
    floor9 = m9._mtot_floor
    m9.params = m9.params.replace_raw(raw0)
    reset_counts(*counters)
    t = time.perf_counter()
    m9.optimize_hyperparameters(generator=seeded(), **opt9)
    sync()
    t9 = time.perf_counter() - t
    launches9 = dict(cuda_nufft.LAUNCHES)
    picks9 = dict(nufft_mod.BACKEND_PICKS)
    prof9 = profile_run(lambda: m9.compute_gradients(trace_samples=10))
    # the same trajectory in float64 on the plain path: same start, same
    # rung, same generator seed, so the same probes
    m9_64 = gpquad_torch.EFGP(x32.double(), y32.double(), "SE",
                              sigmasq=sigmasq, eps=eps,
                              opts={"nufft_method": "matmul"}, device=dev)
    m9_64.params = m9_64.params.replace_raw(raw0)
    m9_64._mtot_floor = floor9
    m9_64.optimize_hyperparameters(generator=seeded(), **opt9)
    gap9 = (m9.params.raw - m9_64.params.raw).abs().tolist()
    print(f"[9] headline facade: start {torch.exp(raw0).tolist()}, rung "
          f"{m9.last_gradient_stats['mtot']}; 20 Adam iterations "
          f"{t9 * 1e3:.1f} ms = {t9 / 20 * 1e3:.2f} ms per iteration (host "
          f"clock) {card}; launches={launches9} backend_picks={picks9}; "
          f"final raw f32 {m9.params.raw.tolist()} f64 "
          f"{m9_64.params.raw.tolist()}, |gap| {gap9} (bar 0.1)")
    print_profile("[9] profiled gradient step (plan + gradient):", prof9,
                  card)
    for k in KERNELS_2D:
        check(launches9[k] > 0, f"kernel {k} was not launched by the "
              "headline facade")
    check(picks9["matmul"] == 0, f"the headline facade took the plain path "
          f"{picks9}")
    check(all(g <= 0.1 for g in gap9), f"headline facade: f32 and f64 "
          f"trajectories end {gap9} apart in log space")
    record["phases"]["headline_facade"] = dict(
        start=torch.exp(raw0).tolist(), rung=m9.last_gradient_stats["mtot"],
        hyper20_s=t9, iter_ms=t9 / 20 * 1e3, launches=launches9,
        backend_picks=picks9, profile_gradient_step=prof9,
        raw_f32=m9.params.raw.tolist(), raw_f64=m9_64.params.raw.tolist(),
        raw_gap=gap9, history=m9.training_log)
    phase_s["9"] = time.perf_counter() - t_phase
    print(f"[9] phase wall time {phase_s['9']:.1f} s")

    # -- phase 10: the scale configuration with kron -------------------------
    t_phase = time.perf_counter()
    xs, ys, xqs = scale_data(n10)
    xq10 = torch.as_tensor(xqs, dtype=torch.float32, device=dev)
    x10 = torch.as_tensor(xs, dtype=torch.float32, device=dev)
    y10 = torch.as_tensor(ys, dtype=torch.float32, device=dev)
    del xs, ys
    kron_kw = dict(solver="cg", precond="kron", fft_smooth=True)

    def fit10(x, y, xq):
        st_ = gpquad_torch.fit_with_grid(x, y, kern10, sigmasq, h10, mtot10,
                                         cg_tol=1e-6, max_cg_iter=2000,
                                         device=dev, **kron_kw)
        return st_, gpquad_torch.predict_mean(st_, xq)

    stage = {}
    fit10(x10, y10, xq10)                                  # warm
    reset_counts(*counters)
    t = time.perf_counter()
    st10, mean10 = fit10(x10, y10, xq10)
    sync()
    stage["fit_mean_s"] = time.perf_counter() - t
    tiled10 = tiled_counts(cuda_nufft.LAUNCH_WIDTHS)
    launches10 = dict(cuda_nufft.LAUNCHES)
    iters10 = int(st10.mean_cg_iters)

    def var10():
        return gpquad_torch.predict_var(
            st10, xq10[:1000], method="stochastic", probes=256, cg_tol=1e-4,
            max_cg_iter=1000,
            generator=torch.Generator(device=dev).manual_seed(11))

    var10()
    reset_counts(*counters)
    t = time.perf_counter()
    v10 = var10()
    sync()
    stage["var_s"] = time.perf_counter() - t
    launches_var10 = dict(cuda_nufft.LAUNCHES)
    tiled_var10 = tiled_counts(cuda_nufft.LAUNCH_WIDTHS)
    etas10 = torch.as_tensor(np.random.default_rng(12).choice(
        [-1.0, 1.0], size=(256, st10.M)), dtype=torch.float32, device=dev)
    res10 = efgp_mod._solve_var(st10, st10.ws[None, :] * etas10,
                                cg_tol=1e-4, max_cg_iter=1000)
    var_iters10 = (int(res10.iters), int(res10.converged.sum()))
    del etas10, res10

    def grad10(kern, s2, gen, **kw):
        return gpquad_torch.gradient_with_grid(
            x10, y10, kern, s2, h10, gen, mtot=mtot10, device=dev,
            **kron_kw, **kw)

    gkw10 = dict(trace_samples=10, cg_tol=1e-4, max_cg_iter=1000)
    grad10(kern10, sigmasq, seeded(), **gkw10)
    reset_counts(*counters)
    t = time.perf_counter()
    gr10 = grad10(kern10, sigmasq, seeded(), **gkw10)
    sync()
    stage["grad_s"] = time.perf_counter() - t
    launches_grad10 = dict(cuda_nufft.LAUNCHES)
    widths_grad10 = dict(cuda_nufft.LAUNCH_WIDTHS)

    # bench.py's fixed-plan Adam loop on a HyperState (T=5, cg_tol 1e-3)
    params = gpquad_torch.HyperState.create(kern10, sigmasq)
    raw = params.raw.to(dev).clone()
    adam = torch.optim.Adam([raw], lr=0.05)
    gen10 = seeded()

    def hyper_iter():
        p = params.replace_raw(raw.detach())
        res = grad10(p.kernel_of(kern10), p.sig2, gen10, trace_samples=5,
                     cg_tol=1e-3, max_cg_iter=500)
        raw.grad = res.grad.to(raw.dtype) * torch.exp(raw.detach())
        adam.step()
        return res

    hyper_iter()                                           # warm
    raw.data.copy_(params.raw.to(dev))
    adam = torch.optim.Adam([raw], lr=0.05)
    reset_counts(*counters)
    t = time.perf_counter()
    trace_iters_loop = [int(hyper_iter().trace_cg_iters) for _ in range(20)]
    sync()
    stage["hyperlearn_20iters_s"] = time.perf_counter() - t
    launches_loop10 = dict(cuda_nufft.LAUNCHES)
    widths_loop10 = dict(cuda_nufft.LAUNCH_WIDTHS)
    st10_64, mean10_64 = fit10(x10.double(), y10.double(), xq10.double())
    err10 = float((mean10.double() - mean10_64).abs().max())
    print(f"[10] scale n={n10} mtot={mtot10} M={st10.M} (kron, smooth FFT "
          f"{st10.toeplitz.fft_shape}): fit + mean {stage['fit_mean_s'] * 1e3:.1f}"
          f" ms, kron PCG iters {iters10} (bar {KRON_MAX_ITERS}; f64 "
          f"{int(st10_64.mean_cg_iters)}); launches={launches10} (past 256 "
          f"modes {tiled10}); max|mean "
          f"err| vs the f64 kron fit {err10:.3e} (bar 5e-4) {card}")
    print(f"[10] variance (256 probes, 1 000 targets) {stage['var_s'] * 1e3:.1f}"
          f" ms, probe solves {var_iters10[0]} iterations, {var_iters10[1]}/"
          f"256 converged; gradient (T=10) {stage['grad_s'] * 1e3:.1f} ms, "
          f"trace PCG iters {int(gr10.trace_cg_iters)}, mean "
          f"{int(gr10.mean_cg_iters)}; 20 Adam iterations "
          f"{stage['hyperlearn_20iters_s'] * 1e3:.1f} ms = "
          f"{stage['hyperlearn_20iters_s'] / 20 * 1e3:.1f} ms per Adam step, "
          f"trace iters {trace_iters_loop}; learned lengthscale "
          f"{float(torch.exp(raw[0])):.5f} (host clock) {card}")
    print(f"[10] launches: variance {launches_var10} (past 256 modes "
          f"{tiled_var10}); gradient {launches_grad10} (by width "
          f"{widths_grad10}); the 20-step Adam loop {launches_loop10} (by "
          f"width {widths_loop10})")
    check(launches10 == counts(2, 1),
          f"unexpected scale fit + mean launch counts {launches10}")
    # F*y (339) and the lag table (677) past 256 modes, and the mean (339)
    check((tiled10["_pallas_nufft1_2d_tiled"],
           tiled10["_pallas_nufft2_2d_tiled"]) == (2, 1),
          f"unexpected mode-tiled launches at scale {tiled10}")
    check(iters10 <= KRON_MAX_ITERS,
          f"scale kron fit took {iters10} > {KRON_MAX_ITERS} iterations")
    check(err10 <= 5e-4, f"scale mean error {err10:.3e} > 5e-4")
    check(var_iters10[1] == 256, "the scale variance solves did not "
          "converge")
    check(all(bool(torch.isfinite(t_).all())
              for t_ in (mean10, v10, gr10.grad, raw)),
          "non-finite scale output")
    record["phases"]["scale"] = dict(
        n=n10, mtot=mtot10, M=st10.M, fft_shape=list(st10.toeplitz.fft_shape),
        tiled_launches=tiled10,
        stages_s=stage, kron_iters=iters10,
        kron_iters_f64=int(st10_64.mean_cg_iters), launches=launches10,
        err_mean=err10, var_iters=var_iters10,
        grad_trace_iters=int(gr10.trace_cg_iters),
        grad_mean_iters=int(gr10.mean_cg_iters),
        loop_trace_iters=trace_iters_loop,
        ms_per_adam_step=stage["hyperlearn_20iters_s"] / 20 * 1e3,
        launches_var=launches_var10, tiled_launches_var=tiled_var10,
        launches_grad=launches_grad10,
        launches_grad_by_width={f"{k} {m}": c
                                for (k, m), c in widths_grad10.items()},
        launches_adam_loop=launches_loop10,
        launches_adam_loop_by_width={f"{k} {m}": c
                                     for (k, m), c in widths_loop10.items()},
        learned_raw=raw.detach().tolist())
    del st10, st10_64, x10, y10
    phase_s["10"] = time.perf_counter() - t_phase
    print(f"[10] phase wall time {phase_s['10']:.1f} s")

    # -- phase 11: the SKI baseline at full width ---------------------------
    t_phase = time.perf_counter()
    from gpquad_torch.ops.cg import pcg
    from gpquad_torch.ops.toeplitz import make_toeplitz
    ski_counters = (cuda_interp.LAUNCHES, ski_mod.INTERP_PICKS, *counters)
    xq11_t = torch.as_tensor(xq11, dtype=torch.float32, device=dev)
    reset_counts(*ski_counters)
    stages11, times11 = {}, {}
    t = time.perf_counter()
    fit11 = ski_mod.fit_ski_gp(xs11, ys11, kernel="SE", grid_size=SKI_GRID,
                               max_iters=SKI_ITERS, verbose=False, device=dev)
    sync()
    times11["fit_s"] = time.perf_counter() - t
    stages11["fit"] = dict(cuda_interp.LAUNCHES)
    t = time.perf_counter()
    mean11 = ski_mod.ski_predict_mean(fit11, xq11_t)
    sync()
    times11["mean_s"] = time.perf_counter() - t
    stages11["mean"] = dict(cuda_interp.LAUNCHES)
    t = time.perf_counter()
    var11 = ski_mod.ski_predict_var(fit11, xq11_t[:SKI_VAR_TARGETS],
                                    batch_size=SKI_VAR_TARGETS, cg_tol=1e-6,
                                    max_cg_iter=1000)
    sync()
    times11["var_s"] = time.perf_counter() - t
    stages11["var"] = dict(cuda_interp.LAUNCHES)
    launches11 = dict(cuda_interp.LAUNCHES)
    picks11 = dict(ski_mod.INTERP_PICKS)
    nufft11 = dict(cuda_nufft.LAUNCHES)
    op11 = fit11["model"]["operator"]
    hist11 = fit11["history"]
    iter_ms11 = [(f + b) * 1e3 for f, b in zip(hist11["forward_sec"],
                                               hist11["backward_sec"])]
    print(f"[11] ski n={SKI_N} grid {SKI_GRID}^2 (extended "
          f"{op11.grid_shape}, {op11.banded.pidx.shape[0]} bands of cap "
          f"{op11.banded.pidx.shape[1]}): fit ({SKI_ITERS} Adam iterations "
          f"+ final solve) {times11['fit_s'] * 1e3:.1f} ms, "
          f"{statistics.median(iter_ms11):.2f} ms per iteration (median, "
          f"host clock; the first {iter_ms11[0]:.1f} ms, the final solve "
          f"{times11['fit_s'] * 1e3 - hist11['elapsed_sec'][-1] * 1e3:.1f} "
          f"ms), PCG iters {hist11['cg_iters']}; mean at "
          f"{SKI_TARGETS} targets {times11['mean_s'] * 1e3:.1f} ms; variance "
          f"at {SKI_VAR_TARGETS} targets {times11['var_s'] * 1e3:.1f} ms "
          f"{card}; launches by stage (cumulative) {stages11}; routes "
          f"{picks11}; learned ls/os/noise "
          f"{torch.exp(fit11['model']['raw']).tolist()}, loss "
          f"{hist11['loss'][0]:.6f} -> {hist11['loss'][-1]:.6f}")
    # the mean launches W^T alpha; its W_* g is a gather, as gpquad's
    prev = {k: 0 for k in KERNELS_INTERP}
    for stage in ("fit", "mean", "var"):
        for k in KERNELS_INTERP:
            if stage == "mean" and k == "interp_2d":
                check(stages11[stage][k] == prev[k],
                      f"the ski mean launched {k}")
            else:
                check(stages11[stage][k] > prev[k],
                      f"kernel {k} was not launched in the ski {stage}")
        prev = stages11[stage]
    check(picks11["banded"] == 0 and picks11["unbanded"] == 0,
          f"the ski path took a plain route {picks11}")
    check(all(v == 0 for v in nufft11.values()),
          f"the ski path launched NUFFT kernels {nufft11}")
    check(mean11.shape == (SKI_TARGETS,) and var11.shape ==
          (SKI_VAR_TARGETS,) and bool(torch.isfinite(mean11).all())
          and bool(torch.isfinite(var11).all())
          and mean11.dtype == torch.float32,
          "ski mean or variance: wrong shape, type or non-finite")
    check(hist11["loss"][-1] < hist11["loss"][0],
          f"the ski fit did not lower its loss {hist11['loss']}")

    # one Adam iteration's loss and gradient at the learned hypers, profiled
    template11 = gpquad_torch.make_kernel("SE", 2)
    y11 = fit11["train_y"]
    pos11 = torch.exp(fit11["model"]["raw"])
    Z11, zq11 = ski_mod._draw_probes(
        torch.Generator(device=dev).manual_seed(3), 0, 2, 8, SKI_N,
        torch.float32, dev)
    prof11 = profile_run(lambda: ski_mod._ski_loss_and_grad(
        op11, y11, template11.with_hypers(pos11), pos11[-1], Z11, zq11,
        cg_tol=1e-3, max_cg_iter=100, slq_steps=10))
    print_profile("[11] profiled loss and gradient (one Adam iteration):",
                  prof11, card)
    # one operator apply W K_g W^T v + sigma^2 v, the unit of every PCG
    # iteration, for the final solve's single vector and the loop's three
    T11 = fit11["model"]["toeplitz"]
    matvec_ms = {}
    for B_ in (1, 3):
        v_ = y11 if B_ == 1 else y11.expand(B_, -1).contiguous()
        matvec_ms[B_] = (
            host_ms(lambda: op11.matvec(v_, pos11[-1], T11), reps=20),
            time_cuda(lambda: op11.matvec(v_, pos11[-1], T11), 20))
    print(f"[11] one SKI matvec, host clock / CUDA events (ms): B=1 "
          f"{matvec_ms[1][0]:.3f} / {matvec_ms[1][1]:.3f}, B=3 "
          f"{matvec_ms[3][0]:.3f} / {matvec_ms[3][1]:.3f} {card}")
    # the mean's W_* g as gpquad's gather, against a band plan made for the
    # targets on the host (stencils to the host, a stable argsort, tables
    # back) so that it runs on interp_2d
    def mean_target_plan():
        a_ = fit11["model"]["alpha"]
        g_ = T11(op11.interp_T(a_)).real.to(a_.dtype)
        i0_, w1d_, idx_, wv_ = ski_mod._stencils(xq11_t, op11.lo, op11.dx,
                                                 op11.grid_shape)
        return ski_mod.SKIOperator(
            idx=idx_, wvals=wv_, toeplitz=None, grid_shape=op11.grid_shape,
            lo=op11.lo, dx=op11.dx, banded=ski_mod._banded_plan(
                i0_, w1d_, op11.grid_shape, SKI_TARGETS, dev)).interp(g_)
    err_tp = float((mean_target_plan() - mean11).abs().max())
    mean_ms = {"gather": host_ms(
        lambda: ski_mod.ski_predict_mean(fit11, xq11_t), reps=20),
        "target band plan": host_ms(mean_target_plan, reps=20)}
    print(f"[11] mean at {SKI_TARGETS} targets, host clock (ms): W_* g by "
          f"gpquad's gather {mean_ms['gather']:.3f}, by a band plan for the "
          f"targets on interp_2d {mean_ms['target band plan']:.3f} (max "
          f"difference {err_tp:.3e}) {card}")
    check(err_tp <= 1e-5 * float(mean11.abs().max()),
          f"the target-plan mean differs by {err_tp:.3e}")

    # the loss and gradient at the starting hypers: float32 on the kernels
    # and on the plain path against float64 on the plain path, same probes,
    # all solved to 1e-6
    lo_hi = max(hi - lo for lo, hi in bounds11)
    start = np.array([0.2 * lo_hi, np.var(ys11),
                      max(0.1 * np.var(ys11), 1e-4)])
    prng = np.random.default_rng(12)
    Zs = prng.choice([-1.0, 1.0], size=(2, SKI_N))
    zqs = prng.choice([-1.0, 1.0], size=(8, SKI_N))
    op11_64 = ski_mod.build_ski_operator(
        torch.as_tensor(xs11, dtype=torch.float64, device=dev), ski_kern,
        (SKI_GRID, SKI_GRID), bounds11)
    lg = {}
    for tag, dtype, op_, impl in (
            ("f32", torch.float32, op11, "auto"),
            ("f32 plain", torch.float32, op11, "einsum"),
            ("f64 plain", torch.float64, op11_64, "einsum")):
        st_ = torch.as_tensor(start, dtype=dtype, device=dev)
        ski_mod.set_interp_impl(impl)
        try:
            reset_counts(*ski_counters)
            t = time.perf_counter()
            out_ = ski_mod._ski_loss_and_grad(
                op_, torch.as_tensor(ys11, dtype=dtype, device=dev),
                template11.with_hypers(st_), st_[-1],
                torch.as_tensor(Zs, dtype=dtype, device=dev),
                torch.as_tensor(zqs, dtype=dtype, device=dev), cg_tol=1e-6,
                max_cg_iter=1000, slq_steps=10)
            sync()
            lg[tag] = (out_, time.perf_counter() - t,
                       dict(ski_mod.INTERP_PICKS))
        finally:
            ski_mod.set_interp_impl("auto")
    (l32, g32, it32, _), lg32_s, picks32 = lg["f32"]
    (l32p, g32p, it32p, _), lg32p_s, picks32p = lg["f32 plain"]
    (l64, g64, it64, _), lg64_s, picks64 = lg["f64 plain"]
    loss_rel = abs(float(l32) - float(l64)) / abs(float(l64))
    g_rel = rel_to(g32, g64)
    g_rel_plain = rel_to(g32p, g64)
    g_bars = [1e-2] * (len(g_rel) - 1) + [2e-2]
    # the outputscale component is 0.5 (tr(A^-1 dK) - alpha' dK alpha) / n
    # with dK = K / variance and A = K + sigma^2 I, so A^-1 K = I -
    # sigma^2 A^-1: its trace term is 0.5 / variance (z'z = n for the
    # probes) less a noise term of the same size, and the component is what
    # is left of their cancellation.  Its error is read against that term
    # too: where the term is over 10x the component the bar is 1e-4 of the
    # term, the f32 solves' level (the loss agrees to ~4e-6).  Where the
    # error comes from: the same component in float32 on the plain path,
    # and the gradient in float64 with its solves taken to 1e-9, against
    # which the runs at 1e-6 are read
    term_var = 0.5 / start[1]
    err_var_g = abs(float(g32[1]) - float(g64[1]))
    err_var_plain = abs(float(g32p[1]) - float(g64[1]))
    cancel_var = term_var / abs(float(g64[1]))
    var_ok = (g_rel[1] <= g_bars[1] or
              (cancel_var > 10 and err_var_g <= 1e-4 * term_var))
    reset_counts(*ski_counters)
    st64 = torch.as_tensor(start, device=dev)
    _, g_tight, it_tight, _ = ski_mod._ski_loss_and_grad(
        op11_64, torch.as_tensor(ys11, device=dev),
        template11.with_hypers(st64), st64[-1],
        torch.as_tensor(Zs, device=dev), torch.as_tensor(zqs, device=dev),
        cg_tol=1e-9, max_cg_iter=3000, slq_steps=10)
    tight_err = {"f32 cg_tol 1e-6": rel_to(g32, g_tight),
                 "f32 plain cg_tol 1e-6": rel_to(g32p, g_tight),
                 "f64 cg_tol 1e-6": rel_to(g64, g_tight)}
    print(f"[11] loss and gradient at the start {start.tolist()} (cg_tol "
          f"1e-6): f32 on the kernels {lg32_s * 1e3:.1f} ms, {int(it32)} "
          f"PCG iterations, routes {picks32}; f32 on the plain path "
          f"{lg32p_s * 1e3:.1f} ms, {int(it32p)} iterations; f64 on the "
          f"plain path {lg64_s * 1e3:.1f} ms, {int(it64)} iterations, routes "
          f"{picks64}; loss f32 {float(l32):.8f} f32 plain "
          f"{float(l32p):.8f} f64 {float(l64):.8f} rel err {loss_rel:.3e} "
          f"(bar 1e-4); grad f32 {g32.tolist()} f32 plain {g32p.tolist()} "
          f"f64 {g64.tolist()} rel err {[f'{r:.3e}' for r in g_rel]} (bars "
          f"{g_bars}; the f32 plain path "
          f"{[f'{r:.3e}' for r in g_rel_plain]}) {card}")
    print(f"[11] outputscale component: trace term 0.5/variance "
          f"{term_var:.6e}, {cancel_var:.1f}x the component; its f32 error "
          f"{err_var_g:.3e} = {err_var_g / term_var:.3e} of the term (bar "
          f"1e-4 where the term is over 10x the component; the f32 plain "
          f"path {err_var_plain:.3e} = {err_var_plain / term_var:.3e}); "
          f"against float64 solved to 1e-9 ({int(it_tight)} PCG iterations, "
          f"grad {g_tight.tolist()}): "
          + "; ".join(f"{k} [{', '.join(f'{r:.3e}' for r in v)}]"
                      for k, v in tight_err.items()))
    check(picks32["banded"] == picks32["unbanded"] == 0 and
          picks32p["cuda"] == 0 and picks64["cuda"] == 0,
          "the loss comparison took the wrong routes")
    check(loss_rel <= 1e-4, f"ski loss f32 vs f64 {loss_rel:.3e} > 1e-4")
    check(g_rel[0] <= g_bars[0] and g_rel[2] <= g_bars[2] and var_ok,
          f"ski gradient f32 vs f64 {g_rel} over {g_bars} (outputscale: "
          f"{err_var_g:.3e} of a term {term_var:.3e})")

    # the mean and the variance at the learned hypers, f32 against f64 (on
    # the f64 kernels), alpha solved to 1e-6 in both
    def tight_fit(dtype, op_):
        raw_ = fit11["model"]["raw"].to(dtype)
        pos_ = torch.exp(raw_)
        kern_ = template11.with_hypers(pos_)
        T_ = make_toeplitz(ski_mod._grid_lag_table(
            kern_, op_.grid_shape, op_.dx).to(
                torch.complex64 if dtype == torch.float32
                else torch.complex128))
        sol = pcg(lambda v_: op_.matvec(v_, pos_[-1], T_),
                  torch.as_tensor(ys11, dtype=dtype, device=dev), tol=1e-6,
                  maxiter=1000)
        return {"model": {"kernel": kern_, "raw": raw_, "alpha": sol.x,
                          "operator": op_, "toeplitz": T_}}, int(sol.iters)

    mv = {}
    for dtype, op_ in ((torch.float32, op11), (torch.float64, op11_64)):
        f_, iters_ = tight_fit(dtype, op_)
        xq_ = xq11_t.to(dtype)
        t = time.perf_counter()
        mv[dtype] = (ski_mod.ski_predict_mean(f_, xq_),
                     ski_mod.ski_predict_var(
                         f_, xq_[:SKI_VAR_TARGETS],
                         batch_size=SKI_VAR_TARGETS, cg_tol=1e-6,
                         max_cg_iter=1000), iters_)
        sync()
        mv[dtype] += (time.perf_counter() - t,)
    m32, v32, a32, mv32_s = mv[torch.float32]
    m64, v64, a64, mv64_s = mv[torch.float64]
    err_m11 = float((m32.double() - m64).abs().max())
    # the f32 floor of this system (n = 2e5 points, noise 0.02: condition
    # ~n k(0) / sigma^2 ~ 1e7) without the kernels, a witness: the same
    # mean in float32 on the plain path
    var_kw = dict(batch_size=SKI_VAR_TARGETS, cg_tol=1e-6, max_cg_iter=1000)
    ski_mod.set_interp_impl("einsum")
    try:
        f_p, a32p = tight_fit(torch.float32, op11)
        m32p = ski_mod.ski_predict_mean(f_p, xq11_t)
    finally:
        ski_mod.set_interp_impl("auto")
    # the variance's witness on the scatter/gather plain path (the plan
    # dropped: one index_add_ and one gather a matvec; the plain banded
    # W^T u takes ~0.13 s a call at B 64), from the same alpha
    f_p["model"]["operator"] = dataclasses.replace(op11, banded=None)
    v32p = ski_mod.ski_predict_var(f_p, xq11_t[:SKI_VAR_TARGETS], **var_kw)
    err_m11_plain = float((m32p.double() - m64).abs().max())
    err_v11_plain = float((v32p.double() - v64).abs().max())
    # the control the bar must fail: every interpolation weight (the band
    # tables, the stencils, the targets') rounded to bfloat16, on the kernels
    def bf16(w):
        return w.to(torch.bfloat16).to(w.dtype)
    op_c = dataclasses.replace(op11, wvals=bf16(op11.wvals),
                               banded=op11.banded._replace(
                                   w_row=bf16(op11.banded.w_row),
                                   w_col=bf16(op11.banded.w_col)))
    f_c, a32c = tight_fit(torch.float32, op_c)
    idx_c, wv_c = ski_mod._point_stencils(op_c, xq11_t, torch.float32)
    g_c = f_c["model"]["toeplitz"](op_c.interp_T(
        f_c["model"]["alpha"])).real.float()
    m32c = torch.sum(g_c[idx_c] * bf16(wv_c), dim=-1)
    err_m11_ctl = float((m32c.double() - m64).abs().max())
    v32c = ski_mod.ski_predict_var(f_c, xq11_t[:SKI_VAR_TARGETS], **var_kw)
    err_v11_ctl = float((v32c.double() - v64).abs().max())
    del f_p, m32p, op_c, f_c, g_c, m32c, v32p, v32c
    err_v11 = float((v32.double() - v64).abs().max())
    v11_scale = float(v64.abs().max())
    print(f"[11] mean and variance at the learned hypers vs float64 (alpha "
          f"to 1e-6: {a32} / {a64} PCG iterations; the f32 plain path "
          f"{a32p}, the bfloat16-weight control {a32c}): max|mean err| "
          f"{err_m11:.3e} (bar {SKI_MEAN_BAR:.0e}; the f32 plain path "
          f"{err_m11_plain:.3e}; the control {err_m11_ctl:.3e}), max|var "
          f"err| {err_v11:.3e} (bar 5e-2*max|var64| = "
          f"{5e-2 * v11_scale:.3e}; the f32 scatter/gather plain path "
          f"{err_v11_plain:.3e}; "
          f"the bfloat16-weight control {err_v11_ctl:.3e}); mean + variance "
          f"f32 "
          f"{mv32_s * 1e3:.1f} ms, f64 {mv64_s * 1e3:.1f} ms {card}")
    check(err_m11 <= SKI_MEAN_BAR,
          f"ski mean error {err_m11:.3e} > {SKI_MEAN_BAR:.0e}")
    check(err_m11_ctl > SKI_MEAN_BAR,
          f"the bfloat16-weight control's mean error {err_m11_ctl:.3e} "
          f"passes the bar {SKI_MEAN_BAR:.0e}")
    check(err_v11 <= 5e-2 * v11_scale,
          f"ski variance error {err_v11:.3e} > 5e-2 * max|var64|")
    record["phases"]["ski"] = dict(
        n=SKI_N, grid=SKI_GRID, plan=plans["ski"], times_s=times11,
        iter_ms=iter_ms11, cg_iters=hist11["cg_iters"], loss=hist11["loss"],
        stages=stages11, launches=launches11, routes=picks11,
        profile_iteration=prof11, matvec_ms=matvec_ms, learned=torch.exp(
            fit11["model"]["raw"]).tolist(),
        loss_grad=dict(start=start.tolist(), loss_f32=float(l32),
                       loss_f64=float(l64), loss_rel_err=loss_rel,
                       grad_f32=g32.tolist(), grad_f64=g64.tolist(),
                       grad_rel_err=g_rel, outputscale_term=term_var,
                       outputscale_err_vs_term=err_var_g / term_var,
                       grad_f32_plain=g32p.tolist(),
                       grad_rel_err_f32_plain=g_rel_plain,
                       outputscale_err_vs_term_f32_plain=(err_var_plain
                                                          / term_var),
                       grad_tight_f64=g_tight.tolist(),
                       rel_err_vs_tight=tight_err,
                       iters_f32=int(it32), iters_f32_plain=int(it32p),
                       iters_f64=int(it64), ms_f32=lg32_s * 1e3,
                       ms_f32_plain=lg32p_s * 1e3,
                       ms_f64_plain=lg64_s * 1e3),
        mean_ms=mean_ms, mean_target_plan_diff=err_tp,
        err_mean=err_m11, err_mean_f32_plain=err_m11_plain,
        err_mean_bf16_control=err_m11_ctl, mean_bar=SKI_MEAN_BAR,
        err_var=err_v11, err_var_f32_plain=err_v11_plain,
        err_var_bf16_control=err_v11_ctl, max_abs_var64=v11_scale,
        alpha_iters=(a32, a64), ms_per_adam_iteration=statistics.median(
            iter_ms11))
    del fit11, op11_64, mv, lg, Z11, zq11
    torch.cuda.empty_cache()
    phase_s["11"] = time.perf_counter() - t_phase
    print(f"[11] phase wall time {phase_s['11']:.1f} s")

    # -- phase 11b: examples/temperature_map.py on the port ----------------
    t_phase = time.perf_counter()
    xr, yr = raster["x_train"], raster["y_train"]
    xv, yv = raster["x_val"], raster["y_val"]
    xv_t = torch.as_tensor(xv, dtype=torch.float32, device=dev)
    t = time.perf_counter()
    m11b = gpquad_torch.EFGP(torch.as_tensor(xr, dtype=torch.float32,
                                             device=dev),
                             torch.as_tensor(yr, dtype=torch.float32,
                                             device=dev),
                             "SE", eps=1e-4, opts={"cg_tolerance": 1e-6},
                             device=dev)
    m11b.optimize_hyperparameters(max_iters=15, lr=0.1, trace_samples=10)
    val_mean, _ = m11b.predict(xv_t, return_variance=False)
    sync()
    efgp_s = time.perf_counter() - t
    efgp_rmse = float(np.sqrt(np.mean((val_mean.double().cpu().numpy()
                                       - yv) ** 2)))
    reset_counts(*ski_counters)
    t = time.perf_counter()
    ski_r = ski_mod.fit_ski_gp(xr, yr, kernel="SE", target_grid_points=4096,
                               max_iters=15, lr=0.1, verbose=False,
                               device=dev)
    ski_val = ski_mod.ski_predict_mean(ski_r, xv_t)
    sync()
    ski_s = time.perf_counter() - t
    launches_r = dict(cuda_interp.LAUNCHES)
    picks_r = dict(ski_mod.INTERP_PICKS)
    ski_rmse = float(np.sqrt(np.mean((ski_val.double().cpu().numpy()
                                      - yv) ** 2)))
    print(f"[11b] raster (n={len(yr)}, {len(yv)} held out): EFGP val RMSE "
          f"{efgp_rmse:.4f} (hypers "
          f"{[round(float(h), 4) for h in torch.exp(m11b.params.raw)]}, "
          f"{efgp_s * 1e3:.1f} ms for 15 Adam iterations + predict), SKI val "
          f"RMSE {ski_rmse:.4f} (grid {ski_r['grid_size']}, "
          f"{ski_s * 1e3:.1f} ms for 15 iterations + mean); std(y_val) "
          f"{float(np.std(yv)):.4f}; SKI launches {launches_r} routes "
          f"{picks_r} {card}")
    check(efgp_rmse < 0.5 * float(np.std(yv)),
          f"EFGP val RMSE {efgp_rmse:.4f} >= 0.5 std(y_val)")
    check(efgp_rmse < 1.15 * ski_rmse,
          f"EFGP val RMSE {efgp_rmse:.4f} >= 1.15 * SKI's {ski_rmse:.4f}")
    for k in KERNELS_INTERP:
        check(launches_r[k] > 0, f"kernel {k} was not launched on the raster")
    check(picks_r["banded"] == 0 and picks_r["unbanded"] == 0,
          f"the raster's SKI took a plain route {picks_r}")
    record["phases"]["raster"] = dict(
        efgp_rmse=efgp_rmse, ski_rmse=ski_rmse, std_y_val=float(np.std(yv)),
        efgp_s=efgp_s, ski_s=ski_s, launches=launches_r, routes=picks_r,
        ski_grid=list(ski_r["grid_size"]), plan=plans["raster"])
    phase_s["11b"] = time.perf_counter() - t_phase
    print(f"[11b] phase wall time {phase_s['11b']:.1f} s")

    # -- phase 12: the exact variances and the high-precision tier ---------
    t_phase = time.perf_counter()
    from gpquad_torch.utils import f64_oracles
    record["phases"]["high"] = high = phase_high(types.SimpleNamespace(
        gt=gpquad_torch, orc=f64_oracles, nufft_mod=nufft_mod,
        cuda_nufft=cuda_nufft, efgp_mod=efgp_mod, dev=dev, card=card,
        counters=counters + (cuda_nufft.LAUNCH_PRECISIONS,),
        sigmasq=sigmasq, eps=eps, phase3=phase3, kernels=kernels,
        plains=plains, x32=x32, y32=y32, xq32=xq32, kernel32=kernel32,
        h_head=h_head, mtot_head=mtot_head, st=st, x2=x2, y2=y2, xq2=xq2,
        kern_hard=kern_hard, h_hard=h_hard, mtot_hard=mtot_hard, n10=n10,
        kern10=kern10, h10=h10, mtot10=mtot10, xh3=xh3, yh3=yh3, xqh3=xqh3,
        kern_h3=kern_h3, h_h3=h_h3, mtot_h3=mtot_h3))
    phase_s["12"] = time.perf_counter() - t_phase
    print(f"[12] phase wall time {phase_s['12']:.1f} s")

    # -- phase 13: the Polya-Gamma estimators --------------------------------
    t_phase = time.perf_counter()
    record["phases"]["pg"] = pg = phase_pg(types.SimpleNamespace(
        gt=gpquad_torch, cuda_nufft=cuda_nufft, nufft_mod=nufft_mod,
        dev=dev, card=card, counters=counters + (cuda_nufft.LAUNCH_PRECISIONS,),
        kernels=kernels, plains=plains))
    phase_s["13"] = time.perf_counter() - t_phase
    print(f"[13] phase wall time {phase_s['13']:.1f} s")

    # -- phase 14: the spreading NUFFT backends and the samplers ------------
    t_phase = time.perf_counter()
    record["phases"]["spread"] = phase_spread(types.SimpleNamespace(
        gt=gpquad_torch, nufft_mod=nufft_mod, cuda_nufft=cuda_nufft,
        dev=dev, card=card, counters=counters, sigmasq=sigmasq, n10=n10,
        kern10=kern10, h10=h10, mtot10=mtot10, seeded=seeded,
        scale_rec=record["phases"]["scale"], mean10_64=mean10_64,
        grad10=gr10.grad, n_d3=100_000, h_d3=h_d3, mtot_d3=mtot_d3, st=st,
        x32=x32, y32=y32, xq32=xq32, kernels=kernels, plains=plains))
    phase_s["14"] = time.perf_counter() - t_phase
    print(f"[14] phase wall time {phase_s['14']:.1f} s (14a "
          f"{record['phases']['spread']['14a_s']:.1f} s, 14b "
          f"{record['phases']['spread']['14b_s']:.1f} s, 14c "
          f"{record['phases']['spread']['14c_s']:.1f} s); the script so far "
          f"{time.perf_counter() - t_run:.1f} s")

    # -- phase 15: the utilities ---------------------------------------------
    t_phase = time.perf_counter()
    record["phases"]["utils"] = utils15 = phase_utils(types.SimpleNamespace(
        gt=gpquad_torch, cuda_nufft=cuda_nufft, dev=dev, card=card,
        kernels=kernels, plains=plains, x32=x32, y32=y32, xq32=xq32,
        kernel32=kernel32, sigmasq=sigmasq, eps=eps, h_head=h_head,
        fused=lambda: fused(x32, y32, xq32, "auto"), fused_ms=fused_ms,
        cg_kron=lambda: run_cg(x2, y2, xq2, kern_hard, "auto",
                               precond="kron"),
        lc_iteration=lambda: lc_model(x8, y8).optimize_hyperparameters(
            **dict(LC_OPT, max_iters=1)),
        lc_iter_ms=statistics.median(iter_ms), m9=m9))
    phase_s["15"] = time.perf_counter() - t_phase
    print(f"[15] phase wall time {phase_s['15']:.1f} s (15a "
          f"{utils15['15a_s']:.1f} s, 15b {utils15['15b_s']:.1f} s, 15c "
          f"{utils15['15c_s']:.1f} s, 15d {utils15['15d_s']:.1f} s); the "
          f"script so far {time.perf_counter() - t_run:.1f} s")

    # -- the record ----------------------------------------------------------
    # each kernel's row: its largest float32 call on a driven path (the
    # headline's for d=2, the light curve's for d=1, the d=3 paths' by work
    # B n mtot^d); launches from the main path's run of each (the fused call
    # at the headline, the light-curve facade, the fused call at d3)
    row_shape = {"nufft1_2d": (m_lag, False), "nufft2_2d": (m_lag, True),
                 "nufft1_2d_batched": (mtot_head, False),
                 "nufft2_2d_batched": (mtot_head, False)}
    rows = []

    def high_launches(names, above=0):
        """Phase 12's launches of the kernels ``names`` past mtot ``above``,
        by precision."""
        out = {"f32": 0, "f64": 0}
        for key, v in high["launches"].items():
            k, rest = key.split("/")
            p, m = rest.split("@")
            if k in names and int(m) > above:
                out[p] += v
        return out
    # the d=3 functions' two kernels each (phase 3's tc_3d_both)
    TC3_KEYS = ("dispatch", "tc_ms", "cuda_core_ms", "tc_rel_err",
                "cuda_core_rel_err", "bound_fp32_ms", "bound_3xtf32_ms")

    def single_at_scale(f32_rows, keys):
        """The single type-2's paths at the scale configuration's calls, by
        what each serves."""
        return {r["serves"]: {k: r[k] for k in keys + ("n", "mtot",
                                                       "bound_ms",
                                                       "bound_by")}
                for r in f32_rows if r["serves"].startswith("scale")}

    for name in KERNELS_NUFFT:
        f32_rows = [r for r in phase3 if r["name"] == name
                    and r["dtype"] == "float32"]
        if name in KERNELS_1D:
            row = max((r for r in f32_rows
                       if r["serves"].startswith("light curve")),
                      key=lambda r: r["B"] * r["n"] * r["mtot"])
            extra = {"launches": launches_lc[name],
                     "launches_headline_facade": launches9[name]}
            if name in KERNELS_1D:
                # both kernels' card times on the same inputs, the 3xTF32
                # bound (bound_ms) beside the fp32 one, at every light-curve
                # call (the type-2 also its padding)
                keys = ("dispatch", "tc_ms", "cuda_core_ms", "tc_rel_err",
                        "cuda_core_rel_err", "bound_fp32_ms")
                if name == "nufft2_1d":
                    keys += ("padding", "bound_3xtf32_ms")
                extra.update({k: row[k] for k in keys})
                extra["at_calls"] = {
                    r["serves"]: {k: r[k] for k in keys + (
                        "B", "n", "mtot", "ms", "bound_ms", "bound_by")}
                    for r in f32_rows if r["serves"].startswith("light")
                    or r["serves"] == "mtot 8191"}
        elif name in row_shape:
            m, fo = row_shape[name]
            row = next(r for r in f32_rows if r["mtot"] == m and
                       r["fft_order"] == fo and r["n"] in (10_000, 100_000))
            extra = {"launches": fused_launches[name],
                     "launches_slice": launches[name],
                     "launches_cg_tier": launches_cg[name]
                     + launches_gcg[name],
                     "launches_headline_facade": launches9[name],
                     "launches_scale_fit_mean": launches10[name],
                     "launches_high_tier": high_launches((name,)),
                     "launches_pg": pg["13a"]["launches"][name]}
            if name == "nufft2_2d":
                # its paths here and at the scale configuration's mean,
                # variance evaluation and gradient, and the scale
                # configuration's launches past its fit and mean
                keys = ("dispatch", "fastest", "tc_ms", "split_ms",
                        "cuda_ms", "tc_rel_err", "split_rel_err",
                        "cuda_rel_err")
                extra.update({k: row[k] for k in keys})
                extra["launches_scale_variance"] = launches_var10[name]
                extra["launches_scale_gradient"] = launches_grad10[name]
                extra["launches_scale_adam_loop"] = launches_loop10[name]
                extra["at_scale"] = single_at_scale(f32_rows, keys)
            if name == "nufft2_2d_batched":
                # its two routes here and at the scale configuration's
                # probe batches (B 10 and 5)
                # (the kernels line carries no bound but bound_ms; both
                # bounds stay in phase 3's rows)
                keys = ("dispatch", "tc_ms", "cuda_core_ms", "tc_rel_err",
                        "cuda_core_rel_err")
                extra.update({k: row[k] for k in keys})
                extra["launches_scale_gradient"] = launches_grad10[name]
                extra["launches_scale_adam_loop"] = launches_loop10[name]
                extra["at_scale"] = {
                    f"B{r['B']}": {k: r[k]
                                   for k in keys + ("bound_ms", "bound_by")}
                    for r in f32_rows if r["n"] == n10}
        else:
            row = max((r for r in f32_rows
                       if r["serves"].startswith(("d3", "hard3d"))),
                      key=lambda r: r["B"] * r["n"] * r["mtot"] ** 3)
            extra = {"launches": launches_d3[name],
                     "launches_hard3d": launches_h3[name]
                     + launches_var4[name] + launches_g4[name],
                     "launches_high_tier": high_launches((name,))}
            if name in KERNELS_3D:
                # both kernels' card times on the same inputs, the 3xTF32
                # bound (bound_ms where the tensor cores are picked) beside
                # the fp32 one, at every call phase 3 makes
                extra.update({k: row[k] for k in TC3_KEYS})
                extra["at_calls"] = {
                    f"{r['serves']} (B {r['B']}, mtot {r['mtot']})": {
                        k: r[k] for k in TC3_KEYS + (
                            "B", "n", "mtot", "ms", "bound_ms", "bound_by")}
                    for r in f32_rows}
        rows.append({"name": name, "route": "cuda", "source": source_of(name),
                     "replaces": REPLACES[name], **extra,
                     "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                     "plain_ms": row["plain_ms"],
                     "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"], "library_ms": None,
                     "shape": {"B": row["B"], "n": row["n"],
                               "mtot": row["mtot"],
                               "fft_order": row["fft_order"],
                               "serves": row["serves"],
                               "dtype": "float32"}})
    # the TPU's mode-tiled functions, each covered by the kernel above: its
    # float32 call past the single-block limit on the path that drives it
    # (scale fit + mean at d=2, the d3 fused call at d=3)
    tiled_row = {"_pallas_nufft2_2d_tiled": "scale mean",
                 "_pallas_nufft1_2d_tiled": "scale lag table",
                 "_pallas_nufft2_3d_tiled": "d3 variance evaluation",
                 "_pallas_nufft1_3d_tiled": "d3 lag table"}
    for tpu, (kernel, replaces, limit) in TILED.items():
        row = next(r for r in phase3 if r["name"] == kernel
                   and r["dtype"] == "float32"
                   and r["serves"] == tiled_row[tpu])
        launched = tiled10 if "_2d" in kernel else tiled_d3
        extra = {}
        if "_2d" in kernel:
            extra = {"launches_scale_variance": tiled_var10[tpu],
                     "launches_scale_gradient":
                         tiled_counts(widths_grad10)[tpu],
                     "launches_scale_adam_loop":
                         tiled_counts(widths_loop10)[tpu],
                     "launches_high_tier": high_launches(
                         (kernel, kernel + "_batched"), limit)}
        if kernel in KERNELS_3D:
            extra.update({k: row[k] for k in TC3_KEYS})
        if kernel == "nufft2_2d":
            keys = ("dispatch", "fastest", "tc_ms", "split_ms", "cuda_ms")
            extra.update({k: row[k] for k in keys})
            extra["at_scale"] = single_at_scale(
                [r for r in phase3 if r["name"] == kernel
                 and r["dtype"] == "float32"], keys)
        rows.append({"name": f"{kernel} (mtot > {limit}, for {tpu})",
                     "route": "cuda", "source": source_of(kernel),
                     "replaces": replaces, "launches": launched[tpu], **extra,
                     "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                     "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"], "library_ms": None,
                     "shape": {"B": row["B"], "n": row["n"],
                               "mtot": row["mtot"],
                               "fft_order": row["fft_order"],
                               "serves": row["serves"], "dtype": "float32"}})
    # the interpolation kernels: the float32 call of phase 11's PCG (y and
    # two trace probes, B 3); launches from phase 11's fit, mean and variance
    for name in KERNELS_INTERP:
        row = next(r for r in phase3 if r["name"] == name and r["serves"] ==
                   "ski" and r["dtype"] == "float32" and r["B"] == 3)
        if name == "interp_2d":
            # the whole SKIOperator.interp (one launch) beside the library
            # call, with the host's enqueue and on the card, at every batch
            extra = {"interp_ms": row["interp_ms"],
                     "card_ms": {k: row[f"{k}_card_ms"]
                                 for k in ("kernel", "interp", "library")},
                     "at_batches": {
                         f"{r['serves']} B{r['B']}": {
                             k: r[k] for k in (
                                 "ms", "interp_ms", "library_ms",
                                 "kernel_card_ms", "interp_card_ms",
                                 "library_card_ms", "bound_ms")}
                         for r in phase3 if r["name"] == name
                         and r["dtype"] == "float32"}}
        else:
            extra = {}
        rows.append({"name": name, "route": "cuda", "source": source_of(name),
                     "replaces": REPLACES[name], **extra,
                     "launches": launches11[name],
                     "launches_by_stage_cumulative": {
                         stage: counts_[name]
                         for stage, counts_ in stages11.items()},
                     "launches_raster": launches_r[name],
                     "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                     "plain_ms": row["plain_ms"],
                     "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                     "library_ms": row["library_ms"],
                     "shape": {"B": 3, "nbands": row["nbands"],
                               "cap": row["cap"], "G2": row["G2"],
                               "serves": "ski PCG (y + 2 probes)",
                               "dtype": "float32"}})
    record["kernels"] = rows
    phase_s["total"] = time.perf_counter() - t_run
    record["phase_wall_s"] = phase_s
    print(f"phase wall times (s): "
          + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
