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
     the output; under 256 MB);
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
     points, 15 iterations) in float32, with the example's assertions.
Phase 3 also holds the two d=3 kernels at every shape of phases 6 and 7
and at mtot 57, 101 and 255, the two d=1 kernels at phase 8's shapes and
at mtot 8191, and the two SKI interpolation kernels at phase 11's band
tables (B 1, 3, 8 and 64) and the raster's (B 1, 3 and 8), with the
column-sorted index's bytes; interp_T_2d also bit for bit against a
second launch and its plain twin's walk.  Phase 10 prints its ms per Adam
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
import statistics
import subprocess
import sys
import time
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
# the float32 d=2 type-1 on the tensor cores: three TF32 products (the
# 3xTF32 split) per real product, 8 flops per point, output and vector each
TC_TYPE1 = ("nufft1_2d", "nufft1_2d_batched")
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


def time_cuda(fn, reps, trials=5):
    """Median over ``trials`` of the CUDA-event time of ``reps`` calls (ms
    per call), after two warm calls."""
    fn()
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


def profile_run(fn, top=8):
    """Run ``fn`` once under torch.profiler: host wall time, device busy
    time (union of the CUDA events' intervals), idle share, and the
    kernels with the most device time.  Device numbers are None when the
    profiler saw no CUDA event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
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


def interp_work(name, nbands, cap, G2, dtype, B, listed=None):
    """(flops, bytes) of an interpolation kernel on a band plan, at
    INTERP_FLOPS a slot and vector; bytes of the tables (two int32 and
    eight weights a slot), the B inputs read once (W v: the padded grid
    under the slab view) and the B outputs written once.  W v works on every
    slot (padded ones included: they are in its output); W^T u needs only
    the ``listed`` slots of the column index (the valid ones), their values
    and the index itself (a slot number each, G2 + 1 column starts a
    band)."""
    s = 4 if dtype == torch.float32 else 8
    rows = nbands * 8 + 3
    if name == "interp_T_2d":
        tables = listed * (3 * 4 + 8 * s) + nbands * (G2 + 1) * 4
        io = B * listed * s + nbands * B * 11 * G2 * s
        return INTERP_FLOPS[name] * B * listed, tables + io
    tables = nbands * cap * (2 * 4 + 8 * s)
    io = B * rows * G2 * s + nbands * B * cap * s
    return INTERP_FLOPS[name] * B * nbands * cap, tables + io


def bound_ms(name, n, m, dtype, B=1, work=None):
    flops, nbytes = work or kernel_work(name, n, m, dtype, B)
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bound_3xtf32_ms(name, n, m, B=1):
    """The float32 d=2 type-1's bound on the tensor cores: 3 x 8 flops per
    point, output and vector at the dense TF32 rate, plus the rest of
    kernel_work's operations (the phases, once per point, dimension and
    mode, and the products v e1) at the fp32 rate; against its bytes."""
    flops, nbytes = kernel_work(name, n, m, torch.float32, B)
    tc = 3 * 8 * B * n * m * m
    t_ops = (tc / PEAK_TF32 + (flops - 8 * B * n * m * m)
             / PEAK_FLOPS[torch.float32]) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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
                row["bound_ms"], row["bound_by"] = bound_3xtf32_ms(name, n, m,
                                                                   B)
                geo = cuda_nufft.type1_2d_geometry(n, m, B, batched)
                groups = -(-n // geo[-1])
                row["scratch_bytes"] = scratch
                check(scratch < 256e6,
                      f"{name} B={B} n={n} mtot={m}: scratch {scratch} bytes "
                      f">= 256 MB")
                row["tile"] = f"{geo[0]}x{geo[1]}"
                row["split_bar"] = split_bar
                extra = (f" tile {row['tile']}, scratch {groups} groups "
                         f"{scratch / 1e6:.3f} MB (measured; partials "
                         f"{groups * B * m * m * 8 / 1e6:.3f} MB), "
                         f"bound_3xtf32_ms={row['bound_ms']:.4f}")
                b_ms, b_by = row["bound_fp32_ms"], "fp32 operations"
            if batched:
                single = kernels[name.replace("_batched", "")]
                row["singles_ms"] = time_cuda(
                    lambda: [single(x, a, hq, **kw) for a in arg], reps,
                    trials)
                extra += f" {B}x single ms={row['singles_ms']:.4f}"
            if name == "nufft1_3d":
                groups, _ = cuda_nufft.type1_3d_groups(n, m, B)
                row["scratch_bytes"] = scratch
                extra = (f" scratch {groups} groups {scratch / 1e6:.3f} MB "
                         f"(measured)")
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
                    "interp_2d": (
                        lambda: cuda_interp.interp_2d(vs, *tabs, bh=8),
                        lambda: cuda_interp.interp_2d_ref(vs, *tabs, bh=8),
                        lambda: cuda_interp.interp_2d_ref(
                            vs.double(), *tabs64, bh=8), lib_fwd)}
                for name, (kern_fn, plain_fn, ref_fn, lib_fn) in \
                        calls.items():
                    got = kern_fn()
                    sync()
                    ref = ref_fn()
                    if name == "interp_2d":     # the valid slots only
                        keep = t.valid[:, None, :].expand_as(ref)
                        got, ref = got[keep], ref[keep]
                    err = float((got.double() - ref).abs().max())
                    scale = float(ref.abs().max())
                    rel = err / scale
                    bar = 1e-5 if dtype == torch.float32 else 1e-12
                    check(np.isfinite(rel) and rel <= bar,
                          f"{name} {tag} {dtype} B={B}: error {rel:.3e} of "
                          f"max|ref| > {bar:.0e}")
                    if name == "interp_T_2d":
                        # the same sums in the same order: a second launch
                        # and the plain twin's column-sorted walk
                        check(torch.equal(kern_fn(), got) and torch.equal(
                            cuda_interp.interp_T_2d_sorted_ref(
                                us, *tabs, *idx, G2=G2, bh=8), got),
                            f"interp_T_2d {tag} {dtype} B={B}: not bit for "
                            "bit the same on a second launch and in its twin")
                    del got, ref
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
                        name, nb, cap, G2, dtype, B, listed))
                    row = dict(name=name, serves=tag, B=B, nbands=nb,
                               cap=cap, G2=G2,
                               dtype=str(dtype).split(".")[-1],
                               max_abs_err=err, max_abs_ref=scale,
                               rel_err=rel, ms=ms, plain_ms=plain_ms,
                               library_ms=library_ms, bound_ms=b_ms,
                               bound_by=b_by)
                    phase3.append(row)
                    extra = "" if plain_ms is None else (
                        f" plain_ms={plain_ms:.4f} library (unbanded path) "
                        f"ms={library_ms:.4f}")
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
    def grad_cg(x, y, s, method):
        return gpquad_torch.gradient_with_grid(
            x, y, kern_hard, sigmasq, s.h,
            torch.Generator(device=dev).manual_seed(0), mtot=s.mtot,
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
        grad_converged=converged, grad_rel_err=grad_rel_cg)

    phase_s["5"] = time.perf_counter() - t_phase
    print(f"[5] phase wall time {phase_s['5']:.1f} s")

    # -- phase 6: d3, the fused pass on 3-D data -----------------------------
    t_phase = time.perf_counter()
    x3 = torch.as_tensor(xd3, dtype=torch.float32, device=dev)
    y3 = torch.as_tensor(yd3, dtype=torch.float32, device=dev)
    xq3 = torch.as_tensor(xqd3, dtype=torch.float32, device=dev)

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
                  grad_rel_err=d3k_grad_rel),
        mean_cg_iters=int(out3.mean_cg_iters),
        mean_cg_iters_f64=int(out3_64.mean_cg_iters),
        trace_cg_iters=int(out3.trace_cg_iters),
        trace_cg_iters_f64=int(out3_64.trace_cg_iters),
        err_mean=d3_err_mean, err_var=d3_err_var,
        max_abs_var64=d3_var_scale, grad_rel_err=d3_grad_rel,
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
        grad_rel_err=g4_rel, grad_rel_err_vs_tight_f64=g4_vs_tight)
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
    rng10 = np.random.default_rng(10)
    xs = rng10.uniform(0, 1, size=(n10, 2))
    ys = (np.sin(3 * np.pi * xs[:, 0]) * np.cos(2 * np.pi * xs[:, 1])
          + 0.5 * np.sin(7 * xs[:, 0] + 5 * xs[:, 1])
          + 0.1 * rng10.normal(size=n10))
    xq10 = torch.as_tensor(rng10.uniform(0, 1, size=(2000, 2)),
                           dtype=torch.float32, device=dev)
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
    t = time.perf_counter()
    v10 = var10()
    sync()
    stage["var_s"] = time.perf_counter() - t
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
    print(f"[10] launches: gradient {launches_grad10} (by width "
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

    # -- the record ----------------------------------------------------------
    # each kernel's row: its largest float32 call on a driven path (the
    # headline's for d=2, the light curve's for d=1, the d=3 paths' by work
    # B n mtot^d); launches from the main path's run of each (the fused call
    # at the headline, the light-curve facade, the fused call at d3)
    row_shape = {"nufft1_2d": (m_lag, False), "nufft2_2d": (m_lag, True),
                 "nufft1_2d_batched": (mtot_head, False),
                 "nufft2_2d_batched": (mtot_head, False)}
    rows = []

    for name in KERNELS_NUFFT:
        f32_rows = [r for r in phase3 if r["name"] == name
                    and r["dtype"] == "float32"]
        if name in KERNELS_1D:
            row = max((r for r in f32_rows
                       if r["serves"].startswith("light curve")),
                      key=lambda r: r["B"] * r["n"] * r["mtot"])
            extra = {"launches": launches_lc[name],
                     "launches_headline_facade": launches9[name]}
        elif name in row_shape:
            m, fo = row_shape[name]
            row = next(r for r in f32_rows if r["mtot"] == m and
                       r["fft_order"] == fo and r["n"] in (10_000, 100_000))
            extra = {"launches": fused_launches[name],
                     "launches_slice": launches[name],
                     "launches_cg_tier": launches_cg[name]
                     + launches_gcg[name],
                     "launches_headline_facade": launches9[name],
                     "launches_scale_fit_mean": launches10[name]}
        else:
            row = max((r for r in f32_rows
                       if r["serves"].startswith(("d3", "hard3d"))),
                      key=lambda r: r["B"] * r["n"] * r["mtot"] ** 3)
            extra = {"launches": launches_d3[name],
                     "launches_hard3d": launches_h3[name]
                     + launches_var4[name] + launches_g4[name]}
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
        rows.append({"name": f"{kernel} (mtot > {limit}, for {tpu})",
                     "route": "cuda", "source": source_of(kernel),
                     "replaces": replaces, "launches": launched[tpu],
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
        rows.append({"name": name, "route": "cuda", "source": source_of(name),
                     "replaces": REPLACES[name],
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
