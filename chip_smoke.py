#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gpquad_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
  1. torch and the card (nvidia-smi name and power limit);
  2. build the CUDA kernels from gpquad_torch/csrc (timed);
  3. each kernel against its float64 plain version on the card, at every
     shape that phases 4 and 5 give it and at mtot > 256, in float32 and
     float64, with CUDA-event times of kernel and plain version; for the
     batched pair also the time of B single-vector launches of the single
     kernels on the same inputs;
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
  5. the CG tier at bench.py's hard configuration (l=0.02, mtot=107, Jacobi
     PCG): fit + predict_mean, then gradient_with_grid(state=...), with
     their own launch counts, against float64;
  6. d3, the fused fit_predict_grad on 3-D data (n=1e5 in [0,1]^3, SE
     l=0.1 -> mtot 31, M 29 791, Jacobi PCG; 10 000 targets, 256 variance
     probes, 10 trace samples): launches per call, median of 5 warm calls,
     one profile, against the port's float64 run on the plain path with
     the same generator seed;
  7. hard3d (bench.py:363-438: n=2e4, l=0.2 -> mtot 21, M 9261): the fit
     with the deflation preconditioner (rank 2048) and the mean, then the
     stochastic variance and gradient_with_grid(state=fit) reusing its
     block, against float64.
Phase 3 also holds the two d=3 kernels at every shape of phases 6 and 7
and at mtot 57, 101 and 255.

It prints each phase's wall time, the kernels' JSON line, then the card's
nvidia-smi line, then ``{"ok": true, "device": ...}`` as the last line, and
writes the full record to build/chip_smoke.json.  Without a CUDA device, or
without the package beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, fp64 outside the tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
PEAK_BYTES = 3.35e12
# One phase e^{i 2 pi c} counted as 20 flops: the 10 multiply-adds of the
# minimax sin/cos pair the TPU kernel evaluates (pallas_nufft.py:61-77).
PHASE_FLOPS = 20

REPLACES = {"nufft1_2d": "gpquad/ops/pallas_nufft.py:195",
            "nufft2_2d": "gpquad/ops/pallas_nufft.py:113",
            "nufft1_2d_batched": "gpquad/ops/pallas_nufft.py:914",
            "nufft2_2d_batched": "gpquad/ops/pallas_nufft.py:838",
            # one kernel per type covers the single-block (mtot <= 56) and
            # the slab-tiled (:1118, :1034) TPU functions
            "nufft1_3d": "gpquad/ops/pallas_nufft.py:750",
            "nufft2_3d": "gpquad/ops/pallas_nufft.py:662"}
KERNELS_2D = ("nufft1_2d", "nufft2_2d", "nufft1_2d_batched",
              "nufft2_2d_batched")
KERNELS_3D = ("nufft1_3d", "nufft2_3d")
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


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def sync():
    torch.cuda.synchronize()


def source_of(name):
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
    kernels), d = 2 or 3 from the name.  Per point and vector: mtot^d
    complex multiply-adds at 8 flops; then the outer axes' products,
    multiply-adds at 8 flops for type-2 (mtot^(d-1) + ... + mtot of them:
    sum_j e1 t_j, and at d=3 sum_k e2 t_jk) and plain complex multiplies at
    6 for type-1 (at d=3 the mtot^2 products (v e1) e2; the mtot products
    v e1).  Phases at PHASE_FLOPS once per point, dimension and mode, also
    for a batch; the points, the B inputs and the B outputs read or written
    once."""
    d = 3 if name.endswith("_3d") else 2
    s = 4 if dtype == torch.float32 else 8
    phases = d * n * m * PHASE_FLOPS
    outer = 8 if name.startswith("nufft2") else 6
    outer_products = sum(m ** k for k in range(1, d))
    flops = B * n * (8 * m ** d + outer * outer_products) + phases
    nbytes = d * n * s + B * (2 * m ** d * s + 2 * n * s)
    return flops, nbytes


def bound_ms(name, n, m, dtype, B=1):
    flops, nbytes = kernel_work(name, n, m, dtype, B)
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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


def launch_counts(**nonzero):
    """The LAUNCHES dict a path should leave: every kernel 0 but those
    named."""
    return {k: nonzero.get(k, 0) for k in REPLACES}


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

    def path_grid(kern, xs):
        """(h, mtot) as fit plans them for the float32 points ``xs``."""
        x = torch.as_tensor(xs, dtype=torch.float32)
        L = float((x.max(dim=0).values - x.min(dim=0).values).max())
        _, h, mtot = gpquad_torch.spectral_grid(kern, 1e-6, L)
        return h, mtot

    h_head, mtot_head = path_grid(kernel32, xh)
    h_hard, mtot_hard = path_grid(kern_hard, xh2)
    # the d=3 paths take bench.py's grid for [0,1]^3 (bench.py:387)
    _, h_d3, mtot_d3 = gpquad_torch.spectral_grid(kern_d3, 1e-6, 1.0)
    _, h_h3, mtot_h3 = gpquad_torch.spectral_grid(kern_h3, 1e-6, 1.0)
    check((mtot_d3, mtot_h3) == (31, 21),
          f"d=3 grids planned mtot {mtot_d3} and {mtot_h3}, not 31 and 21")
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
    for name in SINGLE:
        for m in (339, 677):
            shapes.append((name, 20_000, m, False, 0.97, "mtot > 256", 1))
    for name in ("nufft1_2d_batched", "nufft2_2d_batched"):
        shapes.append((name, 20_000, 339, False, 0.97, "any mtot", 4))
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
    kernels = {k: getattr(cuda_nufft, k) for k in REPLACES}
    plains = {k: getattr(cuda_nufft, k + "_ref") for k in REPLACES}
    phase3 = []
    for name, n, m, fo, h, what, B in shapes:
        d = 3 if name in KERNELS_3D else 2
        batched = name.endswith("_batched")
        lead = (B,) if batched or B > 1 else ()
        x64 = torch.as_tensor(gen.uniform(0, 1, (n, d)), device=dev)
        shape = lead + ((n,) if name.startswith("nufft1") else (m,) * d)
        arg64 = torch.as_tensor(gen.normal(size=shape)
                                + 1j * gen.normal(size=shape), device=dev)
        for dtype in (torch.float32, torch.float64):
            cdt = torch.complex64 if dtype == torch.float32 \
                else torch.complex128
            x = x64.to(dtype)
            arg = arg64.to(cdt)
            hq = float(torch.tensor(h, dtype=dtype))
            kw = dict(mtot=m, fft_order=fo)
            got = kernels[name](x, arg, hq, **kw)
            sync()
            ref = plains[name](x.double(), arg.to(torch.complex128), hq, **kw)
            err = float((got.to(torch.complex128) - ref).abs().max())
            scale = float(ref.abs().max())
            rel = err / scale
            # the plain version in the run's precision, for comparison
            plain_rel = float((plains[name](x, arg, hq, **kw)
                               .to(torch.complex128) - ref).abs().max()) / scale
            bar = 1e-4 if dtype == torch.float32 or d == 2 else 1e-10
            check(np.isfinite(rel) and rel <= bar,
                  f"{name} {dtype} B={B} n={n} mtot={m}: error {rel:.3e} "
                  f"of max|ref| > {bar:.0e}")
            if d == 2:
                reps, trials = max(3, min(50, int(2e9 / (B * n * m * m)))), 5
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
            if batched:
                single = kernels[name.replace("_batched", "")]
                row["singles_ms"] = time_cuda(
                    lambda: [single(x, a, hq, **kw) for a in arg], reps)
                extra = f" {B}x single ms={row['singles_ms']:.4f}"
            if name == "nufft1_3d":
                groups, _ = cuda_nufft.type1_3d_groups(n, m, B)
                row["scratch_bytes"] = (groups * B * m ** 3
                                        * (8 if dtype == torch.float32
                                           else 16))
                extra = (f" scratch {groups} groups "
                         f"{row['scratch_bytes'] / 1e6:.1f} MB")
            phase3.append(row)
            print(f"[3] {name} {row['dtype']} B={B} n={n} mtot={m} "
                  f"fft_order={fo} ({what}): max_abs_err={err:.3e} "
                  f"rel={rel:.3e} (plain {row['dtype']}: {plain_rel:.3e}) "
                  f"ms={ms:.4f} plain_ms={plain_ms:.4f}"
                  f"{extra} bound_ms={b_ms:.4f} ({b_by}) {card}")
    record["phases"]["kernels"] = phase3
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
    counters = (cuda_nufft.LAUNCHES, nufft_mod.BACKEND_PICKS)

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

    def run_cg(x, y, xq, kern, method):
        t = time.perf_counter()
        s = gpquad_torch.fit(x, y, kern, sigmasq, eps=eps, cg_tol=1e-6,
                             max_cg_iter=2000, solver="cg",
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
    d3_ms = host_ms(lambda: fused3(x3, y3, xq3, "auto"))
    prof_d3 = profile_run(lambda: fused3(x3, y3, xq3, "auto"))
    print(f"[6] d3 fused fit_predict_grad (var_max_cg_iter "
          f"{D3_VAR_MAX_CG_ITER}): {d3_ms:.2f} ms median of 5 warm "
          f"calls (host clock) {card}; mean PCG iters "
          f"{int(out3.mean_cg_iters)} converged {bool(out3.mean_converged)}, "
          f"trace PCG iters {int(out3.trace_cg_iters)}")
    print_profile("[6] profiled d3 fused call:", prof_d3, card)
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
    record["phases"]["d3"] = dict(
        var_max_cg_iter=D3_VAR_MAX_CG_ITER, var_solves=var_solves,
        mtot=mtot_d3, M=mtot_d3 ** 3, launches=launches_d3,
        backend_picks=picks_d3, fused_ms=d3_ms, profile=prof_d3,
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

    # -- the record ----------------------------------------------------------
    # each kernel's row: its largest float32 call on a driven path (the
    # headline's for d=2, the d=3 paths' by work B n mtot^d); launches from
    # the main path's run of each (the fused call at the headline, at d3)
    row_shape = {"nufft1_2d": (m_lag, False), "nufft2_2d": (m_lag, True),
                 "nufft1_2d_batched": (mtot_head, False),
                 "nufft2_2d_batched": (mtot_head, False)}
    rows = []
    for name in REPLACES:
        f32_rows = [r for r in phase3 if r["name"] == name
                    and r["dtype"] == "float32"]
        if name in row_shape:
            m, fo = row_shape[name]
            row = next(r for r in f32_rows if r["mtot"] == m and
                       r["fft_order"] == fo and r["n"] in (10_000, 100_000))
            extra = {"launches": fused_launches[name],
                     "launches_slice": launches[name],
                     "launches_cg_tier": launches_cg[name]
                     + launches_gcg[name]}
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
