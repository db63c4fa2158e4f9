"""Compare two checkouts of the PyTorch port (``gpquad_torch``) on one card,
in alternating processes.

    python scripts/port_compare_trees.py --base DIR [--pairs 3] [--out FILE]

``DIR`` is another checkout of the repo, for example the parent commit
unpacked with ``git archive``.  The script runs the same measurements on
``DIR`` and on the checkout that holds it, each run in a process of its own
that imports ``gpquad_torch`` from its checkout alone (each builds its own
kernels), in the order base, this, this, base, base, this, ... (``--pairs``
pairs).  A run measures:

- the headline fused ``fit_predict_grad`` (chip_smoke.py phase 4's call:
  n 1e5 in [0,1]^2, SE l=0.1, 10 000 targets, float32 on the kernels):
  host-clock median of 5 warm calls, each synchronised;
- phase 11's SKI fit (``fit_ski_gp``, n 2e5 in [-1,1]^2, grid 512^2, 20 Adam
  iterations, after a 2-iteration warm fit): its wall time and the median
  ms of an Adam iteration (forward + backward, from the fit's history);
- the float32 d=2 type-1 kernels at the headline's widths (n 1e5, mtot 29
  and 57; single and B 10): CUDA-event medians of 5 trials;
- the float32 batched type-2 (``nufft2_2d_batched``, through its wrapper,
  so on the route each checkout gives it) at the headline (B 10, mtot 29)
  and at the scale configuration's Adam loop (B 5, n 1e6, mtot 339):
  CUDA-event medians of 5 and 3 trials;
- the float32 single type-2 (``nufft2_2d``, through its wrapper) at the
  scale configuration's F(D beta) (n 1e6, mtot 339), mean (2 000 points)
  and variance evaluation (1 000 points, mtot 677 in FFT order):
  CUDA-event medians of 3 and 5 trials;
- three steps of chip_smoke.py phase 10's fixed-plan Adam loop at scale
  (n 1e6, SE l=0.006, mtot 339, kron, 5 trace samples, after one warm
  step): the host-clock time of each step, synchronised;
- the fitted SKI operator's ``W^T u``, ``W v`` and matvec at B 3: the
  host's microseconds to issue a call, and the CUDA-event time of a call;
- phase 8's light-curve facade (``EFGP`` on the Kepler-cadence series of
  chip_smoke.lightcurve_data, 50 Adam iterations, after a warm fit): the
  median ms of an iteration (from the grid plan each one starts with);
- the float32 ``nufft1_1d`` at the light curve's calls (F*y and F*Z at
  mtot 1031, the lag table at 2061) and ``nufft2_1d`` (F(D beta), and
  B 10), through their wrappers: CUDA-event medians of 5 trials;
- phase 6's d3 fused call with kron (n 1e5 in [0,1]^3, mtot 31): the
  host-clock median of 3 warm calls; and the float32 ``nufft1_3d`` at its
  calls (F*y, the lag table at 61, F*Z at B 10; through the wrapper):
  CUDA-event medians of 3 trials;
- the torch operations a one-iteration ``fit_ski_gp`` issues on the host
  (``torch.profiler``): their count and the 12 with the most self host
  time.

Each run prints one JSON line; the script then prints each measurement's
per-checkout medians and quartiles as one JSON line, and writes every run
to ``--out`` (default ``build/compare_trees.json``).  It needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
FUSED_KW = dict(trace_samples=10, var_probes=256, cg_tol=1e-6,
                var_cg_tol=1e-4, grad_cg_tol=1e-4, max_cg_iter=1000,
                var_max_cg_iter=400)


def one_run(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    import gpquad_torch
    from gpquad_torch.models import ski
    from gpquad_torch.ops import cuda_nufft
    assert Path(gpquad_torch.__file__).resolve().is_relative_to(root)
    dev = torch.device("cuda")

    def sync():
        torch.cuda.synchronize(dev)

    def host_ms(fn, reps=5):
        fn()
        sync()
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            sync()
            ts.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts)

    def event_ms(fn, reps, trials=5):
        fn()
        sync()
        ts = []
        for _ in range(trials):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            sync()
            ts.append(a.elapsed_time(b) / reps)
        return statistics.median(ts)

    out = {"root": str(root)}
    # the headline data (bench.py:836-845, chip_smoke.headline_data)
    rng = np.random.default_rng(0)
    xh = rng.uniform(0, 1, size=(100_000, 2))
    yh = (np.sin(3 * np.pi * xh[:, 0]) * np.cos(2 * np.pi * xh[:, 1])
          + 0.5 * np.sin(7 * xh[:, 0] + 5 * xh[:, 1])
          + 0.1 * rng.normal(size=len(xh)))
    xq = rng.uniform(0, 1, size=(10_000, 2))
    x32, y32, xq32 = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                      for a in (xh, yh, xq))
    kern = gpquad_torch.make_kernel("SE", 2, lengthscale=np.float32(0.1),
                                    variance=np.float32(1.0))
    _, h, mtot = gpquad_torch.spectral_grid(kern, 1e-6, 1.0)

    def fused():
        return gpquad_torch.fit_predict_grad(
            x32, y32, xq32, kern, 0.01, h,
            torch.Generator(device=dev).manual_seed(0), mtot=mtot,
            nufft_method="auto", device=dev, **FUSED_KW)
    out["fused_ms"] = host_ms(fused)

    # the float32 d=2 type-1 at the headline's widths
    gen = np.random.default_rng(1)
    hq = float(torch.tensor(h, dtype=torch.float32))
    v = torch.as_tensor(gen.normal(size=(10, len(xh)))
                        + 1j * gen.normal(size=(10, len(xh))),
                        device=dev).to(torch.complex64)
    for m in (mtot, 2 * mtot - 1):
        out[f"nufft1_2d_m{m}_ms"] = event_ms(
            lambda: cuda_nufft.nufft1_2d(x32, v[0], hq, mtot=m), 50)
        out[f"nufft1_2d_batched_B10_m{m}_ms"] = event_ms(
            lambda: cuda_nufft.nufft1_2d_batched(x32, v, hq, mtot=m), 20)
    del v

    # the batched type-2 at the headline (B 10) and at scale (B 5)
    f10 = torch.as_tensor(gen.normal(size=(10, mtot, mtot))
                          + 1j * gen.normal(size=(10, mtot, mtot)),
                          device=dev).to(torch.complex64)
    out[f"nufft2_2d_batched_B10_m{mtot}_ms"] = event_ms(
        lambda: cuda_nufft.nufft2_2d_batched(x32, f10, hq, mtot=mtot), 20)
    rng10 = np.random.default_rng(10)
    xs = rng10.uniform(0, 1, size=(1_000_000, 2))
    ys = (np.sin(3 * np.pi * xs[:, 0]) * np.cos(2 * np.pi * xs[:, 1])
          + 0.5 * np.sin(7 * xs[:, 0] + 5 * xs[:, 1])
          + 0.1 * rng10.normal(size=len(xs)))
    x10, y10 = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                for a in (xs, ys))
    kern10 = gpquad_torch.make_kernel("SE", 2, lengthscale=np.float32(0.006),
                                      variance=np.float32(1.0))
    _, h10, mtot10 = gpquad_torch.spectral_grid(kern10, 1e-6, 1.0)
    hq10 = float(torch.tensor(h10, dtype=torch.float32))
    f5 = torch.as_tensor(gen.normal(size=(5, mtot10, mtot10))
                         + 1j * gen.normal(size=(5, mtot10, mtot10)),
                         device=dev).to(torch.complex64)
    out[f"nufft2_2d_batched_B5_m{mtot10}_ms"] = event_ms(
        lambda: cuda_nufft.nufft2_2d_batched(x10, f5, hq10, mtot=mtot10), 3,
        trials=3)
    del f5

    # the single type-2 (through its wrapper, so on the path each checkout
    # gives it) at the scale configuration's calls: F(D beta) (n 1e6), the
    # mean (2 000 targets) and the variance evaluation (1 000 targets, the
    # 2 mtot - 1 grid in FFT order)
    lag10 = 2 * mtot10 - 1
    f1, fl = (torch.as_tensor(gen.normal(size=(m, m))
                              + 1j * gen.normal(size=(m, m)),
                              device=dev).to(torch.complex64)
              for m in (mtot10, lag10))
    out[f"nufft2_2d_n1000000_m{mtot10}_ms"] = event_ms(
        lambda: cuda_nufft.nufft2_2d(x10, f1, hq10, mtot=mtot10), 3,
        trials=3)
    out[f"nufft2_2d_n2000_m{mtot10}_ms"] = event_ms(
        lambda: cuda_nufft.nufft2_2d(x10[:2000], f1, hq10, mtot=mtot10), 20)
    out[f"nufft2_2d_n1000_m{lag10}_ms"] = event_ms(
        lambda: cuda_nufft.nufft2_2d(x10[:1000], fl, hq10, mtot=lag10,
                                     fft_order=True), 20)
    del f1, fl

    # phase 10's fixed-plan Adam loop (bench.py's T=5, cg_tol 1e-3)
    params = gpquad_torch.HyperState.create(kern10, 0.01)
    raw = params.raw.to(dev).clone()
    adam = torch.optim.Adam([raw], lr=0.05)
    gen10 = torch.Generator(device=dev).manual_seed(7)

    def hyper_iter():
        p = params.replace_raw(raw.detach())
        res = gpquad_torch.gradient_with_grid(
            x10, y10, p.kernel_of(kern10), p.sig2, h10, gen10, mtot=mtot10,
            device=dev, solver="cg", precond="kron", fft_smooth=True,
            trace_samples=5, cg_tol=1e-3, max_cg_iter=500)
        raw.grad = res.grad.to(raw.dtype) * torch.exp(raw.detach())
        adam.step()
    hyper_iter()
    steps = []
    for _ in range(3):
        sync()
        t = time.perf_counter()
        hyper_iter()
        sync()
        steps.append((time.perf_counter() - t) * 1e3)
    out["scale_adam_step_ms"] = statistics.median(steps)
    out["scale_adam_steps"] = steps
    del x10, y10

    # phase 11's SKI fit (chip_smoke.ski_data)
    rng = np.random.default_rng(0)
    xs = rng.uniform(-1, 1, size=(200_000, 2))
    ys = (np.sin(3 * xs[:, 0]) * np.cos(2 * xs[:, 1])
          + 0.5 * np.sin(2 * xs[:, 0] + 3 * xs[:, 1])
          + 0.1 * rng.normal(size=len(xs)))
    ski.fit_ski_gp(xs, ys, kernel="SE", grid_size=512, max_iters=2,
                   verbose=False, device=dev)
    sync()
    t = time.perf_counter()
    fit = ski.fit_ski_gp(xs, ys, kernel="SE", grid_size=512, max_iters=20,
                         verbose=False, device=dev)
    sync()
    out["ski_fit_ms"] = (time.perf_counter() - t) * 1e3
    hist = fit["history"]
    out["ski_adam_iter_ms"] = statistics.median(
        (f + b) * 1e3 for f, b in zip(hist["forward_sec"],
                                      hist["backward_sec"]))

    # the SKI operator at the PCG's batch (y and two probes): the host's
    # time to issue a call (no synchronisation) and the call's CUDA-event
    # time, for W^T u alone and for a whole matvec
    op = fit["model"]["operator"]
    u3 = torch.randn((3, len(xs)), generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)
    g3 = torch.randn((3, op.M), generator=torch.Generator(
        device=dev).manual_seed(4), device=dev)
    for name, fn in (("interp_T", lambda: op.interp_T(u3)),
                     ("interp", lambda: op.interp(g3)),
                     ("matvec", lambda: op.matvec(u3, 0.01))):
        fn()
        sync()
        t = time.perf_counter()
        for _ in range(200):
            fn()
        out[f"ski_{name}_host_us"] = (time.perf_counter() - t) / 200 * 1e6
        sync()
        out[f"ski_{name}_ms"] = event_ms(fn, 100)

    # phase 8's light-curve facade and its type-1 calls
    from chip_smoke import LC_OPT, lightcurve_data
    lc = lightcurve_data()
    x8, y8 = (torch.as_tensor(lc[k], dtype=torch.float32, device=dev)
              for k in ("x", "y"))
    kern_lc = gpquad_torch.make_kernel("SE", 1,
                                       lengthscale=np.float32(0.0015),
                                       variance=np.float32(1.0))

    def lc_iter_ms():
        model = gpquad_torch.EFGP(x8, y8, kern_lc, sigmasq=0.01, eps=1e-4,
                                  estimate_params=False, device=dev)
        starts, plan = [], model._grid_plan

        def timed_plan(bucket):
            starts.append(time.perf_counter())
            return plan(bucket)
        model._grid_plan = timed_plan
        model.optimize_hyperparameters(**LC_OPT)
        sync()
        return statistics.median((b - a) * 1e3
                                 for a, b in zip(starts, starts[1:]))
    lc_iter_ms()
    out["lc_adam_iter_ms"] = lc_iter_ms()
    n_lc = len(lc["x"])
    _, h_lc, _ = gpquad_torch.spectral_grid(kern_lc, 1e-4, 1.0)
    hq_lc = float(torch.tensor(h_lc, dtype=torch.float32))
    v10 = torch.as_tensor(gen.normal(size=(10, n_lc))
                          + 1j * gen.normal(size=(10, n_lc)),
                          device=dev).to(torch.complex64)
    for tag, arg, m in (("Fy", v10[0], 1031), ("lag", v10[0], 2061),
                        ("FZ_B10", v10, 1031)):
        out[f"nufft1_1d_{tag}_m{m}_ms"] = event_ms(
            lambda: cuda_nufft.nufft1_1d(x8[:, None], arg, hq_lc, mtot=m),
            20)

    # ... and its type-2 calls (F(D beta), and the B 10 probe batch)
    f10 = torch.as_tensor(gen.normal(size=(10, 1031))
                          + 1j * gen.normal(size=(10, 1031)),
                          device=dev).to(torch.complex64)
    for tag, arg in (("FDbeta", f10[0]), ("B10", f10)):
        out[f"nufft2_1d_{tag}_m1031_ms"] = event_ms(
            lambda: cuda_nufft.nufft2_1d(x8[:, None], arg, hq_lc, mtot=1031),
            20)
    del v10, f10

    # phase 6's d3 fused call with kron (n 1e5 in [0,1]^3, SE l=0.1, mtot
    # 31; host-clock median of 3 warm calls) and its type-1 calls (F*y, the
    # lag table at 61, F*Z at B 10; through the wrapper)
    from chip_smoke import FUSED3_KW, data_3d
    xd, yd, xqd = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                   for a in data_3d(100_000, 10_000, seed=3))
    kern3 = gpquad_torch.make_kernel("SE", 3, lengthscale=np.float32(0.1),
                                     variance=np.float32(1.0))
    _, h3, mtot3 = gpquad_torch.spectral_grid(kern3, 1e-6, 1.0)

    def fused3():
        return gpquad_torch.fit_predict_grad(
            xd, yd, xqd, kern3, 0.01, h3,
            torch.Generator(device=dev).manual_seed(0), mtot=mtot3,
            nufft_method="auto", precond="kron", device=dev, **FUSED3_KW)
    out["d3_fused_kron_ms"] = host_ms(fused3, reps=3)
    hq3 = float(torch.tensor(h3, dtype=torch.float32))
    v3 = torch.as_tensor(gen.normal(size=(10, len(xd)))
                         + 1j * gen.normal(size=(10, len(xd))),
                         device=dev).to(torch.complex64)
    for tag, arg, m in (("Fy", v3[0], mtot3), ("lag", v3[0], 2 * mtot3 - 1),
                        ("FZ_B10", v3, mtot3)):
        out[f"nufft1_3d_{tag}_m{m}_ms"] = event_ms(
            lambda: cuda_nufft.nufft1_3d(xd, arg, hq3, mtot=m), 3, trials=3)
    del v3, xd, yd, xqd

    # the torch operations the host issues in a one-iteration fit (its
    # final solve included), by count and self host time
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ski.fit_ski_gp(xs, ys, kernel="SE", grid_size=512, max_iters=1,
                       verbose=False, device=dev)
        sync()
    events = prof.key_averages()
    out["ski_fit1_op_count"] = sum(e.count for e in events)
    out["ski_fit1_top_ops"] = [
        [e.key, e.count, round(e.self_cpu_time_total / 1e3, 3)]
        for e in sorted(events, key=lambda e: -e.self_cpu_time_total)[:12]]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=Path)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--out", type=Path,
                    default=HERE / "build" / "compare_trees.json")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(one_run(args.one.resolve())), flush=True)
        return 0
    if args.base is None:
        ap.error("--base is required")
    base = args.base.resolve()
    order = []
    for i in range(args.pairs):
        order += [base, HERE] if i % 2 == 0 else [HERE, base]
    runs = []
    for root in order:
        proc = subprocess.run([sys.executable, __file__, "--one", str(root)],
                              capture_output=True, text=True, cwd=root)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        run["tree"] = "base" if root == base else "this"
        runs.append(run)
        print(json.dumps(run), flush=True)
    keys = [k for k in runs[0] if k.endswith(("_ms", "_us", "_count"))]

    def stats(values):
        q = (statistics.quantiles(values, n=4, method="inclusive")
             if len(values) > 1 else [values[0]] * 3)
        return {"median": statistics.median(values), "q1": q[0], "q3": q[2]}
    summary = {tree: {k: stats([r[k] for r in runs if r["tree"] == tree])
                      for k in keys}
               for tree in ("base", "this")}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"runs": runs, "stats": summary},
                                   indent=1))
    print(json.dumps({"stats": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
