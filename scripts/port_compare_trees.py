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
- the fitted SKI operator's ``W^T u`` and matvec at B 3: the host's
  microseconds to issue a call, and the CUDA-event time of a call;
- the torch operations a one-iteration ``fit_ski_gp`` issues on the host
  (``torch.profiler``): their count and the 12 with the most self host
  time.

Each run prints one JSON line; the script then prints each measurement's
per-checkout medians as one JSON line, and writes every run to ``--out``
(default ``build/compare_trees.json``).  It needs a CUDA device.
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
    for name, fn in (("interp_T", lambda: op.interp_T(u3)),
                     ("matvec", lambda: op.matvec(u3, 0.01))):
        fn()
        sync()
        t = time.perf_counter()
        for _ in range(200):
            fn()
        out[f"ski_{name}_host_us"] = (time.perf_counter() - t) / 200 * 1e6
        sync()
        out[f"ski_{name}_ms"] = event_ms(fn, 100)

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
    summary = {tree: {k: statistics.median(r[k] for r in runs
                                           if r["tree"] == tree)
                      for k in keys}
               for tree in ("base", "this")}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"runs": runs, "medians": summary},
                                   indent=1))
    print(json.dumps({"medians": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
