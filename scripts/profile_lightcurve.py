"""Profile chip_smoke.py phase 8's light-curve Adam loop in two checkouts of
the PyTorch port, in alternating processes, to find what sets its ms per
iteration.

    python scripts/profile_lightcurve.py --base DIR [--pairs 2] [--out FILE]

``DIR`` is another checkout of the repo, for example the parent commit
unpacked with ``git archive``.  Each run is a process of its own that
imports ``gpquad_torch`` from its checkout alone, in the order base, this,
this with the CUDA-core type-1, then the same reversed, ``--pairs`` times.
"This with the CUDA-core type-1" is this checkout with the float32
``nufft1_1d`` sent to the CUDA-core kernel (``type1_1d_geometry`` patched
to return its ``("cuda", chunk)`` path): it keeps everything else of the
checkout and changes the type-1's rounding back.

A run takes the light curve of chip_smoke.lightcurve_data (``EFGP``, SE
l 0.0015, eps 1e-4, chip_smoke.LC_OPT: 50 Adam iterations, float32), fits
once to warm up, then:

- a timed fit: per iteration the host-clock ms from its grid plan to the
  next one, the plan's mtot, and its mean and trace CG iterations (the
  fit's history); the median microseconds the host spends inside a
  ``nufft1_1d`` call (no synchronisation); the NUFFT launches of the loop
  by kernel; the learned hypers;
- in a checkout that has both float32 type-1 paths, six more fits in
  the same process, the tensor cores and the CUDA cores in turn: the
  median ms of an iteration and of the host's time inside ``nufft1_1d``
  for each fit;
- a profiled fit (``torch.profiler``, CPU and CUDA): per iteration the
  torch operations the host issues and the device's busy ms (the union of
  its kernels' spans), the idle share over the loop, and the kernels and
  host operations that take the most time.

Each run prints one JSON line; all runs go to ``--out`` (default
``build/profile_lightcurve.json``).  It needs a CUDA device.
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
VARIANTS = ("kernels", "cuda_core_type1")


def _median(values):
    return statistics.median(values) if values else None


def one_run(root: Path, variant: str) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    import gpquad_torch
    from gpquad_torch.ops import cuda_nufft
    from chip_smoke import LC_OPT, lightcurve_data
    assert Path(gpquad_torch.__file__).resolve().is_relative_to(root)
    if variant == "cuda_core_type1":
        cuda_nufft.type1_1d_geometry = (
            lambda n, mtot, B=1: ("cuda", cuda_nufft.TYPE1_CHUNK))
    dev = torch.device("cuda")
    lc = lightcurve_data()
    x, y = (torch.as_tensor(lc[k], dtype=torch.float32, device=dev)
            for k in ("x", "y"))
    kern = gpquad_torch.make_kernel("SE", 1, lengthscale=np.float32(0.0015),
                                    variance=np.float32(1.0))

    type1, type1_us = cuda_nufft.nufft1_1d, []

    def timed_type1(*args, **kw):
        t = time.perf_counter()
        out = type1(*args, **kw)
        type1_us.append((time.perf_counter() - t) * 1e6)
        return out
    cuda_nufft.nufft1_1d = timed_type1

    def fit():
        model = gpquad_torch.EFGP(x, y, kern, sigmasq=0.01, eps=1e-4,
                                  estimate_params=False, device=dev)
        starts, mtots, plan = [], [], model._grid_plan

        def timed_plan(bucket):
            starts.append(time.perf_counter())
            out = plan(bucket)
            mtots.append(out[1])
            return out
        model._grid_plan = timed_plan
        type1_us.clear()
        model.optimize_hyperparameters(**LC_OPT)
        torch.cuda.synchronize(dev)
        return model, starts, mtots

    def iter_median(starts):
        return statistics.median((b - a) * 1e3
                                 for a, b in zip(starts, starts[1:]))

    fit()
    before = dict(cuda_nufft.LAUNCHES)
    model, starts, mtots = fit()
    launches = {k: c - before[k] for k, c in cuda_nufft.LAUNCHES.items()
                if c != before[k]}
    log = model.training_log
    iter_ms = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
    out = {"root": str(root), "variant": variant,
           "lc_adam_iter_ms": statistics.median(iter_ms),
           "type1_host_us": _median(type1_us),
           "iter_ms": iter_ms, "mtot": mtots,
           "mean_cg_iters": log["mean_cg_iters"],
           "trace_cg_iters": log["trace_cg_iters"],
           "cg_iters_total": sum(log["mean_cg_iters"])
           + sum(log["trace_cg_iters"]),
           "launches": launches,
           "final": {k: log[k][-1] for k in log
                     if isinstance(log[k], list) and log[k]
                     and isinstance(log[k][-1], float)}}

    # in a checkout with both d=1 type-1 paths: fits in one process, the
    # float32 type-1 on the tensor cores and on the CUDA cores in turn
    # (tc, cuda, cuda, tc, tc, cuda), free of the host's process-to-process
    # spread
    geometry = getattr(cuda_nufft, "type1_1d_geometry", None)
    if variant == "kernels" and geometry is not None:
        paths = {"tc": geometry,
                 "cuda": lambda n, mtot, B=1: ("cuda",
                                               cuda_nufft.TYPE1_CHUNK)}
        ab = {"tc": [], "cuda": [], "tc_type1_host_us": [],
              "cuda_type1_host_us": []}
        for path in ("tc", "cuda", "cuda", "tc", "tc", "cuda"):
            cuda_nufft.type1_1d_geometry = paths[path]
            _, ab_starts, _ = fit()
            ab[path].append(iter_median(ab_starts))
            ab[f"{path}_type1_host_us"].append(_median(type1_us))
        cuda_nufft.type1_1d_geometry = geometry
        out["same_process"] = ab

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    # the device spans of the ops' record_function scopes run from their
    # first kernel to their last, idle gaps included: busy time counts
    # kernels and copies only (named here, as a --base checkout may
    # predate gpquad_torch.utils.profiling)
    scopes = {"nufft_type1", "nufft_type2", "toeplitz_matvec", "4_solve_cg",
              "7_batch_cg_solve"}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, pstarts, _ = fit()
        wall_ms = (time.perf_counter() - t0) * 1e3
    iters = len(pstarts)
    events = prof.key_averages()
    host_ops = sum(e.count for e in events)
    spans = []
    for e in prof.events():
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and e.name not in scopes):
            spans.append((e.time_range.start, e.time_range.end))
    busy = 0.0
    if spans:
        spans.sort()
        cur_s, cur_e = spans[0]
        for s_, e_ in spans[1:]:
            if s_ > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s_, e_
            else:
                cur_e = max(cur_e, e_)
        busy += cur_e - cur_s
    busy_ms = busy / 1e3

    def dev_time(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0))
    out["profile"] = {
        "wall_ms": wall_ms, "iterations": iters,
        "host_ops_per_iter": host_ops / iters,
        "device_busy_ms_per_iter": busy_ms / iters if spans else None,
        "idle_share": 1 - busy_ms / wall_ms if spans else None,
        "top_device": [[e.key[:80], e.count, round(dev_time(e) / 1e3, 3)]
                       for e in sorted(events, key=lambda e: -dev_time(e))
                       if e.key not in scopes][:12],
        "top_host": [[e.key[:80], e.count,
                      round(e.self_cpu_time_total / 1e3, 3)]
                     for e in sorted(events,
                                     key=lambda e: -e.self_cpu_time_total)
                     [:15]]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=Path)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--out", type=Path,
                    default=HERE / "build" / "profile_lightcurve.json")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--variant", choices=VARIANTS, default="kernels",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(one_run(args.one.resolve(), args.variant)),
              flush=True)
        return 0
    if args.base is None:
        ap.error("--base is required")
    base = args.base.resolve()
    cycle = [(base, "kernels"), (HERE, "kernels"), (HERE, "cuda_core_type1")]
    order = []
    for i in range(args.pairs):
        order += cycle if i % 2 == 0 else cycle[::-1]
    runs = []
    for root, variant in order:
        proc = subprocess.run([sys.executable, __file__, "--one", str(root),
                               "--variant", variant],
                              capture_output=True, text=True, cwd=root)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        run["tree"] = "base" if root == base else "this"
        runs.append(run)
        summary = {k: run.get(k) for k in (
            "tree", "variant", "lc_adam_iter_ms", "type1_host_us",
            "cg_iters_total", "launches", "same_process")}
        summary["mtot"] = sorted(set(run["mtot"]))
        summary["profile"] = {k: v for k, v in run["profile"].items()
                              if not k.startswith("top")}
        print(json.dumps(summary), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
