"""Compare two checkouts of the PyTorch port on chip_smoke.py phase 12d, the
float64 high tier at the scale configuration, in alternating processes.

    python scripts/time_high_scale.py --base DIR [--pairs 2] [--out FILE]

``DIR`` is another checkout of the repo, for example the parent commit
unpacked with ``git archive`` into ``build/parent``.  Each run is a process
of its own that imports ``gpquad_torch`` from its checkout alone (each
builds its own kernels), in the order base, this, this, base, ...
(``--pairs`` pairs).  A run measures, on phase 10's data (n 1e6 in
[0,1]^2, SE l 0.006 -> mtot 339, chip_smoke.scale_data):

- ``fit_high`` (deflation rank 2048, the iterative solver) +
  ``predict_mean_high`` at 500 targets, phase 12d's call: the CUDA-event
  ms of each of 5 calls after a warm one, and the inner PCG iterations;
- one such call under ``torch.profiler``: the device's busy ms (kernels
  and copies; chip_smoke.profile_run), the ms of the float64 type-1
  kernels (``type1_f64_kernel``, the FP64 tensor cores, or
  ``nufft1_2d_partial_kernel``, the chunked CUDA cores) and the host
  operators with the most self time;
- 5 more calls after the profiled one, timed as the first 5 (whether a
  profiled call leaves a cost on later calls), then a second profiled
  call (whether its trace holds what the first one's held);
- the float64 ``nufft1_2d`` at the call's shapes (F*y at 339, the lag
  table at 677) through the wrapper: CUDA-event medians of 3 trials.

Each run prints one JSON line; the script then prints each measurement's
per-checkout medians as one JSON line and writes every run to ``--out``
(default ``build/time_high_scale.json``).  It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
CALLS = 5
TYPE1_KERNELS = ("type1_f64_kernel", "nufft1_2d_partial_kernel")


def one_run(root: Path) -> dict:
    """One run on ``root``'s gpquad_torch, measured with this checkout's
    chip_smoke.py helpers (the same measuring code for both trees)."""
    sys.path.insert(0, str(root))
    import importlib.util
    import numpy as np
    import torch
    import gpquad_torch
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from gpquad_torch.ops import cuda_nufft
    assert Path(gpquad_torch.__file__).resolve().is_relative_to(root)
    dev = torch.device("cuda")
    cuda_nufft.build()
    xs, ys, xqs = chip_smoke.scale_data(1_000_000)
    x, y, xq = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                for a in (xs, ys, xqs[:500]))
    kern = gpquad_torch.make_kernel("SE", 2, lengthscale=np.float32(0.006),
                                    variance=np.float32(1.0))
    _, h, mtot = gpquad_torch.spectral_grid(kern, 1e-6, 1.0)

    def call():
        hs = gpquad_torch.fit_high(x, y, kern, 0.01, h, mtot, device=dev,
                                   solver="iterative",
                                   precond_rank=chip_smoke.HIGH_RANK)
        return hs, gpquad_torch.predict_mean_high(hs, xq)

    hs, _ = call()
    torch.cuda.synchronize()
    ms = []
    for _ in range(CALLS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        call()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    prof = chip_smoke.profile_run(call, groups={"type1_f64": TYPE1_KERNELS},
                                  host_top=8)
    after = []
    for _ in range(CALLS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        call()
        b.record()
        torch.cuda.synchronize()
        after.append(a.elapsed_time(b))
    again = chip_smoke.profile_run(call, groups={"type1_f64": TYPE1_KERNELS},
                                   host_top=8)
    out = {"root": str(root), "fit_mean_ms_calls": ms,
           "fit_mean_ms": statistics.median(ms),
           "after_profile_ms_calls": after,
           "after_profile_ms": statistics.median(after),
           "inner_iters": int(hs.state.mean_cg_iters),
           "profiled_wall_ms": prof["wall_ms"],
           "profiled_busy_ms": prof["busy_ms"],
           "profiled_type1_f64_ms": prof.get("groups_ms", {}).get(
               "type1_f64"),
           "profiled_host_top": prof.get("host_top"),
           "profiled_again_wall_ms": again["wall_ms"],
           "profiled_again_busy_ms": again["busy_ms"],
           "profiled_again_type1_f64_ms": again.get("groups_ms", {}).get(
               "type1_f64"),
           "profiled_again_host_top": again.get("host_top")}
    xd = x.double()
    rng = np.random.default_rng(0)
    v = torch.as_tensor(rng.normal(size=xd.shape[0]), device=dev) + 0j
    for m in (mtot, 2 * mtot - 1):
        out[f"nufft1_2d_f64_{m}_ms"] = chip_smoke.time_cuda(
            lambda: cuda_nufft.nufft1_2d(xd, v, h, mtot=m), 1, 3)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=Path)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--out", type=Path,
                    default=HERE / "build" / "time_high_scale.json")
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
    keys = [k for k, v in runs[0].items()
            if k.endswith(("_ms", "iters")) and isinstance(v, (int, float))]
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
