"""Time the single d=2 type-2 (``gpquad_torch.ops.cuda_nufft.nufft2_2d``) on
each of its paths, on the same inputs, over a sweep of points and grid
widths: the tensor cores (float32: the batched type-2's kernel at B 1;
float64: the FP64 tensor cores' B 1 instance), the mode split and the CUDA
cores.

    python scripts/time_type2_single.py [--out build/type2_single.json]

The sweep covers n in {5 000, 16 000, 30 000, 60 000, 100 000} by mtot in
{45, 57, 107, 339}, in float32 and float64, with h = 0.05: the shapes
between the driven ones that chip_smoke.py phase 3 times, where
``cuda_nufft.type2_2d_single_geometry`` draws its lines.  Each path is held
within 1e-4 of max|ref| (float32) or 1e-13 (float64) against the float64
plain version and bit for bit against a second launch; times are the
card's (CUDA events, the host ahead, the paths in turn in each of 5
rounds, as chip_smoke.py phase 3 times them), medians.  It prints a line
a shape and precision, with the path the table picks and the fastest, and
the card's name and power limit, and writes the rows to ``--out``.  It
needs a CUDA device.

It is a tool for work on the dispatch, not a check: nothing on the main
path, in the tests or in chip_smoke.py runs it.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from gpquad_torch.ops import cuda_nufft  # noqa: E402

POINTS = (5_000, 16_000, 30_000, 60_000, 100_000)
WIDTHS = (45, 57, 107, 339)
HOST_AHEAD_CYCLES = 35_000_000      # as chip_smoke.py's


def time_paths(fns, reps, trials=5):
    """The card's time a call (ms) of each function in ``fns``, median of
    ``trials`` rounds, as chip_smoke.py's time_cuda_paths times the paths:
    the card sleeps first, so that the host has enqueued the ``reps`` calls
    before the first starts, and each round times every path in turn."""
    for fn in fns.values():
        fn()
        fn()
    torch.cuda.synchronize()
    times = {p: [] for p in fns}
    for _ in range(trials):
        for p, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(HOST_AHEAD_CYCLES)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            times[p].append(start.elapsed_time(end) / reps)
    return {p: statistics.median(t) for p, t in times.items()}


def paths(dtype, mtot):
    geos = {"split": ("split", cuda_nufft.TYPE2_2D_SPLIT_ROWS,
                      cuda_nufft.TYPE2_2D_SPLIT_THREADS),
            "cuda": ("cuda",)}
    geos["tc"] = (("tc", cuda_nufft.TYPE2_2D_POINTS,
                   cuda_nufft.TYPE2_2D_COLS, cuda_nufft.TYPE2_2D_STAGE)
                  if dtype == torch.float32
                  else cuda_nufft.type2_2d_geometry(mtot, dtype))
    return geos


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "type2_single.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_type2_single: torch sees no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda")
    gen = np.random.default_rng(1)
    rows = []
    for n in POINTS:
        for m in WIDTHS:
            x64 = torch.as_tensor(gen.uniform(0, 1, (n, 2)), device=dev)
            f64 = torch.as_tensor(gen.normal(size=(m, m))
                                  + 1j * gen.normal(size=(m, m)), device=dev)
            for dtype in (torch.float32, torch.float64):
                x = x64.to(dtype)
                f = f64.to(torch.complex64 if dtype == torch.float32
                           else torch.complex128)
                h = float(torch.tensor(0.05, dtype=dtype))
                # the float64 plain version on the inputs as rounded
                ref = cuda_nufft.nufft2_2d_ref(x.double(),
                                               f.to(torch.complex128), h,
                                               mtot=m)
                scale = float(ref.abs().max())
                bar = 1e-4 if dtype == torch.float32 else 1e-13
                row = dict(n=n, mtot=m, dtype=str(dtype).split(".")[-1],
                           pick=cuda_nufft.type2_2d_single_geometry(
                               n, m, dtype)[0], card=card)
                calls = {}
                for path, geo in paths(dtype, m).items():
                    def call(geo=geo):
                        return cuda_nufft._nufft2_2d_on(x, f, h, m, False,
                                                        geo)
                    calls[path] = call
                    got = call()
                    rel = float((got.to(torch.complex128) - ref).abs().max()
                                ) / scale
                    if not (rel <= bar and torch.equal(call(), got)):
                        raise RuntimeError(f"{path} n={n} mtot={m} {dtype}: "
                                           f"error {rel:.3e} or a second "
                                           "launch differs")
                    row[f"{path}_rel_err"] = rel
                reps = max(3, min(50, int(2e9 / (n * m * m))))
                for path, ms in time_paths(calls, reps).items():
                    row[f"{path}_ms"] = ms
                fastest = min(paths(dtype, m), key=lambda p: row[f"{p}_ms"])
                row["fastest"] = fastest
                rows.append(row)
                print(f"n={n} mtot={m} {row['dtype']}: pick {row['pick']}, "
                      f"fastest {fastest}; " + ", ".join(
                          f"{p} {row[f'{p}_ms']:.4f} ms"
                          for p in paths(dtype, m)) + f" [{card}]", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
