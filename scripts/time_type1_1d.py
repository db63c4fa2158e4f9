"""Time the float32 d=1 type-1 on the tensor cores (``nufft1_1d``'s
``type1_tc_kernel`` on ``Type1Split1D``) over its point-group sizes, beside
the CUDA-core kernel, at the light curve's calls.

    python scripts/time_type1_1d.py

At each of chip_smoke.py phase 8's type-1 calls (63 480 points: F*y at
mtot 1031, the lag table at 2061, F*Z at 1031 and B 10) and at the dense
tier's widest lag table (20 000 points, mtot 8191), it launches the kernel
with the geometry ``cuda_nufft.type1_1d_geometry`` picks and with every
chunk of 256 to 5 120 points (runs of 256, and of 1 024 at 5 120), on the
narrow and the wide tile where the q values fit both, each held within
1e-6 of max|ref| from the float64 plain version and bit for bit against a
second launch, and the CUDA-core kernel on the same inputs.  Times are the
card's (it sleeps first, so that the host enqueues ahead; the geometries in
turn each of 7 rounds, medians); it prints the card's name and power limit
and, per call, the picked geometry's time and the six fastest.  It needs a
CUDA device.

It is a tool for work on the kernel's geometry, not a check: nothing on the
main path, in the tests or in chip_smoke.py runs it.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from gpquad_torch.ops import cuda_nufft as cn  # noqa: E402

CALLS = ((63_480, 1031, 1), (63_480, 2061, 1), (63_480, 1031, 10),
         (20_000, 8191, 1))
CHUNKS = ((256, 256), (256, 512), (256, 1024), (256, 1280), (256, 2560),
          (256, 5120), (1024, 5120))
SLEEP_CYCLES = 35_000_000


def card_ms(fns, reps=20, trials=7):
    """The card's ms a call of each function, in turn each round, the card
    asleep before each run so that the host is ahead."""
    for f in fns.values():
        f()
    torch.cuda.synchronize()
    out = {k: [] for k in fns}
    for _ in range(trials):
        for k, f in fns.items():
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(SLEEP_CYCLES)
            a.record()
            for _ in range(reps):
                f()
            b.record()
            torch.cuda.synchronize()
            out[k].append(a.elapsed_time(b) / reps)
    return {k: statistics.median(v) for k, v in out.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("time_type1_1d.py needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    h = float(torch.tensor(0.99, dtype=torch.float32))
    for n, m, B in CALLS:
        x = torch.as_tensor(rng.uniform(0, 1, (n, 1)), device=dev).float()
        V = torch.as_tensor(rng.normal(size=(B, n)) + 1j * rng.normal(
            size=(B, n)), device=dev).to(torch.complex64)
        ref = cn.nufft1_1d_ref(x.double(), V.to(torch.complex128), h,
                               mtot=m)
        pick = cn.type1_1d_geometry(n, m, B)
        geos = {"pick": pick, "cuda_cores": ("cuda", cn.TYPE1_CHUNK)}
        g = pick[3]
        q = cn.type1_1d_split(m, cn.TYPE1_2D_ROWS // g)[1]
        for cols in (cn.TYPE1_2D_NARROW_COLS, cn.TYPE1_2D_COLS):
            if cols == cn.TYPE1_2D_COLS and q <= cn.TYPE1_2D_NARROW_COLS:
                continue
            for run, chunk in CHUNKS:
                geos[f"cols{cols}_run{run}_chunk{chunk}"] = (
                    "tc", cn.TYPE1_2D_ROWS, cols, g, cn.TYPE1_2D_STAGE, run,
                    chunk)
        fns = {k: (lambda geo=geo: cn._nufft1_1d_on(x, V, h, m, False, geo))
               for k, geo in geos.items()}
        for k, f in fns.items():
            got = f()
            err = float((got.to(torch.complex128) - ref).abs().max()
                        / ref.abs().max())
            if err > 1e-6 or not torch.equal(f(), got):
                print(f"{k} at n={n} m={m} B={B}: error {err:.3e} or not "
                      "the same bits on a second launch", file=sys.stderr)
                return 1
        ms = card_ms(fns)
        best = sorted(ms.items(), key=lambda kv: kv[1])[:6]
        print(f"n={n} mtot={m} B={B}: pick {pick} {ms['pick']:.4f} ms, CUDA "
              f"cores {ms['cuda_cores']:.4f}; fastest "
              + ", ".join(f"{k} {t:.4f}" for k, t in best) + f" [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
