"""Time SKI's ``W v`` kernel (``gpquad_torch/csrc/interp_2d.cu``
``interp_kernel``, through ``ops/cuda_interp.py`` ``interp_2d_points``) at
chip_smoke.py phase 11's band plan, with parts of it taken out.

    python scripts/time_interp_2d.py

It copies ``interp_2d.cu`` into ``build/interp_ablation/`` and builds, one
``nvcc`` each, all started together:

- ``full``: the kernel as it is (held bit for bit against the library's);
- ``no_stage``: no slab copied into shared memory (the sums read what is
  there);
- ``no_sums``: no stencil summed (a slot adds one weight);
- ``no_writes``: no point written;
- ``writes_alone``: neither slab nor sums (the tables, then the writes);
- ``tables_alone``: neither slab, sums nor writes;

and the kernel in other shapes, right answers all: ``slots8`` (2 048
slots a block), ``threads128`` and ``threads512`` (512 and 2 048 slots a
block, the latter one block an SM), ``batch1`` and ``batch16`` (vectors a
block), ``blocks3`` (three blocks an SM, fewer registers).

The answers of the ablations are wrong by design; ``full`` and the shapes
are held bit for bit against the library's kernel.  Each is
timed at B 1, 3, 8 and 64 on the same inputs, in turns each round, as the
card's time (it sleeps first, so that the host enqueues ahead: the
``time_cuda_paths`` of chip_smoke.py); it prints the card's name and power
limit.  It needs a CUDA device.

It is a tool for work on the kernel, not a check: nothing on the main path,
in the tests or in chip_smoke.py runs it, and it stops with an error where a
line it replaces is no longer in ``interp_2d.cu``.
"""
from __future__ import annotations

import ctypes
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import gpquad_torch  # noqa: E402
from gpquad_torch.models import ski  # noqa: E402
from gpquad_torch.ops import cuda_interp, cuda_nufft  # noqa: E402

OUT = ROOT / "build" / "interp_ablation"
# (the text in interp_2d.cu, what replaces it)
STAGE = ("    stage_slab(slabs + (s & 1) * F_ROWS * rs, rs,",
         "    if (0) stage_slab(slabs + (s & 1) * F_ROWS * rs, rs,")
SUMS = ("""        acc[k] = slot_sum(acc[k], slab, rs, i0[k], cc[k] - t0, wt, wr[k],
                          wc[k]);""", "        acc[k] = acc[k] + wr[k][0];")
WRITES = ("if (dst[k] >= 0) o[dst[k]] = acc[k];",
          "if (dst[k] >= 0 && acc[k] == T(12345.678)) o[dst[k]] = acc[k];")
SLOTS = "constexpr int F_SLOTS = sizeof(T) == 4 ? 4 : 2;"
BOUNDS = "__launch_bounds__(F_THREADS, 2)\ninterp_kernel"
VARIANTS = {"full": (), "no_stage": (STAGE,), "no_sums": (SUMS,),
            "no_writes": (WRITES,), "writes_alone": (STAGE, SUMS),
            "tables_alone": (STAGE, SUMS, WRITES),
            "slots8": ((SLOTS, SLOTS.replace("? 4 : 2", "? 8 : 4")),),
            "threads128": (("F_THREADS = 256", "F_THREADS = 128"),),
            "threads512": (("F_THREADS = 256", "F_THREADS = 512"),
                           (BOUNDS, BOUNDS.replace(", 2)", ", 1)"))),
            "batch1": (("F_BATCH = 4", "F_BATCH = 1"),),
            "batch16": (("F_BATCH = 4", "F_BATCH = 16"),),
            "blocks3": ((BOUNDS, BOUNDS.replace(", 2)", ", 3)")),)}
# the variants whose answers stay right
SHAPES = ("full", "slots8", "threads128", "threads512", "batch1", "batch16",
          "blocks3")
BATCHES = (1, 3, 8, 64)
SLEEP_CYCLES = 35_000_000


def build_variants():
    """Build every variant into its own library; their C entry points."""
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    src = (ROOT / "gpquad_torch" / "csrc" / "interp_2d.cu").read_text()
    nvcc, procs = cuda_nufft._nvcc(), {}
    for name, hooks in VARIANTS.items():
        text = src
        for old, new in hooks:
            if old not in text:
                raise RuntimeError(f"{name}: no line {old!r} in interp_2d.cu")
            text = text.replace(old, new)
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *cuda_nufft.NVCC_FLAGS, "-shared", "-o",
             str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    fns = {}
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, proc in procs.items():
        so, se = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{so}\n{se}")
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).gpq_interp_2d_f32
        fn.argtypes = [ptr, i64, i64, i64, i64, i32, i32, ptr, ptr, ptr,
                       ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr]
        fn.restype = i32
        fns[name] = fn
    return fns


def card_ms(fns, reps=50, trials=7):
    """The card's ms a call of each function, the functions in turn each
    round, the card asleep before each run so that the host is ahead."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for _ in range(trials):
        for k, fn in fns.items():
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(SLEEP_CYCLES)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            torch.cuda.synchronize()
            times[k].append(a.elapsed_time(b) / reps)
    return {k: statistics.median(t) for k, t in times.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("time_interp_2d.py needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    fns = build_variants()
    # phase 11's data and plan (chip_smoke.ski_data, grid 512^2)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (200_000, 2))
    kern = gpquad_torch.make_kernel("SE", 2, lengthscale=0.3, variance=1.0)
    op = ski.build_ski_operator(torch.as_tensor(x, dtype=torch.float32,
                                                device=dev), kern,
                                (512, 512), ski.resolve_grid_bounds(x))
    t = op.banded
    G1, G2 = op.grid_shape
    nb, cap = t.pidx.shape
    n = x.shape[0]
    for B in BATCHES:
        v = torch.as_tensor(rng.normal(size=(B, G1 * G2)), device=dev).float()
        want = cuda_interp.interp_2d_points(v, t.i0loc, t.c0, t.w_row,
                                            t.w_col, t.pout, G1=G1, G2=G2,
                                            n=n, bh=8)
        calls = {}
        for name, fn in fns.items():
            def call(fn=fn, B=B, v=v):
                out = torch.empty((B, n), device=dev)
                rc = fn(v.data_ptr(), G1 * G2, 8 * G2, G2, 1, G1, 1,
                        t.i0loc.data_ptr(), t.c0.data_ptr(),
                        t.w_row.data_ptr(), t.w_col.data_ptr(),
                        t.pout.data_ptr(), B, nb, cap, G2, n,
                        out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
                return out
            calls[name] = call
        for name in SHAPES:
            if not torch.equal(calls[name](), want):
                print(f"{name} differs from the library's kernel",
                      file=sys.stderr)
                return 1
        ms = card_ms(calls)
        print(f"B={B} (ms on the card; {nb} bands of cap {cap}, n {n}): "
              + " ".join(f"{k} {t_:.4f}" for k, t_ in ms.items())
              + f" [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
