"""Time the float32 d=3 type-1 on the tensor cores (``nufft1_3d``'s
``type1_tc_kernel`` of ``csrc/tc_type1.cuh`` on ``nufft_3d.cu``'s
``Type1Grid3D``) at the driven shapes, taken apart.

    python scripts/time_type1_3d.py [--shapes driven|all]

It copies ``gpquad_torch/csrc`` into ``build/type1_3d_ablation/<variant>/``
and builds ``nufft_3d.cu`` there, one ``nvcc`` a variant, all started
together:

- ``full``: the kernel as it is;
- ``no_table_phases``: the stage table's phases (e^{-2 pi i r u1},
  e^{-2 pi i S q u1} and e2, made by the producers once a stage) replaced
  by a product;
- ``no_row_phases``: the rows' e3 phases (one a row and point) replaced
  likewise;
- ``no_phases``: both (the table's and the operands' stores, the splits
  and the products stay);
- ``no_mma``: no k-step run by the consumers (what is left: the producers'
  whole work, the hand-offs, the sums' stores).

The answers of the variants but ``full`` are wrong by design; ``full`` is
held within 1e-5 of max|ref| against the float64 plain version
(``nufft1_3d_ref``).  At each shape it also launches ``full`` with the
other tile width (32 or 128 columns (q, j2)) and with point groups of half
and twice the picked chunk, and prints each shape's work a stage and producer thread:
the table's phases, the rows' phases (A entries) and the columns' table
products (B entries).
Times are the card's (it sleeps first, so that the host enqueues ahead;
the variants in turn each of 5 rounds, medians); it prints the card's name
and power limit.  It needs a CUDA device.

It is a tool for work on the kernel, not a check: nothing on the main
path, in the tests or in chip_smoke.py runs it, and it stops with an error
where a line it replaces is no longer in the sources.
"""
from __future__ import annotations

import argparse
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
from gpquad_torch.ops import cuda_nufft as cn  # noqa: E402

OUT = ROOT / "build" / "type1_3d_ablation"
CSRC = ROOT / "gpquad_torch" / "csrc"
# (file, the text there, what replaces it)
TABLE = ("nufft_3d.cu", "        phase(u, kv, &c, &s);",
         "        c = u * kv; s = c + 1.f;")
ROWS = ("nufft_3d.cu", "    phase(u3, r.k3, &e3.x, &e3.y);",
        "    e3.x = u3 * r.k3; e3.y = e3.x + 1.f;")
KSTEPS = ("tc_type1.cuh", "for (int ks = 0; ks < TC_P; ks += 8) {",
          "for (int ks = 0; ks < 0; ks += 8) {")
VARIANTS = {"full": (), "no_table_phases": (TABLE,),
            "no_row_phases": (ROWS,), "no_phases": (TABLE, ROWS),
            "no_mma": (KSTEPS,)}
# (n, mtot, B, what): chip_smoke.py phase 6's and 7's type-1 calls (d3:
# F*y, the lag table, F*Z; hard3d likewise), then the slab-tiled widths
SHAPES = {"driven": [(100_000, 31, 1, "d3 F*y"),
                     (100_000, 61, 1, "d3 lag table"),
                     (100_000, 31, 10, "d3 F*Z"),
                     (20_000, 21, 1, "hard3d F*y"),
                     (20_000, 41, 1, "hard3d lag table"),
                     (20_000, 21, 10, "hard3d F*Z")]}
SHAPES["all"] = SHAPES["driven"] + [(20_000, m, 1, "slab-tiled")
                                    for m in (57, 101, 255)]
SLEEP_CYCLES = 35_000_000


def card_ms(fns, reps, trials=5):
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


def build_variants(nvcc):
    """One shared library of nufft_3d.cu per variant, compiled in parallel;
    returns {name: the ctypes function gpq_nufft1_3d_tc_f32} and prints
    each variant's registers and spills."""
    procs = {}
    for name, hooks in VARIANTS.items():
        d = OUT / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(CSRC, d)
        for fname, old, new in hooks:
            text = (d / fname).read_text()
            if old not in text:
                raise RuntimeError(f"{name}: '{old}' is not in {fname}")
            (d / fname).write_text(text.replace(old, new))
        procs[name] = subprocess.Popen(
            [nvcc, *cn.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "nufft_3d.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "Type1Grid3D" in line:
                inst = line.split("Type1Grid3DE")[1][:12]
                print(name, inst, " ".join(
                    ln.split(":", 1)[-1].strip() for ln in lines[i + 1:i + 3]))
        fn = ctypes.CDLL(str(OUT / name / "lib.so")).gpq_nufft1_3d_tc_f32
        fn.argtypes = [ptr, ptr, ctypes.c_float, *[i32] * 10, ptr, ptr, ptr]
        fn.restype = i32
        fns[name] = fn
    return fns


def stage_counts(geo, m):
    """Per stage of 32 points and producer thread (256 of them): the
    table's phases (averaged over the column tiles), the rows' phases and
    the columns' table products."""
    _, rows, cols, g, *_ = geo
    S, _, Q = cn.type1_3d_split(m, rows // g)
    tab = [S + min(k0 + cols - 1, Q * m - 1) // m - k0 // m + 1
           + min(m, cols) for k0 in range(0, Q * m, cols)]
    per = 32 / 256
    return (statistics.mean(tab) * per, rows * per, cols * per)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", choices=sorted(SHAPES), default="driven")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_type1_3d.py needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    fns = build_variants(cn._nvcc())
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    h = float(np.float32(0.2))
    for n, m, B, what in SHAPES[args.shapes]:
        x = torch.as_tensor(rng.uniform(0, 1, (n, 3)), device=dev).float()
        V = torch.as_tensor(rng.normal(size=(B, n)) + 1j * rng.normal(
            size=(B, n)), device=dev).to(torch.complex64)
        pick = cn.type1_3d_tc_geometry(n, m, B)
        ref = cn.nufft1_3d_ref(x.double(), V.to(torch.complex128), h,
                               mtot=m)
        scale = float(ref.abs().max())
        geos = {"pick": pick}
        other = 128 if pick[2] == 32 else 32
        if other == 32 or m <= 64:   # the launch refuses a table past kTab
            geos[f"cols{other}"] = pick[:2] + (other,) + pick[3:]
        for f, tag in ((0.5, "half"), (2, "twice")):
            chunk = max(pick[5], int(pick[6] * f) // pick[5] * pick[5])
            if chunk != pick[6]:
                geos[f"chunk_{tag}"] = pick[:6] + (chunk,)
        out = torch.empty((B, m, m, m), dtype=torch.complex64, device=dev)

        def launcher(fn, geo):
            groups = -(-n // geo[-1])
            part = torch.empty((groups, B, m, m, m), dtype=torch.complex64,
                               device=dev)

            def call():
                rc = fn(x.data_ptr(), V.data_ptr(), h, n, m, B, 0, *geo[1:],
                        part.data_ptr(), out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"CUDA error {rc}")
            return call
        calls = {}
        for k, geo in geos.items():
            calls[k] = launcher(fns["full"], geo)
            calls[k]()
            err = float((out.to(torch.complex128) - ref).abs().max()) / scale
            if err > 1e-5:
                print(f"{k} at n={n} m={m} B={B}: {err:.3e} of max|ref| from "
                      "the float64 plain version", file=sys.stderr)
                return 1
        for name, fn in fns.items():
            if name != "full":
                calls[name] = launcher(fn, pick)
        reps = max(1, min(10, int(3e10 / (n * B * m ** 3))))
        ms = card_ms(calls, reps)
        tab, rows, col = stage_counts(pick, m)
        print(f"{what} n={n} mtot={m} B={B} tensor cores {pick}: per stage"
              f" and producer thread {tab:.2f} table phases, {rows:.0f} row "
              f"phases, {col:.0f} column products; "
              + ", ".join(f"{k} {t:.4f}" for k, t in ms.items())
              + f" ms [{smi}]", flush=True)
        del x, V, ref, out, calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
