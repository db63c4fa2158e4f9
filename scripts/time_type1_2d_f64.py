"""Time the float64 d=2 type-1 on the FP64 tensor cores (``nufft1_2d`` and
``nufft1_2d_batched`` in float64: ``type1_f64_kernel`` of
``csrc/tc_type1_f64.cuh``) at the driven shapes, taken apart, beside
another checkout's float64 d=2 type-1.

    python scripts/time_type1_2d_f64.py [--shapes driven|scale|all|phase3]
        [--base DIR]

It copies ``gpquad_torch/csrc`` into ``build/type1_2d_f64_ablation/
<variant>/`` and builds ``nufft_2d.cu`` there, one ``nvcc`` a variant, all
started together:

- ``full``: the kernel as it is;
- ``no_phases``: the producers' phase factors (phase<double>: the torus
  fold, the compensated u k, sincospi) replaced by a product and a sum;
- ``no_fill``: no stage filled by the producers (the consumers' DMMA on
  whatever the stage buffers hold, the hand-offs and the sums' stores:
  the consumers' pipeline alone);
- ``no_mma``: no k-step run by the consumers (the producers' whole work,
  the hand-offs, the sums' stores);
- ``base``, with ``--base DIR``: ``DIR/gpquad_torch/csrc/nufft_2d.cu``
  as it is, another checkout (for example the parent commit unpacked with
  ``git archive`` into ``build/parent``), whose float64 d=2 type-1 is an
  FP64 tensor-core kernel that takes the same geometry
  (``gpq_nufft1_2d_f64(x, v, h, n, m, fft_order, rows, cols, group, run,
  chunk, partial, out, stream)``, the batched one with ``nb`` after
  ``m``), launched at the pick; the script says whether it gives the bits
  of ``full`` there.

``--shapes phase3`` takes every float64 d=2 type-1 shape that
chip_smoke.py phase 3 runs.  The answers of the variants but ``full`` and
``base`` are wrong by design; ``full`` and ``base`` are held within 1e-12
of max|ref| of the float64 plain version (``nufft1_2d_batched_ref`` on
the card).  At each shape it also launches ``full`` with the other
tile width (32 or 64 columns) and with point groups of half and twice the
picked chunk.  Times are the card's (it sleeps first, so that the host
enqueues ahead; the variants in turn each of 5 rounds, medians), each with
the shape's FP64 tensor-core rate on the padded tiles; it prints the
card's name and power limit.  It needs a CUDA device.

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

OUT = ROOT / "build" / "type1_2d_f64_ablation"
CSRC = ROOT / "gpquad_torch" / "csrc"
# (file, the text there, what replaces it)
PHASES = ("tc_type1_f64.cuh",
          "    phase(tb.u[d.x][q], (double)d.y, &c, &sn);",
          "    c = tb.u[d.x][q] * d.y; sn = c + 1.0;")
FILL = ("tc_type1_f64.cuh",
        "        t64_fill<P, G, COLS>(stages[s & 1], tb, ptid, pt, x, v,",
        "        if (0) t64_fill<P, G, COLS>(stages[s & 1], tb, ptid, pt, "
        "x, v,")
KSTEPS = ("tc_type1_f64.cuh", "for (int ks = 0; ks < T64_P; ks += 8) {",
          "for (int ks = 0; ks < 0; ks += 8) {")
VARIANTS = {"full": (), "no_phases": (PHASES,), "no_fill": (FILL,),
            "no_mma": (KSTEPS,)}
# (n, mtot, B, what): the float64 type-1 calls of chip_smoke.py phase 12
# (headline, hard, Matern, scale) and phase 13 (PG)
SHAPES = {"scale": [(1_000_000, 339, 1, "scale F*y"),
                    (1_000_000, 677, 1, "scale lag table")],
          "driven": [(100_000, 29, 1, "headline F*y"),
                     (100_000, 107, 1, "hard F*y"),
                     (100_000, 213, 1, "hard lag table"),
                     (100_000, 107, 10, "hard F*Z"),
                     (20_000, 93, 1, "matern F*y"),
                     (100_000, 21, 10, "PG F*Z"),
                     (24_010, 43, 10, "spatial F*Z")]}
SHAPES["all"] = SHAPES["driven"] + SHAPES["scale"]
# chip_smoke.py phase 3's float64 d=2 type-1 rows: the headline, hard,
# Matern and scale calls, the B 10 probe batches, PG's batches (B 10 and
# 11) and single calls
SHAPES["phase3"] = (
    [(100_000, m, 1, "headline / hard") for m in (29, 57, 107, 213)]
    + [(20_000, m, 1, "matern") for m in (93, 185)] + SHAPES["scale"]
    + [(100_000, 29, 10, "headline F*Z"), (100_000, 107, 10, "hard F*Z"),
       (20_000, 93, 10, "matern F*Z")]
    + [(n, m, B, "PG F*Z") for n, m in ((100_000, 17), (100_000, 21),
                                         (24_010, 43)) for B in (10, 11)]
    + [(n, m, 1, "PG") for n, m in ((20_000, 15), (20_000, 29),
                                     (20_000, 57), (24_010, 43),
                                     (24_010, 85), (100_000, 17),
                                     (100_000, 21), (100_000, 33),
                                     (100_000, 41))])
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


def build_variants(nvcc, base=None):
    """One shared library of nufft_2d.cu per variant (and of ``base``'s
    own where given), compiled in parallel; returns {name: (single,
    batched) ctypes functions} and prints each variant's registers and
    spills."""
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
             str(d / "nufft_2d.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if base is not None:
        (OUT / "base").mkdir(parents=True, exist_ok=True)
        procs["base"] = subprocess.Popen(
            [nvcc, *cn.NVCC_FLAGS, "-shared", "-o",
             str(OUT / "base" / "lib.so"),
             str(base / "gpquad_torch" / "csrc" / "nufft_2d.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "type1_f64_kernel" in line:
                inst = line.split("type1_f64_kernel")[1][:12]
                print(name, inst, " ".join(
                    ln.split(":", 1)[-1].strip() for ln in lines[i + 1:i + 3]))
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        single, batched = lib.gpq_nufft1_2d_f64, lib.gpq_nufft1_2d_batched_f64
        # (n, m, fft_order, then the geometry: rows, cols, group, run,
        # chunk)
        single.argtypes = [ptr, ptr, ctypes.c_double, *[i32] * 8, ptr, ptr,
                           ptr]
        batched.argtypes = [ptr, ptr, ctypes.c_double, *[i32] * 9, ptr, ptr,
                            ptr]
        single.restype = batched.restype = i32
        fns[name] = (single, batched)
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", choices=sorted(SHAPES), default="all")
    ap.add_argument("--base", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_type1_2d_f64.py needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    base = args.base.resolve() if args.base is not None else None
    fns = build_variants(cn._nvcc(), base)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for n, m, B, what in SHAPES[args.shapes]:
        h = 0.97 if m > 300 else 0.65
        x = torch.as_tensor(rng.uniform(0, 1, (n, 2)), device=dev)
        V = torch.as_tensor(rng.normal(size=(B, n)) + 1j * rng.normal(
            size=(B, n)), device=dev)
        batched = B > 1
        pick = cn.type1_2d_geometry(n, m, B, batched, torch.float64)
        ref = cn.nufft1_2d_batched_ref(x, V, h, mtot=m)
        scale = float(ref.abs().max())
        geos = {"pick": pick}
        other = 64 if pick[1] == 32 else 32
        geos[f"cols{other}"] = pick[:1] + (other,) + pick[2:]
        for f, tag in ((0.5, "half"), (2, "twice")):
            chunk = max(pick[3], int(pick[4] * f) // pick[3] * pick[3])
            if chunk != pick[4]:
                geos[f"chunk_{tag}"] = pick[:4] + (chunk,)
        out = torch.empty((B, m, m), dtype=torch.complex128, device=dev)

        def launcher(fn, geo):
            groups = -(-n // geo[-1])
            part = torch.empty((groups, B, m, m), dtype=torch.complex128,
                               device=dev)
            lead = (n, m, B) if batched else (n, m)

            def call():
                rc = fn[batched](x.data_ptr(), V.data_ptr(), h, *lead, 0,
                                 *geo, part.data_ptr(), out.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"CUDA error {rc}")
            return call
        full = {k: (fns["full"], geo) for k, geo in geos.items()}
        if base is not None:
            full["base"] = (fns["base"], pick)
        calls, bits = {}, ""
        for k, (fn, geo) in full.items():
            calls[k] = launcher(fn, geo)
            calls[k]()
            if k == "pick":
                got = out.clone()
            elif k == "base":
                bits = f"; base's bits: {torch.equal(out, got)}"
            err = float((out - ref).abs().max()) / scale
            if err > 1e-12:
                print(f"{k} at n={n} m={m} B={B}: {err:.3e} of max|ref| from "
                      "the plain version", file=sys.stderr)
                return 1
        for name, fn in fns.items():
            if name not in ("full", "base"):
                calls[name] = launcher(fn, pick)
        reps = max(1, min(20, int(2e9 / (n * B * m * m))))
        ms = card_ms(calls, reps)
        rows = pick[0] // pick[2]
        padded = (B * n * 8 * (-(-m // rows) * rows) * (-(-m // pick[1])
                                                        * pick[1]))
        print(f"{what} n={n} mtot={m} B={B} {pick}: "
              + ", ".join(f"{k} {t:.4f}" for k, t in ms.items())
              + f" ms; pick at {padded / ms['pick'] / 1e9:.1f} TFLOP/s on "
              f"the padded tiles{bits} [{smi}]", flush=True)
        del x, V, ref, out, calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
