"""Time the float64 d=3 type-1 on the FP64 tensor cores (``nufft1_3d`` in
float64: ``type1_f64_kernel`` of ``csrc/tc_type1_f64.cuh`` on
``csrc/nufft_3d.cu``'s ``Type1F64Grid3D``) at chip_smoke.py phase 3's
float64 d=3 type-1 shapes, beside another checkout's float64 d=3 type-1
and the plain version, optionally taken apart.

    python scripts/time_type1_3d_f64.py [--shapes phase3|hard3d|all]
        [--base DIR] [--ablate] [--groups]

It copies ``gpquad_torch/csrc`` into ``build/type1_3d_f64_timer/
<variant>/`` and builds ``nufft_3d.cu`` there, one ``nvcc`` a variant,
all started together:

- ``full``: the kernel as it is;
- with ``--ablate``: ``no_phases``, the producers' phase factors
  (phase<double>: the torus fold, the compensated u k, sincospi) replaced
  by a product and a sum; ``no_fill``, no stage filled by the producers
  (the consumers' DMMA on whatever the stage buffers hold, the hand-offs
  and the sums' stores: the consumers' pipeline alone); ``no_mma``, no
  k-step run by the consumers (the producers' whole work, the hand-offs,
  the sums' stores);
- ``base``, with ``--base DIR``: ``DIR/gpquad_torch/csrc/nufft_3d.cu`` as
  it is, another checkout (for example the parent commit unpacked with
  ``git archive`` into ``build/parent``), whose float64 d=3 type-1 is the
  CUDA-core kernel before the FP64 tensor cores
  (``gpq_nufft1_3d_f64(x, v, h, n, m, nb, fft_order, chunk, groups,
  partial, out, stream)``, its groups as that checkout's
  ``type1_3d_groups`` counts them).

At each shape it also launches ``full`` with the other tile width (32 or
64 columns), with point groups of half and twice the picked chunk, and
with runs of 256 points; with ``--groups``, also with the point groups
that give about 1, 2, 3, 4, 6 and 8 waves of blocks on the card's
``cuda_nufft.CARD_SMS`` SMs (``g<groups>``, where the points allow).
``full``, its other geometries and ``base`` are
held within 1e-12 (``base`` 1e-10) of max|ref| of the float64 plain
version (``nufft1_3d_ref`` on the card), whose card time it prints beside
the FP64 tensor-core bound (chip_smoke.py ``bound_fp64_tc_ms``); the
answers of the ablation variants are wrong by design.  Times are the
card's (it sleeps first, so that the host enqueues ahead; the calls in
turn each of 5 rounds, medians), each with the pick's FP64 tensor-core
rate on the padded tiles; it prints the card's name and power limit.  It
needs a CUDA device.

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
from chip_smoke import bound_fp64_tc_ms  # noqa: E402
from gpquad_torch.ops import cuda_nufft as cn  # noqa: E402

OUT = ROOT / "build" / "type1_3d_f64_timer"
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
ABLATIONS = {"no_phases": (PHASES,), "no_fill": (FILL,),
             "no_mma": (KSTEPS,)}
# (n, mtot, B, h, what): chip_smoke.py phase 3's float64 d=3 type-1 rows
# (d3's and hard3d's F*y, lag table and gradient F*Z, the slab-tiled
# widths)
SHAPES = {"hard3d": [(20_000, 21, 1, "hard3d F*y"),
                     (20_000, 41, 1, "hard3d lag table"),
                     (20_000, 21, 10, "hard3d F*Z")]}
SHAPES["phase3"] = (
    [(100_000, 31, 1, "d3 F*y"), (100_000, 61, 1, "d3 lag table"),
     (100_000, 31, 10, "d3 F*Z")] + SHAPES["hard3d"]
    + [(20_000, m, 1, "slab-tiled mtot") for m in (57, 101, 255)])
SHAPES["all"] = SHAPES["phase3"]
SLEEP_CYCLES = 35_000_000
# the parent's CUDA-core kernel: its chunk, and blocks for its groups
# (ops/cuda_nufft.py TYPE1_CHUNK, TYPE1_3D_BLOCKS, type1_3d_groups there)
BASE_CHUNK, BASE_BLOCKS = 2048, 1056


def base_groups(n, m, B):
    blocks = (-(-m // 16)) ** 2 * -(-m // 8) * B
    nchunk = max(1, -(-n // BASE_CHUNK))
    groups = min(nchunk, max(1, -(-BASE_BLOCKS // blocks)))
    cpg = -(-nchunk // groups)
    return -(-nchunk // cpg)


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


def build_variants(nvcc, variants, base=None):
    """One shared library of nufft_3d.cu per variant (and of ``base``'s
    own where given), compiled in parallel; returns {name: ctypes
    function} and prints each variant's registers and spills."""
    procs = {}
    for name, hooks in variants.items():
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
    if base is not None:
        (OUT / "base").mkdir(parents=True, exist_ok=True)
        procs["base"] = subprocess.Popen(
            [nvcc, *cn.NVCC_FLAGS, "-shared", "-o",
             str(OUT / "base" / "lib.so"),
             str(base / "gpquad_torch" / "csrc" / "nufft_3d.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and (
                    "type1_f64_kernel" in line
                    or ("nufft1_3d_partial_kernel" in line and "Ed" in line)):
                print(name, line.split("'")[1][:60], " ".join(
                    ln.split(":", 1)[-1].strip() for ln in lines[i + 1:i + 3]))
        fn = ctypes.CDLL(str(OUT / name / "lib.so")).gpq_nufft1_3d_f64
        # (n, m, nb, fft_order, then the geometry: chunk and groups in
        # base's)
        fn.argtypes = [ptr, ptr, ctypes.c_double,
                       *[i32] * (4 + (2 if name == "base" else 6)), ptr, ptr,
                       ptr]
        fn.restype = i32
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", choices=sorted(SHAPES), default="phase3")
    ap.add_argument("--base", type=Path)
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--groups", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_type1_3d_f64.py needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    base = args.base.resolve() if args.base is not None else None
    variants = {"full": (), **(ABLATIONS if args.ablate else {})}
    fns = build_variants(cn._nvcc(), variants, base)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for n, m, B, what in SHAPES[args.shapes]:
        h = 0.97 if what == "slab-tiled mtot" else 0.65
        x = torch.as_tensor(rng.uniform(0, 1, (n, 3)), device=dev)
        V = torch.as_tensor(rng.normal(size=(B, n)) + 1j * rng.normal(
            size=(B, n)), device=dev)
        pick = cn.type1_3d_geometry(n, m, B, torch.float64)[1:]
        ref = cn.nufft1_3d_ref(x, V, h, mtot=m)
        scale = float(ref.abs().max())
        geos = {"pick": pick}
        rows, cols, g, S, run, chunk = pick
        other = 64 if cols == 32 else 32
        S_other = cn.type1_3d_f64_split(m, rows // g, other)[0]
        geos[f"cols{other}"] = (rows, other, g, S_other, run, chunk)
        for f, tag in ((0.5, "half"), (2, "twice")):
            c = max(run, int(chunk * f) // run * run)
            if c != chunk:
                geos[f"chunk_{tag}"] = pick[:5] + (c,)
        geos["run256"] = pick[:4] + (256, max(256, chunk // 256 * 256))
        if args.groups:
            mi = max(m, cn.TYPE1_2D_F64_K)
            tiles = (-(-S * mi // (rows // g))
                     * -(-cn.type1_1d_split(m, S)[1] * mi // cols)
                     * -(-B // g))
            nrun = -(-n // run)
            for waves in (1, 2, 3, 4, 6, 8):
                groups = min(nrun, max(1, round(waves * cn.CARD_SMS
                                                / tiles)))
                c = -(-nrun // groups) * run
                if c not in [geo[-1] for geo in geos.values()]:
                    geos[f"g{-(-n // c)}"] = pick[:5] + (c,)
        out = torch.empty((B, m, m, m), dtype=torch.complex128, device=dev)

        def launcher(fn, geo, is_base=False):
            groups = (base_groups(n, m, B) if is_base
                      else -(-n // geo[-1]))
            part = torch.empty((groups, B, m, m, m), dtype=torch.complex128,
                               device=dev) if groups > 1 or is_base else out
            args_ = ((BASE_CHUNK, groups) if is_base else geo)

            def call():
                rc = fn(x.data_ptr(), V.data_ptr(), h, n, m, B, 0, *args_,
                        part.data_ptr(), out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"CUDA error {rc}")
            return call
        full = {k: (fns["full"], geo, False) for k, geo in geos.items()}
        if base is not None:
            full["base"] = (fns["base"], None, True)
        calls = {}
        for k, (fn, geo, is_base) in full.items():
            calls[k] = launcher(fn, geo, is_base)
            calls[k]()
            err = float((out - ref).abs().max()) / scale
            if err > (1e-10 if is_base else 1e-12):
                print(f"{k} {geo} at n={n} m={m} B={B}: {err:.3e} of "
                      "max|ref| from the plain version", file=sys.stderr)
                return 1
        for name, fn in fns.items():
            if name not in ("full", "base"):
                calls[name] = launcher(fn, pick)
        calls["plain"] = lambda: cn.nufft1_3d_ref(x, V, h, mtot=m)
        reps = max(1, min(20, int(2e10 / (n * B * m ** 3))))
        ms = card_ms(calls, reps)
        tj = rows // g
        mi = max(m, cn.TYPE1_2D_F64_K)
        Q = cn.type1_1d_split(m, S)[1]
        padded = (8 * B * n * -(-S * mi // tj) * tj
                  * -(-Q * mi // cols) * cols)
        bound = bound_fp64_tc_ms("nufft1_3d", n, m, B)[0]
        print(f"{what} n={n} mtot={m} B={B} {pick}: "
              + ", ".join(f"{k} {t:.4f}" for k, t in ms.items())
              + f" ms; bound_fp64_tc_ms {bound:.4f}; pick at "
              f"{padded / ms['pick'] / 1e9:.1f} TFLOP/s on the padded "
              f"tiles [{smi}]", flush=True)
        del x, V, ref, out, calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
