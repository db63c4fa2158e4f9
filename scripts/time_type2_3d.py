"""Time the float32 d=3 type-2 on the tensor cores (``nufft2_3d``'s
``type2_tc_kernel`` of ``csrc/tc_type2.cuh`` on ``nufft_3d.cu``'s
``Type2Grid3D``) at the driven shapes, taken apart, beside the CUDA-core
kernel, and sweep the dispatch's boundary.

    python scripts/time_type2_3d.py [--shapes driven|all|none] [--sweep]

It copies ``gpquad_torch/csrc`` into ``build/type2_3d_ablation/<variant>/``
and builds ``nufft_3d.cu`` there, one ``nvcc`` a variant, all started
together:

- ``full``: the kernel as it is;
- ``no_outer_phases``: the outer phases (e2, one a stage and point)
  replaced by a product;
- ``no_phases``: every phase (e2, e3 and the epilogue's e1) replaced
  likewise (the phase products, the splits, the stores and the sums stay);
- ``no_mma``: no k-step's products (what is left: the F copies, the phases
  and stores, the barriers, the epilogue).

The answers of the variants but ``full`` are wrong by design; ``full`` is
held within 1e-5 of max|ref| against the CUDA-core kernel of the library
build.  At each shape it also launches ``full`` with the other tile width
(32 or 64 columns (vector, j1)) and with the stages in one run (no split)
and in the split count the geometry picks, and prints each shape's work a
stage and thread.  ``--sweep`` times the picked geometry against the CUDA
cores at mtot 21-33 for 20 000 points at B 1 and 10 and 100 000 at B 1,
at mtot 41-63 for 10 000 and 20 000 points at B 1, and at the widths the
table's padding rule sends to the CUDA cores past 33 (mtot 35-47 and
65-71) for 20 000 points at B 10 and 100 000 at B 1.
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

OUT = ROOT / "build" / "type2_3d_ablation"
CSRC = ROOT / "gpquad_torch" / "csrc"
CHEAP = "*c = {u} * kv; *s = *c + 1.f;"
# (file, the text there, what replaces it)
OUTER = ("nufft_3d.cu", "    phase(u2, kv, c, s);", CHEAP.format(u="u2"))
INNER = ("nufft_3d.cu", "    phase(u3, kv, c, s);", CHEAP.format(u="u3"))
EPI = ("nufft_3d.cu",
       "    phase(u1, mode_value<float>(j, m, fft_order), c, s);",
       "    *c = u1 * j; *s = *c + 1.f;")
MMA = ("tc_type2.cuh",
       "  t2c_products<NT, NKS>(sm, buf, acc, lane, wr, wc, gq, tq);", "")
VARIANTS = {"full": (), "no_outer_phases": (OUTER,),
            "no_phases": (OUTER, INNER, EPI), "no_mma": (MMA,)}
# (n, mtot, B, fft_order, what): chip_smoke.py phase 6's and 7's type-2
# calls (the mean, the variance evaluation, F(D beta) and the probe
# batches), then the slab-tiled widths
SHAPES = {"driven": [(10_000, 31, 1, False, "d3 mean"),
                     (10_000, 61, 1, True, "d3 variance evaluation"),
                     (100_000, 31, 1, False, "d3 F(D beta)"),
                     (100_000, 31, 10, False, "d3 F(D'F*Z)"),
                     (1_000, 21, 1, False, "hard3d mean"),
                     (1_000, 41, 1, True, "hard3d variance evaluation"),
                     (20_000, 21, 1, False, "hard3d F(D beta)"),
                     (20_000, 21, 10, False, "hard3d F(D'F*Z)")]}
SHAPES["all"] = SHAPES["driven"] + [(20_000, m, 1, False, "slab-tiled")
                                    for m in (57, 101, 255)]
SHAPES["none"] = []
SWEEP = ([(n, m, B) for m in range(21, 34, 2)
          for n, B in ((20_000, 1), (20_000, 10), (100_000, 1))]
         + [(n, m, 1) for m in range(41, 64, 2) for n in (10_000, 20_000)]
         + [(n, m, B) for m in (*range(35, 48, 2), *range(65, 72, 2))
            for n, B in ((20_000, 10), (100_000, 1))])
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
    returns {name: the ctypes function gpq_nufft2_3d_tc_f32} and prints
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
            if "Compiling entry" in line and "Type2Grid3DE" in line \
                    and "tc_kernel" in line:
                inst = line.split("Type2Grid3DE")[1][:6]
                print(name, inst, " ".join(
                    ln.split(":", 1)[-1].strip() for ln in lines[i + 1:i + 3]))
        fn = ctypes.CDLL(str(OUT / name / "lib.so")).gpq_nufft2_3d_tc_f32
        fn.argtypes = [ptr, ptr, ctypes.c_float, *[i32] * 8, ptr,
                       ctypes.c_longlong, ptr, ptr]
        fn.restype = i32
        fns[name] = fn
    return fns


def stage_counts(geo, m, B):
    """Per stage and thread (512 of them, 128 points a block): the phases
    and phase products made for eA (two outer phases and eight products;
    the inner phases once a run of m stages), the k-step products a warp
    (12 mma a k-step and n-tile) and the column tiles a block walks."""
    _, _, cols, _, _ = geo
    tiles = -(-B * (-(-m // 32) * 32) // cols)
    return 2 + 8 / m, 4 * (cols // 16) * 12, tiles


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", choices=sorted(SHAPES), default="driven")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_type2_3d.py needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    fns = build_variants(cn._nvcc())
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    h = float(np.float32(0.2))
    for n, m, B, fo, what in SHAPES[args.shapes]:
        x = torch.as_tensor(rng.uniform(0, 1, (n, 3)), device=dev).float()
        f = torch.as_tensor(rng.normal(size=(B, m ** 3)) + 1j * rng.normal(
            size=(B, m ** 3)), device=dev).to(torch.complex64)
        pick = cn.type2_3d_tc_geometry(n, m, B)
        ref = cn._nufft2_3d_on(x, f, h, m, fo, ("cuda",))
        scale = float(ref.abs().max())
        other = 64 if pick[2] == 32 else 32
        geos = {"pick": pick, f"cols{other}": pick[:2] + (other,) + pick[3:]}
        if pick[4] > 1:
            geos["no_split"] = pick[:4] + (1,)
        out = torch.empty((B, n), dtype=torch.complex64, device=dev)

        def launcher(fn, geo):
            floats = cn.type2_3d_scratch_floats(n, m, B, geo)
            scratch = torch.empty(floats, dtype=torch.float32, device=dev)

            def call():
                rc = fn(x.data_ptr(), f.data_ptr(), h, n, m, B, int(fo),
                        *geo[1:], scratch.data_ptr(), floats, out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"CUDA error {rc}")
            return call
        calls = {"cuda_cores": lambda: cn._nufft2_3d_on(x, f, h, m, fo,
                                                        ("cuda",))}
        for k, geo in geos.items():
            calls[k] = launcher(fns["full"], geo)
            calls[k]()
            err = float((out - ref).abs().max()) / scale
            if err > 1e-5:
                print(f"{k} at n={n} m={m} B={B}: {err:.3e} of max|ref| from "
                      "the CUDA cores", file=sys.stderr)
                return 1
        for name, fn in fns.items():
            if name != "full":
                calls[name] = launcher(fn, pick)
        reps = max(1, min(20, int(3e10 / (n * B * m ** 3))))
        ms = card_ms(calls, reps)
        phases, mma, tiles = stage_counts(pick, m, B)
        print(f"{what} n={n} mtot={m} B={B} tensor cores {pick}: per stage "
              f"and thread {phases:.2f} phases, {mma} mma a warp, {tiles} "
              "column tiles a block; "
              + ", ".join(f"{k} {t:.4f}" for k, t in ms.items())
              + f" ms [{smi}]", flush=True)
        del x, f, ref, out, calls
        torch.cuda.empty_cache()
    if args.sweep:
        for n, m, B in SWEEP:
            x = torch.as_tensor(rng.uniform(0, 1, (n, 3)), device=dev).float()
            f = torch.as_tensor(rng.normal(size=(B, m ** 3)), device=dev).to(
                torch.complex64)
            pick = cn.type2_3d_tc_geometry(n, m, B)
            ms = card_ms({
                "tc": lambda: cn._nufft2_3d_on(x, f, h, m, False, pick),
                "cuda": lambda: cn._nufft2_3d_on(x, f, h, m, False,
                                                 ("cuda",))},
                max(1, min(20, int(3e10 / (n * B * m ** 3)))))
            print(f"sweep n={n} mtot={m} B={B} dispatch "
                  f"{cn.type2_3d_geometry(n, m, B)[0]} tensor cores {pick} "
                  f"{ms['tc']:.4f} CUDA cores {ms['cuda']:.4f} ms "
                  f"(tc/cuda {ms['tc'] / ms['cuda']:.3f}) [{smi}]",
                  flush=True)
            del x, f
    return 0


if __name__ == "__main__":
    sys.exit(main())
