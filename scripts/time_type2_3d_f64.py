"""Time the float64 d=3 type-2 on the FP64 tensor cores (``nufft2_3d`` in
float64: ``type2_f64_kernel`` of ``csrc/tc_type2_f64.cuh`` on
``csrc/nufft_3d.cu``'s ``Type2F64Grid3D``) at chip_smoke.py phase 3's
float64 d=3 type-2 shapes, beside another checkout's float64 d=3 type-2
and the plain version, optionally taken apart.

    python scripts/time_type2_3d_f64.py [--shapes phase3|hard3d]
        [--base DIR] [--ablate] [--splits]

It copies ``gpquad_torch/csrc`` into ``build/type2_3d_f64_timer/
<variant>/`` and builds ``nufft_3d.cu`` there, one ``nvcc`` a variant,
all started together:

- ``full``: the kernel as it is;
- with ``--ablate``: ``no_phases``, every phase<double> of the kernel
  (the points' factors, the k-steps', e1's) replaced by a product and a
  sum; ``no_mma``, no k-step's DMMA; ``no_epilogue``, no pass's sums over
  j1 (the outputs are not written); ``no_chunk``, no chunk of A made (the
  DMMA on whatever the buffer holds);
- ``base``, with ``--base DIR``: ``DIR/gpquad_torch/csrc/nufft_3d.cu`` as
  it is, another checkout (for example the parent commit unpacked with
  ``git archive`` into ``build/parent``), whose float64 d=3 type-2 is the
  CUDA-core kernel before the FP64 tensor cores
  (``gpq_nufft2_3d_f64(x, f, h, n, m, nb, fft_order, out, stream)``).
  With ``--base`` it also builds ``nufft_2d.cu`` of this checkout and of
  ``DIR`` and says, at every float64 d=2 type-2 shape of
  ``scripts/time_type2_2d_f64.py``'s ``DRIVEN`` list (the calls of
  chip_smoke.py phases 3, 12, 13 and 14c), whether the FP64 tensor-core
  d=2 type-2, batched (``gpq_nufft2_2d_batched_tc_f64``) and single
  (``gpq_nufft2_2d_tc_f64``, the first vector), gives ``DIR``'s bits at
  ``type2_2d_geometry``'s float64 geometry, and the card's time of both
  checkouts' calls.

At each shape it also launches ``full`` with the other tile width (32 or
64 columns) and with one split, half and twice the picked splits; with
``--splits`` with every split count of 1-16 that the chunks allow.
``full``, its other geometries and ``base`` are held within 1e-12
(``base`` 1e-10) of max|ref| of the float64 plain version
(``nufft2_3d_ref`` on the card), whose card time it prints beside the
FP64 tensor-core bound (chip_smoke.py ``bound_fp64_tc_ms``); the answers
of the ablation variants are wrong by design.  Times are the card's (it
sleeps first, so that the host enqueues ahead; the calls in turn each of 5
rounds, medians), each with the pick's FP64 tensor-core rate on the padded
work; it prints the card's name and power limit.  It needs a CUDA device.

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
sys.path.insert(0, str(ROOT / "scripts"))
from chip_smoke import bound_fp64_tc_ms  # noqa: E402
from gpquad_torch.ops import cuda_nufft as cn  # noqa: E402
from time_type2_2d_f64 import DRIVEN as DRIVEN_2D  # noqa: E402

OUT = ROOT / "build" / "type2_3d_f64_timer"
CSRC = ROOT / "gpquad_torch" / "csrc"
FAKE = ("tc_type2_f64.cuh", "namespace {\n",
        "namespace {\n__device__ __forceinline__ void t2d_fake_phase("
        "double u, double k, double* c, double* s) { *c = u * k; "
        "*s = *c + 1.0; }\n")
# (file, the text there, what replaces it; every occurrence)
ABLATIONS = {
    "no_phases": (FAKE, ("tc_type2_f64.cuh", "phase(sm.u[",
                         "t2d_fake_phase(sm.u["),
                  ("nufft_3d.cu", "phase(sm.u[", "t2d_fake_phase(sm.u[")),
    "no_mma": (("tc_type2_f64.cuh", "        if (kk < kn)\n          t2d_kstep",
                "        if (kk < 0)\n          t2d_kstep"),),
    "no_epilogue": (("tc_type2_f64.cuh", "      if (p0 + ep < n) {",
                     "      if (ep < 0) {"),),
    "no_chunk": (("tc_type2_f64.cuh",
                  "if ((ks0 - kb) % KCH == 0 && (nchunks > 1 || ct == ct0))",
                  "if (ks0 < 0)"),),
}
# (n, mtot, B, FFT order, h, what): chip_smoke.py phase 3's float64 d=3
# type-2 rows (d3's and hard3d's mean, variance evaluation and gradient
# F(D beta) and F(D'F*Z), the slab-tiled widths)
SHAPES = {"hard3d": [(1_000, 21, 1, False, 0.65, "hard3d mean"),
                     (1_000, 41, 1, True, 0.65,
                      "hard3d variance evaluation"),
                     (20_000, 21, 1, False, 0.65, "hard3d F(D beta)"),
                     (20_000, 21, 10, False, 0.65, "hard3d F(D'F*Z)")]}
SHAPES["phase3"] = (
    [(10_000, 31, 1, False, 0.65, "d3 mean"),
     (10_000, 61, 1, True, 0.65, "d3 variance evaluation"),
     (100_000, 31, 1, False, 0.65, "d3 F(D beta)"),
     (100_000, 31, 10, False, 0.65, "d3 F(D'F*Z)")] + SHAPES["hard3d"]
    + [(20_000, m, 1, False, 0.97, "slab-tiled mtot") for m in (57, 101, 255)])
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


def build_variants(nvcc, variants, base=None):
    """One shared library a variant (nufft_3d.cu; with ``base`` also base's
    nufft_3d.cu, and this checkout's and base's nufft_2d.cu), compiled in
    parallel; returns {name: ctypes library} and prints each float64
    type-2 instance's registers and spills."""
    procs = {}

    def start(name, src):
        procs[name] = subprocess.Popen(
            [nvcc, *cn.NVCC_FLAGS, "-shared", "-o", str(OUT / name / "lib.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for name, hooks in variants.items():
        d = OUT / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(CSRC, d)
        for fname, old, new in hooks:
            text = (d / fname).read_text()
            if old not in text:
                raise RuntimeError(f"{name}: '{old}' is not in {fname}")
            (d / fname).write_text(
                text.replace(old, new, 1 if old == FAKE[1] else -1))
        start(name, d / "nufft_3d.cu")
    if base is not None:
        for name, root, src in (("base", base, "nufft_3d.cu"),
                                ("base2d", base, "nufft_2d.cu"),
                                ("full2d", ROOT, "nufft_2d.cu")):
            (OUT / name).mkdir(parents=True, exist_ok=True)
            start(name, root / "gpquad_torch" / "csrc" / src)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and (
                    "type2_f64_kernel" in line
                    or ("nufft2_3d_kernel" in line and "Ed" in line)):
                print(name, line.split("'")[1][:60], " ".join(
                    ln.split(":", 1)[-1].strip() for ln in lines[i + 1:i + 3]))
        libs[name] = ctypes.CDLL(str(OUT / name / "lib.so"))
    return libs


def type2_3d_fn(lib, is_base):
    """The library's float64 d=3 type-2: base's (n, m, nb, fft_order, then
    the output) or this one's (then the geometry and the scratch)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = lib.gpq_nufft2_3d_f64
    fn.argtypes = ([ptr, ptr, ctypes.c_double, *[i32] * 4, ptr, ptr]
                   if is_base else
                   [ptr, ptr, ctypes.c_double, *[i32] * 8, ptr,
                    ctypes.c_longlong, ptr, ptr])
    fn.restype = i32
    return fn


def d2_bits(libs, smi):
    """Whether this checkout's FP64 tensor-core d=2 type-2, batched and
    single, gives base's bits at every DRIVEN_2D shape, and the card's
    time of both; prints a line a shape and returns whether all agree."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name in ("full2d", "base2d"):
        b = libs[name].gpq_nufft2_2d_batched_tc_f64
        b.argtypes = [ptr, ptr, ctypes.c_double, *[i32] * 7, ptr,
                      ctypes.c_longlong, ptr, ptr]
        s = libs[name].gpq_nufft2_2d_tc_f64
        s.argtypes = [ptr, ptr, ctypes.c_double, *[i32] * 6, ptr,
                      ctypes.c_longlong, ptr, ptr]
        b.restype = s.restype = i32
        fns[name] = (b, s)
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    stream = torch.cuda.current_stream().cuda_stream
    same_all = True
    for n, m, B, fo, what in DRIVEN_2D:
        h = 0.97 if m > 300 else 0.65
        x = torch.as_tensor(rng.uniform(0, 1, (n, 2)), device=dev)
        F = torch.as_tensor(rng.normal(size=(B, m, m)) + 1j * rng.normal(
            size=(B, m, m)), device=dev)
        outs, calls = {}, {}
        for name, (batched, single) in fns.items():
            got = []
            for nb in (B, 1):
                geo = cn.type2_2d_geometry(m, torch.float64, nb)
                doubles = cn.type2_2d_f64_scratch_doubles(m, nb, geo)
                scratch = torch.empty(doubles, dtype=torch.float64,
                                      device=dev)
                out = torch.empty((nb, n), dtype=torch.complex128,
                                  device=dev)
                args = (x.data_ptr(), F.data_ptr(), h, n, m)
                tail = (int(fo), *geo[1:], scratch.data_ptr(), doubles,
                        out.data_ptr(), stream)

                def call(nb=nb, args=args, tail=tail, keep=scratch):
                    rc = (batched(*args, nb, *tail) if nb > 1
                          else single(*args, *tail))
                    if rc:
                        raise RuntimeError(f"{name}: CUDA error {rc}")
                call()
                calls[f"{name[:-2]} B{nb}"] = call
                got.append(out)
            outs[name] = got
        same = [torch.equal(a, b) for a, b in zip(outs["full2d"],
                                                  outs["base2d"])]
        same_all = same_all and all(same)
        ms = card_ms(calls, max(1, min(20, int(2e9 / (n * B * m * m)))))
        print(f"d=2 float64 type-2 {what} n={n} mtot={m} B={B} fft={fo}: "
              f"base's bits batched {same[0]}, single {same[1]}; "
              + ", ".join(f"{k} {t:.4f}" for k, t in ms.items())
              + f" ms [{smi}]", flush=True)
        del x, F, outs, calls
        torch.cuda.empty_cache()
    return same_all


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", choices=sorted(SHAPES), default="phase3")
    ap.add_argument("--base", type=Path)
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--splits", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_type2_3d_f64.py needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    base = args.base.resolve() if args.base is not None else None
    variants = {"full": (), **(ABLATIONS if args.ablate else {})}
    libs = build_variants(cn._nvcc(), variants, base)
    fns = {k: type2_3d_fn(lib, k == "base") for k, lib in libs.items()
           if not k.endswith("2d")}
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    for n, m, B, fo, h, what in SHAPES[args.shapes]:
        x = torch.as_tensor(rng.uniform(0, 1, (n, 3)), device=dev)
        F = torch.as_tensor(rng.normal(size=(B, m, m, m)) + 1j * rng.normal(
            size=(B, m, m, m)), device=dev)
        pick = cn.type2_3d_geometry(n, m, B, torch.float64)
        ref = cn.nufft2_3d_ref(x, F, h, mtot=m, fft_order=fo)
        scale = float(ref.abs().max())
        nch = -(-cn.type2_3d_f64_split(m)[1] // cn.TYPE2_3D_F64_CHUNK)

        def canonical(s):
            per = -(-nch // s)
            return -(-nch // per)
        geos = {"pick": pick,
                f"cols{96 - pick[2]}": pick[:2] + (96 - pick[2],) + pick[3:]}
        counts = (range(1, cn.TYPE2_3D_F64_MAX_SPLITS + 1) if args.splits
                  else (1, pick[4] // 2, 2 * pick[4]))
        for s in counts:
            s = canonical(max(1, min(s, cn.TYPE2_3D_F64_MAX_SPLITS, nch)))
            if s not in [g[4] for g in geos.values() if g[2] == pick[2]]:
                geos[f"s{s}"] = pick[:4] + (s,)
        out = torch.empty((B, n), dtype=torch.complex128, device=dev)
        scratch = torch.empty(max(cn.type2_3d_f64_scratch_doubles(
            n, m, B, g) for g in geos.values()), dtype=torch.float64,
            device=dev)

        def launcher(fn, geo):
            def call():
                rc = (fn(x.data_ptr(), F.data_ptr(), h, n, m, B, int(fo),
                         out.data_ptr(), stream) if geo is None else
                      fn(x.data_ptr(), F.data_ptr(), h, n, m, B, int(fo),
                         *geo[1:], scratch.data_ptr(), scratch.numel(),
                         out.data_ptr(), stream))
                if rc:
                    raise RuntimeError(f"CUDA error {rc}")
            return call
        full = {k: (fns["full"], geo) for k, geo in geos.items()}
        if base is not None:
            full["base"] = (fns["base"], None)
        calls = {}
        for k, (fn, geo) in full.items():
            calls[k] = launcher(fn, geo)
            calls[k]()
            err = float((out - ref).abs().max()) / scale
            if err > (1e-10 if geo is None else 1e-12):
                print(f"{k} {geo} at n={n} m={m} B={B}: {err:.3e} of "
                      "max|ref| from the plain version", file=sys.stderr)
                return 1
        for name, fn in fns.items():
            if name not in ("full", "base"):
                calls[name] = launcher(fn, pick)
        calls["plain"] = lambda: cn.nufft2_3d_ref(x, F, h, mtot=m,
                                                  fft_order=fo)
        reps = max(1, min(20, int(2e10 / (n * B * m ** 3))))
        ms = card_ms(calls, reps)
        J3, steps = cn.type2_3d_f64_split(m)
        padded = 8 * n * 8 * steps * -(-B * m // pick[2]) * pick[2]
        bound = bound_fp64_tc_ms("nufft2_3d", n, m, B)[0]
        beats = ("below" if ms["pick"] < ms["plain"] else "not below")
        print(f"{what} n={n} mtot={m} B={B} fft={fo} {pick}: "
              + ", ".join(f"{k} {t:.4f}" for k, t in ms.items())
              + f" ms; bound_fp64_tc_ms {bound:.4f} ({bound / ms['pick']:.1%}"
              f" of it); pick at {padded / ms['pick'] / 1e9:.1f} TFLOP/s on "
              f"the padded work, {beats} the plain version [{smi}]",
              flush=True)
        del x, F, ref, out, scratch, calls
        torch.cuda.empty_cache()
    if base is not None and not d2_bits(libs, smi):
        print("the d=2 float64 type-2 does not give base's bits",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
