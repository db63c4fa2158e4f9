"""Time the float64 d=2 type-2 on the FP64 tensor cores (``nufft2_2d_batched``
and, where ``type2_2d_single_geometry`` sends it, ``nufft2_2d`` in float64:
``type2_f64_kernel`` of ``csrc/tc_type2_f64.cuh``) at the driven shapes,
beside the other paths of the same call and another checkout's kernels.

    python scripts/time_type2_2d_f64.py [--shapes driven|sweep|all]
        [--base DIR] [--ablate]

At each batched shape it times the new kernel at the picked column tile
and at the other width (32 or 64 columns), and with ``--base DIR`` the
float64 batched type-2 of ``DIR/gpquad_torch/csrc/nufft_2d.cu`` (for
example the parent commit unpacked with ``git archive`` into
``build/parent``, whose float64 batched type-2 is the CUDA-core kernel:
``gpq_nufft2_2d_batched_f64(x, f, h, n, m, nb, fft_order, out, stream)``),
built into ``build/type2_2d_f64_timer/`` by one ``nvcc`` started beside the
port's own build.  At each single shape it times every path of
``nufft2_2d`` in float64 (the FP64 tensor cores at both widths, the mode
split, the CUDA cores) and the picked one.  Each answer is held within
1e-12 of max|ref| of the float64 plain version (``nufft2_2d_batched_ref``
on the card).  Times are the card's (it sleeps first, so that the host
enqueues ahead; the paths in turn each of 5 rounds, medians), beside the
FP64 tensor-core rate on the padded work; it prints the card's name and
power limit.  ``--shapes sweep`` takes a grid of single calls (points x
mtot) for the single type-2's table.  With ``--ablate`` it also copies
``gpquad_torch/csrc`` into ``build/type2_2d_f64_timer/<variant>/`` and
builds ``nufft_2d.cu`` there (one ``nvcc`` a variant, all started
together), each with a part of the kernel taken out, and times them
beside it at the batched shapes: ``no_mma`` (no k-step's DMMA),
``no_epilogue`` (no pass's sums over j), ``no_mma_epilogue`` (neither),
``no_fcopy`` (no stage of F copied), ``no_phases`` (phase<double>
replaced by a product and a sum), whose answers are wrong by design;
``one_block`` (one block an SM, its registers unbounded) and
``no_s1_table`` (e1's factors e(u1, 8 s - half) made in the epilogue at
every mtot), whose answers are right.  It needs a CUDA device.

It is a tool for work on the kernel, not a check: nothing on the main
path, in the tests or in chip_smoke.py runs it.
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

OUT = ROOT / "build" / "type2_2d_f64_timer"
CSRC = ROOT / "gpquad_torch" / "csrc"
# (the text in tc_type2_f64.cuh, what replaces it; or (file, text, what
# replaces it) for another source)
VARIANTS = {
    "no_mma": [("        if (kk < kn)\n          t2d_kstep",
                "        if (kk < 0)\n          t2d_kstep")],
    "no_epilogue": [("      if (p0 + ep < n) {", "      if (ep < 0) {")],
    "no_fcopy": [("    cp_async16(&buf[0][0][0][0] + e, src + e);", "")],
    "no_mma_epilogue": [("        if (kk < kn)\n          t2d_kstep",
                         "        if (kk < 0)\n          t2d_kstep"),
                        ("      if (p0 + ep < n) {", "      if (ep < 0) {")],
    "one_block": [("__launch_bounds__(T2D_THREADS, 2)",
                   "__launch_bounds__(T2D_THREADS, 1)")],
    "no_s1_table": [("const bool s1_kept = nj <= T2D_S1;",
                     "const bool s1_kept = false;")],
    "no_phases": [("    phase(sm.u[c][p], k, cs, sn);",
                   "    t2d_fake_phase(sm.u[c][p], k, cs, sn);"),
                  ("nufft_2d.cu", "phase(sm.u[", "t2d_fake_phase(sm.u["),
                  ("namespace {\n", "namespace {\n__device__ __forceinline__ "
                   "void t2d_fake_phase(double u, double k, double* c, "
                   "double* s) { *c = u * k; *s = *c + 1.0; }\n")],
}
# (n, mtot, B, FFT order, what): the float64 type-2 calls of chip_smoke.py
# phases 3, 12, 13 and 14c; B 1 are the single calls
DRIVEN = [
    (100_000, 29, 10, False, "headline F(D'F*Z)"),
    (100_000, 107, 10, False, "hard F(D'F*Z)"),
    (100_000, 17, 11, False, "PG F(D'F*Z)"),
    (100_000, 21, 11, False, "PG / sampler F(D'F*Z)"),
    (24_010, 43, 11, False, "PG spatial F(D'F*Z)"),
    (10_000, 29, 1, False, "headline mean_high"),
    (10_000, 57, 1, True, "headline variance evaluation"),
    (100_000, 29, 1, False, "headline F(D beta)"),
    (2_000, 107, 1, False, "hard mean_high"),
    (100_000, 107, 1, False, "hard F(D beta)"),
    (1_000, 93, 1, False, "matern mean_high"),
    (500, 339, 1, False, "scale mean_high"),
    (2_000, 339, 1, False, "scale mean"),
    (1_000, 677, 1, True, "scale variance evaluation"),
    (1_000_000, 339, 1, False, "scale F(D beta)"),
    (128, 15, 1, False, "PG"), (128, 21, 1, False, "PG"),
    (128, 29, 1, False, "PG"), (2_000, 43, 1, False, "PG"),
    (10_000, 21, 1, False, "PG"), (10_000, 41, 1, True, "PG"),
    (100_000, 11, 1, False, "loader"),
]
SWEEP = [(n, m, 1, False, "sweep")
         for n in (1_000, 2_000, 4_000, 16_000, 32_000, 64_000, 128_000,
                   256_000)
         for m in (15, 17, 21, 29, 31, 33, 45, 63, 93, 107, 129, 151, 213,
                   339)]
SHAPES = {"driven": DRIVEN, "sweep": SWEEP, "all": DRIVEN + SWEEP}
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


def build_base(nvcc, base):
    """Start the port's build and base's nufft_2d.cu together; return base's
    float64 batched and single type-2 (CUDA cores) as ctypes functions."""
    OUT.mkdir(parents=True, exist_ok=True)
    lib_path = OUT / "base.so"
    proc = subprocess.Popen(
        [nvcc, *cn.NVCC_FLAGS, "-shared", "-o", str(lib_path),
         str(base / "gpquad_torch" / "csrc" / "nufft_2d.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cn.build()
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {base}:\n{log}")
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    batched, single = lib.gpq_nufft2_2d_batched_f64, lib.gpq_nufft2_2d_f64
    batched.argtypes = [ptr, ptr, ctypes.c_double, i32, i32, i32, i32, ptr,
                        ptr]
    single.argtypes = [ptr, ptr, ctypes.c_double, i32, i32, i32, ptr, ptr]
    batched.restype = single.restype = i32
    return batched, single


def build_variants(nvcc):
    """One library of nufft_2d.cu a variant, compiled in parallel; returns
    {name: the float64 batched type-2's ctypes function}."""
    procs = {}
    for name, hooks in VARIANTS.items():
        d = OUT / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(CSRC, d)
        for hook in hooks:
            fname, old, new = (hook if len(hook) == 3
                               else ("tc_type2_f64.cuh", *hook))
            path = d / fname
            text = path.read_text()
            if old not in text:
                raise RuntimeError(f"{name}: '{old}' is not in {path.name}")
            path.write_text(text.replace(old, new))
        procs[name] = subprocess.Popen(
            [nvcc, *cn.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "nufft_2d.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        fn = lib.gpq_nufft2_2d_batched_tc_f64
        fn.argtypes = [ptr, ptr, ctypes.c_double, *[i32] * 7, ptr,
                       ctypes.c_longlong, ptr, ptr]
        fn.restype = i32
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", choices=sorted(SHAPES), default="driven")
    ap.add_argument("--base", type=Path)
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_type2_2d_f64.py needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    base = (build_base(cn._nvcc(), args.base.resolve())
            if args.base is not None else None)
    variants = build_variants(cn._nvcc()) if args.ablate else {}
    cn.build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for n, m, B, fo, what in SHAPES[args.shapes]:
        h = 0.97 if m > 300 else 0.65
        x = torch.as_tensor(rng.uniform(0, 1, (n, 2)), device=dev)
        F = torch.as_tensor(rng.normal(size=(B, m, m)) + 1j * rng.normal(
            size=(B, m, m)), device=dev)
        ref = cn.nufft2_2d_batched_ref(x, F, h, mtot=m, fft_order=fo)
        scale = float(ref.abs().max())
        pick_tc = cn.type2_2d_geometry(m, torch.float64, B)
        other = pick_tc[:2] + (96 - pick_tc[2],) + pick_tc[3:]
        out = torch.empty((B, n), dtype=torch.complex128, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        if B > 1:
            calls = {
                f"tc{g[2]}": (lambda g=g: cn._nufft2_2d_batched_on(
                    x, F, h, m, fo, g)) for g in (pick_tc, other)}
            pick = f"tc{pick_tc[2]}"
            if base is not None:
                def base_call():
                    rc = base[0](x.data_ptr(), F.data_ptr(), h, n, m, B,
                                 int(fo), out.data_ptr(), stream)
                    if rc:
                        raise RuntimeError(f"CUDA error {rc}")
                    return out
                calls["base"] = base_call
            doubles = cn.type2_2d_f64_scratch_doubles(m, B, pick_tc)
            scratch = torch.empty(doubles, dtype=torch.float64, device=dev)
            ablated = {}
            for name, fn in variants.items():
                def var_call(fn=fn):
                    rc = fn(x.data_ptr(), F.data_ptr(), h, n, m, B, int(fo),
                            *pick_tc[1:], scratch.data_ptr(), doubles,
                            out.data_ptr(), stream)
                    if rc:
                        raise RuntimeError(f"CUDA error {rc}")
                    return out
                ablated[name] = var_call
        else:
            ablated = {}
            f = F[0]
            geos = {f"tc{pick_tc[2]}": pick_tc, f"tc{other[2]}": other,
                    "split": ("split", cn.TYPE2_2D_SPLIT_ROWS,
                              cn.TYPE2_2D_SPLIT_THREADS),
                    "cuda": ("cuda",)}
            calls = {k: (lambda g=g: cn._nufft2_2d_on(x, f, h, m, fo, g)[None])
                     for k, g in geos.items()}
            sg = cn.type2_2d_single_geometry(n, m, torch.float64)
            pick = next(k for k, g in geos.items() if g == sg)
            if base is not None:
                def base_call():
                    rc = base[1](x.data_ptr(), f.data_ptr(), h, n, m,
                                 int(fo), out.data_ptr(), stream)
                    if rc:
                        raise RuntimeError(f"CUDA error {rc}")
                    return out
                calls["base"] = base_call
        for k, call in calls.items():
            got = call()
            err = float((got - ref).abs().max()) / scale
            if not err <= 1e-12:
                print(f"{k} at n={n} m={m} B={B}: {err:.3e} of max|ref| from "
                      "the plain version", file=sys.stderr)
                return 1
        reps = max(1, min(20, int(2e9 / (n * B * m * m))))
        ms = card_ms({**calls, **ablated}, reps)
        kq = -(-m // 8) * 8
        padded = 8 * n * kq * -(-B * m // pick_tc[2]) * pick_tc[2]
        best = min(ms, key=ms.get)
        print(f"{what} n={n} mtot={m} B={B} fft={fo}: "
              + ", ".join(f"{k} {t:.4f}" for k, t in ms.items())
              + f" ms; pick {pick} (fastest {best}); tc{pick_tc[2]} at "
              f"{padded / ms[f'tc{pick_tc[2]}'] / 1e9:.1f} TFLOP/s on the "
              f"padded work [{smi}]", flush=True)
        del x, F, ref, out, calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
