"""Time the float64 d=1 pair on the FP64 tensor cores (``nufft1_1d`` and
``nufft2_1d`` in float64: ``type1_f64_kernel`` of ``csrc/tc_type1_f64.cuh``
on ``csrc/nufft_1d.cu``'s ``Type1F64Split1D``, ``type2_f64_kernel`` of
``csrc/tc_type2_f64.cuh`` on ``Type2F64Split1D``) at the float64 d=1 shapes
the driven paths launch, beside another checkout's float64 d=1 pair and the
plain version.

    python scripts/time_nufft_1d_f64.py [--base DIR] [--shapes driven|all]

``--base DIR`` names another checkout (for example the parent commit
unpacked with ``git archive`` into ``build/parent``), whose
``gpquad_torch/csrc/nufft_1d.cu``, ``nufft_2d.cu`` and ``nufft_3d.cu`` it
builds into one library under ``build/nufft_1d_f64_timer/`` (one ``nvcc``
started beside the port's own build).  Its float64 d=1 pair is the
CUDA-core template at ``T = double`` (``gpq_nufft1_1d_f64(x, v, h, n, m,
nb, fft_order, chunk, partial, out, stream)``, 2048-point chunks, and
``gpq_nufft2_1d_f64(x, f, h, n, m, nb, fft_order, out, stream)``).  With
``--base`` it also says, at every float64 d=2 and d=3 shape of the driven
paths (chip_smoke.py phases 3, 12, 13, 14c and 16: the type-1, single and
batched, and the type-2, batched and single, whose kernels share the two
headers with the d=1 pair), whether this checkout's wrapper gives DIR's
bits on the same inputs, DIR's library called with this checkout's
geometry (the same at d=2 and d=3).

The shapes (``driven``): phase 12f's (the light curve's high tier: the
type-1 at n 63 480 x 919 and 1 837 and at B 10, the type-2 at 5 000 x 919),
14c's (the samplers': 7-120 points at B up to 30 000) and phase 3's
float64 d=1 rows (the light curve's rung 1 031 and lag grid 2 061, mtot
8 191); ``all`` adds a few between them.  At each it runs the FP64
tensor cores' geometry (``type1_1d_f64_tc_geometry`` /
``type2_1d_f64_tc_geometry``; it names the path the dispatch picks there)
and, for the type-1, the other tile width; each answer is held
within 1e-10 of max|ref| of the float64 plain version (``nufft1_1d_ref`` /
``nufft2_1d_ref`` on the card), the FP64 tensor cores also within 1e-12 of
their plain twin (``nufft1_1d_f64_tc_ref`` / ``nufft2_1d_f64_tc_ref``, on
the card, up to 25 000 points) and bit for bit on a second launch.  Times
are the card's (it sleeps first, so that the host enqueues ahead; the calls
in turn each of 5 rounds, medians), beside the FP64 tensor-core bound and
the CUDA cores' (chip_smoke.py ``bound_fp64_tc_ms`` and ``bound_ms``); it
prints the card's name and power limit.  It needs a CUDA device.

It is a tool for work on the kernels, not a check: nothing on the main
path, in the tests or in chip_smoke.py runs it.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import gpquad_torch  # noqa: E402
from chip_smoke import (bound_fp64_tc_ms, bound_ms, fp64_tc_split,  # noqa
                         lightcurve_data)
from gpquad_torch.ops import cuda_nufft as cn  # noqa: E402

OUT = ROOT / "build" / "nufft_1d_f64_timer"
F64 = torch.float64
SLEEP_CYCLES = 35_000_000
TWIN_MAX_N = 25_000
# (kind, n, mtot, B, FFT order, what); n 63 480 is the light curve's
# cadence (its points), the rest uniform in [0, 1] with h the light curve's
# grid (0.97 at mtot 8 191, phase 3's), but the samplers' (14c) in [-1, 1]
# with chip_smoke.py shape_table's h 0.4
LC_N = 63_480
SHAPES = {"driven": [
    (1, LC_N, 919, 1, False, "12f F*y"),
    (1, LC_N, 919, 10, False, "12f gradient_high F*Z"),
    (1, LC_N, 1837, 1, False, "12f lag table"),
    (2, 5_000, 919, 1, False, "12f mean_high"),
    (1, 120, 17, 1, False, "14c"), (1, 120, 17, 4000, False, "14c"),
    (1, 120, 33, 1, False, "14c"),
    (2, 7, 17, 1, False, "14c"), (2, 7, 17, 4000, False, "14c"),
    (2, 25, 15, 30000, False, "14c"), (2, 120, 17, 4000, False, "14c"),
    (1, LC_N, 1031, 1, False, "phase 3 light curve F*y"),
    (1, LC_N, 2061, 1, False, "phase 3 light curve lag table"),
    (1, LC_N, 1031, 10, False, "phase 3 light curve F*Z"),
    (1, 20_000, 8191, 1, False, "phase 3 mtot 8191"),
    (2, 5_000, 1031, 1, False, "phase 3 light curve mean"),
    (2, 5_000, 2061, 1, True, "phase 3 light curve variance evaluation"),
    (2, LC_N, 1031, 1, False, "phase 3 light curve F(D beta)"),
    (2, LC_N, 1031, 10, False, "phase 3 light curve F(D'F*Z)"),
    (2, 20_000, 8191, 1, False, "phase 3 mtot 8191")]}
SHAPES["all"] = SHAPES["driven"] + [
    (kind, n, m, B, False, "between")
    for kind in (1, 2) for n, m, B in ((1_000, 119, 1), (16_000, 301, 1),
                                       (2_000, 17, 512), (400, 65, 64))]
# the float64 d=2 / d=3 calls of the driven paths: (function, n, mtot, B,
# FFT order)
D23 = ([("nufft1_2d", 100_000, m, 1, False) for m in (29, 57, 107, 213)]
       + [("nufft1_2d", 20_000, m, 1, False) for m in (93, 185)]
       + [("nufft1_2d", 1_000_000, m, 1, False) for m in (339, 677)]
       + [("nufft1_2d", 100_000, m, 1, False) for m in (17, 21, 33, 41)]
       + [("nufft1_2d", 20_000, m, 1, False) for m in (15, 29, 57)]
       + [("nufft1_2d", 24_010, m, 1, False) for m in (43, 85)]
       + [("nufft1_2d_batched", n, m, B, False)
          for n, m, B in ((100_000, 29, 10), (100_000, 107, 10),
                          (20_000, 93, 10), (100_000, 17, 10),
                          (100_000, 17, 11), (100_000, 21, 10),
                          (100_000, 21, 11), (24_010, 43, 10),
                          (24_010, 43, 11))]
       + [("nufft2_2d_batched", n, m, B, False)
          for n, m, B in ((100_000, 29, 10), (100_000, 107, 10),
                          (100_000, 17, 11), (100_000, 21, 11),
                          (24_010, 43, 11))]
       + [("nufft2_2d", n, m, 1, fo)
          for n, m, fo in ((10_000, 29, False), (10_000, 57, True),
                           (100_000, 29, False), (2_000, 107, False),
                           (100_000, 107, False), (1_000, 93, False),
                           (500, 339, False), (2_000, 339, False),
                           (1_000, 677, True), (128, 15, False),
                           (128, 21, False), (128, 29, False),
                           (2_000, 43, False), (10_000, 21, False),
                           (10_000, 41, True), (100_000, 11, False))]
       + [("nufft1_3d", n, m, B, False)
          for n, m, B in ((20_000, 21, 1), (20_000, 41, 1), (20_000, 21, 10),
                          (100_000, 31, 1), (100_000, 61, 1),
                          (100_000, 31, 10))]
       + [("nufft2_3d", n, m, B, fo)
          for n, m, B, fo in ((1_000, 21, 1, False), (1_000, 41, 1, True),
                              (20_000, 21, 1, False), (20_000, 21, 10, False),
                              (10_000, 31, 1, False), (10_000, 61, 1, True),
                              (100_000, 31, 1, False),
                              (100_000, 31, 10, False))])
# the base's d=1 CUDA-core pair, which this checkout may no longer hold
BASE_D1 = {"gpq_nufft1_1d_f64": 5, "gpq_nufft2_1d_f64": 4}


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


class BaseLibrary:
    """Another checkout's library, its functions typed as this checkout's
    of the same name (the base's d=1 CUDA-core pair as BASE_D1 says), so
    that the wrappers of cuda_nufft launch it when it stands in for
    ``cuda_nufft._lib``."""

    def __init__(self, path, like):
        self._lib, self._like = ctypes.CDLL(str(path)), like

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name in BASE_D1:
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            tail = [ptr, ptr, ptr] if name.startswith("gpq_nufft1") \
                else [ptr, ptr]
            fn.argtypes = [ptr, ptr, ctypes.c_double,
                           *[i32] * BASE_D1[name], *tail]
        else:
            fn.argtypes = getattr(self._like, name).argtypes
        fn.restype = ctypes.c_int
        return fn


def build_base(base):
    """Start base's build (its three NUFFT sources in one library) beside
    this checkout's; return the base's library path."""
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / "base.so"
    proc = subprocess.Popen(
        [cn._nvcc(), *cn.NVCC_FLAGS, "-shared", "-o", str(path),
         *(str(base / "gpquad_torch" / "csrc" / f"nufft_{d}d.cu")
           for d in (1, 2, 3))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _, log = cn.build()
    for line in log.splitlines():
        if "Compiling entry" in line and ("Split1D" in line):
            print("this:", line.strip()[:150])
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the base:\n{out}")
    return path


def d1_shape(kind, n, m, B, fo, what, h_lc, x_lc, base, smi, rng):
    """One float64 d=1 shape: the FP64 tensor cores' geometry (and the
    type-1's other tile width) held to the plain version, its twin and a
    second launch, timed beside the base's CUDA-core kernel and the plain
    version."""
    dev = torch.device("cuda")
    if n == LC_N:
        x, h = torch.as_tensor(x_lc[:, None], device=dev), h_lc
    elif what == "14c":
        x, h = torch.as_tensor(rng.uniform(-1, 1, (n, 1)), device=dev), 0.4
    else:
        x = torch.as_tensor(rng.uniform(0, 1, (n, 1)), device=dev)
        h = 0.97 if m == 8191 else h_lc
    shape = (B, n) if kind == 1 else (B, m)
    arg = torch.as_tensor(rng.normal(size=shape) + 1j * rng.normal(
        size=shape), device=dev)
    name = f"nufft{kind}_1d"
    plain = getattr(cn, f"{name}_ref")
    on = getattr(cn, f"_{name}_on")
    twin = getattr(cn, f"{name}_f64_tc_ref")
    ref = plain(x, arg, h, mtot=m, fft_order=fo)
    scale = float(ref.abs().max())
    pick = getattr(cn, f"type{kind}_1d_geometry")(n, m, B, F64)
    tc = getattr(cn, f"type{kind}_1d_f64_tc_geometry")(n, m, B)
    geos = {"tc": tc}
    if kind == 1:
        other = 96 - tc[2]
        S = cn.type1_1d_f64_split(m, tc[1] // tc[3], other)[0]
        geos[f"tc cols {other}"] = tc[:2] + (other, tc[3], S) + tc[5:]
    calls, rels = {}, {}
    for k, geo in geos.items():
        def call(geo=geo):
            return on(x, arg, h, m, fo, geo)
        o = call()
        rels[k] = float((o - ref).abs().max()) / scale
        if rels[k] > 1e-10 or not torch.equal(call(), o):
            raise RuntimeError(f"{what} {name} n={n} m={m} B={B} {geo}: "
                               f"{rels[k]:.3e} of max|ref|, or not the same "
                               "bits twice")
        if k == "tc" and n <= TWIN_MAX_N:
            tw = (twin(x, arg, h, mtot=m, fft_order=fo) if kind == 1 else
                  twin(x, arg, h, mtot=m, fft_order=fo, geometry=geo))
            diff = float((o - tw.reshape(o.shape)).abs().max()) / scale
            if diff > 1e-12:
                raise RuntimeError(f"{what} {name} n={n} m={m} B={B}: "
                                   f"{diff:.3e} of max|ref| from its twin")
            rels["twin"] = diff
        calls[k] = call
    if base is not None:
        cuda_geo = ("cuda", cn.TYPE1_CHUNK) if kind == 1 else ("cuda",)

        def base_call():
            cn._lib, keep = base, cn._lib
            try:
                return on(x, arg, h, m, fo, cuda_geo)
            finally:
                cn._lib = keep
        o = base_call()
        rels["base"] = float((o - ref).abs().max()) / scale
        if rels["base"] > 1e-10:
            raise RuntimeError(f"{what}: the base {rels['base']:.3e}")
        calls["base"] = base_call
    work = B * n * m
    reps = max(1, min(50, int(2e9 / work)))
    ms = card_ms(calls, reps, 5 if work < 2e9 else 3)
    # the plain version (past 50 ms a call at B in the thousands: one call)
    ms["plain"] = card_ms(
        {"plain": lambda: plain(x, arg, h, mtot=m, fft_order=fo)},
        1 if work > 1e6 else reps, 1 if work > 1e6 else 3)["plain"]
    b_tc = bound_fp64_tc_ms(name, n, m, B, fp64_tc_split(cn, name, n, m, B))[0]
    b_cc = bound_ms(name, n, m, F64, B)[0]
    line = (f"{what} {name} n={n} mtot={m} B={B} fft={fo} {tc} (pick "
            f"{pick[0]}): "
            + ", ".join(f"{k} {t:.4f}" for k, t in ms.items())
            + f" ms; bound_fp64_tc_ms {b_tc:.4f} ({b_tc / ms['tc']:.1%} of "
            f"it), CUDA cores {b_cc:.4f}")
    if "base" in ms:
        line += f"; base / tc {ms['base'] / ms['tc']:.2f}x"
    line += "; rel " + ", ".join(f"{k} {v:.1e}" for k, v in rels.items())
    print(line + f" [{smi}]", flush=True)
    return ms


def d23_bits(base, smi):
    """Whether this checkout's float64 d=2 and d=3 wrappers give the base's
    bits at every D23 shape (the base's library in cuda_nufft's place, the
    same geometry), with both card times; returns whether all agree."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    same_all = True
    for name, n, m, B, fo in D23:
        d = 3 if "3d" in name else 2
        x = torch.as_tensor(rng.uniform(0, 1, (n, d)), device=dev)
        lead = (B,) if name.endswith("batched") or B > 1 else ()
        shape = lead + ((n,) if name.startswith("nufft1") else (m,) * d)
        arg = torch.as_tensor(rng.normal(size=shape) + 1j * rng.normal(
            size=shape), device=dev)
        h = 0.97 if m > 300 else 0.65
        fn = getattr(cn, name)

        def this():
            return fn(x, arg, h, mtot=m, fft_order=fo)

        def other():
            cn._lib, keep = base, cn._lib
            try:
                return fn(x, arg, h, mtot=m, fft_order=fo)
            finally:
                cn._lib = keep
        same = torch.equal(this(), other())
        same_all = same_all and same
        work = B * n * m ** d
        ms = card_ms({"this": this, "base": other},
                     max(1, min(20, int(2e9 / work))), 3)
        print(f"float64 {name} n={n} mtot={m} B={B} fft={fo}: the base's "
              f"bits {same}; this {ms['this']:.4f}, base {ms['base']:.4f} "
              f"ms [{smi}]", flush=True)
        del x, arg
        torch.cuda.empty_cache()
    return same_all


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", choices=sorted(SHAPES), default="driven")
    ap.add_argument("--base", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_nufft_1d_f64.py needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    base = None
    if args.base is not None:
        base = BaseLibrary(build_base(args.base.resolve()), cn._library())
    else:
        cn.build()
    lc = lightcurve_data()
    kern = gpquad_torch.make_kernel("SE", 1, lengthscale=np.float32(0.0015),
                                    variance=np.float32(1.0))
    xl = torch.as_tensor(lc["x"][:, None], dtype=torch.float32)
    L = float(xl.max() - xl.min())
    _, h_lc, m_lc = gpquad_torch.spectral_grid(kern, 1e-4, L)
    if (len(lc["x"]), m_lc) != (LC_N, 919):
        raise RuntimeError(f"the light curve: n {len(lc['x'])}, mtot {m_lc}")
    rng = np.random.default_rng(0)
    for shape in SHAPES[args.shapes]:
        d1_shape(*shape, float(h_lc), lc["x"], base, smi, rng)
        torch.cuda.empty_cache()
    if base is not None and not d23_bits(base, smi):
        print("a float64 d=2 or d=3 kernel does not give the base's bits",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
