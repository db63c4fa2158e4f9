"""Time the float32 d=1 type-2 on the tensor cores (``nufft2_1d``'s
``type2_tc_kernel`` of ``csrc/tc_type2.cuh`` on ``nufft_1d.cu``'s
``Type2Split1D``) at the driven shapes, taken apart, beside the CUDA-core
kernel.

    python scripts/time_type2_1d.py

It copies ``gpquad_torch/csrc`` into ``build/type2_1d_ablation/<variant>/``
and builds ``nufft_1d.cu`` there, one ``nvcc`` a variant, all started
together:

- ``full``: the kernel as it is (K 32, 128 points a block);
- ``k64``: the split k = K q + r at K 64 (64 columns a vector, half the
  values of q);
- ``p64``: 64 points a block (4 x 4 warps);
- ``no_red_phases``: the reduction's phases e^{+2 pi i K q t} replaced by
  a product (their split and stores stay);
- ``no_epi_phases``: the epilogue's phases e^{+2 pi i r t} replaced
  likewise.

The answers of ``no_*`` are wrong by design; the others are held within
1e-5 of max|ref| against the CUDA-core kernel of the library build.  At
each shape ``full`` also runs on the other column tile (32 or 128 columns),
and the line gives the geometry's padding (the products made a point
against the B mtot needed) and the phases a point.  Times are the card's
(it sleeps first, so that the host enqueues ahead; the variants in turn
each of 7 rounds, medians); it prints the card's name and power limit.  It
needs a CUDA device.

It is a tool for work on the kernel's geometry, not a check: nothing on the
main path, in the tests or in chip_smoke.py runs it, and it stops with an
error where a line it replaces is no longer in the sources.
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
from gpquad_torch.ops import cuda_nufft as cn  # noqa: E402

OUT = ROOT / "build" / "type2_1d_ablation"
CSRC = ROOT / "gpquad_torch" / "csrc"
# (file, the text there, what replaces it)
K64 = ("nufft_1d.cu", "constexpr int T2S_K = 32;", "constexpr int T2S_K = 64;")
P64 = (("tc_type2.cuh", "constexpr int T2C_P = 128;",
        "constexpr int T2C_P = 64;"),
       ("tc_type2.cuh", "constexpr int T2C_WM = 8;",
        "constexpr int T2C_WM = 4;"))
RED = ("tc_type2.cuh",
       "if (ok) P::red_phase(ua[r & 1], ub[r & 1], kv, &c[r], &s[r]);",
       "if (ok) { c[r] = ua[r & 1] * kv; s[r] = c[r] + ub[r & 1]; }")
EPI = ("tc_type2.cuh", "P::epi_phase(ua, ub, j0 + jj, m, fft_order, &c, &s);",
       "c = ua + jj; s = ub;")
# (hooks, points a block, K)
VARIANTS = {"full": ((), 128, 32), "k64": ((K64,), 128, 64),
            "p64": (P64, 64, 32), "no_red_phases": ((RED,), 128, 32),
            "no_epi_phases": ((EPI,), 128, 32)}
# (n, mtot, B, fft_order, what): chip_smoke.py phase 8's type-2 calls and
# the dense tier's widest lag table
SHAPES = [(5_000, 1031, 1, False, "light curve mean"),
          (5_000, 2061, 1, True, "light curve variance evaluation"),
          (63_480, 1031, 1, False, "light curve F(D beta)"),
          (63_480, 1031, 10, False, "light curve F(D'F*Z), F(D Beta)"),
          (20_000, 8191, 1, False, "mtot 8191")]
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


def build_variants(nvcc):
    """One shared library of nufft_1d.cu per variant, compiled in parallel;
    returns {name: the ctypes function gpq_nufft2_1d_tc_f32} and prints
    each variant's registers and spills."""
    procs = {}
    for name, (hooks, _, _) in VARIANTS.items():
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
             str(d / "nufft_1d.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "Type2Split1D" in line \
                    and "type2_tc_kernel" in line:
                inst = line.split("Type2Split1DE")[1][:8]
                print(name, inst, " ".join(
                    ln.split(":", 1)[-1].strip() for ln in lines[i + 1:i + 3]))
        fn = ctypes.CDLL(str(OUT / name / "lib.so")).gpq_nufft2_1d_tc_f32
        fn.argtypes = [ptr, ptr, ctypes.c_float, *[i32] * 8, ptr,
                       ctypes.c_longlong, ptr, ptr]
        fn.restype = i32
        fns[name] = fn
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("time_type2_1d.py needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    fns = build_variants(cn._nvcc())
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    h = float(np.float32(0.0097))
    for n, m, B, fo, what in SHAPES:
        x = torch.as_tensor(rng.uniform(0, 1, (n, 1)), device=dev).float()
        f = torch.as_tensor(rng.normal(size=(B, m)) + 1j * rng.normal(
            size=(B, m)), device=dev).to(torch.complex64)
        pick = cn.type2_1d_geometry(n, m, B)
        ref = cn._nufft2_1d_on(x, f, h, m, fo, ("cuda",))
        scale = float(ref.abs().max())
        out = torch.empty((B, n), dtype=torch.complex64, device=dev)

        def launcher(fn, geo):
            floats = 4 * (8 * -(-cn.type1_1d_split(m, geo[2])[1] // 8)
                          ) * -(-B * geo[2] // geo[3]) * geo[3]
            scratch = torch.empty(floats, device=dev)

            def call():
                rc = fn(x.data_ptr(), f.data_ptr(), h, n, m, B, int(fo),
                        *geo[1:], scratch.data_ptr(), floats, out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"CUDA error {rc}")
            return call
        tc = cn.type2_1d_tc_geometry(B)
        width = 128 if tc[3] == 32 else 32
        calls = {"cuda_cores": lambda: cn._nufft2_1d_on(x, f, h, m, fo,
                                                        ("cuda",))}
        for name, (_, points, K) in VARIANTS.items():
            geos = {name: ("tc", points, K, tc[3], tc[4])}
            if name == "full":
                geos[f"full_cols{width}"] = tc[:3] + (width,) + tc[4:]
            for k, geo in geos.items():
                calls[k] = launcher(fns[name], geo)
                calls[k]()
                err = float((out - ref).abs().max()) / scale
                if not k.startswith("no_") and err > 1e-5:
                    print(f"{k} at n={n} m={m} B={B}: {err:.3e} of max|ref| "
                          "from the CUDA cores", file=sys.stderr)
                    return 1
        ms = card_ms(calls)
        K = tc[2]
        Q = cn.type1_1d_split(m, K)[1]
        kq = -(-Q // 8) * 8
        ncp = -(-B * K // tc[3]) * tc[3]
        print(f"{what} n={n} mtot={m} B={B}: pick {pick}, padding "
              f"x{kq * ncp / (B * m):.3f}, phases a point {ncp // tc[3] * kq}"
              f" + {B * K}; " + ", ".join(f"{k} {t:.4f}" for k, t in
                                          ms.items()) + f" ms [{smi}]",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
