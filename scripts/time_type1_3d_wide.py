"""Time the float32 d=3 type-1 on the wide grids' tensor-core kernel
(``nufft1_3d``'s ``type1_wide_kernel`` of ``csrc/tc_type1_wide.cuh``)
beside the other paths of the same function on the same inputs, beside
another checkout's float32 d=3 type-1, and taken apart.

    python scripts/time_type1_3d_wide.py [--shapes SET [SET ...]]
        [--base DIR] [--ablate]

It copies ``gpquad_torch/csrc`` into ``build/type1_3d_wide_timer/
<variant>/`` and builds ``nufft_3d.cu`` there, one ``nvcc`` a variant, all
started together:

- ``full``: the kernel as it is;
- ``cols32``: the kernel with a second instance, output tiles 32 modes j3
  wide (``type1_wide_kernel<32>``), launched at the picked geometry but
  for the column tile;
- with ``--ablate``: ``no_phases``, every phase of the producers' table
  replaced by a product (the table's stores, the operands' products and
  splits stay); ``no_table``, no table made (its phases and stores);
  ``no_a`` / ``no_e``, no A / no E made (their products, splits and
  stores); ``no_fill``, no stage filled at all (the producers only hand
  the buffers over: what is left is the consumers' work); ``no_mma``, no
  k-step run by the consumers (what is left: the producers' whole work,
  the hand-offs, the sums' stores; the consumers still take and release
  every stage, so that nothing waits forever);
- ``base``, with ``--base DIR``: ``DIR/gpquad_torch/csrc/nufft_3d.cu`` as
  it is, another checkout (for example the parent commit unpacked with
  ``git archive`` into ``build/parent``), whose float32 d=3 type-1 is the
  CUDA-core kernel before the wide grids' tensor cores
  (``gpq_nufft1_3d_f32(x, v, h, n, m, nb, fft_order, chunk, groups,
  partial, out, stream)``, its groups as that checkout's
  ``type1_3d_groups`` counts them).

At each shape it times, on the card: ``full`` at the geometry
``type1_3d_wide_geometry`` picks (``wide``), with point groups of half and
twice the picked chunk, and ``cols32``; Type1Grid3D's tensor-core kernel
(``tc``, the geometry of ``type1_3d_tc_geometry``: 64 x 32 tiles past mtot
64); ``base``; the float32 plain version (``plain``); and the ablation
variants.  The shape sets (``phase3`` by default, several in turn):
``phase3``, chip_smoke.py phase 3's float32 d=3 type-1 shapes past mtot
56; ``sweep``, 2e4 points at odd mtot 33-193, among them the widths where
the 32-column tile pads the columns least; ``6b``, phase 6b's lag table on
its own inputs (``chip_smoke.data_3d``'s 1e5 points, ones, the grid's h
rounded to float32, mtot 105); the others random points in [-1, 1]^3 and
values at h 0.97.

The variants' answers are wrong by design.  ``full`` at each geometry and
``cols32`` must hold max(2 x the float32 plain version's error, 1e-6) of
max|ref| against the float64 plain version and give the same bits on a
second launch, ``base`` 1e-4; the script stops with an error where they do
not.  Times are the card's (it sleeps first, so that the host enqueues
ahead; the paths in turn each of 3 rounds, medians); it prints the card's
name and power limit and the 3xTF32 bound (chip_smoke.py
``bound_3xtf32_ms``).  It needs a CUDA device.

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
import chip_smoke  # noqa: E402
import gpquad_torch  # noqa: E402
from gpquad_torch.ops import cuda_nufft as cn  # noqa: E402

OUT = ROOT / "build" / "type1_3d_wide_timer"
CSRC = ROOT / "gpquad_torch" / "csrc"
# (file, the text there, what replaces it)
COLS32 = ("tc_type1_wide.cuh", "  if (cols == TW_COLS)\n",
          "  if (cols == 32)\n"
          "    return launch_type1_wide_cols<32>(x, v, h, n, m, nb, "
          "fft_order, acc, run,\n"
          "                                      chunk, partial, out, s);\n"
          "  if (cols == TW_COLS)\n")
PHASES = ("tc_type1_wide.cuh", "  phase(u, (float)k, &c, &s);",
          "  c = u * (float)k; s = c + 1.f;")
KSTEPS = ("tc_type1_wide.cuh", "for (int ks = 0; ks < TC_P; ks += 8) {",
          "for (int ks = 0; ks < 0; ks += 8) {")
TABLE = ("tc_type1_wide.cuh",
         "  // the table: entries ptid % 8 + 8 i of point ptid / 8\n  {",
         "  if (false) {")
AFILL = ("tc_type1_wide.cuh",
         "  // A: row r = ptid % 64 of points ptid / 64 + 4 it\n  {",
         "  if (false) {")
EFILL = ("tc_type1_wide.cuh",
         "  // E: column c = ptid % COLS of points ptid / COLS + (NP / COLS) "
         "it\n  {", "  if (false) {")
FILL = ("tc_type1_wide.cuh",
        "        tw_fill<COLS>(stages[s & 1], tab, ptid, x, vb, h, m, i0, k0,"
        "\n                      p0 + TC_P, p_end, &xp, &vp);", "")
ABLATIONS = {"no_phases": (PHASES,), "no_table": (TABLE,),
             "no_a": (AFILL,), "no_e": (EFILL,), "no_fill": (FILL,),
             "no_mma": (KSTEPS,)}
# (n, mtot, B): chip_smoke.py phase 3's float32 d=3 type-1 shapes past 56
SHAPES = {"phase3": [(20_000, 57, 1), (20_000, 101, 1), (20_000, 255, 1),
                     (100_000, 61, 1), (100_000, 105, 1),
                     (100_000, 105, 10), (20_000, 101, 10)],
          "quick": [(20_000, 101, 1), (20_000, 255, 1), (100_000, 105, 1)],
          "two": [(20_000, 101, 1), (20_000, 255, 1)],
          "sweep": [(20_000, m, 1) for m in (33, 45, 57, 65, 73, 81, 89,
                                             97, 129, 161, 193)],
          "6b": [(100_000, 105, 1)]}
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


def card_ms(fns, reps, trials=3):
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
    own where given), compiled in parallel; returns {name: the ctypes
    function gpq_nufft1_3d_wide_f32, or base's gpq_nufft1_3d_f32} and
    prints each variant's registers and spills."""
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
                    "type1_wide_kernel" in line
                    or ("nufft1_3d_partial_kernel" in line and "If" in line)):
                print(name, line.split("'")[1][:60], " ".join(
                    ln.split(":", 1)[-1].strip() for ln in lines[i + 1:i + 3]))
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        if name == "base":
            fn = lib.gpq_nufft1_3d_f32
            fn.argtypes = [ptr, ptr, ctypes.c_float, *[i32] * 6, ptr, ptr,
                           ptr]
        else:
            fn = lib.gpq_nufft1_3d_wide_f32
            fn.argtypes = [ptr, ptr, ctypes.c_float, *[i32] * 9, ptr, ptr,
                           ptr]
        fn.restype = i32
        fns[name] = fn
    return fns


def inputs(shapes, n, m, B, rng, dev):
    """(x, V, h) of a shape: 6b's lag table on its own inputs, else random
    points in [-1, 1]^3 and values, h 0.97."""
    if shapes == "6b":
        kern = gpquad_torch.make_kernel("SE", 3, lengthscale=np.float32(0.05),
                                        variance=np.float32(1.0))
        _, h, mtot = gpquad_torch.spectral_grid(kern, 1e-6, 1.0)
        if (n, m, B) != (100_000, 2 * mtot - 1, 1):
            raise RuntimeError(f"6b's lag table is {2 * mtot - 1} wide")
        x = torch.as_tensor(chip_smoke.data_3d(n, 10_000, seed=3)[0],
                            dtype=torch.float32, device=dev)
        V = torch.ones((1, n), dtype=torch.complex64, device=dev)
        return x, V, float(torch.tensor(h, dtype=torch.float32))
    x = torch.as_tensor(rng.uniform(-1, 1, (n, 3)), device=dev).float()
    V = torch.as_tensor(rng.normal(size=(B, n)) + 1j * rng.normal(
        size=(B, n)), device=dev).to(torch.complex64)
    return x, V, float(np.float32(0.97))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", choices=sorted(SHAPES), nargs="+",
                    default=["phase3"])
    ap.add_argument("--base", type=Path)
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_type1_3d_wide.py needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    cn.build()
    base = args.base.resolve() if args.base is not None else None
    variants = {"full": (), "cols32": (COLS32,),
                **(ABLATIONS if args.ablate else {})}
    fns = build_variants(cn._nvcc(), variants, base)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for which, (n, m, B) in ((s, shape) for s in args.shapes
                             for shape in SHAPES[s]):
        x, V, h = inputs(which, n, m, B, rng, dev)
        ref = sum(cn.nufft1_3d_ref(x[i:i + 20_000].double(),
                                   V[:, i:i + 20_000].to(torch.complex128),
                                   h, mtot=m)
                  for i in range(0, n, 20_000))
        scale = float(ref.abs().max())
        plain_rel = float((cn.nufft1_3d_ref(x, V, h, mtot=m).to(
            torch.complex128) - ref).abs().max()) / scale
        bar = max(2 * plain_rel, 1e-6)
        pick = cn.type1_3d_wide_geometry(n, m, B)
        geos = {"wide": ("full", pick),
                "cols32": ("cols32", pick[:2] + (32,) + pick[3:])}
        for f, tag in ((0.5, "half"), (2, "twice")):
            chunk = max(pick[4], int(pick[5] * f) // pick[4] * pick[4])
            if chunk != pick[5] and chunk < 2 * n:
                geos[f"chunk_{tag}"] = ("full", pick[:5] + (chunk,))
        out = torch.empty((B, m, m, m), dtype=torch.complex64, device=dev)

        def launcher(fn, geo):
            groups = -(-n // geo[-1])
            part = (out if groups == 1 else
                    torch.empty((groups, B, m, m, m), dtype=torch.complex64,
                                device=dev))

            def call():
                rc = fn(x.data_ptr(), V.data_ptr(), h, n, m, B, 0, *geo[1:],
                        part.data_ptr(), out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"CUDA error {rc} at {geo}")
            return call

        def base_launcher():
            groups = base_groups(n, m, B)
            part = torch.empty((groups, B, m, m, m), dtype=torch.complex64,
                               device=dev)

            def call():
                rc = fns["base"](x.data_ptr(), V.data_ptr(), h, n, m, B, 0,
                                 BASE_CHUNK, groups, part.data_ptr(),
                                 out.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"base: CUDA error {rc}")
            return call
        calls = {k: launcher(fns[lib], geo) for k, (lib, geo) in geos.items()}
        if base is not None:
            calls["base"] = base_launcher()
        errs = {}
        for k, call in calls.items():
            call()
            torch.cuda.synchronize()
            got = out.clone()
            errs[k] = float((got - ref).abs().max()) / scale
            call()
            torch.cuda.synchronize()
            if not torch.equal(got, out):
                print(f"{k} at n={n} m={m} B={B}: a second launch differs",
                      file=sys.stderr)
                return 1
            lim = 1e-4 if k == "base" else bar
            if not errs[k] <= lim:
                print(f"{k} at n={n} m={m} B={B}: {errs[k]:.3e} of max|ref| "
                      f"over {lim:.3e}", file=sys.stderr)
                return 1
        calls["tc"] = lambda: cn._nufft1_3d_on(
            x, V, h, m, False, cn.type1_3d_tc_geometry(n, m, B))
        for name, fn in fns.items():
            if name in ABLATIONS:
                calls[name] = launcher(fn, pick)
        reps = max(1, min(10, int(3e10 / (n * B * m ** 3))))
        ms = card_ms(calls, reps)
        ms["plain"] = card_ms({"plain": lambda: cn.nufft1_3d_ref(
            x, V, h, mtot=m)}, 1, 1)["plain"]
        bound = chip_smoke.bound_3xtf32_ms("nufft1_3d", n, m, B)[0]
        rel = ", ".join(f"{k}/wide {ms[k] / ms['wide']:.3f}"
                        for k in ("cols32", "base", "plain") if k in ms)
        print(f"[{which}] n={n} mtot={m} B={B} pick {pick}: rel err "
              + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
              + f" (plain f32 {plain_rel:.3e}, bar {bar:.3e}); ms "
              + ", ".join(f"{k} {t:.4f}" for k, t in ms.items())
              + f"; {rel}; bound_3xtf32 {bound:.4f} ({bound / ms['wide']:.1%}"
              f" of it) [{smi}]", flush=True)
        del x, V, ref, out, calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
