"""Time the float32 batched d=2 type-2 on the tensor cores
(``gpquad_torch/csrc/tc_type2.cuh`` ``type2_tc_kernel`` on ``nufft_2d.cu``'s
``Type2Grid2D``) alone, with parts of it taken out, beside the CUDA-core
kernel and the card's ``mma.sync`` TF32 rate.

    python scripts/time_type2_batched.py [--shapes scale|all]

It copies ``gpquad_torch/csrc`` into ``build/type2_ablation/<variant>/`` and
builds ``nufft_2d.cu`` there, one ``nvcc`` each, all started together:

- ``full``: the kernel as it is;
- ``no_e2_phases``: E2's phases replaced by a product (the split and the
  stores stay);
- ``no_e1_phases``: the epilogue's e1 phases replaced likewise;
- ``mma_only``: both replaced (the products, F's copies, the syncs and the
  epilogue's sums stay);
- ``no_mma``: both replaced and no k-step run (what is left: F's copies,
  E2's stores, the syncs, the epilogue).

The answers of the variants but ``full`` are wrong by design; ``full`` is
held against the CUDA-core kernel of the library build.  A last kernel
issues back-to-back independent ``mma.sync.m16n8k8`` TF32 chains (eight a
warp, 16 warps a block, one and two blocks an SM) for the card's rate of
that instruction.  Times are CUDA-event medians of 3 trials; it prints the
card's name and power limit.  It needs a CUDA device.

It is a tool for work on the kernel, not a check: nothing on the main path,
in the tests or in chip_smoke.py runs it, and it stops with an error where a
line it replaces is no longer in ``tc_type2.cuh``.
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
from gpquad_torch.ops import cuda_nufft  # noqa: E402

OUT = ROOT / "build" / "type2_ablation"
# (the text in tc_type2.cuh, what replaces it)
E2_PHASE = ("if (ok) P::red_phase(ua[r & 1], ub[r & 1], kv, &c[r], &s[r]);",
            "if (ok) { c[r] = ub[r & 1] * kv; s[r] = c[r] + 1.f; }")
E1_PHASE = ("P::epi_phase(ua, ub, j0 + jj, m, fft_order, &c, &s);",
            "c = ua + jj; s = ua;")
KSTEPS = ("for (int ks = 0; ks < NKS; ++ks) {",
          "for (int ks = 0; ks < 0; ++ks) {")
VARIANTS = {"full": (), "no_e2_phases": (E2_PHASE,),
            "no_e1_phases": (E1_PHASE,), "mma_only": (E2_PHASE, E1_PHASE),
            "no_mma": (E2_PHASE, E1_PHASE, KSTEPS)}
PEAK_SRC = r"""
__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__global__ void __launch_bounds__(512, 1) peak_kernel(float* out, int iters) {
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(threadIdx.x * 2e-3f + i);
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < 8; ++c) mma_tf32(d[c], a, b);
  float s = 0.f;
  for (int c = 0; c < 8; ++c)
    for (int r = 0; r < 4; ++r) s += d[c][r];
  out[blockIdx.x * 512 + threadIdx.x] = s;
}
extern "C" int peak(float* out, int iters, int blocks) {
  peak_kernel<<<blocks, 512>>>(out, iters);
  return (int)cudaGetLastError();
}
"""
SHAPES = {"scale": [(1_000_000, 339, 10), (1_000_000, 339, 5)],
          "all": [(1_000_000, 339, 10), (1_000_000, 339, 5),
                  (100_000, 107, 10), (100_000, 29, 10)]}


def event_ms(fn, reps, trials=3):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    return statistics.median(ts)


def build_variants(nvcc):
    """One shared library per variant (and the peak kernel), compiled in
    parallel; returns {name: the ctypes function}, and prints each
    variant's registers and spills."""
    OUT.mkdir(parents=True, exist_ok=True)
    csrc = ROOT / "gpquad_torch" / "csrc"
    procs = {}
    for name, hooks in VARIANTS.items():
        d = OUT / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(csrc, d)
        text = (d / "tc_type2.cuh").read_text()
        for old, new in hooks:
            if old not in text:
                raise RuntimeError(f"{name}: '{old}' is not in tc_type2.cuh")
            text = text.replace(old, new)
        (d / "tc_type2.cuh").write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *cuda_nufft.NVCC_FLAGS, "-shared", "-o",
             str(OUT / f"{name}.so"), str(d / "nufft_2d.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    (OUT / "peak.cu").write_text(PEAK_SRC)
    procs["peak"] = subprocess.Popen(
        [nvcc, *cuda_nufft.NVCC_FLAGS, "-shared", "-o", str(OUT / "peak.so"),
         str(OUT / "peak.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    fns = {}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        if name == "peak":
            lib.peak.argtypes = [ptr, i32, i32]
            lib.peak.restype = i32
            fns[name] = lib.peak
            continue
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "Type2Grid2DELi128" in line \
                    and "type2_tc_kernel" in line:
                print(name, " ".join(ln.split(":", 1)[-1].strip()
                                     for ln in lines[i + 1:i + 4]))
                break
        fn = lib.gpq_nufft2_2d_batched_tc_f32
        fn.argtypes = [ptr, ptr, ctypes.c_float, i32, i32, i32, i32, i32,
                       i32, i32, ptr, ctypes.c_longlong, ptr, ptr]
        fn.restype = i32
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", choices=sorted(SHAPES), default="all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_type2_batched: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    fns = build_variants(cuda_nufft._nvcc())
    dev = torch.device("cuda")
    buf = torch.empty(2 * 132 * 512, device=dev)
    for blocks in (132, 264):
        iters = 2000

        def peak():
            rc = fns["peak"](buf.data_ptr(), iters, blocks)
            if rc:
                raise RuntimeError(f"peak: CUDA error {rc}")
        ms = event_ms(peak, 1)
        flops = blocks * 16 * iters * 8 * 2048
        print(f"mma.sync m16n8k8 TF32, 8 chains a warp, {blocks} blocks of "
              f"512 threads: {ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s "
              f"[{smi}]")
    tc = ("tc", cuda_nufft.TYPE2_2D_POINTS, cuda_nufft.TYPE2_2D_COLS,
          cuda_nufft.TYPE2_2D_STAGE)
    cc = ("cuda",)
    gen = np.random.default_rng(1)
    for n, m, B in SHAPES[args.shapes]:
        x = torch.as_tensor(gen.uniform(0, 1, (n, 2)), device=dev).float()
        f = torch.as_tensor(gen.normal(size=(B, m, m))
                            + 1j * gen.normal(size=(B, m, m)),
                            device=dev).to(torch.complex64)
        h = float(np.float32(0.97))
        floats = cuda_nufft.type2_2d_scratch_floats(m, B, tc)
        scratch = torch.empty(floats, dtype=torch.float32, device=dev)
        ref = cuda_nufft._nufft2_2d_batched_on(x, f, h, m, False, cc)
        scale = float(ref.abs().max())
        reps = 2 if n * B * m * m > 1e11 else 10
        ms_cc = event_ms(lambda: cuda_nufft._nufft2_2d_batched_on(
            x, f, h, m, False, cc), reps)
        print(f"n={n} mtot={m} B={B}: CUDA cores {ms_cc:.4f} ms [{smi}]")
        for name, fn in fns.items():
            if name == "peak":
                continue
            out = torch.empty((B, n), dtype=torch.complex64, device=dev)

            def call():
                rc = fn(x.data_ptr(), f.data_ptr(), h, n, m, B, 0, *tc[1:],
                        scratch.data_ptr(), floats, out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            ms = event_ms(call, reps)
            diff = float((out - ref).abs().max()) / scale
            print(f"n={n} mtot={m} B={B}: {name} {ms:.4f} ms (|out - CUDA "
                  f"cores| / max {diff:.3e}) [{smi}]", flush=True)
        del x, f, scratch, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
