"""The NUFFT layer's yardstick: the operations and bytes of a direct-sum
NUFFT call, counted from its shape alone, and the least time one NVIDIA
H100 needs for them.

The count is the same whatever kernel, path or backend runs the call, so a
redesigned kernel is judged against the same least time.  Per point and
vector: mtot^d complex multiply-adds at 8 flops; then the outer axes'
products (type-2: multiply-adds at 8 flops, mtot^(d-1) + ... + mtot of
them; type-1: plain complex multiplies at 6); the phases at PHASE_FLOPS
once per point, dimension and mode, also for a batch; the points, the B
inputs and the B outputs read or written once.  The least time of a
float32 call is the larger of the operations on the tensor cores in
3xTF32 (three TF32 products per real product, at the dense TF32 rate,
the rest at the fp32 rate) and the bytes at the HBM bandwidth.
"""
from __future__ import annotations

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W): fp32
# outside the tensor cores, dense TF32 on the tensor cores, HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12

# One phase e^{i 2 pi c} at its least cost: a rotation recurrence along the
# modes (one complex multiply, 6 flops) re-anchored every 32 modes by an
# exact sin/cos pair (20 flops).
PHASE_FLOPS = 6 + 20 / 32


def kernel_work(kind, d, n, mtot, B=1, real_bytes=4):
    """(flops, bytes) of a type-``kind`` (1 or 2) NUFFT of B vectors at n
    points on an mtot^d grid, with reals of ``real_bytes`` bytes."""
    s = real_bytes
    phases = d * n * mtot * PHASE_FLOPS
    outer = 8 if kind == 2 else 6
    outer_products = sum(mtot ** k for k in range(1, d))
    flops = B * n * (8 * mtot ** d + outer * outer_products) + phases
    nbytes = d * n * s + B * (2 * mtot ** d * s + 2 * n * s)
    return flops, nbytes


def least_ms(kind, d, n, mtot, B=1):
    """The float32 call's least time on one H100 (ms) and what bounds it:
    3 x 8 flops per point, mode and vector at the TF32 rate plus the rest
    of kernel_work's operations at the fp32 rate (at d=3 the type-2's
    rest: the phases, the mtot^2 products e2 e3 once a point and the
    mtot multiply-adds e1 T a point and vector), against the bytes."""
    flops, nbytes = kernel_work(kind, d, n, mtot, B)
    tc = 3 * 8 * B * n * mtot ** d
    rest = flops - 8 * B * n * mtot ** d
    if kind == 2 and d == 3:
        rest = (d * n * mtot * PHASE_FLOPS + 6 * n * mtot ** 2
                + 8 * B * n * mtot)
    t_ops = (tc / PEAK_TF32 + rest / PEAK_FP32) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")
