"""The float64 d=3 type-1 on the FP64 tensor cores (gpquad_torch.ops.
cuda_nufft: ``type1_3d_geometry`` at float64, ``type1_3d_f64_split`` and
the kernel's plain twin ``nufft1_3d_f64_tc_ref``) against gpquad's float64
type-1 at d=3.

The twin forms the kernel's operands (rows (r, j3) and columns (q, j2) of
the split k1 = S q + r, each inner phase the product of the mode split's
two factors, the outer factor e(t1, r) or e(t1, S q) and, in A, v folded
into the first) and makes its sums in the kernel's order (k-steps of 8
points from zero in a run, the runs in order into a group's partial, the
groups in order).  It is held within 1e-12 of max|ref| of gpquad's float64
``nufft1`` (gpquad/ops/nufft.py:279, the MXU path with x64 on the CPU)
and of the port's plain version ``nufft1_3d_ref``: float64 evaluations of
the same sums whose phases differ by a rounding or three (~1e-15 of
max|ref| here).  The kernel itself runs on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py phase 3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.ops.nufft import nufft1
from gpquad_torch.ops import cuda_nufft
from gpquad_torch.ops.cuda_nufft import (nufft1_3d, nufft1_3d_f64_tc_ref,
                                         nufft1_3d_ref, type1_1d_split,
                                         type1_3d_f64_split,
                                         type1_3d_geometry)

# The parity problems are small: torch's intra-op threads cost more than
# they give on them, most of all beside other test processes.
torch.set_num_threads(1)

BAR = 1e-12
F64 = torch.float64


def _inputs(seed, n, B):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 3))
    v = rng.normal(size=(B, n)) + 1j * rng.normal(size=(B, n))
    return x, v


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# hard3d's mtot 21 and 41, one width past 64 (67: S 7, a row tile across
# two values of r); n ragged against the k-step (8), the run (512) and the
# group; chunk 1024 puts two runs in a group and two or three groups in a
# call; B 1 and odd B 3 (the batch in pairs, the last alone); both orders
@pytest.mark.parametrize("n,mtot,B,h,fft_order,chunk", [
    (2501, 21, 1, 0.65, False, 1024),
    (2001, 21, 3, 0.65, True, None),
    (1203, 41, 1, 0.4, True, 512),
    (1999, 41, 3, 0.4, False, 1024),
    (777, 67, 1, 0.3, False, None),
    (515, 67, 3, 0.3, True, 512),
])
def test_f64_3d_twin_matches_gpquad(n, mtot, B, h, fft_order, chunk):
    x, v = _inputs(n + mtot, n, B)
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    arg = vt[0] if B == 1 else vt
    twin = nufft1_3d_f64_tc_ref(xt, arg, h, mtot=mtot, fft_order=fft_order,
                                chunk=chunk).numpy()
    assert twin.dtype == np.complex128
    assert twin.shape == ((mtot,) * 3 if B == 1 else (B,) + (mtot,) * 3)
    want = np.asarray(nufft1(jnp.asarray(x), jnp.asarray(v), h, mtot,
                             fft_order=fft_order))
    assert want.dtype == np.complex128
    assert _rel(twin.reshape(want.shape), want) <= BAR
    plain = nufft1_3d_ref(xt, vt, h, mtot=mtot, fft_order=fft_order).numpy()
    assert _rel(twin.reshape(plain.shape), plain) <= BAR


@pytest.mark.parametrize("mtot,split", [(5, 3), (9, 8), (21, 1), (31, 2)])
def test_f64_3d_twin_any_split(mtot, split):
    """Every split S the launch takes gives the same sums: the rows (r, j3)
    and columns (q, j2) only place the outputs (mtot below 8 pads each
    index's inner stride to 8)."""
    n, h = 700, 0.45
    x, v = _inputs(mtot, n, 2)
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    ref = nufft1_3d_ref(xt, vt, h, mtot=mtot, fft_order=True).numpy()
    twin = nufft1_3d_f64_tc_ref(xt, vt, h, mtot=mtot, fft_order=True,
                                split=split).numpy()
    assert _rel(twin, ref) <= BAR


def test_f64_3d_twin_order_of_sums():
    """The twin's sums depend on the groups and runs only through their
    rounding: other point groups move the result by ~1e-16 of max|ref|,
    never by more than the bar."""
    n, mtot, h = 3000, 21, 0.7
    x, v = _inputs(3, n, 2)
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    a = nufft1_3d_f64_tc_ref(xt, vt, h, mtot=mtot, chunk=512).numpy()
    b = nufft1_3d_f64_tc_ref(xt, vt, h, mtot=mtot, chunk=3072).numpy()
    assert _rel(a, b) <= BAR
    with pytest.raises(ValueError, match="multiple"):
        nufft1_3d_f64_tc_ref(xt, vt, h, mtot=mtot, chunk=700)


@pytest.mark.parametrize("mtot", [1, 3, 5, 7, 9, 21, 31, 41, 57, 61, 67,
                                  101, 255])
@pytest.mark.parametrize("rows,cols", [(64, 64), (64, 32), (32, 64),
                                       (32, 32)])
def test_type1_3d_f64_split(mtot, rows, cols):
    """S in 1..TYPE1_3D_F64_MAX_SPLIT makes the fewest padded outputs of
    the tiles (the smallest S of a tie); q runs over the values that reach
    every |k1| <= half, each k1 once; the inner stride is mtot, 8 below 8."""
    S, qmin, Q, mi = type1_3d_f64_split(mtot, rows, cols)
    assert mi == max(mtot, 8) and (qmin, Q) == type1_1d_split(mtot, S)

    def padded(s):
        q = type1_1d_split(mtot, s)[1]
        return -(-s * mi // rows) * rows * -(-q * mi // cols) * cols
    sizes = [padded(s) for s in range(1, cuda_nufft.TYPE1_3D_F64_MAX_SPLIT
                                      + 1)]
    assert padded(S) == min(sizes) and sizes.index(min(sizes)) == S - 1
    half = (mtot - 1) // 2
    k1 = sorted(S * (qmin + q) + r for q in range(Q) for r in range(S))
    assert k1 == list(range(k1[0], k1[0] + S * Q))
    assert k1[0] <= -half and k1[-1] >= half and S * Q < mtot + 2 * S


# chip_smoke.py phase 3's float64 d=3 type-1 shapes (d3's and hard3d's F*y,
# lag table and B 10 gradient F*Z, the slab-tiled widths) and a few more:
# few points, the widest grid in a batch, single points
@pytest.mark.parametrize("n,mtot,B", [
    (100_000, 31, 1), (100_000, 61, 1), (100_000, 31, 10),
    (20_000, 21, 1), (20_000, 41, 1), (20_000, 21, 10),
    (20_000, 57, 1), (20_000, 101, 1), (20_000, 255, 1),
    (1_000, 21, 1), (20_000, 255, 10), (1, 1, 1), (1, 3, 2)])
def test_type1_3d_f64_geometry(n, mtot, B):
    """The tile (64 rows, a batch in pairs; 32 columns where 64 would pad
    the outputs 1.25x as far, else 64), the split of type1_3d_f64_split for
    that tile, whole runs in a group, none of the groups empty, and the
    point groups whose blocks take the fewest waves on the card times runs
    a block, the fewest of a tie, their partials (groups x B x mtot^3
    values) at most TYPE1_3D_F64_SCRATCH bytes, or one group, which writes
    the output itself: at 2e4 x 255 the points make one group, where the
    float64 CUDA-core kernel before it took 265 MB of partials beside the
    output."""
    geo = type1_3d_geometry(n, mtot, B, F64)
    tag, rows, cols, g, S, run, chunk = geo
    assert (tag, rows, run) == ("tc", cuda_nufft.TYPE1_2D_ROWS,
                                cuda_nufft.TYPE1_2D_F64_RUN)
    assert g == (1 if B == 1 else cuda_nufft.TYPE1_2D_BATCH_GROUP)
    tj = rows // g

    def layout(c):
        s, _, q, mi = type1_3d_f64_split(mtot, tj, c)
        tiles = -(-s * mi // tj) * -(-q * mi // c) * -(-B // g)
        return s, tiles, tiles * tj * c
    wide, narrow = layout(64), layout(32)
    assert cols == (32 if wide[2] >= 1.25 * narrow[2] else 64)
    S_, tiles = (narrow if cols == 32 else wide)[:2]
    assert S == S_
    assert chunk % run == 0
    groups = -(-n // chunk)
    assert (groups - 1) * chunk < n          # no empty group
    assert cuda_nufft._type1_3d_groups_of(n, geo) == groups
    partials = groups * B * mtot ** 3 * 16
    assert groups == 1 or partials <= cuda_nufft.TYPE1_3D_F64_SCRATCH
    nrun = -(-n // run)

    def cost(c):
        """waves of blocks x runs a block at groups of c runs"""
        return -(-tiles * -(-nrun // c) // cuda_nufft.CARD_SMS) * c
    for c in range(1, nrun + 1):
        gc = -(-nrun // c)
        if gc == 1 or gc * B * mtot ** 3 * 16 <= \
                cuda_nufft.TYPE1_3D_F64_SCRATCH:
            assert cost(chunk // run) <= cost(c)
            if cost(chunk // run) == cost(c):
                assert groups <= gc
    if (n, B) == (20_000, 1) and mtot == 255:
        assert groups == 1


def test_f64_3d_wrapper_takes_plain_version_on_cpu():
    """A float64 CPU tensor goes to the plain version, bit for bit, and
    counts no launch; CudaNUFFT's d=3 type-1 likewise."""
    n, mtot, h = 500, 13, 0.3
    x, v = _inputs(11, n, 3)
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    before = (dict(cuda_nufft.LAUNCHES), dict(cuda_nufft.LAUNCH_WIDTHS),
              dict(cuda_nufft.LAUNCH_PRECISIONS))
    assert torch.equal(nufft1_3d(xt, vt[0], h, mtot=mtot),
                       nufft1_3d_ref(xt, vt[0], h, mtot=mtot))
    assert torch.equal(nufft1_3d(xt, vt, h, mtot=mtot, fft_order=True),
                       nufft1_3d_ref(xt, vt, h, mtot=mtot, fft_order=True))
    op = cuda_nufft.CudaNUFFT(xt, h, mtot)
    assert torch.equal(op.type1(vt), nufft1_3d_ref(xt, vt, h, mtot=mtot))
    assert (dict(cuda_nufft.LAUNCHES), dict(cuda_nufft.LAUNCH_WIDTHS),
            dict(cuda_nufft.LAUNCH_PRECISIONS)) == before


@pytest.mark.parametrize("geo", [
    ("cuda",), ("tc", 64, 128, 1, 256, 1024, 2048),
    ("tc", 64, 32, 1, 256, 1024, 2048), ("tc", 64, 64, 1, 0, 512, 512),
    ("tc", 64, 64, 1, 9, 512, 512), ("tc", 64, 48, 1, 3, 512, 512),
    ("tc", 64, 64, 1, 3, 512), ("split", 64, 64, 1, 3, 512, 512),
    ("tc", 64, 64, 1, 3, 512, 512, 1)])
def test_f64_3d_launch_refuses_foreign_geometry(geo):
    """The float64 d=3 type-1's launch takes ("tc", rows, cols 32 or 64,
    group, split 1..8, run, chunk) and raises on anything else before it
    touches the card: the float32 tensor-core geometries (128 columns, or
    a stage of 256 where the split goes), the CUDA cores (the float64
    instance there is gone), a split out of range, a tile width it has no
    instance for, a field missing or added."""
    x = torch.zeros((8, 3), dtype=F64)
    v = torch.zeros((1, 8), dtype=torch.complex128)
    with pytest.raises(ValueError, match="no d=3 type-1 path"):
        cuda_nufft._nufft1_3d_on(x, v, 0.5, 5, False, geo)
