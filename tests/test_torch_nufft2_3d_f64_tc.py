"""The float64 d=3 type-2 on the FP64 tensor cores (gpquad_torch.ops.
cuda_nufft: ``type2_3d_geometry`` at float64, ``type2_3d_f64_split``,
``type2_3d_f64_scratch_doubles`` and the kernel's plain twin
``nufft2_3d_f64_tc_ref``) against gpquad's float64 type-2 at d=3.

The twin forms the kernel's operands (the reduction over the pairs (j2,
j3) in k-steps of one j2 and 8 modes j3, j3 padded to whole k-steps; A's
entry the k-step's factor e2(j2) e(t3, 8 s - half) times e(t3, r), every
phase the product of the mode split's two factors) and makes its sums in
the kernel's order (k-steps from zero in a split's T, then each vector's
columns of an epilogue pass of 32 in j1 order from zero, the passes added
in order, the splits added in order).  It is held within 1e-12 of max|ref|
of gpquad's float64 ``nufft2`` (gpquad/ops/nufft.py:284, the MXU path with
x64 on the CPU) and of the port's plain version ``nufft2_3d_ref``: float64
evaluations of the same sums whose phases differ by a rounding or three
(~1e-15 of max|ref| here).  The kernel itself runs on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py phase 3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.ops.nufft import nufft2
from gpquad_torch.ops import cuda_nufft
from gpquad_torch.ops.cuda_nufft import (nufft2_3d, nufft2_3d_f64_tc_ref,
                                         nufft2_3d_ref, type2_2d_geometry,
                                         type2_3d_f64_scratch_doubles,
                                         type2_3d_f64_split,
                                         type2_3d_geometry)

# The parity problems are small: torch's intra-op threads cost more than
# they give on them, most of all beside other test processes.
torch.set_num_threads(1)

BAR = 1e-12
F64 = torch.float64


def _inputs(seed, n, mtot, B):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 3))
    f = (rng.normal(size=(B, mtot, mtot, mtot))
         + 1j * rng.normal(size=(B, mtot, mtot, mtot)))
    return x, f


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# hard3d's mtot 21, its variance evaluation's 41 in FFT order, and 57 past
# the TPU's single-block 56 (_pallas_nufft2_3d_tiled); n ragged against the
# block's 64 points and the k-step's 8; B 1 and odd B 3 (vectors crossing
# the epilogue's passes of 32 columns); the default splits (16 at few
# points: a split of 4 k-steps at 21, ragged at 57) and others
@pytest.mark.parametrize("n,mtot,B,h,fft_order,splits", [
    (301, 21, 1, 0.65, False, None),
    (203, 21, 3, 0.65, True, 5),
    (451, 41, 1, 0.4, True, None),
    (131, 41, 3, 0.4, False, 7),
    (97, 57, 1, 0.3, False, None),
    (75, 57, 3, 0.3, True, 2),
])
def test_f64_3d_type2_twin_matches_gpquad(n, mtot, B, h, fft_order, splits):
    x, f = _inputs(n + mtot, n, mtot, B)
    xt, ft = torch.as_tensor(x), torch.as_tensor(f)
    twin = nufft2_3d_f64_tc_ref(xt, ft, h, mtot=mtot, fft_order=fft_order,
                                splits=splits).numpy()
    assert twin.dtype == np.complex128
    assert twin.shape == (B, n)
    want = np.asarray(nufft2(jnp.asarray(x), jnp.asarray(f), h, mtot,
                             fft_order=fft_order))
    assert want.dtype == np.complex128
    assert _rel(twin, want.reshape(B, n)) <= BAR
    plain = nufft2_3d_ref(xt, ft, h, mtot=mtot, fft_order=fft_order).numpy()
    assert _rel(twin, plain) <= BAR
    # the flat mode layout is the same apply
    flat = nufft2_3d_f64_tc_ref(xt, ft.reshape(B, -1), h, mtot=mtot,
                                fft_order=fft_order, splits=splits).numpy()
    np.testing.assert_array_equal(flat, twin)


@pytest.mark.parametrize("fft_order", [False, True])
def test_f64_3d_type2_twin_single_vector(fft_order):
    """One vector, (mtot,)*3 or flat: the twin's (N,) against
    nufft2_3d_ref; mtot below a k-step (5: j3 padded to 8)."""
    for n, mtot in ((257, 5), (129, 13)):
        x, f = _inputs(mtot, n, mtot, 1)
        xt, ft = torch.as_tensor(x), torch.as_tensor(f[0])
        twin = nufft2_3d_f64_tc_ref(xt, ft, 0.5, mtot=mtot,
                                    fft_order=fft_order)
        assert twin.shape == (n,)
        ref = nufft2_3d_ref(xt, ft, 0.5, mtot=mtot, fft_order=fft_order)
        assert _rel(twin.numpy(), ref.numpy()) <= BAR
        flat = nufft2_3d_f64_tc_ref(xt, ft.reshape(-1), 0.5, mtot=mtot,
                                    fft_order=fft_order)
        assert torch.equal(flat, twin)


def test_f64_3d_type2_twin_order_of_sums():
    """The twin's sums depend on the splits and the epilogue's passes only
    through their rounding: one split or many, one pass a vector or passes
    of 8 columns, move the result by ~1e-16 of max|ref|, never by more
    than the bar; a pass takes at least one column."""
    n, mtot, h = 400, 21, 0.7
    x, f = _inputs(3, n, mtot, 3)
    xt, ft = torch.as_tensor(x), torch.as_tensor(f)
    base = nufft2_3d_f64_tc_ref(xt, ft, h, mtot=mtot, splits=1).numpy()
    for kw in (dict(splits=16), dict(splits=4), dict(chunk=8),
               dict(chunk=3 * mtot, splits=2)):
        other = nufft2_3d_f64_tc_ref(xt, ft, h, mtot=mtot, **kw).numpy()
        assert _rel(other, base) <= BAR
    with pytest.raises(ValueError, match="chunk"):
        nufft2_3d_f64_tc_ref(xt, ft, h, mtot=mtot, chunk=0)


def _coef_cell(b, j1, k, mtot):
    """The kernel's F_b[j1, k] (nufft_3d.cu Type2F64Grid3D::coef_index,
    symmetric order): the flat index of f[b, j1, j2, j3], or -1."""
    n3 = -(-mtot // 8)
    ks = k // 8
    j2, j3 = ks // n3, 8 * (ks % n3) + k % 8
    return ((b * mtot + j1) * mtot + j2) * mtot + j3 if j3 < mtot else -1


@pytest.mark.parametrize("mtot", [1, 5, 9, 21, 31, 41])
def test_type2_3d_f64_cells_hold_every_coefficient(mtot):
    """The reduction's J3 mtot indices k (J3 = mtot rounded up to whole
    k-steps of 8: 21 -> 24) and the columns j1 hold every coefficient
    f[j1, j2, j3] once, the other cells zero; a k-step is one j2 and 8
    modes j3, the j2 in order."""
    J3, steps = type2_3d_f64_split(mtot)
    assert J3 % 8 == 0 and J3 - mtot < 8 and steps == mtot * J3 // 8
    cells = np.array([[_coef_cell(0, j1, k, mtot) for j1 in range(mtot)]
                      for k in range(8 * steps)])
    held = cells[cells >= 0]
    assert np.array_equal(np.sort(held), np.arange(mtot ** 3))
    j2 = (cells // mtot) % mtot
    for ks in range(steps):
        used = j2[8 * ks:8 * ks + 8][cells[8 * ks:8 * ks + 8] >= 0]
        assert np.all(used == ks // (J3 // 8))


# chip_smoke.py phase 3's float64 d=3 type-2 shapes (d3's and hard3d's
# mean, variance evaluation and gradient F(D beta) and F(D'F*Z), the
# slab-tiled widths) and a few more: single points, the widest grid in a
# batch
@pytest.mark.parametrize("n,mtot,B", [
    (10_000, 31, 1), (10_000, 61, 1), (100_000, 31, 1), (100_000, 31, 10),
    (1_000, 21, 1), (1_000, 41, 1), (20_000, 21, 1), (20_000, 21, 10),
    (20_000, 57, 1), (20_000, 101, 1), (20_000, 255, 1), (20_000, 255, 3),
    (1, 1, 1), (1, 3, 2), (0, 9, 1)])
def test_type2_3d_f64_geometry(n, mtot, B):
    """The float64 d=2 type-2's blocks of 64 points and stage of 16, its
    column tiles on the B * mtot columns (32 where 64 pads them 1.25x as
    far), and the splits of the chunks of 4 k-steps that cost least (waves
    of blocks, two an SM on the card, times a split's k-steps and 8 more;
    the fewest of a tie), none empty; the scratch holds F (both parts of
    each (index k, column) cell) and, split, the partial outputs."""
    geo = type2_3d_geometry(n, mtot, B, F64)
    tag, points, cols, stage, splits = geo
    assert (tag, points, stage) == ("tc", 64, 16)
    assert cols == type2_2d_geometry(mtot, F64, B)[2]
    steps = type2_3d_f64_split(mtot)[1]
    nch = -(-steps // cuda_nufft.TYPE2_3D_F64_CHUNK)
    per = -(-nch // splits)
    assert -(-nch // per) == splits and (splits - 1) * per < nch
    assert 1 <= splits <= min(nch, cuda_nufft.TYPE2_3D_F64_MAX_SPLITS)
    blocks = -(-n // 64)

    def cost(s):
        return (-(-blocks * s // (2 * cuda_nufft.CARD_SMS))
                * (-(-nch // s) * 4 + cuda_nufft.TYPE2_3D_F64_SPLIT_OVERHEAD))
    best = min(cost(s) for s in range(1, min(16, nch) + 1))
    assert cost(splits) == best
    assert all(cost(s) > best for s in range(1, splits))
    ncp = -(-B * mtot // cols) * cols
    doubles = type2_3d_f64_scratch_doubles(n, mtot, B, geo)
    assert doubles == (2 * 8 * steps * ncp
                       + (2 * splits * B * n if splits > 1 else 0))
    if (n, mtot, B) == (20_000, 255, 1):
        # F the size of f itself (255 x 256 x 256 cells of 16 bytes)
        assert 2 * 8 * steps * ncp * 8 == 255 * 256 * 256 * 16


def test_type2_3d_f64_fills_the_card_at_few_points():
    """hard3d's mean (1 000 targets at mtot 21: 16 blocks of 64 points)
    splits its 16 chunks 16 ways, 256 blocks, one wave of two blocks an SM;
    d3's 1e5 points (1 563 blocks, six waves) take no split."""
    assert type2_3d_geometry(1_000, 21, 1, F64) == ("tc", 64, 32, 16, 16)
    assert type2_3d_geometry(1_000, 41, 1, F64)[4] == 16
    assert 16 * 16 <= 2 * cuda_nufft.CARD_SMS
    assert type2_3d_geometry(100_000, 31, 1, F64)[4] == 1
    assert type2_3d_geometry(100_000, 31, 10, F64) == ("tc", 64, 64, 16, 1)


# the float32 table stays as it was
@pytest.mark.parametrize("n,mtot,B,geo", [
    (1_000, 21, 1, ("tc", 128, 32, 32, 11)),
    (20_000, 21, 10, ("cuda",)),
    (10_000, 61, 1, ("tc", 128, 64, 32, 5)),
    (100_000, 31, 10, ("tc", 128, 64, 32, 1)),
    (20_000, 255, 1, ("tc", 128, 64, 32, 5))])
def test_type2_3d_geometry_float32_unchanged(n, mtot, B, geo):
    assert type2_3d_geometry(n, mtot, B) == geo
    assert type2_3d_geometry(n, mtot, B, torch.float32) == geo


def test_f64_3d_type2_wrapper_takes_plain_version_on_cpu():
    """Float64 CPU tensors go to the plain version, bit for bit, and count
    no launch; CudaNUFFT's d=3 type-2 likewise."""
    n, mtot, h = 500, 13, 0.3
    x, f = _inputs(11, n, mtot, 3)
    xt, ft = torch.as_tensor(x), torch.as_tensor(f)
    before = (dict(cuda_nufft.LAUNCHES), dict(cuda_nufft.LAUNCH_WIDTHS),
              dict(cuda_nufft.LAUNCH_PRECISIONS))
    assert torch.equal(nufft2_3d(xt, ft[0], h, mtot=mtot),
                       nufft2_3d_ref(xt, ft[0], h, mtot=mtot))
    assert torch.equal(nufft2_3d(xt, ft, h, mtot=mtot, fft_order=True),
                       nufft2_3d_ref(xt, ft, h, mtot=mtot, fft_order=True))
    op = cuda_nufft.CudaNUFFT(xt, h, mtot)
    assert torch.equal(op.type2(ft), nufft2_3d_ref(xt, ft, h, mtot=mtot))
    assert (dict(cuda_nufft.LAUNCHES), dict(cuda_nufft.LAUNCH_WIDTHS),
            dict(cuda_nufft.LAUNCH_PRECISIONS)) == before


@pytest.mark.parametrize("geo", [
    ("cuda",), ("tc", 128, 32, 32, 11), ("tc", 128, 64, 32, 1),
    ("tc", 64, 128, 16, 1), ("tc", 64, 48, 16, 1), ("tc", 64, 64, 32, 1),
    ("tc", 32, 64, 16, 1), ("tc", 64, 64, 16, 0), ("tc", 64, 64, 16, 17),
    ("tc", 64, 64, 16), ("tc", 64, 64, 16, 1, 1), ("split", 64, 64, 16, 1)])
def test_f64_3d_type2_launch_refuses_foreign_geometry(geo):
    """The float64 d=3 type-2's launch takes ("tc", 64 points, cols 32 or
    64, stage 16, splits 1..16) and raises on anything else before it
    touches the card: the float32 geometries (the tensor cores' 128 points
    and stage of 32), the CUDA cores (the float64 instance there is gone),
    a tile width it has no instance for, splits out of range, a field
    missing or added."""
    x = torch.zeros((8, 3), dtype=F64)
    f = torch.zeros((1, 125), dtype=torch.complex128)
    with pytest.raises(ValueError, match="no d=3 type-2 path"):
        cuda_nufft._nufft2_3d_on(x, f, 0.5, 5, False, geo)
