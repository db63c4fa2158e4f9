"""The float64 d=2 type-2 on the FP64 tensor cores (gpquad_torch.ops.
cuda_nufft: ``type2_2d_geometry`` and ``type2_2d_single_geometry`` at
float64 and the kernel's plain twin ``nufft2_2d_f64_tc_ref``) against
gpquad's float64 type-2.

The twin forms the kernel's operands (the modes in symmetric order, each
phase the product of the mode split's two factors, the modes k padded to
whole k-steps of 8) and makes its sums in the kernel's order (k-steps of 8
modes from zero, then each vector's columns of an epilogue pass of 32 in j
order from zero, the passes added in order).  It is held within 1e-12 of
max|ref| of gpquad's float64 ``nufft2`` (gpquad/ops/nufft.py:284, the MXU
path with x64 on the CPU) and of the port's plain version: both are
float64 evaluations of the same sums, whose phases differ by a rounding or
two (~1e-15 of max|ref| here).  The kernel itself runs on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py phase 3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.ops.nufft import nufft2
from gpquad_torch.ops import cuda_nufft
from gpquad_torch.ops.cuda_nufft import (nufft2_2d, nufft2_2d_batched,
                                         nufft2_2d_batched_ref,
                                         nufft2_2d_f64_tc_ref, nufft2_2d_ref,
                                         type2_2d_f64_scratch_doubles,
                                         type2_2d_geometry,
                                         type2_2d_single_geometry)

# The parity problems are small: torch's intra-op threads cost more than
# they give on them, most of all beside other test processes.
torch.set_num_threads(1)

BAR = 1e-12


def _inputs(seed, n, mtot, B):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 2))
    f = (rng.normal(size=(B, mtot, mtot))
         + 1j * rng.normal(size=(B, mtot, mtot)))
    return x, f


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# PG's mtot 17 and 21, the headline's 29, PG's spatial 43, and 77 past the
# 48 modes whose e2 a block keeps (its chunks made again a column tile);
# n ragged against the k-step (8) and the block's 64 points; B 1, 3 and
# 11 (vectors crossing the epilogue's passes of 32 columns and the tiles
# of 64); both mode orders
@pytest.mark.parametrize("n,mtot,B,h,fft_order", [
    (1001, 17, 11, 0.4, False),
    (777, 17, 1, 0.4, True),
    (1203, 21, 11, 0.4, True),
    (997, 21, 3, 0.4, False),
    (1500, 29, 3, 0.65, False),
    (1027, 29, 1, 0.65, True),
    (601, 43, 11, 0.4, False),
    (999, 43, 3, 0.4, True),
    (700, 77, 1, 0.3, False),
    (531, 77, 3, 0.3, True),
])
def test_f64_type2_twin_matches_gpquad(n, mtot, B, h, fft_order):
    x, f = _inputs(n + mtot, n, mtot, B)
    xt, ft = torch.as_tensor(x), torch.as_tensor(f)
    twin = nufft2_2d_f64_tc_ref(xt, ft, h, mtot=mtot,
                                fft_order=fft_order).numpy()
    assert twin.dtype == np.complex128
    assert twin.shape == (B, n)
    want = np.asarray(nufft2(jnp.asarray(x), jnp.asarray(f), h, mtot,
                             fft_order=fft_order))
    assert want.dtype == np.complex128
    assert _rel(twin, want) <= BAR
    plain = nufft2_2d_batched_ref(xt, ft, h, mtot=mtot,
                                  fft_order=fft_order).numpy()
    assert _rel(twin, plain) <= BAR
    # the flat mode layout is the same apply
    flat = nufft2_2d_f64_tc_ref(xt, ft.reshape(B, -1), h, mtot=mtot,
                                fft_order=fft_order).numpy()
    np.testing.assert_array_equal(flat, twin)


@pytest.mark.parametrize("fft_order", [False, True])
def test_f64_type2_twin_is_the_single_plain_version(fft_order):
    """One vector, as the single type-2 launches the kernel at B 1: the
    twin's (1, N) against nufft2_2d_ref in the same mode order."""
    n, mtot, h = 2049, 57, 0.5
    x, f = _inputs(5, n, mtot, 1)
    xt, ft = torch.as_tensor(x), torch.as_tensor(f)
    twin = nufft2_2d_f64_tc_ref(xt, ft, h, mtot=mtot, fft_order=fft_order)
    ref = nufft2_2d_ref(xt, ft[0], h, mtot=mtot, fft_order=fft_order)
    assert _rel(twin[0].numpy(), ref.numpy()) <= BAR


def test_f64_type2_twin_order_of_sums():
    """The twin's sums depend on the epilogue's passes only through their
    rounding: one pass a vector, or passes of 8 columns, move the result by
    ~1e-16 of max|ref|, never by more than the bar; a pass takes at least
    one column."""
    n, mtot, h = 900, 21, 0.7
    x, f = _inputs(3, n, mtot, 5)
    xt, ft = torch.as_tensor(x), torch.as_tensor(f)
    base = nufft2_2d_f64_tc_ref(xt, ft, h, mtot=mtot).numpy()
    for chunk in (8, 5 * mtot):
        other = nufft2_2d_f64_tc_ref(xt, ft, h, mtot=mtot,
                                     chunk=chunk).numpy()
        assert _rel(other, base) <= BAR
    with pytest.raises(ValueError, match="chunk"):
        nufft2_2d_f64_tc_ref(xt, ft, h, mtot=mtot, chunk=0)


# the driven float64 batched shapes (chip_smoke.py phase 3: the headline's
# and hard's B 10, PG's and the samplers' B 11), a single vector on narrow
# and wide grids, and the edges of the 1.25x rule
@pytest.mark.parametrize("mtot,B,cols", [
    (29, 10, 64), (107, 10, 64), (17, 11, 64), (21, 11, 64), (43, 11, 64),
    (29, 1, 32), (93, 1, 32), (107, 1, 64), (339, 1, 64), (57, 1, 64),
    (15, 1, 32), (3, 1, 32), (5, 3, 32), (41, 1, 64)])
def test_type2_2d_f64_geometry(mtot, B, cols):
    """The FP64 tensor-core geometry: blocks of 64 points, 16 modes k a
    stage, column tiles of 64, or 32 where 64 pads the B * mtot columns
    1.25x as far; float64 batched calls take it at every mtot; its scratch
    holds both parts of each (mode k, column) cell, the modes padded to
    whole k-steps of 8 (17 -> 24, not 32) and the columns to whole tiles."""
    geo = type2_2d_geometry(mtot, torch.float64, B)
    assert geo == ("tc", cuda_nufft.TYPE2_2D_F64_POINTS, cols,
                   cuda_nufft.TYPE2_2D_F64_STAGE) == ("tc", 64, cols, 16)
    assert type2_2d_geometry(mtot, torch.float64, B) == geo
    wide, narrow = -(-B * mtot // 64) * 64, -(-B * mtot // 32) * 32
    assert (cols == 32) == (wide >= 1.25 * narrow)
    kq = -(-mtot // 8) * 8
    assert kq - mtot < 8
    doubles = type2_2d_f64_scratch_doubles(mtot, B, geo)
    assert doubles == 2 * kq * -(-B * mtot // cols) * cols
    if (mtot, B) == (17, 11):
        assert doubles == 2 * 24 * 192
    if (mtot, B) == (43, 11):
        # PG's spatial batch: 590 KB, in the L2
        assert doubles * 8 < 600e3


# the float32 batched table stays as it was
@pytest.mark.parametrize("mtot", [9, 29, 63, 64, 107, 339])
def test_type2_2d_geometry_float32_unchanged(mtot):
    geo = type2_2d_geometry(mtot)
    assert geo == type2_2d_geometry(mtot, torch.float32, 10)
    if mtot >= cuda_nufft.TYPE2_2D_TC_MIN_MTOT:
        assert geo == ("tc", 128, 128, 32)
    else:
        assert geo == ("cuda",)


def test_type2_2d_single_geometry_f64_takes_the_kernel():
    """Where the single float64 type-2 takes the FP64 tensor cores it takes
    this geometry at B 1."""
    for n in (1, 1000, 10_000, 100_000, 1_000_000):
        for mtot in (11, 15, 29, 43, 57, 93, 107, 339, 677):
            geo = type2_2d_single_geometry(n, mtot, torch.float64)
            assert geo[0] in ("tc", "split", "cuda")
            if geo[0] == "tc":
                assert geo == type2_2d_geometry(mtot, torch.float64, 1)


@pytest.mark.parametrize("geo", [
    ("tc", 128, 128, 32), ("tc", 64, 128, 16), ("tc", 64, 64, 32),
    ("tc", 32, 64, 16), ("tc", 64, 64, 16, 6)])
def test_type2_f64_refuses_foreign_geometry(geo):
    """The float64 type-2's launches take (points, cols, stage) of an
    instance and raise on anything else before they touch the card (the
    float32 geometry included)."""
    x = torch.zeros((8, 2), dtype=torch.float64)
    f = torch.zeros((2, 5, 5), dtype=torch.complex128)
    with pytest.raises(ValueError, match="float64 d=2 type-2"):
        cuda_nufft._nufft2_2d_batched_on(x, f, 0.5, 5, False, geo)
    with pytest.raises(ValueError, match="float64 d=2 type-2"):
        cuda_nufft._nufft2_2d_on(x, f[0], 0.5, 5, False, geo)


def test_f64_batched_type2_has_no_cuda_core_kernel():
    """The float64 batched type-2 runs on the FP64 tensor cores alone: the
    CUDA-core geometry is refused in float64 (the float32 batch keeps it)
    before anything is launched."""
    x = torch.zeros((8, 2), dtype=torch.float64)
    f = torch.zeros((2, 5, 5), dtype=torch.complex128)
    with pytest.raises(ValueError, match="float64 batched type-2"):
        cuda_nufft._nufft2_2d_batched_on(x, f, 0.5, 5, False, ("cuda",))
    assert all(type2_2d_geometry(m, torch.float64, B)[0] == "tc"
               for m in (1, 3, 17, 63, 64, 339, 677) for B in (1, 2, 11))


def test_f64_type2_wrappers_take_plain_version_on_cpu():
    """Float64 CPU tensors go to the plain versions, bit for bit, and count
    no launch."""
    n, mtot, h = 500, 17, 0.3
    x, f = _inputs(11, n, mtot, 3)
    xt, ft = torch.as_tensor(x), torch.as_tensor(f)
    before = (dict(cuda_nufft.LAUNCHES), dict(cuda_nufft.LAUNCH_WIDTHS),
              dict(cuda_nufft.LAUNCH_PRECISIONS))
    assert torch.equal(nufft2_2d_batched(xt, ft, h, mtot=mtot),
                       nufft2_2d_batched_ref(xt, ft, h, mtot=mtot))
    assert torch.equal(nufft2_2d(xt, ft[0], h, mtot=mtot),
                       nufft2_2d_ref(xt, ft[0], h, mtot=mtot))
    assert (dict(cuda_nufft.LAUNCHES), dict(cuda_nufft.LAUNCH_WIDTHS),
            dict(cuda_nufft.LAUNCH_PRECISIONS)) == before
