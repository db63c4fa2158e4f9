"""The float64 d=2 type-1 on the FP64 tensor cores (gpquad_torch.ops.
cuda_nufft: ``type1_2d_geometry`` at float64 and the kernel's plain twin
``nufft1_2d_f64_tc_ref``) against gpquad's float64 type-1.

The twin forms the kernel's operands (each phase the product of the mode
split's two factors, v folded into the first factor of e1) and makes its
sums in the kernel's order (k-steps of 8 points from zero in a run, the
runs in order into a group's partial, the groups in order).  It is held
within 1e-12 of max|ref| of gpquad's float64 ``nufft1``
(gpquad/ops/nufft.py:279, the MXU path with x64 on the CPU) and of the
port's plain version: both are float64 evaluations of the same sums, whose
phases differ by a rounding or two (~1e-15 of max|ref| here).  The kernel
itself runs on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py
phase 3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.ops.nufft import nufft1
from gpquad_torch.ops import cuda_nufft
from gpquad_torch.ops.cuda_nufft import (nufft1_2d, nufft1_2d_batched,
                                         nufft1_2d_batched_ref,
                                         nufft1_2d_f64_tc_ref, nufft1_2d_ref,
                                         type1_2d_geometry)

# The parity problems are small: torch's intra-op threads cost more than
# they give on them, most of all beside other test processes.
torch.set_num_threads(1)

BAR = 1e-12


def _inputs(seed, n, B):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 2))
    v = rng.normal(size=(B, n)) + 1j * rng.normal(size=(B, n))
    return x, v


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# mtot 29 (narrow tiles) and 57 (wide) at most 64, 77 and 93 past it (93
# on the narrow tiles); n ragged against the k-step (8), the run (512) and
# the group; chunk 1024 puts two runs in a group, and three or four groups
# in a call; B 1 and odd B 3 and 5 (the batch in pairs, the last alone)
@pytest.mark.parametrize("n,mtot,B,h,fft_order,chunk", [
    (3001, 29, 1, 0.65, False, 1024),
    (3001, 29, 3, 0.65, True, 1024),
    (2501, 57, 1, 0.4, True, None),
    (1999, 57, 5, 0.4, False, 1024),
    (2100, 77, 1, 0.3, False, 1024),
    (1203, 77, 3, 0.3, True, None),
    (1500, 93, 1, 0.13, True, 512),
])
def test_f64_twin_matches_gpquad(n, mtot, B, h, fft_order, chunk):
    x, v = _inputs(n + mtot, n, B)
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    arg = vt[0] if B == 1 else vt
    twin = nufft1_2d_f64_tc_ref(xt, arg, h, mtot=mtot, fft_order=fft_order,
                                chunk=chunk).numpy()
    assert twin.dtype == np.complex128
    assert twin.shape == ((mtot, mtot) if B == 1 else (B, mtot, mtot))
    want = np.asarray(nufft1(jnp.asarray(x), jnp.asarray(v), h, mtot,
                             fft_order=fft_order))
    assert want.dtype == np.complex128
    assert _rel(twin.reshape(want.shape), want) <= BAR
    plain = nufft1_2d_batched_ref(xt, vt, h, mtot=mtot,
                                  fft_order=fft_order).numpy()
    assert _rel(twin.reshape(plain.shape), plain) <= BAR


@pytest.mark.parametrize("fft_order", [False, True])
def test_f64_twin_is_the_single_plain_version(fft_order):
    """One vector: the twin's (mtot, mtot) grid against nufft1_2d_ref in the
    same mode order, with the geometry's own point groups."""
    n, mtot, h = 4099, 41, 0.5
    x, v = _inputs(7, n, 1)
    xt, vt = torch.as_tensor(x), torch.as_tensor(v[0])
    chunk = type1_2d_geometry(n, mtot, dtype=torch.float64)[-1]
    assert chunk < n            # more than one group
    twin = nufft1_2d_f64_tc_ref(xt, vt, h, mtot=mtot, fft_order=fft_order)
    ref = nufft1_2d_ref(xt, vt, h, mtot=mtot, fft_order=fft_order)
    assert _rel(twin.numpy(), ref.numpy()) <= BAR


def test_f64_twin_order_of_sums():
    """The twin's sums depend on the groups and runs only through their
    rounding: other point groups move the result by ~1e-16 of max|ref|,
    never by more than the bar."""
    n, mtot, h = 3000, 21, 0.7
    x, v = _inputs(3, n, 2)
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    a = nufft1_2d_f64_tc_ref(xt, vt, h, mtot=mtot, chunk=512).numpy()
    b = nufft1_2d_f64_tc_ref(xt, vt, h, mtot=mtot, chunk=3072).numpy()
    assert _rel(a, b) <= BAR
    with pytest.raises(ValueError, match="multiple"):
        nufft1_2d_f64_tc_ref(xt, vt, h, mtot=mtot, chunk=700)


# the driven float64 shapes (chip_smoke.py phase 3): the headline, hard,
# Matern and scale single calls, the probe batches (B 10, the PG B 11),
# and a single point
@pytest.mark.parametrize("n,mtot,B,batched", [
    (100_000, 29, 1, False), (100_000, 57, 1, False),
    (100_000, 107, 1, False), (100_000, 213, 1, False),
    (20_000, 93, 1, False), (20_000, 185, 1, False),
    (1_000_000, 339, 1, False), (1_000_000, 677, 1, False),
    (100_000, 29, 10, True), (100_000, 107, 10, True),
    (20_000, 93, 10, True), (100_000, 17, 11, True),
    (24_010, 43, 11, True), (1, 3, 1, False), (1, 5, 3, True)])
def test_type1_2d_f64_geometry(n, mtot, B, batched):
    """The tile (64 rows; 32 columns where 64 would pad the columns 1.25x
    as far, else 64), the batch group, whole runs in a group, none of the
    groups empty, at most TYPE1_2D_BLOCKS blocks where the points allow,
    and a scratch of groups x B x mtot^2 values: at the scale lag table
    (n 1e6, mtot 677) under 64 MB, against the 3.59 GB of the 2048-point
    chunks the CUDA-core kernel before it took."""
    rows, cols, g, run, chunk = type1_2d_geometry(n, mtot, B, batched,
                                                  torch.float64)
    assert (rows, run) == (cuda_nufft.TYPE1_2D_ROWS,
                           cuda_nufft.TYPE1_2D_F64_RUN)
    assert g == (cuda_nufft.TYPE1_2D_BATCH_GROUP if batched else 1)
    wide, narrow = -(-mtot // 64) * 64, -(-mtot // 32) * 32
    assert cols == (32 if wide >= 1.25 * narrow else 64)
    assert run % 32 == 0 and chunk % run == 0
    groups = -(-n // chunk)
    assert (groups - 1) * chunk < n          # no empty group
    tiles = -(-mtot // (rows // g)) * -(-mtot // cols) * -(-B // g)
    assert tiles * groups <= max(tiles, cuda_nufft.TYPE1_2D_BLOCKS)
    scratch = groups * B * mtot ** 2 * 16
    assert scratch <= cuda_nufft.TYPE1_2D_BLOCKS * B * mtot ** 2 * 16
    if (n, mtot) == (1_000_000, 677):
        pr1 = -(-n // cuda_nufft.TYPE1_CHUNK) * B * mtot ** 2 * 16
        assert scratch < 64e6 and pr1 > 3.5e9


def test_f64_wrappers_take_plain_version_on_cpu():
    """A float64 CPU tensor goes to the plain version, bit for bit, and
    counts no launch."""
    n, mtot, h = 500, 13, 0.3
    x, v = _inputs(11, n, 3)
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    before = (dict(cuda_nufft.LAUNCHES), dict(cuda_nufft.LAUNCH_WIDTHS),
              dict(cuda_nufft.LAUNCH_PRECISIONS))
    assert torch.equal(nufft1_2d(xt, vt[0], h, mtot=mtot),
                       nufft1_2d_ref(xt, vt[0], h, mtot=mtot))
    assert torch.equal(nufft1_2d_batched(xt, vt, h, mtot=mtot),
                       nufft1_2d_batched_ref(xt, vt, h, mtot=mtot))
    assert (dict(cuda_nufft.LAUNCHES), dict(cuda_nufft.LAUNCH_WIDTHS),
            dict(cuda_nufft.LAUNCH_PRECISIONS)) == before


@pytest.mark.parametrize("geo", [
    ("tc", 64, 64, 1, 512, 2048), ("cuda", 2048), (64, 64, 1, 512),
    (64, 64, 1, 256, 1024, 2048)])
def test_f64_launch_refuses_foreign_geometry(geo):
    """The float64 type-1's launch takes (rows, cols, group, run, chunk)
    and raises on anything else before it touches the card (the float32
    geometry included)."""
    x = torch.zeros((8, 2), dtype=torch.float64)
    v = torch.zeros((1, 8), dtype=torch.complex128)
    with pytest.raises(ValueError, match="float64 d=2 type-1"):
        cuda_nufft._nufft1_2d_on(x, v, 0.5, 5, False, geo, False)
