"""The d=2 NUFFT kernels' wrappers and plain versions
(gpquad_torch.ops.cuda_nufft) against the Pallas kernels they replace.

Off the TPU the Pallas kernels run in interpret mode
(gpquad/ops/pallas_nufft.py:119-120).  On the CPU the wrappers take the
plain version; the bar is 5e-5 * max|ref| in float32, the one
tests/test_pallas_nufft.py uses between the Pallas and the MXU paths (two
f32 evaluations of the same sums, with different sin/cos and summation
order).  The kernels themselves run in tests/test_torch_cuda_kernels.py
on the card.

The float32 type-1's tensor-core twin ``nufft1_2d_3xtf32_ref`` is held
against the float64 plain version at max(2x the float32 plain version's own
error, 1e-6) of max|ref| (the same bar chip_smoke.py holds the kernel to),
a plain-TF32 control (big*big alone) must read above that bar, and the twin
must match the Pallas kernels at the 5e-5 above.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.ops.pallas_nufft import (_MODE_TILE, pallas_nufft1_2d,
                                     pallas_nufft1_2d_batched,
                                     pallas_nufft2_2d)
from gpquad_torch.ops import cuda_nufft
from gpquad_torch.ops.cuda_nufft import (CudaNUFFT, nufft1_2d,
                                         nufft1_2d_3xtf32_ref,
                                         nufft1_2d_batched_ref, nufft1_2d_ref,
                                         nufft2_2d, nufft2_2d_ref,
                                         type1_2d_chunk)

# The parity problems are small: torch's intra-op threads cost more than
# they give on them, most of all beside other test processes.
torch.set_num_threads(1)


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _inputs(rng, n, mtot, span=1.0):
    x = rng.uniform(-span, span, (n, 2)).astype(np.float32)
    v = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    f = (rng.normal(size=(mtot, mtot))
         + 1j * rng.normal(size=(mtot, mtot))).astype(np.complex64)
    return x, v, f


# n=700 with tile=512 leaves a ragged last tile; mtot=9 is the smallest grid
# the JAX tests use; 31 in both orders is the variance evaluation's shape.
@pytest.mark.parametrize("n,mtot,h,fft_order", [
    (700, 9, 0.31, False),
    (700, 9, 0.31, True),
    (1100, 31, 0.05, False),
    (1100, 31, 0.05, True),
])
def test_plain_versions_match_pallas(rng, n, mtot, h, fft_order):
    x, v, f = _inputs(rng, n, mtot)
    want2 = np.asarray(pallas_nufft2_2d(jnp.asarray(x), jnp.asarray(f), h,
                                        mtot=mtot, fft_order=fft_order))
    got2 = nufft2_2d_ref(torch.as_tensor(x), torch.as_tensor(f), h,
                         mtot=mtot, fft_order=fft_order).numpy()
    assert _rel(got2, want2) < 5e-5
    want1 = np.asarray(pallas_nufft1_2d(jnp.asarray(x), jnp.asarray(v), h,
                                        mtot=mtot, fft_order=fft_order))
    got1 = nufft1_2d_ref(torch.as_tensor(x), torch.as_tensor(v), h,
                         mtot=mtot, fft_order=fft_order).numpy()
    assert got1.shape == (mtot, mtot)
    assert _rel(got1, want1) < 5e-5


@pytest.mark.parametrize("fft_order", [False, True])
def test_plain_versions_match_mode_tiled_pallas(rng, fft_order):
    """mtot > 256 runs the mode-tiled Pallas kernels (rows 3-4 of the TPU
    kernel table); the CUDA kernels take any odd mtot in one kernel."""
    n, mtot, h = 600, _MODE_TILE + 45, 0.011
    x, v, _ = _inputs(rng, n, mtot, span=2.0)
    f = rng.normal(size=(mtot, mtot)).astype(np.complex64)
    want2 = np.asarray(pallas_nufft2_2d(jnp.asarray(x), jnp.asarray(f), h,
                                        mtot=mtot, tile=256,
                                        fft_order=fft_order))
    got2 = nufft2_2d(torch.as_tensor(x), torch.as_tensor(f), h, mtot=mtot,
                     fft_order=fft_order).numpy()
    assert _rel(got2, want2) < 5e-5
    want1 = np.asarray(pallas_nufft1_2d(jnp.asarray(x), jnp.asarray(v), h,
                                        mtot=mtot, tile=256,
                                        fft_order=fft_order))
    got1 = nufft1_2d(torch.as_tensor(x), torch.as_tensor(v), h, mtot=mtot,
                     fft_order=fft_order).numpy()
    assert _rel(got1, want1) < 5e-5


def test_wrappers_take_plain_version_on_cpu(rng):
    """A CPU tensor goes to the plain version and counts no launch."""
    x, v, f = _inputs(rng, 300, 9)
    before = dict(cuda_nufft.LAUNCHES)
    xt = torch.as_tensor(x)
    np.testing.assert_array_equal(
        nufft2_2d(xt, torch.as_tensor(f), 0.3, mtot=9).numpy(),
        nufft2_2d_ref(xt, torch.as_tensor(f), 0.3, mtot=9).numpy())
    np.testing.assert_array_equal(
        nufft1_2d(xt, torch.as_tensor(v), 0.3, mtot=9).numpy(),
        nufft1_2d_ref(xt, torch.as_tensor(v), 0.3, mtot=9).numpy())
    assert cuda_nufft.LAUNCHES == before


def test_wrappers_validate_shapes():
    with pytest.raises(ValueError, match=r"\(N, 2\)"):
        nufft2_2d(torch.zeros(5, 3), torch.zeros(9, dtype=torch.complex64),
                  0.1, mtot=3)
    with pytest.raises(ValueError, match="odd"):
        nufft1_2d(torch.zeros(5, 2), torch.zeros(5, dtype=torch.complex64),
                  0.1, mtot=4)
    with pytest.raises(TypeError):
        nufft1_2d(torch.zeros(5, 2, dtype=torch.int32),
                  torch.zeros(5, dtype=torch.complex64), 0.1, mtot=3)


def test_cuda_backend_batches_over_single_kernel(rng):
    """CudaNUFFT's batched applies (one batched wrapper call, the plain
    batched version on CPU tensors) equal the single-vector plain version
    row by row."""
    n, mtot, h, B = 200, 9, 0.2, 3
    x = torch.as_tensor(rng.uniform(-1, 1, (n, 2)))
    op = CudaNUFFT(x=x, h=h, mtot=mtot)
    V = torch.as_tensor(rng.normal(size=(B, n)) + 0j)
    got = op.type1(V)
    assert got.shape == (B, mtot, mtot)
    for b in range(B):
        np.testing.assert_allclose(
            got[b].numpy(), nufft1_2d_ref(x, V[b], h, mtot=mtot).numpy(),
            rtol=1e-13, atol=1e-12)
    F = torch.as_tensor(rng.normal(size=(2, B, mtot * mtot)) + 0j)
    got2 = op.type2(F)
    assert got2.shape == (2, B, n)
    np.testing.assert_allclose(
        got2[1, 2].numpy(),
        nufft2_2d_ref(x, F[1, 2], h, mtot=mtot).numpy(), rtol=1e-13,
        atol=1e-12)


# mtot 29 and 57 as the headline's type-1 calls, 261 past the TPU's 256-mode
# block (the mode-tiled Pallas kernel); chunk 2048 puts two runs of 1024
# points in a group and n = 5000 three groups, the last one short
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("n,mtot,h,fft_order", [
    (5000, 29, 0.65, False),
    (3000, 57, 0.65, True),
    (400, _MODE_TILE + 5, 0.011, False),
])
def test_3xtf32_twin_meets_the_split_bar(rng, B, n, mtot, h, fft_order):
    x = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    v = (rng.normal(size=(B, n))
         + 1j * rng.normal(size=(B, n))).astype(np.complex64)
    hq = float(np.float32(h))
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    kw = dict(mtot=mtot, fft_order=fft_order)
    ref = nufft1_2d_batched_ref(xt.double(), vt.to(torch.complex128), hq,
                                **kw).numpy()
    scale = np.max(np.abs(ref))

    def err(a):
        return np.max(np.abs(a.reshape(ref.shape) - ref)) / scale
    plain = nufft1_2d_batched_ref(xt, vt, hq, **kw).numpy()
    bar = max(2 * err(plain), 1e-6)
    arg = vt[0] if B == 1 else vt
    twin = nufft1_2d_3xtf32_ref(xt, arg, hq, chunk=2048, **kw).numpy()
    assert twin.shape == ((mtot, mtot) if B == 1 else (B, mtot, mtot))
    assert err(twin) <= bar
    control = nufft1_2d_3xtf32_ref(xt, arg, hq, chunk=2048, passes=1,
                                   **kw).numpy()
    assert err(control) > bar
    xj, vj = jnp.asarray(x), jnp.asarray(v)
    if B == 1:
        want = pallas_nufft1_2d(xj, vj[0], hq, tile=256, **kw)
    elif mtot <= _MODE_TILE:
        want = pallas_nufft1_2d_batched(xj, vj, hq, tile=256, **kw)
    else:       # gpquad maps the mode-tiled function over a wide batch
        want = np.stack([pallas_nufft1_2d(xj, vj[b], hq, tile=256, **kw)
                         for b in range(B)])
    assert _rel(twin, np.asarray(want)) < 5e-5


def test_tf32_rounding_is_cvt_rna():
    """The twin's TF32 rounding keeps 10 mantissa bits, to nearest with
    ties away from zero, on both signs; the split's small part carries the
    rest."""
    ulp = 2.0 ** -10
    a = np.array([1 + ulp / 2, 1 + ulp / 2 - 2 ** -23, 1 + 1.5 * ulp,
                  -(1 + ulp / 2), 3.0, 0.0, -2 ** -130], np.float32)
    want = np.array([1 + ulp, 1.0, 1 + 2 * ulp, -(1 + ulp), 3.0, 0.0,
                     -2 ** -130], np.float32)
    got = cuda_nufft._tf32(torch.as_tensor(a)).numpy()
    assert np.array_equal(got, want)
    z = torch.as_tensor(np.random.default_rng(1).normal(size=1000)
                        .astype(np.float32))
    big, small = cuda_nufft._split3(z)
    for t in (big, small):
        assert not np.any(t.numpy().view(np.int32) & 0x1FFF)
    rest = (z.double() - big.double() - small.double()).abs()
    assert float((rest / z.double().abs()).max()) < 2.0 ** -21


@pytest.mark.parametrize("n,mtot,B,batched", [
    (100_000, 29, 1, False), (1_000_000, 677, 1, False),
    (1_000_000, 339, 10, True), (1_000_000, 339, 5, True),
    (1_000, 339, 1, False), (1, 3, 1, False), (100_000, 57, 10, True)])
def test_type1_2d_groups(n, mtot, B, batched):
    """The float32 type-1's geometry and point groups: the narrow tile up
    to mtot 64, whole runs of whole register sums, none empty, at most
    TYPE1_2D_BLOCKS blocks where the points allow, and the scratch at the
    scale lag table (n 1e6, mtot 677) under 256 MB."""
    rows, cols, g, stage, run, chunk = cuda_nufft.type1_2d_geometry(
        n, mtot, B, batched)
    assert chunk == type1_2d_chunk(n, mtot, B, batched)
    assert (rows, g, stage, run) == (
        cuda_nufft.TYPE1_2D_ROWS, cuda_nufft.TYPE1_2D_BATCH_GROUP
        if batched else 1, cuda_nufft.TYPE1_2D_STAGE, cuda_nufft.TYPE1_2D_RUN)
    assert cols == (32 if mtot <= 64 else 128)
    assert run % stage == 0 and stage % 32 == 0
    assert chunk % run == 0
    groups = -(-n // chunk)
    assert (groups - 1) * chunk < n
    tiles = -(-mtot // (rows // g)) * -(-mtot // cols) * -(-B // g)
    assert tiles * groups <= max(tiles, cuda_nufft.TYPE1_2D_BLOCKS)
    if (n, mtot) == (1_000_000, 677):
        assert groups * B * mtot ** 2 * 8 < 256e6
