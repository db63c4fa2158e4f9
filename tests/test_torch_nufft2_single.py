"""The single d=2 type-2's paths (gpquad_torch.ops.cuda_nufft.nufft2_2d):
their plain twins against the Pallas kernels they replace, and the
dispatch that picks a path from the shape.

Off the TPU the Pallas kernels run in interpret mode
(gpquad/ops/pallas_nufft.py:119-120), in float32 whatever the input; the
bar is tests/test_torch_cuda_nufft.py's 5e-5 * max|ref| for inputs in
float32 and float64 alike.  The mode split's twin ``nufft2_2d_split_ref``
is held against ``pallas_nufft2_2d`` up to 256 modes and against the
mode-tiled ``_pallas_nufft2_2d_tiled`` past them; the tensor-core path's
twin is the batched one's (``nufft2_2d_batched_3xtf32_ref``) at B 1, held
to the bar of ``test_type2_3xtf32_twin_meets_the_split_bar``.  The kernels
themselves run in tests/test_torch_cuda_kernels.py on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.ops.pallas_nufft import _MODE_TILE, pallas_nufft2_2d
from gpquad_torch.ops import cuda_nufft
from gpquad_torch.ops.cuda_nufft import (nufft2_2d,
                                         nufft2_2d_batched_3xtf32_ref,
                                         nufft2_2d_ref, nufft2_2d_split_ref,
                                         type2_2d_single_geometry)

torch.set_num_threads(1)


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _inputs(rng, n, mtot, dtype, span=1.0):
    x = rng.uniform(-span, span, (n, 2)).astype(np.float32)
    f = (rng.normal(size=(mtot, mtot))
         + 1j * rng.normal(size=(mtot, mtot))).astype(np.complex64)
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    return x, f, torch.as_tensor(x).to(dtype), torch.as_tensor(f).to(cdt)


# slabs of 16 modes j: mtot 9 is one slab, 31 two, 71 and 107 several with
# a short last one; both mode orders
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,mtot,h,fft_order", [
    (700, 9, 0.31, False),
    (1100, 31, 0.05, True),
    (900, 71, 0.05, False),
    (600, 107, 0.1, True),
])
def test_split_twin_matches_pallas(rng, dtype, n, mtot, h, fft_order):
    x, f, xt, ft = _inputs(rng, n, mtot, dtype)
    want = np.asarray(pallas_nufft2_2d(jnp.asarray(x), jnp.asarray(f), h,
                                       mtot=mtot, fft_order=fft_order))
    got = nufft2_2d_split_ref(xt, ft, h, mtot=mtot,
                              fft_order=fft_order).numpy()
    assert got.shape == (n,)
    assert _rel(got, want) < 5e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("fft_order", [False, True])
def test_split_twin_matches_mode_tiled_pallas(rng, dtype, fft_order):
    """Past 256 modes gpquad runs the mode-tiled Pallas kernel (row 3 of the
    TPU kernel table), which the split covers at few points."""
    n, mtot, h = 300, _MODE_TILE + 45, 0.011
    x, f, xt, ft = _inputs(rng, n, mtot, dtype, span=2.0)
    want = np.asarray(pallas_nufft2_2d(jnp.asarray(x), jnp.asarray(f), h,
                                       mtot=mtot, tile=256,
                                       fft_order=fft_order))
    got = nufft2_2d_split_ref(xt, ft, h, mtot=mtot,
                              fft_order=fft_order).numpy()
    assert _rel(got, want) < 5e-5


@pytest.mark.parametrize("rows", [7, 16, 32, 200])
def test_split_twin_is_the_plain_sum_in_float64(rng, rows):
    """However the modes j are cut into slabs (the last one short, or one
    slab for all), the float64 twin is the plain version's sum."""
    n, mtot, h = 400, 61, 0.2
    _, _, xt, ft = _inputs(rng, n, mtot, torch.float64)
    want = nufft2_2d_ref(xt, ft, h, mtot=mtot, fft_order=True).numpy()
    got = nufft2_2d_split_ref(xt, ft, h, mtot=mtot, fft_order=True,
                              rows=rows).numpy()
    assert _rel(got, want) < 1e-13


# the tensor-core path's widths: 65 (one column tile, its modes padded to
# 96), the CG tier's 107 in FFT order, and 301 past the TPU's 256-mode block
# (three column tiles, as the scale gradient's 339); n leaves a ragged
# last block of 128 points
@pytest.mark.parametrize("n,mtot,h,fft_order", [
    (777, 65, 0.65, False),
    (600, 107, 0.1, True),
    (300, _MODE_TILE + 45, 0.011, False),
])
def test_single_3xtf32_twin_meets_the_split_bar(rng, n, mtot, h, fft_order):
    """The batched type-2's tensor-core twin at B 1, the single's
    tensor-core path: within max(2x the float32 plain version's error,
    1e-6) of max|ref| from float64, a plain-TF32 control above that bar,
    and the Pallas single type-2 within 5e-5."""
    x = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    f = (rng.normal(size=(mtot, mtot))
         + 1j * rng.normal(size=(mtot, mtot))).astype(np.complex64)
    hq = float(np.float32(h))
    xt, ft = torch.as_tensor(x), torch.as_tensor(f)
    kw = dict(mtot=mtot, fft_order=fft_order)
    ref = nufft2_2d_ref(xt.double(), ft.to(torch.complex128), hq,
                        **kw).numpy()
    scale = np.max(np.abs(ref))

    def err(a):
        return np.max(np.abs(a - ref)) / scale
    bar = max(2 * err(nufft2_2d_ref(xt, ft, hq, **kw).numpy()), 1e-6)
    twin = nufft2_2d_batched_3xtf32_ref(xt, ft[None], hq, **kw).numpy()[0]
    assert twin.shape == (n,)
    assert err(twin) <= bar
    control = nufft2_2d_batched_3xtf32_ref(xt, ft[None], hq, passes=1,
                                           **kw).numpy()[0]
    assert err(control) > bar
    want = pallas_nufft2_2d(jnp.asarray(x), jnp.asarray(f), hq, tile=256,
                            **kw)
    assert _rel(twin, np.asarray(want)) < 5e-5


_TC = ("tc", cuda_nufft.TYPE2_2D_POINTS, cuda_nufft.TYPE2_2D_COLS,
       cuda_nufft.TYPE2_2D_STAGE)


# every driven shape of the single type-2 (chip_smoke.py phase 3: the
# headline's mean, variance evaluation and gradient; the CG tier's mean and
# gradient; the scale configuration's mean, variance evaluation and
# gradient) with the path phase 3 timed fastest there, and the table's
# edges
@pytest.mark.parametrize("n,mtot,f32,f64", [
    (10_000, 29, "cuda", "tc"),
    (10_000, 57, "split", "tc"),
    (100_000, 29, "cuda", "tc"),
    (2_000, 107, "split", "tc"),
    (100_000, 107, "tc", "tc"),
    (2_000, 339, "split", "split"),
    (1_000, 677, "split", "split"),
    (1_000_000, 339, "tc", "tc"),
    (1, 3, "cuda", "cuda"),
    (1000, 43, "cuda", "tc"),
    (16_383, 45, "split", "tc"),
    (16_384, 63, "cuda", "tc"),
    (65_535, 107, "tc", "tc"),
    (65_536, 63, "cuda", "tc"),
    (8191, 65, "split", "tc"),
    (8192, 65, "tc", "tc"),
    # the float64 table's edges: the CUDA cores below mtot 17 and up to 23
    # from 32 768 points, the split from 109 below 4 096 points
    (100_000, 15, "cuda", "cuda"),
    (128, 15, "cuda", "cuda"),
    (128, 17, "cuda", "tc"),
    (32_767, 23, "cuda", "tc"),
    (32_768, 23, "cuda", "cuda"),
    (32_768, 25, "cuda", "tc"),
    (4_095, 109, "split", "split"),
    (4_096, 109, "split", "tc"),
    (1_000, 93, "split", "tc"),
])
def test_type2_2d_single_geometry(n, mtot, f32, f64):
    for dtype, path in ((torch.float32, f32), (torch.float64, f64)):
        geo = type2_2d_single_geometry(n, mtot, dtype)
        assert geo[0] == path, (n, mtot, dtype)
        if path == "tc" and dtype == torch.float64:
            # the FP64 tensor cores' B 1 instance
            assert geo == cuda_nufft.type2_2d_geometry(mtot, dtype, 1)
        elif path == "tc":
            assert geo == _TC == cuda_nufft.type2_2d_geometry(mtot)
        elif path == "split":
            assert geo == ("split", cuda_nufft.TYPE2_2D_SPLIT_ROWS,
                           cuda_nufft.TYPE2_2D_SPLIT_THREADS)
            # three slabs of modes j or more, and few points
            assert mtot > 2 * geo[1]
            assert n < cuda_nufft.TYPE2_2D_SPLIT_MAX_POINTS[dtype]
        else:
            assert geo == ("cuda",)
    # the scale gradient's scratch at B 1: 2.16 MB of split F
    if (n, mtot) == (1_000_000, 339):
        assert cuda_nufft.type2_2d_scratch_floats(mtot, 1, _TC) * 4 == \
            4 * 352 * 384 * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,mtot", [(2000, 107), (1200, 301)])
def test_single_type2_takes_plain_version_on_cpu(rng, dtype, n, mtot):
    """At shapes the card sends to the split or the tensor cores, a CPU
    tensor still goes to the plain version and counts no launch."""
    _, _, xt, ft = _inputs(rng, n, mtot, dtype)
    before = dict(cuda_nufft.LAUNCHES)
    widths = dict(cuda_nufft.LAUNCH_WIDTHS)
    got = nufft2_2d(xt, ft, 0.05, mtot=mtot)
    assert torch.equal(got, nufft2_2d_ref(xt, ft, 0.05, mtot=mtot))
    assert cuda_nufft.LAUNCHES == before
    assert cuda_nufft.LAUNCH_WIDTHS == widths
