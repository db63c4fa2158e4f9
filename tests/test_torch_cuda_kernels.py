"""The d=1, d=2 and d=3 CUDA NUFFT kernels and the SKI interpolation
kernels on the card, against their float64 plain versions on the same
inputs.

Marked ``cuda``: they skip where torch sees no CUDA device.  This file
imports neither JAX nor ``gpquad`` (the card's machine has no JAX), so it
runs there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Bar: 1e-4 * max|ref| (f32 rounding of the inputs' phases x*h and of sums of
up to 1e5 terms; chip_smoke.py phase 3 holds the same bar at full size).
"""
import numpy as np
import pytest
import torch

import gpquad_torch
from gpquad_torch.ops import cuda_nufft
from gpquad_torch.ops.cuda_nufft import (CudaNUFFT, nufft1_1d,
                                         nufft1_1d_ref, nufft2_1d,
                                         nufft2_1d_ref, nufft1_2d,
                                         nufft1_2d_batched,
                                         nufft1_2d_batched_ref, nufft1_2d_ref,
                                         nufft1_3d, nufft1_3d_ref,
                                         nufft2_2d, nufft2_2d_batched,
                                         nufft2_2d_batched_ref, nufft2_2d_ref,
                                         nufft2_3d, nufft2_3d_ref)
from gpquad_torch.ops import nufft as nufft_mod
from gpquad_torch.ops.nufft import NUFFT, make_nufft


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda_kernels.py")
    return torch.device("cuda")


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,mtot,h,fft_order", [
    (5000, 29, 0.65, False),
    (5000, 57, 0.65, True),
    (777, 9, 0.31, False),
    (1, 1, 0.3, False),
    (63, 3, 0.3, True),
    (3000, 301, 0.011, False),
    (3000, 339, 0.97, True),
])
def test_kernels_match_plain_on_card(cuda_device, dtype, n, mtot, h,
                                     fft_order):
    rng = np.random.default_rng(0)
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    x = torch.as_tensor(rng.uniform(0, 1, (n, 2)), device=cuda_device).to(dtype)
    v = torch.as_tensor(rng.normal(size=n) + 1j * rng.normal(size=n),
                        device=cuda_device).to(cdt)
    f = torch.as_tensor(rng.normal(size=(mtot, mtot))
                        + 1j * rng.normal(size=(mtot, mtot)),
                        device=cuda_device).to(cdt)
    hq = float(torch.tensor(h, dtype=dtype))
    before = dict(cuda_nufft.LAUNCHES)
    widths = dict(cuda_nufft.LAUNCH_WIDTHS)
    got1 = nufft1_2d(x, v, hq, mtot=mtot, fft_order=fft_order)
    got2 = nufft2_2d(x, f, hq, mtot=mtot, fft_order=fft_order)
    torch.cuda.synchronize()
    assert cuda_nufft.LAUNCHES["nufft1_2d"] == before["nufft1_2d"] + 1
    assert cuda_nufft.LAUNCHES["nufft2_2d"] == before["nufft2_2d"] + 1
    for name in ("nufft1_2d", "nufft2_2d"):
        assert cuda_nufft.LAUNCH_WIDTHS[name, mtot] == \
            widths.get((name, mtot), 0) + 1
    x64 = x.double()
    ref1 = nufft1_2d_ref(x64, v.to(torch.complex128), hq, mtot=mtot,
                         fft_order=fft_order)
    ref2 = nufft2_2d_ref(x64, f.to(torch.complex128), hq, mtot=mtot,
                         fft_order=fft_order)
    assert _rel(got1.to(torch.complex128), ref1) < 1e-4
    assert _rel(got2.to(torch.complex128), ref2) < 1e-4


@pytest.mark.cuda
def test_kernel_wrappers_reject_mismatched_inputs(cuda_device):
    x = torch.zeros((8, 2), device=cuda_device)
    with pytest.raises(TypeError):
        nufft2_2d(x, torch.zeros(9, dtype=torch.complex128,
                                 device=cuda_device), 0.1, mtot=3)
    with pytest.raises(ValueError):
        nufft1_2d(x, torch.zeros(7, dtype=torch.complex64,
                                 device=cuda_device), 0.1, mtot=3)


@pytest.mark.cuda
def test_dispatcher_on_card(cuda_device):
    """d=1 and d=2 (any odd mtot), and d=3 up to mtot 255, on the card take
    the kernels; wider d=3 grids the phase matrices."""
    for d, mtot, cls in ((1, 9, CudaNUFFT), (1, 8191, CudaNUFFT),
                         (2, 9, CudaNUFFT), (3, 9, CudaNUFFT),
                         (3, 255, CudaNUFFT), (3, 257, NUFFT)):
        x = torch.rand((50, d), device=cuda_device)
        assert isinstance(make_nufft(x, 0.3, mtot), cls), (d, mtot)
    x = torch.rand((50, 2), device=cuda_device)
    assert isinstance(make_nufft(x, 0.3, 9, method="matmul"), NUFFT)
    # h is read to the host once, in x's precision, so launches never sync
    op = make_nufft(x, torch.tensor(0.3, device=cuda_device), 9)
    assert type(op.h) is float
    assert op.h == float(torch.tensor(0.3, dtype=torch.float32))


@pytest.mark.cuda
def test_slice_on_card_matches_cpu(cuda_device):
    """fit -> mean -> stochastic variance on the card (kernels, float64)
    against the same slice on the CPU (phase matrices), same probes: the
    float64 kernels agree with the phase matrices to ~1e-13, so the slice
    agrees to the f64 bars of tests/test_torch_efgp.py; the float32 slice
    on the card is held at 1e-4 * max|ref|."""
    rng = np.random.default_rng(4)
    n = 3000
    x = rng.uniform(0, 1, (n, 2))
    y = np.sin(3 * np.pi * x[:, 0]) * np.cos(2 * np.pi * x[:, 1]) \
        + 0.1 * rng.normal(size=n)
    xq = rng.uniform(0, 1, (200, 2))
    kern = gpquad_torch.make_kernel("SE", 2, lengthscale=0.2, variance=1.0)
    out = {}
    for dev, dtype in (("cpu", np.float64), (cuda_device, np.float64),
                       (cuda_device, np.float32)):
        st = gpquad_torch.fit(x.astype(dtype), y.astype(dtype), kern, 0.5,
                              eps=1e-4, cg_tol=1e-10, device=dev)
        etas = np.random.default_rng(5).choice([-1.0, 1.0],
                                               size=(64, st.mtot ** 2))
        mean = gpquad_torch.predict_mean(st, xq)
        var = gpquad_torch.predict_var(st, xq, probes=64, cg_tol=1e-10,
                                       etas=etas)
        out[(str(dev), dtype)] = (mean.cpu().numpy().astype(np.float64),
                                  var.cpu().numpy().astype(np.float64))
    m_cpu, v_cpu = out[("cpu", np.float64)]
    m64, v64 = out[(str(cuda_device), np.float64)]
    m32, v32 = out[(str(cuda_device), np.float32)]
    assert np.max(np.abs(m64 - m_cpu)) < 1e-9
    assert np.max(np.abs(v64 - v_cpu)) < 1e-8 * np.max(np.abs(v_cpu))
    assert np.max(np.abs(m32 - m_cpu)) < 1e-4 * np.max(np.abs(m_cpu))
    assert np.max(np.abs(v32 - v_cpu)) < 1e-4 * np.max(np.abs(v_cpu))


@pytest.mark.cuda
def test_default_probes_on_card(cuda_device):
    """predict_var with neither generator nor etas draws its probes on the
    card: reproducible (seed 0) and finite."""
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, (2000, 2)).astype(np.float32)
    y = np.sin(4 * x[:, 0]).astype(np.float32)
    xq = rng.uniform(0, 1, (100, 2)).astype(np.float32)
    kern = gpquad_torch.make_kernel("SE", 2, lengthscale=0.2, variance=1.0)
    st = gpquad_torch.fit(x, y, kern, 0.1, eps=1e-4, device=cuda_device)
    a = gpquad_torch.predict_var(st, xq, probes=32)
    b = gpquad_torch.predict_var(st, xq, probes=32)
    assert a.device.type == "cuda" and a.shape == (100,)
    assert torch.equal(a, b)
    assert bool(torch.isfinite(a).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n,mtot,h,fft_order", [
    (1, 3000, 29, 0.65, False),
    (3, 5000, 57, 0.65, True),
    (20, 2100, 29, 0.65, False),
    (3, 777, 9, 0.31, True),
    (20, 1500, 107, 0.1, False),
    (3, 1200, 339, 0.97, True),
])
def test_batched_kernels_match_plain_on_card(cuda_device, dtype, B, n, mtot,
                                             h, fft_order):
    """One launch each for the whole batch (groups of 4 / 8 inside the
    kernels, so B = 1, 3 and 20 cover a partial group, one group and
    several), against the float64 plain batched versions."""
    rng = np.random.default_rng(1)
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    x = torch.as_tensor(rng.uniform(0, 1, (n, 2)), device=cuda_device).to(dtype)
    V = torch.as_tensor(rng.normal(size=(B, n)) + 1j * rng.normal(size=(B, n)),
                        device=cuda_device).to(cdt)
    F = torch.as_tensor(rng.normal(size=(B, mtot, mtot))
                        + 1j * rng.normal(size=(B, mtot, mtot)),
                        device=cuda_device).to(cdt)
    hq = float(torch.tensor(h, dtype=dtype))
    kw = dict(mtot=mtot, fft_order=fft_order)
    before = dict(cuda_nufft.LAUNCHES)
    got1 = nufft1_2d_batched(x, V, hq, **kw)
    got2 = nufft2_2d_batched(x, F, hq, **kw)
    torch.cuda.synchronize()
    assert cuda_nufft.LAUNCHES["nufft1_2d_batched"] == \
        before["nufft1_2d_batched"] + 1
    assert cuda_nufft.LAUNCHES["nufft2_2d_batched"] == \
        before["nufft2_2d_batched"] + 1
    x64 = x.double()
    ref1 = nufft1_2d_batched_ref(x64, V.to(torch.complex128), hq, **kw)
    ref2 = nufft2_2d_batched_ref(x64, F.to(torch.complex128), hq, **kw)
    assert got1.shape == (B, mtot, mtot) and got2.shape == (B, n)
    assert _rel(got1.to(torch.complex128), ref1) < 1e-4
    assert _rel(got2.to(torch.complex128), ref2) < 1e-4
    # the flat mode layout gives the same launch and result
    flat = nufft2_2d_batched(x, F.reshape(B, mtot * mtot), hq, **kw)
    assert torch.equal(flat, got2)


@pytest.mark.cuda
def test_cuda_backend_batches_in_one_launch(cuda_device):
    """CudaNUFFT sends a leading batch of >= 2 to one batched launch and a
    single vector to the single kernels."""
    x = torch.rand((400, 2), device=cuda_device)
    op = make_nufft(x, 0.3, 9)
    before = dict(cuda_nufft.LAUNCHES)
    assert op.type1(torch.ones((2, 3, 400), device=cuda_device)).shape == \
        (2, 3, 9, 9)
    assert op.type2(torch.ones((5, 81), dtype=torch.complex64,
                               device=cuda_device)).shape == (5, 400)
    assert op.type2(torch.ones((1, 9, 9), dtype=torch.complex64,
                               device=cuda_device)).shape == (1, 400)
    after = dict(cuda_nufft.LAUNCHES)
    assert {k: after[k] - before[k] for k in after} == {
        "nufft1_1d": 0, "nufft2_1d": 0,
        "nufft1_2d": 0, "nufft2_2d": 1, "nufft1_2d_batched": 1,
        "nufft2_2d_batched": 1, "nufft1_3d": 0, "nufft2_3d": 0}


@pytest.mark.cuda
def test_pipeline_on_card_matches_cpu(cuda_device):
    """fit_predict_grad on the card (kernels) against the CPU (phase
    matrices), same generator seed: the CPU generator draws the probes for
    both, so they see the same +-1 vectors.  float64 on the card agrees to
    the solves' tolerance; float32 to 1e-4 * max|ref| on mean and variance
    and 1e-2 relative on the gradient."""
    rng = np.random.default_rng(8)
    n = 3000
    x = rng.uniform(0, 1, (n, 2))
    y = np.sin(3 * np.pi * x[:, 0]) * np.cos(2 * np.pi * x[:, 1]) \
        + 0.1 * rng.normal(size=n)
    xq = rng.uniform(0, 1, (200, 2))
    kern = gpquad_torch.make_kernel("SE", 2, lengthscale=0.2, variance=1.0)
    _, h, mtot = gpquad_torch.spectral_grid(kern, 1e-4, 1.0)
    out = {}
    for dev, dtype in (("cpu", np.float64), (cuda_device, np.float64),
                       (cuda_device, np.float32)):
        cuda_nufft.LAUNCHES.update({k: 0 for k in cuda_nufft.LAUNCHES})
        nufft_mod.BACKEND_PICKS.update({k: 0 for k in nufft_mod.BACKEND_PICKS})
        r = gpquad_torch.fit_predict_grad(
            x.astype(dtype), y.astype(dtype), xq.astype(dtype), kern, 0.5, h,
            torch.Generator().manual_seed(3), mtot=mtot, trace_samples=4,
            var_probes=32, cg_tol=1e-10, var_cg_tol=1e-10, grad_cg_tol=1e-10,
            device=dev)
        if dev != "cpu":
            assert dict(cuda_nufft.LAUNCHES) == {
                "nufft1_1d": 0, "nufft2_1d": 0,
                "nufft1_2d": 3, "nufft2_2d": 3, "nufft1_2d_batched": 1,
                "nufft2_2d_batched": 2, "nufft1_3d": 0, "nufft2_3d": 0}
            assert nufft_mod.BACKEND_PICKS["matmul"] == 0
        out[(str(dev), dtype)] = [t.cpu().numpy().astype(np.float64)
                                  for t in (r.mean, r.var, r.grad)]
    m_cpu, v_cpu, g_cpu = out[("cpu", np.float64)]
    m64, v64, g64 = out[(str(cuda_device), np.float64)]
    m32, v32, g32 = out[(str(cuda_device), np.float32)]
    assert np.max(np.abs(m64 - m_cpu)) < 1e-9
    assert np.max(np.abs(v64 - v_cpu)) < 1e-8 * np.max(np.abs(v_cpu))
    assert np.all(np.abs(g64 - g_cpu) < 1e-8 * np.abs(g_cpu))
    assert np.max(np.abs(m32 - m_cpu)) < 1e-4 * np.max(np.abs(m_cpu))
    assert np.max(np.abs(v32 - v_cpu)) < 1e-4 * np.max(np.abs(v_cpu))
    assert np.all(np.abs(g32 - g_cpu) < 1e-2 * np.abs(g_cpu))


# ---------------------------------------------------------------------------
# d=3
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n,mtot,h,fft_order", [
    (1, 3000, 9, 0.31, False),
    (3, 2000, 9, 0.31, True),
    (10, 1500, 9, 0.31, False),
    (1, 1000, 61, 0.11, True),
    (3, 700, 61, 0.11, False),
    (10, 300, 61, 0.11, True),
    (1, 400, 101, 0.05, False),
    (3, 300, 101, 0.05, True),
    (1, 1, 3, 0.3, False),
])
def test_3d_kernels_match_plain_on_card(cuda_device, dtype, B, n, mtot, h,
                                        fft_order):
    """One launch per call for one vector or a batch (B 1/3/10), at mtot 9
    (the TPU's single-block branch), 61 and 101 (its slab-tiled branch),
    against the float64 plain versions; f64 at 1e-10."""
    rng = np.random.default_rng(2)
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    x = torch.as_tensor(rng.uniform(0, 1, (n, 3)), device=cuda_device).to(dtype)
    lead = () if B == 1 else (B,)
    V = torch.as_tensor(rng.normal(size=lead + (n,))
                        + 1j * rng.normal(size=lead + (n,)),
                        device=cuda_device).to(cdt)
    F = torch.as_tensor(rng.normal(size=lead + (mtot,) * 3)
                        + 1j * rng.normal(size=lead + (mtot,) * 3),
                        device=cuda_device).to(cdt)
    hq = float(torch.tensor(h, dtype=dtype))
    kw = dict(mtot=mtot, fft_order=fft_order)
    before = dict(cuda_nufft.LAUNCHES)
    got1 = nufft1_3d(x, V, hq, **kw)
    got2 = nufft2_3d(x, F, hq, **kw)
    torch.cuda.synchronize()
    assert cuda_nufft.LAUNCHES["nufft1_3d"] == before["nufft1_3d"] + 1
    assert cuda_nufft.LAUNCHES["nufft2_3d"] == before["nufft2_3d"] + 1
    x64 = x.double()
    ref1 = nufft1_3d_ref(x64, V.to(torch.complex128), hq, **kw)
    ref2 = nufft2_3d_ref(x64, F.to(torch.complex128), hq, **kw)
    assert got1.shape == lead + (mtot,) * 3 and got2.shape == lead + (n,)
    bar = 1e-4 if dtype == torch.float32 else 1e-10
    assert _rel(got1.to(torch.complex128), ref1) < bar
    assert _rel(got2.to(torch.complex128), ref2) < bar
    flat = nufft2_3d(x, F.reshape(lead + (mtot ** 3,)), hq, **kw)
    assert torch.equal(flat, got2)


@pytest.mark.cuda
def test_3d_dispatch_launches_kernels(cuda_device):
    """make_nufft on d=3 points on the card launches the d=3 kernels once
    per call, for a single vector or a batch, and never the plain path."""
    x = torch.rand((500, 3), device=cuda_device)
    nufft_mod.BACKEND_PICKS.update({k: 0 for k in nufft_mod.BACKEND_PICKS})
    op = make_nufft(x, 0.3, 9)
    before = dict(cuda_nufft.LAUNCHES)
    assert op.type1(torch.ones((2, 3, 500), device=cuda_device)).shape == \
        (2, 3, 9, 9, 9)
    assert op.type1(torch.ones(500, device=cuda_device)).shape == (9, 9, 9)
    assert op.type2(torch.ones((5, 729), dtype=torch.complex64,
                               device=cuda_device)).shape == (5, 500)
    assert op.type2(torch.ones((9, 9, 9), dtype=torch.complex64,
                               device=cuda_device)).shape == (500,)
    after = dict(cuda_nufft.LAUNCHES)
    assert {k: after[k] - before[k] for k in after} == {
        "nufft1_1d": 0, "nufft2_1d": 0,
        "nufft1_2d": 0, "nufft2_2d": 0, "nufft1_2d_batched": 0,
        "nufft2_2d_batched": 0, "nufft1_3d": 2, "nufft2_3d": 2}
    assert nufft_mod.BACKEND_PICKS == {"cuda": 1, "matmul": 0, "spread": 0,
                                       "banded": 0, "sub": 0}


@pytest.mark.cuda
def test_3d_pipeline_on_card_matches_cpu(cuda_device):
    """fit_predict_grad at d=3 on the card (kernels) against the CPU (phase
    matrices), same generator seed, on the dense tier (mtot 9) and the CG
    tier; bars as test_pipeline_on_card_matches_cpu."""
    rng = np.random.default_rng(9)
    n = 2000
    x = rng.uniform(0, 1, (n, 3))
    y = (np.sin(3 * np.pi * x[:, 0]) * np.cos(2 * np.pi * x[:, 1])
         * np.cos(np.pi * x[:, 2]) + 0.1 * rng.normal(size=n))
    xq = rng.uniform(0, 1, (150, 3))
    kern = gpquad_torch.make_kernel("SE", 3, lengthscale=0.4, variance=1.0)
    _, h, mtot = gpquad_torch.spectral_grid(kern, 1e-3, 1.0)
    for solver in ("dense", "cg"):
        out = {}
        for dev, dtype in (("cpu", np.float64), (cuda_device, np.float64),
                           (cuda_device, np.float32)):
            cuda_nufft.LAUNCHES.update({k: 0 for k in cuda_nufft.LAUNCHES})
            nufft_mod.BACKEND_PICKS.update(
                {k: 0 for k in nufft_mod.BACKEND_PICKS})
            r = gpquad_torch.fit_predict_grad(
                x.astype(dtype), y.astype(dtype), xq.astype(dtype), kern,
                0.5, h, torch.Generator().manual_seed(3), mtot=mtot,
                trace_samples=4, var_probes=32, cg_tol=1e-10,
                var_cg_tol=1e-10, grad_cg_tol=1e-10, max_cg_iter=3000,
                solver=solver, device=dev)
            if dev != "cpu":
                assert dict(cuda_nufft.LAUNCHES) == {
                    "nufft1_1d": 0, "nufft2_1d": 0,
                    "nufft1_2d": 0, "nufft2_2d": 0, "nufft1_2d_batched": 0,
                    "nufft2_2d_batched": 0, "nufft1_3d": 4, "nufft2_3d": 5}
                assert nufft_mod.BACKEND_PICKS["matmul"] == 0
            out[(str(dev), dtype)] = [t.cpu().numpy().astype(np.float64)
                                      for t in (r.mean, r.var, r.grad)]
        m_cpu, v_cpu, g_cpu = out[("cpu", np.float64)]
        m64, v64, g64 = out[(str(cuda_device), np.float64)]
        m32, v32, g32 = out[(str(cuda_device), np.float32)]
        assert np.max(np.abs(m64 - m_cpu)) < 1e-9, solver
        assert np.max(np.abs(v64 - v_cpu)) < 1e-8 * np.max(np.abs(v_cpu))
        assert np.all(np.abs(g64 - g_cpu) < 1e-8 * np.abs(g_cpu)), solver
        assert np.max(np.abs(m32 - m_cpu)) < 1e-4 * np.max(np.abs(m_cpu))
        assert np.max(np.abs(v32 - v_cpu)) < 1e-4 * np.max(np.abs(v_cpu))
        assert np.all(np.abs(g32 - g_cpu) < 1e-2 * np.abs(g_cpu)), solver


# ---------------------------------------------------------------------------
# d=1 (rows 5-6) and the facade
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n,mtot,h,fft_order", [
    (0, 5000, 1031, 0.99, False),
    (0, 3000, 2061, 0.99, True),
    (1, 777, 9, 0.31, True),
    (3, 2000, 8191, 0.99, False),
    (10, 20000, 1031, 0.99, False),
    (0, 1, 1, 0.3, False),
])
def test_1d_kernels_match_plain_on_card(cuda_device, dtype, B, n, mtot, h,
                                        fft_order):
    """B = 0 is a single vector.  Bar 1e-4 (f32) and 1e-10 (f64) of
    max|ref|: the kernels carry the rounding of t = x*h into the phase."""
    rng = np.random.default_rng(1)
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    lead = (B,) if B else ()
    x = torch.as_tensor(rng.uniform(0, 1, (n, 1)), device=cuda_device).to(dtype)
    v = torch.as_tensor(rng.normal(size=lead + (n,))
                        + 1j * rng.normal(size=lead + (n,)),
                        device=cuda_device).to(cdt)
    f = torch.as_tensor(rng.normal(size=lead + (mtot,))
                        + 1j * rng.normal(size=lead + (mtot,)),
                        device=cuda_device).to(cdt)
    hq = float(torch.tensor(h, dtype=dtype))
    before = dict(cuda_nufft.LAUNCHES)
    kw = dict(mtot=mtot, fft_order=fft_order)
    got1 = nufft1_1d(x, v, hq, **kw)
    got2 = nufft2_1d(x, f, hq, **kw)
    torch.cuda.synchronize()
    assert cuda_nufft.LAUNCHES["nufft1_1d"] == before["nufft1_1d"] + 1
    assert cuda_nufft.LAUNCHES["nufft2_1d"] == before["nufft2_1d"] + 1
    assert got1.shape == lead + (mtot,) and got2.shape == lead + (n,)
    bar = 1e-4 if dtype == torch.float32 else 1e-10
    ref1 = nufft1_1d_ref(x.double(), v.to(torch.complex128), hq, **kw)
    ref2 = nufft2_1d_ref(x.double(), f.to(torch.complex128), hq, **kw)
    assert _rel(got1.to(torch.complex128), ref1) < bar
    assert _rel(got2.to(torch.complex128), ref2) < bar


@pytest.mark.cuda
def test_1d_type1_sums_sorted_points_on_card(cuda_device):
    """Sorted points (a series at a fixed cadence) keep the type-1 chunk
    sums large at the low modes; ``nufft1_1d`` adds runs of 32 points apart
    so that the f32 lag table of the Kepler-cadence series (n 68 628) stays
    within 1e-7 of max|ref| = n."""
    t = np.arange(0.0, 1400.0, 0.0204)
    x = torch.as_tensor((t - t[0]) / (t[-1] - t[0]),
                        device=cuda_device)[:, None]
    kw = dict(mtot=2061, fft_order=False)
    ones = torch.ones(x.shape[0], dtype=torch.complex128, device=cuda_device)
    hq = float(torch.tensor(0.9936, dtype=torch.float32))
    x32 = x.float()
    got = nufft1_1d(x32, ones.to(torch.complex64), hq, **kw)
    ref = nufft1_1d_ref(x32.double(), ones, hq, **kw)
    rel = _rel(got.to(torch.complex128), ref)
    print(f"f32 lag table on sorted points: {rel:.3e} of max|ref|")
    assert rel < 1e-7


@pytest.mark.cuda
def test_facade_on_card_matches_cpu(cuda_device):
    """EFGP on the card (d=1 kernels, float64) against the same model on the
    CPU (phase matrices): three Adam steps with the same probes, then the
    mean; launches of both d=1 kernels, none of the plain path."""
    rng = np.random.default_rng(5)
    n = 3000
    x = rng.uniform(0, 1, n)
    y = np.sin(40 * x) + 0.1 * rng.normal(size=n)
    out = {}
    for dev in ("cpu", cuda_device):
        model = gpquad_torch.EFGP(x, y, "SE", sigmasq=0.05, eps=1e-5,
                                  estimate_params=False, device=dev)
        model.params = model.params.replace_raw(torch.log(torch.tensor(
            [0.02, 1.0, 0.05], dtype=torch.float64, device=dev)))
        model._mtot_floor = gpquad_torch.quadrature.bucket_mtot(
            model._grid_plan(False)[1] + 20)
        M = model._mtot_floor
        Z = torch.as_tensor(np.random.default_rng(6).choice(
            [-1.0, 1.0], size=(2, n)), device=dev)
        V = torch.as_tensor(np.random.default_rng(7).choice(
            [-1.0, 1.0], size=(2, M)), device=dev)
        cuda_nufft.LAUNCHES.update({k: 0 for k in cuda_nufft.LAUNCHES})
        nufft_mod.BACKEND_PICKS.update({"cuda": 0, "matmul": 0})
        model.optimize_hyperparameters(max_iters=3, lr=0.05, trace_samples=2,
                                       cg_tol=1e-10, probes=(Z, V))
        mean, _ = model.predict(np.linspace(0, 1, 500),
                                return_variance=False)
        out[str(dev)] = (model.params.raw.cpu().numpy(), mean.cpu().numpy(),
                         dict(cuda_nufft.LAUNCHES),
                         dict(nufft_mod.BACKEND_PICKS))
    raw_cpu, mean_cpu, _, _ = out["cpu"]
    raw_gpu, mean_gpu, launches, picks = out[str(cuda_device)]
    assert np.max(np.abs(raw_gpu - raw_cpu)) < 1e-8
    assert np.max(np.abs(mean_gpu - mean_cpu)) < 1e-8
    assert launches["nufft1_1d"] > 0 and launches["nufft2_1d"] > 0
    assert picks["matmul"] == 0


# ---------------------------------------------------------------------------
# SKI interpolation (rows 13-14)
# ---------------------------------------------------------------------------

def _ski_tables(cuda_device, dtype, n, grid, seed=3):
    from gpquad_torch.models import ski
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(-1, 1, (n, 2)), device=cuda_device)
    kern = gpquad_torch.make_kernel("SE", 2, lengthscale=0.3, variance=1.0)
    op = ski.build_ski_operator(x.to(dtype), kern, grid,
                                ((-1.0, 1.0), (-1.0, 1.0)))
    assert op.banded is not None
    return rng, op


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n,grid", [(1, 20_000, (200, 150)),
                                      (3, 20_000, (200, 150)),
                                      (8, 5_000, (60, 300)),
                                      (21, 3_000, (8, 600))])
def test_interp_kernels_match_plain_on_card(cuda_device, dtype, B, n, grid):
    """Both kernels against their float64 plain versions on the band plan,
    one launch each; W^T u on every slab cell (padded slots included), W v
    on the valid slots, from the overlapping strided slab view.  Bars
    1e-5 (f32) and 1e-12 (f64) of max|ref|."""
    from gpquad_torch.ops import cuda_interp
    rng, op = _ski_tables(cuda_device, dtype, n, grid)
    t = op.banded
    G1, G2 = op.grid_shape
    nbands, cap = t.pidx.shape
    tabs64 = (t.i0loc, t.c0, t.w_row.double(), t.w_col.double())
    tabs = (t.i0loc, t.c0, t.w_row, t.w_col)
    idx = (t.col_slots, t.col_start)
    us = (torch.as_tensor(rng.normal(size=(B, nbands, cap)),
                          device=cuda_device) * t.valid).to(dtype)
    v = torch.as_tensor(rng.normal(size=(B, G1, G2)), device=cuda_device)
    vp = torch.nn.functional.pad(v, (0, 0, 0, nbands * 8 + 3 - G1)).to(dtype)
    vs = vp.as_strided((B, nbands, 11, G2), (vp.stride(0), 8 * G2, G2, 1))
    before = dict(cuda_interp.LAUNCHES)
    got_T = cuda_interp.interp_T_2d(us, *tabs, *idx, G2=G2, bh=8)
    got = cuda_interp.interp_2d(vs, *tabs, bh=8)
    torch.cuda.synchronize()
    assert cuda_interp.LAUNCHES["interp_T_2d"] == before["interp_T_2d"] + 1
    assert cuda_interp.LAUNCHES["interp_2d"] == before["interp_2d"] + 1
    ref_T = cuda_interp.interp_T_2d_ref(us.double(), *tabs64, G2=G2, bh=8)
    ref = cuda_interp.interp_2d_ref(vs.double(), *tabs64, bh=8)
    bar = 1e-5 if dtype == torch.float32 else 1e-12
    assert got_T.shape == ref_T.shape and got.shape == ref.shape
    assert _rel(got_T.double(), ref_T) < bar
    mask = t.valid[:, None, :].expand_as(ref)
    assert _rel(got.double()[mask], ref[mask]) < bar
    # the same sums in the same order on every launch, and the order of the
    # plain twin's column-sorted walk, bit for bit
    assert torch.equal(cuda_interp.interp_T_2d(us, *tabs, *idx, G2=G2, bh=8),
                       got_T)
    assert torch.equal(cuda_interp.interp_T_2d_sorted_ref(
        us, *tabs, *idx, G2=G2, bh=8), got_T)


@pytest.mark.cuda
def test_interp_kernels_padded_tables_on_card(cuda_device):
    """Padded slots whose stencil lies outside the slab (negative or past
    it, in rows and columns) are bounds-checked: W^T u equals the plain
    version and W v stays finite and right on the valid slots."""
    from gpquad_torch.ops import cuda_interp
    rng = np.random.default_rng(4)
    nbands, cap, G2, B = 5, 600, 300, 3
    i0 = rng.integers(0, 8, (nbands, cap)).astype(np.int32)
    c0 = rng.integers(0, G2 - 3, (nbands, cap)).astype(np.int32)
    valid = np.ones((nbands, cap), bool)
    valid[:, 500:] = False
    i0[~valid] = rng.choice([-8, -3, 9, 4000], size=(~valid).sum())
    c0[~valid] = rng.choice([-8, -2, G2 - 1, G2 + 70], size=(~valid).sum())
    dev = cuda_device
    tabs = (torch.as_tensor(i0, device=dev), torch.as_tensor(c0, device=dev),
            torch.as_tensor(rng.normal(size=(nbands, cap, 4)), device=dev),
            torch.as_tensor(rng.normal(size=(nbands, cap, 4)), device=dev))
    idx = tuple(torch.as_tensor(a, device=dev)
                for a in cuda_interp.column_index(valid, c0, G2))
    us = torch.as_tensor(rng.normal(size=(B, nbands, cap)) * valid,
                         device=dev)
    vs = torch.as_tensor(rng.normal(size=(B, nbands, 11, G2)), device=dev)
    got_T = cuda_interp.interp_T_2d(us, *tabs, *idx, G2=G2, bh=8)
    got = cuda_interp.interp_2d(vs, *tabs, bh=8)
    ref_T = cuda_interp.interp_T_2d_ref(us, *tabs, G2=G2, bh=8)
    ref = cuda_interp.interp_2d_ref(vs, *tabs, bh=8)
    assert _rel(got_T, ref_T) < 1e-12
    assert bool(torch.isfinite(got).all())
    assert _rel(got[:, :, :500], ref[:, :, :500]) < 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,mtot,h,fft_order", [
    (1, 5000, 29, 0.65, False),
    (1, 30_000, 339, 0.97, True),
    (3, 5000, 57, 0.65, True),
    (5, 20_000, 261, 0.011, False),
])
def test_type1_tensor_core_kernel_on_card(cuda_device, B, n, mtot, h,
                                          fft_order):
    """The float32 d=2 type-1 on the tensor cores: within max(2x the float32
    plain version's error, 1e-6) of max|ref| from float64, as its 3xTF32
    twin, and within twice that of the twin; bit for bit the same on a
    second launch; its scratch (the peak allocated in the call, less the
    output and the allocator's rounding) no more than groups x B x mtot^2
    partials."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.uniform(0, 1, (n, 2)),
                        device=cuda_device).float()
    V = torch.as_tensor(rng.normal(size=(B, n)) + 1j * rng.normal(size=(B, n)),
                        device=cuda_device).to(torch.complex64)
    hq = float(torch.tensor(h, dtype=torch.float32))
    kw = dict(mtot=mtot, fft_order=fft_order)
    batched = B > 1

    def call():
        return (nufft1_2d_batched(x, V, hq, **kw) if batched
                else nufft1_2d(x, V[0], hq, **kw)[None])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    groups = -(-n // cuda_nufft.type1_2d_chunk(n, mtot, B, batched))
    # the caching allocator rounds each of the two blocks (the partials,
    # the output) up to at most 2 MiB
    assert peak <= (groups + 1) * B * mtot ** 2 * 8 + 2 * 2 ** 21
    assert torch.equal(call(), got)
    ref = nufft1_2d_batched_ref(x.double(), V.to(torch.complex128), hq, **kw)
    scale = float(ref.abs().max())

    def err(a):
        return float((a.to(torch.complex128) - ref).abs().max()) / scale
    bar = max(2 * err(nufft1_2d_batched_ref(x, V, hq, **kw)), 1e-6)
    assert err(got) <= bar
    twin = cuda_nufft.nufft1_2d_3xtf32_ref(x.cpu(), V.cpu(), hq,
                                           chunk=cuda_nufft.type1_2d_chunk(
                                               n, mtot, B, batched), **kw)
    assert float((got.cpu() - twin).abs().max()) <= 2 * bar * scale


_TYPE2_TC = ("tc", cuda_nufft.TYPE2_2D_POINTS, cuda_nufft.TYPE2_2D_COLS,
             cuda_nufft.TYPE2_2D_STAGE)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,mtot,h,fft_order", [
    (1, 1000, 9, 0.31, False),
    (3, 5001, 29, 0.65, True),
    (10, 3000, 107, 0.1, False),
    (5, 20_000, 339, 0.97, True),
])
def test_type2_tensor_core_kernel_on_card(cuda_device, B, n, mtot, h,
                                          fft_order):
    """The float32 batched d=2 type-2 on the tensor cores: one launch
    counted a call; within max(2x the float32 plain version's error, 1e-6)
    of max|ref| from float64, as its 3xTF32 twin, and within twice that of
    the twin; bit for bit the same on a second launch; the wrapper's result
    that of the route type2_2d_geometry gives the shape."""
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.uniform(0, 1, (n, 2)),
                        device=cuda_device).float()
    F = torch.as_tensor(rng.normal(size=(B, mtot, mtot))
                        + 1j * rng.normal(size=(B, mtot, mtot)),
                        device=cuda_device).to(torch.complex64)
    hq = float(torch.tensor(h, dtype=torch.float32))
    kw = dict(mtot=mtot, fft_order=fft_order)
    before = cuda_nufft.LAUNCHES["nufft2_2d_batched"]
    got = cuda_nufft._nufft2_2d_batched_on(x, F, hq, mtot, fft_order,
                                           _TYPE2_TC)
    torch.cuda.synchronize()
    assert cuda_nufft.LAUNCHES["nufft2_2d_batched"] == before + 1
    assert got.shape == (B, n)
    assert torch.equal(cuda_nufft._nufft2_2d_batched_on(
        x, F, hq, mtot, fft_order, _TYPE2_TC), got)
    ref = nufft2_2d_batched_ref(x.double(), F.to(torch.complex128), hq, **kw)
    scale = float(ref.abs().max())

    def err(a):
        return float((a.to(torch.complex128) - ref).abs().max()) / scale
    bar = max(2 * err(nufft2_2d_batched_ref(x, F, hq, **kw)), 1e-6)
    assert err(got) <= bar
    twin = cuda_nufft.nufft2_2d_batched_3xtf32_ref(x.cpu(), F.cpu(), hq,
                                                   **kw)
    assert float((got.cpu() - twin).abs().max()) <= 2 * bar * scale
    routed = nufft2_2d_batched(x, F, hq, **kw)
    if cuda_nufft.type2_2d_geometry(mtot)[0] == "tc":
        assert torch.equal(routed, got)
    else:
        assert err(routed) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("field,value", [(1, 64), (2, 64), (3, 16)])
def test_type2_2d_launch_refuses_foreign_geometry(cuda_device, field, value):
    """The tensor-core batched type-2's launch takes its geometry from
    type2_2d_geometry and refuses one it has no instance for (points,
    columns or stage changed): a CUDA error is raised, and nothing is
    written."""
    n, mtot, B = 1000, 107, 3
    x = torch.rand((n, 2), device=cuda_device)
    F = torch.ones((B, mtot, mtot), dtype=torch.complex64, device=cuda_device)
    geo = list(_TYPE2_TC)
    geo[field] = value
    floats = cuda_nufft.type2_2d_scratch_floats(mtot, B, _TYPE2_TC)
    scratch = torch.zeros(floats, device=cuda_device)
    out = torch.zeros((B, n), dtype=torch.complex64, device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_nufft._launch("nufft2_2d_batched", x, x.data_ptr(),
                           F.data_ptr(), 0.5, n, mtot, B, 0, *geo[1:],
                           scratch.data_ptr(), floats, out.data_ptr(),
                           mtot=mtot, symbol="gpq_nufft2_2d_batched_tc_f32")
    torch.cuda.synchronize()
    assert not bool(out.abs().any())
    assert not bool(scratch.any())


@pytest.mark.cuda
@pytest.mark.parametrize("field,value", [
    (0, 32), (1, 64), (2, 2), (3, 48), (4, 1000), (5, 1536)])
def test_type1_2d_launch_refuses_foreign_geometry(cuda_device, field, value):
    """The float32 d=2 type-1's launch takes its geometry from
    ``type1_2d_geometry`` and refuses one it has no instance for (rows,
    cols, group, stage, run or chunk changed): a CUDA error is raised, and
    nothing is written."""
    n, mtot = 4096, 29
    x = torch.rand((n, 2), device=cuda_device)
    v = torch.ones(n, dtype=torch.complex64, device=cuda_device)
    geo = list(cuda_nufft.type1_2d_geometry(n, mtot))
    geo[field] = value
    partial = torch.zeros((-(-n // geo[-1]) + 1, mtot, mtot),
                          dtype=torch.complex64, device=cuda_device)
    out = torch.zeros((mtot, mtot), dtype=torch.complex64,
                      device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_nufft._launch("nufft1_2d", x, x.data_ptr(), v.data_ptr(), 0.5,
                           n, mtot, 0, *geo, partial.data_ptr(),
                           out.data_ptr(), mtot=mtot)
    torch.cuda.synchronize()
    assert not bool(out.abs().any())


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,mtot,h,fft_order", [
    (1, 5000, 29, 0.65, False),
    (3, 5001, 57, 0.4, True),
    (1, 3000, 93, 0.13, True),
    (5, 20_000, 107, 0.1, False),
    (1, 30_000, 339, 0.97, True),
])
def test_type1_f64_tensor_core_kernel_on_card(cuda_device, B, n, mtot, h,
                                              fft_order):
    """The float64 d=2 type-1 on the FP64 tensor cores: one float64 launch a
    call; within 1e-10 of max|ref| of the float64 plain version; bit for
    bit the same on a second launch; within 1e-12 of max|ref| of its twin
    nufft1_2d_f64_tc_ref; the wrapper's result this kernel's."""
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.uniform(0, 1, (n, 2)), device=cuda_device)
    V = torch.as_tensor(rng.normal(size=(B, n)) + 1j * rng.normal(size=(B, n)),
                        device=cuda_device)
    batched = B > 1
    name = "nufft1_2d_batched" if batched else "nufft1_2d"
    geo = cuda_nufft.type1_2d_geometry(n, mtot, B, batched, torch.float64)
    key = (name, "f64", mtot)
    before = cuda_nufft.LAUNCH_PRECISIONS.get(key, 0)
    got = cuda_nufft._nufft1_2d_on(x, V, h, mtot, fft_order, geo, batched)
    torch.cuda.synchronize()
    assert cuda_nufft.LAUNCH_PRECISIONS[key] == before + 1
    assert got.shape == (B, mtot, mtot)
    assert torch.equal(cuda_nufft._nufft1_2d_on(x, V, h, mtot, fft_order, geo,
                                                batched), got)
    ref = nufft1_2d_batched_ref(x, V, h, mtot=mtot, fft_order=fft_order)
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-10 * scale
    twin = cuda_nufft.nufft1_2d_f64_tc_ref(x.cpu(), V.cpu(), h, mtot=mtot,
                                           fft_order=fft_order)
    assert float((got.cpu() - twin).abs().max()) <= 1e-12 * scale
    routed = (nufft1_2d_batched(x, V, h, mtot=mtot, fft_order=fft_order)
              if batched else nufft1_2d(x, V[0], h, mtot=mtot,
                                        fft_order=fft_order)[None])
    assert torch.equal(routed, got)


@pytest.mark.cuda
@pytest.mark.parametrize("field,value", [
    (0, 32), (1, 128), (2, 2), (3, 100), (4, 1000)])
def test_type1_f64_launch_refuses_foreign_geometry(cuda_device, field, value):
    """The FP64 tensor-core type-1's launch takes its geometry from
    ``type1_2d_geometry`` at float64 and refuses one it has no instance for
    (rows, cols, group, run or chunk changed): a CUDA error is raised, and
    nothing is written."""
    n, mtot = 4096, 29
    x = torch.rand((n, 2), dtype=torch.float64, device=cuda_device)
    v = torch.ones(n, dtype=torch.complex128, device=cuda_device)
    geo = list(cuda_nufft.type1_2d_geometry(n, mtot, dtype=torch.float64))
    geo[field] = value
    partial = torch.zeros((-(-n // 512) + 1, mtot, mtot),
                          dtype=torch.complex128, device=cuda_device)
    out = torch.zeros((mtot, mtot), dtype=torch.complex128,
                      device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_nufft._launch("nufft1_2d", x, x.data_ptr(), v.data_ptr(), 0.5,
                           n, mtot, 0, *geo, partial.data_ptr(),
                           out.data_ptr(), mtot=mtot)
    torch.cuda.synchronize()
    assert not bool(out.abs().any())


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,mtot,h,fft_order", [
    (11, 5001, 17, 0.4, False),
    (11, 3001, 21, 0.4, True),
    (3, 3000, 43, 0.4, True),
    (1, 2049, 29, 0.65, True),
    (10, 20_000, 107, 0.1, False),
    (1, 3000, 339, 0.97, True),
    (2, 777, 5, 0.3, False),
])
def test_type2_f64_tensor_core_kernel_on_card(cuda_device, B, n, mtot, h,
                                              fft_order):
    """The float64 d=2 type-2 on the FP64 tensor cores, batched and at B 1:
    one float64 launch a call; within 1e-12 of max|ref| of the float64
    plain version; bit for bit the same on a second launch; within 1e-12 of
    max|ref| of its twin nufft2_2d_f64_tc_ref; the batched wrapper's result
    this kernel's, and at B 1 the single instance's the same bits (the
    single wrapper's where type2_2d_single_geometry sends it here)."""
    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.uniform(0, 1, (n, 2)), device=cuda_device)
    F = torch.as_tensor(rng.normal(size=(B, mtot, mtot))
                        + 1j * rng.normal(size=(B, mtot, mtot)),
                        device=cuda_device)
    kw = dict(mtot=mtot, fft_order=fft_order)
    geo = cuda_nufft.type2_2d_geometry(mtot, torch.float64, B)
    key = ("nufft2_2d_batched", "f64", mtot)
    before = cuda_nufft.LAUNCH_PRECISIONS.get(key, 0)
    got = cuda_nufft._nufft2_2d_batched_on(x, F, h, mtot, fft_order, geo)
    torch.cuda.synchronize()
    assert cuda_nufft.LAUNCH_PRECISIONS[key] == before + 1
    assert got.shape == (B, n)
    assert torch.equal(cuda_nufft._nufft2_2d_batched_on(
        x, F, h, mtot, fft_order, geo), got)
    ref = nufft2_2d_batched_ref(x, F, h, **kw)
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-12 * scale
    twin = cuda_nufft.nufft2_2d_f64_tc_ref(x.cpu(), F.cpu(), h, **kw)
    assert float((got.cpu() - twin).abs().max()) <= 1e-12 * scale
    assert torch.equal(nufft2_2d_batched(x, F, h, **kw), got)
    if B == 1:
        single = cuda_nufft._nufft2_2d_on(x, F[0], h, mtot, fft_order, geo)
        assert torch.equal(single, got[0])
        if cuda_nufft.type2_2d_single_geometry(n, mtot,
                                               torch.float64)[0] == "tc":
            assert torch.equal(nufft2_2d(x, F[0], h, **kw), got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("field,value", [
    (1, 128), (2, 128), (3, 32), ("scratch", -1)])
def test_type2_f64_launch_refuses_foreign_geometry(cuda_device, field,
                                                   value):
    """The FP64 tensor-core type-2's launch takes its geometry from
    type2_2d_geometry at float64 and refuses one it has no instance for
    (points, columns or stage changed) and a scratch shorter than its
    split F: a CUDA error is raised, and nothing is written."""
    n, mtot, B = 1000, 43, 3
    x = torch.rand((n, 2), dtype=torch.float64, device=cuda_device)
    F = torch.ones((B, mtot, mtot), dtype=torch.complex128,
                   device=cuda_device)
    geo = list(cuda_nufft.type2_2d_geometry(mtot, torch.float64, B))
    doubles = cuda_nufft.type2_2d_f64_scratch_doubles(mtot, B, geo)
    if field == "scratch":
        doubles += value
    else:
        geo[field] = value
    scratch = torch.zeros(doubles + 8, dtype=torch.float64,
                          device=cuda_device)
    out = torch.zeros((B, n), dtype=torch.complex128, device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_nufft._launch("nufft2_2d_batched", x, x.data_ptr(),
                           F.data_ptr(), 0.5, n, mtot, B, 0, *geo[1:],
                           scratch.data_ptr(), doubles, out.data_ptr(),
                           mtot=mtot, symbol="gpq_nufft2_2d_batched_tc_f64")
    torch.cuda.synchronize()
    assert not bool(out.abs().any())
    assert not bool(scratch.any())


@pytest.mark.cuda
@pytest.mark.parametrize("kind,B,n,mtot,h,fft_order", [
    (1, 1, 5001, 919, 0.99, False),
    (1, 3, 3001, 301, 0.61, True),
    (1, 10, 4097, 1031, 0.99, False),
    (1, 1, 2000, 17, 0.4, True),
    (1, 5, 700, 33, 0.4, False),
    (2, 1, 5000, 919, 0.99, False),
    (2, 3, 3001, 301, 0.61, True),
    (2, 1, 2000, 2061, 0.99, True),
    (2, 200, 25, 15, 0.4, False),
    (2, 4000, 7, 17, 0.4, False),
])
def test_1d_f64_tensor_core_kernels_on_card(cuda_device, kind, B, n, mtot, h,
                                            fft_order):
    """The float64 d=1 pair on the FP64 tensor cores (type1_1d_f64_tc_
    geometry / type2_1d_f64_tc_geometry): one float64 launch a call;
    within 1e-10 of max|ref| of the float64 plain version; bit for bit the
    same on a second launch; within 1e-12 of max|ref| of its twin
    (nufft1_1d_f64_tc_ref / nufft2_1d_f64_tc_ref); the wrapper's result
    this kernel's where the dispatch picks it, else the CUDA cores', also
    within the bar."""
    rng = np.random.default_rng(10)
    x = torch.as_tensor(rng.uniform(-1, 1, (n, 1)), device=cuda_device)
    shape = (B, n) if kind == 1 else (B, mtot)
    arg = torch.as_tensor(rng.normal(size=shape) + 1j * rng.normal(
        size=shape), device=cuda_device)
    name = f"nufft{kind}_1d"
    on = getattr(cuda_nufft, f"_{name}_on")
    geo = getattr(cuda_nufft, f"type{kind}_1d_f64_tc_geometry")(n, mtot, B)
    kw = dict(mtot=mtot, fft_order=fft_order)
    key = (name, "f64", mtot)
    before = cuda_nufft.LAUNCH_PRECISIONS.get(key, 0)
    got = on(x, arg, h, mtot, fft_order, geo)
    torch.cuda.synchronize()
    assert cuda_nufft.LAUNCH_PRECISIONS[key] == before + 1
    assert got.shape == shape[:1] + ((mtot,) if kind == 1 else (n,))
    assert torch.equal(on(x, arg, h, mtot, fft_order, geo), got)
    ref = getattr(cuda_nufft, f"{name}_ref")(x, arg, h, **kw)
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-10 * scale
    twin = getattr(cuda_nufft, f"{name}_f64_tc_ref")(x.cpu(), arg.cpu(), h,
                                                      **kw)
    assert float((got.cpu() - twin).abs().max()) <= 1e-12 * scale
    routed = getattr(cuda_nufft, name)(x, arg, h, **kw)
    pick = getattr(cuda_nufft, f"type{kind}_1d_geometry")(n, mtot, B,
                                                           torch.float64)
    if pick == geo:
        assert torch.equal(routed, got)
    else:
        assert float((routed - ref).abs().max()) <= 1e-10 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("kind,field,value", [
    (1, 1, 32), (1, 2, 128), (1, 3, 3), (1, 4, 24), (1, 5, 100),
    (1, 6, 1000), (2, 1, 128), (2, 2, 12), (2, 2, 64), (2, 3, 48),
    (2, 4, 32), (2, 5, 4), (2, "scratch", -1)])
def test_1d_f64_launch_refuses_foreign_geometry(cuda_device, kind, field,
                                                value):
    """The FP64 tensor-core d=1 pair's launches take their geometry from
    type1_1d_f64_tc_geometry / type2_1d_f64_tc_geometry and refuse one they
    have no instance for (the type-1's rows, columns, group, a split S not
    a power of two, run or chunk; the type-2's points, K not a power of
    two or past TYPE2_1D_F64_MAX_K, columns, stage, splits that leave a
    run empty) and the type-2's
    scratch shorter than its split F: a CUDA error is raised, and nothing
    is written."""
    n, mtot, B = 1000, 119, 3
    x = torch.rand((n, 1), dtype=torch.float64, device=cuda_device)
    out = torch.zeros((B, mtot if kind == 1 else n), dtype=torch.complex128,
                      device=cuda_device)
    if kind == 1:
        v = torch.ones((B, n), dtype=torch.complex128, device=cuda_device)
        geo = list(cuda_nufft.type1_1d_f64_tc_geometry(n, mtot, B))
        geo[field] = value
        partial = torch.zeros((4, B, mtot), dtype=torch.complex128,
                              device=cuda_device)
        with pytest.raises(RuntimeError, match="CUDA error"):
            cuda_nufft._launch("nufft1_1d", x, x.data_ptr(), v.data_ptr(),
                               0.5, n, mtot, B, 0, *geo[1:],
                               partial.data_ptr(), out.data_ptr(), mtot=mtot,
                               symbol="gpq_nufft1_1d_tc_f64")
    else:
        f = torch.ones((B, mtot), dtype=torch.complex128, device=cuda_device)
        geo = list(cuda_nufft.type2_1d_f64_tc_geometry(n, mtot, B))
        doubles = cuda_nufft.type2_1d_f64_scratch_doubles(mtot, B, geo)
        if field == "scratch":
            doubles += value
        else:
            geo[field] = value
        scratch = torch.zeros(max(doubles, 1) * 4, dtype=torch.float64,
                              device=cuda_device)
        with pytest.raises(RuntimeError, match="CUDA error"):
            cuda_nufft._launch("nufft2_1d", x, x.data_ptr(), f.data_ptr(),
                               0.5, n, mtot, B, 0, *geo[1:],
                               scratch.data_ptr(), doubles, out.data_ptr(),
                               mtot=mtot, symbol="gpq_nufft2_1d_tc_f64")
        assert not bool(scratch.any())
    torch.cuda.synchronize()
    assert not bool(out.abs().any())


@pytest.mark.cuda
def test_ski_on_card_matches_cpu(cuda_device):
    """fit_ski_gp -> mean -> variance on the card (kernels, float64) against
    the CPU (plain versions), the probes drawn by one CPU generator seed:
    the history to 1e-6, mean and variance to 1e-6 of max|ref|; both
    kernels launched in the fit and the variance and ``W^T alpha`` in the
    mean (its ``W_* g`` is a gather), no plain banded or unbanded route."""
    from gpquad_torch.models import ski
    from gpquad_torch.ops import cuda_interp
    rng = np.random.default_rng(11)
    n = 4000
    x = rng.uniform(-1, 1, (n, 2))
    y = np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]) + 0.1 * rng.normal(size=n)
    xq = rng.uniform(-1, 1, (400, 2))
    out = {}
    for dev in ("cpu", cuda_device):
        stages = {}
        cuda_interp.LAUNCHES.update({k: 0 for k in cuda_interp.LAUNCHES})
        ski.INTERP_PICKS.update({k: 0 for k in ski.INTERP_PICKS})
        fit = ski.fit_ski_gp(x, y, grid_size=(48, 48), max_iters=3, lr=0.1,
                             dtype=torch.float64, cg_tolerance=1e-8,
                             max_cg_iterations=300, init_noise=0.3,
                             verbose=False,
                             generator=torch.Generator().manual_seed(0),
                             device=dev)
        stages["fit"] = dict(cuda_interp.LAUNCHES)
        mean = ski.ski_predict_mean(fit, xq)
        stages["mean"] = dict(cuda_interp.LAUNCHES)
        var = ski.ski_predict_var(fit, xq[:64], batch_size=32, cg_tol=1e-8)
        stages["var"] = dict(cuda_interp.LAUNCHES)
        out[str(dev)] = (fit["history"], mean.cpu().numpy(),
                         var.cpu().numpy(), stages, dict(ski.INTERP_PICKS))
    h_cpu, m_cpu, v_cpu, _, _ = out["cpu"]
    h_gpu, m_gpu, v_gpu, stages, picks = out[str(cuda_device)]
    for k in ("loss", "lengthscale", "outputscale", "noise"):
        assert np.all(np.abs(np.array(h_gpu[k]) - np.array(h_cpu[k]))
                      <= 1e-6 * np.abs(np.array(h_cpu[k]))), k
    assert np.max(np.abs(m_gpu - m_cpu)) < 1e-6 * np.max(np.abs(m_cpu))
    assert np.max(np.abs(v_gpu - v_cpu)) < 1e-6 * np.max(np.abs(v_cpu))
    prev = {"interp_T_2d": 0, "interp_2d": 0}
    for stage in ("fit", "mean", "var"):
        for k in prev:
            if stage == "mean" and k == "interp_2d":
                assert stages[stage][k] == prev[k]
            else:
                assert stages[stage][k] > prev[k], (stage, k)
        prev = stages[stage]
    assert picks["banded"] == 0 and picks["unbanded"] == 0


def _single_geometries(dtype, mtot):
    """Every path of the single type-2 in ``dtype``: the mode split, the
    CUDA cores and the tensor cores (float32: the batched 3xTF32 kernel at
    B 1; float64: the FP64 tensor cores' B 1 instance)."""
    geos = {"split": ("split", cuda_nufft.TYPE2_2D_SPLIT_ROWS,
                      cuda_nufft.TYPE2_2D_SPLIT_THREADS),
            "cuda": ("cuda",)}
    geos["tc"] = (_TYPE2_TC if dtype == torch.float32
                  else cuda_nufft.type2_2d_geometry(mtot, dtype))
    return geos


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,mtot,h,fft_order", [
    (1000, 29, 0.65, False),
    (777, 57, 0.65, True),
    (2000, 107, 0.1, False),
    (1000, 339, 0.97, True),
    (20_000, 339, 0.97, False),
])
def test_type2_single_paths_on_card(cuda_device, dtype, n, mtot, h,
                                    fft_order):
    """The single d=2 type-2 on each of its paths, on the same inputs: one
    launch of ``nufft2_2d`` counted a call; float32 within max(2x the
    float32 plain version's error, 1e-6) of max|ref| from float64 on the
    tensor cores and the mode split (the CUDA-core kernel within 1e-4, as
    before), float64 within 1e-13; bit for bit the same on a second launch;
    the tensor cores within twice the bar of their 3xTF32 twin at B 1 (in
    float64 the FP64 tensor cores within 1e-12 of max|ref| of theirs) and
    the split within it of its twin; the wrapper's result that of the path
    type2_2d_single_geometry gives the shape."""
    rng = np.random.default_rng(7)
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    x = torch.as_tensor(rng.uniform(0, 1, (n, 2)), device=cuda_device).to(dtype)
    f = torch.as_tensor(rng.normal(size=(mtot, mtot))
                        + 1j * rng.normal(size=(mtot, mtot)),
                        device=cuda_device).to(cdt)
    hq = float(torch.tensor(h, dtype=dtype))
    kw = dict(mtot=mtot, fft_order=fft_order)
    ref = nufft2_2d_ref(x.double(), f.to(torch.complex128), hq, **kw)
    scale = float(ref.abs().max())

    def err(a):
        return float((a.to(torch.complex128) - ref).abs().max()) / scale
    bar = (max(2 * err(nufft2_2d_ref(x, f, hq, **kw)), 1e-6)
           if dtype == torch.float32 else 1e-13)
    outs = {}
    for path, geo in _single_geometries(dtype, mtot).items():
        before = cuda_nufft.LAUNCHES["nufft2_2d"]
        got = cuda_nufft._nufft2_2d_on(x, f, hq, mtot, fft_order, geo)
        torch.cuda.synchronize()
        assert cuda_nufft.LAUNCHES["nufft2_2d"] == before + 1
        assert got.shape == (n,)
        assert torch.equal(
            cuda_nufft._nufft2_2d_on(x, f, hq, mtot, fft_order, geo), got)
        if path == "cuda" and dtype == torch.float32:
            assert err(got) < 1e-4
        else:
            assert err(got) <= bar, path
        outs[path] = got
    if dtype == torch.float32:
        twin = cuda_nufft.nufft2_2d_batched_3xtf32_ref(x.cpu(), f[None].cpu(),
                                                       hq, **kw)[0]
        assert float((outs["tc"].cpu() - twin).abs().max()) <= \
            2 * bar * scale
    else:
        twin = cuda_nufft.nufft2_2d_f64_tc_ref(x.cpu(), f[None].cpu(), hq,
                                               **kw)[0]
        assert float((outs["tc"].cpu() - twin).abs().max()) <= 1e-12 * scale
    split_twin = cuda_nufft.nufft2_2d_split_ref(x.cpu(), f.cpu(), hq, **kw)
    assert float((outs["split"].cpu() - split_twin).abs().max()) <= \
        2 * bar * scale
    routed = nufft2_2d(x, f, hq, **kw)
    path = cuda_nufft.type2_2d_single_geometry(n, mtot, dtype)[0]
    assert torch.equal(routed, outs[path])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,geo", [
    (torch.float32, ("split", 8, 64)),
    (torch.float32, ("split", 32, 128)),
    (torch.float64, ("split", 32, 64)),
    (torch.float32, ("tc", 64, 128, 32)),
    (torch.float32, ("tc", 128, 64, 32)),
    (torch.float32, ("tc", 128, 128, 16)),
])
def test_type2_single_launch_refuses_foreign_geometry(cuda_device, dtype,
                                                      geo):
    """The single type-2's split and tensor-core launches take their
    geometry from type2_2d_single_geometry and refuse one they have no
    instance for (rows or threads, points, columns or stage changed): a
    CUDA error is raised, and nothing is written."""
    n, mtot = 1000, 107
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    x = torch.rand((n, 2), device=cuda_device, dtype=dtype)
    f = torch.ones((mtot, mtot), dtype=cdt, device=cuda_device)
    out = torch.zeros(n, dtype=cdt, device=cuda_device)
    if geo[0] == "split":
        scratch = torch.zeros((-(-mtot // geo[1]) + 8, n), dtype=cdt,
                              device=cuda_device)
        prec = "f32" if dtype == torch.float32 else "f64"
        tail = (0, *geo[1:], scratch.data_ptr(), out.data_ptr())
        symbol = f"gpq_nufft2_2d_split_{prec}"
    else:
        # the batched kernel at B 1
        floats = cuda_nufft.type2_2d_scratch_floats(mtot, 1, _TYPE2_TC)
        scratch = torch.zeros(floats, device=cuda_device)
        tail = (1, 0, *geo[1:], scratch.data_ptr(), floats, out.data_ptr())
        symbol = "gpq_nufft2_2d_batched_tc_f32"
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_nufft._launch("nufft2_2d", x, x.data_ptr(), f.data_ptr(), 0.5, n,
                           mtot, *tail, mtot=mtot, symbol=symbol)
    torch.cuda.synchronize()
    assert not bool(out.abs().any())
    assert not bool(scratch.abs().any())


# ---------------------------------------------------------------------------
# W v in one launch (row 14) and the float32 d=1 type-1 on the tensor cores
# (row 6)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n,grid", [(1, 20_000, (200, 150)),
                                      (3, 20_000, (200, 150)),
                                      (8, 5_000, (60, 300)),
                                      (21, 3_000, (8, 600)),
                                      (2, 3_000, (30, 1500))])
def test_interp_points_kernel_on_card(cuda_device, dtype, B, n, grid):
    """W v from the grid to point order: one launch, bit for bit its plain
    twin and a second launch, within 1e-5 (f32) / 1e-12 (f64) of max|ref|
    from the float64 twin; the real part of a complex grid (a strided
    view, element copies) gives what its contiguous copy gives; G2 1504
    (grid 1500) takes two column tiles in float32 and three in float64;
    the unchecked launch gives the same bits, and a point table that
    reaches past n is refused with no launch."""
    from gpquad_torch.ops import cuda_interp
    rng, op = _ski_tables(cuda_device, dtype, n, grid)
    t = op.banded
    G1, G2 = op.grid_shape
    tabs = (t.i0loc, t.c0, t.w_row, t.w_col, t.pout)
    kw = dict(G1=G1, G2=G2, n=n, bh=8)
    v = torch.as_tensor(rng.normal(size=(B, G1 * G2)),
                        device=cuda_device).to(dtype)
    before = cuda_interp.LAUNCHES["interp_2d"]
    got = cuda_interp.interp_2d_points(v, *tabs, **kw)
    torch.cuda.synchronize()
    assert cuda_interp.LAUNCHES["interp_2d"] == before + 1
    assert got.shape == (B, n)
    assert torch.equal(cuda_interp.interp_2d_points(v, *tabs, **kw), got)
    assert torch.equal(cuda_interp.interp_2d_points_ref(v, *tabs, **kw), got)
    ref = cuda_interp.interp_2d_points_ref(
        v.double(), t.i0loc, t.c0, t.w_row.double(), t.w_col.double(),
        t.pout, **kw)
    bar = 1e-5 if dtype == torch.float32 else 1e-12
    assert _rel(got.double(), ref) < bar
    z = torch.complex(v, 0.5 * v)
    assert not z.real.is_contiguous()
    assert torch.equal(cuda_interp.interp_2d_points(z.real, *tabs, **kw), got)
    # the unchecked launch (the operator's, on its checked plan) is the
    # same kernel; a point past n is refused before any launch
    assert torch.equal(cuda_interp.interp_2d_points_trusted(v, *tabs, **kw),
                       got)
    wild = t.pout.clone()
    wild[0, 0] = n
    launches = cuda_interp.LAUNCHES["interp_2d"]
    with pytest.raises(ValueError, match="pout must lie"):
        cuda_interp.interp_2d_points(v, *tabs[:4], wild, **kw)
    assert cuda_interp.LAUNCHES["interp_2d"] == launches


@pytest.mark.cuda
def test_ski_interp_is_one_launch(cuda_device):
    """SKIOperator.interp on the card is one launch of the interp kernel
    and no other device work: no pad, transpose or gather around it (the
    profiler sees one CUDA kernel), for one vector and a batch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from gpquad_torch.ops import cuda_interp
    rng, op = _ski_tables(cuda_device, torch.float32, 20_000, (200, 150))
    for shape in ((op.M,), (3, op.M)):
        v = torch.as_tensor(rng.normal(size=shape), device=cuda_device).float()
        op.interp(v)
        torch.cuda.synchronize()
        # a capture that holds no CUDA event at all saw nothing (once in
        # a run the profiler's device tracing came back empty): take the
        # first of up to three captures that saw the device
        for _ in range(3):
            before = cuda_interp.LAUNCHES["interp_2d"]
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                out = op.interp(v)
                torch.cuda.synchronize()
            assert cuda_interp.LAUNCHES["interp_2d"] == before + 1
            kernels = [e.name for e in prof.events()
                       if e.device_type == DeviceType.CUDA]
            if kernels:
                break
        assert out.shape == shape[:-1] + (op.banded.inv_slot.shape[0],)
        assert len(kernels) == 1 and "interp_kernel" in kernels[0], kernels


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,mtot,h,fft_order", [
    (1, 5000, 1031, 0.99, False),
    (1, 3000, 2061, 0.99, True),
    (3, 2000, 33, 0.31, False),
    (10, 20_000, 1031, 0.99, False),
    (1, 20_000, 8191, 0.97, False),
])
def test_type1_1d_tensor_core_kernel_on_card(cuda_device, B, n, mtot, h,
                                             fft_order):
    """The float32 nufft1_1d takes the tensor cores (type1_1d_geometry):
    one launch, bit for bit the tensor-core path's result and the same on a
    second launch; within max(2x the float32 plain version's error, 1e-6)
    of max|ref| from float64, and within twice that of its 3xTF32 twin.

    The twin is held to a bar, not bit for bit, as the d=2 type-1's is: the
    tensor cores' rounding inside an 8-point ``mma`` product is not
    specified (they do not round their fp32 sums to nearest), and the twin
    makes its phases in float64 from the exact t = x h where the kernel
    takes them from ``phase_split`` and ``sincospif`` in float32; both
    differences sit far below the bar."""
    rng = np.random.default_rng(12)
    x = torch.as_tensor(rng.uniform(0, 1, (n, 1)),
                        device=cuda_device).float()
    V = torch.as_tensor(rng.normal(size=(B, n)) + 1j * rng.normal(size=(B, n)),
                        device=cuda_device).to(torch.complex64)
    hq = float(torch.tensor(h, dtype=torch.float32))
    kw = dict(mtot=mtot, fft_order=fft_order)
    arg = V[0] if B == 1 else V
    before = cuda_nufft.LAUNCHES["nufft1_1d"]
    got = nufft1_1d(x, arg, hq, **kw).reshape(B, mtot)
    torch.cuda.synchronize()
    assert cuda_nufft.LAUNCHES["nufft1_1d"] == before + 1
    geo = cuda_nufft.type1_1d_geometry(n, mtot, B)
    assert geo[0] == "tc"
    assert torch.equal(cuda_nufft._nufft1_1d_on(x, V, hq, mtot, fft_order,
                                                geo), got)
    assert torch.equal(nufft1_1d(x, arg, hq, **kw).reshape(B, mtot), got)
    ref = nufft1_1d_ref(x.double(), V.to(torch.complex128), hq, **kw)
    scale = float(ref.abs().max())

    def err(a):
        return float((a.to(torch.complex128) - ref).abs().max()) / scale
    bar = max(2 * err(nufft1_1d_ref(x, V, hq, **kw)), 1e-6)
    assert err(got) <= bar
    twin = cuda_nufft.nufft1_1d_3xtf32_ref(x, V, hq, **kw)
    assert float((got - twin).abs().max()) <= 2 * bar * scale


@pytest.mark.cuda
@pytest.mark.parametrize("field,value", [
    (1, 32), (2, 64), (3, 3), (4, 48), (5, 300), (6, 384)])
def test_type1_1d_launch_refuses_foreign_geometry(cuda_device, field, value):
    """The float32 d=1 type-1's launch takes its geometry from
    type1_1d_geometry and refuses one it has no instance for (rows, cols,
    group, stage, run or chunk changed): a CUDA error is raised, and
    nothing is written."""
    n, mtot = 4096, 1031
    x = torch.rand((n, 1), device=cuda_device)
    v = torch.ones((1, n), dtype=torch.complex64, device=cuda_device)
    geo = list(cuda_nufft.type1_1d_geometry(n, mtot))
    geo[field] = value
    partial = torch.zeros((n, 1, mtot), dtype=torch.complex64,
                          device=cuda_device)
    out = torch.zeros((1, mtot), dtype=torch.complex64, device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_nufft._launch("nufft1_1d", x, x.data_ptr(), v.data_ptr(), 0.5,
                           n, mtot, 1, 0, *geo[1:], partial.data_ptr(),
                           out.data_ptr(), mtot=mtot,
                           symbol="gpq_nufft1_1d_tc_f32")
    torch.cuda.synchronize()
    assert not bool(out.abs().any())


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,mtot,h,fft_order", [
    (1, 5000, 1031, 0.99, False),
    (1, 3000, 2061, 0.99, True),
    (3, 1500, 33, 0.31, False),
    (10, 20_000, 1031, 0.99, False),
    (1, 20_000, 8191, 0.97, False),
    (2, 777, 65, 0.5, True),
])
def test_type2_1d_tensor_core_kernel_on_card(cuda_device, B, n, mtot, h,
                                             fft_order):
    """The float32 d=1 type-2 on the tensor cores (type2_1d_tc_geometry):
    one launch counted a call, bit for bit the same on a second launch;
    within max(2x the float32 plain version's error, 1e-6) of max|ref| from
    float64, and within twice that of its 3xTF32 twin (held to a bar, not
    bit for bit: the tensor cores' rounding inside an 8-mode product is not
    specified, and the twin's phases are float64 ones of the exact t = x h);
    the wrapper's result that of the path type2_1d_geometry picks."""
    rng = np.random.default_rng(13)
    x = torch.as_tensor(rng.uniform(0, 1, (n, 1)),
                        device=cuda_device).float()
    F = torch.as_tensor(rng.normal(size=(B, mtot))
                        + 1j * rng.normal(size=(B, mtot)),
                        device=cuda_device).to(torch.complex64)
    hq = float(torch.tensor(h, dtype=torch.float32))
    kw = dict(mtot=mtot, fft_order=fft_order)
    geo = cuda_nufft.type2_1d_tc_geometry(B)
    before = cuda_nufft.LAUNCHES["nufft2_1d"]
    got = cuda_nufft._nufft2_1d_on(x, F, hq, mtot, fft_order, geo)
    torch.cuda.synchronize()
    assert cuda_nufft.LAUNCHES["nufft2_1d"] == before + 1
    assert got.shape == (B, n)
    assert torch.equal(cuda_nufft._nufft2_1d_on(x, F, hq, mtot, fft_order,
                                                geo), got)
    ref = nufft2_1d_ref(x.double(), F.to(torch.complex128), hq, **kw)
    scale = float(ref.abs().max())

    def err(a):
        return float((a.to(torch.complex128) - ref).abs().max()) / scale
    bar = max(2 * err(nufft2_1d_ref(x, F, hq, **kw)), 1e-6)
    assert err(got) <= bar
    twin = cuda_nufft.nufft2_1d_3xtf32_ref(x, F, hq, geometry=geo, **kw)
    assert float((got - twin).abs().max()) <= 2 * bar * scale
    routed = nufft2_1d(x, F, hq, **kw)
    if cuda_nufft.type2_1d_geometry(n, mtot, B)[0] == "tc":
        assert torch.equal(routed, got)
    else:
        assert err(routed) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("field,value", [(1, 64), (2, 64), (3, 64),
                                         (4, 16)])
def test_type2_1d_launch_refuses_foreign_geometry(cuda_device, field, value):
    """The tensor-core d=1 type-2's launch takes its geometry from
    type2_1d_geometry and refuses one it has no instance for (points, K,
    columns or stage changed): a CUDA error is raised, and nothing is
    written."""
    n, mtot, B = 1000, 1031, 3
    x = torch.rand((n, 1), device=cuda_device)
    F = torch.ones((B, mtot), dtype=torch.complex64, device=cuda_device)
    geo = list(cuda_nufft.type2_1d_tc_geometry(B))
    floats = cuda_nufft.type2_1d_scratch_floats(mtot, B, tuple(geo))
    geo[field] = value
    scratch = torch.zeros(floats, device=cuda_device)
    out = torch.zeros((B, n), dtype=torch.complex64, device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_nufft._launch("nufft2_1d", x, x.data_ptr(), F.data_ptr(), 0.5,
                           n, mtot, B, 0, *geo[1:], scratch.data_ptr(),
                           floats, out.data_ptr(), mtot=mtot,
                           symbol="gpq_nufft2_1d_tc_f32")
    torch.cuda.synchronize()
    assert not bool(out.abs().any())
    assert not bool(scratch.any())


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,mtot,h,fft_order", [
    (1, 5000, 9, 0.31, False),
    (3, 4001, 21, 0.65, True),
    (10, 3000, 31, 0.2, False),
    (1, 20_000, 61, 0.2, False),
    (1, 2000, 101, 0.2, True),
])
def test_type1_3d_tensor_core_kernel_on_card(cuda_device, B, n, mtot, h,
                                             fft_order):
    """The float32 d=3 type-1 on the tensor cores (type1_3d_tc_geometry):
    one launch counted a call, bit for bit the same on a second launch;
    within max(2x the float32 plain version's error, 1e-6) of max|ref| from
    float64, and within twice that of its 3xTF32 twin; the wrapper's result
    that of the path type1_3d_geometry picks."""
    rng = np.random.default_rng(14)
    x = torch.as_tensor(rng.uniform(0, 1, (n, 3)),
                        device=cuda_device).float()
    V = torch.as_tensor(rng.normal(size=(B, n)) + 1j * rng.normal(size=(B, n)),
                        device=cuda_device).to(torch.complex64)
    hq = float(torch.tensor(h, dtype=torch.float32))
    kw = dict(mtot=mtot, fft_order=fft_order)
    geo = cuda_nufft.type1_3d_tc_geometry(n, mtot, B)
    before = cuda_nufft.LAUNCHES["nufft1_3d"]
    got = cuda_nufft._nufft1_3d_on(x, V, hq, mtot, fft_order, geo)
    torch.cuda.synchronize()
    assert cuda_nufft.LAUNCHES["nufft1_3d"] == before + 1
    assert got.shape == (B,) + (mtot,) * 3
    assert torch.equal(cuda_nufft._nufft1_3d_on(x, V, hq, mtot, fft_order,
                                                geo), got)
    ref = nufft1_3d_ref(x.double(), V.to(torch.complex128), hq, **kw)
    scale = float(ref.abs().max())

    def err(a):
        return float((a.to(torch.complex128) - ref).abs().max()) / scale
    bar = max(2 * err(nufft1_3d_ref(x, V, hq, **kw)), 1e-6)
    assert err(got) <= bar
    twin = cuda_nufft.nufft1_3d_3xtf32_ref(x, V, hq, **kw)
    assert float((got - twin).abs().max()) <= 2 * bar * scale
    routed = nufft1_3d(x, V, hq, **kw)
    if cuda_nufft.type1_3d_geometry(n, mtot, B)[0] == "tc":
        assert torch.equal(routed, got)
    else:
        assert err(routed) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("field,value", [
    (1, 32), (2, 64), (3, 3), (4, 48), (5, 1000), (6, 1536)])
def test_type1_3d_launch_refuses_foreign_geometry(cuda_device, field, value):
    """The float32 d=3 type-1's launch takes its geometry from
    type1_3d_geometry and refuses one it has no instance for (rows, cols,
    group, stage, run or chunk changed): a CUDA error is raised, and
    nothing is written."""
    n, mtot = 4096, 21
    x = torch.rand((n, 3), device=cuda_device)
    v = torch.ones((1, n), dtype=torch.complex64, device=cuda_device)
    geo = list(cuda_nufft.type1_3d_tc_geometry(n, mtot))
    geo[field] = value
    partial = torch.zeros((n, 1) + (mtot,) * 3, dtype=torch.complex64,
                          device=cuda_device)
    out = torch.zeros((1,) + (mtot,) * 3, dtype=torch.complex64,
                      device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_nufft._launch("nufft1_3d", x, x.data_ptr(), v.data_ptr(), 0.5,
                           n, mtot, 1, 0, *geo[1:], partial.data_ptr(),
                           out.data_ptr(), mtot=mtot,
                           symbol="gpq_nufft1_3d_tc_f32")
    torch.cuda.synchronize()
    assert not bool(out.abs().any())


@pytest.mark.cuda
def test_type1_3d_launch_refuses_overflowing_table(cuda_device):
    """Past mtot 64 a 128-column tile's phase table would pass Type1Grid3D's
    72 entries a point: the launch refuses that width (a CUDA error, nothing
    written), and the geometry takes 32 there."""
    n, mtot = 2048, 101
    x = torch.rand((n, 3), device=cuda_device)
    v = torch.ones((1, n), dtype=torch.complex64, device=cuda_device)
    geo = list(cuda_nufft.type1_3d_tc_geometry(n, mtot))
    assert geo[2] == 32
    geo[2] = 128
    partial = torch.zeros((1, 1) + (mtot,) * 3, dtype=torch.complex64,
                          device=cuda_device)
    out = torch.zeros((1,) + (mtot,) * 3, dtype=torch.complex64,
                      device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_nufft._launch("nufft1_3d", x, x.data_ptr(), v.data_ptr(), 0.5,
                           n, mtot, 1, 0, *geo[1:], partial.data_ptr(),
                           out.data_ptr(), mtot=mtot,
                           symbol="gpq_nufft1_3d_tc_f32")
    torch.cuda.synchronize()
    assert not bool(out.abs().any())


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,mtot,h,fft_order", [
    (1, 5000, 65, 0.31, False),
    (2, 3001, 73, 0.65, True),
    (1, 3000, 101, 0.2, True),
    (3, 2000, 105, 0.97, False),
    (1, 20_000, 61, 0.2, False),
    (1, 1000, 255, 0.97, True),
])
def test_type1_3d_wide_kernel_on_card(cuda_device, B, n, mtot, h, fft_order):
    """The float32 d=3 type-1 on the wide grids' tensor-core kernel
    (csrc/tc_type1_wide.cuh, type1_3d_wide_geometry; tiles of 128 modes
    j3, one or several point groups, B 1 to 3, both orders): one launch
    counted a
    call, bit for bit the same on a second launch; within max(2x the
    float32 plain version's error, 1e-6) of max|ref| from float64, and
    within twice that of its twin nufft1_3d_wide_ref; past mtot 64 the
    wrapper's result is this kernel's."""
    rng = np.random.default_rng(23)
    x = torch.as_tensor(rng.uniform(-1, 1, (n, 3)),
                        device=cuda_device).float()
    V = torch.as_tensor(rng.normal(size=(B, n)) + 1j * rng.normal(size=(B, n)),
                        device=cuda_device).to(torch.complex64)
    hq = float(torch.tensor(h, dtype=torch.float32))
    kw = dict(mtot=mtot, fft_order=fft_order)
    geo = cuda_nufft.type1_3d_wide_geometry(n, mtot, B)
    before = cuda_nufft.LAUNCHES["nufft1_3d"]
    got = cuda_nufft._nufft1_3d_on(x, V, hq, mtot, fft_order, geo)
    torch.cuda.synchronize()
    assert cuda_nufft.LAUNCHES["nufft1_3d"] == before + 1
    assert got.shape == (B,) + (mtot,) * 3
    assert torch.equal(cuda_nufft._nufft1_3d_on(x, V, hq, mtot, fft_order,
                                                geo), got)
    ref = nufft1_3d_ref(x.double(), V.to(torch.complex128), hq, **kw)
    scale = float(ref.abs().max())

    def err(a):
        return float((a.to(torch.complex128) - ref).abs().max()) / scale
    bar = max(2 * err(nufft1_3d_ref(x, V, hq, **kw)), 1e-6)
    assert err(got) <= bar
    twin = cuda_nufft.nufft1_3d_wide_ref(x, V, hq, **kw)
    assert float((got - twin).abs().max()) <= 2 * bar * scale
    pick = cuda_nufft.type1_3d_geometry(n, mtot, B)
    if mtot > cuda_nufft.TYPE1_3D_TC_MAX_MTOT:
        assert pick == geo
        assert torch.equal(nufft1_3d(x, V, hq, **kw), got)


@pytest.mark.cuda
@pytest.mark.parametrize("field,value", [
    (1, 32), (2, 64), (2, 32), (3, 48), (3, 0), (4, 1000), (5, 1536),
    ("mtot", 31)])
def test_type1_3d_wide_launch_refuses_foreign_geometry(cuda_device, field,
                                                       value):
    """The wide d=3 type-1's launch takes its geometry from
    type1_3d_wide_geometry and refuses one it has no instance for (rows,
    cols (32 included: one instance, 128 columns), stage, run or chunk
    changed, or mtot below the kernel's least): a CUDA error is raised, and
    nothing is written."""
    n, mtot = 4096, 67
    x = torch.rand((n, 3), device=cuda_device)
    v = torch.ones((1, n), dtype=torch.complex64, device=cuda_device)
    geo = list(cuda_nufft.type1_3d_wide_geometry(n, mtot))
    if field == "mtot":
        mtot = value
    else:
        geo[field] = value
    partial = torch.zeros((8, 1) + (mtot,) * 3, dtype=torch.complex64,
                          device=cuda_device)
    out = torch.zeros((1,) + (mtot,) * 3, dtype=torch.complex64,
                      device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_nufft._launch("nufft1_3d", x, x.data_ptr(), v.data_ptr(), 0.5,
                           n, mtot, 1, 0, *geo[1:], partial.data_ptr(),
                           out.data_ptr(), mtot=mtot,
                           symbol="gpq_nufft1_3d_wide_f32")
    torch.cuda.synchronize()
    assert not bool(out.abs().any())


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,mtot,h,fft_order", [
    (1, 5000, 21, 0.65, False),
    (3, 4001, 41, 0.4, True),
    (10, 3000, 31, 0.2, False),
    (1, 2000, 67, 0.3, True),
    (1, 2000, 101, 0.97, False),
    (2, 999, 5, 0.3, True),
])
def test_type1_3d_f64_tensor_core_kernel_on_card(cuda_device, B, n, mtot, h,
                                                 fft_order):
    """The float64 d=3 type-1 on the FP64 tensor cores (type1_3d_geometry
    at float64): one float64 launch a call; within 1e-10 of max|ref| of the
    float64 plain version; bit for bit the same on a second launch; within
    1e-12 of max|ref| of its twin nufft1_3d_f64_tc_ref; the wrapper's
    result this kernel's."""
    rng = np.random.default_rng(20)
    x = torch.as_tensor(rng.uniform(0, 1, (n, 3)), device=cuda_device)
    V = torch.as_tensor(rng.normal(size=(B, n)) + 1j * rng.normal(size=(B, n)),
                        device=cuda_device)
    kw = dict(mtot=mtot, fft_order=fft_order)
    geo = cuda_nufft.type1_3d_geometry(n, mtot, B, torch.float64)
    key = ("nufft1_3d", "f64", mtot)
    before = cuda_nufft.LAUNCH_PRECISIONS.get(key, 0)
    got = cuda_nufft._nufft1_3d_on(x, V, h, mtot, fft_order, geo)
    torch.cuda.synchronize()
    assert cuda_nufft.LAUNCH_PRECISIONS[key] == before + 1
    assert got.shape == (B,) + (mtot,) * 3
    assert torch.equal(cuda_nufft._nufft1_3d_on(x, V, h, mtot, fft_order,
                                                geo), got)
    ref = nufft1_3d_ref(x, V, h, **kw)
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-10 * scale
    twin = cuda_nufft.nufft1_3d_f64_tc_ref(x, V, h, **kw)
    assert float((got - twin).abs().max()) <= 1e-12 * scale
    routed = nufft1_3d(x, V if B > 1 else V[0], h, **kw)
    assert torch.equal(routed.reshape(got.shape), got)


@pytest.mark.cuda
@pytest.mark.parametrize("field,value", [
    (1, 32), (2, 128), (3, 3), (4, 0), (4, 9), (5, 100), (6, 1000),
    (0, "out")])
def test_type1_3d_f64_launch_refuses_foreign_geometry(cuda_device, field,
                                                      value):
    """The FP64 tensor-core d=3 type-1's launch takes its geometry from
    ``type1_3d_geometry`` at float64 and refuses one it has no instance for
    (rows, cols, group, split, run or chunk changed), and the output as
    its partial where the points make more than one group: a CUDA error
    is raised, and nothing is written."""
    n, mtot = 4096, 21
    x = torch.rand((n, 3), dtype=torch.float64, device=cuda_device)
    v = torch.ones((1, n), dtype=torch.complex128, device=cuda_device)
    geo = list(cuda_nufft.type1_3d_geometry(n, mtot, 1, torch.float64))
    assert -(-n // geo[-1]) > 1
    if field:
        geo[field] = value
    partial = torch.zeros((n, 1) + (mtot,) * 3, dtype=torch.complex128,
                          device=cuda_device)
    out = torch.zeros((1,) + (mtot,) * 3, dtype=torch.complex128,
                      device=cuda_device)
    if value == "out":
        partial = out
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_nufft._launch("nufft1_3d", x, x.data_ptr(), v.data_ptr(), 0.5,
                           n, mtot, 1, 0, *geo[1:], partial.data_ptr(),
                           out.data_ptr(), mtot=mtot)
    torch.cuda.synchronize()
    assert not bool(out.abs().any())


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,mtot,h,fft_order,cols,splits", [
    (1, 1000, 21, 0.65, False, None, None),
    (1, 1000, 41, 0.65, True, None, None),
    (3, 4001, 21, 0.65, True, None, 1),
    (10, 3000, 31, 0.2, False, 32, 5),
    (1, 2000, 61, 0.2, True, None, 3),
    (1, 777, 101, 0.97, False, 64, None),
    (2, 999, 5, 0.3, True, None, None),
])
def test_type2_3d_f64_tensor_core_kernel_on_card(cuda_device, B, n, mtot, h,
                                                 fft_order, cols, splits):
    """The float64 d=3 type-2 on the FP64 tensor cores (type2_3d_geometry
    at float64, its tile width and splits as given or the geometry's): one
    float64 launch a call; within 1e-12 of max|ref| of the float64 plain
    version; bit for bit the same on a second launch; within 1e-12 of
    max|ref| of its twin nufft2_3d_f64_tc_ref with the same splits; the
    wrapper's result this kernel's where the geometry is the wrapper's."""
    rng = np.random.default_rng(21)
    x = torch.as_tensor(rng.uniform(0, 1, (n, 3)), device=cuda_device)
    F = torch.as_tensor(rng.normal(size=(B, mtot ** 3))
                        + 1j * rng.normal(size=(B, mtot ** 3)),
                        device=cuda_device)
    kw = dict(mtot=mtot, fft_order=fft_order)
    geo = list(cuda_nufft.type2_3d_geometry(n, mtot, B, torch.float64))
    geo[2], geo[4] = cols or geo[2], splits or geo[4]
    geo = tuple(geo)
    key = ("nufft2_3d", "f64", mtot)
    before = cuda_nufft.LAUNCH_PRECISIONS.get(key, 0)
    got = cuda_nufft._nufft2_3d_on(x, F, h, mtot, fft_order, geo)
    torch.cuda.synchronize()
    assert cuda_nufft.LAUNCH_PRECISIONS[key] == before + 1
    assert got.shape == (B, n)
    assert torch.equal(cuda_nufft._nufft2_3d_on(x, F, h, mtot, fft_order,
                                                geo), got)
    ref = nufft2_3d_ref(x, F, h, **kw)
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-12 * scale
    twin = cuda_nufft.nufft2_3d_f64_tc_ref(x, F, h, splits=geo[4], **kw)
    assert float((got - twin).abs().max()) <= 1e-12 * scale
    routed = nufft2_3d(x, F if B > 1 else F[0], h, **kw)
    if cuda_nufft.type2_3d_geometry(n, mtot, B, torch.float64) == geo:
        assert torch.equal(routed.reshape(got.shape), got)


@pytest.mark.cuda
@pytest.mark.parametrize("field,value", [
    (1, 128), (2, 128), (2, 48), (3, 32), (4, 0), (4, 10), (0, "short")])
def test_type2_3d_f64_launch_refuses_foreign_geometry(cuda_device, field,
                                                      value):
    """The FP64 tensor-core d=3 type-2's launch takes its geometry from
    type2_3d_geometry at float64 and refuses one it has no instance for
    (points, a column tile other than 32 or 64, stage, no split, or splits
    with an empty one: 10 of mtot 21's 16 chunks), and a scratch shorter
    than F and the partials: a CUDA error is raised, and nothing is
    written."""
    n, mtot, B = 1000, 21, 2
    x = torch.rand((n, 3), dtype=torch.float64, device=cuda_device)
    F = torch.ones((B, mtot ** 3), dtype=torch.complex128,
                   device=cuda_device)
    geo = list(cuda_nufft.type2_3d_geometry(n, mtot, B, torch.float64))
    assert geo[4] > 1
    doubles = cuda_nufft.type2_3d_f64_scratch_doubles(n, mtot, B, geo)
    if field:
        geo[field] = value
    else:
        doubles -= 1
    scratch = torch.zeros(doubles, dtype=torch.float64, device=cuda_device)
    out = torch.zeros((B, n), dtype=torch.complex128, device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_nufft._launch("nufft2_3d", x, x.data_ptr(), F.data_ptr(), 0.5,
                           n, mtot, B, 0, *geo[1:], scratch.data_ptr(),
                           doubles, out.data_ptr(), mtot=mtot)
    torch.cuda.synchronize()
    assert not bool(out.abs().any())
    assert not bool(scratch.any())


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,mtot,h,fft_order,cols,splits", [
    (1, 5000, 9, 0.31, False, None, None),
    (3, 4001, 21, 0.65, True, None, None),
    (10, 3000, 31, 0.2, False, None, 1),
    (10, 3000, 31, 0.2, False, 32, 5),
    (1, 1000, 61, 0.2, True, None, None),
    (1, 2000, 101, 0.2, False, 32, None),
])
def test_type2_3d_tensor_core_kernel_on_card(cuda_device, B, n, mtot, h,
                                             fft_order, cols, splits):
    """The float32 d=3 type-2 on the tensor cores (type2_3d_tc_geometry, its
    tile width and splits as given or the geometry's): one launch counted a
    call, bit for bit the same on a second launch; within max(2x the
    float32 plain version's error, 1e-6) of max|ref| from float64, and
    within twice that of its 3xTF32 twin with the same geometry; the
    wrapper's result that of the path type2_3d_geometry picks."""
    rng = np.random.default_rng(15)
    x = torch.as_tensor(rng.uniform(0, 1, (n, 3)),
                        device=cuda_device).float()
    F = torch.as_tensor(rng.normal(size=(B, mtot ** 3))
                        + 1j * rng.normal(size=(B, mtot ** 3)),
                        device=cuda_device).to(torch.complex64)
    hq = float(torch.tensor(h, dtype=torch.float32))
    kw = dict(mtot=mtot, fft_order=fft_order)
    geo = list(cuda_nufft.type2_3d_tc_geometry(n, mtot, B))
    geo[2], geo[4] = cols or geo[2], splits or geo[4]
    geo = tuple(geo)
    before = cuda_nufft.LAUNCHES["nufft2_3d"]
    got = cuda_nufft._nufft2_3d_on(x, F, hq, mtot, fft_order, geo)
    torch.cuda.synchronize()
    assert cuda_nufft.LAUNCHES["nufft2_3d"] == before + 1
    assert got.shape == (B, n)
    assert torch.equal(cuda_nufft._nufft2_3d_on(x, F, hq, mtot, fft_order,
                                                geo), got)
    ref = nufft2_3d_ref(x.double(), F.to(torch.complex128), hq, **kw)
    scale = float(ref.abs().max())

    def err(a):
        return float((a.to(torch.complex128) - ref).abs().max()) / scale
    bar = max(2 * err(nufft2_3d_ref(x, F, hq, **kw)), 1e-6)
    assert err(got) <= bar
    twin = cuda_nufft.nufft2_3d_3xtf32_ref(x, F, hq, geometry=geo, **kw)
    assert float((got - twin).abs().max()) <= 2 * bar * scale
    routed = nufft2_3d(x, F, hq, **kw)
    if cuda_nufft.type2_3d_geometry(n, mtot, B) == geo:
        assert torch.equal(routed, got)
    else:
        assert err(routed) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("field,value", [
    (1, 64), (2, 128), (2, 48), (3, 16), (4, 0), (4, 20)])
def test_type2_3d_launch_refuses_foreign_geometry(cuda_device, field, value):
    """The float32 d=3 type-2's launch takes its geometry from
    type2_3d_geometry and refuses one it has no instance for (points,
    stage, a column tile other than 32 or 64, no split, or splits with an
    empty one: 20 of mtot 21's 21 stages): a CUDA error is raised, and
    nothing is written."""
    n, mtot, B = 1000, 21, 2
    x = torch.rand((n, 3), device=cuda_device)
    F = torch.ones((B, mtot ** 3), dtype=torch.complex64, device=cuda_device)
    geo = list(cuda_nufft.type2_3d_tc_geometry(n, mtot, B))
    geo[field] = value
    floats = 4 * 21 * 32 * 128 + 2 * 21 * B * n
    scratch = torch.zeros(floats, device=cuda_device)
    out = torch.zeros((B, n), dtype=torch.complex64, device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_nufft._launch("nufft2_3d", x, x.data_ptr(), F.data_ptr(), 0.5,
                           n, mtot, B, 0, *geo[1:], scratch.data_ptr(),
                           floats, out.data_ptr(), mtot=mtot,
                           symbol="gpq_nufft2_3d_tc_f32")
    torch.cuda.synchronize()
    assert not bool(out.abs().any())
    assert not bool(scratch.any())


@pytest.mark.cuda
def test_type2_3d_launch_refuses_short_scratch(cuda_device):
    """The launch checks the scratch against the split f and the splits'
    partials it must hold (type2_3d_scratch_floats): one float short is
    refused, nothing written."""
    n, mtot, B = 1000, 21, 2
    x = torch.rand((n, 3), device=cuda_device)
    F = torch.ones((B, mtot ** 3), dtype=torch.complex64, device=cuda_device)
    geo = cuda_nufft.type2_3d_tc_geometry(n, mtot, B)
    assert geo[-1] > 1
    floats = cuda_nufft.type2_3d_scratch_floats(n, mtot, B, geo) - 1
    scratch = torch.zeros(floats, device=cuda_device)
    out = torch.zeros((B, n), dtype=torch.complex64, device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_nufft._launch("nufft2_3d", x, x.data_ptr(), F.data_ptr(), 0.5,
                           n, mtot, B, 0, *geo[1:], scratch.data_ptr(),
                           floats, out.data_ptr(), mtot=mtot,
                           symbol="gpq_nufft2_3d_tc_f32")
    torch.cuda.synchronize()
    assert not bool(out.abs().any())


@pytest.mark.cuda
@pytest.mark.parametrize("d,mtot,h,ell", [(1, 9, 0.31, 0.25),
                                          (2, 9, 0.31, 0.25),
                                          (3, 7, 0.35, 0.375)])
def test_high_tier_on_card(cuda_device, d, mtot, h, ell):
    """fit_high + predict_mean_high, gradient_high, variance_high and the
    exact variance of a float64 fit on the card, against the port's float64
    oracles on the plain path (``utils/f64_oracles.py``) at 1e-8 (mean
    relative to max|mean|, gradient and variance per entry); every NUFFT of
    the high tier is a float64 launch of a CUDA kernel (BACKEND_PICKS
    "matmul" 0)."""
    from gpquad_torch.utils import f64_oracles as orc
    rng = np.random.default_rng(d)
    n, sig = 2000, 0.05
    x = torch.as_tensor(rng.uniform(0, 1, (n, d)), dtype=torch.float32,
                        device=cuda_device)
    y = torch.as_tensor(rng.normal(size=n), dtype=torch.float32,
                        device=cuda_device)
    xq = torch.as_tensor(rng.uniform(0.1, 0.9, (60, d)), dtype=torch.float32,
                         device=cuda_device)
    Z = torch.as_tensor(rng.integers(0, 2, (4, n)) * 2.0 - 1,
                        device=cuda_device)
    V = torch.as_tensor(rng.integers(0, 2, (4, mtot ** d)) * 2.0 - 1,
                        device=cuda_device)
    kern = gpquad_torch.make_kernel("SE", d, lengthscale=ell, variance=1.25)
    for counter in (nufft_mod.BACKEND_PICKS, cuda_nufft.LAUNCH_PRECISIONS):
        for k in counter:
            counter[k] = 0
    hs = gpquad_torch.fit_high(x, y, kern, sig, h, mtot, device=cuda_device)
    mean = gpquad_torch.predict_mean_high(hs, xq)
    grad = gpquad_torch.gradient_high(x, y, kern, sig, h, mtot,
                                      probes=(Z, V), device=cuda_device).grad
    var = gpquad_torch.variance_high(x, kern, sig, h, mtot, xq,
                                     device=cuda_device)
    torch.cuda.synchronize()
    assert nufft_mod.BACKEND_PICKS["matmul"] == 0
    assert nufft_mod.BACKEND_PICKS["cuda"] > 0
    launched = {k: c for k, c in cuda_nufft.LAUNCH_PRECISIONS.items() if c}
    assert launched and all(p == "f64" for _, p, _ in launched)
    obj = orc.efgp_f64_objects_kernel(x, y, kern, sig, h, mtot)
    ref = orc.mean_f64(obj, xq)
    assert float((mean - ref).abs().max()) <= 1e-8 * float(ref.abs().max())
    g64 = orc.gradient_f64(obj, Z, V)
    assert float(((grad - g64).abs() / g64.abs()).max()) < 1e-8
    v64 = orc.regular_var_f64(obj, xq)
    assert float(((var - v64).abs() / v64).max()) < 1e-8
    st = gpquad_torch.fit_with_grid(x.double(), y.double(), kern, sig, h,
                                    mtot, cg_tol=1e-12, device=cuda_device)
    for method in ("regular", "chebyshev"):
        v = gpquad_torch.predict_var(st, xq, method=method,
                                     chebyshev_nodes=24, cg_tol=1e-12)
        assert float((v - v64).abs().max()) <= (
            1e-8 if method == "regular" else 1e-5) * float(v64.max())
