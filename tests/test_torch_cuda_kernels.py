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
    assert nufft_mod.BACKEND_PICKS == {"cuda": 1, "matmul": 0}


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
