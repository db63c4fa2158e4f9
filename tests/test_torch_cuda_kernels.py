"""The d=1, d=2 and d=3 CUDA NUFFT kernels on the card, against their
float64 plain versions on the same inputs.

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
