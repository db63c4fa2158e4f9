"""The plain reference against a dense float64 GP and against the port's
CPU path run separately on the same inputs and probes."""
import math

import numpy as np
import pytest
import torch

from benchmark import data
from benchmark.reference import gp

L, VAR, S2 = 0.2, 1.0, 0.05
TIGHT = gp.Tolerances(mean=1e-12, mean_iters=3000, var=1e-12,
                      var_iters=3000, grad=1e-12)


def _inputs(n=400, d=2, targets=50, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(0, 1, (n, d)))
    y = torch.sin(3 * x[:, 0]) * torch.cos(2 * x[:, -1]) + 0.1 * torch.as_tensor(
        rng.normal(size=n))
    xq = torch.as_tensor(rng.uniform(0, 1, (targets, d)))
    return x, y, xq


def _dense(x, y, xq):
    """Dense GP: posterior mean and variance at xq and the gradient of the
    negative log marginal in (lengthscale, variance, sigmasq)."""
    def k(a, b):
        r2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return VAR * torch.exp(-0.5 * r2 / L ** 2), r2
    K0, r2 = k(x, x)
    K = K0 + S2 * torch.eye(x.shape[0], dtype=x.dtype)
    Ki = torch.linalg.inv(K)
    alpha = Ki @ y
    kq, _ = k(xq, x)
    mean = kq @ alpha
    var = VAR - ((kq @ Ki) * kq).sum(-1)
    dKs = [K0 * r2 / L ** 3, K0 / VAR, torch.eye(x.shape[0], dtype=x.dtype)]
    grad = torch.stack([0.5 * torch.trace(Ki @ dK) - 0.5 * alpha @ dK @ alpha
                        for dK in dKs])
    return mean, var, grad


@pytest.fixture(scope="module")
def model():
    x, y, xq = _inputs()
    h, mtot = gp.se_plan(L, VAR, 1e-10, 1.0, 2)
    return gp.make_model(x, y, h, mtot), x, y, xq


def test_plan_matches_the_port():
    import gpquad_torch
    for ell, eps, d, want in ((0.006, 1e-6, 2, 339), (0.1, 1e-6, 3, 31)):
        kern = gpquad_torch.make_kernel("SE", d, lengthscale=ell,
                                        variance=1.0)
        _, h, mtot = gpquad_torch.spectral_grid(kern, eps, 1.0)
        hr, mr = gp.se_plan(ell, 1.0, eps, 1.0, d)
        assert mr == mtot == want
        assert abs(hr - h) <= 1e-15 * h


def test_mean_and_variance_match_a_dense_gp(model):
    m, x, y, xq = model
    mean_d, var_d, _ = _dense(x, y, xq)
    fit = m.fit(L, VAR, S2, TIGHT)
    mean = m.predict_mean(fit, xq, L, VAR)["mid"]
    assert float((mean - mean_d).abs().max()) < 1e-7
    g = torch.Generator().manual_seed(3)
    etas = data.rademacher(g, 4000, m.mtot ** 2, torch.float64)
    var = m.variance(etas, xq, L, VAR, S2, TIGHT)["mid"]
    # the Hutchinson estimate's own spread at 4 000 probes
    assert float((var - var_d).abs().max()) < 0.1 * float(var_d.abs().max())


def test_gradient_matches_a_dense_gp(model):
    m, x, y, xq = model
    _, _, grad_d = _dense(x, y, xq)
    g = torch.Generator().manual_seed(4)
    Z = data.rademacher(g, 3000, x.shape[0], torch.float64)
    V = data.rademacher(g, 3000, m.mtot ** 2, torch.float64)
    grad = m.gradient(L, VAR, S2, Z, V, TIGHT)["mid"]
    assert float(((grad - grad_d).abs() / grad_d.abs()).max()) < 0.05


@pytest.mark.parametrize("d", [2, 3])
def test_matches_the_ports_cpu_path(d):
    """The port in float64 on the CPU, on the same probes and tolerances:
    the same algorithm, so the same numbers to rounding."""
    import gpquad_torch
    x, y, xq = _inputs(n=300, d=d, targets=40, seed=1)
    ell = 0.2 if d == 2 else 0.35
    kern = gpquad_torch.make_kernel("SE", d, lengthscale=ell, variance=VAR)
    _, h, mtot = gpquad_torch.spectral_grid(kern, 1e-6, 1.0)
    kw = dict(trace_samples=4, var_probes=16, cg_tol=1e-6, var_cg_tol=1e-4,
              grad_cg_tol=1e-4, max_cg_iter=1000, var_max_cg_iter=1000,
              solver="cg", precond="kron", device="cpu")
    res = gpquad_torch.fit_predict_grad(
        x, y, xq, kern, S2, h, torch.Generator().manual_seed(5), mtot=mtot,
        **kw)
    m = gp.make_model(x, y, h, mtot)
    tol = gp.Tolerances(mean=1e-6, mean_iters=1000, var=1e-4,
                        var_iters=1000, grad=1e-4)
    g = torch.Generator().manual_seed(5)
    M = mtot ** d
    etas = data.rademacher(g, 16, M, torch.float64)
    Z = data.rademacher(g, 4, x.shape[0], torch.float64)
    V = data.rademacher(g, 4, M, torch.float64)
    fit = m.fit(ell, VAR, S2, tol)
    mean = m.predict_mean(fit, xq, ell, VAR)["mid"]
    var = m.variance(etas, xq, ell, VAR, S2, tol)["mid"]
    grad = m.gradient(ell, VAR, S2, Z, V, tol, beta0=fit)["mid"]
    assert float((res.mean - mean).abs().max()) < 1e-9
    assert float((res.var - var).abs().max()) < 1e-9 * float(var.abs().max())
    assert float(((res.grad - grad).abs() / grad.abs()).max()) < 1e-8


def test_tf32_control_keeps_float32_types():
    x, y, xq = _inputs(n=200)
    h, mtot = gp.se_plan(L, VAR, 1e-6, 1.0, 2)
    m = gp.make_model(x, y, h, mtot, "tf32")
    assert m.Fy.dtype == torch.complex64 and m.gram.v.dtype == torch.complex64
    assert not math.isnan(float(m.predict_mean(
        m.fit(L, VAR, S2, TIGHT), xq, L, VAR)["mid"].abs().max()))
