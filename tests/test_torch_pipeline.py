"""Port parity for the fused pipeline ``fit_predict_grad``.

- The port's fused call equals the port's own stage calls with the probes
  drawn in the documented order (etas, Z, V) from the same generator seed;
  tolerances as tests/test_pipeline.py::test_fused_matches_components
  (mean and variance 1e-9 absolute, grad 1e-7 relative, beta 1e-9).
- The port's fused call equals gpquad's stage calls fed the same etas and
  probes, in float64: mean 1e-9 absolute, variance 1e-8 * max|var|, grad
  1e-8 relative per component (both sides solve the same systems to
  ~1e-12; on the CG tier every solve runs to 1e-12).
- float32 against float64 with the same generator seed (the same +-1
  probes): mean and variance 1e-4 * max|ref| (the slice's f32 bar,
  tests/test_torch_efgp.py), grad 1e-2 relative per component.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.kernels import SquaredExponential as JaxSE
from gpquad.models import efgp as jefgp
from gpquad.models.gradient import gradient_with_grid as jax_gradient_with_grid
from gpquad.quadrature import spectral_grid
import gpquad_torch
from gpquad_torch.models.efgp import _variance_stochastic

# The parity problems are small: torch's intra-op threads cost more than
# they give on them, most of all beside other test processes.
torch.set_num_threads(1)

N, NQ, SIGMASQ = 200, 40, 0.1


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 1, (N, 2))
    y = (np.sin(3 * np.pi * x[:, 0]) * np.cos(2 * np.pi * x[:, 1])
         + 0.1 * rng.normal(size=N))
    xq = rng.uniform(0.2, 0.8, (NQ, 2))
    return x, y, xq


def _grid(d=2, eps=1e-3):
    _, h, mtot = spectral_grid(JaxSE(lengthscale=0.3, variance=1.0,
                                     dimension=d), eps, 1.0)
    return float(h), int(mtot)


def _kernel(d=2):
    return gpquad_torch.make_kernel("SE", d, lengthscale=0.3, variance=1.0)


def test_fused_matches_components(data):
    x, y, xq = data
    h, mtot = _grid()
    kern = _kernel()
    out = gpquad_torch.fit_predict_grad(
        x, y, xq, kern, SIGMASQ, h, torch.Generator().manual_seed(0),
        mtot=mtot, trace_samples=4, var_probes=16, cg_tol=1e-10,
        var_cg_tol=1e-8, grad_cg_tol=1e-8, max_cg_iter=2000, device="cpu")

    state = gpquad_torch.fit_with_grid(x, y, kern, SIGMASQ, h, mtot,
                                       cg_tol=1e-10, max_cg_iter=2000,
                                       device="cpu")
    mean = gpquad_torch.predict_mean(state, xq)
    gen = torch.Generator().manual_seed(0)
    var = _variance_stochastic(state, torch.as_tensor(xq), gen, probes=16,
                               cg_tol=1e-8, max_cg_iter=2000)
    gres = gpquad_torch.gradient_with_grid(
        x, y, kern, SIGMASQ, h, gen, mtot=mtot, trace_samples=4,
        cg_tol=1e-8, max_cg_iter=2000, beta0=state.beta, device="cpu")

    np.testing.assert_allclose(out.mean.numpy(), mean.numpy(), atol=1e-9)
    np.testing.assert_allclose(out.var.numpy(), var.numpy(), atol=1e-9)
    np.testing.assert_allclose(out.grad.numpy(), gres.grad.numpy(),
                               rtol=1e-7)
    assert np.max(np.abs((out.beta - state.beta).numpy())) < 1e-9
    assert bool(out.mean_converged)


def test_fused_accepts_1d_targets():
    rng = np.random.default_rng(12)
    x = rng.uniform(0, 1, 100)
    y = np.sin(6 * x) + 0.1 * rng.normal(size=100)
    h, mtot = _grid(d=1)
    out = gpquad_torch.fit_predict_grad(
        x, y, np.linspace(0.2, 0.8, 16), _kernel(d=1), SIGMASQ, h,
        mtot=mtot, trace_samples=2, var_probes=8, device="cpu")
    assert out.mean.shape == (16,) and out.var.shape == (16,)
    assert np.all(np.isfinite(out.mean.numpy()))
    assert out.grad.shape == (3,)


@pytest.mark.parametrize("solver,tol", [("dense", 1e-10), ("cg", 1e-12)])
def test_fused_matches_jax_stages(data, solver, tol):
    """The port's fused call against gpquad's stage calls fed the probes the
    port draws: etas (16, M), then Z (4, n), then V (4, M)."""
    x, y, xq = data
    h, mtot = _grid()
    M = mtot ** 2
    out = gpquad_torch.fit_predict_grad(
        x, y, xq, _kernel(), SIGMASQ, h, torch.Generator().manual_seed(5),
        mtot=mtot, trace_samples=4, var_probes=16, cg_tol=tol,
        var_cg_tol=tol, grad_cg_tol=tol, max_cg_iter=2000, solver=solver,
        device="cpu")

    g = torch.Generator().manual_seed(5)
    etas, Z, V = ((torch.randint(0, 2, shape, generator=g) * 2 - 1).numpy()
                  .astype(np.float64) for shape in ((16, M), (4, N), (4, M)))
    jk = JaxSE(lengthscale=0.3, variance=1.0, dimension=2)
    xj, yj, xqj = jnp.asarray(x), jnp.asarray(y), jnp.asarray(xq)
    js = jefgp.fit_with_grid(xj, yj, jk, SIGMASQ, h, mtot, cg_tol=tol,
                             max_cg_iter=2000, solver=solver)
    jmean = np.asarray(jefgp.predict_mean(js, xqj))
    jvar = np.asarray(jefgp._variance_stochastic(
        js, xqj, None, probes=16, cg_tol=tol, max_cg_iter=2000,
        etas=jnp.asarray(etas)))
    jg = jax_gradient_with_grid(xj, yj, jk, SIGMASQ, h, jax.random.PRNGKey(0),
                                mtot=mtot, trace_samples=4, cg_tol=tol,
                                max_cg_iter=2000, beta0=js.beta,
                                solver=solver,
                                probes=(jnp.asarray(Z), jnp.asarray(V)))
    assert np.max(np.abs(out.mean.numpy() - jmean)) < 1e-9
    assert np.max(np.abs(out.var.numpy() - jvar)) < 1e-8 * np.max(
        np.abs(jvar))
    rel = np.abs(out.grad.numpy() - np.asarray(jg.grad)) / np.abs(
        np.asarray(jg.grad))
    assert np.all(rel < 1e-8), rel


@pytest.mark.parametrize("solver,tol", [("dense", 1e-10), ("cg", 1e-12)])
def test_fused_matches_jax_stages_3d(solver, tol):
    """The fused call at d=3 (mtot 9, M 729) against gpquad's stage calls
    fed the probes the port draws, as test_fused_matches_jax_stages."""
    rng = np.random.default_rng(13)
    n = 150
    x = rng.uniform(0, 1, (n, 3))
    y = (np.sin(3 * np.pi * x[:, 0]) * np.cos(2 * np.pi * x[:, 1])
         * np.cos(np.pi * x[:, 2]) + 0.1 * rng.normal(size=n))
    xq = rng.uniform(0.2, 0.8, (NQ, 3))
    jk = JaxSE(lengthscale=0.4, variance=1.0, dimension=3)
    _, h, mtot = spectral_grid(jk, 1e-3, 1.0)
    h, mtot = float(h), int(mtot)
    M = mtot ** 3
    out = gpquad_torch.fit_predict_grad(
        x, y, xq, gpquad_torch.make_kernel("SE", 3, lengthscale=0.4,
                                           variance=1.0),
        SIGMASQ, h, torch.Generator().manual_seed(5),
        mtot=mtot, trace_samples=3, var_probes=8, cg_tol=tol,
        var_cg_tol=tol, grad_cg_tol=tol, max_cg_iter=3000, solver=solver,
        device="cpu")
    g = torch.Generator().manual_seed(5)
    etas, Z, V = ((torch.randint(0, 2, shape, generator=g) * 2 - 1).numpy()
                  .astype(np.float64) for shape in ((8, M), (3, n), (3, M)))
    xj, yj, xqj = jnp.asarray(x), jnp.asarray(y), jnp.asarray(xq)
    js = jefgp.fit_with_grid(xj, yj, jk, SIGMASQ, h, mtot, cg_tol=tol,
                             max_cg_iter=3000, solver=solver)
    jmean = np.asarray(jefgp.predict_mean(js, xqj))
    jvar = np.asarray(jefgp._variance_stochastic(
        js, xqj, None, probes=8, cg_tol=tol, max_cg_iter=3000,
        etas=jnp.asarray(etas)))
    jg = jax_gradient_with_grid(xj, yj, jk, SIGMASQ, h, jax.random.PRNGKey(0),
                                mtot=mtot, trace_samples=3, cg_tol=tol,
                                max_cg_iter=3000, beta0=js.beta,
                                solver=solver,
                                probes=(jnp.asarray(Z), jnp.asarray(V)))
    assert out.mean.shape == (NQ,) and out.grad.shape == (3,)
    assert np.max(np.abs(out.mean.numpy() - jmean)) < 1e-9
    assert np.max(np.abs(out.var.numpy() - jvar)) < 1e-8 * np.max(
        np.abs(jvar))
    rel = np.abs(out.grad.numpy() - np.asarray(jg.grad)) / np.abs(
        np.asarray(jg.grad))
    assert np.all(rel < 1e-8), rel


def test_float32_run_uses_float32(data):
    """Same generator seed, float32 against float64: the f32 run stays in
    float32/complex64 (the hypers are cast, gradient.py:115-118)."""
    x, y, xq = data
    h, mtot = _grid()
    out = {}
    for dtype in (np.float32, np.float64):
        out[dtype] = gpquad_torch.fit_predict_grad(
            x.astype(dtype), y.astype(dtype), xq.astype(dtype), _kernel(),
            SIGMASQ, h, torch.Generator().manual_seed(1), mtot=mtot,
            trace_samples=4, var_probes=16, device="cpu")
    r32, r64 = out[np.float32], out[np.float64]
    assert r32.grad.dtype == r32.mean.dtype == torch.float32
    assert r32.beta.dtype == torch.complex64
    for field in ("mean", "var"):
        a = getattr(r32, field).double().numpy()
        b = getattr(r64, field).numpy()
        assert np.max(np.abs(a - b)) < 1e-4 * np.max(np.abs(b)), field
    rel = np.abs(r32.grad.double().numpy() - r64.grad.numpy()) / np.abs(
        r64.grad.numpy())
    assert np.all(rel < 1e-2), rel


def test_precond_quirks(data):
    """gpquad's pipeline.py:93 resolves the preconditioner without n and M
    (ROADMAP §C), mirrored: 'adaptive' always resolves to kron and runs as
    'kron' does, equal to gpquad's kron stages fed the same etas and
    probes; 'none' and
    'deflation' still run Jacobi, as gpquad's else-branch does."""
    x, y, xq = data
    h, mtot = _grid()
    M = mtot ** 2
    kw = dict(mtot=mtot, trace_samples=2, var_probes=8, solver="cg",
              device="cpu")
    tol = dict(cg_tol=1e-12, var_cg_tol=1e-12, grad_cg_tol=1e-12,
               max_cg_iter=2000)
    runs = {p: gpquad_torch.fit_predict_grad(
        x, y, xq, _kernel(), SIGMASQ, h, torch.Generator().manual_seed(5),
        precond=p, **tol, **kw) for p in ("kron", "adaptive")}
    for field in ("mean", "var", "grad", "beta"):
        np.testing.assert_array_equal(getattr(runs["adaptive"], field),
                                      getattr(runs["kron"], field))
    g = torch.Generator().manual_seed(5)
    etas, Z, V = ((torch.randint(0, 2, shape, generator=g) * 2 - 1).numpy()
                  .astype(np.float64) for shape in ((8, M), (2, N), (2, M)))
    jk = JaxSE(lengthscale=0.3, variance=1.0, dimension=2)
    xj, yj, xqj = jnp.asarray(x), jnp.asarray(y), jnp.asarray(xq)
    js = jefgp.fit_with_grid(xj, yj, jk, SIGMASQ, h, mtot, cg_tol=1e-12,
                             max_cg_iter=2000, solver="cg", precond="kron")
    jvar = np.asarray(jefgp._variance_stochastic(
        js, xqj, None, probes=8, cg_tol=1e-12, max_cg_iter=2000,
        etas=jnp.asarray(etas)))
    jg = jax_gradient_with_grid(xj, yj, jk, SIGMASQ, h, jax.random.PRNGKey(0),
                                mtot=mtot, trace_samples=2, cg_tol=1e-12,
                                max_cg_iter=2000, beta0=js.beta, state=js,
                                probes=(jnp.asarray(Z), jnp.asarray(V)))
    out = runs["kron"]
    assert np.max(np.abs(out.mean.numpy()
                         - np.asarray(jefgp.predict_mean(js, xqj)))) < 1e-9
    assert np.max(np.abs(out.var.numpy() - jvar)) < 1e-8 * np.max(
        np.abs(jvar))
    rel = np.abs(out.grad.numpy() - np.asarray(jg.grad)) / np.abs(
        np.asarray(jg.grad))
    assert np.all(rel < 1e-8), rel
    b = gpquad_torch.fit_predict_grad(x, y, xq, _kernel(), SIGMASQ, h,
                                      precond="auto", **kw)
    for precond in ("none", "deflation"):
        a = gpquad_torch.fit_predict_grad(x, y, xq, _kernel(), SIGMASQ, h,
                                          precond=precond, **kw)
        np.testing.assert_array_equal(a.mean.numpy(), b.mean.numpy())
        np.testing.assert_array_equal(a.grad.numpy(), b.grad.numpy())
        assert int(a.mean_cg_iters) == int(b.mean_cg_iters)


def test_entry_point_fails_without_card(data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x, y, xq = data
    h, mtot = _grid()
    with pytest.raises(RuntimeError, match="cuda"):
        gpquad_torch.fit_predict_grad(x, y, xq, _kernel(), SIGMASQ, h,
                                      mtot=mtot)
    with pytest.raises(RuntimeError, match="cuda"):
        gpquad_torch.gradient(x, y, _kernel(), SIGMASQ, 1e-3)
