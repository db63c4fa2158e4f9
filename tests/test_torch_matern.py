"""Port parity for the Matérn kernel and its Bessel K: gpquad_torch's
``kernels/bessel.py``, ``kernels/matern.py``, the Matérn branch of the grid
planner and the ``EFGP`` facade with "Matern32", against gpquad in float64
on the CPU.

Tolerances:
  - log K_nu 1e-12 absolute against gpquad (the same integral rules) and
    1e-12 relative to max(1, |log K|) against scipy's ``kve`` on both
    branches (x < 10 cosh trapezoid, x >= 10 generalized Gauss-Laguerre);
  - kernel values, spectral density and gradient 1e-13 relative (closed
    forms; the general-nu kernel through log K at 1e-12);
  - (h, mtot) identical, integral and heuristic, eps 1e-2 ... 1e-8;
  - two Adam steps of the facade with the rung pinned and the same probes
    1e-8 relative per entry (tests/test_torch_model.py's bar).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import kve

from gpquad.kernels import Matern as JaxMatern
from gpquad.kernels import bessel as jbessel
from gpquad.models.model import EFGP as JaxEFGP
from gpquad.quadrature import grid_geometry as jax_geometry
from gpquad.quadrature import spectral_grid as jax_grid
import gpquad_torch
from gpquad_torch import EFGP, convert
from gpquad_torch import quadrature as tquad
from gpquad_torch.kernels import Matern, bessel

from .test_efgp import make_data

torch.set_num_threads(1)

NUS = (0.5, 1.5, 2.5, 0.8)
EPSES = (1e-2, 1e-3, 1e-4, 1e-6, 1e-8)
X_BOTH = np.concatenate([np.logspace(-8, np.log10(9.99), 40),
                         np.logspace(1.0, 4.0, 40)])


@pytest.mark.parametrize("nu", (0.5, 0.8, 1.5, 2.5, 7.3))
def test_log_bessel_k(nu):
    got = bessel.log_bessel_k(nu, torch.as_tensor(X_BOTH)).numpy()
    ref = np.log(kve(nu, X_BOTH)) - X_BOTH
    jref = np.asarray(jbessel.log_bessel_k(nu, jnp.asarray(X_BOTH)))
    np.testing.assert_allclose(got, jref, rtol=0, atol=1e-12)
    for branch in (X_BOTH < 10, X_BOTH >= 10):
        assert np.max(np.abs(got - ref)[branch]
                      / np.maximum(1.0, np.abs(ref[branch]))) < 1e-12
    small = X_BOTH[X_BOTH < 30]
    np.testing.assert_allclose(
        bessel.bessel_k(nu, torch.as_tensor(small)).numpy(),
        kve(nu, small) * np.exp(-small), rtol=1e-11)
    xs = np.concatenate([[0.0, 1e-13], X_BOTH])
    np.testing.assert_allclose(
        bessel.log_matern_profile(nu, torch.as_tensor(xs)).numpy(),
        np.asarray(jbessel.log_matern_profile(nu, jnp.asarray(xs))),
        rtol=0, atol=1e-11)


def _pair_kernels(nu, d, ell=0.37, var=1.7):
    return (JaxMatern(lengthscale=jnp.float64(ell), variance=jnp.float64(var),
                      dimension=d, nu=nu),
            Matern(dimension=d, nu=nu, lengthscale=ell, variance=var))


@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("d", [1, 2, 3])
def test_matern_matches(nu, d):
    jk, tk = _pair_kernels(nu, d)
    r = np.concatenate([[0.0], np.linspace(1e-4, 4.0, 60)])
    tol = 1e-13 if nu in (0.5, 1.5, 2.5) else 1e-11
    np.testing.assert_allclose(tk.kernel(torch.as_tensor(r)).numpy(),
                               np.asarray(jk.kernel(jnp.asarray(r))),
                               rtol=tol, atol=0)
    xi = np.random.default_rng(d).normal(size=(50, d)) * 3.0
    np.testing.assert_allclose(
        tk.spectral_density(torch.as_tensor(xi)).numpy(),
        np.asarray(jk.spectral_density(jnp.asarray(xi))), rtol=1e-13)
    np.testing.assert_allclose(
        tk.spectral_grad(torch.as_tensor(xi)).numpy(),
        np.asarray(jk.spectral_grad(jnp.asarray(xi))), rtol=1e-13)
    np.testing.assert_array_equal(tk.hyper_vector().numpy(),
                                  np.asarray(jk.hyper_vector()))
    # the closed-form gradient against autograd of the density
    hv = tk.hyper_vector().clone().requires_grad_(True)
    auto = torch.autograd.functional.jacobian(
        lambda v: tk.with_hypers(v).spectral_density(torch.as_tensor(xi)),
        hv)
    np.testing.assert_allclose(tk.spectral_grad(torch.as_tensor(xi)).numpy(),
                               auto.numpy(), rtol=1e-12)
    moved = tk.with_hypers(torch.tensor([0.2, 3.0]))
    assert moved.nu == nu and moved.dimension == d
    assert tk.set_hyper("variance", 2.0).nu == nu


def test_matern_rejects_nonpositive_nu():
    with pytest.raises(ValueError):
        Matern(nu=0.0)
    k = convert.kernel_from_numpy("Matern", [0.3, 1.1], 2, nu=0.8)
    assert k.nu == 0.8 and float(k.lengthscale) == 0.3
    assert convert.kernel_from_numpy("Matern52", [0.3, 1.1], 2).nu == 2.5


@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("use_integral", [True, False])
def test_grid_plan_matches(nu, use_integral):
    """``(h, mtot)`` of spectral_grid and ``(h, hm_real)`` of grid_geometry
    equal gpquad's at d = 2, lengthscale 0.14 (bench.py's Matérn row) over
    eps 1e-2 ... 1e-8, and at a second L (with ``trunc_eps`` on the
    integral path)."""
    jk, tk = _pair_kernels(nu, 2, ell=0.14, var=1.0)
    for eps in EPSES:
        _, th, tm = gpquad_torch.spectral_grid(tk, eps, 1.0,
                                               use_integral=use_integral)
        _, jh, jm = jax_grid(jk, eps, 1.0, use_integral=use_integral)
        assert tm == jm, (eps, tm, jm)
        np.testing.assert_allclose(th, jh, rtol=1e-15)
    kw = dict(trunc_eps=1e-7) if use_integral else {}
    got = tquad.grid_geometry(tk, 1e-4, 1.3, use_integral=use_integral, **kw)
    want = jax_geometry(jk, 1e-4, 1.3, use_integral=use_integral, **kw)
    np.testing.assert_allclose([float(g) for g in got],
                               [float(w) for w in want], rtol=1e-14)
    if nu == 1.5 and use_integral:
        # bench.py:645: Matérn-3/2, l 0.14, eps 1e-4 plans mtot 93
        assert gpquad_torch.spectral_grid(tk, 1e-4, 1.0)[2] == 93


def test_facade_matern_adam_matches(rng):
    """EFGP(x, y, "Matern32"): the grid plan, then two Adam steps with the
    rung pinned and the same probes, against gpquad's facade."""
    n = 150
    x, y = make_data(rng, n=n, d=2, lengthscale=0.25, variance=1.0)
    hypers = [0.3, 0.8, 0.3]
    jm = JaxEFGP(jnp.asarray(x), jnp.asarray(y), "Matern32",
                 sigmasq=hypers[2], eps=1e-3, estimate_params=False)
    jm.params = jm.params.replace_raw(jnp.log(jnp.asarray(hypers)))
    tm = EFGP(x, y, "Matern32", sigmasq=hypers[2], eps=1e-3,
              estimate_params=False, device="cpu")
    tm.params = tm.params.replace_raw(torch.log(torch.as_tensor(
        hypers, dtype=torch.float64)))
    assert tm.kernel.nu == 1.5
    assert tm._grid_plan(False) == jm._grid_plan(False)
    rung = tquad.bucket_mtot(tm._grid_plan(False)[1] + 6)
    jm._mtot_floor = tm._mtot_floor = rung
    T = 3
    Z = rng.integers(0, 2, (T, n)) * 2.0 - 1
    V = rng.integers(0, 2, (T, rung ** 2)) * 2.0 - 1
    kw = dict(max_iters=2, lr=0.1, trace_samples=T, cg_tol=1e-10,
              min_lengthscale=1e-3)
    jm.optimize_hyperparameters(probes=(jnp.asarray(Z), jnp.asarray(V)),
                                key=jax.random.PRNGKey(0), **kw)
    tm.optimize_hyperparameters(probes=(torch.as_tensor(Z),
                                        torch.as_tensor(V)), **kw)
    jh, th = jm.training_log, tm.training_log
    for key in ("lengthscale", "variance", "sigmasq"):
        got, want = np.asarray(th[key]), np.asarray(jh[key])
        assert len(got) == 2
        assert np.max(np.abs(got - want) / np.abs(want)) < 1e-8, key
    got, want = np.array(th["gradients"]), np.array(jh["gradients"])
    assert np.max(np.abs(got - want) / np.abs(want)) < 1e-8
    xq = rng.uniform(0, 1, (20, 2))
    jmean, _ = jm.predict(jnp.asarray(xq), return_variance=False)
    tmean, _ = tm.predict(xq, return_variance=False)
    assert np.max(np.abs(tmean.numpy() - np.asarray(jmean))) < 1e-8
