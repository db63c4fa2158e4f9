"""Port parity for the Kronecker eigen-preconditioner
(gpquad_torch.ops.kron_precond vs gpquad.ops.kron_precond) and for the kron
fit, variance, gradient and fused pass, all in float64.

Tolerances: the separable factors, the centro-unitary and the marginal
Toeplitz matrices are the same arithmetic (1e-12 relative, or exact);
``denom`` (eigenvalues) 1e-10 relative.  The eigenvectors themselves are
not compared: they differ by sign, and by a rotation inside degenerate
eigenspaces, between two eigensolvers; the apply ``M_inv(r)`` does not, and
is held at 1e-10.  The kron fit's beta 1e-10 absolute at cg_tol 1e-12, with
iteration counts of the same order (two float64 PCGs stop a few iterations
apart, ROADMAP §C); the variance 1e-8 * max|var| and the gradient 1e-8
relative with the same probes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.kernels import SquaredExponential as JaxSE
from gpquad.models import efgp as jefgp
from gpquad.models.gradient import gradient_with_grid as jax_gradient_with_grid
from gpquad.ops import kron_precond as jkp
from gpquad.ops.operators import convolution_vector as jax_conv
from gpquad.quadrature import spectral_grid
import gpquad_torch
from gpquad_torch import convert
from gpquad_torch.ops import kron_precond as tkp

# The parity problems are small: torch's intra-op threads cost more than
# they give on them, most of all beside other test processes.
torch.set_num_threads(1)

SIGMASQ = 0.05
# (n, lengthscale, eps) per dimension: grids of mtot 15-21, 9-13 and 7-9
_CASES = {1: (300, 0.1, 1e-4), 2: (400, 0.2, 1e-3), 3: (300, 0.35, 1e-3)}


def _problem(d, seed=0):
    """Points, y, (h, mtot), JAX's weights and lag table, as numpy."""
    n, ell, eps = _CASES[d]
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, d))
    y = np.sin(5 * x[:, 0]) + 0.1 * rng.normal(size=n)
    jk = JaxSE(lengthscale=ell, variance=1.0, dimension=d)
    _, h, mtot = spectral_grid(jk, eps, 1.0)
    h, mtot = float(h), int(mtot)
    m = (mtot - 1) // 2
    xis = jefgp.tensor_grid(jnp.arange(-m, m + 1) * h, d)
    ws = np.asarray(jefgp.quadrature_weights(jk, xis, jnp.asarray(h), d))
    v = np.asarray(jax_conv(m, jnp.asarray(x), h))
    return x, y, h, mtot, ws, v, jk


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("d", [1, 2, 3])
def test_separable_factors_match(d):
    _, _, _, mtot, ws, _, _ = _problem(d)
    rng = np.random.default_rng(1)
    # the SE weights are separable; a random positive grid is not, and runs
    # the alternating sweeps for real
    for W in (np.abs(ws).reshape((mtot,) * d),
              rng.uniform(0.1, 1.0, (mtot,) * d)):
        want = jkp._separable_factors(jnp.asarray(W), d)
        got = tkp._separable_factors(torch.as_tensor(W), d)
        assert len(got) == len(want) == d
        for g, w in zip(got, want):
            assert _rel(g.numpy(), np.asarray(w)) < 1e-12


@pytest.mark.parametrize("m", [1, 7, 21])
def test_centro_unitary_matches(m):
    want = np.asarray(jkp._centro_unitary(m, jnp.complex128))
    got = tkp._centro_unitary(m, torch.complex128).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got.conj().T @ got, np.eye(m), atol=1e-15)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_marginal_toeplitz_and_denom_match(d):
    _, _, _, mtot, ws, v, _ = _problem(d)
    for axis in range(d):
        np.testing.assert_array_equal(
            tkp._marginal_toeplitz(torch.as_tensor(v), axis, mtot, d).numpy(),
            np.asarray(jkp._marginal_toeplitz(jnp.asarray(v), axis, mtot,
                                              d)))
    n = float(np.real(v[((2 * mtot - 2) // 2,) * d]))
    jk = jkp.kron_eig_build(jnp.asarray(ws), jnp.asarray(v), SIGMASQ,
                            mtot=mtot, d=d, diag_scale=n)
    tk = tkp.kron_eig_build(torch.as_tensor(ws), torch.as_tensor(v), SIGMASQ,
                            mtot=mtot, d=d, diag_scale=n)
    assert tk.denom.shape == (mtot,) * d and tk.denom.dtype == torch.float64
    assert _rel(tk.denom.numpy(), np.asarray(jk.denom)) < 1e-10
    # the apply, not the eigenvectors (sign and degenerate-space rotations)
    rng = np.random.default_rng(2)
    r = rng.normal(size=(3, mtot ** d)) + 1j * rng.normal(size=(3, mtot ** d))
    want = np.asarray(jkp.make_kron_precond(jk)(jnp.asarray(r)))
    got = tkp.make_kron_precond(tk)(torch.as_tensor(r)).numpy()
    assert got.shape == r.shape
    assert _rel(got, want) < 1e-10
    single = tkp.make_kron_precond(tk)(torch.as_tensor(r[0])).numpy()
    assert _rel(single, want[0]) < 1e-10


@pytest.mark.parametrize("d", [1, 2, 3])
def test_kron_fit_matches(d):
    x, y, h, mtot, _, _, jk = _problem(d)
    tk = gpquad_torch.make_kernel("SE", d, lengthscale=_CASES[d][1],
                                  variance=1.0)
    kw = dict(cg_tol=1e-12, max_cg_iter=3000, solver="cg", precond="kron")
    js = jefgp.fit_with_grid(jnp.asarray(x), jnp.asarray(y), jk, SIGMASQ, h,
                             mtot, **kw)
    ts = gpquad_torch.fit_with_grid(x, y, tk, SIGMASQ, h, mtot,
                                    device="cpu", **kw)
    assert ts.kron is not None
    assert np.max(np.abs(ts.beta.numpy() - np.asarray(js.beta))) < 1e-10
    it_t, it_j = int(ts.mean_cg_iters), int(js.mean_cg_iters)
    assert it_t < 3000 and abs(it_t - it_j) <= max(3, it_j // 4), (it_t,
                                                                   it_j)


def _jax_state_arrays(js):
    arrays = {k: np.asarray(getattr(js, k)) for k in
              ("beta", "ws", "h", "sigmasq", "diag_scale", "mean_cg_iters")}
    arrays["fft_kernel"] = np.asarray(js.toeplitz.fft_kernel)
    arrays["kron_Us"] = [np.asarray(U) for U in js.kron.Us]
    arrays["kron_denom"] = np.asarray(js.kron.denom)
    return arrays


@pytest.mark.parametrize("d", [2, 3])
def test_kron_variance_and_gradient_match(d):
    """The variance on a kron fit's state, the gradient building kron itself
    (``precond="kron"``) and on a JAX kron state carried over by
    convert.py, against gpquad with the same etas and probes."""
    x, y, h, mtot, _, _, jk = _problem(d)
    M = mtot ** d
    tk = gpquad_torch.make_kernel("SE", d, lengthscale=_CASES[d][1],
                                  variance=1.0)
    kw = dict(cg_tol=1e-12, max_cg_iter=3000, solver="cg", precond="kron")
    js = jefgp.fit_with_grid(jnp.asarray(x), jnp.asarray(y), jk, SIGMASQ, h,
                             mtot, **kw)
    ts = gpquad_torch.fit_with_grid(x, y, tk, SIGMASQ, h, mtot,
                                    device="cpu", **kw)
    rng = np.random.default_rng(3)
    xq = rng.uniform(0.1, 0.9, (30, d))
    etas = rng.choice([-1.0, 1.0], size=(8, M))
    vkw = dict(probes=8, cg_tol=1e-12, max_cg_iter=3000)
    jvar = np.asarray(jefgp.predict_var(js, jnp.asarray(xq),
                                        etas=jnp.asarray(etas), **vkw))
    tvar = gpquad_torch.predict_var(ts, xq, etas=etas, **vkw).numpy()
    assert np.max(np.abs(tvar - jvar)) < 1e-8 * np.max(np.abs(jvar))

    Z = rng.integers(0, 2, (2, len(y))) * 2 - 1.0
    V = rng.integers(0, 2, (2, M)) * 2 - 1.0
    carried = convert.fit_state_from_numpy(_jax_state_arrays(js), mtot, d,
                                           device="cpu")
    assert len(carried.kron.Us) == d
    for jax_kw, port_kw in ((dict(precond="kron", solver="cg"),
                             dict(precond="kron", solver="cg")),
                            (dict(state=js), dict(state=carried))):
        jg = jax_gradient_with_grid(
            jnp.asarray(x), jnp.asarray(y), jk, SIGMASQ, h,
            jax.random.PRNGKey(0), mtot=mtot, trace_samples=2, cg_tol=1e-12,
            max_cg_iter=3000, probes=(jnp.asarray(Z), jnp.asarray(V)),
            **jax_kw)
        tg = gpquad_torch.gradient_with_grid(
            x, y, tk, SIGMASQ, h, mtot=mtot, trace_samples=2, cg_tol=1e-12,
            max_cg_iter=3000, probes=(torch.as_tensor(Z), torch.as_tensor(V)),
            device="cpu", **port_kw)
        rel = np.abs(tg.grad.numpy() - np.asarray(jg.grad)) / np.abs(
            np.asarray(jg.grad))
        assert np.all(rel < 1e-8), rel


def test_kron_state_round_trip():
    """A port kron state goes to numpy and back unchanged (``kron_Us``
    stacked, ``kron_denom``)."""
    x, y, h, mtot, _, _, _ = _problem(2)
    tk = gpquad_torch.make_kernel("SE", 2, lengthscale=_CASES[2][1],
                                  variance=1.0)
    ts = gpquad_torch.fit_with_grid(x, y, tk, SIGMASQ, h, mtot, solver="cg",
                                    precond="kron", device="cpu")
    arrays = convert.fit_state_to_numpy(ts)
    assert arrays["kron_Us"].shape == (2, mtot, mtot)
    back = convert.fit_state_from_numpy(arrays, mtot, 2, device="cpu")
    for a, b in zip(back.kron.Us, ts.kron.Us):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(back.kron.denom.numpy(),
                                  ts.kron.denom.numpy())
