"""Port parity for the exact and the Chebyshev posterior variances:
``predict_var(method="regular" | "chebyshev")`` of gpquad_torch
(device="cpu") against gpquad's, on the same fit.

gpquad fits in float64; its state goes to the port through
``convert.fit_state_from_numpy``, so both sides evaluate the variance of the
same state (the dense tier's inverse, the CG tier's Jacobi scale, deflation
block or none).  Tolerances:
  - float64: 1e-10 of max|var| for "regular" and "chebyshev" (fixed node
    counts and automatic), on the dense tier and on the CG tier at cg_tol
    1e-13, where both sides solve the same systems to rounding; the
    automatic node counts are equal, and so is the fall-back to "regular";
  - float32 (each side its own float32 fit): 2e-4 of max|var| between the
    two packages, where each side's own float32 error against float64 is
    ~1e-5-1e-4 of max|var| (the variance is a small difference of O(1)
    sums; tests/test_torch_efgp.py's noise 0.5 keeps it above that floor).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.kernels import SquaredExponential as JaxSE
from gpquad.models import efgp as jefgp
from gpquad.models.pg_core import chebyshev_lobatto_nodes as jax_nodes
import gpquad_torch
from gpquad_torch import convert
from gpquad_torch.models import efgp as tefgp
from gpquad_torch.models.pg_core import chebyshev_lobatto_nodes

torch.set_num_threads(1)

SIGMASQ = 0.5
# d -> (points, lengthscale, eps, targets)
SIZES = {1: (300, 0.05, 1e-4, 120), 2: (600, 0.2, 1e-4, 60),
         3: (500, 0.35, 1e-3, 40)}
# (d, solver, precond, precond_rank)
CASES = [(1, "dense", "auto", 0), (2, "dense", "auto", 0),
         (3, "dense", "auto", 0), (1, "cg", "jacobi", 0),
         (2, "cg", "jacobi", 0), (2, "cg", "deflation", 64),
         (3, "cg", "deflation", 100)]
CG_TOL = 1e-13
# fixed Chebyshev node counts a dimension (d=3 solves 4^3 nodes)
CHEB_NODES = {1: 9, 2: 7, 3: 4}


def _data(d, seed=11):
    n, ell, eps, nq = SIZES[d]
    rng = np.random.default_rng(seed + d)
    x = rng.uniform(0, 1, (n, d))
    y = np.sin(2 * np.pi * x.sum(1)) + 0.3 * rng.normal(size=n)
    xq = rng.uniform(0.05, 0.95, (nq, d))
    return x, y, xq, ell, eps


def _state_arrays(js):
    keys = ("beta", "ws", "h", "sigmasq", "diag_scale", "A_dense", "P_dense",
            "defl_idx", "defl_P", "mean_cg_iters")
    arrays = {k: np.asarray(getattr(js, k)) for k in keys
              if getattr(js, k) is not None}
    arrays["fft_kernel"] = np.asarray(js.toeplitz.fft_kernel)
    return arrays


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: f"d{c[0]}-{c[1]}-{c[2]}")
def case(request):
    d, solver, precond, rank = request.param
    x, y, xq, ell, eps = _data(d)
    jk = JaxSE(lengthscale=jnp.float64(ell), variance=jnp.float64(1.0),
               dimension=d)
    js = jefgp.fit(jnp.asarray(x), jnp.asarray(y), jk, SIGMASQ, eps=eps,
                   cg_tol=CG_TOL, solver=solver, precond=precond,
                   precond_rank=rank)
    ts = convert.fit_state_from_numpy(_state_arrays(js), js.mtot, d,
                                      device="cpu")
    kw = dict(cg_tol=CG_TOL, max_cg_iter=2000)
    out = {}
    for tag, vkw in (("regular", dict(method="regular")),
                     ("cheb", dict(method="chebyshev",
                                   chebyshev_nodes=CHEB_NODES[d])),
                     ("auto", dict(method="chebyshev"))):
        jv = np.asarray(jefgp.predict_var(js, jnp.asarray(xq), **vkw, **kw))
        tv = gpquad_torch.predict_var(ts, xq, **vkw, **kw).numpy()
        out[tag] = (jv, tv)
    return dict(d=d, js=js, ts=ts, xq=xq, out=out, tier=(solver, precond))


def test_state_tier(case):
    st = case["ts"]
    solver, precond = case["tier"]
    assert (st.P_dense is not None) == (solver == "dense")
    assert (st.defl_P is not None) == (precond == "deflation")


@pytest.mark.parametrize("method", ["regular", "cheb", "auto"])
def test_float64_matches_gpquad(case, method):
    jv, tv = case["out"][method]
    assert tv.dtype == np.float64 and tv.shape == jv.shape
    assert np.all(tv >= 0.0)
    scale = np.max(np.abs(jv))
    assert np.max(np.abs(tv - jv)) <= 1e-10 * scale, (
        np.max(np.abs(tv - jv)) / scale)


def test_auto_nodes_and_fallback(case):
    """The automatic node counts equal gpquad's; where their grid is no
    smaller than the target set, "chebyshev" returns "regular" (bit for
    bit on the port's side), else it interpolates."""
    js, ts, xq = case["js"], case["ts"], case["xq"]
    auto_t = tefgp._auto_chebyshev_nodes(ts, torch.as_tensor(xq))
    auto_j = jefgp._auto_chebyshev_nodes(js, jnp.asarray(xq))
    assert auto_t == auto_j
    falls_back = int(np.prod(auto_t)) >= xq.shape[0]
    _, t_auto = case["out"]["auto"]
    _, t_reg = case["out"]["regular"]
    assert np.array_equal(t_auto, t_reg) == falls_back
    # each branch is met by some case (d=1 interpolates, d=2 and 3 fall
    # back at these target counts)
    assert falls_back == (case["d"] > 1)


def test_chebyshev_lobatto_nodes():
    for a, b, n in ((0.0, 1.0, 2), (-0.3, 2.5, 7), (0.1, 0.9, 69)):
        for got, ref in zip(chebyshev_lobatto_nodes(a, b, n),
                            jax_nodes(a, b, n)):
            np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        chebyshev_lobatto_nodes(0.0, 1.0, 1)


def test_bary_rows_one_hot_and_partition():
    nodes, weights = chebyshev_lobatto_nodes(0.0, 1.0, 9)
    t = torch.as_tensor(np.concatenate([nodes[:3], [0.123, 0.5, 0.77]]))
    rows = tefgp._bary_rows(torch.as_tensor(nodes), torch.as_tensor(weights),
                            t).numpy()
    ref = np.asarray(jefgp._bary_rows(jnp.asarray(nodes),
                                      jnp.asarray(weights),
                                      jnp.asarray(t.numpy())))
    np.testing.assert_allclose(rows, ref, rtol=0, atol=1e-14)
    np.testing.assert_array_equal(rows[:3], np.eye(9)[:3])
    np.testing.assert_allclose(rows.sum(1), 1.0, atol=1e-13)


def test_posterior_fourier_rows():
    rng = np.random.default_rng(5)
    for d in (1, 2, 3):
        x = rng.uniform(0, 1, (7, d))
        got = tefgp.posterior_fourier_rows(torch.as_tensor(x), 0.37, 9, d)
        ref = np.asarray(jefgp.posterior_fourier_rows(jnp.asarray(x), 0.37,
                                                      9, d))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-13)


@pytest.mark.parametrize("d,solver", [(2, "dense"), (2, "cg")])
def test_float32_against_gpquad_float32(d, solver):
    x, y, xq, ell, eps = _data(d)
    jk = JaxSE(lengthscale=jnp.float32(ell), variance=jnp.float32(1.0),
               dimension=d)
    js = jefgp.fit(jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
                   jk, SIGMASQ, eps=eps, cg_tol=1e-6, solver=solver)
    tk = gpquad_torch.make_kernel("SE", d, lengthscale=np.float32(ell),
                                  variance=np.float32(1.0))
    ts = gpquad_torch.fit(torch.as_tensor(x, dtype=torch.float32),
                          torch.as_tensor(y, dtype=torch.float32), tk,
                          SIGMASQ, eps=eps, cg_tol=1e-6, solver=solver,
                          device="cpu")
    xq32 = xq.astype(np.float32)
    for vkw in (dict(method="regular"),
                dict(method="chebyshev", chebyshev_nodes=[8, 6])):
        jv = np.asarray(jefgp.predict_var(js, jnp.asarray(xq32), cg_tol=1e-6,
                                          **vkw))
        tv = gpquad_torch.predict_var(ts, xq32, cg_tol=1e-6, **vkw).numpy()
        assert tv.dtype == np.float32
        scale = np.max(np.abs(jv))
        assert np.max(np.abs(tv - jv)) <= 2e-4 * scale, (
            vkw, np.max(np.abs(tv - jv)) / scale)


def test_unknown_method_raises():
    x, y, xq, ell, eps = _data(1)
    tk = gpquad_torch.make_kernel("SE", 1, lengthscale=ell, variance=1.0)
    st = gpquad_torch.fit(x, y, tk, SIGMASQ, eps=1e-2, device="cpu")
    with pytest.raises(ValueError):
        gpquad_torch.predict_var(st, xq, method="exact")
