"""Port parity for the Polya-Gamma float64 leg: ``gpquad_torch``'s
``pg_predict_high`` / ``pg_beta_mean_high`` and its PG float64 oracles
against ``gpquad``'s (JAX on the CPU with x64, the port with
``device="cpu"``) on the same seeded numpy inputs.

Tolerances: the port's float64 leg against gpquad's numpy float64 dense
oracle to 1e-9 relative (float64 words where gpquad has double words: it
reaches the float64 floor, ~1e-14 here); against gpquad's double-word
result at gpquad's own bar, 1e-6; the port's oracles against gpquad's to
1e-11 (another route to the same dense system: the lag table's Toeplitz
gather instead of the dense design matrix).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.kernels import Matern as JaxMatern
from gpquad.kernels import SquaredExponential as JaxSE
from gpquad.models import pg_high as jhigh
from gpquad.quadrature import spectral_grid
from gpquad.utils import f64_oracles as jorc
import gpquad_torch
from gpquad_torch.models import pg_high as thigh
from gpquad_torch.utils import f64_oracles as torc

torch.set_num_threads(1)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _problem(seed, n=400, d=2, ell=0.25, var=2.0, eps=1e-4, matern=False):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, size=(n, d)).astype(np.float32)
    if matern:
        kj = JaxMatern(lengthscale=jnp.float32(ell), variance=jnp.float32(var),
                       nu=1.5, dimension=d)
        kt = gpquad_torch.make_kernel("Matern32", d,
                                      lengthscale=np.float32(ell),
                                      variance=np.float32(var))
    else:
        kj = JaxSE(lengthscale=jnp.float32(ell), variance=jnp.float32(var),
                   dimension=d)
        kt = gpquad_torch.make_kernel("SE", d, lengthscale=np.float32(ell),
                                      variance=np.float32(var))
    _, h, mtot = spectral_grid(kj, eps, 1.0)
    delta = (0.1 + 0.15 * rng.uniform(size=n)).astype(np.float32)
    kappa = (rng.integers(0, 2, n) - 0.5).astype(np.float32)
    xt = rng.uniform(0.1, 0.9, size=(48, d)).astype(np.float32)
    return dict(x=x, kj=kj, kt=kt, h=float(h), mtot=int(mtot), delta=delta,
                kappa=kappa, xt=xt)


def _oracle(p, hm=None, mtot=None):
    mtot = p["mtot"] if mtot is None else mtot
    obj = jorc.pg_f64_objects(p["x"], p["delta"], p["kj"], p["h"], mtot,
                              hm=hm)
    beta = jorc.pg_beta_mean_f64(obj, p["kappa"])
    return (beta, jorc.pg_mean_f64(obj, p["xt"], beta),
            jorc.pg_var_f64(obj, p["xt"]))


@pytest.fixture(scope="module")
def se():
    p = _problem(0)
    p["oracle"] = _oracle(p)
    p["gpquad"] = jhigh.pg_predict_high(p["x"], p["kj"], p["h"], p["mtot"],
                                        p["delta"], p["kappa"], p["xt"])
    return p


def _port(p, **kw):
    return gpquad_torch.pg_predict_high(
        p["x"], p["kt"], p["h"], kw.pop("mtot", p["mtot"]), p["delta"],
        p["kappa"], p["xt"], device="cpu", **kw)


def test_pg_high_matches_gpquad_oracle_and_leg(se):
    res = _port(se)
    beta64, mean64, var64 = se["oracle"]
    assert res.beta.dtype == torch.complex128
    assert res.mean.dtype == res.var.dtype == torch.float64
    assert (np.linalg.norm(res.beta.numpy() - beta64)
            / np.linalg.norm(beta64)) < 1e-9
    assert _rel(res.mean.numpy(), mean64) < 1e-9
    assert _rel(res.var.numpy(), var64) < 1e-9
    assert np.max(np.abs(res.var.numpy() - var64) / var64) < 1e-9
    # gpquad's double words, at gpquad's own bar
    g = se["gpquad"]
    beta_df = (np.asarray(g.beta, np.complex128)
               + np.asarray(g.beta_lo, np.complex128))
    assert (np.linalg.norm(res.beta.numpy() - beta_df)
            / np.linalg.norm(beta_df)) < 1e-6
    assert _rel(res.mean.numpy(), np.asarray(g.mean, np.float64)) < 1e-6
    assert _rel(res.var.numpy(), np.asarray(g.var, np.float64)) < 1e-6


def test_pg_beta_mean_high(se):
    beta, iters, residual = gpquad_torch.pg_beta_mean_high(
        se["x"], se["kt"], se["h"], se["mtot"], se["delta"], se["kappa"],
        device="cpu")
    beta64 = se["oracle"][0]
    assert (np.linalg.norm(beta.numpy() - beta64)
            / np.linalg.norm(beta64)) < 1e-9
    assert int(iters) >= 1 and float(residual) >= 0.0
    res = _port(se, with_var=False)
    assert res.var is None
    assert torch.equal(res.beta, beta)


def test_pg_high_iterative_inner_solve(se, monkeypatch):
    """Past DENSE_SOLVER_MAX_M the float32 corrections come from the float32
    PCG (Jacobi), against the same float64 residuals."""
    monkeypatch.setattr(thigh, "DENSE_SOLVER_MAX_M", 0)
    res = _port(se, passes=12)
    _, mean64, var64 = se["oracle"]
    assert _rel(res.mean.numpy(), mean64) < 1e-9
    assert _rel(res.var.numpy(), var64) < 1e-9


def test_pg_high_bucketed_rung_masks_surplus_nodes(se):
    hm = (se["mtot"] - 1) // 2
    mtot_b = 2 * (hm + 3) + 1
    res = _port(se, mtot=mtot_b, hm=hm)
    _, mean64, var64 = _oracle(se, hm=hm, mtot=mtot_b)
    assert _rel(res.mean.numpy(), mean64) < 1e-9
    assert _rel(res.var.numpy(), var64) < 1e-9
    # the masked rung is the planned grid's system
    assert _rel(res.mean.numpy(), se["oracle"][1]) < 1e-9


@pytest.mark.parametrize("case", ["se_masked", "matern_1d"])
def test_pg_oracles_match_gpquad(case):
    if case == "se_masked":
        p = _problem(1, n=300)
        hm = (p["mtot"] - 1) // 2 - 2
    else:
        p = _problem(2, n=300, d=1, ell=0.2, var=1.5, eps=1e-5, matern=True)
        hm = None
    beta_j, mean_j, var_j = _oracle(p, hm=hm)
    obj = torc.pg_f64_objects(p["x"], p["delta"], p["kt"], p["h"],
                              p["mtot"], hm=hm)
    beta = torc.pg_beta_mean_f64(obj, p["kappa"])
    assert (np.linalg.norm(beta.numpy() - beta_j)
            / np.linalg.norm(beta_j)) < 1e-11
    assert _rel(torc.pg_mean_f64(obj, p["xt"], beta).numpy(), mean_j) < 1e-11
    assert _rel(torc.pg_var_f64(obj, p["xt"]).numpy(), var_j) < 1e-11


def test_pg_high_matern_1d_matches_gpquad():
    p = _problem(3, n=300, d=1, ell=0.2, var=1.5, eps=1e-5, matern=True)
    res = _port(p)
    _, mean64, var64 = _oracle(p)
    assert _rel(res.mean.numpy(), mean64) < 1e-9
    assert _rel(res.var.numpy(), var64) < 1e-9


def test_pg_high_defaults_to_the_card(se):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        gpquad_torch.pg_predict_high(se["x"], se["kt"], se["h"], se["mtot"],
                                     se["delta"], se["kappa"], se["xt"])
