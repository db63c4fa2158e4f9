"""Port parity for the high-precision gradient (``models/gradient_high.py``)
and variance (``models/variance_high.py``), on the CPU.

Both are held against gpquad's dense numpy float64 oracles
(``gpquad/utils/f64_oracles.py``: ``gradient_f64`` with the same probes,
``regular_var_f64``) at 1e-8 relative per component or target, at d = 1, 2
and 3 and for Matérn, with the inner float32 corrections on the dense
inverse and, with the dense window shut (``DENSE_SOLVER_MAX_M`` patched to
0), on the PCG with Jacobi and with deflation.  Against gpquad's
double-word outputs they are held at gpquad's own bars
(``tests/test_precision.py``: 3e-4 for the gradient, 1e-6 for the
variance), each gpquad function called once in a module fixture (tens of
seconds on XLA:CPU).  The hypers are exact in float32, so both packages see
the same values.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.kernels import Matern as JaxMatern
from gpquad.kernels import SquaredExponential as JaxSE
from gpquad.models.gradient_high import gradient_high as jax_gradient_high
from gpquad.models.variance_high import variance_high as jax_variance_high
from gpquad.utils import f64_oracles as jor
import gpquad_torch

tgh = importlib.import_module("gpquad_torch.models.gradient_high")
tvh = importlib.import_module("gpquad_torch.models.variance_high")

torch.set_num_threads(1)

VAR = 1.25
# tests/test_precision.py's gradient and variance sizes:
# kind -> (d, n, mtot, h, sigmasq, lengthscale)
CASES = {"SE-d1": (1, 2000, 9, 0.31, 0.01, 0.25),
         "SE-d2": (2, 2000, 9, 0.31, 0.01, 0.25),
         "SE-d3": (3, 2000, 7, 0.35, 0.05, 0.35),
         "Matern32-d2": (2, 2000, 9, 0.31, 0.01, 0.25)}
T = 4


def _kernels(kind, d, ell):
    """gpquad's kernel with float32 hypers, the port's with the same values
    in float64."""
    ell32 = float(np.float32(ell))
    if kind.startswith("SE"):
        return (JaxSE(lengthscale=jnp.float32(ell), variance=jnp.float32(VAR),
                      dimension=d),
                gpquad_torch.make_kernel("SE", d, lengthscale=ell32,
                                         variance=VAR))
    return (JaxMatern(lengthscale=jnp.float32(ell), variance=jnp.float32(VAR),
                      dimension=d, nu=1.5),
            gpquad_torch.make_kernel("Matern32", d, lengthscale=ell32,
                                     variance=VAR))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    kind = request.param
    d, n, mtot, h, sig, ell = CASES[kind]
    rng = np.random.default_rng(d)
    x = rng.uniform(0, 1, (n, d)).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    xt = rng.uniform(0.1, 0.9, (40, d)).astype(np.float32)
    M = mtot ** d
    Z = (rng.integers(0, 2, (T, n)) * 2 - 1).astype(np.float32)
    V = (rng.integers(0, 2, (T, M)) * 2 - 1).astype(np.float32)
    jk, tk = _kernels(kind, d, ell)
    obj = jor.efgp_f64_objects_kernel(x, y, jk, sig, h, mtot)
    return dict(kind=kind, x=x, y=y, xt=xt, Z=Z, V=V, h=h, mtot=mtot,
                sig=sig, jk=jk, tk=tk, grad64=jor.gradient_f64(obj, Z, V),
                var64=jor.regular_var_f64(obj, xt))


def _rel(got, want):
    return np.max(np.abs(np.asarray(got) - want) / np.abs(want))


@pytest.mark.parametrize("inner", ["dense", "jacobi", "deflation"])
def test_gradient_high_matches_oracle(case, inner, monkeypatch):
    kw = {}
    if inner != "dense":
        monkeypatch.setattr(tgh, "DENSE_SOLVER_MAX_M", 0)
        kw = dict(precond_rank=40 if inner == "deflation" else 0,
                  ir_maxiter=2000)
    res = gpquad_torch.gradient_high(
        case["x"], case["y"], case["tk"], case["sig"], case["h"],
        case["mtot"], probes=(case["Z"], case["V"]), device="cpu", **kw)
    assert res.grad.dtype == torch.float64 and res.grad.shape == (3,)
    assert _rel(res.grad.numpy(), case["grad64"]) < 1e-8
    if inner == "dense":
        assert int(res.inner_iters) <= 7          # one matmul a pass


@pytest.mark.parametrize("inner", ["dense", "jacobi", "deflation"])
def test_variance_high_matches_oracle(case, inner, monkeypatch):
    kw = {}
    if inner != "dense":
        monkeypatch.setattr(tvh, "DENSE_SOLVER_MAX_M", 0)
        kw = dict(precond_rank=40 if inner == "deflation" else 0,
                  ir_maxiter=2000)
    var = gpquad_torch.variance_high(case["x"], case["tk"], case["sig"],
                                     case["h"], case["mtot"], case["xt"],
                                     slab=16, device="cpu", **kw)
    assert var.dtype == torch.float64 and var.shape == (len(case["xt"]),)
    assert _rel(var.numpy(), case["var64"]) < 1e-8


def _se_d2():
    """The SE-d2 case's data, probes and kernels."""
    d, n, mtot, h, sig, ell = CASES["SE-d2"]
    rng = np.random.default_rng(d)
    x = rng.uniform(0, 1, (n, d)).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    xt = rng.uniform(0.1, 0.9, (40, d)).astype(np.float32)
    Z = (rng.integers(0, 2, (T, n)) * 2 - 1).astype(np.float32)
    V = (rng.integers(0, 2, (T, mtot ** d)) * 2 - 1).astype(np.float32)
    jk, tk = _kernels("SE", d, ell)
    return dict(x=x, y=y, xt=xt, Z=Z, V=V, h=h, mtot=mtot, sig=sig, jk=jk,
                tk=tk)


def test_gradient_high_draws_probes_from_generator():
    """Without probes, Z (T, n) then V (T, M) come from the generator, as
    in gradient_with_grid."""
    c = _se_d2()
    n, M = c["x"].shape[0], c["mtot"] ** 2
    args = (c["x"], c["y"], c["tk"], c["sig"], c["h"], c["mtot"])
    got = gpquad_torch.gradient_high(
        *args, trace_samples=3, generator=torch.Generator().manual_seed(4),
        device="cpu")
    g = torch.Generator().manual_seed(4)
    Z = torch.randint(0, 2, (3, n), generator=g) * 2 - 1
    V = torch.randint(0, 2, (3, M), generator=g) * 2 - 1
    want = gpquad_torch.gradient_high(*args, probes=(Z, V), device="cpu")
    assert torch.equal(got.grad, want.grad)


def test_matches_gpquad_double_word():
    """gpquad's double-word gradient and variance on the SE-d2 case (one
    call each): the port within gpquad's bars of them, and nearer the
    float64 oracle than they are."""
    c = _se_d2()
    xj, yj = jnp.asarray(c["x"]), jnp.asarray(c["y"])
    jgrad = np.asarray(jax_gradient_high(xj, yj, c["jk"], c["sig"], c["h"],
                                         c["mtot"], probes=(c["Z"], c["V"])
                                         ).grad)
    jvar = np.asarray(jax_variance_high(xj, c["jk"], c["sig"], c["h"],
                                        c["mtot"], jnp.asarray(c["xt"]),
                                        slab=40))
    obj = jor.efgp_f64_objects_kernel(c["x"], c["y"], c["jk"], c["sig"],
                                      c["h"], c["mtot"])
    grad64 = jor.gradient_f64(obj, c["Z"], c["V"])
    res = gpquad_torch.gradient_high(c["x"], c["y"], c["tk"], c["sig"],
                                     c["h"], c["mtot"],
                                     probes=(c["Z"], c["V"]), device="cpu")
    assert _rel(res.grad.numpy(), jgrad) < 3e-4
    assert _rel(res.grad.numpy(), grad64) <= _rel(jgrad, grad64)
    var = gpquad_torch.variance_high(c["x"], c["tk"], c["sig"], c["h"],
                                     c["mtot"], c["xt"], device="cpu")
    assert _rel(var.numpy(), jvar) < 1e-6
