"""Port parity for the spreading NUFFT backends: ``gpquad_torch.ops.
spread_nufft`` and ``.spread_banded`` against ``gpquad.ops.spread_nufft``
and ``.spread_banded`` on the same seeded numpy inputs (JAX on the CPU with
x64, the port on the CPU), and their wiring through ``make_nufft``, the fit,
the gradient, the fused pipeline and the ``EFGP`` facade.

Tolerances: each backend against gpquad's same function in float64 within
1e-10 of max|ref| (the same kernel, fine grid, deconvolution and
compensated coordinates; the sums run in another order); each backend
against the exact phase-matrix path within 1e-6 (gpquad's bar for w=8,
tests/test_spread_banded.py:29); the host-planned caps and subproblem
counts equal; the fit's mean within 1e-4 and the gradient within 1e-3 of
gpquad's on the same backend with the same probes in float32 (gpquad's bars
against its exact path, tests/test_spread_banded.py:103, :118).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.kernels import SquaredExponential as JaxSE
from gpquad.models.efgp import fit_with_grid as j_fit_with_grid
from gpquad.models.efgp import plan_nufft_caps as j_plan_nufft_caps
from gpquad.models.efgp import predict_mean as j_predict_mean
from gpquad.models.gradient import gradient_with_grid as j_gradient_with_grid
from gpquad.models.model import EFGP as JaxEFGP
from gpquad.ops import spread_banded as jb
from gpquad.ops import spread_nufft as js
from gpquad.ops.nufft import make_nufft as j_make_nufft
import gpquad_torch
from gpquad_torch.models import efgp as tefgp
from gpquad_torch.ops import nufft as tnufft
from gpquad_torch.ops import spread_banded as tb
from gpquad_torch.ops import spread_nufft as ts

torch.set_num_threads(1)

T64 = torch.float64


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / max(1e-300, np.max(np.abs(want)))


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _complex(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


@pytest.fixture(scope="module")
def setup2d():
    """gpquad's d=2 inputs (tests/test_spread_banded.py:15)."""
    rng = np.random.default_rng(0)
    n, mtot, h = 2500, 23, 0.31
    x = rng.uniform(-2, 2, (n, 2))
    return dict(x=x, v=_complex(rng, n), f=_complex(rng, (mtot, mtot)),
                mtot=mtot, h=h, cap=jb.banded_plan_cap(x, h, mtot, w=8))


@pytest.fixture(scope="module")
def setup3d():
    """gpquad's d=3 inputs (tests/test_spread_banded.py:139)."""
    rng = np.random.default_rng(1)
    n, mtot, h = 1500, 11, 0.29
    x = rng.uniform(-2, 2, (n, 3))
    return dict(x=x, v=_complex(rng, n), f=_complex(rng, (mtot,) * 3),
                mtot=mtot, h=h, cap=jb.banded_plan_cap_3d(x, h, mtot, w=8))


# (name, d, gpquad function, port function, options)
FUNCTIONS = [
    ("spread1", 2, js.spread_nufft1_2d, ts.spread_nufft1_2d, {}),
    ("spread2", 2, js.spread_nufft2_2d, ts.spread_nufft2_2d, {}),
    ("banded1", 2, jb.banded_nufft1_2d, tb.banded_nufft1_2d, "cap"),
    ("banded2", 2, jb.banded_nufft2_2d, tb.banded_nufft2_2d, "cap"),
    ("sub1", 2, jb.sub_nufft1_2d, tb.sub_nufft1_2d, dict(cc=64, sc=8)),
    ("sub2", 2, jb.sub_nufft2_2d, tb.sub_nufft2_2d, dict(cc=64, sc=8)),
    ("sub1_defaults", 2, jb.sub_nufft1_2d, tb.sub_nufft1_2d, {}),
    ("banded1_3d", 3, jb.banded_nufft1_3d, tb.banded_nufft1_3d, "cap"),
    ("banded2_3d", 3, jb.banded_nufft2_3d, tb.banded_nufft2_3d, "cap"),
    ("sub1_3d", 3, jb.sub_nufft1_3d, tb.sub_nufft1_3d, dict(cc=64, sc=4)),
    ("sub2_3d", 3, jb.sub_nufft2_3d, tb.sub_nufft2_3d, dict(cc=64, sc=4)),
]


@pytest.mark.parametrize("name,d,jfn,tfn,kw", FUNCTIONS,
                         ids=[f[0] for f in FUNCTIONS])
def test_function_matches_gpquad(name, d, jfn, tfn, kw, setup2d, setup3d):
    s = setup2d if d == 2 else setup3d
    kw = dict(cap=s["cap"]) if kw == "cap" else kw
    arg = s["v"] if "1" in name.split("_")[0] else s["f"].reshape(-1)
    want = np.asarray(jfn(jnp.asarray(s["x"]), jnp.asarray(arg), s["h"],
                          mtot=s["mtot"], **kw))
    got = tfn(_t(s["x"]), _t(arg), s["h"], mtot=s["mtot"], **kw)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) < 1e-10


@pytest.mark.parametrize("method,d", [("spread", 2), ("banded", 2),
                                      ("sub", 2), ("banded", 3), ("sub", 3)])
def test_backend_matches_exact_path(method, d, setup2d, setup3d):
    """make_nufft(method=...) against the phase-matrix path: both types, a
    single vector and a leading batch of two, flat and block modes."""
    s = setup2d if d == 2 else setup3d
    x, mtot = _t(s["x"]), s["mtot"]
    before = dict(tnufft.BACKEND_PICKS)
    op = tnufft.make_nufft(x, s["h"], mtot, method=method)
    assert tnufft.BACKEND_PICKS[method] == before[method] + 1
    assert op.d == d and op.n == x.shape[0]
    exact = tnufft.make_nufft(x, s["h"], mtot, method="matmul")
    v, f = _t(s["v"]), _t(s["f"])
    vb = torch.stack([v, 2.0 * v])
    fb = torch.stack([f.reshape(-1), 3.0 * f.reshape(-1)])
    for got, want in ((op.type1(v), exact.type1(v)),
                      (op.type1(vb), exact.type1(vb)),
                      (op.type2(f), exact.type2(f)),
                      (op.type2(f.reshape(-1)), exact.type2(f.reshape(-1))),
                      (op.type2(fb), exact.type2(fb))):
        assert got.shape == want.shape
        assert _rel(got.numpy(), want.numpy()) < 1e-6


@pytest.mark.parametrize("d", [2, 3])
def test_adjoint_identity(d, setup2d, setup3d):
    """<F* v, f> == <v, F f> through each planned backend."""
    s = setup2d if d == 2 else setup3d
    for method in ("banded", "sub"):
        op = tnufft.make_nufft(_t(s["x"]), s["h"], s["mtot"], method=method)
        v, f = _t(s["v"]), _t(s["f"])
        lhs = torch.sum(op.type1(v).conj() * f)
        rhs = torch.sum(v.conj() * op.type2(f))
        assert abs(complex(lhs - rhs)) < 1e-10 * abs(complex(lhs))


@pytest.mark.parametrize("lo,hi,h,mtot", [(-2, 2, 0.31, 23), (0, 10, 0.31, 23),
                                          (0, 1, 0.2, 21), (0, 1, 0.02, 17),
                                          (0, 1, 0.97, 339)])
def test_plans_equal_gpquad(lo, hi, h, mtot):
    rng = np.random.default_rng(mtot)
    x2 = rng.uniform(lo, hi, (3000, 2)).astype(np.float32)
    x3 = rng.uniform(lo, hi, (3000, 3)).astype(np.float32)
    assert tb.banded_plan_cap(_t(x2), h, mtot) == jb.banded_plan_cap(
        x2, h, mtot)
    assert tb.banded_plan_cap(x2, h, mtot, w=6, slack=1.5) == \
        jb.banded_plan_cap(x2, h, mtot, w=6, slack=1.5)
    assert tb.banded_plan_cap_3d(_t(x3), h, mtot) == jb.banded_plan_cap_3d(
        x3, h, mtot)
    for n in (1, 500, 3000, 1_000_000):
        assert tb.sub_nsub_2d(n, mtot) == jb.sub_nsub_2d(n, mtot)
        assert tb.sub_nsub_3d(n, mtot, cc=64) == jb.sub_nsub_3d(n, mtot,
                                                                cc=64)
    caps = tefgp.plan_nufft_caps(_t(x2), h, mtot)
    assert caps == j_plan_nufft_caps(jnp.asarray(x2), h, mtot)


def test_spread_params_and_deconvolution_match_gpquad():
    for eps in (1e-3, 1e-6, 1e-9):
        assert ts.spread_params(eps) == js.spread_params(eps)
    for mtot in (11, 23, 339, 677):
        nf = ts._fine_size(mtot)
        assert nf == js._fine_size(mtot)
        assert tb._geometry(mtot, 8) == jb._geometry(mtot, 8)
        np.testing.assert_allclose(ts._deconv_factors(mtot, nf, 8, 18.4),
                                   js._deconv_factors(mtot, nf, 8, 18.4),
                                   rtol=1e-13)


@pytest.mark.parametrize("d", [2, 3])
def test_banded_cap_overflow_poisons(d):
    """A band (tile) past the cap poisons both types with NaN (gpquad
    tests/test_spread_banded.py:121-129, :199-203)."""
    rng = np.random.default_rng(5)
    x = _t(rng.uniform(0, 0.01, (500, d)), torch.float32)
    v = _t(rng.normal(size=500), torch.float32)
    op = tb.BandedNUFFT(x, 0.31, 11, cap=64) if d == 2 else \
        tb.BandedNUFFT3D(x, 0.31, 11, cap=8)
    assert torch.isnan(op.type1(v).real).all()
    assert torch.isnan(op.type2(torch.ones((11,) * d)).real).all()
    want = np.asarray(jb.banded_nufft1_2d(jnp.asarray(x.numpy()),
                                          jnp.asarray(v.numpy()), 0.31,
                                          mtot=11, cap=64)) if d == 2 else \
        np.asarray(jb.banded_nufft1_3d(jnp.asarray(x.numpy()),
                                       jnp.asarray(v.numpy()), 0.31,
                                       mtot=11, cap=8))
    assert np.isnan(want.real).all()
    # a planned cap holds the same points
    ok = tnufft.make_nufft(x, 0.31, 11, method="banded")
    assert torch.isfinite(ok.type1(v).real).all()


@pytest.mark.parametrize("d,n,mtot,h,cc,sc", [(2, 3000, 21, 0.2, 64, 8),
                                             (2, 500, 17, 0.02, 32, 4),
                                             (3, 2000, 13, 0.15, 64, 4)],
                         ids=["clustered_2d", "single_band", "clustered_3d"])
def test_sub_clustered_points(d, n, mtot, h, cc, sc):
    """Points in a few bands (all in one at h 0.02): the subproblem path
    against gpquad's and the exact path (tests/test_spread_banded.py:
    230-268, :312-330)."""
    rng = np.random.default_rng(7 + d)
    x = rng.uniform(0, 1, (n, d))
    v = _complex(rng, n)
    f = _complex(rng, (mtot,) * d)
    one = ((tb.sub_nufft1_2d, tb.sub_nufft2_2d) if d == 2 else
           (tb.sub_nufft1_3d, tb.sub_nufft2_3d))
    two = ((jb.sub_nufft1_2d, jb.sub_nufft2_2d) if d == 2 else
           (jb.sub_nufft1_3d, jb.sub_nufft2_3d))
    exact = tnufft.make_nufft(_t(x), h, mtot, method="matmul")
    kw = dict(mtot=mtot, cc=cc, sc=sc)
    got1 = one[0](_t(x), _t(v), h, **kw)
    got2 = one[1](_t(x), _t(f.reshape(-1)), h, **kw)
    assert _rel(got1.numpy(), two[0](jnp.asarray(x), jnp.asarray(v), h,
                                     **kw)) < 1e-10
    assert _rel(got2.numpy(), two[1](jnp.asarray(x),
                                     jnp.asarray(f.reshape(-1)), h,
                                     **kw)) < 1e-10
    assert _rel(got1.numpy(), exact.type1(_t(v)).numpy()) < 1e-6
    assert _rel(got2.numpy(), exact.type2(_t(f)).numpy()) < 1e-6


def test_xcen_shifts_the_points(setup2d):
    """xcen: make_nufft(x, xcen=c) is make_nufft(x - c) on every backend;
    on the phase matrices it matches gpquad's make_nufft(xcen=c)."""
    s = setup2d
    c = np.array([0.37, -1.2])
    x, v = _t(s["x"]), _t(s["v"])
    want = np.asarray(j_make_nufft(jnp.asarray(s["x"]), s["h"], s["mtot"],
                                   xcen=jnp.asarray(c)).type1(
                                       jnp.asarray(s["v"])))
    got = tnufft.make_nufft(x, s["h"], s["mtot"], xcen=_t(c),
                            method="matmul").type1(v)
    assert _rel(got.numpy(), want) < 1e-12
    for method in ("spread", "banded", "sub"):
        a = tnufft.make_nufft(x, s["h"], s["mtot"], xcen=c,
                              method=method).type1(v)
        b = tnufft.make_nufft(x - _t(c), s["h"], s["mtot"],
                              method=method).type1(v)
        assert torch.equal(a, b)
        assert _rel(a.numpy(), want) < 1e-6


def test_make_nufft_limits():
    x1, x2, x3 = (torch.rand(50, d, dtype=T64) for d in (1, 2, 3))
    for method, x in (("spread", x1), ("spread", x3), ("banded", x1),
                      ("sub", x1)):
        with pytest.raises(NotImplementedError):
            tnufft.make_nufft(x, 0.3, 11, method=method)
    for method in ("spread", "banded", "sub"):
        with pytest.raises(NotImplementedError):
            tnufft.make_nufft(x2, 0.3, 11, method=method, fft_order=True)
    with pytest.raises(ValueError):
        tnufft.make_nufft(x2, 0.3, 11, method="mxu")
    op = tnufft.make_nufft(x2, 0.3, 11, method="banded", cap=16)
    assert op.cap == 16
    assert tnufft.make_nufft(x3, 0.3, 11, method="banded").cap == \
        tb.banded_plan_cap_3d(x3, 0.3, 11)


def test_float32_accuracy_at_a_wide_grid():
    """At nf 2048 (mtot 677) the port's float32 backends stay within 1e-5
    (type-1) and 2e-6 (type-2) of the float64 exact path, where gpquad's
    float32 spread and banded type-2 do not (ROADMAP §C): the port's
    spread stencil reads the compensated fine coordinate, where gpquad's
    reads the rounded angle of ``_thetas``, and the banded column
    distances are taken to the unwrapped column, where gpquad's
    ``(g - c)`` rounds near the torus seam."""
    rng = np.random.default_rng(12)
    n, mtot, h = 4000, 677, 0.97
    h32 = float(np.float32(h))
    x32 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    v = _complex(rng, n).astype(np.complex64)
    f = _complex(rng, (mtot, mtot)).astype(np.complex64)
    exact = tnufft.make_nufft(_t(x32, T64), h32, mtot, method="matmul")
    want1 = exact.type1(_t(v).to(torch.complex128)).numpy()
    want2 = exact.type2(_t(f).to(torch.complex128)).numpy()
    for m in ("spread", "banded", "sub"):
        op = tnufft.make_nufft(_t(x32), h, mtot, method=m)
        assert _rel(op.type1(_t(v)).numpy(), want1) < 1e-5, m
        assert _rel(op.type2(_t(f)).numpy(), want2) < 2e-6, m
    xj = jnp.asarray(x32)
    gpq1 = _rel(np.asarray(js.spread_nufft1_2d(
        xj, jnp.asarray(v), jnp.float32(h), mtot=mtot)), want1)
    gpq2 = _rel(np.asarray(jb.banded_nufft2_2d(
        xj, jnp.asarray(f), jnp.float32(h), mtot=mtot,
        cap=jb.banded_plan_cap(x32, h, mtot))), want2)
    assert gpq1 > 1e-5 and gpq2 > 2e-6, (gpq1, gpq2)


@pytest.fixture(scope="module")
def fit_data():
    """gpquad's fit-and-gradient inputs (tests/test_spread_banded.py:
    81-118), float32, with probes Z and V."""
    rng = np.random.default_rng(3)
    n, d, mtot, h = 3000, 2, 11, np.float32(0.33)
    x = rng.uniform(0, 1, (n, d)).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    xt = rng.uniform(0.1, 0.9, (64, d)).astype(np.float32)
    T = 4
    Z = (rng.integers(0, 2, (T, n)) * 2 - 1).astype(np.float32)
    V = (rng.integers(0, 2, (T, mtot ** d)) * 2 - 1).astype(np.float32)
    return dict(x=x, y=y, xt=xt, Z=Z, V=V, mtot=mtot, h=h, T=T)


def _kernels(dtype=np.float32):
    jk = JaxSE(lengthscale=jnp.asarray(0.25, dtype),
               variance=jnp.asarray(1.0, dtype), dimension=2)
    tk = gpquad_torch.make_kernel("SE", 2, lengthscale=float(dtype(0.25)),
                                  variance=1.0)
    return jk, tk


def test_fit_and_gradient_on_banded_match_gpquad(fit_data):
    s = fit_data
    jk, tk = _kernels()
    st_j = j_fit_with_grid(jnp.asarray(s["x"]), jnp.asarray(s["y"]), jk,
                           0.1, jnp.asarray(s["h"]), s["mtot"],
                           nufft_method="banded")
    mj = np.asarray(j_predict_mean(st_j, jnp.asarray(s["xt"])))
    before = dict(tnufft.BACKEND_PICKS)
    st_t = gpquad_torch.fit_with_grid(s["x"], s["y"], tk, 0.1, s["h"],
                                      s["mtot"], nufft_method="banded",
                                      device="cpu")
    # the fit's operator and its lag table on banded; the mean on "auto"
    assert tnufft.BACKEND_PICKS["banded"] == before["banded"] + 2
    mt = gpquad_torch.predict_mean(st_t, s["xt"]).numpy()
    assert np.max(np.abs(mt - mj)) < 1e-4 * max(1.0, np.max(np.abs(mj)))

    caps = j_plan_nufft_caps(jnp.asarray(s["x"]), float(s["h"]), s["mtot"])
    gj = np.asarray(j_gradient_with_grid(
        jnp.asarray(s["x"]), jnp.asarray(s["y"]), jk, 0.1,
        jnp.asarray(s["h"]), jax.random.PRNGKey(0), mtot=s["mtot"],
        trace_samples=s["T"], probes=(jnp.asarray(s["Z"]),
                                      jnp.asarray(s["V"])),
        nufft_method="banded", nufft_caps=caps).grad)
    gt = gpquad_torch.gradient_with_grid(
        s["x"], s["y"], tk, 0.1, s["h"], mtot=s["mtot"],
        trace_samples=s["T"], probes=(_t(s["Z"]), _t(s["V"])),
        nufft_method="banded", nufft_caps=caps, device="cpu").grad.numpy()
    assert np.max(np.abs(gt - gj)) < 1e-3 * max(1.0, np.max(np.abs(gj)))


@pytest.mark.parametrize("method", ["banded", "sub", "spread"])
def test_float64_paths_on_spreading_backends(method, fit_data):
    """fit_with_grid, gradient_with_grid (its caps planned when None),
    gradient() and fit_predict_grad on each spreading backend against the
    same calls on the exact path, float64 with the same probes."""
    s = fit_data
    x, y, xt = (s[k].astype(np.float64) for k in ("x", "y", "xt"))
    _, tk = _kernels(np.float64)
    h, mtot = float(s["h"]), s["mtot"]
    kw = dict(device="cpu", cg_tol=1e-12)

    def run(m):
        st = gpquad_torch.fit_with_grid(x, y, tk, 0.1, h, mtot,
                                        nufft_method=m, **kw)
        g = gpquad_torch.gradient_with_grid(
            x, y, tk, 0.1, h, mtot=mtot, trace_samples=s["T"],
            probes=(_t(s["Z"], T64), _t(s["V"], T64)), nufft_method=m, **kw)
        g2 = gpquad_torch.gradient(
            x, y, tk, 0.1, 1e-3, torch.Generator().manual_seed(4),
            trace_samples=2, nufft_method=m, **kw)
        fused = gpquad_torch.fit_predict_grad(
            x, y, xt, tk, 0.1, h, torch.Generator().manual_seed(5),
            mtot=mtot, trace_samples=2, var_probes=8, nufft_method=m,
            device="cpu")
        return (gpquad_torch.predict_mean(st, xt), g.grad, g2.grad,
                fused.mean, fused.var, fused.grad)

    for got, want in zip(run(method), run("auto")):
        assert _rel(got.numpy(), want.numpy()) < 1e-6


def test_facade_on_banded():
    """EFGP(opts={"nufft_method": "banded"}): fit, predict and two Adam
    iterations (caps planned per grid) against the facade on the exact
    path, float64 with the same generator.  gpquad's facade cannot take
    that Adam loop: its fused step plans no cap under jit (ROADMAP §C)."""
    rng = np.random.default_rng(9)
    x = rng.uniform(0, 1, (800, 2))
    y = np.sin(5 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.1 * rng.normal(size=800)
    xq = rng.uniform(0.1, 0.9, (50, 2))
    out = {}
    for m in ("banded", "auto"):
        model = gpquad_torch.EFGP(
            x, y, "SE", sigmasq=0.05, eps=1e-4,
            opts={"nufft_method": m, "cg_tolerance": 1e-12},
            generator=torch.Generator().manual_seed(1), device="cpu")
        mean, var = model.predict(xq, hutchinson_probes=16)
        model.optimize_hyperparameters(max_iters=2, lr=0.05,
                                       trace_samples=2, cg_tol=1e-10)
        out[m] = (mean, var, model.params.raw,
                  torch.as_tensor(model.compute_gradients(trace_samples=2)))
    for got, want in zip(out["banded"], out["auto"]):
        assert _rel(got.numpy(), want.numpy()) < 1e-6
    jm = JaxEFGP(jnp.asarray(x), jnp.asarray(y), "SE", sigmasq=0.05,
                 eps=1e-4, opts={"nufft_method": "banded"})
    with pytest.raises(ValueError, match="static band cap"):
        jm.optimize_hyperparameters(max_iters=1, trace_samples=2)
