"""Port parity for the EFGP facade (gpquad_torch.EFGP vs gpquad.EFGP), its
hyper state (HyperState) and the grid ladders and masks, all in float64 on
the CPU, plus the facade's own behaviour mirrored from tests/test_model.py.

Tolerances: ladders, masks, HyperState views and the grid plans are
identical (the same float64 host arithmetic); the mean 1e-9 absolute and
beta 1e-9 on the dense tier at cg_tol 1e-10 (test_torch_efgp.py's bars);
gradients with the same injected probes (Z, V) 1e-8 relative; an Adam
history with the rung pinned and the same probes 1e-8 relative per entry
(torch.optim.Adam and optax.adam round their bias corrections in a
different order, ~1e-16 per step).  Sampling and SLQ are statistical, at
the bars of tests/test_model.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.kernels import HyperState as JaxHyperState
from gpquad.kernels import SquaredExponential as JaxSE
from gpquad.kernels import median_distance_heuristic as jax_median
from gpquad import quadrature as jquad
from gpquad.models.model import EFGP as JaxEFGP
import gpquad_torch
from gpquad_torch import EFGP, HyperState, convert
from gpquad_torch import quadrature as tquad
from gpquad_torch.models.efgp import predict_var

from .test_efgp import dense_gp_posterior, make_data

# The parity problems are small: torch's intra-op threads cost more than
# they give on them, most of all beside other test processes.
torch.set_num_threads(1)


def _pair(x, y, hypers, eps=1e-4, **kw):
    """A JAX and a port model on the same data with the same hypers
    (lengthscale, variance, sigmasq)."""
    jm = JaxEFGP(jnp.asarray(x), jnp.asarray(y), "SE", sigmasq=hypers[2],
                 eps=eps, estimate_params=False, **kw)
    jm.params = jm.params.replace_raw(jnp.log(jnp.asarray(hypers)))
    tm = EFGP(np.asarray(x), np.asarray(y), "SE", sigmasq=hypers[2], eps=eps,
              estimate_params=False, device="cpu", **kw)
    tm.params = tm.params.replace_raw(torch.log(torch.as_tensor(
        hypers, dtype=torch.float64)))
    return jm, tm


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want) / np.abs(want))


# ---------------------------------------------------------------------------
# HyperState, ladders, masks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ell,var,s2", [(0.2, 1.5, 0.1), (3e-3, 0.7, 2.0)])
def test_hyper_state_matches(ell, var, s2):
    js = JaxHyperState.create(JaxSE(lengthscale=ell, variance=var,
                                    dimension=2), s2)
    ts = HyperState.create(gpquad_torch.make_kernel(
        "SE", 2, lengthscale=ell, variance=var), s2)
    assert ts.names == js.names == ("lengthscale", "variance")
    assert ts.raw.dtype == torch.float64
    np.testing.assert_array_equal(ts.raw.numpy(), np.asarray(js.raw))
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    assert float(ts.sig2) == float(js.sig2)
    np.testing.assert_array_equal(
        ts.kernel_of(gpquad_torch.make_kernel("SE", 2)).hyper_vector()
        .numpy(), np.asarray(js.kernel_of(JaxSE(dimension=2))
                             .hyper_vector()))
    tc, jc = ts.clamp_min("lengthscale", 5e-3), js.clamp_min("lengthscale",
                                                             5e-3)
    np.testing.assert_array_equal(tc.raw.numpy(), np.asarray(jc.raw))
    assert ts.raw[0] == float(np.log(ell))            # the original is kept
    assert {k: float(v) for k, v in ts.as_dict().items()} == {
        k: float(v) for k, v in js.as_dict().items()}
    moved = ts.replace_raw(ts.raw + 1.0)
    assert moved.names == ts.names and float(moved.raw[1]) == float(
        ts.raw[1] + 1.0)


def test_bucket_ladders_match():
    for m in range(0, 3001):
        assert tquad.bucket_mtot(m) == jquad.bucket_mtot(m), m
        assert tquad.bucket_neighbors(m) == jquad.bucket_neighbors(m), m
    for m in (1, 5, 17, 200):
        assert tquad.bucket_mtot(m, minimum=3) == jquad.bucket_mtot(
            m, minimum=3)
    for n in list(range(0, 2000, 7)) + [10 ** 5, 10 ** 6 + 1, 3 * 10 ** 6]:
        assert tquad.bucket_points(n) == jquad.bucket_points(n), n


@pytest.mark.parametrize("d", [1, 2, 3])
def test_grid_masks_match(d):
    for mtot_pad, hm in ((9, 4), (15, 3), (21, 0), (33, 12)):
        want = np.asarray(jquad.flat_grid_mask(mtot_pad, d, hm,
                                               dtype=jnp.float64))
        got = tquad.flat_grid_mask(mtot_pad, d, hm, dtype=torch.float64)
        assert got.shape == (mtot_pad ** d,)
        np.testing.assert_array_equal(got.numpy(), want)
        if d == 1:
            jx, jm = jquad.padded_grid_mask(mtot_pad, hm, 0.37)
            tx, tm = tquad.padded_grid_mask(mtot_pad, hm, 0.37)
            np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


# ---------------------------------------------------------------------------
# kernel plumbing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d", [(150, 1), (400, 2), (1000, 3)])
def test_estimate_hyperparameters_exact(rng, n, d):
    """n <= K = 1000: no subsample, so the heuristic is exact on both
    sides (the median of the positive distances, SE takes half of it)."""
    x = rng.uniform(0, 1, (n, d))
    y = rng.normal(size=n)
    jl, jv, jn = JaxSE(dimension=d).estimate_hyperparameters(
        jnp.asarray(x), jnp.asarray(y))
    tl, tv, tn = gpquad_torch.make_kernel("SE", d).estimate_hyperparameters(
        torch.as_tensor(x), torch.as_tensor(y))
    assert abs(float(tl) - float(jl)) <= 1e-14 * float(jl)
    assert abs(float(tv) - float(jv)) <= 1e-14 * float(jv)
    assert abs(float(tn) - float(jn)) <= 1e-14 * float(jn)
    assert float(tl) == pytest.approx(0.5 * float(jax_median(jnp.asarray(x))),
                                      rel=1e-14)


def test_kernel_plumbing_matches(rng):
    x = rng.uniform(0, 1, (60, 2))
    y = rng.normal(size=60)
    jk = JaxSE(lengthscale=0.3, variance=1.7, dimension=2)
    tk = gpquad_torch.make_kernel("SE", 2, lengthscale=0.3, variance=1.7)
    assert [n for n, _ in tk.iter_hypers()] == [n for n, _ in
                                                jk.iter_hypers()]
    K = tk.kernel_matrix(torch.as_tensor(x), torch.as_tensor(x[:7])).numpy()
    assert _rel(K, jk.kernel_matrix(jnp.asarray(x), jnp.asarray(x[:7]))) \
        < 1e-13
    lm = float(tk.log_marginal(torch.as_tensor(x), torch.as_tensor(y), 0.2))
    assert abs(lm - float(jk.log_marginal(jnp.asarray(x), jnp.asarray(y),
                                          0.2))) < 1e-10 * abs(lm)
    moved = tk.set_hyper("variance", 2.5)
    assert float(moved.variance) == 2.5 and float(tk.variance) == 1.7
    with pytest.raises(ValueError):
        tk.set_hyper("nu", 1.0)
    # a failed Cholesky is -inf, as gpquad's NaN fallback gives it
    assert tk.log_marginal(torch.zeros((3, 2), dtype=torch.float64),
                           torch.ones(3, dtype=torch.float64),
                           -5.0) == -float("inf")


# ---------------------------------------------------------------------------
# the facade against gpquad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_fit_predict_match(rng, solver):
    x, y = make_data(rng, n=150, d=1, lengthscale=0.2, variance=1.5)
    opts = {"cg_tolerance": 1e-10, "solver": solver}
    jm, tm = _pair(x, y, [0.2, 1.5, 0.2], opts=opts)
    xq = np.linspace(0.05, 0.95, 40)
    jmean, _ = jm.predict(jnp.asarray(xq), return_variance=False)
    tmean, tvar = tm.predict(xq, return_variance=False)
    assert tvar is None
    assert tm._state.mtot == jm._state.mtot
    assert np.max(np.abs(tm._state.beta.numpy()
                         - np.asarray(jm._state.beta))) < 1e-9
    assert np.max(np.abs(tmean.numpy() - np.asarray(jmean))) < 1e-9
    # the facade's variance draws from its generator: the functional call
    # with the same generator seed gives the same numbers
    _, var = tm.predict(xq, hutchinson_probes=64,
                        generator=torch.Generator().manual_seed(4))
    want = predict_var(tm.state, torch.as_tensor(xq), probes=64,
                       cg_tol=1e-10, generator=torch.Generator().manual_seed(4))
    np.testing.assert_array_equal(var.numpy(), want.numpy())


def test_compute_gradients_match(rng):
    x, y = make_data(rng, n=90, d=1)
    jm, tm = _pair(x, y, [0.25, 1.3, 0.15], eps=1e-3)
    assert tm._grid_plan(True) == jm._grid_plan(True)
    _, mtot, _ = tm._grid_plan(True)
    T = 4
    Z = rng.integers(0, 2, (T, 90)) * 2.0 - 1
    V = rng.integers(0, 2, (T, mtot)) * 2.0 - 1
    jg = jm.compute_gradients(trace_samples=T, cg_tol=1e-10,
                              probes=(jnp.asarray(Z), jnp.asarray(V)))
    tg = tm.compute_gradients(trace_samples=T, cg_tol=1e-10,
                              probes=(torch.as_tensor(Z), torch.as_tensor(V)))
    assert tg.dtype == torch.float64 and tg.shape == (3,)
    assert _rel(tg.numpy(), jg) < 1e-8
    for key in ("mtot", "feature_count", "trace_samples",
                "mean_cg_warm_start_used"):
        assert tm.last_gradient_stats[key] == jm.last_gradient_stats[key]
    # the log-space chain rule over the functional gradient on the masked
    # padded grid, as tests/test_model.py checks it
    h, mtot2, hm = tm._grid_plan(True)
    _, mask = tquad.padded_grid_mask(mtot2, hm, h)
    res = gpquad_torch.gradient_with_grid(
        x, y, tm.kernel, tm.sigmasq, h, mtot=mtot2, trace_samples=T,
        cg_tol=1e-10, probes=(torch.as_tensor(Z), torch.as_tensor(V)),
        ws_mask=mask, device="cpu")
    want = res.grad.numpy() * np.exp(tm.params.raw.numpy())
    assert np.allclose(tm.compute_gradients(
        trace_samples=T, cg_tol=1e-10,
        probes=(torch.as_tensor(Z), torch.as_tensor(V))).numpy(), want,
        rtol=1e-9)


@pytest.mark.parametrize("d", [1, 2])
def test_optimize_history_matches(rng, d):
    """A few Adam iterations with the rung pinned above every plan and the
    same probes in both models: the histories agree entry by entry."""
    n = 100 if d == 1 else 150
    x, y = make_data(rng, n=n, d=d, lengthscale=0.25, variance=1.0)
    jm, tm = _pair(x, y, [0.3, 0.8, 0.3], eps=1e-3)
    rung = tquad.bucket_mtot(tm._grid_plan(False)[1] + 6)
    jm._mtot_floor = tm._mtot_floor = rung
    T = 3
    Z = rng.integers(0, 2, (T, n)) * 2.0 - 1
    V = rng.integers(0, 2, (T, rung ** d)) * 2.0 - 1
    kw = dict(max_iters=4, lr=0.1, trace_samples=T, cg_tol=1e-10,
              min_lengthscale=1e-3)
    jm.optimize_hyperparameters(probes=(jnp.asarray(Z), jnp.asarray(V)),
                                key=jax.random.PRNGKey(0), **kw)
    tm.optimize_hyperparameters(probes=(torch.as_tensor(Z),
                                        torch.as_tensor(V)), **kw)
    jh, th = jm.training_log, tm.training_log
    assert sorted(th) == sorted(jh)
    for key in ("lengthscale", "variance", "sigmasq"):
        assert len(th[key]) == 4
        assert _rel(th[key], jh[key]) < 1e-8, key
    assert _rel(np.array(th["gradients"]), np.array(jh["gradients"])) < 1e-8
    assert th["mean_cg_iters"] == jh["mean_cg_iters"]
    assert th["log_marginal"] == jh["log_marginal"] == []
    assert _rel(tm.params.raw.numpy(), jm.params.raw) < 1e-8
    assert tm.last_gradient_stats["mtot"] == jm.last_gradient_stats["mtot"] \
        == rung
    # the final refit at the learned hypers
    assert not tm._params_changed()
    assert np.max(np.abs(tm._state.beta.numpy()
                         - np.asarray(jm._state.beta))) < 1e-7


def test_rebuilt_across_packages(rng):
    """A port model given a JAX model's HyperState (through convert.py)
    predicts the JAX model's mean, and the way back."""
    x, y = make_data(rng, n=120, d=1, lengthscale=0.3)
    opts = {"cg_tolerance": 1e-10}
    jm = JaxEFGP(x, y, "SE", sigmasq=0.3, eps=1e-4, estimate_params=False,
                 opts=opts)
    jm.params = jm.params.replace_raw(jnp.log(jnp.asarray([0.3, 1.2, 0.2])))
    tm = EFGP(np.asarray(x), np.asarray(y), "SE", eps=1e-4,
              estimate_params=False, opts=opts, device="cpu")
    tm.params = convert.hyper_state_from_numpy(np.asarray(jm.params.raw),
                                               jm.params.names, device="cpu")
    xq = np.linspace(0, 1, 25)
    jmean, _ = jm.predict(jnp.asarray(xq), return_variance=False)
    tmean, _ = tm.predict(xq, return_variance=False)
    assert np.max(np.abs(tmean.numpy() - np.asarray(jmean))) < 1e-9
    back = convert.hyper_state_to_numpy(tm.params)
    again = JaxHyperState(raw=jnp.asarray(back["raw"]), names=back["names"])
    np.testing.assert_array_equal(np.asarray(again.raw),
                                  np.asarray(jm.params.raw))


# ---------------------------------------------------------------------------
# the facade's own behaviour (tests/test_model.py:38-217)
# ---------------------------------------------------------------------------

def _model(x, y, hypers, **kw):
    m = EFGP(np.asarray(x), np.asarray(y), "SE", sigmasq=hypers[-1],
             estimate_params=False, device="cpu", **kw)
    m.params = m.params.replace_raw(torch.log(torch.as_tensor(
        hypers, dtype=torch.float64)))
    return m


def test_fit_cache_invalidation(rng):
    x, y = make_data(rng, n=80, d=1)
    model = EFGP(np.asarray(x), np.asarray(y), "SE", sigmasq=0.1, eps=1e-3,
                 estimate_params=False, device="cpu")
    model.fit()
    state1 = model._state
    model.fit()
    assert model._state is state1                  # cache hit
    model.params = model.params.replace_raw(model.params.raw + torch.tensor(
        [0.05, 0.0, 0.0], dtype=torch.float64))
    model.fit()
    assert model._state is not state1
    state2 = model._state
    model.fit(force_recompute=True)
    assert model._state is not state2


def test_min_lengthscale_clamp(rng):
    x, y = make_data(rng, n=60, d=1)
    model = _model(x, y, [6e-3, 1.0, 0.1], eps=1e-2)
    model.optimize_hyperparameters(max_iters=3, lr=0.5, trace_samples=2,
                                   min_lengthscale=5e-3,
                                   generator=torch.Generator().manual_seed(0))
    assert float(torch.exp(model.params.raw[0])) >= 5e-3 - 1e-12
    assert min(model.training_log["lengthscale"][1:]) >= 5e-3 - 1e-12


def test_optimize_hyperparameters_improves_nll(rng):
    x, y = make_data(rng, n=150, d=1, lengthscale=0.2, variance=1.0,
                     noise=0.1)
    model = _model(x, y, [0.6, 0.3, 0.5], eps=1e-3)

    def dense_nll():
        k = model.kernel
        K = k.kernel_matrix(torch.as_tensor(np.asarray(x)),
                            torch.as_tensor(np.asarray(x))).numpy()
        C = K + float(model.sigmasq) * np.eye(len(np.asarray(y)))
        _, logdet = np.linalg.slogdet(C)
        return 0.5 * (np.asarray(y) @ np.linalg.solve(C, np.asarray(y))
                      + logdet)

    nll0 = dense_nll()
    model.optimize_hyperparameters(max_iters=25, lr=0.1, trace_samples=8,
                                   generator=torch.Generator().manual_seed(0))
    assert dense_nll() < nll0 - 1.0
    hist = model.training_log
    assert len(hist["lengthscale"]) == len(hist["gradients"]) == 25
    assert all(isinstance(m, int) for m in hist["mean_cg_iters"])


def test_grid_plan_rung_hysteresis(rng):
    """Bucketed plans only grow over a model's life; unbucketed plans are
    untouched by the floor; every plan equals gpquad's."""
    x, y = make_data(rng, n=200, d=2, lengthscale=0.1, variance=1.0)
    jm, tm = _pair(x, y, [0.05, 1.0, 0.1], eps=1e-3)
    _, mtot_small_ell, hm0 = tm._grid_plan(True)
    assert (_, mtot_small_ell, hm0) == jm._grid_plan(True)
    tm.params = tm.params.replace_raw(torch.log(torch.tensor(
        [0.4, 1.0, 0.1], dtype=torch.float64)))
    jm.params = jm.params.replace_raw(jnp.log(jnp.asarray([0.4, 1.0, 0.1])))
    _, mtot2, hm2 = tm._grid_plan(True)
    assert (mtot2, hm2) == jm._grid_plan(True)[1:]
    assert mtot2 == mtot_small_ell and hm2 < hm0
    tm.params = tm.params.replace_raw(torch.log(torch.tensor(
        [0.02, 1.0, 0.1], dtype=torch.float64)))
    _, mtot3, _ = tm._grid_plan(True)
    assert mtot3 > mtot_small_ell
    _, mtot_raw, _ = tm._grid_plan(False)
    assert mtot_raw < mtot3


def test_gradient_unchanged_by_hysteresis_floor(rng):
    """A gradient on a floored (larger, masked) rung equals the one on the
    planned rung, with the frequency probes embedded in the centre."""
    x, y = make_data(rng, n=300, d=1, lengthscale=0.25, variance=1.0)
    model = _model(x, y, [0.25, 1.0, 0.1], eps=1e-4)
    prng = np.random.default_rng(3)
    T = 4
    Z = torch.as_tensor(prng.integers(0, 2, (T, 300)) * 2.0 - 1)
    model._mtot_floor = 0
    _, mtot_small, _ = model._grid_plan(True)
    model._mtot_floor = 0
    V_small = prng.integers(0, 2, (T, mtot_small)) * 2.0 - 1
    g_fresh = model.compute_gradients(
        trace_samples=T, cg_tol=1e-10,
        probes=(Z, torch.as_tensor(V_small))).numpy()
    mtot_big = 2 * mtot_small + 9
    model._mtot_floor = mtot_big
    off = (mtot_big - mtot_small) // 2
    V_big = prng.integers(0, 2, (T, mtot_big)) * 2.0 - 1
    V_big[:, off:off + mtot_small] = V_small
    g_floored = model.compute_gradients(
        trace_samples=T, cg_tol=1e-10,
        probes=(Z, torch.as_tensor(V_big))).numpy()
    assert model.last_gradient_stats["mtot"] == mtot_big
    assert np.allclose(g_fresh, g_floored, rtol=1e-6, atol=1e-8)


def test_sample_posterior(rng):
    x, y = make_data(rng, n=80, d=1, lengthscale=0.3)
    model = _model(x, y, [0.3, 1.0, 0.1], eps=1e-4)
    xnew = np.linspace(0.2, 0.8, 12)
    samples = model.sample_posterior(
        xnew, nsamples=4000, generator=torch.Generator().manual_seed(2))
    assert samples.shape == (12, 4000)
    mo, vo = dense_gp_posterior(JaxSE(lengthscale=0.3, variance=1.0,
                                      dimension=1), x, y, 0.1,
                                jnp.asarray(xnew)[:, None])
    assert np.max(np.abs(samples.mean(axis=1) - mo)) < 0.1
    assert np.max(np.abs(samples.var(axis=1) - vo)) < 0.2 * np.max(vo) + 0.01


def test_log_marginal_slq(rng):
    x, y = make_data(rng, n=80, d=1, lengthscale=0.3)
    model = _model(x, y, [0.3, 1.0, 0.1], eps=1e-4,
                   opts={"log_marginal_probes": 200,
                         "log_marginal_steps": 30, "cg_tolerance": 1e-10})
    lm = float(model.log_marginal(generator=torch.Generator().manual_seed(1)))
    K = model.kernel.kernel_matrix(torch.as_tensor(np.asarray(x)),
                                   torch.as_tensor(np.asarray(x))).numpy()
    C = K + 0.1 * np.eye(80)
    _, logdet = np.linalg.slogdet(C)
    want = -0.5 * (logdet + np.asarray(y) @ np.linalg.solve(C, np.asarray(y))
                   + 80 * np.log(2 * np.pi))
    assert abs(lm - want) / abs(want) < 0.05, (lm, want)
    mean, var, lm2 = model.predict(np.linspace(0, 1, 5),
                                   return_variance=False,
                                   compute_log_marginal=True)
    assert var is None and mean.shape == (5,) and np.isfinite(float(lm2))


def test_estimated_start_and_string_kernel(rng):
    x, y = make_data(rng, n=100, d=2)
    model = EFGP(np.asarray(x), np.asarray(y), "SE", eps=1e-3, device="cpu")
    l, v, nv = gpquad_torch.make_kernel("SE", 2).estimate_hyperparameters(
        torch.as_tensor(np.asarray(x)), torch.as_tensor(np.asarray(y)))
    np.testing.assert_allclose(model.params.pos.numpy(),
                               [float(l), float(v), float(nv)], rtol=1e-15)
    mean, var = model.predict(np.asarray(x)[:10], hutchinson_probes=32)
    assert mean.shape == (10,) and var.shape == (10,)
    # Matérn starts from the median distance itself (SE from half of it)
    matern = EFGP(np.asarray(x), np.asarray(y), "Matern32", eps=1e-3,
                  device="cpu")
    assert matern.kernel.nu == 1.5
    np.testing.assert_allclose(float(matern.params.pos[0]), 2 * float(l),
                               rtol=1e-15)
    with pytest.raises(ValueError, match="Unsupported optimizer"):
        model.optimize_hyperparameters(optimizer="sgd", max_iters=1)


def test_facade_fails_without_card(rng):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x, y = make_data(rng, n=20, d=1)
    with pytest.raises(RuntimeError, match="cuda"):
        EFGP(np.asarray(x), np.asarray(y), "SE", sigmasq=0.1)
