"""Port parity for the Polya-Gamma estimators: ``gpquad_torch.models.pg_core``
and ``.pg`` against ``gpquad.models.pg_core`` and ``.pg`` on the same seeded
numpy inputs (JAX on the CPU with x64, the port with ``device="cpu"``).

Tolerances: the likelihood maths to 1e-12 relative; every core function at
d=1, 2 and 3 at cg_tol 1e-13 to 1e-9 relative (the CG iteration counts are
not compared: two float64 PCGs with other FFT and summation orders may stop
an iteration apart); the estimators' 3-iteration histories, with gpquad's
probes recreated from its keys in place of ``_draw_probes``, to 1e-8
relative per entry (torch's and optax's Adam round their bias corrections in
another order), and their predictions to 1e-8; the same predictions from a
gpquad fit carried over by ``convert.pg_state_from_numpy`` to 1e-9;
``predict_latent_high`` against gpquad's float64 oracle on the gpquad fit's
state (what gpquad's own double-word leg is certified against; compiling
that leg at these shapes would take ~20 s) to 1e-8.  The float32 core
against the port's float64 is no worse than 2x gpquad's float32 core
against it (plus 1e-6 of the scale for results at the float32 floor).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.kernels import SquaredExponential as JaxSE
from gpquad.models import pg as jpg
from gpquad.models import pg_core as jc
from gpquad.quadrature import bucket_points, flat_grid_mask, spectral_grid
import gpquad_torch
from gpquad_torch import convert
from gpquad_torch.models import pg as tpg
from gpquad_torch.models import pg_core as tc

torch.set_num_threads(1)

T64 = torch.float64


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / max(1e-300, np.max(np.abs(want)))


def _t(a, dtype=T64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# ---------------------------------------------------------------------------
# likelihood maths
# ---------------------------------------------------------------------------

def test_likelihood_maths_match_gpquad():
    rng = np.random.default_rng(0)
    mean = rng.normal(size=50)
    var = rng.uniform(0.0, 2.0, size=50)
    var[:3] = [0.0, -1e-3, 1e-12]
    c = np.concatenate([[1e-12, 1e-9, 0.0], rng.uniform(0, 5, 47)])
    b = rng.uniform(0.5, 4.0, size=50)
    y = rng.poisson(3.0, size=50).astype(np.float64)
    pairs = [
        (tc.approximate_logistic_gaussian_prob(_t(mean), _t(var)),
         jc.approximate_logistic_gaussian_prob(jnp.asarray(mean),
                                               jnp.asarray(var))),
        (tc.approximate_logistic_gaussian_prob(_t(mean)),
         jc.approximate_logistic_gaussian_prob(jnp.asarray(mean))),
        (tc.negative_binomial_gaussian_mean(_t(mean), _t(var),
                                            total_count=2.5),
         jc.negative_binomial_gaussian_mean(jnp.asarray(mean),
                                            jnp.asarray(var),
                                            total_count=2.5)),
        (tc.pg_omega_expectation(_t(c), _t(b)),
         jc.pg_omega_expectation(jnp.asarray(c), jnp.asarray(b))),
        (tc.expected_log_sigmoid_neg_gaussian(_t(mean), _t(var),
                                              quadrature_nodes=20),
         jc.expected_log_sigmoid_neg_gaussian(jnp.asarray(mean),
                                              jnp.asarray(var),
                                              quadrature_nodes=20)),
        (tc.negative_binomial_total_count_gradient(
            _t(y), _t(mean), _t(var), total_count=1.7, quadrature_nodes=12),
         jc.negative_binomial_total_count_gradient(
             jnp.asarray(y), jnp.asarray(mean), jnp.asarray(var),
             total_count=1.7, quadrature_nodes=12)),
    ]
    for i, (got, want) in enumerate(pairs):
        assert _rel(got.numpy(), want) < 1e-12, i
    for k in (1, 7, 32):
        for got, want in zip(tc._gauss_hermite_normal_rule(k),
                             jc._gauss_hermite_normal_rule(k)):
            assert np.array_equal(got, want)


def test_pg_omega_expectation_limits():
    got = tc.pg_omega_expectation(_t([1e-12, 1e-9, 0.5, 2.0]),
                                  _t([1.0, 2.0, 1.0, 3.0])).numpy()
    assert np.allclose(got, [0.25, 0.5, np.tanh(0.25), 3 * np.tanh(1) / 4])


# ---------------------------------------------------------------------------
# the core at d = 1, 2, 3
# ---------------------------------------------------------------------------

_CASES = {1: dict(n=150, ell=0.35, pad=2), 2: dict(n=300, ell=0.35, pad=2),
          3: dict(n=200, ell=0.8, pad=0)}


@pytest.fixture(scope="module", params=[1, 2, 3], ids=lambda d: f"d{d}")
def core_case(request):
    d = request.param
    cfg = _CASES[d]
    rng = np.random.default_rng(10 + d)
    n = cfg["n"]
    X = rng.uniform(-1, 1, size=(n, d))
    kj = JaxSE(lengthscale=cfg["ell"], variance=1.2, dimension=d)
    kt = gpquad_torch.make_kernel("SE", d, lengthscale=cfg["ell"],
                                  variance=1.2)
    _, h, mtot = spectral_grid(kj, 1e-4, float(np.max(X.max(0) - X.min(0))),
                               trunc_eps=1e-4)
    # a bucketed rung with surplus nodes, masked
    hm = (mtot - 1) // 2
    mtot_b = mtot + 2 * cfg["pad"]
    mask = np.asarray(flat_grid_mask(mtot_b, d, hm, dtype=jnp.float64))
    spj = jc.build_pg_spectral_state(jnp.asarray(X), kj, h, mtot=mtot_b,
                                     ws_mask=jnp.asarray(mask))
    spt = tc.build_pg_spectral_state(_t(X), kt, h, mtot=mtot_b,
                                     ws_mask=_t(mask))
    return dict(d=d, n=n, X=X, h=h, mtot=mtot_b, spj=spj, spt=spt,
                delta=rng.uniform(0.05, 0.3, n), kappa=rng.normal(size=n),
                probes=rng.integers(0, 2, (6, n)) * 2.0 - 1,
                etas=rng.integers(0, 2, (8, mtot_b ** d)) * 2.0 - 1,
                xq=rng.uniform(-0.9, 0.9, size=(37, d)))


def _args(c):
    return ((c["spj"], jnp.asarray(c["X"]), jnp.asarray(c["delta"])),
            (c["spt"], _t(c["X"]), _t(c["delta"])))


def test_spectral_state(core_case):
    c = core_case
    spj, spt = c["spj"], c["spt"]
    assert spt.mtot == spj.mtot and spt.d == spj.d and spt.M == spj.M
    assert _rel(spt.ws2.numpy(), spj.ws2) < 1e-13
    assert _rel(spt.ws.numpy(), spj.ws) < 1e-13
    assert _rel(spt.Dprime.numpy(), spj.Dprime) < 1e-13
    v = np.random.default_rng(0).normal(size=spt.M) + 0j
    assert _rel(spt.toeplitz(_t(v, torch.complex128)).numpy(),
                spj.toeplitz(jnp.asarray(v))) < 1e-12


def test_weighted_toeplitz(core_case):
    c = core_case
    (spj, Xj, dj), (spt, Xt, dt) = _args(c)
    v = np.random.default_rng(1).normal(size=(2, spt.M)) + 0j
    got = tc.weighted_toeplitz(spt, Xt, dt)(_t(v, torch.complex128))
    want = jc.weighted_toeplitz(spj, Xj, dj)(jnp.asarray(v))
    assert _rel(got.numpy(), want) < 1e-12


@pytest.mark.parametrize("tol", [0.0, 1e3], ids=["full", "early_stop"])
def test_estep_pass(core_case, tol):
    c = core_case
    (spj, Xj, dj), (spt, Xt, dt) = _args(c)
    kw = dict(max_iters=3, rho0=0.7, gamma=1e-3, cg_tol=1e-13, tol=tol)
    want = jc.estep_pass(spj, Xj, dj, jnp.asarray(c["kappa"]),
                         jnp.ones(c["n"]), jnp.asarray(c["probes"]), **kw)
    got = tc.estep_pass(spt, Xt, dt, _t(c["kappa"]),
                        torch.ones(c["n"], dtype=T64), _t(c["probes"]), **kw)
    assert got.iters_used == int(want.iters_used) == (3 if tol == 0 else 1)
    for k in ("delta", "mean", "sigma_diag"):
        assert _rel(getattr(got, k).numpy(), getattr(want, k)) < 1e-9, k
    assert abs(float(got.residual) - float(want.residual)) <= 1e-9 * max(
        1.0, float(want.residual))


def test_mstep_gradient(core_case):
    c = core_case
    (spj, Xj, dj), (spt, Xt, dt) = _args(c)
    want = jc.mstep_gradient(spj, Xj, dj, jnp.asarray(c["kappa"]),
                             jnp.asarray(c["probes"]), cg_tol=1e-13)
    got = tc.mstep_gradient(spt, Xt, dt, _t(c["kappa"]), _t(c["probes"]),
                            cg_tol=1e-13)
    for k in ("grad", "term1", "term2", "beta_mean"):
        assert _rel(getattr(got, k).numpy(), getattr(want, k)) < 1e-9, k


def test_beta_and_predictive_mean(core_case):
    c = core_case
    (spj, Xj, dj), (spt, Xt, dt) = _args(c)
    bj, _ = jc.solve_beta_mean(spj, Xj, dj, jnp.asarray(c["kappa"]),
                               cg_tol=1e-13)
    bt, _ = tc.solve_beta_mean(spt, Xt, dt, _t(c["kappa"]), cg_tol=1e-13)
    assert _rel(bt.numpy(), bj) < 1e-9
    assert _rel(tc.predictive_mean(spt, _t(c["xq"]), bt).numpy(),
                jc.predictive_mean(spj, jnp.asarray(c["xq"]), bj)) < 1e-9


def test_exact_variances(core_case):
    c = core_case
    (spj, Xj, dj), (spt, Xt, dt) = _args(c)
    xj, xt = jnp.asarray(c["xq"]), _t(c["xq"])
    want = jc.predictive_variance_exact(spj, Xj, dj, xj, cg_tol=1e-13)
    got = tc.predictive_variance_exact(spt, Xt, dt, xt, cg_tol=1e-13)
    assert _rel(got.numpy(), want) < 1e-9
    # CG in chunks (37 targets, chunks of 8: the last one short)
    got_b = tc.predictive_variance_exact_batched(spt, Xt, dt, xt,
                                                 batch_size=8, cg_tol=1e-13)
    want_b = jc.predictive_variance_exact_batched(spj, Xj, dj, xj,
                                                  batch_size=8, cg_tol=1e-13)
    assert _rel(got_b.numpy(), want_b) < 1e-9
    # the dense tier, one-shot and in chunks, and with a prebuilt system
    A, P, Ds = tc.dense_feature_system(spt, Xt, dt)
    Aj, _, Dsj = jc.dense_feature_system(spj, Xj, dj)
    assert _rel(A.numpy(), Aj) < 1e-12 and _rel(Ds.numpy(), Dsj) < 1e-14
    want_d = jc.predictive_variance_exact_dense(spj, Xj, dj, xj)
    for kw in ({}, dict(batch_size=8), dict(system=(A, P, Ds))):
        got_d = tc.predictive_variance_exact_dense(spt, Xt, dt, xt, **kw)
        assert _rel(got_d.numpy(), want_d) < 1e-9, kw


def test_stochastic_variance(core_case):
    c = core_case
    (spj, Xj, dj), (spt, Xt, dt) = _args(c)
    sj = jc.stochastic_variance_sums(spj, Xj, dj, jnp.asarray(c["etas"]),
                                     cg_tol=1e-13)
    st = tc.stochastic_variance_sums(spt, Xt, dt, _t(c["etas"]),
                                     cg_tol=1e-13)
    assert _rel(st.numpy(), sj) < 1e-9
    assert _rel(tc.evaluate_variance_sums(spt, st, _t(c["xq"])).numpy(),
                jc.evaluate_variance_sums(spj, sj, jnp.asarray(c["xq"]))
                ) < 1e-9


@pytest.mark.parametrize("solver", ["cg", "dense"])
def test_chebyshev_variance(core_case, solver):
    c = core_case
    (spj, Xj, dj), (spt, Xt, dt) = _args(c)
    kw = dict(n_nodes_per_dim=5, cg_tol=1e-13, solver=solver, batch_size=16)
    want = jc.predictive_variance_chebyshev(spj, Xj, dj, np.asarray(c["xq"]),
                                            **kw)
    got = tc.predictive_variance_chebyshev(spt, Xt, dt, _t(c["xq"]), **kw)
    assert _rel(got.numpy(), want) < 1e-9
    nodes, w = tc.chebyshev_lobatto_nodes(-0.7, 0.9, 6)
    pts = np.concatenate([nodes[:2], np.linspace(-0.7, 0.9, 11)])
    assert np.array_equal(tc.barycentric_matrix(nodes, w, pts),
                          jc.barycentric_matrix(nodes, w, pts))


def test_outer_step(core_case):
    """One EM iteration with the M-step probes given: gpquad's are drawn
    inside from its key, recreated here."""
    c = core_case
    d, n = c["d"], c["n"]
    X = c["X"]
    kj = JaxSE(lengthscale=0.4, variance=1.1, dimension=d)
    kt = gpquad_torch.make_kernel("SE", d, lengthscale=0.4, variance=1.1)
    mask = np.asarray(flat_grid_mask(c["mtot"], d, (c["mtot"] - 3) // 2,
                                     dtype=jnp.float64))
    key = jax.random.PRNGKey(5)
    m_probes = np.asarray((jax.random.bernoulli(key, 0.5, (4, n)) * 2 - 1
                           ).astype(jnp.float64))
    import optax
    raw0 = np.log([0.4, 1.1])
    kw = dict(mtot=c["mtot"], e_iters=2, rho0=0.7, gamma=1e-3, e_tol=0.0,
              cg_tol=1e-13)
    want = jc.outer_step(jnp.asarray(X), kj, c["h"], jnp.asarray(mask),
                         jnp.asarray(c["delta"]), jnp.asarray(c["kappa"]),
                         jnp.ones(n), jnp.asarray(c["probes"]), key,
                         jnp.asarray(raw0), optax.adam(0.05).init(
                             jnp.asarray(raw0)), n_m_probes=4, lr=0.05,
                         **kw)
    raw = _t(raw0).clone()
    got = tc.outer_step(_t(X), kt, c["h"], _t(mask), _t(c["delta"]),
                        _t(c["kappa"]), torch.ones(n, dtype=T64),
                        _t(c["probes"]), _t(m_probes), raw,
                        torch.optim.Adam([raw], lr=0.05), **kw)
    for k in ("delta", "mean", "sigma_diag", "m_grad"):
        assert _rel(getattr(got, k).numpy(), getattr(want, k)) < 1e-9, k
    assert got.e_iters_used == int(want.e_iters_used) == 2
    assert _rel(got.raw.numpy(), want.raw) < 1e-12


# ---------------------------------------------------------------------------
# estimators, with gpquad's probes
# ---------------------------------------------------------------------------

def _with_gpquad_draws(est, n, seed):
    """``est`` with its probe draws replaced by gpquad's: the same salts,
    keys fold_in(PRNGKey(seed), salt), drawn at gpquad's padded point count
    and cut to the port's n points (gpquad zeroes the pad)."""
    nb = bucket_points(n)

    def draws(salt, shape):
        rows, cols = shape
        key = jax.random.fold_in(jax.random.PRNGKey(seed), salt)
        z = np.asarray(jax.random.bernoulli(
            key, 0.5, (rows, nb if cols == n else cols)) * 2 - 1)
        return torch.as_tensor(z[:, :cols], dtype=est._rdtype(),
                               device=est._dev())
    est._draw_probes = draws
    return est


def _binary(rng, n):
    X = rng.uniform(-1, 1, size=(n, 2))
    y = (3 * X[:, 0] - 2 * X[:, 1] + 0.5 * rng.normal(size=n) > 0)
    return X, y.astype(int)


def _history_close(hg, hw, rtol=1e-8):
    assert len(hg) == len(hw)
    for rg, rw in zip(hg, hw):
        assert set(rg) == set(rw)
        for k, v in rw.items():
            if k.endswith("cg_iters"):
                continue
            assert abs(rg[k] - v) <= rtol * max(1.0, abs(v)), (k, rg[k], v)


_CLF = dict(max_iter=3, random_state=0, dtype="float64", store_history=True,
            cg_tol=1e-12, lengthscale_init=0.4, e_step_iters=2,
            e_step_tol=0.0, prediction_batch_size=16)


@pytest.fixture(scope="module")
def clf_pair():
    """A classifier fit at n = 1300, not a 1-2-5 rung: gpquad pads it to
    2000 points, the port fits the 1300 as given."""
    rng = np.random.default_rng(3)
    n = 1300
    X, y = _binary(rng, n)
    want = jpg.PolyagammaGPClassifier(**_CLF).fit(X, y)
    got = _with_gpquad_draws(gpquad_torch.PolyagammaGPClassifier(
        device="cpu", **_CLF), n, 0).fit(X, y)
    xq = rng.uniform(-1, 1, size=(40, 2))
    return dict(X=X, y=y, want=want, got=got, xq=xq)


def _gpquad_oracle_moments(est, X, xq):
    """gpquad's float64 dense oracle of a fitted gpquad estimator's latent
    moments (what its predict_latent_high is certified against)."""
    from gpquad.utils import f64_oracles as jorc
    n = X.shape[0]
    sp = est._spectral_state_
    kern = est._make_kernel_obj(est.lengthscale_, est.variance_, X.shape[1])
    obj = jorc.pg_f64_objects(X, est.delta_, kern, float(np.asarray(sp.h)),
                              sp.mtot, hm=est._hm_)
    beta = jorc.pg_beta_mean_f64(obj, np.asarray(est._kappa_t_)[:n])
    return jorc.pg_mean_f64(obj, xq, beta), jorc.pg_var_f64(obj, xq)


def test_classifier_history_matches(clf_pair):
    want, got = clf_pair["want"], clf_pair["got"]
    assert want._delta_t_.shape[0] == 2000 and got._delta_t_.shape[0] == 1300
    _history_close(got.history_, want.history_)
    assert got.history_[0]["e_iters_used"] == 2.0
    assert _rel(got.delta_, want.delta_) < 1e-9
    assert _rel(got.posterior_mean_, want.posterior_mean_) < 1e-9
    assert _rel(got.posterior_var_diag_, want.posterior_var_diag_) < 1e-9
    assert _rel(got.beta_mean_, want.beta_mean_) < 1e-9
    assert _rel(got.m_step_gradient_, want.m_step_gradient_) < 1e-8
    assert got.training_accuracy_ == want.training_accuracy_
    assert list(got.classes_) == list(want.classes_)
    assert got._spectral_state_.mtot == want._spectral_state_.mtot
    assert got._hm_ == want._hm_


@pytest.mark.parametrize("method", ["exact", "stochastic", "chebyshev"])
@pytest.mark.parametrize("solver", ["auto", "cg"])
def test_classifier_predictions_match(clf_pair, method, solver):
    want, got, xq = clf_pair["want"], clf_pair["got"], clf_pair["xq"]
    for est in (want, got):
        est.predictive_variance_method = method
        est.prediction_solver = solver
        est._est_sums_ = est._dense_system_ = None
    assert _rel(got.decision_function(xq), want.decision_function(xq)) < 1e-8
    assert _rel(got.predictive_variance(xq),
                want.predictive_variance(xq)) < 1e-8
    assert _rel(got.predict_proba(xq), want.predict_proba(xq)) < 1e-8
    assert np.array_equal(got.predict(xq), want.predict(xq))
    X = clf_pair["X"]
    assert np.array_equal(got.decision_function(X), got.posterior_mean_)


def test_predict_latent_high_matches(clf_pair):
    want, got, xq = clf_pair["want"], clf_pair["got"], clf_pair["xq"]
    mw, vw = _gpquad_oracle_moments(want, clf_pair["X"], xq)
    mg, vg = got.predict_latent_high(xq)
    assert _rel(mg, mw) < 1e-8 and _rel(vg, vw) < 1e-8
    mg2, vg2 = got.predict_latent_high(xq, with_var=False)
    assert vg2 is None and np.array_equal(mg2, mg)


def test_predictions_from_a_gpquad_fit(clf_pair):
    want, xq = clf_pair["want"], clf_pair["xq"]
    n = clf_pair["X"].shape[0]
    sp = want._spectral_state_
    arrays = dict(X=clf_pair["X"], delta=want.delta_,
                  beta_mean=want.beta_mean_, lengthscale=want.lengthscale_,
                  variance=want.variance_, h=float(np.asarray(sp.h)),
                  mtot=sp.mtot, hm=want._hm_,
                  kappa=np.asarray(want._kappa_t_)[:n],
                  posterior_mean=want.posterior_mean_,
                  posterior_var_diag=want.posterior_var_diag_,
                  classes=want.classes_)
    got = convert.pg_state_from_numpy(arrays, want.get_params(),
                                      device="cpu")
    assert isinstance(got, gpquad_torch.PolyagammaGPClassifier)
    for method in ("exact", "stochastic", "chebyshev"):
        want.predictive_variance_method = method
        want._est_sums_ = want._dense_system_ = None
        got.predictive_variance_method = method
        # gpquad's pad draws the stochastic etas at M, not at n: same draws
        if method == "stochastic":
            etas = np.asarray(jax.random.bernoulli(
                jax.random.fold_in(jax.random.PRNGKey(0), 2_000_000), 0.5,
                (16, sp.M)) * 2 - 1)
            got._draw_probes = lambda salt, shape: torch.as_tensor(
                etas, dtype=T64)
        assert _rel(got.predictive_variance(xq),
                    want.predictive_variance(xq)) < 1e-9, method
        assert _rel(got.predict_proba(xq), want.predict_proba(xq)) < 1e-9
    assert _rel(got.decision_function(xq), want.decision_function(xq)) < 1e-9
    mw, vw = _gpquad_oracle_moments(want, clf_pair["X"], xq)
    mg, vg = got.predict_latent_high(xq)
    assert _rel(mg, mw) < 1e-9 and _rel(vg, vw) < 1e-9
    with pytest.raises(ValueError, match="kind"):
        convert.pg_state_from_numpy(arrays, kind="poisson", device="cpu")


@pytest.fixture(scope="module")
def nb_pair():
    rng = np.random.default_rng(4)
    n = 200
    X = rng.uniform(-1, 1, size=(n, 1))
    y = rng.poisson(2.0 * np.exp(0.8 * np.sin(3 * X[:, 0])))
    kw = dict(total_count=2.0, learn_total_count=True,
              total_count_update_frequency=1, max_iter=3,
              lengthscale_init=0.4, random_state=0, dtype="float64",
              store_history=True, cg_tol=1e-12)
    want = jpg.PolyagammaGPNegativeBinomialRegressor(**kw).fit(X, y)
    got = _with_gpquad_draws(
        gpquad_torch.PolyagammaGPNegativeBinomialRegressor(device="cpu",
                                                           **kw),
        n, 0).fit(X, y)
    return dict(X=X, y=y, want=want, got=got,
                xq=rng.uniform(-1, 1, size=(30, 1)))


def test_nb_regressor_history_matches(nb_pair):
    want, got = nb_pair["want"], nb_pair["got"]
    _history_close(got.history_, want.history_)
    assert abs(got.total_count_ - want.total_count_) < 1e-9
    assert got.total_count_ != 2.0
    assert got.shape_parameter_ == got.total_count_
    assert (got.training_mean_absolute_error_
            == pytest.approx(want.training_mean_absolute_error_, rel=1e-9))


def test_nb_regressor_predictions_match(nb_pair):
    want, got, xq = nb_pair["want"], nb_pair["got"], nb_pair["xq"]
    assert _rel(got.predict(xq), want.predict(xq)) < 1e-8
    assert _rel(got.predict_mean_count(nb_pair["X"]),
                want.predict_mean_count(nb_pair["X"])) < 1e-9
    n = nb_pair["X"].shape[0]
    sp = want._spectral_state_
    arrays = dict(X=nb_pair["X"], delta=want.delta_,
                  beta_mean=want.beta_mean_, lengthscale=want.lengthscale_,
                  variance=want.variance_, h=float(np.asarray(sp.h)),
                  mtot=sp.mtot, hm=want._hm_,
                  kappa=np.asarray(want._kappa_t_)[:n],
                  total_count=want.total_count_)
    conv = convert.pg_state_from_numpy(arrays, dict(cg_tol=1e-12,
                                                    dtype="float64"),
                                       kind="negative_binomial",
                                       device="cpu")
    assert conv.total_count_ == want.total_count_
    assert _rel(conv.predict(xq), want.predict(xq)) < 1e-9
    yq = np.random.default_rng(8).poisson(2.0, size=xq.shape[0])
    assert got.score(xq, yq) == pytest.approx(want.score(xq, yq), rel=1e-8)


# ---------------------------------------------------------------------------
# float32: the port's core no worse than gpquad's own against float64
# ---------------------------------------------------------------------------

def test_f32_core_no_worse_than_gpquad_f32():
    rng = np.random.default_rng(6)
    n, d = 1000, 2
    X = rng.uniform(-1, 1, size=(n, d))
    delta = rng.uniform(0.05, 0.3, n)
    kappa = rng.integers(0, 2, n) - 0.5
    probes = rng.integers(0, 2, (8, n)) * 2.0 - 1
    xq = rng.uniform(-1, 1, size=(50, d))
    ell = np.float32(0.3)
    kj32 = JaxSE(lengthscale=jnp.float32(ell), variance=jnp.float32(1.5),
                 dimension=d)
    _, h, mtot = spectral_grid(kj32, 1e-4, 2.0, trunc_eps=1e-4)
    h32 = float(np.float32(h))

    def run_port(rd):
        kt = gpquad_torch.make_kernel("SE", d, lengthscale=float(ell),
                                      variance=1.5)
        Xt = _t(X, rd)
        sp = tc.build_pg_spectral_state(Xt, kt, h32, mtot=mtot)
        tol = 1e-6 if rd == torch.float32 else 1e-13
        args = (sp, Xt, _t(delta, rd))
        e = tc.estep_pass(*args, _t(kappa, rd), torch.ones(n, dtype=rd),
                          _t(probes, rd), max_iters=1, rho0=0.7, gamma=1e-3,
                          cg_tol=tol)
        m = tc.mstep_gradient(*args, _t(kappa, rd), _t(probes, rd),
                              cg_tol=tol)
        b, _ = tc.solve_beta_mean(*args, _t(kappa, rd), cg_tol=tol)
        v = tc.predictive_variance_exact_dense(*args, _t(xq, rd))
        return [np.asarray(t, np.float64) for t in
                (e.mean, m.grad, tc.predictive_mean(sp, _t(xq, rd), b), v)]

    def run_gpquad():
        Xj = jnp.asarray(X, jnp.float32)
        sp = jc.build_pg_spectral_state(Xj, kj32, jnp.float32(h32),
                                        mtot=mtot)
        args = (sp, Xj, jnp.asarray(delta, jnp.float32))
        k32 = jnp.asarray(kappa, jnp.float32)
        p32 = jnp.asarray(probes, jnp.float32)
        e = jc.estep_pass(*args, k32, jnp.ones(n, jnp.float32), p32,
                          max_iters=1, rho0=0.7, gamma=1e-3, cg_tol=1e-6)
        m = jc.mstep_gradient(*args, k32, p32, cg_tol=1e-6)
        b, _ = jc.solve_beta_mean(*args, k32, cg_tol=1e-6)
        v = jc.predictive_variance_exact_dense(*args, jnp.asarray(
            xq, jnp.float32))
        return [np.asarray(t, np.float64) for t in
                (e.mean, m.grad, jc.predictive_mean(
                    sp, jnp.asarray(xq, jnp.float32), b), v)]

    ref = run_port(torch.float64)
    port, gpq = run_port(torch.float32), run_gpquad()
    for name, r, p, g in zip(("estep mean", "mstep grad", "mean", "var"),
                             ref, port, gpq):
        scale = np.max(np.abs(r))
        ep, eg = np.max(np.abs(p - r)), np.max(np.abs(g - r))
        assert ep <= 2 * eg + 1e-6 * scale, (name, ep, eg, scale)


# ---------------------------------------------------------------------------
# the estimator contract and its errors (tests/test_pg.py on the port)
# ---------------------------------------------------------------------------

def _clf(**kw):
    return gpquad_torch.PolyagammaGPClassifier(device="cpu", **kw)


def test_classifier_sklearn_contract():
    rng = np.random.default_rng(0)
    X, y = _binary(rng, 150)
    clf = _clf(max_iter=5, random_state=0, dtype="float64").fit(X, y)
    assert list(clf.classes_) == [0, 1]
    assert clf.n_features_in_ == 2
    proba = clf.predict_proba(X[:10])
    assert proba.shape == (10, 2) and np.allclose(proba.sum(axis=1), 1.0)
    assert set(clf.predict(X[:10])).issubset({0, 1})
    assert clf.decision_function(X).shape == (150,)
    assert clf.predictive_variance(X).shape == (150,)
    assert clf.history_[-1]["iter"] == 5.0
    assert len(clf.history_) == 1          # store_history=False
    assert 0.8 < clf.score(X, y) <= 1.0
    # string labels, as sklearn's classifiers take them
    ys = np.where(y == 1, "pos", "neg")
    cs = _clf(max_iter=2, random_state=0, dtype="float64").fit(X, ys)
    assert set(cs.predict(X[:20])).issubset({"neg", "pos"})


def test_params_protocol():
    clf = _clf(max_iter=4, lr=0.1)
    params = clf.get_params()
    assert params["max_iter"] == 4 and params["lr"] == 0.1
    assert params["device"] == "cpu" and params["prefetch_rungs"] is False
    assert set(params) == set(jpg.PolyagammaGPClassifier().get_params())
    clone = gpquad_torch.PolyagammaGPClassifier(**params)
    assert clone.get_params() == params
    assert clf.set_params(max_iter=7) is clf and clf.max_iter == 7
    with pytest.raises(ValueError, match="Invalid parameter"):
        clf.set_params(bogus=1)
    reg = gpquad_torch.PolyagammaGPNegativeBinomialRegressor(
        total_count=2.0, max_iter=3, device="cpu")
    rp = reg.get_params()
    assert rp["total_count"] == 2.0 and rp["max_iter"] == 3
    assert {"learn_total_count", "kernel", "cg_tol"} <= set(rp)
    assert "PolyagammaGPClassifier(" in repr(clf)


def test_classifier_reproducible_and_prefetch_inert():
    rng = np.random.default_rng(1)
    X, y = _binary(rng, 150)
    a = _clf(max_iter=4, random_state=7, dtype="float64").fit(X, y)
    b = _clf(max_iter=4, random_state=7, dtype="float64",
             prefetch_rungs=True).fit(X, y)
    assert np.array_equal(a.delta_, b.delta_)
    assert a.lengthscale_ == b.lengthscale_
    Xt = rng.uniform(-1, 1, size=(20, 2))
    assert np.array_equal(a.predict_proba(Xt), b.predict_proba(Xt))
    c = _clf(max_iter=4, random_state=8, dtype="float64").fit(X, y)
    assert not np.array_equal(a.delta_, c.delta_)


def test_errors():
    rng = np.random.default_rng(2)
    X = rng.uniform(size=(30, 2))
    with pytest.raises(ValueError):
        _clf(max_iter=1).fit(X, rng.integers(0, 3, size=30))
    X1 = rng.uniform(size=(20, 1))
    NB = gpquad_torch.PolyagammaGPNegativeBinomialRegressor
    with pytest.raises(ValueError):
        NB(max_iter=1, device="cpu").fit(X1, -np.ones(20))
    with pytest.raises(ValueError):
        NB(max_iter=1, device="cpu").fit(X1, np.full(20, 0.5))
    with pytest.raises(ValueError):
        NB(total_count=-1.0, max_iter=1, device="cpu").fit(X1, np.ones(20))
    with pytest.raises(ValueError):
        NB(total_count_update_frequency=0, max_iter=1, device="cpu").fit(
            X1, np.ones(20))
    Xb, yb = _binary(rng, 50)
    with pytest.raises(ValueError, match="Unknown kernel"):
        _clf(kernel="nope").fit(Xb, yb)
    with pytest.raises(ValueError):
        _clf(max_iter=1).fit(Xb[:, 0], yb)            # 1-D X
    with pytest.raises(ValueError):
        _clf(max_iter=1).fit(Xb, yb[:-1])             # lengths differ
    with pytest.raises(tpg.NotFittedError):
        _clf().predict(Xb)
    clf = _clf(max_iter=1, random_state=0, dtype="float64").fit(Xb, yb)
    xq = rng.uniform(size=(5, 2))
    clf.predictive_variance_method = "bogus"
    with pytest.raises(ValueError):
        clf.predictive_variance(xq)
    clf.predictive_variance_method = "exact"
    clf.prediction_solver = "nope"
    with pytest.raises(ValueError):
        clf.predictive_variance(xq)
    clf.prediction_solver = "auto"
    clf.predictive_variance_method = "stochastic"
    clf.predictive_variance_probes = 0
    with pytest.raises(ValueError):
        clf.predictive_variance(xq)


def test_dense_prediction_solver_guard(core_case, monkeypatch):
    c = core_case
    (_, _, _), (spt, Xt, dt) = _args(c)
    monkeypatch.setattr(tc, "DENSE_SOLVER_MAX_M", spt.M - 1)
    with pytest.raises(ValueError, match="dense prediction solver"):
        tc.predictive_variance_exact_dense(spt, Xt, dt, _t(c["xq"]))


def test_matern_estimator_and_estep_early_stop():
    rng = np.random.default_rng(5)
    X = rng.uniform(-1, 1, (160, 2))
    y = (rng.uniform(size=160)
         < 1 / (1 + np.exp(-3 * np.sin(2 * X[:, 0])))).astype(float)
    clf = _clf(kernel="Matern32", max_iter=2, lr=0.0, lengthscale_init=0.5,
               random_state=0, dtype="float64", spectral_eps=1e-6).fit(X, y)
    p = clf.predict_proba(rng.uniform(-1, 1, (32, 2)))[:, 1]
    assert np.all((p > 0) & (p < 1))
    assert clf.lengthscale_ == 0.5                 # lr 0 keeps the hypers
    base = dict(max_iter=2, e_step_iters=3, random_state=0, dtype="float64",
                store_history=True)
    a = _clf(e_step_tol=0.0, **base).fit(X, y)
    b = _clf(e_step_tol=1e6, **base).fit(X, y)
    assert a.history_[0]["e_iters_used"] == 3.0
    assert b.history_[0]["e_iters_used"] == 1.0


def test_estimators_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rng = np.random.default_rng(7)
    X, y = _binary(rng, 40)
    with pytest.raises(RuntimeError, match="cuda"):
        gpquad_torch.PolyagammaGPClassifier(max_iter=1).fit(X, y)
    with pytest.raises(RuntimeError, match="cuda"):
        gpquad_torch.PolyagammaGPNegativeBinomialRegressor(max_iter=1).fit(
            X[:, :1], np.ones(40))
