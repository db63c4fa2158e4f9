"""Port parity for the samplers: ``gpquad_torch.models.sampling`` against
``gpquad.models.sampling`` (JAX on the CPU with x64, the port on the CPU).

Each sampler runs with gpquad's own normal and uniform draws put in place of
the port's (``sampling._normal`` / ``_uniform`` replaced by draws from
gpquad's keys, split as gpquad splits them) and agrees with gpquad's output
within 1e-10 of its max; then gpquad's statistical tests
(tests/test_sampling.py) run on the port with its own generator, at their
sizes and bars.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpquad
from gpquad.kernels import SquaredExponential as JaxSE
from gpquad.models import sampling as jsamp
import gpquad_torch
from gpquad_torch.kernels import SquaredExponential
from gpquad_torch.models import sampling as tsamp

torch.set_num_threads(1)

T64 = torch.float64


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / max(1e-300, np.max(np.abs(want)))


@pytest.fixture
def gpquad_draws(monkeypatch):
    """Replace the port's draws by gpquad's: ``feed(kind, key)`` queues a
    draw (``"normal"`` or ``"uniform"``) from a JAX key, made at the shape
    and dtype the port asks for."""
    queue = []

    def draw(kind):
        def fn(generator, shape, dtype, device):
            want, key = queue.pop(0)
            assert want == kind
            jdt = jnp.float64 if dtype == T64 else jnp.float32
            a = (jax.random.normal if kind == "normal" else
                 jax.random.uniform)(key, tuple(shape), dtype=jdt)
            return torch.as_tensor(np.array(a)).to(device)
        return fn

    monkeypatch.setattr(tsamp, "_normal", draw("normal"))
    monkeypatch.setattr(tsamp, "_uniform", draw("uniform"))
    yield lambda kind, key: queue.append((kind, key))
    assert not queue


def test_dense_samplers_match_gpquad(gpquad_draws):
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (30, 1))
    key = jax.random.PRNGKey(3)
    jk = JaxSE(lengthscale=0.4, variance=1.5, dimension=1)
    tk = SquaredExponential(lengthscale=0.4, variance=1.5, dimension=1)
    want = jsamp.sample_gp_dense(key, jnp.asarray(x), jk,
                                 noise_variance=0.05, num_samples=5)
    gpquad_draws("normal", key)
    got = tsamp.sample_gp_dense(None, torch.as_tensor(x), tk,
                                noise_variance=0.05, num_samples=5,
                                device="cpu")
    assert got.shape == want.shape and _rel(got, want) < 1e-10

    x2 = rng.uniform(0, 1, (40, 2))
    want = jsamp.sample_gp_matern(key, jnp.asarray(x2), nu=1.5,
                                  lengthscale=0.3, variance=2.0)
    gpquad_draws("normal", key)
    got = tsamp.sample_gp_matern(None, torch.as_tensor(x2), nu=1.5,
                                 lengthscale=0.3, variance=2.0, device="cpu")
    assert got.shape == want.shape and _rel(got, want) < 1e-10


@pytest.mark.parametrize("d,n,S", [(1, 400, 1), (1, 400, 3), (2, 300, 4)])
def test_spectral_sampler_matches_gpquad(gpquad_draws, d, n, S):
    rng = np.random.default_rng(d * 10 + S)
    x = rng.uniform(0, 1, (n, d))
    mean = rng.normal(size=n)
    key = jax.random.PRNGKey(7)
    want = jsamp.sample_gp_spectral(key, jnp.asarray(x), lengthscale=0.15,
                                    variance=1.3, num_samples=S,
                                    mean=jnp.asarray(mean))
    for k in jax.random.split(key):
        gpquad_draws("normal", k)
    got = tsamp.sample_gp_spectral(None, torch.as_tensor(x), lengthscale=0.15,
                                   variance=1.3, num_samples=S,
                                   mean=mean, device="cpu")
    assert got.shape == want.shape and _rel(got, want) < 1e-10


def test_bernoulli_samplers_match_gpquad(gpquad_draws):
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (80, 1))
    key = jax.random.PRNGKey(4)
    kf, kb = jax.random.split(key)
    y_j, f_j = jsamp.sample_bernoulli_gp(key, jnp.asarray(x),
                                         lengthscale=0.3)
    gpquad_draws("normal", kf)
    gpquad_draws("uniform", kb)
    y_t, f_t = tsamp.sample_bernoulli_gp(None, torch.as_tensor(x),
                                         lengthscale=0.3, device="cpu")
    assert _rel(f_t, f_j) < 1e-10
    assert np.array_equal(y_t.numpy(), np.asarray(y_j))

    y_j, f_j = jsamp.sample_bernoulli_gp_spectral(key, jnp.asarray(x),
                                                  lengthscale=0.2,
                                                  variance=2.0)
    for k in jax.random.split(kf):
        gpquad_draws("normal", k)
    gpquad_draws("uniform", kb)
    y_t, f_t = tsamp.sample_bernoulli_gp_spectral(
        None, torch.as_tensor(x), lengthscale=0.2, variance=2.0,
        device="cpu")
    assert _rel(f_t, f_j) < 1e-10
    assert np.array_equal(y_t.numpy(), np.asarray(y_j))
    assert set(np.unique(y_t.numpy())) <= {0.0, 1.0}


@pytest.fixture(scope="module")
def pathwise_fits():
    """gpquad's pathwise test problem (tests/test_sampling.py:64-77), fit
    by gpquad and by the port."""
    rng = np.random.default_rng(0)
    n = 120
    x = rng.uniform(0, 1, (n, 1))
    y = np.sin(6 * x[:, 0]) + 0.2 * rng.normal(size=n)
    xq = np.linspace(0.05, 0.95, 7)[:, None]
    jk = JaxSE(lengthscale=0.2, variance=1.0, dimension=1)
    tk = SquaredExponential(lengthscale=0.2, variance=1.0, dimension=1)
    js = gpquad.fit(jnp.asarray(x), jnp.asarray(y), jk, 0.05, eps=1e-5,
                    cg_tol=1e-10)
    ts = gpquad_torch.fit(x, y, tk, 0.05, eps=1e-5, cg_tol=1e-10,
                          device="cpu")
    return dict(x=x, y=y, xq=xq, js=js, ts=ts)


def test_pathwise_sampler_matches_gpquad(gpquad_draws, pathwise_fits):
    p = pathwise_fits
    key = jax.random.PRNGKey(0)
    want = jsamp.sample_posterior_pathwise(
        jnp.asarray(p["x"]), jnp.asarray(p["y"]), p["js"],
        jnp.asarray(p["xq"]), key, num_samples=6, cg_tol=1e-12)
    for k in jax.random.split(key, 3):
        gpquad_draws("normal", k)
    got = tsamp.sample_posterior_pathwise(p["x"], p["y"], p["ts"], p["xq"],
                                          num_samples=6, cg_tol=1e-12)
    assert got.shape == want.shape and _rel(got, want) < 1e-10


@pytest.mark.parametrize("cap,converged", [(1000, True), (2, False)])
def test_pathwise_draw_reports_its_residual(pathwise_fits, cap, converged):
    """``_pathwise_draw``'s third output is each draw's final CG residual
    relative to its right-hand side: below cg_tol when the CG stopped
    before its cap, above it when the cap cut the solve; the samples are
    the public sampler's."""
    p = pathwise_fits
    st = p["ts"]
    x, xq = torch.as_tensor(p["x"]), torch.as_tensor(p["xq"])
    y = torch.as_tensor(p["y"])

    def gen():
        return torch.Generator().manual_seed(3)
    samples, iters, rel = tsamp._pathwise_draw(
        x, y, st.ws, st.sigmasq, st.toeplitz, st.h, xq, gen(),
        mtot=st.mtot, num_samples=5, cg_tol=1e-8, max_cg_iter=cap)
    assert rel.shape == (5,) and bool(torch.all(rel < 1e-8)) == converged
    assert (int(iters) < cap) == converged
    public = tsamp.sample_posterior_pathwise(x, y, st, xq, gen(),
                                             num_samples=5, cg_tol=1e-8,
                                             max_cg_iter=cap)
    assert torch.equal(samples, public)


# ---------------------------------------------------------------------------
# gpquad's statistical tests (tests/test_sampling.py) on the port
# ---------------------------------------------------------------------------

def test_dense_sampler_covariance():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(0, 1, size=(30, 1)))
    k = SquaredExponential(lengthscale=0.4, variance=1.5, dimension=1)
    S = gpquad_torch.sample_gp_dense(torch.Generator().manual_seed(0), x, k,
                                     noise_variance=0.05, num_samples=20000,
                                     device="cpu")
    emp = np.cov(S.numpy())
    want = k.kernel_matrix(x, x).numpy() + 0.05 * np.eye(30)
    assert np.max(np.abs(emp - want)) < 0.12


def test_matern_sampler_runs():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(0, 1, size=(40, 2)))
    s = gpquad_torch.sample_gp_matern(torch.Generator().manual_seed(1), x,
                                      nu=1.5, num_samples=3, device="cpu")
    assert s.shape == (40, 3)
    s1 = gpquad_torch.sample_gp_matern(torch.Generator().manual_seed(1), x,
                                       nu=2.5, device="cpu")
    assert s1.shape == (40,)


def test_spectral_sampler_covariance():
    """Empirical covariance of spectral draws ~ the SE kernel matrix, to MC
    accuracy."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(0, 1, size=(25, 1)))
    k = SquaredExponential(lengthscale=0.3, variance=1.0, dimension=1)
    S = gpquad_torch.sample_gp_spectral(
        torch.Generator().manual_seed(2), x, lengthscale=0.3, variance=1.0,
        num_samples=30000, spectral_eps=1e-6, trunc_eps=1e-6, device="cpu")
    assert S.shape == (25, 30000)
    emp = (S @ S.T).numpy() / 30000
    want = k.kernel_matrix(x, x).numpy()
    assert np.max(np.abs(emp - want)) < 0.05, np.max(np.abs(emp - want))


def test_spectral_sampler_2d_shapes():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(0, 1, size=(60, 2)))
    s = gpquad_torch.sample_gp_spectral(torch.Generator().manual_seed(3), x,
                                        lengthscale=0.4, device="cpu")
    assert s.shape == (60,)
    assert torch.isfinite(s).all()


def test_bernoulli_samplers():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(0, 1, size=(80, 1)))
    y, f = gpquad_torch.sample_bernoulli_gp(
        torch.Generator().manual_seed(4), x, lengthscale=0.3, device="cpu")
    assert set(np.unique(y.numpy())) <= {0.0, 1.0}
    assert f.shape == (80,)
    y2, _ = gpquad_torch.sample_bernoulli_gp_spectral(
        torch.Generator().manual_seed(5), x, lengthscale=0.3, device="cpu")
    assert set(np.unique(y2.numpy())) <= {0.0, 1.0}


def test_pathwise_posterior_matches_efgp_posterior(pathwise_fits):
    """Matheron pathwise samples have the EFGP posterior mean and (regular)
    variance, statistically over many samples."""
    p = pathwise_fits
    st = p["ts"]
    mean = gpquad_torch.predict_mean(st, p["xq"]).numpy()
    var = gpquad_torch.predict_var(st, p["xq"], method="regular",
                                   cg_tol=1e-10).numpy()
    S = 4000
    samp = gpquad_torch.sample_posterior_pathwise(
        p["x"], p["y"], st, p["xq"], torch.Generator().manual_seed(0),
        num_samples=S, cg_tol=1e-10).numpy()
    assert samp.shape == (S, 7)
    se_mean = np.sqrt(var / S)
    assert np.all(np.abs(samp.mean(0) - mean) < 5 * se_mean), (
        samp.mean(0), mean, se_mean)
    rel = np.abs(samp.var(0) - var) / var
    assert np.all(rel < 6 * np.sqrt(2.0 / S)), (samp.var(0), var, rel)


def test_samplers_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = torch.rand(10, 1, dtype=T64)
    with pytest.raises(RuntimeError, match="cuda"):
        gpquad_torch.sample_gp_spectral(None, x)
