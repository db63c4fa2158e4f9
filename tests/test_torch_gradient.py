"""Port parity for the hyper-gradient and SLQ: gpquad_torch (device="cpu")
against gpquad, same numpy inputs and the same injected probes (Z, V).

Tolerances:
  - grad 1e-8 relative per component and beta 1e-9 absolute in float64, on
    the dense tier and on the CG tier at cg_tol 1e-12: both sides solve the
    same systems to ~1e-12, so the gap is rounding.  CG iteration fields
    are not compared (ROADMAP §C: two float64 CGs drift apart by rounding
    and stop a few iterations apart).
  - float32 SE gradient within 1e-2 relative per component of the float64
    one: the f32 level of the estimator (bench_full.json records 3.4e-3 for
    SE against a dense f64 oracle; gpquad's own f32 gradient test is
    Matern, which is not ported yet).
  - SLQ estimates (probes drawn from a torch.Generator, so statistical, as
    in gpquad) at the bars of tests/test_gradient.py; the Lanczos
    recurrence itself with a shared q0 at 1e-10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.kernels import SquaredExponential as JaxSE
from gpquad.models import efgp as jefgp
from gpquad.models.gradient import gradient as jax_gradient
from gpquad.models.gradient import gradient_with_grid as jax_gradient_with_grid
from gpquad.ops import slq as jslq
from gpquad.quadrature import padded_grid_mask, spectral_grid
import gpquad_torch
from gpquad_torch import convert
from gpquad_torch.models import efgp as tefgp
from gpquad_torch.ops import slq as tslq

from .test_gradient import _dense_exact_gradient, _dummy_slq_problem

# The parity problems are small: torch's intra-op threads cost more than
# they give on them, most of all beside other test processes.
torch.set_num_threads(1)

SIGMASQ, EPS, T = 0.15, 1e-3, 3


def _data(rng, n, d):
    x = rng.uniform(0, 1, size=(n, d))
    y = np.sin(5 * x[:, 0]) + 0.3 * rng.normal(size=n)
    return x, y


def _kernels(d, dtype=np.float64, lengthscale=0.25, variance=1.3):
    jk = JaxSE(lengthscale=jnp.asarray(lengthscale, dtype),
               variance=jnp.asarray(variance, dtype), dimension=d)
    tk = gpquad_torch.make_kernel("SE", d, lengthscale=lengthscale,
                                  variance=variance)
    return jk, tk


def _probes(rng, n, M, t=T):
    return (rng.integers(0, 2, (t, n)) * 2 - 1.0,
            rng.integers(0, 2, (t, M)) * 2 - 1.0)


def _grid(kernel, x):
    L = float(np.max(x.max(0) - x.min(0)))
    _, h, mtot = spectral_grid(kernel, EPS, L)
    return float(h), int(mtot)


def _run_both(x, y, d, h, mtot, probes, sigmasq=SIGMASQ, jax_kw=None, **kw):
    jk, tk = _kernels(d)
    Z, V = probes
    jres = jax_gradient_with_grid(
        jnp.asarray(x), jnp.asarray(y), jk, sigmasq, h,
        jax.random.PRNGKey(0), mtot=mtot, trace_samples=len(Z),
        probes=(jnp.asarray(Z), jnp.asarray(V)), **(jax_kw or kw))
    tres = gpquad_torch.gradient_with_grid(
        x, y, tk, sigmasq, h, mtot=mtot, trace_samples=len(Z),
        probes=(torch.as_tensor(Z), torch.as_tensor(V)), device="cpu", **kw)
    return jres, tres


def _assert_grad(got, want, rtol=1e-8):
    got, want = np.asarray(got), np.asarray(want)
    rel = np.abs(got - want) / np.abs(want)
    assert np.all(rel < rtol), (got, want, rel)


@pytest.mark.parametrize("d,solver", [(1, "dense"), (2, "dense"),
                                      (1, "cg"), (2, "cg"), (3, "dense"),
                                      (3, "cg")])
def test_gradient_same_probes(rng, d, solver):
    x, y = _data(rng, 80 if d == 1 else 120, d)
    h, mtot = _grid(_kernels(d)[0], x)
    probes = _probes(rng, len(y), mtot ** d)
    jres, tres = _run_both(x, y, d, h, mtot, probes, cg_tol=1e-12,
                           solver=solver)
    _assert_grad(tres.grad.numpy(), jres.grad)
    assert np.max(np.abs(tres.beta.numpy() - np.asarray(jres.beta))) < 1e-9
    assert tres.grad.dtype == torch.float64 and tres.grad.shape == (3,)
    assert np.isnan(float(tres.log_marginal))
    if solver == "dense":
        assert int(tres.trace_cg_iters) == int(jres.trace_cg_iters)


def test_gradient_plans_grid_like_gpquad(rng):
    """``gradient`` plans with the integral method and cg_tol = eps."""
    x, y = _data(rng, 70, 1)
    jk, tk = _kernels(1)
    h, mtot = _grid(jk, x)
    Z, V = _probes(rng, 70, mtot)
    want = jax_gradient(jnp.asarray(x), jnp.asarray(y), jk, SIGMASQ, EPS,
                          jax.random.PRNGKey(0), trace_samples=T,
                          probes=(jnp.asarray(Z), jnp.asarray(V)))
    got = gpquad_torch.gradient(x, y, tk, SIGMASQ, EPS, trace_samples=T,
                                probes=(Z, V), device="cpu")
    _assert_grad(got.grad.numpy(), want.grad)


def test_noise_floor(rng):
    """A binding noise floor solves at the floor (mirror of
    tests/test_gradient.py::test_noise_floor), and equals gpquad's."""
    x, y = _data(rng, 50, 1)
    _, tk = _kernels(1)
    floor = gpquad_torch.gradient(x, y, tk, 1e-8, 1e-3, trace_samples=2,
                                  noise_floor=0.05, cg_tol=1e-8, device="cpu")
    at = gpquad_torch.gradient(x, y, tk, 0.05, 1e-3, trace_samples=2,
                               cg_tol=1e-8, device="cpu")
    np.testing.assert_allclose(floor.grad.numpy(), at.grad.numpy(),
                               rtol=1e-5)
    h, mtot = _grid(_kernels(1)[0], x)
    jres, tres = _run_both(x, y, 1, h, mtot, _probes(rng, 50, mtot, 2),
                           sigmasq=1e-8, cg_tol=1e-12, noise_floor=0.05)
    _assert_grad(tres.grad.numpy(), jres.grad)


def test_padded_grid_is_exact(rng):
    """``ws_mask`` on a padded grid gives the tight grid's gradient (mirror
    of tests/test_gradient.py::test_bucketed_padded_grid_is_exact), and
    the padded run equals gpquad's padded run."""
    x, y = _data(rng, 60, 1)
    jk, tk = _kernels(1)
    _, h, mtot = spectral_grid(jk, EPS, 1.0)
    h = float(h)
    hm = (mtot - 1) // 2
    Z, Vt = _probes(rng, 60, mtot)
    tight = gpquad_torch.gradient_with_grid(
        x, y, tk, SIGMASQ, h, mtot=mtot, trace_samples=T, cg_tol=1e-12,
        probes=(Z, Vt), device="cpu")
    mtot_pad = mtot + 6
    _, mask = padded_grid_mask(mtot_pad, hm, h)
    mask = np.array(mask)
    pad_lo = (mtot_pad - mtot) // 2
    Vp = rng.integers(0, 2, (T, mtot_pad)) * 2 - 1.0
    Vp[:, pad_lo:pad_lo + mtot] = Vt
    jres, tres = _run_both(x, y, 1, h, mtot_pad, (Z, Vp), cg_tol=1e-12,
                           ws_mask=mask,
                           jax_kw=dict(cg_tol=1e-12,
                                       ws_mask=jnp.asarray(mask)))
    np.testing.assert_allclose(tres.grad.numpy(), tight.grad.numpy(),
                               rtol=1e-7, atol=1e-8)
    _assert_grad(tres.grad.numpy(), jres.grad)


def test_log_marginal_matches_dense(rng):
    """compute_log_marginal: the SLQ log marginal within 2% of the dense
    float64 value (SLQ at 300 probes, 30 steps; tests/test_gradient.py
    holds the log-determinant alone at 5%)."""
    x, y = _data(rng, 70, 1)
    jk, tk = _kernels(1)
    res = gpquad_torch.gradient(x, y, tk, SIGMASQ, EPS, trace_samples=2,
                                cg_tol=1e-10, compute_log_marginal=True,
                                log_marginal_probes=300,
                                log_marginal_steps=30,
                                generator=torch.Generator().manual_seed(1),
                                device="cpu")
    _, C = _dense_exact_gradient(jk, jnp.asarray(x), jnp.asarray(y),
                                 SIGMASQ, EPS)
    _, logdet = np.linalg.slogdet(C)
    want = (-0.5 * y @ np.linalg.solve(C, y) - 0.5 * logdet
            - 0.5 * len(y) * np.log(2 * np.pi))
    got = float(res.log_marginal)
    assert abs(got - want) / abs(want) < 2e-2, (got, want)


@pytest.mark.parametrize("noise_floor", [None, 0.3])
def test_state_from_jax_fit(rng, noise_floor):
    """``state=`` fed by a JAX FitState through fit_state_from_numpy gives
    JAX's state= gradient.  With a binding noise floor both sides solve
    with the state's un-floored A_dense (gpquad's gradient.py:150 quirk,
    ROADMAP §C): mirrored, not repaired."""
    x, y = _data(rng, 90, 2)
    jk, tk = _kernels(2)
    h, mtot = _grid(jk, x)
    js = jefgp.fit_with_grid(jnp.asarray(x), jnp.asarray(y), jk, SIGMASQ,
                             h, mtot, cg_tol=1e-12)
    arrays = {k: np.asarray(getattr(js, k)) for k in
              ("beta", "ws", "h", "sigmasq", "diag_scale", "A_dense",
               "P_dense", "mean_cg_iters")}
    arrays["fft_kernel"] = np.asarray(js.toeplitz.fft_kernel)
    st = convert.fit_state_from_numpy(arrays, mtot, 2, device="cpu")
    probes = _probes(rng, 90, mtot ** 2)
    jres, tres = _run_both(
        x, y, 2, h, mtot, probes, cg_tol=1e-12, noise_floor=noise_floor,
        state=st, jax_kw=dict(cg_tol=1e-12, noise_floor=noise_floor,
                              state=js))
    _assert_grad(tres.grad.numpy(), jres.grad)
    if noise_floor is not None:
        fresh = gpquad_torch.gradient_with_grid(
            x, y, tk, SIGMASQ, h, mtot=mtot, trace_samples=T, cg_tol=1e-12,
            noise_floor=noise_floor, probes=probes, device="cpu")
        assert not np.allclose(fresh.grad.numpy(), tres.grad.numpy(),
                               rtol=1e-3)


def test_float32_gradient_near_float64(rng):
    """The f32 run casts the float64 hypers to float32 (gradient.py:115-118)
    and stays within 1e-2 relative per component of the f64 gradient."""
    x, y = _data(rng, 400, 2)
    _, tk = _kernels(2)
    h, mtot = _grid(_kernels(2)[0], x)
    probes = _probes(rng, 400, mtot ** 2, 4)
    out = {}
    for dtype in (np.float64, np.float32):
        out[dtype] = gpquad_torch.gradient_with_grid(
            x.astype(dtype), y.astype(dtype), tk, 0.1, h, mtot=mtot,
            trace_samples=4, cg_tol=1e-6, probes=probes, device="cpu")
    r32, r64 = out[np.float32], out[np.float64]
    assert r32.grad.dtype == torch.float32
    assert r32.beta.dtype == torch.complex64
    _assert_grad(r32.grad.double().numpy(), r64.grad.numpy(), rtol=1e-2)


def test_float32_gradient_no_worse_than_gpquad():
    """At the headline configuration (bench.py: n=1e5, SE l=0.1, sigmasq
    0.01, eps 1e-6, T=10, cg_tol 1e-4) the f32 gradient against the f64 one
    with the same probes: the noise-variance component cancels two terms of
    ~n/sigma^2 = 1e7 down to ~7e3, so f32 rounding of the dense solve
    shows there.  gpquad's own f32 gradient reads [6.2e-3, 9.2e-3, 2.7e-2]
    (lengthscale, variance, noise variance) and the port's [1.9e-3, 1.7e-3,
    5.1e-3] on the CPU (printed below).  The port's f32 error stays within
    3e-2 per component, gpquad's level, and no larger than gpquad's own f32
    error on the same inputs."""
    rng = np.random.default_rng(0)
    n = 100_000
    x = rng.uniform(0, 1, (n, 2))
    y = (np.sin(3 * np.pi * x[:, 0]) * np.cos(2 * np.pi * x[:, 1])
         + 0.5 * np.sin(7 * x[:, 0] + 5 * x[:, 1]) + 0.1 * rng.normal(size=n))
    jk = JaxSE(lengthscale=jnp.float32(0.1), variance=jnp.float32(1.0),
               dimension=2)
    tk = gpquad_torch.make_kernel("SE", 2, lengthscale=np.float32(0.1),
                                  variance=np.float32(1.0))
    _, h, mtot = spectral_grid(jk, 1e-6, 1.0)
    h, mtot = float(h), int(mtot)
    Z, V = _probes(rng, n, mtot ** 2, 10)
    kw = dict(mtot=mtot, trace_samples=10, cg_tol=1e-4, max_cg_iter=1000)
    grads = {}
    for dtype in (np.float64, np.float32):
        grads["jax", dtype] = np.asarray(jax_gradient_with_grid(
            jnp.asarray(x, dtype), jnp.asarray(y, dtype), jk, 0.01, h,
            jax.random.PRNGKey(0), probes=(jnp.asarray(Z, dtype),
                                           jnp.asarray(V, dtype)),
            **kw).grad, np.float64)
        grads["torch", dtype] = gpquad_torch.gradient_with_grid(
            x.astype(dtype), y.astype(dtype), tk, 0.01, h, probes=(Z, V),
            device="cpu", **kw).grad.double().numpy()
    rel = {side: np.abs(grads[side, np.float32] - grads[side, np.float64])
           / np.abs(grads[side, np.float64]) for side in ("jax", "torch")}
    print("f32 vs f64 gradient, relative per component "
          "(lengthscale, variance, noise variance):", rel)
    assert np.all(rel["torch"] < 3e-2), rel
    assert np.max(rel["torch"]) <= np.max(rel["jax"]), rel


def test_generator_probe_order(rng):
    """Without ``probes`` the generator gives Z (T, n), then V (T, M)."""
    x, y = _data(rng, 60, 1)
    _, tk = _kernels(1)
    h, mtot = _grid(_kernels(1)[0], x)
    g = torch.Generator().manual_seed(3)
    Z = torch.randint(0, 2, (T, 60), generator=g) * 2 - 1
    V = torch.randint(0, 2, (T, mtot), generator=g) * 2 - 1
    kw = dict(mtot=mtot, trace_samples=T, cg_tol=1e-12, device="cpu")
    drawn = gpquad_torch.gradient_with_grid(
        x, y, tk, SIGMASQ, h, torch.Generator().manual_seed(3), **kw)
    given = gpquad_torch.gradient_with_grid(x, y, tk, SIGMASQ, h,
                                            probes=(Z, V), **kw)
    np.testing.assert_array_equal(drawn.grad.numpy(), given.grad.numpy())


def test_unported_preconditioners_raise(rng):
    """kron, precond_rank, precond='deflation' and 'adaptive' at n < M
    (here n = 40, M = 169: deflation) all reach the Jacobi run's
    gradient."""
    x, y = _data(rng, 40, 2)
    _, tk = _kernels(2)
    grads = []
    for kw in (dict(), dict(precond_rank=16), dict(precond="deflation"),
               dict(precond="adaptive"), dict(precond="kron")):
        grads.append(gpquad_torch.gradient(
            x, y, tk, SIGMASQ, EPS, torch.Generator().manual_seed(0),
            solver="cg", trace_samples=2, cg_tol=1e-10, device="cpu",
            **kw).grad.numpy())
    for g in grads[1:]:
        np.testing.assert_allclose(g, grads[0], rtol=1e-6)


@pytest.mark.parametrize("source", ["rank", "state"])
def test_gradient_deflation_same_probes(rng, source):
    """d=3 on the CG tier with the deflation preconditioner, against gpquad
    with the same probes at 1e-8 relative: built by the gradient itself
    (``precond_rank``, gradient.py:192-201) or carried on a deflated fit's
    state (gradient.py:164-168, the JAX state through fit_state_from_numpy).
    """
    x, y = _data(rng, 120, 3)
    jk, tk = _kernels(3)
    h, mtot = _grid(jk, x)
    probes = _probes(rng, 120, mtot ** 3)
    if source == "rank":
        kw = dict(cg_tol=1e-12, solver="cg", precond_rank=200)
        jax_kw = kw
    else:
        js = jefgp.fit_with_grid(jnp.asarray(x), jnp.asarray(y), jk, SIGMASQ,
                                 h, mtot, cg_tol=1e-12, solver="cg",
                                 precond_rank=200)
        arrays = {k: np.asarray(getattr(js, k)) for k in
                  ("beta", "ws", "h", "sigmasq", "diag_scale", "defl_idx",
                   "defl_P")}
        arrays["fft_kernel"] = np.asarray(js.toeplitz.fft_kernel)
        st = convert.fit_state_from_numpy(arrays, mtot, 3, device="cpu")
        kw = dict(cg_tol=1e-12, state=st)
        jax_kw = dict(cg_tol=1e-12, state=js)
    jres, tres = _run_both(x, y, 3, h, mtot, probes, jax_kw=jax_kw, **kw)
    _assert_grad(tres.grad.numpy(), jres.grad)


def test_kernel_hyper_access():
    jk, tk = _kernels(2)
    assert tk.num_hypers == jk.num_hypers == 3
    assert float(tk.get_hyper("variance")) == float(jk.get_hyper("variance"))
    with pytest.raises(ValueError):
        tk.get_hyper("period")


def test_quadrature_weights_mask(rng):
    jk, tk = _kernels(2)
    xis = rng.uniform(-3, 3, (50, 2))
    mask = (rng.uniform(size=50) > 0.3).astype(np.float64)
    want = jefgp.quadrature_weights(jk, jnp.asarray(xis), jnp.asarray(0.2),
                                    2, mask=jnp.asarray(mask))
    got = tefgp.quadrature_weights(tk, torch.as_tensor(xis),
                                   torch.tensor(0.2, dtype=torch.float64), 2,
                                   mask=torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14)
    assert np.all(got.numpy()[mask == 0] == 0)


# ---------------------------------------------------------------------------
# ops/slq.py
# ---------------------------------------------------------------------------

def test_lanczos_matches_jax(rng):
    """Same q0, same operator (60 distinct eigenvalues, so 12 steps stay
    far from breakdown and loss of orthogonality)."""
    Q, _ = np.linalg.qr(rng.normal(size=(60, 60)))
    A = (Q * np.linspace(1.0, 10.0, 60)) @ Q.T
    q0 = rng.normal(size=(4, 60))
    q0 /= np.linalg.norm(q0, axis=1, keepdims=True)
    ja, jb = jslq.lanczos_tridiag(lambda v: v @ jnp.asarray(A).T,
                                  jnp.asarray(q0), 12)
    ta, tb = tslq.lanczos_tridiag(lambda v: v @ torch.as_tensor(A).T,
                                  torch.as_tensor(q0), 12)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-10,
                               atol=1e-10)


def test_lanczos_breakdown_zero_pads():
    """An invariant subspace of size 2: coefficients after the breakdown
    are exactly zero, as the JAX scan leaves them."""
    A = np.diag([1.0, 2.0, 3.0, 4.0])
    q0 = np.array([[1.0, 1.0, 0.0, 0.0]]) / np.sqrt(2)
    ja, jb = jslq.lanczos_tridiag(lambda v: v @ jnp.asarray(A),
                                  jnp.asarray(q0), 4)
    ta, tb = tslq.lanczos_tridiag(lambda v: v @ torch.as_tensor(A),
                                  torch.as_tensor(q0), 4)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-12)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-12)
    assert np.all(tb.numpy()[0, 1:] == 0) and np.all(ta.numpy()[0, 2:] == 0)


def test_slq_logdet_matches_dense(rng):
    x, y = _data(rng, 70, 1)
    jk, tk = _kernels(1)
    st = gpquad_torch.fit(x, y, tk, SIGMASQ, EPS, cg_tol=1e-10, device="cpu")
    got = float(tslq.logdet_slq(st.ws, st.sigmasq, st.toeplitz,
                                torch.Generator().manual_seed(3),
                                probes=300, steps=30, n=70))
    _, C = _dense_exact_gradient(jk, jnp.asarray(x), jnp.asarray(y),
                                 SIGMASQ, EPS)
    _, want = np.linalg.slogdet(C)
    assert abs(got - want) / abs(want) < 0.05, (got, want)


def test_slq_trace_inv_matches_dense(rng):
    A, _ = _dummy_slq_problem(rng)
    At = torch.as_tensor(np.array(A))
    got = float(tslq.slq_trace_f(lambda v: At @ v,
                                 torch.Generator().manual_seed(0),
                                 At.shape[0], probes=64, steps=30,
                                 dtype=torch.float64))
    want = float(np.trace(np.linalg.inv(np.asarray(A))))
    assert abs(got - want) / abs(want) < 0.02, (got, want)


def test_slq_trace_logdet_matches_dense(rng):
    A, _ = _dummy_slq_problem(rng)
    At = torch.as_tensor(np.array(A))
    got = float(tslq.slq_trace_f(lambda V: V @ At.T,
                                 torch.Generator().manual_seed(1),
                                 At.shape[0], probes=512, steps=30,
                                 f=torch.log, dtype=torch.float64,
                                 batched=True))
    _, want = np.linalg.slogdet(np.asarray(A))
    assert abs(got - want) / max(abs(want), 1.0) < 0.05, (got, want)


def test_power_iteration_matches_dense(rng):
    A, _ = _dummy_slq_problem(rng)
    At = torch.as_tensor(np.array(A))
    got = float(tslq.power_iteration(lambda v: At @ v,
                                     torch.Generator().manual_seed(2),
                                     At.shape[0], iters=30,
                                     dtype=torch.float64))
    want = float(np.linalg.eigvalsh(np.asarray(A)).max())
    assert abs(got - want) / want < 0.01, (got, want)


def test_trace_ainv_b_fd_matches_dense(rng):
    """512 probes (gpquad's test uses 64 with a key that lands inside 5%;
    at 64 probes both packages spread ~8% over seeds), batched operators."""
    A, B = _dummy_slq_problem(rng)
    At, Bt = torch.as_tensor(np.array(A)), torch.as_tensor(np.array(B))
    est, h = tslq.trace_ainv_b_fd(lambda V: V @ At.T, lambda V: V @ Bt.T,
                                  torch.Generator().manual_seed(3),
                                  At.shape[0], probes=512, steps=30,
                                  dtype=torch.float64, batched=True)
    est, h = float(est), float(h)
    want = float(np.trace(np.linalg.solve(np.asarray(A), np.asarray(B))))
    assert h > 0
    assert abs(est - want) / abs(want) < 0.05, (est, want, h)
