"""Port parity for the serving slice end to end: fit -> predict_mean ->
predict_var(stochastic), gpquad_torch (device="cpu") against gpquad.

The same numpy inputs and the same Rademacher probes (``etas``) go to both
sides.  Tolerances:
  - float64: beta and mean 1e-9 absolute, variance 1e-8 * max|var|; both
    sides solve the same systems to ~1e-13, and the CG tier is run to
    cg_tol=1e-13 so that its stopping point does not decide the gap;
  - float32: mean and variance 1e-4 * max|ref|.  Each side's f32 result
    is ~1e-5 of max|var| from its own f64 result here; at sigmasq=0.05 it
    is ~1e-4 on both sides (the variance is a small difference of O(1)
    lag sums), so the noise is 0.5 to keep the bar above that floor.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.kernels import SquaredExponential as JaxSE
from gpquad.models import efgp as jefgp
import gpquad_torch
from gpquad_torch import convert
from gpquad_torch.models import efgp as tefgp

N, NQ, PROBES, SIGMASQ, EPS = 1500, 60, 48, 0.5, 1e-4


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (N, 2))
    y = (np.sin(3 * np.pi * x[:, 0]) * np.cos(2 * np.pi * x[:, 1])
         + 0.1 * rng.normal(size=N))
    xq = rng.uniform(0, 1, (NQ, 2))
    return x, y, xq


def _kernels(dtype):
    jk = JaxSE(lengthscale=jnp.asarray(0.2, dtype),
               variance=jnp.asarray(1.0, dtype), dimension=2)
    tk = gpquad_torch.make_kernel(
        "SE", 2, lengthscale=torch.as_tensor(np.asarray(0.2, dtype)),
        variance=torch.as_tensor(np.asarray(1.0, dtype)))
    return jk, tk


def _slice_both(x, y, xq, dtype, solver, cg_tol):
    jk, tk = _kernels(dtype)
    xj, yj, xqj = (jnp.asarray(a, dtype) for a in (x, y, xq))
    js = jefgp.fit(xj, yj, jk, SIGMASQ, eps=EPS, cg_tol=cg_tol,
                   solver=solver)
    ts = gpquad_torch.fit(torch.as_tensor(np.asarray(x, dtype)),
                          torch.as_tensor(np.asarray(y, dtype)), tk, SIGMASQ,
                          eps=EPS, cg_tol=cg_tol, solver=solver,
                          device="cpu")
    assert ts.mtot == js.mtot
    etas = np.random.default_rng(3).choice([-1.0, 1.0],
                                           size=(PROBES, js.mtot ** 2))
    out = {
        "jax": dict(state=js,
                    mean=np.asarray(jefgp.predict_mean(js, xqj)),
                    var=np.asarray(jefgp.predict_var(
                        js, xqj, probes=PROBES, cg_tol=cg_tol,
                        etas=jnp.asarray(etas)))),
        "torch": dict(state=ts,
                      mean=gpquad_torch.predict_mean(
                          ts, np.asarray(xq, dtype)).numpy(),
                      var=gpquad_torch.predict_var(
                          ts, np.asarray(xq, dtype), probes=PROBES,
                          cg_tol=cg_tol, etas=etas).numpy()),
    }
    return out, etas


@pytest.mark.parametrize("solver,cg_tol", [("dense", 1e-10), ("cg", 1e-13)])
def test_slice_float64(data, solver, cg_tol):
    out, _ = _slice_both(*data, np.float64, solver, cg_tol)
    j, t = out["jax"], out["torch"]
    assert np.max(np.abs(t["state"].beta.numpy()
                         - np.asarray(j["state"].beta))) < 1e-9
    assert np.max(np.abs(t["mean"] - j["mean"])) < 1e-9
    assert np.max(np.abs(t["var"] - j["var"])) < 1e-8 * np.max(np.abs(j["var"]))
    assert t["mean"].shape == (NQ,) and t["var"].shape == (NQ,)


def test_slice_float32(data):
    out, _ = _slice_both(*data, np.float32, "dense", 1e-6)
    j, t = out["jax"], out["torch"]
    assert t["mean"].dtype == np.float32
    assert np.max(np.abs(t["mean"] - j["mean"])) < 1e-4 * np.max(
        np.abs(j["mean"]))
    assert np.max(np.abs(t["var"] - j["var"])) < 1e-4 * np.max(
        np.abs(j["var"]))


def test_state_carried_across(data):
    """A JAX FitState loaded through fit_state_from_numpy predicts JAX's
    mean and variance, and a port state handed to JAX predicts the port's."""
    x, y, xq = data
    out, etas = _slice_both(x, y, xq, np.float64, "dense", 1e-10)
    js, ts = out["jax"]["state"], out["torch"]["state"]
    arrays = {k: np.asarray(getattr(js, k)) for k in
              ("beta", "ws", "h", "sigmasq", "diag_scale", "A_dense",
               "P_dense", "mean_cg_iters")}
    arrays["fft_kernel"] = np.asarray(js.toeplitz.fft_kernel)
    st = convert.fit_state_from_numpy(arrays, js.mtot, js.d, device="cpu")
    mean = gpquad_torch.predict_mean(st, xq).numpy()
    var = gpquad_torch.predict_var(st, xq, probes=PROBES, cg_tol=1e-10,
                                   etas=etas).numpy()
    assert np.max(np.abs(mean - out["jax"]["mean"])) < 1e-9
    assert np.max(np.abs(var - out["jax"]["var"])) < 1e-8 * np.max(
        np.abs(out["jax"]["var"]))

    back = convert.fit_state_to_numpy(ts)
    from gpquad.ops.toeplitz import ToeplitzND
    jstate = jefgp.FitState(
        beta=jnp.asarray(back["beta"]), ws=jnp.asarray(back["ws"]),
        h=jnp.asarray(back["h"]), sigmasq=jnp.asarray(back["sigmasq"]),
        toeplitz=ToeplitzND(fft_kernel=jnp.asarray(back["fft_kernel"]),
                            ns=(ts.mtot,) * 2,
                            fft_shape=back["fft_kernel"].shape),
        mean_cg_iters=jnp.asarray(back["mean_cg_iters"]),
        diag_scale=jnp.asarray(back["diag_scale"]),
        A_dense=jnp.asarray(back["A_dense"]),
        P_dense=jnp.asarray(back["P_dense"]), mtot=ts.mtot, d=2)
    jmean = np.asarray(jefgp.predict_mean(jstate, jnp.asarray(xq)))
    assert np.max(np.abs(jmean - out["torch"]["mean"])) < 1e-9


def test_kernel_from_numpy_roundtrip():
    jk = JaxSE(lengthscale=0.3, variance=2.0, dimension=2)
    tk = convert.kernel_from_numpy("SE", np.asarray(jk.hyper_vector()), 2)
    np.testing.assert_array_equal(tk.hyper_vector().numpy(),
                                  np.asarray(jk.hyper_vector()))
    assert tk.dimension == 2


def test_generator_probes_reproducible(data):
    x, y, xq = data
    tk = gpquad_torch.make_kernel("SE", 2, lengthscale=0.3, variance=1.0)
    st = gpquad_torch.fit(x[:300], y[:300], tk, 0.1, eps=1e-3, device="cpu")
    a = gpquad_torch.predict_var(st, xq, probes=300,
                                 generator=torch.Generator().manual_seed(5))
    b = gpquad_torch.predict_var(st, xq, probes=300,
                                 generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert np.all(np.isfinite(a.numpy())) and a.shape == (NQ,)


def test_default_generator_on_state_device(data):
    """With neither generator nor etas, the probes come from a generator on
    the state's device seeded 0: the same numbers as passing one."""
    x, y, xq = data
    tk = gpquad_torch.make_kernel("SE", 2, lengthscale=0.3, variance=1.0)
    st = gpquad_torch.fit(x[:300], y[:300], tk, 0.1, eps=1e-3, device="cpu")
    a = gpquad_torch.predict_var(st, xq, probes=40)
    b = gpquad_torch.predict_var(
        st, xq, probes=40,
        generator=torch.Generator(device=st.device).manual_seed(0))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_entry_points_fail_without_card(data):
    """device defaults to "cuda" and is never swapped for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x, y, _ = data
    tk = gpquad_torch.make_kernel("SE", 2, lengthscale=0.3, variance=1.0)
    with pytest.raises(RuntimeError, match="cuda"):
        gpquad_torch.fit(x, y, tk, 0.1)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.fit_state_from_numpy({}, 9, 2)


def test_unported_options_raise(data):
    x, y, xq = data
    tk = gpquad_torch.make_kernel("SE", 2, lengthscale=0.3, variance=1.0)
    for kw in (dict(precond="kron"), dict(precond_rank=16),
               dict(precond="adaptive")):
        with pytest.raises(NotImplementedError, match="A.11"):
            gpquad_torch.fit(x[:200], y[:200], tk, 0.1, solver="cg",
                             device="cpu", **kw)
    # gpquad's known quirk (ROADMAP §C): 'kron' at d > 3 becomes Jacobi
    assert tefgp.resolve_precond("kron", 0, True, 4) == "jacobi"
    st = gpquad_torch.fit(x[:200], y[:200], tk, 0.1, eps=1e-3, device="cpu")
    for method in ("regular", "chebyshev"):
        with pytest.raises(NotImplementedError, match="A.8"):
            gpquad_torch.predict_var(st, xq, method=method)
    with pytest.raises(ValueError):
        gpquad_torch.predict_var(st, xq, method="exact")
