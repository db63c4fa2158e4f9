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
from gpquad.quadrature import spectral_grid
import gpquad_torch
from gpquad_torch import convert
from gpquad_torch.models import efgp as tefgp

# The parity problems are small: torch's intra-op threads cost more than
# they give on them, most of all beside other test processes.
torch.set_num_threads(1)

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
    """kron (also 'adaptive' at n >= M) runs and keeps its factors on the
    state; precond_rank runs the deflation preconditioner and keeps its
    block on the state; the "regular" and "chebyshev" variances run and an
    unknown method raises."""
    x, y, xq = data
    tk = gpquad_torch.make_kernel("SE", 2, lengthscale=0.3, variance=1.0)
    betas = []
    for kw in (dict(precond="kron"), dict(precond="adaptive")):
        st = gpquad_torch.fit(x[:200], y[:200], tk, 0.1, solver="cg",
                              cg_tol=1e-10, device="cpu", **kw)
        assert st.kron is not None and st.defl_P is None
        assert len(st.kron.Us) == 2 and st.kron.denom.shape == (st.mtot,) * 2
        betas.append(st.beta.numpy())
    np.testing.assert_array_equal(betas[0], betas[1])
    st = gpquad_torch.fit(x[:200], y[:200], tk, 0.1, solver="cg",
                          precond_rank=16, device="cpu")
    assert st.defl_idx.shape == (16,) and st.defl_P.shape == (16, 16)
    assert tefgp.resolve_precond("deflation", 0, True, 2) == "deflation"
    assert tefgp.resolve_precond("adaptive", 0, True, 2, n=10, M=100) == \
        "deflation"
    # gpquad's known quirk (ROADMAP §C): 'kron' at d > 3 becomes Jacobi
    assert tefgp.resolve_precond("kron", 0, True, 4) == "jacobi"
    st = gpquad_torch.fit(x[:200], y[:200], tk, 0.1, eps=1e-3, device="cpu")
    # the exact and the Chebyshev variances are ported
    # (tests/test_torch_variance.py holds them against gpquad)
    for method in ("regular", "chebyshev"):
        var = gpquad_torch.predict_var(st, xq, method=method)
        assert var.shape == (len(xq),) and bool(torch.all(var >= 0))
    with pytest.raises(ValueError):
        gpquad_torch.predict_var(st, xq, method="exact")


@pytest.mark.parametrize("option", ["ws_mask", "fft_smooth"])
def test_fit_with_grid_options_match(data, option):
    """fit_with_grid's ``ws_mask`` (a grid padded past the planned one, the
    surplus nodes masked) and ``fft_smooth`` (2,3,5,7-smooth Toeplitz pads)
    against gpquad's, on the CG tier at cg_tol 1e-13: beta 1e-9, the mean
    1e-9 absolute."""
    x, y, xq = data
    x, y = x[:400], y[:400]
    jk, tk = _kernels(np.float64)
    _, h, mtot = spectral_grid(jk, 1e-3, 1.0)
    h, mtot = float(h), int(mtot)
    kw = dict(cg_tol=1e-13, solver="cg")
    if option == "ws_mask":
        hm = (mtot - 1) // 2
        mtot += 8
        mask = np.asarray(jquad_flat_grid_mask(mtot, 2, hm))
        jkw, tkw = dict(ws_mask=jnp.asarray(mask)), dict(ws_mask=mask)
    else:
        jkw = tkw = dict(fft_smooth=True)
    js = jefgp.fit_with_grid(jnp.asarray(x), jnp.asarray(y), jk, SIGMASQ, h,
                             mtot, **kw, **jkw)
    ts = gpquad_torch.fit_with_grid(x, y, tk, SIGMASQ, h, mtot, device="cpu",
                                    **kw, **tkw)
    assert ts.toeplitz.fft_shape == tuple(js.toeplitz.fft_shape)
    assert np.max(np.abs(ts.beta.numpy() - np.asarray(js.beta))) < 1e-9
    jmean = np.asarray(jefgp.predict_mean(js, jnp.asarray(xq)))
    assert np.max(np.abs(gpquad_torch.predict_mean(ts, xq).numpy()
                         - jmean)) < 1e-9
    if option == "ws_mask":
        assert np.count_nonzero(np.abs(ts.ws.numpy())) == (mtot - 8) ** 2


def jquad_flat_grid_mask(mtot_pad, d, hm):
    from gpquad.quadrature import flat_grid_mask
    return flat_grid_mask(mtot_pad, d, hm, dtype=jnp.float64)


# ---------------------------------------------------------------------------
# d=3: the slice on both tiers, Jacobi and deflation, and a deflated JAX state
# ---------------------------------------------------------------------------

N3, NQ3, SIG3, ELL3, EPS3 = 300, 40, 0.1, 0.3, 1e-3


@pytest.fixture(scope="module")
def data3():
    rng = np.random.default_rng(17)
    x = rng.uniform(0, 1, (N3, 3))
    y = (np.sin(3 * np.pi * x[:, 0]) * np.cos(2 * np.pi * x[:, 1])
         * np.cos(np.pi * x[:, 2]) + 0.1 * rng.normal(size=N3))
    xq = rng.uniform(0, 1, (NQ3, 3))
    jk = JaxSE(lengthscale=ELL3, variance=1.0, dimension=3)
    _, h, mtot = spectral_grid(jk, EPS3, 1.0)
    return x, y, xq, float(h), int(mtot)


def _slice3_both(data3, **kw):
    x, y, xq, h, mtot = data3
    jk = JaxSE(lengthscale=ELL3, variance=1.0, dimension=3)
    tk = gpquad_torch.make_kernel("SE", 3, lengthscale=ELL3, variance=1.0)
    etas = np.random.default_rng(4).choice([-1.0, 1.0],
                                           size=(16, mtot ** 3))
    js = jefgp.fit_with_grid(jnp.asarray(x), jnp.asarray(y), jk, SIG3, h,
                             mtot, cg_tol=1e-13, **kw)
    ts = gpquad_torch.fit_with_grid(x, y, tk, SIG3, h, mtot, cg_tol=1e-13,
                                    device="cpu", **kw)
    vkw = dict(probes=16, cg_tol=1e-13, max_cg_iter=4000)
    jout = (np.asarray(jefgp.predict_mean(js, jnp.asarray(xq))),
            np.asarray(jefgp.predict_var(js, jnp.asarray(xq),
                                         etas=jnp.asarray(etas), **vkw)))
    tout = (gpquad_torch.predict_mean(ts, xq).numpy(),
            gpquad_torch.predict_var(ts, xq, etas=etas, **vkw).numpy())
    return js, ts, jout, tout, etas


@pytest.mark.parametrize("solver,precond_rank", [("dense", 0), ("cg", 0),
                                                 ("cg", 100)])
def test_slice_3d_float64(data3, solver, precond_rank):
    """fit_with_grid -> predict_mean -> predict_var(etas=) at d=3 (mtot 11,
    M 1331) on the dense tier and on the CG tier with Jacobi and with the
    deflation preconditioner, against gpquad: mean 1e-9 absolute, variance
    1e-8 * max|var| (every solve at cg_tol 1e-13)."""
    js, ts, (jm, jv), (tm, tv), _ = _slice3_both(
        data3, solver=solver, precond_rank=precond_rank)
    assert ts.mtot == js.mtot == 11 and ts.d == 3
    assert np.max(np.abs(tm - jm)) < 1e-9
    assert np.max(np.abs(tv - jv)) < 1e-8 * np.max(np.abs(jv))
    assert tm.shape == tv.shape == (NQ3,)
    if precond_rank:
        np.testing.assert_array_equal(ts.defl_idx.numpy(),
                                      np.asarray(js.defl_idx))
        assert np.max(np.abs(ts.defl_P.numpy() - np.asarray(js.defl_P))) \
            < 1e-10 * np.max(np.abs(np.asarray(js.defl_P)))
    else:
        assert ts.defl_idx is None and ts.defl_P is None


def test_deflated_state_carried_across(data3):
    """A JAX deflated CG-tier state loaded through fit_state_from_numpy
    predicts gpquad's mean and variance (the variance solve reuses the
    carried block), and fit_state_to_numpy round-trips a port state."""
    x, y, xq, h, mtot = data3
    js, ts, (jm, jv), _, etas = _slice3_both(data3, solver="cg",
                                              precond_rank=100)
    arrays = {k: np.asarray(getattr(js, k)) for k in
              ("beta", "ws", "h", "sigmasq", "diag_scale", "defl_idx",
               "defl_P", "mean_cg_iters")}
    arrays["fft_kernel"] = np.asarray(js.toeplitz.fft_kernel)
    st = convert.fit_state_from_numpy(arrays, mtot, 3, device="cpu")
    assert st.defl_idx.dtype == torch.int64 and st.A_dense is None
    mean = gpquad_torch.predict_mean(st, xq).numpy()
    var = gpquad_torch.predict_var(st, xq, probes=16, cg_tol=1e-13,
                                   max_cg_iter=4000, etas=etas).numpy()
    assert np.max(np.abs(mean - jm)) < 1e-9
    assert np.max(np.abs(var - jv)) < 1e-8 * np.max(np.abs(jv))

    back = convert.fit_state_to_numpy(ts)
    assert {"defl_idx", "defl_P"} <= set(back)
    assert "A_dense" not in back
    again = convert.fit_state_from_numpy(back, mtot, 3, device="cpu")
    for k in ("beta", "ws", "defl_idx", "defl_P", "diag_scale"):
        assert torch.equal(getattr(again, k), getattr(ts, k)), k
    np.testing.assert_array_equal(
        gpquad_torch.predict_mean(again, xq).numpy(),
        gpquad_torch.predict_mean(ts, xq).numpy())
