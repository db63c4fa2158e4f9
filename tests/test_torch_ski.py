"""Port parity for the SKI baseline: ``gpquad_torch.models.ski`` against
``gpquad.models.ski`` on the same seeded numpy inputs (JAX on the CPU with
x64, the port with ``device="cpu"``).

Tolerances: grid sizes, stencil indices and band tables identical; floats of
the stencils to 1e-14; the operator (interp, interp_T, matvec) to 1e-10
(another summation order); the loss and gradient with JAX's own probes to
1e-8 relative with equal PCG iterations; a 3-iteration Adam history to 1e-6
relative per entry (torch's and optax's Adam round their bias corrections in
another order); predictions from a JAX fit carried across to 1e-8.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.kernels import SquaredExponential as JaxSE
from gpquad.models import ski as jski
import gpquad_torch
from gpquad_torch import convert
from gpquad_torch.models import ski as tski

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _impls():
    yield
    jski.set_interp_impl("auto")
    tski.set_interp_impl("auto")


def _kernels(d, lengthscale=0.3, variance=1.0):
    return (JaxSE(lengthscale=lengthscale, variance=variance, dimension=d),
            gpquad_torch.make_kernel("SE", d, lengthscale=lengthscale,
                                     variance=variance))


def _ops(x, grid, bounds, lengthscale=0.3):
    kj, kt = _kernels(x.shape[1], lengthscale)
    return (jski.build_ski_operator(jnp.asarray(x), kj, grid, bounds),
            tski.build_ski_operator(torch.as_tensor(x), kt, grid, bounds))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / max(1e-300, np.max(np.abs(want)))


@pytest.mark.parametrize("case", range(4))
def test_grid_resolution_helpers(rng, case):
    d = (1, 2, 3, 2)[case]
    x = rng.uniform(-0.5, 2.0, size=(200, d)) * (1 + np.arange(d))
    bounds = tski.resolve_grid_bounds(x)
    assert bounds == jski.resolve_grid_bounds(x)
    given = tuple((-1.0 - t, 3.0 + t) for t in range(d))
    assert tski.resolve_grid_bounds(x, given) == jski.resolve_grid_bounds(
        x, given)
    for target in (900, 4096, 32_768):
        kw = dict(grid_size=None, num_dims=d, target_grid_points=target,
                  grid_bounds=bounds)
        assert tski.resolve_grid_size(**kw) == jski.resolve_grid_size(**kw)
    kw = dict(num_dims=d, target_grid_points=0, grid_bounds=bounds)
    assert tski.resolve_grid_size(grid_size=32, **kw) == (32,) * d
    with pytest.raises(ValueError):
        tski.resolve_grid_size(grid_size=(32,) * (d + 1), **kw)
    with pytest.raises(ValueError):
        tski.resolve_grid_bounds(x, [(0.0, 1.0)] * (d + 1))
    with pytest.raises(ValueError):
        tski.resolve_grid_bounds(x, [(1.0, 1.0)] * d)


def test_cubic_weights(rng):
    t = rng.uniform(0, 1, size=(500,))
    got = tski._cubic_weights(torch.as_tensor(t)).numpy()
    want = np.asarray(jski._cubic_weights(jnp.asarray(t)))
    assert np.max(np.abs(got - want)) < 1e-14
    # partition of unity
    assert np.max(np.abs(got.sum(-1) - 1.0)) < 1e-14


def _clustered(rng, n=2000):
    x = np.zeros((n, 2))
    x[:, 0] = rng.uniform(-0.01, 0.01, n)         # one row band
    x[:, 1] = rng.uniform(-1, 1, n)
    return x


CASES = {
    "d1": (lambda rng: rng.uniform(0, 1, (300, 1)), (40,), None),
    "d2": (lambda rng: rng.uniform(-1, 1, (1500, 2)), (30, 26),
           ((-1.0, 1.0), (-1.0, 1.0))),
    "d2_wide": (lambda rng: rng.uniform(-1, 1, (1200, 2)), (8, 600),
                ((-1.0, 1.0), (-1.0, 1.0))),
    "d3": (lambda rng: rng.uniform(0, 1, (200, 3)), (10, 12, 9), None),
    "clustered": (_clustered, (64, 64), ((-1.0, 1.0), (-1.0, 1.0))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_operator_tables_identical(rng, case):
    make_x, grid, bounds = CASES[case]
    x = make_x(rng)
    bounds = bounds or jski.resolve_grid_bounds(x)
    opj, opt = _ops(x, grid, bounds)
    assert opt.grid_shape == opj.grid_shape
    assert np.array_equal(opt.idx.numpy(), np.asarray(opj.idx))
    assert np.max(np.abs(opt.wvals.numpy() - np.asarray(opj.wvals))) < 1e-14
    assert np.max(np.abs(opt.lo.numpy() - np.asarray(opj.lo))) == 0.0
    assert np.max(np.abs(opt.dx.numpy() - np.asarray(opj.dx))) == 0.0
    assert _rel(opt.toeplitz.fft_kernel.numpy(),
                np.asarray(opj.toeplitz.fft_kernel)) < 1e-12
    if opj.banded is None:
        assert opt.banded is None
        assert case != "d2"
        return
    for field in opj.banded._fields:
        got = getattr(opt.banded, field).numpy()
        want = np.asarray(getattr(opj.banded, field))
        assert got.shape == want.shape, field
        if want.dtype.kind == "f":
            assert np.max(np.abs(got - want)) < 1e-14, field
        else:
            assert np.array_equal(got, want), field


# the route matters only for the banded plan (d=2, not clustered)
@pytest.mark.parametrize("case,impl", [
    (case, impl) for case in sorted(CASES)
    for impl in (("auto", "einsum", "cuda") if case.startswith("d2")
                 else ("auto",))])
def test_operator_matches(rng, case, impl):
    """interp, interp_T (single vector and a batch) and matvec; at d=2
    under each of the port's routes (on the CPU "cuda" runs the kernels'
    plain versions, as gpquad's "pallas" runs its kernels interpreted)."""
    make_x, grid, bounds = CASES[case]
    x = make_x(rng)
    bounds = bounds or jski.resolve_grid_bounds(x)
    opj, opt = _ops(x, grid, bounds)
    jski.set_interp_impl({"auto": "auto", "einsum": "einsum",
                          "cuda": "pallas"}[impl])
    tski.set_interp_impl(impl)
    n = x.shape[0]
    u = rng.normal(size=(3, n))
    v = rng.normal(size=(3, opt.M))
    before = dict(tski.INTERP_PICKS)
    for arg_u, arg_v in ((u, v), (u[0], v[0])):
        assert _rel(opt.interp_T(torch.as_tensor(arg_u)).numpy(),
                    opj.interp_T(jnp.asarray(arg_u))) < 1e-10
        assert _rel(opt.interp(torch.as_tensor(arg_v)).numpy(),
                    opj.interp(jnp.asarray(arg_v))) < 1e-10
    assert _rel(opt.matvec(torch.as_tensor(u), 0.1).numpy(),
                opj.matvec(jnp.asarray(u), 0.1)) < 1e-10
    picks = {k: tski.INTERP_PICKS[k] - before[k] for k in before}
    if opt.banded is None:
        assert picks == {"cuda": 0, "banded": 0, "unbanded": 6}
    elif impl == "cuda":
        assert picks == {"cuda": 6, "banded": 0, "unbanded": 0}
    else:   # the plain banded W^T u, the gather W v, as gpquad off the TPU
        assert picks == {"cuda": 0, "banded": 3, "unbanded": 3}
    # adjointness
    lhs = float(torch.dot(torch.as_tensor(u[0]),
                          opt.interp(torch.as_tensor(v[0]))))
    rhs = float(torch.dot(opt.interp_T(torch.as_tensor(u[0])),
                          torch.as_tensor(v[0])))
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))


def test_set_interp_impl_rejects_unknown():
    with pytest.raises(ValueError):
        tski.set_interp_impl("pallas")


def _jax_probes(key, it, trace_samples, slq_probes, n):
    """gpquad's draws for iteration ``it`` (ski.py:473-474, :508-509)."""
    k = jax.random.fold_in(key, it)
    z = (jax.random.bernoulli(k, 0.5, (trace_samples, n)) * 2 - 1)
    zq = (jax.random.bernoulli(jax.random.fold_in(k, 3), 0.5,
                               (slq_probes, n)) * 2 - 1)
    return np.asarray(z, np.float64), np.asarray(zq, np.float64)


def _data(rng, n, d=2):
    x = rng.uniform(-1, 1, (n, d))
    y = np.sin(3 * x[:, 0]) * np.cos(2 * x[:, -1]) + 0.1 * rng.normal(size=n)
    return x, y


@pytest.mark.parametrize("d,grid", [(2, (24, 22)), (1, (50,))])
def test_loss_and_grad_matches_with_jax_probes(rng, d, grid):
    n = 600 if d == 2 else 300
    x, y = _data(rng, n, d)
    bounds = jski.resolve_grid_bounds(x)
    opj, opt = _ops(x, grid, bounds, lengthscale=0.4)
    kj, kt = _kernels(d, 0.4, 1.2)
    key = jax.random.PRNGKey(5)
    Z, zq = _jax_probes(key, 0, 2, 8, n)
    sig2 = 0.3
    want = jski._ski_loss_and_grad(
        opj.idx, opj.wvals, opj.banded, jnp.asarray(x), jnp.asarray(y), kj,
        jnp.asarray(sig2), jax.random.fold_in(key, 0),
        grid_shape=opj.grid_shape, dx=opj.dx, cg_tol=1e-10, max_cg_iter=500,
        trace_samples=2, slq_probes=8, slq_steps=10)
    got = tski._ski_loss_and_grad(
        opt, torch.as_tensor(y), kt, torch.tensor(sig2, dtype=torch.float64),
        torch.as_tensor(Z), torch.as_tensor(zq), cg_tol=1e-10,
        max_cg_iter=500, slq_steps=10)
    assert int(got[2]) == int(want[2])
    assert abs(float(got[0]) - float(want[0])) < 1e-8 * abs(float(want[0]))
    assert np.all(np.abs(got[1].numpy() - np.asarray(want[1]))
                  < 1e-8 * np.abs(np.asarray(want[1])))
    assert _rel(got[3].numpy(), want[3]) < 1e-8


def _fit_both(rng, monkeypatch, **kw):
    x, y = _data(rng, 500)
    key = jax.random.PRNGKey(2)

    def draws(generator, it, trace_samples, slq_probes, n, dtype, device):
        z, zq = _jax_probes(key, it, trace_samples, slq_probes, n)
        return (torch.as_tensor(z, dtype=dtype, device=device),
                torch.as_tensor(zq, dtype=dtype, device=device))
    monkeypatch.setattr(tski, "_draw_probes", draws)
    common = dict(kernel="SE", grid_size=(20, 18), max_iters=3, lr=0.1,
                  verbose=False, cg_tolerance=1e-8, max_cg_iterations=300,
                  init_lengthscale=0.4, init_noise=0.5, **kw)
    want = jski.fit_ski_gp(x, y, dtype=jnp.float64, key=key, **common)
    got = tski.fit_ski_gp(x, y, dtype=torch.float64, device="cpu", **common)
    return x, y, want, got


def test_fit_history_matches(rng, monkeypatch):
    _, _, want, got = _fit_both(rng, monkeypatch)
    hw, hg = want["history"], got["history"]
    assert set(hg) == set(hw)
    for k in ("loss", "lengthscale", "outputscale", "noise"):
        assert np.all(np.abs(np.array(hg[k]) - np.array(hw[k]))
                      <= 1e-6 * np.abs(np.array(hw[k]))), k
    assert hg["iteration"] == hw["iteration"] == [1, 2, 3]
    # two float64 PCGs with other FFT and summation orders stop within an
    # iteration of each other at 1e-8 (ROADMAP section C, CG drift)
    assert np.all(np.abs(np.array(hg["cg_iters"])
                         - np.array(hw["cg_iters"])) <= 1)
    assert len(hg["rss_gb"]) == 3
    for k in ("num_train", "num_total", "grid_size", "grid_bounds",
              "best_iteration", "dtype", "settings"):
        assert got[k] == want[k], k
    assert abs(got["best_loss"] - want["best_loss"]) < 1e-6 * abs(
        want["best_loss"])
    assert _rel(got["model"]["raw"].numpy(), want["model"]["raw"]) < 1e-6
    assert _rel(got["model"]["alpha"].numpy(), want["model"]["alpha"]) < 1e-5


def _jax_fit_arrays(fit):
    model = fit["model"]
    op = model["operator"]
    arrays = {"idx": op.idx, "wvals": op.wvals, "lo": op.lo, "dx": op.dx,
              "fft_kernel": model["toeplitz"].fft_kernel,
              "alpha": model["alpha"], "raw": model["raw"],
              "hypers": model["kernel"].hyper_vector()}
    if op.banded is not None:
        arrays.update({f"banded_{k}": v
                       for k, v in op.banded._asdict().items()})
    out = {k: np.asarray(v) for k, v in arrays.items()}
    out["grid_shape"] = np.asarray(op.grid_shape)
    out["kernel_name"] = type(model["kernel"]).__name__
    return out


@pytest.mark.parametrize("impl", ["auto", "cuda"])
def test_predict_from_jax_fit(rng, impl):
    """A gpquad fit carried across by ``convert``: mean and variance at new
    points equal gpquad's to 1e-8."""
    x, y = _data(rng, 700)
    want = jski.fit_ski_gp(x, y, grid_size=(22, 22), max_iters=2,
                           verbose=False, dtype=jnp.float64,
                           cg_tolerance=1e-10, max_cg_iterations=300)
    fit = convert.ski_fit_from_numpy(_jax_fit_arrays(want), device="cpu")
    assert fit["model"]["operator"].banded is not None
    tski.set_interp_impl(impl)
    for nq in (300, 5):
        xq = rng.uniform(-1, 1, (nq, 2))
        mean = tski.ski_predict_mean(fit, xq).numpy()
        assert _rel(mean, jski.ski_predict_mean(want, jnp.asarray(xq))) < 1e-8
    xq = rng.uniform(-1, 1, (30, 2))
    var = tski.ski_predict_var(fit, xq, batch_size=16, cg_tol=1e-10).numpy()
    wvar = jski.ski_predict_var(want, jnp.asarray(xq), batch_size=16,
                                cg_tol=1e-10)
    assert var.shape == (30,)
    assert _rel(var, wvar) < 1e-8


def test_predict_mean_gathers_target_stencils(rng):
    """The mean's ``W_* g`` is a gather on the targets' stencils, as
    gpquad's: one banded ``W^T alpha`` and no interpolation route besides."""
    x, y = _data(rng, 700)
    fit = tski.fit_ski_gp(x, y, grid_size=(22, 22), max_iters=1,
                          verbose=False, dtype=torch.float64, device="cpu")
    op, model = fit["model"]["operator"], fit["model"]
    xq = rng.uniform(-1, 1, (300, 2))
    before = dict(tski.INTERP_PICKS)
    mean = tski.ski_predict_mean(fit, xq)
    picks = {k: tski.INTERP_PICKS[k] - before[k] for k in before}
    assert picks == {"cuda": 0, "banded": 1, "unbanded": 0}
    idx, wv = tski._point_stencils(op, xq, torch.float64)
    g = model["toeplitz"](op.interp_T(model["alpha"])).real
    assert torch.equal(mean, torch.sum(g[idx] * wv, dim=-1))


def test_fit_roundtrip_through_numpy(rng):
    x, y = _data(rng, 400)
    fit = tski.fit_ski_gp(x, y, grid_size=(20, 20), max_iters=1,
                          verbose=False, dtype=torch.float64, device="cpu")
    back = convert.ski_fit_from_numpy(convert.ski_fit_to_numpy(fit),
                                      device="cpu")
    xq = rng.uniform(-1, 1, (40, 2))
    assert torch.equal(tski.ski_predict_mean(back, xq),
                       tski.ski_predict_mean(fit, xq))
    op, op2 = fit["model"]["operator"], back["model"]["operator"]
    for field in op.banded._fields:
        assert torch.equal(getattr(op.banded, field),
                           getattr(op2.banded, field))


def test_column_index_is_made_not_read(rng):
    """The fit's arrays carry gpquad's seven band tables and no column
    index; a column index passed in anyway (here out of range and not
    monotone) is not read: the index is made from ``valid`` and ``c0``, so
    the fit predicts exactly as the untouched one."""
    x, y = _data(rng, 400)
    fit = tski.fit_ski_gp(x, y, grid_size=(20, 20), max_iters=1,
                          verbose=False, dtype=torch.float64, device="cpu")
    arrays = convert.ski_fit_to_numpy(fit)
    assert "banded_col_slots" not in arrays
    assert "banded_col_start" not in arrays
    op = fit["model"]["operator"]
    nbands, cap = op.banded.pidx.shape
    tampered = dict(arrays)
    tampered["banded_col_slots"] = np.full((nbands, cap), 10 * cap, np.int32)
    tampered["banded_col_start"] = rng.integers(
        -cap, 3 * cap, (nbands, 21)).astype(np.int32)
    back = convert.ski_fit_from_numpy(tampered, device="cpu")
    for field in op.banded._fields:
        assert torch.equal(getattr(op.banded, field),
                           getattr(back["model"]["operator"].banded, field))
    xq = rng.uniform(-1, 1, (40, 2))
    assert torch.equal(tski.ski_predict_mean(back, xq),
                       tski.ski_predict_mean(fit, xq))


def test_float32_fit_runs_in_float32(rng):
    x, y = _data(rng, 400)
    fit = tski.fit_ski_gp(x, y, grid_size=(20, 20), max_iters=2,
                          verbose=False, device="cpu")
    assert fit["dtype"] == "float32"
    assert fit["model"]["alpha"].dtype == torch.float32
    assert fit["model"]["raw"].dtype == torch.float32
    xq = rng.uniform(-1, 1, (20, 2))
    mean = tski.ski_predict_mean(fit, xq)
    var = tski.ski_predict_var(fit, xq)
    assert mean.dtype == var.dtype == torch.float32
    assert bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all())


def test_fit_validates_inputs():
    with pytest.raises(ValueError):
        tski.fit_ski_gp(np.zeros((10,)), np.zeros(10), device="cpu")
    with pytest.raises(ValueError):
        tski.fit_ski_gp(np.zeros((10, 1)), np.zeros(9), device="cpu")
    with pytest.raises(ValueError):
        tski.fit_ski_gp(np.zeros((10, 1)), np.zeros(10), max_iters=0,
                        device="cpu")
    with pytest.raises(ValueError):
        tski.fit_ski_gp(np.zeros((10, 1)), np.zeros(10), kernel="exp",
                        device="cpu")
    # the Matérn names map as gpquad's, then wait for the Matérn kernel
    with pytest.raises(NotImplementedError, match="Mat"):
        tski.fit_ski_gp(np.zeros((10, 1)), np.arange(10.0),
                        kernel="Matern32", device="cpu")
    with pytest.raises(TypeError):
        tski.fit_ski_gp(np.zeros((10, 1)), np.zeros(10), kernel=42,
                        device="cpu")
    assert tski._canonical_kernel("rbf") == jski._canonical_kernel("rbf")
    assert tski._canonical_kernel("Mat52") == jski._canonical_kernel("Mat52")


def test_fit_takes_kernel_instance_and_subsamples(rng, monkeypatch):
    x, y = _data(rng, 300)
    k = gpquad_torch.make_kernel("SE", 2, lengthscale=0.37, variance=1.3)
    out = tski.fit_ski_gp(x, y, kernel=k, grid_size=24, max_iters=1, lr=0.0,
                          verbose=False, dtype=torch.float64, device="cpu",
                          max_train_n=120)
    assert out["settings"]["kernel"] == "se"
    assert np.isclose(out["history"]["lengthscale"][0], 0.37, rtol=1e-12)
    assert np.isclose(out["history"]["outputscale"][0], 1.3, rtol=1e-12)
    assert out["num_train"] == 120 and out["num_total"] == 300
    want = jski.fit_ski_gp(x, y, grid_size=24, max_iters=1, verbose=False,
                           dtype=jnp.float64, max_train_n=120)
    assert np.array_equal(out["train_indices"], want["train_indices"])


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tski.fit_ski_gp(np.zeros((10, 2)), np.zeros(10))


def test_dropped_plan_fit_runs_unbanded(rng):
    """Clustered data drops the band plan: the fit's interpolations go
    through the scatter/gather path, visible in INTERP_PICKS."""
    x = _clustered(rng, 600)
    y = np.sin(3 * x[:, 1])
    before = dict(tski.INTERP_PICKS)
    fit = tski.fit_ski_gp(x, y, grid_size=(32, 32),
                          grid_bounds=((-1.0, 1.0), (-1.0, 1.0)),
                          max_iters=1, verbose=False, dtype=torch.float64,
                          device="cpu")
    assert fit["model"]["operator"].banded is None
    picks = {k: tski.INTERP_PICKS[k] - before[k] for k in before}
    assert picks["cuda"] == picks["banded"] == 0 and picks["unbanded"] > 0
    # and still matches gpquad's operator with its plan dropped
    opj = jski.build_ski_operator(jnp.asarray(x), _kernels(2)[0], (32, 32),
                                  ((-1.0, 1.0), (-1.0, 1.0)))
    assert opj.banded is None
    u = rng.normal(size=600)
    op = dataclasses.replace(fit["model"]["operator"])
    assert _rel(op.interp_T(torch.as_tensor(u)).numpy(),
                opj.interp_T(jnp.asarray(u))) < 1e-10


def test_float32_loss_and_grad_no_worse_than_gpquad(rng):
    """The loss and gradient in float32 against float64, in the port and in
    gpquad on the same inputs and probes (n 3000 on a 40^2 grid, noise
    0.01, the banded plan, cg_tol 1e-6, 10 Lanczos steps).  On the CPU
    gpquad's own f32 reads loss 1.36e-5 and gradient [4.5e-5, 4.6e-4,
    1.3e-4] (lengthscale, outputscale, noise) from its f64, the port loss
    1.43e-5 and [4.4e-5, 6.3e-5, 8.2e-6] (printed below).  The port's worst
    reading, over the loss and the three components, is no larger than
    gpquad's, and its loss is within 1e-4 relative (chip_smoke.py's bar)."""
    n, grid, sig2 = 3000, (40, 40), 0.01
    x, y = _data(rng, n)
    bounds = jski.resolve_grid_bounds(x)
    key = jax.random.PRNGKey(5)
    Z, zq = _jax_probes(key, 0, 2, 8, n)
    kw = dict(cg_tol=1e-6, max_cg_iter=1000, slq_steps=10)
    out = {}
    for dt, tdt in ((np.float64, torch.float64), (np.float32, torch.float32)):
        kj = JaxSE(lengthscale=dt(0.3), variance=dt(1.0), dimension=2)
        kt = gpquad_torch.make_kernel("SE", 2, lengthscale=dt(0.3),
                                      variance=dt(1.0))
        opj = jski.build_ski_operator(jnp.asarray(x, dt), kj, grid, bounds)
        opt = tski.build_ski_operator(torch.as_tensor(x, dtype=tdt), kt,
                                      grid, bounds)
        assert opj.banded is not None and opt.banded is not None
        want = jski._ski_loss_and_grad(
            opj.idx, opj.wvals, opj.banded, jnp.asarray(x, dt),
            jnp.asarray(y, dt), kj, jnp.asarray(sig2, dt),
            jax.random.fold_in(key, 0), grid_shape=opj.grid_shape,
            dx=opj.dx, trace_samples=2, slq_probes=8, **kw)
        got = tski._ski_loss_and_grad(
            opt, torch.as_tensor(y, dtype=tdt), kt,
            torch.tensor(sig2, dtype=tdt), torch.as_tensor(Z, dtype=tdt),
            torch.as_tensor(zq, dtype=tdt), **kw)
        out["jax", dt] = np.concatenate([[float(want[0])],
                                         np.asarray(want[1], np.float64)])
        out["torch", dt] = np.concatenate([[float(got[0])],
                                           got[1].double().numpy()])
    rel = {side: np.abs(out[side, np.float32] - out[side, np.float64])
           / np.abs(out[side, np.float64]) for side in ("jax", "torch")}
    print("f32 vs f64, relative (loss, lengthscale, outputscale, noise):",
          rel)
    assert rel["torch"][0] < 1e-4, rel
    assert np.max(rel["torch"]) <= np.max(rel["jax"]), rel
