"""Port parity for the scale-out (``gpquad_torch.parallel``) on the CPU.

Each world size (1, 2 and 4: a 2 x 2 ``dp`` x ``probe`` mesh) is one spawn
of gloo ranks, every rank a process of ``tests/torch_parallel_ranks.py``
(numpy, torch and ``gpquad_torch`` only: no JAX in the children).  The
three spawns start together in a module fixture, run while gpquad's
references are computed here, and are joined with a timeout (a hung
collective fails the file instead of spending the suite's time); rank 0
saves its results.  Every case mirrors ``tests/test_parallel.py`` on its
inputs and tolerances, and is held against gpquad's single-device call,
gpquad's sharded call on the 8 virtual devices (the high tier and the
variance: gpquad's test holds those equal to its single-device call) and
the port's own single-process call.  At world size 1 the data- and
probe-parallel functions give the single-process call's bits; the
M-sharded ones take the FFT axis by axis, so the pencil matvec is held to
1e-10 and their solves to gpquad's tolerances.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from gpquad import parallel as jpar
from gpquad.kernels import SquaredExponential as JaxSE
from gpquad.models import pg_core as jpg
from gpquad.models.efgp import fit_with_grid, predict_mean, predict_var
from gpquad.models.gradient import gradient_with_grid
from gpquad.models.precision import fit_high
from gpquad.ops.operators import convolution_vector
from gpquad.ops.toeplitz import make_toeplitz

from .test_efgp import make_data as jax_make_data
from .torch_parallel_ranks import (PG_KW, PG_LR, PG_M_PROBES, PROBE_MESH,
                                   make_inputs)

torch.set_num_threads(1)

WORLDS = (1, 2, 4)
JOIN_S = 420                     # the three spawns together, at most
RANKS = Path(__file__).resolve().parent / "torch_parallel_ranks.py"
ROOT = RANKS.parent.parent
PG_KEY = 42

pytestmark = pytest.mark.skipif(
    not torch.distributed.is_available()
    or not torch.distributed.is_gloo_available()
    or len(jax.devices()) < 8,
    reason="needs torch.distributed with gloo and 8 virtual JAX devices")


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, rtol=0.0, atol=0.0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.allclose(got, want, rtol=rtol, atol=atol), (
        np.max(np.abs(got - want)), np.max(np.abs(want)))


def _same_bits(got: dict, want: dict):
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v) or (
                torch.isnan(v).all() and torch.isnan(got[k]).all()), k
        else:
            assert got[k] == v, k


@pytest.fixture(scope="module")
def inputs():
    inp = make_inputs()
    n = inp["pg"]["x"].shape[0]
    # gpquad's outer_step draws its M-step probes from its key
    inp["pg_m_probes"] = np.asarray(
        (jax.random.bernoulli(jax.random.PRNGKey(PG_KEY), 0.5,
                              (PG_M_PROBES, n)) * 2 - 1).astype(jnp.float64))
    return inp


@pytest.fixture(scope="module")
def spawned(inputs, tmp_path_factory):
    """Every world size's ranks, started together; killed at the end if
    any is still alive."""
    d = tmp_path_factory.mktemp("torch_parallel")
    torch.save(inputs, d / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    runs = {}
    for k in WORLDS:
        out = d / f"ws{k}.pt"
        procs = [subprocess.Popen(
            [sys.executable, str(RANKS), str(k), str(r), str(d / f"store{k}"),
             str(d / "inputs.pt"), str(out)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(k)]
        runs[k] = (procs, out)
    yield runs
    for procs, _ in runs.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def jref(inputs, spawned):
    """gpquad's single-device and sharded (8 devices) references, computed
    while the ranks run."""
    r = {}
    mesh = jpar.make_mesh(8)
    mesh2 = jpar.make_mesh(8, axes=("dp", "probe"), shape=(4, 2))

    def put2(a):
        return jax.device_put(jnp.asarray(a),
                              NamedSharding(mesh2, P("probe", "dp")))

    c = inputs["problem"]
    x, y = jnp.asarray(c["x"]), jnp.asarray(c["y"])
    k2 = JaxSE(lengthscale=0.3, variance=1.0, dimension=2)
    r["grid"] = jax_make_data(np.random.default_rng(0), n=256, d=2,
                              lengthscale=0.3, variance=1.0)
    ref = fit_with_grid(x, y, k2, 0.1, c["h"], c["mtot"], cg_tol=1e-10)
    st = jpar.sharded_fit(x, y, k2, 0.1, c["h"], c["mtot"], mesh,
                          cg_tol=1e-10)
    r["fit"] = [dict(beta=s.beta, mean=predict_mean(s, x[:31]))
                for s in (ref, st)]
    gkw = dict(mtot=c["mtot"], trace_samples=8, cg_tol=1e-10)
    Z, V = jnp.asarray(c["Z"]), jnp.asarray(c["V"])
    r["grad"] = [gradient_with_grid(x, y, k2, 0.1, c["h"],
                                    jax.random.PRNGKey(0), probes=(Z, V),
                                    **gkw).grad,
                 gradient_with_grid(
                     jpar.shard_points(x, mesh2), jpar.shard_points(y, mesh2),
                     k2, 0.1, c["h"], jax.random.PRNGKey(0),
                     probes=(put2(Z), jpar.shard_probes(V, mesh2)),
                     **gkw).grad]
    c = inputs["wide"]
    r["wide"] = gradient_with_grid(
        jnp.asarray(c["x"]), jnp.asarray(c["y"]),
        JaxSE(lengthscale=0.2, variance=1.0, dimension=2), 0.05, c["h"],
        jax.random.PRNGKey(0), mtot=c["mtot"], trace_samples=8, cg_tol=1e-8,
        probes=(jnp.asarray(c["Z"]), jnp.asarray(c["V"]))).grad
    for name in ("pencil2", "pencil3"):
        c = inputs[name]
        T = make_toeplitz(convolution_vector((c["mtot"] - 1) // 2,
                                             jnp.asarray(c["x"]),
                                             jnp.asarray(c["h"])))
        r[name] = dict(fft_shape=T.fft_shape, v=T(jnp.asarray(c["v"])),
                       B=T(jnp.asarray(c["B"]).astype(jnp.complex128)),
                       v_sh=jpar.msharded_toeplitz_matvec(
                           T, jnp.asarray(c["v"]), mesh))
    for name in ("mfit2", "mfit3"):
        c = inputs[name]
        kern = JaxSE(lengthscale=c["ell"], variance=1.0, dimension=c["d"])
        x, y, xt = (jnp.asarray(c[k]) for k in ("x", "y", "xt"))
        ref = fit_with_grid(x, y, kern, 0.05, jnp.asarray(c["h"]), c["mtot"],
                            cg_tol=1e-8, solver="cg")
        st = jpar.msharded_fit(x, y, kern, 0.05, c["h"], c["mtot"], mesh,
                               cg_tol=1e-8)
        r[name] = [dict(beta=s.beta, mean=predict_mean(s, xt))
                   for s in (ref, st)]
    for name, h, tol in (("mgrad2", 0.03, 1e-8), ("mgrad3", 0.11, 1e-10)):
        c = inputs[name]
        kern = JaxSE(lengthscale=0.05 if c["d"] == 2 else 0.15, variance=1.0,
                     dimension=c["d"])
        x, y, Z, V = (jnp.asarray(c[k]) for k in ("x", "y", "Z", "V"))
        kw = dict(mtot=c["mtot"], trace_samples=4, cg_tol=tol, probes=(Z, V))
        r[name] = [gradient_with_grid(x, y, kern, 0.05, jnp.asarray(h),
                                      jax.random.PRNGKey(0), solver="cg",
                                      **kw).grad,
                   jpar.msharded_gradient(x, y, kern, 0.05, h,
                                          jax.random.PRNGKey(0), mesh,
                                          **kw).grad]
    for d in (2, 3):
        c = inputs[f"mvar{d}"]
        st = fit_with_grid(
            jnp.asarray(c["x"]), jnp.asarray(c["y"]),
            JaxSE(lengthscale=0.1 if d == 2 else 0.15, variance=1.0,
                  dimension=d), 0.05, jnp.asarray(0.03 if d == 2 else 0.11),
            c["mtot"], cg_tol=1e-8, solver="cg")
        r[f"mvar{d}"] = predict_var(st, jnp.asarray(c["xt"]),
                                    method="regular", cg_tol=1e-10,
                                    max_cg_iter=4000)
    for name in ("mhigh2", "mhigh3"):
        c = inputs[name]
        kern = JaxSE(lengthscale=jnp.float32(c["ell"]),
                     variance=jnp.float32(1.0), dimension=c["d"])
        hs = fit_high(jnp.asarray(c["x"]), jnp.asarray(c["y"]), kern, 0.05,
                      c["h"], c["mtot"], solver="iterative", **c["kw"])
        r[name] = (np.asarray(hs.state.beta, np.complex128)
                   + np.asarray(hs.beta_lo, np.complex128))
    c = inputs["pg"]
    n = c["x"].shape[0]
    kp = JaxSE(lengthscale=0.25, variance=1.5, dimension=2)
    raw = jnp.log(jnp.asarray([0.25, 1.5]))
    args = (jnp.asarray(c["x"]), kp, c["h"], None, jnp.full((n,), 0.25),
            jnp.asarray(c["kappa"]), jnp.ones((n,)),
            jnp.asarray(c["e_probes"]), jax.random.PRNGKey(PG_KEY), raw,
            optax.adam(PG_LR).init(raw))
    kw = dict(mtot=int(c["mtot"]), n_m_probes=PG_M_PROBES, lr=PG_LR, **PG_KW)
    r["pg"] = [jpg.outer_step(*args, **kw),
               jpar.sharded_pg_outer_step(*args, mesh=mesh2, **kw)]
    return r


@pytest.fixture(scope="module")
def ranks(spawned, jref):
    """Each world size's results, the spawns joined with a timeout."""
    deadline = time.monotonic() + JOIN_S
    out = {}
    for k, (procs, path) in spawned.items():
        for p in procs:
            try:
                log, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pytest.fail(f"world size {k}: a rank did not finish within "
                            f"{JOIN_S} s")
            assert p.returncode == 0, f"world size {k}:\n{log}"
        out[k] = torch.load(path, weights_only=False)
    return out


# ---------------------------------------------------------------------------
# the mesh and the data
# ---------------------------------------------------------------------------

def test_inputs_are_gpquads(inputs, jref):
    """The ranks' arrays are tests/test_parallel.py's, on gpquad's grids."""
    from gpquad.quadrature import spectral_grid
    x, y = jref["grid"]
    assert np.array_equal(inputs["problem"]["x"], np.asarray(x))
    assert np.array_equal(inputs["problem"]["y"], np.asarray(y))
    for name, ell, var, eps in (("problem", 0.3, 1.0, 1e-3),
                                ("wide", 0.2, 1.0, 1e-4),
                                ("pg", 0.25, 1.5, 1e-3)):
        _, h, mtot = spectral_grid(
            JaxSE(lengthscale=ell, variance=var, dimension=2), eps, 1.0)
        assert int(mtot) == inputs[name]["mtot"], name
        assert np.isclose(float(h), inputs[name]["h"], rtol=1e-12), name


@pytest.mark.parametrize("k", WORLDS)
def test_mesh_construction(ranks, k):
    m = ranks[k]["mesh"]
    assert m["size"] == k and m["names"] == ("dp",)
    assert m["names2"] == ("dp", "probe") and m["shape2"] == PROBE_MESH[k]


# ---------------------------------------------------------------------------
# data and probe parallel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", WORLDS)
def test_sharded_fit_matches_single(ranks, jref, k):
    got = ranks[k]["fit"]
    for want in jref["fit"]:
        _close(got["beta"], want["beta"], atol=1e-8)
        _close(got["mean"], want["mean"], atol=1e-8)
    if k == 1:
        _same_bits(got, ranks[1]["fit_local"])
    else:
        _close(got["beta"], ranks[1]["fit_local"]["beta"], atol=1e-8)


@pytest.mark.parametrize("k", WORLDS)
def test_sharded_gradient_matches_single(ranks, jref, k):
    got = ranks[k]["grad"]
    for want in jref["grad"]:
        _close(got["grad"], want, rtol=1e-6)
    local = ranks[1]["grad_local"]
    if k == 1:
        _same_bits(got, local)
    else:
        _close(got["grad"], local["grad"], rtol=1e-6)
        assert torch.equal(got["trace_conv_iters"],
                           local["trace_conv_iters"])


@pytest.mark.parametrize("k", WORLDS)
def test_sharded_gradient_wrapper(ranks, k):
    """The probes drawn from the generator as gradient_with_grid draws
    them."""
    got = ranks[k]["grad_wrapper"]
    assert torch.isfinite(got["grad"]).all()
    local = ranks[1]["grad_wrapper_local"]
    if k == 1:
        _same_bits(got, local)
    else:
        _close(got["grad"], local["grad"], rtol=1e-6)


@pytest.mark.parametrize("k", WORLDS)
def test_sharded_gradient_large_n_wide_probe_axis(ranks, jref, k):
    got = ranks[k]["wide"]
    _close(got["grad"], jref["wide"], rtol=1e-5)
    local = ranks[1]["wide_local"]
    if k == 1:
        _same_bits(got, local)
    else:
        _close(got["grad"], local["grad"], rtol=1e-5)


@pytest.mark.parametrize("k", WORLDS)
def test_sharded_pg_outer_step_matches_single(ranks, jref, k):
    got = ranks[k]["pg"]
    for want in jref["pg"]:
        _close(got["delta"], want.delta, rtol=1e-8, atol=1e-10)
        _close(got["mean"], want.mean, rtol=1e-7, atol=1e-9)
        _close(got["m_grad"], want.m_grad, rtol=1e-6)
        _close(got["raw"], want.raw, rtol=1e-7, atol=1e-9)
    local = ranks[1]["pg_local"]
    if k == 1:
        _same_bits(got, local)
    else:
        _close(got["delta"], local["delta"], rtol=1e-8, atol=1e-10)
        _close(got["m_grad"], local["m_grad"], rtol=1e-6)


# ---------------------------------------------------------------------------
# M-sharded
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", WORLDS)
@pytest.mark.parametrize("d", (2, 3))
def test_msharded_toeplitz_matches_replicated(ranks, jref, k, d):
    got, want = ranks[k][f"pencil{d}"], jref[f"pencil{d}"]
    fs = want["fft_shape"]
    # this rank's spectrum slab: (P1, P2/k) at d=2, (P1, P2/k, P3) at d=3
    assert got["kf_shape"] == (fs[0], fs[1] // k) + tuple(fs[2:])
    for key in ("v", "B"):
        _close(got[key], got[f"want_{key}"], rtol=1e-10, atol=1e-10)
        _close(got[key], want[key], rtol=1e-10, atol=1e-10)
    _close(got["v"], want["v_sh"], rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("k", WORLDS)
def test_msharded_toeplitz_validates(ranks, k):
    v = ranks[k]["validate"]
    assert v["d1"] == "NotImplementedError"
    assert v["fit_d1"] == "NotImplementedError"
    # an FFT size of 15 splits over one rank only
    assert v["odd_fft_shape"] == (15, 15)
    assert v["odd"] == (None if k == 1 else "ValueError")


@pytest.mark.parametrize("k", WORLDS)
@pytest.mark.parametrize("d", (2, 3))
def test_msharded_fit_matches_single_device(ranks, jref, k, d):
    got = ranks[k][f"mfit{d}"]
    assert int(got["iters"]) > 0
    for want in jref[f"mfit{d}"] + [ranks[1][f"mfit{d}_local"]]:
        _close(got["beta"], want["beta"], rtol=1e-6, atol=1e-9)
        _close(got["mean"], want["mean"], atol=1e-7)


@pytest.mark.parametrize("k", WORLDS)
@pytest.mark.parametrize("d", (2, 3))
def test_msharded_gradient_matches_single_device(ranks, jref, k, d):
    rtol = 1e-5 if d == 2 else 1e-6
    got = ranks[k][f"mgrad{d}"]["grad"]
    for want in jref[f"mgrad{d}"] + [ranks[1][f"mgrad{d}_local"]["grad"]]:
        _close(got, want, rtol=rtol)


@pytest.mark.parametrize("k", WORLDS)
@pytest.mark.parametrize("d", (2, 3))
def test_msharded_predict_var_matches_regular(ranks, jref, k, d):
    got = ranks[k][f"mvar{d}"]
    for want in (jref[f"mvar{d}"], ranks[1][f"mvar{d}_local"]):
        _close(got, want, rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("k", WORLDS)
@pytest.mark.parametrize("d", (2, 3))
def test_msharded_fit_high_matches_single_device(ranks, jref, k, d):
    """The float64 beta against gpquad's double-word fit_high(iterative)
    (hi + lo words) and the port's own fit_high(iterative), within 1e-9 of
    max|beta| (gpquad's bar between its sharded and single-device fits)."""
    got = ranks[k][f"mhigh{d}"]
    assert int(got["iters"]) > 0
    for want in (jref[f"mhigh{d}"], ranks[1][f"mhigh{d}_local"]["beta"]):
        want = _np(want)
        scale = np.max(np.abs(want))
        assert np.max(np.abs(_np(got["beta"]) - want)) < 1e-9 * scale
