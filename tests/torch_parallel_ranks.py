"""Rank bodies of ``tests/test_torch_parallel.py``: one process a rank of a
gloo group on the CPU, imports only numpy, torch and ``gpquad_torch``.

    python tests/torch_parallel_ranks.py WORLD RANK STORE INPUTS OUT

Every rank runs every case of :func:`run` on the same inputs (SPMD); rank
0 saves the results to OUT with ``torch.save``.  At world size 1 it also
saves the port's unsharded calls on the same inputs.  The inputs are
:func:`make_inputs`'s arrays (``tests/test_parallel.py``'s seeds and sizes)
plus what only gpquad can draw (the M-step probes of its PG key), which the
test writes to INPUTS first.
"""
from __future__ import annotations

import sys
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import gpquad_torch  # noqa: E402
from gpquad_torch import parallel  # noqa: E402
from gpquad_torch.models import pg_core  # noqa: E402
from gpquad_torch.ops.operators import convolution_vector  # noqa: E402
from gpquad_torch.ops.toeplitz import make_toeplitz  # noqa: E402

# the dp x probe mesh of each world size
PROBE_MESH = {1: (1, 1), 2: (1, 2), 4: (2, 2)}
# PG outer step: tests/test_parallel.py's keywords (n_m_probes and lr are
# the port's m_probes rows and Adam's rate)
PG_KW = dict(e_iters=3, rho0=0.5, gamma=0.1, e_tol=0.0, cg_tol=1e-10)
PG_M_PROBES, PG_LR = 6, 0.05


def make_data(rng, n, d, lengthscale, variance, noise=0.2):
    """tests/test_efgp.py's make_data in numpy (the same draws)."""
    x = rng.uniform(0, 1, size=(n, d))
    dist = np.linalg.norm(x[:, None, :] - x[None, :, :], axis=-1)
    K = variance * np.exp(-0.5 * (dist / lengthscale) ** 2)
    L = np.linalg.cholesky(K + 1e-10 * np.eye(n))
    f = L @ rng.normal(size=n)
    return x, f + np.sqrt(noise) * rng.normal(size=n)


def _se(d, ell, var):
    return gpquad_torch.make_kernel("SE", d, lengthscale=ell, variance=var)


def make_inputs():
    """Each case's arrays, as tests/test_parallel.py draws them."""
    out = {}
    rng = np.random.default_rng(0)
    x, y = make_data(rng, 256, 2, 0.3, 1.0)
    _, h, mtot = gpquad_torch.spectral_grid(_se(2, 0.3, 1.0), 1e-3, 1.0)
    rng = np.random.default_rng(1)
    T = 8
    out["problem"] = dict(
        x=x, y=y, h=h, mtot=mtot,
        Z=rng.integers(0, 2, (T, 256)) * 2.0 - 1,
        V=rng.integers(0, 2, (T, mtot ** 2)) * 2.0 - 1)
    rng = np.random.default_rng(3)
    n = 100_000
    xw = rng.uniform(0, 1, size=(n, 2))
    yw = np.sin(5 * xw[:, 0]) + 0.2 * rng.normal(size=n)
    _, hw, mw = gpquad_torch.spectral_grid(_se(2, 0.2, 1.0), 1e-4, 1.0)
    out["wide"] = dict(x=xw, y=yw, h=hw, mtot=mw,
                       Z=rng.integers(0, 2, (T, n)) * 2.0 - 1,
                       V=rng.integers(0, 2, (T, mw ** 2)) * 2.0 - 1)
    rng = np.random.default_rng(5)
    xp = rng.uniform(0, 1, size=(2000, 2))
    out["pencil2"] = dict(
        x=xp, mtot=65, h=0.03,
        v=rng.normal(size=65 ** 2) + 1j * rng.normal(size=65 ** 2),
        B=rng.normal(size=(3, 65, 65)))
    rng = np.random.default_rng(11)
    xp = rng.uniform(0, 1, size=(1500, 3))
    out["pencil3"] = dict(
        x=xp, mtot=9, h=0.11,
        v=rng.normal(size=9 ** 3) + 1j * rng.normal(size=9 ** 3),
        B=rng.normal(size=(3, 9 ** 3)))
    for name, seed, n, d, mtot, h, ell, nq in (
            ("mfit2", 7, 4000, 2, 65, 0.03, 0.05, 50),
            ("mfit3", 12, 3000, 3, 9, 0.11, 0.15, 40)):
        rng = np.random.default_rng(seed)
        out[name] = dict(x=rng.uniform(0, 1, size=(n, d)),
                         y=rng.normal(size=n), d=d, mtot=mtot, h=h, ell=ell,
                         xt=rng.uniform(0.1, 0.9, size=(nq, d)))
    for name, seed, n, d, mtot, T in (("mgrad2", 11, 3000, 2, 65, 4),
                                      ("mgrad3", 14, 2000, 3, 9, 4)):
        rng = np.random.default_rng(seed)
        out[name] = dict(x=rng.uniform(0, 1, size=(n, d)),
                         y=rng.normal(size=n), d=d, mtot=mtot,
                         Z=rng.integers(0, 2, (T, n)) * 2.0 - 1,
                         V=rng.integers(0, 2, (T, mtot ** d)) * 2.0 - 1)
    rng = np.random.default_rng(13)
    for d, mtot, n in ((2, 65, 3000), (3, 9, 2000)):
        out[f"mvar{d}"] = dict(x=rng.uniform(0, 1, size=(n, d)),
                               y=rng.normal(size=n), d=d, mtot=mtot,
                               xt=rng.uniform(0.1, 0.9, size=(33, d)))
    for name, seed, n, d, h, ell, kw in (
            ("mhigh2", 13, 2000, 2, 0.31, 0.25,
             dict(ir_passes=8, ir_rtol=1e-12)),
            ("mhigh3", 15, 1500, 3, 0.11, 0.15, {})):
        rng = np.random.default_rng(seed)
        # gpquad takes float32 hypers: the port the same values in float64
        out[name] = dict(
            x=rng.uniform(0, 1, size=(n, d)).astype(np.float32),
            y=rng.normal(size=n).astype(np.float32), d=d, mtot=9, h=h,
            ell=float(np.float32(ell)), kw=kw)
    rng = np.random.default_rng(9)
    n = 512
    xg = rng.uniform(0, 1, size=(n, 2))
    lab = (rng.uniform(size=n) < 0.5).astype(np.float64)
    _, hg, mg = gpquad_torch.spectral_grid(_se(2, 0.25, 1.5), 1e-3, 1.0)
    out["pg"] = dict(x=xg, kappa=lab - 0.5, h=hg, mtot=mg,
                     e_probes=rng.integers(0, 2, (8, n)) * 2.0 - 1)
    return out


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _mvar_state(c):
    d = c["d"]
    return gpquad_torch.fit_with_grid(
        c["x"], c["y"], _se(d, 0.1 if d == 2 else 0.15, 1.0), 0.05,
        0.03 if d == 2 else 0.11, c["mtot"], cg_tol=1e-8, solver="cg",
        device="cpu")


def _raises(fn):
    try:
        fn()
    except (NotImplementedError, ValueError) as e:
        return type(e).__name__
    return None


def run(world: int, inp: dict, local: bool) -> dict:
    """Every case on this rank; with ``local``, also the unsharded calls
    (keys ending in ``_local``)."""
    mesh = parallel.make_mesh(world, device="cpu")
    mesh2 = parallel.make_mesh(world, axes=("dp", "probe"),
                               shape=PROBE_MESH[world], device="cpu")
    res = {"mesh": dict(size=mesh.size(), names=mesh.mesh_dim_names,
                        shape2=tuple(mesh2.mesh.shape),
                        names2=mesh2.mesh_dim_names)}
    c = inp["problem"]
    k2 = _se(2, 0.3, 1.0)
    st = parallel.sharded_fit(c["x"], c["y"], k2, 0.1, c["h"], c["mtot"],
                              mesh, cg_tol=1e-10)
    res["fit"] = dict(beta=st.beta,
                      mean=gpquad_torch.predict_mean(st, c["x"][:31]))
    gkw = dict(mtot=c["mtot"], trace_samples=8, cg_tol=1e-10)
    g = parallel.sharded_gradient(c["x"], c["y"], k2, 0.1, c["h"], mesh=mesh2,
                                  probes=(c["Z"], c["V"]), **gkw)
    res["grad"] = g._asdict()
    gw = parallel.sharded_gradient(
        c["x"], c["y"], k2, 0.1, c["h"], torch.Generator().manual_seed(3),
        mesh=mesh2, mtot=c["mtot"], trace_samples=4, cg_tol=1e-8)
    res["grad_wrapper"] = gw._asdict()
    if local:
        st0 = gpquad_torch.fit_with_grid(c["x"], c["y"], k2, 0.1, c["h"],
                                         c["mtot"], cg_tol=1e-10,
                                         device="cpu")
        res["fit_local"] = dict(
            beta=st0.beta, mean=gpquad_torch.predict_mean(st0, c["x"][:31]))
        res["grad_local"] = gpquad_torch.gradient_with_grid(
            c["x"], c["y"], k2, 0.1, c["h"], probes=(c["Z"], c["V"]),
            device="cpu", **gkw)._asdict()
        res["grad_wrapper_local"] = gpquad_torch.gradient_with_grid(
            c["x"], c["y"], k2, 0.1, c["h"], torch.Generator().manual_seed(3),
            mtot=c["mtot"], trace_samples=4, cg_tol=1e-8,
            device="cpu")._asdict()

    c = inp["wide"]
    wkw = dict(mtot=c["mtot"], trace_samples=8, cg_tol=1e-8)
    kw_ = _se(2, 0.2, 1.0)
    res["wide"] = parallel.sharded_gradient(
        c["x"], c["y"], kw_, 0.05, c["h"], mesh=mesh2,
        probes=(c["Z"], c["V"]), **wkw)._asdict()
    if local:
        res["wide_local"] = gpquad_torch.gradient_with_grid(
            c["x"], c["y"], kw_, 0.05, c["h"], probes=(c["Z"], c["V"]),
            device="cpu", **wkw)._asdict()

    for name in ("pencil2", "pencil3"):
        c = inp[name]
        x = _t(c["x"])
        T = make_toeplitz(convolution_vector((c["mtot"] - 1) // 2, x,
                                             c["h"]))
        kf = parallel.shard_toeplitz_kernel(T, mesh)
        res[name] = dict(
            kf_shape=tuple(kf.shape),
            v=parallel.msharded_toeplitz_matvec(T, _t(c["v"]), mesh,
                                                fft_kernel=kf),
            B=parallel.msharded_toeplitz_matvec(T, _t(c["B"]), mesh),
            want_v=T(_t(c["v"])), want_B=T(_t(c["B"])))
    x1 = _t(inp["pencil2"]["x"][:50, :1])
    T1 = make_toeplitz(convolution_vector(7, x1, 0.05))
    odd = make_toeplitz(torch.ones((15, 15), dtype=torch.complex128),
                        force_pow2=False)
    res["validate"] = dict(
        d1=_raises(lambda: parallel.msharded_toeplitz_matvec(
            T1, torch.zeros(15, dtype=torch.complex128), mesh)),
        fit_d1=_raises(lambda: parallel.msharded_fit(
            np.zeros((8, 1)), np.zeros(8), _se(1, 0.1, 1.0), 0.1, 0.3, 9,
            mesh)),
        odd=_raises(lambda: parallel.msharded_toeplitz_matvec(
            odd, torch.zeros(64, dtype=torch.complex128), mesh)),
        odd_fft_shape=odd.fft_shape)

    for name in ("mfit2", "mfit3"):
        c = inp[name]
        kern = _se(c["d"], c["ell"], 1.0)
        st = parallel.msharded_fit(c["x"], c["y"], kern, 0.05, c["h"],
                                   c["mtot"], mesh, cg_tol=1e-8)
        res[name] = dict(beta=st.beta, iters=st.mean_cg_iters,
                         mean=gpquad_torch.predict_mean(st, c["xt"]))
        if local:
            st0 = gpquad_torch.fit_with_grid(c["x"], c["y"], kern, 0.05,
                                             c["h"], c["mtot"], cg_tol=1e-8,
                                             solver="cg", device="cpu")
            res[name + "_local"] = dict(
                beta=st0.beta, iters=st0.mean_cg_iters,
                mean=gpquad_torch.predict_mean(st0, c["xt"]))

    for name, h, tol in (("mgrad2", 0.03, 1e-8), ("mgrad3", 0.11, 1e-10)):
        c = inp[name]
        kern = _se(c["d"], 0.05 if c["d"] == 2 else 0.15, 1.0)
        kw = dict(mtot=c["mtot"], trace_samples=4, cg_tol=tol)
        res[name] = parallel.msharded_gradient(
            c["x"], c["y"], kern, 0.05, h, None, mesh,
            probes=(c["Z"], c["V"]), **kw)._asdict()
        if local:
            res[name + "_local"] = gpquad_torch.gradient_with_grid(
                c["x"], c["y"], kern, 0.05, h, probes=(c["Z"], c["V"]),
                solver="cg", precond="jacobi", device="cpu", **kw)._asdict()

    for d in (2, 3):
        c = inp[f"mvar{d}"]
        st = _mvar_state(c)
        kw = dict(cg_tol=1e-10, max_cg_iter=4000)
        res[f"mvar{d}"] = parallel.msharded_predict_var(st, c["xt"], mesh,
                                                        **kw)
        if local:
            res[f"mvar{d}_local"] = gpquad_torch.predict_var(
                st, c["xt"], method="regular", **kw)

    for name in ("mhigh2", "mhigh3"):
        c = inp[name]
        kern = _se(c["d"], c["ell"], 1.0)
        hs = parallel.msharded_fit_high(c["x"], c["y"], kern, 0.05, c["h"],
                                        c["mtot"], mesh, **c["kw"])
        res[name] = dict(beta=hs.beta, iters=hs.state.mean_cg_iters,
                         residual=hs.residual)
        if local:
            hs0 = gpquad_torch.fit_high(c["x"], c["y"], kern, 0.05, c["h"],
                                        c["mtot"], solver="iterative",
                                        **dict(dict(ir_passes=6,
                                                    ir_rtol=1e-8),
                                               **c["kw"]), device="cpu")
            res[name + "_local"] = dict(beta=hs0.beta,
                                        iters=hs0.state.mean_cg_iters,
                                        residual=hs0.residual)

    c = inp["pg"]
    n = c["x"].shape[0]
    kp = _se(2, 0.25, 1.5)

    def pg_step(fn, **kw):
        raw = torch.log(torch.tensor([0.25, 1.5], dtype=torch.float64))
        r = fn(_t(c["x"]), kp, c["h"], None, torch.full((n,), 0.25,
                                                         dtype=torch.float64),
               _t(c["kappa"]), torch.ones(n, dtype=torch.float64),
               _t(c["e_probes"]), _t(inp["pg_m_probes"]), raw,
               torch.optim.Adam([raw], lr=PG_LR), mtot=c["mtot"],
               **PG_KW, **kw)
        return dict(delta=r.delta, mean=r.mean, sigma_diag=r.sigma_diag,
                    m_grad=r.m_grad, raw=r.raw.detach(),
                    e_cg_iters=r.e_cg_iters, m_cg_iters=r.m_cg_iters,
                    e_iters_used=r.e_iters_used)
    res["pg"] = pg_step(parallel.sharded_pg_outer_step, mesh=mesh2)
    if local:
        res["pg_local"] = pg_step(pg_core.outer_step)
    return res


def main(argv):
    world, rank, store, inputs, out = argv[1:6]
    world, rank = int(world), int(rank)
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    try:
        res = run(world, torch.load(inputs, weights_only=False),
                  local=world == 1)
        if rank == 0:
            torch.save(res, out)
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
