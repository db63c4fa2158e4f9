"""High-precision leg of the Polya-Gamma estimators; port of
``gpquad/models/pg_high.py``.

The PG outer loop is a float32 variational fit, but the final beta-mean
solve and the exact predictive moments deserve the float64 oracle's
agreement.  For fixed posterior weights ``delta`` the prediction system is

    (I + Ds T_w Ds) z = Ds q        beta = Ds^-1 z
    T_w = F* diag(delta) F          Ds = sqrt(max(ws2, eps_d))

gpquad solves it in double-word arithmetic on float32-only hardware; the
card has float64, so each (hi, lo) pair is a float64 word here, as in
``models/precision.py``:

- ``ws2 = S h^d``, ``Ds``, ``Ds^-1`` and ``e = ws2 / Ds`` come from the
  kernel's density in float64 on the host (the bucketed grid's surplus
  nodes zeroed before the floor, as the float32 fit masks them);
- the weighted lag table is the float64 type-1 NUFFT of ``delta`` on the
  doubled grid, and ``q = F* kappa`` the float64 type-1 (the kernels'
  float64 instances on the card);
- each solve is iterative refinement (``precision.ir_solve``): float64 TRUE
  residuals through the complex128 Toeplitz, float32 corrections by the
  dense float32 inverse for ``M <= DENSE_SOLVER_MAX_M``, else the float32
  PCG with Jacobi;
- the latent mean is the float64 type-2 NUFFT of ``ws2 beta`` and the
  latent variance ``Re <phi, e z>`` over slabs of targets, in float64.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.dense_solve import DENSE_SOLVER_MAX_M, dense_inverse, \
    dense_toeplitz
from ..ops.nufft import make_nufft
from ..ops.toeplitz import make_toeplitz, toeplitz_diag_scale
from ..quadrature import _host_f64
from .efgp import _as_points, posterior_fourier_rows, resolve_device
from .precision import _grid_xis, ir_solve

__all__ = ["pg_beta_mean_high", "pg_predict_high", "PGHighResult"]

_F64, _C64, _C128 = torch.float64, torch.complex64, torch.complex128


class PGHighResult(NamedTuple):
    """The float64 PG prediction (gpquad's hi and lo words are one float64
    word here)."""
    beta: torch.Tensor                 # (M,) complex128
    mean: torch.Tensor                 # (B,) float64 latent mean
    var: Optional[torch.Tensor]        # (B,) float64 latent variance
    solve_iters: torch.Tensor          # inner iterations of all solves
    residual: torch.Tensor             # the beta solve's last true residual


def _pg_host_tables(kernel, h64: float, mtot: int, d: int,
                    hm: Optional[int] = None):
    """Host float64 tables ``ws2 = S h^d``, ``Ds = sqrt(max(ws2, eps_d))``,
    ``Ds^-1`` and ``e = ws2 / Ds``, flat (M,).  ``hm`` (when given) zeroes
    ``ws2`` on the nodes with any ``|k| > hm`` before the floor, as the
    masked float32 fit does on a bucketed rung."""
    m = (mtot - 1) // 2
    with torch.no_grad():
        ws2 = _host_f64(kernel).spectral_density(_grid_xis(h64, mtot, d)) \
            * h64 ** d
    if hm is not None and hm < m:
        j = torch.abs(torch.arange(-m, m + 1))
        grids = torch.meshgrid(*([j] * d), indexing="ij")
        active = torch.stack([g.reshape(-1) for g in grids], -1).amax(-1) \
            <= hm
        ws2 = torch.where(active, ws2, torch.zeros_like(ws2))
    eps_d = max(float(torch.mean(ws2)) * 1e-14, 1e-14)
    Ds = torch.sqrt(torch.clamp(ws2, min=eps_d))
    return ws2, Ds, 1.0 / Ds, ws2 / Ds


def _pg_high_core(x64, x_new, delta, kappa, tables, h64: float, *,
                  mtot: int, slab: int, passes: int, ir_tol: float,
                  ir_maxiter: int, rtol: float, with_var: bool):
    d = x64.shape[1]
    dev = x64.device
    ws2, Ds, Dsinv, e = (t.to(dev) for t in tables)
    Ds_c, e_c = Ds.to(_C128), e.to(_C128)

    # float64 weighted lag table on the doubled grid
    v = make_nufft(x64, h64, 2 * mtot - 1).type1(delta.to(_C128))
    T64 = make_toeplitz(v)
    v32 = v.to(_C64)
    Ds32 = Ds.to(_C64)
    A_mean32 = M_inv = solve32 = None
    if mtot ** d <= DENSE_SOLVER_MAX_M:
        Tw = dense_toeplitz(v32, mtot, d)
        A32 = Ds32[:, None] * Tw * Ds32[None, :] + torch.eye(
            Tw.shape[0], dtype=_C64, device=dev)
        P32 = dense_inverse(A32)
        solve32 = lambda r: r @ P32.T          # noqa: E731
    else:
        wtoe32 = make_toeplitz(v32)
        diag = 1.0 + Ds32.real ** 2 * toeplitz_diag_scale(v32)

        def A_mean32(Y):
            return Y + Ds32 * wtoe32(Ds32 * Y)

        def M_inv(r):
            return r / diag.to(r.dtype)

    def A64(z):
        return z + Ds_c * T64(Ds_c * z)

    def solve_sym(b):
        return ir_solve(A_mean32, M_inv, A64, b, passes=passes,
                        ir_tol=ir_tol, ir_maxiter=ir_maxiter, rtol=rtol,
                        solve32=solve32)

    # beta mean: q = F* kappa, b = Ds q, beta = Ds^-1 z
    q = make_nufft(x64, h64, mtot).type1(kappa.to(_C128)).reshape(-1)
    z, iters, res = solve_sym((Ds_c * q)[None, :])
    beta = Dsinv.to(_C128) * z[0]

    # latent mean at the targets: the float64 type-2 of ws2 beta
    mean = make_nufft(x_new, h64, mtot).type2(
        (ws2.to(_C128) * beta).reshape((mtot,) * d)).real
    if not with_var:
        return PGHighResult(beta=beta, mean=mean, var=None,
                            solve_iters=iters, residual=res)

    # latent variance: phi = conj rows, (I + Ds T_w Ds) z = Ds phi,
    # var = Re <phi, e z>
    out = []
    for xs in torch.split(x_new, max(1, slab)):
        phi = posterior_fourier_rows(xs, h64, mtot, d).conj()
        zs, it, _ = solve_sym(Ds_c * phi)
        out.append(torch.sum(phi.conj() * (e_c * zs), dim=-1).real)
        iters = iters + it
    var = torch.clamp(torch.cat(out), min=0.0)
    return PGHighResult(beta=beta, mean=mean, var=var, solve_iters=iters,
                        residual=res)


def pg_predict_high(x, kernel, h, mtot: int, delta, kappa, x_new, *,
                    hm: Optional[int] = None, with_var: bool = True,
                    slab: int = 128, passes: int = 7, ir_tol: float = 1e-2,
                    ir_maxiter: int = 600, ir_rtol: float = 1e-11,
                    device="cuda") -> PGHighResult:
    """The PG posterior in float64: the beta-mean solve and the latent
    predictive mean at ``x_new`` (and, with ``with_var``, the exact latent
    variance) at the float64 oracle's agreement.

    ``h`` and the kernel's hypers are concrete host values; ``delta`` and
    ``kappa`` are the posterior weights of the float32 fit, taken as given
    in float64 (the leg solves the system the fit defined).  Pass ``hm``
    when ``mtot`` is a bucketed rung past ``2 hm + 1``.  ``x`` and
    ``x_new`` are taken in float64 on ``device`` (or the points' device
    when they are tensors there)."""
    dev = x.device if torch.is_tensor(x) else resolve_device(device)
    x64 = _as_points(x, dev).to(_F64)
    xq = _as_points(x_new, dev).to(_F64)
    h64 = float(h)
    tables = _pg_host_tables(kernel, h64, mtot, x64.shape[1], hm=hm)
    delta = torch.as_tensor(delta, device=dev).to(_F64)
    kappa = torch.as_tensor(kappa, device=dev).to(_F64)
    return _pg_high_core(x64, xq, delta, kappa, tables, h64, mtot=mtot,
                         slab=min(slab, max(1, xq.shape[0])), passes=passes,
                         ir_tol=ir_tol, ir_maxiter=ir_maxiter, rtol=ir_rtol,
                         with_var=with_var)


def pg_beta_mean_high(x, kernel, h, mtot: int, delta, kappa, **kw):
    """The float64 beta mean alone: ``(beta, iters, residual)``, beta
    complex128 (gpquad returns its hi and lo words)."""
    dev = x.device if torch.is_tensor(x) else resolve_device(
        kw.get("device", "cuda"))
    d = _as_points(x, dev).shape[1]
    res = pg_predict_high(x, kernel, h, mtot, delta, kappa,
                          torch.zeros((1, d), dtype=_F64, device=dev),
                          with_var=False, **kw)
    return res.beta, res.solve_iters, res.residual
