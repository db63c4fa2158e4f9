"""High-precision posterior variance; port of
``gpquad/models/variance_high.py``.

The float32 ``predict_var`` paths bottom out at ~2e-5 of the float64 dense
oracle: the quadratic form ``f_x^T W A_var^{-1} W conj(f_x)`` amplifies the
per-target solve's residual.  This re-runs the exact ("regular") estimator
with float64 residuals:

- the Toeplitz lag table from the float64 type-1 NUFFT drives the
  complex128 Toeplitz matvec and the float32 inner operator;
- the targets' rows ``conj(f_x) = exp(-2 pi i x . xi)`` are the
  conjugates of ``efgp.posterior_fourier_rows`` in float64;
- each slab of targets solves ``A_mean z = W conj(f_x)`` by iterative
  refinement (``precision.ir_solve``), float32 corrections against float64
  true residuals;
- ``var = sigma^2 Re <conj(f_x), W z>`` (A_var = A_mean / sigma^2), in
  float64.

Memory is O(slab * M); use the float32 paths for bulk prediction and this
one where the 1e-6 agreement matters.
"""
from __future__ import annotations

import torch

from ..ops.dense_solve import DENSE_SOLVER_MAX_M
from .efgp import _as_points, posterior_fourier_rows
from .precision import _high_inputs, _high_operators, ir_solve

__all__ = ["variance_high"]

_F64, _C128 = torch.float64, torch.complex128


def variance_high(x, kernel, sigmasq, h, mtot: int, x_new, *,
                  passes: int = 7, chunk: int = 64, slab: int = 256,
                  ir_tol: float = 1e-2, ir_maxiter: int = 600,
                  ir_rtol: float = 1e-11, precond_rank: int = 0,
                  device="cuda") -> torch.Tensor:
    """Exact per-target posterior variance with float64 residuals (~1e-7 of
    the float64 dense oracle or better), float64, (nt,).  ``h``,
    ``sigmasq`` and the hypers are concrete host float64 values.

    Matrix-free at any grid size; the inner float32 corrections use the
    dense float32 inverse for ``M <= DENSE_SOLVER_MAX_M``, else the PCG
    with the deflation block (``precond_rank > 0``) or Jacobi.  Targets go
    in slabs of ``slab``, one batched refinement each.  ``chunk`` sized
    gpquad's double-word type-1 and is accepted and ignored."""
    x64, ws64, h64, dev = _high_inputs(x, kernel, h, mtot, device)
    d = x64.shape[1]
    xq = _as_points(x_new, dev).to(_F64)
    sig = float(sigmasq)
    if mtot ** d <= DENSE_SOLVER_MAX_M:
        inner = "dense"
    else:
        inner = "deflation" if precond_rank > 0 else "jacobi"
    ops = _high_operators(x64, ws64, h64, sig, mtot, inner=inner,
                          precond_rank=precond_rank)
    ws = ws64.to(_C128)
    out = []
    for xs in torch.split(xq, max(1, min(slab, xq.shape[0]))):
        g = posterior_fourier_rows(xs, h64, mtot, d).conj()
        z, _, _ = ir_solve(ops.A_mean32, ops.M_inv32, ops.A64, ws * g,
                           passes=passes, ir_tol=ir_tol,
                           ir_maxiter=ir_maxiter, rtol=ir_rtol,
                           solve32=ops.solve32)
        out.append(sig * torch.sum(g.conj() * (ws * z), dim=-1).real)
    return torch.clamp(torch.cat(out), min=0.0)
