"""Batched preconditioned conjugate gradients; port of ``gpquad/ops/cg.py``.

The batch stays rectangular and a boolean lane mask freezes converged
systems: their update factors are exactly zero, so frozen lanes do not move.
Convergence is the row-wise relative residual against the right-hand side's
norm, with an absolute 1e-12 fallback; zero denominators are guarded
exactly (a ``where``, never an additive eps).

The loop asks the device whether any lane is still active only every
``_CHECK_EVERY`` iterations, so a GPU run does not wait on the host each
step.  Iterations after the last lane converged are exact no-ops, and the
iteration count is accumulated on the device, so ``iters``, ``converged``,
``resnorm`` and ``conv_iters`` equal those of the JAX ``while_loop``.

Each solve is a ``pcg`` span (B, n, tol, maxiter) holding a ``pcg_check``
span per host check.  While a profiler runs it counts, at its end,
``pcg_iters`` (the result's ``iters``), ``pcg_steps`` (the steps it
launched, up to ``_CHECK_EVERY - 1`` past the last lane's convergence) and
``pcg_active_lane_steps`` (the sum of ``conv_iters``: lane b is active in
steps 0 to ``conv_iters[b] - 1``), the first and last as device tensors.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..utils import profiling

__all__ = ["pcg", "CGResult"]

_DIV_EPS = 1e-16
_CHECK_EVERY = 8
_PCG_ATTRS = profiling.keyed("B", "n", "tol", "maxiter")


class CGResult(NamedTuple):
    x: torch.Tensor            # solutions, same shape as b
    iters: torch.Tensor        # scalar: loop iterations executed
    converged: torch.Tensor    # (B,) bool
    resnorm: torch.Tensor      # (B,) final residual norms
    conv_iters: torch.Tensor   # (B,) iteration index at convergence (maxiter if not)


def _rowdot(a, b):
    return torch.sum(a.conj() * b, dim=-1).real


def _nonzero(v):
    return torch.where(v == 0, torch.ones_like(v), v)


def pcg(A: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None, *,
        tol: float = 1e-6, maxiter: Optional[int] = None,
        M_inv: Optional[Callable] = None) -> CGResult:
    """Solve ``A x = b`` for one ``(n,)`` or a batch ``(B, n)`` of
    right-hand sides; ``A`` and ``M_inv`` map arrays shaped like ``b``."""
    single = b.ndim == 1
    if single:
        b = b[None, :]
        if x0 is not None:
            x0 = x0[None, :]
        Ab = lambda v: A(v[0])[None, :]                       # noqa: E731
        Mb = (lambda v: M_inv(v[0])[None, :]) if M_inv is not None else None
    else:
        Ab, Mb = A, M_inv

    B, n = b.shape
    if maxiter is None:
        maxiter = 2 * n
    with profiling.stage("pcg", _PCG_ATTRS, B, n, tol, maxiter):
        return _pcg_body(Ab, b, x0, Mb, tol, maxiter, single)


def _pcg_body(Ab, b, x0, Mb, tol, maxiter, single):
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype)
    r = b - Ab(x)
    z = Mb(r) if Mb is not None else r
    p = z
    rz = _rowdot(r, z)
    b_norm = torch.sqrt(_rowdot(b, b))
    denom = torch.where(b_norm > 0, b_norm, torch.ones_like(b_norm))

    rn0 = torch.sqrt(_rowdot(r, r))
    conv0 = (rn0 / (denom + _DIV_EPS) < tol) | (rn0 < 1e-12)
    active = ~conv0
    conv_iters = torch.where(conv0, 0, maxiter).to(torch.int32)
    k = torch.zeros((), dtype=torch.int32, device=b.device)

    steps = maxiter
    for step in range(maxiter):
        if step % _CHECK_EVERY == 0:
            with profiling.stage("pcg_check"):
                done = not bool(active.any())
            if done:
                steps = step
                break
        k = k + active.any().to(torch.int32)
        Ap = Ab(p)
        pAp = _rowdot(p, Ap)
        alpha = torch.where(active, rz / _nonzero(pAp), 0.0)
        x = x + alpha[:, None].to(x.dtype) * p
        r = r - alpha[:, None].to(r.dtype) * Ap
        z = Mb(r) if Mb is not None else r
        rz_new = _rowdot(r, z)
        beta = torch.where(active, rz_new / _nonzero(rz), 0.0)
        p = torch.where(active[:, None], z + beta[:, None].to(p.dtype) * p, p)
        rz = torch.where(active, rz_new, rz)
        rn = torch.sqrt(_rowdot(r, r))
        newly = active & ((rn / (denom + _DIV_EPS) < tol) | (rn < 1e-12))
        conv_iters = torch.where(newly, step + 1, conv_iters)
        active = active & ~newly

    rn = torch.sqrt(_rowdot(r, r))
    converged = (rn / (denom + _DIV_EPS) < tol) | (rn < 1e-12)
    if profiling.recording():
        profiling.count("pcg_iters", k)
        profiling.count("pcg_steps", steps)
        profiling.count("pcg_active_lane_steps", conv_iters.sum())
    if single:
        return CGResult(x[0], k, converged[0], rn[0], conv_iters[0])
    return CGResult(x, k, converged, rn, conv_iters)
