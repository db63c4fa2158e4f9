"""Dense Gram factor-solve with iterative refinement; port of
``gpquad/ops/dense_solve.py``.

For moderate ``M = mtot^d`` every solve of the model shares
``A = D T D + sigma^2 I``: materialise ``A`` once from the Toeplitz lag
table, invert it once, and answer each right-hand side with a matmul plus a
few refinement passes ``x_{k+1} = x_k + P (b - A x_k)``.  Beyond
``DENSE_SOLVER_MAX_M`` the callers use CG.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .cg import CGResult

__all__ = ["DENSE_SOLVER_MAX_M", "dense_lag_gather_indices", "dense_toeplitz",
           "dense_gram", "dense_inverse", "refine_solve"]

DENSE_SOLVER_MAX_M = 4096


def dense_lag_gather_indices(mtot: int, d: int) -> np.ndarray:
    """Flat indices into the ``(2*mtot-1,)*d`` lag table ``v`` such that
    ``T[j, k] = v.ravel()[idx[j, k]]`` (``T[j, k] = v[j - k]``)."""
    L = 2 * mtot - 1
    g1 = np.arange(mtot)
    grids = np.meshgrid(*([g1] * d), indexing="ij")
    multi = np.stack([g.ravel() for g in grids], axis=-1)      # (M, d)
    lag = multi[:, None, :] - multi[None, :, :] + (mtot - 1)   # (M, M, d)
    idx = lag[..., 0]
    for t in range(1, d):
        idx = idx * L + lag[..., t]
    return idx.astype(np.int64)


def dense_toeplitz(v: torch.Tensor, mtot: int, d: int) -> torch.Tensor:
    """The (M, M) dense Gram ``T = F* F`` from the lag table ``v``."""
    idx = torch.from_numpy(dense_lag_gather_indices(mtot, d)).to(v.device)
    return v.reshape(-1)[idx]


def dense_gram(ws: torch.Tensor, v: torch.Tensor, mtot: int, d: int,
               sigmasq) -> torch.Tensor:
    """Dense ``A = D T D + sigma^2 I``."""
    T = dense_toeplitz(v, mtot, d)
    M = T.shape[0]
    A = ws[:, None] * T * ws.conj()[None, :]
    return A + sigmasq * torch.eye(M, dtype=A.dtype, device=A.device)


def dense_inverse(A: torch.Tensor) -> torch.Tensor:
    """Inverse of the Hermitian positive-definite ``A``: Jacobi-equilibrate
    to a unit diagonal, Cholesky-factor, invert from the factor
    (``torch.cholesky_inverse``) and undo the scaling."""
    rdiag = A.diagonal().real
    tiny = torch.finfo(rdiag.dtype).tiny
    dinv = (1.0 / torch.sqrt(torch.clamp(rdiag, min=tiny))).to(A.dtype)
    Aeq = dinv[:, None] * A * dinv[None, :]
    L = torch.linalg.cholesky(Aeq)
    P = torch.cholesky_inverse(L)
    return dinv[:, None] * P * dinv[None, :]


def refine_solve(A: torch.Tensor, P: torch.Tensor, b: torch.Tensor, *,
                 passes: int = 4, tol: float = 1e-6,
                 scale: Optional[torch.Tensor] = None) -> CGResult:
    """Solve ``(scale * A) x = b`` with ``P = inv(A)`` and ``passes`` rounds
    of iterative refinement; ``b`` is (M,) or (B, M).  Returns a
    :class:`CGResult` (``iters`` = passes; ``converged``/``resnorm`` from one
    extra matvec)."""
    single = b.ndim == 1
    B = b[None, :] if single else b
    inv_scale = 1.0 if scale is None else 1.0 / scale

    def solve_once(r):
        return r @ P.T

    def matvec(x):
        Ax = x @ A.T
        return Ax if scale is None else Ax * scale

    x = solve_once(B) * inv_scale
    for _ in range(passes):
        r = B - matvec(x)
        x = x + solve_once(r) * inv_scale

    r = B - matvec(x)
    rn = torch.sqrt(torch.sum(torch.abs(r) ** 2, dim=-1))
    bn = torch.sqrt(torch.sum(torch.abs(B) ** 2, dim=-1))
    converged = ((rn / torch.where(bn > 0, bn, torch.ones_like(bn)) < tol)
                 | (rn < 1e-12))
    iters = torch.tensor(passes, dtype=torch.int32, device=B.device)
    conv_iters = torch.full((B.shape[0],), passes, dtype=torch.int32,
                            device=B.device)
    if single:
        return CGResult(x[0], iters, converged[0], rn[0], conv_iters[0])
    return CGResult(x, iters, converged, rn, conv_iters)
