"""Deflation (dense-head + Jacobi-tail) preconditioner for the EFGP Gram
system; port of ``gpquad/ops/deflation.py``.

The ill-conditioning of ``A = D T D + sigma^2 I`` concentrates in the modes
with the largest quadrature weights.  Gather the principal ``k x k``
submatrix of ``A`` on the top-``k`` weight modes straight from the Toeplitz
lag table, invert it once, and precondition with

    P^{-1} = inv(A[B, B])                     on the head block B,
             1 / (diag_scale |w|^2 + sigma^2)  on the tail,

a Hermitian positive-definite block-diagonal operator.  Every solve that
shares ``A`` (mean, variance probes, gradient traces) reuses the one
O(k^3) build.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from .dense_solve import dense_inverse

__all__ = ["deflation_block", "make_deflation_precond", "make_block_precond",
           "DEFLATION_RANK"]

# Head rank when a caller asks for precond="deflation" without precond_rank
# (gpquad/models/efgp.py:258-260, gradient.py:195-198).
DEFLATION_RANK = 2048


def deflation_block(ws: torch.Tensor, v: torch.Tensor, sigmasq, *,
                    mtot: int, d: int, rank: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select the top-``rank`` modes by |ws| and build ``inv(A[B, B])``.

    ``v`` is the ``(2*mtot-1,)*d`` lag table; ``A[j, k] = ws_j conj(ws_k)
    v[lag(j, k)] + sigma^2 delta_jk``.  Ties in |ws|^2 (SE weights tie on
    whole shells of |k|) keep the lower mode index first, as
    ``jax.lax.top_k`` does: a stable descending sort, not ``torch.topk``.
    Returns ``(idx, P_BB)``: (rank,) mode indices and the (rank, rank)
    inverse."""
    M = mtot ** d
    k = min(int(rank), M)
    absw2 = torch.abs(ws) ** 2
    idx = torch.sort(absw2, descending=True, stable=True).indices[:k]
    # flat mode index -> d-digit multi-index (row-major, as tensor_grid and
    # dense_lag_gather_indices lay the grid out)
    digits = []
    rem = idx
    for _ in range(d):
        digits.append(rem % mtot)
        rem = rem // mtot
    multi = torch.stack(digits[::-1], dim=-1)              # (k, d)
    L = 2 * mtot - 1
    lag = multi[:, None, :] - multi[None, :, :] + (mtot - 1)
    flat = lag[..., 0]
    for t in range(1, d):
        flat = flat * L + lag[..., t]
    T_BB = v.reshape(-1)[flat]
    wB = ws[idx]
    A_BB = wB[:, None] * T_BB * wB.conj()[None, :]
    A_BB = A_BB + sigmasq * torch.eye(k, dtype=A_BB.dtype, device=A_BB.device)
    return idx, dense_inverse(A_BB)


def make_block_precond(idx: torch.Tensor, P_BB: torch.Tensor,
                       jac_diag: torch.Tensor) -> Callable:
    """Block-diagonal preconditioner apply from a prebuilt head inverse and
    tail Jacobi diagonal, over the trailing axis of (M,) or (B, M)."""
    def M_inv(r):
        z = r / jac_diag.to(r.dtype)
        z[..., idx] = r[..., idx] @ P_BB.T
        return z
    return M_inv


def make_deflation_precond(ws: torch.Tensor, v: torch.Tensor, sigmasq, *,
                           mtot: int, d: int, rank: int,
                           diag_scale=1.0) -> Callable:
    """One-shot build: :func:`deflation_block` + :func:`make_block_precond`;
    ``diag_scale`` is the Toeplitz diagonal (N for the lag table), as in
    ``make_jacobi_precond``."""
    idx, P_BB = deflation_block(ws, v, sigmasq, mtot=mtot, d=d, rank=rank)
    return make_block_precond(idx, P_BB, diag_scale * torch.abs(ws) ** 2
                              + sigmasq)
