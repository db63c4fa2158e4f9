"""EFGP structured operators over the weighted Gram ``G = D T D``; port of
``gpquad/ops/operators.py``:

    A_mean(beta)  = G beta + sigma^2 beta        (mean solve)
    A_var(gamma)  = G gamma / sigma^2 + gamma    (variance solve)
    M_inv(v)      = v / (c |w|^2 + sigma^2)      (Jacobi preconditioner)
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..utils import profiling
from .nufft import make_nufft
from .toeplitz import ToeplitzND

__all__ = ["convolution_vector", "make_Gv", "make_A_mean", "make_A_var",
           "make_jacobi_precond"]

_LAG_ATTRS = profiling.keyed("mtot")


def convolution_vector(m: int, x: torch.Tensor, h, *,
                       nufft_method: str = "auto",
                       cap: Optional[int] = None) -> torch.Tensor:
    """Toeplitz lag table ``v[k] = sum_n exp(-2 pi i <k, h x_n>)``, k in
    [-2m, 2m]^d: a type-1 NUFFT of ones on the doubled grid (``cap``: the
    banded backend's band cap on that grid, planned when None)."""
    if x.ndim == 1:
        x = x[:, None]
    with profiling.stage("lag_table", _LAG_ATTRS, 4 * m + 1):
        op = make_nufft(x, h, 4 * m + 1, method=nufft_method, cap=cap)
        cdtype = (torch.complex64 if x.dtype == torch.float32
                  else torch.complex128)
        ones = torch.ones((x.shape[0],), dtype=cdtype, device=x.device)
        return op.type1(ones)


def make_Gv(ws: torch.Tensor, toeplitz: ToeplitzND) -> Callable:
    """G v = ws * T(ws * v) over the trailing feature axis."""
    def Gv(v):
        v = v.to(ws.dtype)
        return ws * toeplitz(ws * v)
    return Gv


def make_A_mean(ws, toeplitz, sigmasq) -> Callable:
    """A_mean = G + sigma^2 I."""
    Gv = make_Gv(ws, toeplitz)

    def A_mean(beta):
        beta = beta.to(ws.dtype)
        return Gv(beta) + sigmasq * beta
    return A_mean


def make_A_var(ws, toeplitz, sigmasq) -> Callable:
    """A_var = G / sigma^2 + I."""
    Gv = make_Gv(ws, toeplitz)

    def A_var(gamma):
        gamma = gamma.to(ws.dtype)
        return Gv(gamma) / sigmasq + gamma
    return A_var


def make_jacobi_precond(ws, sigmasq, diag_scale=1.0) -> Callable:
    """Diagonal preconditioner 1 / (diag_scale |ws|^2 + sigma^2)."""
    diag = diag_scale * torch.abs(ws) ** 2 + sigmasq

    def M_inv(v):
        return v / diag.to(v.dtype)
    return M_inv
