"""Kronecker eigen-preconditioner for the EFGP Gram system; port of
``gpquad/ops/kron_precond.py``.

``A = D T D + sigma^2 I`` is nearly separable: for a product sampling
density ``T`` concentrates around ``T1 (x) ... (x) Td / n^(d-1)``, where
``Ti`` is the 1-D marginal Gram (an (mtot, mtot) Hermitian Toeplitz matrix
whose lag table is the zero-lag slice of the d-dim lag table on every other
axis), and for a separable spectral density (SE exactly) the weights are
``g1 (x) ... (x) gd``.  So

    P = (M1 (x) ... (x) Md) / n^(d-1) + sigma^2 I,   Mi = diag(gi) Ti diag(gi)

agrees with ``A`` in expectation and is inverted exactly from d dense
eigendecompositions: ``P^-1 r = U [ U^H r / (prod lam / n^(d-1) + s2) ]``
with ``U = U1 (x) ... (x) Ud``, applied as mode products.

Each ``Mi`` is Hermitian and centro-Hermitian, so the sparse unitary of
:func:`_centro_unitary` carries it to a real symmetric matrix and the
eigendecomposition is a real ``torch.linalg.eigh`` (cuSOLVER on the card);
the mode products are ``torch.matmul`` (cuBLAS).  A global scale leaves PCG
iterates unchanged, so the same operator preconditions ``A / sigma^2``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..utils import profiling

__all__ = ["KronPrecond", "kron_eig_build", "make_kron_precond"]


_SPAN_ATTRS = profiling.keyed("d", "mtot")


class KronPrecond(NamedTuple):
    """Eigen-factorised separable preconditioner."""
    Us: Tuple[torch.Tensor, ...]   # d unitaries, each (mtot, mtot) complex
    denom: torch.Tensor            # (mtot,)*d real: prod(lam)/n^(d-1) + s2


def _normalize(v):
    nv = torch.sqrt(torch.sum(v * v))
    return v / torch.where(nv > 0, nv, torch.ones_like(nv))


def _separable_factors(W: torch.Tensor, d: int, iters: int = 40):
    """Best positive rank-1 tensor factors of the nonnegative weight grid
    ``W`` ((mtot,)*d) by alternating contractions (power iteration for d=2,
    ALS for d=3; exact for separable densities).  The overall scale is
    folded into the first factor."""
    if d == 1:
        return [W]
    cur = [torch.ones((W.shape[i],), dtype=W.dtype, device=W.device)
           for i in range(d)]
    for _ in range(iters):
        for i in range(d):
            X = W
            # contract from the last axis down, so the lower axes keep
            # their index
            for j in range(d - 1, -1, -1):
                if j != i:
                    X = torch.tensordot(X, cur[j], dims=([j], [0]))
            cur[i] = X if i == d - 1 else _normalize(X)
    gs = list(cur)
    scale = torch.sqrt(torch.sum(gs[-1] * gs[-1]))
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    gs[-1] = gs[-1] / safe
    gs[0] = gs[0] * scale
    return gs


def _centro_unitary(m: int, cdtype, device=None) -> torch.Tensor:
    """The sparse unitary that carries centro-Hermitian matrices to real
    ones (Cantoni & Butler 1976): columns ``(e_j + e_{m-1-j})/sqrt(2)``,
    the centre ``e_p``, and ``i (e_j - e_{m-1-j})/sqrt(2)``."""
    p = (m - 1) // 2
    rt = 0.7071067811865476
    j = torch.arange(p, device=device)
    U = torch.zeros((m, m), dtype=cdtype, device=device)
    U[j, j] = rt
    U[m - 1 - j, j] = rt
    U[p, p] = 1.0
    U[j, p + 1 + j] = 1j * rt
    U[m - 1 - j, p + 1 + j] = -1j * rt
    return U


def _marginal_toeplitz(v: torch.Tensor, axis: int, mtot: int,
                       d: int) -> torch.Tensor:
    """(mtot, mtot) Hermitian Toeplitz matrix of the 1-D marginal Gram
    along ``axis``: its lag table is the zero-lag slice of ``v`` on every
    other axis."""
    m = (mtot - 1) // 2
    idx = tuple(slice(None) if a == axis else 2 * m for a in range(d))
    vi = v[idx]                                   # (2 mtot - 1,)
    j = torch.arange(mtot, device=v.device)
    return vi[j[:, None] - j[None, :] + 2 * m]


def kron_eig_build(ws: torch.Tensor, v: torch.Tensor, sigmasq, *, mtot: int,
                   d: int, diag_scale) -> KronPrecond:
    """Build the preconditioner from the fit's quadrature weights ``ws``
    (flat (M,), complex), lag table ``v`` ((2 mtot - 1,)*d), noise
    ``sigmasq`` and ``diag_scale`` (the Toeplitz zero lag, = n)."""
    with profiling.stage("kron_setup", _SPAN_ATTRS, d, mtot):
        return _kron_eig_build(ws, v, sigmasq, mtot, d, diag_scale)


def _kron_eig_build(ws, v, sigmasq, mtot, d, diag_scale) -> KronPrecond:
    rdtype = ws.real.dtype
    W = torch.abs(ws).reshape((mtot,) * d).to(rdtype)
    gs = _separable_factors(W, d)
    Uc = _centro_unitary(mtot, v.dtype, v.device)
    lams, Us = [], []
    for i in range(d):
        Ti = _marginal_toeplitz(v, i, mtot, d)
        gi = gs[i].to(Ti.dtype)
        Mi = gi[:, None] * Ti * gi.conj()[None, :]
        Mi = 0.5 * (Mi + Mi.conj().T)
        # U^H M U is real for the centro-Hermitian M_i; any asymmetry lost
        # to .real only perturbs the preconditioner (V stays unitary, P
        # stays Hermitian positive definite)
        K = torch.matmul(Uc.conj().T, torch.matmul(Mi, Uc)).real
        lam, V = torch.linalg.eigh(0.5 * (K + K.T))
        lams.append(torch.clamp(lam, min=0.0).to(rdtype))
        Us.append(torch.matmul(Uc, V.to(Uc.dtype)))
    prod = lams[0]
    for lam in lams[1:]:
        prod = prod[..., :, None] * lam
    n_scale = torch.clamp(torch.as_tensor(diag_scale).real.to(rdtype),
                          min=1.0)
    denom = (prod / n_scale ** (d - 1)
             + torch.as_tensor(sigmasq, dtype=rdtype, device=ws.device))
    return KronPrecond(Us=tuple(Us), denom=denom.to(rdtype))


def _mode_products(X: torch.Tensor, mats, d: int) -> torch.Tensor:
    """Apply ``mats[i]`` along tensor axis ``i + 1`` of ``X``
    ((B,) + (mtot,)*d)."""
    for i, Mi in enumerate(mats):
        X = torch.movedim(torch.tensordot(Mi, X, dims=([1], [i + 1])), 0,
                          i + 1)
    return X


def make_kron_precond(kp: KronPrecond):
    """Preconditioner apply ``M_inv(r)`` for flat (..., M) right-hand
    sides."""
    d = len(kp.Us)
    mtot = kp.Us[0].shape[0]
    Uh = [U.conj().T for U in kp.Us]

    def M_inv(r):
        shp = r.shape
        X = r.reshape((-1,) + (mtot,) * d)
        Y = _mode_products(X, Uh, d)
        Y = Y / kp.denom[None].to(Y.dtype)
        return _mode_products(Y, kp.Us, d).reshape(shp)

    return M_inv
