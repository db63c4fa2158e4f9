"""High-precision EFGP fit and posterior mean; port of
``gpquad/models/precision.py``.

The posterior mean's error is dominated by the solve: a solution with
relative residual r leaves ~180 r in the mean (cond(A) ~ 6e5 at the bench
headline).  gpquad reaches the float64 oracle on f32-only hardware by
iterative refinement with double-word (hi, lo) float32 residuals.  The card
has float64, so the port keeps the algorithm and replaces each pair by a
float64 word:

- the quadrature weights ``ws`` and the grid spacing ``h`` are computed on
  the host in float64 (the hypers are concrete here);
- ``b = D F* y`` and the Toeplitz lag table come from the float64 type-1
  NUFFT (the float64 instances of the CUDA kernels on the card);
- every pass of the refinement computes the TRUE residual ``b - A x`` in
  float64 (the dense float64 operator, or the complex128 FFT Toeplitz
  matvec) and solves the correction system in float32: the dense float32
  inverse (``dense_inverse``) for ``M <= DENSE_SOLVER_MAX_M``, else the
  float32 PCG on the float32 Toeplitz with Jacobi or deflation.  The
  residual contracts by about the inner solve's accuracy a pass;
- the solution and the posterior mean (the float64 type-2) are float64.

The returned :class:`HighState` carries the float32 companion ``FitState``
(so that ``predict_var`` works on it) and, where gpquad keeps low words,
the float64 ``ws``, ``h`` and ``beta``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..ops import collectives
from ..ops.cg import pcg
from ..ops.deflation import deflation_block, make_block_precond
from ..ops.dense_solve import DENSE_SOLVER_MAX_M, dense_gram, dense_inverse
from ..ops.nufft import make_nufft
from ..ops.operators import (convolution_vector, make_A_mean,
                             make_jacobi_precond)
from ..ops.toeplitz import ToeplitzND, make_toeplitz, toeplitz_diag_scale
from ..quadrature import _host_f64
from .efgp import FitState, _as_points, resolve_device, tensor_grid

__all__ = ["HighState", "ws_host_f64", "ir_solve", "fit_high",
           "predict_mean_high"]

_F64, _C64, _C128 = torch.float64, torch.complex64, torch.complex128


class HighState(NamedTuple):
    """A high-precision fit: the float32 companion state and the float64
    words of the weights, the grid spacing and the solution."""
    state: FitState            # float32 companion (predict_var works on it)
    ws: torch.Tensor           # (M,) float64 quadrature weights
    h: torch.Tensor            # 0-d float64 grid spacing
    beta: torch.Tensor         # (M,) complex128 Fourier weights
    residual: torch.Tensor     # 0-d float64 |b - A beta| / |b| at the end


def _grid_xis(h64: float, mtot: int, d: int) -> torch.Tensor:
    """(M, d) float64 host tensor-product grid ``k h``, ``ij`` order."""
    m = (mtot - 1) // 2
    return tensor_grid(torch.arange(-m, m + 1, dtype=_F64) * h64, d)


def ws_host_f64(kernel, h64: float, mtot: int, d: int) -> torch.Tensor:
    """Quadrature weights ``sqrt(S(xi) h^d)``: the kernel's own spectral
    density evaluated in float64 on the host."""
    with torch.no_grad():
        S = _host_f64(kernel).spectral_density(_grid_xis(h64, mtot, d))
    return torch.sqrt(S * h64 ** d)


def ir_solve(A_mean: Optional[Callable], M_inv: Optional[Callable],
             A64: Callable, b: torch.Tensor, *, passes: int, ir_tol: float,
             ir_maxiter: int, rtol: float = 0.0,
             solve32: Optional[Callable] = None):
    """Iterative refinement of ``A x = b`` to the float64 floor (gpquad's
    ``df64_ir_solve``).  Each pass computes the TRUE residual in float64
    with ``A64`` and solves the correction system in float32: with
    ``solve32`` (a direct solver, e.g. a dense-inverse matmul) or else the
    float32 PCG on ``A_mean`` (preconditioner ``M_inv``) to ``ir_tol``.
    ``b`` is complex128, (M,) or (B, M) (the rows share one batched PCG).
    Refinement stops after ``passes`` passes, or once the residual of every
    row measured at the start of a pass is no larger than ``rtol`` times
    its right-hand side's norm (one host read a pass; gpquad compares the
    norms of the whole batch, which lets rows of small norm stop early).
    Returns ``(x, inner iterations, the residual norm of the batch measured
    at the start of the last pass)``."""
    x = torch.zeros_like(b)
    bn = torch.linalg.vector_norm(b, dim=-1)
    iters = torch.zeros((), dtype=torch.int32, device=b.device)
    res = torch.full((), math.inf, dtype=bn.dtype, device=b.device)
    rows = torch.full_like(bn, math.inf)
    for _ in range(passes):
        if not bool(torch.any(rows > rtol * bn)):
            break
        r = b - A64(x)
        rows = torch.linalg.vector_norm(r, dim=-1)
        res = torch.linalg.vector_norm(rows)
        r32 = r.to(_C64)
        if solve32 is not None:
            cx, c_iters = solve32(r32), 1
        else:
            corr = pcg(A_mean, r32, tol=ir_tol, maxiter=ir_maxiter,
                       M_inv=M_inv)
            cx, c_iters = corr.x, corr.iters
        x = x + cx.to(_C128)
        iters = iters + c_iters
    return x, iters, res


class _HighOperators(NamedTuple):
    """The float64 and float32 operators the high tier's solves share."""
    v: torch.Tensor              # (2 mtot - 1,)*d complex128 lag table
    T64: ToeplitzND              # complex128 Toeplitz Gram
    A64: Callable                # float64 A = D T D + sigma^2 I
    A_mean32: Callable           # its float32 companion
    M_inv32: Optional[Callable]  # float32 preconditioner of the inner PCG
    solve32: Optional[Callable]  # dense float32 inverse, where used
    toeplitz32: ToeplitzND
    ws32: torch.Tensor           # (M,) complex64
    P32: Optional[torch.Tensor]  # (M, M) float32 inverse (dense inner)
    A32: Optional[torch.Tensor]  # (M, M) float32 A (dense inner)


def _high_operators(x64, ws64, h64: float, sig64: float, mtot: int, *,
                    inner: str, precond_rank: int = 0) -> _HighOperators:
    """The float64 lag table (type-1 NUFFT of ones on the doubled grid)
    and the operators built from it.  ``inner``: "dense" (the float32
    inverse of the float32 A), "deflation" (the inner PCG with the
    top-``precond_rank`` block) or "jacobi".  Inside
    ``collectives.sharded`` ``x64`` is this rank's block of the points, the
    lag table is reduced over the ranks and both Grams apply as the
    sharding's ``toeplitz``."""
    sh = collectives.current()
    d = x64.shape[1]
    m = (mtot - 1) // 2
    v = sh.points(convolution_vector(m, x64, h64))
    T64 = make_toeplitz(v)
    ws_c = ws64.to(_C128)
    A64 = make_A_mean(ws_c, sh.toeplitz(T64), sig64)
    v32 = v.to(_C64)
    toeplitz32 = make_toeplitz(v32)
    ws32 = ws64.to(_C64)
    sig32 = torch.tensor(sig64, dtype=torch.float32, device=x64.device)
    A_mean32 = make_A_mean(ws32, sh.toeplitz(toeplitz32), sig32)
    diag_scale = toeplitz_diag_scale(v32)
    M_inv = solve32 = P = A32 = None
    if inner == "dense":
        A32 = dense_gram(ws32, v32, mtot, d, sig32)
        P = dense_inverse(A32)
        solve32 = lambda r: r @ P.T            # noqa: E731
    elif inner == "deflation":
        idx, P_BB = deflation_block(ws32, v32, sig32, mtot=mtot, d=d,
                                    rank=precond_rank)
        M_inv = make_block_precond(
            idx, P_BB, diag_scale * torch.abs(ws32) ** 2 + sig32)
    else:
        M_inv = make_jacobi_precond(ws32, sig32, diag_scale=diag_scale)
    return _HighOperators(v=v, T64=T64, A64=A64, A_mean32=A_mean32,
                          M_inv32=M_inv, solve32=solve32,
                          toeplitz32=toeplitz32, ws32=ws32, P32=P, A32=A32)


def _high_inputs(x, kernel, h, mtot, device):
    """Points in float64 on ``device``, the host float64 weights there and
    the float64 spacing."""
    dev = resolve_device(device)
    x64 = _as_points(x, dev).to(_F64)
    h64 = float(h)
    ws64 = ws_host_f64(kernel, h64, mtot, x64.shape[1]).to(dev)
    return x64, ws64, h64, dev


def fit_high(x, y, kernel, sigmasq, h, mtot: int, *, passes: int = 8,
             chunk: int = 8, solver: str = "auto", ir_passes: int = 7,
             ir_tol: float = 1e-2, ir_maxiter: int = 600,
             ir_rtol: float = 1e-11, exact_tables: Optional[bool] = None,
             precond_rank: int = 0, device="cuda") -> HighState:
    """High-precision fit; ``h``, ``sigmasq`` and the hypers are concrete
    (host float64 planning values).  ``x`` and ``y`` are taken as given, in
    float64 (pass a float32 fit's float32 data to hold the two on the same
    points).

    Every pass takes the true residual with the complex128 Toeplitz Gram.
    ``solver``: 'auto' is 'dense' for ``M <= DENSE_SOLVER_MAX_M``
    (``passes`` refinements of ``dense_inverse``'s float32 solution) and
    'iterative' beyond (the float32 PCG correction to ``ir_tol``, at most
    ``ir_passes`` passes, stopping once the residual is below ``ir_rtol *
    |b|``; ``precond_rank > 0`` deflates the inner PCG, else Jacobi).
    ``chunk`` and
    ``exact_tables`` chose between gpquad's double-word table routines;
    here the tables always come from the float64 type-1 NUFFT, and both are
    accepted and ignored.  The outputs are float64."""
    x64, ws64, h64, dev = _high_inputs(x, kernel, h, mtot, device)
    n, d = x64.shape
    M = mtot ** d
    if solver == "auto":
        solver = "dense" if M <= DENSE_SOLVER_MAX_M else "iterative"
    if solver not in ("dense", "iterative"):
        raise ValueError(
            f"Unknown solver '{solver}' (auto | dense | iterative)")
    if solver == "dense" and M > DENSE_SOLVER_MAX_M:
        raise ValueError(
            f"solver='dense' materializes an {M}x{M} float32 inverse; "
            f"M={M} exceeds DENSE_SOLVER_MAX_M={DENSE_SOLVER_MAX_M}. "
            f"Use solver='iterative'.")
    sig64 = float(sigmasq)
    y64 = torch.as_tensor(y, device=dev).to(_F64)
    Fy = collectives.current().points(
        make_nufft(x64, h64, mtot).type1(y64.to(_C128))).reshape(-1)
    b = ws64 * Fy
    if solver == "dense":
        ops = _high_operators(x64, ws64, h64, sig64, mtot, inner="dense")
        # the float32 inverse's first solution, then ``passes`` refinements
        beta, _, _ = ir_solve(None, None, ops.A64, b, passes=passes + 1,
                              ir_tol=0.0, ir_maxiter=0, solve32=ops.solve32)
        iters = torch.tensor(passes, dtype=torch.int32, device=dev)
    else:
        ops = _high_operators(
            x64, ws64, h64, sig64, mtot,
            inner="deflation" if precond_rank > 0 else "jacobi",
            precond_rank=precond_rank)
        beta, iters, _ = ir_solve(ops.A_mean32, ops.M_inv32, ops.A64, b,
                                  passes=ir_passes, ir_tol=ir_tol,
                                  ir_maxiter=ir_maxiter, rtol=ir_rtol)
    res = torch.linalg.vector_norm(b - ops.A64(beta))
    v32 = ops.v.to(_C64)
    state = FitState(beta=beta.to(_C64), ws=ops.ws32,
                     h=torch.tensor(h64, dtype=torch.float32, device=dev),
                     sigmasq=torch.tensor(sig64, dtype=torch.float32,
                                          device=dev),
                     toeplitz=ops.toeplitz32, mean_cg_iters=iters,
                     diag_scale=toeplitz_diag_scale(v32), A_dense=ops.A32,
                     P_dense=ops.P32, mtot=mtot, d=d)
    return HighState(state=state, ws=ws64,
                     h=torch.tensor(h64, dtype=_F64, device=dev), beta=beta,
                     residual=res / torch.linalg.vector_norm(b))


def predict_mean_high(hs: HighState, x_new, *, slab: int = 2048
                      ) -> torch.Tensor:
    """Posterior mean at ``x_new`` (float64): the float64 type-2 NUFFT of
    ``ws * beta``.  ``slab`` bounded the memory of gpquad's double-word
    type-2; the float64 NUFFT takes the targets in one call, and ``slab``
    is accepted and ignored."""
    st = hs.state
    x64 = _as_points(x_new, hs.beta.device).to(_F64)
    nufft = make_nufft(x64, hs.h, st.mtot)
    return nufft.type2((hs.ws * hs.beta).reshape((st.mtot,) * st.d)).real
