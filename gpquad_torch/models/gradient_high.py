"""High-precision hyper-gradient; port of ``gpquad/models/gradient_high.py``.

The float32 gradient estimator's error is an arithmetic floor: its trace
chain forms ``alpha_t = (F q_t - F D Beta_t) / sigma^2`` from two n-space
operands that cancel to ~1/6800 of their size (headline configuration).
Every term of the estimator (``models/gradient.py``) is an inner product
that reduces to the M-dimensional feature space,

    z^T F s            = (F* z)^H s
    y^T F beta         = (F* y)^H beta
    |F beta|^2         = beta^H (F* F) beta = beta^H T beta,

so with float64 type-1 NUFFTs for ``F* y`` and ``F* Z`` (the batched kernel
for the probes), the complex128 Toeplitz matvec for T, and float64-refined
solves (``precision.ir_solve``) for beta and every probe system, the
gradient assembles from float64 dot products over (M,) vectors and needs
no type-2 at all.  SE and fixed-nu Matérn kernels (host float64 spectral
derivative tables).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.dense_solve import DENSE_SOLVER_MAX_M
from ..ops.nufft import make_nufft
from .gradient import _rademacher_rows
from ..quadrature import _host_f64
from .precision import _grid_xis, _high_inputs, _high_operators, ir_solve

__all__ = ["GradientHighResult", "gradient_high", "dlength_host_f64"]

_F64, _C128 = torch.float64, torch.complex128


class GradientHighResult(NamedTuple):
    grad: torch.Tensor          # (H+1,) d(NLL)/d(positive hypers), float64
    inner_iters: torch.Tensor   # inner float32 CG iterations (passes, dense)
    residual: torch.Tensor      # true float64 residual of the batched solve


def dlength_host_f64(kernel, h64: float, mtot: int, d: int) -> torch.Tensor:
    """Float64 table ``h^d dS/d(lengthscale)`` on the grid: the kernel's own
    ``spectral_grad`` evaluated in float64 on the host."""
    with torch.no_grad():
        dS = _host_f64(kernel).spectral_grad(_grid_xis(h64, mtot, d))[:, 0]
    return dS * h64 ** d


def _dot_re(a, b):
    """Re <a, b> = Re sum conj(a) b over the last axis."""
    return torch.sum(a.conj() * b, dim=-1).real


def gradient_high(x, y, kernel, sigmasq, h, mtot: int, *,
                  trace_samples: int = 10,
                  generator: Optional[torch.Generator] = None,
                  probes: Optional[Tuple] = None, passes: int = 7,
                  chunk: int = 64, ir_tol: float = 1e-2,
                  ir_maxiter: int = 600, ir_rtol: float = 1e-11,
                  precond_rank: int = 0, device="cuda") -> GradientHighResult:
    """Float64 hyper-gradient over (lengthscale, variance, sigmasq).

    The estimator and probe conventions of ``gradient_with_grid``: pass
    ``probes=(Z, V)`` ((T, n) and (T, M), +-1) for same-probe comparisons,
    or they are drawn from ``generator`` (Z, then V; a fresh generator on
    the device seeded 0 when None).  ``h``, ``sigmasq`` and the hypers are
    concrete host float64 values.  The mean and all probe systems are one
    batched refinement (``precision.ir_solve``): its float32 corrections use
    the dense float32 inverse for ``M <= DENSE_SOLVER_MAX_M``, else the
    PCG with the deflation block (``precond_rank > 0``) or Jacobi.
    ``chunk`` sized gpquad's double-word type-1 and is accepted and
    ignored.  The gradient is float64."""
    if kernel.hyper_names != ("lengthscale", "variance"):
        raise NotImplementedError(
            "gradient_high supports (lengthscale, variance) kernels "
            "(SE / fixed-nu Matern)")
    x64, ws64, h64, dev = _high_inputs(x, kernel, h, mtot, device)
    n, d = x64.shape
    M = mtot ** d
    y64 = torch.as_tensor(y, device=dev).to(_F64)
    if probes is not None:
        Z, V = (torch.as_tensor(p, device=dev).to(_F64) for p in probes)
    else:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        Z = _rademacher_rows(generator, trace_samples, n, _F64, dev)
        V = _rademacher_rows(generator, trace_samples, M, _F64, dev)
    T = Z.shape[0]
    sig = float(sigmasq)
    var = float(kernel.variance)
    ws = ws64.to(_C128)
    dl = dlength_host_f64(kernel, h64, mtot, d).to(dev, _C128)

    # float64 feature-space ingredients: F* y, F* Z (one batched type-1),
    # the lag table and the operators on it
    nufft = make_nufft(x64, h64, mtot)
    Fy = nufft.type1(y64.to(_C128)).reshape(M)
    q0 = nufft.type1(Z.to(_C128)).reshape(T, M)
    if M <= DENSE_SOLVER_MAX_M:
        inner = "dense"
    else:
        inner = "deflation" if precond_rank > 0 else "jacobi"
    ops = _high_operators(x64, ws64, h64, sig, mtot, inner=inner,
                          precond_rank=precond_rank)

    # right-hand sides [mean; kernel probes; noise probes]: D F* y, the
    # kernel probes' D T (D' F* z_t), the noise probes' D T (D v_t)
    q = dl * q0
    B = torch.cat([(ws * Fy)[None], ws * ops.T64(q),
                   ws * ops.T64(ws * V.to(_C128))])
    X, iters, res = ir_solve(ops.A_mean32, ops.M_inv32, ops.A64, B,
                             passes=passes, ir_tol=ir_tol,
                             ir_maxiter=ir_maxiter, rtol=ir_rtol,
                             solve32=ops.solve32)
    beta, Bk, Bn = X[0], X[1:1 + T], X[1 + T:]

    # term2 (mean chain): fadj_alpha = (F* y - T D beta) / sigma^2
    bw = ws * beta
    tb = ops.T64(bw)
    fa = (Fy - tb) / sig
    t2_l = _dot_re(fa, dl * fa)
    yy = torch.dot(y64, y64)
    fyb = _dot_re(Fy, bw)
    alpha_norm = (yy + _dot_re(bw, tb) - 2.0 * fyb) / sig ** 2
    y_alpha = (yy - fyb) / sig
    t2_v = (y_alpha - sig * alpha_norm) / var

    # term1: t1_l = mean_t Re <F* z_t, q_t - D Beta_t> / sigma^2; the noise
    # block by Woodbury, t1_noise = n / sigma^2 - mean_t <v_t, Beta_t> / s^2
    t1_l = torch.mean(_dot_re(q0, q - ws * Bk)) / sig
    t1_n = n / sig - torch.mean(torch.sum(V * Bn.real, dim=-1)) / sig
    t1_v = (n - sig * t1_n) / var
    grad = 0.5 * torch.stack([t1_l - t2_l, t1_v - t2_v, t1_n - alpha_norm])
    return GradientHighResult(grad=grad, inner_iters=iters, residual=res)
