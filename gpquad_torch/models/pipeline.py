"""The north-star workload in one call: fit + posterior mean + stochastic
variance + one hyper-gradient, and with it the high-precision refit and
mean; port of ``gpquad/models/pipeline.py`` (``fit_predict_grad``,
``fit_predict_grad_high``).

The JAX version compiles the whole pass into one XLA program, which shares
the grid set-up, lag table and Toeplitz spectrum between the stages.  Here
the stages run eagerly and share them explicitly: the fit's ``FitState``
goes to the gradient (``state=``), so the lag table and the dense factors
are built once.  The gradient recomputes ``F* y`` as gpquad's does
(gradient.py:213); XLA merges that with the fit's copy, eager torch runs it
again.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.cg import pcg
from ..ops.dense_solve import dense_gram, dense_inverse, refine_solve
from ..ops.kron_precond import kron_eig_build, make_kron_precond
from ..ops.nufft import make_nufft
from ..ops.operators import (convolution_vector, make_A_mean,
                             make_jacobi_precond)
from ..ops.toeplitz import make_toeplitz, toeplitz_diag_scale
from ..utils import profiling
from .efgp import (FitState, _as_points, _cdtype, _variance_stochastic,
                   predict_mean, quadrature_weights, resolve_device,
                   resolve_precond, resolve_solver, serving_method,
                   tensor_grid)
from .gradient import gradient_with_grid
from .precision import fit_high, predict_mean_high

__all__ = ["FusedResult", "fit_predict_grad", "FusedHighResult",
           "fit_predict_grad_high"]


class FusedResult(NamedTuple):
    mean: torch.Tensor           # (B,) posterior mean at targets
    var: torch.Tensor            # (B,) posterior variance at targets
    grad: torch.Tensor           # (H+1,) NLL gradient wrt positive hypers
    beta: torch.Tensor           # (M,) mean-solve weights
    mean_cg_iters: torch.Tensor
    trace_cg_iters: torch.Tensor
    mean_converged: torch.Tensor


@profiling.spanned("fit_predict_grad")
def fit_predict_grad(x, y, xnew, kernel, sigmasq, h, generator=None, *,
                     mtot: int, trace_samples: int = 10,
                     var_probes: int = 256, cg_tol: float = 1e-6,
                     var_cg_tol: float = 1e-4, grad_cg_tol: float = 1e-4,
                     max_cg_iter: int = 1000,
                     var_max_cg_iter: Optional[int] = None, ws_mask=None,
                     solver: str = "auto", nufft_method: str = "auto",
                     nufft_caps: Optional[tuple] = None,
                     precond: str = "auto", fft_smooth: bool = False,
                     device="cuda") -> FusedResult:
    """Mean fit + target mean and stochastic variance + one hyper-gradient.

    All probes come from one generator (a fresh one on ``device`` seeded 0
    when None), in this order: the variance's (var_probes, M) ``etas``, then
    the gradient's ``Z`` (T, n), then its ``V`` (T, M).  The same seed
    therefore gives the same +-1 probes in a float32 and a float64 run.
    ``nufft_method`` takes the fit's and the gradient's NUFFTs, with
    ``nufft_caps`` for "banded" (a None cap planned by ``make_nufft``); the
    mean and the variance take :func:`~.efgp.serving_method`'s, as gpquad's
    do.
    """
    dev = resolve_device(device)
    x = _as_points(x, dev)
    xnew = _as_points(xnew, dev, x.dtype)
    n, d = x.shape
    rdtype = x.dtype
    cdtype = _cdtype(rdtype)
    y = torch.as_tensor(y, device=dev).to(rdtype)
    h = torch.as_tensor(h, dtype=rdtype, device=dev)
    sigmasq = torch.as_tensor(sigmasq, dtype=rdtype, device=dev)
    kernel = kernel.with_hypers(kernel.hyper_vector().to(dev, rdtype))
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if ws_mask is not None:
        ws_mask = torch.as_tensor(ws_mask, device=dev).to(rdtype)

    m = (mtot - 1) // 2
    xis = tensor_grid(torch.arange(-m, m + 1, dtype=rdtype, device=dev) * h,
                      d)
    ws = quadrature_weights(kernel, xis, h, d, mask=ws_mask)
    caps = nufft_caps or (None, None)
    nufft = make_nufft(x, h, mtot, method=nufft_method, cap=caps[0])
    v = convolution_vector(m, x, h, nufft_method=nufft_method, cap=caps[1])
    toeplitz = make_toeplitz(v, force_pow2=not fft_smooth)
    diag_scale = toeplitz_diag_scale(v)
    rhs = ws * nufft.type1(y.to(cdtype)).reshape(-1)

    A_dense = P_dense = kron = None
    if resolve_solver(solver, mtot, d) == "dense":
        A_dense = dense_gram(ws, v, mtot, d, sigmasq)
        P_dense = dense_inverse(A_dense)
        res_mean = refine_solve(A_dense, P_dense, rhs, tol=cg_tol)
    else:
        # without n and M, as gpquad's pipeline.py:93 (ROADMAP §C): 'kron'
        # and 'adaptive' build kron, anything else runs Jacobi, 'deflation'
        # included
        if resolve_precond(precond, 0, True, d) == "kron":
            kron = kron_eig_build(ws, v, sigmasq, mtot=mtot, d=d,
                                  diag_scale=diag_scale)
            M_inv = make_kron_precond(kron)
        else:
            M_inv = make_jacobi_precond(ws, sigmasq, diag_scale=diag_scale)
        res_mean = pcg(make_A_mean(ws, toeplitz, sigmasq), rhs, tol=cg_tol,
                       maxiter=max_cg_iter, M_inv=M_inv)
    state = FitState(beta=res_mean.x, ws=ws, h=h, sigmasq=sigmasq,
                     toeplitz=toeplitz, mean_cg_iters=res_mean.iters,
                     diag_scale=diag_scale, A_dense=A_dense, P_dense=P_dense,
                     kron=kron, mtot=mtot, d=d)

    mean = predict_mean(state, xnew,
                        nufft_method=serving_method(nufft_method))
    var = _variance_stochastic(
        state, xnew, generator, probes=var_probes, cg_tol=var_cg_tol,
        max_cg_iter=var_max_cg_iter if var_max_cg_iter is not None
        else max_cg_iter, nufft_method=nufft_method)
    gres = gradient_with_grid(x, y, kernel, sigmasq, h, generator, mtot=mtot,
                              trace_samples=trace_samples,
                              cg_tol=grad_cg_tol, max_cg_iter=max_cg_iter,
                              beta0=res_mean.x, ws_mask=ws_mask,
                              solver=solver, nufft_method=nufft_method,
                              nufft_caps=nufft_caps, precond=precond,
                              fft_smooth=fft_smooth, state=state)
    return FusedResult(mean=mean, var=var, grad=gres.grad, beta=res_mean.x,
                       mean_cg_iters=res_mean.iters,
                       trace_cg_iters=gres.trace_cg_iters,
                       mean_converged=res_mean.converged)


class FusedHighResult(NamedTuple):
    fused: FusedResult
    mean_high: torch.Tensor       # (B,) float64 posterior mean
    high_residual: torch.Tensor   # float64 relative residual of the refit


def fit_predict_grad_high(x, y, xnew, kernel, sigmasq, h, generator=None, *,
                          mtot: int, passes: int = 8, chunk: int = 8,
                          slab: int = 2048, fuse: bool = True,
                          exact_tables: bool = False, device="cuda",
                          **kw) -> FusedHighResult:
    """The fused float32 pass (:func:`fit_predict_grad`, ``**kw`` its
    options, ``nufft_method`` and ``nufft_caps`` among them) followed by
    the float64 high-precision refit on the dense tier
    (``precision.fit_high(solver="dense")``, ``passes`` refinements)
    and the float64 mean at ``xnew``.  ``h``, ``sigmasq`` and the hypers
    are concrete host float64 values.  gpquad's ``fuse`` chose between one
    XLA program and two, ``chunk`` and ``exact_tables`` between its
    double-word table routines, and ``slab`` bounded its type-2's memory:
    here the stages run in turn either way and the four are accepted and
    ignored."""
    fused = fit_predict_grad(x, y, xnew, kernel, sigmasq, h, generator,
                             mtot=mtot, device=device, **kw)
    hs = fit_high(x, y, kernel, sigmasq, h, mtot, passes=passes,
                  solver="dense", device=device)
    return FusedHighResult(fused=fused, mean_high=predict_mean_high(hs, xnew),
                           high_residual=hs.residual)
