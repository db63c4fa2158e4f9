"""Batched stochastic hyperparameter gradient of the GP log-marginal; port of
``gpquad/models/gradient.py``.

For hypers theta = (kernel hypers..., sigma^2) the gradient of the
*negative* log marginal is estimated as ``0.5 * (term1 - term2)`` with

  term2 (quadratic forms, exact given the mean solve):
    kernel hyper i : Re< F* alpha, D'_i F* alpha >
    sigma_f^2      : (y.alpha - sigma^2 |alpha|^2) / sigma_f^2   [algebraic]
    sigma^2        : |alpha|^2

  term1 (Hutchinson traces, all probe systems in ONE batched solve):
    kernel hyper i : data-space probes z_t: solve A b = D T (D'_i F* z),
                     alpha_t = (F D'_i F* z - F D b)/sigma^2,
                     mean_t Re<z_t, alpha_t>
    sigma^2        : feature-space probes v_t via the Woodbury identity
                     tr(K^-1) = n/sigma^2 - tr(A^-1 G)/sigma^2
    sigma_f^2      : (n - sigma^2 * term1_noise) / sigma_f^2     [algebraic]

The probe batches are the only batched NUFFTs of the main path: ``F* Z``
(T, n) -> (T, M) and two ``F`` applies of (tk T, M) -> (tk T, n).  On the
card they are one launch each of the batched kernels (``ops/cuda_nufft.py``).

Randomness comes from a ``torch.Generator`` in place of a JAX key, and the
probes can be passed in (``probes=(Z, V)``) for same-probe comparisons.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops import collectives
from ..ops.cg import pcg
from ..ops.deflation import (DEFLATION_RANK, make_block_precond,
                             make_deflation_precond)
from ..ops.dense_solve import dense_gram, dense_inverse, refine_solve
from ..ops.kron_precond import kron_eig_build, make_kron_precond
from ..ops.nufft import make_nufft
from ..ops.operators import (convolution_vector, make_A_mean,
                             make_jacobi_precond)
from ..ops.slq import logdet_slq
from ..ops.toeplitz import make_toeplitz, toeplitz_diag_scale
from ..quadrature import spectral_grid
from ..utils import profiling
from .efgp import (_as_points, _cdtype, quadrature_weights, resolve_device,
                   resolve_precond, resolve_solver, tensor_grid)

__all__ = ["GradientResult", "gradient_with_grid", "gradient"]


class GradientResult(NamedTuple):
    grad: torch.Tensor            # (H+1,) d(NLL)/d(positive hypers)
    beta: torch.Tensor            # (M,) raw mean-solve weights (warm start)
    log_marginal: torch.Tensor    # scalar (nan when not requested)
    mean_cg_iters: torch.Tensor
    trace_cg_iters: torch.Tensor
    trace_conv_iters: torch.Tensor  # ((tk+1)*T,) per-RHS convergence iter


def _variance_index(kernel) -> Optional[int]:
    names = kernel.hyper_names
    return names.index("variance") if "variance" in names else None


def _rademacher_rows(generator, rows, cols, rdtype, device):
    bits = torch.randint(0, 2, (rows, cols), generator=generator,
                         device=generator.device)
    return (bits * 2 - 1).to(device, rdtype)


@profiling.spanned("gradient_with_grid")
def gradient_with_grid(
        x, y, kernel, sigmasq, h, generator=None, *, mtot: int,
        trace_samples: int = 10, cg_tol: float = 1e-3,
        max_cg_iter: Optional[int] = None, noise_floor=None, beta0=None,
        ws_mask=None, use_mean_precond: bool = True,
        use_trace_precond: bool = True,
        probes: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        compute_log_marginal: bool = False, log_marginal_probes: int = 100,
        log_marginal_steps: int = 25, nufft_method: str = "auto",
        nufft_caps: Optional[Tuple[int, int]] = None, solver: str = "auto",
        precond_rank: int = 0, precond: str = "auto",
        fft_smooth: bool = False, state=None,
        device="cuda") -> GradientResult:
    """One gradient evaluation on a fixed-size frequency grid.

    ``ws_mask`` zeroes padded grid nodes (both D and D') so that a padded
    grid gives the tight grid's gradient.  ``state`` (a ``FitState`` of the
    same kernel, sigmasq and grid, without noise floor) reuses the fit's
    ws, Toeplitz spectrum, dense factors, deflation block and Jacobi scale;
    the fused pipeline passes it.  With ``state`` and a binding
    ``noise_floor`` the dense tier solves with the state's un-floored
    ``A_dense``, as gpquad does (ROADMAP §C known quirk).
    ``nufft_caps`` (the fit grid's and the lag grid's band caps) serves
    ``nufft_method="banded"``; a None cap is planned by ``make_nufft``.

    Probes: ``probes=(Z, V)`` ((T, n) and (T, M), +-1) or, when None, drawn
    from ``generator`` in this order: ``Z`` (T, n), then ``V`` (T, M), then
    (with ``compute_log_marginal``) the SLQ probes.  A None generator is a
    fresh generator on the run's device seeded 0.  Runs on ``state``'s
    device when a state is given, else on ``device``.

    Inside ``collectives.sharded`` (the scale-out, ``gpquad_torch.parallel``)
    ``x``, ``y`` and the columns of ``Z`` are this rank's block of the
    points and the rows of ``Z`` and ``V`` its block of the probes: the
    type-1 sums and the point sums are reduced over the point ranks, the
    probe means over the probe ranks.
    """
    sh = collectives.current()
    dev = state.device if state is not None else resolve_device(device)
    x = _as_points(x, dev)
    d = x.shape[1]
    n = sh.n_points(x.shape[0])
    rdtype = x.dtype
    cdtype = _cdtype(rdtype)
    y = torch.as_tensor(y, device=dev).to(rdtype)
    h = torch.as_tensor(h, dtype=rdtype, device=dev)
    sigmasq = torch.as_tensor(sigmasq, dtype=rdtype, device=dev)
    # cast the (float64) hypers to x's dtype: otherwise ws, and through it
    # the whole float32 run, would go to complex128 and the f64 kernels
    kernel = kernel.with_hypers(kernel.hyper_vector().to(dev, rdtype))
    sigmasq_eff = (torch.maximum(sigmasq, torch.as_tensor(
        noise_floor, dtype=rdtype, device=dev))
        if noise_floor is not None else sigmasq)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    num_hypers = kernel.num_hypers
    variance_idx = _variance_index(kernel)
    kernel_hyper_count = num_hypers - 1
    trace_kernel_indices = [i for i in range(kernel_hyper_count)
                            if i != variance_idx]
    tk = len(trace_kernel_indices)
    T = trace_samples

    # --- stage 1: frequency grid, weights, density gradients ---------------
    with profiling.stage("1_frequency_grid_setup"):
        m = (mtot - 1) // 2
        xis = tensor_grid(
            torch.arange(-m, m + 1, dtype=rdtype, device=dev) * h, d)
        if ws_mask is not None:
            ws_mask = torch.as_tensor(ws_mask, device=dev).to(rdtype)
        Dprime = (h ** d) * kernel.spectral_grad(xis)            # (M, H)
        if ws_mask is not None:
            Dprime = Dprime * ws_mask[:, None]
        Dprime = Dprime.to(cdtype)
        M = Dprime.shape[0]

    # --- stage 2/3: NUFFT + Toeplitz + operators ---------------------------
    with profiling.stage("3_toeplitz_setup"):
        caps = nufft_caps or (None, None)
        nufft = make_nufft(x, h, mtot, method=nufft_method, cap=caps[0])

        def fadj(v):
            return sh.points(nufft.type1(v)).reshape(v.shape[:-1] + (M,))

        fwd = nufft.type2
        if state is not None:
            ws = state.ws
            toeplitz = sh.toeplitz(state.toeplitz)
            diag_scale = state.diag_scale
            use_dense = state.P_dense is not None
            if use_dense:
                A_dense, P_dense = state.A_dense, state.P_dense
            else:
                A_mean = make_A_mean(ws, toeplitz, sigmasq_eff)
                if state.kron is not None:
                    M_inv_op = make_kron_precond(state.kron)
                elif state.defl_P is not None:
                    M_inv_op = make_block_precond(
                        state.defl_idx, state.defl_P,
                        diag_scale * torch.abs(ws) ** 2 + sigmasq_eff)
                else:
                    M_inv_op = make_jacobi_precond(ws, sigmasq_eff,
                                                   diag_scale=diag_scale)
        else:
            ws = quadrature_weights(kernel, xis, h, d, mask=ws_mask)
            v_kernel = sh.points(convolution_vector(
                m, x, h, nufft_method=nufft_method, cap=caps[1]))
            toeplitz = sh.toeplitz(make_toeplitz(v_kernel,
                                                 force_pow2=not fft_smooth))
            diag_scale = toeplitz_diag_scale(v_kernel)
            use_dense = resolve_solver(solver, mtot, d) == "dense"
            if use_dense:
                A_dense = dense_gram(ws, v_kernel, mtot, d, sigmasq_eff)
                P_dense = dense_inverse(A_dense)
            else:
                A_mean = make_A_mean(ws, toeplitz, sigmasq_eff)
                # 'none' still preconditions with Jacobi, as in gpquad
                family = resolve_precond(precond, precond_rank, True, d, n=n,
                                         M=M)
                if family == "kron":
                    M_inv_op = make_kron_precond(kron_eig_build(
                        ws, v_kernel, sigmasq_eff, mtot=mtot, d=d,
                        diag_scale=diag_scale))
                elif family == "deflation":
                    M_inv_op = make_deflation_precond(
                        ws, v_kernel, sigmasq_eff, mtot=mtot, d=d,
                        rank=(precond_rank if precond_rank > 0
                              else DEFLATION_RANK),
                        diag_scale=diag_scale)
                else:
                    M_inv_op = make_jacobi_precond(ws, sigmasq_eff,
                                                   diag_scale=diag_scale)
        if use_dense:
            def solve(b):
                # the dense tier takes no warm start: beta0 is ignored, as in
                # gpquad (gradient.py:216 calls solve(rhs) without x0)
                return refine_solve(A_dense, P_dense, b, tol=cg_tol)
        else:
            mean_M_inv = M_inv_op if use_mean_precond else None
            trace_M_inv = M_inv_op if use_trace_precond else None
            maxiter = max_cg_iter if max_cg_iter is not None else 2 * M

    # --- stage 4: mean solve A beta = D F* y -------------------------------
    with profiling.stage("4_solve_cg"):
        yc = y.to(cdtype)
        Fy = fadj(yc)
        rhs = ws * Fy
        if use_dense:
            res_mean = solve(rhs)
        else:
            if beta0 is not None:
                beta0 = torch.as_tensor(beta0, device=dev)
            res_mean = pcg(A_mean, rhs, beta0, tol=cg_tol, maxiter=maxiter,
                           M_inv=mean_M_inv)
        beta_raw = res_mean.x
        beta = ws * beta_raw
        sig_c = sigmasq_eff.to(cdtype)
        alpha = (yc - fwd(beta)) / sig_c

    # --- stage 5: term2 ----------------------------------------------------
    with profiling.stage("5_compute_term2"):
        fadj_alpha = (Fy - toeplitz(beta)) / sig_c
        term2 = torch.zeros((num_hypers,), dtype=rdtype, device=dev)
        for i in range(kernel_hyper_count):
            term2[i] = torch.sum(fadj_alpha.conj()
                                 * (Dprime[:, i] * fadj_alpha)).real
        alpha_norm = sh.points(torch.sum(alpha.conj() * alpha).real)
        if variance_idx is not None:
            variance = kernel.get_hyper("variance").to(rdtype)
            y_alpha = sh.points(torch.sum(yc.conj() * alpha).real)
            term2[variance_idx] = ((y_alpha - sigmasq_eff * alpha_norm)
                                   / variance)
        term2[-1] = alpha_norm

    # --- stage 6: assemble all probe right-hand sides ----------------------
    with profiling.stage("6_monte_carlo_trace"):
        if probes is not None:
            Z, V = probes
            Z = torch.as_tensor(Z, device=dev).to(rdtype)
            V = torch.as_tensor(V, device=dev).to(rdtype)
        else:
            Z = _rademacher_rows(generator, T, n, rdtype, dev)
            V = _rademacher_rows(generator, T, M, rdtype, dev)
        # this rank's probe rows; the means divide by the count of all rows
        T = Z.shape[0]
        T_all = sh.n_probes(T)

        if tk > 0:
            fadjZ = fadj(Z.to(cdtype))                            # (T, M)
            Di_FZ = torch.stack([Dprime[:, i] * fadjZ
                                 for i in trace_kernel_indices])   # (tk, T, M)
            Di_FZ_flat = Di_FZ.reshape(tk * T, M)
            rhs_data = fwd(Di_FZ_flat)                            # (tk*T, n)
            B_kernel = ws * toeplitz(Di_FZ_flat)                  # (tk*T, M)
        else:
            B_kernel = torch.zeros((0, M), dtype=cdtype, device=dev)

        B_noise = ws * toeplitz(ws * V.to(cdtype))                # (T, M)
        B_all = torch.cat([B_kernel, B_noise], dim=0)

    # --- stage 7: one batched solve for every probe system -----------------
    with profiling.stage("7_batch_cg_solve"):
        if use_dense:
            res_trace = solve(B_all)
        else:
            res_trace = pcg(A_mean, B_all, tol=cg_tol, maxiter=maxiter,
                            M_inv=trace_M_inv)
        Beta_all = res_trace.x

    # --- stage 7.5: assemble term1 -----------------------------------------
    with profiling.stage("7.5_compute_alpha"):
        term1 = torch.zeros((num_hypers,), dtype=rdtype, device=dev)
        if tk > 0:
            Beta_kernel = ws * Beta_all[:tk * T]
            fwdBeta = fwd(Beta_kernel)                            # (tk*T, n)
            Alpha = ((rhs_data - fwdBeta) / sig_c).reshape(tk, T, -1)
            t1_kernel = sh.probes(torch.sum(sh.points(
                torch.sum(Z[None, :, :].to(cdtype) * Alpha, dim=2).real),
                dim=1)) / T_all
            for slot, idx in enumerate(trace_kernel_indices):
                term1[idx] = t1_kernel[slot]

        Beta_noise = Beta_all[tk * T:]
        term1_noise = (n / sigmasq_eff
                       - sh.probes(torch.sum(
                           torch.sum(V.to(cdtype).conj() * Beta_noise,
                                     dim=1).real / sigmasq_eff)) / T_all)
        if variance_idx is not None:
            term1[variance_idx] = (n - sigmasq_eff * term1_noise) / variance
        term1[-1] = term1_noise

    # --- stage 8: gradient -------------------------------------------------
    with profiling.stage("8_gradient_calculation"):
        grad = 0.5 * (term1 - term2)

    # --- stage 9: optional SLQ log marginal --------------------------------
    if compute_log_marginal:
        with profiling.stage("9_log_marginal_likelihood"):
            det_term = logdet_slq(ws, sigmasq_eff, toeplitz, generator,
                                  probes=log_marginal_probes,
                                  steps=log_marginal_steps, n=n)
            vdot_term = sh.points(torch.sum(yc.conj() * alpha).real)
            log_marginal = (-0.5 * vdot_term - 0.5 * det_term
                            - 0.5 * n * math.log(2 * math.pi))
    else:
        log_marginal = torch.tensor(float("nan"), dtype=rdtype, device=dev)

    return GradientResult(
        grad=grad, beta=beta_raw, log_marginal=log_marginal,
        mean_cg_iters=res_mean.iters,
        trace_cg_iters=sh.probe_max(res_trace.iters),
        trace_conv_iters=sh.gather_probe_rows(res_trace.conv_iters, tk + 1))


def gradient(x, y, kernel, sigmasq, eps, generator=None, *,
             trace_samples: int = 10, cg_tol: Optional[float] = None,
             device="cuda", **kwargs) -> GradientResult:
    """Plan the grid (bisection, float64 on the host, integral method) for
    the data's extent, then run :func:`gradient_with_grid`.  ``cg_tol``
    defaults to ``eps``."""
    dev = resolve_device(device)
    x = _as_points(x, dev)
    L = float((x.max(dim=0).values - x.min(dim=0).values).max())
    if L <= 1e-9:
        L = 1.0
    _, h, mtot = spectral_grid(kernel, eps, L, use_integral=True)
    if cg_tol is None:
        cg_tol = eps
    return gradient_with_grid(x, y, kernel, sigmasq, h, generator, mtot=mtot,
                              trace_samples=trace_samples, cg_tol=cg_tol,
                              device=dev, **kwargs)
