"""Polya-Gamma variational GP core; port of ``gpquad/models/pg_core.py``.

The EFGP structured-operator core, reused for the PG-augmented GP:

  - the *weighted* Gram ``F* diag(Delta) F``, a multilevel Toeplitz matrix
    whose lag table is one type-1 NUFFT of Delta on the doubled grid
    (``nufft1_2d`` at ``2 mtot - 1`` on the card at d=2);
  - a damped fixed point on the diagonal PG variational parameters Delta,
    with Hutchinson probes estimating diag(Sigma): one batched type-1 of
    ``[kappa; probes]``, one batched PCG, one batched type-2 an iteration;
  - the symmetrised feature-space solver ``(I + Ds F* Omega F Ds)`` of the
    M-step, the beta-mean solve and every predictive-variance mode, with
    the Kronecker eigen-preconditioner at a unit identity coefficient;
  - Bernoulli and negative-binomial Polya-Gamma likelihood maths, the
    logistic-Gaussian moment approximation and the Gauss-Hermite
    total-count gradient.

Plain functions on tensors in the points' dtype.  The NUFFTs go through
``ops.nufft.make_nufft``, which launches the hand-written CUDA kernels for
points on the card; the probes are arguments (the estimator draws them).
gpquad compiles each pass once per grid bucket; here each is eager, and
the E-step's damped fixed point is a Python loop.

Inside ``collectives.sharded`` (``gpquad_torch.parallel.
sharded_pg_outer_step``) the points and the point axis of the probes are
this rank's block, and the probe rows may be split too: every type-1 over
the training points is reduced over the point ranks, the probe means over
the probe ranks.
"""
from __future__ import annotations

import dataclasses
import functools
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import collectives
from ..ops.cg import pcg
from ..ops.dense_solve import (DENSE_SOLVER_MAX_M, dense_inverse,
                               dense_toeplitz, refine_solve)
from ..ops.kron_precond import kron_eig_build, make_kron_precond
from ..ops.nufft import make_nufft
from ..ops.operators import convolution_vector
from ..ops.toeplitz import ToeplitzND, make_toeplitz, toeplitz_diag_scale
from .efgp import (_as_points, _cdtype, _full_fp32_matmul,
                   posterior_fourier_rows, tensor_grid)

__all__ = [
    "PGSpectralState", "build_pg_spectral_state", "weighted_toeplitz",
    "weighted_toeplitz_from_points",
    "pg_omega_expectation", "approximate_logistic_gaussian_prob",
    "negative_binomial_gaussian_mean", "expected_log_sigmoid_neg_gaussian",
    "negative_binomial_total_count_gradient",
    "EstepResult", "estep_pass", "MstepResult", "mstep_gradient",
    "solve_beta_mean", "outer_step", "OuterStepResult",
    "predictive_mean", "predictive_variance_exact",
    "predictive_variance_exact_batched",
    "dense_feature_system", "predictive_variance_exact_dense",
    "stochastic_variance_sums", "evaluate_variance_sums",
    "chebyshev_lobatto_nodes", "barycentric_matrix",
    "predictive_variance_chebyshev", "DENSE_SOLVER_MAX_M",
]


# ---------------------------------------------------------------------------
# likelihood maths
# ---------------------------------------------------------------------------

def approximate_logistic_gaussian_prob(mean, variance=None):
    """E[sigmoid(F)] for Gaussian F via sigmoid(m / sqrt(1 + pi v / 8))."""
    if variance is None:
        return torch.sigmoid(mean)
    safe = torch.clamp(variance, min=0.0)
    return torch.sigmoid(mean / torch.sqrt(1.0 + (np.pi / 8.0) * safe))


def negative_binomial_gaussian_mean(mean, variance, *, total_count):
    """E[count] = r exp(m + v/2)."""
    return total_count * torch.exp(mean + 0.5 * torch.clamp(variance,
                                                             min=0.0))


def pg_omega_expectation(c, pg_b):
    """E[omega | c] = b/(2c) tanh(c/2), small-c limit b/4."""
    safe = torch.clamp(c, min=1e-12)
    mean = 0.5 * pg_b * torch.tanh(0.5 * safe) / safe
    return torch.where(c > 1e-8, mean, 0.25 * pg_b)


@lru_cache(maxsize=None)
def _gauss_hermite_normal_rule(num_nodes: int):
    """Nodes and weights (numpy float64) for E_{z~N(0,1)} f(z)."""
    base_nodes, base_weights = np.polynomial.hermite.hermgauss(num_nodes)
    return (np.sqrt(2.0) * base_nodes, base_weights / np.sqrt(np.pi))


def expected_log_sigmoid_neg_gaussian(mean, variance, *,
                                      quadrature_nodes: int):
    """E[log sigmoid(-F)] for Gaussian F by Gauss-Hermite quadrature."""
    nodes, weights = _gauss_hermite_normal_rule(quadrature_nodes)
    nodes = torch.as_tensor(nodes, dtype=mean.dtype, device=mean.device)
    weights = torch.as_tensor(weights, dtype=mean.dtype, device=mean.device)
    std = torch.sqrt(torch.clamp(variance, min=0.0))
    pts = mean[..., None] + std[..., None] * nodes
    return torch.sum(F.logsigmoid(-pts) * weights, dim=-1)


def negative_binomial_total_count_gradient(targets, mean, variance, *,
                                           total_count,
                                           quadrature_nodes: int):
    """d ELBO / d r of the negative-binomial likelihood (a 0-d tensor)."""
    r = torch.as_tensor(total_count, dtype=mean.dtype, device=mean.device)
    els = expected_log_sigmoid_neg_gaussian(mean, variance,
                                            quadrature_nodes=quadrature_nodes)
    return torch.sum(torch.special.digamma(targets + r)
                     - torch.special.digamma(r) + els)


# ---------------------------------------------------------------------------
# spectral state and the weighted Toeplitz
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PGSpectralState:
    """EFGP grid artefacts of the PG model: the grid spacing, the
    quadrature weights ``ws = sqrt(S h^d)`` and ``ws2 = S h^d`` (complex,
    flat (M,)), ``Dprime = h^d dS/d(lengthscale, variance)`` ((M, 2),
    complex), the NUFFT operator of the training points and the grid's
    ``mtot`` and ``d``.

    ``toeplitz``, the unweighted Gram ``F* F``, is kept for parity and
    diagnostics and built on first use: no pass of the model reads it (in
    gpquad the compiler drops it from the fused step), and building it is
    one type-1 NUFFT on the doubled grid."""
    h: torch.Tensor            # 0-d, the points' dtype
    ws: torch.Tensor           # (M,) complex sqrt(S h^d)
    ws2: torch.Tensor          # (M,) complex S h^d
    Dprime: torch.Tensor       # (M, H) complex h^d dS/dtheta
    nufft: object              # make_nufft(x, h, mtot)
    x: torch.Tensor            # (n, d) the training points
    mtot: int = 0
    d: int = 1

    @property
    def M(self) -> int:
        return self.mtot ** self.d

    @functools.cached_property
    def toeplitz(self) -> ToeplitzND:
        return make_toeplitz(convolution_vector((self.mtot - 1) // 2,
                                                self.x, self.h))


def build_pg_spectral_state(x, kernel, h, *, mtot: int,
                            ws_mask=None) -> PGSpectralState:
    """Grid, weights and operators for points ``x`` (n, d) in their dtype;
    ``ws_mask`` ((M,), optional) zeroes the surplus nodes of a bucketed
    grid in ``ws`` and ``Dprime``."""
    if x.ndim == 1:
        x = x[:, None]
    d = x.shape[1]
    rdtype, dev = x.dtype, x.device
    cdtype = _cdtype(rdtype)
    h = torch.as_tensor(h, dtype=rdtype, device=dev)
    kernel = kernel.with_hypers(kernel.hyper_vector().to(dev, rdtype))
    m = (mtot - 1) // 2
    xis = tensor_grid(torch.arange(-m, m + 1, dtype=rdtype, device=dev) * h,
                      d)
    s = kernel.spectral_density(xis)
    if ws_mask is not None:
        ws_mask = torch.as_tensor(ws_mask, device=dev).to(rdtype)
        s = s * ws_mask
    ws2 = (s * h ** d).to(cdtype)
    ws = torch.sqrt(ws2)
    Dprime = (h ** d) * kernel.spectral_grad(xis)
    if ws_mask is not None:
        Dprime = Dprime * ws_mask[:, None]
    return PGSpectralState(h=h, ws=ws, ws2=ws2, Dprime=Dprime.to(cdtype),
                           nufft=make_nufft(x, h, mtot), x=x, mtot=mtot, d=d)


def weighted_toeplitz_from_points(x, h, mtot: int, delta) -> ToeplitzND:
    """``F* diag(delta) F`` for points ``x``: the lag table is the type-1
    NUFFT of ``delta`` on the doubled grid (``2 mtot - 1`` a side)."""
    if x.ndim == 1:
        x = x[:, None]
    op = make_nufft(x, h, 2 * mtot - 1)
    return make_toeplitz(collectives.current().points(
        op.type1(delta.to(_cdtype(x.dtype)))))


def weighted_toeplitz(spectral: PGSpectralState, x, delta) -> ToeplitzND:
    """Exact weighted Gram ``F* diag(delta) F`` as a Toeplitz operator."""
    return weighted_toeplitz_from_points(x, spectral.h, spectral.mtot, delta)


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------

def _wtoe_kron_precond(Ds, wtoe: ToeplitzND, mtot: int, d: int):
    """Kronecker eigen-preconditioner of ``I + Ds T_w Ds`` (the EFGP
    preconditioner with a unit identity coefficient and delta as the point
    measure).  The weighted lag table comes back from the cached kernel
    spectrum by an inverse FFT."""
    Ls = tuple(2 * n - 1 for n in wtoe.ns)
    dims = tuple(range(-len(Ls), 0))
    v = torch.fft.ifftn(wtoe.fft_kernel, dim=dims)[
        tuple(slice(0, L) for L in Ls)]
    kp = kron_eig_build(Ds, v, 1.0, mtot=mtot, d=d,
                        diag_scale=toeplitz_diag_scale(v))
    return make_kron_precond(kp)


def _floored_Ds(spectral: PGSpectralState) -> torch.Tensor:
    """``Ds = sqrt(max(ws2, eps_d))``, ``eps_d = max(mean(ws2) 1e-14,
    1e-14)``, complex."""
    D2 = spectral.ws2.real
    eps_d = torch.clamp(torch.mean(D2) * 1e-14, min=1e-14)
    return torch.sqrt(torch.maximum(D2, eps_d)).to(spectral.ws.dtype)


def _feature_solver(spectral: PGSpectralState, wtoe: ToeplitzND, *,
                    cg_tol: float, max_cg_iter: int = 2000):
    """Symmetrised solver of ``A = I + Ds F* Omega F Ds``: ``solve(q) ->
    (beta, iters)`` with ``beta = Ds^-1 (I + Ds T_w Ds)^-1 Ds q`` by one
    batched PCG over the rows of ``q``."""
    Ds = _floored_Ds(spectral)
    Ds_inv = 1.0 / Ds
    M_inv = _wtoe_kron_precond(Ds, wtoe, spectral.mtot, spectral.d)

    def apply_IpS(Y):
        return Y + Ds * wtoe(Ds * Y)

    def solve(q):
        rhs = Ds * q.to(Ds.dtype)
        res = pcg(apply_IpS, rhs, tol=cg_tol, maxiter=max_cg_iter,
                  M_inv=M_inv)
        return Ds_inv * res.x, res.iters

    return solve


# ---------------------------------------------------------------------------
# E-step
# ---------------------------------------------------------------------------

class EstepResult(NamedTuple):
    delta: torch.Tensor
    mean: torch.Tensor
    sigma_diag: torch.Tensor
    residual: torch.Tensor
    cg_iters: torch.Tensor
    iters_used: int


def estep_pass(spectral: PGSpectralState, x, delta0, kappa, pg_b, probes, *,
               max_iters: int, rho0: float, gamma: float, cg_tol: float,
               max_cg_iter: int = 2000, tol=0.0) -> EstepResult:
    """Damped fixed point on the PG variational diagonal Delta.

    Each iteration applies Sigma = F D (I + D F* Delta F D)^-1 D F* to
    ``[kappa; probes]`` with one batched PCG, estimates diag(Sigma) by the
    probes' correlation and updates Delta <- (1 - rho) Delta + rho
    E[omega | c], rho = rho0 / (1 + gamma it).

    ``tol`` stops early: once ``max|Delta - Lambda| < tol`` after an
    iteration, the next ones do not run, and ``iters_used`` counts the
    iterations that ran.  The check gates the next iteration, so the
    residual is read on the host only when ``max_iters > 1``.
    """
    sh = collectives.current()
    rdtype = kappa.dtype
    cdtype = spectral.ws.dtype
    n = kappa.shape[0]
    n_probes = probes.shape[0]
    ws = spectral.ws
    delta = delta0
    mean = torch.zeros((n,), dtype=rdtype, device=kappa.device)
    sigma_diag = torch.zeros_like(mean)
    iters = torch.zeros((), dtype=torch.int32, device=kappa.device)
    residual = torch.full((), float("inf"), dtype=rdtype,
                          device=kappa.device)
    tol = float(tol)
    used = 0
    Z = torch.cat([kappa[None, :], probes], dim=0).to(cdtype)
    for it in range(max_iters):
        if it > 0 and bool(residual < tol):
            break
        wtoe = weighted_toeplitz_from_points(x, spectral.h, spectral.mtot,
                                             delta)
        rhs = ws[None, :] * sh.points(spectral.nufft.type1(Z)).reshape(
            Z.shape[0], -1)

        def A_feat(u, wtoe=wtoe):
            return u + ws * wtoe(ws * u)

        M_inv = _wtoe_kron_precond(ws, wtoe, spectral.mtot, spectral.d)
        res = pcg(A_feat, rhs, tol=cg_tol, maxiter=max_cg_iter, M_inv=M_inv)
        S_all = spectral.nufft.type2(ws[None, :] * res.x).real
        mean = S_all[0]
        Sz = S_all[1:]
        sigma_diag = (sh.probes(torch.sum(probes * Sz, dim=0))
                      / sh.n_probes(n_probes) if n_probes > 0
                      else torch.zeros_like(mean))
        c = torch.sqrt(torch.clamp(sigma_diag + mean ** 2, min=1e-12))
        Lam = pg_omega_expectation(c, pg_b)
        rho = rho0 / (1.0 + gamma * it)
        delta = torch.clamp((1.0 - rho) * delta + rho * Lam, min=0.0)
        residual = sh.all_max(torch.max(torch.abs(delta - Lam)))
        iters = sh.probe_max(res.iters)
        used += 1
    return EstepResult(delta=delta, mean=mean, sigma_diag=sigma_diag,
                       residual=residual, cg_iters=iters, iters_used=used)


# ---------------------------------------------------------------------------
# M-step
# ---------------------------------------------------------------------------

class MstepResult(NamedTuple):
    grad: torch.Tensor        # (H,) d ELBO / d (lengthscale, variance)
    term1: torch.Tensor
    term2: torch.Tensor
    beta_mean: torch.Tensor
    cg_iters: torch.Tensor


def mstep_gradient(spectral: PGSpectralState, x, delta, kappa, probes, *,
                   cg_tol: float, max_cg_iter: int = 2000) -> MstepResult:
    """Stochastic M-step gradient with respect to (lengthscale, variance):

      term1 = Dprime^T |beta_kappa|^2                      (data-fit pull)
      term2 = E_probes Re[(conj(F* Omega z) . beta_z)^T Dprime]   (trace)
      grad  = 0.5 (term1 - term2), the ELBO's ascent direction.
    """
    sh = collectives.current()
    cdtype = spectral.ws.dtype
    wtoe = weighted_toeplitz_from_points(x, spectral.h, spectral.mtot, delta)
    solve = _feature_solver(spectral, wtoe, cg_tol=cg_tol,
                            max_cg_iter=max_cg_iter)
    n_probes = probes.shape[0]
    pz = probes.to(cdtype)
    nufft = spectral.nufft
    Q = sh.points(nufft.type1(pz)).reshape(n_probes, -1)
    q_y = sh.points(nufft.type1(kappa.to(cdtype))).reshape(-1)
    beta_all, iters = solve(torch.cat([Q, q_y[None, :]], dim=0))
    beta_probes, beta_k = beta_all[:-1], beta_all[-1]
    Rfeat = sh.points(nufft.type1(delta.to(cdtype) * pz)).reshape(n_probes,
                                                                  -1)
    vals = ((torch.conj(Rfeat) * beta_probes) @ spectral.Dprime).real
    term2 = sh.probes(torch.sum(vals, dim=0)) / sh.n_probes(n_probes)
    iters = sh.probe_max(iters)
    term1 = spectral.Dprime.real.T @ torch.abs(beta_k) ** 2
    grad = 0.5 * (term1 - term2)
    return MstepResult(grad=grad, term1=term1, term2=term2,
                       beta_mean=beta_k, cg_iters=iters)


def solve_beta_mean(spectral: PGSpectralState, x, delta, kappa, *,
                    cg_tol: float, max_cg_iter: int = 2000):
    """Posterior-mean feature weights ``beta`` (M,) and the PCG's
    iterations."""
    cdtype = spectral.ws.dtype
    wtoe = weighted_toeplitz_from_points(x, spectral.h, spectral.mtot, delta)
    solve = _feature_solver(spectral, wtoe, cg_tol=cg_tol,
                            max_cg_iter=max_cg_iter)
    q_y = collectives.current().points(
        spectral.nufft.type1(kappa.to(cdtype))).reshape(-1)
    beta, iters = solve(q_y[None, :])
    return beta[0], iters


# ---------------------------------------------------------------------------
# predictions
# ---------------------------------------------------------------------------

def _points(x_new, spectral: PGSpectralState):
    return _as_points(x_new, spectral.h.device, spectral.h.dtype)


def predictive_mean(spectral: PGSpectralState, x_new, beta_mean):
    """Latent predictive mean ``F_new (ws2 beta)``: one type-2 NUFFT."""
    x_new = _points(x_new, spectral)
    op = make_nufft(x_new, spectral.h, spectral.mtot)
    return op.type2((spectral.ws2 * beta_mean)
                    .reshape((spectral.mtot,) * spectral.d)).real


def _target_rows(spectral: PGSpectralState, x_new):
    """``phi = conj(exp(+2 pi i x . xi))`` at the targets, (B, M)."""
    return torch.conj(posterior_fourier_rows(x_new, spectral.h,
                                             spectral.mtot, spectral.d))


def _variance_exact_from_op(spectral: PGSpectralState, wtoe: ToeplitzND,
                            x_new, *, cg_tol: float,
                            max_cg_iter: int = 2000):
    """Exact per-target latent variance ``phi^H ws2 A^-1 phi`` against a
    prebuilt weighted Toeplitz operator, one batched PCG."""
    solve = _feature_solver(spectral, wtoe, cg_tol=cg_tol,
                            max_cg_iter=max_cg_iter)
    phi = _target_rows(spectral, x_new)
    beta, _ = solve(phi)
    return torch.clamp(torch.sum(torch.conj(phi) * (spectral.ws2[None, :]
                                                    * beta), dim=1).real,
                       min=0.0)


def predictive_variance_exact(spectral: PGSpectralState, x, delta, x_new, *,
                              cg_tol: float, max_cg_iter: int = 2000):
    """Exact per-target latent variance by the symmetrised solver."""
    x_new = _points(x_new, spectral)
    wtoe = weighted_toeplitz_from_points(x, spectral.h, spectral.mtot, delta)
    return _variance_exact_from_op(spectral, wtoe, x_new, cg_tol=cg_tol,
                                   max_cg_iter=max_cg_iter)


def dense_feature_system(spectral: PGSpectralState, x, delta):
    """Materialise and invert ``A = I + Ds (F* diag(delta) F) Ds`` (M x M)
    once for a fixed posterior ``delta``; every prediction target then
    costs two matmuls.  Only for ``spectral.M <= DENSE_SOLVER_MAX_M``.
    Returns ``(A, P, Ds)`` with ``P ~ inv(A)``."""
    cdtype = spectral.ws.dtype
    op = make_nufft(x, spectral.h, 2 * spectral.mtot - 1)
    v = collectives.current().points(op.type1(delta.to(cdtype)))
    Tw = dense_toeplitz(v, spectral.mtot, spectral.d)
    Ds = _floored_Ds(spectral)
    A = Ds[:, None] * Tw * Ds[None, :] + torch.eye(
        Tw.shape[0], dtype=cdtype, device=Tw.device)
    return A, dense_inverse(A), Ds


def _variance_exact_dense_apply(spectral: PGSpectralState, A, P, Ds, x_new,
                                *, passes: int):
    phi = _target_rows(spectral, x_new)
    res = refine_solve(A, P, Ds[None, :] * phi, passes=passes)
    beta = res.x / Ds[None, :]
    return torch.clamp(torch.sum(torch.conj(phi) * (spectral.ws2[None, :]
                                                    * beta), dim=1).real,
                       min=0.0)


def predictive_variance_exact_dense(spectral: PGSpectralState, x, delta,
                                    x_new, *, batch_size=None, system=None,
                                    passes=None):
    """Exact variance of all targets from one dense factorisation.

    ``system``: a prebuilt ``(A, P, Ds)`` from :func:`dense_feature_system`
    (the estimators cache it; ``delta`` is frozen after the fit).
    ``batch_size`` bounds the (B, M) rows a batch (default min(4096,
    targets)); ``passes`` of refinement default to 1 in complex128, 2 in
    complex64."""
    if spectral.M > DENSE_SOLVER_MAX_M:
        raise ValueError(
            f"dense prediction solver needs M <= {DENSE_SOLVER_MAX_M}; "
            f"got M = {spectral.M}. Use solver='cg'.")
    x_new = _points(x_new, spectral)
    A, P, Ds = (dense_feature_system(spectral, x, delta)
                if system is None else system)
    if passes is None:
        passes = 1 if A.dtype == torch.complex128 else 2
    b = min(4096, x_new.shape[0]) if batch_size is None else int(batch_size)
    return torch.cat([_variance_exact_dense_apply(spectral, A, P, Ds, xb,
                                                  passes=passes)
                      for xb in torch.split(x_new, max(1, b))])


def predictive_variance_exact_batched(spectral: PGSpectralState, x, delta,
                                      x_new, *, batch_size, cg_tol: float,
                                      max_cg_iter: int = 2000):
    """Exact variance by PCG in chunks of ``batch_size`` targets (the (B, M)
    rows bound the memory), with the weighted Toeplitz built once for all
    chunks.  gpquad pads the last chunk to ``batch_size`` rows so that its
    compiled step is reused; the PCG's rows are independent, so the port
    does not pad."""
    x_new = _points(x_new, spectral)
    if batch_size is None or x_new.shape[0] <= int(batch_size):
        return predictive_variance_exact(spectral, x, delta, x_new,
                                         cg_tol=cg_tol,
                                         max_cg_iter=max_cg_iter)
    wtoe = weighted_toeplitz_from_points(x, spectral.h, spectral.mtot, delta)
    return torch.cat([_variance_exact_from_op(spectral, wtoe, xb,
                                              cg_tol=cg_tol,
                                              max_cg_iter=max_cg_iter)
                      for xb in torch.split(x_new, int(batch_size))])


def stochastic_variance_sums(spectral: PGSpectralState, x, delta, etas, *,
                             cg_tol: float, max_cg_iter: int = 2000):
    """Hutchinson lag sums of the stochastic predictive variance, on the
    doubled grid ((2 mtot - 1,)*d, FFT order)."""
    cdtype = spectral.ws.dtype
    wtoe = weighted_toeplitz_from_points(x, spectral.h, spectral.mtot, delta)
    solve = _feature_solver(spectral, wtoe, cg_tol=cg_tol,
                            max_cg_iter=max_cg_iter)
    J = etas.shape[0]
    beta, _ = solve(etas.to(cdtype))
    gammas = spectral.ws2[None, :] * beta
    mtot, d = spectral.mtot, spectral.d
    shape = (J,) + (mtot,) * d
    s_size = (2 * mtot - 1,) * d
    dims = tuple(range(1, d + 1))
    G = torch.fft.fftn(gammas.reshape(shape), s=s_size, dim=dims)
    E = torch.fft.fftn(etas.reshape(shape).to(G.dtype), s=s_size, dim=dims)
    return torch.mean(torch.fft.ifftn(G * torch.conj(E), dim=dims), dim=0)


def evaluate_variance_sums(spectral: PGSpectralState, est_sums, x_new):
    """The lag sums at the targets: one type-2 NUFFT in FFT order on the
    doubled grid."""
    x_new = _points(x_new, spectral)
    op = make_nufft(x_new, spectral.h, 2 * spectral.mtot - 1,
                    fft_order=True)
    return torch.clamp(op.type2(est_sums).real, min=0.0)


# ---------------------------------------------------------------------------
# Chebyshev-interpolated variance
# ---------------------------------------------------------------------------

def chebyshev_lobatto_nodes(a: float, b: float, n_nodes: int):
    """Chebyshev-Lobatto nodes on [a, b] and their barycentric weights,
    both float64 numpy, in ascending node order."""
    if n_nodes < 2:
        raise ValueError("chebyshev nodes must be at least 2.")
    k = np.arange(n_nodes, dtype=np.float64)
    nodes_std = np.cos(np.pi * k / (n_nodes - 1))
    weights = np.ones(n_nodes)
    weights[0] = 0.5
    weights[-1] = 0.5
    weights *= (-1.0) ** k
    nodes = 0.5 * (a + b) + 0.5 * (b - a) * nodes_std
    scale = 2.0 / (b - a) if b > a else 1.0
    order = np.argsort(nodes)
    return nodes[order], (weights * scale)[order]


def barycentric_matrix(nodes, weights, targets, *, atol: float = 1e-14):
    """Barycentric interpolation rows (targets, nodes), float64 numpy;
    targets within ``atol`` of a node take its one-hot row."""
    nodes = np.asarray(nodes, np.float64)
    weights = np.asarray(weights, np.float64)
    targets = np.asarray(targets, np.float64)
    diff = targets[:, None] - nodes[None, :]
    mat = np.empty((targets.size, nodes.size))
    close = np.isclose(diff, 0.0, atol=atol, rtol=0.0)
    matched = close.any(axis=1)
    if np.any(matched):
        idx = np.argmax(close[matched], axis=1)
        mat[matched] = 0.0
        mat[np.where(matched)[0], idx] = 1.0
    un = ~matched
    if np.any(un):
        with np.errstate(divide="ignore", invalid="ignore"):
            raw = weights[None, :] / diff[un]
        mat[un] = raw / raw.sum(axis=1, keepdims=True)
    return mat


def predictive_variance_chebyshev(spectral: PGSpectralState, x, delta,
                                  x_new, *, n_nodes_per_dim: int,
                                  cg_tol: float, max_cg_iter: int = 2000,
                                  batch_size=None, solver: str = "cg",
                                  system=None):
    """The exact variance on a Chebyshev-Lobatto tensor grid over the
    targets' box (dense or CG, in ``batch_size`` chunks), barycentric-
    interpolated to the targets."""
    x_new = _points(x_new, spectral)
    xh = x_new.cpu().numpy()
    d = xh.shape[1]
    axes_nodes, mats = [], []
    for dim in range(d):
        coord = xh[:, dim]
        lo, hi = float(coord.min()), float(coord.max())
        if np.isclose(lo, hi):
            pad = max(abs(lo), 1.0) * 1e-6
            lo, hi = lo - pad, hi + pad
        nodes, weights = chebyshev_lobatto_nodes(lo, hi, n_nodes_per_dim)
        mats.append(torch.as_tensor(barycentric_matrix(nodes, weights, coord),
                                    device=x_new.device))
        axes_nodes.append(nodes)
    mesh = np.stack(np.meshgrid(*axes_nodes, indexing="ij"), -1).reshape(-1, d)
    mesh_t = torch.as_tensor(mesh, dtype=x_new.dtype, device=x_new.device)
    if solver == "dense":
        node_var = predictive_variance_exact_dense(
            spectral, x, delta, mesh_t, batch_size=batch_size, system=system)
    else:
        node_var = predictive_variance_exact_batched(
            spectral, x, delta, mesh_t, batch_size=batch_size, cg_tol=cg_tol,
            max_cg_iter=max_cg_iter)
    node_grid = node_var.reshape((n_nodes_per_dim,) * d)
    letters = "abcdefghij"[:d]
    expr = ",".join(f"n{c}" for c in letters) + "," + letters + "->n"
    # full fp32: the rows' alternating-sign weights lose ~4e-3 of the
    # variance's scale in a reduced-precision contraction
    with _full_fp32_matmul():
        interp = torch.einsum(expr, *[m.to(node_grid.dtype) for m in mats],
                              node_grid)
    return torch.clamp(interp, min=0.0)


# ---------------------------------------------------------------------------
# one outer iteration
# ---------------------------------------------------------------------------

class OuterStepResult(NamedTuple):
    delta: torch.Tensor
    mean: torch.Tensor
    sigma_diag: torch.Tensor
    e_residual: torch.Tensor
    e_iters_used: int
    e_cg_iters: torch.Tensor
    m_grad: torch.Tensor
    m_cg_iters: torch.Tensor
    raw: torch.Tensor
    opt_state: torch.optim.Optimizer


def outer_step(x, kern, h, ws_mask, delta, kappa, pg_b, e_probes, m_probes,
               raw, opt, *, mtot: int, e_iters: int, rho0: float,
               gamma: float, e_tol, cg_tol: float,
               max_cg_iter: int = 2000) -> OuterStepResult:
    """One EM outer iteration: the spectral state, the damped E-step, the
    stochastic M-step and the Adam ascent on ``raw = log(lengthscale,
    variance)`` (``opt``, a ``torch.optim.Adam`` over ``[raw]``, updates
    ``raw`` in place on ``-grad * exp(raw)``).  The M-step probes are an
    argument; gpquad draws them inside from its key."""
    spectral = build_pg_spectral_state(x, kern, h, mtot=mtot,
                                       ws_mask=ws_mask)
    eres = estep_pass(spectral, x, delta, kappa, pg_b, e_probes,
                      max_iters=e_iters, rho0=rho0, gamma=gamma,
                      cg_tol=cg_tol, max_cg_iter=max_cg_iter, tol=e_tol)
    mres = mstep_gradient(spectral, x, eres.delta, kappa, m_probes,
                          cg_tol=cg_tol, max_cg_iter=max_cg_iter)
    grad = mres.grad.real
    raw.grad = -(grad * torch.exp(raw)).to(raw.dtype)
    opt.step()
    return OuterStepResult(delta=eres.delta, mean=eres.mean,
                           sigma_diag=eres.sigma_diag,
                           e_residual=eres.residual,
                           e_iters_used=eres.iters_used,
                           e_cg_iters=eres.cg_iters, m_grad=grad,
                           m_cg_iters=mres.cg_iters, raw=raw, opt_state=opt)
