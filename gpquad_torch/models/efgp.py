"""EFGP regression serving path: fit, posterior mean, and the posterior
variance by exact per-target solves ("regular"), Hutchinson probes
("stochastic") or Chebyshev interpolation of exact node solves
("chebyshev").

Port of ``gpquad/models/efgp.py``.  Plain functions on tensors: the fit
returns a :class:`FitState` dataclass, and prediction reads it.  The NUFFTs
go through ``ops.nufft.make_nufft``, which launches the hand-written CUDA
kernels for d=1, d=2 and d=3 points on the card; the Gram matvec is the FFT
Toeplitz operator; solves are the dense factor-solve for
``M <= DENSE_SOLVER_MAX_M`` and batched PCG beyond, preconditioned by Jacobi,
the dense-head deflation block or the Kronecker eigen-preconditioner.

Every entry point takes ``device=`` (default ``"cuda"``) or reads the
state's device, and fails when CUDA is asked for and absent.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops import collectives
from ..ops.cg import CGResult, pcg
from ..ops.deflation import (DEFLATION_RANK, deflation_block,
                             make_block_precond)
from ..ops.dense_solve import (DENSE_SOLVER_MAX_M, dense_gram, dense_inverse,
                               refine_solve)
from ..ops.kron_precond import KronPrecond, kron_eig_build, make_kron_precond
from ..ops.nufft import SPREADING, make_nufft, make_phase_nufft
from ..ops.operators import (convolution_vector, make_A_mean, make_A_var,
                             make_jacobi_precond)
from ..ops.toeplitz import ToeplitzND, _next_smooth, make_toeplitz, \
    toeplitz_diag_scale
from ..quadrature import spectral_grid
from ..utils import profiling

__all__ = ["FitState", "resolve_device", "resolve_solver", "resolve_precond",
           "tensor_grid", "quadrature_weights", "fit_with_grid", "fit",
           "plan_nufft_caps", "predict_mean", "predict_var",
           "posterior_fourier_rows"]

_PROBE_CHUNK = 256


def _cdtype(rdtype):
    return torch.complex64 if rdtype == torch.float32 else torch.complex128


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for and absent:
    the port never moves to the CPU by itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gpquad_torch: device 'cuda' was requested but torch sees no "
            "CUDA device; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass
class FitState:
    """Cached fit artifacts."""
    beta: torch.Tensor            # (M,) complex Fourier weights
    ws: torch.Tensor              # (M,) complex quadrature weights sqrt(S h^d)
    h: torch.Tensor               # 0-d grid spacing
    sigmasq: torch.Tensor         # 0-d noise variance
    toeplitz: ToeplitzND          # Gram operator F*F
    mean_cg_iters: torch.Tensor
    diag_scale: torch.Tensor      # Toeplitz zero-lag (= n), Jacobi scale
    A_dense: Optional[torch.Tensor] = None   # (M, M) dense A (dense solver)
    P_dense: Optional[torch.Tensor] = None   # (M, M) inv(A) (dense solver)
    defl_idx: Optional[torch.Tensor] = None  # (k,) deflated mode indices
    defl_P: Optional[torch.Tensor] = None    # (k, k) inv(A[B, B])
    kron: Optional[KronPrecond] = None       # Kronecker eigen-preconditioner
    mtot: int = 0
    d: int = 1

    @property
    def M(self) -> int:
        return self.mtot ** self.d

    @property
    def device(self) -> torch.device:
        return self.beta.device


def resolve_precond(precond: str, precond_rank: int, use_precond: bool,
                    d: int, n: Optional[int] = None,
                    M: Optional[int] = None) -> str:
    """Preconditioner family for the CG branch: 'auto' is deflation when
    ``precond_rank > 0``, else Jacobi (or none without ``use_precond``);
    'adaptive' is kron for n >= M at d <= 3 (and whenever n or M is not
    given), deflation otherwise.  As in gpquad, 'kron' at d > 3 silently
    becomes 'jacobi' (ROADMAP §C known quirk)."""
    if precond == "auto":
        family = "deflation" if precond_rank > 0 else (
            "jacobi" if use_precond else "none")
    elif precond == "adaptive":
        family = "deflation" if (d > 3 or (n is not None and M is not None
                                           and n < M)) else "kron"
    elif precond == "kron" and d > 3:
        family = "jacobi"
    elif precond in ("jacobi", "deflation", "kron", "none"):
        family = precond
    else:
        raise ValueError(f"Unknown precond '{precond}' "
                         "(auto | adaptive | jacobi | deflation | kron | none)")
    return family


def resolve_solver(solver: str, mtot: int, d: int) -> str:
    """'auto' picks the dense factor-solve for M <= DENSE_SOLVER_MAX_M,
    CG beyond."""
    if solver == "auto":
        return "dense" if mtot ** d <= DENSE_SOLVER_MAX_M else "cg"
    if solver not in ("dense", "cg"):
        raise ValueError(f"Unknown solver '{solver}' (auto | dense | cg)")
    return solver


def tensor_grid(xis_1d: torch.Tensor, d: int) -> torch.Tensor:
    """(mtot^d, d) tensor-product grid in ``ij`` order."""
    grids = torch.meshgrid(*([xis_1d] * d), indexing="ij")
    return torch.stack(grids, dim=-1).reshape(-1, d)


def quadrature_weights(kernel, xis_flat, h, d, *, mask=None):
    """ws = sqrt(S(xi) h^d), complex.  ``mask`` ((M,), optional) zeroes
    padded grid nodes so that a padded grid stays algebraically exact."""
    s = kernel.spectral_density(xis_flat)
    if mask is not None:
        s = s * torch.as_tensor(mask, dtype=s.dtype, device=s.device)
    return torch.sqrt(s.to(_cdtype(s.dtype)) * h.to(s.dtype) ** d)


def _as_points(x, device, dtype=None):
    x = torch.as_tensor(x, device=device, dtype=dtype)
    return x[:, None] if x.ndim == 1 else x


def plan_nufft_caps(x, h, mtot: int) -> tuple:
    """Host-side band caps of the banded backend: (the fit grid's, the
    doubled lag grid's), from one copy of the points to the host."""
    from ..ops.spread_banded import (_host_points, banded_plan_cap,
                                     banded_plan_cap_3d)
    xh = _host_points(x)
    m = (mtot - 1) // 2
    plan = banded_plan_cap if xh.shape[1] == 2 else banded_plan_cap_3d
    return plan(xh, float(h), mtot), plan(xh, float(h), 4 * m + 1)


def serving_method(nufft_method: str) -> str:
    """The backend of the posterior mean and the stochastic variance for a
    fit on ``nufft_method``: the spreading backends fit, and the exact
    default serves, as in gpquad (efgp.py:311, 462; pipeline.py:106)."""
    return "auto" if nufft_method in SPREADING else nufft_method


@profiling.spanned("fit_with_grid")
def fit_with_grid(x, y, kernel, sigmasq, h, mtot: int, *,
                  cg_tol: float = 1e-4, max_cg_iter: Optional[int] = None,
                  beta0: Optional[torch.Tensor] = None,
                  use_precond: bool = True, ws_mask=None,
                  nufft_method: str = "auto",
                  nufft_caps: Optional[tuple] = None,
                  solver: str = "auto",
                  precond_rank: int = 0,
                  precond: str = "auto",
                  fft_smooth: bool = False,
                  device="cuda") -> FitState:
    """Fit against a fixed frequency grid: quadrature weights, the NUFFT
    right-hand side ``ws * F* y``, the Toeplitz Gram from the lag table, and
    the mean solve (dense factor-solve or PCG).  ``precond_rank > 0`` (or
    ``precond="deflation"``, rank 2048 by default) preconditions the CG
    branch with the deflation block on the top-``precond_rank`` weight
    modes, ``precond="kron"`` with the Kronecker eigen-preconditioner; the
    state keeps either, so that the variance and the gradient reuse it.
    ``ws_mask`` ((M,), optional) zeroes padded grid nodes (a bucketed grid
    stays algebraically exact); ``fft_smooth`` pads the Toeplitz FFT to a
    2,3,5,7-smooth size instead of a power of two.  ``nufft_caps`` (the fit
    grid's and the lag grid's band caps, :func:`plan_nufft_caps`) serves
    ``nufft_method="banded"``; ``make_nufft`` plans a None cap on the host.
    Runs in ``x``'s floating dtype.  Inside ``collectives.sharded`` (the
    scale-out, ``gpquad_torch.parallel``) ``x`` and ``y`` are this rank's
    block of the points, and both type-1 sums are reduced over the ranks."""
    sh = collectives.current()
    dev = resolve_device(device)
    x = _as_points(x, dev)
    d = x.shape[1]
    n = sh.n_points(x.shape[0])
    rdtype = x.dtype
    cdtype = _cdtype(rdtype)
    y = torch.as_tensor(y, device=dev)
    h = torch.as_tensor(h, dtype=rdtype, device=dev)
    sigmasq = torch.as_tensor(sigmasq, dtype=rdtype, device=dev)
    kernel = kernel.with_hypers(kernel.hyper_vector().to(dev, rdtype))

    m = (mtot - 1) // 2
    xis_1d = torch.arange(-m, m + 1, dtype=rdtype, device=dev) * h
    if ws_mask is not None:
        ws_mask = torch.as_tensor(ws_mask, device=dev).to(rdtype)
    ws = quadrature_weights(kernel, tensor_grid(xis_1d, d), h, d,
                            mask=ws_mask)

    caps = nufft_caps or (None, None)
    nufft = make_nufft(x, h, mtot, method=nufft_method, cap=caps[0])
    rhs = ws * sh.points(nufft.type1(y.to(cdtype))).reshape(-1)

    v = sh.points(convolution_vector(m, x, h, nufft_method=nufft_method,
                                     cap=caps[1]))
    toeplitz = make_toeplitz(v, force_pow2=not fft_smooth)
    diag_scale = toeplitz_diag_scale(v)
    A_dense = P_dense = defl_idx = defl_P = kron = None
    if resolve_solver(solver, mtot, d) == "dense":
        A_dense = dense_gram(ws, v, mtot, d, sigmasq)
        P_dense = dense_inverse(A_dense)
        res = refine_solve(A_dense, P_dense, rhs, tol=cg_tol)
    else:
        family = resolve_precond(precond, precond_rank, use_precond, d,
                                 n=n, M=mtot ** d)
        M_inv = None
        if family == "kron":
            kron = kron_eig_build(ws, v, sigmasq, mtot=mtot, d=d,
                                  diag_scale=diag_scale)
            M_inv = make_kron_precond(kron)
        elif family == "deflation":
            defl_idx, defl_P = deflation_block(
                ws, v, sigmasq, mtot=mtot, d=d,
                rank=precond_rank if precond_rank > 0 else DEFLATION_RANK)
            M_inv = make_block_precond(
                defl_idx, defl_P, diag_scale * torch.abs(ws) ** 2 + sigmasq)
        elif family == "jacobi":
            M_inv = make_jacobi_precond(ws, sigmasq, diag_scale=diag_scale)
        if beta0 is not None:
            beta0 = torch.as_tensor(beta0, device=dev)
        res = pcg(make_A_mean(ws, sh.toeplitz(toeplitz), sigmasq), rhs,
                  beta0, tol=cg_tol,
                  maxiter=max_cg_iter if max_cg_iter is not None
                  else 2 * rhs.shape[0],
                  M_inv=M_inv)
    return FitState(beta=res.x, ws=ws, h=h, sigmasq=sigmasq,
                    toeplitz=toeplitz, mean_cg_iters=res.iters,
                    diag_scale=diag_scale, A_dense=A_dense, P_dense=P_dense,
                    defl_idx=defl_idx, defl_P=defl_P, kron=kron, mtot=mtot,
                    d=d)


def fit(x, y, kernel, sigmasq, eps: float = 1e-2, *, cg_tol: float = 1e-4,
        max_cg_iter: Optional[int] = None, beta0=None,
        use_precond: bool = True, solver: str = "auto",
        precond_rank: int = 0, precond: str = "auto",
        nufft_method: str = "auto", device="cuda") -> FitState:
    """Plan the quadrature grid for the data's extent, then solve."""
    dev = resolve_device(device)
    x = _as_points(x, dev)
    L = float((x.max(dim=0).values - x.min(dim=0).values).max())
    if L <= 1e-9:
        L = 1.0
    _, h, mtot = spectral_grid(kernel, eps, L, use_integral=True)
    return fit_with_grid(x, y, kernel, sigmasq, h, mtot, cg_tol=cg_tol,
                         max_cg_iter=max_cg_iter, beta0=beta0,
                         use_precond=use_precond, nufft_method=nufft_method,
                         solver=solver, precond_rank=precond_rank,
                         precond=precond, device=dev)


# ---------------------------------------------------------------------------
# prediction
# ---------------------------------------------------------------------------

@profiling.spanned("predict_mean")
def predict_mean(state: FitState, x_new, *,
                 nufft_method: str = "auto") -> torch.Tensor:
    """Posterior mean: one type-2 apply of ``ws * beta`` at the targets."""
    x_new = _as_points(x_new, state.device, state.h.dtype)
    nufft = make_nufft(x_new, state.h, state.mtot, method=nufft_method)
    return nufft.type2((state.ws * state.beta).reshape(
        (state.mtot,) * state.d)).real


def _solve_var(state: FitState, rhs, *, cg_tol, max_cg_iter) -> CGResult:
    """Solve ``A_var x = rhs`` (``A_var = A_mean / sigma^2``): the fit's
    dense inverse when present, batched CG otherwise."""
    if state.P_dense is not None:
        return refine_solve(state.A_dense, state.P_dense, rhs,
                            scale=1.0 / state.sigmasq, tol=cg_tol)
    A_var = make_A_var(state.ws, collectives.current().toeplitz(
        state.toeplitz), state.sigmasq)
    return pcg(A_var, rhs, tol=cg_tol, maxiter=max_cg_iter,
               M_inv=_var_precond(state))


def _var_precond(state: FitState):
    """Preconditioner for ``A_var = A_mean / sigma^2``: the fit's Kronecker
    preconditioner or deflation block when present (a preconditioner for
    ``A`` serves ``A / sigma^2`` unchanged, a global scale leaves the PCG
    iterates invariant), Jacobi otherwise."""
    if state.kron is not None:
        return make_kron_precond(state.kron)
    if state.defl_P is not None:
        return make_block_precond(
            state.defl_idx, state.defl_P,
            state.diag_scale * torch.abs(state.ws) ** 2 + state.sigmasq)
    diag = state.diag_scale * torch.abs(state.ws) ** 2 / state.sigmasq + 1.0

    def M_inv(v):
        return v / diag.to(v.dtype)
    return M_inv


@profiling.spanned("variance")
def _variance_stochastic(state: FitState, x_new, generator, *, probes: int,
                         cg_tol, max_cg_iter, nufft_method: str = "auto",
                         etas=None) -> torch.Tensor:
    """Hutchinson diag-sums variance: solve ``A_var u_j = D eta_j`` for
    Rademacher probes in chunks of 256, cross-correlate ``gamma = D u`` with
    ``eta`` on a 2,3,5,7-smooth FFT grid of size >= 2 mtot - 1, keep the
    +-(mtot-1) lags, and evaluate the lag sums at the targets with one
    FFT-ordered type-2 apply (on :func:`serving_method`'s backend: the
    spreading backends take no FFT order).  ``etas`` ((probes, M), +-1)
    replaces the generated probes, for same-probe comparisons."""
    mtot, d = state.mtot, state.d
    M = mtot ** d
    rdtype = state.h.dtype
    dev = state.device
    if etas is None:
        if generator is None:
            # on the state's device, so the probes are drawn where they
            # are used and never copied from the host
            generator = torch.Generator(device=dev).manual_seed(0)
        bits = torch.randint(0, 2, (probes, M), generator=generator,
                             device=generator.device)
        etas = (bits * 2 - 1).to(dev, rdtype)
    else:
        etas = torch.as_tensor(etas, device=dev).to(rdtype)
        probes = etas.shape[0]
    L = 2 * mtot - 1
    Lf = _next_smooth(L)
    s_size = (Lf,) * d
    dims = tuple(range(1, d + 1))
    pc = min(probes, _PROBE_CHUNK)
    nc = -(-probes // pc)
    pad = nc * pc - probes
    if pad:
        etas = torch.cat([etas, etas.new_zeros((pad, M))])
    eta_c = etas.reshape(nc, pc, M)

    est_sums = None
    for e_flat in eta_c:
        res = _solve_var(state, state.ws[None, :] * e_flat, cg_tol=cg_tol,
                         max_cg_iter=max_cg_iter)
        g = (state.ws[None, :] * res.x).reshape((pc,) + (mtot,) * d)
        e = e_flat.reshape((pc,) + (mtot,) * d)
        G = torch.fft.fftn(g, s=s_size, dim=dims)
        E = torch.fft.fftn(e.to(G.dtype), s=s_size, dim=dims)
        part = torch.fft.ifftn(G * E.conj(), s=s_size, dim=dims).sum(0)
        est_sums = part if est_sums is None else est_sums + part
    est_sums = est_sums / probes
    if Lf != L:
        lag_idx = torch.cat([torch.arange(mtot),
                             torch.arange(Lf - mtot + 1, Lf)]).to(dev)
        for ax in range(d):
            est_sums = torch.index_select(est_sums, ax, lag_idx)

    nufft = make_nufft(x_new, state.h, 2 * mtot - 1, fft_order=True,
                       method=serving_method(nufft_method))
    return nufft.type2(est_sums).real


def posterior_fourier_rows(x_new, h, mtot: int, d: int) -> torch.Tensor:
    """Rows ``f_x = exp(+2 pi i x . xi)`` of the Fourier design at the
    targets, (B, mtot^d): the outer product of per-axis phase vectors.
    They are made by the phase-matrix code of ``ops/nufft.py`` (the
    angle ``t = x h`` rounded in x's precision, folded onto the torus), as
    gpquad takes them from its phase-matrix operator; no NUFFT is
    applied."""
    fs = [p.conj_physical() for p in make_phase_nufft(x_new, h, mtot).phases]
    if d == 1:
        return fs[0]
    if d == 2:
        return torch.einsum("nj,nk->njk", fs[0], fs[1]).reshape(
            x_new.shape[0], -1)
    if d == 3:
        return torch.einsum("nj,nk,nl->njkl", fs[0], fs[1], fs[2]).reshape(
            x_new.shape[0], -1)
    raise NotImplementedError("d <= 3")


def _variance_regular(state: FitState, x_new, *, cg_tol, max_cg_iter,
                      microbatch: int = 8192) -> torch.Tensor:
    """Exact per-target variance ``Re f_x^T W A_var^{-1} W conj(f_x)``, in
    microbatches of ``microbatch`` targets: the fit's dense inverse with
    refinement on the dense tier, one batched PCG a microbatch (with the
    fit's preconditioner) otherwise."""
    out = []
    for xb in torch.split(x_new, microbatch):
        fx = posterior_fourier_rows(xb, state.h, state.mtot, state.d)
        res = _solve_var(state, state.ws * fx.conj(), cg_tol=cg_tol,
                         max_cg_iter=max_cg_iter)
        out.append(torch.clamp(
            torch.sum(fx * (state.ws * res.x), dim=-1).real, min=0.0))
    return torch.cat(out)


def _auto_chebyshev_nodes(state: FitState, x_new, *, mass: float = 0.999,
                          c: float = 4.0, floor: int = 20, cap: int = 96):
    """Per-dimension Chebyshev node counts from the variance surface's
    bandwidth (host numpy, as gpquad).

    The variance is a trigonometric polynomial in x whose spectral envelope
    is the Woodbury-damped ``q = ws^2 / (n ws^2 + sigma^2)``, not ``ws^2``.
    Per dimension, B is the q-weighted ``mass``-quantile of |xi| and W the
    targets' width; Chebyshev interpolation of e^{2 pi i B x} over W needs
    about pi nodes a wavelength, so N = ceil(2 c B W), clipped to [floor,
    cap]."""
    m = (state.mtot - 1) // 2
    xis1 = np.arange(-m, m + 1) * float(state.h)
    w2 = (torch.abs(state.ws) ** 2).cpu().numpy()
    w2 = w2 / (float(state.diag_scale) * w2 + float(state.sigmasq))
    w2 = w2.reshape((state.mtot,) * state.d)
    xh = x_new.cpu().numpy()
    order = np.argsort(np.abs(xis1))
    fsorted = np.abs(xis1)[order]
    out = []
    for dim in range(state.d):
        axes = tuple(i for i in range(state.d) if i != dim)
        wdim = w2.sum(axis=axes) if axes else w2
        cs = np.cumsum(wdim[order])
        B = fsorted[min(int(np.searchsorted(cs, mass * cs[-1])),
                        len(fsorted) - 1)]
        W = float(xh[:, dim].max() - xh[:, dim].min())
        out.append(int(np.clip(np.ceil(2.0 * c * B * W), floor, cap)))
    return out


def _variance_chebyshev(state: FitState, x_new, *, n_nodes_per_dim,
                        cg_tol, max_cg_iter) -> torch.Tensor:
    """The exact variance on a Chebyshev-Lobatto tensor grid over the
    targets' box, barycentric-interpolated to the targets.
    ``n_nodes_per_dim`` is an int, a per-dimension sequence, or None
    (:func:`_auto_chebyshev_nodes`)."""
    from .pg_core import chebyshev_lobatto_nodes
    xh = x_new.cpu().numpy()
    d = xh.shape[1]
    if n_nodes_per_dim is None:
        n_per_dim = _auto_chebyshev_nodes(state, x_new)
    elif np.ndim(n_nodes_per_dim) == 0:
        n_per_dim = [int(n_nodes_per_dim)] * d
    else:
        n_per_dim = [int(v) for v in n_nodes_per_dim]
    axes_nodes, axes_weights = [], []
    for dim in range(d):
        lo, hi = float(xh[:, dim].min()), float(xh[:, dim].max())
        if np.isclose(lo, hi):
            pad = max(abs(lo), 1.0) * 1e-6
            lo, hi = lo - pad, hi + pad
        nodes, weights = chebyshev_lobatto_nodes(lo, hi, n_per_dim[dim])
        axes_nodes.append(torch.as_tensor(nodes, dtype=x_new.dtype,
                                          device=x_new.device))
        axes_weights.append(torch.as_tensor(weights, dtype=x_new.dtype,
                                            device=x_new.device))
    mesh = torch.stack(torch.meshgrid(*axes_nodes, indexing="ij"),
                       dim=-1).reshape(-1, d)
    return _cheb_eval(state, x_new, axes_nodes, axes_weights, mesh,
                      cg_tol=cg_tol, max_cg_iter=max_cg_iter)


def _bary_rows(nodes, weights, t):
    """Barycentric interpolation rows (targets, nodes).  The barycentric
    form normalises itself as t -> node, so only exact hits take the
    one-hot row."""
    diff = t[:, None] - nodes[None, :]
    hit = diff == 0.0
    matched = hit.any(dim=1)
    raw = weights[None, :] / torch.where(hit, torch.ones_like(diff), diff)
    raw = torch.where(hit, torch.zeros_like(raw), raw)
    smooth = raw / raw.sum(dim=1, keepdim=True)
    return torch.where(matched[:, None], hit.to(t.dtype), smooth)


@contextlib.contextmanager
def _full_fp32_matmul():
    """CUDA float32 matmuls in full fp32 (TF32 off) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _cheb_eval(state, x_new, nodes, weights, mesh, *, cg_tol, max_cg_iter):
    d = len(nodes)
    node_var = _variance_regular(state, mesh, cg_tol=cg_tol,
                                 max_cg_iter=max_cg_iter)
    node_grid = node_var.reshape(tuple(n.shape[0] for n in nodes))
    mats = [_bary_rows(nodes[i], weights[i], x_new[:, i]) for i in range(d)]
    letters = "abcdefghij"[:d]
    expr = ",".join(f"n{c}" for c in letters) + "," + letters + "->n"
    # full fp32: the rows carry alternating-sign O(1) weights, and a
    # reduced-precision contraction (a bfloat16 pass on the TPU) left ~4e-3
    # of the variance's scale (gpquad/models/efgp.py:585-590)
    with _full_fp32_matmul():
        return torch.clamp(torch.einsum(expr, *mats, node_grid), min=0.0)


def predict_var(state: FitState, x_new, *, method: str = "stochastic",
                generator: Optional[torch.Generator] = None,
                probes: int = 1000, cg_tol: float = 1e-4,
                max_cg_iter: int = 1000, microbatch: int = 8192,
                chebyshev_nodes=None, nufft_method: str = "auto",
                etas=None) -> torch.Tensor:
    """Posterior variance at ``x_new``.

    ``method="regular"``: exact per-target solves in microbatches of
    ``microbatch``.  ``"stochastic"``: the Hutchinson diag-sums estimator,
    its probes from ``generator`` (a fresh generator on the state's device
    seeded 0 when None) unless ``etas`` is given.  ``"chebyshev"``: the
    exact variance at Chebyshev-Lobatto nodes, interpolated to the targets;
    ``chebyshev_nodes`` (int or per dimension) or None for the automatic
    count, which falls back to "regular" when its grid would be no smaller
    than the target set."""
    x_new = _as_points(x_new, state.device, state.h.dtype)
    method = method.lower()
    if method == "regular":
        return _variance_regular(state, x_new, cg_tol=cg_tol,
                                 max_cg_iter=max_cg_iter,
                                 microbatch=microbatch)
    if method == "stochastic":
        return _variance_stochastic(state, x_new, generator, probes=probes,
                                    cg_tol=cg_tol, max_cg_iter=max_cg_iter,
                                    nufft_method=nufft_method, etas=etas)
    if method == "chebyshev":
        if chebyshev_nodes is None:
            auto = _auto_chebyshev_nodes(state, x_new)
            if int(np.prod(auto)) >= x_new.shape[0]:
                return _variance_regular(state, x_new, cg_tol=cg_tol,
                                         max_cg_iter=max_cg_iter,
                                         microbatch=microbatch)
            chebyshev_nodes = auto
        return _variance_chebyshev(state, x_new,
                                   n_nodes_per_dim=chebyshev_nodes,
                                   cg_tol=cg_tol, max_cg_iter=max_cg_iter)
    raise ValueError(
        f"Variance method '{method}' not implemented. Choose 'regular', "
        f"'stochastic' or 'chebyshev'.")
