"""SKI (structured kernel interpolation) baseline GP; port of
``gpquad/models/ski.py``.

    K ~ W K_grid W^T,   K_grid multilevel Toeplitz (stationary kernel on a
                        uniform grid) -> FFT matvec (ops/toeplitz.py),
    W sparse local cubic-convolution interpolation (4^d Keys a = -1/2
    weights per point).

Hyper-learning: Hutchinson probes for tr(K^-1 dK), one batched PCG for all
solves, SLQ for the reported loss, ``torch.optim.Adam`` (optax's defaults)
on log-space hypers with a noise floor.  A ``torch.Generator`` replaces the
key: each iteration draws its trace probes, then its SLQ probes
(:func:`_draw_probes`).

At d=2 the interpolation runs on a host-planned band plan (points sorted by
the base row of their stencil, a stable argsort as in gpquad, so the tables
are identical): on a CUDA tensor ``W^T u`` and ``W v`` launch the
hand-written kernels of ``ops/cuda_interp.py`` at every batch size.  The
scatter/gather path (``index_add_`` / a gather) serves d=1, d=3 and plans
dropped for clustered data; :func:`set_interp_impl` picks "auto" (the
kernels on the card, the plain banded path on the CPU), "einsum" (the plain
banded ``W^T u`` and the gather ``W v``, gpquad's "einsum") or "cuda" (the
kernel wrappers, gpquad's "pallas").  :data:`INTERP_PICKS` counts which
route each interpolation took.

Entry points run on the card unless given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels import make_kernel
from ..ops.cg import pcg
from ..ops.cuda_interp import (check_point_tables, column_index,
                               interp_2d_points_trusted, interp_T_2d,
                               interp_T_2d_ref, point_of_slot)
from ..ops.slq import _gauss_quadrature, lanczos_tridiag
from ..ops.toeplitz import ToeplitzND, make_toeplitz
from .efgp import _cdtype, resolve_device

__all__ = ["SKIOperator", "BandedInterpTables", "build_ski_operator",
           "fit_ski_gp", "ski_predict_mean", "ski_predict_var",
           "resolve_grid_bounds", "resolve_grid_size", "set_interp_impl",
           "INTERP_PICKS"]


def _canonical_kernel(kernel) -> str:
    """Accepts the reference's string names plus kernel instances."""
    if not isinstance(kernel, str):
        name = type(kernel).__name__
        if name == "SquaredExponential":
            return "se"
        if name == "Matern":
            nu = getattr(kernel, "nu", None)
            if nu is not None and abs(nu - 1.5) < 1e-9:
                return "matern32"
            if nu is not None and abs(nu - 2.5) < 1e-9:
                return "matern52"
            raise ValueError(
                f"SKI supports Matern nu in {{1.5, 2.5}}, got nu={nu}.")
        raise TypeError(
            f"Unsupported SKI kernel object {name!r}. Pass a kernel name "
            "string or a SquaredExponential / Matern(nu=1.5|2.5) instance.")
    key = kernel.lower().replace("-", "").replace("_", "")
    if key in {"se", "squaredexponential", "rbf", "gaussian"}:
        return "se"
    if key in {"matern", "matern32", "mat32"}:
        return "matern32"
    if key in {"matern52", "mat52"}:
        return "matern52"
    raise ValueError(
        f"Unsupported SKI kernel '{kernel}'. Expected one of: SE, "
        "SquaredExponential, RBF, Matern32, Matern52.")


def resolve_grid_bounds(x: np.ndarray, grid_bounds=None
                        ) -> Tuple[Tuple[float, float], ...]:
    """1%-padded data bounds (float64 on the host)."""
    x = np.asarray(x)
    d = x.shape[1]
    if grid_bounds is not None:
        if len(grid_bounds) != d:
            raise ValueError(
                f"grid_bounds has {len(grid_bounds)} dims, expected {d}")
        out = []
        for lo, hi in grid_bounds:
            if not float(hi) > float(lo):
                raise ValueError(
                    f"Each grid bound must satisfy hi > lo, got {(lo, hi)}")
            out.append((float(lo), float(hi)))
        return tuple(out)
    mins, maxs = x.min(0), x.max(0)
    spans = np.maximum(maxs - mins, 1e-6)
    pad = 0.01 * spans
    return tuple((float(mins[i] - pad[i]), float(maxs[i] + pad[i]))
                 for i in range(d))


def resolve_grid_size(*, grid_size=None, num_dims: int,
                      target_grid_points: int, grid_bounds
                      ) -> Tuple[int, ...]:
    """Span-scaled per-dim sizes within a total budget."""
    if isinstance(grid_size, int):
        return (int(grid_size),) * num_dims
    if grid_size is not None:
        out = tuple(int(v) for v in grid_size)
        if len(out) != num_dims:
            raise ValueError(
                f"grid_size has {len(out)} dims, expected {num_dims}")
        if any(v <= 1 for v in out):
            raise ValueError("Each entry in grid_size must be > 1")
        return out
    base = max(16, int(round(target_grid_points ** (1.0 / num_dims))))
    spans = [max(hi - lo, 1e-6) for lo, hi in grid_bounds]
    gm = math.prod(spans) ** (1.0 / num_dims)
    scaled = [max(16, int(round(base * (s / gm)))) for s in spans]
    total = math.prod(scaled)
    if total > target_grid_points:
        shrink = (target_grid_points / total) ** (1.0 / num_dims)
        scaled = [max(16, int(math.floor(v * shrink))) for v in scaled]
    return tuple(scaled)


def _cubic_weights(t):
    """Keys cubic-convolution weights (a = -1/2) for fractional offset
    t in [0,1): weights for nodes at offsets (-1, 0, 1, 2)."""
    a = -0.5

    def f1(s):  # |s| <= 1
        return (a + 2.0) * s**3 - (a + 3.0) * s**2 + 1.0

    def f2(s):  # 1 < |s| < 2
        return a * s**3 - 5.0 * a * s**2 + 8.0 * a * s - 4.0 * a
    return torch.stack([f2(t + 1.0), f1(t), f1(1.0 - t), f2(2.0 - t)], dim=-1)


_BANDED_BH = 8          # band height (rows); slab height is BH + 3

# interpolation route for the banded plan: "auto" (the CUDA kernels on the
# card, the plain banded path on the CPU), "einsum" (the plain banded W^T u
# and the gather W v) or "cuda" (the kernel wrappers: the kernel on a CUDA
# tensor, its plain version on a CPU one)
_INTERP_IMPL = "auto"

# the route each interpolation call took since the last reset: "cuda" (the
# kernel wrappers), "banded" (the plain banded W^T u) or "unbanded" (the
# scatter / gather over the (n, 4^d) stencils)
INTERP_PICKS = {"cuda": 0, "banded": 0, "unbanded": 0}


def set_interp_impl(impl: str) -> None:
    """Select the banded interpolation route ("auto"/"einsum"/"cuda")."""
    global _INTERP_IMPL
    if impl not in ("auto", "einsum", "cuda"):
        raise ValueError(f"unknown interp impl: {impl!r}")
    _INTERP_IMPL = impl


def _interp_impl(device: torch.device) -> str:
    """The route for a tensor on ``device``: on the card "auto" launches
    the kernels at every batch size (gpquad's batch crossovers are TPU
    measurements)."""
    if _INTERP_IMPL != "auto":
        return _INTERP_IMPL
    return "cuda" if device.type == "cuda" else "einsum"


def _fold_band_slabs(slabs, batch, G1: int, G2: int, bh: int):
    """Fold each band's 3-row stencil halo into the next band and flatten
    (B, nbands, bh+3, G2) slabs to (*batch, G1*G2)."""
    B, nbands = slabs.shape[:2]
    fine = slabs[:, :, :bh, :].clone()               # (B, nb, bh, G2)
    fine[:, 1:, :3, :] += slabs[:, :-1, bh:, :]
    fine = fine.reshape(B, nbands * bh, G2)
    return fine[:, :G1, :].reshape(tuple(batch) + (G1 * G2,))


class BandedInterpTables(NamedTuple):
    """Point-to-band gather tables for the banded interpolation (d=2):
    points sorted by the stencil's base grid row, padded to a per-band
    ``cap`` (host-planned).  The first seven are gpquad's tables; then the
    column-sorted slot index the ``interp_T_2d`` kernel walks
    (``ops/cuda_interp.py`` :func:`column_index`) and the point each slot
    of ``W v`` writes (:func:`point_of_slot`)."""
    pidx: torch.Tensor       # (nbands, cap) int64 original point index
    valid: torch.Tensor      # (nbands, cap) bool
    i0loc: torch.Tensor      # (nbands, cap) int32 local row offset 0..BH-1
    c0: torch.Tensor         # (nbands, cap) int32 column stencil start
    w_row: torch.Tensor      # (nbands, cap, 4) row cubic weights
    w_col: torch.Tensor      # (nbands, cap, 4) column cubic weights
    inv_slot: torch.Tensor   # (n,) int64 band-major slot of each point
    col_slots: torch.Tensor  # (nbands, cap) int32 valid slots sorted by c0
    col_start: torch.Tensor  # (nbands, G2+1) int32 where each c0 starts
    pout: torch.Tensor       # (nbands, cap) int32 pidx on valid slots, else -1


def _plan_banded_interp(i0, w1d, G1: int, G2: int, bh: int = _BANDED_BH,
                        slack: float = 1.25, device="cpu"):
    """Host-side banded plan (numpy): sort by base row band with a stable
    argsort, pad band occupancy to a cap; then each band's valid slots
    sorted stably by base column."""
    i0 = np.asarray(i0)
    w1d = np.asarray(w1d)
    n = i0.shape[0]
    nbands = -(-G1 // bh)
    band = i0[:, 0] // bh
    order = np.argsort(band, kind="stable")
    band_sorted = band[order]
    starts = np.searchsorted(band_sorted, np.arange(nbands + 1))
    occ = starts[1:] - starts[:-1]
    cap = max(8, int(math.ceil(occ.max() * slack / 8.0)) * 8)
    offs = starts[:-1, None] + np.arange(cap)[None, :]
    valid = offs < starts[1:, None]
    table = np.where(valid, np.clip(offs, 0, n - 1), 0)
    pidx = order[table]
    i0loc = i0[pidx, 0] - (np.arange(nbands) * bh)[:, None]
    inv_slot = np.empty(n, np.int64)
    slot_ids = np.arange(nbands * cap).reshape(nbands, cap)
    inv_slot[pidx[valid]] = slot_ids[valid]

    c0 = i0[pidx, 1].astype(np.int32)
    col_slots, col_start = column_index(valid, c0, G2)

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)
    return BandedInterpTables(
        pidx=t(pidx, torch.int64), valid=t(valid),
        i0loc=t(i0loc.astype(np.int32)), c0=t(c0),
        w_row=t(w1d[pidx, 0, :]), w_col=t(w1d[pidx, 1, :]),
        inv_slot=t(inv_slot), col_slots=t(col_slots), col_start=t(col_start),
        pout=t(point_of_slot(valid, pidx, n)))


def _banded_plan(i0, w1d, grid_shape, n: int, device):
    """The band plan at d=2, or None: clustered data blows up the per-band
    cap (all points in few bands), and past 4x slot waste the banded
    formulation loses to plain scatter/gather, so the tables are dropped."""
    if len(grid_shape) != 2:
        return None
    banded = _plan_banded_interp(i0.cpu().numpy(), w1d.cpu().numpy(),
                                 grid_shape[0], grid_shape[1], device=device)
    nbands, cap = banded.pidx.shape
    if nbands * cap > 4 * max(n, 1):
        return None
    return banded


@dataclasses.dataclass(frozen=True)
class SKIOperator:
    """W K_grid W^T + sigma^2 I with precomputed interpolation stencils."""
    idx: torch.Tensor            # (n, 4^d) int64 flat grid indices
    wvals: torch.Tensor          # (n, 4^d) real weights
    toeplitz: Optional[ToeplitzND]
    grid_shape: Tuple[int, ...] = ()
    lo: Optional[torch.Tensor] = None
    dx: Optional[torch.Tensor] = None
    banded: Optional[BandedInterpTables] = None

    def __post_init__(self):
        # the W v kernel writes through the band plan's point table
        # unchecked: the tables are checked once, here
        t = self.banded
        if t is not None and len(self.grid_shape) == 2:
            check_point_tables(t.i0loc, t.c0, t.w_row, t.w_col, t.pout,
                               n=t.inv_slot.shape[0], G1=self.grid_shape[0],
                               bh=_BANDED_BH)

    @property
    def M(self) -> int:
        return int(np.prod(self.grid_shape))

    def interp(self, v):
        """W v: grid -> points; v (..., M) -> (..., n)."""
        if self.banded is not None and len(self.grid_shape) == 2 \
                and _interp_impl(v.device) == "cuda":
            return self._interp_banded(v)
        INTERP_PICKS["unbanded"] += 1
        g = v[..., self.idx]                        # (..., n, 4^d)
        return torch.sum(g * self.wvals, dim=-1)

    def _interp_banded(self, v):
        t = self.banded
        G1, G2 = self.grid_shape
        INTERP_PICKS["cuda"] += 1
        return interp_2d_points_trusted(v, t.i0loc, t.c0, t.w_row, t.w_col,
                                        t.pout, G1=G1, G2=G2,
                                        n=t.inv_slot.shape[0], bh=_BANDED_BH)

    def interp_T(self, u):
        """W^T u: points -> grid; u (..., n) -> (..., M)."""
        if self.banded is not None and len(self.grid_shape) == 2:
            return self._interp_T_banded(u)
        INTERP_PICKS["unbanded"] += 1
        contrib = u[..., :, None] * self.wvals      # (..., n, 4^d)
        lead = tuple(u.shape[:-1])
        z = torch.zeros((int(np.prod(lead, dtype=np.int64)), self.M),
                        dtype=u.dtype, device=u.device)
        z.index_add_(1, self.idx.reshape(-1),
                     contrib.reshape(z.shape[0], -1))
        return z.reshape(lead + (self.M,))

    def _interp_T_banded(self, u):
        t = self.banded
        G1, G2 = self.grid_shape
        bh = _BANDED_BH
        nbands, cap = t.pidx.shape
        batch = tuple(u.shape[:-1])
        ub = u.reshape(-1, u.shape[-1])             # (B, n)
        B = ub.shape[0]
        us = ub[:, t.pidx.reshape(-1)].reshape(B, nbands, cap) \
            * t.valid[None].to(u.dtype)
        if _interp_impl(u.device) == "cuda":
            INTERP_PICKS["cuda"] += 1
            slabs = interp_T_2d(us, t.i0loc, t.c0, t.w_row, t.w_col,
                                t.col_slots, t.col_start, G2=G2, bh=bh)
        else:
            INTERP_PICKS["banded"] += 1
            slabs = interp_T_2d_ref(us, t.i0loc, t.c0, t.w_row, t.w_col,
                                    G2=G2, bh=bh)
        return _fold_band_slabs(slabs.transpose(0, 1), batch, G1, G2, bh)

    def matvec(self, v, sigmasq, toeplitz: Optional[ToeplitzND] = None):
        """(W K_g W^T + sigma^2 I) v over the trailing point axis."""
        T = toeplitz if toeplitz is not None else self.toeplitz
        Kg = T(self.interp_T(v)).real.to(v.dtype)
        return self.interp(Kg) + sigmasq * v


def _grid_lag_table(kernel, grid_shape, dx):
    """Kernel values on the full lag grid (2 m_t - 1 per dim).  The
    distances are taken in ``dx``'s dtype and evaluated in the kernel's
    hyper dtype where that is wider, as JAX promotes them."""
    axes = [torch.arange(-(m - 1), m, dtype=dx.dtype, device=dx.device)
            * dx[t] for t, m in enumerate(grid_shape)]
    mesh = torch.meshgrid(*axes, indexing="ij")
    dist = torch.sqrt(sum(g * g for g in mesh))
    dtype = functools.reduce(torch.promote_types,
                             (getattr(kernel, n).dtype
                              for n in kernel.hyper_names), dist.dtype)
    return kernel.kernel(dist.to(dtype))


def _stencils(x, lo, dx, grid_shape):
    """Cubic stencils of points ``x`` (n, d) on the grid at ``lo`` with
    spacing ``dx``: base nodes ``i0`` (n, d), 1-D weights (n, d, 4), and the
    tensor-product flat indices and weights (n, 4^d)."""
    n, d = x.shape
    t = (x - lo[None, :]) / dx[None, :]
    fl = torch.floor(t)
    hi = torch.as_tensor([m - 4 for m in grid_shape], dtype=torch.int32,
                         device=x.device)
    i0 = torch.minimum(torch.clamp(fl.to(torch.int32) - 1, min=0), hi)
    w1d = _cubic_weights(t - fl)                 # (n, d, 4)
    strides = np.ones(d, np.int64)
    for tdim in range(d - 2, -1, -1):
        strides[tdim] = strides[tdim + 1] * grid_shape[tdim + 1]
    offsets = np.stack(np.meshgrid(*([np.arange(4)] * d), indexing="ij"),
                       -1).reshape(-1, d)        # (4^d, d)
    corner = i0.long()[:, None, :] + torch.as_tensor(offsets,
                                                     device=x.device)
    idx = torch.sum(corner * torch.as_tensor(strides, device=x.device),
                    dim=-1)                      # (n, 4^d)
    wv = torch.ones((n, offsets.shape[0]), dtype=x.dtype, device=x.device)
    for tdim in range(d):
        wv = wv * w1d[:, tdim, :][:, torch.as_tensor(offsets[:, tdim],
                                                     device=x.device)]
    return i0, w1d, idx, wv


def build_ski_operator(x, kernel, grid_size: Tuple[int, ...],
                       grid_bounds) -> SKIOperator:
    """Precompute interpolation stencils + grid-kernel Toeplitz operator.

    The working grid extends the requested bounds by two nodes per side so
    the 4-point cubic stencil never clips for in-bounds data.  Runs on
    ``x``'s device in its dtype; the band plan (d=2) is made on the host."""
    x = torch.as_tensor(x)
    n, d = x.shape
    rdtype, dev = x.dtype, x.device
    los = torch.as_tensor([b[0] for b in grid_bounds], dtype=rdtype,
                          device=dev)
    his = torch.as_tensor([b[1] for b in grid_bounds], dtype=rdtype,
                          device=dev)
    sizes = np.asarray(grid_size)
    dx = (his - los) / torch.as_tensor(sizes - 1, dtype=rdtype, device=dev)
    ext_sizes = tuple(int(m) + 4 for m in sizes)
    lo_ext = los - 2.0 * dx
    i0, w1d, idx, wv = _stencils(x, lo_ext, dx, ext_sizes)
    toeplitz = make_toeplitz(
        _grid_lag_table(kernel, ext_sizes, dx).to(_cdtype(rdtype)))
    return SKIOperator(idx=idx, wvals=wv, toeplitz=toeplitz,
                       grid_shape=ext_sizes, lo=lo_ext, dx=dx,
                       banded=_banded_plan(i0, w1d, ext_sizes, n, dev))


# ---------------------------------------------------------------------------
# training-step math
# ---------------------------------------------------------------------------

def _ski_loss_and_grad(op: SKIOperator, y, kernel, sigmasq, Z, zq, *,
                       cg_tol, max_cg_iter, slq_steps):
    """One MLL evaluation + gradient wrt (hypers..., noise).

    grad_theta NLL = 0.5 (tr(K^-1 dK) - alpha^T dK alpha), Hutchinson trace
    with the (T, n) probes ``Z``, all solves in one batched PCG; the loss by
    SLQ with the (probes, n) probes ``zq``.  Returns ``(nll / n, grad / n,
    iters, alpha)``."""
    n = y.shape[0]
    rdtype = y.dtype
    cdtype = _cdtype(rdtype)
    grid_shape, dx = op.grid_shape, op.dx
    T = make_toeplitz(_grid_lag_table(kernel, grid_shape, dx).to(cdtype))

    def A(v):
        return op.matvec(v, sigmasq, T)
    sol = pcg(A, torch.cat([y[None, :], Z], dim=0), tol=cg_tol,
              maxiter=max_cg_iter)
    alpha = sol.x[0]
    U = sol.x[1:]

    # dK_g wrt each kernel hyper by forward mode through the lag table
    def lag_of(vec):
        return _grid_lag_table(kernel.with_hypers(vec), grid_shape, dx)
    dlags = torch.func.jacfwd(lag_of)(kernel.hyper_vector())  # (*lag, H)

    # a^T W dK_g W^T b for (a, b) = (alpha, alpha) and (U_s, Z_s): W^T b
    # does not depend on the hyper, so it is taken once
    G = op.interp_T(torch.cat([alpha[None, :], Z], dim=0))
    left = torch.cat([alpha[None, :], U], dim=0)
    grads = []
    for i in range(len(kernel.hyper_names)):
        Td = make_toeplitz(dlags[..., i].to(cdtype))
        q = torch.sum(left * op.interp(Td(G).real.to(rdtype)), dim=-1)
        grads.append(0.5 * (torch.mean(q[1:]) - q[0]))
    # noise: dK = I
    t_trace_noise = torch.mean(torch.sum(U * Z, dim=1))
    grads.append(0.5 * (t_trace_noise - torch.sum(alpha * alpha)))
    grad = torch.stack(grads)

    znorm = torch.sqrt(torch.sum(zq * zq, dim=-1))
    alphas_l, betas_l = lanczos_tridiag(A, zq / znorm[:, None], slq_steps)
    logdet = torch.mean(_gauss_quadrature(alphas_l, betas_l, torch.log)
                        * znorm ** 2)
    nll = 0.5 * (torch.sum(y * alpha) + logdet + n * math.log(2 * math.pi))
    return nll / n, grad / n, sol.iters, alpha


def _draw_probes(generator, it: int, trace_samples: int, slq_probes: int,
                 n: int, dtype, device):
    """Iteration ``it``'s Rademacher probes: the (trace_samples, n) trace
    probes, then the (slq_probes, n) SLQ probes, the next draws of
    ``generator``."""
    def rademacher(rows):
        bits = torch.randint(0, 2, (rows, n), generator=generator,
                             device=generator.device)
        return (bits * 2 - 1).to(device, dtype)
    return rademacher(trace_samples), rademacher(slq_probes)


def _rss_gb():
    try:
        import psutil
        return psutil.Process().memory_info().rss / (1024 ** 3)
    except Exception:
        return None


def fit_ski_gp(x, y, *, kernel="SE", grid_size=None,
               target_grid_points: int = 32_768, grid_bounds=None,
               max_iters: int = 50, lr: float = 0.05,
               noise_floor: float = 1e-4, dtype=torch.float32,
               max_train_n: Optional[int] = None, subsample_seed: int = 0,
               init_lengthscale: Optional[float] = None,
               init_outputscale: Optional[float] = None,
               init_noise: Optional[float] = None,
               cg_tolerance: float = 1e-3, max_cg_iterations: int = 100,
               max_lanczos_quadrature_iterations: int = 10,
               num_trace_samples: int = 2, slq_probes: int = 8,
               verbose: bool = True,
               generator: Optional[torch.Generator] = None,
               device="cuda") -> Dict[str, Any]:
    """Fit the SKI GP and return training logs (gpquad's ``fit_ski_gp``;
    same defaults).  ``generator`` (default: one on ``device`` seeded
    ``subsample_seed``) draws every iteration's probes."""
    dev = resolve_device(device)
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64).reshape(-1)
    if x.ndim != 2:
        raise ValueError(f"x must have shape (N, d), got {x.shape}")
    if x.shape[0] != y.shape[0]:
        raise ValueError("x and y must have matching first dims, got "
                         f"{x.shape[0]} and {y.shape[0]}")
    if max_iters < 1:
        raise ValueError("max_iters must be >= 1")
    total_n = x.shape[0]
    train_indices = None
    if max_train_n is not None and total_n > max_train_n:
        rng = np.random.default_rng(subsample_seed)
        train_indices = np.sort(rng.permutation(total_n)[:max_train_n])
        x, y = x[train_indices], y[train_indices]

    kname = _canonical_kernel(kernel)
    if not isinstance(kernel, str):       # seed inits from the instance
        if init_lengthscale is None:
            init_lengthscale = float(kernel.lengthscale)
        if init_outputscale is None:
            init_outputscale = float(kernel.variance)
    d = x.shape[1]
    bounds = resolve_grid_bounds(x, grid_bounds)
    sizes = resolve_grid_size(grid_size=grid_size, num_dims=d,
                              target_grid_points=target_grid_points,
                              grid_bounds=bounds)

    x_t = torch.as_tensor(x, dtype=dtype, device=dev)
    y_t = torch.as_tensor(y, dtype=dtype, device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(subsample_seed)

    l0 = init_lengthscale if init_lengthscale is not None else \
        0.2 * max(hi - lo for lo, hi in bounds)
    v0 = init_outputscale if init_outputscale is not None else float(np.var(y))
    n0 = max(init_noise if init_noise is not None else 0.1 * float(np.var(y)),
             noise_floor)
    template = make_kernel({"se": "SE", "matern32": "Matern32",
                            "matern52": "Matern52"}[kname], dimension=d)
    raw = torch.log(torch.as_tensor([l0, v0, n0], dtype=dtype, device=dev))
    adam = torch.optim.Adam([raw], lr=lr)
    log_floor = math.log(noise_floor)

    # stencils are hyper-independent: build once
    op = build_ski_operator(x_t, template.with_hypers(torch.exp(raw)), sizes,
                            bounds)

    history = {k: [] for k in ("iteration", "loss", "lengthscale",
                               "outputscale", "noise", "forward_sec",
                               "backward_sec", "elapsed_sec", "rss_gb",
                               "cg_iters")}
    best = (np.inf, None, None)
    start = time.time()
    n = x_t.shape[0]
    for it in range(max_iters):
        t0 = time.time()
        pos = torch.exp(raw)
        kern = template.with_hypers(pos)
        Z, zq = _draw_probes(generator, it, num_trace_samples, slq_probes, n,
                             dtype, dev)
        nll, grad, iters, _ = _ski_loss_and_grad(
            op, y_t, kern, pos[-1], Z, zq, cg_tol=cg_tolerance,
            max_cg_iter=max_cg_iterations,
            slq_steps=max_lanczos_quadrature_iterations)
        loss_v = float(nll)
        fwd_sec = time.time() - t0
        t0 = time.time()
        raw.grad = grad * torch.exp(raw)
        adam.step()
        with torch.no_grad():
            raw[-1] = torch.clamp(raw[-1], min=log_floor)
        pos_h = np.exp(raw.cpu().numpy())
        bwd_sec = time.time() - t0

        history["iteration"].append(it + 1)
        history["loss"].append(loss_v)
        history["lengthscale"].append(float(pos_h[0]))
        history["outputscale"].append(float(pos_h[1]))
        history["noise"].append(float(pos_h[2]))
        history["forward_sec"].append(fwd_sec)
        history["backward_sec"].append(bwd_sec)
        history["elapsed_sec"].append(time.time() - start)
        history["rss_gb"].append(_rss_gb())
        history["cg_iters"].append(int(iters))
        if loss_v < best[0]:
            best = (loss_v, raw.detach().clone(), it + 1)
        if verbose:
            print(f"[SKI] iter {it+1:>3}/{max_iters}  loss={loss_v:.6g}  "
                  f"ls={pos_h[0]:.6g}  os={pos_h[1]:.6g}  "
                  f"noise={pos_h[2]:.6g}  cg={int(iters)}")

    raw = (best[1] if best[1] is not None else raw).detach()
    pos = torch.exp(raw)
    kern = template.with_hypers(pos)
    # final mean solve at best hypers
    T_final = make_toeplitz(
        _grid_lag_table(kern, op.grid_shape, op.dx).to(_cdtype(dtype)))
    res = pcg(lambda v: op.matvec(v, pos[-1], T_final), y_t,
              tol=cg_tolerance, maxiter=10 * max_cg_iterations)

    return {
        "model": {"kernel": kern, "raw": raw, "alpha": res.x,
                  "operator": op, "toeplitz": T_final},
        "history": history,
        "train_x": x_t, "train_y": y_t, "train_indices": train_indices,
        "num_train": int(x_t.shape[0]), "num_total": int(total_n),
        "grid_size": sizes, "grid_bounds": bounds,
        "best_iteration": best[2], "best_loss": best[0],
        "dtype": str(dtype).split(".")[-1],
        "fit_time_sec": time.time() - start,
        "settings": {"kernel": kname, "lr": lr, "noise_floor": noise_floor,
                     "cg_tolerance": cg_tolerance,
                     "max_cg_iterations": max_cg_iterations,
                     "num_trace_samples": num_trace_samples},
    }


def _points_of(op: SKIOperator, x_new, dtype):
    x_new = torch.as_tensor(x_new, dtype=dtype, device=op.dx.device)
    return x_new[:, None] if x_new.ndim == 1 else x_new


def _point_stencils(op: SKIOperator, x_new, dtype):
    """Cubic-interpolation stencils (idx, weights) for new points on the
    fitted operator's extended grid (same construction as
    build_ski_operator)."""
    _, _, idx, wv = _stencils(_points_of(op, x_new, dtype), op.lo, op.dx,
                              op.grid_shape)
    return idx, wv


def ski_predict_mean(fit: Dict[str, Any], x_new) -> torch.Tensor:
    """Predictive mean w(x*)^T K_g W^T alpha using the fitted stencils."""
    op: SKIOperator = fit["model"]["operator"]
    alpha = fit["model"]["alpha"]
    T = fit["model"]["toeplitz"]
    idx, wv = _point_stencils(op, x_new, alpha.dtype)
    g = T(op.interp_T(alpha)).real.to(alpha.dtype)   # K_g W^T alpha
    return torch.sum(g[..., idx] * wv, dim=-1)


def ski_predict_var(fit: Dict[str, Any], x_new, *, batch_size: int = 256,
                    cg_tol: float = 1e-6,
                    max_cg_iter: int = 1000) -> torch.Tensor:
    """Exact-CG predictive variance under the SKI approximation:

        var(x*) = k(0) - k_*^T (W K_g W^T + sigma^2 I)^{-1} k_*,
        k_*     = W K_g w_*                       (SKI cross-covariance),

    in chunks of ``batch_size`` targets, one batched PCG per chunk."""
    op: SKIOperator = fit["model"]["operator"]
    kern = fit["model"]["kernel"]
    raw = fit["model"]["raw"]
    T = fit["model"]["toeplitz"]
    rdtype = fit["model"]["alpha"].dtype
    sigmasq = torch.exp(raw)[-1]
    k0 = kern.kernel(torch.zeros((), dtype=rdtype,
                                 device=op.dx.device)).to(rdtype)

    x_new = _points_of(op, x_new, rdtype)
    n_new = x_new.shape[0]
    b = min(int(batch_size), n_new)
    pad = (-n_new) % b
    xp = torch.cat([x_new, x_new[:1].expand(pad, x_new.shape[1])]) \
        if pad else x_new

    out = []
    for s in range(0, n_new + pad, b):
        idx, wv = _point_stencils(op, xp[s:s + b], rdtype)
        # W_*^T rows scattered onto the grid: (b, M)
        u = torch.zeros((idx.shape[0], op.M), dtype=rdtype,
                        device=xp.device)
        u.scatter_add_(1, idx, wv)
        kstar = op.interp(T(u).real.to(rdtype))      # (b, n)
        sol = pcg(lambda v: op.matvec(v, sigmasq, T), kstar, tol=cg_tol,
                  maxiter=max_cg_iter)
        out.append(torch.clamp(k0 - torch.sum(kstar * sol.x, dim=-1),
                               min=0.0))
    return torch.cat(out)[:n_new]
