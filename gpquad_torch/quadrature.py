"""Equispaced Fourier quadrature node selection; port of
``gpquad/quadrature.py`` (``truncation_bound``, ``grid_geometry``,
``spectral_grid``, the bucket ladders and the padded-grid masks).

Planning always runs on the host in float64, so ``(h, mtot)`` equal what
the JAX package computes with x64 enabled:

  - ``h = 1 / (L + Ltime)`` where ``k(Ltime) = eps`` (aliasing control);
  - ``hm = ceil(Lfreq / h)`` where ``|r|^(d-1) S(r) / S(0) = trunc_eps``
    (truncation control, ``trunc_eps = eps`` by default), or the
    closed-form SE and Matérn heuristics.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .kernels.matern import Matern
from .kernels.squared_exponential import SquaredExponential

__all__ = ["truncation_bound", "grid_geometry", "spectral_grid",
           "bucket_mtot", "bucket_points", "bucket_neighbors",
           "flat_grid_mask", "padded_grid_mask"]

_F64 = torch.float64


def truncation_bound(f, eps, *, initial_upper: float = 1000.0,
                     lower: float = 0.0, iters: int = 200,
                     doublings: int = 10):
    """Find L with f(L) ~= eps for monotone-decreasing ``f``: locate an upper
    bound by at most ``doublings`` doublings, then ``iters`` bisection
    steps.  Returns a float64 0-d tensor.

    Both loops stop at their fixed point (a step that changes nothing, e.g.
    once ``a`` and ``b`` are adjacent doubles), after which every further
    step would change nothing either: the result is the full loops', in
    ~60 bisection steps instead of 200."""
    eps = torch.as_tensor(eps, dtype=_F64)
    b = torch.tensor(initial_upper, dtype=_F64)
    for _ in range(doublings):
        if not bool(f(b) > eps):
            break
        b = b * 2.0
    a = torch.tensor(lower, dtype=_F64)
    for _ in range(iters):
        mid = 0.5 * (a + b)
        if bool(f(mid) > eps):
            if bool(mid == a):
                break
            a = mid
        else:
            if bool(mid == b):
                break
            b = mid
    return 0.5 * (a + b)


def _host_f64(kernel):
    return kernel.with_hypers(kernel.hyper_vector().to("cpu", _F64))


def grid_geometry(kernel, eps, L, *, use_integral: bool = True,
                  trunc_eps=None):
    """Quadrature geometry ``(h, hm_real)`` as float64 0-d tensors; callers
    take ``mtot = 2 * ceil(hm_real) + 1``.  ``trunc_eps`` (default ``eps``)
    is the integral method's truncation level for the spectral tail."""
    kernel = _host_f64(kernel)
    L = torch.as_tensor(L, dtype=_F64)
    if trunc_eps is None:
        trunc_eps = eps

    if use_integral:
        Ltime = truncation_bound(lambda r: kernel.kernel(r), eps)
        h = 1.0 / (L + Ltime)
        s0 = kernel.spectral_density(torch.zeros((1,), dtype=_F64))[0]
        d = kernel.dimension

        def khat_mod(r):
            return (torch.abs(r ** (d - 1))
                    * kernel.spectral_density(r.reshape(1))[0] / s0)

        Lfreq = truncation_bound(khat_mod, trunc_eps)
        return h, Lfreq / h

    l = kernel.lengthscale
    var = kernel.variance
    d = kernel.dimension
    eps_use = eps / var
    if isinstance(kernel, Matern):
        nu = kernel.nu
        h = 1.0 / (L + 0.85 * l / math.sqrt(nu) * torch.log(1.0 / eps_use))
        hm_real = ((math.pi ** (nu + d / 2) * l ** (2 * nu) * eps_use / 0.15)
                   ** (-1.0 / (2 * nu + d / 2))) / h
        return h, hm_real
    if isinstance(kernel, SquaredExponential):
        h = 1.0 / (L + l * torch.sqrt(2.0 * torch.log(4 * d * 3 ** d
                                                      / eps_use)))
        hm_real = (torch.sqrt(torch.log(d * 4.0 ** (d + 1) / eps_use) / 2.0)
                   / math.pi / l) / h
        return h, hm_real
    raise NotImplementedError(
        "Heuristic grid selection only for SE/Matérn; use use_integral=True.")


def spectral_grid(kernel, eps, L, *, use_integral: bool = True,
                  trunc_eps=None) -> Tuple[np.ndarray, float, int]:
    """Concrete ``(xis_1d, h, mtot)`` with ``xis = arange(-hm, hm+1) * h``."""
    h, hm_real = grid_geometry(kernel, eps, L, use_integral=use_integral,
                               trunc_eps=trunc_eps)
    h = float(h)
    hm = int(math.ceil(float(hm_real) - 1e-12))
    xis = np.arange(-hm, hm + 1, dtype=np.float64) * h
    return xis, h, 2 * hm + 1


# ---------------------------------------------------------------------------
# bucketed grid sizes: a hyper-learning run pads the grid to the next rung of
# a geometric ladder and masks the surplus nodes to exactly zero weight, so
# that every operator on the padded grid equals the tight grid's
# ---------------------------------------------------------------------------

_BUCKET_GROWTH = 1.25


def bucket_mtot(mtot: int, minimum: int = 9) -> int:
    """Round a grid size up to the next odd rung of the 1.25 ladder."""
    m = max(minimum, mtot)
    rung = minimum
    while rung < m:
        rung = int(rung * _BUCKET_GROWTH) + 1
    if rung % 2 == 0:
        rung += 1
    return rung


def bucket_points(n: int, minimum: int = 100) -> int:
    """Round a point count up to the 1-2-5 decade ladder."""
    if n <= minimum:
        return minimum
    rung = minimum
    while rung < n:
        lead = int(str(rung)[0])
        rung = rung * 2 if lead in (1, 5) else rung * 5 // 2   # 1->2->5->10
    return rung


def bucket_neighbors(mtot: int, minimum: int = 9):
    """``(down, up)`` rungs of the :func:`bucket_mtot` ladder adjacent to
    ``mtot`` (``down`` is None at the bottom of the ladder)."""
    r, prev = minimum, None
    while True:
        cur = r + 1 if r % 2 == 0 else r
        nxt_raw = int(r * _BUCKET_GROWTH) + 1
        nxt = nxt_raw + 1 if nxt_raw % 2 == 0 else nxt_raw
        if cur >= mtot:
            return prev, nxt
        prev = cur
        r = nxt_raw


def flat_grid_mask(mtot_pad: int, d: int, hm, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """Active-node mask of a padded d-dim grid, flat ``(mtot_pad**d,)``:
    the product of the 1-D masks ``|j| <= hm``."""
    m_pad = (mtot_pad - 1) // 2
    j = torch.abs(torch.arange(-m_pad, m_pad + 1, device=device))
    mask1 = (j <= hm).to(dtype)
    out = mask1
    for _ in range(d - 1):
        out = (out[:, None] * mask1[None, :]).reshape(-1)
    return out


def padded_grid_mask(mtot_pad: int, hm, h, dtype=torch.float64,
                     device=None):
    """``(xis_1d, mask_1d)`` of a grid of ``mtot_pad`` nodes:
    ``xis_1d[j] = (j - m_pad) h`` and the mask 1 for ``|j - m_pad| <= hm``,
    else 0."""
    m_pad = (mtot_pad - 1) // 2
    j = torch.arange(-m_pad, m_pad + 1, dtype=dtype, device=device)
    xis = j * h
    return xis, (torch.abs(j) <= hm).to(xis.dtype)
