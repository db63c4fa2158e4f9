"""Equispaced Fourier quadrature node selection; port of
``gpquad/quadrature.py`` (``truncation_bound``, ``grid_geometry``,
``spectral_grid``).

Planning always runs on the host in float64, so ``(h, mtot)`` equal what
the JAX package computes with x64 enabled:

  - ``h = 1 / (L + Ltime)`` where ``k(Ltime) = eps`` (aliasing control);
  - ``hm = ceil(Lfreq / h)`` where ``|r|^(d-1) S(r) / S(0) = eps``
    (truncation control), or the closed-form SE heuristic.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .kernels.squared_exponential import SquaredExponential

__all__ = ["truncation_bound", "grid_geometry", "spectral_grid"]

_F64 = torch.float64


def truncation_bound(f, eps, *, initial_upper: float = 1000.0,
                     lower: float = 0.0, iters: int = 200,
                     doublings: int = 10):
    """Find L with f(L) ~= eps for monotone-decreasing ``f``: locate an upper
    bound by at most ``doublings`` doublings, then ``iters`` bisection
    steps.  Returns a float64 0-d tensor."""
    eps = torch.as_tensor(eps, dtype=_F64)
    b = torch.tensor(initial_upper, dtype=_F64)
    for _ in range(doublings):
        b = torch.where(f(b) > eps, b * 2.0, b)
    a = torch.tensor(lower, dtype=_F64)
    for _ in range(iters):
        mid = 0.5 * (a + b)
        gt = f(mid) > eps
        a, b = torch.where(gt, mid, a), torch.where(gt, b, mid)
    return 0.5 * (a + b)


def _host_f64(kernel):
    return kernel.with_hypers(kernel.hyper_vector().to("cpu", _F64))


def grid_geometry(kernel, eps, L, *, use_integral: bool = True):
    """Quadrature geometry ``(h, hm_real)`` as float64 0-d tensors; callers
    take ``mtot = 2 * ceil(hm_real) + 1``."""
    kernel = _host_f64(kernel)
    L = torch.as_tensor(L, dtype=_F64)

    if use_integral:
        Ltime = truncation_bound(lambda r: kernel.kernel(r), eps)
        h = 1.0 / (L + Ltime)
        s0 = kernel.spectral_density(torch.zeros((1,), dtype=_F64))[0]
        d = kernel.dimension

        def khat_mod(r):
            return (torch.abs(r ** (d - 1))
                    * kernel.spectral_density(r.reshape(1))[0] / s0)

        Lfreq = truncation_bound(khat_mod, eps)
        return h, Lfreq / h

    if not isinstance(kernel, SquaredExponential):
        raise NotImplementedError(
            "Heuristic grid selection is ported for SE only; use "
            "use_integral=True.")
    l = kernel.lengthscale
    var = kernel.variance
    d = kernel.dimension
    eps_use = eps / var
    h =1.0 / (L + l * torch.sqrt(2.0 * torch.log(4 * d * 3 ** d / eps_use)))
    hm_real = (torch.sqrt(torch.log(d * 4.0 ** (d + 1) / eps_use) / 2.0)
               / math.pi / l) / h
    return h, hm_real


def spectral_grid(kernel, eps, L, *, use_integral: bool = True
                  ) -> Tuple[np.ndarray, float, int]:
    """Concrete ``(xis_1d, h, mtot)`` with ``xis = arange(-hm, hm+1) * h``."""
    h, hm_real = grid_geometry(kernel, eps, L, use_integral=use_integral)
    h = float(h)
    hm = int(math.ceil(float(hm_real) - 1e-12))
    xis = np.arange(-hm, hm + 1, dtype=np.float64) * h
    return xis, h, 2 * hm + 1
