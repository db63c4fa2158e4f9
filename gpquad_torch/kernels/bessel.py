"""Modified Bessel function of the second kind, K_nu, in torch; port of
``gpquad/kernels/bessel.py``.

``torch.special`` has K0 and K1 only, so K_nu for a general nu is evaluated
from two exact integral representations, in log space, switching at x = 10:

small/moderate x (cosh representation, trapezoidal rule):

    K_nu(x) = int_0^inf exp(-x cosh t) cosh(nu t) dt

  The even extension of the integrand is analytic in |Im t| < pi/2, so the
  trapezoid error decays like exp(-2 pi^2 / (h^2 x)): a step of h ~ 0.165
  is below 1e-30 for x <= 10.  Truncation at t_max = 42 covers x >= 1e-12
  for nu <= 12.

large x (Laguerre representation, generalized Gauss-Laguerre):

    K_nu(x) = sqrt(pi / (2x)) e^{-x} / Gamma(nu + 1/2)
              * int_0^inf e^{-u} u^{nu-1/2} (1 + u/(2x))^{nu-1/2} du

  (DLMF 10.32.8, nu > -1/2).  The weight u^{nu-1/2} e^{-u} goes into a
  generalized Gauss-Laguerre rule, whose 48 nodes (scipy, on the host, once
  per nu) leave a smooth factor near 1: full float64 accuracy for x >= 10.

Both are sums of exponentials taken as log-sum-exp, so neither K_nu ~ x^-nu
at x -> 0 nor e^{-x} at x ~ 1e4 over- or underflows the log.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

__all__ = ["log_bessel_k", "bessel_k", "log_matern_profile"]

_T_MAX = 42.0
_NUM = 256          # trapezoid step h = t_max / (num - 1) ~ 0.165
_X_SPLIT = 10.0
_N_LAGUERRE = 48


@lru_cache(maxsize=None)
def _genlaguerre_rule(nu: float, n: int):
    """Generalized Gauss-Laguerre nodes and log-weights for the weight
    u^{nu-1/2} e^{-u}, float64 on the host."""
    from scipy.special import roots_genlaguerre
    u, w = roots_genlaguerre(n, nu - 0.5)
    return np.asarray(u, np.float64), np.log(np.asarray(w, np.float64))


def _log_k_cosh(nu: float, x, *, t_max: float, num: int):
    t = torch.linspace(0.0, t_max, num, dtype=x.dtype, device=x.device)
    a = abs(float(nu)) * t
    # log cosh(nu t) without overflow: a + log1p(e^{-2a}) - log 2
    log_cosh = a + torch.log1p(torch.exp(-2.0 * a)) - math.log(2.0)
    f = -x[..., None] * torch.cosh(t) + log_cosh        # (..., num)
    m = torch.amax(f, dim=-1)
    w = torch.ones((num,), dtype=x.dtype, device=x.device)
    w[0] = w[-1] = 0.5
    s = torch.sum(w * torch.exp(f - m[..., None]), dim=-1)
    return m + torch.log(s * (t_max / (num - 1)))


def _log_k_laguerre(nu: float, x, *, n: int):
    u, logw = _genlaguerre_rule(float(nu), n)
    u = torch.as_tensor(u, dtype=x.dtype, device=x.device)
    logw = torch.as_tensor(logw, dtype=x.dtype, device=x.device)
    f = logw + (nu - 0.5) * torch.log1p(u / (2.0 * x[..., None]))
    m = torch.amax(f, dim=-1)
    s = torch.sum(torch.exp(f - m[..., None]), dim=-1)
    return (0.5 * math.log(math.pi / 2.0) - 0.5 * torch.log(x) - x
            - math.lgamma(float(nu) + 0.5) + m + torch.log(s))


def log_bessel_k(nu, x, *, t_max: float = _T_MAX, num: int = _NUM,
                 n_laguerre: int = _N_LAGUERRE):
    """log K_nu(x) for x > 0, elementwise over ``x`` (any shape); ``nu`` is
    a Python float (the kernel's fixed smoothness)."""
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.float64)
    # each branch's argument clamped into its own domain, so that the
    # branch not taken stays finite (and so does its gradient)
    small = _log_k_cosh(float(nu), torch.clamp(x, max=_X_SPLIT),
                        t_max=t_max, num=num)
    large = _log_k_laguerre(float(nu), torch.clamp(x, min=_X_SPLIT),
                            n=n_laguerre)
    return torch.where(x < _X_SPLIT, small, large)


def bessel_k(nu, x, **kw):
    """K_nu(x) (overflows for tiny x, where K blows up; prefer the log)."""
    return torch.exp(log_bessel_k(nu, x, **kw))


def log_matern_profile(nu, x):
    """log of the normalised Matérn radial profile

        g(x) = 2^{1-nu} / Gamma(nu) * x^nu * K_nu(x),   g(0) = 1,

    at x = sqrt(2 nu) r / lengthscale; 0 (= log 1) for x <= 1e-12."""
    x = torch.as_tensor(x)
    tiny = 1e-12
    x_safe = torch.clamp(x, min=tiny)
    lg = ((1.0 - nu) * math.log(2.0) - math.lgamma(nu)
          + nu * torch.log(x_safe) + log_bessel_k(nu, x_safe))
    # g(x) -> 1 as x -> 0 (relative error O(x^{2 min(nu, 1)}) at the cutoff)
    return torch.where(x > tiny, lg, torch.zeros_like(lg))
