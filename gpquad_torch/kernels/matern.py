"""Matérn kernel (any nu > 0; closed forms for nu in {1/2, 3/2, 5/2}); port
of ``gpquad/kernels/matern.py``:

    k(r)  = variance * 2^{1-nu} / Gamma(nu) (sqrt(2 nu) r / l)^nu
            * K_nu(sqrt(2 nu) r / l)
    S(xi) = variance * (2 sqrt(pi))^d Gamma(nu + d/2) (2 nu)^nu
            / (Gamma(nu) l^(2 nu)) * (2 nu / l^2 + 4 pi^2 |xi|^2)^-(nu + d/2)

``nu`` is fixed (not a hyper); the hypers are ``(lengthscale, variance)``.
For a general nu the kernel values come from :mod:`.bessel`; the spectral
density and its gradient are closed forms for every nu.
"""
from __future__ import annotations

import math

import torch

from .base import AbstractKernel
from .bessel import log_matern_profile

__all__ = ["Matern"]


class Matern(AbstractKernel):
    hyper_names = ("lengthscale", "variance")

    def __init__(self, dimension: int = 1, nu: float = 2.5, **hypers):
        if not float(nu) > 0.0:
            raise ValueError("Matérn nu must be positive.")
        super().__init__(dimension=dimension, **hypers)
        self.nu = float(nu)

    def _static_kwargs(self) -> dict:
        return {"dimension": self.dimension, "nu": self.nu}

    def kernel(self, distance):
        """Matérn values: closed forms for nu in {1/2, 3/2, 5/2}, the
        Bessel-K profile otherwise."""
        s = torch.abs(distance) / self.lengthscale
        if self.nu == 0.5:
            return self.variance * torch.exp(-s)
        if self.nu == 1.5:
            r3 = math.sqrt(3.0)
            return self.variance * (1.0 + r3 * s) * torch.exp(-r3 * s)
        if self.nu == 2.5:
            r5 = math.sqrt(5.0)
            return (self.variance * (1.0 + r5 * s + (5.0 / 3.0) * s * s)
                    * torch.exp(-r5 * s))
        nu = self.nu
        return self.variance * torch.exp(
            log_matern_profile(nu, math.sqrt(2.0 * nu) * s))

    def spectral_density(self, xi):
        """S(xi) for xi of shape (n,) or (n, d)."""
        xi = xi[..., None] if xi.ndim == 1 else xi
        nsq = torch.sum(xi * xi, dim=-1)
        d, nu = self.dimension, self.nu
        l = self.lengthscale
        scaling = ((2.0 * math.sqrt(math.pi)) ** d
                   * math.gamma(nu + d / 2.0) * (2.0 * nu) ** nu
                   / math.gamma(nu)) / l ** (2.0 * nu)
        base = 2.0 * nu / (l * l) + 4.0 * math.pi ** 2 * nsq
        return self.variance * scaling * base ** (-(nu + d / 2.0))

    def spectral_grad(self, xi):
        """[dS/dl, dS/dvariance], shape (n, 2)."""
        xi = xi[..., None] if xi.ndim == 1 else xi
        nsq = torch.sum(xi * xi, dim=-1)
        d, nu = self.dimension, self.nu
        l = self.lengthscale
        s = self.spectral_density(xi)
        dv = s / self.variance
        denom = 2.0 * nu / (l * l) + 4.0 * math.pi ** 2 * nsq
        exponent_grad = -(nu + d / 2.0) * (-4.0 * nu / l ** 3) / denom
        dl = s * (-2.0 * nu / l + exponent_grad)
        return torch.stack([dl, dv], dim=-1)
