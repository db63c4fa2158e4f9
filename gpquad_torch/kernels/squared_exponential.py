"""Squared-exponential (RBF) kernel; port of
``gpquad/kernels/squared_exponential.py``:

    k(r)   = variance * exp(-r^2 / (2 l^2))
    S(xi)  = (2 pi l^2)^(d/2) * variance * exp(-2 pi^2 l^2 |xi|^2)
"""
from __future__ import annotations

import math

import torch

from .base import AbstractKernel

__all__ = ["SquaredExponential"]


class SquaredExponential(AbstractKernel):
    hyper_names = ("lengthscale", "variance")

    def kernel(self, distance):
        s = distance / self.lengthscale
        return self.variance * torch.exp(-0.5 * s * s)

    def spectral_density(self, xi):
        """S(xi) for xi of shape (n,) or (n, d)."""
        xi = xi[..., None] if xi.ndim == 1 else xi
        nsq = torch.sum(xi * xi, dim=-1)
        l2 = self.lengthscale * self.lengthscale
        pref = (2.0 * math.pi * l2) ** (self.dimension / 2.0) * self.variance
        return pref * torch.exp(-2.0 * math.pi ** 2 * l2 * nsq)

    def spectral_grad(self, xi):
        """[dS/dl, dS/dvariance], shape (n, 2)."""
        xi = xi[..., None] if xi.ndim == 1 else xi
        nsq = torch.sum(xi * xi, dim=-1)
        s = self.spectral_density(xi)
        two_pi_sq = (2.0 * math.pi) ** 2
        dl = s * (self.dimension / self.lengthscale
                  - two_pi_sq * self.lengthscale * nsq)
        dv = s / self.variance
        return torch.stack([dl, dv], dim=-1)

    def _median_to_lengthscale(self, med):
        return 0.5 * med
