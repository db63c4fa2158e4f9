"""Kernel base class: hyperparameters as buffers of an ``nn.Module``.

Port of ``gpquad/kernels/base.py``.  The JAX kernels are immutable pytrees;
here a kernel is an ``nn.Module`` whose hyperparameters are buffers, so
``.to(device, dtype)`` moves them with the module, and :meth:`with_hypers`
returns a new kernel rather than changing this one.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

__all__ = ["AbstractKernel", "median_distance_heuristic"]


class AbstractKernel(nn.Module):
    """Shared kernel interface.

    Subclasses define ``hyper_names`` (ordered kernel hyperparameters; the
    noise variance is not one of them), ``kernel(distance)`` and
    ``spectral_density(xi)``.
    """

    hyper_names: Tuple[str, ...] = ()

    def __init__(self, dimension: int = 1, **hypers):
        super().__init__()
        self.dimension = int(dimension)
        for name in self.hyper_names:
            value = hypers.pop(name, 1.0)
            if not torch.is_tensor(value):
                value = torch.tensor(value, dtype=torch.float64)
            self.register_buffer(name, value.reshape(()))
        if hypers:
            raise TypeError(f"Unknown hyperparameters: {sorted(hypers)}")

    def _static_kwargs(self) -> dict:
        """Constructor arguments that are not hypers (the dimension, and a
        Matérn kernel's nu): carried over to the kernels
        :meth:`with_hypers` and :meth:`set_hyper` make."""
        return {"dimension": self.dimension}

    @property
    def num_hypers(self) -> int:
        """Number of hyperparameters *including* the noise variance."""
        return len(self.hyper_names) + 1

    def get_hyper(self, name: str) -> torch.Tensor:
        if name not in self.hyper_names:
            raise ValueError(f"Unknown hyperparameter: {name}")
        return getattr(self, name)

    def hyper_vector(self) -> torch.Tensor:
        """Kernel hypers stacked in declared order, float64, shape ``(H,)``."""
        return torch.stack([getattr(self, n).to(torch.float64)
                            for n in self.hyper_names])

    def with_hypers(self, vec) -> "AbstractKernel":
        """A new kernel with hyperparameters taken from ``vec`` (positive
        space, ``hyper_names`` order; trailing entries such as the noise
        variance are ignored).  The new buffers take ``vec``'s dtype and
        device."""
        vec = torch.as_tensor(vec)
        updates = {n: vec[i] for i, n in enumerate(self.hyper_names)}
        return type(self)(**self._static_kwargs(), **updates)

    def set_hyper(self, name: str, value) -> "AbstractKernel":
        """A new kernel with hyper ``name`` set to ``value``."""
        if name not in self.hyper_names:
            raise ValueError(f"Unknown hyperparameter: {name}")
        hypers = dict(self.iter_hypers())
        hypers[name] = torch.as_tensor(value)
        return type(self)(**self._static_kwargs(), **hypers)

    def iter_hypers(self):
        for n in self.hyper_names:
            yield n, getattr(self, n)

    def kernel(self, distance):
        raise NotImplementedError

    def spectral_density(self, xi):
        raise NotImplementedError

    # ------------------------------------------------------------------
    # dense reference implementations (oracle paths)
    # ------------------------------------------------------------------
    def kernel_matrix(self, x, y) -> torch.Tensor:
        """Dense kernel matrix K(x, y), O(n m) memory."""
        x = x[:, None] if x.ndim == 1 else x
        y = y[:, None] if y.ndim == 1 else y
        d2 = torch.sum((x[:, None, :] - y[None, :, :]) ** 2, dim=-1)
        return self.kernel(torch.sqrt(torch.clamp(d2, min=0.0)))

    def log_marginal(self, x, y, sigmasq) -> torch.Tensor:
        """Dense Cholesky log marginal likelihood; -inf when the Cholesky
        fails."""
        x = x[:, None] if x.ndim == 1 else x
        n = x.shape[0]
        K = self.kernel_matrix(x, x)
        Kn = K + sigmasq * torch.eye(n, dtype=K.dtype, device=K.device)
        L, info = torch.linalg.cholesky_ex(Kn)
        if bool(info != 0):
            return torch.tensor(-float("inf"), dtype=K.dtype, device=K.device)
        y = torch.as_tensor(y, dtype=K.dtype, device=K.device)
        alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
        data_fit = 0.5 * torch.sum(y * alpha)
        complexity = torch.sum(torch.log(torch.diagonal(L)))
        constant = 0.5 * n * math.log(2.0 * math.pi)
        return -(data_fit + complexity + constant)

    def estimate_hyperparameters(self, x, y, generator=None, K: int = 1000):
        """Median-distance initial hypers: (lengthscale, variance,
        noise variance) = (f(median), var(y), 0.2 var(y))."""
        x = x[:, None] if x.ndim == 1 else x
        y_var = torch.var(torch.as_tensor(y), unbiased=False)
        med = median_distance_heuristic(x, generator=generator, K=K)
        return self._median_to_lengthscale(med), y_var, 0.2 * y_var

    def _median_to_lengthscale(self, med):
        return med      # Matérn's rule; SE takes half the median


def median_distance_heuristic(x, generator=None, K: int = 1000):
    """Median of the strictly positive pairwise distances over at most K
    points, drawn without replacement by ``generator`` (a fresh CPU
    generator seeded 0 when None) when there are more."""
    n = x.shape[0]
    if n > K:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        idx = torch.randperm(n, generator=generator,
                             device=generator.device)[:K].to(x.device)
        x = x[idx]
    d2 = torch.sum((x[:, None, :] - x[None, :, :]) ** 2, dim=-1)
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    vals = dist[dist > 0]
    # the mean of the two middle values for an even count, as
    # jnp.nanmedian gives it (torch.median returns the lower one)
    return torch.quantile(vals, 0.5) if vals.numel() else dist.new_tensor(
        float("nan"))
