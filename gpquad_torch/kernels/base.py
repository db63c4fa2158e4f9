"""Kernel base class: hyperparameters as buffers of an ``nn.Module``.

Port of ``gpquad/kernels/base.py``.  The JAX kernels are immutable pytrees;
here a kernel is an ``nn.Module`` whose hyperparameters are buffers, so
``.to(device, dtype)`` moves them with the module, and :meth:`with_hypers`
returns a new kernel rather than changing this one.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

__all__ = ["AbstractKernel"]


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
        return type(self)(dimension=self.dimension, **updates)

    def kernel(self, distance):
        raise NotImplementedError

    def spectral_density(self, xi):
        raise NotImplementedError
