"""Kernels of the port (``gpquad/kernels``)."""
from __future__ import annotations

from .base import AbstractKernel, median_distance_heuristic
from .matern import Matern
from .params import HyperState
from .squared_exponential import SquaredExponential

__all__ = ["AbstractKernel", "HyperState", "Matern", "SquaredExponential",
           "make_kernel", "median_distance_heuristic"]


def make_kernel(name, dimension: int = 1, **kwargs):
    """String kernel factory: "SquaredExponential"/"SE", and "Matern12",
    "Matern32", "Matern52" (nu = 1/2, 3/2, 5/2)."""
    if not isinstance(name, str):
        return name
    key = name.lower()
    if key in ("squaredexponential", "se"):
        return SquaredExponential(dimension=dimension, **kwargs)
    if key == "matern12":
        return Matern(dimension=dimension, nu=0.5, **kwargs)
    if key == "matern32":
        return Matern(dimension=dimension, nu=1.5, **kwargs)
    if key == "matern52":
        return Matern(dimension=dimension, nu=2.5, **kwargs)
    raise ValueError(f"Unknown kernel type: {name}")
