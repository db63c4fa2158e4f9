"""Kernels of the port (``gpquad/kernels``)."""
from __future__ import annotations

from .base import AbstractKernel, median_distance_heuristic
from .params import HyperState
from .squared_exponential import SquaredExponential

__all__ = ["AbstractKernel", "HyperState", "SquaredExponential",
           "make_kernel", "median_distance_heuristic"]


def make_kernel(name, dimension: int = 1, **kwargs):
    """String kernel factory: "SquaredExponential"/"SE".  The Matérn names
    are recognised but not ported yet (ROADMAP queue A, Matérn/Bessel)."""
    if not isinstance(name, str):
        return name
    key = name.lower()
    if key in ("squaredexponential", "se"):
        return SquaredExponential(dimension=dimension, **kwargs)
    if key in ("matern12", "matern32", "matern52"):
        raise NotImplementedError(
            f"{name}: the Matérn kernels are not ported yet (ROADMAP A.1, "
            "Matérn with general-nu Bessel K)")
    raise ValueError(f"Unknown kernel type: {name}")
