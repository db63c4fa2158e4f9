"""gpquad_torch: the EFGP regression path of ``gpquad`` in PyTorch, with the
d=1, d=2 and d=3 NUFFTs on hand-written CUDA kernels for Hopper.

The package imports neither JAX nor ``gpquad``.  Entry points run on the
CUDA device unless the caller passes ``device="cpu"``.
"""
from .kernels import HyperState, SquaredExponential, make_kernel
from .models.efgp import (FitState, fit, fit_with_grid, predict_mean,
                          predict_var)
from .models.gradient import GradientResult, gradient, gradient_with_grid
from .models.model import EFGP
from .models.pipeline import FusedResult, fit_predict_grad
from .quadrature import spectral_grid

__all__ = ["EFGP", "FitState", "FusedResult", "GradientResult", "HyperState",
           "SquaredExponential", "fit", "fit_predict_grad", "fit_with_grid",
           "gradient", "gradient_with_grid", "make_kernel", "predict_mean",
           "predict_var", "spectral_grid"]
