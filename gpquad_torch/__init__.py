"""gpquad_torch: the EFGP regression path of ``gpquad`` in PyTorch, with the
d=1, d=2 and d=3 NUFFTs on hand-written CUDA kernels for Hopper, and the SKI
baseline with its d=2 interpolation on hand-written CUDA kernels.

The package imports neither JAX nor ``gpquad``.  Entry points run on the
CUDA device unless the caller passes ``device="cpu"``.
"""
from .kernels import HyperState, SquaredExponential, make_kernel
from .models.efgp import (FitState, fit, fit_with_grid, predict_mean,
                          predict_var)
from .models.gradient import GradientResult, gradient, gradient_with_grid
from .models.model import EFGP
from .models.pipeline import FusedResult, fit_predict_grad
from .models.ski import (SKIOperator, build_ski_operator, fit_ski_gp,
                         ski_predict_mean, ski_predict_var)
from .quadrature import spectral_grid

__all__ = ["EFGP", "FitState", "FusedResult", "GradientResult", "HyperState",
           "SKIOperator", "SquaredExponential", "build_ski_operator", "fit",
           "fit_predict_grad", "fit_ski_gp", "fit_with_grid", "gradient",
           "gradient_with_grid", "make_kernel", "predict_mean", "predict_var",
           "ski_predict_mean", "ski_predict_var", "spectral_grid"]
