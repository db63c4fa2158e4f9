"""Models of the port (``gpquad/models``)."""
from .efgp import (FitState, fit, fit_with_grid, predict_mean, predict_var,
                   quadrature_weights, tensor_grid)
from .gradient import GradientResult, gradient, gradient_with_grid
from .model import EFGP
from .pipeline import FusedResult, fit_predict_grad

__all__ = ["EFGP", "FitState", "FusedResult", "GradientResult", "fit",
           "fit_predict_grad", "fit_with_grid", "gradient",
           "gradient_with_grid", "predict_mean", "predict_var",
           "quadrature_weights", "tensor_grid"]
