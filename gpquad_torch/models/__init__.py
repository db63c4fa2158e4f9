"""Models of the port (``gpquad/models``)."""
from .efgp import (FitState, fit, fit_with_grid, predict_mean, predict_var,
                   quadrature_weights, tensor_grid)
from .gradient import GradientResult, gradient, gradient_with_grid
from .model import EFGP
from .pipeline import FusedResult, fit_predict_grad
from .ski import (SKIOperator, build_ski_operator, fit_ski_gp,
                  ski_predict_mean, ski_predict_var)

__all__ = ["EFGP", "FitState", "FusedResult", "GradientResult", "fit",
           "fit_predict_grad", "fit_with_grid", "gradient",
           "gradient_with_grid", "predict_mean", "predict_var",
           "quadrature_weights", "tensor_grid", "SKIOperator",
           "build_ski_operator", "fit_ski_gp", "ski_predict_mean",
           "ski_predict_var"]
