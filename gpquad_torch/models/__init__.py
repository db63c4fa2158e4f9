"""Models of the port (``gpquad/models``)."""
from .efgp import (FitState, fit, fit_with_grid, predict_mean, predict_var,
                   quadrature_weights, tensor_grid)

__all__ = ["FitState", "fit", "fit_with_grid", "predict_mean", "predict_var",
           "quadrature_weights", "tensor_grid"]
