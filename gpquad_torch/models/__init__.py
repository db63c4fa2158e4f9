"""Models of the port (``gpquad/models``)."""
from .efgp import (FitState, fit, fit_with_grid, posterior_fourier_rows,
                   predict_mean, predict_var, quadrature_weights, tensor_grid)
from .gradient import GradientResult, gradient, gradient_with_grid
from .model import EFGP
from .pg import (PolyagammaGPClassifier,
                 PolyagammaGPNegativeBinomialRegressor)
from .pg_high import PGHighResult, pg_beta_mean_high, pg_predict_high
from .pipeline import FusedResult, fit_predict_grad
from .sampling import (sample_bernoulli_gp, sample_bernoulli_gp_spectral,
                       sample_gp_dense, sample_gp_matern, sample_gp_spectral,
                       sample_posterior_pathwise)
from .ski import (SKIOperator, build_ski_operator, fit_ski_gp,
                  ski_predict_mean, ski_predict_var)

__all__ = ["EFGP", "FitState", "FusedResult", "GradientResult", "fit",
           "fit_predict_grad", "fit_with_grid", "gradient",
           "gradient_with_grid", "PGHighResult", "PolyagammaGPClassifier",
           "PolyagammaGPNegativeBinomialRegressor", "pg_beta_mean_high",
           "pg_predict_high", "posterior_fourier_rows", "predict_mean",
           "predict_var",
           "quadrature_weights", "tensor_grid", "SKIOperator",
           "build_ski_operator", "fit_ski_gp", "ski_predict_mean",
           "ski_predict_var", "sample_bernoulli_gp",
           "sample_bernoulli_gp_spectral", "sample_gp_dense",
           "sample_gp_matern", "sample_gp_spectral",
           "sample_posterior_pathwise"]
