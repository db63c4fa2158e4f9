"""gpquad_torch: the EFGP regression path of ``gpquad`` in PyTorch (SE and
Matérn kernels, the three variance estimators, the float64 high-precision
tier), the Polya-Gamma classifier and negative-binomial regressor with
their float64 leg, the prior and pathwise posterior samplers, with the d=1,
d=2 and d=3 NUFFTs on hand-written CUDA kernels for Hopper (and the
spreading NUFFT backends "spread", "banded" and "sub" in PyTorch), and the
SKI baseline with its d=2 interpolation on hand-written CUDA kernels.

The package imports neither JAX nor ``gpquad``.  Entry points run on the
CUDA device unless the caller passes ``device="cpu"``.
"""
from .kernels import HyperState, Matern, SquaredExponential, make_kernel
from .models.efgp import (FitState, fit, fit_with_grid, predict_mean,
                          predict_var)
from .models.gradient import GradientResult, gradient, gradient_with_grid
from .models.gradient_high import GradientHighResult, gradient_high
from .models.model import EFGP
from .models.pg import (PolyagammaGPClassifier,
                        PolyagammaGPNegativeBinomialRegressor)
from .models.pg_high import PGHighResult, pg_beta_mean_high, pg_predict_high
from .models.pipeline import (FusedHighResult, FusedResult,
                              fit_predict_grad, fit_predict_grad_high)
from .models.precision import HighState, fit_high, predict_mean_high
from .models.sampling import (sample_bernoulli_gp,
                              sample_bernoulli_gp_spectral, sample_gp_dense,
                              sample_gp_matern, sample_gp_spectral,
                              sample_posterior_pathwise)
from .models.ski import (SKIOperator, build_ski_operator, fit_ski_gp,
                         ski_predict_mean, ski_predict_var)
from .models.variance_high import variance_high
from .quadrature import spectral_grid

__all__ = ["EFGP", "FitState", "FusedHighResult", "FusedResult",
           "GradientHighResult", "GradientResult", "HighState", "HyperState",
           "Matern", "PGHighResult", "PolyagammaGPClassifier",
           "PolyagammaGPNegativeBinomialRegressor", "SKIOperator",
           "SquaredExponential",
           "build_ski_operator", "fit", "fit_high", "fit_predict_grad",
           "fit_predict_grad_high", "fit_ski_gp", "fit_with_grid",
           "gradient", "gradient_high", "gradient_with_grid", "make_kernel",
           "pg_beta_mean_high", "pg_predict_high",
           "predict_mean", "predict_mean_high", "predict_var",
           "sample_bernoulli_gp", "sample_bernoulli_gp_spectral",
           "sample_gp_dense", "sample_gp_matern", "sample_gp_spectral",
           "sample_posterior_pathwise",
           "ski_predict_mean", "ski_predict_var", "spectral_grid",
           "variance_high"]
