"""GP prior and posterior samplers; port of ``gpquad/models/sampling.py``.

Dense Cholesky samplers for small oracle problems; the EFGP spectral prior
sampler, complex-Gaussian Fourier coefficients pushed through one type-2
NUFFT (the batched CUDA kernel for a batch of draws at d=2), which scales
to millions of points; and Matheron's pathwise posterior sampler on a
fitted ``FitState``.

Every sampler draws from an explicit ``torch.Generator`` (a fresh one on the
run's device seeded 0 when None), through :func:`_normal` and
:func:`_uniform` only, in the order gpquad splits its key.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..kernels import Matern, SquaredExponential
from ..ops.cg import pcg
from ..ops.nufft import make_nufft
from ..ops.operators import make_A_mean
from ..quadrature import spectral_grid
from .efgp import (_as_points, _cdtype, quadrature_weights, resolve_device,
                   tensor_grid)

__all__ = [
    "sample_gp_dense",
    "sample_gp_matern",
    "sample_gp_spectral",
    "sample_bernoulli_gp",
    "sample_bernoulli_gp_spectral",
    "sample_posterior_pathwise",
]


def _normal(generator, shape, dtype, device):
    """Standard normals from ``generator`` (drawn on its device)."""
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device).to(device)


def _uniform(generator, shape, dtype, device):
    """Uniforms on [0, 1) from ``generator`` (drawn on its device)."""
    return torch.rand(shape, generator=generator, dtype=dtype,
                      device=generator.device).to(device)


def _generator(generator, dev):
    return (generator if generator is not None
            else torch.Generator(device=dev).manual_seed(0))


def _in_dtype(kernel, x):
    return kernel.with_hypers(kernel.hyper_vector().to(x.device, x.dtype))


def sample_gp_dense(generator, x, kernel, *, noise_variance: float = 0.1,
                    num_samples: int = 1, mean=None, jitter: float = 1e-6,
                    device="cuda"):
    """Dense Cholesky GP sampler (reference sample_gp_fast,
    vanilla_gp_sampling.py:100-163).  O(n^3): oracle scale.

    Returns (n,) for one sample or (n, num_samples)."""
    dev = resolve_device(device)
    x = _as_points(x, dev)
    n = x.shape[0]
    K = _in_dtype(kernel, x).kernel_matrix(x, x)
    Kn = K + (noise_variance + jitter) * torch.eye(n, dtype=K.dtype,
                                                   device=dev)
    L = torch.linalg.cholesky(Kn)
    z = _normal(_generator(generator, dev), (n, num_samples), K.dtype, dev)
    mu = (torch.zeros((n,), dtype=K.dtype, device=dev) if mean is None
          else torch.as_tensor(mean, dtype=K.dtype, device=dev))
    samples = mu[:, None] + L @ z
    return samples[:, 0] if num_samples == 1 else samples


def sample_gp_matern(generator, x, *, nu: float = 1.5,
                     lengthscale: float = 1.0, variance: float = 1.0,
                     noise_variance: float = 0.1, num_samples: int = 1,
                     device="cuda"):
    """Matérn dense sampler (reference sample_gp_matern,
    vanilla_gp_sampling.py:262-301)."""
    d = 1 if x.ndim == 1 else x.shape[1]
    kern = Matern(dimension=d, nu=nu, lengthscale=lengthscale,
                  variance=variance)
    return sample_gp_dense(generator, x, kern, noise_variance=noise_variance,
                           num_samples=num_samples, device=device)


def sample_gp_spectral(generator, x, *, lengthscale: float = 1.0,
                       variance: float = 1.0, num_samples: int = 1,
                       spectral_eps: float = 1e-4,
                       trunc_eps: Optional[float] = 1e-4, mean=None,
                       kernel=None, device="cuda"):
    """EFGP spectral-approximation prior sampler (reference
    sample_gp_spectral_approx, vanilla_gp_sampling.py:166-260).

    Draws proper complex Gaussians c ~ CN(0, I) and evaluates
    ``sqrt(2) Re[F (D c)]``, a sample of the rank-M approximate prior
    ``K ~ F D^2 F*``.  The grid is planned on the host for the points'
    extent.  Returns (n,) for one sample or (n, num_samples)."""
    dev = resolve_device(device)
    x = _as_points(x, dev)
    d = x.shape[1]
    if kernel is None:
        kernel = SquaredExponential(lengthscale=lengthscale,
                                    variance=variance, dimension=d)
    L = float((x.max(dim=0).values - x.min(dim=0).values).max())
    if L <= 1e-9:
        L = 1.0
    _, h, mtot = spectral_grid(kernel, spectral_eps, L, trunc_eps=trunc_eps)
    samples = _spectral_draw(_generator(generator, dev), x, kernel, h,
                             mtot=mtot, num_samples=num_samples)
    if mean is not None:
        samples = samples + torch.as_tensor(mean, dtype=samples.dtype,
                                            device=dev)[None, :]
    return samples[0] if num_samples == 1 else samples.T


def _spectral_draw(generator, x, kernel, h, *, mtot: int, num_samples: int):
    """(num_samples, n) draws ``sqrt(2) Re[F (ws * c)]`` on the grid
    (h, mtot)."""
    n, d = x.shape
    rdtype, dev = x.dtype, x.device
    h = torch.as_tensor(h, dtype=rdtype, device=dev)
    m = (mtot - 1) // 2
    xis = tensor_grid(torch.arange(-m, m + 1, dtype=rdtype, device=dev) * h,
                      d)
    ws = quadrature_weights(_in_dtype(kernel, x), xis, h, d)
    M = ws.shape[0]
    cr = _normal(generator, (num_samples, M), rdtype, dev)
    ci = _normal(generator, (num_samples, M), rdtype, dev)
    coeffs = torch.complex(cr, ci) / math.sqrt(2.0)
    latent = make_nufft(x, h, mtot).type2(ws[None, :] * coeffs)
    return math.sqrt(2.0) * latent.real


def _bernoulli(generator, f):
    """Bernoulli(sigmoid(f)) labels as f's dtype."""
    u = _uniform(generator, f.shape, f.dtype, f.device)
    return (u < torch.sigmoid(f)).to(f.dtype)


def sample_bernoulli_gp(generator, x, *, lengthscale: float = 1.0,
                        variance: float = 1.0, noise_variance: float = 1e-4,
                        device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Bernoulli(sigmoid(f)) observations from a dense SE GP draw
    (reference sample_bernoulli_gp, vanilla_gp_sampling.py:303-348).
    Returns (labels, latent)."""
    gen = _generator(generator, resolve_device(device))
    d = 1 if x.ndim == 1 else x.shape[1]
    kern = SquaredExponential(lengthscale=lengthscale, variance=variance,
                              dimension=d)
    f = sample_gp_dense(gen, x, kern, noise_variance=noise_variance,
                        device=device)
    return _bernoulli(gen, f), f


def sample_bernoulli_gp_spectral(generator, x, *, lengthscale: float = 1.0,
                                 variance: float = 1.0,
                                 spectral_eps: float = 1e-4,
                                 trunc_eps: float = 1e-4, device="cuda"
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bernoulli observations from the spectral prior sampler (reference
    sample_bernoulli_gp_spectral_approx, vanilla_gp_sampling.py:351-381).
    Scales to large n.  Returns (labels, latent)."""
    gen = _generator(generator, resolve_device(device))
    f = sample_gp_spectral(gen, x, lengthscale=lengthscale,
                           variance=variance, spectral_eps=spectral_eps,
                           trunc_eps=trunc_eps, device=device)
    return _bernoulli(gen, f), f


def _pathwise_draw(x, y, ws, sigmasq, toeplitz, h, x_new, generator, *,
                   mtot: int, num_samples: int, cg_tol: float,
                   max_cg_iter: int):
    """(samples (S, n_new), CG iterations, (S,) final residuals relative to
    the right-hand sides): prior draws with SHARED
    Fourier coefficients at the data and the targets, the residuals with
    observation noise solved in feature space (unpreconditioned batched
    CG, as gpquad's), one type-2 update."""
    n = x.shape[0]
    rdtype, dev = x.dtype, x.device
    cdtype = _cdtype(rdtype)
    M = ws.shape[0]
    cr = _normal(generator, (num_samples, M), rdtype, dev)
    ci = _normal(generator, (num_samples, M), rdtype, dev)
    coeffs = torch.complex(cr, ci) / math.sqrt(2.0)
    wc = ws[None, :] * coeffs
    nufft_x = make_nufft(x, h, mtot)
    nufft_t = make_nufft(x_new, h, mtot)
    root2 = math.sqrt(2.0)
    f_x = root2 * nufft_x.type2(wc).real                      # (S, n)
    f_t = root2 * nufft_t.type2(wc).real                      # (S, n_new)

    eps = torch.sqrt(sigmasq).to(rdtype) * _normal(
        generator, (num_samples, n), rdtype, dev)
    r = y[None, :] - f_x - eps                                # (S, n)
    rhs = ws[None, :] * nufft_x.type1(r.to(cdtype)).reshape(num_samples, -1)
    res = pcg(make_A_mean(ws, toeplitz, sigmasq), rhs, tol=cg_tol,
              maxiter=max_cg_iter)
    update = nufft_t.type2(ws[None, :] * res.x).real
    rel = res.resnorm / torch.linalg.vector_norm(rhs, dim=-1)
    return f_t + update, res.iters, rel


def sample_posterior_pathwise(x, y, state, x_new, generator=None, *,
                              num_samples: int = 16, cg_tol: float = 1e-6,
                              max_cg_iter: int = 1000):
    """Scalable posterior samples by Matheron's rule (pathwise update).

    ``f_post(x*) = f_prior(x*) + K(x*,X)(K + s2 I)^{-1}(y - f_prior(X) - e)``
    with the EFGP approximate prior ``K ~ F D^2 F*``: one spectral prior
    draw shared between data and targets (two type-2 NUFFTs), one batched
    feature-space CG, one type-2 update.  O(n M) per sample at any number
    of targets.  ``state`` is the ``FitState`` of a fit on ``x``/``y``; the
    run takes its device and the points' dtype.  Returns
    ``(num_samples, n_new)`` samples of the approximate posterior."""
    dev = state.device
    x = _as_points(x, dev)
    x_new = _as_points(x_new, dev, x.dtype)
    y = torch.as_tensor(y, device=dev).to(x.dtype)
    samples, _, _ = _pathwise_draw(
        x, y, state.ws, state.sigmasq, state.toeplitz, state.h, x_new,
        _generator(generator, dev), mtot=state.mtot,
        num_samples=num_samples, cg_tol=cg_tol, max_cg_iter=max_cg_iter)
    return samples
