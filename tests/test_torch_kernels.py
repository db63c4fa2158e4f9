"""Port parity: kernels and grid planning (gpquad_torch vs gpquad, float64).

Both sides run on the CPU in float64 (conftest enables JAX x64), so the
spectral density agrees to rounding (1e-12 relative) and the bisection
planner gives the same ``mtot`` exactly and ``h`` to 1e-12 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.kernels import SquaredExponential as JaxSE
from gpquad.quadrature import grid_geometry as jax_grid_geometry
from gpquad.quadrature import spectral_grid as jax_spectral_grid
from gpquad_torch.kernels import SquaredExponential, make_kernel
from gpquad_torch.quadrature import grid_geometry, spectral_grid

# The parity problems are small: torch's intra-op threads cost more than
# they give on them, most of all beside other test processes.
torch.set_num_threads(1)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_se_spectral_density_and_kernel(rng, d):
    xi = rng.normal(size=(50, d)) * 3.0
    r = np.abs(rng.normal(size=40))
    jk = JaxSE(lengthscale=0.17, variance=1.3, dimension=d)
    tk = SquaredExponential(dimension=d, lengthscale=0.17, variance=1.3)
    want = np.asarray(jk.spectral_density(jnp.asarray(xi)))
    got = tk.spectral_density(torch.as_tensor(xi)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    np.testing.assert_allclose(tk.kernel(torch.as_tensor(r)).numpy(),
                               np.asarray(jk.kernel(jnp.asarray(r))),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(tk.spectral_grad(torch.as_tensor(xi)).numpy(),
                               np.asarray(jk.spectral_grad(jnp.asarray(xi))),
                               rtol=1e-12, atol=0)


def test_hyper_plumbing():
    k = make_kernel("SE", 2, lengthscale=0.3, variance=2.0)
    np.testing.assert_array_equal(k.hyper_vector().numpy(), [0.3, 2.0])
    k2 = k.with_hypers(torch.tensor([0.5, 4.0, 0.01]))   # noise ignored
    np.testing.assert_array_equal(k2.hyper_vector().numpy(), [0.5, 4.0])
    assert k2.dimension == 2
    np.testing.assert_array_equal(k.hyper_vector().numpy(), [0.3, 2.0])
    k32 = k.with_hypers(k.hyper_vector().to(torch.float32))
    assert k32.lengthscale.dtype == torch.float32


def test_make_kernel_names():
    assert isinstance(make_kernel("SquaredExponential", 1), SquaredExponential)
    for name, nu in (("Matern12", 0.5), ("Matern32", 1.5),
                     ("Matern52", 2.5)):
        k = make_kernel(name, 2, lengthscale=0.3)
        assert type(k).__name__ == "Matern" and k.nu == nu
        assert k.with_hypers(torch.tensor([0.5, 2.0])).nu == nu
    with pytest.raises(ValueError):
        make_kernel("Cauchy", 1)


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("eps", [1e-2, 1e-4, 1e-6])
@pytest.mark.parametrize("lengthscale", [0.05, 0.1, 0.3])
def test_spectral_grid_matches(lengthscale, eps, d):
    jk = JaxSE(lengthscale=lengthscale, variance=1.0, dimension=d)
    tk = SquaredExponential(dimension=d, lengthscale=lengthscale, variance=1.0)
    jx, jh, jm = jax_spectral_grid(jk, eps, 1.0)
    tx, th, tm = spectral_grid(tk, eps, 1.0)
    assert tm == jm
    assert abs(th - jh) <= 1e-12 * jh
    np.testing.assert_allclose(tx, jx, rtol=1e-12, atol=0)


@pytest.mark.parametrize("lengthscale,eps,d", [(0.12, 1e-5, 2),
                                               (0.3, 1e-3, 1)])
def test_se_heuristic_geometry_matches(lengthscale, eps, d):
    jk = JaxSE(lengthscale=lengthscale, variance=1.5, dimension=d)
    tk = SquaredExponential(dimension=d, lengthscale=lengthscale,
                            variance=1.5)
    jh, jhm = jax_grid_geometry(jk, eps, 1.3, use_integral=False)
    th, thm = grid_geometry(tk, eps, 1.3, use_integral=False)
    np.testing.assert_allclose(float(th), float(jh), rtol=1e-12)
    np.testing.assert_allclose(float(thm), float(jhm), rtol=1e-12)


def test_planner_runs_in_float64_from_float32_hypers():
    """Hypers held in float32 are planned in float64 from their f32 values,
    as the JAX planner does under x64 with f32 hypers."""
    jk = JaxSE(lengthscale=jnp.float32(0.1), variance=jnp.float32(1.0),
               dimension=2)
    tk = SquaredExponential(dimension=2,
                            lengthscale=torch.tensor(0.1, dtype=torch.float32),
                            variance=torch.tensor(1.0, dtype=torch.float32))
    _, jh, jm = jax_spectral_grid(jk, 1e-6, 1.0)
    _, th, tm = spectral_grid(tk, 1e-6, 1.0)
    assert tm == jm == 29
    assert abs(th - jh) <= 1e-12 * jh
