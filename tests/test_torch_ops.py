"""Port parity: Toeplitz Gram, operators, dense solve and PCG
(gpquad_torch.ops vs gpquad.ops), float64 on the CPU.

Tolerance 1e-10 relative to the reference's scale: both sides do the same
arithmetic in float64 and differ only in FFT/matmul summation order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.ops import cg as jcg
from gpquad.ops import dense_solve as jds
from gpquad.ops import operators as jops
from gpquad.ops import toeplitz as jtp
from gpquad_torch.ops import cg as tcg
from gpquad_torch.ops import dense_solve as tds
from gpquad_torch.ops import operators as tops
from gpquad_torch.ops import toeplitz as ttp

# The parity problems are small: torch's intra-op threads cost more than
# they give on them, most of all beside other test processes.
torch.set_num_threads(1)


def _rel(got, want):
    return np.max(np.abs(np.asarray(got) - np.asarray(want))) / np.max(
        np.abs(np.asarray(want)))


def _lag_table(rng, n, mtot, d=2, h=0.3):
    x = rng.uniform(0, 1, (n, d))
    m = (mtot - 1) // 2
    jv = np.asarray(jops.convolution_vector(m, jnp.asarray(x), h))
    tv = tops.convolution_vector(m, torch.as_tensor(x), h).numpy()
    return x, jv, tv


def _weights(rng, M):
    return np.exp(-rng.uniform(0, 6, M)) + 0j


def test_convolution_vector_matches(rng):
    _, jv, tv = _lag_table(rng, 500, 9)
    assert tv.shape == jv.shape == (17, 17)
    assert _rel(tv, jv) < 1e-10
    assert float(ttp.toeplitz_diag_scale(torch.as_tensor(tv))) == \
        pytest.approx(500.0, rel=1e-12)


@pytest.mark.parametrize("force_pow2", [True, False])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_toeplitz_matvec_matches(rng, d, force_pow2):
    mtot = {1: 23, 2: 11, 3: 7}[d]
    _, jv, tv = _lag_table(rng, 400, mtot, d=d)
    jT = jtp.make_toeplitz(jnp.asarray(jv), force_pow2=force_pow2)
    tT = ttp.make_toeplitz(torch.as_tensor(tv), force_pow2=force_pow2)
    assert tT.fft_shape == jT.fft_shape and tT.ns == jT.ns
    M = mtot ** d
    X = rng.normal(size=(3, M)) + 1j * rng.normal(size=(3, M))
    assert _rel(tT(torch.as_tensor(X)).numpy(), jT(jnp.asarray(X))) < 1e-10
    if d > 1:      # block layout keeps its shape
        Xb = X.reshape((3,) + (mtot,) * d)
        got = tT(torch.as_tensor(Xb)).numpy()
        assert got.shape == Xb.shape
        assert _rel(got, jT(jnp.asarray(Xb))) < 1e-10


@pytest.mark.parametrize("n", [1, 17, 97, 321, 677, 1000])
def test_next_smooth(n):
    assert ttp._next_smooth(n) == jtp._next_smooth(n)


def test_operators_match(rng):
    mtot = 9
    _, jv, tv = _lag_table(rng, 300, mtot)
    ws = _weights(rng, mtot ** 2)
    jT, tT = jtp.make_toeplitz(jnp.asarray(jv)), ttp.make_toeplitz(
        torch.as_tensor(tv))
    X = rng.normal(size=(2, mtot ** 2)) + 1j * rng.normal(size=(2, mtot ** 2))
    sig = 0.05
    for jmk, tmk in ((jops.make_A_mean, tops.make_A_mean),
                     (jops.make_A_var, tops.make_A_var)):
        want = jmk(jnp.asarray(ws), jT, sig)(jnp.asarray(X))
        got = tmk(torch.as_tensor(ws), tT, sig)(torch.as_tensor(X)).numpy()
        assert _rel(got, want) < 1e-10
    want = jops.make_jacobi_precond(jnp.asarray(ws), sig, 300.0)(
        jnp.asarray(X))
    got = tops.make_jacobi_precond(torch.as_tensor(ws), sig, 300.0)(
        torch.as_tensor(X)).numpy()
    assert _rel(got, want) < 1e-12


def test_dense_gram_inverse_refine_match(rng):
    mtot, d, sig = 9, 2, 0.01
    _, jv, tv = _lag_table(rng, 800, mtot)
    ws = _weights(rng, mtot ** d)
    np.testing.assert_array_equal(tds.dense_lag_gather_indices(mtot, d),
                                  jds.dense_lag_gather_indices(mtot, d))
    jA = jds.dense_gram(jnp.asarray(ws), jnp.asarray(jv), mtot, d, sig)
    tA = tds.dense_gram(torch.as_tensor(ws), torch.as_tensor(tv), mtot, d,
                        sig)
    assert _rel(tA.numpy(), jA) < 1e-10
    jP = jds.dense_inverse(jA)
    tP = tds.dense_inverse(tA)
    assert _rel(tP.numpy(), jP) < 1e-10
    B = rng.normal(size=(4, mtot ** d)) + 1j * rng.normal(size=(4, mtot ** d))
    for scale in (None, 1.0 / sig):
        jr = jds.refine_solve(jA, jP, jnp.asarray(B), scale=scale, tol=1e-10)
        tr = tds.refine_solve(tA, tP, torch.as_tensor(B), scale=scale,
                              tol=1e-10)
        assert _rel(tr.x.numpy(), jr.x) < 1e-10
        assert int(tr.iters) == int(jr.iters)
        np.testing.assert_array_equal(tr.converged.numpy(),
                                      np.asarray(jr.converged))
    single = tds.refine_solve(tA, tP, torch.as_tensor(B[0]))
    assert single.x.shape == (mtot ** d,)


def _hpd_system(rng, B=5):
    """A Hermitian positive-definite system whose spectrum is 8 clusters of
    5 equal eigenvalues.  CG on it reaches the float64 floor in as many
    steps as the right-hand side has clusters, with a residual drop of
    seven decades at that step (to ~1e-8 here), so at tol=1e-6 the stopping step is decided by the
    algebra and not by rounding (on a graded spectrum the two sides' CG
    iterates drift apart at ~1e-5 after 20 steps, as rounding differences
    are amplified).  Lane i of ``b`` lives in the first i + 3 clusters;
    lane 1 is tiny and converges at once through the 1e-12 floor."""
    n, k = 40, 8
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    eig = np.repeat(np.logspace(0, 2, k), n // k)
    A = (Q * eig) @ Q.conj().T
    A = 0.5 * (A + A.conj().T)
    # a preconditioner with A's eigenvectors keeps the clusters
    Minv = (Q / (eig + 3.0)) @ Q.conj().T
    Minv = 0.5 * (Minv + Minv.conj().T)
    coef = rng.normal(size=(B, n)) + 1j * rng.normal(size=(B, n))
    for i in range(B):
        coef[i, (i + 3) * (n // k):] = 0.0
    b = coef @ Q.T
    b[1] *= 1e-14
    return A, b, Minv


@pytest.mark.parametrize("precond", [False, True])
def test_pcg_matches(rng, precond):
    """Same solution, iteration count, lane convergence and conv_iters as
    the JAX while_loop, for a batch with a lane that is converged at start
    and with/without a diagonal preconditioner."""
    A, b, Minv = _hpd_system(rng)
    jA = lambda v: v @ jnp.asarray(A).T                     # noqa: E731
    tA = lambda v: v @ torch.as_tensor(A).T                 # noqa: E731
    jM = (lambda v: v @ jnp.asarray(Minv).T) if precond else None
    tM = (lambda v: v @ torch.as_tensor(Minv).T) if precond else None
    jr = jcg.pcg(jA, jnp.asarray(b), tol=1e-6, maxiter=200, M_inv=jM)
    tr = tcg.pcg(tA, torch.as_tensor(b), tol=1e-6, maxiter=200, M_inv=tM)
    assert _rel(tr.x.numpy(), jr.x) < 1e-10
    assert int(tr.iters) == int(jr.iters)
    np.testing.assert_array_equal(tr.converged.numpy(),
                                  np.asarray(jr.converged))
    np.testing.assert_array_equal(tr.conv_iters.numpy(),
                                  np.asarray(jr.conv_iters))
    # the final residuals are what is left after a drop of seven decades
    # or more, made of rounding: both sides must report them under the
    # stopping test, not equal to each other
    bound = 1e-6 * np.linalg.norm(b, axis=1) + 1e-12
    assert np.all(tr.resnorm.numpy() < bound)
    assert np.all(np.asarray(jr.resnorm) < bound)
    # lane i converges at the step of its last cluster
    assert tr.conv_iters.tolist() == [3, 0, 5, 6, 7]


def test_pcg_single_and_maxiter(rng):
    """A single right-hand side and a run cut by maxiter (not converged,
    conv_iters = maxiter), cut before and after the loop's first host check
    (every 8 steps)."""
    A, b, _ = _hpd_system(rng)
    jA = lambda v: v @ jnp.asarray(A).T                     # noqa: E731
    tA = lambda v: v @ torch.as_tensor(A).T                 # noqa: E731
    for kw in (dict(maxiter=4), dict(maxiter=9)):
        jr = jcg.pcg(jA, jnp.asarray(b[4]), tol=1e-12, **kw)
        tr = tcg.pcg(tA, torch.as_tensor(b[4]), tol=1e-12, **kw)
        assert tr.x.shape == (A.shape[0],)
        assert _rel(tr.x.numpy(), jr.x) < 1e-10
        assert int(tr.iters) == int(jr.iters) == kw["maxiter"]
        assert bool(tr.converged) == bool(jr.converged)
        assert int(tr.conv_iters) == int(jr.conv_iters)
