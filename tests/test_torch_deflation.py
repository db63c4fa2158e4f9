"""Port parity for the deflation preconditioner (gpquad_torch.ops.deflation vs
gpquad.ops.deflation), float64 on the CPU.

The same numpy weights and lag table go to both sides.  The weights are SE
quadrature weights, which depend on |k| only, so whole shells of modes tie
in |ws|^2; the rank is chosen inside a shell.  ``jax.lax.top_k`` keeps the
lower index first on ties, and the port's stable descending sort must pick
the identical modes (``torch.topk`` does not promise that).  Tolerance for
the head inverse and the applies: 1e-10 relative to the reference's scale
(both sides factor the same matrix in float64).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.ops import deflation as jdefl
from gpquad.ops import operators as jops
from gpquad_torch.ops import deflation as tdefl

# The parity problems are small: torch's intra-op threads cost more than
# they give on them, most of all beside other test processes.
torch.set_num_threads(1)


def _rel(got, want):
    return np.max(np.abs(np.asarray(got) - np.asarray(want))) / np.max(
        np.abs(np.asarray(want)))


def _problem(rng, mtot, d, n=300, h=0.4, ell=0.3):
    """SE weights on the (mtot,)*d grid (exact ties on shells of |k|^2) and
    the lag table of n random points."""
    m = (mtot - 1) // 2
    k = np.arange(-m, m + 1)
    k2 = sum(g ** 2 for g in np.meshgrid(*([k] * d), indexing="ij"))
    s = np.exp(-2 * np.pi ** 2 * ell ** 2 * h ** 2 * k2.ravel().astype(float))
    ws = np.sqrt(s * h ** d) + 0j
    x = rng.uniform(0, 1, (n, d))
    v = np.array(jops.convolution_vector(m, jnp.asarray(x), h))
    return ws, v


def _rank_inside_a_shell(ws):
    """A rank that cuts a tie shell: the k-th and (k+1)-th largest |ws|^2
    are equal."""
    w2 = np.sort(np.abs(ws) ** 2)[::-1]
    for k in range(8, len(w2) - 1):
        if w2[k - 1] == w2[k] and w2[k - 2] != w2[k - 1]:
            return k
    raise AssertionError("no tie shell")


@pytest.mark.parametrize("d,mtot", [(2, 15), (3, 7)])
def test_deflation_block_matches_jax(rng, d, mtot):
    ws, v = _problem(rng, mtot, d)
    rank = _rank_inside_a_shell(ws)
    sig = 0.05
    jidx, jP = jdefl.deflation_block(jnp.asarray(ws), jnp.asarray(v), sig,
                                     mtot=mtot, d=d, rank=rank)
    tidx, tP = tdefl.deflation_block(torch.as_tensor(ws), torch.as_tensor(v),
                                     sig, mtot=mtot, d=d, rank=rank)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert _rel(tP.numpy(), jP) < 1e-10
    # a rank past the grid takes every mode
    tidx_all, _ = tdefl.deflation_block(torch.as_tensor(ws),
                                        torch.as_tensor(v), sig, mtot=mtot,
                                        d=d, rank=10 ** 6)
    assert sorted(tidx_all.tolist()) == list(range(mtot ** d))


def test_block_precond_matches_jax(rng):
    d, mtot, sig = 3, 7, 0.05
    ws, v = _problem(rng, mtot, d)
    M = mtot ** d
    R = rng.normal(size=(3, M)) + 1j * rng.normal(size=(3, M))
    jM = jdefl.make_deflation_precond(jnp.asarray(ws), jnp.asarray(v), sig,
                                      mtot=mtot, d=d, rank=40,
                                      diag_scale=300.0)
    tM = tdefl.make_deflation_precond(torch.as_tensor(ws), torch.as_tensor(v),
                                      sig, mtot=mtot, d=d, rank=40,
                                      diag_scale=300.0)
    for r in (R, R[0]):
        got = tM(torch.as_tensor(r)).numpy()
        assert got.shape == r.shape
        assert _rel(got, jM(jnp.asarray(r))) < 1e-10
    # the apply leaves its input alone
    Rt = torch.as_tensor(R)
    before = Rt.clone()
    tM(Rt)
    assert torch.equal(Rt, before)
