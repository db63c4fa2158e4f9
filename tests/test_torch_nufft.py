"""Port parity: the phase-matrix NUFFT backend and the backend dispatcher
(gpquad_torch.ops.nufft vs gpquad.ops.nufft with method="mxu").

Tolerances: 1e-10 relative to max|ref| in float64 (the two sides do the same
arithmetic, differing only in matmul summation order), 1e-5 in float32
(f32 rounding of sums of up to a few thousand terms of unit size).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.ops.nufft import make_nufft as jax_make_nufft
from gpquad_torch.ops import nufft as tnufft
from gpquad_torch.ops.nufft import make_nufft, make_phase_nufft

_TOL = {np.float64: 1e-10, np.float32: 1e-5}
_MTOT = {1: 41, 2: 15, 3: 7}


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("fft_order", [False, True])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_phase_backend_matches_jax(rng, d, fft_order, dtype):
    n, mtot, h = 600, _MTOT[d], 0.13
    cdtype = np.complex128 if dtype == np.float64 else np.complex64
    x = rng.uniform(-1.5, 1.5, (n, d)).astype(dtype)
    v = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(cdtype)
    f = (rng.normal(size=(mtot,) * d)
         + 1j * rng.normal(size=(mtot,) * d)).astype(cdtype)
    jop = jax_make_nufft(jnp.asarray(x), h, mtot, fft_order=fft_order)
    top = make_phase_nufft(torch.as_tensor(x), h, mtot, fft_order=fft_order)
    got1 = top.type1(torch.as_tensor(v)).numpy()
    want1 = np.asarray(jop.type1(jnp.asarray(v)))
    assert got1.shape == want1.shape
    assert _rel(got1, want1) < _TOL[dtype]
    got2 = top.type2(torch.as_tensor(f)).numpy()
    want2 = np.asarray(jop.type2(jnp.asarray(f)))
    assert _rel(got2, want2) < _TOL[dtype]


@pytest.mark.parametrize("d", [1, 2])
def test_phase_backend_batched_and_flat(rng, d):
    n, mtot, h, B = 300, _MTOT[d], 0.21, 3
    x = rng.uniform(-1, 1, (n, d))
    V = rng.normal(size=(B, n)) + 1j * rng.normal(size=(B, n))
    F = rng.normal(size=(2, B, mtot ** d)) + 0j
    jop = jax_make_nufft(jnp.asarray(x), h, mtot)
    top = make_phase_nufft(torch.as_tensor(x), h, mtot)
    got = top.type1(torch.as_tensor(V)).numpy()
    want = np.asarray(jop.type1(jnp.asarray(V)))
    assert got.shape == want.shape and _rel(got, want) < 1e-10
    got2 = top.type2(torch.as_tensor(F)).numpy()
    want2 = np.asarray(jop.type2(jnp.asarray(F)))
    assert got2.shape == want2.shape == (2, B, n)
    assert _rel(got2, want2) < 1e-10


@pytest.mark.parametrize("d", [1, 2])
def test_chunked_f32_type1(rng, monkeypatch, d):
    """The two-stage f32 type-1 (partials over point chunks) computes the
    same operator: a 256-point chunk at n=1100 exercises the chunked branch
    and its ragged tail at a test's size, against JAX's unchunked f32."""
    monkeypatch.setattr(tnufft, "_CHUNK", 256)
    n, mtot, h = 1100, _MTOT[d], 0.3
    x = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    v = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    want = np.asarray(jax_make_nufft(jnp.asarray(x), h, mtot).type1(
        jnp.asarray(v)))
    got = make_phase_nufft(torch.as_tensor(x), h, mtot).type1(
        torch.as_tensor(v)).numpy()
    assert _rel(got, want) < 1e-5


def test_dispatcher_picks_matmul_on_cpu(rng):
    x = torch.as_tensor(rng.uniform(0, 1, (40, 2)))
    before = dict(tnufft.BACKEND_PICKS)
    op = make_nufft(x, 0.4, 9)
    assert isinstance(op, tnufft.NUFFT)
    assert tnufft.BACKEND_PICKS["matmul"] == before["matmul"] + 1
    assert tnufft.BACKEND_PICKS["cuda"] == before["cuda"]
    assert isinstance(make_nufft(x, 0.4, 9, method="matmul"), tnufft.NUFFT)


def test_dispatcher_rejects_bad_input():
    x = torch.zeros((4, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="odd"):
        make_nufft(x, 0.1, 8)
    with pytest.raises(ValueError, match="Unknown NUFFT method"):
        make_nufft(x, 0.1, 9, method="pallas")
