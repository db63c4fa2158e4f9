"""Port parity: the phase-matrix NUFFT backend, the backend dispatcher
(gpquad_torch.ops.nufft vs gpquad.ops.nufft with method="mxu"), and the
batched d=2 kernels' plain versions and dispatch (gpquad_torch.ops.cuda_nufft
vs the batched Pallas kernels and PallasNUFFT).

Tolerances: 1e-10 relative to max|ref| in float64 (the two sides do the same
arithmetic, differing only in matmul summation order), 1e-5 in float32
(f32 rounding of sums of up to a few thousand terms of unit size).  Against
the Pallas kernels, which run in interpret mode off the TPU
(pallas_nufft.py:842-843), 5e-5 * max|ref| in float32: the bar of
tests/test_pallas_nufft.py::test_pallas_batched_kernels_match_map (two f32
evaluations of the same sums, with different sin/cos and summation order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.ops.nufft import make_nufft as jax_make_nufft
from gpquad.ops.pallas_nufft import (PallasNUFFT, pallas_nufft1_2d_batched,
                                     pallas_nufft2_2d_batched)
from gpquad_torch.ops import cuda_nufft
from gpquad_torch.ops import nufft as tnufft
from gpquad_torch.ops.cuda_nufft import (CudaNUFFT, nufft1_2d_batched,
                                         nufft1_2d_batched_ref,
                                         nufft2_2d_batched,
                                         nufft2_2d_batched_ref)
from gpquad_torch.ops.nufft import make_nufft, make_phase_nufft

# The parity problems are small: torch's intra-op threads cost more than
# they give on them, most of all beside other test processes.
torch.set_num_threads(1)

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


# n=600 with the Pallas tile of 512 leaves a ragged last tile
@pytest.mark.parametrize("mtot,B,fft_order,flat", [
    (9, 1, False, False),
    (9, 3, True, True),
    (25, 5, False, True),
    (25, 3, True, False),
])
def test_batched_plain_versions_match_pallas(rng, mtot, B, fft_order, flat):
    n, h = 600, 0.05 if mtot == 25 else 0.31
    x = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    V = (rng.normal(size=(B, n))
         + 1j * rng.normal(size=(B, n))).astype(np.complex64)
    F = (rng.normal(size=(B, mtot, mtot))
         + 1j * rng.normal(size=(B, mtot, mtot))).astype(np.complex64)
    if flat:
        F = F.reshape(B, mtot * mtot)
    kw = dict(mtot=mtot, fft_order=fft_order)
    want2 = np.asarray(pallas_nufft2_2d_batched(jnp.asarray(x),
                                                jnp.asarray(F), h, **kw))
    got2 = nufft2_2d_batched_ref(torch.as_tensor(x), torch.as_tensor(F), h,
                                 **kw).numpy()
    assert got2.shape == want2.shape == (B, n)
    assert _rel(got2, want2) < 5e-5
    want1 = np.asarray(pallas_nufft1_2d_batched(jnp.asarray(x),
                                                jnp.asarray(V), h, **kw))
    got1 = nufft1_2d_batched_ref(torch.as_tensor(x), torch.as_tensor(V), h,
                                 **kw).numpy()
    assert got1.shape == want1.shape == (B, mtot, mtot)
    assert _rel(got1, want1) < 5e-5


@pytest.mark.parametrize("fft_order", [False, True])
def test_batched_plain_versions_match_mxu_f64(rng, fft_order):
    n, mtot, h, B = 500, 25, 0.07, 4
    x = rng.uniform(-1, 1, (n, 2))
    V = rng.normal(size=(B, n)) + 1j * rng.normal(size=(B, n))
    F = rng.normal(size=(B, mtot * mtot)) + 1j * rng.normal(
        size=(B, mtot * mtot))
    jop = jax_make_nufft(jnp.asarray(x), h, mtot, fft_order=fft_order,
                         method="mxu")
    kw = dict(mtot=mtot, fft_order=fft_order)
    got1 = nufft1_2d_batched_ref(torch.as_tensor(x), torch.as_tensor(V), h,
                                 **kw).numpy()
    assert _rel(got1, np.asarray(jop.type1(jnp.asarray(V)))) < 1e-10
    got2 = nufft2_2d_batched_ref(torch.as_tensor(x), torch.as_tensor(F), h,
                                 **kw).numpy()
    assert _rel(got2, np.asarray(jop.type2(jnp.asarray(F)))) < 1e-10


def test_cuda_backend_dispatch_on_cpu(rng, monkeypatch):
    """CudaNUFFT on CPU tensors: a batch of two or more goes through the
    plain batched version once, a single vector (also a batch of one)
    through the single plain version; shapes are PallasNUFFT's
    (``lead + (m, m)`` and ``lead + (n,)``), flat or block-shaped modes."""
    n, mtot, h = 300, 9, 0.3
    x = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    V = (rng.normal(size=(2, 3, n))
         + 1j * rng.normal(size=(2, 3, n))).astype(np.complex64)
    F = (rng.normal(size=(2, 3, mtot, mtot))
         + 1j * rng.normal(size=(2, 3, mtot, mtot))).astype(np.complex64)
    calls = []
    for name in ("nufft1_2d_ref", "nufft2_2d_ref", "nufft1_2d_batched_ref",
                 "nufft2_2d_batched_ref"):
        real = getattr(cuda_nufft, name)
        monkeypatch.setattr(
            cuda_nufft, name,
            lambda *a, _real=real, _name=name, **k: (calls.append(_name),
                                                     _real(*a, **k))[1])
    op = CudaNUFFT(x=torch.as_tensor(x), h=h, mtot=mtot)
    pop = PallasNUFFT(x=jnp.asarray(x), h=jnp.asarray(h, jnp.float32),
                      mtot=mtot)
    before = dict(cuda_nufft.LAUNCHES)

    got1 = op.type1(torch.as_tensor(V)).numpy()
    want1 = np.asarray(pop.type1(jnp.asarray(V)))
    assert calls == ["nufft1_2d_batched_ref"]
    assert got1.shape == want1.shape == (2, 3, mtot, mtot)
    assert _rel(got1, want1) < 5e-5
    for fk in (F, F.reshape(2, 3, mtot * mtot)):
        calls.clear()
        got2 = op.type2(torch.as_tensor(fk)).numpy()
        want2 = np.asarray(pop.type2(jnp.asarray(fk)))
        assert calls == ["nufft2_2d_batched_ref"]
        assert got2.shape == want2.shape == (2, 3, n)
        assert _rel(got2, want2) < 5e-5

    calls.clear()
    assert op.type1(torch.as_tensor(V[0, :1])).shape == (1, mtot, mtot)
    assert op.type2(torch.as_tensor(F[0, 0])).shape == (n,)
    assert op.type2(torch.as_tensor(F[0, :1])).shape == (1, n)
    assert calls == ["nufft1_2d_ref", "nufft2_2d_ref", "nufft2_2d_ref"]
    assert cuda_nufft.LAUNCHES == before


def test_batched_wrappers_validate_shapes():
    x = torch.zeros((5, 2))
    with pytest.raises(ValueError, match="B, 3, 3"):
        nufft2_2d_batched(x, torch.zeros((2, 8), dtype=torch.complex64),
                          0.1, mtot=3)
    with pytest.raises(ValueError, match="at least one"):
        nufft2_2d_batched(x, torch.zeros((0, 3, 3), dtype=torch.complex64),
                          0.1, mtot=3)
    with pytest.raises(ValueError, match=r"\(B, 5\)"):
        nufft1_2d_batched(x, torch.zeros((2, 4), dtype=torch.complex64),
                          0.1, mtot=3)
    with pytest.raises(ValueError, match="32-bit"):
        nufft1_2d_batched(x, torch.zeros((2 ** 14, 5), dtype=torch.complex64),
                          0.1, mtot=363)
