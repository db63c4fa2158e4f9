"""Port parity for the d=1 NUFFT: the plain versions of the CUDA pair
``nufft1_1d`` / ``nufft2_1d`` (gpquad_torch.ops.cuda_nufft) against the
Pallas kernels ``pallas_nufft1_1d`` / ``pallas_nufft2_1d``, which run in
interpret mode off the TPU (pallas_nufft.py:551-552), and against gpquad's
phase-matrix backend in float64; the d=1 dispatch on the CPU.

Tolerances: 5e-5 * max|ref| against the Pallas kernels in float32, the bar
of tests/test_pallas_nufft.py::test_pallas_1d_matches_mxu (two f32
evaluations of the same sums with different sin/cos and summation order);
1e-10 against gpquad's float64 phase matrices (the same arithmetic in a
different summation order).  The float32 tensor-core kernels' twins
``nufft1_1d_3xtf32_ref`` and ``nufft2_1d_3xtf32_ref`` are held to the
Pallas kernels at 5e-5 and, against float64, to max(2x the float32 plain
version's error, 1e-6) of max|ref|, which their plain-TF32 controls
(``passes=1``) must miss.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.ops.nufft import make_nufft as jax_make_nufft
from gpquad.ops.pallas_nufft import (PallasNUFFT, pallas_nufft1_1d,
                                     pallas_nufft2_1d)
from gpquad_torch.ops import cuda_nufft
from gpquad_torch.ops import nufft as tnufft
from gpquad_torch.ops.cuda_nufft import (CudaNUFFT, nufft1_1d,
                                         nufft1_1d_3xtf32_ref, nufft1_1d_ref,
                                         nufft2_1d, nufft2_1d_3xtf32_ref,
                                         nufft2_1d_ref, type1_1d_geometry,
                                         type1_1d_split, type2_1d_geometry,
                                         type2_1d_scratch_floats,
                                         type2_1d_tc_geometry)
from gpquad_torch.ops.nufft import make_nufft

# The parity problems are small: torch's intra-op threads cost more than
# they give on them, most of all beside other test processes.
torch.set_num_threads(1)


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


# n = 1500 with the Pallas tile of 1024 leaves a ragged last tile; mtot 1031
# is the phase-8 rung, past one 1024-mode block
@pytest.mark.parametrize("mtot,h", [(41, 0.07), (1031, 0.0097)])
@pytest.mark.parametrize("fft_order", [False, True])
def test_plain_versions_match_pallas(rng, mtot, h, fft_order):
    n = 1500
    x = rng.uniform(-1, 1, (n, 1)).astype(np.float32)
    f = (rng.normal(size=mtot) + 1j * rng.normal(size=mtot)).astype(
        np.complex64)
    v = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    kw = dict(mtot=mtot, fft_order=fft_order)
    want2 = np.asarray(pallas_nufft2_1d(jnp.asarray(x), jnp.asarray(f), h,
                                        **kw))
    got2 = nufft2_1d_ref(torch.as_tensor(x), torch.as_tensor(f), h,
                         **kw).numpy()
    assert got2.shape == want2.shape == (n,)
    assert _rel(got2, want2) < 5e-5
    want1 = np.asarray(pallas_nufft1_1d(jnp.asarray(x), jnp.asarray(v), h,
                                        **kw))
    got1 = nufft1_1d_ref(torch.as_tensor(x), torch.as_tensor(v), h,
                         **kw).numpy()
    assert got1.shape == want1.shape == (mtot,)
    assert _rel(got1, want1) < 5e-5


@pytest.mark.parametrize("B", [1, 3])
def test_batched_plain_versions_match_pallas_map(rng, B):
    """A batch in one call of the plain versions against gpquad's
    ``lax.map`` of the single Pallas kernel (PallasNUFFT, :294-297,
    :313-315)."""
    n, mtot, h = 700, 63, 0.05
    x = rng.uniform(-1, 1, (n, 1)).astype(np.float32)
    V = (rng.normal(size=(B, n)) + 1j * rng.normal(size=(B, n))).astype(
        np.complex64)
    F = (rng.normal(size=(B, mtot)) + 1j * rng.normal(size=(B, mtot))).astype(
        np.complex64)
    pop = PallasNUFFT(x=jnp.asarray(x), h=jnp.asarray(h, jnp.float32),
                      mtot=mtot)
    want1 = np.asarray(jax.lax.map(
        lambda v: pallas_nufft1_1d(pop.x, v, pop.h, mtot=mtot),
        jnp.asarray(V)))
    got1 = nufft1_1d_ref(torch.as_tensor(x), torch.as_tensor(V), h,
                         mtot=mtot).numpy()
    assert got1.shape == want1.shape == (B, mtot)
    assert _rel(got1, want1) < 5e-5
    want2 = np.asarray(pop.type2(jnp.asarray(F)))
    got2 = nufft2_1d_ref(torch.as_tensor(x), torch.as_tensor(F), h,
                         mtot=mtot).numpy()
    assert got2.shape == want2.shape == (B, n)
    assert _rel(got2, want2) < 5e-5


@pytest.mark.parametrize("mtot", [1, 9, 2061])
@pytest.mark.parametrize("fft_order", [False, True])
def test_plain_versions_match_mxu_f64(rng, mtot, fft_order):
    n, h, B = 400, 0.0031, 2
    x = rng.uniform(-1, 1, (n, 1))
    V = rng.normal(size=(B, n)) + 1j * rng.normal(size=(B, n))
    F = rng.normal(size=(B, mtot)) + 1j * rng.normal(size=(B, mtot))
    jop = jax_make_nufft(jnp.asarray(x), h, mtot, fft_order=fft_order,
                         method="mxu")
    kw = dict(mtot=mtot, fft_order=fft_order)
    got1 = nufft1_1d_ref(torch.as_tensor(x), torch.as_tensor(V), h,
                         **kw).numpy()
    assert _rel(got1, np.asarray(jop.type1(jnp.asarray(V)))) < 1e-10
    got2 = nufft2_1d_ref(torch.as_tensor(x), torch.as_tensor(F[0]), h,
                         **kw).numpy()
    assert _rel(got2, np.asarray(jop.type2(jnp.asarray(F[0])))) < 1e-10


def test_make_nufft_takes_the_plain_path_for_d1_on_cpu(rng):
    x = torch.as_tensor(rng.uniform(0, 1, 50))
    before = dict(tnufft.BACKEND_PICKS)
    op = make_nufft(x, 0.4, 2061)
    assert isinstance(op, tnufft.NUFFT) and op.d == 1
    assert tnufft.BACKEND_PICKS["matmul"] == before["matmul"] + 1
    assert tnufft.BACKEND_PICKS["cuda"] == before["cuda"]


def test_cuda_backend_dispatch_on_cpu_d1(rng, monkeypatch):
    """CudaNUFFT at d=1 on CPU tensors: one call of the plain version for a
    single vector or any leading batch; shapes are PallasNUFFT's; nothing
    counts as a launch."""
    n, mtot, h = 300, 21, 0.3
    x = rng.uniform(-1, 1, (n, 1)).astype(np.float32)
    V = (rng.normal(size=(2, 3, n))
         + 1j * rng.normal(size=(2, 3, n))).astype(np.complex64)
    F = (rng.normal(size=(2, 3, mtot))
         + 1j * rng.normal(size=(2, 3, mtot))).astype(np.complex64)
    calls = []
    for name in ("nufft1_1d_ref", "nufft2_1d_ref"):
        real = getattr(cuda_nufft, name)
        monkeypatch.setattr(
            cuda_nufft, name,
            lambda *a, _real=real, _name=name, **k: (calls.append(_name),
                                                     _real(*a, **k))[1])
    op = CudaNUFFT(x=torch.as_tensor(x), h=h, mtot=mtot)
    pop = PallasNUFFT(x=jnp.asarray(x), h=jnp.asarray(h, jnp.float32),
                      mtot=mtot)
    before = dict(cuda_nufft.LAUNCHES)
    widths = dict(cuda_nufft.LAUNCH_WIDTHS)
    got1 = op.type1(torch.as_tensor(V)).numpy()
    want1 = np.asarray(pop.type1(jnp.asarray(V)))
    got2 = op.type2(torch.as_tensor(F)).numpy()
    want2 = np.asarray(pop.type2(jnp.asarray(F)))
    assert calls == ["nufft1_1d_ref", "nufft2_1d_ref"]
    assert got1.shape == want1.shape == (2, 3, mtot)
    assert got2.shape == want2.shape == (2, 3, n)
    assert _rel(got1, want1) < 5e-5 and _rel(got2, want2) < 5e-5
    assert op.type1(torch.as_tensor(V[0, 0])).shape == (mtot,)
    assert op.type2(torch.as_tensor(F[0, 0])).shape == (n,)
    assert cuda_nufft.LAUNCHES == before
    assert cuda_nufft.LAUNCH_WIDTHS == widths


def test_1d_wrappers_validate_shapes():
    x = torch.zeros((5, 1))
    with pytest.raises(ValueError, match=r"\(N, 1\)"):
        nufft2_1d(torch.zeros((5, 2)), torch.zeros(3, dtype=torch.complex64),
                  0.1, mtot=3)
    with pytest.raises(ValueError, match=r"\(3,\) or \(B, 3\)"):
        nufft2_1d(x, torch.zeros(4, dtype=torch.complex64), 0.1, mtot=3)
    with pytest.raises(ValueError, match=r"\(5,\) or \(B, 5\)"):
        nufft1_1d(x, torch.zeros((2, 4), dtype=torch.complex64), 0.1, mtot=3)
    with pytest.raises(ValueError, match="odd"):
        nufft1_1d(x, torch.zeros(5, dtype=torch.complex64), 0.1, mtot=4)
    with pytest.raises(ValueError, match="at least one"):
        nufft2_1d(x, torch.zeros((0, 3), dtype=torch.complex64), 0.1, mtot=3)


# mtot 33 (one column of q at K 64), 1031 (the light curve's rung) and 2061
# in FFT order (its lag table: two column tiles); B 3 runs in pairs (K 32),
# its last pair half empty; n 1500 gives several point groups
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("mtot,h,fft_order", [(33, 0.3, False),
                                              (1031, 0.0097, False),
                                              (2061, 0.0049, True)])
def test_3xtf32_twin_matches_pallas(rng, B, mtot, h, fft_order):
    n = 1500
    x = rng.uniform(-1, 1, (n, 1)).astype(np.float32)
    v = (rng.normal(size=(B, n))
         + 1j * rng.normal(size=(B, n))).astype(np.complex64)
    hq = float(np.float32(h))
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    kw = dict(mtot=mtot, fft_order=fft_order)
    arg = vt[0] if B == 1 else vt
    twin = nufft1_1d_3xtf32_ref(xt, arg, hq, **kw).numpy()
    assert twin.shape == ((mtot,) if B == 1 else (B, mtot))
    twin = twin.reshape(B, mtot)
    want = np.stack([np.asarray(pallas_nufft1_1d(
        jnp.asarray(x), jnp.asarray(v[b]), hq, **kw)) for b in range(B)])
    assert _rel(twin, want) < 5e-5
    ref = nufft1_1d_ref(xt.double(), vt.to(torch.complex128), hq,
                        **kw).numpy()
    plain = nufft1_1d_ref(xt, vt, hq, **kw).numpy()
    bar = max(2 * _rel(plain, ref), 1e-6)
    assert _rel(twin, ref) <= bar
    control = nufft1_1d_3xtf32_ref(xt, arg, hq, passes=1, **kw).numpy()
    assert _rel(control.reshape(B, mtot), ref) > bar


@pytest.mark.parametrize("n,mtot,B", [
    (63_480, 1031, 1), (63_480, 2061, 1), (63_480, 1031, 10),
    (20_000, 8191, 1), (1, 1, 1), (1500, 33, 3), (5000, 57, 2)])
def test_type1_1d_geometry(n, mtot, B):
    """The float32 d=1 type-1's geometry: K 64 for one vector and 32 for a
    batch in pairs, the narrow tile while the q values fit two of them;
    whole runs of whole register sums a group, no group empty, at most
    CARD_SMS blocks; the split reaches every mode |k| <= half once
    and the crop leaves out the rest."""
    path, rows, cols, group, stage, run, chunk = type1_1d_geometry(n, mtot, B)
    assert path == "tc" and rows == cuda_nufft.TYPE1_2D_ROWS
    assert group == (1 if B == 1 else 2)
    K = rows // group
    qmin, Q = type1_1d_split(mtot, K)
    assert cols == (32 if Q <= 64 else 128)
    assert run % stage == 0 and chunk % run == 0
    groups = -(-n // chunk)
    assert (groups - 1) * chunk < n
    tiles = -(-Q // cols) * -(-B // group)
    assert tiles * groups <= max(tiles, cuda_nufft.CARD_SMS)
    half = (mtot - 1) // 2
    k = K * (qmin + np.arange(Q))[None, :] + np.arange(K)[:, None]
    kept = np.sort(k[np.abs(k) <= half])
    assert np.array_equal(kept, np.arange(-half, half + 1))
    assert k.min() <= -half and k.max() >= half
    # no q value is wholly cropped
    assert np.all((np.abs(k) <= half).any(axis=0))


def test_1d_type1_launch_refuses_foreign_path(rng):
    """The d=1 type-1's launch takes ("tc", 6 fields) or ("cuda", chunk)
    and refuses any other geometry before it touches the card, in either
    precision; in float64, whose tensor-core path is the FP64 tensor
    cores', it refuses the float32 one (its 3xTF32 stage and runs of 256
    points)."""
    x64 = torch.as_tensor(rng.uniform(0, 1, (64, 1)))
    geo = type1_1d_geometry(64, 33)
    for x in (x64.float(), x64):
        v = torch.ones((1, 64), dtype=cuda_nufft._complex_of(x.dtype))
        for bad in (("tc",) + geo[1:-1], ("split", 16), ("cuda",),
                    geo + (1,)):
            with pytest.raises(ValueError, match="no d=1 type-1 path"):
                cuda_nufft._nufft1_1d_on(x, v, 0.3, 33, False, bad)
    with pytest.raises(ValueError, match="in float64"):
        cuda_nufft._nufft1_1d_on(x64, v, 0.3, 33, False, geo)


# the type-2's twin at the same shapes: mtot 33 (two values of q at K 32),
# 1031 (the light curve's rung) and 2061 in FFT order (its variance
# evaluation); B 1 on the 32-column tile (its epilogue in four chunks of 8
# values of r), B 3 on the 128-column one (a chunk of 32 a vector, 96 of
# 128 columns live)
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("mtot,h,fft_order", [(33, 0.3, False),
                                              (1031, 0.0097, False),
                                              (2061, 0.0049, True)])
def test_type2_3xtf32_twin_matches_pallas(rng, B, mtot, h, fft_order):
    n = 1500
    x = rng.uniform(-1, 1, (n, 1)).astype(np.float32)
    f = (rng.normal(size=(B, mtot))
         + 1j * rng.normal(size=(B, mtot))).astype(np.complex64)
    hq = float(np.float32(h))
    xt, ft = torch.as_tensor(x), torch.as_tensor(f)
    kw = dict(mtot=mtot, fft_order=fft_order)
    arg = ft[0] if B == 1 else ft
    twin = nufft2_1d_3xtf32_ref(xt, arg, hq, **kw).numpy()
    assert twin.shape == ((n,) if B == 1 else (B, n))
    twin = twin.reshape(B, n)
    want = np.stack([np.asarray(pallas_nufft2_1d(
        jnp.asarray(x), jnp.asarray(f[b]), hq, **kw)) for b in range(B)])
    assert _rel(twin, want) < 5e-5
    ref = nufft2_1d_ref(xt.double(), ft.to(torch.complex128), hq,
                        **kw).numpy()
    plain = nufft2_1d_ref(xt, ft, hq, **kw).numpy()
    bar = max(2 * _rel(plain, ref), 1e-6)
    assert _rel(twin, ref) <= bar
    control = nufft2_1d_3xtf32_ref(xt, arg, hq, passes=1, **kw).numpy()
    assert _rel(control.reshape(B, n), ref) > bar


@pytest.mark.parametrize("n,mtot,B", [
    (63_480, 1031, 1), (63_480, 1031, 10), (5_000, 1031, 1),
    (5_000, 2061, 1), (20_000, 8191, 1), (1500, 33, 3), (700, 63, 2),
    (2_000, 513, 1), (1_000, 1031, 1), (1, 1, 1)])
def test_type2_1d_geometry(n, mtot, B):
    """The float32 d=1 type-2's path: the CUDA cores below
    TYPE2_1D_TC_MIN_MTOT or TYPE2_1D_TC_MIN_WORK (n mtot, for one vector or
    a batch), else the tensor cores with K 32, the 32-column tile for one
    vector (one tile, no padded column) and the 128-column tile for a
    batch; the q padded to whole k-steps of 8 only.  The light curve's
    calls (5 000 and 63 480 points) and the widest lag table take the
    tensor cores.  Each mode |k| <= half is one (q, r) cell of
    the split, every other cell is zero (nothing to crop); the scratch and
    the padding (products a point against the B mtot needed) is x1.24 at
    1031 for one vector (32 x 40 cells) and x1.0 at 8191."""
    geo = type2_1d_geometry(n, mtot, B)
    if (n, mtot) in ((5_000, 1031), (5_000, 2061), (63_480, 1031),
                     (20_000, 8191)):
        assert geo[0] == "tc"
    if (mtot < cuda_nufft.TYPE2_1D_TC_MIN_MTOT
            or n * mtot < cuda_nufft.TYPE2_1D_TC_MIN_WORK[B > 1]):
        assert geo == ("cuda",)
        return
    assert geo == type2_1d_tc_geometry(B)
    _, points, K, cols, stage = geo
    assert (points, K, stage) == (cuda_nufft.TYPE2_2D_POINTS,
                                  cuda_nufft.TYPE2_1D_K,
                                  cuda_nufft.TYPE2_2D_STAGE)
    assert cols == (32 if B == 1 else 128)
    qmin, Q = type1_1d_split(mtot, K)
    kq = -(-Q // 8) * 8
    assert kq - Q < 8
    half = (mtot - 1) // 2
    k = K * (qmin + np.arange(kq))[:, None] + np.arange(K)[None, :]
    live = (np.abs(k) <= half) & (np.arange(kq) < Q)[:, None]
    assert np.array_equal(np.sort(k[live]), np.arange(-half, half + 1))
    ncp = -(-B * K // cols) * cols
    assert type2_1d_scratch_floats(mtot, B, geo) == 4 * kq * ncp
    padding = kq * ncp / (B * mtot)
    if mtot == 1031 and B == 1:
        assert abs(padding - 1280 / 1031) < 1e-12
    if mtot == 8191:
        assert abs(padding - 1.0) < 1e-3


def test_1d_type2_launch_refuses_foreign_path(rng):
    """The d=1 type-2's launch takes ("tc", 4 fields) or ("cuda",) in
    float32, ("tc", 5 fields) or ("cuda",) in float64, and refuses any
    other geometry before it touches the card; in float64, whose
    tensor-core path is the FP64 tensor cores', it refuses the float32
    one."""
    x64 = torch.as_tensor(rng.uniform(0, 1, (64, 1)))
    geo = type2_1d_tc_geometry(1)
    for x in (x64.float(), x64):
        f = torch.ones((1, 1031), dtype=cuda_nufft._complex_of(x.dtype))
        for bad in (geo[:-1], ("split", 16), ("cuda", 1), geo + (1,)):
            with pytest.raises(ValueError, match="no d=1 type-2 path"):
                cuda_nufft._nufft2_1d_on(x, f, 0.3, 1031, False, bad)
    with pytest.raises(ValueError, match="in float64"):
        cuda_nufft._nufft2_1d_on(x64, f, 0.3, 1031, False, geo)
