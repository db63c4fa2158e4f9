"""Port parity for the d=3 NUFFT kernels' plain versions and the d=3 dispatch
(gpquad_torch.ops.cuda_nufft vs gpquad.ops.pallas_nufft).

The plain versions ``nufft{1,2}_3d_ref`` (and the wrappers, which take them
for CPU tensors) are held against ``pallas_nufft{1,2}_3d`` in interpret mode
at the single-block mtot 9 and the slab-tiled mtot 61, at 1e-4 * max|ref| in
float32: the bar of tests/test_pallas_nufft.py::test_pallas_3d_matches_mxu
(two f32 evaluations of sums of up to 61^3 terms, with different sin/cos and
summation order).  Batches are held against PallasNUFFT (one Pallas launch
per vector, ``lax.map``), and float64 against gpquad's phase-matrix backend
at 1e-10.  The float32 tensor-core kernel's twin ``nufft1_3d_3xtf32_ref``
is held to ``pallas_nufft1_3d`` at 5e-5 (both within ~3e-7 of float64 at
these sizes) and, against float64, to max(2x the float32 plain version's
error, 1e-6) of max|ref|, which its plain-TF32 control (``passes=1``) must
miss; the float32 type-2's twin ``nufft2_3d_3xtf32_ref`` likewise against
``pallas_nufft2_3d`` (and its slab-tiled branch past 56 modes).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.ops.nufft import make_nufft as jax_make_nufft
from gpquad.ops.pallas_nufft import pallas_nufft1_3d, pallas_nufft2_3d
from gpquad_torch.ops import cuda_nufft
from gpquad_torch.ops import nufft as tnufft
from gpquad_torch.ops.cuda_nufft import (CudaNUFFT, nufft1_3d,
                                         nufft1_3d_3xtf32_ref, nufft1_3d_ref,
                                         nufft2_3d, nufft2_3d_3xtf32_ref,
                                         nufft2_3d_ref, type1_3d_geometry,
                                         type2_3d_geometry,
                                         type2_3d_scratch_floats,
                                         type2_3d_split)
from gpquad_torch.ops.nufft import CUDA_D3_MAX_MTOT, make_nufft

# The parity problems are small: torch's intra-op threads cost more than
# they give on them, most of all beside other test processes.
torch.set_num_threads(1)


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _inputs(rng, n, mtot, B=None, dtype=np.float32):
    cdtype = np.complex64 if dtype == np.float32 else np.complex128
    lead = () if B is None else (B,)
    x = rng.uniform(-1, 1, (n, 3)).astype(dtype)
    v = (rng.normal(size=lead + (n,))
         + 1j * rng.normal(size=lead + (n,))).astype(cdtype)
    f = (rng.normal(size=lead + (mtot,) * 3)
         + 1j * rng.normal(size=lead + (mtot,) * 3)).astype(cdtype)
    return x, v, f


# mtot 9 takes the TPU's single-block kernels, 61 (> 56) the slab-tiled ones
@pytest.mark.parametrize("mtot,n", [(9, 400), (61, 96)])
@pytest.mark.parametrize("fft_order", [False, True])
def test_plain_versions_match_pallas(rng, mtot, n, fft_order):
    h = 0.11
    x, v, f = _inputs(rng, n, mtot)
    kw = dict(mtot=mtot, fft_order=fft_order)
    want2 = np.asarray(pallas_nufft2_3d(jnp.asarray(x), jnp.asarray(f), h,
                                        **kw))
    want1 = np.asarray(pallas_nufft1_3d(jnp.asarray(x), jnp.asarray(v), h,
                                        **kw))
    xt = torch.as_tensor(x)
    for fn2, fn1 in ((nufft2_3d_ref, nufft1_3d_ref), (nufft2_3d, nufft1_3d)):
        got2 = fn2(xt, torch.as_tensor(f), h, **kw).numpy()
        assert got2.shape == want2.shape == (n,)
        assert _rel(got2, want2) < 1e-4
        got1 = fn1(xt, torch.as_tensor(v), h, **kw).numpy()
        assert got1.shape == want1.shape == (mtot,) * 3
        assert _rel(got1, want1) < 1e-4
    # the flat mode layout gives the same result
    flat = nufft2_3d(xt, torch.as_tensor(f.reshape(-1)), h, **kw).numpy()
    np.testing.assert_array_equal(flat, nufft2_3d(xt, torch.as_tensor(f), h,
                                                  **kw).numpy())


@pytest.mark.parametrize("mtot,n,B,fft_order,flat", [
    (9, 400, 3, False, False),
    (9, 400, 3, True, True),
    (61, 96, 2, True, False),
])
def test_batched_plain_versions_match_pallas(rng, mtot, n, B, fft_order,
                                             flat):
    h = 0.11
    x, V, F = _inputs(rng, n, mtot, B)
    if flat:
        F = F.reshape(B, -1)
    pop = jax_make_nufft(jnp.asarray(x), h, mtot, fft_order=fft_order,
                         method="pallas")
    kw = dict(mtot=mtot, fft_order=fft_order)
    want2 = np.asarray(pop.type2(jnp.asarray(F)))
    got2 = nufft2_3d(torch.as_tensor(x), torch.as_tensor(F), h, **kw).numpy()
    assert got2.shape == want2.shape == (B, n)
    assert _rel(got2, want2) < 1e-4
    want1 = np.asarray(pop.type1(jnp.asarray(V)))
    got1 = nufft1_3d(torch.as_tensor(x), torch.as_tensor(V), h, **kw).numpy()
    assert got1.shape == want1.shape == (B,) + (mtot,) * 3
    assert _rel(got1, want1) < 1e-4


@pytest.mark.parametrize("fft_order", [False, True])
def test_plain_versions_match_mxu_f64(rng, fft_order):
    n, mtot, h, B = 300, 11, 0.07, 2
    x, V, F = _inputs(rng, n, mtot, B, dtype=np.float64)
    jop = jax_make_nufft(jnp.asarray(x), h, mtot, fft_order=fft_order,
                         method="mxu")
    kw = dict(mtot=mtot, fft_order=fft_order)
    got1 = nufft1_3d_ref(torch.as_tensor(x), torch.as_tensor(V), h,
                         **kw).numpy()
    assert _rel(got1, np.asarray(jop.type1(jnp.asarray(V)))) < 1e-10
    got2 = nufft2_3d_ref(torch.as_tensor(x), torch.as_tensor(F), h,
                         **kw).numpy()
    assert _rel(got2, np.asarray(jop.type2(jnp.asarray(F)))) < 1e-10


class _OnCard(torch.Tensor):
    """A CPU tensor that answers ``is_cuda`` with True: make_nufft's CUDA
    branch without a card (the wrappers still see a CPU device and take the
    plain versions)."""
    @property
    def is_cuda(self):
        return True


def test_d3_dispatch(rng):
    """On the CPU d=3 takes the phase matrices.  On the card (CUDA branch
    taken through ``is_cuda``) d=3 with mtot <= 255 takes the kernels and
    wider grids the phase matrices, counted in BACKEND_PICKS."""
    x = torch.as_tensor(rng.uniform(0, 1, (40, 3)))
    before = dict(tnufft.BACKEND_PICKS)
    assert isinstance(make_nufft(x, 0.4, 9), tnufft.NUFFT)
    assert tnufft.BACKEND_PICKS["matmul"] == before["matmul"] + 1
    xc = x.as_subclass(_OnCard)
    for mtot, cls in ((9, CudaNUFFT), (CUDA_D3_MAX_MTOT, CudaNUFFT),
                      (CUDA_D3_MAX_MTOT + 2, tnufft.NUFFT)):
        before = dict(tnufft.BACKEND_PICKS)
        op = make_nufft(xc, 0.4, mtot)
        assert isinstance(op, cls), mtot
        key = "cuda" if cls is CudaNUFFT else "matmul"
        assert tnufft.BACKEND_PICKS[key] == before[key] + 1
    assert make_nufft(xc, 0.4, 9).d == 3
    assert isinstance(make_nufft(xc, 0.4, 9, method="matmul"), tnufft.NUFFT)
    # d=1 takes its kernels at any odd mtot
    for mtot in (9, 8191):
        op = make_nufft(xc[:, :1], 0.4, mtot)
        assert isinstance(op, CudaNUFFT) and op.d == 1, mtot


def test_cuda_backend_3d_on_cpu(rng, monkeypatch):
    """CudaNUFFT at d=3 on CPU tensors: any batch goes through one call of
    the plain version, with PallasNUFFT's shapes (``lead + (m, m, m)`` and
    ``lead + (n,)``), flat or block-shaped modes."""
    n, mtot, h = 150, 7, 0.2
    x, _, _ = _inputs(rng, n, mtot)
    V = (rng.normal(size=(2, 3, n))).astype(np.complex64)
    F = (rng.normal(size=(2, 3) + (mtot,) * 3)).astype(np.complex64)
    calls = []
    for name in ("nufft1_3d_ref", "nufft2_3d_ref"):
        real = getattr(cuda_nufft, name)
        monkeypatch.setattr(
            cuda_nufft, name,
            lambda *a, _real=real, _name=name, **k: (calls.append(_name),
                                                     _real(*a, **k))[1])
    op = CudaNUFFT(x=torch.as_tensor(x), h=h, mtot=mtot)
    pop = jax_make_nufft(jnp.asarray(x), h, mtot, method="pallas")
    before = dict(cuda_nufft.LAUNCHES)
    got1 = op.type1(torch.as_tensor(V)).numpy()
    want1 = np.asarray(pop.type1(jnp.asarray(V)))
    assert calls == ["nufft1_3d_ref"]
    assert got1.shape == want1.shape == (2, 3) + (mtot,) * 3
    assert _rel(got1, want1) < 1e-4
    for fk in (F, F.reshape(2, 3, -1)):
        calls.clear()
        got2 = op.type2(torch.as_tensor(fk)).numpy()
        want2 = np.asarray(pop.type2(jnp.asarray(fk)))
        assert calls == ["nufft2_3d_ref"]
        assert got2.shape == want2.shape == (2, 3, n)
        assert _rel(got2, want2) < 1e-4
    calls.clear()
    assert op.type1(torch.as_tensor(V[0, 0])).shape == (mtot,) * 3
    assert op.type2(torch.as_tensor(F[0, 0])).shape == (n,)
    assert op.type2(torch.as_tensor(F[0, 0].reshape(-1))).shape == (n,)
    assert calls == ["nufft1_3d_ref", "nufft2_3d_ref", "nufft2_3d_ref"]
    assert cuda_nufft.LAUNCHES == before


def test_3d_wrappers_validate_input():
    x = torch.zeros((5, 3))
    c64 = torch.complex64
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        nufft2_3d(torch.zeros((5, 2)), torch.zeros(27, dtype=c64), 0.1,
                  mtot=3)
    with pytest.raises(ValueError, match="mtot <= 255"):
        nufft1_3d(x, torch.zeros(5, dtype=c64), 0.1, mtot=257)
    with pytest.raises(ValueError, match="odd"):
        nufft1_3d(x, torch.zeros(5, dtype=c64), 0.1, mtot=4)
    with pytest.raises(ValueError, match=r"\(3, 3, 3\)"):
        nufft2_3d(x, torch.zeros((2, 9, 3), dtype=c64), 0.1, mtot=3)
    with pytest.raises(ValueError, match="at least one"):
        nufft2_3d(x, torch.zeros((0, 27), dtype=c64), 0.1, mtot=3)
    with pytest.raises(ValueError, match=r"\(B, 5\)"):
        nufft1_3d(x, torch.zeros((2, 4), dtype=c64), 0.1, mtot=3)
    with pytest.raises(ValueError, match="32-bit"):
        nufft2_3d(x, torch.zeros((140, 1), dtype=c64).expand(140, 255 ** 3),
                  0.1, mtot=255)


@pytest.mark.parametrize("n,mtot,B", [(100_000, 61, 1), (100_000, 31, 1),
                                      (100_000, 31, 10), (20_000, 21, 10),
                                      (20_000, 255, 1), (1, 3, 1)])
def test_type1_3d_groups_bound_the_scratch(n, mtot, B):
    """The float32 d=3 type-1's point groups (type1_3d_geometry's chunk):
    every run of points lies in exactly one group, no group is empty, and
    the partial sums stay within a fixed number of blocks' outputs on
    Type1Grid3D's kernel (TYPE1_2D_BLOCKS, or one group where the tiles
    alone pass it) and within TYPE1_3D_WIDE_SCRATCH bytes on the wide
    grids' (or one group, which writes the output itself)."""
    geo = type1_3d_geometry(n, mtot, B)
    groups = cuda_nufft._type1_3d_groups_of(n, geo)
    chunk, run = geo[-1], geo[-2]
    assert chunk % run == 0 and groups == -(-n // chunk)
    assert groups >= 1 and (groups - 1) * chunk < n <= groups * chunk
    scratch = groups * B * mtot ** 3 * 8
    if geo[0] == "tc":
        g, tj, cols = geo[3], 64 // geo[3], geo[2]
        S, _, Q = cuda_nufft.type1_3d_split(mtot, tj)
        tiles = -(-S * mtot // tj) * -(-Q * mtot // cols) * -(-B // g)
        assert groups == 1 or groups * tiles <= cuda_nufft.TYPE1_2D_BLOCKS
    else:
        assert geo[0] == "wide" and mtot > cuda_nufft.TYPE1_3D_TC_MAX_MTOT
        assert groups == 1 or scratch <= cuda_nufft.TYPE1_3D_WIDE_SCRATCH
    # at the d3 configuration's lag table: 17 groups of 6 runs, 31 MB
    if (n, mtot, B) == (100_000, 61, 1):
        assert groups == 17 and scratch < 32e6


# mtot 9 and 21 (hard3d's grid), n 400 (one group at most a few runs); B 3
# runs in pairs, its last pair half empty
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("mtot,fft_order", [(9, False), (21, True)])
def test_3xtf32_twin_matches_pallas(rng, B, mtot, fft_order):
    n, h = 400, 0.11
    x, v, _ = _inputs(rng, n, mtot, B)
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    kw = dict(mtot=mtot, fft_order=fft_order)
    arg = vt[0] if B == 1 else vt
    twin = nufft1_3d_3xtf32_ref(xt, arg, h, **kw).numpy()
    assert twin.shape == ((mtot,) * 3 if B == 1 else (B,) + (mtot,) * 3)
    twin = twin.reshape((B,) + (mtot,) * 3)
    want = np.stack([np.asarray(pallas_nufft1_3d(
        jnp.asarray(x), jnp.asarray(v[b]), h, **kw)) for b in range(B)])
    assert _rel(twin, want) < 5e-5
    ref = nufft1_3d_ref(xt.double(), vt.to(torch.complex128), h,
                        **kw).numpy()
    plain = nufft1_3d_ref(xt, vt, h, **kw).numpy()
    bar = max(2 * _rel(plain, ref), 1e-6)
    assert _rel(twin, ref) <= bar
    control = nufft1_3d_3xtf32_ref(xt, arg, h, passes=1, **kw).numpy()
    assert _rel(control.reshape(twin.shape), ref) > bar


def _grid3d_table(k0, m, TJ, cols):
    """csrc/nufft_3d.cu Type1Grid3D's table for the column tile from k0:
    its entries' phases as (axis, mode value), and each column's two
    entries (col_mode); the rows' entries (row_mode: e^{-2 pi i r u1} at
    index r)."""
    S, qmin, Q = cuda_nufft.type1_3d_split(m, TJ)
    nc = Q * m
    nq = min(k0 + cols - 1, nc - 1) // m - k0 // m + 1
    half = (m - 1) // 2
    entries = ([(1, r) for r in range(S)]
               + [(1, S * (qmin + k0 // m + t)) for t in range(nq)]
               + [(2, (k0 + t) % m - half) for t in range(min(m, cols))])
    col_idx = [(S + c // m - k0 // m, S + nq + (c - k0) % m)
               for c in range(k0, min(k0 + cols, nc))]
    return entries, col_idx


@pytest.mark.parametrize("n,mtot,B", [
    (100_000, 31, 1), (100_000, 61, 1), (100_000, 31, 10), (20_000, 21, 1),
    (20_000, 41, 1), (20_000, 21, 10), (20_000, 57, 1), (20_000, 101, 1),
    (20_000, 255, 1), (400, 9, 3), (1, 3, 1)])
def test_type1_3d_geometry(n, mtot, B):
    """The float32 d=3 type-1's geometry: the tensor cores up to
    TYPE1_3D_TC_MAX_MTOT, else the wide grids' tensor cores
    (type1_3d_wide_geometry; tests/test_torch_nufft3_wide_tc.py).  On
    the tensor cores the first axis's mode splits as k1 = S q + r (S = 64 /
    mtot rows a vector where that is two or more, 32 for a batch in pairs):
    rows (r, j3), columns (q, j2) in tiles of 128 up to mtot 64 (where they
    pass 64 and give a wave of blocks) and 32 past; whole runs of whole register sums a group, no
    group empty, at most TYPE1_2D_BLOCKS blocks (or one group), the
    partials within 256 MB.  Every output (j1, j2, j3) is one (row, column)
    cell, every other cell cropped (|k1| past half); each column's two
    table entries are its e^{-2 pi i S q u1} and e2(j2), and a tile's table
    holds at most kTab = 72 phases a point."""
    geo = type1_3d_geometry(n, mtot, B)
    tc = cuda_nufft.type1_3d_tc_geometry(n, mtot, B)
    assert geo == (tc if mtot <= cuda_nufft.TYPE1_3D_TC_MAX_MTOT
                   else cuda_nufft.type1_3d_wide_geometry(n, mtot, B))
    path, rows, cols, group, stage, run, chunk = tc
    assert path == "tc" and rows == cuda_nufft.TYPE1_2D_ROWS
    assert group == (1 if B == 1 else 2)
    TJ = rows // group
    S, qmin, Q = cuda_nufft.type1_3d_split(mtot, TJ)
    assert S == (TJ // mtot if TJ >= 2 * mtot else 1)
    assert run % stage == 0 and chunk % run == 0
    groups = -(-n // chunk)
    assert (groups - 1) * chunk < n
    tiles = -(-S * mtot // TJ) * -(-Q * mtot // cols) * -(-B // group)
    nrun = -(-n // run)

    def blocks(width):
        t = -(-S * mtot // TJ) * -(-Q * mtot // width) * -(-B // group)
        return t * min(nrun, max(1, cuda_nufft.TYPE1_2D_BLOCKS // t))
    # the narrow tile where the wide one leaves the card short of a wave of
    # blocks and the narrow one gives more
    wide = (mtot <= 64 and Q * mtot > 64
            and not (blocks(128) < cuda_nufft.CARD_SMS
                     and blocks(32) > blocks(128)))
    assert cols == (128 if wide else 32)
    assert tiles * groups == blocks(cols)
    if (n, mtot, B) == (20_000, 21, 1):
        assert cols == 32 and tiles * groups == 120
    assert tiles * groups <= max(tiles, cuda_nufft.TYPE1_2D_BLOCKS)
    assert groups * B * mtot ** 3 * 8 < 256e6
    # every output once, the rest cropped (csrc Type1Grid3D out_index)
    half = (mtot - 1) // 2
    r, j3 = np.divmod(np.arange(S * mtot), mtot)
    q, j2 = np.divmod(np.arange(Q * mtot), mtot)
    k1 = S * (qmin + q)[None, :] + r[:, None]
    keep = np.abs(k1) <= half
    out = ((k1 + half) * mtot + j2[None, :]) * mtot + j3[:, None]
    assert np.array_equal(np.sort(out[keep]), np.arange(mtot ** 3))
    for k0 in range(0, Q * mtot, cols):
        entries, col_idx = _grid3d_table(k0, mtot, TJ, cols)
        assert len(entries) <= 72
        for c, (iq, i2) in zip(range(k0, k0 + cols), col_idx):
            assert entries[iq] == (1, S * (qmin + c // mtot))
            assert entries[i2] == (2, c % mtot - half)
        for i in range(S):
            assert entries[i] == (1, i)


def test_3d_type1_table_bound_at_every_width():
    """Type1Grid3D's table (kTab = 72 entries a point) holds every column
    tile's phases at every odd mtot the kernels take on the tile width the
    geometry picks, for one vector's 64 rows and a pair's 32; 128-column
    tiles would overflow it past mtot 64 (there the geometry takes 32, and
    the launch refuses 128)."""
    over = set()
    for mtot in range(1, cuda_nufft.CUDA_D3_MAX_MTOT + 1, 2):
        for B in (1, 2):
            geo = cuda_nufft.type1_3d_tc_geometry(1000, mtot, B)
            TJ = geo[1] // geo[3]
            for cols in (32, 128):
                Q = cuda_nufft.type1_3d_split(mtot, TJ)[2]
                size = max(len(_grid3d_table(k0, mtot, TJ, cols)[0])
                           for k0 in range(0, Q * mtot, cols))
                if cols == geo[2]:
                    assert size <= 72, (mtot, B)
                elif size > 72:
                    over.add(mtot)
    assert min(over) > 64


def test_3d_type1_launch_refuses_foreign_path(rng):
    """The d=3 type-1's launch takes ("tc", 6 fields) or ("wide", 5
    fields) and refuses any other geometry before it touches the card, the
    CUDA-core kernel's ("cuda",) included (the kernel is gone); float64
    takes its own tensor-core geometry (tests/test_torch_nufft3_f64_tc.py),
    not the float32 one."""
    x = torch.as_tensor(rng.uniform(0, 1, (64, 3)))
    v = torch.ones((1, 64), dtype=torch.complex128)
    geo = type1_3d_geometry(64, 9)
    for bad in (geo[:-1], ("split", 16), ("cuda", 2048), ("cuda",),
                geo + (1,)):
        for xs, vs in ((x.float(), v.to(torch.complex64)), (x, v)):
            with pytest.raises(ValueError, match="no d=3 type-1 path"):
                cuda_nufft._nufft1_3d_on(xs, vs, 0.3, 9, False, bad)
    with pytest.raises(ValueError, match="float64"):
        cuda_nufft._nufft1_3d_on(x, v, 0.3, 9, False, geo)


# mtot 9 and 21 (hard3d's grid) hold one block of 32 modes j3, 57 (past the
# TPU's single-block 56: _pallas_nufft2_3d_tiled) two, the second mostly
# padding; every call's default geometry splits its stages (a few blocks of
# points); B 3 loops gpquad's single-vector kernel over the vectors
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("mtot,fft_order,n", [(9, False, 300), (21, True, 300),
                                              (57, False, 96),
                                              (57, True, 96)])
def test_type2_3d_3xtf32_twin_matches_pallas(rng, B, mtot, fft_order, n):
    h = 0.11
    x, _, f = _inputs(rng, n, mtot, B)
    xt, ft = torch.as_tensor(x), torch.as_tensor(f)
    kw = dict(mtot=mtot, fft_order=fft_order)
    arg = ft[0] if B == 1 else ft
    geo = cuda_nufft.type2_3d_tc_geometry(n, mtot, B)
    assert geo[-1] > 1
    twin = nufft2_3d_3xtf32_ref(xt, arg, h, **kw).numpy()
    assert twin.shape == ((n,) if B == 1 else (B, n))
    twin = twin.reshape(B, n)
    want = np.stack([np.asarray(pallas_nufft2_3d(
        jnp.asarray(x), jnp.asarray(f[b]), h, **kw)) for b in range(B)])
    assert _rel(twin, want) < 5e-5
    ref = nufft2_3d_ref(xt.double(), ft.to(torch.complex128), h,
                        **kw).numpy()
    plain = nufft2_3d_ref(xt, ft, h, **kw).numpy()
    bar = max(2 * _rel(plain, ref), 1e-6)
    assert _rel(twin, ref) <= bar
    # the stages in one run: the same bar, other sums
    whole = nufft2_3d_3xtf32_ref(xt, ft, h, geometry=geo[:-1] + (1,),
                                 **kw).numpy()
    assert _rel(whole, ref) <= bar and not np.array_equal(whole, twin)
    control = nufft2_3d_3xtf32_ref(xt, ft, h, passes=1, **kw).numpy()
    assert _rel(control, ref) > bar


def _grid3d_type2_cells(mtot):
    """csrc/nufft_3d.cu Type2Grid3D's coef(): for each reduction index k
    and column j1 of one vector, the flat index (j1, j2, j3) of f it
    holds, -1 where the cell is zero (j1 or j3 past mtot)."""
    J3, nst = type2_3d_split(mtot)
    k = np.arange(nst * 32)[:, None]
    j1 = np.arange(-(-mtot // 32) * 32)[None, :]
    st = k // 32
    j2, j3 = st % mtot, st // mtot * 32 + k % 32
    flat = (j1 * mtot + j2) * mtot + j3
    return np.where((j1 < mtot) & (j3 < mtot), flat, -1)


@pytest.mark.parametrize("B", [1, 5, 10])
def test_type2_3d_geometry(B):
    """The float32 d=3 type-2's geometry at every odd mtot the kernels take:
    the CUDA cores where the tensor cores' padding of j1 and j3 to 32,
    (mq / mtot)^2, passes 1.8 and the call has 65 536 point-vectors or
    more, else the tensor cores.  On
    the tensor cores: blocks of 128 points, stages of 32 modes k (J3 / 32
    of them a j2), column tiles of 32 or 64 (the wider where both walk the
    fewest columns), each vector's j1 padded to 32 so that no
    epilogue chunk (cols / 4 columns) holds two vectors; splits of whole
    stages, none empty, at most TYPE2_3D_MAX_SPLITS, of the least cost
    (waves of blocks on the card's SMs times stages and overhead a split),
    one at 100 000 points; the split f's cells and the partials'
    within the kernels' 32-bit index range, and the scratch exactly the
    split f and, for two splits or more, the partials."""
    for mtot in range(1, cuda_nufft.CUDA_D3_MAX_MTOT + 1, 2):
        J3, nst = type2_3d_split(mtot)
        assert J3 % 32 == 0 and mtot <= J3 < mtot + 32
        assert nst == mtot * J3 // 32
        mq = -(-mtot // 32) * 32
        for n in (1, 1000, 10_000, 20_000, 100_000):
            geo = type2_3d_geometry(n, mtot, B)
            tc = cuda_nufft.type2_3d_tc_geometry(n, mtot, B)
            cuda = (mq / mtot) ** 2 > 1.8 and n * B >= 65536
            assert geo == (("cuda",) if cuda else tc)
            path, points, cols, stage, splits = tc
            assert (path, points, stage) == ("tc", 128, 32)
            assert mq % (cols // 4) == 0
            walked = {w: -(-B * mq // w) * w for w in (32, 64)}
            assert walked[cols] == min(walked.values())
            assert all(w <= cols for w in walked
                       if walked[w] == walked[cols])
            per = -(-nst // splits)
            assert 1 <= splits <= cuda_nufft.TYPE2_3D_MAX_SPLITS
            assert -(-nst // per) == splits and (splits - 1) * per < nst
            blocks = -(-n // 128)

            def cost(k):
                return -(-blocks * k // cuda_nufft.CARD_SMS) * (
                    -(-nst // k) + cuda_nufft.TYPE2_3D_SPLIT_OVERHEAD)
            assert cost(splits) == min(
                cost(k) for k in range(1, min(nst, 16) + 1))
            if n == 100_000:
                assert splits == 1
            ncp = -(-B * mq // cols) * cols
            assert ncp * nst * 32 < 2 ** 31 and splits * B * n < 2 ** 31
            floats = type2_3d_scratch_floats(n, mtot, B, tc)
            assert floats == 4 * nst * 32 * ncp + (
                2 * splits * B * n if splits > 1 else 0)
    # the driven shapes: d3's mean and B 10, the variance evaluation;
    # hard3d's calls but its probe batches on the tensor cores
    assert cuda_nufft.type2_3d_tc_geometry(10_000, 31, 1)[2] == 32
    assert [type2_3d_geometry(n, 21, B)[0] for n, B in (
        (1000, 1), (20_000, 1), (20_000, 10))] == ["tc", "tc", "cuda"]
    assert type2_3d_geometry(1000, 41, 1)[0] == "tc"
    assert cuda_nufft.type2_3d_tc_geometry(100_000, 31, 10)[2] == 64
    assert cuda_nufft.type2_3d_tc_geometry(10_000, 61, 1)[2] == 64


@pytest.mark.parametrize("mtot", [1, 9, 31, 41, 61])
def test_type2_3d_cells_hold_every_coefficient(mtot):
    """Type2Grid3D's reduction index k = (jb mtot + j2) 32 + j3 % 32 and
    columns j1 hold every coefficient f[j1, j2, j3] once, the other cells
    zero; a run of mtot stages holds one block of 32 modes j3."""
    cells = _grid3d_type2_cells(mtot)
    held = cells[cells >= 0]
    assert np.array_equal(np.sort(held), np.arange(mtot ** 3))
    J3, nst = type2_3d_split(mtot)
    j3 = (cells % mtot).reshape(J3 // 32, mtot * 32, -1)
    for jb in range(J3 // 32):
        used = j3[jb][cells.reshape(J3 // 32, mtot * 32, -1)[jb] >= 0]
        assert used.min() >= jb * 32 and used.max() < (jb + 1) * 32


def test_3d_type2_launch_refuses_foreign_path(rng):
    """The d=3 type-2's launch takes ("tc", 4 fields) or ("cuda",) and
    refuses any other geometry before it touches the card; float64 takes
    its own tensor-core geometry (tests/test_torch_nufft2_3d_f64_tc.py),
    not the float32 one."""
    x = torch.as_tensor(rng.uniform(0, 1, (64, 3)))
    f = torch.ones((1, 729), dtype=torch.complex128)
    geo = type2_3d_geometry(64, 9)
    for bad in (geo[:-1], ("split", 16), ("cuda", 2048), geo + (1,)):
        for xs, fs in ((x.float(), f.to(torch.complex64)), (x, f)):
            with pytest.raises(ValueError, match="no d=3 type-2 path"):
                cuda_nufft._nufft2_3d_on(xs, fs, 0.3, 9, False, bad)
    with pytest.raises(ValueError, match="float64"):
        cuda_nufft._nufft2_3d_on(x, f, 0.3, 9, False, geo)
