"""The float64 d=1 pair on the FP64 tensor cores (gpquad_torch.ops.
cuda_nufft: ``type1_1d_geometry`` and ``type2_1d_geometry`` at float64,
``type1_1d_f64_split``, ``type2_1d_f64_scratch_doubles`` and the kernels'
plain twins ``nufft1_1d_f64_tc_ref`` and ``nufft2_1d_f64_tc_ref``) against
gpquad's float64 d=1 type-1 and type-2.

The twins form the kernels' operands (the mode split as k = S q + r for the
type-1, rows r and columns q, and k = K q + r for the type-2, the GEMM over
q and the sum over r in the epilogue; each index's phase the product of a
coarse factor a group of 8 and a fine one, the columns q on the coordinate
S u or K u; every phase with the rounding of t = x h carried in) and make
their sums in the kernels' order.  They are held within 1e-12 of max|ref|
of gpquad's float64 ``nufft1`` / ``nufft2`` (gpquad/ops/nufft.py:279,
:284, the MXU path with x64 on the CPU) and of the port's plain versions:
float64 evaluations of the same sums whose phases differ by a rounding or
three (~1e-15 of max|ref| at a few hundred modes).  The kernels themselves
run on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py phase 3).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.ops.nufft import nufft1, nufft2
from gpquad_torch.ops import cuda_nufft
from gpquad_torch.ops.cuda_nufft import (nufft1_1d, nufft1_1d_f64_tc_ref,
                                         nufft1_1d_ref, nufft2_1d,
                                         nufft2_1d_f64_tc_ref, nufft2_1d_ref,
                                         type1_1d_f64_split,
                                         type1_1d_f64_tc_geometry,
                                         type1_1d_geometry, type1_1d_split,
                                         type2_1d_f64_scratch_doubles,
                                         type2_1d_f64_tc_geometry,
                                         type2_1d_geometry)

# The parity problems are small: torch's intra-op threads cost more than
# they give on them, most of all beside other test processes.
torch.set_num_threads(1)

BAR = 1e-12
F64 = torch.float64


def _inputs(seed, n, mtot, B):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 1))
    v = rng.normal(size=(B, n)) + 1j * rng.normal(size=(B, n))
    f = rng.normal(size=(B, mtot)) + 1j * rng.normal(size=(B, mtot))
    return x, v, f


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# mtot 1 (one mode), 15 and 17 (the samplers'), 31, a few hundred (the
# type-2's K 8 and the type-1's S 16: several groups of 8 columns); B 1 and
# 3 (the type-1's batch in pairs, the last one short; the type-2's columns
# split over tiles); both FFT orders; n ragged against the type-1's stages
# of 32 points and the type-2's blocks of 64
@pytest.mark.parametrize("n,mtot,B,h,fft_order", [
    (301, 1, 1, 0.5, False),
    (257, 15, 3, 0.4, True),
    (199, 17, 1, 0.9, False),
    (333, 31, 3, 0.37, True),
    (401, 301, 1, 0.97, False),
    (213, 301, 3, 0.61, True),
    (150, 919, 1, 0.002, False),
])
def test_f64_1d_twins_match_gpquad(n, mtot, B, h, fft_order):
    x, v, f = _inputs(n + mtot, n, mtot, B)
    xt = torch.as_tensor(x)
    vt, ft = torch.as_tensor(v), torch.as_tensor(f)
    kw = dict(mtot=mtot, fft_order=fft_order)
    t1 = nufft1_1d_f64_tc_ref(xt, vt, h, **kw).numpy()
    t2 = nufft2_1d_f64_tc_ref(xt, ft, h, **kw).numpy()
    assert t1.dtype == t2.dtype == np.complex128
    assert t1.shape == (B, mtot) and t2.shape == (B, n)
    w1 = np.asarray(nufft1(jnp.asarray(x), jnp.asarray(v), h, mtot,
                           fft_order=fft_order)).reshape(B, mtot)
    w2 = np.asarray(nufft2(jnp.asarray(x), jnp.asarray(f), h, mtot,
                           fft_order=fft_order)).reshape(B, n)
    assert w1.dtype == w2.dtype == np.complex128
    assert _rel(t1, w1) <= BAR
    assert _rel(t2, w2) <= BAR
    assert _rel(t1, nufft1_1d_ref(xt, vt, h, **kw).numpy()) <= BAR
    assert _rel(t2, nufft2_1d_ref(xt, ft, h, **kw).numpy()) <= BAR
    # one vector: the twins' (mtot,) and (N,) are the batch's first row
    one1 = nufft1_1d_f64_tc_ref(xt, vt[0], h, **kw)
    one2 = nufft2_1d_f64_tc_ref(xt, ft[0], h, **kw)
    assert one1.shape == (mtot,) and one2.shape == (n,)
    if B == 1:
        assert torch.equal(one1, torch.as_tensor(t1[0]))
        assert torch.equal(one2, torch.as_tensor(t2[0]))


def test_f64_1d_twins_carry_the_rounding_of_t():
    """At mtot 8 191 (phase 3's widest d=1 grid) the rounding of t = x h,
    ~1e-16 t, moves a phase by ~k 1e-16 cycles: the twins, which carry it
    in as the kernels do, stand apart from the plain versions (which take
    t as rounded) by more than a rounding of the sums, and stay within
    1e-11 of them."""
    n, mtot, h = 64, 8191, 0.97
    x, v, f = _inputs(5, n, mtot, 1)
    xt = torch.as_tensor(x)
    t1 = nufft1_1d_f64_tc_ref(xt, torch.as_tensor(v[0]), h, mtot=mtot)
    p1 = nufft1_1d_ref(xt, torch.as_tensor(v[0]), h, mtot=mtot)
    t2 = nufft2_1d_f64_tc_ref(xt, torch.as_tensor(f[0]), h, mtot=mtot)
    p2 = nufft2_1d_ref(xt, torch.as_tensor(f[0]), h, mtot=mtot)
    for twin, plain in ((t1, p1), (t2, p2)):
        rel = _rel(twin.numpy(), plain.numpy())
        assert 1e-14 < rel <= 1e-11
    # the splits of the coordinate: S t and K t are exact for powers of two
    hq = float(h)
    for s in (1, 2, 32, 64):
        xs = xt.reshape(-1) * s
        assert torch.equal(xs / s, xt.reshape(-1))
        assert torch.equal(xs * hq, (xt.reshape(-1) * hq) * s)


def test_f64_1d_twins_order_of_sums():
    """The type-1 twin's sums depend on its point groups and split only
    through their rounding, the type-2's on its split and epilogue passes:
    other choices move the result by ~1e-16 of max|ref|, never by more
    than the bar."""
    n, mtot, h = 700, 119, 0.7
    x, v, f = _inputs(3, n, mtot, 3)
    xt, vt, ft = (torch.as_tensor(a) for a in (x, v, f))
    base1 = nufft1_1d_f64_tc_ref(xt, vt, h, mtot=mtot).numpy()
    for kw in (dict(chunk=512), dict(split=4), dict(split=64, chunk=1024)):
        other = nufft1_1d_f64_tc_ref(xt, vt, h, mtot=mtot, **kw).numpy()
        assert _rel(other, base1) <= BAR
    base2 = nufft2_1d_f64_tc_ref(xt, ft, h, mtot=mtot).numpy()
    for geo, chunk in ((("tc", 64, 1, 32, 16, 1), 32),
                       (("tc", 64, 16, 64, 16, 1), 8),
                       (("tc", 64, 32, 32, 16, 3), 32)):
        other = nufft2_1d_f64_tc_ref(xt, ft, h, mtot=mtot, geometry=geo,
                                     chunk=chunk).numpy()
        assert _rel(other, base2) <= BAR


def _outputs_of_split(mtot, S):
    """The outputs k = S q + r (r < S, q from qmin, Q values) that the
    type-1's rows and columns hold, |k| <= half: each mode once."""
    qmin, Q = type1_1d_split(mtot, S)
    half = (mtot - 1) // 2
    k = S * (qmin + np.arange(Q))[None, :] + np.arange(S)[:, None]
    return np.sort(k[np.abs(k) <= half])


# 12f's calls (the light curve's high tier: F*y and the lag table at
# 63 480 points, gradient_high's F*Z at B 10) and 14c's (the samplers'),
# with phase 3's light-curve rows and mtot 8 191
@pytest.mark.parametrize("n,mtot,B,want", [
    (63_480, 919, 1, ("tc", 64, 32, 1, 32, 512, 512)),
    (63_480, 919, 10, ("tc", 64, 32, 2, 32, 512, 2560)),
    (63_480, 1837, 1, ("tc", 64, 32, 1, 64, 512, 512)),
    (120, 17, 1, ("tc", 64, 32, 1, 1, 512, 512)),
    (120, 17, 4000, ("tc", 64, 32, 2, 1, 512, 512)),
    (120, 33, 1, ("tc", 64, 32, 1, 2, 512, 512)),
    (63_480, 1031, 10, ("tc", 64, 64, 2, 32, 512, 2560)),
    (63_480, 2061, 1, ("tc", 64, 64, 1, 64, 512, 512)),
    (20_000, 8191, 1, ("tc", 64, 64, 1, 64, 512, 512)),
])
def test_type1_1d_f64_geometry(n, mtot, B, want):
    """Tiles of 64 rows (one vector's, or a pair's 32 each) by 32 or 64
    values q (32 where 64 pads 1.25x as far); S the power of two whose
    tiles pad least (the smallest of a tie), every mode one output; runs
    of 512 points and the point groups of the fewest waves x runs a block
    on the card's 132 SMs: 124 groups of one run at 63 480 points and one
    tile, 25 of five at B 10 (five pairs); the partials groups x B x mtot
    values, under 64 MB."""
    geo = type1_1d_f64_tc_geometry(n, mtot, B)
    assert geo == want
    _, rows, cols, g, S, run, chunk = geo
    tj = rows // g
    assert S & (S - 1) == 0
    assert np.array_equal(_outputs_of_split(mtot, S),
                          np.arange(-(mtot // 2), mtot // 2 + 1))
    assert type1_1d_f64_split(mtot, tj, cols)[0] == S

    def padded(s):
        return -(-s // tj) * tj * (-(-type1_1d_split(mtot, s)[1] // cols)
                                   * cols)
    assert padded(S) == min(padded(1 << i) for i in range(11))
    assert all(padded(1 << i) > padded(S) for i in range(S.bit_length() - 1))
    groups = -(-n // chunk)
    assert chunk % run == 0 and (groups - 1) * chunk < n
    assert groups * B * mtot * 16 <= 64e6


def test_type1_1d_f64_fills_the_card_through_point_groups():
    """12f's F*y: one output tile (64 x 32 for 919 modes), so the card
    fills through the point groups alone, one a run: 124 blocks, one
    wave of the card's 132 SMs."""
    geo = type1_1d_f64_tc_geometry(63_480, 919, 1)
    tiles = 1
    groups = -(-63_480 // geo[-1])
    assert groups == 124 and tiles * groups <= cuda_nufft.CARD_SMS
    # 14c's 120 points at B 4 000: one group (the output written by the
    # kernel itself), 2 000 pairs of vectors a tile each
    assert type1_1d_f64_tc_geometry(120, 17, 4000)[-1] >= 120


@pytest.mark.parametrize("n,mtot,B,want", [
    (5_000, 919, 1, ("tc", 64, 32, 32, 16, 1)),
    (7, 17, 1, ("tc", 64, 1, 32, 16, 1)),
    (7, 17, 4000, ("tc", 64, 1, 64, 16, 63)),
    (25, 15, 30000, ("tc", 64, 1, 64, 16, 235)),
    (120, 17, 4000, ("tc", 64, 1, 64, 16, 63)),
    (5_000, 2061, 1, ("tc", 64, 32, 32, 16, 1)),
    (63_480, 1031, 10, ("tc", 64, 32, 64, 16, 1)),
    (20_000, 8191, 1, ("tc", 64, 32, 32, 16, 1)),
])
def test_type2_1d_f64_geometry(n, mtot, B, want):
    """Blocks of 64 points, 16 values q a stage; K the least power of two
    up to 32 whose Q values of q fit 6 k-steps (A made once a block): 32
    at 919, 1 at the samplers' 15 and 17 (the columns the vectors); the
    column tiles on the B K columns (32 where 64 pads 1.25x as far), each
    holding whole vectors; the tiles split over grid axis y into as many
    runs as bring the blocks to two an SM on the card's 132, none empty;
    the scratch holds F's both parts of each (q, column) cell."""
    geo = type2_1d_f64_tc_geometry(n, mtot, B)
    assert geo == want
    _, points, K, cols, stage, splits = geo
    Q = type1_1d_split(mtot, K)[1]
    assert K == 32 or Q <= 48
    assert K == 1 or type1_1d_split(mtot, K // 2)[1] > 48
    assert cols % K == 0
    tiles = -(-B * K // cols)
    per = -(-tiles // splits)
    assert -(-tiles // per) == splits and (splits - 1) * per < tiles
    blocks = -(-n // points)
    assert splits == 1 or blocks * (splits - 1) < 2 * cuda_nufft.CARD_SMS
    assert type2_1d_f64_scratch_doubles(mtot, B, geo) == (
        2 * (-(-Q // 8) * 8) * tiles * cols)


# the dispatch at 12f's and 14c's calls: the FP64 tensor cores but for the
# samplers' few points at many vectors (the type-1's one run of points with
# more output tiles than the card's SMs; the type-2's K 1 under 2^19
# point-vectors) and its lone 7 points
@pytest.mark.parametrize("kind,n,mtot,B,path", [
    (1, 63_480, 919, 1, "tc"), (1, 63_480, 919, 10, "tc"),
    (1, 63_480, 1837, 1, "tc"), (1, 120, 17, 1, "tc"),
    (1, 120, 17, 4000, "cuda"), (1, 120, 33, 1, "tc"),
    (1, 512, 17, 300, "cuda"), (1, 513, 17, 300, "tc"),
    (1, 120, 17, 264, "tc"), (1, 120, 17, 266, "cuda"),
    (2, 5_000, 919, 1, "tc"), (2, 7, 17, 1, "cuda"),
    (2, 7, 17, 4000, "cuda"), (2, 25, 15, 30000, "tc"),
    (2, 120, 17, 4000, "cuda"), (2, 100_000, 47, 1, "cuda"),
    (2, 100_000, 49, 1, "tc"), (2, 2 ** 19, 15, 1, "tc"),
])
def test_f64_1d_dispatch(kind, n, mtot, B, path):
    geo = (type1_1d_geometry if kind == 1 else type2_1d_geometry)(
        n, mtot, B, F64)
    assert geo[0] == path
    if path == "cuda":
        assert geo == (("cuda", cuda_nufft.TYPE1_CHUNK) if kind == 1
                       else ("cuda",))
    else:
        assert geo == (type1_1d_f64_tc_geometry if kind == 1
                       else type2_1d_f64_tc_geometry)(n, mtot, B)


def test_f64_1d_wrappers_take_the_plain_version_on_the_cpu():
    """A CPU tensor takes the plain version, bit for bit, in float64."""
    x, v, f = _inputs(11, 90, 33, 2)
    xt, vt, ft = (torch.as_tensor(a) for a in (x, v, f))
    for fo in (False, True):
        assert torch.equal(nufft1_1d(xt, vt, 0.5, mtot=33, fft_order=fo),
                           nufft1_1d_ref(xt, vt, 0.5, mtot=33, fft_order=fo))
        assert torch.equal(nufft2_1d(xt, ft, 0.5, mtot=33, fft_order=fo),
                           nufft2_1d_ref(xt, ft, 0.5, mtot=33, fft_order=fo))


@pytest.mark.parametrize("kind,geo", [
    (1, ("tc", 32, 32, 1, 32, 512, 512)),      # rows not 64
    (1, ("tc", 64, 128, 1, 32, 512, 512)),     # no 128-wide instance
    (1, ("tc", 64, 32, 1, 24, 512, 512)),      # S not a power of two
    (1, ("tc", 64, 32, 1, 2048, 512, 512)),    # S past the largest
    (1, ("tc", 64, 32, 1, 32, 512)),           # short
    (2, ("tc", 128, 32, 32, 16, 1)),           # points not 64
    (2, ("tc", 64, 32, 128, 16, 1)),           # no 128-wide tile
    (2, ("tc", 64, 12, 32, 16, 1)),            # K not a power of two
    (2, ("tc", 64, 64, 32, 16, 1)),            # K wider than the tile
    (2, ("tc", 64, 64, 64, 16, 1)),            # K past the largest
    (2, ("tc", 64, 32, 32, 32, 1)),            # stage not 16
    (2, ("tc", 64, 32, 32, 16)),               # the float32 geometry
])
def test_f64_1d_launch_refuses_a_foreign_geometry(kind, geo):
    """The wrappers' launches refuse a float64 geometry the kernels have no
    instance for before they reach the card (the C launches refuse it as
    well)."""
    x, v, f = _inputs(2, 50, 17, 1)
    xt = torch.as_tensor(x)
    on = cuda_nufft._nufft1_1d_on if kind == 1 else cuda_nufft._nufft2_1d_on
    arg = torch.as_tensor(v if kind == 1 else f)
    with pytest.raises(ValueError, match="d=1 type"):
        on(xt, arg, 0.5, 17, False, geo)


@pytest.mark.parametrize("policy,const,name", [
    ("Type1F64Split1D", "kMaxSplit", "TYPE1_1D_F64_MAX_SPLIT"),
    ("Type2F64Split1D", "kMaxSplit", "TYPE2_1D_F64_MAX_K"),
    ("Type2F64Split1D", "kChunk", "TYPE2_1D_F64_CHUNK"),
])
def test_f64_1d_geometry_constants_match_the_source(policy, const, name):
    """The geometries' limits are the grid policies' own in
    csrc/nufft_1d.cu: the largest split each launch takes, and the type-2's
    chunk of k-steps that its K is picked to fill."""
    src = (Path(cuda_nufft.__file__).parents[1] / "csrc"
           / "nufft_1d.cu").read_text()
    body = src[src.index(f"struct {policy} {{"):]
    body = body[:body.index("\n};")]
    got = re.search(rf"static constexpr int {const} = (\d+);", body)
    assert got is not None and int(got[1]) == getattr(cuda_nufft, name)


# the d=2 and d=3 float64 geometries, unchanged by the d=1 pair's policies
# (the values the float64 d=2 and d=3 kernels ran at before them)
@pytest.mark.parametrize("fn,args,want", [
    ("type1_2d_geometry", (100_000, 29, 1, False, F64), (64, 32, 1, 512, 512)),
    ("type1_2d_geometry", (100_000, 107, 10, True, F64),
     (64, 64, 2, 512, 8192)),
    ("type1_2d_geometry", (1_000_000, 677, 1, False, F64),
     (64, 64, 1, 512, 250368)),
    ("type1_2d_geometry", (24_010, 43, 11, True, F64), (64, 64, 2, 512, 1024)),
    ("type1_3d_geometry", (20_000, 21, 1, F64),
     ("tc", 64, 64, 1, 3, 512, 512)),
    ("type1_3d_geometry", (20_000, 41, 1, F64),
     ("tc", 64, 64, 1, 3, 512, 3072)),
    ("type1_3d_geometry", (100_000, 31, 10, F64),
     ("tc", 64, 64, 2, 1, 512, 12800)),
    ("type1_3d_geometry", (20_000, 255, 1, F64),
     ("tc", 64, 64, 1, 1, 512, 20480)),
    ("type2_3d_geometry", (20_000, 21, 10, F64), ("tc", 64, 64, 16, 2)),
    ("type2_3d_geometry", (20_000, 255, 1, F64), ("tc", 64, 64, 16, 5)),
    ("type2_2d_geometry", (29, F64, 1), ("tc", 64, 32, 16)),
    ("type2_2d_geometry", (17, F64, 11), ("tc", 64, 64, 16)),
    ("type2_2d_single_geometry", (500, 339, F64), ("split", 16, 64)),
    ("type2_2d_single_geometry", (128, 15, F64), ("cuda",)),
])
def test_f64_2d_3d_geometries_unchanged(fn, args, want):
    assert tuple(getattr(cuda_nufft, fn)(*args)) == want
