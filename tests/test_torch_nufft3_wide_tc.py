"""The float32 d=3 type-1 on the wide grids' tensor-core kernel
(gpquad_torch.ops.cuda_nufft: ``type1_3d_wide_geometry``, the float32 pick
of ``type1_3d_geometry`` past ``TYPE1_3D_TC_MAX_MTOT``, and the kernel's
plain twin ``nufft1_3d_wide_ref``) against gpquad.

The twin forms the kernel's operands from its per-tile table (rows the
pairs (j1, j2) of a vector laid end to end, columns j3; each entry a
product of the table's phases, csrc/tc_type1_wide.cuh) and makes its sums
in the kernel's order (k-steps of 8 points in a 3xTF32 split, sums of 256
points, runs of 1024, groups in order).  It is held against gpquad's
``pallas_nufft1_3d`` in interpret mode, which past 56 modes runs the
slab-tiled ``_pallas_nufft1_3d_tiled`` (gpquad/ops/pallas_nufft.py:1118),
as tests/test_pallas_nufft.py runs it, at 5e-5 of max|ref| (both ~2e-6
from float64 here), and against the float64 plain version at max(2x the
float32 plain version's error, 1e-6) of max|ref|, which its plain-TF32
control (``passes=1``) must miss.  The operands are held to the direct
phases at 1e-6, the geometry at the shapes chip_smoke.py phase 3 and 6b
run, and phase 6b's configuration (a d=3 fit whose lag table is past 64
modes) against gpquad's stages at the d=3 pipeline's bars.  The kernel
itself runs on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py
phases 3 and 6b).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.kernels import SquaredExponential as JaxSE
from gpquad.models import efgp as jefgp
from gpquad.models.gradient import gradient_with_grid as jax_gradient_with_grid
from gpquad.ops.pallas_nufft import pallas_nufft1_3d
from gpquad.quadrature import spectral_grid
import gpquad_torch
from gpquad_torch.ops import cuda_nufft
from gpquad_torch.ops.cuda_nufft import (nufft1_3d, nufft1_3d_ref,
                                         nufft1_3d_wide_ref,
                                         type1_3d_geometry,
                                         type1_3d_wide_geometry)
from gpquad_torch.ops.nufft import _phase_matrix

# The parity problems are small: torch's intra-op threads cost more than
# they give on them, most of all beside other test processes.
torch.set_num_threads(1)

SOURCE = (Path(cuda_nufft.__file__).resolve().parent.parent / "csrc"
          / "tc_type1_wide.cuh")


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _inputs(seed, n, B):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    v = (rng.normal(size=(B, n)) + 1j * rng.normal(size=(B, n))).astype(
        np.complex64)
    return x, v


# odd mtot past 64 (one column tile of 128 modes j3, mostly padding), a few
# hundred points (one group, a ragged last k-step; at 65 and B 1 also two
# groups), B 1 and 2, both mode orders
@pytest.mark.parametrize("mtot,B,fft_order,n", [
    (65, 1, False, 300), (65, 2, True, 203), (73, 1, True, 257),
    (73, 2, False, 150)])
def test_wide_twin_matches_pallas(mtot, B, fft_order, n):
    h = 0.11
    x, v = _inputs(mtot + B, n, B)
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    kw = dict(mtot=mtot, fft_order=fft_order)
    arg = vt[0] if B == 1 else vt
    twin = nufft1_3d_wide_ref(xt, arg, h, **kw).numpy()
    assert twin.dtype == np.complex64
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
    control = nufft1_3d_wide_ref(xt, arg, h, passes=1, **kw).numpy()
    assert _rel(control.reshape(twin.shape), ref) > bar
    if (mtot, B) == (65, 1):
        # two point groups of one run each (1 024 points) against one
        # group of both runs, at 1 030 points: the groups added in group
        # order make the one group's sum, bit for bit, within the bar
        x2, v2 = _inputs(7, 1030, B)
        x2t, v2t = torch.as_tensor(x2), torch.as_tensor(v2)
        ref2 = nufft1_3d_ref(x2t.double(), v2t.to(torch.complex128), h,
                             **kw).numpy()
        bar2 = max(2 * _rel(nufft1_3d_ref(x2t, v2t, h, **kw).numpy(), ref2),
                   1e-6)
        arg2 = v2t[0] if B == 1 else v2t
        two, one = (nufft1_3d_wide_ref(x2t, arg2, h, chunk=c, **kw)
                    .numpy().reshape(ref2.shape) for c in (1024, 2048))
        assert np.array_equal(two, one) and _rel(one, ref2) <= bar2


@pytest.mark.parametrize("mtot", [65, 105, 255])
def test_wide_operands_are_the_phases(mtot):
    """Each entry of A (rows (j1, j2) end to end) and E (columns j3) is the
    product of the tile's table factors, within 1e-6 of the direct phases
    v e(t1, j1 - half) e(t2, j2 - half) and e(t3, j3 - half) (the factors'
    roundings); rows across the wrap of j2 past mtot included."""
    x, v = _inputs(mtot, 40, 1)
    xt, V = torch.as_tensor(x), torch.as_tensor(v)
    h = torch.tensor(0.37, dtype=torch.float32)
    m, half = mtot, (mtot - 1) // 2
    i = torch.arange(m * m)
    A = cuda_nufft._type1_3d_wide_rows(xt, V, h, m, i)[0]
    k = torch.arange(m, dtype=torch.float32) - half
    e1, e2, e3 = (_phase_matrix(xt[:, d] * h, k, torch.complex64)
                  for d in range(3))
    want = V[0][:, None] * e1[:, i // m] * e2[:, i % m]
    assert float((A - want).abs().max()) <= 1e-6 * float(V.abs().max())
    E = cuda_nufft._type1_3d_wide_cols(xt, h, m,
                                       cuda_nufft.TYPE1_3D_WIDE_COLS)
    assert float((E - e3).abs().max()) <= 1e-6


def test_wide_row_tiles_reach_three_j1():
    """At every odd mtot from the kernel's least (32) to 255 a tile of 64
    rows (j1, j2) reaches at most TW_N1 = 3 values of j1, and its row r
    has j1 = i0 // mtot + idx, j2 = b2 + r - mtot idx with idx = (b2 + r)
    // mtot, b2 = i0 % mtot: the wrap of j2 is the step of j1 (the
    kernel's table keeps e1 and the wrap's factor a value of idx)."""
    for m in range(33, cuda_nufft.CUDA_D3_MAX_MTOT + 1, 2):
        i = np.arange(m * m)
        i0 = i - i % 64
        r, b2 = i - i0, i0 % m
        idx = (b2 + r) // m
        assert idx.max() < 3, m
        assert np.array_equal(i // m, i0 // m + idx)
        assert np.array_equal(i % m, b2 + r - m * idx)


def test_wide_constants_match_the_source():
    """The Python side's limits are the kernel's: TW_MIN_MTOT (the least
    mtot whose row tiles reach at most TW_N1 = 3 values of j1), the column
    tile TW_COLS (the one instance) and the row tile, TC_ROWS."""
    text = SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (TW_\w+) = (\d+);", text))
    rows = re.search(r"constexpr int TC_ROWS = (\d+);", (
        SOURCE.parent / "tc_type1.cuh").read_text())
    assert int(rows.group(1)) == cuda_nufft.TYPE1_2D_ROWS == 64
    least, n1 = int(consts["TW_MIN_MTOT"]), int(consts["TW_N1"])
    assert least == cuda_nufft.TYPE1_3D_WIDE_MIN_MTOT
    assert int(consts["TW_COLS"]) == cuda_nufft.TYPE1_3D_WIDE_COLS == 128
    # the largest idx = (b2 + r) // mtot at the least mtot, plus one
    assert (least - 1 + 63) // least + 1 == n1 == 3


# chip_smoke.py phase 3's wide shapes (2e4 x 57 / 101 / 255, 1e5 x 61 /
# 105, B 1 and 10) and phase 6b's (n 1e5, mtot 53: F*y and F*Z on Type1Grid3D's
# kernel, the lag table at 105 on this one)
@pytest.mark.parametrize("n,mtot,B", [
    (20_000, 57, 1), (20_000, 101, 1), (20_000, 255, 1), (100_000, 61, 1),
    (100_000, 105, 1), (100_000, 105, 10), (20_000, 101, 10),
    (20_000, 255, 10), (100_000, 53, 1), (100_000, 53, 10), (300, 65, 2)])
def test_type1_3d_wide_geometry(n, mtot, B):
    """The pick (the wide kernel past TYPE1_3D_TC_MAX_MTOT, Type1Grid3D's
    below), and the wide geometry: 64 rows, 128 columns j3, whole runs of
    whole register sums a group, no group empty, the groups that make the fewest waves of
    blocks times runs a block, and their partials within
    TYPE1_3D_WIDE_SCRATCH (one group writes the output itself)."""
    pick = type1_3d_geometry(n, mtot, B)
    assert pick[0] == ("wide" if mtot > cuda_nufft.TYPE1_3D_TC_MAX_MTOT
                       else "tc")
    geo = type1_3d_wide_geometry(n, mtot, B)
    if pick[0] == "wide":
        assert pick == geo
    path, rows, cols, stage, run, chunk = geo
    assert (path, rows, stage, run) == ("wide", 64,
                                        cuda_nufft.TYPE1_2D_STAGE,
                                        cuda_nufft.TYPE1_2D_RUN)
    assert run % stage == 0 and chunk % run == 0
    assert cols == 128
    groups = -(-n // chunk)
    assert (groups - 1) * chunk < n
    tiles = -(-mtot * mtot // 64) * -(-mtot // cols) * B
    scratch = groups * B * mtot ** 3 * 8
    assert groups == 1 or scratch <= cuda_nufft.TYPE1_3D_WIDE_SCRATCH
    nrun = -(-n // run)

    def cost(g):
        per = -(-nrun // g)
        return -(-tiles * -(-nrun // per) // cuda_nufft.CARD_SMS) * per
    allowed = [g for g in range(1, nrun + 1)
               if g == 1 or g * B * mtot ** 3 * 8
               <= cuda_nufft.TYPE1_3D_WIDE_SCRATCH]
    assert cost(groups) == min(cost(g) for g in allowed)
    if (n, mtot, B) == (20_000, 255, 1):
        assert (cols, groups) == (128, 1)
    if (n, mtot, B) == (100_000, 105, 1):
        assert cols == 128 and scratch < 64e6
    assert groups * B * mtot ** 3 < 2 ** 31


def test_wide_geometry_and_launch_refuse_what_they_cannot_run():
    """The wide geometry refuses mtot below TYPE1_3D_WIDE_MIN_MTOT; the
    d=3 type-1's launch takes ("wide", 5 fields) and refuses a field
    missing or added before it touches the card; float64 takes none of
    the float32 paths."""
    with pytest.raises(ValueError, match="mtot >= 32"):
        type1_3d_wide_geometry(1000, 31)
    x = torch.zeros((8, 3))
    v = torch.zeros((1, 8), dtype=torch.complex64)
    geo = type1_3d_wide_geometry(8, 67)
    for bad in (geo[:-1], geo + (1,), ("wide",)):
        with pytest.raises(ValueError, match="no d=3 type-1 path"):
            cuda_nufft._nufft1_3d_on(x, v, 0.3, 67, False, bad)
    with pytest.raises(ValueError, match="float64"):
        cuda_nufft._nufft1_3d_on(x.double(), v.to(torch.complex128), 0.3, 67,
                                 False, geo)


def test_wide_wrapper_takes_plain_version_on_cpu():
    """Past mtot 64 the wrapper on a CPU tensor is the plain version, bit
    for bit, and counts no launch."""
    x, v = _inputs(5, 60, 2)
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    before = dict(cuda_nufft.LAUNCHES)
    for arg in (vt[0], vt):
        assert torch.equal(nufft1_3d(xt, arg, 0.2, mtot=67, fft_order=True),
                           nufft1_3d_ref(xt, arg, 0.2, mtot=67,
                                         fft_order=True))
    assert dict(cuda_nufft.LAUNCHES) == before


def test_wide_lag_table_fit_matches_gpquad():
    """Phase 6b's configuration at a CPU size: a d=3 fit on the kron tier
    whose grid (mtot 33) puts its Toeplitz lag table past 64 modes (65),
    the fused call against gpquad's stages fed the same etas and probes,
    at the d=3 pipeline's bars (tests/test_torch_pipeline.py: mean 1e-9,
    variance 1e-8 * max|var|, gradient 1e-8 relative); both sides pad the
    Toeplitz FFT to a 7-smooth size (fft_smooth), so that the 65^3 lag
    grid's solves stay within seconds on the CPU."""
    rng = np.random.default_rng(17)
    n, nq, sigmasq, tol = 200, 40, 1.0, 1e-9
    x = rng.uniform(0, 1, (n, 3))
    y = (np.sin(3 * np.pi * x[:, 0]) * np.cos(2 * np.pi * x[:, 1])
         * np.cos(np.pi * x[:, 2]) + 0.1 * rng.normal(size=n))
    xq = rng.uniform(0.2, 0.8, (nq, 3))
    jk = JaxSE(lengthscale=0.064, variance=1.0, dimension=3)
    _, h, mtot = spectral_grid(jk, 1e-3, 1.0)
    h, mtot = float(h), int(mtot)
    assert mtot == 33 and 2 * mtot - 1 > cuda_nufft.TYPE1_3D_TC_MAX_MTOT
    M = mtot ** 3
    out = gpquad_torch.fit_predict_grad(
        x, y, xq, gpquad_torch.make_kernel("SE", 3, lengthscale=0.064,
                                           variance=1.0),
        sigmasq, h, torch.Generator().manual_seed(5), mtot=mtot,
        trace_samples=2, var_probes=4, cg_tol=tol, var_cg_tol=tol,
        grad_cg_tol=tol, max_cg_iter=3000, solver="cg", precond="kron",
        fft_smooth=True, device="cpu")
    g = torch.Generator().manual_seed(5)
    etas, Z, V = ((torch.randint(0, 2, shape, generator=g) * 2 - 1).numpy()
                  .astype(np.float64) for shape in ((4, M), (2, n), (2, M)))
    xj, yj, xqj = jnp.asarray(x), jnp.asarray(y), jnp.asarray(xq)
    js = jefgp.fit_with_grid(xj, yj, jk, sigmasq, h, mtot, cg_tol=tol,
                             max_cg_iter=3000, solver="cg", precond="kron",
                             fft_smooth=True)
    jmean = np.asarray(jefgp.predict_mean(js, xqj))
    jvar = np.asarray(jefgp._variance_stochastic(
        js, xqj, None, probes=4, cg_tol=tol, max_cg_iter=3000,
        etas=jnp.asarray(etas)))
    jg = jax_gradient_with_grid(xj, yj, jk, sigmasq, h, jax.random.PRNGKey(0),
                                mtot=mtot, trace_samples=2, cg_tol=tol,
                                max_cg_iter=3000, beta0=js.beta, state=js,
                                probes=(jnp.asarray(Z), jnp.asarray(V)))
    assert out.mean.shape == (nq,) and out.grad.shape == (3,)
    assert np.max(np.abs(out.mean.numpy() - jmean)) < 1e-9
    assert np.max(np.abs(out.var.numpy() - jvar)) < 1e-8 * np.max(
        np.abs(jvar))
    rel = np.abs(out.grad.numpy() - np.asarray(jg.grad)) / np.abs(
        np.asarray(jg.grad))
    assert np.all(rel < 1e-8), rel
