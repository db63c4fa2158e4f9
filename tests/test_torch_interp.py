"""Port parity for SKI's d=2 interpolation kernels: the plain versions of
the CUDA pair ``interp_T_2d`` / ``interp_2d`` (gpquad_torch.ops.cuda_interp)
against the Pallas kernels ``pallas_interp_T_2d`` / ``pallas_interp_2d``,
which run in interpret mode off the TPU (pallas_interp.py:118-119), on the
band tables of gpquad's own plan; the wrappers' dispatch on the CPU.

Tolerance 1e-10 * max|ref| in float64 (the same sums in another order, as
tests/test_ski.py holds the Pallas kernels against the scatter path), and
1e-12 between the two plain versions of ``W^T u`` (``index_add_`` and the
kernel's twin ``interp_T_2d_sorted_ref``, which walks the column-sorted slot
index in the kernel's order).
``W^T u`` is compared on every slab cell, padded slots included (their
tables belong to a point of another band and their u is zero); ``W v`` on
the valid slots only (pallas_interp.py:250-252).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpquad.kernels import SquaredExponential as JaxSE
from gpquad.models.ski import build_ski_operator as jax_build
from gpquad.ops.pallas_interp import pallas_interp_2d, pallas_interp_T_2d
from gpquad_torch.ops import cuda_interp
from gpquad_torch import make_kernel
from gpquad_torch.models import ski as torch_ski
from gpquad_torch.ops.cuda_interp import (column_index, interp_2d,
                                          interp_2d_ref, interp_T_2d,
                                          interp_T_2d_ref,
                                          interp_T_2d_sorted_ref)

torch.set_num_threads(1)

BH = 8


def _rel(got, want):
    return np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want)))


def _plan(rng, n, grid):
    """gpquad's operator for n uniform points on [-1, 1]^2 and its band
    tables as torch tensors."""
    x = rng.uniform(-1, 1, (n, 2))
    kern = JaxSE(lengthscale=0.3, variance=1.0, dimension=2)
    op = jax_build(jnp.asarray(x), kern, grid, ((-1.0, 1.0), (-1.0, 1.0)))
    assert op.banded is not None
    tabs = {k: np.array(getattr(op.banded, k)) for k in op.banded._fields}
    return op, tabs


def _torch_tables(tabs):
    return (torch.as_tensor(tabs["i0loc"]), torch.as_tensor(tabs["c0"]),
            torch.as_tensor(tabs["w_row"]), torch.as_tensor(tabs["w_col"]))


def _torch_index(valid, c0, G2):
    return tuple(torch.as_tensor(a) for a in column_index(valid, c0, G2))


# (48, 33) + 4: G2 37 pads the TPU's column tile, G1 52 folds 7 bands;
# (8, 600) + 4: G2 604 spans two 512-column tiles and cap ~1900 four point
# chunks of 512; B 21 and 40 span two and three batch tiles of 16
@pytest.mark.parametrize("n,grid,B", [(4000, (48, 33), 3),
                                      (3000, (8, 600), 2),
                                      (2500, (40, 40), 21),
                                      (2500, (40, 40), 40)])
def test_plain_versions_match_pallas(rng, n, grid, B):
    op, tabs = _plan(rng, n, grid)
    G1, G2 = op.grid_shape
    nbands, cap = tabs["pidx"].shape
    valid = tabs["valid"]
    u = rng.normal(size=(B, n))
    us = u[:, tabs["pidx"].reshape(-1)].reshape(B, nbands, cap) * valid
    jt = (jnp.asarray(tabs["i0loc"]), jnp.asarray(tabs["c0"]),
          jnp.asarray(tabs["w_row"]), jnp.asarray(tabs["w_col"]))
    tt = _torch_tables(tabs)
    want_T = np.asarray(pallas_interp_T_2d(jnp.asarray(us), *jt, G2=G2,
                                           bh=BH, interpret=True))
    got_T = interp_T_2d_ref(torch.as_tensor(us), *tt, G2=G2, bh=BH).numpy()
    assert got_T.shape == want_T.shape == (nbands, B, BH + 3, G2)
    assert _rel(got_T, want_T) < 1e-10

    v = rng.normal(size=(B, G1, G2))
    vp = np.pad(v, [(0, 0), (0, nbands * BH + 3 - G1), (0, 0)])
    rows = np.arange(nbands)[:, None] * BH + np.arange(BH + 3)[None, :]
    vs = vp[:, rows, :]                               # (B, nbands, 11, G2)
    want = np.asarray(pallas_interp_2d(jnp.asarray(vs), *jt, bh=BH,
                                       interpret=True))
    got = interp_2d_ref(torch.as_tensor(vs), *tt, bh=BH).numpy()
    assert got.shape == want.shape == (nbands, B, cap)
    assert _rel(got[np.broadcast_to(valid[:, None, :], got.shape)],
                want[np.broadcast_to(valid[:, None, :], want.shape)]) < 1e-10


@pytest.mark.parametrize("n,grid,B", [(4000, (48, 33), 3),
                                      (3000, (8, 600), 2),
                                      (2500, (40, 40), 21),
                                      (2500, (40, 40), 40)])
def test_sorted_twin_matches_plain_and_pallas(rng, n, grid, B):
    """The kernel's twin (the column-sorted walk) equals the index_add_
    plain version to 1e-12 and the Pallas kernel to 1e-10 of max|ref| in
    float64, on gpquad's own band tables indexed by column_index."""
    op, tabs = _plan(rng, n, grid)
    G2 = op.grid_shape[1]
    nbands, cap = tabs["pidx"].shape
    u = rng.normal(size=(B, n))
    us = u[:, tabs["pidx"].reshape(-1)].reshape(B, nbands, cap) * tabs["valid"]
    tt = _torch_tables(tabs)
    idx = _torch_index(tabs["valid"], tabs["c0"], G2)
    got = interp_T_2d_sorted_ref(torch.as_tensor(us), *tt, *idx, G2=G2,
                                 bh=BH).numpy()
    plain = interp_T_2d_ref(torch.as_tensor(us), *tt, G2=G2, bh=BH).numpy()
    assert _rel(got, plain) < 1e-12
    want = np.asarray(pallas_interp_T_2d(
        jnp.asarray(us), jnp.asarray(tabs["i0loc"]), jnp.asarray(tabs["c0"]),
        jnp.asarray(tabs["w_row"]), jnp.asarray(tabs["w_col"]), G2=G2,
        bh=BH, interpret=True))
    assert _rel(got, want) < 1e-10


@pytest.mark.parametrize("n,grid", [(4000, (48, 33)), (3000, (8, 600)),
                                    (2500, (40, 40))])
def test_column_index_plan(rng, n, grid):
    """The port's plan carries gpquad's tables unchanged and a column index
    of them: each valid slot lies in exactly the column ranges of
    c0..c0+3 (clipped to the slab), no padded slot in any, and slots of
    equal c0 keep their slot order (a stable sort)."""
    x = rng.uniform(-1, 1, (n, 2))
    kern = JaxSE(lengthscale=0.3, variance=1.0, dimension=2)
    bounds = ((-1.0, 1.0), (-1.0, 1.0))
    op = jax_build(jnp.asarray(x), kern, grid, bounds)
    tabs = {k: np.array(getattr(op.banded, k)) for k in op.banded._fields}
    G2 = op.grid_shape[1]
    plan = torch_ski.build_ski_operator(
        torch.as_tensor(x), make_kernel("SE", 2, lengthscale=0.3,
                                        variance=1.0), grid, bounds).banded
    for field in tabs:
        assert np.array_equal(getattr(plan, field).numpy(), tabs[field]), \
            field
    slots, start = plan.col_slots.numpy(), plan.col_start.numpy()
    valid, c0 = tabs["valid"], tabs["c0"]
    assert start.shape == (valid.shape[0], G2 + 1)
    for b in range(valid.shape[0]):
        count = start[b, G2]
        assert count == valid[b].sum()
        listed = slots[b, :count]
        assert np.array_equal(np.sort(listed), np.flatnonzero(valid[b]))
        keys = c0[b, listed]
        assert np.all(np.diff(keys) >= 0)
        same = np.diff(keys) == 0
        assert np.all(np.diff(listed)[same] > 0)        # stable
        hits = {}
        for c in range(G2):
            for s in listed[start[b, max(c - 3, 0)]:start[b, c + 1]]:
                hits.setdefault(s, set()).add(c)
        for s in np.flatnonzero(valid[b]):
            cols = set(range(max(c0[b, s], 0), min(c0[b, s] + 4, G2)))
            assert hits.get(s, set()) == cols
        assert not set(hits) - set(np.flatnonzero(valid[b]))


def test_strided_slab_view_equals_gathered_copy(rng):
    """The overlapping ``as_strided`` view of the padded grid (what the
    operator passes) gives what the gathered slab copy gives."""
    op, tabs = _plan(rng, 2000, (30, 26))
    G1, G2 = op.grid_shape
    nbands = tabs["pidx"].shape[0]
    v = torch.as_tensor(rng.normal(size=(3, G1, G2)))
    vp = torch.nn.functional.pad(v, (0, 0, 0, nbands * BH + 3 - G1))
    view = vp.as_strided((3, nbands, BH + 3, G2),
                         (vp.stride(0), BH * G2, G2, 1))
    rows = torch.arange(nbands)[:, None] * BH + torch.arange(BH + 3)[None]
    copy = vp[:, rows, :]
    assert torch.equal(view, copy)
    tt = _torch_tables(tabs)
    assert torch.equal(interp_2d(view, *tt, bh=BH), interp_2d(copy, *tt,
                                                                bh=BH))


def test_padded_slots_with_wild_tables(rng):
    """Padded slots whose stencil lies anywhere (negative or past the slab)
    add nothing to W^T u (their u is zero) and stay finite in W v; the
    valid slots are untouched by them."""
    nbands, cap, G2, B = 3, 40, 29, 2
    i0 = rng.integers(0, BH, (nbands, cap)).astype(np.int32)
    c0 = rng.integers(0, G2 - 3, (nbands, cap)).astype(np.int32)
    valid = np.ones((nbands, cap), bool)
    valid[:, 30:] = False
    i0[~valid] = rng.choice([-8, -3, 9, 40], size=(~valid).sum())
    c0[~valid] = rng.choice([-8, -2, G2 - 1, G2 + 7], size=(~valid).sum())
    wr = rng.normal(size=(nbands, cap, 4))
    wc = rng.normal(size=(nbands, cap, 4))
    us = rng.normal(size=(B, nbands, cap)) * valid
    vs = rng.normal(size=(B, nbands, BH + 3, G2))
    jt = (jnp.asarray(i0), jnp.asarray(c0), jnp.asarray(wr), jnp.asarray(wc))
    tt = (torch.as_tensor(i0), torch.as_tensor(c0), torch.as_tensor(wr),
          torch.as_tensor(wc))
    idx = _torch_index(valid, c0, G2)
    want_T = np.asarray(pallas_interp_T_2d(jnp.asarray(us), *jt, G2=G2,
                                           bh=BH, interpret=True))
    got_T = interp_T_2d(torch.as_tensor(us), *tt, *idx, G2=G2,
                        bh=BH).numpy()
    assert _rel(got_T, want_T) < 1e-10
    # dropping the padded slots entirely changes nothing
    ref = interp_T_2d_ref(torch.as_tensor(us)[:, :, :30],
                          *(t[:, :30] for t in tt), G2=G2, bh=BH)
    assert np.max(np.abs(got_T - ref.numpy())) < 1e-12
    # the kernel's twin: the index leaves the padded slots out
    sorted_T = interp_T_2d_sorted_ref(torch.as_tensor(us), *tt, *idx, G2=G2,
                                      bh=BH).numpy()
    assert np.max(np.abs(sorted_T - ref.numpy())) < 1e-12
    assert _rel(sorted_T, want_T) < 1e-10
    want = np.asarray(pallas_interp_2d(jnp.asarray(vs), *jt, bh=BH,
                                       interpret=True))
    got = interp_2d(torch.as_tensor(vs), *tt, bh=BH).numpy()
    assert np.all(np.isfinite(got))
    assert _rel(got[:, :, :30], want[:, :, :30]) < 1e-10


def test_cpu_tensors_take_the_plain_versions(rng, monkeypatch):
    """On CPU tensors the wrappers call the plain versions, once each, and
    count no launch; any band height goes there."""
    calls = []
    for name in ("interp_T_2d_ref", "interp_2d_ref"):
        real = getattr(cuda_interp, name)
        monkeypatch.setattr(
            cuda_interp, name,
            lambda *a, _real=real, _name=name, **k: (calls.append(_name),
                                                     _real(*a, **k))[1])
    before = dict(cuda_interp.LAUNCHES)
    nbands, cap, G2, bh = 2, 16, 12, 5
    tt = (torch.zeros((nbands, cap), dtype=torch.int32),
          torch.zeros((nbands, cap), dtype=torch.int32),
          torch.ones((nbands, cap, 4)), torch.ones((nbands, cap, 4)))
    idx = _torch_index(np.ones((nbands, cap), bool),
                       np.zeros((nbands, cap), np.int32), G2)
    out = cuda_interp.interp_T_2d(torch.ones((1, nbands, cap)), *tt, *idx,
                                  G2=G2, bh=bh)
    assert out.shape == (nbands, 1, bh + 3, G2)
    assert float(out.sum()) == 16.0 * nbands * cap
    pts = cuda_interp.interp_2d(torch.ones((1, nbands, bh + 3, G2)), *tt,
                                bh=bh)
    assert pts.shape == (nbands, 1, cap)
    assert calls == ["interp_T_2d_ref", "interp_2d_ref"]
    assert cuda_interp.LAUNCHES == before


def test_wrappers_validate_inputs():
    nbands, cap, G2 = 2, 16, 12
    i0 = torch.zeros((nbands, cap), dtype=torch.int32)
    w = torch.ones((nbands, cap, 4))
    st = torch.zeros((nbands, G2 + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="B >= 1"):
        interp_T_2d(torch.ones((0, nbands, cap)), i0, i0, w, w, i0, st,
                    G2=G2, bh=BH)
    with pytest.raises(ValueError, match=r"\(B, 2, 16\)"):
        interp_T_2d(torch.ones((1, nbands, cap + 1)), i0, i0, w, w, i0, st,
                    G2=G2, bh=BH)
    with pytest.raises(TypeError, match="int32"):
        interp_T_2d(torch.ones((1, nbands, cap)), i0.long(), i0, w, w, i0,
                    st, G2=G2, bh=BH)
    with pytest.raises(TypeError, match="w_col"):
        interp_T_2d(torch.ones((1, nbands, cap)), i0, i0, w, w.double(), i0,
                    st, G2=G2, bh=BH)
    with pytest.raises(ValueError, match="column index"):
        interp_T_2d(torch.ones((1, nbands, cap)), i0, i0, w, w, i0,
                    st[:, :-1], G2=G2, bh=BH)
    with pytest.raises(TypeError, match="col_slots"):
        interp_T_2d(torch.ones((1, nbands, cap)), i0, i0, w, w, i0.long(),
                    st, G2=G2, bh=BH)
    with pytest.raises(ValueError, match="tables"):
        interp_2d(torch.ones((1, nbands, BH + 3, G2)), i0, i0, w[:, :, :3],
                  w, bh=BH)
    with pytest.raises(ValueError, match="bands"):
        interp_2d(torch.ones((1, nbands + 1, BH + 3, G2)), i0, i0, w, w,
                  bh=BH)
    with pytest.raises(ValueError, match=r"\(B, nbands, 11, G2\)"):
        interp_2d(torch.ones((1, nbands, BH + 2, G2)), i0, i0, w, w, bh=BH)
