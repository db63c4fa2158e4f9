"""Hand-written CUDA kernels for SKI's d=2 cubic interpolation, and their
plain versions.

Port of ``gpquad/ops/pallas_interp.py``.  On the band plan of
``models/ski.py`` (points sorted by the base row of their 4x4 stencil, each
band of ``bh`` grid rows padded to ``cap`` slots):

- :func:`interp_T_2d` replaces ``pallas_interp_T_2d`` (pallas_interp.py:104):
  the band slabs of ``W^T u``, (nbands, B, bh+3, G2), whose 3-row halo the
  caller folds into the next band;
- :func:`interp_2d_points` replaces ``pallas_interp_2d`` (:237) with the
  gather around it (gpquad/models/ski.py ``_interp_banded_pallas``):
  ``W v`` from the grid (B, G1, G2) straight to point order (B, n), one
  launch; :func:`interp_2d_points_ref` is its plain twin, in the kernel's
  order;
- :func:`interp_2d` is the same kernel on gpquad's band-slot API: ``W v``
  at the band-sorted slots, (nbands, B, cap), read from per-band slab views
  of the grid.

The kernels (``csrc/interp_2d.cu``) are bound by bytes; the source says how
they stage the work.  ``interp_T_2d`` walks a column-sorted index of each
band's valid slots (:func:`column_index`, made with the host plan): each
slab column reads only the slots whose stencil reaches it and sums every
cell in the index's order, with no atomics, so its result does not change
from run to run; :func:`interp_T_2d_sorted_ref` is its plain twin, in the
same order.  The wrappers take a tensor on the CPU to the plain version
(``*_ref``, the order-free ``index_add_`` one for ``W^T u``); on a CUDA
tensor they launch the kernel or raise.  The kernels are built into the
NUFFT kernels' library (``cuda_nufft.build``: one ``nvcc`` per source, one
link).
"""
from __future__ import annotations

import numpy as np
import torch

from . import cuda_nufft

__all__ = ["interp_T_2d", "interp_2d", "interp_2d_points", "interp_T_2d_ref",
           "interp_2d_ref", "interp_2d_points_ref", "interp_T_2d_sorted_ref",
           "interp_2d_points_trusted", "check_point_tables", "column_index",
           "point_of_slot", "LAUNCHES", "KERNEL_BH"]

# Launches of each kernel since the last reset (one wrapper call on a CUDA
# tensor is one launch; interp_2d and interp_2d_points launch the same
# kernel and count as "interp_2d").
LAUNCHES = {"interp_T_2d": 0, "interp_2d": 0}
# The kernels hold the slab's bh + 3 rows in registers for this band height
# (the plan's, models/ski.py _BANDED_BH); the plain versions take any.
KERNEL_BH = 8


def _check_tables(i0loc, c0, w_row, w_col, dtype, device):
    nbands, cap = i0loc.shape
    if tuple(c0.shape) != (nbands, cap) or \
            tuple(w_row.shape) != (nbands, cap, 4) or \
            tuple(w_col.shape) != (nbands, cap, 4):
        raise ValueError(
            f"tables must be i0loc, c0 ({nbands}, {cap}) and w_row, w_col "
            f"({nbands}, {cap}, 4); got {tuple(c0.shape)}, "
            f"{tuple(w_row.shape)}, {tuple(w_col.shape)}")
    for name, t in (("i0loc", i0loc), ("c0", c0)):
        if t.dtype != torch.int32 or t.device != device:
            raise TypeError(f"{name} must be int32 on {device}, got "
                            f"{t.dtype} on {t.device}")
    for name, t in (("w_row", w_row), ("w_col", w_col)):
        if t.dtype != dtype or t.device != device:
            raise TypeError(f"{name} must be {dtype} on {device}, got "
                            f"{t.dtype} on {t.device}")
    return nbands, cap


def column_index(valid, c0, G2: int):
    """The column-sorted slot index of a band plan (host, numpy).

    ``valid`` (nbands, cap) bool, ``c0`` (nbands, cap) base columns.  The
    listed slots are each band's valid ones whose stencil columns
    ``c0..c0+3`` meet the slab's ``0..G2-1``.  Returns ``col_slots``
    (nbands, cap) int32: the listed slots sorted stably by ``c0`` (slot
    order among equal ``c0``), the rest of the row 0; and ``col_start``
    (nbands, G2+1) int32: ``col_start[:, c]`` the number of listed slots
    with ``c0 < c`` for ``c >= 1``, and 0 at ``c = 0``.  Column ``c`` owns the
    contiguous range ``col_start[max(c-3, 0)] : col_start[c+1]``: the slots
    with ``c0`` in ``[c-3, c]`` (from ``-3`` for ``c < 3``).
    ``col_start[:, G2]`` is each band's count."""
    valid = np.asarray(valid, dtype=bool)
    c0 = np.asarray(c0).astype(np.int64)
    nbands, cap = c0.shape
    listed = valid & (c0 >= -3) & (c0 <= G2 - 1)
    order = np.argsort(np.where(listed, c0, G2), axis=1, kind="stable")
    count = listed.sum(axis=1)
    col_slots = np.where(np.arange(cap)[None, :] < count[:, None], order, 0)
    # hist[band, c0 + 3] of the listed slots; col_start[c] = #(c0 <= c - 1)
    hist = np.zeros((nbands, G2 + 3), np.int64)
    band = np.broadcast_to(np.arange(nbands)[:, None], c0.shape)
    np.add.at(hist, (band[listed], c0[listed] + 3), 1)
    col_start = np.zeros((nbands, G2 + 1), np.int64)
    col_start[:, 1:] = np.cumsum(hist, axis=1)[:, 3:G2 + 3]
    return col_slots.astype(np.int32), col_start.astype(np.int32)


def point_of_slot(valid, pidx, n: int):
    """The point each slot of a band plan writes (host, numpy): ``pidx`` on
    the valid slots, -1 on the padded ones; (nbands, cap) int32, the table
    :func:`interp_2d_points` scatters its sums through.  Raises unless
    every valid slot's point lies in [0, n)."""
    valid = np.asarray(valid, dtype=bool)
    live = np.asarray(pidx)[valid]
    if live.size and (live.min() < 0 or live.max() >= n):
        raise ValueError(f"pidx must lie in [0, {n}) on the valid slots, "
                         f"got [{live.min()}, {live.max()}]")
    return np.where(valid, np.asarray(pidx), -1).astype(np.int32)


def _check_index(col_slots, col_start, nbands, cap, G2, device):
    if tuple(col_slots.shape) != (nbands, cap) or \
            tuple(col_start.shape) != (nbands, G2 + 1):
        raise ValueError(
            f"the column index must be col_slots ({nbands}, {cap}) and "
            f"col_start ({nbands}, {G2 + 1}); got {tuple(col_slots.shape)}, "
            f"{tuple(col_start.shape)}")
    for name, t in (("col_slots", col_slots), ("col_start", col_start)):
        if t.dtype != torch.int32 or t.device != device:
            raise TypeError(f"{name} must be int32 on {device}, got "
                            f"{t.dtype} on {t.device}")


def _check_kernel_call(t, bh):
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the kernels take float32 or float64, got {t.dtype}")
    if bh != KERNEL_BH:
        raise ValueError(f"the CUDA kernels take bh = {KERNEL_BH}, got {bh}")


def _launch(name, t, *args):
    """Call ``gpq_<name>_<f32|f64>`` with ``args`` and ``t``'s current
    stream, on ``t``'s device; raise on a CUDA error, count the launch."""
    prec = "f32" if t.dtype == torch.float32 else "f64"
    fn = getattr(cuda_nufft._library(), f"gpq_{name}_{prec}")
    with torch.cuda.device(t.device):
        rc = fn(*args, torch.cuda.current_stream(t.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} "
                           f"({torch.cuda.get_device_name(t.device)})")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def interp_T_2d_ref(us, i0loc, c0, w_row, w_col, *, G2: int, bh: int):
    """Plain band slabs of ``W^T u``: ``out[band, b, i0+jr, c0+jc] +=
    (w_row[jr] u[b]) w_col[jc]`` over every slot, by ``index_add_`` into a
    (nbands, B, bh+3, G2) buffer; stencil cells outside the slab are left
    out, as the TPU's one-hot selectors leave them."""
    B, nbands, cap = us.shape
    rows = bh + 3
    out = torch.zeros((nbands, B, rows, G2), dtype=us.dtype, device=us.device)
    j = torch.arange(4, device=us.device)
    r = i0loc.long()[..., None] + j                     # (nbands, cap, 4)
    c = c0.long()[..., None] + j
    ok = (((r >= 0) & (r < rows))[..., :, None]
          & ((c >= 0) & (c < G2))[..., None, :])        # (nbands, cap, 4, 4)
    band = torch.arange(nbands, device=us.device)[:, None, None, None]
    bidx = torch.arange(B, device=us.device)[:, None, None, None, None]
    cell = (((band * B + bidx) * rows + r[..., :, None]) * G2
            + c[..., None, :])                          # (B, nb, cap, 4, 4)
    wu = w_row[None] * us[..., None]                    # (B, nb, cap, 4)
    val = wu[..., :, None] * w_col[None, :, :, None, :]
    val = torch.where(ok[None], val, torch.zeros((), dtype=val.dtype,
                                                 device=val.device))
    cell = torch.where(ok[None], cell, torch.zeros((), dtype=cell.dtype,
                                                   device=cell.device))
    out.view(-1).index_add_(0, cell.reshape(-1), val.reshape(-1))
    return out


def interp_T_2d_sorted_ref(us, i0loc, c0, w_row, w_col, col_slots,
                           col_start, *, G2: int, bh: int):
    """Plain twin of the ``interp_T_2d`` kernel: the band slabs of ``W^T u``
    summed in the kernel's order.  Every slab column walks its range of the
    column-sorted index (:func:`column_index`) from the first slot on, and
    each slot adds ``(w_row[jr] u[b]) w_col[jc]`` to the cells of its four
    rows that lie in the slab, in float arithmetic without fused
    multiply-adds, as the kernel does; so on the same inputs the two agree
    bit for bit.  Slots not in the index (the padded ones) add nothing."""
    B, nbands, cap = us.shape
    rows = bh + 3
    dev = us.device
    out = torch.zeros((nbands, B, rows, G2), dtype=us.dtype, device=dev)
    if G2 == 0 or cap == 0:
        return out
    cols = torch.arange(G2, device=dev)
    starts = col_start.long()
    lo = starts[:, (cols - 3).clamp(min=0)]            # (nbands, G2)
    hi = starts[:, cols + 1]
    band = torch.arange(nbands, device=dev)[:, None]
    r = torch.arange(rows, device=dev)[None, :, None]
    slots = col_slots.long()
    i0l, c0l = i0loc.long(), c0.long()
    zero = torch.zeros((), dtype=us.dtype, device=dev)
    for it in range(int((hi - lo).max())):
        pos = lo + it
        slot = slots[band, pos.clamp(max=cap - 1)]        # (nbands, G2)
        jc = cols[None, :] - c0l[band, slot]
        ok = (pos < hi) & (jc >= 0) & (jc < 4)
        jr = r - i0l[band, slot][:, None, :]            # (nbands, rows, G2)
        okr = ok[:, None, :] & (jr >= 0) & (jr < 4)
        wr = w_row[band[:, :, None], slot[:, None, :], jr.clamp(0, 3)]
        wc = w_col[band, slot, jc.clamp(0, 3)]          # (nbands, G2)
        u = us[:, band, slot]                           # (B, nbands, G2)
        val = (wr[None] * u[:, :, None, :]) * wc[None, :, None, :]
        out += torch.where(okr[None], val, zero).transpose(0, 1)
    return out


def interp_2d_ref(vs, i0loc, c0, w_row, w_col, *, bh: int):
    """Plain ``W v`` at the band-sorted slots: ``out[band, b, p] = sum_jc
    w_col[jc] sum_jr w_row[jr] vs[b, band, i0+jr, c0+jc]`` (the TPU kernel's
    order: rows first), cells outside the slab left out.  ``vs`` (B, nbands,
    bh+3, G2) may be any strided view; returns (nbands, B, cap)."""
    B, nbands, rows, G2 = vs.shape
    dev = vs.device
    band = torch.arange(nbands, device=dev)[:, None]
    zero = torch.zeros((), dtype=vs.dtype, device=dev)
    out = torch.zeros((B, nbands, i0loc.shape[1]), dtype=vs.dtype, device=dev)
    for jc in range(4):
        col = c0.long() + jc
        okc = (col >= 0) & (col < G2)
        inner = torch.zeros_like(out)
        for jr in range(4):
            row = i0loc.long() + jr
            ok = okc & (row >= 0) & (row < rows)
            g = vs[:, band, row.clamp(0, rows - 1), col.clamp(0, G2 - 1)]
            inner = inner + w_row[None, :, :, jr] * torch.where(ok, g, zero)
        out = out + inner * torch.where(okc, w_col[:, :, jc], zero)[None]
    return out.transpose(0, 1)


def interp_2d_points_ref(v, i0loc, c0, w_row, w_col, pout, *, G1: int,
                         G2: int, n: int, bh: int):
    """Plain twin of :func:`interp_2d_points`: ``W v`` in point order, the
    kernel's sums in its order.  Each slot of band ``band`` sums
    ``acc = sum_jc (sum_jr w_row[jr] v[b, band*bh + i0 + jr, c0 + jc])
    w_col[jc]``, rows first, each product and sum rounded on its own (no
    fused multiply-add), from zero; a cell outside the slab's bh + 3 rows,
    past the grid's G1 rows or outside its G2 columns reads as zero.  The
    valid slots (``pout >= 0``) write ``out[b, pout[slot]]``.  ``v`` (...,
    G1 * G2) with any strides; returns (..., n)."""
    lead = tuple(v.shape[:-1])
    v = v.reshape(-1, G1, G2)
    B = v.shape[0]
    dev = v.device
    nbands = i0loc.shape[0]
    rows = bh + 3
    band = torch.arange(nbands, device=dev)[:, None]
    zero = torch.zeros((), dtype=v.dtype, device=dev)
    acc = torch.zeros((B,) + tuple(i0loc.shape), dtype=v.dtype, device=dev)
    for jc in range(4):
        col = c0.long() + jc
        okc = (col >= 0) & (col < G2)
        inner = torch.zeros_like(acc)
        for jr in range(4):
            r = i0loc.long() + jr
            grow = band * bh + r
            ok = okc & (r >= 0) & (r < rows) & (grow < G1)
            g = v[:, grow.clamp(0, G1 - 1), col.clamp(0, G2 - 1)]
            inner = inner + w_row[None, :, :, jr] * torch.where(ok, g, zero)
        acc = acc + inner * torch.where(okc, w_col[:, :, jc], zero)[None]
    out = torch.zeros((B, n), dtype=v.dtype, device=dev)
    live = pout >= 0
    out[:, pout[live].long()] = acc[:, live]
    return out.reshape(lead + (n,))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def interp_T_2d(us, i0loc, c0, w_row, w_col, col_slots, col_start, *,
                G2: int, bh: int):
    """Band slabs of ``W^T u`` (replaces ``pallas_interp_T_2d``).

    ``us`` (B, nbands, cap): point values in band-slot order, zero on the
    padded slots; ``i0loc`` (nbands, cap) int32 local base row (anything on
    padded slots); ``c0`` (nbands, cap) int32 base column; ``w_row``,
    ``w_col`` (nbands, cap, 4) in ``us``'s dtype; ``col_slots``,
    ``col_start`` the plan's column-sorted index (:func:`column_index`).
    Returns (nbands, B, bh+3, G2).  A CPU tensor takes the plain version
    (``index_add_``); a CUDA tensor launches the kernel, which reads only
    the indexed slots."""
    if us.ndim != 3 or us.shape[0] < 1:
        raise ValueError(f"us must be (B, nbands, cap) with B >= 1, got "
                         f"{tuple(us.shape)}")
    nbands, cap = _check_tables(i0loc, c0, w_row, w_col, us.dtype, us.device)
    if tuple(us.shape[1:]) != (nbands, cap):
        raise ValueError(f"us must be (B, {nbands}, {cap}), got "
                         f"{tuple(us.shape)}")
    _check_index(col_slots, col_start, nbands, cap, G2, us.device)
    if us.device.type == "cpu":
        return interp_T_2d_ref(us, i0loc, c0, w_row, w_col, G2=G2, bh=bh)
    _check_kernel_call(us, bh)
    B = us.shape[0]
    out = torch.empty((nbands, B, bh + 3, G2), dtype=us.dtype,
                      device=us.device)
    if cap == 0:
        return out.zero_()
    us, i0loc, c0 = us.contiguous(), i0loc.contiguous(), c0.contiguous()
    w_row, w_col = _aligned_weights(w_row, w_col)
    col_slots, col_start = col_slots.contiguous(), col_start.contiguous()
    _launch("interp_T_2d", us, us.data_ptr(), i0loc.data_ptr(),
            c0.data_ptr(), w_row.data_ptr(), w_col.data_ptr(),
            col_slots.data_ptr(), col_start.data_ptr(), B, nbands, cap, G2,
            out.data_ptr())
    return out


def _vector_rows(t, strides, G2):
    """1 when the kernel may stage the grid's rows with 16-byte loads:
    contiguous columns, whole vectors a row, aligned rows."""
    V = 16 // t.element_size()
    return int(strides[-1] == 1 and G2 % V == 0 and t.data_ptr() % 16 == 0
               and all(st % V == 0 for st in strides[:-1]))


def _aligned_weights(w_row, w_col):
    """The weights as the kernels read them: a slot's four as one vector."""
    return (w if w.is_contiguous()
            and w.data_ptr() % (4 * w.element_size()) == 0
            else w.clone(memory_format=torch.contiguous_format)
            for w in (w_row, w_col))


def interp_2d(vs, i0loc, c0, w_row, w_col, *, bh: int):
    """``W v`` at the band-sorted slots (gpquad's ``pallas_interp_2d``
    API).

    ``vs`` (B, nbands, bh+3, G2): per-band slab views of the grid (core rows
    and the 3-row halo of the next band), any strides, e.g. an overlapping
    ``as_strided`` view of the padded grid.  Tables as
    :func:`interp_T_2d`.  Returns (nbands, B, cap); padded slots hold sums
    over the part of their stencil inside the slab (read only the valid
    slots back).  A CPU tensor takes the plain version; a CUDA tensor
    launches the ``interp_2d_points`` kernel in band-slot order."""
    if vs.ndim != 4 or vs.shape[0] < 1 or vs.shape[2] != bh + 3:
        raise ValueError(f"vs must be (B, nbands, {bh + 3}, G2) with B >= 1, "
                         f"got {tuple(vs.shape)}")
    nbands, cap = _check_tables(i0loc, c0, w_row, w_col, vs.dtype, vs.device)
    if vs.shape[1] != nbands:
        raise ValueError(f"vs has {vs.shape[1]} bands, the tables {nbands}")
    if vs.device.type == "cpu":
        return interp_2d_ref(vs, i0loc, c0, w_row, w_col, bh=bh)
    _check_kernel_call(vs, bh)
    B, G2 = vs.shape[0], vs.shape[3]
    out = torch.empty((nbands, B, cap), dtype=vs.dtype, device=vs.device)
    if cap == 0:
        return out
    i0loc, c0 = i0loc.contiguous(), c0.contiguous()
    w_row, w_col = _aligned_weights(w_row, w_col)
    # every row of the view holds data
    _launch("interp_2d", vs, vs.data_ptr(), *vs.stride(), nbands * bh + 3,
            _vector_rows(vs, vs.stride(), G2), i0loc.data_ptr(),
            c0.data_ptr(), w_row.data_ptr(), w_col.data_ptr(), None, B,
            nbands, cap, G2, 0, out.data_ptr())
    return out


def check_point_tables(i0loc, c0, w_row, w_col, pout, *, n: int, G1: int,
                       bh: int):
    """Check a band plan's tables for :func:`interp_2d_points_trusted`,
    which launches on them unchecked: i0loc, c0 and pout (nbands, cap)
    int32 with nbands = ceil(G1 / bh), w_row and w_col (nbands, cap, 4) of
    one float dtype, all on one device and contiguous, the weights on the
    card 16-byte aligned, and every pout in [-1, n) (one host read).
    Raise on a fault; return (nbands, cap)."""
    nbands, cap = _check_tables(i0loc, c0, w_row, w_col, w_row.dtype,
                                w_row.device)
    if tuple(pout.shape) != (nbands, cap) or pout.dtype != torch.int32 \
            or pout.device != w_row.device:
        raise TypeError(f"pout must be int32 ({nbands}, {cap}) on "
                        f"{w_row.device}, got {pout.dtype} "
                        f"{tuple(pout.shape)} on {pout.device}")
    if nbands != -(-G1 // bh):
        raise ValueError(f"a grid of {G1} rows has {-(-G1 // bh)} bands of "
                         f"{bh}, the tables {nbands}")
    for name, t in (("i0loc", i0loc), ("c0", c0), ("w_row", w_row),
                    ("w_col", w_col), ("pout", pout)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("w_row", w_row), ("w_col", w_col)):
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes (the kernel "
                             f"reads a slot's weights as vectors)")
    if pout.numel():
        lo, hi = torch.stack(torch.aminmax(pout)).tolist()
        if lo < -1 or hi >= n:
            raise ValueError(f"pout must lie in [-1, {n}), got "
                             f"[{lo}, {hi}]")
    return nbands, cap


def interp_2d_points(v, i0loc, c0, w_row, w_col, pout, *, G1: int, G2: int,
                     n: int, bh: int):
    """``W v`` from the grid straight to point order (replaces
    ``pallas_interp_2d`` and the ``inv_slot`` gather around it).

    ``v`` (..., G1 * G2), the grid row-major in its last axis, any strides
    (e.g. the real part of a complex grid); tables as :func:`interp_T_2d`
    on ``ceil(G1 / bh)`` bands, and ``pout`` (nbands, cap) int32 the point
    of each valid slot, -1 on padded ones (:func:`point_of_slot`; every
    point 0..n-1 on exactly one valid slot).  Returns (..., n).  The tables
    are laid out and checked on every call (:func:`check_point_tables`),
    then :func:`interp_2d_points_trusted` runs: a CPU tensor takes the plain
    twin :func:`interp_2d_points_ref`; a CUDA tensor launches the kernel
    once (counted as ``interp_2d``), which reads the grid's band slabs in
    place, rows past G1 as zero, and writes each valid slot's point."""
    i0loc, c0, pout = i0loc.contiguous(), c0.contiguous(), pout.contiguous()
    w_row, w_col = _aligned_weights(w_row, w_col)
    check_point_tables(i0loc, c0, w_row, w_col, pout, n=n, G1=G1, bh=bh)
    return interp_2d_points_trusted(v, i0loc, c0, w_row, w_col, pout, G1=G1,
                                    G2=G2, n=n, bh=bh)


def interp_2d_points_trusted(v, i0loc, c0, w_row, w_col, pout, *, G1: int,
                             G2: int, n: int, bh: int):
    """:func:`interp_2d_points` on tables that :func:`check_point_tables`
    passed (``SKIOperator`` checks its plan once, when it is made): checks
    only ``v`` against them, so the kernel's writes through ``pout`` are as
    safe as that check."""
    if v.ndim < 1 or v.shape[-1] != G1 * G2 or v.numel() == 0:
        raise ValueError(f"v must be (..., {G1} * {G2}) with a vector, got "
                         f"{tuple(v.shape)}")
    if v.dtype != w_row.dtype or v.device != w_row.device:
        raise TypeError(f"v must be {w_row.dtype} on {w_row.device} as the "
                        f"tables (w_row), got {v.dtype} on {v.device}")
    if v.device.type == "cpu":
        return interp_2d_points_ref(v, i0loc, c0, w_row, w_col, pout, G1=G1,
                                    G2=G2, n=n, bh=bh)
    _check_kernel_call(v, bh)
    nbands, cap = pout.shape
    out = torch.empty(v.shape[:-1] + (n,), dtype=v.dtype, device=v.device)
    if n == 0:
        return out
    if v.ndim > 2:
        v = v.reshape(-1, G1 * G2)
    B = out.numel() // n
    s_col = v.stride(-1)
    strides = (v.stride(0) if v.ndim == 2 else 0, bh * G2 * s_col, G2 * s_col,
               s_col)
    _launch("interp_2d", v, v.data_ptr(), *strides, G1,
            _vector_rows(v, strides, G2), i0loc.data_ptr(), c0.data_ptr(),
            w_row.data_ptr(), w_col.data_ptr(), pout.data_ptr(), B, nbands,
            cap, G2, n, out.data_ptr())
    return out
