"""The numbers that decide ``correct``: gaps between what the program
produced and what the reference worked out, each a float64 host value."""
from __future__ import annotations

import torch


def _f64(t):
    return torch.as_tensor(t).detach().to("cpu", torch.float64).reshape(-1)


def leaf_scale(ref):
    """Each leaf's own size, or the median leaf's where that is larger
    (some leaves are all but zero)."""
    r = _f64(ref).abs()
    return torch.clamp(r, min=float(r.median()))


def gap_of_norms(prog, ref) -> float:
    """Worst leaf of | |prog_i| - |ref_i| | / scale_i, each hyper a scalar
    leaf."""
    p, r = _f64(prog), _f64(ref)
    return float(((p.abs() - r.abs()).abs() / leaf_scale(r)).max())


def leaf_error(prog, ref) -> float:
    """Worst leaf of |prog_i - ref_i| / scale_i."""
    p, r = _f64(prog), _f64(ref)
    return float(((p - r).abs() / leaf_scale(r)).max())


def sign_flips(prog, ref, floor=1e-3) -> int:
    """Leaves whose sign differs, among those over ``floor`` of the median
    leaf in the reference (the rest are nought to rounding)."""
    p, r = _f64(prog), _f64(ref)
    live = r.abs() >= floor * float(r.abs().median())
    return int(((torch.sign(p) != torch.sign(r)) & live).sum())


def relative_max(prog, ref) -> float:
    """max |prog - ref| / max |ref|."""
    p, r = _f64(prog), _f64(ref)
    return float((p - r).abs().max() / r.abs().max())
