"""Spread/interpolate (FINUFFT-style) NUFFT for wide mode grids; port of
``gpquad/ops/spread_nufft.py``.

The exact phase-sum backends cost O(N mtot^d).  This module implements the
classical O(N w^d + nf^d log nf) algorithm the reference delegates to
FINUFFT (reference efgpnd.py:1496-1548):

  - the exponential-of-semicircle kernel phi(z) = exp(beta (sqrt(1-z^2) - 1))
    with FINUFFT's parameters (w ~ log10(1/eps) + 1, beta = 2.3 w at
    upsampling sigma = 2);
  - type-1: scatter-add each point's separable w x w stencil onto the 2x
    fine grid, FFT, deconvolve by the kernel's transform, crop to [-m, m]^2;
  - type-2: the exact adjoint (deconvolve, inverse FFT, gather).

The scatter is ``index_add_``, whose CUDA form adds with atomics: the sums
of one fine cell come in a different order from call to call.  The banded
and subproblem backends (``ops/spread_banded.py``) give the same bits on
every call.

One difference from gpquad: the stencil is placed and weighed from the
compensated fine-grid coordinate of ``spread_banded._fine_coords``, where
gpquad's ``_thetas`` rounds the angle ``2 pi frac(x h)`` to one float, whose
float32 rounding reaches every kernel weight on a wide fine grid
(``tests/test_torch_spread.py::test_float32_accuracy_at_a_wide_grid``).
In float64 the two agree to rounding.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import numpy as np
import torch

__all__ = ["spread_params", "spread_nufft1_2d", "spread_nufft2_2d",
           "SpreadNUFFT"]

# numpy < 2.0 names np.trapezoid np.trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz

# Points per scatter pass: bounds the (points, w, w) stencil tables.
_SPREAD_CHUNK = 1 << 17


def spread_params(eps: float) -> Tuple[int, float]:
    """FINUFFT-style kernel width and ES beta for tolerance ``eps`` at
    upsampling sigma = 2."""
    w = max(2, int(math.ceil(math.log10(1.0 / eps))) + 1)
    beta = 2.30 * w
    return w, beta


def _fine_size(mtot: int) -> int:
    nf = 1 << (2 * mtot - 1).bit_length()
    return max(nf, 32)


def _complex_dtype(rdtype):
    return torch.complex64 if rdtype == torch.float32 else torch.complex128


def _es_kernel(z, w: int, beta: float):
    """phi(z) on |z| < w/2 (grid units), zero outside."""
    t = 2.0 * z / w
    inside = torch.abs(t) < 1.0
    t = torch.where(inside, t, 0.0)
    return torch.where(inside, torch.exp(beta * (torch.sqrt(1.0 - t * t)
                                                 - 1.0)), 0.0)


@functools.lru_cache(maxsize=None)
def _deconv_factors(mtot: int, nf: int, w: int, beta: float) -> np.ndarray:
    """c_fac[k] = Delta / psi_hat(k), k = -m..m, by dense quadrature of the
    kernel's transform (float64 on the host, cached per configuration)."""
    m = (mtot - 1) // 2
    # psi(t) supported on |t| <= pi w / nf; psi_hat(k) = int psi e^{i k t}
    half = math.pi * w / nf
    q = 2000
    t = np.linspace(-half, half, q)
    z = t * nf / (2.0 * math.pi) * (2.0 / w)   # in [-1, 1]
    phi = np.exp(beta * (np.sqrt(np.maximum(1.0 - z * z, 0.0)) - 1.0))
    k = np.arange(-m, m + 1)
    psi_hat = _trapezoid(phi[None, :] * np.cos(k[:, None] * t[None, :]),
                         t, axis=1)
    return (2.0 * math.pi / nf) / psi_hat


def _deconv(mtot: int, nf: int, w: int, d: int, rdtype, device):
    """The d-fold outer product of the deconvolution factors, (mtot,)*d."""
    cf = torch.as_tensor(_deconv_factors(mtot, nf, w, 2.30 * w),
                         dtype=rdtype, device=device)
    out = cf
    for _ in range(d - 1):
        out = out[..., None] * cf
    return out


def _crop_index(mtot: int, nf: int, device):
    m = (mtot - 1) // 2
    return torch.remainder(torch.arange(-m, m + 1, device=device), nf)


def _stencil(g, glo, nf: int, w: int, beta: float):
    """Per-point fine-grid cells and kernel values along one axis, from the
    compensated fine coordinate ``g + glo`` (``spread_banded._fine_coords``).

    Returns (cells (N, w) int64 mod nf, weights (N, w))."""
    i0 = torch.ceil(g - 0.5 * w)
    offs = torch.arange(w, device=g.device)
    cells = torch.remainder(i0.long()[:, None] + offs, nf)
    z = (g[:, None] - (i0[:, None] + offs.to(g.dtype))) + glo[:, None]
    return cells, _es_kernel(z, w, beta)


def fine_grid_to_modes(fine, mtot: int, w: int, d: int):
    """FFT the (B,) + (nf,)*d fine grid, crop to [-m, m]^d and deconvolve:
    the type-1 output (B,) + (mtot,)*d."""
    nf = fine.shape[-1]
    dims = tuple(range(-d, 0))
    U = torch.fft.fftn(fine, dim=dims)
    kidx = _crop_index(mtot, nf, fine.device)
    for ax in dims:
        U = torch.index_select(U, ax, kidx)
    rdtype = torch.float32 if fine.dtype == torch.complex64 else torch.float64
    return U * _deconv(mtot, nf, w, d, rdtype, fine.device).to(U.dtype)


def modes_to_fine_grid(f, nf: int, w: int, d: int):
    """The type-2 front: deconvolve the (B,) + (mtot,)*d modes, place them
    on the (nf,)*d grid and inverse-FFT (scaled by nf^d)."""
    mtot = f.shape[-1]
    rdtype = torch.float32 if f.dtype == torch.complex64 else torch.float64
    fd = f * _deconv(mtot, nf, w, d, rdtype, f.device).to(f.dtype)
    kidx = _crop_index(mtot, nf, f.device)
    F = f.new_zeros(f.shape[:-d] + (nf,) * d)
    if d == 2:
        F[:, kidx[:, None], kidx[None, :]] = fd
    else:
        F[:, kidx[:, None, None], kidx[None, :, None], kidx[None, None, :]] = fd
    dims = tuple(range(-d, 0))
    return torch.fft.ifftn(F, dim=dims) * float(nf ** d)


def _batch(vals, n):
    """(n,) or (B, n) -> (B, n), and whether a batch axis was added."""
    single = vals.ndim == 1
    return (vals[None, :] if single else vals.reshape(-1, n)), single


def _stencils_2d(x, h, nf: int, w: int):
    from .spread_banded import _fine_coords
    beta = 2.30 * w
    g, glo = _fine_coords(x, h, nf)
    c0, w0 = _stencil(g[:, 0], glo[:, 0], nf, w, beta)
    c1, w1 = _stencil(g[:, 1], glo[:, 1], nf, w, beta)
    idx = (c0[:, :, None] * nf + c1[:, None, :]).reshape(x.shape[0], -1)
    stw = (w0[:, :, None] * w1[:, None, :]).reshape(x.shape[0], -1)
    return idx, stw


def _h_tensor(h, x):
    """``h`` as a 0-d tensor of ``x``'s dtype on its device."""
    if torch.is_tensor(h):
        return h.to(device=x.device, dtype=x.dtype)
    return torch.full((), float(h), dtype=x.dtype, device=x.device)


def spread_nufft1_2d(x, vals, h, *, mtot: int, w: int = 8):
    """Type-1 (isign=-1): out[k] = sum_n v_n e^{-2 pi i h k.x_n},
    k in [-m, m]^2, by spreading; error ~1e-{w-1}.  ``vals`` is (N,) or
    (B, N); the output (mtot, mtot) or (B, mtot, mtot)."""
    nf = _fine_size(mtot)
    n = x.shape[0]
    cdtype = _complex_dtype(x.dtype)
    v, single = _batch(vals.to(cdtype), n)
    h = _h_tensor(h, x)
    B = v.shape[0]
    fine = torch.zeros((B * nf * nf, 2), dtype=x.dtype, device=x.device)
    base = (torch.arange(B, device=x.device) * (nf * nf))[:, None, None]
    for p0 in range(0, n, _SPREAD_CHUNK):
        sl = slice(p0, min(n, p0 + _SPREAD_CHUNK))
        idx, stw = _stencils_2d(x[sl], h, nf, w)
        contrib = v[:, sl, None] * stw.to(cdtype)            # (B, p, w*w)
        fine.index_add_(0, (base + idx).reshape(-1),
                        torch.view_as_real(contrib).reshape(-1, 2))
    out = fine_grid_to_modes(torch.view_as_complex(fine).reshape(B, nf, nf),
                             mtot, w, 2)
    return out[0] if single else out


def spread_nufft2_2d(x, fk, h, *, mtot: int, w: int = 8):
    """Type-2 (isign=+1): out[n] = sum_k f_k e^{+2 pi i h k.x_n} by
    deconvolution, inverse FFT and gather-interpolation.  ``fk`` is (M,),
    (mtot, mtot), or (B, M) / (B, mtot, mtot); the output (N,) or (B, N)."""
    nf = _fine_size(mtot)
    n = x.shape[0]
    cdtype = _complex_dtype(x.dtype)
    single = fk.ndim == 1 or tuple(fk.shape) == (mtot, mtot)
    f = fk.to(cdtype).reshape(-1, mtot, mtot)
    u = modes_to_fine_grid(f, nf, w, 2).reshape(f.shape[0], nf * nf)
    h = _h_tensor(h, x)
    out = []
    for p0 in range(0, n, _SPREAD_CHUNK):
        sl = slice(p0, min(n, p0 + _SPREAD_CHUNK))
        idx, stw = _stencils_2d(x[sl], h, nf, w)
        g = u[:, idx]                                        # (B, p, w*w)
        out.append(torch.sum(g * stw.to(cdtype), dim=-1))
    out = torch.cat(out, dim=1)
    return out[0] if single else out


def _batched_type1(fn, vals, n, block):
    """Apply ``fn`` ((N,) or (B, N) -> modes) to leading batch dims."""
    lead = tuple(vals.shape[:-1])
    out = fn(vals.reshape(-1, n))
    return out.reshape(lead + block)


def _batched_type2(fn, fk, mtot, d, n):
    """Apply ``fn`` ((B, M) -> (B, N)) to flat or block-shaped modes with
    optional leading batch dims."""
    M = mtot ** d
    shape = tuple(fk.shape)
    if shape in ((M,), (mtot,) * d):
        lead = ()
    elif shape[-1] == M:
        lead = shape[:-1]
    else:
        lead = shape[:-d]
    return fn(fk.reshape(-1, M)).reshape(lead + (n,))


@dataclasses.dataclass(frozen=True)
class SpreadNUFFT:
    """Scatter/gather spread NUFFT with the ``ops/nufft.NUFFT`` interface
    (d=2, symmetric mode ordering; error ~1e-{w-1}).  Needs no cap; its
    CUDA scatter adds with atomics (see the module docstring)."""
    x: torch.Tensor
    h: float
    mtot: int = 0
    w: int = 8

    @property
    def d(self) -> int:
        return 2

    @property
    def n(self) -> int:
        return self.x.shape[0]

    def type1(self, vals: torch.Tensor) -> torch.Tensor:
        return _batched_type1(
            lambda v: spread_nufft1_2d(self.x, v, self.h, mtot=self.mtot,
                                       w=self.w),
            vals, self.n, (self.mtot, self.mtot))

    def type2(self, fk: torch.Tensor) -> torch.Tensor:
        return _batched_type2(
            lambda f: spread_nufft2_2d(self.x, f, self.h, mtot=self.mtot,
                                       w=self.w),
            fk, self.mtot, 2, self.n)
