"""Nonuniform Fourier design-matrix applies: the phase-matrix backend and the
backend dispatcher.

Port of ``gpquad/ops/nufft.py``.  The EFGP frequency nodes lie on a tensor
grid ``xi = k h``, ``k in [-m, m]^d``, so

    (F* c)[k1..kd] = sum_n c_n prod_t exp(-2 pi i x[n,t] h k_t)
    (F  f)[n]      = sum_k f_k prod_t exp(+2 pi i x[n,t] h k_t)

factor through per-dimension phase matrices ``E_t in C^{N x mtot}`` and each
apply is one (or d) dense matmuls.  This backend is the CPU path, the
reference the CUDA kernels are held against, and the card's path for d=3
grids wider than the d=3 kernels take.

Conventions: ``type1`` isign=-1, ``type2`` isign=+1; modes ordered -m..m,
or 0..m, -m..-1 with ``fft_order=True``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..utils import profiling

__all__ = ["NUFFT", "make_nufft", "make_phase_nufft", "BACKEND_PICKS"]

# How often make_nufft picked each backend since the last reset.
BACKEND_PICKS = {"cuda": 0, "matmul": 0, "spread": 0, "banded": 0, "sub": 0}

# The spreading backends (ops/spread_nufft.py, ops/spread_banded.py) and
# the dimensions each takes
SPREADING = {"spread": (2,), "banded": (2, 3), "sub": (2, 3)}

# Widest d=3 grid the CUDA kernels take: the TPU kernels' _D3_TILED_MAX
# (pallas_nufft.py:966); wider d=3 grids take the phase matrices, as gpquad's
# default backend does.
CUDA_D3_MAX_MTOT = 255

# Points per partial sum of the chunked f32 type-1 (ops/nufft.py:107).
_CHUNK = 2048


def _complex_dtype(rdtype):
    return torch.complex64 if rdtype == torch.float32 else torch.complex128


def _phase_matrix(t, k, cdtype):
    """E[n, j] = exp(-2 pi i t_n k_j) for t = h * x[:, dim].

    The angle is folded onto the torus and the product u * k carries a
    Dekker two-product compensation (k and the 12-bit halves of u multiply
    exactly in f32), so the f32 phase error is the rounding of the reduced
    angle rather than ~|k| 2^-24 cycles.  Same arithmetic as
    gpquad/ops/nufft.py:42-66.
    """
    u = t - torch.round(t)
    p = u[:, None] * k[None, :]
    c = 4097.0                                   # 2^12 + 1
    u_big = u * c
    u_hi = u_big - (u_big - u)
    u_lo = u - u_hi
    err = (u_hi[:, None] * k[None, :] - p) + u_lo[:, None] * k[None, :]
    cycles = p - torch.round(p)
    cycles = cycles + err
    cycles = cycles - torch.round(cycles)        # keep |angle| <= pi
    ang = (-2.0 * math.pi) * cycles
    return torch.complex(torch.cos(ang), torch.sin(ang)).to(cdtype)


def _k_values(mtot: int, fft_order: bool, dtype, device):
    m = (mtot - 1) // 2
    if fft_order:
        k = torch.cat([torch.arange(0, m + 1), torch.arange(-m, 0)])
    else:
        k = torch.arange(-m, m + 1)
    return k.to(dtype=dtype, device=device)


def span_attrs(kind: int, op, vals: torch.Tensor, dtype) -> dict:
    """The attributes of a ``nufft_type1`` / ``nufft_type2`` span on an
    operator with ``d``, ``n`` and ``mtot``: the call's type, shape, number
    of vectors B and precision (``dtype``'s real type)."""
    per = op.n if kind == 1 else op.mtot ** op.d
    return dict(kind=kind, d=op.d, n=op.n, mtot=op.mtot,
                B=vals.numel() // per,
                precision=str(dtype.to_real()).removeprefix("torch."))


@dataclasses.dataclass(frozen=True)
class NUFFT:
    """Precomputed per-dimension phase matrices for a fixed point set."""
    phases: Tuple[torch.Tensor, ...]   # d tensors of shape (N, mtot)
    mtot: int

    @property
    def d(self) -> int:
        return len(self.phases)

    @property
    def n(self) -> int:
        return self.phases[0].shape[0]

    def type1(self, vals: torch.Tensor) -> torch.Tensor:
        """Adjoint apply F*: (N,) or (B, N) -> (mtot,)*d or (B,)+(mtot,)*d."""
        with profiling.stage("nufft_type1", span_attrs, 1, self, vals,
                             self.phases[0].dtype):
            if vals.ndim == 1:
                return self._type1_single(vals)
            return torch.stack([self._type1_single(v) for v in vals])

    def _type1_single(self, vals):
        cdtype = self.phases[0].dtype
        v = vals.to(cdtype)
        n = v.shape[0]
        m = self.mtot
        # two-stage chunked accumulation in f32 (gpquad/ops/nufft.py:102-109):
        # ~2k-point partials, then a sum of the partials
        chunked = cdtype == torch.complex64 and n >= 4 * _CHUNK
        n_head = (n // _CHUNK) * _CHUNK if chunked else 0
        if self.d == 1:
            (e1,) = self.phases
            if chunked:
                part = torch.einsum("cn,cnj->cj", v[:n_head].reshape(-1, _CHUNK),
                                    e1[:n_head].reshape(-1, _CHUNK, m))
                out = part.sum(0)
                if n_head < n:
                    out = out + v[n_head:] @ e1[n_head:]
                return out
            return v @ e1
        if self.d == 2:
            e1, e2 = self.phases
            if chunked:
                w = (e1[:n_head] * v[:n_head, None]).reshape(-1, _CHUNK, m)
                part = torch.bmm(w.transpose(1, 2),
                                 e2[:n_head].reshape(-1, _CHUNK, m))
                out = part.sum(0)
                if n_head < n:
                    out = out + (e1[n_head:] * v[n_head:, None]).T @ e2[n_head:]
                return out
            return (e1 * v[:, None]).T @ e2
        if self.d == 3:
            e1, e2, e3 = self.phases
            # contract n in j1-slabs to bound memory at O(N * mtot)
            return torch.stack([(e2 * (e1[:, j] * v)[:, None]).T @ e3
                                for j in range(m)])
        raise NotImplementedError("NUFFT supports d <= 3")

    def type2(self, fk: torch.Tensor) -> torch.Tensor:
        """Forward apply F: flat (M,) or block (mtot,)*d, optionally with
        leading batch dims -> (N,) or (B, N)."""
        with profiling.stage("nufft_type2", span_attrs, 2, self, fk,
                             self.phases[0].dtype):
            return self._type2(fk)

    def _type2(self, fk):
        block = (self.mtot,) * self.d
        M = self.mtot ** self.d
        if tuple(fk.shape) == (M,):
            return self._type2_single(fk.reshape(block))
        if tuple(fk.shape) == block:
            return self._type2_single(fk)
        lead = fk.shape[:-1] if fk.shape[-1] == M else fk.shape[:-self.d]
        flat = fk.reshape((-1,) + block)
        out = torch.stack([self._type2_single(f) for f in flat])
        return out.reshape(tuple(lead) + (self.n,))

    def _type2_single(self, fk):
        cdtype = self.phases[0].dtype
        f = fk.to(cdtype)
        if self.d == 1:
            (e1,) = self.phases
            return e1.conj() @ f
        if self.d == 2:
            e1, e2 = self.phases
            tmp = f @ e2.conj().T                               # (m, N)
            return (e1.conj() * tmp.T).sum(1)
        if self.d == 3:
            e1, e2, e3 = self.phases
            per_j1 = torch.stack([(e2.conj() * (fj @ e3.conj().T).T).sum(1)
                                  for fj in f])                 # (m, N)
            return (e1.conj() * per_j1.T).sum(1)
        raise NotImplementedError("NUFFT supports d <= 3")


def make_phase_nufft(x: torch.Tensor, h, mtot: int, *,
                     fft_order: bool = False) -> NUFFT:
    """Phase-matrix operator for points ``x`` (N, d) on grid spacing ``h``."""
    if x.ndim == 1:
        x = x[:, None]
    if mtot % 2 != 1:
        raise ValueError(f"mtot must be odd (symmetric grid -m..m), got {mtot}")
    n, d = x.shape
    rdtype = x.dtype
    k = _k_values(mtot, fft_order, rdtype, x.device)
    t = x * torch.as_tensor(h, dtype=rdtype, device=x.device)
    phases = tuple(_phase_matrix(t[:, i], k, _complex_dtype(rdtype))
                   for i in range(d))
    return NUFFT(phases=phases, mtot=mtot)


def make_nufft(x: torch.Tensor, h, mtot: int, *, xcen=None,
               fft_order: bool = False, method: str = "auto",
               cap: Optional[int] = None):
    """Build the NUFFT operator for points ``x`` (N, d).

    ``method="auto"`` launches the hand-written kernels
    (``ops/cuda_nufft.py``) for points on a CUDA device with d=1 or d=2 (any
    odd mtot), or d=3 and ``mtot <= CUDA_D3_MAX_MTOT``, and uses the
    phase-matrix backend otherwise: on the CPU and for wider d=3 grids.
    ``method="matmul"`` always takes the phase-matrix backend.  The
    spreading backends take symmetric mode ordering only:
    ``method="spread"`` (d=2) the scatter/gather ES-kernel spread,
    ``method="banded"`` (d=2 or 3) the banded spread with a band ``cap``
    (planned on the host from ``x`` when None), ``method="sub"`` (d=2 or 3)
    the subproblem-scheduled banded spread, whose planning needs no data.
    ``xcen`` ((d,), optional) shifts the points, ``x - xcen``, before any
    backend sees them.  The pick is counted in :data:`BACKEND_PICKS`.
    """
    if x.ndim == 1:
        x = x[:, None]
    if mtot % 2 != 1:
        raise ValueError(f"mtot must be odd (symmetric grid -m..m), got {mtot}")
    if method not in ("auto", "matmul") + tuple(SPREADING):
        raise ValueError(f"Unknown NUFFT method '{method}' "
                         "(auto | matmul | spread | banded | sub)")
    if xcen is not None:
        x = x - torch.as_tensor(xcen, dtype=x.dtype, device=x.device)[None, :]
    d = x.shape[1]
    if method in SPREADING:
        return _make_spreading(x, h, mtot, method, fft_order, cap)
    if method == "auto" and x.is_cuda and (
            d in (1, 2) or (d == 3 and mtot <= CUDA_D3_MAX_MTOT)):
        from .cuda_nufft import CudaNUFFT
        BACKEND_PICKS["cuda"] += 1
        # h in x's precision, read to the host once here so that no launch
        # waits on the device for it
        h = float(torch.as_tensor(h, dtype=x.dtype))
        return CudaNUFFT(x=x, h=h, mtot=mtot, fft_order=fft_order)
    BACKEND_PICKS["matmul"] += 1
    return make_phase_nufft(x, h, mtot, fft_order=fft_order)


def _make_spreading(x, h, mtot: int, method: str, fft_order: bool, cap):
    """The spreading backend ``method`` with gpquad's limits
    (gpquad/ops/nufft.py:229-261)."""
    d = x.shape[1]
    dims = SPREADING[method]
    if d not in dims or fft_order:
        raise NotImplementedError(
            f"{method} NUFFT supports d in {set(dims)} with symmetric mode "
            "ordering")
    from . import spread_banded as sb
    from .spread_nufft import SpreadNUFFT
    h = float(torch.as_tensor(h, dtype=x.dtype))
    BACKEND_PICKS[method] += 1
    if method == "spread":
        return SpreadNUFFT(x=x, h=h, mtot=mtot)
    if method == "sub":
        cls = sb.SubNUFFT if d == 2 else sb.SubNUFFT3D
        return cls(x=x, h=h, mtot=mtot)
    if cap is None:
        plan = sb.banded_plan_cap if d == 2 else sb.banded_plan_cap_3d
        cap = plan(x, h, mtot)
    cls = sb.BandedNUFFT if d == 2 else sb.BandedNUFFT3D
    return cls(x=x, h=h, mtot=mtot, cap=cap)
