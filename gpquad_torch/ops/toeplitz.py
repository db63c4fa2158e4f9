"""FFT-based d-dimensional block-Toeplitz (BTTB) matvec; port of
``gpquad/ops/toeplitz.py``.

The Gram matrix F*F of the equispaced Fourier design is multilevel Toeplitz,
so its matvec is a d-dim circular convolution: pad to an FFT size, multiply
by the cached kernel spectrum, transform back and take the central block.
Leading dimensions of the input are batch.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..utils import profiling

__all__ = ["ToeplitzND", "make_toeplitz", "toeplitz_diag_scale"]


def _span_attrs(op, x: torch.Tensor) -> dict:
    """A ``toeplitz_matvec`` span's attributes: the vectors it applies."""
    return dict(batch=x.numel() // op.size)


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _next_smooth(n: int) -> int:
    """Smallest 2,3,5,7-smooth integer >= n."""
    def is_smooth(k):
        for p in (2, 3, 5, 7):
            while k % p == 0:
                k //= p
        return k == 1
    while not is_smooth(n):
        n += 1
    return n


@dataclasses.dataclass(frozen=True)
class ToeplitzND:
    """Multilevel Toeplitz operator T with precomputed kernel spectrum."""
    fft_kernel: torch.Tensor            # (*fft_shape,) complex
    ns: Tuple[int, ...]
    fft_shape: Tuple[int, ...]

    @property
    def d(self) -> int:
        return len(self.ns)

    @property
    def size(self) -> int:
        out = 1
        for n in self.ns:
            out *= n
        return out

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Apply T to ``x`` with trailing flat (M,) or block ``ns`` layout."""
        with profiling.stage("toeplitz_matvec", _span_attrs, self, x):
            return self._apply(x)

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        d = self.d
        flat = x.shape[-1] == self.size and (
            x.ndim < d or tuple(x.shape[-d:]) != tuple(self.ns))
        if d == 1:
            flat = True
        batch = tuple(x.shape[:-1]) if flat else tuple(x.shape[:-d])
        xb = x.reshape(batch + tuple(self.ns)).to(self.fft_kernel.dtype)
        dims = tuple(range(xb.ndim - d, xb.ndim))
        xf = torch.fft.fftn(xb, s=self.fft_shape, dim=dims)
        y = torch.fft.ifftn(xf * self.fft_kernel, dim=dims)
        # central block: output lag k needs rows n-1 .. 2n-2 of the circular
        # convolution
        sl = (tuple([slice(None)] * (xb.ndim - d))
              + tuple(slice(n - 1, 2 * n - 1) for n in self.ns))
        y = y[sl]
        return y.reshape(batch + (self.size,)) if flat else y


def make_toeplitz(v: torch.Tensor, *, force_pow2: bool = True) -> ToeplitzND:
    """Build the operator from the full lag table ``v`` of shape
    ``(2 n_1 - 1, ..., 2 n_d - 1)``; the FFT size is the next power of two
    or, with ``force_pow2=False``, the next 2,3,5,7-smooth size."""
    if not v.is_complex():
        v = v.to(torch.complex64 if v.dtype == torch.float32
                 else torch.complex128)
    Ls = tuple(v.shape)
    ns = tuple((L + 1) // 2 for L in Ls)
    sizer = _next_pow2 if force_pow2 else _next_smooth
    fft_shape = tuple(sizer(L) for L in Ls)
    dims = tuple(range(-len(Ls), 0))
    fft_kernel = torch.fft.fftn(v, s=fft_shape, dim=dims)
    return ToeplitzND(fft_kernel=fft_kernel, ns=ns, fft_shape=fft_shape)


def toeplitz_diag_scale(v: torch.Tensor):
    """Zero-lag entry of T (the Jacobi scale): N for the EFGP lag table."""
    center = tuple((s - 1) // 2 for s in v.shape)
    return v[center].real
