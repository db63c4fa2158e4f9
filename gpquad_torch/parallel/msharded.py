"""M-sharded Toeplitz matvec: a pencil-decomposed distributed FFT; port of
``gpquad/parallel/msharded.py``.

The data-parallel layout (``sharding.py``) replicates the frequency state:
every rank holds the whole padded FFT grid of the Gram matvec.  Here the
padded grid itself is split over a mesh axis of k ranks with one transpose
pair a matvec (``torch.distributed.all_to_all_single`` on contiguous
``(k, ...)`` blocks):

    d=2: input slab (B, P1/k, P2) -> FFT axis 2 -> transpose -> (B, P1, P2/k)
         -> FFT axis 1, times the spectrum slab (P1, P2/k), iFFT axis 1
         -> transpose back -> (B, P1/k, P2) -> iFFT axis 2
    d=3: input slab (B, P1, P2, P3/k) -> FFT axes 1, 2 -> transpose ->
         (B, P1, P2/k, P3) -> FFT axis 3, times the spectrum slab
         (P1, P2/k, P3), iFFT axis 3 -> transpose back -> iFFT axes 2, 1

Each rank pads only its slab of the input, and keeps only its slab of the
kernel spectrum, so the frequency memory a rank holds is 1/k of the grid.
The CG vectors stay replicated, as in gpquad: after the inverse transform
an ``all_gather`` of the central block gives every rank the whole result,
the same bits on every rank, so every rank takes the same CG steps.

``msharded_fit``, ``msharded_gradient`` and ``msharded_fit_high`` run the
port's ``fit_with_grid``, ``gradient_with_grid`` and ``fit_high`` inside
``ops.collectives.sharded`` with the points split over the same axis and
every Gram apply of their solves on this pencil.  gpquad's
``make_msharded_toeplitz_df_apply`` is the double-word (float32 pair)
form of the apply, which the TPU needs for float64 accuracy; the card has
float64, so the port's high tier runs the complex128 pencil and that
function is not re-created (as ``gpquad/ops/df64.py`` is not).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.efgp import (FitState, _as_points, _variance_regular,
                           fit_with_grid)
from ..models.gradient import _rademacher_rows, gradient_with_grid
from ..models.precision import HighState, fit_high
from ..ops import collectives
from ..ops.operators import make_A_mean
from ..ops.toeplitz import ToeplitzND
from .sharding import (_axis, _probe_block, mesh_device, point_sharding,
                       replicate, shard_points)

__all__ = ["msharded_toeplitz_matvec", "shard_toeplitz_kernel",
           "make_msharded_A_mean", "make_msharded_toeplitz_apply",
           "msharded_fit", "msharded_gradient", "msharded_predict_var",
           "msharded_fit_high"]


def _transpose(a: torch.Tensor, split: int, concat: int, group,
               k: int) -> torch.Tensor:
    """All-to-all over ``group``: dim ``split`` of ``a`` cut into k blocks,
    block j sent to rank j; the blocks received concatenated in rank order
    along dim ``concat`` (where each rank holds its slab)."""
    import torch.distributed as dist
    send = a.unflatten(split, (k, a.shape[split] // k)).movedim(
        split, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(torch.view_as_real(recv), torch.view_as_real(send),
                           group=group)
    return recv.movedim(0, concat).flatten(concat, concat + 1)


def _pencil_conv2d(xp, kf, group, k):
    """Circular 2-D convolution of the padded slab ``xp`` (B, P1/k, P2)
    with the spectrum slab ``kf`` (P1, P2/k); the result's slab (B, P1/k,
    P2)."""
    a = torch.fft.fft(xp, dim=2)
    a = _transpose(a, 2, 1, group, k)                  # (B, P1, P2/k)
    a = torch.fft.ifft(torch.fft.fft(a, dim=1) * kf, dim=1)
    a = _transpose(a, 1, 2, group, k)                  # (B, P1/k, P2)
    return torch.fft.ifft(a, dim=2)


def _pencil_conv3d(xp, kf, group, k):
    """Circular 3-D convolution of the padded slab ``xp`` (B, P1, P2,
    P3/k) with the spectrum slab ``kf`` (P1, P2/k, P3), the layout that the
    forward transpose lands on; the result's slab (B, P1, P2, P3/k)."""
    a = torch.fft.fft(torch.fft.fft(xp, dim=1), dim=2)
    a = _transpose(a, 2, 3, group, k)                  # (B, P1, P2/k, P3)
    a = torch.fft.ifft(torch.fft.fft(a, dim=3) * kf, dim=3)
    a = _transpose(a, 3, 2, group, k)                  # (B, P1, P2, P3/k)
    return torch.fft.ifft(torch.fft.ifft(a, dim=2), dim=1)


def _check(toeplitz: ToeplitzND, k: int, axis: str):
    d = toeplitz.d
    if d not in (2, 3):
        raise NotImplementedError(
            "pencil-sharded matvec is implemented for d in {2, 3}; other "
            "dims run the replicated ToeplitzND path")
    # the axes the transposes split: d=2 P1 and P2, d=3 P2 and P3
    fshape = toeplitz.fft_shape
    if any(s % k for s in (fshape if d == 2 else fshape[1:])):
        raise ValueError(
            f"fft_shape {fshape} not divisible by mesh axis '{axis}' of "
            f"size {k}")


def shard_toeplitz_kernel(toeplitz: ToeplitzND, mesh,
                          axis: str = "dp") -> torch.Tensor:
    """This rank's slab of the cached kernel spectrum: columns (P1, P2/k)
    at d=2, middle-axis slabs (P1, P2/k, P3) at d=3 (the layout the
    forward transpose lands on)."""
    k, r = _axis(mesh, axis)
    _check(toeplitz, k, axis)
    w = toeplitz.fft_shape[1] // k
    return toeplitz.fft_kernel[:, r * w:(r + 1) * w].contiguous()


def make_msharded_toeplitz_apply(toeplitz: ToeplitzND, mesh,
                                 axis: str = "dp", fft_kernel=None):
    """``T(z)`` on the flat layout (..., M) with the padded grid split over
    ``mesh[axis]``: the input replicated, the output replicated.
    ``fft_kernel``: this rank's spectrum slab (:func:`shard_toeplitz_kernel`),
    cut from ``toeplitz`` when None."""
    k, r = _axis(mesh, axis)
    _check(toeplitz, k, axis)
    group = mesh.get_group(axis)
    kf = (fft_kernel if fft_kernel is not None
          else shard_toeplitz_kernel(toeplitz, mesh, axis))
    ns, fshape, d = toeplitz.ns, toeplitz.fft_shape, toeplitz.d
    cdtype = toeplitz.fft_kernel.dtype
    # this rank's slab of the padded input: rows [lo, lo + w) of the split
    # axis (P1 at d=2, P3 at d=3), of which [lo, hi) hold input
    ax = 0 if d == 2 else 2
    w = fshape[ax] // k
    lo, hi = r * w, min((r + 1) * w, ns[ax])
    central = tuple(slice(n - 1, 2 * n - 1) for n in ns)

    def T_apply(z):
        batch = z.shape[:-1]
        xb = z.to(cdtype).reshape((-1,) + tuple(ns))
        B = xb.shape[0]
        if d == 2:
            xp = xb.new_zeros((B, w, fshape[1]))
            if hi > lo:
                xp[:, :hi - lo, :ns[1]] = xb[:, lo:hi]
            y = _pencil_conv2d(xp, kf, group, k)[:, :, central[1]]
            y = collectives.all_gather(y, group, 1)[:, central[0]]
        else:
            xp = xb.new_zeros((B, fshape[0], fshape[1], w))
            if hi > lo:
                xp[:, :ns[0], :ns[1], :hi - lo] = xb[..., lo:hi]
            y = _pencil_conv3d(xp, kf, group, k)[:, central[0], central[1]]
            y = collectives.all_gather(y, group, 3)[..., central[2]]
        return y.reshape(batch + (toeplitz.size,))

    return T_apply


def msharded_toeplitz_matvec(toeplitz: ToeplitzND, x, mesh,
                             axis: str = "dp", fft_kernel=None):
    """Apply the d=2 or d=3 multilevel-Toeplitz operator with its padded
    grid split over ``mesh[axis]``.  ``x``: (..., M) flat or (..., n1, n2[,
    n3]) block, replicated; the result (the same layout, on every rank)
    equals ``toeplitz(x)`` up to the order of the FFT's sums.  Requires the
    split FFT sizes divisible by the axis (power-of-two pads on
    power-of-two meshes)."""
    d = toeplitz.d
    flat = x.shape[-1] == toeplitz.size and (
        x.ndim < d or tuple(x.shape[-d:]) != tuple(toeplitz.ns))
    batch = x.shape[:-1] if flat else x.shape[:-d]
    T_apply = make_msharded_toeplitz_apply(toeplitz, mesh, axis, fft_kernel)
    y = T_apply(x.reshape(batch + (toeplitz.size,)))
    return y if flat else y.reshape(batch + tuple(toeplitz.ns))


def make_msharded_A_mean(ws, toeplitz: ToeplitzND, sigmasq, mesh,
                         axis: str = "dp"):
    """The mean-solve operator ``A beta = D T D beta + sigma^2 beta`` on the
    pencil-split Toeplitz apply."""
    return make_A_mean(ws, make_msharded_toeplitz_apply(toeplitz, mesh, axis),
                       sigmasq)


def _msharding(mesh, n: int, axis: str) -> collectives.Sharding:
    """The points split over ``axis``, every Gram on its pencil."""
    return point_sharding(
        mesh, n, axis,
        pencil=lambda T: make_msharded_toeplitz_apply(T, mesh, axis))


def _points_2_or_3(x, name: str) -> torch.Tensor:
    x = _as_points(torch.as_tensor(x), None)
    if x.shape[1] not in (2, 3):
        raise NotImplementedError(f"{name} requires d in {{2, 3}}")
    return x


def msharded_fit(x, y, kernel, sigmasq, h, mtot: int, mesh, *,
                 axis: str = "dp", cg_tol: float = 1e-4,
                 max_cg_iter: Optional[int] = None,
                 use_precond: bool = True) -> FitState:
    """EFGP fit with the frequency grid split over ``axis``: the points
    split over it too (the type-1 right-hand side and lag table reduced
    over the ranks), then the Jacobi PCG (or CG without ``use_precond``)
    on the pencil operator.  Equals ``fit_with_grid(..., solver="cg")`` up
    to the order of sums; the state is that function's, on every rank.
    d in {2, 3}."""
    x = _points_2_or_3(x, "msharded_fit")
    with collectives.sharded(_msharding(mesh, x.shape[0], axis)):
        return fit_with_grid(
            shard_points(x, mesh, axis), shard_points(y, mesh, axis), kernel,
            sigmasq, h, mtot, cg_tol=cg_tol, max_cg_iter=max_cg_iter,
            use_precond=use_precond, solver="cg", device=mesh_device(mesh))


def msharded_predict_var(state: FitState, x_new, mesh, *, axis: str = "dp",
                         cg_tol: float = 1e-4, max_cg_iter: int = 1000,
                         microbatch: int = 2048) -> torch.Tensor:
    """Exact per-target posterior variance (``predict_var(method=
    "regular")``) with the per-target solves, one batched Jacobi PCG a
    microbatch of targets, on the pencil operator, whatever tier or
    preconditioner the fit took (as gpquad's).  d in {2, 3}."""
    jacobi = dataclasses.replace(state, A_dense=None, P_dense=None,
                                 defl_idx=None, defl_P=None, kron=None)
    pencil = collectives.Sharding(
        pencil=lambda T: make_msharded_toeplitz_apply(T, mesh, axis))
    with collectives.sharded(pencil):
        return _variance_regular(
            jacobi, _as_points(x_new, state.device, state.h.dtype),
            cg_tol=cg_tol, max_cg_iter=max_cg_iter, microbatch=microbatch)


def msharded_gradient(x, y, kernel, sigmasq, h, generator, mesh, *,
                      mtot: int, trace_samples: int = 10,
                      axis: str = "dp", cg_tol: float = 1e-3,
                      max_cg_iter: Optional[int] = None, probes=None):
    """Hyper-gradient with the frequency grid split over ``axis``:
    ``gradient_with_grid``'s estimator with Jacobi PCG, every Gram apply
    (the mean solve, the probe right-hand sides, the batched trace PCG) on
    the pencil, the points split over the same axis.  ``probes=(Z, V)``
    or, when None, drawn as ``gradient_with_grid`` draws them from
    ``generator`` (a fresh generator seeded 0 when None).  d in {2, 3}."""
    x = _points_2_or_3(x, "msharded_gradient")
    dev = mesh_device(mesh)
    n, d = x.shape
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if probes is None:
        probes = (_rademacher_rows(generator, trace_samples, n, x.dtype, dev),
                  _rademacher_rows(generator, trace_samples, mtot ** d,
                                   x.dtype, dev))
    Z, V = probes
    with collectives.sharded(_msharding(mesh, n, axis)):
        return gradient_with_grid(
            shard_points(x, mesh, axis), shard_points(y, mesh, axis), kernel,
            sigmasq, h, generator, mtot=mtot, trace_samples=trace_samples,
            cg_tol=cg_tol, max_cg_iter=max_cg_iter,
            probes=(_probe_block(Z, mesh, None, axis), replicate(V, mesh)),
            solver="cg",
            precond="jacobi", device=dev)


def msharded_fit_high(x, y, kernel, sigmasq, h, mtot: int, mesh, *,
                      axis: str = "dp", chunk: int = 64, ir_passes: int = 6,
                      ir_tol: float = 1e-2, ir_maxiter: int = 600,
                      ir_rtol: float = 1e-8) -> HighState:
    """High-precision (float64) fit with the frequency grid split over
    ``axis``: ``fit_high(solver="iterative")`` with Jacobi, whose float64
    ``F* y`` and lag table are the float64 type-1 on each rank's points
    reduced in complex128, whose true residuals take the complex128 pencil
    apply and whose float32 correction PCG the complex64 one.  gpquad
    returns ``(FitState, beta_lo)``, the low word of a double-word beta;
    the port's beta is float64, so it returns ``fit_high``'s
    :class:`HighState` (``predict_mean_high`` serves it).  ``chunk`` sized
    gpquad's double-word tables and is accepted and ignored.  d in {2,
    3}."""
    x = _points_2_or_3(x, "msharded_fit_high")
    with collectives.sharded(_msharding(mesh, x.shape[0], axis)):
        return fit_high(shard_points(x, mesh, axis),
                        shard_points(y, mesh, axis), kernel, sigmasq, h, mtot,
                        solver="iterative", ir_passes=ir_passes,
                        ir_tol=ir_tol, ir_maxiter=ir_maxiter,
                        ir_rtol=ir_rtol, device=mesh_device(mesh))
