"""Data- and probe-parallel scale-out over ``torch.distributed``; port of
``gpquad/parallel/sharding.py``.

gpquad places the points on a ``dp`` mesh axis and the trace probes on a
``probe`` axis, and GSPMD turns the type-1 NUFFT contraction over the
sharded points into one ``psum`` while the frequency-space state stays
replicated.  The port's functions take the same whole inputs and a
``DeviceMesh``, and every rank calls them with the same arguments
(SPMD).  Each rank takes its contiguous block of the points (and of the
probe rows), and runs the single-process entry point on it inside
``ops.collectives.sharded``: each sum over the points becomes an
``all_reduce`` over the ``dp`` group, each mean over the probe rows one
over the ``probe`` group, and the iteration counts their maximum.  What
follows a reduction is computed alike on every rank, so the frequency
state is replicated.  At world size 1 every collective is a copy and the
results have the bits of the unsharded call.

The process group is the caller's: ``torch.distributed.init_process_group``
before :func:`make_mesh` (NCCL for the card, gloo on the CPU).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.efgp import _as_points, fit_with_grid, resolve_device
from ..models.gradient import _rademacher_rows, gradient_with_grid
from ..models.pg_core import outer_step
from ..ops import collectives

__all__ = ["make_mesh", "shard_points", "shard_probes", "replicate",
           "sharded_fit", "sharded_gradient", "sharded_pg_outer_step"]


def make_mesh(n_devices: Optional[int] = None,
              axes: Tuple[str, ...] = ("dp",),
              shape: Optional[Tuple[int, ...]] = None, *, device="cuda"):
    """A ``DeviceMesh`` over the default process group, with the axis names
    ``axes``; by default all ranks on the first axis.  ``n_devices`` must
    be the world size (one device a rank).  The mesh lives on the card
    unless ``device="cpu"``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: call torch.distributed.init_process_group first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"make_mesh: {n} devices asked for, but the process "
                         f"group has {world} ranks (one device a rank)")
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes) or int(torch.tensor(shape).prod()) != n:
        raise ValueError(f"make_mesh: shape {shape} for axes {axes} does not "
                         f"hold {n} ranks")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=tuple(axes))


def mesh_device(mesh) -> torch.device:
    """The device of this rank's tensors on ``mesh``."""
    if mesh.device_type == "cuda":
        return resolve_device(f"cuda:{torch.cuda.current_device()}")
    return torch.device(mesh.device_type)


def _axis(mesh, axis: Optional[str]):
    """(size, this rank's index) along ``axis``; (1, 0) for None."""
    if axis is None:
        return 1, 0
    return (mesh.size(mesh.mesh_dim_names.index(axis)),
            mesh.get_local_rank(axis))


def _block(arr, dim: int, mesh, axis: Optional[str], *, even: bool = False):
    k, r = _axis(mesh, axis)
    if even and arr.shape[dim] % k:
        raise ValueError(f"{arr.shape[dim]} rows do not split evenly over "
                         f"mesh axis '{axis}' of size {k}")
    return torch.tensor_split(arr, k, dim=dim)[r]


def shard_points(arr, mesh, axis: str = "dp") -> torch.Tensor:
    """This rank's contiguous block of the leading (point) axis of
    ``arr``, on the rank's device."""
    arr = torch.as_tensor(arr)
    return _block(arr, 0, mesh, axis).contiguous().to(mesh_device(mesh))


def shard_probes(arr, mesh, axis: str = "probe") -> torch.Tensor:
    """This rank's block of the leading (probe) axis of ``arr``, which the
    axis must split evenly (probe means divide by the count of all
    rows)."""
    arr = torch.as_tensor(arr)
    return _block(arr, 0, mesh, axis, even=True).contiguous().to(
        mesh_device(mesh))


def replicate(arr, mesh) -> torch.Tensor:
    """``arr`` whole, on the rank's device."""
    return torch.as_tensor(arr).to(mesh_device(mesh))


def _probe_axis(mesh, probe_axis: Optional[str]) -> Optional[str]:
    return probe_axis if probe_axis in (mesh.mesh_dim_names or ()) else None


def point_sharding(mesh, n: int, axis: str = "dp",
                   probe_axis: Optional[str] = None,
                   pencil=None) -> collectives.Sharding:
    """The ``Sharding`` of ``n`` points split over ``axis`` (and probe rows
    over ``probe_axis``, where given)."""
    k, _ = _axis(mesh, axis)
    counts = tuple(len(b) for b in torch.tensor_split(torch.arange(n), k))
    kp, _ = _axis(mesh, probe_axis)
    return collectives.Sharding(
        dp=mesh.get_group(axis), point_counts=counts,
        probe=mesh.get_group(probe_axis) if probe_axis else None,
        probe_ranks=kp, pencil=pencil)


def _probe_block(arr, mesh, probe_axis, axis="dp"):
    """Rows over ``probe_axis`` (evenly), columns (points) over ``axis``."""
    arr = torch.as_tensor(arr)
    rows = _block(arr, 0, mesh, probe_axis, even=True)
    return _block(rows, 1, mesh, axis).contiguous().to(mesh_device(mesh))


def sharded_fit(x, y, kernel, sigmasq, h, mtot, mesh, **kw):
    """Data-parallel fit: the points split over ``dp``, the type-1
    right-hand side and lag table reduced over it, and the solve (any of
    ``fit_with_grid``'s tiers and preconditioners, ``**kw``) replicated.
    The state is ``fit_with_grid``'s, on every rank."""
    x = _as_points(torch.as_tensor(x), None)
    sh = point_sharding(mesh, x.shape[0])
    with collectives.sharded(sh):
        return fit_with_grid(shard_points(x, mesh), shard_points(y, mesh),
                             kernel, sigmasq, h, mtot,
                             device=mesh_device(mesh), **kw)


def sharded_gradient(x, y, kernel, sigmasq, h, generator=None, *, mesh,
                     mtot: int, trace_samples: int,
                     probe_axis: str = "probe", **kw):
    """Data- and probe-parallel ``gradient_with_grid``: the points split
    over ``dp``, the Rademacher probe rows over ``probe_axis`` (replicated
    when the mesh lacks it), so each rank solves its rows of the batched
    trace PCG.  The probes are drawn as ``gradient_with_grid`` draws them
    (``Z`` (T, n) then ``V`` (T, M) from ``generator``, a fresh generator
    on the mesh's device seeded 0 when None), or given as
    ``probes=(Z, V)``; the rest of ``**kw`` passes through."""
    dev = mesh_device(mesh)
    x = _as_points(torch.as_tensor(x), None)
    n, d = x.shape
    probes = kw.pop("probes", None)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if probes is None:
        rdtype = x.dtype
        probes = (_rademacher_rows(generator, trace_samples, n, rdtype, dev),
                  _rademacher_rows(generator, trace_samples, mtot ** d,
                                   rdtype, dev))
    pa = _probe_axis(mesh, probe_axis)
    Z, V = probes
    sh = point_sharding(mesh, n, probe_axis=pa)
    with collectives.sharded(sh):
        return gradient_with_grid(
            shard_points(x, mesh), shard_points(y, mesh), kernel, sigmasq,
            h, generator, mtot=mtot, trace_samples=trace_samples,
            probes=(_probe_block(Z, mesh, pa),
                    shard_probes(V, mesh, pa) if pa else replicate(V, mesh)),
            device=dev, **kw)


def sharded_pg_outer_step(x, kern, h, ws_mask, delta, kappa, pg_b, e_probes,
                          m_probes, raw, opt, *, mesh,
                          probe_axis: str = "probe", **kw):
    """Data- and probe-parallel Polya-Gamma outer EM iteration
    (``models.pg_core.outer_step``): the point-space vectors (x, delta,
    kappa, pg_b and the probes' point axis) split over ``dp``, the E-step
    and M-step probe rows over ``probe_axis`` (replicated when the mesh
    lacks it), the (M,)-space state replicated.  The M-step probes are an
    argument, as ``outer_step`` takes them.  The result's point-space
    vectors (delta, mean, sigma_diag) are gathered whole on every rank."""
    x = _as_points(torch.as_tensor(x), None)
    pa = _probe_axis(mesh, probe_axis)
    sh = point_sharding(mesh, x.shape[0], probe_axis=pa)
    pts = [shard_points(v, mesh) for v in (x, delta, kappa, pg_b)]
    with collectives.sharded(sh):
        res = outer_step(pts[0], kern, h, ws_mask, pts[1], pts[2], pts[3],
                         _probe_block(e_probes, mesh, pa),
                         _probe_block(m_probes, mesh, pa), raw, opt, **kw)
    return res._replace(delta=sh.gather_points(res.delta),
                        mean=sh.gather_points(res.mean),
                        sigma_diag=sh.gather_points(res.sigma_diag))
