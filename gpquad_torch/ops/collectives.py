"""The reductions of the scale-out (``gpquad_torch.parallel``).

gpquad shards its cores by the placement of their inputs on a mesh: the
points over a ``dp`` axis, the probe rows over a ``probe`` axis, and GSPMD
turns every sum over a sharded axis into a ``psum``.  The port has no such
compiler, so its cores name each such sum: the fit, the gradient, the high
tier and the Polya-Gamma passes call :func:`current` and route

- every type-1 NUFFT over the training points, and every other sum over
  the points, through :meth:`Sharding.points`;
- every mean over the probe rows through :meth:`Sharding.probes` (a sum,
  then a division by the count of all rows, :meth:`Sharding.n_probes`);
- the Toeplitz Gram of a solve through :meth:`Sharding.toeplitz`, which the
  M-sharded layout replaces by its pencil-transposed apply.

Unsharded (:data:`LOCAL`, the default) every method is the identity, so the
single-process entry points run as before.  ``gpquad_torch.parallel``'s
functions call the same entry points inside :func:`sharded`, on this rank's
block of the inputs: the program is the same, and at world size 1 each
collective is a copy, so the result has the same bits.

Complex tensors cross a collective as their real view (NCCL and gloo
differ in their complex support).  A reduction works in place on the
tensor it is given, which is a fresh result at every call site.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, Optional, Sequence

import torch

__all__ = ["Sharding", "LOCAL", "current", "sharded", "all_reduce"]


def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """``t`` reduced in place over ``group`` (``op``: "sum" or "max"), and
    returned; the identity when ``group`` is None."""
    if group is None:
        return t
    import torch.distributed as dist
    t = t.contiguous()
    dist.all_reduce(_real(t), op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order; every
    rank's ``t`` has the same shape."""
    import torch.distributed as dist
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather([_real(p) for p in parts], _real(t), group=group)
    return torch.cat(parts, dim=dim)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How this rank holds a sharded call's inputs.

    ``dp``: the process group over which the points are split (None: this
    rank holds them all), ``point_counts`` the size of each rank's block in
    the group's rank order; ``probe``: the group over which the probe rows
    are split evenly, ``probe_ranks`` its size; ``pencil``: maps a
    ``ToeplitzND`` to the apply that the M-sharded layout runs in its
    place (None: the operator itself)."""
    dp: object = None
    point_counts: Optional[Sequence[int]] = None
    probe: object = None
    probe_ranks: int = 1
    pencil: Optional[Callable] = None

    def points(self, t: torch.Tensor) -> torch.Tensor:
        """A sum over this rank's points made a sum over all points."""
        return all_reduce(t, "sum", self.dp)

    def probes(self, t: torch.Tensor) -> torch.Tensor:
        """A sum over this rank's probe rows made a sum over all rows."""
        return all_reduce(t, "sum", self.probe)

    def probe_max(self, t: torch.Tensor) -> torch.Tensor:
        """The largest ``t`` over the probe group (iteration counts)."""
        return all_reduce(t, "max", self.probe)

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        """The largest ``t`` over every rank of the call, so that a host
        decision on it is the same on all."""
        return all_reduce(all_reduce(t, "max", self.dp), "max", self.probe)

    def n_points(self, n_local: int) -> int:
        return n_local if self.point_counts is None else sum(self.point_counts)

    def n_probes(self, rows_local: int) -> int:
        return rows_local * self.probe_ranks

    def toeplitz(self, T) -> Callable:
        return T if self.pencil is None else self.pencil(T)

    def gather_points(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a point-space vector (n_local,) made the
        whole vector, in point order."""
        if self.dp is None:
            return t
        width = max(self.point_counts)
        padded = torch.nn.functional.pad(t, (0, width - t.shape[0]))
        parts = all_gather(padded[None], self.dp, 0)
        return torch.cat([parts[i, :c]
                          for i, c in enumerate(self.point_counts)])

    def gather_probe_rows(self, t: torch.Tensor, groups: int) -> torch.Tensor:
        """Per-row values of ``groups`` stacked blocks of this rank's probe
        rows (``groups * rows_local``,) made those of all rows, in the
        unsharded order (each block's rows over the probe ranks in turn)."""
        if self.probe is None:
            return t
        parts = all_gather(t.reshape(1, groups, -1), self.probe, 0)
        return parts.transpose(0, 1).reshape(-1)


LOCAL = Sharding()
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "gpquad_torch_sharding", default=LOCAL)


def current() -> Sharding:
    """The sharding of the call in progress (:data:`LOCAL` outside
    :func:`sharded`)."""
    return _CURRENT.get()


@contextlib.contextmanager
def sharded(sharding: Sharding):
    """Run the cores inside the block with ``sharding``'s reductions."""
    token = _CURRENT.set(sharding)
    try:
        yield sharding
    finally:
        _CURRENT.reset(token)
