"""Hyperparameter state: a flat log-space vector with named views; port of
``gpquad/kernels/params.py``.

``raw = log([kernel hypers..., sigmasq])``, float64.  The state is
immutable: an optimiser step makes a new one (:meth:`replace_raw`), and
:meth:`kernel_of` gives a kernel carrying the current positive values.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = ["HyperState"]


@dataclasses.dataclass(frozen=True)
class HyperState:
    raw: torch.Tensor                # (H+1,) log-space; last entry = noise var
    names: Tuple[str, ...]           # kernel hyper names

    @classmethod
    def create(cls, kernel, sigmasq) -> "HyperState":
        """Pack ``kernel``'s hypers and the noise variance into log space."""
        vals = [torch.as_tensor(v, dtype=torch.float64).reshape(())
                for _, v in kernel.iter_hypers()]
        vals.append(torch.as_tensor(sigmasq, dtype=torch.float64).reshape(()))
        dev = vals[0].device
        raw = torch.log(torch.stack([v.to(dev) for v in vals]))
        return cls(raw=raw, names=tuple(kernel.hyper_names))

    @property
    def pos(self) -> torch.Tensor:
        """Positive-space values ``exp(raw)``."""
        return torch.exp(self.raw)

    @property
    def sig2(self) -> torch.Tensor:
        """Noise variance, the last entry."""
        return self.pos[-1]

    def kernel_of(self, template):
        """``template`` carrying this state's hyper values."""
        return template.with_hypers(self.pos)

    def replace_raw(self, raw) -> "HyperState":
        return dataclasses.replace(self, raw=torch.as_tensor(raw))

    def clamp_min(self, name: str, min_value) -> "HyperState":
        """Lower-clamp one named hyper in positive space (the
        min-lengthscale constraint)."""
        idx = self.names.index(name)
        raw = self.raw.clone()
        raw[idx] = torch.clamp(raw[idx], min=float(torch.log(
            torch.as_tensor(min_value, dtype=torch.float64))))
        return self.replace_raw(raw)

    def as_dict(self):
        p = self.pos
        out = {n: p[i] for i, n in enumerate(self.names)}
        out["sigmasq"] = p[-1]
        return out
