"""Carry kernels, hypers and fit state across from the JAX package as numpy
arrays.

A JAX ``FitState`` turned into numpy (``np.asarray`` of each field, the
Toeplitz operator as its ``fft_kernel``, a Kronecker preconditioner as
``kron_Us`` (its d unitaries stacked) and ``kron_denom``) becomes the port's
:class:`~gpquad_torch.models.efgp.FitState`, and back, so that the port can
predict from a JAX fit and JAX from the port's.  A ``HyperState``'s ``raw``
and ``names`` carry the hypers of an ``EFGP`` either way.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .kernels import HyperState, make_kernel
from .models.efgp import FitState, resolve_device
from .ops.kron_precond import KronPrecond
from .ops.toeplitz import ToeplitzND

__all__ = ["kernel_from_numpy", "fit_state_from_numpy", "fit_state_to_numpy",
           "hyper_state_from_numpy", "hyper_state_to_numpy"]

_STATE_ARRAYS = ("beta", "ws", "h", "sigmasq", "fft_kernel", "diag_scale",
                 "A_dense", "P_dense", "defl_idx", "defl_P", "mean_cg_iters")


def kernel_from_numpy(name, hypers, dimension: int):
    """Kernel ``name`` with the hyper vector ``hypers`` (``hyper_names``
    order, as ``AbstractKernel.hyper_vector`` gives it)."""
    kernel = make_kernel(name, dimension)
    return kernel.with_hypers(torch.as_tensor(np.array(hypers)))


def fit_state_from_numpy(arrays: Mapping[str, np.ndarray], mtot: int, d: int,
                         device="cuda") -> FitState:
    """The port's ``FitState`` from numpy arrays: ``beta``, ``ws``, ``h``,
    ``sigmasq``, the Toeplitz ``fft_kernel``, ``diag_scale`` and, for the
    dense tier, ``A_dense`` and ``P_dense``, for a deflated CG fit
    ``defl_idx`` and ``defl_P``, for a kron fit ``kron_Us`` ((d, mtot,
    mtot) or a sequence of d matrices) and ``kron_denom``
    (``mean_cg_iters`` optional)."""
    dev = resolve_device(device)

    # np.array copies: numpy views of JAX arrays are read-only
    def t(key):
        a = arrays.get(key)
        return None if a is None else torch.as_tensor(np.array(a),
                                                      device=dev)

    fft_kernel = t("fft_kernel")
    toeplitz = ToeplitzND(fft_kernel=fft_kernel, ns=(mtot,) * d,
                          fft_shape=tuple(fft_kernel.shape))
    iters = t("mean_cg_iters")
    defl_idx = t("defl_idx")
    kron = None
    if arrays.get("kron_Us") is not None:
        Us = tuple(torch.as_tensor(np.array(U), device=dev)
                   for U in arrays["kron_Us"])
        kron = KronPrecond(Us=Us, denom=t("kron_denom"))
    return FitState(beta=t("beta"), ws=t("ws"), h=t("h"),
                    sigmasq=t("sigmasq"), toeplitz=toeplitz,
                    mean_cg_iters=iters if iters is not None
                    else torch.zeros((), dtype=torch.int32, device=dev),
                    diag_scale=t("diag_scale"), A_dense=t("A_dense"),
                    P_dense=t("P_dense"),
                    defl_idx=None if defl_idx is None else defl_idx.long(),
                    defl_P=t("defl_P"), kron=kron, mtot=mtot, d=d)


def fit_state_to_numpy(state: FitState) -> dict:
    """The arrays :func:`fit_state_from_numpy` reads, from a port state."""
    fields = {"fft_kernel": state.toeplitz.fft_kernel}
    fields.update({k: getattr(state, k) for k in _STATE_ARRAYS
                   if k != "fft_kernel"})
    if state.kron is not None:
        fields["kron_Us"] = torch.stack(state.kron.Us)
        fields["kron_denom"] = state.kron.denom
    return {k: v.detach().cpu().numpy() for k, v in fields.items()
            if v is not None}


def hyper_state_from_numpy(raw, names, device="cuda") -> HyperState:
    """The port's ``HyperState`` from a log-space ``raw`` vector (kernel
    hypers, then the noise variance) and the kernel's hyper ``names``."""
    return HyperState(raw=torch.as_tensor(np.array(raw, dtype=np.float64),
                                          device=resolve_device(device)),
                      names=tuple(names))


def hyper_state_to_numpy(state: HyperState) -> dict:
    """``{"raw": ..., "names": ...}`` of a port ``HyperState``; a JAX
    ``HyperState(raw=jnp.asarray(raw), names=names)`` is the same state."""
    return {"raw": state.raw.detach().cpu().numpy(),
            "names": tuple(state.names)}
