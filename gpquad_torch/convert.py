"""Carry kernels, hypers and fit state across from the JAX package as numpy
arrays.

A JAX ``FitState`` turned into numpy (``np.asarray`` of each field, the
Toeplitz operator as its ``fft_kernel``, a Kronecker preconditioner as
``kron_Us`` (its d unitaries stacked) and ``kron_denom``) becomes the port's
:class:`~gpquad_torch.models.efgp.FitState`, and back, so that the port can
predict from a JAX fit and JAX from the port's.  A ``HyperState``'s ``raw``
and ``names`` carry the hypers of an ``EFGP`` either way, and a fitted
Polya-Gamma estimator's state becomes a fitted port estimator
(:func:`pg_state_from_numpy`).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .kernels import HyperState, Matern, make_kernel
from .models.efgp import FitState, resolve_device
from .models.precision import HighState
from .models.ski import BandedInterpTables, SKIOperator
from .ops.cuda_interp import column_index, point_of_slot
from .ops.kron_precond import KronPrecond
from .ops.toeplitz import ToeplitzND

__all__ = ["kernel_from_numpy", "fit_state_from_numpy", "fit_state_to_numpy",
           "high_state_from_numpy", "hyper_state_from_numpy",
           "hyper_state_to_numpy",
           "pg_state_from_numpy", "ski_fit_from_numpy", "ski_fit_to_numpy"]

# gpquad's band tables, the ones a SKI fit's arrays carry
_BAND_TABLES = ("pidx", "valid", "i0loc", "c0", "w_row", "w_col", "inv_slot")
_STATE_ARRAYS = ("beta", "ws", "h", "sigmasq", "fft_kernel", "diag_scale",
                 "A_dense", "P_dense", "defl_idx", "defl_P", "mean_cg_iters")


def kernel_from_numpy(name, hypers, dimension: int, nu=None):
    """Kernel ``name`` ("SE", "SquaredExponential", "Matern12/32/52", or
    "Matern" with its ``nu``) with the hyper vector ``hypers``
    (``hyper_names`` order, as ``AbstractKernel.hyper_vector`` gives
    it)."""
    if str(name).lower() == "matern":
        kernel = Matern(dimension=dimension, nu=2.5 if nu is None else nu)
    else:
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


def high_state_from_numpy(arrays: Mapping[str, np.ndarray], mtot: int,
                          d: int, device="cuda") -> HighState:
    """The port's ``HighState`` from a gpquad ``HighState``'s arrays: its
    state's (as :func:`fit_state_from_numpy` reads them) and the low words
    ``ws_lo``, ``h_lo`` and, from the matrix-free fit, ``beta_lo``.  Each
    float64 word is the sum of its pair taken in float64: ``ws = Re(ws) +
    ws_lo``, ``h = h + h_lo``, ``beta = beta + beta_lo``.  gpquad keeps no
    residual on its state: ``residual`` is NaN."""
    dev = resolve_device(device)
    state = fit_state_from_numpy(arrays, mtot, d, device=dev)

    def f64(key, dtype=np.float64):
        return np.asarray(arrays[key]).astype(dtype)

    beta = f64("beta", np.complex128)
    if arrays.get("beta_lo") is not None:
        beta = beta + f64("beta_lo", np.complex128)
    return HighState(
        state=state,
        ws=torch.as_tensor(np.real(f64("ws", np.complex128)) + f64("ws_lo"),
                           device=dev),
        h=torch.as_tensor(f64("h") + f64("h_lo"), device=dev),
        beta=torch.as_tensor(beta, device=dev),
        residual=torch.tensor(float("nan"), dtype=torch.float64, device=dev))


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


def ski_fit_to_numpy(fit) -> dict:
    """The arrays of a port SKI fit: the stencils ``idx`` and ``wvals``,
    gpquad's band tables (``banded_<field>`` for each field of
    ``_BAND_TABLES``, absent when the plan was dropped; the
    column index is derived from them on reading), ``grid_shape``, ``lo``,
    ``dx``, the Toeplitz ``fft_kernel``, ``alpha``, ``raw`` (log-space
    hypers, the noise variance last), and the kernel's ``kernel_name`` and
    ``hypers`` (``hyper_names`` order), with ``kernel_nu`` for a Matérn
    kernel."""
    model = fit["model"]
    op = model["operator"]
    fields = {"idx": op.idx, "wvals": op.wvals, "lo": op.lo, "dx": op.dx,
              "fft_kernel": model["toeplitz"].fft_kernel,
              "alpha": model["alpha"], "raw": model["raw"],
              "hypers": model["kernel"].hyper_vector()}
    if op.banded is not None:
        fields.update({f"banded_{k}": getattr(op.banded, k)
                       for k in _BAND_TABLES})
    out = {k: v.detach().cpu().numpy() for k, v in fields.items()}
    out["grid_shape"] = np.asarray(op.grid_shape)
    out["kernel_name"] = type(model["kernel"]).__name__
    if isinstance(model["kernel"], Matern):
        out["kernel_nu"] = np.float64(model["kernel"].nu)
    return out


def ski_fit_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda"):
    """A SKI fit dict that ``ski_predict_mean`` / ``ski_predict_var`` read,
    from the arrays :func:`ski_fit_to_numpy` names (from the port or from a
    gpquad fit: ``np.asarray`` of its operator's fields, its Toeplitz
    ``fft_kernel``, ``alpha`` and ``raw``).  The column-sorted slot index
    the ``interp_T_2d`` kernel walks and the point each slot of ``W v``
    writes are always made here from ``valid``, ``c0`` and ``pidx``, never
    read: they are derived data, and the kernels trust their slot and point
    numbers and ranges (each point is checked against n as it is made, and
    ``SKIOperator`` checks the point table again)."""
    dev = resolve_device(device)

    def t(a, dtype=None):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    grid_shape = tuple(int(m) for m in np.asarray(arrays["grid_shape"]))
    banded = None
    if arrays.get("banded_pidx") is not None:
        dtypes = {"pidx": torch.int64, "inv_slot": torch.int64,
                  "i0loc": torch.int32, "c0": torch.int32,
                  "col_slots": torch.int32, "col_start": torch.int32,
                  "pout": torch.int32}
        tables = {k: arrays[f"banded_{k}"] for k in _BAND_TABLES}
        tables["col_slots"], tables["col_start"] = column_index(
            tables["valid"], tables["c0"], grid_shape[1])
        tables["pout"] = point_of_slot(tables["valid"], tables["pidx"],
                                       len(tables["inv_slot"]))
        banded = BandedInterpTables(**{k: t(a, dtypes.get(k))
                                       for k, a in tables.items()})
    fft_kernel = t(arrays["fft_kernel"])
    toeplitz = ToeplitzND(fft_kernel=fft_kernel, ns=grid_shape,
                          fft_shape=tuple(fft_kernel.shape))
    op = SKIOperator(idx=t(arrays["idx"], torch.int64),
                     wvals=t(arrays["wvals"]), toeplitz=toeplitz,
                     grid_shape=grid_shape, lo=t(arrays["lo"]),
                     dx=t(arrays["dx"]), banded=banded)
    nu = arrays.get("kernel_nu")
    kernel = kernel_from_numpy(str(arrays["kernel_name"]), arrays["hypers"],
                               len(grid_shape),
                               nu=None if nu is None else float(nu)).to(dev)
    return {"model": {"kernel": kernel, "raw": t(arrays["raw"]),
                      "alpha": t(arrays["alpha"]), "operator": op,
                      "toeplitz": toeplitz}}


_PG_STATE = ("X", "delta", "beta_mean", "lengthscale", "variance", "h",
             "mtot", "hm", "kappa")


def pg_state_from_numpy(arrays: Mapping[str, np.ndarray], params=None, *,
                        kind: str = "classifier", device="cuda"):
    """A fitted port PG estimator (``kind`` "classifier" or
    "negative_binomial") at a fitted state given as numpy arrays, so that
    predictions compare at one fixed state.

    ``arrays``: the training points ``X`` (n, d), the posterior ``delta``
    and ``kappa`` (n,), ``beta_mean`` (M,) complex, ``lengthscale``,
    ``variance``, the grid plan's ``h``, ``mtot`` and ``hm``, optionally
    ``posterior_mean`` and ``posterior_var_diag`` (n,), and the
    likelihood's fields: ``classes`` for the classifier, ``total_count``
    for the regressor.  From a gpquad estimator: its ``delta_``,
    ``beta_mean_``, ``lengthscale_``, ``variance_``, the spectral state's
    ``h`` and ``mtot``, ``_hm_``, ``_kappa_t_`` cut to the first n
    entries, and ``classes_`` or ``total_count_``.  ``params`` are the
    estimator's constructor arguments (its ``get_params()``)."""
    from .models.pg import (PolyagammaGPClassifier,
                            PolyagammaGPNegativeBinomialRegressor)
    params = dict(params or {})
    params["device"] = device
    missing = [k for k in _PG_STATE if k not in arrays]
    if missing:
        raise KeyError(f"pg_state_from_numpy: missing {missing}")
    if kind == "classifier":
        est = PolyagammaGPClassifier(**params)
        est.classes_ = np.asarray(arrays["classes"])
    elif kind == "negative_binomial":
        params["total_count"] = float(arrays["total_count"])
        params["learn_total_count"] = False
        est = PolyagammaGPNegativeBinomialRegressor(**params)
        est.total_count_ = est.shape_parameter_ = float(
            arrays["total_count"])
    else:
        raise ValueError(f"Unknown PG estimator kind {kind!r} "
                         "(classifier | negative_binomial)")
    n = np.asarray(arrays["X"]).shape[0]
    return est._load_state(
        X=arrays["X"], delta=np.asarray(arrays["delta"])[:n],
        beta_mean=arrays["beta_mean"], lengthscale=arrays["lengthscale"],
        variance=arrays["variance"], h=float(arrays["h"]),
        mtot=int(arrays["mtot"]), hm=int(arrays["hm"]),
        kappa=np.asarray(arrays["kappa"])[:n],
        posterior_mean=arrays.get("posterior_mean"),
        posterior_var_diag=arrays.get("posterior_var_diag"))
