"""Float64 same-probe oracles for the EFGP and Polya-Gamma estimators; port
of ``gpquad/utils/f64_oracles.py``, in torch float64 on any device.

Replicas of the estimators' exact algebra that take their probes as
arguments, so that a difference from the estimator measures arithmetic and
solver error, not Hutchinson noise.  They run on the plain float64 path and
never on the CUDA kernels they check: the Gram ``T = F* F`` is the lag table
of the phase-matrix type-1 NUFFT (``ops/nufft.py``, in chunks of points)
gathered into a dense Toeplitz matrix, ``F* y`` and ``F* Z`` come from the
same plain type-1, and the solves are dense LU (``O(M^2)`` memory, ``M <=``
a few 10^4) or, for wider grids, :func:`toeplitz_cg_oracle_f64`'s float64
PCG on the FFT Toeplitz matvec.  The gradient oracle evaluates gpquad's
n-space formulas in the feature space (``z^T F s = (F* z)^H s``,
``|y - F beta|^2 = y.y - 2 Re (F* y)^H beta + beta^H T beta``), which
needs no (n, M) design matrix.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..kernels import SquaredExponential
from ..models.efgp import tensor_grid
from ..ops.cg import pcg
from ..ops.dense_solve import dense_toeplitz
from ..ops.kron_precond import kron_eig_build, make_kron_precond
from ..ops.nufft import make_phase_nufft
from ..ops.operators import make_A_mean, make_jacobi_precond
from ..ops.toeplitz import make_toeplitz
from ..quadrature import _host_f64

__all__ = ["plain_type1_f64", "efgp_f64_objects", "efgp_f64_objects_kernel",
           "mean_f64", "gradient_f64", "stochastic_var_f64",
           "regular_var_f64", "toeplitz_cg_oracle_f64", "pg_f64_objects",
           "pg_beta_mean_f64", "pg_mean_f64", "pg_var_f64"]

_F64, _C128 = torch.float64, torch.complex128
# points a phase-matrix chunk takes: (chunk, 4 mtot) complex128 matrices,
# 4.3 GB a dimension at n = 1e6 and mtot 677
_CHUNK = 200_000


def _f64(a, device=None):
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                           device=device).to(_F64)


def plain_type1_f64(x, vals, h: float, mtot: int, *, chunk: int = _CHUNK):
    """Float64 type-1 ``F* vals`` on the phase-matrix path, summed over
    chunks of ``chunk`` points: (n,) -> (M,), (B, n) -> (B, M)."""
    vals = vals.to(_C128)
    out = None
    for i in range(0, x.shape[0], chunk):
        op = make_phase_nufft(x[i:i + chunk], h, mtot)
        part = op.type1(vals[..., i:i + chunk])
        out = part if out is None else out + part
    return out.reshape(vals.shape[:-1] + (-1,))


def _spectral_tables(kernel, h: float, mtot: int, d: int):
    """The grid ``k h`` ((M, d)), ``S`` and ``dS/d(lengthscale)`` on it: the
    kernel's own formulas in float64 on the host."""
    m = (mtot - 1) // 2
    xis = tensor_grid(torch.arange(-m, m + 1, dtype=_F64) * h, d)
    with torch.no_grad():
        k = _host_f64(kernel)
        return xis, k.spectral_density(xis), k.spectral_grad(xis)[:, 0]


def efgp_f64_objects_kernel(x, y, kernel, sigmasq, h, mtot: int, *,
                            device=None, chunk: int = _CHUNK) -> Dict:
    """Dense float64 EFGP objects on the grid the estimators use: the Gram
    ``T``, the operator ``A = D T D + sigma^2 I`` and its LU factors,
    ``F* y``, the mean solve and the ``h^d dS/d(lengthscale)`` table.  The
    density and its derivative are the kernel's own formulas, evaluated in
    float64 on the host (SE or Matérn, any nu).  ``x``, ``y`` (numpy or tensors) go to
    ``device`` (default: ``x``'s, or the CPU) in float64."""
    if device is None:
        device = x.device if torch.is_tensor(x) else "cpu"
    x = _f64(x, device)
    x = x[:, None] if x.ndim == 1 else x
    y = _f64(y, device)
    n, d = x.shape
    h = float(h)
    m = (mtot - 1) // 2
    xis, S, dS = _spectral_tables(kernel, h, mtot, d)
    ws = torch.sqrt(S * h ** d).to(device)
    Dl = (dS * h ** d).to(device)
    ones = torch.ones((n,), dtype=_C128, device=device)
    v = plain_type1_f64(x, ones, h, 4 * m + 1, chunk=chunk)
    T = dense_toeplitz(v.reshape((4 * m + 1,) * d), mtot, d)
    M = T.shape[0]
    A = ws[:, None] * T * ws[None, :] + float(sigmasq) * torch.eye(
        M, dtype=_C128, device=device)
    lu = torch.linalg.lu_factor(A)
    Fy = plain_type1_f64(x, y, h, mtot, chunk=chunk)
    beta_raw = torch.linalg.lu_solve(*lu, (ws * Fy)[:, None])[:, 0]
    return dict(x=x, y=y, T=T, A=A, lu=lu, ws=ws, Fy=Fy, beta_raw=beta_raw,
                Dl=Dl, xis=xis.to(device), n=n, d=d,
                M=M, h=h, mtot=mtot, ell=float(kernel.lengthscale),
                var=float(kernel.variance), sigmasq=float(sigmasq),
                chunk=chunk)


def efgp_f64_objects(x, y, ell, var, sigmasq, h, mtot: int, **kw) -> Dict:
    """:func:`efgp_f64_objects_kernel` for the SE kernel (``ell``,
    ``var``) in the points' dimension."""
    d = 1 if np.ndim(x) == 1 else np.shape(x)[1]
    kernel = SquaredExponential(dimension=d, lengthscale=float(ell),
                                variance=float(var))
    return efgp_f64_objects_kernel(x, y, kernel, sigmasq, h, mtot, **kw)


def _solve(obj, B):
    """A^{-1} B for B of shape (M,) or (rows, M)."""
    lu, piv = obj["lu"]
    if B.ndim == 1:
        return torch.linalg.lu_solve(lu, piv, B[:, None])[:, 0]
    return torch.linalg.lu_solve(lu, piv, B.T).T


def _dot_re(a, b):
    return torch.sum(a.conj() * b, dim=-1).real


def _rows(obj, x_new):
    """Fourier rows ``exp(+2 pi i x . xi)`` at the targets, (B, M)."""
    xq = _f64(x_new, obj["x"].device)
    return torch.exp(2j * math.pi * (xq @ obj["xis"].T))


def mean_f64(obj: Dict, x_new) -> torch.Tensor:
    """Float64 posterior mean ``Re F_new (D beta)`` at the targets."""
    return (_rows(obj, x_new) @ (obj["ws"] * obj["beta_raw"])).real


def gradient_f64(obj: Dict, Z, V) -> torch.Tensor:
    """Same-probe float64 replica of ``gradient_with_grid``: the (3,)
    gradient over (lengthscale, variance, sigmasq) for the probes ``Z``
    (T, n) and ``V`` (T, M)."""
    dev = obj["x"].device
    T, ws, Fy, Dl, y = obj["T"], obj["ws"], obj["Fy"], obj["Dl"], obj["y"]
    n, sig, var = obj["n"], obj["sigmasq"], obj["var"]
    Z, V = _f64(Z, dev), _f64(V, dev)
    Tn = Z.shape[0]

    beta = ws * obj["beta_raw"]
    Tb = beta @ T.T
    fadj_alpha = (Fy - Tb) / sig
    term2_l = _dot_re(fadj_alpha, Dl * fadj_alpha)
    yy = torch.dot(y, y)
    fyb = _dot_re(Fy, beta)
    alpha_norm = (yy - 2.0 * fyb + _dot_re(beta, Tb)) / sig ** 2
    y_alpha = (yy - fyb) / sig
    term2_v = (y_alpha - sig * alpha_norm) / var

    fadjZ = plain_type1_f64(obj["x"], Z, obj["h"], obj["mtot"],
                            chunk=obj["chunk"])               # (T, M)
    Di_FZ = Dl * fadjZ
    B_kernel = ws * (Di_FZ @ T.T)
    B_noise = ws * ((ws * V).to(_C128) @ T.T)
    Beta_all = _solve(obj, torch.cat([B_kernel, B_noise]))
    # t1_l = mean_t Re z_t^T (F D' F* z_t - F D Beta_t) / sigma^2
    t1_l = torch.mean(_dot_re(fadjZ, Di_FZ - ws * Beta_all[:Tn])) / sig
    t1_noise = n / sig - torch.mean(
        torch.sum(V * Beta_all[Tn:], dim=1).real) / sig
    t1_v = (n - sig * t1_noise) / var
    term1 = torch.stack([t1_l, t1_v, t1_noise])
    term2 = torch.stack([term2_l, term2_v, alpha_norm])
    return 0.5 * (term1 - term2)


def stochastic_var_f64(obj: Dict, etas, x_new) -> torch.Tensor:
    """Same-probe float64 replica of the Hutchinson diag-sums variance."""
    dev = obj["x"].device
    ws, sig = obj["ws"], obj["sigmasq"]
    mtot, d, h = obj["mtot"], obj["d"], obj["h"]
    etas = _f64(etas, dev)
    P = etas.shape[0]
    gammas = ws * (sig * _solve(obj, (ws * etas).to(_C128)))
    L = 2 * mtot - 1
    shape = (P,) + (mtot,) * d
    dims = tuple(range(1, d + 1))
    G = torch.fft.fftn(gammas.reshape(shape), s=(L,) * d, dim=dims)
    E = torch.fft.fftn(etas.reshape(shape).to(_C128), s=(L,) * d, dim=dims)
    est = torch.mean(torch.fft.ifftn(G * E.conj(), s=(L,) * d, dim=dims),
                     dim=0)
    k1 = torch.fft.fftfreq(L, 1.0 / L, dtype=_F64, device=dev)
    K = torch.stack(torch.meshgrid(*([k1] * d), indexing="ij"),
                    dim=-1).reshape(-1, d)
    xq = _f64(x_new, dev)
    phase = torch.exp(2j * math.pi * (xq @ (h * K).T))
    return (phase @ est.reshape(-1)).real


def regular_var_f64(obj: Dict, x_new) -> torch.Tensor:
    """Exact per-target posterior variance in float64 (the "regular"
    method)."""
    ws, sig = obj["ws"], obj["sigmasq"]
    Ft = _rows(obj, x_new)
    Z = sig * _solve(obj, ws * Ft.conj())
    return torch.clamp(torch.sum(Ft * (ws * Z), dim=-1).real, min=0.0)


def toeplitz_cg_oracle_f64(x, y, kernel, sigmasq, h, mtot: int, x_targets,
                           *, tol: float = 1e-12, maxiter: int = 4000,
                           chunk: int = _CHUNK, device=None):
    """Float64 posterior mean at ``x_targets`` for grids where a dense
    ``A`` does not fit (bench.py's scale oracle): the lag table and ``F* y``
    by the chunked phase-matrix type-1, PCG to ``tol`` on the complex128
    FFT Toeplitz matvec, preconditioned by the Kronecker eigen-
    preconditioner at d = 2 (Jacobi otherwise; the preconditioner changes
    the iteration count, not the solution), the mean by the phase-matrix
    type-2.  Returns ``(mean, PCG iterations, relative residual)``."""
    if device is None:
        device = x.device if torch.is_tensor(x) else "cpu"
    x = _f64(x, device)
    y = _f64(y, device)
    n, d = x.shape
    h = float(h)
    m = (mtot - 1) // 2
    ws = torch.sqrt(_spectral_tables(kernel, h, mtot, d)[1]
                    * h ** d).to(device, _C128)
    ones = torch.ones((n,), dtype=_C128, device=device)
    v = plain_type1_f64(x, ones, h, 4 * m + 1, chunk=chunk).reshape(
        (4 * m + 1,) * d)
    b = ws * plain_type1_f64(x, y, h, mtot, chunk=chunk)
    sig = float(sigmasq)
    diag_scale = float(n)
    if d == 2:
        M_inv = make_kron_precond(kron_eig_build(
            ws, v, sig, mtot=mtot, d=d, diag_scale=diag_scale))
    else:
        M_inv = make_jacobi_precond(ws, sig, diag_scale=diag_scale)
    A = make_A_mean(ws, make_toeplitz(v), sig)
    res = pcg(A, b, tol=tol, maxiter=maxiter, M_inv=M_inv)
    rel = torch.linalg.vector_norm(b - A(res.x)) / torch.linalg.vector_norm(b)
    mean = make_phase_nufft(_f64(x_targets, device), h, mtot).type2(
        (ws * res.x).reshape((mtot,) * d)).real
    return mean, int(res.iters), float(rel)


# ---------------------------------------------------------------------------
# the Polya-Gamma prediction system
# ---------------------------------------------------------------------------

def pg_f64_objects(x, delta, kernel, h, mtot: int, hm=None, *,
                   device=None, chunk: int = _CHUNK) -> Dict:
    """Dense float64 PG feature system for a fixed posterior ``delta``:

        T_w = F* diag(delta) F,   Ds = sqrt(max(ws2, eps_d)),
        A   = I + Ds T_w Ds,

    ``T_w`` gathered from the plain float64 type-1 of ``delta`` on the
    doubled grid, ``ws2 = S h^d`` from the kernel's density in float64 on
    the host (with ``hm``, zero on the bucketed rung's surplus nodes), and
    ``A``'s LU factors.  ``x``, ``delta`` go to ``device`` (default:
    ``x``'s, or the CPU)."""
    if device is None:
        device = x.device if torch.is_tensor(x) else "cpu"
    x = _f64(x, device)
    x = x[:, None] if x.ndim == 1 else x
    delta = _f64(delta, device)
    n, d = x.shape
    h = float(h)
    m = (mtot - 1) // 2
    xis, S, _ = _spectral_tables(kernel, h, mtot, d)
    ws2 = S * h ** d
    if hm is not None and hm < m:
        k = torch.round(xis / h).abs().amax(-1)
        ws2 = torch.where(k <= hm, ws2, torch.zeros_like(ws2))
    eps_d = max(float(torch.mean(ws2)) * 1e-14, 1e-14)
    Ds = torch.sqrt(torch.clamp(ws2, min=eps_d))
    ws2, Ds = ws2.to(device), Ds.to(device)
    v = plain_type1_f64(x, delta, h, 4 * m + 1, chunk=chunk)
    Tw = dense_toeplitz(v.reshape((4 * m + 1,) * d), mtot, d)
    M = Tw.shape[0]
    A = torch.eye(M, dtype=_C128, device=device) + Ds[:, None] * Tw \
        * Ds[None, :]
    return dict(x=x, A=A, lu=torch.linalg.lu_factor(A), ws2=ws2, Ds=Ds,
                xis=xis.to(device), n=n, d=d, M=M, h=h, mtot=mtot,
                chunk=chunk)


def pg_beta_mean_f64(obj: Dict, kappa) -> torch.Tensor:
    """Float64 beta mean: ``(I + Ds T_w Ds) z = Ds F* kappa``, ``beta =
    Ds^-1 z``."""
    q = plain_type1_f64(obj["x"], _f64(kappa, obj["x"].device), obj["h"],
                        obj["mtot"], chunk=obj["chunk"])
    return _solve(obj, obj["Ds"] * q) / obj["Ds"]


def pg_mean_f64(obj: Dict, x_new, beta) -> torch.Tensor:
    """Float64 latent predictive mean ``Re F_new (ws2 beta)``."""
    beta = torch.as_tensor(beta, device=obj["x"].device).to(_C128)
    return (_rows(obj, x_new) @ (obj["ws2"] * beta)).real


def pg_var_f64(obj: Dict, x_new) -> torch.Tensor:
    """Float64 exact latent variance: ``phi`` the conjugate rows, ``var =
    Re <phi, ws2 Ds^-1 z>``, ``(I + Ds T_w Ds) z = Ds phi``."""
    Ds, ws2 = obj["Ds"], obj["ws2"]
    phi = _rows(obj, x_new).conj()                           # (B, M)
    Z = _solve(obj, Ds * phi)
    return torch.clamp(torch.sum(phi.conj() * ((ws2 / Ds) * Z),
                                 dim=-1).real, min=0.0)
