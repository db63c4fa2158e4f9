"""Stochastic Lanczos quadrature; port of ``gpquad/ops/slq.py``.

``logdet_slq`` estimates ``log det(I + sigma^-2 D T D) + n log sigma^2``,
which by the Weinstein-Aronszajn identity equals
``log det(K_approx + sigma^2 I_n)``.  All probes run together: the Lanczos
recurrence is a Python loop over steps on a ``(probes, m)`` batch, and the
tridiagonal eigenproblems are one batched ``eigh``.  Early Krylov breakdown
(beta ~ 0) zeroes the recurrence, so the decoupled block carries zero Gauss
weight, as in the JAX ``lax.scan``.

Random probes come from a ``torch.Generator`` in place of a JAX key and are
drawn on the generator's device; a ``None`` generator is a fresh CPU
generator seeded 0.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

__all__ = ["logdet_slq", "lanczos_tridiag", "slq_trace_f", "power_iteration",
           "trace_ainv_b_fd"]

_BREAKDOWN = 1e-12


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None \
        else torch.Generator().manual_seed(0)


def lanczos_tridiag(Av: Callable, q0: torch.Tensor, steps: int):
    """Run ``steps`` of Lanczos from unit vector(s) ``q0`` (B, m).

    Returns (alphas, betas) of shapes (B, steps) and (B, steps): the
    tridiagonal coefficients, zero-padded after Krylov breakdown.
    """
    B = q0.shape[0]
    rdtype = q0.real.dtype if q0.is_complex() else q0.dtype
    q, q_prev = q0, torch.zeros_like(q0)
    beta_prev = torch.zeros((B,), dtype=rdtype, device=q0.device)
    alive = torch.ones((B,), dtype=torch.bool, device=q0.device)
    alphas, betas = [], []
    for _ in range(steps):
        v = Av(q) - beta_prev[:, None].to(q.dtype) * q_prev
        alpha = torch.sum(q.conj() * v, dim=-1).real
        v = v - alpha[:, None].to(v.dtype) * q
        beta = torch.sqrt(torch.sum(torch.abs(v) ** 2, dim=-1))
        alive_next = alive & (beta > _BREAKDOWN)
        safe = torch.where(beta == 0, torch.ones_like(beta), beta)
        q_next = torch.where(alive_next[:, None], v / safe[:, None].to(v.dtype),
                             torch.zeros_like(v))
        alphas.append(torch.where(alive, alpha, torch.zeros_like(alpha)))
        beta_kept = torch.where(alive_next, beta, torch.zeros_like(beta))
        betas.append(beta_kept)
        q_prev, q, beta_prev, alive = q, q_next, beta_kept, alive_next
    return torch.stack(alphas, dim=1), torch.stack(betas, dim=1)


def _gauss_quadrature(alphas, betas, f):
    """Per-probe Gauss quadrature ``e1' f(T) e1`` from Lanczos coefficients
    (B, steps); (B,) values for *unit-norm* starting vectors (scale by
    ||z||^2 for Hutchinson probes).  Eigenvalue floor 1e-18."""
    B, steps = alphas.shape
    T = torch.diag_embed(alphas)
    if steps > 1:
        off = betas[:, :-1]
        T = T + torch.diag_embed(off, offset=1) + torch.diag_embed(off,
                                                                   offset=-1)
    evals, evecs = torch.linalg.eigh(T)
    evals = torch.clamp(evals, min=1e-18)
    w1 = evecs[:, 0, :]
    return torch.sum(w1 ** 2 * f(evals), dim=-1)


def _rademacher(generator, probes, m, dtype, device=None):
    bits = torch.randint(0, 2, (probes, m), generator=generator,
                         device=generator.device)
    z = (bits * 2 - 1).to(device or generator.device, dtype)
    return z, torch.sqrt(torch.sum(z * z, dim=-1))


def _batched(Av: Callable) -> Callable:
    """A single-vector operator applied row by row to a (B, m) stack."""
    return lambda V: torch.stack([Av(v) for v in V])


def logdet_slq(ws, sigmasq, toeplitz, generator=None, *, probes: int = 100,
               steps: int = 25, n: int = 0) -> torch.Tensor:
    """Estimate ``log det(K_approx + sigma^2 I_n)``.

    ``ws``: (M,) quadrature weights; ``toeplitz``: the Gram operator;
    ``n``: number of data points for the ``n log sigma^2`` correction.
    The (probes, M) Rademacher probes are the next draw of ``generator``.
    """
    m = ws.shape[0]
    rdtype = ws.real.dtype
    sigmasq = torch.as_tensor(sigmasq, dtype=rdtype, device=ws.device)
    z, znorm = _rademacher(_generator(generator), probes, m, rdtype,
                           ws.device)
    q0 = (z / znorm[:, None]).to(ws.dtype)

    def Av(v):
        return v + (ws * toeplitz(ws * v)) / sigmasq.to(v.dtype)

    alphas, betas = lanczos_tridiag(Av, q0, steps)
    quad = _gauss_quadrature(alphas, betas, torch.log) * znorm ** 2
    return torch.mean(quad) + n * torch.log(sigmasq)


def slq_trace_f(Av: Callable, generator, m: int, *, probes: int = 8,
                steps: int = 20, f: Callable = lambda x: 1.0 / x,
                dtype=torch.float32, batched: bool = False) -> torch.Tensor:
    """Hutchinson + Lanczos estimate of ``tr(f(A))`` for SPD ``A``.

    ``Av`` maps a single (m,) vector; pass ``batched=True`` if it already
    maps (B, m) stacks.  Default ``f = 1/x`` estimates ``tr(A^{-1})``."""
    Avb = Av if batched else _batched(Av)
    z, znorm = _rademacher(_generator(generator), probes, m, dtype)
    q0 = z / znorm[:, None]
    alphas, betas = lanczos_tridiag(Avb, q0, steps)
    return torch.mean(_gauss_quadrature(alphas, betas, f) * znorm ** 2)


def power_iteration(Av: Callable, generator, m: int, *, iters: int = 8,
                    dtype=torch.float32) -> torch.Tensor:
    """Operator-norm estimate by power iteration from a normal start."""
    gen = _generator(generator)
    x = torch.randn((m,), generator=gen, dtype=dtype, device=gen.device)
    x = x / torch.linalg.norm(x)
    for _ in range(iters):
        y = Av(x)
        ny = torch.linalg.norm(y)
        x = y / torch.where(ny == 0, torch.ones_like(ny), ny)
    return torch.linalg.norm(Av(x))


def trace_ainv_b_fd(A_apply: Callable, B_apply: Callable, generator, m: int,
                    *, probes: int = 8, steps: int = 20, c: float = 5.0,
                    max_halves: int = 8, dtype=torch.float32,
                    batched: bool = False):
    """Estimate ``tr(A^{-1} B)`` for SPD ``A``, symmetric ``B``, matvecs only.

    Central finite difference of two SLQ log-dets sharing the same
    Rademacher probes (``tr(A^{-1}B) = d/dh log det(A+hB)``), with the step
    ``h = c sqrt(eps) ||A|| / ||B||`` halved (up to ``max_halves`` times)
    until ``A +- hB`` pass a two-probe Rayleigh SPD check.  ``generator``
    gives, in this order, the two power-iteration starts (A, then B), the
    two Rayleigh vectors and the SLQ probes.  ``A_apply``/``B_apply`` map
    single (m,) vectors unless ``batched=True``.

    Returns ``(estimate, h)``.
    """
    gen = _generator(generator)
    if batched:
        A1 = lambda v: A_apply(v[None, :])[0]                 # noqa: E731
        B1 = lambda v: B_apply(v[None, :])[0]                 # noqa: E731
    else:
        A1, B1 = A_apply, B_apply
        A_apply, B_apply = _batched(A_apply), _batched(B_apply)
    A_norm = power_iteration(A1, gen, m, dtype=dtype)
    B_norm = power_iteration(B1, gen, m, dtype=dtype)
    eps = torch.finfo(dtype).eps
    h = c * math.sqrt(eps) * A_norm / torch.where(
        B_norm == 0, torch.ones_like(B_norm), B_norm)

    r = torch.randn((2, m), generator=gen, dtype=dtype, device=gen.device)
    r = r / torch.linalg.norm(r, dim=-1, keepdim=True)
    # h-independent Rayleigh quotients: 2+2 matvecs once, not per halving
    quad_a = torch.sum(r * A_apply(r), dim=-1)
    quad_b = torch.sum(r * B_apply(r), dim=-1)
    for _ in range(max_halves):
        if bool(torch.all(quad_a + h * quad_b > 0)
                & torch.all(quad_a - h * quad_b > 0)):
            break
        h = h * 0.5

    z, znorm = _rademacher(gen, probes, m, dtype)
    q0 = z / znorm[:, None]

    def logdet(sign):
        def Av(v):
            return A_apply(v) + sign * h * B_apply(v)
        alphas, betas = lanczos_tridiag(Av, q0, steps)
        return torch.mean(_gauss_quadrature(alphas, betas, torch.log)
                          * znorm ** 2)

    return (logdet(1.0) - logdet(-1.0)) / (2.0 * h), h
