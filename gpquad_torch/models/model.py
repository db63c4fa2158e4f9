"""The EFGP model facade; port of ``gpquad/models/model.py`` (``EFGP``).

A stateful wrapper over the functional path: ``predict``,
``compute_gradients``, ``optimize_hyperparameters``, ``sample_posterior``
and ``log_marginal``, a fit cached under a fingerprint of the hypers, CG
warm starts, and an options dict with gpquad's keys.

The hypers live in a :class:`~gpquad_torch.kernels.HyperState` (log space,
float64) on the data's device.  Every gradient step runs on a bucketed grid
(``quadrature.bucket_mtot``) whose rung only grows over the model's life;
the surplus nodes carry exactly zero weight (``flat_grid_mask``), so a
padded step equals the tight one.  ``torch.optim.Adam`` (the defaults of
``optax.adam``: betas 0.9 / 0.999, eps 1e-8) replaces optax, and a
``torch.Generator`` replaces the key: every stochastic estimator draws from
``self.generator`` unless the call passes its own.

Per Adam iteration the host reads the hypers once, to plan the grid (float64
bisection on the host); the gradients, iteration counts and hypers of the
history stay on the device until the loop ends and are read in bulk.

``opts["nufft_method"]`` picks the fit's and the gradient's NUFFT backend
(``"auto"``, ``"matmul"``, ``"spread"``, ``"banded"`` or ``"sub"``); for
``"banded"`` each grid's band caps are planned on the host from a copy of
the points made once (``plan_nufft_caps``).  Predictions serve on the exact
default after a spreading fit, as gpquad's do.
"""
from __future__ import annotations

import math
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..kernels import HyperState, make_kernel
from ..ops.slq import logdet_slq
from ..quadrature import bucket_mtot, flat_grid_mask, grid_geometry, \
    spectral_grid
from .efgp import (FitState, _as_points, fit_with_grid, plan_nufft_caps,
                   predict_mean, predict_var, resolve_device, serving_method)
from .gradient import gradient_with_grid

__all__ = ["EFGP"]


class EFGP:
    """Equispaced-Fourier GP regression in d dimensions.

    ``kernel`` is a kernel object or a name ("SquaredExponential", "SE");
    with ``estimate_params=True`` the hypers start from the median-distance
    heuristic.  ``nufft_eps`` is accepted for the reference signature and
    ignored: the NUFFT applies are exact.  ``generator`` (default: a
    generator on ``device`` seeded 0) feeds every stochastic estimator.
    """

    def __init__(self, x, y, kernel, sigmasq: Optional[float] = None,
                 eps: float = 1e-2, nufft_eps: Optional[float] = None,
                 opts: Optional[Dict] = None, estimate_params: bool = True,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        dev = resolve_device(device)
        self.x = _as_points(x, dev)
        self.y = torch.as_tensor(y, device=dev)
        self.eps = eps
        self.opts = {} if opts is None else dict(opts)
        self.generator = (generator if generator is not None
                          else torch.Generator(device=dev).manual_seed(0))
        d = self.x.shape[1]
        span = (self.x.max(dim=0).values - self.x.min(dim=0).values).max()
        self._L = float(span) if float(span) > 1e-9 else 1.0

        kernel = make_kernel(kernel, dimension=d)
        if estimate_params:
            ell, var, noise = kernel.estimate_hyperparameters(self.x, self.y)
            kernel = kernel.with_hypers(torch.stack([ell.double(),
                                                     var.double()]))
            if sigmasq is None:
                sigmasq = noise
        if sigmasq is None:
            sigmasq = 0.1
        self._template = kernel
        params = HyperState.create(kernel, sigmasq)
        self.params = params.replace_raw(params.raw.to(dev))

        self._state: Optional[FitState] = None
        self._fitted_raw = None
        self._last_gradient_beta = None
        self._mtot_floor = 0
        self._x_host = None
        self.last_gradient_stats: Dict = {}
        self.training_log: Dict = {}

    # ------------------------------------------------------------------
    @property
    def kernel(self):
        """Kernel carrying the current hyper values."""
        return self.params.kernel_of(self._template)

    @property
    def sigmasq(self):
        return self.params.sig2

    @property
    def device(self) -> torch.device:
        return self.x.device

    def _opt(self, name, default):
        return self.opts.get(name, default)

    def _params_changed(self) -> bool:
        """Fingerprint check: any hyper moved by more than 1e-8 in positive
        space since the cached fit."""
        if self._fitted_raw is None:
            return True
        raw = self.params.raw.detach().cpu().numpy()
        return bool(np.max(np.abs(np.exp(raw) - np.exp(self._fitted_raw)))
                    > 1e-8)

    def _domain_length(self) -> float:
        return self._L

    @property
    def state(self) -> FitState:
        """The cached ``FitState`` (fits first if needed)."""
        self.fit()
        return self._state

    def _nufft_caps(self, h, mtot: int):
        """The banded backend's band caps for a grid of ``mtot`` (None for
        the other backends)."""
        if self._opt("nufft_method", "auto") != "banded":
            return None
        if self._x_host is None:
            self._x_host = self.x.cpu().numpy()
        return plan_nufft_caps(self._x_host, h, mtot)

    def _warm_beta(self, beta, mtot: int):
        """``beta`` as a CG warm start on a grid of ``mtot``, if the option
        allows it and the sizes agree."""
        if self._opt("mean_cg_warm_start", True) and beta is not None \
                and beta.shape[0] == mtot ** self.x.shape[1]:
            return beta
        return None

    # ------------------------------------------------------------------
    def fit(self, force_recompute: bool = False) -> "EFGP":
        """Compute and cache the mean solve for the current hypers."""
        if self._state is not None and not force_recompute \
                and not self._params_changed():
            return self
        kernel = self.kernel
        _, h, mtot = spectral_grid(kernel, self.eps, self._domain_length())
        beta0 = self._warm_beta(
            None if self._state is None else self._state.beta, mtot)
        self._state = fit_with_grid(
            self.x, self.y, kernel, self.sigmasq, h, mtot,
            cg_tol=self._opt("cg_tolerance", 1e-4),
            max_cg_iter=self._opt("max_cg_iterations", None),
            beta0=beta0,
            use_precond=self._opt("mean_cg_preconditioner", True),
            nufft_method=self._opt("nufft_method", "auto"),
            nufft_caps=self._nufft_caps(h, mtot),
            solver=self._opt("solver", "auto"),
            precond_rank=self._opt("precond_rank", 0),
            precond=self._opt("precond", "auto"), device=self.device)
        self._fitted_raw = self.params.raw.detach().cpu().numpy().copy()
        return self

    def predict(self, x_new, *, return_variance: bool = True,
                variance_method: str = "stochastic",
                hutchinson_probes: int = 1000,
                compute_log_marginal: bool = False,
                force_recompute: bool = False,
                generator: Optional[torch.Generator] = None):
        """Posterior mean (and variance, and the log marginal) at ``x_new``:
        ``(mean, var)`` with ``var`` None when ``return_variance=False``,
        plus the log marginal when ``compute_log_marginal=True``."""
        x_new = _as_points(x_new, self.device)
        self.fit(force_recompute=force_recompute)
        st = self._state
        method = self._opt("nufft_method", "auto")
        mean = predict_mean(st, x_new, nufft_method=serving_method(method))
        var = None
        if return_variance:
            var = predict_var(
                st, x_new, method=variance_method,
                generator=generator if generator is not None
                else self.generator,
                probes=hutchinson_probes,
                cg_tol=self._opt("cg_tolerance", 1e-4),
                max_cg_iter=self._opt("max_cg_iterations", 1000),
                nufft_method=method)
        if compute_log_marginal:
            return mean, var, self.log_marginal()
        return mean, var

    def log_marginal(self, generator: Optional[torch.Generator] = None):
        """SLQ log marginal of the fitted model:
        ``-0.5 (y.alpha + logdet C + n log 2 pi)``, ``alpha = C^-1 y =
        (y - F D beta) / sigma^2``."""
        self.fit()
        st = self._state
        n = self.x.shape[0]
        log_det = logdet_slq(
            st.ws, st.sigmasq, st.toeplitz,
            generator if generator is not None else self.generator,
            probes=self._opt("log_marginal_probes", 100),
            steps=self._opt("log_marginal_steps", 25), n=n)
        yhat = predict_mean(st, self.x, nufft_method=serving_method(
            self._opt("nufft_method", "auto")))
        y = self.y.to(yhat.dtype)
        data_fit = torch.sum(y * (y - yhat)) / st.sigmasq
        return -0.5 * (data_fit + log_det + n * math.log(2 * math.pi))

    # ------------------------------------------------------------------
    def _grid_plan(self, bucket: bool):
        """``(h, mtot, hm)`` for the current hypers (one host read of them).

        Bucketed plans are grow-only over the model's life: a larger rung
        with the planned ``hm`` masked in is algebraically the same grid,
        so a trajectory whose lengthscale grows keeps its rung."""
        h, hm_real = grid_geometry(self.kernel, self.eps,
                                   self._domain_length())
        hm = int(math.ceil(float(hm_real) - 1e-12))
        mtot = 2 * hm + 1
        if bucket:
            mtot = max(bucket_mtot(mtot), self._mtot_floor)
            self._mtot_floor = mtot
        return float(h), mtot, hm

    def _gradient_options(self, **overrides):
        """The options dict's settings for ``gradient_with_grid``."""
        gw = dict(use_mean_precond=self._opt("mean_cg_preconditioner", True),
                  use_trace_precond=self._opt("trace_cg_preconditioner",
                                              True),
                  nufft_method=self._opt("nufft_method", "auto"),
                  solver=self._opt("solver", "auto"),
                  precond_rank=self._opt("precond_rank", 0),
                  precond=self._opt("precond", "auto"))
        gw.update(overrides)
        return gw

    def compute_gradients(self, *, trace_samples: int = 10,
                          cg_tol: Optional[float] = None,
                          noise_floor: Optional[float] = None,
                          compute_log_marginal: bool = False,
                          log_marginal_probes: int = 100,
                          log_marginal_steps: int = 25,
                          bucket_grid: bool = True,
                          generator: Optional[torch.Generator] = None,
                          probes=None):
        """Gradient of the negative log marginal with respect to the
        log-space hypers (``grad_raw = grad_pos * pos``); returns
        ``grad_raw`` or ``(grad_raw, log_marginal)`` and updates
        ``last_gradient_stats``."""
        if cg_tol is None:
            cg_tol = self._opt("gradient_cg_tolerance", 0.1 * self.eps)
        if noise_floor is None:
            noise_floor = self._opt("noise_floor", None)
        h, mtot, hm = self._grid_plan(bucket_grid)
        d = self.x.shape[1]
        ws_mask = (flat_grid_mask(mtot, d, hm, dtype=self.x.dtype,
                                  device=self.device)
                   if bucket_grid else None)
        beta0 = self._warm_beta(self._last_gradient_beta, mtot)
        res = gradient_with_grid(
            self.x, self.y, self.kernel, self.sigmasq, h,
            generator if generator is not None else self.generator,
            mtot=mtot, trace_samples=trace_samples, cg_tol=cg_tol,
            noise_floor=noise_floor, beta0=beta0, ws_mask=ws_mask,
            probes=probes, compute_log_marginal=compute_log_marginal,
            log_marginal_probes=log_marginal_probes,
            log_marginal_steps=log_marginal_steps, device=self.device,
            nufft_caps=self._nufft_caps(h, mtot), **self._gradient_options())
        self._last_gradient_beta = res.beta
        self.last_gradient_stats = {
            "mean_cg_iters": int(res.mean_cg_iters),
            "trace_cg_iters": int(res.trace_cg_iters),
            "feature_count": mtot ** d,
            "mtot": mtot,
            "trace_samples": trace_samples,
            "mean_cg_warm_start_used": beta0 is not None,
            "mean_cg_preconditioned": self._opt("mean_cg_preconditioner",
                                                True),
            "trace_cg_preconditioned": self._opt("trace_cg_preconditioner",
                                                 True),
        }
        grad_raw = res.grad * self.params.pos
        if compute_log_marginal:
            return grad_raw, res.log_marginal
        return grad_raw

    def optimize_hyperparameters(self, *, optimizer="adam", lr: float = 0.1,
                                 max_iters: int = 50,
                                 min_lengthscale: float = 5e-3,
                                 log_interval: int = 10,
                                 compute_log_marginal: bool = False,
                                 verbose: bool = False,
                                 trace_samples: int = 10,
                                 generator: Optional[torch.Generator] = None,
                                 **gkwargs) -> "EFGP":
        """Adam on the log-space hypers with the min-lengthscale clamp
        after each step; then a refit at the learned hypers.

        ``optimizer`` is "adam" or a callable that takes the parameter
        list and returns a ``torch.optim.Optimizer``.  ``gkwargs`` go to
        ``gradient_with_grid`` (``cg_tol`` and ``noise_floor`` default to
        the options dict's ``gradient_cg_tolerance`` and ``noise_floor``),
        e.g. fixed ``probes=(Z, V)``.  The history (``training_log``) has
        the positive-space hypers, gradients and CG iterations of every
        iteration, read from the device once the loop ends."""
        raw = self.params.raw.detach().clone()
        if isinstance(optimizer, str):
            if optimizer.lower() != "adam":
                raise ValueError(f"Unsupported optimizer string: {optimizer}")
            opt = torch.optim.Adam([raw], lr=lr)
        else:
            opt = optimizer([raw])
        if generator is not None:
            self.generator = generator
        ls_idx = (self.params.names.index("lengthscale")
                  if "lengthscale" in self.params.names else None)
        log_min_ls = math.log(min_lengthscale)

        def step(grad_raw):
            raw.grad = grad_raw.to(raw.dtype)
            opt.step()
            with torch.no_grad():
                if ls_idx is not None:
                    raw[ls_idx] = torch.clamp(raw[ls_idx], min=log_min_ls)
            self.params = self.params.replace_raw(raw.detach().clone())

        cg_tol = gkwargs.pop("cg_tol", None)
        if cg_tol is None:
            cg_tol = self._opt("gradient_cg_tolerance", 0.1 * self.eps)
        noise_floor = gkwargs.pop("noise_floor", self._opt("noise_floor",
                                                           None))
        gw = self._gradient_options(trace_samples=trace_samples,
                                    cg_tol=cg_tol, noise_floor=noise_floor,
                                    **gkwargs)
        template = self._template
        rdtype = self.x.dtype
        d = self.x.shape[1]

        history: Dict = {"log_marginal": [], "gradients": [],
                         "mean_cg_iters": [], "trace_cg_iters": [],
                         "sigmasq": []}
        for name in self.params.names:
            history[name] = []
        raw_hist, grad_hist, mit_hist, tit_hist = [], [], [], []
        start = time.time()
        for it in range(max_iters):
            raw_hist.append(self.params.raw)
            if compute_log_marginal and (it % log_interval == 0
                                         or it == max_iters - 1):
                # the log marginal takes the unfused estimator
                grad_raw, lm = self.compute_gradients(
                    trace_samples=trace_samples, cg_tol=cg_tol,
                    noise_floor=noise_floor, compute_log_marginal=True,
                    **gkwargs)
                history["log_marginal"].append(float(lm))
                self._last_mtot = self.last_gradient_stats["mtot"]
                mit = torch.as_tensor(
                    self.last_gradient_stats["mean_cg_iters"])
                tit = torch.as_tensor(
                    self.last_gradient_stats["trace_cg_iters"])
            else:
                h, mtot, hm = self._grid_plan(True)
                ws_mask = flat_grid_mask(mtot, d, hm, dtype=rdtype,
                                         device=self.device)
                pos = torch.exp(self.params.raw)
                kern = template.with_hypers(pos[:-1].to(rdtype))
                res = gradient_with_grid(
                    self.x, self.y, kern, pos[-1].to(rdtype), h,
                    self.generator, mtot=mtot,
                    beta0=self._warm_beta(self._last_gradient_beta, mtot),
                    ws_mask=ws_mask, device=self.device,
                    nufft_caps=self._nufft_caps(h, mtot), **gw)
                grad_raw = res.grad.to(raw.dtype) * pos
                self._last_gradient_beta = res.beta
                self._last_mtot = mtot
                mit, tit = res.mean_cg_iters, res.trace_cg_iters
            grad_hist.append(grad_raw)
            mit_hist.append(mit)
            tit_hist.append(tit)
            step(grad_raw)
            if verbose and (it % log_interval == 0 or it == max_iters - 1):
                print(f"iter {it}/{max_iters}: raw="
                      f"{self.params.raw.cpu().numpy()}")

        if raw_hist:
            # bulk history read: four device-to-host copies in all
            pos_hist = torch.exp(torch.stack(raw_hist)).cpu().numpy()
            grads = torch.stack(grad_hist).cpu().numpy()
            mits = torch.stack([t.cpu() for t in mit_hist]).numpy()
            tits = torch.stack([t.cpu() for t in tit_hist]).numpy()
            for i, name in enumerate(self.params.names):
                history[name] = [float(v) for v in pos_hist[:, i]]
            history["sigmasq"] = [float(v) for v in pos_hist[:, -1]]
            history["gradients"] = [g.tolist() for g in grads]
            history["mean_cg_iters"] = [int(v) for v in mits]
            history["trace_cg_iters"] = [int(v) for v in tits]
            self.last_gradient_stats = {
                "mean_cg_iters": int(mits[-1]),
                "trace_cg_iters": int(tits[-1]),
                "feature_count": int(getattr(self, "_last_mtot", 0)) ** d,
                "mtot": int(getattr(self, "_last_mtot", 0)),
                "trace_samples": trace_samples,
                "mean_cg_warm_start_used":
                    self._last_gradient_beta is not None,
                "mean_cg_preconditioned": gw["use_mean_precond"],
                "trace_cg_preconditioned": gw["use_trace_precond"],
            }

        # final refit at the learned hypers
        self.fit(force_recompute=True)
        self.training_log = history
        if verbose:
            print(f"Optimization complete after {time.time() - start:.2f}s")
        return self

    # ------------------------------------------------------------------
    def sample_posterior(self, x_new, nsamples: int,
                         generator: Optional[torch.Generator] = None):
        """Dense-Cholesky posterior samples at ``x_new``, (nnew, nsamples)
        numpy; O(nnew^2 n), an oracle path."""
        x_new = _as_points(x_new, self.device)
        kernel = self.kernel
        n = self.x.shape[0]
        Kso = kernel.kernel_matrix(x_new, self.x)
        Koo = kernel.kernel_matrix(self.x, self.x) + self.sigmasq.to(
            Kso.dtype) * torch.eye(n, dtype=Kso.dtype, device=self.device)
        Kss = kernel.kernel_matrix(x_new, x_new)
        cov = Kss - Kso @ torch.linalg.solve(Koo, Kso.T)
        cov = cov + 1e-10 * torch.eye(x_new.shape[0], dtype=cov.dtype,
                                      device=self.device)
        L = torch.linalg.cholesky(cov)
        gen = generator if generator is not None else self.generator
        z = torch.randn((x_new.shape[0], nsamples), generator=gen,
                        dtype=cov.dtype, device=gen.device).to(self.device)
        mean, _ = self.predict(x_new, return_variance=False)
        return (mean.to(cov.dtype)[:, None] + L @ z).cpu().numpy()
