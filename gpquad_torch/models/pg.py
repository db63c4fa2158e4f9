"""Polya-Gamma GP estimators; port of ``gpquad/models/pg.py``.

``PolyagammaGPClassifier`` (Bernoulli likelihood, logistic link) and
``PolyagammaGPNegativeBinomialRegressor`` (negative-binomial counts, with
optional Gauss-Hermite learning of the total count), with gpquad's
estimator API (``fit``, ``predict``, ``predict_proba``,
``decision_function``, ``predictive_variance``, ``predict_response_mean``,
``predict_latent_high``) and fitted attributes (``delta_``,
``posterior_mean_``, ``beta_mean_``, ``history_``, ...).  Each outer
iteration rebuilds the spectral state (the lengthscale moved), runs the
damped PG E-step and the stochastic M-step, and takes one Adam step on
``log(lengthscale, variance)`` (``torch.optim.Adam`` with ``optax.adam``'s
defaults: betas 0.9 / 0.999, eps 1e-8).

The estimators stand alone: their own ``get_params`` / ``set_params`` from
the ``__init__`` signatures, numpy input checks, and no sklearn or optax.
``device`` (default ``"cuda"``) is where the fit runs; it raises without a
card.

Differences from gpquad, none of which changes a result:

- **No n-bucketing.** gpquad pads the training points to a 1-2-5 rung so
  that XLA compiles its fused step once per rung; the pad carries exactly
  zero Delta, kappa and probes, so the algebra is that of the unpadded
  points.  There is no compile to cache here, and the pad would add up to
  150% to every NUFFT's points, so the port fits the points as given.
- **``prefetch_rungs``** warmed XLA compiles of neighbouring grid rungs on
  threads; it is accepted and has no effect.
- **Probes** come from :meth:`_draw_probes` (salted per use as gpquad's
  keys are: 17 (outer + 1) for the E-step, 10 000 + outer for the M-step,
  999 999 for a final E-step without a loop, 2 000 000 for the stochastic
  variance), a ``torch.Generator`` seeded from ``random_state`` and the
  salt.

Per outer iteration the host reads the hypers once, to plan the grid
(float64 bisection on the host, as gpquad); the records of the history stay
on the device until the loop ends and are read in one batch.
"""
from __future__ import annotations

import inspect
import math
from typing import Dict, List

import numpy as np
import torch

from ..kernels import SquaredExponential, make_kernel
from ..quadrature import bucket_mtot, flat_grid_mask, grid_geometry
from . import pg_core as core
from .efgp import _cdtype, resolve_device

__all__ = ["PolyagammaGPClassifier", "PolyagammaGPNegativeBinomialRegressor",
           "NotFittedError"]


class NotFittedError(ValueError, AttributeError):
    """An estimator was used before ``fit``."""


# ---------------------------------------------------------------------------
# numpy input checks (sklearn's check_X_y / check_array / check_is_fitted)
# ---------------------------------------------------------------------------

def _check_array(X, name="X"):
    X = np.asarray(X, dtype=np.float64)
    if X.ndim != 2:
        raise ValueError(f"Expected a 2D array for {name}, got a {X.ndim}D "
                         "array; reshape with X.reshape(-1, 1) for a single "
                         "feature.")
    if X.shape[0] < 1 or X.shape[1] < 1:
        raise ValueError(f"{name} has shape {X.shape}: at least one sample "
                         "and one feature are required.")
    if not np.all(np.isfinite(X)):
        raise ValueError(f"{name} contains NaN or infinity.")
    return X


def _check_X_y(X, y):
    X = _check_array(X)
    y = np.asarray(y)
    if y.ndim == 2 and y.shape[1] == 1:
        y = y[:, 0]
    if y.ndim != 1:
        raise ValueError(f"y must be 1D, got shape {y.shape}.")
    if y.shape[0] != X.shape[0]:
        raise ValueError(f"X and y have inconsistent numbers of samples: "
                         f"{X.shape[0]} and {y.shape[0]}.")
    if y.dtype.kind in "fc" and not np.all(np.isfinite(y)):
        raise ValueError("y contains NaN or infinity.")
    return X, y


def _check_is_fitted(est, attrs):
    if not all(hasattr(est, a) for a in attrs):
        raise NotFittedError(
            f"This {type(est).__name__} instance is not fitted yet. Call "
            "'fit' with appropriate arguments before using this estimator.")


# ---------------------------------------------------------------------------
# likelihoods
# ---------------------------------------------------------------------------

class _BernoulliLikelihood:
    history_key = "approx_accuracy"
    training_attr = "training_accuracy_"

    def prepare_targets(self, y):
        classes = np.unique(y)
        if classes.size != 2:
            raise ValueError(
                "PolyagammaGPClassifier only supports binary classification.")
        return (y == classes[1]).astype(np.float64), {"classes_": classes}

    def kappa(self, t):
        return t - 0.5

    def pg_b(self, t):
        return torch.ones_like(t)

    def response_mean(self, mean, variance):
        return core.approximate_logistic_gaussian_prob(mean, variance)

    def fit_metric(self, mean, variance, targets):
        """Training accuracy, a 0-d tensor on the device."""
        pred = self.response_mean(mean, variance) > 0.5
        return torch.mean((pred == (targets > 0.5)).to(torch.float32))


class _NegativeBinomialLikelihood:
    history_key = "mean_count_mae"
    training_attr = "training_mean_absolute_error_"

    def __init__(self, total_count: float):
        if total_count <= 0:
            raise ValueError("total_count must be positive.")
        self.total_count = total_count

    def prepare_targets(self, y):
        y = np.asarray(y, dtype=np.float64)
        if np.any(y < 0):
            raise ValueError("Negative binomial targets must be nonnegative.")
        if not np.allclose(y, np.round(y)):
            raise ValueError(
                "Negative binomial targets must be integer-valued.")
        return np.round(y).astype(np.float64), {}

    def kappa(self, t):
        return 0.5 * (t - self.total_count)

    def pg_b(self, t):
        return t + self.total_count

    def response_mean(self, mean, variance):
        return core.negative_binomial_gaussian_mean(
            mean, variance, total_count=self.total_count)

    def fit_metric(self, mean, variance, targets):
        """Mean absolute error of the mean count, a 0-d tensor."""
        return torch.mean(torch.abs(self.response_mean(mean, variance)
                                    - targets))


# ---------------------------------------------------------------------------
# estimators
# ---------------------------------------------------------------------------

class _BasePolyagammaGPEstimator:
    """Shared PG estimator implementation."""

    def __init__(self, *, kernel="squared_exponential",
                 lengthscale_init=0.3, variance_init=1.0, max_iter=50,
                 e_step_iters=1, final_e_step_iters=1, e_step_tol=1e-4,
                 rho0=0.7, gamma=1e-3, lr=0.05, n_e_probes=10, n_m_probes=10,
                 cg_tol=1e-6, nufft_eps=None, spectral_eps=1e-4,
                 trunc_eps=1e-4, jitter=1e-8,
                 use_exact_weighted_toeplitz_operator=True, device="cuda",
                 reuse_e_probes=True,
                 prediction_batch_size=64,
                 prediction_solver="auto",
                 predictive_variance_method="exact",
                 predictive_variance_probes=16,
                 predictive_variance_chebyshev_nodes=7, warm_start=False,
                 random_state=None, dtype="float32", verbose=0,
                 store_history=False, prefetch_rungs=False):
        self.kernel = kernel
        self.lengthscale_init = lengthscale_init
        self.variance_init = variance_init
        self.max_iter = max_iter
        self.e_step_iters = e_step_iters
        self.final_e_step_iters = final_e_step_iters
        self.e_step_tol = e_step_tol
        self.rho0 = rho0
        self.gamma = gamma
        self.lr = lr
        self.n_e_probes = n_e_probes
        self.n_m_probes = n_m_probes
        self.cg_tol = cg_tol
        # accepted for the reference signature: the NUFFT is exact
        # (nufft_eps), the weighted Toeplitz operator is always the exact
        # one, and the estimator never reads jitter
        self.nufft_eps = nufft_eps
        self.use_exact_weighted_toeplitz_operator = \
            use_exact_weighted_toeplitz_operator
        self.device = device
        self.spectral_eps = spectral_eps
        self.trunc_eps = trunc_eps
        self.jitter = jitter
        self.reuse_e_probes = reuse_e_probes
        self.prediction_batch_size = prediction_batch_size
        self.prediction_solver = prediction_solver
        self.predictive_variance_method = predictive_variance_method
        self.predictive_variance_probes = predictive_variance_probes
        self.predictive_variance_chebyshev_nodes = \
            predictive_variance_chebyshev_nodes
        self.warm_start = warm_start
        self.random_state = random_state
        self.dtype = dtype
        self.verbose = verbose
        self.store_history = store_history
        # gpquad warms XLA compiles of neighbouring rungs on threads; there
        # is nothing to warm here, and the option has no effect
        self.prefetch_rungs = prefetch_rungs

    # -- parameters (sklearn's BaseEstimator protocol) ---------------------
    @classmethod
    def _get_param_names(cls):
        """The keyword parameters of ``__init__`` along the class chain: a
        subclass whose ``__init__`` takes ``**kwargs`` passes them on to its
        base."""
        names = []
        for klass in cls.__mro__:
            init = klass.__dict__.get("__init__")
            if init is None:
                continue
            params = inspect.signature(init).parameters.values()
            for p in params:
                if p.name != "self" and p.kind in (p.KEYWORD_ONLY,
                                                   p.POSITIONAL_OR_KEYWORD):
                    names.append(p.name)
            if not any(p.kind == p.VAR_KEYWORD for p in params):
                break
        return sorted(set(names))

    def get_params(self, deep=True):
        return {name: getattr(self, name) for name in self._get_param_names()}

    def set_params(self, **params):
        valid = self._get_param_names()
        for key, value in params.items():
            if key not in valid:
                raise ValueError(f"Invalid parameter {key!r} for estimator "
                                 f"{type(self).__name__}. Valid parameters "
                                 f"are: {valid!r}.")
            setattr(self, key, value)
        return self

    def __repr__(self):
        args = ", ".join(f"{k}={v!r}" for k, v in self.get_params().items())
        return f"{type(self).__name__}({args})"

    # ------------------------------------------------------------------
    def _make_likelihood(self):
        raise NotImplementedError

    def _rdtype(self):
        return torch.float64 if str(self.dtype) == "float64" else \
            torch.float32

    def _dev(self):
        return resolve_device(self.device)

    def _draw_probes(self, salt: int, shape):
        """Rademacher probes of ``shape`` in the fit's dtype on its device:
        a ``torch.Generator`` on the device seeded from ``random_state``
        (0 when None) and ``salt``."""
        dev = self._dev()
        seed = 0 if self.random_state is None else int(self.random_state)
        gen = torch.Generator(device=dev).manual_seed(
            (seed * 1_000_003 + int(salt)) % (2 ** 63))
        bits = torch.randint(0, 2, tuple(shape), generator=gen, device=dev)
        return (bits * 2 - 1).to(self._rdtype())

    def _make_kernel_obj(self, lengthscale, variance, d):
        """SE for "squared_exponential" / "se" / "rbf", else any name of
        ``make_kernel`` (the Matérn variants): the E and M passes see only
        the quadrature weights and their derivatives."""
        name = str(self.kernel).lower()
        hyp = torch.tensor([float(lengthscale), float(variance)],
                           dtype=self._rdtype())
        if name in {"squared_exponential", "se", "rbf"}:
            return SquaredExponential(lengthscale=hyp[0], variance=hyp[1],
                                      dimension=d)
        try:
            kern = make_kernel(self.kernel, dimension=d)
        except ValueError as e:
            raise ValueError(
                f"Unknown kernel {self.kernel!r} for the PG estimator "
                "(use 'squared_exponential' or a Matern variant).") from e
        return kern.with_hypers(hyp)

    @staticmethod
    def _domain_length(X) -> float:
        """The widest side of the points' box (1 where they coincide), in
        the points' dtype as gpquad takes it."""
        X = X if torch.is_tensor(X) else torch.as_tensor(np.asarray(X))
        L = float(torch.max(X.max(0).values - X.min(0).values))
        return 1.0 if L <= 1e-9 else L

    def _plan_grid(self, X, lengthscale, variance, min_mtot: int = 0, *,
                   L=None):
        """Host grid plan ``(kernel, h, mtot, mask, hm)``: gpquad's plan,
        the rung of ``bucket_mtot`` with the planned ``hm`` masked in.

        ``min_mtot`` is the grow-only rung hysteresis of a fit: a larger
        rung with ``hm`` masked in is the planned grid algebraically, and
        since the rung sets ``mtot``, and so the result, the port keeps
        gpquad's rule.  ``L`` (default: from ``X``) is the domain side."""
        d = X.shape[1]
        kern = self._make_kernel_obj(lengthscale, variance, d)
        if L is None:
            L = self._domain_length(X)
        h, hm_real = grid_geometry(kern, self.spectral_eps, L,
                                   trunc_eps=self.trunc_eps)
        hm = int(math.ceil(float(hm_real) - 1e-12))
        mtot = max(bucket_mtot(2 * hm + 1), int(min_mtot))
        dev = X.device if torch.is_tensor(X) else self._dev()
        mask = flat_grid_mask(mtot, d, hm, dtype=self._rdtype(), device=dev)
        return kern, float(h), mtot, mask, hm

    def _spectral(self, X, lengthscale, variance, min_mtot: int = 0, *,
                  L=None):
        kern, h, mtot, mask, hm = self._plan_grid(X, lengthscale, variance,
                                                  min_mtot=min_mtot, L=L)
        self._hm_ = hm       # active-node half-width; the high leg masks to it
        return core.build_pg_spectral_state(X, kern, h, mtot=mtot,
                                            ws_mask=mask)

    # ------------------------------------------------------------------
    def _initialize_likelihood_state(self, y_t):
        return None

    def _step_auxiliary_parameters(self, *, targets, outer) -> Dict:
        return {}

    def _history_parameter_record(self) -> Dict:
        return {}

    def fit(self, X, y):
        X_arr, y_arr = _check_X_y(X, y)
        likelihood = self._make_likelihood()
        y_model, meta = likelihood.prepare_targets(y_arr)
        for k, v in meta.items():
            setattr(self, k, v)

        dev = self._dev()
        rd = self._rdtype()
        self.n_features_in_ = X_arr.shape[1]
        self._X_train_np_ = X_arr.copy()
        X_t = torch.as_tensor(X_arr, dtype=rd, device=dev)
        y_t = torch.as_tensor(y_model, dtype=rd, device=dev)
        n = X_t.shape[0]
        self._n_valid_ = n
        L = self._domain_length(X_arr.astype(
            np.float32 if rd == torch.float32 else np.float64))

        kp_cache: Dict = {}

        def _kappa_pgb(likelihood):
            ck = (type(likelihood).__name__,
                  getattr(likelihood, "total_count", None))
            if ck not in kp_cache:
                kp_cache[ck] = (likelihood.kappa(y_t), likelihood.pg_b(y_t))
            return kp_cache[ck]

        self._X_train_t_ = X_t
        self._initialize_likelihood_state(y_t)
        likelihood = self._make_likelihood()

        if not (self.warm_start and hasattr(self, "_delta_t_")
                and self._delta_t_.shape[0] == n):
            self._delta_t_ = 0.25 * _kappa_pgb(likelihood)[1]
            self._lengthscale_v_ = float(self.lengthscale_init)
            self._variance_v_ = float(self.variance_init)

        raw = torch.log(torch.tensor([self._lengthscale_v_,
                                      self._variance_v_], dtype=rd,
                                     device=dev))
        opt = torch.optim.Adam([raw], lr=self.lr)

        pending: List = []     # device records, read once after the loop
        e_probes = None
        ores = None
        rung_floor = 0         # grow-only rung hysteresis (see _plan_grid)

        for outer in range(self.max_iter):
            likelihood = self._make_likelihood()
            kappa, pg_b = _kappa_pgb(likelihood)
            pos = torch.exp(raw).tolist()
            kern, h, mtot, mask, _hm = self._plan_grid(
                X_t, pos[0], pos[1], min_mtot=rung_floor, L=L)
            rung_floor = max(rung_floor, mtot)
            if e_probes is None or not self.reuse_e_probes:
                e_probes = self._draw_probes(17 * (outer + 1),
                                             (self.n_e_probes, n))
            m_probes = self._draw_probes(10_000 + outer,
                                         (self.n_m_probes, n))
            ores = core.outer_step(
                X_t, kern, h, mask, self._delta_t_, kappa, pg_b, e_probes,
                m_probes, raw, opt, mtot=mtot, e_iters=self.e_step_iters,
                rho0=self.rho0, gamma=self.gamma, e_tol=self.e_step_tol,
                cg_tol=self.cg_tol)
            self._delta_t_ = ores.delta
            self._last_mean_, self._last_sigma_diag_ = ores.mean, \
                ores.sigma_diag
            aux = self._step_auxiliary_parameters(targets=y_t, outer=outer)
            if self.store_history:
                pending.append(dict(
                    iter=float(outer), raw=raw.detach().clone(),
                    grad=ores.m_grad, e_residual=ores.e_residual,
                    e_iters_used=float(ores.e_iters_used),
                    e_cg_iters=ores.e_cg_iters, m_cg_iters=ores.m_cg_iters,
                    mean=ores.mean, sigma_diag=ores.sigma_diag, aux=aux,
                    history_key=likelihood.history_key))
            if self.verbose:
                p = torch.exp(raw).tolist()
                print(f"outer {outer:3d} lengthscale={p[0]:.5f} "
                      f"variance={p[1]:.5f}")

        # every record's metric with the loop's last likelihood, as gpquad
        for rec in pending:
            rec["metric"] = likelihood.fit_metric(
                rec.pop("mean"), rec.pop("sigma_diag"), y_t)
        history = self._read_history(pending)

        pos = torch.exp(raw).tolist()
        self._lengthscale_v_ = float(pos[0])
        self._variance_v_ = float(pos[1])

        # the final spectral state, E-step and beta-mean solve
        likelihood = self._make_likelihood()
        kappa, pg_b = _kappa_pgb(likelihood)
        spectral = self._spectral(X_t, self._lengthscale_v_,
                                  self._variance_v_, min_mtot=rung_floor,
                                  L=L)
        if e_probes is None:
            e_probes = self._draw_probes(999_999, (self.n_e_probes, n))
        eres = core.estep_pass(spectral, X_t, self._delta_t_, kappa, pg_b,
                               e_probes, max_iters=self.final_e_step_iters,
                               rho0=self.rho0, gamma=self.gamma,
                               cg_tol=self.cg_tol, tol=self.e_step_tol)
        self._delta_t_ = eres.delta
        beta_mean, beta_iters = core.solve_beta_mean(
            spectral, X_t, self._delta_t_, kappa, cg_tol=self.cg_tol)

        self._spectral_state_ = spectral
        self._likelihood_ = likelihood
        self._beta_mean_t_ = beta_mean
        self._kappa_t_ = kappa           # kept for the high leg
        self._est_sums_ = None
        self._dense_system_ = None

        self.delta_ = self._delta_t_.cpu().numpy()
        self.posterior_mean_ = eres.mean.cpu().numpy()
        self.posterior_var_diag_ = eres.sigma_diag.cpu().numpy()
        self.lengthscale_ = self._lengthscale_v_
        self.variance_ = self._variance_v_
        self.n_iter_ = self.max_iter
        self.training_metric_ = float(likelihood.fit_metric(
            eres.mean, eres.sigma_diag, y_t))
        setattr(self, likelihood.training_attr, self.training_metric_)
        self.m_step_gradient_ = (ores.m_grad.cpu().numpy()
                                 if ores is not None else np.zeros(2))
        self.beta_mean_ = beta_mean.cpu().numpy().astype(np.complex128)

        self.history_ = history
        self.history_.append({
            "iter": float(self.max_iter),
            "lengthscale": self.lengthscale_,
            "variance": self.variance_,
            "e_residual": float(eres.residual),
            "e_cg_iters": float(eres.cg_iters),
            "m_cg_iters": float(beta_iters),
            likelihood.history_key: self.training_metric_,
        })
        self.history_[-1].update(self._history_parameter_record())
        return self

    @staticmethod
    def _read_history(pending) -> List[Dict]:
        """The loop's records, each key's device values stacked and read in
        one transfer."""
        if not pending:
            return []
        host = {}
        for key in ("raw", "grad", "e_residual", "e_cg_iters", "m_cg_iters",
                    "metric"):
            host[key] = torch.stack([torch.as_tensor(r[key]).to(
                torch.float64) for r in pending]).cpu().numpy()
        history = []
        for i, rec in enumerate(pending):
            pos = np.exp(host["raw"][i])
            entry = {
                "iter": rec["iter"],
                "lengthscale": float(pos[0]),
                "variance": float(pos[1]),
                "grad_lengthscale": float(host["grad"][i][0]),
                "grad_variance": float(host["grad"][i][1]),
                "e_residual": float(host["e_residual"][i]),
                "e_iters_used": rec["e_iters_used"],
                "e_cg_iters": float(host["e_cg_iters"][i]),
                "m_cg_iters": float(host["m_cg_iters"][i]),
                rec["history_key"]: float(host["metric"][i]),
            }
            entry.update(rec["aux"])
            history.append(entry)
        return history

    def _load_state(self, *, X, delta, beta_mean, lengthscale, variance, h,
                    mtot: int, hm: int, kappa, posterior_mean=None,
                    posterior_var_diag=None):
        """Make this estimator a fitted one at a given state (the fitted
        state of another implementation): the training points, the
        posterior weights ``delta`` and ``beta_mean``, the hypers, the
        grid ``(h, mtot, hm)`` and ``kappa``.  The likelihood's own fields
        (``classes_``, ``total_count``) are set by the caller."""
        dev, rd = self._dev(), self._rdtype()
        X = _check_array(X)
        self.n_features_in_ = X.shape[1]
        self._X_train_np_ = X.copy()
        self._X_train_t_ = torch.as_tensor(X, dtype=rd, device=dev)
        self._n_valid_ = X.shape[0]
        self._lengthscale_v_ = self.lengthscale_ = float(lengthscale)
        self._variance_v_ = self.variance_ = float(variance)
        kern = self._make_kernel_obj(lengthscale, variance, X.shape[1])
        mask = flat_grid_mask(mtot, X.shape[1], hm, dtype=rd, device=dev)
        self._hm_ = int(hm)
        self._spectral_state_ = core.build_pg_spectral_state(
            self._X_train_t_, kern, float(h), mtot=int(mtot), ws_mask=mask)
        self._delta_t_ = torch.as_tensor(np.asarray(delta), dtype=rd,
                                         device=dev)
        self._kappa_t_ = torch.as_tensor(np.asarray(kappa), dtype=rd,
                                         device=dev)
        self._beta_mean_t_ = torch.as_tensor(
            np.asarray(beta_mean), device=dev).to(_cdtype(rd))
        self._likelihood_ = self._make_likelihood()
        self._est_sums_ = None
        self._dense_system_ = None
        self.delta_ = np.asarray(delta, np.float64)
        self.beta_mean_ = np.asarray(beta_mean, np.complex128)
        if posterior_mean is not None:
            self.posterior_mean_ = np.asarray(posterior_mean, np.float64)
        if posterior_var_diag is not None:
            self.posterior_var_diag_ = np.asarray(posterior_var_diag,
                                                  np.float64)
        return self

    # ------------------------------------------------------------------
    def _is_training_input(self, X_arr) -> bool:
        """Whether ``X_arr`` is the training set, whose posterior moments
        the fit kept (a state loaded without them has no such shortcut)."""
        return (hasattr(self, "_X_train_np_")
                and hasattr(self, "posterior_mean_")
                and hasattr(self, "posterior_var_diag_")
                and X_arr.shape == self._X_train_np_.shape
                and np.allclose(X_arr, self._X_train_np_))

    def _variance_method(self) -> str:
        m = str(self.predictive_variance_method).lower()
        if m not in {"exact", "stochastic", "stochastic_diag_sums",
                     "chebyshev"}:
            raise ValueError(
                "predictive_variance_method must be one of {'exact', "
                "'stochastic', 'stochastic_diag_sums', 'chebyshev'}.")
        return "stochastic" if m == "stochastic_diag_sums" else m

    def _resolved_prediction_solver(self, M: int) -> str:
        s = str(self.prediction_solver).lower()
        if s not in {"auto", "dense", "cg"}:
            raise ValueError(
                "prediction_solver must be one of {'auto', 'dense', 'cg'}.")
        if s == "auto":
            return "dense" if M <= core.DENSE_SOLVER_MAX_M else "cg"
        return s

    def _get_dense_system(self):
        """The (A, inv(A), Ds) prediction system, built on first use and
        kept: ``delta`` is frozen after the fit."""
        if getattr(self, "_dense_system_", None) is None:
            self._dense_system_ = core.dense_feature_system(
                self._spectral_state_, self._X_train_t_, self._delta_t_)
        return self._dense_system_

    def _variance_off_train(self, X_t):
        method = self._variance_method()
        sp = self._spectral_state_
        if method == "exact":
            if self._resolved_prediction_solver(sp.M) == "dense":
                return core.predictive_variance_exact_dense(
                    sp, self._X_train_t_, self._delta_t_, X_t,
                    system=self._get_dense_system())
            return core.predictive_variance_exact_batched(
                sp, self._X_train_t_, self._delta_t_, X_t,
                batch_size=self.prediction_batch_size, cg_tol=self.cg_tol)
        if method == "stochastic":
            if self.predictive_variance_probes <= 0:
                raise ValueError(
                    "predictive_variance_probes must be positive.")
            if self._est_sums_ is None:
                etas = self._draw_probes(
                    2_000_000, (self.predictive_variance_probes, sp.M))
                self._est_sums_ = core.stochastic_variance_sums(
                    sp, self._X_train_t_, self._delta_t_, etas,
                    cg_tol=self.cg_tol)
            return core.evaluate_variance_sums(sp, self._est_sums_, X_t)
        solver = self._resolved_prediction_solver(sp.M)
        return core.predictive_variance_chebyshev(
            sp, self._X_train_t_, self._delta_t_, X_t,
            n_nodes_per_dim=self.predictive_variance_chebyshev_nodes,
            cg_tol=self.cg_tol, batch_size=self.prediction_batch_size,
            solver=solver,
            system=self._get_dense_system() if solver == "dense" else None)

    def _as_targets(self, X_arr):
        return torch.as_tensor(X_arr, dtype=self._rdtype(),
                               device=self._X_train_t_.device)

    def decision_function(self, X):
        """The posterior mean on the training inputs, the predictive mean
        elsewhere."""
        _check_is_fitted(self, ["beta_mean_", "delta_"])
        X_arr = _check_array(X)
        if self._is_training_input(X_arr):
            return self.posterior_mean_.copy()
        return core.predictive_mean(self._spectral_state_,
                                    self._as_targets(X_arr),
                                    self._beta_mean_t_).cpu().numpy()

    def predictive_variance(self, X):
        _check_is_fitted(self, ["beta_mean_", "delta_"])
        X_arr = _check_array(X)
        if self._is_training_input(X_arr):
            return self.posterior_var_diag_.copy()
        return self._variance_off_train(self._as_targets(X_arr)).cpu().numpy()

    def predict_latent_high(self, X, *, with_var: bool = True, **kw):
        """Float64 latent predictive moments: the final beta-mean system
        and the exact per-target variance re-solved with float64 residuals
        (``models/pg_high.pg_predict_high``) for the fitted posterior
        ``delta``.  Returns ``(mean, var)`` as float64 numpy arrays
        (``var`` is None with ``with_var=False``)."""
        from .pg_high import pg_predict_high
        _check_is_fitted(self, ["beta_mean_", "delta_", "_kappa_t_",
                                "_spectral_state_"])
        X_arr = _check_array(X)
        sp = self._spectral_state_
        kern = self._make_kernel_obj(self.lengthscale_, self.variance_,
                                     X_arr.shape[1])
        res = pg_predict_high(
            self._X_train_t_, kern, float(sp.h), sp.mtot, self._delta_t_,
            self._kappa_t_, self._as_targets(X_arr),
            hm=getattr(self, "_hm_", None), with_var=with_var,
            device=self._X_train_t_.device, **kw)
        mean = res.mean.cpu().numpy()
        var = res.var.cpu().numpy() if with_var else None
        return mean, var

    def predict_response_mean(self, X):
        _check_is_fitted(self, ["beta_mean_", "delta_"])
        X_arr = _check_array(X)
        if self._is_training_input(X_arr):
            mean = torch.as_tensor(self.posterior_mean_, dtype=self._rdtype())
            var = torch.as_tensor(self.posterior_var_diag_,
                                  dtype=self._rdtype())
        else:
            X_t = self._as_targets(X_arr)
            mean = core.predictive_mean(self._spectral_state_, X_t,
                                        self._beta_mean_t_)
            var = self._variance_off_train(X_t)
        return self._likelihood_.response_mean(mean, var).cpu().numpy()


class PolyagammaGPClassifier(_BasePolyagammaGPEstimator):
    """Scikit-learn-style PG-augmented GP binary classifier (Bernoulli
    likelihood, logistic link)."""

    _estimator_type = "classifier"

    def _make_likelihood(self):
        return _BernoulliLikelihood()

    def predict_proba(self, X):
        p1 = np.clip(self.predict_response_mean(X), 1e-8, 1.0 - 1e-8)
        return np.column_stack([1.0 - p1, p1])

    def predict(self, X):
        proba = self.predict_proba(X)[:, 1]
        return self.classes_[(proba >= 0.5).astype(int)]

    def score(self, X, y):
        """Mean accuracy of :meth:`predict` on ``(X, y)``."""
        return float(np.mean(self.predict(X) == np.asarray(y)))


class PolyagammaGPNegativeBinomialRegressor(_BasePolyagammaGPEstimator):
    """PG-augmented GP regressor for negative-binomial counts, with optional
    Gauss-Hermite learning of ``total_count`` (its own Adam on
    ``log(total_count)``, every ``total_count_update_frequency``
    iterations)."""

    _estimator_type = "regressor"

    def __init__(self, *, total_count=1.0, learn_total_count=False,
                 total_count_lr=None, total_count_update_frequency=5,
                 total_count_quadrature_nodes=12, **kwargs):
        super().__init__(**kwargs)
        self.total_count = total_count
        self.learn_total_count = learn_total_count
        self.total_count_lr = total_count_lr
        self.total_count_update_frequency = total_count_update_frequency
        self.total_count_quadrature_nodes = total_count_quadrature_nodes

    def _current_total_count(self) -> float:
        if hasattr(self, "_raw_total_count_"):
            return float(math.exp(self._raw_total_count_))
        return float(self.total_count)

    def _make_likelihood(self):
        return _NegativeBinomialLikelihood(self._current_total_count())

    def _initialize_likelihood_state(self, y_t):
        if self.total_count <= 0:
            raise ValueError("total_count must be positive.")
        if self.total_count_update_frequency <= 0:
            raise ValueError("total_count_update_frequency must be positive.")
        if self.total_count_quadrature_nodes <= 0:
            raise ValueError("total_count_quadrature_nodes must be positive.")
        if self.learn_total_count:
            if not (self.warm_start and hasattr(self, "_raw_total_count_")):
                self._raw_total_count_ = math.log(float(self.total_count))
            lr = self.lr if self.total_count_lr is None else \
                self.total_count_lr
            # the host float64 log total count and its Adam
            self._tc_raw_ = torch.tensor(self._raw_total_count_,
                                         dtype=torch.float64)
            self._tc_opt_ = torch.optim.Adam([self._tc_raw_], lr=lr)
        elif hasattr(self, "_raw_total_count_"):
            del self._raw_total_count_

    def _step_auxiliary_parameters(self, *, targets, outer):
        tc = self._current_total_count()
        record = {"total_count": tc, "grad_total_count": 0.0,
                  "total_count_updated": 0.0}
        if not self.learn_total_count:
            return record
        g = float(core.negative_binomial_total_count_gradient(
            targets, self._last_mean_, self._last_sigma_diag_,
            total_count=tc,
            quadrature_nodes=self.total_count_quadrature_nodes))
        record["grad_total_count"] = g
        if (outer + 1) % self.total_count_update_frequency == 0:
            raw = self._tc_raw_
            raw.grad = torch.tensor(-g * math.exp(float(raw)),
                                    dtype=torch.float64)
            self._tc_opt_.step()
            self._raw_total_count_ = float(raw)
            record["total_count"] = self._current_total_count()
            record["total_count_updated"] = 1.0
        return record

    def _history_parameter_record(self):
        return {"total_count": self._current_total_count(),
                "grad_total_count": 0.0, "total_count_updated": 0.0}

    def predict_mean_count(self, X):
        return self.predict_response_mean(X)

    def predict(self, X):
        return self.predict_mean_count(X)

    def score(self, X, y):
        """Coefficient of determination R^2 of :meth:`predict` on
        ``(X, y)``."""
        y = np.asarray(y, np.float64)
        resid = np.sum((y - self.predict(X)) ** 2)
        total = np.sum((y - y.mean()) ** 2)
        return float(1.0 - resid / total) if total > 0 else 0.0

    def fit(self, X, y):
        fitted = super().fit(X, y)
        self.total_count_ = self._current_total_count()
        self.shape_parameter_ = self.total_count_
        return fitted
