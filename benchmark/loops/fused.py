"""Back-to-back ``fit_predict_grad`` calls (fit, posterior mean and
stochastic variance at the targets, one hyper-gradient), one caller that
waits for each.  Call i draws its +-1 probes from a generator seeded from
the seed and i, in the order the entry point documents: the variance's
(var_probes, M), then the gradient's Z (T, n) and V (T, M).  Set-up runs
call 0; the reference judges a sample of the window's calls drawn from
the seed.
"""
from __future__ import annotations

import time

import numpy as np
import torch

import gpquad_torch
from benchmark import compare, data
from benchmark.reference import gp



class Loop:
    def __init__(self, cell, inputs, seed, device):
        c, t = cell.config, cell.traffic
        self.cell, self.seed = cell, seed
        self.dev = torch.device(device)
        self.dtype = getattr(torch, c["dtype"])
        as_dev = dict(dtype=self.dtype, device=self.dev)
        self.x = torch.as_tensor(inputs.x, **as_dev)
        self.y = torch.as_tensor(inputs.y, **as_dev)
        self.xq = torch.as_tensor(inputs.xq, **as_dev)
        k = c["kernel"]
        self.kern = gpquad_torch.make_kernel(
            k["name"], c["d"], lengthscale=k["lengthscale"],
            variance=k["variance"])
        self.sigmasq = k["sigmasq"]
        _, self.h, self.mtot = gpquad_torch.spectral_grid(
            self.kern, c["eps"], c["data"]["L"])
        self.kw = dict(trace_samples=t["trace_samples"],
                       var_probes=t["var_probes"], cg_tol=t["cg_tol"],
                       var_cg_tol=t["var_cg_tol"],
                       grad_cg_tol=t["grad_cg_tol"],
                       max_cg_iter=t["max_cg_iter"],
                       var_max_cg_iter=c["var_max_cg_iter"], solver="cg",
                       precond=c["precond"], fft_smooth=c["fft_smooth"],
                       nufft_method=c["nufft_method"], device=self.dev)
        self.entry = gpquad_torch.fit_predict_grad
        self.first_unit = 1
        self.out, self.iters, self.finite = {}, [], []

    def unit(self, i):
        g = data.generator(self.dev, self.seed, i)
        t0 = time.perf_counter()
        res = self.entry(
            self.x, self.y, self.xq, self.kern, self.sigmasq, self.h, g,
            mtot=self.mtot, **self.kw)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        dt = time.perf_counter() - t0
        self.out[i] = (res.mean, res.var, res.grad)
        self.iters.append(res.mean_cg_iters + res.trace_cg_iters)
        self.finite.append(torch.isfinite(res.mean).all()
                           & torch.isfinite(res.var).all()
                           & torch.isfinite(res.grad).all())
        return dt

    def setup(self):
        self.unit(0)
        self.out, self.iters, self.finite = {}, [], []

    def counters(self):
        return dict(pcg_iters=[int(i) for i in self.iters])

    def failed(self):
        return sum(not bool(f) for f in self.finite)

    def outputs_program(self):
        """The sampled calls' outputs: ``checked_calls`` of the window's
        calls drawn from the seed."""
        calls = sorted(self.out)
        rng = np.random.default_rng(data.seed_sequence(self.seed, 2))
        k = min(self.cell.traffic["checked_calls"], len(calls))
        pick = sorted(int(i) for i in rng.choice(calls, size=k,
                                                 replace=False))
        return dict(mtot=self.mtot, checked=pick,
                    calls={i: tuple(t.cpu() for t in self.out[i])
                           for i in pick})

    def release(self):
        self.x = self.y = self.xq = None
        self.out, self.iters, self.finite = {}, [], []


def outputs_reference(cell, inputs, seed, program, precision, device):
    """The reference's (or its control's) mean, variance and gradient of
    each sampled call, on that call's probes."""
    c, t = cell.config, cell.traffic
    k = c["kernel"]
    h, mtot = gp.se_plan(k["lengthscale"], k["variance"], c["eps"],
                         c["data"]["L"], c["d"])
    out = dict(mtot=mtot, calls={})
    if mtot != program["mtot"]:
        return out
    dev = torch.device(device)
    dt = getattr(torch, c["dtype"])
    as_dev = dict(dtype=dt, device=dev)
    x = torch.as_tensor(inputs.x, **as_dev)
    y = torch.as_tensor(inputs.y, **as_dev)
    xq = torch.as_tensor(inputs.xq, **as_dev)
    model = gp.make_model(x, y, h, mtot, precision)
    tol = gp.tolerances_of(c, t)
    hyp = (k["lengthscale"], k["variance"], k["sigmasq"])
    fit = model.fit(*hyp, tol)
    mean = _cpu(model.predict_mean(fit, xq, *hyp[:2]))
    M, T = mtot ** c["d"], t["trace_samples"]
    for i in program["calls"]:
        g = data.generator(dev, seed, i)
        etas = data.rademacher(g, t["var_probes"], M, dt)
        Z = data.rademacher(g, T, x.shape[0], dt)
        V = data.rademacher(g, T, M, dt)
        var = _cpu(model.variance(etas, xq, *hyp, tol))
        grad = _cpu(model.gradient(*hyp, Z, V, tol, beta0=fit))
        out["calls"][i] = (mean, var, grad)
    return out


def _cpu(variants):
    return {v: t.cpu() for v, t in variants.items()}


def as_program(reference):
    """The reference's (its control's) outputs in the program's form."""
    return dict(mtot=reference["mtot"],
                calls={i: tuple(t["mid"] for t in out)
                       for i, out in reference["calls"].items()})


def numbers(program, reference):
    """The mean and the variance by their largest gap over max |ref|, the
    gradient by its worst leaf, each over the sampled calls, each under
    the reading of the reference's stop rule that it is nearest."""
    out = dict(mtot_gap=float(abs(program["mtot"] - reference["mtot"])))
    if not reference["calls"]:
        return dict(out, mean_err=float("inf"))
    pairs = [(program["calls"][i], reference["calls"][i])
             for i in program["calls"]]

    def worst(j, measure):
        return max(min(measure(p[j], r) for r in rs[j].values())
                   for p, rs in pairs)
    out["mean_err"] = worst(0, compare.relative_max)
    out["var_err"] = worst(1, compare.relative_max)
    out["grad_err"] = worst(2, compare.leaf_error)
    return out


def end_to_end(window):
    ms = np.asarray(window.unit_seconds) * 1e3
    return dict(fit_ms=window.seconds * 1e3 / window.units,
                fit_p95_ms=float(np.percentile(ms, 95)))
