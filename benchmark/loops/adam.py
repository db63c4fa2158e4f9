"""Hyperparameter learning: Adam steps on the log hypers (lengthscale,
variance, noise), each step one ``gradient_with_grid`` on a grid planned
once from the starting hypers.  The probes of step k come from the seed
and k; every ``restart_every`` steps (from step 0) the hypers and Adam's
state go back to the start, so the work of step k does not depend on how
many steps a window holds.  Set-up runs one step on probes of its own and
starts the window at step 0.  The window keeps the gradients of the first
``checked_steps`` steps after each restart and the change of the hypers
over them; the reference follows one such block, drawn from the seed among
the blocks after the first that the window completed (the first where it
completed no other), from the start on the same probes.
"""
from __future__ import annotations

import numpy as np
import torch

import gpquad_torch
from benchmark import compare, data
from benchmark.reference import gp


WARM_STREAM = 3      # the warm step's probes: a stream no timed step draws


class Adam:
    """Adam with torch's defaults (betas 0.9, 0.999, eps 1e-8), written out:
    ``torch.optim.Adam`` imports ``torch._dynamo`` when it is made, ~10 s of
    a run's set-up on an H100 machine."""

    def __init__(self, param, lr, betas=(0.9, 0.999), eps=1e-8):
        self.param, self.lr, self.betas, self.eps = param, lr, betas, eps
        self.m = torch.zeros_like(param)
        self.v = torch.zeros_like(param)
        self.t = 0

    def step(self, grad):
        b1, b2 = self.betas
        self.t += 1
        self.m.mul_(b1).add_(grad, alpha=1 - b1)
        self.v.mul_(b2).addcmul_(grad, grad, value=1 - b2)
        denom = (self.v.sqrt() / (1 - b2 ** self.t) ** 0.5).add_(self.eps)
        self.param.addcdiv_(self.m, denom, value=-self.lr / (1 - b1 ** self.t))



class Loop:
    def __init__(self, cell, inputs, seed, device):
        c, t = cell.config, cell.traffic
        self.cell, self.seed = cell, seed
        self.dev = torch.device(device)
        self.dtype = getattr(torch, c["dtype"])
        self.x = torch.as_tensor(inputs.x, dtype=self.dtype, device=self.dev)
        self.y = torch.as_tensor(inputs.y, dtype=self.dtype, device=self.dev)
        k = c["kernel"]
        self.kern = gpquad_torch.make_kernel(
            k["name"], c["d"], lengthscale=k["lengthscale"],
            variance=k["variance"])
        _, self.h, self.mtot = gpquad_torch.spectral_grid(
            self.kern, c["eps"], c["data"]["L"])
        self.params = gpquad_torch.HyperState.create(self.kern, k["sigmasq"])
        self.entry = gpquad_torch.gradient_with_grid
        self.raw0 = self.params.raw.to(self.dev)
        self.kw = dict(trace_samples=t["trace_samples"], cg_tol=t["cg_tol"],
                       max_cg_iter=t["max_cg_iter"], solver="cg",
                       precond=c["precond"], fft_smooth=c["fft_smooth"],
                       nufft_method=c["nufft_method"], device=self.dev)
        self.checked = t["checked_steps"]
        self.first_unit, self.min_units = 0, self.checked
        self.iters, self.finite = [], []
        self._restart()

    def _restart(self):
        self.raw = self.raw0.clone()
        self.adam = Adam(self.raw, self.cell.traffic["lr"])

    def probes(self, step):
        g = (data.generator(self.dev, self.seed, step) if step >= 0 else
             data.generator(self.dev, self.seed, 0, stream=WARM_STREAM))
        T = self.cell.traffic["trace_samples"]
        return (data.rademacher(g, T, self.x.shape[0], self.dtype),
                data.rademacher(g, T, self.mtot ** self.x.shape[1],
                                self.dtype))

    def unit(self, step):
        R = self.cell.traffic["restart_every"]
        if step % R == 0:
            self._restart()
        Z, V = self.probes(step)
        p = self.params.replace_raw(self.raw)
        res = self.entry(
            self.x, self.y, p.kernel_of(self.kern), p.sig2, self.h,
            mtot=self.mtot, probes=(Z, V), **self.kw)
        self.grad = res.grad.to(self.raw.dtype) * torch.exp(self.raw)
        self.adam.step(self.grad)
        self.iters.append(res.mean_cg_iters + res.trace_cg_iters)
        self.finite.append(torch.isfinite(res.grad).all())
        if step >= 0 and step % R < self.checked:
            self.grads[step] = self.grad.clone()
            if step % R == self.checked - 1:
                self.changes[step // R] = self.raw - self.raw0
        return None

    def setup(self):
        """One step on probes of its own; step 0 starts again from the
        starting hypers."""
        self.grads, self.changes = {}, {}
        self.unit(-1)
        self.grads, self.changes = {}, {}
        self.iters, self.finite = [], []

    def counters(self):
        return dict(pcg_iters=[int(i) for i in self.iters])

    def failed(self):
        return sum(not bool(f) for f in self.finite)

    def outputs_program(self):
        """The checked block: drawn from the seed among the completed
        blocks after the first, or the first where there is no other."""
        blocks = sorted(self.changes)
        later = [j for j in blocks if j >= 1] or blocks
        rng = np.random.default_rng(data.seed_sequence(self.seed, 2))
        j = int(rng.choice(later)) if later else None
        first = None if j is None else j * self.cell.traffic["restart_every"]
        steps = [] if j is None else list(range(first, first + self.checked))
        return dict(grads=[self.grads[k].cpu() for k in steps],
                    change=None if j is None else self.changes[j].cpu(),
                    mtot=self.mtot, raw0=self.raw0.cpu(), checked=steps)

    def release(self):
        self.x = self.y = self.adam = self.raw = None
        self.grads, self.changes = {}, {}
        self.iters, self.finite = [], []


def outputs_reference(cell, inputs, seed, program, precision, device):
    """The reference's (or, at ``precision`` "tf32", its control's) own
    trajectory of the program's checked block, from the same start with a
    fresh Adam and on the same probes."""
    c, t = cell.config, cell.traffic
    k = c["kernel"]
    h, mtot = gp.se_plan(k["lengthscale"], k["variance"], c["eps"],
                         c["data"]["L"], c["d"])
    out = dict(mtot=mtot, grads=[], change=None)
    if mtot != program["mtot"] or not program["checked"]:
        return out
    dev = torch.device(device)
    dt = getattr(torch, c["dtype"])
    x = torch.as_tensor(inputs.x, dtype=dt, device=dev)
    y = torch.as_tensor(inputs.y, dtype=dt, device=dev)
    model = gp.make_model(x, y, h, mtot, precision)
    tol = gp.tolerances_of(c, t)
    raw0 = program["raw0"].clone()
    raw = raw0.clone()
    adam = Adam(raw, t["lr"])
    T = t["trace_samples"]
    for step in program["checked"]:
        g = data.generator(dev, seed, step)
        Z = data.rademacher(g, T, x.shape[0], dt)
        V = data.rademacher(g, T, mtot ** c["d"], dt)
        pos = torch.exp(raw)
        grads = model.gradient(float(pos[0]), float(pos[1]), float(pos[2]),
                               Z, V, tol)
        out["grads"].append({v: g.cpu() * pos for v, g in grads.items()})
        adam.step(out["grads"][-1]["mid"])
    out["change"] = raw - raw0
    return out


def as_program(reference):
    """The reference's (its control's) outputs in the program's form."""
    return dict(grads=[g["mid"] for g in reference["grads"]],
                change=reference["change"], mtot=reference["mtot"])


def numbers(program, reference):
    """Each step's gradient (as Adam gets it) and the change of the hypers
    after the checked steps, by the worst leaf; a step's gradient under the
    reading of the reference's stop rule that it is nearest."""
    out = dict(mtot_gap=float(abs(program["mtot"] - reference["mtot"])))
    if reference["change"] is None or program["change"] is None:
        return dict(out, grad_gap=float("inf"))
    flips = 0
    for k, (p, rs) in enumerate(zip(program["grads"], reference["grads"]),
                                1):
        out[f"grad{k}_gap"] = min(compare.gap_of_norms(p, r)
                                  for r in rs.values())
        flips += min(compare.sign_flips(p, r) for r in rs.values())
    out["change_gap"] = compare.gap_of_norms(program["change"],
                                             reference["change"])
    out["sign_flips"] = float(flips)
    return out


def end_to_end(window):
    return dict(train_step_ms=window.seconds * 1e3 / window.units)
