"""Seeded inputs of a cell: points, observations and targets from a
configuration's data description, and the +-1 probes of each timed unit.

The dataset is the configuration's, as a deployment's is fixed: drawn from
its ``data.seed``, so that every run does the same work (with the points
drawn from the run's seed, the PCG iterations and with them the time of a
call moved by a fifth between seeds).  The run's seed draws the probes of
each unit and the sample of units that the reference checks.

The field is data: a sum of terms, each a coefficient times a product of
sin or cos factors of <w, x> (``w`` in units of pi where ``"pi": true``).
The draws follow the scale and d=3 configurations of the repository's
earlier bench scripts: the points uniform in [0, L]^d, then the noise
N(0, noise_sd^2) added to the field, then the targets uniform in [0, L]^d,
all from one numpy generator.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


def seed_sequence(seed: int, *more: int) -> np.random.SeedSequence:
    """Any whole number, negative or past 64 bits included, as entropy."""
    return np.random.SeedSequence([abs(int(seed)), int(seed < 0), *more])


def unit_seed(seed: int, unit: int, stream: int = 1) -> int:
    """The 63-bit seed of timed unit ``unit`` (a step or a call), or of a
    unit of another ``stream`` (a warm-up's)."""
    return int(seed_sequence(seed, stream, unit).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def field(x: np.ndarray, terms) -> np.ndarray:
    out = np.zeros(x.shape[0])
    for term in terms:
        prod = np.full(x.shape[0], float(term["coef"]))
        for fac in term["factors"]:
            w = np.asarray(fac["w"], dtype=np.float64)
            if fac.get("pi"):
                w = w * math.pi
            arg = x @ w
            prod *= np.sin(arg) if fac["fn"] == "sin" else np.cos(arg)
        out += prod
    return out


@dataclass
class Inputs:
    x: np.ndarray        # (n, d) float64
    y: np.ndarray        # (n,)
    xq: np.ndarray       # (targets, d)


def make_inputs(config: dict) -> Inputs:
    data = config["data"]
    n, d, L = data["n"], config["d"], data["L"]
    rng = np.random.default_rng(seed_sequence(data["seed"]))
    x = rng.uniform(0, L, size=(n, d))
    y = field(x, data["field"]) + data["noise_sd"] * rng.normal(size=n)
    xq = rng.uniform(0, L, size=(data["targets"], d))
    return Inputs(x=x, y=y, xq=xq)


def rademacher(generator: torch.Generator, rows: int, cols: int, dtype):
    """+-1 rows as the program draws its own probes from a generator."""
    bits = torch.randint(0, 2, (rows, cols), generator=generator,
                         device=generator.device)
    return (bits * 2 - 1).to(dtype)


def generator(device, seed: int, unit: int,
              stream: int = 1) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        unit_seed(seed, unit, stream))
