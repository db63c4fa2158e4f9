"""Polya-Gamma core; port of ``gpquad/models/pg_core.py``.  So far it holds
the Chebyshev-Lobatto node rule that the EFGP regression's Chebyshev
variance shares with the PG classifier's."""
from __future__ import annotations

import numpy as np

__all__ = ["chebyshev_lobatto_nodes"]


def chebyshev_lobatto_nodes(a: float, b: float, n_nodes: int):
    """Chebyshev-Lobatto nodes on [a, b] and their barycentric weights,
    both float64 numpy, in ascending node order."""
    if n_nodes < 2:
        raise ValueError("chebyshev nodes must be at least 2.")
    k = np.arange(n_nodes, dtype=np.float64)
    nodes_std = np.cos(np.pi * k / (n_nodes - 1))
    weights = np.ones(n_nodes)
    weights[0] = 0.5
    weights[-1] = 0.5
    weights *= (-1.0) ** k
    nodes = 0.5 * (a + b) + 0.5 * (b - a) * nodes_std
    scale = 2.0 / (b - a) if b > a else 1.0
    order = np.argsort(nodes)
    return nodes[order], (weights * scale)[order]
