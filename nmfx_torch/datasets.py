"""Synthetic dataset generators (copies of ``nmfx/datasets.py``'s
``two_group_matrix`` and ``grouped_matrix``; same seed, same bits)."""

from __future__ import annotations

import numpy as np


def two_group_matrix(
    n_genes: int = 1000,
    n_per_group: int = 20,
    frac_de: float = 0.2,
    effect: float = 2.0,
    noise: float = 0.5,
    seed: int = 0,
) -> np.ndarray:
    """Non-negative (genes x samples) matrix with two sample groups.

    A fraction ``frac_de`` of genes is differentially expressed between the
    groups; everything is shifted positive the way the reference preprocesses
    its simulated data (``A = (A - min(A) + runif(1,0,1))/10``, nmf.r:9).
    """
    rng = np.random.default_rng(seed)
    n = 2 * n_per_group
    base = rng.normal(5.0, 1.0, size=(n_genes, 1))
    a = base + rng.normal(0.0, noise, size=(n_genes, n))
    n_de = int(frac_de * n_genes)
    de_idx = rng.choice(n_genes, size=n_de, replace=False)
    signs = rng.choice([-1.0, 1.0], size=n_de)
    a[de_idx, n_per_group:] += signs[:, None] * effect
    a = (a - a.min() + rng.uniform(0, 1)) / 10.0
    return np.ascontiguousarray(a)


def grouped_matrix(
    n_genes: int,
    group_sizes: tuple[int, ...],
    effect: float = 2.0,
    noise: float = 0.5,
    seed: int = 0,
) -> np.ndarray:
    """Non-negative matrix with any number of sample groups, each marked
    by its own block of upregulated genes (cophenetic rho should peak at
    ``len(group_sizes)``)."""
    rng = np.random.default_rng(seed)
    n = sum(group_sizes)
    g = len(group_sizes)
    a = rng.normal(5.0, noise, size=(n_genes, n))
    block = n_genes // g
    col = 0
    for gi, size in enumerate(group_sizes):
        rows = slice(gi * block, (gi + 1) * block)
        a[rows, col:col + size] += effect
        col += size
    a = (a - a.min() + rng.uniform(0, 1)) / 10.0
    return np.ascontiguousarray(a)
