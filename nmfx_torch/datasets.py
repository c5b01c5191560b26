"""Synthetic dataset generators (copies of ``nmfx/datasets.py``'s
``two_group_matrix``, ``grouped_matrix`` and ``make_sparse_design``;
same seed, same bits)."""

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


def make_sparse_design(
    m: int,
    n: int,
    k: int,
    density: float = 0.05,
    seed: int = 0,
):
    """Planted sparse factorizable matrix: a non-negative rank-``k``
    product W·H with block-structured factors, thinned by an independent
    Bernoulli(``density``) mask — the shape of an scRNA-seq count matrix
    (more than 90 % exact zeros, with a planted k-group structure a
    consensus solve should recover). Returns a
    ``nmfx_torch.sparse.SparseMatrix``; ``.toarray()`` densifies it.

    The realized nnz is Binomial(m·n, density), so ``.density`` tracks
    the requested density up to sampling noise."""
    from nmfx_torch.sparse import SparseMatrix

    if not 0.0 <= density <= 1.0:
        raise ValueError(f"density must be in [0, 1], got {density!r}")
    rng = np.random.default_rng(seed)
    # each of the k components owns a row block (features) and a column
    # block (samples), over a dense low-level background
    w = rng.uniform(0.05, 0.3, size=(m, k))
    h = rng.uniform(0.05, 0.3, size=(k, n))
    for j in range(k):
        w[(m * j) // k:(m * (j + 1)) // k, j] += rng.uniform(
            2.0, 4.0, size=(m * (j + 1)) // k - (m * j) // k)
        h[j, (n * j) // k:(n * (j + 1)) // k] += rng.uniform(
            2.0, 4.0, size=(n * (j + 1)) // k - (n * j) // k)
    mask = rng.random((m, n)) < density
    return SparseMatrix.from_dense((w @ h) * mask)
