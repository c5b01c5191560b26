"""Hierarchical clustering (average/complete/single linkage), cophenetic
correlation, cut-tree: a copy of the numpy path of ``nmfx/cophenetic.py``.

The rank-selection step the reference delegates to base R:
``hclust(as.dist(1-C), method="average")`` → ``cophenetic`` → ``cor`` →
``cutree`` (reference ``nmf.r:165-177``). n is the number of samples
(tiny next to the NMF work), so this runs on host numpy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from nmfx_torch.config import LINKAGE_METHODS


class HClust(NamedTuple):
    """Result of agglomerative clustering of an n×n distance matrix."""

    linkage: np.ndarray  # (n-1, 4) scipy-style: id_a, id_b, height, size
    coph: np.ndarray  # (n, n) cophenetic distances
    order: np.ndarray  # (n,) dendrogram leaf order


def linkage_numpy(dist: np.ndarray, method: str = "average") -> HClust:
    """Agglomerative clustering under the "average", "complete", or
    "single" Lance-Williams update.

    Cluster ids follow the scipy convention: leaves are 0..n-1, the cluster
    created at merge t is n+t. Cophenetic distance of a cross pair = height
    of the merge that first joins them.
    """
    if method not in LINKAGE_METHODS:
        raise ValueError(
            f"linkage must be one of {LINKAGE_METHODS}, got {method!r}")
    d = np.array(dist, dtype=np.float64, copy=True)
    n = d.shape[0]
    if d.shape != (n, n):
        raise ValueError("dist must be square")
    np.fill_diagonal(d, np.inf)
    active = np.ones(n, dtype=bool)
    size = np.ones(n)
    cid = np.arange(n)  # cluster id currently held in each slot
    members: list[list[int]] = [[i] for i in range(n)]
    linkage = np.zeros((n - 1, 4))
    coph = np.zeros((n, n))
    children: dict[int, tuple[int, int]] = {}

    for t in range(n - 1):
        masked = np.where(active[:, None] & active[None, :], d, np.inf)
        i, j = np.unravel_index(np.argmin(masked), masked.shape)
        if i > j:
            i, j = j, i
        height = masked[i, j]
        a, b = sorted((cid[i], cid[j]))
        new_size = size[i] + size[j]
        linkage[t] = (a, b, height, new_size)
        mi, mj = members[i], members[j]
        coph[np.ix_(mi, mj)] = height
        coph[np.ix_(mj, mi)] = height
        # Lance-Williams update of the merged cluster's distances
        if method == "average":
            merged = (size[i] * d[i] + size[j] * d[j]) / new_size
        elif method == "complete":
            merged = np.maximum(d[i], d[j])
        else:  # single
            merged = np.minimum(d[i], d[j])
        d[i] = merged
        d[:, i] = merged
        d[i, i] = np.inf
        active[j] = False
        children[n + t] = (a, b)
        members[i] = mi + mj
        size[i] = new_size
        cid[i] = n + t

    # dendrogram leaf order: depth-first, left child first
    order: list[int] = []
    stack = [2 * n - 2] if n > 1 else [0]
    while stack:
        node = stack.pop()
        if node < n:
            order.append(node)
        else:
            left, right = children[node]
            stack.append(right)
            stack.append(left)
    return HClust(linkage, coph, np.asarray(order))


def condensed(mat: np.ndarray) -> np.ndarray:
    """Upper-triangle (off-diagonal) entries, row-major."""
    iu = np.triu_indices(mat.shape[0], k=1)
    return np.asarray(mat)[iu]


def cophenetic_rho(dist: np.ndarray, coph: np.ndarray) -> float:
    """Pearson correlation between the condensed distance and cophenetic
    matrices (reference ``cor(dist.matrix, dist.coph)``, nmf.r:171)."""
    x = condensed(dist)
    y = condensed(coph)
    xc = x - x.mean()
    yc = y - y.mean()
    denom = np.sqrt((xc @ xc) * (yc @ yc))
    if denom == 0:
        return 1.0  # degenerate: all restarts agree perfectly
    return float((xc @ yc) / denom)


def cut_tree_numpy(linkage: np.ndarray, n: int, k: int) -> np.ndarray:
    """Memberships 1..k from the first n-k merges (labels numbered by first
    appearance in leaf index order, as R's cutree does)."""
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, {n}]")
    parent = np.arange(2 * n - 1)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for t in range(n - k):
        a, b, _, _ = linkage[t]
        new = n + t
        parent[find(int(a))] = new
        parent[find(int(b))] = new

    labels = np.zeros(n, dtype=np.int64)
    seen: dict[int, int] = {}
    for i in range(n):
        root = find(i)
        if root not in seen:
            seen[root] = len(seen) + 1
        labels[i] = seen[root]
    return labels


def rank_selection(consensus: np.ndarray, k: int,
                   linkage: str = "average"):
    """Full per-k rank-selection step on one consensus matrix: returns
    (rho, memberships, leaf order), mirroring reference nmf.r:165-177."""
    dist = 1.0 - np.asarray(consensus)
    np.fill_diagonal(dist, 0.0)
    hc = linkage_numpy(dist, linkage)
    rho = cophenetic_rho(dist, hc.coph)
    membership = cut_tree_numpy(hc.linkage, dist.shape[0], k)
    return rho, membership, hc.order
