"""On-device hierarchical clustering (average/complete/single linkage),
cophenetic distances and cut-tree: the port of ``nmfx/ops/hclust_jax.py``.

The reference's default runs this small-n rank selection on the host
(``nmfx_torch/cophenetic.py``); this module is the device-resident
alternative behind ``nmfconsensus(rank_selection="device")``. The n − 1
inherently sequential merges run as a Python loop of plain PyTorch ops on
the consensus's device, with every index kept in a tensor: no host read
inside the n − 1 merges or the 2n − 1 pops of the leaf-order walk, so on
a card the whole selection is queued without a sync. It is XLA code in
the reference, not a Pallas kernel, so plain ops are its port.

Conventions match ``nmfx_torch/cophenetic.py`` and the reference exactly:
scipy-style cluster ids, first minimum in row-major order (``torch.argmin``
returns the first), R ``cutree`` labels by first appearance, left child
first in the leaf order. Arithmetic runs in float32 (or the consensus's
wider type), as the reference promotes.
"""

from __future__ import annotations

import torch

from nmfx_torch.config import LINKAGE_METHODS


def linkage_torch(dist: torch.Tensor, k: int | None = None,
                  method: str = "average"):
    """Agglomerative clustering of an (n, n) distance matrix on its
    device, under the "average", "complete" or "single" Lance-Williams
    update (reference ``linkage_jax``, ``hclust_jax.py:32-105``).

    Returns ``(linkage, coph, order, membership)``: the (n−1, 4)
    scipy-style merge table, the (n, n) cophenetic distances, the (n,)
    leaf order and the (n,) labels 1..k from cutting at k clusters (1s if
    ``k`` is None).
    """
    n = dist.shape[0]
    if dist.shape != (n, n):
        raise ValueError("dist must be square")
    if method not in LINKAGE_METHODS:
        raise ValueError(
            f"linkage must be one of {LINKAGE_METHODS}, got {method!r}")
    kcut = 1 if k is None else k
    if not 1 <= kcut <= n:
        raise ValueError(f"k must be in [1, {n}]")
    dev = dist.device
    f = torch.promote_types(dist.dtype, torch.float32)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    inf = torch.tensor(float("inf"), dtype=f, device=dev)
    d = torch.where(eye, inf, dist.to(f))
    active = torch.ones(n, dtype=torch.bool, device=dev)
    size = torch.ones(n, dtype=f, device=dev)
    cid = torch.arange(n, device=dev)
    mem = eye.clone()  # mem[s]: the samples held by slot s
    coph = torch.zeros((n, n), dtype=f, device=dev)
    linkage = torch.zeros((max(n - 1, 0), 4), dtype=f, device=dev)
    cut_slot = torch.arange(n, device=dev)

    for t in range(n - 1):
        masked = torch.where(active[:, None] & active[None, :], d, inf)
        flat = masked.reshape(-1)
        idx = torch.argmin(flat, dim=0, keepdim=True)  # first minimum
        row, col = idx // n, idx % n
        i, j = torch.minimum(row, col), torch.maximum(row, col)  # (1,)
        height = flat.index_select(0, idx)
        ci, cj = cid.index_select(0, i), cid.index_select(0, j)
        si, sj = size.index_select(0, i), size.index_select(0, j)
        new_size = si + sj
        linkage[t] = torch.cat([torch.minimum(ci, cj).to(f),
                                torch.maximum(ci, cj).to(f), height,
                                new_size])
        mi, mj = mem.index_select(0, i)[0], mem.index_select(0, j)[0]
        cross = mi[:, None] & mj[None, :]
        coph = coph + height * (cross | cross.T).to(f)
        di, dj = d.index_select(0, i)[0], d.index_select(0, j)[0]
        if method == "average":
            merged = (si * di + sj * dj) / new_size
        elif method == "complete":
            merged = torch.maximum(di, dj)
        else:  # single
            merged = torch.minimum(di, dj)
        d.index_copy_(0, i, merged[None, :])
        d.index_copy_(1, i, merged[:, None])
        d.index_put_((i, i), inf.reshape(1))
        active.index_fill_(0, j, False)
        mem.index_copy_(0, i, (mi | mj)[None, :])
        size.index_copy_(0, i, new_size)
        cid.index_fill_(0, i, n + t)
        if n - (t + 1) == kcut:
            # each sample's slot once exactly kcut clusters remain
            cut_slot = torch.argmax(mem.T.to(torch.uint8), dim=1)

    order = _leaf_order(linkage, n)
    membership = _first_appearance_labels(cut_slot)
    return linkage, coph, order, membership


def _leaf_order(linkage: torch.Tensor, n: int) -> torch.Tensor:
    """Dendrogram leaf order by an explicit-stack walk, left child first
    (reference ``_leaf_order``, ``hclust_jax.py:108``): every node is
    popped exactly once (2n − 1 pops), the stack pointer and the order's
    length stay tensors."""
    dev = linkage.device
    if n == 1:
        return torch.zeros(1, dtype=torch.int64, device=dev)
    children = linkage[:, :2].to(torch.int64)  # (n − 1, 2): left, right
    stack = torch.zeros(2 * n, dtype=torch.int64, device=dev)
    stack[0] = 2 * n - 2
    sp = torch.ones(1, dtype=torch.int64, device=dev)
    order = torch.zeros(n, dtype=torch.int64, device=dev)
    no = torch.zeros(1, dtype=torch.int64, device=dev)
    for _ in range(2 * n - 1):
        sp = sp - 1
        node = stack.index_select(0, sp)
        is_leaf = node < n
        # a leaf appends itself; an internal node rewrites the slot with
        # its current value (order's length stays below n until the last
        # leaf, so the slot is in range)
        slot = torch.clamp(no, max=n - 1)
        order.index_copy_(0, slot, torch.where(
            is_leaf, node, order.index_select(0, slot)))
        no = no + is_leaf.to(torch.int64)
        # an internal node pushes right then left (left pops first); a
        # leaf's writes land above the stack top, where nothing is read
        # before the next push overwrites it
        lr = children.index_select(0, torch.clamp(node - n, min=0))[0]
        stack.index_copy_(0, torch.cat([sp, sp + 1]), lr.flip(0))
        sp = sp + 2 * (~is_leaf).to(torch.int64)
    return order


def _first_appearance_labels(raw: torch.Tensor) -> torch.Tensor:
    """Renumber arbitrary integer labels 1..k by first appearance in index
    order (R cutree convention, reference nmf.r:177; reference
    ``_first_appearance_labels``, ``hclust_jax.py:139``). A position p is
    the first of its label when its first-occurrence position is p
    itself; a sample's label is the count of such positions up to its own
    label's first position."""
    n = raw.shape[0]
    idx = torch.arange(n, device=raw.device)
    same = raw[:, None] == raw[None, :]
    first_pos = torch.where(same, idx[None, :], n).amin(dim=1)
    opens = torch.cumsum((first_pos == idx).to(torch.int64), dim=0)
    return opens.index_select(0, first_pos)


def rank_selection_torch(consensus: torch.Tensor, k: int,
                         method: str = "average"):
    """On-device analogue of ``nmfx_torch.cophenetic.rank_selection``
    (reference ``rank_selection_jax``, ``hclust_jax.py:161``): (rho as a
    0-d tensor, membership 1..k, leaf order) from one consensus matrix,
    all on the consensus's device."""
    n = consensus.shape[0]
    f = torch.promote_types(consensus.dtype, torch.float32)
    eye = torch.eye(n, dtype=torch.bool, device=consensus.device)
    dist = torch.where(eye, 0.0, 1.0 - consensus.to(f))
    _, coph, order, membership = linkage_torch(dist, k, method)
    iu = torch.triu_indices(n, n, offset=1, device=consensus.device)
    x = dist[iu[0], iu[1]]
    y = coph[iu[0], iu[1]]
    xc = x - x.mean()
    yc = y - y.mean()
    denom = torch.sqrt((xc @ xc) * (yc @ yc))
    rho = torch.where(denom == 0, torch.ones((), dtype=f,
                                             device=consensus.device),
                      (xc @ yc) / denom)
    return rho, membership, order
