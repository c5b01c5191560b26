"""KL-divergence multiplicative updates (Brunet et al. 2004; counterpart
of ``nmfx/solvers/kl.py``): the update rule of the BROAD original
``nmfconsensus.R``, which the reference's C library replaced with
Euclidean mu:

    H ← H ∘ (Wᵀ(A ⊘ WH)) / (Wᵀ1)
    W ← W ∘ ((A ⊘ WH)Hᵀ) / (1Hᵀ)    (using the fresh H)

descending the generalized KL divergence (:func:`kl_divergence`).
Convergence: class stability when enabled, and TolX. The m×n quotient
A ⊘ (WH) is materialized per half-step, one per lane on the batched
restart route: ``restart_chunk`` bounds how many lanes hold one at once
there, and the slot count bounds it on the packed grid. Under ``shard``
(a grid group's shard) the quotient is a purely local (m_loc × n_loc)
block and each update's contracted terms sum over the grid axis: WᵀQ
and W's column sums over the features, QHᵀ and H's row sums over the
samples (reference ``nmfx/solvers/kl.py:41-77``).
"""

from __future__ import annotations

import dataclasses

import torch

from nmfx_torch.solvers import base


def init_aux(a, w0, h0, cfg, shard=None):
    return ()


def kl_divergence(a, w, h, eps: float = 1e-9):
    """Generalized KL divergence D(A ‖ WH) per lane (0 ≤, 0 iff A == WH),
    with 0·log 0 = 0."""
    wh = w @ h + eps
    logq = torch.where(a > 0, torch.log(a.clamp(min=eps) / wh), 0.0)
    return base.lane_sum(a * logq - a + wh)


def step(a, state: base.State, cfg, check: bool = True,
         shard: "base.ShardInfo | None" = None) -> base.State:
    w0, h0 = state.w, state.h
    eps = cfg.div_eps
    fsum, ssum = base.shard_reducers(shard)
    # under bf16 products the quotient keeps the full-precision A
    # (nmfx/ops/grid_mu.py:321-331); only the products round
    bf, mm = base.bf16_products(cfg, a.device), base.mm
    q = a / (mm(w0, h0, bf) + eps)
    numer, colsum = fsum(mm(w0.mT, q, bf), w0.sum(dim=-2))
    h = h0 * numer / (colsum[..., :, None] + eps)
    h = base.clamp(h, cfg.zero_threshold)
    del q  # one quotient live at a time
    q = a / (mm(w0, h, bf) + eps)
    numer, rowsum = ssum(mm(q, h.mT, bf), h.sum(dim=-1))
    w = w0 * numer / (rowsum[..., None, :] + eps)
    w = base.clamp(w, cfg.zero_threshold)
    state = dataclasses.replace(state, w=w, h=h)
    if not check:
        return state
    return base.check_convergence(state, cfg, use_class=cfg.use_class_stop,
                                  use_tolx=True, shard=shard)
