"""Sparse NMF (Kim & Park 2007, SNMF/R; counterpart of
``nmfx/solvers/snmf.py``):

    min ½‖A − WH‖²_F  +  η‖W‖²_F  +  β Σⱼ ‖H[:,j]‖₁²

Each half-step is the regularized normal-equation solve of the augmented
least-squares systems:

    H = max( (WᵀW + β·1ₖ1ₖᵀ) \\ (WᵀA), 0 )
    W = max( ((HHᵀ + η·Iₖ) \\ (HAᵀ))ᵀ, 0 )

``sparsity_beta`` is β; ``ridge_eta`` is η (None: max(A)², from the
full-precision A). The jittered Cholesky of neals keeps each solve
well-posed. Convergence: class stability when enabled, TolX and TolFun.
"""

from __future__ import annotations

import dataclasses

import torch

from nmfx_torch.solvers import base


def init_aux(a, w0, h0, cfg, shard=None):
    """η, shared by every lane: ``ridge_eta`` or max(A)²; under ``shard``
    the global max over the grid group's blocks (zero padding cannot win:
    A is non-negative)."""
    if cfg.ridge_eta is None:
        amax = a.amax()
        if shard is not None:
            for ax in (shard.feature_axis, shard.sample_axis):
                if ax is not None:
                    amax = shard.comm.max(amax, ax)
        return amax ** 2
    return torch.tensor(cfg.ridge_eta, dtype=w0.dtype, device=w0.device)


def step(a, state: base.State, cfg, check: bool = True,
         shard: "base.ShardInfo | None" = None) -> base.State:
    w0 = state.w
    fsum, ssum = base.shard_reducers(shard)
    eta = state.aux
    k = w0.shape[-1]
    ones = torch.ones((k, k), dtype=w0.dtype, device=w0.device)
    eye = torch.eye(k, dtype=w0.dtype, device=w0.device)
    bf, mm = base.bf16_products(cfg, a.device), base.mm
    # the regularizers are added after the sums: they are global terms,
    # not per-shard contributions
    gram, rhs = fsum(mm(w0.mT, w0, bf), mm(w0.mT, a, bf))
    h = base.clamp(
        base.solve_gram_reg(gram + cfg.sparsity_beta * ones, rhs),
        cfg.zero_threshold)
    gram, rhs = ssum(mm(h, h.mT, bf), mm(h, a.T, bf))
    wt = base.solve_gram_reg(gram + eta * eye, rhs)
    w = base.clamp(wt.mT, cfg.zero_threshold)
    state = dataclasses.replace(state, w=w, h=h)
    if not check:
        return state
    return base.check_convergence(state, cfg, a=a,
                                  use_class=cfg.use_class_stop,
                                  use_tolx=True, use_tolfun=True,
                                  shard=shard)
