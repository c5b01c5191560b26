"""Normal-equation ALS NMF (counterpart of ``nmfx/solvers/neals.py``;
reference ``libnmf/nmf_neals.c:180-470``):

    H = max((WᵀW) \\ (WᵀA), 0)
    W = max(((HHᵀ) \\ (HAᵀ))ᵀ, 0)

solved on the k×k Grams by the jittered Cholesky of
:func:`nmfx_torch.solvers.base.solve_gram_reg` (the reference's dgesv
with a lazy QR fallback becomes one well-posed path). Convergence: TolX
and TolFun at every ``check_every``-th iteration. Lane-polymorphic, as
every step (see ``base``).
"""

from __future__ import annotations

import dataclasses

from nmfx_torch.solvers import base


def init_aux(a, w0, h0, cfg, shard=None):
    return ()


def step(a, state: base.State, cfg, check: bool = True,
         shard: "base.ShardInfo | None" = None) -> base.State:
    w0 = state.w
    bf, mm = base.bf16_products(cfg, a.device), base.mm
    fsum, ssum = base.shard_reducers(shard)
    h = base.clamp(base.solve_gram_reg(*fsum(mm(w0.mT, w0, bf),
                                             mm(w0.mT, a, bf))),
                   cfg.zero_threshold)
    wt = base.solve_gram_reg(*ssum(mm(h, h.mT, bf), mm(h, a.T, bf)))
    w = base.clamp(wt.mT, cfg.zero_threshold)
    state = dataclasses.replace(state, w=w, h=h)
    if not check:
        return state
    return base.check_convergence(state, cfg, a=a, use_tolx=True,
                                  use_tolfun=True, shard=shard)
