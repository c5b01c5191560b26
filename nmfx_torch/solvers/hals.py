"""HALS NMF (Cichocki & Phan 2009; counterpart of
``nmfx/solvers/hals.py``).

Hierarchical alternating least squares: per sweep the same two large
products as mu (WᵀA and AHᵀ, plus the k×k Grams), then coordinate-wise
exact minimizations, each component against the current values of the
others:

    for j = 1..k:   H[j,:] ← max(H[j,:] + ((WᵀA)[j,:] − (WᵀW)[j,:]·H)
                                  / ((WᵀW)[j,j] + ε), 0)
    for j = 1..k:   W[:,j] ← max(W[:,j] + ((AHᵀ)[:,j] − W·(HHᵀ)[:,j])
                                  / ((HHᵀ)[j,j] + ε), 0)

(the W pass uses the fresh H). ``ε`` (``div_eps``) keeps a dead
component's division finite; the max is the zero-threshold clamp.
Convergence: class stability when enabled, TolX and TolFun at every
``check_every``-th iteration.

The two sweeps take lane-batched factors, (B, m, k) and (B, k, n): the
single-restart step runs them at B = 1, the batched restart route at
B = the restarts, the whole grid's dense layout
(``nmfx_torch.ops.grid_mu.hals_block``) and the plain version of the
HALS block kernel at B = the pool's lanes.
"""

from __future__ import annotations

import dataclasses

import torch

from nmfx_torch.solvers import base
from nmfx_torch.solvers.base import clamp


def hals_h_sweep(a, w, h, eps: float, zero_threshold: float,
                 bf16: bool = False):
    """The H half: the shared products once, then the k coordinate
    updates in order, each against the rows already updated
    (Gauss–Seidel). ``w`` (B, m, k), ``h`` (B, k, n); returns a new H.
    ``bf16``: every product's operands rounded (``base.mm``)."""
    return hals_h_sweep_from(base.einsum("bmk,mn->bkn", w, a, bf16),
                             base.einsum("bmk,bml->bkl", w, w, bf16), h,
                             eps, zero_threshold, bf16)


def hals_h_sweep_from(wta, wtw, h, eps: float, zero_threshold: float,
                      bf16: bool = False):
    """The H half's sweep from its products WᵀA (B, k, n) and WᵀW
    (B, k, k)."""
    h = h.clone()
    for jj in range(h.shape[1]):
        num = wta[:, jj, :] - base.einsum("bl,bln->bn", wtw[:, jj, :], h,
                                          bf16)
        hj = h[:, jj, :] + num / (wtw[:, jj, jj, None] + eps)
        h[:, jj, :] = clamp(hj, zero_threshold)
    return h


def hals_w_sweep(a, w, h, eps: float, zero_threshold: float,
                 bf16: bool = False):
    """The W half against the fresh H, in the same component order;
    returns a new W."""
    return hals_w_sweep_from(base.einsum("mn,bkn->bmk", a, h, bf16),
                             base.einsum("bkn,bln->bkl", h, h, bf16), w,
                             eps, zero_threshold, bf16)


def hals_w_sweep_from(aht, hht, w, eps: float, zero_threshold: float,
                      bf16: bool = False):
    """The W half's sweep from its products AHᵀ (B, m, k) and HHᵀ
    (B, k, k)."""
    w = w.clone()
    for jj in range(w.shape[2]):
        num = aht[:, :, jj] - base.einsum("bmk,bk->bm", w, hht[:, :, jj],
                                          bf16)
        wj = w[:, :, jj] + num / (hht[:, jj, jj, None] + eps)
        w[:, :, jj] = clamp(wj, zero_threshold)
    return w


def init_aux(a, w0, h0, cfg, shard=None):
    return ()


def step(a, state: base.State, cfg, check: bool = True,
         shard: "base.ShardInfo | None" = None) -> base.State:
    eps, zt = cfg.div_eps, cfg.zero_threshold
    one = state.w.dim() == 2  # one restart: a lane axis of 1
    w0, h0 = (state.w[None], state.h[None]) if one else (state.w, state.h)
    bf = base.bf16_products(cfg, a.device)
    if shard is None:
        h = hals_h_sweep(a, w0, h0, eps, zt, bf)
        w = hals_w_sweep(a, w0, h, eps, zt, bf)
    else:
        # the shared products sum over their contracted grid axis; the
        # coordinate sweeps run on the local rows / columns
        fsum, ssum = base.shard_reducers(shard)
        h = hals_h_sweep_from(*fsum(base.einsum("bmk,mn->bkn", w0, a, bf),
                                    base.einsum("bmk,bml->bkl", w0, w0, bf)),
                              h0, eps, zt, bf)
        w = hals_w_sweep_from(*ssum(base.einsum("mn,bkn->bmk", a, h, bf),
                                    base.einsum("bkn,bln->bkl", h, h, bf)),
                              w0, eps, zt, bf)
    state = dataclasses.replace(state, w=w[0] if one else w,
                                h=h[0] if one else h)
    if not check:
        return state
    return base.check_convergence(state, cfg, a=a,
                                  use_class=cfg.use_class_stop,
                                  use_tolx=True, use_tolfun=True,
                                  shard=shard)
