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
there, and the slot count bounds it on the packed grid.
"""

from __future__ import annotations

import dataclasses

import torch

from nmfx_torch.solvers import base


def init_aux(a, w0, h0, cfg):
    return ()


def kl_divergence(a, w, h, eps: float = 1e-9):
    """Generalized KL divergence D(A ‖ WH) per lane (0 ≤, 0 iff A == WH),
    with 0·log 0 = 0."""
    wh = w @ h + eps
    logq = torch.where(a > 0, torch.log(a.clamp(min=eps) / wh), 0.0)
    return base.lane_sum(a * logq - a + wh)


def step(a, state: base.State, cfg, check: bool = True) -> base.State:
    w0, h0 = state.w, state.h
    eps = cfg.div_eps
    q = a / (w0 @ h0 + eps)
    h = h0 * (w0.mT @ q) / (w0.sum(dim=-2)[..., :, None] + eps)
    h = base.clamp(h, cfg.zero_threshold)
    del q  # one quotient live at a time
    q = a / (w0 @ h + eps)
    w = w0 * (q @ h.mT) / (h.sum(dim=-1)[..., None, :] + eps)
    w = base.clamp(w, cfg.zero_threshold)
    state = dataclasses.replace(state, w=w, h=h)
    if not check:
        return state
    return base.check_convergence(state, cfg, use_class=cfg.use_class_stop,
                                  use_tolx=True)
