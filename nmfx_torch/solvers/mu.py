"""Multiplicative-update NMF (counterpart of ``nmfx/solvers/mu.py``;
reference ``libnmf/nmf_mu.c:174-216``).

Update rule per iteration:

    H ← H ∘ (WᵀA) / (WᵀW·H + ε),  then the zero-threshold clamp
    W ← W ∘ (AHᵀ) / (W·HHᵀ + ε)   (using the new H), then the clamp

with the exact-zero short-circuit: an element whose previous value or
numerator is exactly 0 stays 0. ``_mu_update`` is the plain epilogue the
hand-written kernels' epilogue must equal (``nmfx_torch/csrc``,
``mu_epilogue``).
"""

from __future__ import annotations

import dataclasses

import torch

from nmfx_torch.solvers import base
from nmfx_torch.solvers.base import clamp


def _mu_update(prev: torch.Tensor, numer: torch.Tensor,
               denom: torch.Tensor, div_eps: float,
               zero_threshold: float) -> torch.Tensor:
    ratio = prev * (numer / (denom + div_eps))
    ratio = torch.where((prev == 0) | (numer == 0),
                        torch.zeros_like(ratio), ratio)
    return clamp(ratio, zero_threshold)


def init_aux(a, w0, h0, cfg):
    return ()


def step(a, state: base.State, cfg, check: bool = True) -> base.State:
    w0, h0 = state.w, state.h  # one restart's, or (B, ·, ·) lanes
    h = _mu_update(h0, w0.mT @ a, (w0.mT @ w0) @ h0, cfg.div_eps,
                   cfg.zero_threshold)
    w = _mu_update(w0, a @ h.mT, w0 @ (h @ h.mT), cfg.div_eps,
                   cfg.zero_threshold)
    state = dataclasses.replace(state, w=w, h=h)
    if not check:
        return state
    return base.check_convergence(state, cfg, use_class=cfg.use_class_stop,
                                  use_tolx=True)
