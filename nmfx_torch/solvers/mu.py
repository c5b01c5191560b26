"""Multiplicative-update epilogue (counterpart of ``nmfx/solvers/mu.py``'s
``_mu_update``; reference ``libnmf/nmf_mu.c:174-216``).

    X ← X ∘ numer / (denom + ε), then the exact-zero short-circuit (an
    element whose previous value or numerator is exactly 0 stays 0), then
    the zero-threshold clamp.

This is the plain epilogue the hand-written kernels' epilogue must equal
(``nmfx_torch/csrc/fused_mu.cu``, ``mu_epilogue``).
"""

from __future__ import annotations

import torch

from nmfx_torch.solvers.base import clamp


def _mu_update(prev: torch.Tensor, numer: torch.Tensor,
               denom: torch.Tensor, div_eps: float,
               zero_threshold: float) -> torch.Tensor:
    ratio = prev * (numer / (denom + div_eps))
    ratio = torch.where((prev == 0) | (numer == 0),
                        torch.zeros_like(ratio), ratio)
    return clamp(ratio, zero_threshold)
