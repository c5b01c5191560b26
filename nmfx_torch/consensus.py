"""Cluster labels and connectivity consensus (counterpart of
``nmfx/consensus.py``; reference ``nmf.r:121-144``)."""

from __future__ import annotations

import torch


def labels_from_h(h: torch.Tensor, rule: str = "argmax") -> torch.Tensor:
    """Per-sample cluster label from H (..., k, n) → (..., n) int32.

    ``argmax`` = intended BROAD semantics (dominant metagene); ``argmin`` =
    the reference R layer's observed behavior (nmf.r:128). Ties go to the
    first index, as in the reference.
    """
    if rule == "argmax":
        return torch.argmax(h, dim=-2).to(torch.int32)
    if rule == "argmin":
        return torch.argmin(h, dim=-2).to(torch.int32)
    raise ValueError(f"rule must be 'argmax' or 'argmin', got {rule!r}")


def connectivity(labels: torch.Tensor) -> torch.Tensor:
    """0/1 connectivity matrix of one labelling (n,) -> (n, n) float32."""
    return (labels[:, None] == labels[None, :]).to(torch.float32)


def one_hot(labels: torch.Tensor, k: int) -> torch.Tensor:
    """(R, n) labels → (R, n, k) float32 one-hot; a label of -1 (a masked
    lane) gives an all-zero row, as ``jax.nn.one_hot`` does."""
    return (labels[..., None].long()
            == torch.arange(k, device=labels.device)).to(torch.float32)


def consensus_matrix(labels: torch.Tensor, k: int) -> torch.Tensor:
    """Mean connectivity across restarts: (R, n) labels → (n, n) float32,
    C = (1/R) Σ_r E_r E_rᵀ with E_r the n×k one-hot label matrix."""
    e = one_hot(labels, k)
    return torch.einsum("rik,rjk->ij", e, e) / labels.shape[0]
