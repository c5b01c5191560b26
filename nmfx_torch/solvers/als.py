"""Alternating least squares NMF (counterpart of ``nmfx/solvers/als.py``;
reference ``libnmf/nmf_als.c:209-360``): each half-step is the
unconstrained minimum-norm least-squares solve of one factor against the
other, then the zero-threshold clamp:

    H = argmin ‖W·X − A‖_F   → min-norm least squares, clamp
    W = argmin ‖Xᵀ·H − A‖_F  → min-norm least squares, clamp

The reference pivots its QR (dgeqp3) for rank deficiency; nmfx takes the
SVD minimum-norm solution instead, and so does :func:`lstsq_min_norm`
here. ``torch.linalg.lstsq`` will not do: on CUDA it offers only
``gels`` (QR, full rank assumed), and the zero-padded lanes of the packed
grid and a dying component make a factor exactly rank-deficient.
Convergence: TolX and TolFun at every ``check_every``-th iteration.
"""

from __future__ import annotations

import dataclasses

import torch

from nmfx_torch.solvers import base
from nmfx_torch.solvers.base import lane_scalar


def init_aux(a, w0, h0, cfg):
    return ()


def lstsq_min_norm(f: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """min_X ‖f·X − b‖_F, minimum-norm for a rank-deficient f, batched
    over f's leading axes: the SVD form of JAX's ``jnp.linalg.lstsq``
    (``jax/_src/numpy/linalg.py::_lstsq``): singular values below
    ``eps·max(m, k)·s[0]`` (or zero) count as zero. ``torch.linalg.svd``
    raises on a non-finite matrix where JAX's returns NaN, so such a lane
    is factored as zeros and its solution set to NaN, for the numeric
    quarantine to stop it."""
    m, k = f.shape[-2:]
    bad = lane_scalar(~torch.isfinite(f).all(dim=-1).all(dim=-1))
    u, s, vt = torch.linalg.svd(torch.where(bad, 0.0, f),
                                full_matrices=False)
    rcond = torch.finfo(f.dtype).eps * max(m, k)
    mask = (s > 0) & (s >= rcond * s[..., :1])
    safe_s = torch.where(mask, s, torch.ones_like(s))
    s_inv = torch.where(mask, 1 / safe_s, torch.zeros_like(s))[..., None]
    return torch.where(bad, torch.nan, vt.mT @ (s_inv * (u.mT @ b)))


def step(a, state: base.State, cfg, check: bool = True) -> base.State:
    h = base.clamp(lstsq_min_norm(state.w, a), cfg.zero_threshold)
    # W: min ||Hᵀ X - Aᵀ|| for X = Wᵀ
    w = base.clamp(lstsq_min_norm(h.mT, a.T).mT, cfg.zero_threshold)
    state = dataclasses.replace(state, w=w, h=h)
    if not check:
        return state
    return base.check_convergence(state, cfg, a=a, use_tolx=True,
                                  use_tolfun=True)
