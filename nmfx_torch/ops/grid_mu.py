"""The dense-batched iteration blocks shared by the whole-grid routes
(counterpart of ``nmfx/ops/grid_mu.py``, mu and hals).

Jobs of mixed rank ride one batch as zero-padded ``(B, m, k_max)`` /
``(B, k_max, n)`` lanes: the padded columns of W and rows of H are exact
zeros, which both rules keep zero (mu's exact-zero short-circuit; hals'
zero numerator over an eps-guarded zero diagonal), so every lane
iterates exactly its true-rank factorization.
"""

from __future__ import annotations

import dataclasses

import torch

from nmfx_torch.ops.packed_mu import residual_norms_direct
from nmfx_torch.solvers.base import StopReason
from nmfx_torch.solvers.hals import hals_h_sweep, hals_w_sweep
from nmfx_torch.solvers.mu import _mu_update


def mu_block(a, wp, hp, done_mask, cfg):
    """ONE dense-batched MU iteration (the reference's f32 branch):
    batched einsums over the lane axis, with lanes under ``done_mask``
    frozen. Plain PyTorch products, as the reference leaves these to
    XLA."""
    numerh = torch.einsum("bmk,mn->bkn", wp, a)
    gw = torch.einsum("bmk,bml->bkl", wp, wp)
    h = _mu_update(hp, numerh, torch.bmm(gw, hp), cfg.div_eps,
                   cfg.zero_threshold)
    gh = torch.einsum("bkn,bln->bkl", h, h)
    numerw = torch.einsum("mn,bkn->bmk", a, h)
    w = _mu_update(wp, numerw, torch.bmm(wp, gh), cfg.div_eps,
                   cfg.zero_threshold)
    frozen = done_mask[:, None, None]
    return torch.where(frozen, wp, w), torch.where(frozen, hp, h)


def hals_block(a, wp, hp, done_mask, cfg):
    """ONE dense-batched HALS iteration (Cichocki & Phan 2009; see
    ``nmfx_torch.solvers.hals`` for the per-restart form): the two shared
    products batch over every lane as in :func:`mu_block`, the k
    coordinate minimizations run as (B, n) / (B, m) updates. Zero-padded
    components are invariant: their numerators are zero, the eps-guarded
    diagonal keeps the division finite, and their Gram cross-terms with
    real components are zero."""
    eps, zt = cfg.div_eps, cfg.zero_threshold
    h = hals_h_sweep(a, wp, hp, eps, zt)
    w = hals_w_sweep(a, wp, h, eps, zt)
    frozen = done_mask[:, None, None]
    return torch.where(frozen, wp, w), torch.where(frozen, hp, h)


#: per-algorithm dense-batched blocks, and whether each uses the TolFun
#: test and the class-stability stop, as its per-restart solver does
#: (mu = class + TolX; hals = class + TolX + TolFun)
BLOCKS = {"mu": mu_block, "hals": hals_block}
USES_TOLFUN = {"mu": False, "hals": True}
USES_CLASS = {"mu": True, "hals": True}


def conv_cfg(cfg):
    """Normalize the config for the batched convergence path: an
    algorithm that never uses the class-stability stop must not gain it
    from the shared ``batch_convergence``."""
    if cfg.use_class_stop and not USES_CLASS[cfg.algorithm]:
        return dataclasses.replace(cfg, use_class_stop=False)
    return cfg


def make_block(cfg, a_full):
    """The per-iteration block for ``cfg.algorithm`` (mu and hals need no
    data-dependent auxiliaries)."""
    del a_full
    return BLOCKS[cfg.algorithm]


def tolfun_update(a, w, h, it, cfg, *, dnorm, done, done_in, stop_reason):
    """The TolFun test of the batched solves (the rule of
    ``base.check_convergence``: relative residual decrease against the
    previous check, after the class and TolX tests of the same check).
    ``it`` is the (B,) per-lane iteration count; the residual is the
    direct form (the Gram-trace identity's cancellation noise would fire
    the decrease test near convergence). Returns (dnorm, done,
    stop_reason)."""
    is_check = (it > 1) & (it % cfg.check_every == 0)
    active = is_check & ~done_in
    new_dnorm = residual_norms_direct(a, w, h)
    hit = (active & torch.isfinite(dnorm)
           & (dnorm - new_dnorm <= cfg.tol_fun * dnorm) & ~done)
    dnorm = torch.where(active, new_dnorm, dnorm)
    stop_reason = torch.where(hit, int(StopReason.TOL_FUN), stop_reason)
    return dnorm, done | hit, stop_reason.to(torch.int32)
