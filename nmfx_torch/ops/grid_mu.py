"""The dense-batched MU block shared by the whole-grid routes
(counterpart of ``nmfx/ops/grid_mu.py``, mu only).

Jobs of mixed rank ride one batch as zero-padded ``(B, m, k_max)`` /
``(B, k_max, n)`` lanes: the padded columns of W and rows of H are exact
zeros, which the mu epilogue's exact-zero short-circuit keeps zero, so
every lane iterates exactly its true-rank factorization.
"""

from __future__ import annotations

import dataclasses

import torch

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


#: per-algorithm dense-batched blocks, and whether each uses the TolFun
#: test and the class-stability stop (the port has mu)
BLOCKS = {"mu": mu_block}
USES_TOLFUN = {"mu": False}
USES_CLASS = {"mu": True}


def conv_cfg(cfg):
    """Normalize the config for the batched convergence path: an
    algorithm that never uses the class-stability stop must not gain it
    from the shared ``batch_convergence``."""
    if cfg.use_class_stop and not USES_CLASS[cfg.algorithm]:
        return dataclasses.replace(cfg, use_class_stop=False)
    return cfg


def make_block(cfg, a_full):
    """The per-iteration block for ``cfg.algorithm`` (mu needs no
    data-dependent auxiliaries)."""
    del a_full
    return BLOCKS[cfg.algorithm]
