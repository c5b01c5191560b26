"""The dense-batched iteration blocks shared by the whole-grid routes
(counterpart of ``nmfx/ops/grid_mu.py``): mu, hals, neals, als, snmf and
kl.

Jobs of mixed rank ride one batch as zero-padded ``(B, m, k_max)`` /
``(B, k_max, n)`` lanes: the padded columns of W and rows of H are exact
zeros, which every rule keeps zero (mu's and kl's zero numerators; hals'
zero numerator over an eps-guarded zero diagonal; the Gram solves' zero
right-hand rows over the jitter on their diagonal; als' minimum-norm
solution, which puts no weight on a zero singular direction), so every
lane iterates exactly its true-rank factorization. snmf's L1 coupling
is the exception, masked to each lane's true rank (``pad_live_mask``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from nmfx_torch.solvers.als import lstsq_min_norm
from nmfx_torch.solvers.base import (StopReason, bf16_products, clamp,
                                     einsum, mm, residual_norms,
                                     solve_gram_reg)
from nmfx_torch.solvers.hals import hals_h_sweep, hals_w_sweep
from nmfx_torch.solvers.mu import _mu_update


def _frozen(done_mask, wp, hp, w, h):
    """The new factors, but the old ones on lanes under ``done_mask``."""
    frozen = done_mask[:, None, None]
    return torch.where(frozen, wp, w), torch.where(frozen, hp, h)


def mu_block(a, wp, hp, done_mask, cfg):
    """ONE dense-batched MU iteration (the reference's f32 branch):
    batched einsums over the lane axis, with lanes under ``done_mask``
    frozen. Plain PyTorch products, as the reference leaves these to
    XLA (every one through ``base.mm``'s operand rounding, as in every
    block here)."""
    bf = bf16_products(cfg, a.device)
    numerh = einsum("bmk,mn->bkn", wp, a, bf)
    gw = einsum("bmk,bml->bkl", wp, wp, bf)
    h = _mu_update(hp, numerh, mm(gw, hp, bf), cfg.div_eps,
                   cfg.zero_threshold)
    gh = einsum("bkn,bln->bkl", h, h, bf)
    numerw = einsum("mn,bkn->bmk", a, h, bf)
    w = _mu_update(wp, numerw, mm(wp, gh, bf), cfg.div_eps,
                   cfg.zero_threshold)
    return _frozen(done_mask, wp, hp, w, h)


def hals_block(a, wp, hp, done_mask, cfg):
    """ONE dense-batched HALS iteration (Cichocki & Phan 2009; see
    ``nmfx_torch.solvers.hals`` for the per-restart form): the two shared
    products batch over every lane as in :func:`mu_block`, the k
    coordinate minimizations run as (B, n) / (B, m) updates. Zero-padded
    components are invariant: their numerators are zero, the eps-guarded
    diagonal keeps the division finite, and their Gram cross-terms with
    real components are zero."""
    eps, zt = cfg.div_eps, cfg.zero_threshold
    bf = bf16_products(cfg, a.device)
    h = hals_h_sweep(a, wp, hp, eps, zt, bf)
    w = hals_w_sweep(a, wp, h, eps, zt, bf)
    return _frozen(done_mask, wp, hp, w, h)


def neals_block(a, wp, hp, done_mask, cfg):
    """ONE dense-batched normal-equation ALS iteration (see
    ``solvers.neals``): H = max(G_w \\ WᵀA, 0), W = max((G_h \\ HAᵀ)ᵀ,
    0), the per-lane Grams and solves batched (``solve_gram_reg``; its
    jitter's trace/k uses k_max here, a 10·eps-scale difference from the
    true-rank lane). hp feeds only the frozen lanes: ALS re-derives H
    from W alone."""
    bf = bf16_products(cfg, a.device)
    gw = einsum("bmk,bml->bkl", wp, wp, bf)
    wta = einsum("bmk,mn->bkn", wp, a, bf)
    h = clamp(solve_gram_reg(gw, wta), cfg.zero_threshold)
    gh = einsum("bkn,bln->bkl", h, h, bf)
    hat = einsum("bkn,mn->bkm", h, a, bf)
    w = clamp(solve_gram_reg(gh, hat).mT, cfg.zero_threshold)
    return _frozen(done_mask, wp, hp, w, h)


def als_block(a, wp, hp, done_mask, cfg):
    """ONE dense-batched ALS iteration (see ``solvers.als``): each
    half-step the per-lane minimum-norm least-squares solve, batched, then
    the clamp. A zero-padded component is a zero singular direction, which
    the minimum-norm solution leaves at exact zero."""
    bf = bf16_products(cfg, a.device)
    h = clamp(lstsq_min_norm(wp, a, bf), cfg.zero_threshold)
    w = clamp(lstsq_min_norm(h.mT, a.T, bf).mT, cfg.zero_threshold)
    return _frozen(done_mask, wp, hp, w, h)


def snmf_block(a, wp, hp, done_mask, cfg, eta=None, pad_live=None):
    """ONE dense-batched sparse-NMF iteration (see ``solvers.snmf``). The
    H solve's β·ones coupling is masked to each lane's true-rank
    components (``pad_live``, (B, k_max) bool), so padding never couples
    into real components; a component that dies mid-solve keeps its place
    in the coupling, as in the per-restart form. ``eta`` (the W ridge) and
    ``pad_live`` come from the caller: ``make_block`` resolves η from the
    full A, the scheduler the masks from each job's rank."""
    if eta is None or pad_live is None:
        raise ValueError("snmf_block requires eta and pad_live resolved "
                         "by the caller (make_block(cfg, a) and the jobs' "
                         "padding masks)")
    f32 = wp.dtype
    ones_mask = (pad_live[:, :, None] & pad_live[:, None, :]).to(f32)
    bf = bf16_products(cfg, a.device)
    gw = einsum("bmk,bml->bkl", wp, wp, bf)
    wta = einsum("bmk,mn->bkn", wp, a, bf)
    h = clamp(solve_gram_reg(gw + cfg.sparsity_beta * ones_mask, wta),
              cfg.zero_threshold)
    gh = einsum("bkn,bln->bkl", h, h, bf)
    hat = einsum("bkn,mn->bkm", h, a, bf)
    eye = torch.eye(wp.shape[2], dtype=f32, device=wp.device)
    w = clamp(solve_gram_reg(gh + eta * eye, hat).mT, cfg.zero_threshold)
    return _frozen(done_mask, wp, hp, w, h)


def kl_block(a, wp, hp, done_mask, cfg):
    """ONE dense-batched KL-divergence iteration (Brunet rule, see
    ``solvers.kl``): each lane holds its m×n quotient, so the block's
    working set is (B, m, n) and the slot count bounds it
    (``sched_mu._kl_slot_clamp``). Under bf16 products the quotient
    reads the A it is given: full precision unless the scheduler rounded
    it (``experimental.kl_bf16_quotient``)."""
    eps = cfg.div_eps
    bf = bf16_products(cfg, a.device)
    q = a[None] / (mm(wp, hp, bf) + eps)
    numer = einsum("bmk,bmn->bkn", wp, q, bf)
    h = clamp(hp * numer / (wp.sum(dim=1)[:, :, None] + eps),
              cfg.zero_threshold)
    del q
    q = a[None] / (mm(wp, h, bf) + eps)
    numer = einsum("bmn,bkn->bmk", q, h, bf)
    w = clamp(wp * numer / (h.sum(dim=2)[:, None, :] + eps),
              cfg.zero_threshold)
    return _frozen(done_mask, wp, hp, w, h)


#: per-algorithm dense-batched blocks, and whether each uses the TolFun
#: test and the class-stability stop, as its per-restart solver does
#: (mu, kl = class + TolX; hals, snmf = class + TolX + TolFun; neals,
#: als = TolX + TolFun)
BLOCKS = {"mu": mu_block, "hals": hals_block, "neals": neals_block,
          "als": als_block, "snmf": snmf_block, "kl": kl_block}
USES_TOLFUN = {"mu": False, "hals": True, "neals": True, "als": True,
               "snmf": True, "kl": False}
USES_CLASS = {"mu": True, "hals": True, "neals": False, "als": False,
              "snmf": True, "kl": True}


def conv_cfg(cfg):
    """Normalize the config for the batched convergence path: an
    algorithm that never uses the class-stability stop must not gain it
    from the shared ``batch_convergence``."""
    if cfg.use_class_stop and not USES_CLASS[cfg.algorithm]:
        return dataclasses.replace(cfg, use_class_stop=False)
    return cfg


def pad_live_mask(w0, h0, job_ks=None):
    """(B, k_max) bool, True on each lane's true-rank components: the
    snmf coupling mask. With ``job_ks`` (per-lane true ranks) it is exact,
    ``col < k``; without, it is read from the initial factors (every true
    component of a random start is nonzero)."""
    k_max = w0.shape[2]
    if job_ks is not None:
        if len(job_ks) != w0.shape[0]:
            raise ValueError(
                f"job_ks has {len(job_ks)} entries but the lane batch "
                f"carries {w0.shape[0]} jobs")
        cols = torch.arange(k_max, device=w0.device)
        return cols[None, :] < torch.as_tensor(job_ks,
                                               device=w0.device)[:, None]
    return (w0 != 0).any(dim=1) | (h0 != 0).any(dim=2)


def make_block(cfg, a_full):
    """The per-iteration block for ``cfg.algorithm``, with snmf's η
    resolved once from the full A (``ridge_eta``, or max(A)²)."""
    if cfg.algorithm == "snmf":
        eta = (a_full.amax() ** 2 if cfg.ridge_eta is None
               else torch.tensor(cfg.ridge_eta, dtype=a_full.dtype,
                                 device=a_full.device))
        return functools.partial(snmf_block, eta=eta)
    return BLOCKS[cfg.algorithm]


def tolfun_update(a, w, h, it, cfg, *, dnorm, done, done_in, stop_reason,
                  bf16: bool = False):
    """The TolFun test of the batched solves (the rule of
    ``base.check_convergence``: relative residual decrease against the
    previous check, after the class and TolX tests of the same check).
    ``it`` is the (B,) per-lane iteration count; the residual is the
    direct form (the Gram-trace identity's cancellation noise would fire
    the decrease test near convergence; ``bf16``: its product's operands
    rounded). Returns (dnorm, done, stop_reason)."""
    is_check = (it > 1) & (it % cfg.check_every == 0)
    active = is_check & ~done_in
    new_dnorm = residual_norms(a, w, h, bf16)
    hit = (active & torch.isfinite(dnorm)
           & (dnorm - new_dnorm <= cfg.tol_fun * dnorm) & ~done)
    dnorm = torch.where(active, new_dnorm, dnorm)
    stop_reason = torch.where(hit, int(StopReason.TOL_FUN), stop_reason)
    return dnorm, done | hit, stop_reason.to(torch.int32)
