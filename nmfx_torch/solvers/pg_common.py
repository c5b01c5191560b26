"""Projected-gradient NNLS subproblem (Lin 2007), shared by pg and alspg
(counterpart of ``nmfx/solvers/pg_common.py``; reference
``libnmf/pg_subprob_h.c:75-202``, ``pg_subprob_w.c:78-208``). Both
half-problems are

    min_{X >= 0}  1/2 <X, G X> - <C, X>     (G = the k×k Gram, C = cross term)

— for H: G = WᵀW, C = WᵀA, X = H; for W: G = HHᵀ, C = HAᵀ, X = Wᵀ.

Line-search semantics follow the reference: the step ``alpha`` persists
across outer iterations, up to ``ls_max_steps`` trials, shrink/grow
factor ``ls_beta``, sufficient decrease ``(1 − ls_sigma)·⟨g,d⟩ +
0.5·⟨Gd,d⟩ < 0``, the direction fixed by the first trial, and the
previous-candidate-equality bailout in grow mode.

The reference's nested ``lax.while_loop``s run under ``jax.vmap`` until
every lane's own condition is false, each lane frozen once its condition
fails. Here each is a host loop over a lane mask: a trial runs on every
lane, keeps the results of the lanes still running, and reads "is any
lane still running" once (``HostReads``). Only the lanes in ``live`` (the
lanes whose outer results are kept) take part.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nmfx_torch.solvers.base import (HostReads, bf16_products, clamp,
                                     keep_lanes, lane_scalar, lane_sum, mm)


class SubprobResult(NamedTuple):
    x: torch.Tensor
    grad: torch.Tensor  # gradient at the returned x
    iterations: torch.Tensor  # per-lane outer iterations entered


def projgrad_norm_sq(grad: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-lane squared norm of the projected gradient: entries where
    grad < 0 or x > 0 (reference pg_subprob_h.c:102-106)."""
    mask = (grad < 0) | (x > 0)
    return lane_sum(torch.where(mask, grad * grad, torch.zeros_like(grad)))


def _line_search(x, grad, gram, alpha0, cfg, live, reads: HostReads):
    """One inner search per lane: returns (new x, new alpha)."""
    zt, sigma, beta = cfg.zero_threshold, cfg.ls_sigma, cfg.ls_beta
    bf = bf16_products(cfg, x.device)
    alpha, xp, xres = alpha0, x, x
    finished = torch.zeros_like(live)
    decrease = torch.zeros_like(live)
    for trial in range(1, cfg.ls_max_steps + 1):
        running = live & ~finished
        if not reads.any(running):
            break
        xn = clamp(x - lane_scalar(alpha) * grad, zt)
        d = xn - x
        suff = ((1.0 - sigma) * lane_sum(grad * d)
                + 0.5 * lane_sum(mm(gram, d, bf) * d)) < 0
        if trial == 1:
            dec, xp_t = ~suff, x
        else:
            dec, xp_t = decrease, xp
        eq = (xp_t == xn).all(dim=-1).all(dim=-1)
        stop_decr = dec & suff
        stop_grow = ~dec & (~suff | eq)
        fin = stop_decr | stop_grow
        xres_t = torch.where(lane_scalar(stop_decr), xn,
                             torch.where(lane_scalar(stop_grow), xp_t, xres))
        alpha_t = torch.where(fin, alpha,
                              torch.where(dec, alpha * beta, alpha / beta))
        xp_t = torch.where(lane_scalar(fin | dec), xp_t, xn)
        alpha, xp, xres, finished, decrease = keep_lanes(
            running, (alpha_t, xp_t, xres_t, fin, dec),
            (alpha, xp, xres, finished, decrease))
    return xres, alpha


def solve_subproblem(gram, ctc, x0, tol, cfg, live,
                     reads: HostReads) -> SubprobResult:
    """Projected-gradient descent on the NNLS subproblem, per lane, to
    the absolute tolerance ``tol`` (a number or per-lane) on the
    projected-gradient norm, or ``cfg.sub_max_iter`` outer iterations."""
    x = x0
    bf = bf16_products(cfg, x0.device)
    alpha = torch.ones(live.shape, dtype=x0.dtype, device=x0.device)
    its = torch.zeros(live.shape, dtype=torch.int32, device=x0.device)
    done = torch.zeros_like(live)
    for it in range(cfg.sub_max_iter):
        running = live & ~done
        if not reads.any(running):
            break
        grad = mm(gram, x, bf) - ctc
        hit = torch.sqrt(projgrad_norm_sq(grad, x)) < tol
        x_new, alpha_new = _line_search(x, grad, gram, alpha, cfg,
                                        running & ~hit, reads)
        x_t = torch.where(lane_scalar(hit), x, x_new)
        alpha_t = torch.where(hit, alpha, alpha_new)
        x, alpha, done = keep_lanes(running, (x_t, alpha_t, hit),
                                    (x, alpha, done))
        its = torch.where(running, it + 1, its)
    return SubprobResult(x, mm(gram, x, bf) - ctc, its)
