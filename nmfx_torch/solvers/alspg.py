"""ALS with projected-gradient subproblems (Lin 2007, alternating
variant; counterpart of ``nmfx/solvers/alspg.py``; reference
``libnmf/nmf_alspg.c:75-290``). Each outer iteration solves the W-then-H
NNLS subproblems with ``pg_common.solve_subproblem``, tightening a
subproblem's tolerance ×``ls_beta`` (0.1) whenever it converged in one
iteration, and stops with PG_TOL when the joint projected-gradient norm
falls below ``tol_pg ×`` its initial value, from the gradients the
previous iteration's subsolvers returned, as the reference does. No
numeric quarantine, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from nmfx_torch.solvers import base
from nmfx_torch.solvers.base import lane_scalar, lane_sum
from nmfx_torch.solvers.pg import _live
from nmfx_torch.solvers.pg_common import projgrad_norm_sq, solve_subproblem


class Aux(NamedTuple):
    gradw: torch.Tensor  # (…, m, k)
    gradh: torch.Tensor  # (…, k, n)
    initgrad: torch.Tensor
    tolw: torch.Tensor
    tolh: torch.Tensor


def init_aux(a, w0, h0, cfg):
    # the initial gradients of 1/2||A - WH||^2 (nmf_alspg.c:155-179)
    gradw = w0 @ (h0 @ h0.mT) - a @ h0.mT
    gradh = (w0.mT @ w0) @ h0 - w0.mT @ a
    initgrad = torch.sqrt(lane_sum(gradw * gradw) + lane_sum(gradh * gradh))
    tol0 = torch.clamp(torch.tensor(cfg.tol_pg, dtype=w0.dtype,
                                    device=w0.device), min=0.001) * initgrad
    return Aux(gradw, gradh, initgrad, tol0, tol0)


def step(a, state: base.State, cfg, check: bool = True) -> base.State:
    # alspg's test is its own projected-gradient norm, every iteration:
    # ``check`` is unused
    del check
    aux: Aux = state.aux
    w, h = state.w, state.h
    projnorm = torch.sqrt(projgrad_norm_sq(aux.gradw, w)
                          + projgrad_norm_sq(aux.gradh, h))
    hit = projnorm < cfg.tol_pg * aux.initgrad
    live = _live(state) & ~hit

    # the W subproblem on X = Wᵀ: gram = HHᵀ, cross = HAᵀ
    res_w = solve_subproblem(h @ h.mT, h @ a.T, w.mT, aux.tolw, cfg, live,
                             state.reads)
    w_new = res_w.x.mT
    tolw = torch.where(res_w.iterations == 1, cfg.ls_beta * aux.tolw,
                       aux.tolw)
    res_h = solve_subproblem(w_new.mT @ w_new, w_new.mT @ a, h, aux.tolh,
                             cfg, live, state.reads)
    tolh = torch.where(res_h.iterations == 1, cfg.ls_beta * aux.tolh,
                       aux.tolh)
    keep = lane_scalar(hit)
    return dataclasses.replace(
        state,
        w=torch.where(keep, w, w_new),
        h=torch.where(keep, h, res_h.x),
        done=state.done | hit,
        stop_reason=torch.where(hit, int(base.StopReason.PG_TOL),
                                state.stop_reason).to(torch.int32),
        aux=Aux(torch.where(keep, aux.gradw, res_w.grad.mT),
                torch.where(keep, aux.gradh, res_h.grad),
                aux.initgrad,
                torch.where(hit, aux.tolw, tolw),
                torch.where(hit, aux.tolh, tolh)))
