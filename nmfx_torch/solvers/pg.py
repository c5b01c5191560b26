"""Direct projected-gradient NMF (Lin 2007, joint W/H step; counterpart
of ``nmfx/solvers/pg.py``; reference ``libnmf/nmf_pg.c:85-473``).

Per iteration: the gradients of ½‖A − WH‖² in both factors, and a
projected step ``(W, H) ← max((W, H) − α·∇, 0)`` whose α is adapted ×/÷
``ls_beta`` under the test ``newobj − obj ≤ ls_sigma·⟨∇, Δ⟩``, with the
equal-candidate bailout in grow mode. Iteration 1 instead polishes H with
the NNLS subproblem at absolute tolerance 0.001 and seeds the objective.
Stops with PG_TOL when the projected-gradient norm falls below
``tol_pg ×`` its initial value; the search is bounded at 40 trials.

The reference's ``lax.cond(iteration == 1, …)`` is uniform across lanes
(every lane starts together), so here it is a branch on the host clock.
pg never runs the generic checks, so it has no numeric quarantine, as in
the reference.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from nmfx_torch.solvers import base
from nmfx_torch.solvers.base import keep_lanes, lane_scalar, lane_sum
from nmfx_torch.solvers.pg_common import projgrad_norm_sq, solve_subproblem

_MAX_TRIALS = 40


class Aux(NamedTuple):
    initgrad: torch.Tensor
    obj: torch.Tensor  # 1/2 ||A - W H||_F^2
    alpha: torch.Tensor


def init_aux(a, w0, h0, cfg):
    lanes = dict(size=w0.shape[:-2], dtype=w0.dtype, device=w0.device)
    return Aux(torch.zeros(**lanes), torch.zeros(**lanes),
               torch.ones(**lanes))


def _grads(a, w, h, bf16: bool = False):
    mm = base.mm
    gradw = mm(w, mm(h, h.mT, bf16), bf16) - mm(a, h.mT, bf16)
    gradh = mm(mm(w.mT, w, bf16), h, bf16) - mm(w.mT, a, bf16)
    return gradw, gradh


def _objective(a, w, h, bf16: bool = False):
    d = a - base.mm(w, h, bf16)
    return 0.5 * lane_sum(d * d)


def _live(state: base.State) -> torch.Tensor:
    if state.active is not None:
        return state.active
    return torch.ones_like(state.done)


def _joint_search(a, w, h, gradw, gradh, obj, alpha0, cfg, live,
                  reads: base.HostReads):
    """Adaptive-step projected line search on the joint (W, H) move, per
    lane; returns (W, H, objective, alpha)."""
    sigma, beta, zt = cfg.ls_sigma, cfg.ls_beta, cfg.zero_threshold
    bf = base.bf16_products(cfg, a.device)

    def trial(alpha):
        wn = base.clamp(w - lane_scalar(alpha) * gradw, zt)
        hn = base.clamp(h - lane_scalar(alpha) * gradh, zt)
        newobj = _objective(a, wn, hn, bf)
        compval = lane_sum(gradw * (wn - w)) + lane_sum(gradh * (hn - h))
        return wn, hn, newobj, (newobj - obj) > sigma * compval

    wp, hp, objp, decrease = trial(alpha0)  # the first trial fixes it
    alpha, wres, hres, objres = alpha0, w, h, obj
    finished = torch.zeros_like(live)
    for _ in range(_MAX_TRIALS):
        running = live & ~finished
        if not reads.any(running):
            break
        alpha_t = torch.where(decrease, alpha * beta, alpha / beta)
        wn, hn, newobj, fail = trial(alpha_t)
        eq = ((wn == wp).all(dim=-1).all(dim=-1)
              & (hn == hp).all(dim=-1).all(dim=-1))
        stop_decr = decrease & ~fail
        stop_grow = ~decrease & (fail | eq)
        fin = stop_decr | stop_grow
        sd, sg = lane_scalar(stop_decr), lane_scalar(stop_grow)
        wres_t = torch.where(sd, wn, torch.where(sg, wp, wres))
        hres_t = torch.where(sd, hn, torch.where(sg, hp, hres))
        objres_t = torch.where(stop_decr, newobj,
                               torch.where(stop_grow, objp, objres))
        # grow mode backs alpha off to the accepted candidate's step
        alpha_t = torch.where(stop_grow, alpha_t * beta, alpha_t)
        keep = fin | decrease
        wp_t = torch.where(lane_scalar(keep), wp, wn)
        hp_t = torch.where(lane_scalar(keep), hp, hn)
        objp_t = torch.where(keep, objp, newobj)
        (alpha, wp, hp, objp, wres, hres, objres, finished) = keep_lanes(
            running,
            (alpha_t, wp_t, hp_t, objp_t, wres_t, hres_t, objres_t, fin),
            (alpha, wp, hp, objp, wres, hres, objres, finished))
    return wres, hres, objres, alpha


def step(a, state: base.State, cfg, check: bool = True) -> base.State:
    # pg's test is its own projected-gradient norm, every iteration, as
    # the reference does: ``check`` is unused
    del check
    aux: Aux = state.aux
    w, h = state.w, state.h
    bf = base.bf16_products(cfg, a.device)
    gradw, gradh = _grads(a, w, h, bf)
    if state.iteration == 1:
        initgrad = torch.sqrt(lane_sum(gradw * gradw)
                              + lane_sum(gradh * gradh))
        res = solve_subproblem(base.mm(w.mT, w, bf), base.mm(w.mT, a, bf),
                               h, 0.001, cfg, _live(state), state.reads)
        obj = _objective(a, w, res.x, bf)
        return dataclasses.replace(state, h=res.x,
                                   aux=Aux(initgrad, obj, aux.alpha))
    projnorm = torch.sqrt(projgrad_norm_sq(gradw, w)
                          + projgrad_norm_sq(gradh, h))
    hit = projnorm < cfg.tol_pg * aux.initgrad
    wn, hn, obj, alpha = _joint_search(a, w, h, gradw, gradh, aux.obj,
                                       aux.alpha, cfg, _live(state) & ~hit,
                                       state.reads)
    return dataclasses.replace(
        state,
        w=torch.where(lane_scalar(hit), w, wn),
        h=torch.where(lane_scalar(hit), h, hn),
        done=state.done | hit,
        stop_reason=torch.where(hit, int(base.StopReason.PG_TOL),
                                state.stop_reason).to(torch.int32),
        aux=Aux(aux.initgrad, torch.where(hit, aux.obj, obj),
                torch.where(hit, aux.alpha, alpha)))
