"""Shared single-restart solver loop (counterpart of
``nmfx/solvers/base.py``).

Every solver exposes

* ``init_aux(a, w0, h0, cfg) -> aux`` — solver-specific carry
* ``step(a, state, cfg, check) -> state`` — one full iteration, then its
  own convergence decision when ``check`` is set

and :func:`run_loop` drives it. The reference's ``lax.while_loop``
becomes a host loop: the iteration clock is a Python int, the
convergence bookkeeping stays on the device, and the host reads the
``done`` flag once per ``check_every`` iterations (once per iteration in
the tail that finishes a ``max_iter`` that is not a multiple of
``check_every``).

Convergence helpers mirror the reference's C utilities:
``residual_norm`` = calculateNorm (``libnmf/calculatenorm.c:44-78``),
``maxchange`` = calculateMaxchange (``libnmf/calculatemaxchange.c:42-71``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, NamedTuple

import torch

from nmfx_torch.config import SolverConfig
from nmfx_torch.device import resolve_device, to_device


class StopReason(enum.IntEnum):
    """Why a restart stopped; the integer values are the reference's, so
    saved results and stop-reason arrays compare across packages."""

    MAX_ITER = 0
    #: per-column argmax of H unchanged for `stable_checks` checks
    CLASS_STABLE = 1
    #: max-change of W and H below TolX
    TOL_X = 2
    #: relative residual decrease below TolFun
    TOL_FUN = 3
    #: projected-gradient norm below tol (pg/alspg)
    PG_TOL = 4
    #: numeric quarantine: the lane's factors went non-finite and it is
    #: masked out of the consensus like a pad lane
    NUMERIC_FAULT = 5
    #: restart screening cut the lane before its exact phase
    SCREENED = 6


@dataclasses.dataclass
class State:
    """Loop state. ``w``/``h`` are the current factors, ``w_prev``/
    ``h_prev`` the previous iteration's (for TolX); ``iteration`` is the
    host clock; the rest are 0-d device tensors (``classes`` (n,))."""

    w: torch.Tensor
    h: torch.Tensor
    w_prev: torch.Tensor
    h_prev: torch.Tensor
    iteration: int
    dnorm: torch.Tensor  # residual at the last check, inf until computed
    classes: torch.Tensor  # (n,) i32 label snapshot
    stable: torch.Tensor  # i32 consecutive stable checks
    done: torch.Tensor  # bool
    stop_reason: torch.Tensor  # i32 StopReason
    aux: Any


class SolverResult(NamedTuple):
    w: torch.Tensor
    h: torch.Tensor
    iterations: int
    dnorm: torch.Tensor  # final ||A - W H||_F / sqrt(m n)
    stop_reason: int


def residual_norm(a: torch.Tensor, w: torch.Tensor,
                  h: torch.Tensor) -> torch.Tensor:
    """RMS residual ||A - W H||_F / sqrt(m n)."""
    m, n = a.shape
    d = a - w @ h
    return torch.sqrt((d * d).sum() / (m * n))


def _sqrteps(dtype, device) -> torch.Tensor:
    return torch.sqrt(torch.tensor(torch.finfo(dtype).eps, dtype=dtype,
                                   device=device))


def maxchange(mat: torch.Tensor, mat0: torch.Tensor) -> torch.Tensor:
    """max|mat - mat0| / (sqrt(eps) + max|mat0|)."""
    diff = (mat - mat0).abs().amax()
    return diff / (_sqrteps(mat.dtype, mat.device) + mat0.abs().amax())


def class_labels(h: torch.Tensor) -> torch.Tensor:
    """Per-sample cluster label = argmax over H's rows (ties to the first
    row, as in the reference)."""
    return torch.argmax(h, dim=0).to(torch.int32)


def clamp(x: torch.Tensor, zero_threshold: float) -> torch.Tensor:
    """Zero out negatives and sub-threshold values (reference
    ZERO_THRESHOLD clamp)."""
    return torch.where(x <= zero_threshold, torch.zeros_like(x), x)


def check_convergence(state: State, cfg, *, a=None,
                      use_class: bool = False, use_tolx: bool = False,
                      use_tolfun: bool = False) -> State:
    """The generic convergence tests after a step (reference
    ``check_convergence`` without mesh axes). They run at every
    ``check_every``-th iteration after the first, on a restart not yet
    done: numeric quarantine first, then class stability, TolX and
    TolFun. The check gate is the host clock; the rest stays on the
    device."""
    it = state.iteration
    if not (it > 1 and it % cfg.check_every == 0):
        return state
    is_check = ~state.done
    done = state.done
    reason = state.stop_reason

    if cfg.nonfinite_guard:
        bad = ~(torch.isfinite(state.w).all() & torch.isfinite(state.h).all())
        faulted = is_check & bad
        done = done | faulted
        is_check = is_check & ~faulted
        reason = torch.where(faulted, int(StopReason.NUMERIC_FAULT), reason)

    classes, stable = state.classes, state.stable
    if use_class:
        # the noise-tolerant snapshot rule (see SolverConfig.class_flip_tol)
        new_classes = class_labels(state.h)
        flip_tol = int(cfg.class_flip_tol * new_classes.shape[0] + 1e-9)
        mism = (new_classes != state.classes).sum(dtype=torch.int32)
        same = mism <= flip_tol
        stable = torch.where(is_check, torch.where(same, state.stable + 1, 0),
                             state.stable).to(torch.int32)
        classes = torch.where(is_check & ~same, new_classes, state.classes)
        hit = is_check & (stable >= cfg.stable_checks)
        done = done | hit
        reason = torch.where(hit, int(StopReason.CLASS_STABLE), reason)

    if use_tolx and cfg.use_tol_checks:
        delta = torch.maximum(maxchange(state.w, state.w_prev),
                              maxchange(state.h, state.h_prev))
        hit = is_check & (delta < cfg.tol_x) & ~done
        done = done | hit
        reason = torch.where(hit, int(StopReason.TOL_X), reason)

    dnorm = state.dnorm
    if use_tolfun and cfg.use_tol_checks:
        new_dnorm = residual_norm(a, state.w, state.h)
        hit = (is_check & torch.isfinite(state.dnorm)
               & (state.dnorm - new_dnorm <= cfg.tol_fun * state.dnorm)
               & ~done)
        dnorm = torch.where(is_check, new_dnorm, state.dnorm)
        done = done | hit
        reason = torch.where(hit, int(StopReason.TOL_FUN), reason)

    return dataclasses.replace(state, classes=classes, stable=stable,
                               done=done, stop_reason=reason.to(torch.int32),
                               dnorm=dnorm)


def init_state(a: torch.Tensor, w0: torch.Tensor, h0: torch.Tensor,
               aux: Any) -> State:
    dev = w0.device
    return State(
        w=w0, h=h0, w_prev=w0, h_prev=h0, iteration=0,
        dnorm=torch.tensor(float("inf"), dtype=w0.dtype, device=dev),
        classes=torch.full((h0.shape[1],), -1, dtype=torch.int32,
                           device=dev),
        stable=torch.zeros((), dtype=torch.int32, device=dev),
        done=torch.zeros((), dtype=torch.bool, device=dev),
        stop_reason=torch.full((), int(StopReason.MAX_ITER),
                               dtype=torch.int32, device=dev),
        aux=aux)


def run_loop(a, w0, h0, cfg, step_fn, aux) -> SolverResult:
    """Drive ``step_fn`` to convergence: blocks of ``check_every``
    iterations whose last one runs the tests, then, if ``max_iter`` is not
    a multiple of ``check_every``, the last few iterations one at a time
    (each checked; the gate passes only on check iterations)."""
    state = init_state(a, w0, h0, aux)

    def one_step(state: State, check: bool) -> State:
        state = dataclasses.replace(state, w_prev=state.w, h_prev=state.h,
                                    iteration=state.iteration + 1)
        return step_fn(a, state, cfg, check)

    running = True  # nothing is done before the first iteration
    while running and state.iteration + cfg.check_every <= cfg.max_iter:
        for i in range(cfg.check_every):
            state = one_step(state, check=i == cfg.check_every - 1)
        running = not bool(state.done)
    while running and state.iteration < cfg.max_iter:
        state = one_step(state, check=True)
        running = not bool(state.done)
    return SolverResult(w=state.w, h=state.h, iterations=state.iteration,
                        dnorm=residual_norm(a, state.w, state.h),
                        stop_reason=int(state.stop_reason))


_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def solve(a, w0, h0, cfg=None, *, device=None) -> SolverResult:
    """Factorize A ≈ W·H from (W0, H0) with the configured algorithm
    (reference ``solve``; the port runs mu and hals).

    Plain PyTorch products on ``device`` (None = CUDA, raising if there is
    none; TF32 off there), in ``cfg.dtype``: "float32" or "float64".
    ``a``, ``w0``, ``h0`` are numpy arrays or tensors.
    """
    from nmfx_torch.solvers import SOLVERS  # imports this module

    cfg = SolverConfig() if cfg is None else cfg
    if cfg.algorithm not in SOLVERS:
        raise NotImplementedError(
            f"algorithm={cfg.algorithm!r} is not ported yet (ROADMAP "
            f"'Modules to port' item 8); the port runs {tuple(SOLVERS)}")
    if cfg.backend == "sketched":
        raise NotImplementedError(
            "backend='sketched' is not ported yet (ROADMAP 'Modules to "
            "port' item 12)")
    if cfg.matmul_precision == "bfloat16":
        raise NotImplementedError(
            "matmul_precision='bfloat16' is not ported yet (ROADMAP 'TPU "
            "kernels to port' item 1)")
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {tuple(_DTYPES)}, got "
                         f"{cfg.dtype!r}")
    dev = resolve_device(device)
    dtype = _DTYPES[cfg.dtype]
    a, w0, h0 = (to_device(x, dtype, dev) for x in (a, w0, h0))
    mod = SOLVERS[cfg.algorithm]
    return run_loop(a, w0, h0, cfg, mod.step, mod.init_aux(a, w0, h0, cfg))
