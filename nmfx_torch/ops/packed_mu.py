"""Restart-packed multiplicative-update solver (counterpart of
``nmfx/ops/packed_mu.py``, per-rank route without mesh axes).

The restart batch is laid out as one pair of packed factor matrices

    Wp = (m, R·k)   — restart-major column blocks
    Hp = (R·k, n)

so every per-iteration contraction is a single large product over the
shared data matrix A. Under ``backend="pallas"`` the two half-updates run
through the hand-written kernels (``nmfx_torch.ops.fused_mu``); under
``backend="packed"`` through their plain PyTorch versions.

Convergence bookkeeping (class stability + TolX, per-lane freeze,
numeric quarantine) stays on the device. The reference's
``lax.while_loop`` becomes a host loop whose shared iteration clock is a
Python int; the host reads the lanes' done flags once per loop trip (one
trip = ``check_block`` check blocks of ``check_every`` iterations), never
once per iteration, and counts those reads in ``host_syncs``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from nmfx_torch.config import SolverConfig, check_ported
from nmfx_torch.device import resolve_device
from nmfx_torch.ops.fused_mu import (fused_h_update, fused_h_update_ref,
                                     fused_w_update, fused_w_update_ref,
                                     lane_gram)
from nmfx_torch.solvers.base import StopReason


@dataclasses.dataclass
class PackedState:
    wp: torch.Tensor  # (m, R*k)
    hp: torch.Tensor  # (R*k, n)
    wp_prev: torch.Tensor
    hp_prev: torch.Tensor
    iteration: int  # shared batch clock, kept on the host
    classes: torch.Tensor  # (R, n) i32
    stable: torch.Tensor  # (R,) i32
    done: torch.Tensor  # (R,) bool
    done_iter: torch.Tensor  # (R,) i32 — iteration at which each lane stopped
    stop_reason: torch.Tensor  # (R,) i32
    #: (R,) bool sticky numeric-quarantine flag, or None without the guard
    nonfinite: "torch.Tensor | None" = None


class PackedMUResult(NamedTuple):
    wp: torch.Tensor  # (m, R*k) final packed factors
    hp: torch.Tensor  # (R*k, n)
    iterations: torch.Tensor  # (R,) i32
    dnorm: torch.Tensor  # (R,) final RMS residual per restart
    stop_reason: torch.Tensor  # (R,) i32 StopReason
    #: reads of the done flags by the host loop (device→host syncs)
    host_syncs: int = 0


def block_diag_mask(r: int, k: int, device) -> torch.Tensor:
    """(R·k, R·k) bool mask keeping only within-restart k×k blocks."""
    lane = torch.arange(r * k, device=device) // k
    return lane[:, None] == lane[None, :]


def bd_select(g: torch.Tensor, bd: torch.Tensor) -> torch.Tensor:
    """Apply the block-diagonal Gram mask as a SELECT, not a multiply: a
    non-finite cross-lane Gram entry becomes a true zero instead of
    ``NaN·0 = NaN``, so one diverged lane cannot leak into its
    batch-mates' denominators."""
    return torch.where(bd, g, torch.zeros((), dtype=g.dtype, device=g.device))


def pack(w0s: torch.Tensor, h0s: torch.Tensor
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(R,m,k),(R,k,n) → packed (m, R·k), (R·k, n)."""
    r, m, k = w0s.shape
    n = h0s.shape[2]
    return (w0s.permute(1, 0, 2).reshape(m, r * k).contiguous(),
            h0s.reshape(r * k, n).contiguous())


def unpack_w(wp: torch.Tensor, r: int) -> torch.Tensor:
    """Packed (m, R·k) → (R, m, k)."""
    m = wp.shape[0]
    return wp.reshape(m, r, wp.shape[1] // r).permute(1, 0, 2)


def padded_rows(m: int) -> int:
    """The row count the reference pads A and Wp to on its fused-kernel
    route: ``ceil(m / 512)`` tiles of a block height rounded up to 8.
    Zero rows are invariant under the mu epilogue's exact-zero
    short-circuit and add nothing to numerators or Grams."""
    tiles = -(-m // 512)
    return tiles * (-(-(-(-m // tiles)) // 8) * 8)


def _lanes_finite(x: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
    """Per-lane all-finite verdict of a lane-stacked factor array."""
    return torch.isfinite(x).all(dim=dims)


def residual_norms_direct(a: torch.Tensor, w: torch.Tensor,
                          h: torch.Tensor, chunk: int | None = None
                          ) -> torch.Tensor:
    """Per-lane RMS residual ‖A − WᵦHᵦ‖_F/√(mn) from (B, m, k) / (B, k, n)
    factor stacks, the direct way: one reconstruction per lane, at most
    ``chunk`` of them live at once (default: ~80 MB of them, capped at 8)."""
    b, m, _ = w.shape
    n = h.shape[2]
    if chunk is None:
        budget = 80 * 2**20  # bytes of live (chunk, m, n) reconstruction
        chunk = max(1, min(8, budget // (m * n * a.element_size())))
    sq = torch.cat([
        ((a[None] - torch.bmm(w[i:i + chunk], h[i:i + chunk])) ** 2
         ).sum(dim=(1, 2))
        for i in range(0, b, chunk)])
    return torch.sqrt(sq.clamp(min=0.0) / (m * n))


def _labels(hp: torch.Tensor, r: int) -> torch.Tensor:
    """(R·k, n) → per-restart argmax labels (R, n)."""
    return torch.argmax(hp.reshape(r, -1, hp.shape[1]), dim=1).to(
        torch.int32)


def flip_budget(class_flip_tol: float, n: int) -> int:
    """The class-stability flip budget ``floor(class_flip_tol · n)`` in
    exact double math (the +eps keeps 0.3·10 = 2.999… from landing one
    flip below the documented floor)."""
    return int(class_flip_tol * n + 1e-9)


def batch_convergence(cfg: SolverConfig, it, *, new_classes, delta,
                      n_glob: int, classes, stable, done, done_iter,
                      stop_reason, flip_floor=None, nonfinite=None):
    """(B,)-batched convergence bookkeeping: the noise-tolerant
    class-stability snapshot rule plus the TolX test, with per-lane
    freeze flags (reference ``batch_convergence``).

    ``it`` is either the shared host clock (an int: off a check boundary
    nothing changes, and no device work is issued) or a (B,) int tensor
    of per-lane iteration counts (the slot scheduler's, whose lanes are
    at different iterations): then the check gate
    ``(it > 1) & (it % check_every == 0)`` is taken per lane.
    ``flip_floor`` overrides the ``floor(class_flip_tol · n_glob)`` flip
    budget. A ``nonfinite`` lane stops FIRST with NUMERIC_FAULT. Returns
    the five updated arrays."""
    if torch.is_tensor(it):
        active = ((it > 1) & (it % cfg.check_every == 0)) & ~done
    elif it > 1 and it % cfg.check_every == 0:
        active = ~done
    else:
        return classes, stable, done, done_iter, stop_reason
    done_in = done
    reason = stop_reason

    if nonfinite is not None:
        bad = active & nonfinite
        done = done | bad
        active = active & ~bad
        reason = torch.where(bad, int(StopReason.NUMERIC_FAULT), reason)

    if cfg.use_class_stop:
        flip_tol = (flip_budget(cfg.class_flip_tol, n_glob)
                    if flip_floor is None else flip_floor)
        mism = (new_classes != classes).sum(dim=1, dtype=torch.int32)
        same = mism <= flip_tol
        stable = torch.where(active, torch.where(same, stable + 1, 0),
                             stable).to(torch.int32)
        reset = active & ~same
        classes = torch.where(reset[:, None], new_classes, classes)
        hit = active & (stable >= cfg.stable_checks)
        done = done | hit
        reason = torch.where(hit, int(StopReason.CLASS_STABLE), reason)

    if cfg.use_tol_checks:
        hit = active & (delta < cfg.tol_x) & ~done
        done = done | hit
        reason = torch.where(hit, int(StopReason.TOL_X), reason)

    newly = done & ~done_in
    done_iter = torch.where(newly, it, done_iter).to(torch.int32)
    return classes, stable, done, done_iter, reason.to(torch.int32)


def _step(a, bd, state: PackedState, cfg: SolverConfig, r: int,
          check: bool, use_kernels: bool) -> None:
    """One packed mu iteration, updating ``state`` in place."""
    k = state.hp.shape[0] // r
    wp0, hp0 = state.wp, state.hp
    kw = dict(k=k, eps=cfg.div_eps, zero_threshold=cfg.zero_threshold,
              matmul_precision=cfg.matmul_precision)
    if use_kernels:
        hp = fused_h_update(a, wp0, hp0, **kw)
        wp = fused_w_update(a, wp0, hp, lane_gram(
            hp, k=k, matmul_precision=cfg.matmul_precision), **kw)
    else:
        hp = fused_h_update_ref(a, wp0, hp0, **kw)
        gh = bd_select(hp @ hp.T, bd)  # small; plain product, as in nmfx
        wp = fused_w_update_ref(a, wp0, hp, gh, **kw)

    # numeric quarantine: a lane whose new factors are non-finite is
    # rolled back to its last finite iterate the same iteration, so the
    # shared operands stay finite; the sticky flag stops it with
    # NUMERIC_FAULT at its next check
    bad = state.nonfinite
    if cfg.nonfinite_guard:
        new_bad = ~(_lanes_finite(wp.reshape(-1, r, k), (0, 2))
                    & _lanes_finite(hp.reshape(r, k, -1), (1, 2)))
        bad = new_bad if bad is None else bad | new_bad

    # freeze converged (and quarantined) lanes
    frozen = state.done if bad is None else state.done | bad
    frozen_col = frozen.repeat_interleave(k)  # (R·k,)
    state.hp = torch.where(frozen_col[:, None], hp0, hp)
    state.wp = torch.where(frozen_col[None, :], wp0, wp)
    state.wp_prev, state.hp_prev = wp0, hp0
    state.iteration += 1
    state.nonfinite = bad
    if check:
        _check(state, cfg, r)


def _check(state: PackedState, cfg: SolverConfig, r: int) -> None:
    """Per-restart convergence tests (class stability first, then TolX)."""
    k = state.hp.shape[0] // r
    new_classes = _labels(state.hp, r)
    delta = None
    if cfg.use_tol_checks:
        sqrteps = torch.sqrt(torch.tensor(torch.finfo(state.wp.dtype).eps,
                                          dtype=state.wp.dtype))
        m, n = state.wp.shape[0], state.hp.shape[1]

        def _delta(cur, prev, dims, shape):
            diff = (cur - prev).abs().reshape(shape).amax(dim=dims)
            ref = prev.abs().reshape(shape).amax(dim=dims)
            return diff / (sqrteps.to(cur.device) + ref)

        dw = _delta(state.wp, state.wp_prev, (0, 2), (m, r, k))
        dh = _delta(state.hp, state.hp_prev, (1, 2), (r, k, n))
        delta = torch.maximum(dw, dh)  # (R,)

    (state.classes, state.stable, state.done, state.done_iter,
     state.stop_reason) = batch_convergence(
        cfg, state.iteration, new_classes=new_classes, delta=delta,
        n_glob=state.hp.shape[1], classes=state.classes,
        stable=state.stable, done=state.done, done_iter=state.done_iter,
        stop_reason=state.stop_reason, nonfinite=state.nonfinite)


def mu_packed(a, w0s, h0s, cfg: SolverConfig = SolverConfig(), *,
              device=None) -> PackedMUResult:
    """Solve the whole restart batch with packed mu iterations.

    Semantically the reference's ``mu_packed``: same update rule, same
    convergence tests, same freeze-on-convergence and quarantine. ``a``
    (m, n), ``w0s`` (R, m, k), ``h0s`` (R, k, n) are numpy arrays or
    tensors; they move to ``device`` (None = CUDA, raising if there is
    none; TF32 is switched off there) in ``cfg.dtype`` (float64 only on
    the plain products: ``check_ported`` keeps it off the kernels).
    """
    check_ported(cfg)
    if cfg.algorithm != "mu":
        raise ValueError(
            f"mu_packed runs algorithm='mu', got {cfg.algorithm!r} (hals "
            "runs through the slot scheduler, nmfx_torch.ops.sched_mu)")
    dev = resolve_device(device)
    dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
    a = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                        dtype=dtype, device=dev)
    w0s = torch.as_tensor(w0s, dtype=dtype, device=dev)
    h0s = torch.as_tensor(h0s, dtype=dtype, device=dev)
    r, m, k = w0s.shape
    n = h0s.shape[2]
    a = a_true = a.contiguous()  # a_true: unpadded, for the residuals
    use_kernels = cfg.backend == "pallas"
    wp, hp = pack(w0s, h0s)
    if use_kernels and padded_rows(m) != m:
        # the reference's tile padding, kept so both routes iterate on
        # the same operands (the CUDA kernels mask ragged edges anyway)
        pad = padded_rows(m) - m
        a = torch.nn.functional.pad(a, (0, 0, 0, pad))
        wp = torch.nn.functional.pad(wp, (0, 0, 0, pad))
    if use_kernels and cfg.matmul_precision == "bfloat16":
        # A in the bf16 form every product reads it in, once a solve
        a = a.to(torch.bfloat16)
    bd = block_diag_mask(r, k, dev)

    nonfinite0 = None
    if cfg.nonfinite_guard:
        # quarantine base case: a lane whose INITIAL factors are already
        # non-finite is zeroed (zero factors are inert under mu and add
        # exact zeros to the shared Grams) and flagged sticky
        bad0 = ~(_lanes_finite(wp.reshape(-1, r, k), (0, 2))
                 & _lanes_finite(hp.reshape(r, k, n), (1, 2)))
        zero_col = bad0.repeat_interleave(k)
        wp = torch.where(zero_col[None, :], 0.0, wp)
        hp = torch.where(zero_col[:, None], 0.0, hp)
        nonfinite0 = bad0

    state = PackedState(
        wp=wp, hp=hp, wp_prev=wp, hp_prev=hp, iteration=0,
        classes=torch.full((r, n), -1, dtype=torch.int32, device=dev),
        stable=torch.zeros((r,), dtype=torch.int32, device=dev),
        done=torch.zeros((r,), dtype=torch.bool, device=dev),
        done_iter=torch.zeros((r,), dtype=torch.int32, device=dev),
        stop_reason=torch.full((r,), int(StopReason.MAX_ITER),
                               dtype=torch.int32, device=dev),
        nonfinite=nonfinite0)

    # "auto" check_block resolves to 1 here, as in the reference
    ncheck = 1 if cfg.check_block == "auto" else int(cfg.check_block)
    trip = cfg.check_every * ncheck
    syncs = 0

    def live() -> bool:
        nonlocal syncs
        syncs += 1
        return not bool(state.done.all())

    running = True  # no lane is done before the first iteration
    while running and state.iteration + trip <= cfg.max_iter:
        for _ in range(ncheck):
            for i in range(cfg.check_every):
                _step(a, bd, state, cfg, r, check=i == cfg.check_every - 1,
                      use_kernels=use_kernels)
        running = live()
    while running and state.iteration < cfg.max_iter:
        _step(a, bd, state, cfg, r, check=True, use_kernels=use_kernels)
        running = live()

    iterations = torch.where(state.done, state.done_iter, state.iteration)
    wp_final = state.wp[:m]  # drop the tile-padding rows, if any
    # final residuals the direct way (reference calculateNorm): exact at
    # tight convergence, once per solve
    dnorm = residual_norms_direct(a_true, unpack_w(wp_final, r),
                                  state.hp.reshape(r, k, n))
    return PackedMUResult(wp=wp_final, hp=state.hp,
                          iterations=iterations.to(torch.int32),
                          dnorm=dnorm, stop_reason=state.stop_reason,
                          host_syncs=syncs)

