"""Restart-packed multiplicative-update solver (counterpart of
``nmfx/ops/packed_mu.py``).

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

Under ``shard`` (one shard of a grid group, ``solvers.base.ShardInfo``)
A and Wp are row blocks over the feature axis and A and Hp column
blocks over the sample axis: the H update's m-contracted WpᵀA and WpᵀWp
sum over the features, the W update's n-contracted HpHpᵀ and AHpᵀ over
the samples (SUMMA-style), on the plain products only: the kernels have
no collective stage, so ``backend="pallas"`` is refused there, as in the
reference.
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
from nmfx_torch.solvers.base import (ShardInfo, StopReason, bf16_products,
                                     mm, residual_norms, shard_reducers)
from nmfx_torch.solvers.mu import _mu_update


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


def _lanes_finite(x: torch.Tensor, dims: tuple[int, ...],
                  mesh_axis: "str | None" = None, comm=None) -> torch.Tensor:
    """Per-lane all-finite verdict of a lane-stacked factor array; with
    ``mesh_axis`` (the factor's grid axis) the verdict is global, so every
    shard of a lane's group agrees."""
    ok = torch.isfinite(x).all(dim=dims)
    if mesh_axis is not None:
        ok = ~comm.any(~ok, mesh_axis)
    return ok


def _factors_finite(wp, hp, r: int, k: int, f_ax=None, s_ax=None,
                    comm=None) -> torch.Tensor:
    """Per-lane all-finite verdict of both packed factors; on a grid
    group each factor's flags or over its axis, in one exchange."""
    ok_w = torch.isfinite(wp.reshape(-1, r, k)).all(dim=(0, 2))
    ok_h = torch.isfinite(hp.reshape(r, k, -1)).all(dim=(1, 2))
    items = [(op, flag, ax) for op, flag, ax in (("any", ~ok_w, f_ax),
                                                 ("any", ~ok_h, s_ax))
             if ax is not None]
    if items:
        bad = iter(comm.reduce(items))
        ok_w = ~next(bad) if f_ax is not None else ok_w
        ok_h = ~next(bad) if s_ax is not None else ok_h
    return ok_w & ok_h


def _block_sums(x: torch.Tensor, r: int) -> torch.Tensor:
    """Sum an (R·k, n)-shaped elementwise product per restart block →
    (R,)."""
    return x.reshape(r, -1, x.shape[1]).sum(dim=(1, 2))


def _diag_blocks(g: torch.Tensor, r: int) -> torch.Tensor:
    """(R·k, R·k) full Gram → (R, k, k) diagonal blocks."""
    k = g.shape[0] // r
    return torch.diagonal(g.reshape(r, k, r, k), dim1=0,
                          dim2=2).permute(2, 0, 1)


def residual_norms_gram(a, wp, hp, r: int,
                        shard: "ShardInfo | None" = None) -> torch.Tensor:
    """Per-restart RMS residual from packed Grams, with no m×n
    reconstruction: ‖A−WH‖² = ‖A‖² − 2⟨WᵀA, H⟩ + ⟨WᵀW, HHᵀ⟩ (reference
    ``residual_norms``). Under ``shard`` the m-contracted terms sum over
    the feature axis and the n-contracted ones over the sample axis, and
    the normalizer takes ``m_total`` / ``n_total`` (a ``ValueError``
    when missing: the local dims would inflate the RMS by √#shards).
    The solvers' end-of-solve form is the direct
    ``solvers.base.residual_norms``, exact at tight convergence."""
    m, n = a.shape
    f_ax = shard.feature_axis if shard is not None else None
    s_ax = shard.sample_axis if shard is not None else None
    numerh = wp.T @ a
    gw_full = wp.T @ wp
    a2 = (a * a).sum()
    if f_ax is not None:
        if shard.m_total is None:
            raise ValueError(
                "residual_norms with feature_axis needs m_total (the "
                "unsharded row count); the local shard's row count would "
                "silently inflate the RMS by sqrt(#shards)")
        numerh = shard.comm.sum(numerh, f_ax)
        gw_full = shard.comm.sum(gw_full, f_ax)
        a2 = shard.comm.sum(a2, f_ax)
        m = shard.m_total
    gh_full = hp @ hp.T
    cross = _block_sums(numerh * hp, r)
    if s_ax is not None:
        if shard.n_total is None:
            raise ValueError(
                "residual_norms with sample_axis needs n_total (the "
                "unsharded column count)")
        gh_full = shard.comm.sum(gh_full, s_ax)
        cross = shard.comm.sum(cross, s_ax)
        a2 = shard.comm.sum(a2, s_ax)
        n = shard.n_total
    quad = (_diag_blocks(gw_full, r) * _diag_blocks(gh_full, r)).sum(
        dim=(1, 2))
    sq = (a2 - 2.0 * cross + quad).clamp(min=0.0)
    return torch.sqrt(sq / (m * n))


def _labels(hp: torch.Tensor, r: int) -> torch.Tensor:
    """(R·k, n) → per-restart argmax labels (R, n)."""
    return torch.argmax(hp.reshape(r, -1, hp.shape[1]), dim=1).to(
        torch.int32)


def flip_budget(class_flip_tol: float, n: int) -> int:
    """The class-stability flip budget ``floor(class_flip_tol · n)`` in
    exact double math (the +eps keeps 0.3·10 = 2.999… from landing one
    flip below the documented floor)."""
    return int(class_flip_tol * n + 1e-9)


def _mismatches(new_classes, classes) -> torch.Tensor:
    """Per-lane count of labels that differ from the held snapshot."""
    return (new_classes != classes).sum(dim=1, dtype=torch.int32)


def batch_convergence(cfg: SolverConfig, it, *, new_classes, delta,
                      n_glob: int, classes, stable, done, done_iter,
                      stop_reason, flip_floor=None, nonfinite=None,
                      mism_reduce=None):
    """(B,)-batched convergence bookkeeping: the noise-tolerant
    class-stability snapshot rule plus the TolX test, with per-lane
    freeze flags (reference ``batch_convergence``).

    ``it`` is either the shared host clock (an int: off a check boundary
    nothing changes, and no device work is issued) or a (B,) int tensor
    of per-lane iteration counts (the slot scheduler's, whose lanes are
    at different iterations): then the check gate
    ``(it > 1) & (it % check_every == 0)`` is taken per lane.
    ``flip_floor`` overrides the ``floor(class_flip_tol · n_glob)`` flip
    budget. A ``nonfinite`` lane stops FIRST with NUMERIC_FAULT.
    ``mism_reduce`` reduces the per-lane mismatch counts (the sum over the
    sample axis when labels are column shards). Returns the five updated
    arrays."""
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
        mism = _mismatches(new_classes, classes)
        if mism_reduce is not None:
            mism = mism_reduce(mism)
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
          check: bool, use_kernels: bool,
          shard: "ShardInfo | None" = None) -> None:
    """One packed mu iteration, updating ``state`` in place. Off the
    kernels the plain versions take bf16 operands only where
    ``bf16_products`` holds (on CUDA), as every plain product does.
    Under ``shard`` the four products sum over their contracted grid
    axis (reference ``_step``, ``nmfx/ops/packed_mu.py:350-385``)."""
    k = state.hp.shape[0] // r
    wp0, hp0 = state.wp, state.hp
    f_ax = shard.feature_axis if shard is not None else None
    s_ax = shard.sample_axis if shard is not None else None
    comm = shard.comm if shard is not None else None
    if shard is not None:
        # the plain products, each m- or n-contracted term summed over
        # its grid axis before the epilogue (A and Wp row blocks, A and
        # Hp column blocks)
        fsum, ssum = shard_reducers(shard)
        bf = bf16_products(cfg, a.device)
        numerh, gw = fsum(mm(wp0.T, a, bf), mm(wp0.T, wp0, bf))
        hp = _mu_update(hp0, numerh, mm(bd_select(gw, bd), hp0, bf),
                        cfg.div_eps, cfg.zero_threshold)
        gh, numerw = ssum(mm(hp, hp.T, bf), mm(a, hp.T, bf))
        wp = _mu_update(wp0, numerw, mm(wp0, bd_select(gh, bd), bf),
                        cfg.div_eps, cfg.zero_threshold)
    elif use_kernels:
        kw = dict(k=k, eps=cfg.div_eps, zero_threshold=cfg.zero_threshold,
                  matmul_precision=cfg.matmul_precision)
        hp = fused_h_update(a, wp0, hp0, **kw)
        wp = fused_w_update(a, wp0, hp, lane_gram(
            hp, k=k, matmul_precision=cfg.matmul_precision), **kw)
    else:
        bf = bf16_products(cfg, a.device)
        kw = dict(k=k, eps=cfg.div_eps, zero_threshold=cfg.zero_threshold,
                  matmul_precision="bfloat16" if bf else "default")
        hp = fused_h_update_ref(a, wp0, hp0, **kw)
        # small; plain product, as in nmfx
        gh = bd_select(mm(hp, hp.T, bf), bd)
        wp = fused_w_update_ref(a, wp0, hp, gh, **kw)

    # numeric quarantine: a lane whose new factors are non-finite is
    # rolled back to its last finite iterate the same iteration, so the
    # shared operands stay finite; the sticky flag stops it with
    # NUMERIC_FAULT at its next check
    bad = state.nonfinite
    if cfg.nonfinite_guard:
        new_bad = ~_factors_finite(wp, hp, r, k, f_ax, s_ax, comm)
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
        _check(state, cfg, r, shard)


def _check(state: PackedState, cfg: SolverConfig, r: int,
           shard: "ShardInfo | None" = None) -> None:
    """Per-restart convergence tests (class stability first, then TolX).
    Under ``shard`` the label mismatches sum over the sample axis (the
    flip budget from ``n_total``) and each factor's max-change is a ratio
    of maxima over its grid axis (reference ``_check`` and
    ``_delta_sharded``, ``nmfx/ops/packed_mu.py:445-480``)."""
    it = state.iteration
    if not (it > 1 and it % cfg.check_every == 0):
        return  # no test runs off a check boundary: no collective runs
    k = state.hp.shape[0] // r
    f_ax = shard.feature_axis if shard is not None else None
    s_ax = shard.sample_axis if shard is not None else None
    new_classes = _labels(state.hp, r)
    n_glob = state.hp.shape[1]
    if s_ax is not None:
        if shard.n_total is None:
            raise ValueError(
                "class-stability check with sample_axis needs n_total "
                "(the unsharded column count); the local shard width "
                "would make the flip tolerance ~#shards too strict")
        n_glob = shard.n_total
    # the local ingredients first; on a grid group every reduction of the
    # check runs in one exchange: the labels' mismatch counts sum over
    # the samples, and a max-change is a ratio of global maxima, both of
    # its ingredients reduced over the factor's axis
    m, n = state.wp.shape[0], state.hp.shape[1]
    # TolX in the solve dtype: a float64 solve's float32 kernel pools
    # widen first, so each difference is exact, as the reference takes it
    # on its float64 factors (which hold the same float32 values)
    wide = torch.float64 if cfg.dtype == "float64" else torch.float32
    maxima = {}
    if cfg.use_tol_checks:
        wp, wp_prev, hp, hp_prev = (x.to(wide) for x in (
            state.wp, state.wp_prev, state.hp, state.hp_prev))
        maxima = {
            "w": ((wp - wp_prev).abs().reshape(m, r, k).amax(dim=(0, 2)),
                  wp_prev.abs().reshape(m, r, k).amax(dim=(0, 2))),
            "h": ((hp - hp_prev).abs().reshape(r, k, n).amax(dim=(1, 2)),
                  hp_prev.abs().reshape(r, k, n).amax(dim=(1, 2)))}
    axes = {"w": f_ax, "h": s_ax}
    items = [("max", x, axes[f]) for f in maxima for x in maxima[f]
             if axes[f] is not None]
    sum_mism = s_ax is not None and cfg.use_class_stop
    if sum_mism:
        items.append(("sum", _mismatches(new_classes, state.classes), s_ax))
    got = iter(shard.comm.reduce(items) if items else ())
    for f in maxima:
        if axes[f] is not None:
            maxima[f] = (next(got), next(got))
    mism_reduce = None
    if sum_mism:
        mism_total = next(got)

        def mism_reduce(_):
            return mism_total
    delta = None
    if cfg.use_tol_checks:
        sqrteps = torch.sqrt(torch.tensor(torch.finfo(wide).eps,
                                          dtype=wide,
                                          device=state.wp.device))
        dw, dh = (diff / (sqrteps + ref)
                  for diff, ref in (maxima["w"], maxima["h"]))
        delta = torch.maximum(dw, dh)  # (R,)

    (state.classes, state.stable, state.done, state.done_iter,
     state.stop_reason) = batch_convergence(
        cfg, state.iteration, new_classes=new_classes, delta=delta,
        n_glob=n_glob, classes=state.classes,
        stable=state.stable, done=state.done, done_iter=state.done_iter,
        stop_reason=state.stop_reason, nonfinite=state.nonfinite,
        mism_reduce=mism_reduce)


def mu_packed(a, w0s, h0s, cfg: SolverConfig = SolverConfig(), *,
              device=None,
              shard: "ShardInfo | None" = None) -> PackedMUResult:
    """Solve the whole restart batch with packed mu iterations.

    Semantically the reference's ``mu_packed``: same update rule, same
    convergence tests, same freeze-on-convergence and quarantine. ``a``
    (m, n), ``w0s`` (R, m, k), ``h0s`` (R, k, n) are numpy arrays or
    tensors; they move to ``device`` (None = CUDA, raising if there is
    none; TF32 is switched off there) in ``cfg.dtype``. A float64 solve
    under ``backend="pallas"`` runs the float32 kernels as the
    reference's do (products and epilogues in float32, the factors
    stored in float64): A is cast to float32 once a solve, the pair
    iterates float32 pools, and the TolX test, the final residuals and
    the returned factors are float64. The reference takes each product
    from the float64 operands rounded once to float32; the card's
    kernels read float32 operands, so the products part from it by
    about a float32 rounding of the operands.

    ``shard``: this call is one shard of a grid group (``a``, ``w0s`` and
    ``h0s`` its blocks); every shard of the group runs it in lockstep on
    its own thread (``nmfx_torch.collectives``).
    """
    check_ported(cfg)
    if cfg.algorithm != "mu":
        raise ValueError(
            f"mu_packed runs algorithm='mu', got {cfg.algorithm!r} (hals "
            "runs through the slot scheduler, nmfx_torch.ops.sched_mu)")
    if shard is not None and cfg.backend == "pallas":
        raise ValueError("feature/sample-axis sharding is not supported "
                         "with the pallas backend (the fused kernels have "
                         "no collective stage); use backend='packed'")
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
    if use_kernels and dtype == torch.float64:
        # float64 storage on the float32 kernels: float32 pools and A,
        # cast once a solve
        wp, hp = wp.to(torch.float32), hp.to(torch.float32)
        a = a.to(torch.float32)
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
        f_ax = shard.feature_axis if shard is not None else None
        s_ax = shard.sample_axis if shard is not None else None
        comm = shard.comm if shard is not None else None
        bad0 = ~_factors_finite(wp, hp, r, k, f_ax, s_ax, comm)
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
                      use_kernels=use_kernels, shard=shard)
        running = live()
    while running and state.iteration < cfg.max_iter:
        _step(a, bd, state, cfg, r, check=True, use_kernels=use_kernels,
              shard=shard)
        running = live()

    iterations = torch.where(state.done, state.done_iter, state.iteration)
    # drop the tile-padding rows, if any; a float32 pool widens to the
    # solve dtype
    wp_final, hp_final = state.wp[:m].to(dtype), state.hp.to(dtype)
    # final residuals the direct way (reference calculateNorm): exact at
    # tight convergence, once per solve
    dnorm = residual_norms(
        a_true, unpack_w(wp_final, r), hp_final.reshape(r, k, n),
        bf16=not use_kernels and bf16_products(cfg, dev), shard=shard)
    return PackedMUResult(wp=wp_final, hp=hp_final,
                          iterations=iterations.to(torch.int32),
                          dnorm=dnorm, stop_reason=state.stop_reason,
                          host_syncs=syncs)

