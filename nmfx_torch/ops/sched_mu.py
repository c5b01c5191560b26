"""Slot-scheduled whole grid (counterpart of ``nmfx/ops/sched_mu.py``
for mu, hals, neals, als, snmf and kl, with the uniform pool).

All J (k, restart) jobs of a sweep are queued at once and solved through
a fixed pool of S slots (default 48): each slot hosts one job, padded to
the largest rank with exact zeros; when a job converges its factors
scatter into per-job result buffers and the slot reloads the next queued
job. Jobs are dispatched in the order given (the sweep passes them
rank-descending: longest expected first). Once the queue drains, the
straggler-tail cascade compacts the survivors into narrower pools.

Two layouts, as in the reference:

* ``backend="pallas"``: packed columns, Wp (m_pad, S·k_max) / Hp
  (S·k_max, n), iterated by a hand-written block kernel (mu:
  ``fused_block_iterations``, phased or, under
  ``experimental.fused_updates="fused"``, join-the-updates; hals:
  ``hals_block_iterations``): one launch per trip runs ``check_block``
  check blocks of ``check_every`` iterations and exports each boundary's
  TolX stats and H snapshot, against which the trip replays every check.
  When ``max_iter`` is not a multiple of ``check_every`` mu's block route
  gives way to the per-iteration kernel pair (``fused_h_update`` /
  ``fused_w_update``, ``lane_gram`` between) with a per-step iteration
  fence; the pair runs one block iteration's kernels, so on the card
  both give the same bits and the same per-job iterations. hals has no
  such fallback and refuses the cap.
* ``backend="auto"``/``"packed"``: dense (S, m, k_max) / (S, k_max, n)
  lanes iterated by ``grid_mu``'s batched blocks (mu and hals under
  "auto"; neals, als, snmf and kl under "packed" only, as in the
  reference; pg and alspg have no block). snmf's blocks take each slot's
  padding mask from a per-job table whose extra all-False row serves the
  empty slots; kl's pool is clamped so its (S, m, n) quotients stay
  under 4 GB (``_kl_slot_clamp``).

hals, als, neals and snmf add the TolFun test to every check, on the
residual of each slot's dense view; hals' residual cannot be replayed
from a launch's boundary exports, so with TolFun on it runs one check
block per trip.

The reference's ``lax.while_loop``/``lax.cond`` become a host loop. The
pool's state lives on the device; the host keeps the queue position and
mirrors of the active and pending slot counts. Each trip ends with ONE
device→host read of those two counts, from which the host takes both the
harvest decision and the stage condition (the harvest claims a count of
queued jobs the host can compute), and it counts the reads in
``host_syncs``.

The block-kernel route's options, as in the reference:
``matmul_precision="bfloat16"`` (A cast to bf16 once a solve, every
product operand rounded to bf16 in the kernels), ``factor_dtype`` (the
pool's W, and H under "bfloat16", stored as bf16: converted at the
pool's edges, results float32), ``alias_io`` (the kernels update the
pool in place), ``block_m`` (the row tiling: it sets m_pad, and zero
rows change no result) and ``ragged`` (below). Their preconditions raise
the reference's ``ValueError``s.

``experimental.ragged=True`` (mu, the block-kernel route, ``job_ks``):
the class-blocked main stage. Jobs of each rank get their own slots of
their true width, laid out class-major with no padding columns
(``_ragged_layout``: a greedy minimax over the uniform pool's column
budget, slots · k_max); one block launch a trip, with per-column segment
ids, advances every class; each trip checks every slot and evicts and
reloads from each class's own queue at once. The per-slot bookkeeping
runs batched over all classes' slots; the host reads one small flag
array a trip (its host sync). Once the queues drain and at most the
tail width's jobs survive, they move into a uniform k_max-padded pool
for the straggler tail.

The block-shape autotuner (``nmfx_torch.autotune``) resolves ``block_m``,
``check_block`` and ``fused_updates`` before a sweep reaches here. The
reference's ``varying_axes`` (``shard_map`` typing) have no counterpart:
on a restart mesh each shard's scheduler runs alone. The reference's slot
clamp (``_pallas_slot_clamp``) fits a TPU core's VMEM; here the factors
stay in device memory, so the pool is bounded by device memory only.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple

import numpy as np
import torch

from nmfx_torch import faults
from nmfx_torch.config import SolverConfig, check_ported
from nmfx_torch.device import resolve_device, to_device
from nmfx_torch.ops.fused_mu import (fused_block_iterations, fused_h_update,
                                     fused_w_update, hals_block_iterations,
                                     lane_gram)
from nmfx_torch.ops.grid_mu import (BLOCKS, USES_TOLFUN, conv_cfg,
                                    make_block, pad_live_mask, tolfun_update)
from nmfx_torch.ops.packed_mu import batch_convergence
from nmfx_torch.solvers.base import (StopReason, bf16_products,
                                     residual_norms)

#: measured on the reference's hardware as the best single tail stage
#: (a narrower pool for the stragglers once the queue drains)
_AUTO_TAIL_SLOTS = (8,)

#: the stale-reload fault (``sched.stale_reload``): a reload that drops
#: its factor write while the bookkeeping marks the new job loaded, so
#: the slot solves on with the previous job's factors. Armed only through
#: ``nmfx_torch.faults`` (or the :func:`enable_stale_reload_fault` shim);
#: the NMFX_FAULT_INJECT_STALE_RELOAD environment variable alone is inert
_announced = {"done": False}


def enable_stale_reload_fault(fraction: float) -> None:
    """Deprecated shim: ``faults.arm("sched.stale_reload",
    rate=fraction)`` (0 disarms), with a loud banner on stderr and the
    logger; results from an armed process are invalid by design."""
    import warnings

    frac = float(fraction)
    if not 0.0 <= frac <= 1.0:
        raise ValueError(
            f"fault fraction must be in [0, 1], got {fraction!r}")
    warnings.warn(
        "enable_stale_reload_fault() is a deprecated shim; arm the "
        "registry directly: nmfx_torch.faults.arm('sched.stale_reload', "
        "rate=...)", DeprecationWarning, stacklevel=2)
    if frac > 0:
        faults.arm("sched.stale_reload", rate=frac)
    else:
        faults.disarm("sched.stale_reload")
    if frac > 0 and not _announced["done"]:
        _announced["done"] = True
        import logging
        import sys

        banner = (
            "stale-reload fault injection ARMED at fraction %g: slot "
            "reloads are being deliberately corrupted (test-only). "
            "Results from this process are INVALID." % frac)
        print(f"nmfx_torch: *** {banner} ***", file=sys.stderr)
        logging.getLogger("nmfx_torch").warning(banner)


def _warn_inert_env_hook() -> None:
    """Say so when the retired environment variable is set: it does
    nothing by itself."""
    import os

    if os.environ.get("NMFX_FAULT_INJECT_STALE_RELOAD", ""):
        import logging
        import sys

        notice = (
            "NMFX_FAULT_INJECT_STALE_RELOAD is set but IGNORED by "
            "library code: fault injection needs the explicit "
            "nmfx_torch.faults.arm('sched.stale_reload', rate=...) "
            "opt-in. An inherited env var alone cannot corrupt a run.")
        print(f"nmfx_torch: *** {notice} ***", file=sys.stderr)
        logging.getLogger("nmfx_torch").warning(notice)


_warn_inert_env_hook()


def _stale_load_mask(jobs: np.ndarray) -> np.ndarray:
    """Which reloads of ``jobs`` (job ids) keep their factor write under
    the armed ``sched.stale_reload`` rate: a job is dropped when the low
    16 bits of its Knuth hash ``job * 2654435761`` fall under
    ``rate * 2**16`` (the reference's ``_stale_load_mask``). All True
    when unarmed."""
    jobs = np.asarray(jobs)
    frac = faults.stale_reload_fraction()
    if frac <= 0:
        return np.ones(jobs.shape, bool)
    h = (jobs.astype(np.uint64) * np.uint64(2654435761)) & np.uint64(0xFFFF)
    keep = ~(h < np.uint64(int(frac * (1 << 16))))
    if not keep.all():
        faults.record_rate_fire("sched.stale_reload",
                                jobs=jobs[~keep].tolist())
    return keep


class SchedMUResult(NamedTuple):
    w: torch.Tensor  # (J, m, k_max) final factors per job, zero-padded
    h: torch.Tensor  # (J, k_max, n)
    iterations: torch.Tensor  # (J,) i32
    dnorm: torch.Tensor  # (J,) final RMS residual (direct form)
    stop_reason: torch.Tensor  # (J,) i32 StopReason
    #: one entry per cascade stage: its pool width, the trips run at that
    #: width, and the live slots summed over those trips (occupancy =
    #: lanes / (trips · width))
    pool_widths: tuple
    pool_trips: tuple
    pool_lanes: tuple
    #: device→host reads of the loop state (one per trip)
    host_syncs: int = 0


def _pallas_block_geometry(m: int, block_m: "int | None" = None
                           ) -> tuple[int, int, int]:
    """(tiles, block_m, m_pad): ~512-row tiles, 16-row aligned, as the
    reference pads A and Wp on its block-kernel route; ``block_m``
    (``experimental.block_m``, a multiple of 16) overrides the tile rows
    and m pads up to a multiple. The port's kernels split m in their own
    fixed way, so only m_pad reaches them: its zero rows add exact zeros
    to every sum."""
    if block_m is not None:
        tiles = -(-m // block_m)
        return tiles, block_m, tiles * block_m
    tiles = -(-m // 512)
    block_m = -(-(-(-m // tiles)) // 16) * 16
    return tiles, block_m, tiles * block_m


class _RaggedClass(NamedTuple):
    """One rank class of the ragged pool."""
    k: int  # true rank of the class's jobs
    jobs: tuple  # global job indices, dispatch order
    slots: int  # resident slots of the class
    off: int  # first packed column of the class's span


def _ragged_iters_est(k: int) -> float:
    """The reference's expected class-stability stop iteration by rank
    (its empirical north-star profile: flat ~515 through k = 4, then
    ~k^1.45). Only the schedule depends on it, never a result."""
    return 515.0 * max(1.0, k / 4.0) ** 1.45


def ragged_estimates_from_iterations(job_ks, iterations
                                     ) -> tuple[tuple[int, float], ...]:
    """Per-class mean stop iterations from a previous run's per-job
    ``iterations`` aligned with ``job_ks``, in the form
    ``ExperimentalConfig.ragged_iters_est`` takes."""
    its = np.asarray(iterations, dtype=np.float64)
    if len(job_ks) != its.shape[0]:
        raise ValueError(
            f"job_ks has {len(job_ks)} entries but iterations carries "
            f"{its.shape[0]} jobs")
    by_k: dict[int, list[float]] = {}
    for k, it in zip(job_ks, its):
        by_k.setdefault(int(k), []).append(float(it))
    return tuple(sorted((k, float(np.mean(v))) for k, v in by_k.items()))


def _resolve_est(iters_est, job_ks, max_iter: int):
    """The per-rank iteration estimate the ragged layout allocates with:
    the caller's measured estimates, else the built-in model, with the
    reference's warning where that model extrapolates (ranks above 10,
    or a cap below its fitted stop range)."""
    if iters_est is not None:
        table = {int(k): float(v) for k, v in iters_est}
        missing = sorted({int(k) for k in job_ks} - set(table))
        if missing:
            raise ValueError(
                "experimental.ragged_iters_est is missing estimates for "
                f"rank classes {missing}")
        return lambda k: table[int(k)]
    ks = {int(k) for k in job_ks}
    if max(ks) > 10 or max_iter < 1030:
        logging.getLogger("nmfx_torch").warning(
            "ragged slot allocation is using the built-in iteration model "
            "calibrated on the north-star profile (mu, k=2..10, "
            "class-stability stops ~515..2000 iterations); this job mix "
            "(k in %s, max_iter=%d) departs it, so the greedy-minimax "
            "allocation may be poor. Pass measured per-class estimates via "
            "ExperimentalConfig.ragged_iters_est (see "
            "ragged_estimates_from_iterations)", sorted(ks), max_iter)
    return _ragged_iters_est


def _ragged_layout(job_ks: tuple, budget_cols: int, iters_est=None,
                   max_iter: int = 10000) -> list:
    """Rank classes and their slots by greedy minimax (the reference's
    ``_ragged_layout``): one slot per class, then each further slot to
    the class with the largest estimated remaining makespan (jobs ×
    expected iterations / slots) while Σ slots_c·k_c <= budget_cols.
    Classes widest first, laid out class-major."""
    by_k: dict = {}
    for i, k in enumerate(job_ks):
        by_k.setdefault(int(k), []).append(i)
    ks_desc = sorted(by_k, reverse=True)
    if sum(ks_desc) > budget_cols:
        raise ValueError(
            f"ragged pool: one slot per rank class needs {sum(ks_desc)} "
            f"columns, budget is {budget_cols}; use the uniform pool")
    est = _resolve_est(iters_est, job_ks, max_iter)
    load = {k: len(by_k[k]) * est(k) for k in ks_desc}
    slots = {k: 1 for k in ks_desc}
    while True:
        spare = budget_cols - sum(slots[k] * k for k in ks_desc)
        grow = [k for k in ks_desc
                if slots[k] < len(by_k[k]) and k <= spare]
        if not grow:
            break
        best = max(grow, key=lambda k: load[k] / slots[k])
        slots[best] += 1
    layout, off = [], 0
    for k in ks_desc:
        layout.append(_RaggedClass(k=k, jobs=tuple(by_k[k]),
                                   slots=slots[k], off=off))
        off += slots[k] * k
    return layout


def _kl_slot_clamp(s: int, m: int, n: int, itemsize: int = 4) -> int:
    """Bound kl's quotient working set: each live lane holds m×n
    intermediates of ``itemsize`` bytes, budgeted as three
    (reconstruction, quotient and the contraction's operand), and the
    pool keeps them under 4 GB (the reference's ``_kl_slot_clamp``).
    Logged when it shrinks the pool."""
    clamped = max(1, min(s, int(4e9 // (3 * m * n * itemsize))))
    if clamped < s:
        logging.getLogger("nmfx_torch").warning(
            "kl scheduler: slot pool clamped %d -> %d (each lane holds "
            "~3 m*n quotient intermediates; m=%d, n=%d)", s, clamped, m, n)
    return clamped


def _resolve_tail(tail_slots, s: int) -> tuple[int, ...]:
    """The tail cascade as a strictly decreasing tuple of pool widths
    (() = off). Accepts None/0, "auto", an int, or a sequence of ints;
    widths at or above the current pool (or out of order) are dropped."""
    if tail_slots in (None, 0):
        return ()
    if tail_slots == "auto":
        tail_slots = _AUTO_TAIL_SLOTS
    if isinstance(tail_slots, int):
        tail_slots = (tail_slots,)
    widths = []
    prev = s
    for t in tail_slots:
        t = int(t)
        if t < 1:
            raise ValueError(f"tail widths must be >= 1, got {t}")
        if t < prev:
            widths.append(t)
            prev = t
    return tuple(widths)


@dataclasses.dataclass
class _Pool:
    """The slot pool: device tensors, plus host mirrors of the queue
    position and of the active and pending slot counts."""

    wp: torch.Tensor
    hp: torch.Tensor
    slot_iter: torch.Tensor  # (S,) i32 iterations done by the slot's job
    classes: torch.Tensor  # (S, n) i32
    stable: torch.Tensor  # (S,) i32
    dnorm: torch.Tensor  # (S,) residual at the last check (TolFun), inf
    slot_job: torch.Tensor  # (S,) i64 job in each slot (J = none)
    active: torch.Tensor  # (S,) bool slot holds a live job
    pending: torch.Tensor  # (S,) bool finished, factors not harvested
    queue: int  # next job to load
    n_active: int
    n_pending: int


class _Layout:
    """The layout hooks of one of the two pool layouts."""

    def init_slots(self, s): ...
    def labels(self, hp): ...
    def nonfinite(self, wp, hp): ...
    def dense_views(self, wp, hp): ...
    def reload(self, pool, slots, first_job, count): ...
    def gather(self, wp, hp, order): ...


def mu_sched(a, w0, h0, cfg: SolverConfig = SolverConfig(), slots: int = 48,
             tail_slots="auto", job_ks=None, flip_floor=None, *,
             device=None) -> SchedMUResult:
    """Solve J zero-padded jobs through an S-slot scheduler.

    ``w0``/``h0``: (J, m, k_max) / (J, k_max, n) initial factors (numpy
    or tensors), in dispatch order; results come back in the same job
    order. Each job's trajectory is its own: only the schedule depends on
    ``slots`` and ``tail_slots``. ``job_ks`` (per-job true ranks) gives
    snmf's padding masks (without it they are read from the initial
    factors); the other rules' padding is exact without it.
    ``flip_floor`` overrides the class-stability flip budget. ``device``:
    None = CUDA (raising without one; TF32 off there), or "cpu", where
    the kernels' plain versions run.
    """
    check_ported(cfg)
    if cfg.algorithm not in BLOCKS:
        raise ValueError(
            f"the slot scheduler implements {tuple(BLOCKS)}, got "
            f"algorithm={cfg.algorithm!r}")
    cfg = conv_cfg(cfg)
    dev = resolve_device(device)
    # the solve dtype (inputs, results, residuals, the stop tests) and
    # the pool dtype f32: the dense layout iterates in the solve dtype;
    # the kernel route's pools are float32 (the kernels' storage), and a
    # float64 solve widens at the checks, the harvest and the residuals,
    # as the reference's float64 pools hold the kernels' float32 values
    dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
    a, w0, h0 = (to_device(x, dtype, dev) for x in (a, w0, h0))
    j, m, k_max = w0.shape
    n = h0.shape[2]
    if job_ks is not None and len(job_ks) != j:
        raise ValueError(
            f"job_ks has {len(job_ks)} entries but w0/h0 carry {j} jobs "
            "— per-job true ranks must match the job batch exactly")
    s = min(slots, j)
    if cfg.algorithm == "kl":
        s = _kl_slot_clamp(s, m, n, torch.finfo(dtype).bits // 8)
    ce = cfg.check_every
    exp = cfg.experimental
    use_pallas = cfg.backend == "pallas"
    f32 = torch.float32 if use_pallas else dtype
    hals = cfg.algorithm == "hals"
    ce_ok = cfg.max_iter % ce == 0
    # the reference's preconditions, in its order and words
    if exp.ragged and not (use_pallas and ce_ok and job_ks is not None):
        raise ValueError(
            "experimental.ragged=True needs backend='pallas', job_ks, "
            "and max_iter a multiple of check_every (the block-kernel "
            "route)")
    use_ragged = bool(exp.ragged)
    if use_pallas and hals:
        if not ce_ok:
            raise ValueError(
                "backend='pallas' with algorithm='hals' requires max_iter to "
                "be a multiple of check_every (the block-kernel route; there "
                "is no per-iteration hals fallback)")
        if use_ragged:
            raise ValueError(
                "experimental.ragged=True is mu-only (the ragged "
                "class-blocked kernel); use the uniform pool for hals")
    # the launch: one block kernel a trip (the ragged stage's too)
    kernel_route = use_pallas and ce_ok
    # the uniform pool's block-kernel route: the only one where
    # check_block batches inside the kernel and the pool options apply
    blk_route = kernel_route and not use_ragged
    # hals' TolFun residual cannot be replayed from a launch's boundary
    # exports (the snapshots carry H, not the residual), so its multi-check
    # launch is sound only with TolFun off
    tolfun = USES_TOLFUN[cfg.algorithm] and cfg.use_tol_checks
    ncheck = cfg.check_block
    if ncheck == "auto":
        ncheck = 4 if (blk_route and not (hals and tolfun)) else 1
    ncheck = int(ncheck)
    if ncheck > 1 and blk_route and hals and tolfun:
        raise ValueError(
            "check_block > 1 on the pallas hals route needs "
            "use_tol_checks=False: TolFun's residual cannot be replayed "
            "from the kernel's boundary exports")
    if ncheck > 1 and use_ragged:
        raise ValueError(
            "check_block > 1 requires the uniform pool "
            "(experimental.ragged=False) — the ragged stage's per-class "
            "bookkeeping is check-per-trip")
    if exp.factor_dtype is not None and not blk_route:
        raise ValueError(
            "experimental.factor_dtype='bfloat16'/'bfloat16_w' is the "
            "pallas block-kernel pool experiment: backend='pallas', "
            "max_iter a multiple of check_every, uniform (non-ragged) "
            "pool")
    if exp.alias_io and not blk_route:
        raise ValueError(
            "experimental.alias_io=True is the uniform pallas "
            "block-kernel route only: backend='pallas', max_iter a "
            "multiple of check_every, non-ragged")
    use_fused = exp.fused_updates == "fused"
    if use_fused and cfg.algorithm != "mu":
        raise ValueError(
            "experimental.fused_updates='fused' is the mu join-the-updates "
            "kernel; the hals block kernel has its own schedule")
    if use_fused and not blk_route:
        raise ValueError(
            "experimental.fused_updates='fused' is the uniform pallas "
            "block-kernel route only: backend='pallas', max_iter a "
            "multiple of check_every, non-ragged")
    if exp.block_m is not None and not use_pallas:
        raise ValueError(
            "experimental.block_m is a pallas tile-shape override; it has "
            f"no meaning for backend={cfg.backend!r}")
    multi = blk_route and ncheck > 1
    evict_batch = exp.evict_batch
    sqrteps = torch.sqrt(torch.tensor(torch.finfo(dtype).eps, device=dev))
    kern_kw = dict(eps=cfg.div_eps, zero_threshold=cfg.zero_threshold,
                   matmul_precision=cfg.matmul_precision)
    # bf16 operands of the plain products off the kernel route (the
    # kernels round their own, and the kernel route's residuals stay
    # float32)
    bf_plain = not use_pallas and bf16_products(cfg, dev)
    # bf16 pool factors: W, and H under "bfloat16" (the reference's
    # to_pool_w / to_pool_h); the result buffers keep the solve dtype
    w_pool = torch.bfloat16 if exp.factor_dtype else f32
    h_pool = torch.bfloat16 if exp.factor_dtype == "bfloat16" else f32

    def ratio(diff, ref):
        # the kernels' float32 stats widen to a float64 solve's test
        return diff.to(dtype) / (sqrteps + ref.to(dtype))

    def lane_max(x):  # (·rk) stats → per-slot max over the slot's k_max
        return x.reshape(-1, k_max).amax(dim=1)

    def fence(active, slot_iter, step=0):
        return ~active | (slot_iter + step >= cfg.max_iter)

    def stepped_block(step_fn, delta_fn):
        """check_every single iterations with the per-step max_iter
        fence; the TolX delta compares the last two iterates."""
        def do_block(wp, hp, active, slot_iter, slot_job):
            for i in range(ce):
                if i == ce - 1:
                    wprev, hprev = wp, hp
                wp, hp = step_fn(wp, hp, fence(active, slot_iter, i),
                                 slot_job)
            return wp, hp, delta_fn(wp, hp, wprev, hprev)

        return do_block

    if use_pallas:
        _, _, m_pad = _pallas_block_geometry(m, exp.block_m)
        a_loop = torch.nn.functional.pad(a, (0, 0, 0, m_pad - m))
        # A in the form every product reads it in, once a solve: bf16
        # under bf16 operands, else float32 (a float64 A cast here)
        a_loop = a_loop.to(torch.bfloat16 if cfg.matmul_precision
                           == "bfloat16" else torch.float32)
        w0 = torch.nn.functional.pad(w0, (0, 0, 0, m_pad - m))

        def fcols(active, slot_iter):
            return fence(active, slot_iter).repeat_interleave(k_max).to(
                f32)[None, :]

        def block_launch(wp, hp, fcol, **kw):
            """The one block-kernel dispatch: hals' sweep kernel or the
            mu kernel (phased or join-the-updates), which share operands
            and outputs."""
            if hals:
                return hals_block_iterations(
                    a_loop, wp, hp, fcol, k=k_max,
                    slots=wp.shape[1] // k_max, iters=ce,
                    alias_io=exp.alias_io, **kern_kw, **kw)
            return fused_block_iterations(a_loop, wp, hp, fcol, k=k_max,
                                          iters=ce, fused=use_fused,
                                          alias_io=exp.alias_io, **kern_kw,
                                          **kw)

        def do_block(wp, hp, active, slot_iter, slot_job):
            # one launch: slot_iter is a multiple of check_every here, so
            # a slot crosses the cap only at a block boundary
            wp, hp, wd, wm, hd, hm = block_launch(
                wp, hp, fcols(active, slot_iter))
            return wp, hp, torch.maximum(ratio(lane_max(wd), lane_max(wm)),
                                         ratio(lane_max(hd), lane_max(hm)))

        def do_multi(wp, hp, active, slot_iter):
            """ncheck check blocks in one launch, with the per-lane
            max_iter fence in-kernel and each boundary's labels and TolX
            delta from the exported snapshots and stats."""
            rk = wp.shape[1]
            budget = (cfg.max_iter - slot_iter).clamp(min=0)
            wp, hp, wd, wm, hd, hm, hck = block_launch(
                wp, hp, fcols(active, slot_iter), check_block=ncheck,
                budget_cols=budget.repeat_interleave(k_max).to(f32)[None, :])
            deltas = [torch.maximum(
                ratio(lane_max(wd[b]), lane_max(wm[b])),
                ratio(lane_max(hd[b * rk:(b + 1) * rk]),
                      lane_max(hm[b * rk:(b + 1) * rk])))
                for b in range(ncheck)]
            labels = torch.argmax(hck.reshape(ncheck, -1, k_max, n),
                                  dim=2).to(torch.int32)
            return wp, hp, deltas, labels

        def one_step(wp, hp, frozen, slot_job):
            k = k_max
            fcol = frozen.repeat_interleave(k)
            hn = fused_h_update(a_loop, wp, hp, k=k, **kern_kw)
            hn = torch.where(fcol[:, None], hp, hn)
            gh = lane_gram(hn, k=k, matmul_precision=cfg.matmul_precision)
            wn = fused_w_update(a_loop, wp, hn, gh, k=k, **kern_kw)
            return torch.where(fcol[None, :], wp, wn), hn

        def packed_deltas(wp, hp, wprev, hprev):
            def _d(cur, prev, shape, dims):
                # widened first: the float64 difference of float32 values
                cur, prev = cur.to(dtype), prev.to(dtype)
                return ratio((cur - prev).abs().reshape(shape).amax(dim=dims),
                             prev.abs().reshape(shape).amax(dim=dims))

            width = wp.shape[1] // k_max
            return torch.maximum(_d(wp, wprev, (m_pad, width, k_max), (0, 2)),
                                 _d(hp, hprev, (width, k_max, n), (1, 2)))

        if not kernel_route:
            do_block = stepped_block(one_step, packed_deltas)

        class Layout(_Layout):
            def init_slots(self, s):
                return (w0[:s].permute(1, 0, 2).reshape(m_pad, -1).to(
                            w_pool, copy=True),
                        h0[:s].reshape(-1, n).to(h_pool, copy=True))

            def labels(self, hp):
                return torch.argmax(hp.reshape(-1, k_max, n), dim=1).to(
                    torch.int32)

            def nonfinite(self, wp, hp):
                return ~(torch.isfinite(wp.reshape(m_pad, -1, k_max)).all(
                    dim=2).all(dim=0)
                    & torch.isfinite(hp.reshape(-1, k_max, n)).all(
                        dim=2).all(dim=1))

            def dense_views(self, wp, hp):
                # the result buffers keep the solve dtype
                return (wp.reshape(m_pad, -1, k_max).permute(1, 0, 2)[:, :m]
                        .to(dtype),
                        hp.reshape(-1, k_max, n).to(dtype))

            def reload(self, pool, slot_ids, first, count):
                # the stale-reload fault drops some factor writes; the
                # caller's bookkeeping goes on with every slot loaded
                keep = _stale_load_mask(np.arange(first, first + count))
                if not keep.all():
                    idx = torch.as_tensor(np.flatnonzero(keep),
                                          device=slot_ids.device)
                    slot_ids, jobs = slot_ids[idx], first + idx
                else:
                    jobs = slice(first, first + count)
                w3 = pool.wp.view(m_pad, -1, k_max)
                w3[:, slot_ids] = w0[jobs].permute(1, 0, 2).to(w_pool)
                pool.hp.view(-1, k_max, n)[slot_ids] = h0[jobs].to(h_pool)

            def gather(self, wp, hp, order):
                return (wp.reshape(m_pad, -1, k_max)[:, order].reshape(
                    m_pad, -1).contiguous(),
                    hp.reshape(-1, k_max, n)[order].reshape(-1, n))
    else:
        a_blk = a
        if bf_plain and (cfg.algorithm != "kl"
                         or exp.kl_bf16_quotient):
            # A in the bf16 form every product reads it in, once a solve
            # (nmfx's _streams_bf16_a): the same products, and kl's
            # quotient too only under kl_bf16_quotient
            a_blk = a.to(torch.bfloat16).to(f32)
        block = make_block(cfg, a_blk)
        if cfg.algorithm == "snmf":
            # per-job true-rank masks; row j (an empty slot's job) is
            # all-False, and its lane is frozen
            pad_jobs = torch.cat([pad_live_mask(w0, h0, job_ks),
                                  torch.zeros((1, k_max), dtype=torch.bool,
                                              device=dev)])

            def step_fn(wp, hp, frozen, slot_job):
                return block(a_blk, wp, hp, frozen, cfg,
                             pad_live=pad_jobs[slot_job])
        else:
            def step_fn(wp, hp, frozen, slot_job):
                return block(a_blk, wp, hp, frozen, cfg)

        def dense_deltas(wp, hp, wprev, hprev):
            def _d(cur, prev):
                return ratio((cur - prev).abs().amax(dim=(1, 2)),
                             prev.abs().amax(dim=(1, 2)))

            return torch.maximum(_d(wp, wprev), _d(hp, hprev))

        do_block = stepped_block(step_fn, dense_deltas)

        class Layout(_Layout):
            def init_slots(self, s):
                return w0[:s].clone(), h0[:s].clone()

            def labels(self, hp):
                return torch.argmax(hp, dim=1).to(torch.int32)

            def nonfinite(self, wp, hp):
                return ~(torch.isfinite(wp).all(dim=2).all(dim=1)
                         & torch.isfinite(hp).all(dim=2).all(dim=1))

            def dense_views(self, wp, hp):
                return wp, hp

            def reload(self, pool, slot_ids, first, count):
                pool.wp[slot_ids] = w0[first:first + count]
                pool.hp[slot_ids] = h0[first:first + count]

            def gather(self, wp, hp, order):
                return wp[order], hp[order]

    layout = Layout()
    i32 = dict(dtype=torch.int32, device=dev)
    out_w = torch.zeros((j, m, k_max), dtype=dtype, device=dev)
    out_h = torch.zeros((j, k_max, n), dtype=dtype, device=dev)
    # row j is the drop target of the per-check outcome scatters
    out_iters = torch.zeros((j + 1,), **i32)
    out_stop = torch.full((j + 1,), int(StopReason.MAX_ITER), **i32)
    drop = torch.tensor(j, dtype=torch.long, device=dev)

    def apply_check(pool: _Pool, wp, hp, delta, new_labels) -> None:
        """ONE convergence check's bookkeeping: class stability, TolX,
        TolFun where the algorithm uses it, the max_iter fence and the
        per-job outcome scatters. On the multi-check launch every check
        sees the launch-final factors (the reference's drift class);
        labels and deltas are the boundary exports."""
        it_new = torch.clamp(pool.slot_iter + ce, max=cfg.max_iter)
        classes, stable, conv, _, reason = batch_convergence(
            cfg, it_new, new_classes=new_labels,
            delta=delta if cfg.use_tol_checks else None, n_glob=n,
            classes=pool.classes, stable=pool.stable, done=~pool.active,
            done_iter=torch.zeros_like(pool.slot_iter),
            stop_reason=torch.full_like(pool.slot_iter,
                                        int(StopReason.MAX_ITER)),
            flip_floor=flip_floor,
            nonfinite=(layout.nonfinite(wp, hp) if cfg.nonfinite_guard
                       else None))
        dnorm = pool.dnorm
        if tolfun:
            dnorm, conv, reason = tolfun_update(
                a, *layout.dense_views(wp, hp), it_new, cfg, dnorm=dnorm,
                done=conv, done_in=~pool.active, stop_reason=reason,
                bf16=bf_plain)
        finished = pool.active & (conv | (it_new >= cfg.max_iter))
        idx = torch.where(finished, pool.slot_job, drop)
        out_iters[idx] = it_new
        out_stop[idx] = reason
        pool.wp, pool.hp = wp, hp
        # a pending slot holds its counter at 0 until harvest, so its
        # successor starts at iteration 0 however long the harvest waits
        pool.slot_iter = torch.where(
            finished, 0, torch.where(pool.active, it_new, pool.slot_iter))
        pool.classes = torch.where(finished[:, None], -1, classes)
        pool.stable = torch.where(finished, 0, stable)
        pool.dnorm = torch.where(finished, torch.inf, dnorm)
        pool.active = pool.active & ~finished
        pool.pending = pool.pending | finished

    def harvest(pool: _Pool) -> None:
        """Scatter the pending slots' factors into the result buffers and
        reload queued jobs into the first of them (the reference's
        prefix-sum claim, in slot order)."""
        order = torch.argsort((~pool.pending).to(torch.int8), stable=True)
        order = order[:pool.n_pending]  # the pending slots, in slot order
        wdv, hdv = layout.dense_views(pool.wp, pool.hp)
        jobs = pool.slot_job[order]
        out_w.index_copy_(0, jobs, wdv[order])
        out_h.index_copy_(0, jobs, hdv[order])
        count = min(pool.n_pending, j - pool.queue)
        slot_job = pool.slot_job.clone()
        slot_job[order] = j
        if count:
            loads = order[:count]
            layout.reload(pool, loads, pool.queue, count)
            slot_job[loads] = torch.arange(pool.queue, pool.queue + count,
                                           device=dev)
            pool.active = pool.active.clone()
            pool.active[loads] = True
        pool.slot_job = slot_job
        pool.pending = torch.zeros_like(pool.pending)
        pool.queue += count
        pool.n_active += count
        pool.n_pending = 0

    stats = {"trips": 0, "lanes": 0, "syncs": 0}

    def trip(pool: _Pool) -> None:
        """One trip: ncheck check blocks, their checks, one read of the
        slot counts, then the harvest decision (the evict_batch rule)."""
        stats["lanes"] += pool.n_active
        if multi:
            wp, hp, deltas, labels = do_multi(pool.wp, pool.hp, pool.active,
                                              pool.slot_iter)
            for b in range(ncheck):
                apply_check(pool, wp, hp, deltas[b], labels[b])
        else:
            for _ in range(ncheck):
                wp, hp, delta = do_block(pool.wp, pool.hp, pool.active,
                                         pool.slot_iter, pool.slot_job)
                apply_check(pool, wp, hp, delta, layout.labels(hp))
        stats["trips"] += 1
        counts = torch.stack([pool.active.sum(), pool.pending.sum()])
        counts = counts.tolist()  # nmfx: ignore[NMFX005] -- the trip's one host read
        pool.n_active, pool.n_pending = (int(c) for c in counts)
        stats["syncs"] += 1
        live = pool.n_active + pool.n_pending
        if pool.n_pending and pool.n_pending >= min(evict_batch, live):
            harvest(pool)

    def compact(pool: _Pool, width: int) -> _Pool:
        order = torch.argsort((~pool.active).to(torch.int8),
                              stable=True)[:width]
        wp, hp = layout.gather(pool.wp, pool.hp, order)
        return dataclasses.replace(
            pool, wp=wp, hp=hp, slot_iter=pool.slot_iter[order],
            classes=pool.classes[order], stable=pool.stable[order],
            dnorm=pool.dnorm[order], slot_job=pool.slot_job[order],
            active=pool.active[order], pending=pool.pending[order])

    def ragged_stage(layout_r, tw: int, drain_tail: bool) -> _Pool:
        """The class-blocked main stage (the reference's
        ``_make_ragged_stage``): one row-3 launch a trip over the
        class-major columns with per-column segment ids, every slot
        checked at once, finished jobs evicted and each class's next
        queued jobs loaded the same trip. Runs until every class queue
        is drained and at most ``tw`` jobs survive (``drain_tail``) or to
        the end; returns the survivors as a ``tw``-slot uniform pool (the
        reference's ``_ragged_to_uniform``) with its queue empty."""
        i64 = dict(dtype=torch.long, device=dev)
        # per slot (class-major): its class, true width, first column
        slot_k = np.concatenate([np.full(c.slots, c.k) for c in layout_r])
        slot_off = np.concatenate([c.off + c.k * np.arange(c.slots)
                                   for c in layout_r])
        s_total, rk = slot_k.size, int(slot_k.sum())
        seg_ids = np.repeat(np.arange(s_total, dtype=np.int32), slot_k)
        col_slot = torch.as_tensor(seg_ids, dtype=torch.long, device=dev)
        # (S, k_max) column of each slot's q-th component; rk (a zero pad
        # column) past the slot's width
        q = np.arange(k_max)
        cols_np = np.where(q[None, :] < slot_k[:, None],
                           slot_off[:, None] + q[None, :], rk)
        cols = torch.as_tensor(cols_np, **i64)

        def seg_max(x):  # (rk,) per-column stats → per-slot max
            x = torch.cat([x.reshape(rk), x.new_zeros(1)])
            return x[cols].amax(dim=1)

        def true_cols(slot_ids):
            """(columns, components) of the slots' true columns, flat."""
            cs = [slot_off[i] + np.arange(slot_k[i]) for i in slot_ids]
            qs = [np.arange(slot_k[i]) for i in slot_ids]
            return (torch.as_tensor(np.concatenate(cs), **i64),
                    torch.as_tensor(np.concatenate(qs), **i64))

        def load(wp, hp, slot_ids, jobs):
            """Each slot's true columns from its job's initial factors."""
            c, qq = true_cols(slot_ids)
            g = torch.as_tensor(np.repeat(jobs, slot_k[slot_ids]), **i64)
            wp[:, c] = w0[g, :, qq].T.to(f32)
            hp[c] = h0[g, qq, :].to(f32)

        queues = [list(cl.jobs) for cl in layout_r]
        slot_class = np.concatenate([np.full(cl.slots, ci)
                                     for ci, cl in enumerate(layout_r)])
        slot_job = np.concatenate([np.asarray(cl.jobs[:cl.slots])
                                   for cl in layout_r])
        qpos = [cl.slots for cl in layout_r]
        active = np.ones(s_total, bool)
        wp = torch.zeros((m_pad, rk), dtype=f32, device=dev)
        hp = torch.zeros((rk, n), dtype=f32, device=dev)
        load(wp, hp, np.arange(s_total), slot_job)
        slot_iter = torch.zeros((s_total,), **i32)
        classes = torch.full((s_total, n), -1, **i32)
        stable = torch.zeros((s_total,), **i32)
        active_d = torch.ones((s_total,), dtype=torch.bool, device=dev)
        neg_inf = torch.full((1, n), -torch.inf, dtype=f32, device=dev)
        trips = lanes = 0

        def pending():
            return any(qpos[ci] < len(queues[ci])
                       for ci in range(len(layout_r)))

        while active.any() and (not drain_tail or pending()
                                or active.sum() > tw):
            lanes += int(active.sum())
            frozen = ~active_d | (slot_iter >= cfg.max_iter)
            fcol = frozen[col_slot].to(f32)[None, :]
            wp, hp, wd, wm, hd, hm = fused_block_iterations(
                a_loop, wp, hp, fcol, k=k_max, iters=ce, seg_ids=seg_ids,
                **kern_kw)
            it_new = torch.clamp(slot_iter + ce, max=cfg.max_iter)
            delta = None
            if cfg.use_tol_checks:
                delta = torch.maximum(ratio(seg_max(wd[0]), seg_max(wm[0])),
                                      ratio(seg_max(hd[:, 0]),
                                            seg_max(hm[:, 0])))
            labels = torch.argmax(torch.cat([hp, neg_inf])[cols], dim=1).to(
                torch.int32)
            nonfinite = None
            if cfg.nonfinite_guard:
                ok = torch.cat([torch.isfinite(wp).all(dim=0)
                                & torch.isfinite(hp).all(dim=1),
                                torch.ones(1, dtype=torch.bool, device=dev)])
                nonfinite = ~ok[cols].all(dim=1)
            classes, stable, conv, _, reason = batch_convergence(
                cfg, it_new, new_classes=labels, delta=delta, n_glob=n,
                classes=classes, stable=stable, done=~active_d,
                done_iter=torch.zeros_like(slot_iter),
                stop_reason=torch.full_like(slot_iter,
                                            int(StopReason.MAX_ITER)),
                flip_floor=flip_floor, nonfinite=nonfinite)
            finished = active_d & (conv | (it_new >= cfg.max_iter))
            fin = finished.cpu().numpy()  # nmfx: ignore[NMFX005] -- the trip's one read
            stats["syncs"] += 1
            trips += 1
            slot_iter = torch.where(finished, 0, it_new)
            classes = torch.where(finished[:, None], -1, classes)
            stable = torch.where(finished, 0, stable)
            if not fin.any():
                continue
            # evict: the finished jobs' factors, iterations and stops
            done = np.flatnonzero(fin)
            c, qq = true_cols(done)
            g = torch.as_tensor(np.repeat(slot_job[done], slot_k[done]),
                                **i64)
            out_w[g, :, qq] = wp[:m, c].T.to(dtype)
            out_h[g, qq, :] = hp[c].to(dtype)
            jobs = torch.as_tensor(slot_job[done], **i64)
            done_d = torch.as_tensor(done, **i64)
            out_iters[jobs] = it_new[done_d]
            out_stop[jobs] = reason[done_d]
            # reload: each class's next queued jobs, in slot order
            loads, new_jobs = [], []
            for i in done:
                ci = slot_class[i]
                if qpos[ci] < len(queues[ci]):
                    loads.append(i)
                    new_jobs.append(queues[ci][qpos[ci]])
                    qpos[ci] += 1
                    slot_job[i] = new_jobs[-1]
                else:
                    active[i] = False
                    slot_job[i] = j
            if loads:
                # the stale-reload fault drops some factor writes; the
                # bookkeeping above has every slot loaded
                keep = _stale_load_mask(new_jobs)
                if keep.any():
                    load(wp, hp, np.asarray(loads)[keep],
                         np.asarray(new_jobs)[keep])
            active_d = torch.as_tensor(active, device=dev)
        stats["trips"] += trips
        stats["lanes"] += lanes
        marks.append((stats["trips"], stats["lanes"]))
        # the survivors, zero-padded to k_max, into a uniform pool
        order = np.argsort(~active, kind="stable")[:tw]
        wpad = torch.cat([wp, wp.new_zeros((m_pad, 1))], dim=1)
        hpad = torch.cat([hp, hp.new_zeros((1, n))])
        sel = cols[torch.as_tensor(order, **i64)]  # (tw, k_max)
        order_d = torch.as_tensor(order, **i64)
        n_live = int(active.sum())
        return _Pool(
            wp=wpad[:, sel.reshape(-1)].contiguous(),
            hp=hpad[sel.reshape(-1)].contiguous(),
            slot_iter=slot_iter[order_d], classes=classes[order_d],
            stable=stable[order_d],
            dnorm=torch.full((tw,), torch.inf, dtype=dtype, device=dev),
            slot_job=torch.as_tensor(slot_job[order], **i64),
            active=active_d[order_d],
            pending=torch.zeros((tw,), dtype=torch.bool, device=dev),
            queue=j, n_active=n_live, n_pending=0)

    marks = []  # cumulative (trips, lanes) at each stage's end
    if use_ragged:
        layout_r = _ragged_layout(job_ks, s * k_max,
                                  iters_est=exp.ragged_iters_est,
                                  max_iter=cfg.max_iter)
        s_total = sum(c.slots for c in layout_r)
        tail_w = _resolve_tail(tail_slots, s_total)
        tw = tail_w[-1] if tail_w else 1
        pool = ragged_stage(layout_r, tw, bool(tail_w))
        widths = [s_total, tw]
    else:
        wp0, hp0 = layout.init_slots(s)
        pool = _Pool(
            wp=wp0, hp=hp0, slot_iter=torch.zeros((s,), **i32),
            classes=torch.full((s, n), -1, **i32),
            stable=torch.zeros((s,), **i32),
            dnorm=torch.full((s,), torch.inf, dtype=dtype, device=dev),
            slot_job=torch.arange(s, dtype=torch.long, device=dev),
            active=torch.ones((s,), dtype=torch.bool, device=dev),
            pending=torch.zeros((s,), dtype=torch.bool, device=dev),
            queue=s, n_active=s, n_pending=0)
        widths = [s]
        for width in _resolve_tail(tail_slots, s):
            while (pool.n_active or pool.n_pending) and (
                    pool.queue < j
                    or pool.n_active + pool.n_pending > width):
                trip(pool)
            if pool.n_pending:
                harvest(pool)
            marks.append((stats["trips"], stats["lanes"]))
            pool = compact(pool, width)
            widths.append(width)
    while pool.n_active:
        trip(pool)
    if pool.n_pending:
        harvest(pool)
    marks.append((stats["trips"], stats["lanes"]))
    trips = np.diff([0] + [t for t, _ in marks])
    lanes = np.diff([0] + [ln for _, ln in marks])
    # exact final residuals, once, from the retained per-job factors
    dnorm = residual_norms(a, out_w, out_h, bf_plain)
    return SchedMUResult(
        w=out_w, h=out_h, iterations=out_iters[:j], dnorm=dnorm,
        stop_reason=out_stop[:j], pool_widths=tuple(widths),
        pool_trips=tuple(int(t) for t in trips),
        pool_lanes=tuple(int(x) for x in lanes),
        host_syncs=stats["syncs"])
