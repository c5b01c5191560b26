"""The (k × restart) sweep (counterpart of the unmeshed routes of
``nmfx/sweep.py``).

Every restart of rank k starts from the reference's key chain
``split(fold_in(key(seed), k), R)``. The routes, chosen as the reference
chooses them (``_build_sweep_fn``, ``_GRID_EXEC_BACKENDS``):

* whole grid (``grid_exec="auto"`` with more than one rank, or
  ``"grid"``), for an algorithm/backend pair in ``_GRID_EXEC_BACKENDS``
  (mu and hals under "auto", "packed" and "pallas"; neals, als, snmf and
  kl under "packed"): every (k, restart) job goes through one
  slot-scheduled solve (``nmfx_torch.ops.sched_mu``), dispatched
  rank-descending;
* per rank (``"per_k"``, one rank, or a pair the grid does not take):
  ranks one after another. mu under "auto", "packed" or "pallas" solves
  each rank's restarts as one restart-packed batch
  (``nmfx_torch.ops.packed_mu``); the other pairs of
  ``_GRID_EXEC_BACKENDS`` run the slot scheduler at that one rank, whose
  key arrives already folded, so its restarts start from the same factors
  as on the whole grid; everything else (pg and alspg, the Gram family
  and kl under "auto", and every algorithm under "vmap") takes the
  batched restart route: the rank's restarts as lanes of one
  ``solvers.base.run_loop_batched`` solve, in ``restart_chunk`` chunks.

Either way each rank's batch reduces to a consensus matrix on the
device. At each rank's ``on_rank`` site the sweep starts the rank's
device→host copies (``harvest.start_host_fetch``, carried in the output's
``fetch`` field), so they stream while later ranks solve.

A moves to the device through the content-keyed input cache
(``data_cache.place_resilient``), so a repeat sweep over the same matrix
copies nothing. ``registry=`` (``nmfx_torch.registry.SweepRegistry``)
loads finished ranks and saves new ones; ``checkpoint=`` runs the durable
per-(rank, restart-chunk) ledger instead (``nmfx_torch.checkpoint``,
through the chunk executor :func:`_build_chunk_sweep_fn`). The armed
``solve.nonfinite`` fault poisons W0 at every place a route draws it.
Float64 runs on every route of plain products (the kernels are
float32). Meshes and the executable cache are not ported yet.

Under a real ``Profiler`` each solve dispatch (``"sweep.grid"``, and
``"sweep.k"`` per rank) is attributed to the cost model
(``nmfx_torch.obs.costmodel``: model FLOPs and bytes, MFU and the
roofline verdict against the peak of A's device).

The job-grid API (:class:`RestartResult`, :func:`grid_cells`,
:func:`reduce_grid`, :func:`consensus_from_cells`; the reference's
``reduceGridBy``) reduces a ``keep_factors=True`` sweep on the host.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from nmfx_torch import faults
from nmfx_torch import random as _random
from nmfx_torch.config import (ROADMAP_SCALE, ConsensusConfig, InitConfig,
                               SolverConfig, check_ported)
from nmfx_torch.consensus import labels_from_h, one_hot
from nmfx_torch.device import resolve_device
from nmfx_torch.harvest import fetch_host, start_host_fetch
from nmfx_torch.init import restart_inits
from nmfx_torch.obs import costmodel
from nmfx_torch.ops.packed_mu import mu_packed, unpack_w
from nmfx_torch.ops.sched_mu import mu_sched
from nmfx_torch.profiling import NullProfiler
from nmfx_torch.solvers import SOLVERS
from nmfx_torch.solvers.base import StopReason, run_loop_batched

#: backends that route each algorithm into the slot scheduler (the
#: reference's table): mu and hals by default; neals, als, snmf and kl
#: only as the explicit backend="packed" opt-in, their "auto" staying on
#: the batched restart route; pg and alspg have no dense-batched block
_GRID_EXEC_BACKENDS = {"mu": ("auto", "packed", "pallas"),
                       "hals": ("auto", "packed", "pallas"),
                       "neals": ("packed",), "als": ("packed",),
                       "snmf": ("packed",), "kl": ("packed",)}


class KSweepOutput(NamedTuple):
    consensus: torch.Tensor  # (n, n)
    iterations: torch.Tensor  # (restarts,)
    dnorms: torch.Tensor  # (restarts,)
    stop_reasons: torch.Tensor  # (restarts,)
    labels: torch.Tensor  # (restarts, n)
    best_w: torch.Tensor  # (m, k) factors of the lowest-residual restart
    best_h: torch.Tensor  # (k, n)
    #: every restart's factors, retained only under ``keep_factors=True``
    all_w: "torch.Tensor | None" = None  # (restarts, m, k)
    all_h: "torch.Tensor | None" = None  # (restarts, k, n)
    #: device→host reads of the solve's loop state (mu_packed, the batched
    #: restart route's loops, or the whole grid's mu_sched, whose count
    #: every rank carries)
    host_syncs: int = 0
    #: the whole grid's pool diagnostics (``SchedMUResult.pool_*``),
    #: carried by every rank; empty on the per-rank route
    pool_widths: tuple = ()
    pool_trips: tuple = ()
    pool_lanes: tuple = ()
    #: the rank's device→host copies, started at its on_rank site
    #: (``harvest.HostFetch``); None until the sweep starts them
    fetch: "object | None" = None


class ChunkSweepOutput(NamedTuple):
    """One restart chunk's per-lane results: a durable-ledger record
    (``nmfx_torch.checkpoint``), everything a rank's finalize needs."""

    labels: torch.Tensor  # (chunk, n); quarantined lanes -1
    iterations: torch.Tensor  # (chunk,)
    dnorms: torch.Tensor  # (chunk,) raw final residuals
    stop_reasons: torch.Tensor  # (chunk,)
    #: chunk-local index of the lowest-dnorm surviving lane (first
    #: minimum, as the global argmin picks it)
    best_local: torch.Tensor  # () i32
    best_w: torch.Tensor  # (m, k)
    best_h: torch.Tensor  # (k, n)


def _use_packed(solver_cfg: SolverConfig) -> bool:
    """Whether mu's restart-packed solve (``mu_packed``) is the rank's
    engine: mu under "auto", "packed" or "pallas"."""
    return (solver_cfg.algorithm == "mu"
            and solver_cfg.backend in ("auto", "packed", "pallas"))


def resolve_engine_family(solver_cfg: SolverConfig) -> str:
    """The engine family a configuration runs, in the reference's words:
    "pallas" (the hand-written kernels), "packed" (mu's packed solve or
    the dense slot scheduler) or "vmap" (the batched restart route).
    Families sum products in other orders, so a registry never crosses
    them."""
    if solver_cfg.backend == "pallas":
        return "pallas"
    if _use_packed(solver_cfg) or grid_exec_ok(solver_cfg):
        return "packed"
    return "vmap"


def _poison_restart_lanes(w0: torch.Tensor, lane_idx) -> torch.Tensor:
    """The ``solve.nonfinite`` fault: one NaN at ``W0[lane, 0, 0]`` of
    each listed lane (the reference's ``_poison_restart_lanes``), and
    the site's flight event naming the pool's poisoned lanes."""
    if not lane_idx:
        return w0
    faults.record_rate_fire("solve.nonfinite", lanes=list(lane_idx),
                            pool=int(w0.shape[0]))
    w0 = w0.clone()
    w0[list(lane_idx), 0, 0] = torch.nan
    return w0


def _quarantine_lanes(labels, dnorm, stops):
    """Mask lanes that stopped with NUMERIC_FAULT (or SCREENED): labels
    become -1 (dropped from the consensus like pad lanes) and their dnorm
    +inf (never the best restart). Returns
    ``(labels, dnorm_for_best, faulted)``."""
    faulted = ((stops == int(StopReason.NUMERIC_FAULT))
               | (stops == int(StopReason.SCREENED)))
    labels = torch.where(faulted[:, None], -1, labels)
    dnorm_best = torch.where(faulted, torch.inf, dnorm)
    return labels, dnorm_best, faulted


def _quarantined_consensus(labels, k: int, restarts: int, faulted):
    """Mean connectivity over the SURVIVING lanes: masked lanes add exact
    zeros and the normalizer becomes the survivor count; a fault-free
    rank divides by the constant restart count, as the reference does."""
    e = one_hot(labels, k)
    raw = torch.einsum("rik,rjk->ij", e, e)
    n_fault = faulted.sum(dtype=torch.int32)
    survivors = torch.clamp(restarts - n_fault, min=1).to(torch.float32)
    return torch.where(n_fault > 0, raw / survivors, raw / restarts)


def _build_packed_sweep_fn(k: int, restarts: int, solver_cfg: SolverConfig,
                           init_cfg: InitConfig, label_rule: str,
                           keep_factors: bool = False):
    """The rank-k solve: init + packed solve + labels + consensus, as a
    function of (A on its device, the rank's key)."""

    poison = faults.poison_restarts(k, restarts)

    def impl(a: torch.Tensor, key: np.ndarray) -> KSweepOutput:
        keys = _random.split(key, restarts)
        w0s, h0s = restart_inits(a, keys, k, init_cfg)
        w0s = _poison_restart_lanes(w0s, poison)
        res = mu_packed(a, w0s, h0s, solver_cfg, device=a.device)
        hs = res.hp.reshape(restarts, k, -1)
        labels = labels_from_h(hs, label_rule)
        labels, masked, faulted = _quarantine_lanes(
            labels, res.dnorm, res.stop_reason)
        cons = _quarantined_consensus(labels, k, restarts, faulted)
        ws = unpack_w(res.wp, restarts)
        best = torch.argmin(masked)
        extra = ((ws.contiguous(), hs) if keep_factors else (None, None))
        return KSweepOutput(cons, res.iterations, res.dnorm,
                            res.stop_reason, labels, ws[best], hs[best],
                            *extra, host_syncs=res.host_syncs)

    return impl


def _build_vmap_sweep_fn(k: int, restarts: int, solver_cfg: SolverConfig,
                         init_cfg: InitConfig, label_rule: str,
                         keep_factors: bool = False):
    """The batched restart route at rank k (the reference's
    ``jax.vmap`` of its generic ``solve``): the rank's restarts as lanes
    of one ``run_loop_batched`` solve of ``solver_cfg.algorithm``, then
    labels, quarantine, consensus and best restart as on the other
    routes. With
    ``restart_chunk`` the restarts run in sequential chunks of that many
    (the last one smaller), which bounds the lanes' (chunk, m, n)
    intermediates; only the per-restart outputs are concatenated, so the
    results do not depend on the chunking."""
    mod = SOLVERS[solver_cfg.algorithm]
    chunk = solver_cfg.restart_chunk or restarts
    poison = faults.poison_restarts(k, restarts)
    if poison and chunk < restarts:
        raise ValueError(
            "solve.nonfinite fault injection does not compose with "
            "restart_chunk (chunked batches lose the global lane index); "
            "disarm the site or drop restart_chunk for the chaos run")

    def impl(a: torch.Tensor, key: np.ndarray) -> KSweepOutput:
        keys = _random.split(key, restarts)
        parts, syncs = [], 0
        for c in range(0, restarts, chunk):
            w0s, h0s = restart_inits(a, keys[c:c + chunk], k, init_cfg)
            w0s = _poison_restart_lanes(w0s, poison)
            res = run_loop_batched(a, w0s, h0s, solver_cfg, mod.step,
                                   mod.init_aux(a, w0s, h0s, solver_cfg))
            syncs += res.host_syncs
            parts.append(res)
        ws, hs, iters, dnorm, stops = (
            torch.cat([getattr(p, f) for p in parts])
            for f in ("w", "h", "iterations", "dnorm", "stop_reason"))
        labels = labels_from_h(hs, label_rule)
        labels, masked, faulted = _quarantine_lanes(labels, dnorm, stops)
        cons = _quarantined_consensus(labels, k, restarts, faulted)
        best = torch.argmin(masked)
        extra = (ws, hs) if keep_factors else (None, None)
        return KSweepOutput(cons, iters, dnorm, stops, labels, ws[best],
                            hs[best], *extra, host_syncs=syncs)

    return impl


def _build_chunk_sweep_fn(k: int, n_chunk: int, solver_cfg: SolverConfig,
                          init_cfg: InitConfig, label_rule: str,
                          poison: tuple = ()):
    """The durable ledger's chunk executor (``nmfx_torch.checkpoint``):
    ``n_chunk`` restarts of rank ``k`` from explicit per-restart keys (a
    slice of ``split(fold_in(key(seed), k), restarts)``), returned as the
    per-lane :class:`ChunkSweepOutput` a record holds. ``poison`` holds
    the chunk-local ``solve.nonfinite`` lanes. mu under "auto", "packed"
    or "pallas" runs ``mu_packed`` (the hand-written pair under
    "pallas"); everything else the batched restart route, the chunk's
    lanes as one solve."""
    packed = _use_packed(solver_cfg)
    mod = SOLVERS[solver_cfg.algorithm]

    def impl(a: torch.Tensor, keys: np.ndarray) -> ChunkSweepOutput:
        w0s, h0s = restart_inits(a, keys, k, init_cfg)
        w0s = _poison_restart_lanes(w0s, poison)
        if packed:
            res = mu_packed(a, w0s, h0s, solver_cfg, device=a.device)
            hs = res.hp.reshape(n_chunk, k, -1)
            ws = unpack_w(res.wp, n_chunk)
        else:
            res = run_loop_batched(a, w0s, h0s, solver_cfg, mod.step,
                                   mod.init_aux(a, w0s, h0s, solver_cfg))
            hs, ws = res.h, res.w
        labels = labels_from_h(hs, label_rule)
        labels, masked, _ = _quarantine_lanes(labels, res.dnorm,
                                              res.stop_reason)
        best = torch.argmin(masked)
        return ChunkSweepOutput(labels, res.iterations, res.dnorm,
                                res.stop_reason, best.to(torch.int32),
                                ws[best], hs[best])

    return impl


def _refuse_mesh(mesh) -> None:
    """The meshed route is not ported: only ``mesh=None`` runs."""
    if mesh is not None:
        raise NotImplementedError(
            f"meshes are not ported yet ({ROADMAP_SCALE}); pass "
            "mesh=None")


def sweep_one_k(a: torch.Tensor, key: np.ndarray, k: int, restarts: int,
                solver_cfg: SolverConfig = SolverConfig(),
                init_cfg: InitConfig = InitConfig(),
                label_rule: str = "argmax",
                mesh=None,
                keep_factors: bool = False,
                grid_slots: int = 48,
                grid_tail_slots="auto") -> KSweepOutput:
    """Run ``restarts`` factorizations at rank k on A's device (``key``
    is the rank's folded key) and reduce them to one consensus matrix
    there, by the reference's order: mu under "auto", "packed" or
    "pallas" as one packed batch; another pair of ``_GRID_EXEC_BACKENDS``
    through the slot scheduler at this one rank (``grid_slots`` wide,
    with the ``grid_tail_slots`` cascade); everything else on the
    batched restart route. The parameters are the reference's, in its
    order; ``mesh`` must be None."""
    _refuse_mesh(mesh)
    if _use_packed(solver_cfg):
        fn = _build_packed_sweep_fn(k, restarts, solver_cfg, init_cfg,
                                    label_rule, keep_factors)
        return fn(a, key)
    if grid_exec_ok(solver_cfg):
        fn = _build_grid_exec_sweep_fn((k,), restarts, solver_cfg, init_cfg,
                                       label_rule, keep_factors, grid_slots,
                                       grid_tail_slots, fold_keys=False)
        return fn(a, key)[k]
    fn = _build_vmap_sweep_fn(k, restarts, solver_cfg, init_cfg, label_rule,
                              keep_factors)
    return fn(a, key)


def grid_exec_ok(solver_cfg: SolverConfig) -> bool:
    """Whether the whole-grid slot scheduler can run this configuration:
    an algorithm with a dense-batched block under a backend that routes
    it there (``_GRID_EXEC_BACKENDS``)."""
    return solver_cfg.backend in _GRID_EXEC_BACKENDS.get(
        solver_cfg.algorithm, ())


def _build_grid_exec_sweep_fn(ks: tuple[int, ...], restarts: int,
                              solver_cfg: SolverConfig,
                              init_cfg: InitConfig, label_rule: str,
                              keep_factors: bool = False, slots: int = 48,
                              tail_slots="auto", fold_keys: bool = True):
    """The whole-grid sweep as a function of (A on its device, the root
    key): every (k, restart) job through one ``mu_sched`` solve, jobs
    rank-descending (longest expected first), lanes rank-major and
    zero-padded to the largest rank; per-rank labels, quarantine,
    consensus and best restart from static slices of the per-job
    results. ``fold_keys=False`` is the single-rank mode whose key is
    already folded with its k."""
    if not fold_keys and len(ks) != 1:
        raise ValueError("fold_keys=False is the single-rank (pre-folded "
                         "key) mode; got several ks")
    ks = tuple(sorted(ks, reverse=True))  # LPT dispatch order
    k_max = max(ks)
    # the global lane of each poisoned (k, restart) in the rank-major stack
    poison = tuple(g * restarts + r for g, k in enumerate(ks)
                   for r in faults.poison_restarts(k, restarts))

    def impl(a: torch.Tensor, root_key: np.ndarray
             ) -> dict[int, KSweepOutput]:
        w0l, h0l = [], []
        for k in ks:
            keys = _random.split(_random.fold_in(root_key, k) if fold_keys
                                 else root_key, restarts)
            w0s, h0s = restart_inits(a, keys, k, init_cfg)
            w0l.append(torch.nn.functional.pad(w0s, (0, k_max - k)))
            h0l.append(torch.nn.functional.pad(h0s, (0, 0, 0, k_max - k)))
        res = mu_sched(a, _poison_restart_lanes(torch.cat(w0l), poison),
                       torch.cat(h0l), solver_cfg,
                       slots=slots, tail_slots=tail_slots,
                       job_ks=tuple(k for k in ks for _ in range(restarts)),
                       device=a.device)
        out: dict[int, KSweepOutput] = {}
        for g, k in enumerate(ks):
            sl = slice(g * restarts, (g + 1) * restarts)
            hk = res.h[sl, :k, :]  # true rows only: right under both rules
            wk = res.w[sl, :, :k]
            labels = labels_from_h(hk, label_rule)
            labels, masked, faulted = _quarantine_lanes(
                labels, res.dnorm[sl], res.stop_reason[sl])
            cons = _quarantined_consensus(labels, k, restarts, faulted)
            best = torch.argmin(masked)
            extra = (wk, hk) if keep_factors else (None, None)
            out[k] = KSweepOutput(cons, res.iterations[sl], res.dnorm[sl],
                                  res.stop_reason[sl], labels, wk[best],
                                  hk[best], *extra,
                                  host_syncs=res.host_syncs,
                                  pool_widths=res.pool_widths,
                                  pool_trips=res.pool_trips,
                                  pool_lanes=res.pool_lanes)
        return out

    return impl


def sweep(a, cfg: ConsensusConfig = ConsensusConfig(),
          solver_cfg: SolverConfig = SolverConfig(),
          init_cfg: InitConfig = InitConfig(), *, device=None,
          on_rank=None, profiler=None, registry=None,
          checkpoint=None) -> dict[int, KSweepOutput]:
    """The (k × restart) grid: one slot-scheduled solve of every rank, or
    one rank at a time (see the module docstring for the routing).

    ``device``: None means CUDA (raising if there is none; TF32 off).
    A moves to the device once, through the input cache.
    ``on_rank(k, out)`` runs after each rank (after the whole solve on the
    grid route), once the rank's host copies are started (``out.fetch``);
    its outputs are device tensors (host arrays for ranks loaded from a
    registry or finalized from a checkpoint ledger).
    ``profiler`` (``nmfx_torch.profiling.Profiler``) times the phases
    ``solve.grid`` or ``solve.k={k}`` and ``xfer.overlap`` (starting the
    copies), and ``checkpoint`` (registry saves); under a real profiler
    each solve dispatch is attributed to the cost model.

    ``registry`` (``nmfx_torch.registry.SweepRegistry``): finished ranks
    load from it and the ranks still needed are solved (on the grid
    route as one smaller grid) and saved. ``checkpoint``
    (``CheckpointConfig``): run through the durable ledger
    (``nmfx_torch.checkpoint.run_checkpointed_sweep``); not with
    ``registry``.
    """
    if profiler is None:
        profiler = NullProfiler()
    if checkpoint is not None:
        if registry is not None:
            raise ValueError(
                "pass either checkpoint (the durable chunked ledger) or "
                "registry (the legacy per-rank SweepRegistry), not both")
        from nmfx_torch.checkpoint import run_checkpointed_sweep

        return run_checkpointed_sweep(a, cfg, solver_cfg, init_cfg,
                                      checkpoint, device=device,
                                      profiler=profiler, on_rank=on_rank)
    eligible = grid_exec_ok(solver_cfg)
    if cfg.grid_exec == "grid" and not eligible:
        raise ValueError(
            "grid_exec='grid' needs an algorithm/backend pair that routes "
            "into the slot scheduler — mu or hals with backend 'auto', "
            "'packed' or 'pallas', or neals, als, snmf or kl with "
            f"'packed'; got algorithm={solver_cfg.algorithm!r}, "
            f"backend={solver_cfg.backend!r} (use grid_exec='auto' to "
            "fall back per configuration)")
    check_ported(solver_cfg)
    dev = resolve_device(device)
    out: dict[int, KSweepOutput] = {}
    needed: list[int] = []
    for k in cfg.ks:
        loaded = registry.try_load(k) if registry is not None else None
        if loaded is None:
            needed.append(k)
            continue
        out[k] = loaded
        if on_rank is not None:
            on_rank(k, loaded)
    if not needed:  # a fully registered re-run copies nothing
        return out
    use_grid = eligible and (cfg.grid_exec == "grid"
                             or (cfg.grid_exec == "auto" and len(needed) > 1))
    from nmfx_torch.data_cache import place_resilient

    a_dev = place_resilient(a, solver_cfg, dev, profiler=profiler)
    root = _random.key(cfg.seed)
    if use_grid:
        fn = _build_grid_exec_sweep_fn(
            tuple(needed), cfg.restarts, solver_cfg, init_cfg,
            cfg.label_rule, cfg.keep_factors, cfg.grid_slots,
            cfg.grid_tail_slots)
        t0 = time.perf_counter()
        with profiler.phase("solve.grid") as sync:
            solved = sync(fn(a_dev, root))
        with profiler.phase("xfer.overlap"):
            # one executable produced every rank, but each rank's copies
            # land (and harvest) independently
            solved = {k: v._replace(fetch=start_host_fetch(v))
                      for k, v in solved.items()}
        out.update(solved)
        for k in needed:
            if on_rank is not None:
                on_rank(k, solved[k])
        _attribute_dispatch("sweep.grid", solver_cfg, a_dev, solved,
                            time.perf_counter() - t0, profiler)
        if registry is not None:
            with profiler.phase("checkpoint"):
                for k in needed:
                    registry.save(k, out[k])
        return {k: out[k] for k in cfg.ks}
    for k in needed:
        # fold in k itself, so a given (seed, k) always yields the same
        # factorizations whatever the sweep's composition
        t0 = time.perf_counter()
        with profiler.phase(f"solve.k={k}") as sync:
            res = sync(sweep_one_k(a_dev, _random.fold_in(root, k), k,
                                   cfg.restarts, solver_cfg, init_cfg,
                                   cfg.label_rule, None, cfg.keep_factors,
                                   cfg.grid_slots, cfg.grid_tail_slots))
        with profiler.phase("xfer.overlap"):
            # rank k's results stream to the host while rank k+1 solves
            out[k] = res._replace(fetch=start_host_fetch(res))
        if on_rank is not None:
            on_rank(k, out[k])
        _attribute_dispatch("sweep.k", solver_cfg, a_dev, {k: out[k]},
                            time.perf_counter() - t0, profiler)
        if registry is not None:
            with profiler.phase("checkpoint"):
                registry.save(k, out[k])
    return {k: out[k] for k in cfg.ks}


def _attribute_dispatch(kind: str, solver_cfg: SolverConfig,
                        a_dev: torch.Tensor, outs: dict, wall_s: float,
                        profiler) -> None:
    """Per-dispatch roofline attribution (``nmfx_torch.obs.costmodel``):
    annotate a just-measured solve dispatch with its model FLOPs/bytes
    against the peak of A's device. Only under a real ``Profiler``,
    whose phase already synchronized the card, so the wall is honest;
    the iteration counts come through the host copies the sweep already
    started. A ``NullProfiler`` run attributes nothing and gains no
    read."""
    if (isinstance(profiler, NullProfiler)
            or not costmodel.attribution_enabled() or not outs):
        return
    iters = {k: fetch_host(v).iterations for k, v in outs.items()}
    costmodel.attribute_dispatch(kind, solver_cfg, a_dev.shape[0],
                                 a_dev.shape[1], iters, wall_s,
                                 device=a_dev.device)


class RestartResult(NamedTuple):
    """One grid cell's full result — the reference's per-job
    ``list(W, H, iter)`` (nmf.r:50), plus the residual and stop reason
    the reference never surfaces."""

    k: int
    restart: int
    w: np.ndarray  # (m, k)
    h: np.ndarray  # (k, n)
    iterations: int
    dnorm: float
    stop_reason: int


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def grid_cells(results) -> list[RestartResult]:
    """Flatten a ``keep_factors=True`` sweep into the (k × restart) grid
    of per-job results the reference's registry holds. Accepts the raw
    ``sweep`` output (``{k: KSweepOutput}``) or a ``ConsensusResult``
    from ``nmfconsensus`` (its per-k records carry the same per-restart
    fields)."""
    if hasattr(results, "per_k"):  # ConsensusResult
        results = results.per_k
    cells: list[RestartResult] = []
    for k in sorted(results):
        out = results[k]
        if out.all_w is None or out.all_h is None:
            raise ValueError(
                f"per-restart factors for k={k} were not retained; run the "
                "sweep with keep_factors=True (or recompute a single "
                "restart with nmfx_torch.restart_factors)")
        all_w, all_h = _host(out.all_w), _host(out.all_h)
        iters, dnorms = _host(out.iterations), _host(out.dnorms)
        stops = _host(out.stop_reasons)
        for r in range(all_w.shape[0]):
            cells.append(RestartResult(k, r, all_w[r], all_h[r],
                                       int(iters[r]), float(dnorms[r]),
                                       int(stops[r])))
    return cells


def reduce_grid(results, fun=None, by: str = "k") -> dict[int, object]:
    """Axis-grouped reduction over the (k × restart) job grid — the
    reference's ``reduceGridBy`` (nmf.r:72-98): group the job results by
    the kept axis and apply ``fun`` to each group's list of
    :class:`RestartResult`. ``fun=None`` is the reference's own
    reduction, :func:`consensus_from_cells`.

    ``by="k"``: ``fun`` receives all restarts at one rank; ``by="restart"``:
    one restart index across all ranks. ``results`` is the raw ``sweep``
    output or a ``ConsensusResult`` (see :func:`grid_cells`). Returns
    ``{axis_value: fun(cells)}`` sorted by axis value. Host numpy by
    design; the performance path is the on-device consensus of the
    sweep."""
    if fun is None:
        fun = consensus_from_cells
    axes = {"k": 0, "restart": 1}
    if by not in axes:
        raise ValueError(f"by must be 'k' or 'restart', got {by!r}")
    groups: dict[int, list[RestartResult]] = {}
    for cell in grid_cells(results):
        groups.setdefault(cell[axes[by]], []).append(cell)
    return {g: fun(groups[g]) for g in sorted(groups)}


def consensus_from_cells(cells: Sequence[RestartResult],
                         label_rule: str = "argmax") -> np.ndarray:
    """Host-numpy ``computeConsensusMatrixFromClusterings``
    (nmf.r:121-144) over a group of grid cells — the reference's default
    reduction, used by :func:`reduce_grid` when no ``fun`` is given."""
    if label_rule not in ("argmax", "argmin"):
        raise ValueError(
            f"label_rule must be 'argmax' or 'argmin', got {label_rule!r}")
    pick = np.argmax if label_rule == "argmax" else np.argmin
    labels = np.stack([pick(c.h, axis=0) for c in cells])  # (R, n)
    return (labels[:, :, None] == labels[:, None, :]).mean(axis=0)
