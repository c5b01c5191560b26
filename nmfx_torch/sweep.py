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
  ``solvers.base.run_loop_batched`` solve, in ``restart_chunk`` chunks;
* ``backend="sketched"`` and ``screen=True`` take neither the packed
  family nor the whole grid: rank by rank, the compressed engine
  (``solvers/sketched.py``) over the rank's restarts as lanes, or the
  screening pass over all of them and then the batched restart route on
  the ``screen_keep`` survivors (:func:`_build_screened_sweep_fn`).

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
float32). A restart mesh (:func:`grid_mesh`) runs every route
restart-sharded, each shard on its device (:func:`_run_shards`). A mesh
with feature or sample axes runs the grid-sharded sweep
(:func:`_build_grid_sharded_sweep_fn`): A tiled over the grid axes, each
restart shard's F×S shards in lockstep on the collective layer
(``nmfx_torch/collectives.py``), mu on ``mu_packed``'s plain products or
one of :data:`GRID_SOLVERS` on the batched restart route.

The serving tier's build functions (:func:`_build_bucketed_sweep_fn`, solo, and
:func:`_build_packed_serve_fn`, lanes from several requests) run the
whole grid on a matrix zero-padded to its shape bucket
(``nmfx_torch/exec_cache.py``): lanes are drawn at the true shape and
zero-padded (:func:`_dyn_lane_init`), the pool is padded to the full
``grid_slots`` width with the tail cascade off (:func:`_pad_pool_lanes`),
pad columns get label -1 and the residuals are rescaled to the true
shape, so a request's lanes compute the same bytes whatever else shares
the pool. ``sweep(exec_cache=)`` serves a sweep through that cache.

Under a real ``Profiler`` each solve dispatch (``"sweep.grid"``, and
``"sweep.k"`` per rank) is attributed to the cost model
(``nmfx_torch.obs.costmodel``: model FLOPs and bytes, MFU and the
roofline verdict against the peak of A's device).

Out-of-core inputs (``nmfx_torch/tiles.py``): a ``SolverConfig.tile_rows``
or a ``nmfx_torch.sparse.SparseMatrix`` input is routed before anything
else. A dense input whose plan is one tile runs the in-core routes with
``tile_rows`` stripped (byte-equal to the dense sweep); a multi-tile
dense plan and every sparse input run the streamed engine rank by rank
(:func:`_sweep_tiled`), A staying on the host.

The job-grid API (:class:`RestartResult`, :func:`grid_cells`,
:func:`reduce_grid`, :func:`consensus_from_cells`; the reference's
``reduceGridBy``) reduces a ``keep_factors=True`` sweep on the host.
"""

from __future__ import annotations

import dataclasses
import functools as _functools
import threading
import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from nmfx_torch import collectives as _coll
from nmfx_torch import faults
from nmfx_torch import random as _random
from nmfx_torch.config import (ConsensusConfig, InitConfig, SolverConfig,
                               check_ported)
from nmfx_torch.consensus import labels_from_h, one_hot
from nmfx_torch.device import (Mesh, _process_index, explicit_device,
                               process_count, resolve_device)
from nmfx_torch.harvest import fetch_host, start_host_fetch
from nmfx_torch.init import random_init, restart_inits
from nmfx_torch.obs import costmodel
from nmfx_torch.obs import metrics as _metrics
from nmfx_torch.ops.fused_mu import launch_scope
from nmfx_torch.ops.packed_mu import mu_packed, unpack_w
from nmfx_torch.ops.sched_mu import mu_sched
from nmfx_torch.profiling import NullProfiler
from nmfx_torch.solvers import SOLVERS
from nmfx_torch.solvers.base import (ShardInfo, StopReason,
                                     run_loop_batched)

#: surplus restart lanes padded onto meshed sweeps so the restarts split
#: evenly over the restart axis: computed and discarded
_pad_lanes_total = _metrics.counter(
    "nmfx_mesh_pad_lanes_total",
    "surplus restart lanes padded onto meshed sweeps (computed and "
    "discarded; subtract from restarts/s)")

#: mesh axis names, the reference's: the restart batch, the rows of A
#: and W, the columns of A and H
RESTART_AXIS = "restarts"
FEATURE_AXIS = _coll.FEATURE_AXIS
SAMPLE_AXIS = _coll.SAMPLE_AXIS

#: solvers whose updates shard over the feature/sample axes through the
#: batched restart route (the reference's ``GRID_SOLVERS``): kl's
#: quotient contractions, neals' and snmf's normal-equation Grams, hals'
#: shared products; mu grids through ``mu_packed``; als, pg and alspg
#: stay restart-parallel only
GRID_SOLVERS = ("kl", "neals", "snmf", "hals")

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
    engine: mu under "auto", "packed" or "pallas", unscreened (a
    screened config's exact phase runs the batched restart route)."""
    return (solver_cfg.algorithm == "mu" and not solver_cfg.screen
            and solver_cfg.backend in ("auto", "packed", "pallas"))


def resolve_engine_family(solver_cfg: SolverConfig, mesh=None) -> str:
    """The engine family a configuration runs, in the reference's words:
    "tiled" (the out-of-core tile pipeline: ``tile_rows`` is set; a
    one-tile config that ``sweep`` hands to the in-core path says
    "tiled" here too, which only splits identities of equal programs),
    "sketched" (the compressed engine), "pallas" (the hand-written
    kernels), "packed" (mu's packed solve or the dense slot scheduler)
    or "vmap" (the batched restart route, which a screened config's
    exact phase runs). Families sum products in other orders, so a
    registry never crosses them. A restart-only ``mesh`` does not change
    the family (each shard runs the unmeshed engine on its lanes); on
    grid axes the Gram family and hals resolve to "vmap" (the
    grid-sharded batched route), mu to "packed", as in the reference."""
    _check_mesh_type(mesh)
    if solver_cfg.tile_rows is not None:
        return "tiled"
    if solver_cfg.backend == "sketched":
        return "sketched"
    if solver_cfg.screen:
        return "vmap"
    if solver_cfg.backend == "pallas":
        return "pallas"
    if _use_packed(solver_cfg) or grid_exec_ok(solver_cfg, mesh):
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


def _pad_pool_lanes(w0, h0, job_ks: tuple, slots: int):
    """Pad a serving-tier job batch with all-zero lanes up to the full
    ``slots`` pool width (the reference's ``_pad_pool_lanes``): every
    serving dispatch then runs a pool of one width, so a lane's
    products do not depend on what else was packed beside it. Zero
    lanes stay zero under every block (zero numerators) and stop at the
    first check; their rows come after the real jobs and are never
    read. No-op when the batch already fills the pool."""
    pad = slots - w0.shape[0]
    if pad <= 0:
        return w0, h0, job_ks
    k_max = w0.shape[2]
    zw = w0.new_zeros((pad,) + tuple(w0.shape[1:]))
    zh = h0.new_zeros((pad,) + tuple(h0.shape[1:]))
    return (torch.cat([w0, zw]), torch.cat([h0, zh]),
            tuple(job_ks) + (k_max,) * pad)


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


def _packed_lanes(a, keys, k: int, solver_cfg: SolverConfig,
                  init_cfg: InitConfig, label_rule: str,
                  poison: tuple = ()) -> "_Lanes":
    """One packed solve (``mu_packed``) of the restarts ``keys`` at rank k
    on A's device: every lane's factors, labels and stops."""
    r = len(keys)
    w0s, h0s = restart_inits(a, keys, k, init_cfg)
    w0s = _poison_restart_lanes(w0s, poison)
    res = mu_packed(a, w0s, h0s, solver_cfg, device=a.device)
    hs = res.hp.reshape(r, k, -1)
    return _Lanes(unpack_w(res.wp, r), hs, labels_from_h(hs, label_rule),
                  res.iterations, res.dnorm, res.stop_reason,
                  res.host_syncs)


def _build_packed_sweep_fn(k: int, restarts: int, solver_cfg: SolverConfig,
                           init_cfg: InitConfig, label_rule: str,
                           keep_factors: bool = False, mesh=None):
    """The rank-k solve: init + packed solve + labels + consensus, as a
    function of (A on its device, the rank's key). With a restart
    ``mesh`` each shard packs and solves only its restarts, on its device
    (under ``backend="pallas"`` on its own launches of rows 1–2): A is
    then the per-device copies of :func:`place_input`."""

    poison = faults.poison_restarts(k, restarts)
    if mesh is not None:
        _refuse_sharded_poison(poison, mesh)
        return _meshed_rank_fn(k, restarts, mesh, keep_factors, lambda a, ks:
                               _packed_lanes(a, ks, k, solver_cfg, init_cfg,
                                             label_rule))

    def impl(a: torch.Tensor, key: np.ndarray) -> KSweepOutput:
        lanes = _packed_lanes(a, _random.split(key, restarts), k,
                              solver_cfg, init_cfg, label_rule, poison)
        return _rank_output(k, lanes, restarts, keep_factors)

    return impl


def _vmap_lanes(a, keys, k: int, solver_cfg: SolverConfig,
                init_cfg: InitConfig, label_rule: str, chunk: int,
                poison: tuple = ()) -> "_Lanes":
    """The batched restart route over the restarts ``keys`` at rank k on
    A's device, ``chunk`` lanes a solve: every lane's results. ``poison``
    (lane indices) only with one chunk."""
    mod = SOLVERS[solver_cfg.algorithm]
    parts, syncs = [], 0
    for c in range(0, len(keys), chunk):
        w0s, h0s = restart_inits(a, keys[c:c + chunk], k, init_cfg)
        w0s = _poison_restart_lanes(w0s, poison)
        res = run_loop_batched(a, w0s, h0s, solver_cfg, mod.step,
                               mod.init_aux(a, w0s, h0s, solver_cfg))
        syncs += res.host_syncs
        parts.append(res)
    ws, hs, iters, dnorm, stops = (
        torch.cat([getattr(p, f) for p in parts])
        for f in ("w", "h", "iterations", "dnorm", "stop_reason"))
    return _Lanes(ws, hs, labels_from_h(hs, label_rule), iters, dnorm,
                  stops, syncs)


def _build_vmap_sweep_fn(k: int, restarts: int, solver_cfg: SolverConfig,
                         init_cfg: InitConfig, label_rule: str,
                         keep_factors: bool = False, mesh=None):
    """The batched restart route at rank k (the reference's
    ``jax.vmap`` of its generic ``solve``): the rank's restarts as lanes
    of one ``run_loop_batched`` solve of ``solver_cfg.algorithm``, then
    labels, quarantine, consensus and best restart as on the other
    routes. With
    ``restart_chunk`` the restarts run in sequential chunks of that many
    (the last one smaller), which bounds the lanes' (chunk, m, n)
    intermediates; only the per-restart outputs are concatenated, so the
    results do not depend on the chunking. With a restart ``mesh`` each
    shard runs its restarts, ``restart_chunk`` rounded up to a multiple
    of the shard count and split over the shards (the reference's
    per-device concurrency)."""
    chunk = solver_cfg.restart_chunk or restarts
    poison = faults.poison_restarts(k, restarts)
    if poison and chunk < restarts:
        raise ValueError(
            "solve.nonfinite fault injection does not compose with "
            "restart_chunk (chunked batches lose the global lane index); "
            "disarm the site or drop restart_chunk for the chaos run")
    if mesh is not None:
        _refuse_sharded_poison(poison, mesh)
        size = _restart_size(mesh)
        loc_chunk = (-(-solver_cfg.restart_chunk // size)
                     if solver_cfg.restart_chunk
                     else _pad_count(restarts, mesh, count=False) // size)
        return _meshed_rank_fn(k, restarts, mesh, keep_factors, lambda a, ks:
                               _vmap_lanes(a, ks, k, solver_cfg, init_cfg,
                                           label_rule, loc_chunk))

    def impl(a: torch.Tensor, key: np.ndarray) -> KSweepOutput:
        lanes = _vmap_lanes(a, _random.split(key, restarts), k, solver_cfg,
                            init_cfg, label_rule, chunk, poison)
        return _rank_output(k, lanes, restarts, keep_factors)

    return impl


def _build_sketched_sweep_fn(k: int, restarts: int,
                             solver_cfg: SolverConfig,
                             init_cfg: InitConfig, label_rule: str,
                             keep_factors: bool = False):
    """The rank-k sweep of ``backend="sketched"`` (the reference's
    ``_build_sketched_sweep_fn``): the rank's restarts as lanes of one
    compressed solve (``solvers.sketched.sweep_lanes``), each lane's
    projections drawn on A's device from its own restart key, so a given
    (seed, k, restart) starts from the same factors and projections in
    every batch; the epilogue is the batched restart route's."""
    from nmfx_torch.solvers import sketched as sk

    poison = faults.poison_restarts(k, restarts)

    def impl(a: torch.Tensor, key: np.ndarray) -> KSweepOutput:
        keys = _random.split(key, restarts)
        w0s, h0s = restart_inits(a, keys, k, init_cfg)
        w0s = _poison_restart_lanes(w0s, poison)
        res = sk.sweep_lanes(a, w0s, h0s, keys, solver_cfg)
        labels = labels_from_h(res.h, label_rule)
        labels, masked, faulted = _quarantine_lanes(labels, res.dnorm,
                                                    res.stop_reason)
        cons = _quarantined_consensus(labels, k, restarts, faulted)
        best = torch.argmin(masked)
        extra = (res.w, res.h) if keep_factors else (None, None)
        return KSweepOutput(cons, res.iterations, res.dnorm,
                            res.stop_reason, labels, res.w[best],
                            res.h[best], *extra, host_syncs=res.host_syncs)

    return impl


def _build_screened_sweep_fn(k: int, restarts: int,
                             solver_cfg: SolverConfig,
                             init_cfg: InitConfig, label_rule: str,
                             keep_factors: bool = False):
    """The rank-k sweep of restart screening (the reference's
    ``_build_screened_sweep_fn``): the screening pass
    (``solvers.sketched.screen_pass``) scores every restart by its
    compressed objective; the ``screen_keep`` lowest (ties to the lower
    index: a stable sort), re-sorted ascending, receive exact iterations
    on the batched restart route from their canonical keys, under the
    configuration with the screening fields stripped (what
    ``restart_factors`` runs for one of them).

    Screened-out lanes read as pad lanes: labels -1, ``StopReason.
    SCREENED``, dnorm +inf, iterations ``sketch.screen_iters``; they
    count as non-survivors under ``min_restarts``. ``keep_factors`` and
    an armed ``solve.nonfinite`` are refused, as in the reference."""
    from nmfx_torch.solvers import sketched as sk

    keep = solver_cfg.screen_keep
    if keep is None or not 1 <= keep <= restarts:
        raise ValueError(
            f"screen_keep must be in [1, restarts={restarts}], got "
            f"{keep!r}")
    if keep_factors:
        raise ValueError(
            "keep_factors does not compose with screening: screened-out "
            "lanes never receive exact iterations, so there is no full "
            "factor grid to keep (use nmfx_torch.restart_factors on "
            "survivor lanes instead)")
    if faults.poison_restarts(k, restarts):
        raise ValueError(
            "solve.nonfinite fault injection does not compose with "
            "screening (the screening pass reorders which lanes the "
            "exact engine sees); disarm the site for screened sweeps")
    exact_cfg = dataclasses.replace(solver_cfg, screen=False,
                                    screen_keep=None)
    mod = SOLVERS[solver_cfg.algorithm]

    def impl(a: torch.Tensor, key: np.ndarray) -> KSweepOutput:
        n = a.shape[1]
        keys = _random.split(key, restarts)
        w0s, h0s = restart_inits(a, keys, k, init_cfg)
        scores = sk.screen_pass(a, w0s, h0s, keys, solver_cfg)
        surv = torch.sort(torch.argsort(scores, stable=True)[:keep]).values
        ws0, hs0 = w0s[surv], h0s[surv]
        res = run_loop_batched(a, ws0, hs0, exact_cfg, mod.step,
                               mod.init_aux(a, ws0, hs0, exact_cfg))
        labels = torch.full((restarts, n), -1, dtype=torch.int32,
                            device=a.device)
        labels[surv] = labels_from_h(res.h, label_rule)
        iters = torch.full((restarts,), solver_cfg.sketch.screen_iters,
                           dtype=torch.int32, device=a.device)
        iters[surv] = res.iterations
        dnorms = torch.full((restarts,), torch.inf, dtype=res.dnorm.dtype,
                            device=a.device)
        dnorms[surv] = res.dnorm
        stops = torch.full((restarts,), int(StopReason.SCREENED),
                           dtype=torch.int32, device=a.device)
        stops[surv] = res.stop_reason
        labels, _, faulted = _quarantine_lanes(labels, dnorms, stops)
        cons = _quarantined_consensus(labels, k, restarts, faulted)
        # the best restart among the survivors (their own numeric faults
        # masked), indexed in the survivor batch, where factors exist
        surv_masked = torch.where(
            res.stop_reason == int(StopReason.NUMERIC_FAULT), torch.inf,
            res.dnorm)
        bi = torch.argmin(surv_masked)
        return KSweepOutput(cons, iters, dnorms, stops, labels, res.w[bi],
                            res.h[bi], host_syncs=res.host_syncs)

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


def _np_dtype(dtype: str):
    return np.float64 if dtype == "float64" else np.float32


def _dyn_lane_init(init_cfg: InitConfig, dtype: str, n_pad: int,
                   m_pad: int, k_max: int):
    """Lane initializer of the bucketed build functions (the reference's
    ``_dyn_lane_init``): ``build(rank_keys, m_true, n_true, device)``
    draws each lane's random W0 (m_true, k) and H0 (k, n_true) on the
    host from its key (``init.random_init``, the reference's draws) and
    zero-pads it to (m_pad, k_max) / (k_max, n_pad), rank-major in the
    order of ``rank_keys`` (``[(k, (R, 2) keys), ...]``). The reference
    draws at the padded shape inside its executable and masks; by the
    threefry flat-index property its values equal the true-shape draws,
    so both give the same bytes."""
    np_dt = _np_dtype(dtype)
    t_dt = torch.float64 if dtype == "float64" else torch.float32

    def build(rank_keys, m_true: int, n_true: int, device="cpu"):
        count = sum(len(keys) for _, keys in rank_keys)
        w = np.zeros((count, m_pad, k_max), np_dt)
        h = np.zeros((count, k_max, n_pad), np_dt)
        lane = 0
        for k, keys in rank_keys:
            for kk in keys:
                w0, h0 = random_init(kk, m_true, n_true, k, init_cfg,
                                     np_dt)
                w[lane, :m_true, :k] = w0
                h[lane, :k, :n_true] = h0
                lane += 1
        return (torch.from_numpy(w).to(device=device, dtype=t_dt),
                torch.from_numpy(h).to(device=device, dtype=t_dt))

    return build


def bucketed_lane_init_fn(true_shape: tuple, ks: tuple, padded_restarts: int,
                          init_cfg: InitConfig, dtype_str: str,
                          bucket_shape: tuple):
    """Lane batch of a bucketed sweep built outside the bucket's sweep
    (the reference's ``bucketed_lane_init_fn``; the NNDSVD route, which
    factors the true matrix): ``build(a_true, root_key)`` returns every
    (k, restart) lane's W0/H0 from the canonical keys
    ``split(fold_in(root, k), R)`` at the true shape
    (``init.restart_inits``: random draws or NNDSVD), zero-padded to the
    bucket, rank-major and rank-descending."""
    m_true, n_true = true_shape
    m_pad, n_pad = bucket_shape
    ks = tuple(sorted(ks, reverse=True))  # LPT dispatch order
    k_max = max(ks)

    def build(a_true: torch.Tensor, root_key: np.ndarray):
        if tuple(a_true.shape) != (m_true, n_true):
            raise ValueError(
                f"a_true has shape {tuple(a_true.shape)}, the lane "
                f"initializer was built for {(m_true, n_true)}")
        w0l, h0l = [], []
        for k in ks:
            keys = _random.split(_random.fold_in(root_key, k),
                                 padded_restarts)
            w0s, h0s = restart_inits(a_true, keys, k, init_cfg)
            w0l.append(torch.nn.functional.pad(
                w0s, (0, k_max - k, 0, m_pad - m_true)))
            h0l.append(torch.nn.functional.pad(
                h0s, (0, n_pad - n_true, 0, k_max - k)))
        return torch.cat(w0l), torch.cat(h0l)

    return build


def _true_scale(m_pad: int, n_pad: int, m_true: int, n_true: int,
                dtype: torch.dtype, device) -> torch.Tensor:
    """The residual rescale from the padded to the true RMS normalizer:
    pad entries add exact zeros to the Frobenius sums, so only √(mn)
    differs. ``sqrt(m_pad·n_pad / (m_true·n_true))`` in float32, as
    the reference computes it (float math: an int32 m·n can overflow)."""
    f32 = torch.float32
    true_mn = (torch.tensor(m_true, dtype=f32)
               * torch.tensor(n_true, dtype=f32))
    scale = torch.sqrt(torch.tensor(float(m_pad * n_pad), dtype=f32)
                       / true_mn)
    return scale.to(device=device, dtype=dtype)


def _masked_rank_output(res, start: int, k: int, restarts: int,
                        label_rule: str, valid: torch.Tensor,
                        scale: torch.Tensor,
                        keep_factors: bool) -> KSweepOutput:
    """One rank's block of a bucketed pool: labels with pad columns -1
    (the consensus one-hot drops them), residuals rescaled to the true
    shape, quarantine, consensus and best restart; outputs keep the
    bucket's extents (``exec_cache._unpad`` slices them)."""
    sl = slice(start, start + restarts)
    hk = res.h[sl, :k, :]
    wk = res.w[sl, :, :k]
    labels = labels_from_h(hk, label_rule)
    labels = torch.where(valid[None, :], labels, -1)
    dnorm = res.dnorm[sl] * scale
    labels, masked, faulted = _quarantine_lanes(labels, dnorm,
                                                res.stop_reason[sl])
    cons = _quarantined_consensus(labels, k, restarts, faulted)
    best = torch.argmin(masked)
    extra = (wk, hk) if keep_factors else (None, None)
    return KSweepOutput(cons, res.iterations[sl], dnorm,
                        res.stop_reason[sl], labels, wk[best], hk[best],
                        *extra, host_syncs=res.host_syncs,
                        pool_widths=res.pool_widths,
                        pool_trips=res.pool_trips,
                        pool_lanes=res.pool_lanes)


def _solve_bucket_pool(a_pad, w0, h0, job_ks, solver_cfg, grid_slots,
                       flip_floor):
    """The serving build functions' one fixed-geometry pool: the batch padded to
    ``grid_slots`` lanes and solved in one stage (tail cascade off), so
    a lane's products are the same however the pool was composed."""
    w0p, h0p, jks = _pad_pool_lanes(w0, h0, job_ks, grid_slots)
    return mu_sched(a_pad, w0p, h0p, solver_cfg, slots=grid_slots,
                    tail_slots=0, job_ks=jks, flip_floor=flip_floor,
                    device=a_pad.device)


def _build_bucketed_sweep_fn(ks: tuple, restarts: int,
                             solver_cfg: SolverConfig, label_rule: str,
                             mesh, keep_factors: bool, grid_slots: int,
                             grid_tail_slots, bucket_shape: tuple,
                             init_cfg: "InitConfig | None" = None):
    """The whole-grid sweep of the shape-bucketed serving layer (the
    reference's ``_build_bucketed_sweep_fn``, its unmeshed branch): one
    built function serves every dataset whose shape rounds up to
    ``bucket_shape``.

    With ``init_cfg`` (random init) it is
    ``fn(a_pad, root_key, m_true, n_true, flip_floor)`` and draws the
    lanes itself (:func:`_dyn_lane_init`); without it (the NNDSVD route)
    ``fn(a_pad, w0, h0, m_true, n_true, flip_floor)`` with the lane batch
    of :func:`bucketed_lane_init_fn`. ``a_pad`` is the zero-padded
    matrix on its device; ``flip_floor`` is the true sample count's
    class-stability flip budget. Outputs keep the bucket's extents.
    ``grid_tail_slots`` is accepted and pinned off (the fixed pool
    geometry). With a restart ``mesh`` (the reference's meshed branch)
    ``a_pad`` is the per-device copies (:func:`_bucket_copies`) and each
    shard schedules its own lanes of every rank through its own
    ``mu_sched`` (with the ``grid_tail_slots`` cascade, as the
    reference's shards run it); the ranks gather in shard order."""
    if mesh is not None and grid_axes_active(mesh):
        raise ValueError(
            "the bucketed sweeps shard the restart axis only; got mesh "
            f"axes {mesh.shape}")
    if mesh is not None and _restart_size(mesh) > 1:
        return _build_meshed_bucketed_sweep_fn(
            ks, restarts, solver_cfg, label_rule, mesh, keep_factors,
            grid_slots, grid_tail_slots, bucket_shape, init_cfg)
    ks = tuple(sorted(ks, reverse=True))
    k_max = max(ks)
    m_pad, n_pad = bucket_shape
    inside_init = init_cfg is not None
    if inside_init and init_cfg.method != "random":
        raise ValueError(
            "inside-executable init is the random-init fast path; NNDSVD "
            "lane batches are built per true shape (pass init_cfg=None)")
    dyn_init = (_dyn_lane_init(init_cfg, solver_cfg.dtype, n_pad, m_pad,
                               k_max) if inside_init else None)
    job_ks = tuple(k for k in ks for _ in range(restarts))

    def run(a_pad, w0, h0, m_true, n_true, flip_floor):
        res = _solve_bucket_pool(a_pad, w0, h0, job_ks, solver_cfg,
                                 grid_slots, flip_floor)
        scale = _true_scale(m_pad, n_pad, m_true, n_true, res.dnorm.dtype,
                            a_pad.device)
        valid = torch.arange(n_pad, device=a_pad.device) < n_true
        return {k: _masked_rank_output(res, g * restarts, k, restarts,
                                       label_rule, valid, scale,
                                       keep_factors)
                for g, k in enumerate(ks)}

    # the armed solve.nonfinite lanes are read when the function runs,
    # so a cached build follows arm() and disarm()
    def poison_lanes():
        return tuple(g * restarts + r for g, k in enumerate(ks)
                     for r in faults.poison_restarts(k, restarts))

    if inside_init:

        def impl(a_pad, root_key, m_true, n_true, flip_floor):
            rank_keys = [(k, _random.split(_random.fold_in(root_key, k),
                                           restarts)) for k in ks]
            w0, h0 = dyn_init(rank_keys, m_true, n_true, a_pad.device)
            w0 = _poison_restart_lanes(w0, poison_lanes())
            return run(a_pad, w0, h0, m_true, n_true, flip_floor)

        return impl

    def impl_external(a_pad, w0, h0, m_true, n_true, flip_floor):
        if poison_lanes():
            raise ValueError(
                "solve.nonfinite fault injection on the bucketed sweep "
                "needs the random-init route (init inside the sweep); "
                "disarm the site for NNDSVD runs")
        return run(a_pad, w0, h0, m_true, n_true, flip_floor)

    return impl_external


def _build_packed_serve_fn(layout: tuple, solver_cfg: SolverConfig,
                           label_rule: str, grid_slots: int,
                           grid_tail_slots, bucket_shape: tuple,
                           init_cfg: InitConfig):
    """Cross-request lane packing (the reference's
    ``_build_packed_serve_fn``, ``nmfx_torch/serve.py``): one
    slot-scheduled solve whose lanes come from several requests.
    ``layout`` is the static pack shape, ``((k, restarts), ...)`` groups
    sorted rank-descending, one group per (request, rank). The built
    function is

        fn(a_pad, group_roots, m_true, n_true, flip_floor)
            -> tuple[KSweepOutput, ...]   # one per group, layout order

    where ``group_roots`` stacks each group's ``fold_in(key(seed), k)``
    (G, 2), so a group draws exactly its solo run's key chain. The pool
    is padded to ``grid_slots`` with the tail cascade off and the
    epilogue is :func:`_build_bucketed_sweep_fn`'s, so a request's
    results equal its solo bucketed sweep's byte for byte wherever each
    lane's products do not depend on its pool neighbours: the card's
    block kernels (one in-order chain per output) and the plain
    versions at the pool's fixed width. Packing requires (the server's
    compatibility key) one padded matrix, one true shape, one
    configuration and random init."""
    if init_cfg.method != "random":
        raise ValueError(
            "cross-request packing draws lanes inside the executable "
            "(the random-init fast path); NNDSVD requests must dispatch "
            "solo")
    if any(layout[i][0] < layout[i + 1][0] for i in range(len(layout) - 1)):
        raise ValueError(
            f"layout must be sorted rank-descending (LPT), got {layout}")
    k_max = max(k for k, _ in layout)
    m_pad, n_pad = bucket_shape
    dyn_init = _dyn_lane_init(init_cfg, solver_cfg.dtype, n_pad, m_pad,
                              k_max)
    job_ks = tuple(k for k, r in layout for _ in range(r))

    def impl(a_pad, group_roots, m_true, n_true, flip_floor):
        rank_keys = [(k, _random.split(group_roots[g], r))
                     for g, (k, r) in enumerate(layout)]
        w0, h0 = dyn_init(rank_keys, m_true, n_true, a_pad.device)
        # each group poisons the lanes its solo run would: selection is
        # (k, restart)-keyed, not request-keyed
        poison, off = [], 0
        for k, r in layout:
            poison.extend(off + rr for rr in faults.poison_restarts(k, r))
            off += r
        w0 = _poison_restart_lanes(w0, tuple(poison))
        res = _solve_bucket_pool(a_pad, w0, h0, job_ks, solver_cfg,
                                 grid_slots, flip_floor)
        scale = _true_scale(m_pad, n_pad, m_true, n_true, res.dnorm.dtype,
                            a_pad.device)
        valid = torch.arange(n_pad, device=a_pad.device) < n_true
        out, start = [], 0
        for k, r in layout:
            out.append(_masked_rank_output(res, start, k, r, label_rule,
                                           valid, scale, False))
            start += r
        return tuple(out)

    return impl


def _bucket_copies(a_pad, mesh) -> dict:
    """A bucket-padded matrix as the per-device copies a meshed bucketed
    sweep reads (a dict passes through; a tensor is copied to each
    distinct device of the mesh that it is not already on)."""
    if isinstance(a_pad, dict):
        return a_pad
    return {d: a_pad if a_pad.device == d else a_pad.to(d)
            for d in mesh.distinct_devices()}


def _build_meshed_bucketed_sweep_fn(ks: tuple, restarts: int,
                                    solver_cfg: SolverConfig,
                                    label_rule: str, mesh,
                                    keep_factors: bool, grid_slots: int,
                                    grid_tail_slots, bucket_shape: tuple,
                                    init_cfg: "InitConfig | None"):
    """:func:`_build_bucketed_sweep_fn` over a restart mesh: the rank's
    restarts padded to a multiple of the shards, shard ``i`` solving
    lanes ``[i·r, (i+1)·r)`` of every rank in one ``mu_sched`` pool on
    its device, then each rank's parts gathered in shard order (pad
    lanes masked) by :func:`_gathered_rank_output`. The signatures are
    the unmeshed function's, ``a_pad`` a tensor or the per-device
    copies."""
    ks = tuple(sorted(ks, reverse=True))
    k_max = max(ks)
    m_pad, n_pad = bucket_shape
    padded = _pad_count(restarts, mesh, count=False)
    r_loc = padded // _restart_size(mesh)
    inside_init = init_cfg is not None
    if inside_init and init_cfg.method != "random":
        raise ValueError(
            "inside-executable init is the random-init fast path; NNDSVD "
            "lane batches are built per true shape (pass init_cfg=None)")
    dyn_init = (_dyn_lane_init(init_cfg, solver_cfg.dtype, n_pad, m_pad,
                               k_max) if inside_init else None)
    job_ks = tuple(k for k in ks for _ in range(r_loc))

    def refuse_poison():
        if any(faults.poison_restarts(k, restarts) for k in ks):
            raise ValueError(
                "solve.nonfinite fault injection on the bucketed sweeps "
                "needs the random-init unmeshed route (init inside the "
                "sweep); disarm the site for NNDSVD/meshed runs")

    def run(copies, lanes_of, m_true, n_true, flip_floor):
        refuse_poison()
        _pad_count(restarts, mesh)
        copies = _bucket_copies(copies, mesh)

        def work(i, a_s):
            lo = i * r_loc
            w0, h0 = lanes_of(lo, a_s.device)
            res = mu_sched(a_s, w0, h0, solver_cfg, slots=grid_slots,
                           tail_slots=grid_tail_slots, job_ks=job_ks,
                           flip_floor=flip_floor, device=a_s.device)
            scale = _true_scale(m_pad, n_pad, m_true, n_true,
                                res.dnorm.dtype, a_s.device)
            valid = torch.arange(n_pad, device=a_s.device) < n_true
            out = {}
            for g, k in enumerate(ks):
                sl = slice(g * r_loc, (g + 1) * r_loc)
                hk = res.h[sl, :k, :]
                labels = torch.where(valid[None, :],
                                     labels_from_h(hk, label_rule), -1)
                lanes = _Lanes(res.w[sl, :, :k], hk, labels,
                               res.iterations[sl], res.dnorm[sl] * scale,
                               res.stop_reason[sl], res.host_syncs,
                               res.pool_widths, res.pool_trips,
                               res.pool_lanes)
                out[k] = _shard_out(lanes, lo, restarts, keep_factors)
            return out

        parts = _run_shards(mesh, copies, work)
        home = mesh_home(mesh)
        return {k: _gathered_rank_output(k, [p[k] for p in parts],
                                         restarts, keep_factors, home)
                for k in ks}

    if inside_init:

        def impl(a_pad, root_key, m_true, n_true, flip_floor):
            keys = {k: _random.split(_random.fold_in(root_key, k), padded)
                    for k in ks}

            def lanes_of(lo, dev):
                return dyn_init([(k, keys[k][lo:lo + r_loc]) for k in ks],
                                m_true, n_true, dev)

            return run(a_pad, lanes_of, m_true, n_true, flip_floor)

        return impl

    def impl_external(a_pad, w0, h0, m_true, n_true, flip_floor):
        w0s = w0.reshape(len(ks), padded, m_pad, k_max)
        h0s = h0.reshape(len(ks), padded, k_max, n_pad)

        def lanes_of(lo, dev):
            return (w0s[:, lo:lo + r_loc].reshape(-1, m_pad, k_max).to(dev),
                    h0s[:, lo:lo + r_loc].reshape(-1, k_max, n_pad).to(dev))

        return run(a_pad, lanes_of, m_true, n_true, flip_floor)

    return impl_external


# -- the restart mesh -------------------------------------------------------
def local_devices() -> list:
    """This process's cards, as ``jax.local_devices()`` lists a host's
    chips: one CUDA device per card ([] without one)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def grid_mesh(restart_shards: "int | None" = None, feature_shards: int = 1,
              sample_shards: int = 1, devices=None) -> Mesh:
    """A mesh over ``devices`` (default: :func:`local_devices`) with the
    reference's three axes, restarts × features × samples; its shapes and
    errors are the reference's. ``restart_shards=None`` takes every
    device left after the other two axes. A device may be named more than
    once (two restart shards on one card, or a grid group's shards on
    one card, which then share it)."""
    if feature_shards < 1 or sample_shards < 1:
        raise ValueError(
            f"shard counts must be >= 1, got features={feature_shards}, "
            f"samples={sample_shards}")
    devices = list(local_devices() if devices is None else devices)
    auto = restart_shards is None
    if auto:
        restart_shards = len(devices) // (feature_shards * sample_shards)
    n = restart_shards * feature_shards * sample_shards
    if restart_shards < 1:
        why = (f"features×samples={feature_shards * sample_shards} exceeds "
               f"the {len(devices)} available devices" if auto
               else "restart_shards must be >= 1")
        raise ValueError(
            f"mesh {restart_shards}x{feature_shards}x{sample_shards}: {why}")
    if n > len(devices):
        raise ValueError(
            f"mesh {restart_shards}x{feature_shards}x{sample_shards} needs "
            f"{n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(restart_shards, feature_shards, sample_shards),
                (RESTART_AXIS, FEATURE_AXIS, SAMPLE_AXIS))


def feature_mesh(restart_shards: "int | None" = None,
                 feature_shards: int = 1, devices=None) -> Mesh:
    """A 2-D restarts × features mesh: :func:`grid_mesh` without a sample
    axis."""
    if restart_shards is None:
        n = len(local_devices() if devices is None else list(devices))
        restart_shards = n // feature_shards
    mesh = grid_mesh(restart_shards, feature_shards, 1, devices=devices)
    return Mesh(mesh.devices.reshape(restart_shards, feature_shards),
                (RESTART_AXIS, FEATURE_AXIS))


def default_mesh() -> "Mesh | None":
    """A 1-D restart mesh over this process's cards; None with one card
    or none (one device is already the unmeshed route)."""
    devices = local_devices()
    if len(devices) <= 1:
        return None
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr, (RESTART_AXIS,))


def grid_axes_active(mesh) -> bool:
    """Whether the mesh shards single factorizations over the feature or
    sample axis (against a restart-only or absent mesh)."""
    return (mesh is not None
            and any(mesh.shape.get(ax, 1) > 1
                    for ax in (FEATURE_AXIS, SAMPLE_AXIS)))


def _check_mesh_type(mesh) -> None:
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a nmfx_torch Mesh (grid_mesh(R, F, S), "
            f"default_mesh()), got {type(mesh).__name__}")


def _grid_route_check(solver_cfg: SolverConfig, keep_factors: bool) -> None:
    """What the reference refuses on feature/sample axes, with its errors
    (``nmfx/sweep.py:315-350``): the sketched engine and screening, any
    engine but mu's plain packed products and :data:`GRID_SOLVERS`, and
    ``keep_factors``."""
    if solver_cfg.backend == "sketched" or solver_cfg.screen:
        raise ValueError(
            "the sketched engine and restart screening are restart-"
            "parallel only (their per-restart projections have no "
            "feature/sample-sharded formulation); drop the grid "
            "mesh axes")
    grid_ok = ((_use_packed(solver_cfg) and solver_cfg.backend != "pallas")
               or solver_cfg.algorithm in GRID_SOLVERS)
    if not grid_ok:
        raise ValueError(
            "feature/sample-axis sharding requires the packed mu "
            "backend (algorithm='mu', backend='packed'/'auto') or a "
            f"Gram/quotient-sharded solver {GRID_SOLVERS}; got "
            f"algorithm={solver_cfg.algorithm!r}, "
            f"backend={solver_cfg.backend!r}")
    if keep_factors:
        raise ValueError(
            "keep_factors is not supported on feature/sample-sharded "
            "meshes (it would gather every restart's full factors onto "
            "each device); use nmfx_torch.restart_factors to recompute "
            "any restart's factors from its key instead")


def _restart_size(mesh) -> int:
    return 1 if mesh is None else mesh.shape.get(RESTART_AXIS, 1)


def _pad_count(restarts: int, mesh, count: bool = True) -> int:
    """``restarts`` rounded up to a multiple of the mesh's restart-axis
    size, so the lanes split evenly; the surplus lanes draw the keys past
    ``restarts`` (``random.split`` is prefix-stable, so the first
    ``restarts`` are the unmeshed ones) and are discarded. ``count``
    books the surplus in ``nmfx_mesh_pad_lanes_total``."""
    size = _restart_size(mesh)
    padded = -(-restarts // size) * size
    if count and padded > restarts:
        _pad_lanes_total.inc(padded - restarts)
    return padded


def _refuse_sharded_poison(poison, mesh) -> None:
    if poison and _restart_size(mesh) > 1:
        raise ValueError(
            "solve.nonfinite fault injection is not supported on a "
            "restart-sharded mesh (per-shard lane indices); disarm the "
            "site or run unmeshed for the chaos run")


def _shard_entries(mesh) -> list:
    """``[(device, process)]`` of each restart shard, in shard order (a
    restart-only mesh's other axes are of size 1)."""
    axis = (mesh.axis_names.index(RESTART_AXIS)
            if RESTART_AXIS in mesh.axis_names else None)
    devs = mesh.devices
    procs = (np.full(devs.shape, _process_index(), dtype=np.int64)
             if mesh.processes is None else mesh.processes)
    if axis is None:
        return [(devs.flat[0], int(procs.flat[0]))]
    devs = np.moveaxis(devs, axis, 0).reshape(devs.shape[axis], -1)
    procs = np.moveaxis(procs, axis, 0).reshape(devs.shape[0], -1)
    return [(devs[i, 0], int(procs[i, 0])) for i in range(devs.shape[0])]


def mesh_home(mesh) -> torch.device:
    """Where a meshed sweep's outputs live: this process's first device
    in the mesh's order (on a restart mesh its first shard's)."""
    rank = _process_index()
    for idx in np.ndindex(mesh.devices.shape):
        if mesh.process_of(idx) == rank:
            return mesh.devices[idx]
    raise ValueError(f"the mesh holds no device of process {rank}: {mesh}")


class GridInput(NamedTuple):
    """A placed on a mesh with feature or sample axes: each shard's block
    of the zero-padded A on its device, and the true shape. No device
    holds A whole; ``source`` is the input as it was given (host memory,
    or a tensor), which only NNDSVD's one SVD reads."""

    #: {(device, feature index, sample index): (m_loc, n_loc) block}
    blocks: dict
    shape: tuple  # (m_true, n_true)
    block_shape: tuple  # (m_loc, n_loc)
    source: object


def _grid_axes(mesh) -> tuple:
    """(R, F, S) of a mesh (an absent axis has size 1)."""
    return tuple(mesh.shape.get(ax, 1)
                 for ax in (RESTART_AXIS, FEATURE_AXIS, SAMPLE_AXIS))


def _grid_devices(mesh) -> tuple:
    """The mesh's devices and processes as (R, F, S) arrays."""
    shape = _grid_axes(mesh)
    names = [ax for ax in (RESTART_AXIS, FEATURE_AXIS, SAMPLE_AXIS)
             if ax in mesh.axis_names]
    order = [mesh.axis_names.index(ax) for ax in names]
    devs = np.transpose(mesh.devices, order).reshape(shape)
    procs = (np.full(shape, _process_index(), dtype=np.int64)
             if mesh.processes is None
             else np.transpose(mesh.processes, order).reshape(shape))
    return devs, procs


def _place_grid_blocks(a, solver_cfg: SolverConfig, mesh,
                       profiler=None) -> GridInput:
    """The reference's tiled ``place_input``: A zero-padded to a multiple
    of the feature and sample shard counts on the host, and each of this
    process's shards' blocks placed on its device through the input cache
    (``data_cache.place_resilient``). A block is its own host array, so
    its content key is its own: a block never answers for the whole
    matrix, nor the whole for a block."""
    from nmfx_torch.data_cache import place_resilient

    if isinstance(a, GridInput):
        return a
    _, f, s = _grid_axes(mesh)
    dt = _np_dtype(solver_cfg.dtype)
    host = (a.detach().cpu().numpy() if torch.is_tensor(a)
            else np.asarray(a))
    m, n = host.shape
    m_loc, n_loc = -(-m // f), -(-n // s)
    padded = np.zeros((m_loc * f, n_loc * s), dt)
    padded[:m, :n] = host
    devs, procs = _grid_devices(mesh)
    rank = _process_index()
    blocks: dict = {}
    for idx in np.ndindex(devs.shape):
        if int(procs[idx]) != rank:
            continue
        _, fi, si = idx
        key = (devs[idx], fi, si)
        if key not in blocks:
            blk = np.ascontiguousarray(
                padded[fi * m_loc:(fi + 1) * m_loc,
                       si * n_loc:(si + 1) * n_loc])
            blocks[key] = place_resilient(blk, solver_cfg, devs[idx],
                                          profiler=profiler)
    return GridInput(blocks, (m, n), (m_loc, n_loc), a)


def place_input(a, solver_cfg: SolverConfig, mesh=None, device=None):
    """A in the solver dtype on its devices: with ``mesh=None`` one tensor
    on ``device`` (None = CUDA); with a restart mesh ``{device: tensor}``,
    A replicated to each distinct device of this process (a card named
    twice holds one copy); with feature or sample axes a
    :class:`GridInput`, A *tiled* over them (no device holds it whole).
    Every copy goes through the input cache
    (``data_cache.place_resilient``), so a repeat sweep copies nothing."""
    from nmfx_torch.data_cache import place_resilient

    if mesh is None:
        return place_resilient(a, solver_cfg, resolve_device(device))
    if grid_axes_active(mesh):
        return _place_grid_blocks(a, solver_cfg, mesh)
    return {d: place_resilient(a, solver_cfg, d)
            for d in mesh.distinct_devices()}


class _Lanes(NamedTuple):
    """A batch of restart lanes' results on one device."""

    w: torch.Tensor  # (r, m, k)
    h: torch.Tensor  # (r, k, n)
    labels: torch.Tensor  # (r, n), before the quarantine
    iterations: torch.Tensor
    dnorm: torch.Tensor
    stop_reason: torch.Tensor
    host_syncs: int = 0
    pool_widths: tuple = ()
    pool_trips: tuple = ()
    pool_lanes: tuple = ()


class _ShardOut(NamedTuple):
    """What a restart shard hands the gather: its lanes' per-restart
    outputs and its best-restart candidate (every lane's factors only
    under ``keep_factors``). On a mesh of several processes it crosses
    the gloo group on the host."""

    labels: torch.Tensor
    iterations: torch.Tensor
    dnorm: torch.Tensor
    stop_reason: torch.Tensor
    best_dnorm: torch.Tensor  # () the candidate's masked residual
    best_w: torch.Tensor
    best_h: torch.Tensor
    all_w: "torch.Tensor | None"
    all_h: "torch.Tensor | None"
    host_syncs: int = 0
    pool_widths: tuple = ()
    pool_trips: tuple = ()
    pool_lanes: tuple = ()


def _rank_output(k: int, lanes: _Lanes, restarts: int,
                 keep_factors: bool) -> KSweepOutput:
    """One rank's output from all of its lanes on one device: labels
    quarantined, the consensus over the survivors, the best restart the
    first minimum of the masked residuals."""
    labels, masked, faulted = _quarantine_lanes(lanes.labels, lanes.dnorm,
                                                lanes.stop_reason)
    cons = _quarantined_consensus(labels, k, restarts, faulted)
    best = torch.argmin(masked)
    extra = ((lanes.w.contiguous(), lanes.h) if keep_factors
             else (None, None))
    return KSweepOutput(cons, lanes.iterations, lanes.dnorm,
                        lanes.stop_reason, labels, lanes.w[best],
                        lanes.h[best], *extra, host_syncs=lanes.host_syncs,
                        pool_widths=lanes.pool_widths,
                        pool_trips=lanes.pool_trips,
                        pool_lanes=lanes.pool_lanes)


def _shard_out(lanes: _Lanes, lo: int, restarts: int,
               keep_factors: bool) -> _ShardOut:
    """A shard's lanes, global restarts ``[lo, lo + r)``, reduced to what
    the gather needs: the candidate is the first minimum of the shard's
    quarantine-masked residuals with its pad lanes masked too, so the
    first minimum over the candidates in shard order is the unmeshed
    first-minimum ``argmin``."""
    r = lanes.labels.shape[0]
    valid = torch.arange(lo, lo + r, device=lanes.dnorm.device) < restarts
    _, masked, _ = _quarantine_lanes(lanes.labels, lanes.dnorm,
                                     lanes.stop_reason)
    masked = torch.where(valid, masked, torch.inf)
    b = torch.argmin(masked)
    extra = (lanes.w, lanes.h) if keep_factors else (None, None)
    return _ShardOut(lanes.labels, lanes.iterations, lanes.dnorm,
                     lanes.stop_reason, masked[b], lanes.w[b], lanes.h[b],
                     *extra, lanes.host_syncs, lanes.pool_widths,
                     lanes.pool_trips, lanes.pool_lanes)


def _gathered_rank_output(k: int, outs: list, restarts: int,
                          keep_factors: bool,
                          home: torch.device) -> KSweepOutput:
    """One rank's output from its shards' parts in shard order, on
    ``home``: the unmeshed epilogue (quarantine, consensus) over the
    concatenated lanes with the pad lanes sliced off, and the best
    restart the first minimum over the shards' candidates."""

    def cat(f):
        return torch.cat([getattr(o, f).to(home) for o in outs])[:restarts]

    labels, iters, dnorm, stops = (cat(f) for f in (
        "labels", "iterations", "dnorm", "stop_reason"))
    labels, _, faulted = _quarantine_lanes(labels, dnorm, stops)
    cons = _quarantined_consensus(labels, k, restarts, faulted)
    g = torch.argmin(torch.stack([o.best_dnorm.to(home) for o in outs]))
    best_w = torch.stack([o.best_w.to(home) for o in outs])[g]
    best_h = torch.stack([o.best_h.to(home) for o in outs])[g]
    extra = ((cat("all_w"), cat("all_h")) if keep_factors
             else (None, None))
    return KSweepOutput(cons, iters, dnorm, stops, labels, best_w, best_h,
                        *extra, host_syncs=sum(o.host_syncs for o in outs),
                        pool_widths=outs[0].pool_widths,
                        pool_trips=outs[0].pool_trips,
                        pool_lanes=outs[0].pool_lanes)


def _meshed_rank_fn(k: int, restarts: int, mesh, keep_factors: bool,
                    lanes_fn):
    """A per-rank route over a restart mesh: ``fn(copies, key)`` with A's
    per-device copies (:func:`place_input`) and the rank's folded key;
    shard ``i`` runs ``lanes_fn(A, keys[i·r:(i+1)·r])`` on its device."""
    padded = _pad_count(restarts, mesh, count=False)
    r_loc = padded // _restart_size(mesh)

    def impl(copies, key: np.ndarray) -> KSweepOutput:
        _pad_count(restarts, mesh)
        keys = _random.split(key, padded)

        def work(i, a_s):
            lo = i * r_loc
            return _shard_out(lanes_fn(a_s, keys[lo:lo + r_loc]), lo,
                              restarts, keep_factors)

        parts = _run_shards(mesh, copies, work)
        return _gathered_rank_output(k, parts, restarts, keep_factors,
                                     mesh_home(mesh))

    return impl


def _to_host(x):
    """A shard's result with every tensor on the host (for the gloo
    gather)."""
    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {key: _to_host(v) for key, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_host(v) for v in x))
    return x


def _run_shards(mesh, copies: dict, work) -> list:
    """``work(i, A on shard i's device)`` for every restart shard of the
    mesh, results in shard order. One thread serves each distinct device
    of this process, its shards one after another (each under its own
    ``fused_mu.launch_scope("shard<i>")``); with a single device the
    calling thread serves it. A shard's exception is raised here, the
    first in shard order. When the mesh spans several processes, each
    runs its own shards and the results are gathered on the host over
    the default ``torch.distributed`` (gloo) group, so every process
    returns every shard's results."""
    entries = _shard_entries(mesh)
    rank = _process_index()
    by_dev: dict = {}
    for i, (dev, proc) in enumerate(entries):
        if proc == rank:
            by_dev.setdefault(dev, []).append(i)
    results: dict = {}
    errors: dict = {}

    def serve(dev, idxs):
        with _coll.device_context(dev):
            for i in idxs:
                try:
                    with launch_scope(f"shard{i}"):
                        results[i] = work(i, copies[dev])
                except BaseException as e:  # nmfx: ignore[NMFX006] -- the
                    # caller re-raises
                    errors[i] = e
                    return
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    if len(by_dev) <= 1:
        for dev, idxs in by_dev.items():
            serve(dev, idxs)
    else:
        threads = [threading.Thread(target=serve, args=(dev, idxs),
                                    name=f"nmfx-shard-{dev}", daemon=True)
                   for dev, idxs in by_dev.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[min(errors)]
    if any(proc != rank for _, proc in entries):
        import torch.distributed as dist

        mine = {i: _to_host(results[i]) for i in results}
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, mine)
        results = {}
        for part in gathered:
            results.update(part)
    return [results[i] for i in range(len(entries))]


def _build_meshed_chunk_sweep_fn(k: int, n_chunk: int,
                                 solver_cfg: SolverConfig,
                                 init_cfg: InitConfig, label_rule: str,
                                 poison: tuple, mesh):
    """The durable chunk executor over a restart-only sub-mesh (the
    reference's ``_build_meshed_chunk_sweep_fn``: the elastic runner's
    shard that owns a device set). The chunk's lanes split over the
    shards, padded by repeating the chunk's own keys; each shard runs the
    batched restart route on its lanes, and the record's best restart is
    the first minimum over the chunk's masked residuals. So the record
    equals the unmeshed executor's. The packed family is refused, as in
    the reference: its pool is one packed solve of the whole chunk."""
    if grid_axes_active(mesh) or RESTART_AXIS not in mesh.axis_names:
        raise ValueError(
            "meshed chunk execution shards the restart axis only; got "
            f"mesh axes {mesh.shape}")
    if _use_packed(solver_cfg):
        raise ValueError(
            "meshed chunk execution supports the batched restart route "
            "only (the packed family's pool geometry is composition-"
            "dependent; ledger records must stay bit-identical to the "
            "unmeshed chunk executor)")
    size = _restart_size(mesh)
    r_loc = -(-n_chunk // size)
    n_pad = r_loc * size

    def impl(copies, keys: np.ndarray) -> ChunkSweepOutput:
        if n_pad != n_chunk:
            keys = np.concatenate([keys] * -(-n_pad // n_chunk))[:n_pad]

        def work(i, a_s):
            lo = i * r_loc
            w0s, h0s = restart_inits(a_s, keys[lo:lo + r_loc], k, init_cfg)
            local = tuple(p - lo for p in poison if lo <= p < lo + r_loc)
            w0s = _poison_restart_lanes(w0s, local)
            mod = SOLVERS[solver_cfg.algorithm]
            res = run_loop_batched(a_s, w0s, h0s, solver_cfg, mod.step,
                                   mod.init_aux(a_s, w0s, h0s, solver_cfg))
            lanes = _Lanes(res.w, res.h, labels_from_h(res.h, label_rule),
                           res.iterations, res.dnorm, res.stop_reason)
            return _shard_out(lanes, lo, n_chunk, False)

        parts = _run_shards(mesh, copies, work)
        home = mesh_home(mesh)

        def cat(f):
            return torch.cat([getattr(o, f).to(home) for o in parts])

        labels, iters, dnorm, stops = (cat(f) for f in (
            "labels", "iterations", "dnorm", "stop_reason"))
        labels, masked, _ = _quarantine_lanes(labels, dnorm, stops)
        masked = torch.where(torch.arange(n_pad, device=home) < n_chunk,
                             masked, torch.inf)
        best = torch.argmin(masked)
        g = torch.argmin(torch.stack([o.best_dnorm.to(home)
                                      for o in parts]))
        return ChunkSweepOutput(
            labels[:n_chunk], iters[:n_chunk], dnorm[:n_chunk],
            stops[:n_chunk], best.to(torch.int32),
            torch.stack([o.best_w.to(home) for o in parts])[g],
            torch.stack([o.best_h.to(home) for o in parts])[g])

    return impl


def _grid_groups(mesh) -> list:
    """One :class:`~nmfx_torch.collectives.GridGroup` a restart shard of
    a mesh with grid axes, each with its gloo subgroup when its shards
    span several processes (made by every process alike)."""
    devs, procs = _grid_devices(mesh)
    r, f, s = devs.shape
    pgs = _coll.group_pgs(mesh, [procs[ri] for ri in range(r)])
    return [_coll.GridGroup(f, s, procs[ri], pgs[ri]) for ri in range(r)]


def _grid_init(source, k: int, keys: np.ndarray, shape: tuple,
               padded_shape: tuple, init_cfg: InitConfig, dtype: str,
               home) -> tuple:
    """Every lane's full W0 / H0, zero-padded to the shard grid, on the
    host: random draws from each restart's canonical key at the true
    shape (the same factors on every mesh shape), or NNDSVD once from the
    full A on ``home`` (deterministic in A: every lane alike). Shards
    slice their blocks from these."""
    m, n = shape
    m_pad, n_pad = padded_shape
    np_dt = _np_dtype(dtype)
    r = len(keys)
    w = np.zeros((r, m_pad, k), np_dt)
    h = np.zeros((r, k, n_pad), np_dt)
    if init_cfg.method == "nndsvd":
        from nmfx_torch.init import nndsvd_init

        t_dt = torch.float64 if dtype == "float64" else torch.float32
        full = (source.to(device=home, dtype=t_dt) if torch.is_tensor(source)
                else torch.as_tensor(np.asarray(source, np_dt), device=home))
        w0, h0 = nndsvd_init(full, k, svd_method=init_cfg.svd_method,
                             ncv=init_cfg.ncv)
        w[:, :m] = w0.cpu().numpy()
        h[:, :, :n] = h0.cpu().numpy()
        return w, h
    for i, kk in enumerate(keys):
        w[i, :m], h[i, :, :n] = random_init(kk, m, n, k, init_cfg, np_dt)
    return w, h


def _build_grid_sharded_sweep_fn(k: int, restarts: int,
                                 solver_cfg: SolverConfig,
                                 init_cfg: InitConfig, label_rule: str,
                                 mesh):
    """The sweep of a mesh with feature (row) and/or sample (column) axes,
    composed with the restart axis (the reference's
    ``_build_grid_sharded_sweep_fn``, ``nmfx/sweep.py:900-1140``):
    ``fn(grid_input, key)`` with A's blocks (:func:`place_input`).

    Layout: A tiled over (features, samples), W row-sharded, H
    column-sharded. Each restart shard is one grid group whose F×S shards
    run on their own threads in lockstep (``nmfx_torch.collectives``):
    mu through ``mu_packed(shard=)``, a :data:`GRID_SOLVERS` algorithm
    through the batched restart route with its ``shard`` bound, in
    ``restart_chunk`` chunks of ``ceil(chunk / R)`` lanes a shard. Init
    draws every lane's full factors from its canonical key, zero-pads and
    slices them (NNDSVD once from the full A). Labels come from the local
    columns and are gathered over the samples; the best restart of a
    restart shard is the first minimum of its masked residuals (the same
    scalars on every shard of the group), its factors gathered over the
    grid axes; the rank's quarantine, consensus and best restart then
    reduce the restart shards' parts in shard order
    (:func:`_gathered_rank_output`)."""
    r_shards, f_shards, s_shards = _grid_axes(mesh)
    f_ax = FEATURE_AXIS if f_shards > 1 else None
    s_ax = SAMPLE_AXIS if s_shards > 1 else None
    padded = _pad_count(restarts, mesh, count=False)
    r_loc = padded // r_shards
    grid_mod = (SOLVERS[solver_cfg.algorithm]
                if solver_cfg.algorithm in GRID_SOLVERS else None)
    chunk = solver_cfg.restart_chunk
    c_loc = max(1, -(-chunk // r_shards)) if chunk is not None else r_loc
    devs, _ = _grid_devices(mesh)

    def impl(grid_in, key: np.ndarray) -> KSweepOutput:
        if not isinstance(grid_in, GridInput):
            grid_in = _place_grid_blocks(grid_in, solver_cfg, mesh)
        _pad_count(restarts, mesh)
        m_true, n_true = grid_in.shape
        m_loc, n_loc = grid_in.block_shape
        home = mesh_home(mesh)
        keys = _random.split(key, padded)
        w_all, h_all = _grid_init(grid_in.source, k, keys, grid_in.shape,
                                  (m_loc * f_shards, n_loc * s_shards),
                                  init_cfg, solver_cfg.dtype, home)
        groups = _grid_groups(mesh)

        def work(ri: int, comm) -> _ShardOut:
            fi, si = comm.fidx, comm.sidx
            dev = devs[ri, fi, si]
            with _coll.device_context(dev):
                a_loc = grid_in.blocks[(dev, fi, si)]
                lo = ri * r_loc
                w0s = torch.from_numpy(np.ascontiguousarray(
                    w_all[lo:lo + r_loc, fi * m_loc:(fi + 1) * m_loc])
                ).to(device=dev, dtype=a_loc.dtype)
                h0s = torch.from_numpy(np.ascontiguousarray(
                    h_all[lo:lo + r_loc, :, si * n_loc:(si + 1) * n_loc])
                ).to(device=dev, dtype=a_loc.dtype)
                info = ShardInfo(f_ax, s_ax, m_true, n_true, comm)
                if grid_mod is None:
                    res = mu_packed(a_loc, w0s, h0s, solver_cfg,
                                    device=dev, shard=info)
                    hs = res.hp.reshape(r_loc, k, -1)
                    ws = unpack_w(res.wp, r_loc)
                    parts = [res]
                else:
                    step = _functools.partial(grid_mod.step, shard=info)
                    parts = []
                    for c in range(0, r_loc, c_loc):
                        w0c, h0c = w0s[c:c + c_loc], h0s[c:c + c_loc]
                        parts.append(run_loop_batched(
                            a_loc, w0c, h0c, solver_cfg, step,
                            grid_mod.init_aux(a_loc, w0c, h0c, solver_cfg,
                                              shard=info), info))
                    ws = torch.cat([p.w for p in parts])
                    hs = torch.cat([p.h for p in parts])
                iters, dnorm, stops = (
                    torch.cat([getattr(p, f) for p in parts])
                    for f in ("iterations", "dnorm", "stop_reason"))
                labels = labels_from_h(hs, label_rule)  # (r_loc, n_loc)
                if s_ax is not None:
                    labels = comm.all_gather(labels, s_ax, dim=1)
                labels = labels[:, :n_true]
                valid = (torch.arange(lo, lo + r_loc, device=dev)
                         < restarts)
                _, masked, _ = _quarantine_lanes(labels, dnorm, stops)
                masked = torch.where(valid, masked, torch.inf)
                b = torch.argmin(masked)
                bw, bh = ws[b], hs[b]
                if f_ax is not None:
                    bw = comm.all_gather(bw, f_ax, dim=0)
                if s_ax is not None:
                    bh = comm.all_gather(bh, s_ax, dim=1)
                out = _ShardOut(labels, iters, dnorm, stops, masked[b],
                                bw[:m_true], bh[:, :n_true], None, None,
                                sum(p.host_syncs for p in parts))
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                return out

        results = _coll.run_groups(groups, work)
        # shard (0, 0) of each group speaks for it: every shard of a group
        # holds the same gathered outputs
        mine = {ri: results[(ri, 0)] for ri in range(r_shards)
                if (ri, 0) in results}
        if process_count() > 1 and mesh.processes is not None:
            import torch.distributed as dist

            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, {ri: _to_host(o)
                                           for ri, o in mine.items()})
            mine = {}
            for part in every:
                mine.update(part)
        return _gathered_rank_output(k, [mine[ri] for ri in range(r_shards)],
                                     restarts, False, home)

    return impl


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
    order. With a restart ``mesh`` (:func:`grid_mesh`) each route runs
    restart-sharded, ``a`` a tensor or the per-device copies of
    :func:`place_input`, and the outputs land on :func:`mesh_home`; the
    sketched and screened engines ignore a restart mesh, as the
    reference's do, and run on the home device. A mesh with feature or
    sample axes runs :func:`_build_grid_sharded_sweep_fn` (``a`` a
    tensor, a host array or :func:`place_input`'s :class:`GridInput`),
    refusing what the reference refuses there. ``tile_rows`` is refused:
    ``sweep`` routes it."""
    _check_mesh_type(mesh)
    if grid_axes_active(mesh):
        _grid_route_check(solver_cfg, keep_factors)
    if solver_cfg.tile_rows is not None:
        # sweep() owns the out-of-core routing (one-tile delegation
        # included), because it runs before A is placed on the device
        raise ValueError(
            "tile_rows is routed by sweep() (which delegates one-tile "
            "dense configs to this in-core path and streams the rest "
            "through nmfx_torch.tiles); call sweep(), or "
            "nmfx_torch.tiles.sweep_one_k_tiled for the streaming engine "
            "directly")
    if grid_axes_active(mesh):
        fn = _build_grid_sharded_sweep_fn(k, restarts, solver_cfg,
                                          init_cfg, label_rule, mesh)
        return fn(a, key)
    if mesh is not None:
        if not isinstance(a, dict):
            dt = torch.float64 if solver_cfg.dtype == "float64" else \
                torch.float32
            a = {d: torch.as_tensor(a).to(device=d, dtype=dt)
                 for d in mesh.distinct_devices()}
        if solver_cfg.backend == "sketched" or solver_cfg.screen:
            a, mesh = a[mesh_home(mesh)], None
    if solver_cfg.backend == "sketched":
        fn = _build_sketched_sweep_fn(k, restarts, solver_cfg, init_cfg,
                                      label_rule, keep_factors)
        return fn(a, key)
    if solver_cfg.screen:
        fn = _build_screened_sweep_fn(k, restarts, solver_cfg, init_cfg,
                                      label_rule, keep_factors)
        return fn(a, key)
    if _use_packed(solver_cfg):
        fn = _build_packed_sweep_fn(k, restarts, solver_cfg, init_cfg,
                                    label_rule, keep_factors, mesh)
        return fn(a, key)
    if grid_exec_ok(solver_cfg, mesh):
        fn = _build_grid_exec_sweep_fn((k,), restarts, solver_cfg, init_cfg,
                                       label_rule, keep_factors, grid_slots,
                                       grid_tail_slots, fold_keys=False,
                                       mesh=mesh)
        return fn(a, key)[k]
    fn = _build_vmap_sweep_fn(k, restarts, solver_cfg, init_cfg, label_rule,
                              keep_factors, mesh)
    return fn(a, key)


def grid_exec_ok(solver_cfg: SolverConfig, mesh=None) -> bool:
    """Whether the whole-grid slot scheduler can run this configuration:
    an algorithm with a dense-batched block under a backend that routes
    it there (``_GRID_EXEC_BACKENDS``), with A on the device (not under
    ``tile_rows``), exact and unscreened (the compressed engine and the
    screening two-phase dispatch have no slot-scheduled form), on no
    feature or sample mesh axes (the grid composes with the restart axis
    only). The executable cache's serving contract reads this too."""
    if solver_cfg.backend == "sketched" or solver_cfg.screen:
        return False
    if solver_cfg.tile_rows is not None:
        return False
    if solver_cfg.backend not in _GRID_EXEC_BACKENDS.get(
            solver_cfg.algorithm, ()):
        return False
    return not grid_axes_active(mesh)


def _grid_lanes(a, rank_keys, solver_cfg: SolverConfig,
                init_cfg: InitConfig, label_rule: str, slots: int,
                tail_slots, poison: tuple = ()) -> "dict[int, _Lanes]":
    """One ``mu_sched`` solve of ``rank_keys`` (``[(k, keys), ...]``,
    rank-descending) on A's device, lanes rank-major and zero-padded to
    the largest rank: each rank's lanes' results (the pool diagnostics and
    host reads on every rank)."""
    k_max = max(k for k, _ in rank_keys)
    w0l, h0l = [], []
    for k, keys in rank_keys:
        w0s, h0s = restart_inits(a, keys, k, init_cfg)
        w0l.append(torch.nn.functional.pad(w0s, (0, k_max - k)))
        h0l.append(torch.nn.functional.pad(h0s, (0, 0, 0, k_max - k)))
    res = mu_sched(a, _poison_restart_lanes(torch.cat(w0l), poison),
                   torch.cat(h0l), solver_cfg, slots=slots,
                   tail_slots=tail_slots,
                   job_ks=tuple(k for k, keys in rank_keys
                                for _ in range(len(keys))),
                   device=a.device)
    out, start = {}, 0
    for k, keys in rank_keys:
        sl = slice(start, start + len(keys))
        start += len(keys)
        hk = res.h[sl, :k, :]  # true rows only: right under both rules
        out[k] = _Lanes(res.w[sl, :, :k], hk, labels_from_h(hk, label_rule),
                        res.iterations[sl], res.dnorm[sl],
                        res.stop_reason[sl], res.host_syncs,
                        res.pool_widths, res.pool_trips, res.pool_lanes)
    return out


def _build_grid_exec_sweep_fn(ks: tuple[int, ...], restarts: int,
                              solver_cfg: SolverConfig,
                              init_cfg: InitConfig, label_rule: str,
                              keep_factors: bool = False, slots: int = 48,
                              tail_slots="auto", fold_keys: bool = True,
                              mesh=None):
    """The whole-grid sweep as a function of (A on its device, the root
    key): every (k, restart) job through one ``mu_sched`` solve, jobs
    rank-descending (longest expected first), lanes rank-major and
    zero-padded to the largest rank; per-rank labels, quarantine,
    consensus and best restart from static slices of the per-job
    results. ``fold_keys=False`` is the single-rank mode whose key is
    already folded with its k. With a restart ``mesh`` each shard
    schedules its own restarts of every rank through its own ``mu_sched``
    on its device (rows 3 or 5 under ``backend="pallas"``), and the
    caller gathers each rank's lanes in shard order; A is then the
    per-device copies of :func:`place_input`."""
    if not fold_keys and len(ks) != 1:
        raise ValueError("fold_keys=False is the single-rank (pre-folded "
                         "key) mode; got several ks")
    ks = tuple(sorted(ks, reverse=True))  # LPT dispatch order
    # the global lane of each poisoned (k, restart) in the rank-major stack
    poison = tuple(g * restarts + r for g, k in enumerate(ks)
                   for r in faults.poison_restarts(k, restarts))
    if mesh is not None:
        _refuse_sharded_poison(poison, mesh)
        padded = _pad_count(restarts, mesh, count=False)
        r_loc = padded // _restart_size(mesh)

        def meshed(copies, root_key: np.ndarray) -> dict[int, KSweepOutput]:
            _pad_count(restarts, mesh)
            keys = {k: _random.split(_random.fold_in(root_key, k)
                                     if fold_keys else root_key, padded)
                    for k in ks}

            def work(i, a_s):
                lo = i * r_loc
                lanes = _grid_lanes(
                    a_s, [(k, keys[k][lo:lo + r_loc]) for k in ks],
                    solver_cfg, init_cfg, label_rule, slots, tail_slots)
                return {k: _shard_out(lanes[k], lo, restarts, keep_factors)
                        for k in ks}

            parts = _run_shards(mesh, copies, work)
            home = mesh_home(mesh)
            return {k: _gathered_rank_output(k, [p[k] for p in parts],
                                             restarts, keep_factors, home)
                    for k in ks}

        return meshed

    def impl(a: torch.Tensor, root_key: np.ndarray
             ) -> dict[int, KSweepOutput]:
        rank_keys = [(k, _random.split(_random.fold_in(root_key, k)
                                       if fold_keys else root_key,
                                       restarts)) for k in ks]
        lanes = _grid_lanes(a, rank_keys, solver_cfg, init_cfg, label_rule,
                            slots, tail_slots, poison)
        return {k: _rank_output(k, lanes[k], restarts, keep_factors)
                for k in ks}

    return impl


def resolve_autotune(shape, cfg: ConsensusConfig, solver_cfg: SolverConfig,
                     *, device=None, mesh=None, exec_cache=None
                     ) -> SolverConfig:
    """``solver_cfg`` with ``experimental.autotune="on"`` resolved by the
    block-shape autotuner (``nmfx_torch.autotune.resolve``) at A's shape
    ``(m, n)``, the sweep's largest rank and the slot count the scheduler
    takes for the grid (``grid_slots``, at most the job count); any other
    config comes back as it is. The store lives under the executable
    cache's ``cache_dir`` (``<cache_dir>/autotune``); the search runs on
    the sweep's device (a mesh's first device of this process)."""
    if solver_cfg.experimental.autotune != "on":
        return solver_cfg
    import os

    from nmfx_torch import autotune

    m, n = shape
    slots = min(int(cfg.grid_slots), int(cfg.restarts) * len(cfg.ks))
    at_dir = None
    if exec_cache is not None and exec_cache.cfg.cache_dir:
        at_dir = os.path.join(exec_cache.cfg.cache_dir, "autotune")
    if mesh is not None:
        device = mesh_home(mesh)
    elif exec_cache is not None and device is None:
        device = exec_cache.device
    return autotune.resolve(solver_cfg, m, n, int(max(cfg.ks)), slots,
                            cache_dir=at_dir, device=device)


def sweep(a, cfg: ConsensusConfig = ConsensusConfig(),
          solver_cfg: SolverConfig = SolverConfig(),
          init_cfg: InitConfig = InitConfig(), *, device=None,
          mesh=None, on_rank=None, profiler=None, registry=None,
          checkpoint=None, exec_cache=None) -> dict[int, KSweepOutput]:
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

    ``experimental.autotune="on"`` resolves the kernel schedule first
    (:func:`resolve_autotune`, after the out-of-core routing).

    Out-of-core routing comes first: with ``solver_cfg.tile_rows`` set
    or a ``nmfx_torch.sparse.SparseMatrix`` input, a dense plan of one
    tile runs on with ``tile_rows`` stripped (byte-equal to the dense
    sweep, under the dense identity in every key downstream); a
    multi-tile plan and every sparse input run the streamed engine
    (:func:`_sweep_tiled`).

    ``mesh`` (:func:`grid_mesh`): on a restart mesh every route runs
    restart-sharded, each shard on its device, A replicated to each
    distinct device (``device`` is then unused) and the outputs on
    :func:`mesh_home`; on the CPU each lane computes what it computes
    unmeshed, so the result is byte-equal to the unmeshed sweep. With
    feature or sample axes the ranks run one after another on the
    grid-sharded sweep, A tiled over the grid axes
    (:func:`_build_grid_sharded_sweep_fn`). Checkpoints, tiles and the
    executable cache refuse a sharded mesh, as the reference's do.
    """
    if profiler is None:
        profiler = NullProfiler()
    _check_mesh_type(mesh)
    grid_axes = grid_axes_active(mesh)
    if grid_axes:
        _grid_route_check(solver_cfg, cfg.keep_factors)
    sharded = mesh is not None and any(
        v > 1 for v in mesh.shape.values())
    from nmfx_torch.sparse import SparseMatrix

    sparse_input = isinstance(a, SparseMatrix)
    if solver_cfg.tile_rows is not None or sparse_input:
        from nmfx_torch import tiles as _tiles

        plan = _tiles.plan_for(a, solver_cfg)
        if plan.n_tiles == 1 and not sparse_input:
            solver_cfg = dataclasses.replace(solver_cfg, tile_rows=None)
        else:
            if sharded:
                raise ValueError(
                    "out-of-core (tiled/sparse) sweeps stream tiles "
                    "through the default device; drop the mesh (the tile "
                    "budget, not the device count, bounds the working "
                    "set)")
            return _sweep_tiled(a, plan, cfg, solver_cfg, init_cfg,
                                device=device, registry=registry,
                                profiler=profiler, on_rank=on_rank,
                                checkpoint=checkpoint)
    # the block-shape autotuner resolves here, before the checkpoint,
    # executable-cache and registry branches, so every key downstream
    # (fingerprint, bucket key, ledger manifest) sees the resolved
    # kernel schedule, and a warm process resolves to the same config
    solver_cfg = resolve_autotune(tuple(a.shape), cfg, solver_cfg,
                                  device=device, mesh=mesh,
                                  exec_cache=exec_cache)
    if checkpoint is not None:
        if registry is not None:
            raise ValueError(
                "pass either checkpoint (the durable chunked ledger) or "
                "registry (the legacy per-rank SweepRegistry), not both")
        if sharded:
            raise ValueError(
                "checkpointed sweeps execute per-(k, restart-chunk) on "
                "the default device (the chunk plan is the durability "
                "unit); drop the mesh, or use nmfx_torch.distributed's "
                "elastic shard runner for multi-device durable sweeps")
        from nmfx_torch.checkpoint import run_checkpointed_sweep

        return run_checkpointed_sweep(a, cfg, solver_cfg, init_cfg,
                                      checkpoint, device=device,
                                      profiler=profiler, on_rank=on_rank)
    if (exec_cache is not None and registry is None
            and exec_cache.cacheable(cfg, solver_cfg, mesh)):
        if mesh is None and explicit_device(
                resolve_device(device)) != exec_cache.device:
            raise ValueError(
                f"the sweep's device ({resolve_device(device)}) is not the "
                f"executable cache's ({exec_cache.device})")
        # a restart mesh passes the reference's predicate and is refused
        # there (the mesh-aware serving tier)
        return exec_cache.run_sweep(a, cfg, solver_cfg, init_cfg, mesh,
                                    profiler=profiler, on_rank=on_rank)
    eligible = grid_exec_ok(solver_cfg, mesh)
    if cfg.grid_exec == "grid" and not eligible:
        raise ValueError(
            "grid_exec='grid' needs an algorithm/backend pair that routes "
            "into the slot scheduler — mu or hals with backend 'auto', "
            "'packed' or 'pallas', or neals, als, snmf or kl with "
            f"'packed'; got algorithm={solver_cfg.algorithm!r}, "
            f"backend={solver_cfg.backend!r} (use grid_exec='auto' to "
            "fall back per configuration)")
    check_ported(solver_cfg)
    dev = resolve_device(device) if mesh is None else mesh_home(mesh)
    out: dict[int, KSweepOutput] = {}
    needed: list[int] = []
    # several processes must take the same solve-or-load branch for
    # each rank, or the shards' gathers would not meet: the coordinator
    # (the one process expected to hold a registry) decides, and a loaded
    # rank travels to the others
    multi = (mesh is not None and mesh.processes is not None
             and process_count() > 1)
    for k in cfg.ks:
        loaded = registry.try_load(k) if registry is not None else None
        if multi:
            import torch.distributed as dist

            box = [_to_host(loaded) if _process_index() == 0 else None]
            dist.broadcast_object_list(box, src=0)
            loaded = box[0]
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

    shape = None
    if mesh is None:
        a_dev = a_in = place_resilient(a, solver_cfg, dev, profiler=profiler)
    elif grid_axes:
        # tiled over the grid axes: no device holds A whole
        a_in = _place_grid_blocks(a, solver_cfg, mesh, profiler)
        a_dev, shape = None, a_in.shape
    else:
        # replicated to each distinct device of the mesh, each copy
        # through the input cache
        a_in = {d: place_resilient(a, solver_cfg, d, profiler=profiler)
                for d in mesh.distinct_devices()}
        a_dev = a_in[dev]
        if solver_cfg.backend == "sketched" or solver_cfg.screen:
            a_in, mesh = a_dev, None  # a restart mesh is ignored here
    root = _random.key(cfg.seed)
    if use_grid:
        fn = _build_grid_exec_sweep_fn(
            tuple(needed), cfg.restarts, solver_cfg, init_cfg,
            cfg.label_rule, cfg.keep_factors, cfg.grid_slots,
            cfg.grid_tail_slots, mesh=mesh)
        t0 = time.perf_counter()
        with profiler.phase("solve.grid") as sync:
            solved = sync(fn(a_in, root))
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
                            time.perf_counter() - t0, profiler, mesh=mesh)
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
            res = sync(sweep_one_k(a_in, _random.fold_in(root, k), k,
                                   cfg.restarts, solver_cfg, init_cfg,
                                   cfg.label_rule, mesh, cfg.keep_factors,
                                   cfg.grid_slots, cfg.grid_tail_slots))
        with profiler.phase("xfer.overlap"):
            # rank k's results stream to the host while rank k+1 solves
            out[k] = res._replace(fetch=start_host_fetch(res))
        if on_rank is not None:
            on_rank(k, out[k])
        _attribute_dispatch("sweep.k", solver_cfg, a_dev, {k: out[k]},
                            time.perf_counter() - t0, profiler, mesh=mesh,
                            shape=shape, device=dev)
        if registry is not None:
            with profiler.phase("checkpoint"):
                registry.save(k, out[k])
    return {k: out[k] for k in cfg.ks}


def _sweep_tiled(a, plan, cfg: ConsensusConfig, solver_cfg: SolverConfig,
                 init_cfg: InitConfig, *, device=None, registry=None,
                 profiler=None, on_rank=None,
                 checkpoint=None) -> dict[int, KSweepOutput]:
    """The out-of-core arm of :func:`sweep` (the reference's
    ``_sweep_tiled``): ranks one after another through the streamed
    engine (``nmfx_torch/tiles.py``), with the canonical per-rank key
    ``fold_in(key(seed), k)``, each rank's host copies started at its
    ``on_rank`` site as on the per-rank route. A stays on the host (the
    stream owns every transfer), so the input cache, the whole grid and
    the executable cache do not apply. The legacy registry and
    ``grid_exec="grid"`` are refused; ``checkpoint`` runs the durable
    ledger, with partials at every check."""
    from nmfx_torch import tiles as _tiles
    from nmfx_torch.sparse import SparseMatrix

    if registry is not None:
        raise ValueError(
            "out-of-core sweeps checkpoint mid-matrix through the "
            "durable chunk ledger (pass checkpoint=CheckpointConfig()); "
            "the legacy per-rank registry has no partial-pass records")
    if cfg.grid_exec == "grid":
        raise ValueError(
            "grid_exec='grid' is the in-core whole-grid solve; "
            "tiled/sparse sweeps run the streaming engine per rank "
            "(use grid_exec='auto')")
    check_ported(solver_cfg)
    if checkpoint is not None:
        from nmfx_torch.checkpoint import run_checkpointed_sweep

        return run_checkpointed_sweep(a, cfg, solver_cfg, init_cfg,
                                      checkpoint, device=device,
                                      profiler=profiler, on_rank=on_rank)
    costmodel.set_sparse_density(
        a.density if isinstance(a, SparseMatrix) else 1.0)
    dev = resolve_device(device)
    # the cost model's family is the engine's, "tiled", also for a
    # sparse input without tile_rows (one whole-matrix tile)
    model_cfg = dataclasses.replace(solver_cfg, tile_rows=plan.tile_rows)
    root = _random.key(cfg.seed)
    out: dict[int, KSweepOutput] = {}
    for k in cfg.ks:
        t0 = time.perf_counter()
        with profiler.phase(f"solve.k={k}") as sync:
            res = sync(_tiles.sweep_one_k_tiled(
                a, _random.fold_in(root, k), k, cfg.restarts, solver_cfg,
                init_cfg, cfg.label_rule, cfg.keep_factors, profiler,
                faults.poison_restarts(k, cfg.restarts), plan=plan,
                device=dev))
        with profiler.phase("xfer.overlap"):
            out[k] = res._replace(fetch=start_host_fetch(res))
        if on_rank is not None:
            on_rank(k, out[k])
        _attribute_dispatch("sweep.k", model_cfg, None, {k: out[k]},
                            time.perf_counter() - t0, profiler,
                            shape=(plan.m, plan.n), device=dev)
    return {k: out[k] for k in cfg.ks}


def _attribute_dispatch(kind: str, solver_cfg: SolverConfig,
                        a_dev: torch.Tensor, outs: dict, wall_s: float,
                        profiler, shape: "tuple | None" = None,
                        device=None, mesh=None) -> None:
    """Per-dispatch roofline attribution (``nmfx_torch.obs.costmodel``):
    annotate a just-measured solve dispatch with its model FLOPs/bytes
    against the peak of A's device. Only under a real ``Profiler``,
    whose phase already synchronized the card, so the wall is honest;
    the iteration counts come through the host copies the sweep already
    started. A ``NullProfiler`` run attributes nothing and gains no
    read. ``shape`` overrides A's (the true shape of a bucket-padded
    matrix). A ``mesh``'s peak counts its distinct devices, so two
    shards on one card are priced as that one card."""
    if (isinstance(profiler, NullProfiler)
            or not costmodel.attribution_enabled() or not outs):
        return
    iters = {k: fetch_host(v).iterations for k, v in outs.items()}
    m, n = a_dev.shape if shape is None else shape
    costmodel.attribute_dispatch(kind, solver_cfg, m, n, iters, wall_s,
                                 device=a_dev.device if a_dev is not None
                                 else device, mesh=mesh)


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
