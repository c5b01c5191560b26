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
float32). Meshes are not ported yet.

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
import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from nmfx_torch import faults
from nmfx_torch import random as _random
from nmfx_torch.config import (ROADMAP_SCALE, ConsensusConfig, InitConfig,
                               SolverConfig, check_ported)
from nmfx_torch.consensus import labels_from_h, one_hot
from nmfx_torch.device import explicit_device, resolve_device
from nmfx_torch.harvest import fetch_host, start_host_fetch
from nmfx_torch.init import random_init, restart_inits
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
    "tiled" (the out-of-core tile pipeline: ``tile_rows`` is set; a
    one-tile config that ``sweep`` hands to the in-core path says
    "tiled" here too, which only splits identities of equal programs),
    "pallas" (the hand-written kernels), "packed" (mu's packed solve or
    the dense slot scheduler) or "vmap" (the batched restart route).
    Families sum products in other orders, so a registry never crosses
    them."""
    if solver_cfg.tile_rows is not None:
        return "tiled"
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
    geometry). A mesh raises."""
    _refuse_mesh(mesh)
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


def _refuse_mesh(mesh) -> None:
    """The meshed route is not ported: only ``mesh=None`` runs."""
    if mesh is not None:
        raise NotImplementedError(
            f"meshes are not ported yet ({ROADMAP_SCALE}: item 10c, the "
            "meshed routes); pass mesh=None")


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
    order; ``mesh`` must be None. ``tile_rows`` is refused: ``sweep``
    routes it."""
    _refuse_mesh(mesh)
    if solver_cfg.tile_rows is not None:
        # sweep() owns the out-of-core routing (one-tile delegation
        # included), because it runs before A is placed on the device
        raise ValueError(
            "tile_rows is routed by sweep() (which delegates one-tile "
            "dense configs to this in-core path and streams the rest "
            "through nmfx_torch.tiles); call sweep(), or "
            "nmfx_torch.tiles.sweep_one_k_tiled for the streaming engine "
            "directly")
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
    it there (``_GRID_EXEC_BACKENDS``), with A on the device (not under
    ``tile_rows``; the executable cache's serving contract reads this
    too)."""
    if solver_cfg.tile_rows is not None:
        return False
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

    Out-of-core routing comes first: with ``solver_cfg.tile_rows`` set
    or a ``nmfx_torch.sparse.SparseMatrix`` input, a dense plan of one
    tile runs on with ``tile_rows`` stripped (byte-equal to the dense
    sweep, under the dense identity in every key downstream); a
    multi-tile plan and every sparse input run the streamed engine
    (:func:`_sweep_tiled`).
    """
    if profiler is None:
        profiler = NullProfiler()
    from nmfx_torch.sparse import SparseMatrix

    sparse_input = isinstance(a, SparseMatrix)
    if solver_cfg.tile_rows is not None or sparse_input:
        from nmfx_torch import tiles as _tiles

        plan = _tiles.plan_for(a, solver_cfg)
        if plan.n_tiles == 1 and not sparse_input:
            solver_cfg = dataclasses.replace(solver_cfg, tile_rows=None)
        else:
            return _sweep_tiled(a, plan, cfg, solver_cfg, init_cfg,
                                device=device, registry=registry,
                                profiler=profiler, on_rank=on_rank,
                                checkpoint=checkpoint)
    if checkpoint is not None:
        if registry is not None:
            raise ValueError(
                "pass either checkpoint (the durable chunked ledger) or "
                "registry (the legacy per-rank SweepRegistry), not both")
        from nmfx_torch.checkpoint import run_checkpointed_sweep

        return run_checkpointed_sweep(a, cfg, solver_cfg, init_cfg,
                                      checkpoint, device=device,
                                      profiler=profiler, on_rank=on_rank)
    if (exec_cache is not None and registry is None
            and exec_cache.cacheable(cfg, solver_cfg)):
        if explicit_device(resolve_device(device)) != exec_cache.device:
            raise ValueError(
                f"the sweep's device ({resolve_device(device)}) is not the "
                f"executable cache's ({exec_cache.device})")
        return exec_cache.run_sweep(a, cfg, solver_cfg, init_cfg,
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
                        device=None) -> None:
    """Per-dispatch roofline attribution (``nmfx_torch.obs.costmodel``):
    annotate a just-measured solve dispatch with its model FLOPs/bytes
    against the peak of A's device. Only under a real ``Profiler``,
    whose phase already synchronized the card, so the wall is honest;
    the iteration counts come through the host copies the sweep already
    started. A ``NullProfiler`` run attributes nothing and gains no
    read. ``shape`` overrides A's (the true shape of a bucket-padded
    matrix)."""
    if (isinstance(profiler, NullProfiler)
            or not costmodel.attribution_enabled() or not outs):
        return
    iters = {k: fetch_host(v).iterations for k, v in outs.items()}
    m, n = a_dev.shape if shape is None else shape
    costmodel.attribute_dispatch(kind, solver_cfg, m, n, iters, wall_s,
                                 device=a_dev.device if device is None
                                 else device)


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
