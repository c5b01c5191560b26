"""The (k × restart) sweep (counterpart of the unmeshed routes of
``nmfx/sweep.py``).

Every restart of rank k starts from the reference's key chain
``split(fold_in(key(seed), k), R)``. Two routes, chosen as the reference
chooses them:

* whole grid (``grid_exec="auto"`` with more than one rank, or
  ``"grid"``): every (k, restart) job goes through one slot-scheduled
  solve (``nmfx_torch.ops.sched_mu``), dispatched rank-descending;
* per rank (``"per_k"``, or a single rank): ranks one after another.
  mu solves each rank's restarts as one restart-packed batch
  (``nmfx_torch.ops.packed_mu``); hals runs the slot scheduler at that
  one rank, whose key arrives already folded, so its restarts start from
  the same factors as on the whole grid.

Either way each rank's batch reduces to a consensus matrix on the
device. At each rank's ``on_rank`` site the sweep starts the rank's
device→host copies (``harvest.start_host_fetch``, carried in the output's
``fetch`` field), so they stream while later ranks solve. Meshes, the
registry and the executable cache are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nmfx_torch import random as _random
from nmfx_torch.config import (ConsensusConfig, InitConfig, SolverConfig,
                               check_ported)
from nmfx_torch.consensus import labels_from_h, one_hot
from nmfx_torch.device import resolve_device
from nmfx_torch.harvest import start_host_fetch
from nmfx_torch.init import restart_inits
from nmfx_torch.ops.packed_mu import mu_packed, unpack_w
from nmfx_torch.ops.sched_mu import mu_sched
from nmfx_torch.profiling import NullProfiler
from nmfx_torch.solvers.base import StopReason

#: backends that route each algorithm into the slot scheduler; hals runs
#: nowhere else (its per-rank route is the scheduler at one rank)
_GRID_EXEC_BACKENDS = {"mu": ("auto", "packed", "pallas"),
                       "hals": ("auto", "packed", "pallas")}


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
    #: device→host reads of the solve's loop state (mu_packed, or the
    #: whole grid's mu_sched, whose count every rank carries)
    host_syncs: int = 0
    #: the whole grid's pool diagnostics (``SchedMUResult.pool_*``),
    #: carried by every rank; empty on the per-rank route
    pool_widths: tuple = ()
    pool_trips: tuple = ()
    pool_lanes: tuple = ()
    #: the rank's device→host copies, started at its on_rank site
    #: (``harvest.HostFetch``); None until the sweep starts them
    fetch: "object | None" = None


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

    def impl(a: torch.Tensor, key: np.ndarray) -> KSweepOutput:
        keys = _random.split(key, restarts)
        w0s, h0s = restart_inits(a, keys, k, init_cfg)
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


def sweep_one_k(a: torch.Tensor, key: np.ndarray, k: int, restarts: int,
                solver_cfg: SolverConfig = SolverConfig(),
                init_cfg: InitConfig = InitConfig(),
                label_rule: str = "argmax",
                keep_factors: bool = False, slots: int = 48,
                tail_slots="auto") -> KSweepOutput:
    """Run ``restarts`` factorizations at rank k on A's device (``key``
    is the rank's folded key) and reduce them to one consensus matrix
    there: mu as one packed batch, hals through the slot scheduler at
    this one rank (``slots`` wide, with the ``tail_slots`` cascade)."""
    if solver_cfg.algorithm != "mu":
        fn = _build_grid_exec_sweep_fn((k,), restarts, solver_cfg, init_cfg,
                                       label_rule, keep_factors, slots,
                                       tail_slots, fold_keys=False)
        return fn(a, key)[k]
    fn = _build_packed_sweep_fn(k, restarts, solver_cfg, init_cfg,
                                label_rule, keep_factors)
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

    def impl(a: torch.Tensor, root_key: np.ndarray
             ) -> dict[int, KSweepOutput]:
        w0l, h0l = [], []
        for k in ks:
            keys = _random.split(_random.fold_in(root_key, k) if fold_keys
                                 else root_key, restarts)
            w0s, h0s = restart_inits(a, keys, k, init_cfg)
            w0l.append(torch.nn.functional.pad(w0s, (0, k_max - k)))
            h0l.append(torch.nn.functional.pad(h0s, (0, 0, 0, k_max - k)))
        res = mu_sched(a, torch.cat(w0l), torch.cat(h0l), solver_cfg,
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
          on_rank=None, profiler=None) -> dict[int, KSweepOutput]:
    """The (k × restart) grid: one slot-scheduled solve of every rank, or
    one rank at a time (see the module docstring for the routing).

    ``device``: None means CUDA (raising if there is none; TF32 off).
    A moves to the device once. ``on_rank(k, out)`` runs after each rank
    (after the whole solve on the grid route), once the rank's host copies
    are started (``out.fetch``); its outputs are device tensors.
    ``profiler`` (``nmfx_torch.profiling.Profiler``) times the phases
    ``solve.grid`` or ``solve.k={k}`` and ``xfer.overlap`` (starting the
    copies).
    """
    if profiler is None:
        profiler = NullProfiler()
    eligible = grid_exec_ok(solver_cfg)
    if cfg.grid_exec == "grid" and not eligible:
        raise ValueError(
            "grid_exec='grid' needs an algorithm/backend pair that routes "
            "into the slot scheduler — mu or hals with backend 'auto', "
            f"'packed' or 'pallas'; got algorithm={solver_cfg.algorithm!r}, "
            f"backend={solver_cfg.backend!r} (use grid_exec='auto' to "
            "fall back per configuration)")
    check_ported(solver_cfg)
    use_grid = eligible and (cfg.grid_exec == "grid"
                             or (cfg.grid_exec == "auto" and len(cfg.ks) > 1))
    dev = resolve_device(device)
    a_dev = torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)
    root = _random.key(cfg.seed)
    if use_grid:
        fn = _build_grid_exec_sweep_fn(
            cfg.ks, cfg.restarts, solver_cfg, init_cfg, cfg.label_rule,
            cfg.keep_factors, cfg.grid_slots, cfg.grid_tail_slots)
        with profiler.phase("solve.grid") as sync:
            solved = sync(fn(a_dev, root))
        with profiler.phase("xfer.overlap"):
            # one executable produced every rank, but each rank's copies
            # land (and harvest) independently
            solved = {k: v._replace(fetch=start_host_fetch(v))
                      for k, v in solved.items()}
        for k in cfg.ks:
            if on_rank is not None:
                on_rank(k, solved[k])
        return {k: solved[k] for k in cfg.ks}
    out: dict[int, KSweepOutput] = {}
    for k in cfg.ks:
        # fold in k itself, so a given (seed, k) always yields the same
        # factorizations whatever the sweep's composition
        with profiler.phase(f"solve.k={k}") as sync:
            res = sync(sweep_one_k(a_dev, _random.fold_in(root, k), k,
                                   cfg.restarts, solver_cfg, init_cfg,
                                   cfg.label_rule, cfg.keep_factors,
                                   cfg.grid_slots, cfg.grid_tail_slots))
        with profiler.phase("xfer.overlap"):
            # rank k's results stream to the host while rank k+1 solves
            out[k] = res._replace(fetch=start_host_fetch(res))
        if on_rank is not None:
            on_rank(k, out[k])
    return out
