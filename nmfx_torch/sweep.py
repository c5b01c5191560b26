"""Per-rank restart sweep (counterpart of the unmeshed per-rank route of
``nmfx/sweep.py``).

For each rank k the sweep draws R initial factor pairs from the
reference's key chain ``split(fold_in(key(seed), k), R)``, solves them as
one restart-packed batch (``nmfx_torch.ops.packed_mu``), and reduces the
batch to a consensus matrix on the device. Ranks run one after another.
The whole-grid slot scheduler (the reference's default route), meshes,
the registry and the executable cache are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nmfx_torch import random as _random
from nmfx_torch.config import ConsensusConfig, InitConfig, SolverConfig
from nmfx_torch.consensus import labels_from_h, one_hot
from nmfx_torch.device import resolve_device
from nmfx_torch.init import restart_inits
from nmfx_torch.ops.packed_mu import mu_packed, unpack_w
from nmfx_torch.solvers.base import StopReason


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
    #: device→host reads of the solve's done flags (mu_packed)
    host_syncs: int = 0


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
                keep_factors: bool = False) -> KSweepOutput:
    """Run ``restarts`` factorizations at rank k on A's device and reduce
    them to one consensus matrix there."""
    fn = _build_packed_sweep_fn(k, restarts, solver_cfg, init_cfg,
                                label_rule, keep_factors)
    return fn(a, key)


def sweep(a, cfg: ConsensusConfig = ConsensusConfig(),
          solver_cfg: SolverConfig = SolverConfig(),
          init_cfg: InitConfig = InitConfig(), *, device=None,
          on_rank=None) -> dict[int, KSweepOutput]:
    """The (k × restart) grid, one rank at a time.

    ``device``: None means CUDA (raising if there is none; TF32 off).
    A moves to the device once. ``on_rank(k, out)`` runs after each rank
    (its outputs are device tensors, complete up to the last host read).
    """
    if cfg.grid_exec != "per_k":
        raise NotImplementedError(
            f"grid_exec={cfg.grid_exec!r} is not ported yet: the "
            "whole-grid slot scheduler is ROADMAP 'Modules to port' item "
            "7; pass grid_exec='per_k'")
    dev = resolve_device(device)
    a_dev = torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)
    root = _random.key(cfg.seed)
    out: dict[int, KSweepOutput] = {}
    for k in cfg.ks:
        # fold in k itself, so a given (seed, k) always yields the same
        # factorizations whatever the sweep's composition
        out[k] = sweep_one_k(a_dev, _random.fold_in(root, k), k,
                             cfg.restarts, solver_cfg, init_cfg,
                             cfg.label_rule, cfg.keep_factors)
        if on_rank is not None:
            on_rank(k, out[k])
    return out
