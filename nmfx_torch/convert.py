"""Carry state across from the reference package.

NMF has no weights: what crosses is the configuration and the initial
factors. Both come in as plain Python/numpy values, so the port imports
nothing of the reference package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nmfx_torch.config import (CheckpointConfig, ConsensusConfig,
                               ExperimentalConfig, InitConfig, SketchConfig,
                               SolverConfig)


def _own_fields(cls, d: dict, inert: dict) -> dict:
    own = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - own - set(inert)
    if unknown:
        raise ValueError(f"unknown {cls.__name__} fields: {sorted(unknown)}")
    return {k: v for k, v in d.items() if k in own}


def solver_config_from_dict(d: dict) -> SolverConfig:
    """The port's SolverConfig from ``dataclasses.asdict`` of a reference
    ``SolverConfig``, its nested ``experimental`` and ``sketch`` dicts
    included (a dict without ``sketch``, as older records are, takes the
    default). Raises ``NotImplementedError`` when the dict turns on an
    experimental knob the port has not got, and ``ValueError`` on an
    unknown field."""
    kw = _own_fields(SolverConfig, d, {})
    exp = kw.get("experimental")
    if isinstance(exp, dict):
        kw["experimental"] = ExperimentalConfig(
            **_own_fields(ExperimentalConfig, exp, {}))
    sk = kw.get("sketch")
    if isinstance(sk, dict):
        kw["sketch"] = SketchConfig(**_own_fields(SketchConfig, sk, {}))
    return SolverConfig(**kw)


def consensus_config_from_dict(d: dict) -> ConsensusConfig:
    """The port's ConsensusConfig from ``dataclasses.asdict`` of a
    reference ``ConsensusConfig`` (every field has a counterpart);
    ``ValueError`` on an unknown field."""
    kw = _own_fields(ConsensusConfig, d, {})
    if isinstance(kw.get("grid_tail_slots"), list):
        kw["grid_tail_slots"] = tuple(kw["grid_tail_slots"])
    return ConsensusConfig(**kw)


def init_config_from_dict(d: dict) -> InitConfig:
    """The port's InitConfig from ``dataclasses.asdict`` of a reference
    ``InitConfig``; ``ValueError`` on an unknown field."""
    return InitConfig(**_own_fields(InitConfig, d, {}))


def checkpoint_config_from_dict(d: dict) -> CheckpointConfig:
    """The port's CheckpointConfig from ``dataclasses.asdict`` of a
    reference ``CheckpointConfig`` (every field has a counterpart);
    ``ValueError`` on an unknown field."""
    return CheckpointConfig(**_own_fields(CheckpointConfig, d, {}))


def factors_from_numpy(w0s: np.ndarray, h0s: np.ndarray, device
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, m, k) / (R, k, n) initial factors as float32 tensors on
    ``device``, ready for ``nmfx_torch.ops.packed_mu.mu_packed``."""
    w0s, h0s = np.asarray(w0s), np.asarray(h0s)
    if w0s.ndim != 3 or h0s.ndim != 3 or w0s.shape[0] != h0s.shape[0] \
            or w0s.shape[2] != h0s.shape[1]:
        raise ValueError(
            f"expected (R, m, k) / (R, k, n) factors, got {w0s.shape} / "
            f"{h0s.shape}")
    return (torch.as_tensor(w0s, dtype=torch.float32, device=device),
            torch.as_tensor(h0s, dtype=torch.float32, device=device))
