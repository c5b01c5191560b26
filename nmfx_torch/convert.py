"""Carry state across from the reference package.

NMF has no weights: what crosses is the configuration and the initial
factors. Both come in as plain Python/numpy values, so the port imports
nothing of the reference package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nmfx_torch.config import (ROADMAP_SCALE, CheckpointConfig,
                               ConsensusConfig, ExperimentalConfig,
                               InitConfig, SolverConfig)

#: reference SolverConfig fields the port has no counterpart for, with
#: the value under which each is inert on the port's routes (None =
#: inert at any value: it configures an engine these routes never run)
_INERT = {"sketch": None, "screen": False, "screen_keep": None}


def _own_fields(cls, d: dict, inert: dict) -> dict:
    own = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - own - set(inert)
    if unknown:
        raise ValueError(f"unknown {cls.__name__} fields: {sorted(unknown)}")
    return {k: v for k, v in d.items() if k in own}


def solver_config_from_dict(d: dict) -> SolverConfig:
    """The port's SolverConfig from ``dataclasses.asdict`` of a reference
    ``SolverConfig``, its nested ``experimental`` dict included. Raises
    ``NotImplementedError`` when the dict turns on something the port has
    not got (screening, an unported experimental knob)
    and ``ValueError`` on an unknown field."""
    kw = _own_fields(SolverConfig, d, _INERT)
    for name, inert in _INERT.items():
        if inert is not None and d.get(name, inert) != inert:
            raise NotImplementedError(
                f"SolverConfig.{name}={d[name]!r} has no counterpart in "
                f"the port yet ({ROADMAP_SCALE})")
    exp = kw.get("experimental")
    if isinstance(exp, dict):
        kw["experimental"] = ExperimentalConfig(
            **_own_fields(ExperimentalConfig, exp, {}))
    return SolverConfig(**kw)


def consensus_config_from_dict(d: dict) -> ConsensusConfig:
    """The port's ConsensusConfig from ``dataclasses.asdict`` of a
    reference ``ConsensusConfig`` (every field has a counterpart);
    ``ValueError`` on an unknown field."""
    kw = _own_fields(ConsensusConfig, d, {})
    if isinstance(kw.get("grid_tail_slots"), list):
        kw["grid_tail_slots"] = tuple(kw["grid_tail_slots"])
    return ConsensusConfig(**kw)


#: reference InitConfig fields the port has not got, inert at any value
#: (``ncv`` sizes the Lanczos SVD, which the port refuses)
_INIT_INERT = {"ncv": None}


def init_config_from_dict(d: dict) -> InitConfig:
    """The port's InitConfig from ``dataclasses.asdict`` of a reference
    ``InitConfig``; ``ValueError`` on an unknown field."""
    return InitConfig(**_own_fields(InitConfig, d, _INIT_INERT))


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
