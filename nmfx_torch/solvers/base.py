"""Solver vocabulary shared by the port's engines (counterpart of the
parts of ``nmfx/solvers/base.py`` the packed mu route reads)."""

from __future__ import annotations

import enum

import torch


class StopReason(enum.IntEnum):
    """Why a restart stopped; the integer values are the reference's, so
    saved results and stop-reason arrays compare across packages."""

    MAX_ITER = 0
    #: per-column argmax of H unchanged for `stable_checks` checks
    CLASS_STABLE = 1
    #: max-change of W and H below TolX
    TOL_X = 2
    #: relative residual decrease below TolFun
    TOL_FUN = 3
    #: projected-gradient norm below tol (pg/alspg)
    PG_TOL = 4
    #: numeric quarantine: the lane's factors went non-finite and it is
    #: masked out of the consensus like a pad lane
    NUMERIC_FAULT = 5
    #: restart screening cut the lane before its exact phase
    SCREENED = 6


def clamp(x: torch.Tensor, zero_threshold: float) -> torch.Tensor:
    """Zero out negatives and sub-threshold values (reference
    ZERO_THRESHOLD clamp)."""
    return torch.where(x <= zero_threshold, torch.zeros_like(x), x)
