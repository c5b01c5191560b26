"""Typed configuration for the port: the fields of the reference's
``SolverConfig`` / ``InitConfig`` / ``ConsensusConfig`` that the per-rank
packed mu route reads, with the reference's defaults and validation
(``nmfx/config.py``). Fields of engines the port does not have yet are
left out; ``nmfx_torch.convert.solver_config_from_dict`` refuses a
reference configuration that sets one of them to a non-inert value.

What the port runs is narrower than what validates: ``check_ported``
raises ``NotImplementedError`` for a solver setting the port has no
route for yet, and ``nmfx_torch.sweep`` does the same for ``grid_exec``
other than "per_k"; each message names the ROADMAP item that brings it.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

ALGORITHMS = ("mu", "als", "neals", "pg", "alspg", "kl", "snmf", "hals")
INIT_METHODS = ("random", "nndsvd")
LINKAGE_METHODS = ("average", "complete", "single")
#: backends with a route in the port (both run nmfx_torch.ops.packed_mu:
#: "pallas" through the hand-written kernels, "packed" through plain GEMMs)
PORTED_BACKENDS = ("pallas", "packed")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Per-factorization solver settings (reference ``nmfx.SolverConfig``).

    ``matmul_precision``: "default" and "highest" both mean full float32
    products on the card (TF32 is switched off by the entry points);
    "bfloat16" operands are not ported yet.
    """

    algorithm: str = "mu"
    max_iter: int = 10000
    tol_x: float = 1e-4
    tol_fun: float = 1e-4
    check_every: int = 2
    #: check blocks per host-loop trip; "auto" resolves to 1 (the host
    #: reads the done flags once per trip)
    check_block: "int | str" = "auto"
    stable_checks: int = 200
    use_class_stop: bool = True
    class_flip_tol: float = 0.02
    use_tol_checks: bool = True
    zero_threshold: float = 0.0
    div_eps: float = 1e-9
    dtype: str = "float32"
    matmul_precision: str = "default"
    backend: str = "auto"
    nonfinite_guard: bool = True

    def __post_init__(self):
        if self.backend not in ("auto", "vmap", "packed", "pallas",
                                "sketched"):
            raise ValueError(
                f"backend must be 'auto', 'vmap', 'packed', 'pallas' or "
                f"'sketched', got {self.backend!r}")
        if self.backend == "pallas" and self.algorithm not in ("mu",
                                                               "hals"):
            raise ValueError(
                "backend='pallas' is only implemented for algorithm='mu' "
                "and 'hals'; use 'auto' to fall back per algorithm")
        if self.algorithm not in ALGORITHMS:
            raise ValueError(
                f"algorithm must be one of {ALGORITHMS}, got "
                f"{self.algorithm!r}")
        if self.max_iter < 1:
            raise ValueError("max_iter must be >= 1")
        if self.check_every < 1:
            raise ValueError("check_every must be >= 1")
        cb = self.check_block
        if not (cb == "auto" or (isinstance(cb, int)
                                 and not isinstance(cb, bool) and cb >= 1)):
            raise ValueError(
                f"check_block must be 'auto' or an int >= 1, got {cb!r}")
        if self.matmul_precision not in ("default", "bfloat16", "highest"):
            raise ValueError(
                "matmul_precision must be 'default', 'bfloat16' or "
                f"'highest', got {self.matmul_precision!r}")
        if not 0.0 <= self.class_flip_tol < 1.0:
            raise ValueError(
                f"class_flip_tol must be in [0, 1), got {self.class_flip_tol}")


def check_ported(cfg: SolverConfig) -> None:
    """Raise ``NotImplementedError`` for a valid setting the port cannot
    run yet (ROADMAP "Open items")."""
    if cfg.algorithm != "mu":
        raise NotImplementedError(
            f"algorithm={cfg.algorithm!r} is not ported yet (ROADMAP "
            "'Modules to port' item 8); the port runs 'mu'")
    if cfg.backend not in PORTED_BACKENDS:
        raise NotImplementedError(
            f"backend={cfg.backend!r} is not ported yet: the default "
            "whole-grid route is ROADMAP 'Modules to port' item 7 and the "
            "vmapped/sketched engines items 4, 8 and 12; pass "
            "backend='pallas' (the hand-written kernels) or 'packed'")
    if cfg.matmul_precision == "bfloat16":
        raise NotImplementedError(
            "matmul_precision='bfloat16' (bf16 operands, f32 accumulation) "
            "is not ported yet (ROADMAP 'TPU kernels to port' item 1)")
    if cfg.dtype != "float32":
        raise NotImplementedError(
            f"dtype={cfg.dtype!r} is not ported yet; the kernels are "
            "float32 (ROADMAP 'Modules to port' item 4)")


@dataclasses.dataclass(frozen=True)
class InitConfig:
    """W0/H0 initialization (reference ``nmfx.InitConfig``; the port has
    the dense SVD only)."""

    method: str = "random"
    minval: float = 0.0
    maxval: float = 1.0
    svd_method: str = "dense"

    def __post_init__(self):
        if self.method not in INIT_METHODS:
            raise ValueError(
                f"init method must be one of {INIT_METHODS}, got "
                f"{self.method!r}")
        if self.svd_method != "dense":
            raise NotImplementedError(
                "svd_method='lanczos' is not ported yet (ROADMAP "
                "'Modules to port' item 12); use 'dense'")


@dataclasses.dataclass(frozen=True)
class ConsensusConfig:
    """Consensus sweep settings (reference ``nmfx.ConsensusConfig``)."""

    ks: Sequence[int] = (2, 3, 4, 5)
    restarts: int = 10
    seed: int = 123
    label_rule: str = "argmax"
    linkage: str = "average"
    keep_factors: bool = False
    grid_exec: str = "auto"
    min_restarts: int = 1

    def __post_init__(self):
        ks = tuple(dict.fromkeys(int(k) for k in self.ks))
        object.__setattr__(self, "ks", ks)
        if any(k < 2 for k in ks):
            raise ValueError("all k must be >= 2")
        if self.restarts < 1:
            raise ValueError("restarts must be >= 1")
        if not 1 <= self.min_restarts <= self.restarts:
            raise ValueError(
                f"min_restarts must be in [1, restarts={self.restarts}], "
                f"got {self.min_restarts}")
        if self.label_rule not in ("argmax", "argmin"):
            raise ValueError("label_rule must be 'argmax' or 'argmin'")
        if self.grid_exec not in ("auto", "grid", "per_k"):
            raise ValueError(
                f"grid_exec must be 'auto', 'grid' or 'per_k', got "
                f"{self.grid_exec!r}")
        if self.linkage not in LINKAGE_METHODS:
            raise ValueError(
                f"linkage must be one of {LINKAGE_METHODS}, got "
                f"{self.linkage!r}")


@dataclasses.dataclass(frozen=True)
class OutputConfig:
    """File outputs (reference ``nmfx.OutputConfig``; plots not ported)."""

    directory: str = "./nmfx_out"
    doc_string: str = ""
    write_gcts: bool = True
