"""Typed configuration for the port: the fields of the reference's
``SolverConfig`` / ``ExperimentalConfig`` / ``InitConfig`` /
``ConsensusConfig`` that the port's routes read, with the reference's
defaults and validation (``nmfx/config.py``), ``SketchConfig`` and the
screening fields included. ``SolverConfig.tile_rows`` is the
reference's: a set value routes mu and hals through the out-of-core tile
pipeline (``nmfx_torch/tiles.py``), which streams A from the host to the
card block by block.

``check_ported`` validates the solve dtype; every valid solver setting
has a route (float64 under ``backend="pallas"`` runs the float32
kernels on float32 pools with float64 bookkeeping, as the reference's
kernels compute it). The scheduler's own preconditions on the options
it runs (ragged, factor_dtype, alias_io, block_m) raise ``ValueError``
in ``nmfx_torch.ops.sched_mu.mu_sched``, with the reference's words.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Sequence

ALGORITHMS = ("mu", "als", "neals", "pg", "alspg", "kl", "snmf", "hals")
INIT_METHODS = ("random", "nndsvd")
LINKAGE_METHODS = ("average", "complete", "single")
#: algorithms with a dense-batched block (``ops.grid_mu.BLOCKS``), the
#: only ones ``backend="packed"`` accepts (reference ``PACKED_ALGORITHMS``)
PACKED_ALGORITHMS = ("mu", "hals", "neals", "als", "snmf", "kl")
#: algorithms with a Gram-accumulation form the out-of-core tile pipeline
#: (``nmfx_torch/tiles.py``) can stream: each tile's contribution reduces
#: into k×k / k×n Gram terms (reference ``TILED_ALGORITHMS``)
TILED_ALGORITHMS = ("mu", "hals")
#: algorithms with a compressed (sketched) update formulation:
#: backend="sketched" and SolverConfig.screen take only these (their
#: updates are Gram-family product chains the projections contract;
#: reference ``SKETCHED_ALGORITHMS``)
SKETCHED_ALGORITHMS = ("mu", "hals")

#: where the ROADMAP brings each refused setting ("Open items")
ROADMAP_WARM = "ROADMAP §1 item 6, warm path remnants"

#: the package version (the reference's; the command line's --version)
VERSION = "0.1.0"


@dataclasses.dataclass(frozen=True)
class ExperimentalConfig:
    """Measured-but-not-default opt-ins of the reference
    (``nmfx.ExperimentalConfig``), with its fields, defaults and
    validation. The port runs ``evict_batch`` (harvest hysteresis of the
    slot scheduler), ``fused_updates`` ("auto" and "phased": the phased
    mu block kernel; "fused": the join-the-updates one), ``ragged`` (the
    class-blocked slot pool, with ``ragged_iters_est``), ``factor_dtype``
    (bf16 pool factors), ``alias_io`` (the block kernels update the pool
    in place), ``block_m`` (the row tiling, which sets the padded row
    count) and ``autotune`` ("on": ``nmfx_torch.autotune`` times the
    kernel-schedule candidates at the sweep's shape bucket once and
    resolves ``block_m``, ``check_block`` and ``fused_updates`` before
    the sweep builds anything). ``kl_bf16_quotient`` (kl on the whole
    grid under ``matmul_precision="bfloat16"`` on CUDA: the quotient reads
    A rounded to bf16 too) configures kl only."""

    ragged: bool = False
    ragged_iters_est: "tuple[tuple[int, float], ...] | None" = None
    evict_batch: int = 1
    factor_dtype: "str | None" = None
    alias_io: bool = False
    kl_bf16_quotient: bool = False
    autotune: str = "off"
    block_m: "int | None" = None
    fused_updates: str = "auto"

    def __post_init__(self):
        if self.factor_dtype not in (None, "bfloat16", "bfloat16_w"):
            raise ValueError(
                "experimental.factor_dtype must be None, 'bfloat16' or "
                f"'bfloat16_w', got {self.factor_dtype!r}")
        if self.evict_batch < 1:
            raise ValueError("experimental.evict_batch must be >= 1")
        if self.autotune not in ("off", "on"):
            raise ValueError(
                "experimental.autotune must be 'off' or 'on', got "
                f"{self.autotune!r}")
        if self.block_m is not None and (
                self.block_m <= 0 or self.block_m % 16):
            raise ValueError(
                "experimental.block_m must be a positive multiple of 16, "
                f"got {self.block_m!r}")
        if self.fused_updates not in ("auto", "phased", "fused"):
            raise ValueError(
                "experimental.fused_updates must be 'auto', 'phased' or "
                f"'fused', got {self.fused_updates!r}")
        if self.ragged_iters_est is not None:
            est = tuple((int(k), float(v))
                        for k, v in self.ragged_iters_est)
            if any(v <= 0 for _, v in est):
                raise ValueError(
                    "experimental.ragged_iters_est iteration estimates "
                    "must be positive")
            object.__setattr__(self, "ragged_iters_est", est)


@dataclasses.dataclass(frozen=True)
class SketchConfig:
    """Random-projection compression of the solver updates (reference
    ``nmfx.SketchConfig``; ``nmfx_torch/solvers/sketched.py``), with its
    fields, defaults and validation.

    Both factors stay full size; per restart two Gaussian projections
    L (r × m) and R (n × r) are drawn from the restart's key, and the
    Gram-family terms of the mu/hals updates contract against L·A and
    A·R instead of A. Labels and the final residual come from the full
    factors, so the accuracy contract is statistical at the consensus
    level (``nmfx_torch.agreement``), never bit-exact. The same pass
    powers restart screening (``SolverConfig.screen``) and
    quality-elastic serving (``ServeConfig.quality_elastic``)."""

    #: sketch dimension r of both projections: "auto" is
    #: ``max(4k + 8, 40)`` per rank, an int pins it; either is clamped
    #: into [k + 1, min(m, n)] (``sketched.resolve_dim``)
    dim: "int | str" = "auto"
    #: Nesterov momentum on the factor iterates (updates evaluate at
    #: ``max(X + beta_t (X - X_prev), 0)`` with the standard t-sequence)
    momentum: bool = True
    #: compressed iterations of the screening pass (``screen``)
    screen_iters: int = 40
    #: exact update iterations after the compressed loop stops, before
    #: the labels and the residual are read
    polish_iters: int = 3

    def __post_init__(self):
        d = self.dim
        if not (d == "auto" or (isinstance(d, int)
                                and not isinstance(d, bool) and d >= 1)):
            raise ValueError(
                f"sketch.dim must be 'auto' or an int >= 1, got {d!r}")
        if self.screen_iters < 1:
            raise ValueError("sketch.screen_iters must be >= 1")
        if self.polish_iters < 0:
            raise ValueError("sketch.polish_iters must be >= 0")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Per-factorization solver settings (reference ``nmfx.SolverConfig``).

    ``matmul_precision``: "default" and "highest" both mean full float32
    products on the card (TF32 is switched off by the entry points, and
    the ``torch.linalg`` solves of als, neals and snmf follow it);
    "bfloat16" rounds every product operand of the hand-written kernels
    to bf16 (float32 sums) and runs where the solve reaches them,
    ``backend="pallas"``; elsewhere it is not ported yet.
    """

    #: the fields declared execution-strategy-only (the reference's
    #: declaration): the registry fingerprint, the checkpoint manifest
    #: and the result-cache key may leave out these and no other
    #: (the linter's NMFX001 / 007 / 011). ``restart_chunk``: chunked and
    #: unchunked sweeps are byte-equal
    NON_NUMERICS_FIELDS: ClassVar[tuple] = ("restart_chunk",)

    algorithm: str = "mu"
    max_iter: int = 10000
    tol_x: float = 1e-4
    tol_fun: float = 1e-4
    #: pg/alspg: stop when the projected-gradient norm falls below
    #: tol_pg times its initial value (Lin 2007)
    tol_pg: float = 1e-4
    check_every: int = 2
    #: check blocks per host-loop trip (the host reads the loop's state
    #: once per trip). "auto" resolves to 4 on the slot scheduler's
    #: block-kernel route (backend "pallas", max_iter a multiple of
    #: check_every: one kernel launch runs all 4 blocks) and to 1
    #: everywhere else, as in the reference
    check_block: "int | str" = "auto"
    stable_checks: int = 200
    use_class_stop: bool = True
    class_flip_tol: float = 0.02
    use_tol_checks: bool = True
    zero_threshold: float = 0.0
    div_eps: float = 1e-9
    #: pg/alspg line search: trials per inner search, the step's
    #: shrink/grow factor and the sufficient-decrease constant
    ls_max_steps: int = 20
    ls_beta: float = 0.1
    ls_sigma: float = 0.01
    #: pg/alspg: outer iterations of one NNLS subproblem
    sub_max_iter: int = 1000
    dtype: str = "float32"
    matmul_precision: str = "default"
    backend: str = "auto"
    #: the sketched engine's and the screening pass's knobs; inert on
    #: the exact engines
    sketch: SketchConfig = SketchConfig()
    #: restart screening: a cheap sketched pass (``sketch.screen_iters``
    #: compressed iterations) scores every restart of a rank, and only
    #: the ``screen_keep`` best receive exact iterations, on the batched
    #: restart route; the others stop ``StopReason.SCREENED`` and are
    #: masked from the consensus like pad lanes. mu and hals, backend
    #: "auto" or "vmap"
    screen: bool = False
    #: survivors of the screening pass per rank (required with
    #: ``screen=True``; at most the sweep's restart count, checked where
    #: that count is known)
    screen_keep: "int | None" = None
    experimental: ExperimentalConfig = ExperimentalConfig()
    #: snmf: the L1 weight on H's columns, and the ridge on W (None =
    #: max(A)², Kim & Park's choice)
    sparsity_beta: float = 0.01
    ridge_eta: "float | None" = None
    nonfinite_guard: bool = True
    #: the batched restart route: solve a rank's restarts in sequential
    #: chunks of this many (bounds kl's (chunk, m, n) quotients); None =
    #: all at once. Results do not depend on it
    restart_chunk: "int | None" = None
    #: the out-of-core tile pipeline (``nmfx_torch/tiles.py``): A stays on
    #: the host and streams to the device in feature-axis (row) blocks of
    #: at most this many rows while W, H and the restart pool stay
    #: resident. "auto" sizes the blocks to the tile budget
    #: (``tiles.tile_budget_bytes``). A dense plan of one tile runs the
    #: in-core engines unchanged (byte-equal); a multi-tile plan, and
    #: every sparse input, runs the streamed engine family "tiled". mu
    #: and hals only; random init only
    tile_rows: "int | str | None" = None

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
        if (self.backend == "sketched"
                and self.algorithm not in SKETCHED_ALGORITHMS):
            raise ValueError(
                "backend='sketched' is only implemented for the Gram-"
                f"family algorithms {SKETCHED_ALGORITHMS}; use 'auto' "
                "for an exact engine")
        if self.screen:
            if self.algorithm not in SKETCHED_ALGORITHMS:
                raise ValueError(
                    "screen=True needs a sketched screening pass, which "
                    f"only the algorithms {SKETCHED_ALGORITHMS} have")
            if self.backend not in ("auto", "vmap"):
                raise ValueError(
                    "screen=True runs its exact phase through the "
                    "vmapped generic driver (the lane-independent "
                    "engine the survivor bit-identity contract rests "
                    "on); use backend 'auto' or 'vmap', got "
                    f"{self.backend!r}")
            if self.screen_keep is None:
                raise ValueError(
                    "screen=True requires screen_keep (how many "
                    "survivors get exact iterations)")
        if self.screen_keep is not None and self.screen_keep < 1:
            raise ValueError("screen_keep must be >= 1 or None")
        if (self.backend == "packed"
                and self.algorithm not in PACKED_ALGORITHMS):
            raise ValueError(
                "backend='packed' is only implemented for algorithms with "
                f"a dense-batched block {PACKED_ALGORITHMS}; use "
                "'auto' to fall back per algorithm")
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
        if self.restart_chunk is not None and self.restart_chunk < 1:
            raise ValueError("restart_chunk must be >= 1 or None")
        tr = self.tile_rows
        if not (tr is None or tr == "auto"
                or (isinstance(tr, int) and not isinstance(tr, bool)
                    and tr >= 1)):
            raise ValueError(
                f"tile_rows must be None, 'auto' or an int >= 1, got {tr!r}")
        if tr is not None and self.algorithm not in TILED_ALGORITHMS:
            raise ValueError(
                "tile_rows is only implemented for the Gram-accumulation "
                f"algorithms {TILED_ALGORITHMS}, got "
                f"algorithm={self.algorithm!r}")
        if tr is not None and self.backend in ("pallas", "sketched"):
            raise ValueError(
                "tile_rows streams A through the tile pipeline's Gram "
                "engines; it "
                f"cannot combine with backend={self.backend!r}")
        if tr is not None and self.screen:
            raise ValueError(
                "tile_rows cannot combine with screen=True (the "
                "screening pass needs in-core A)")
        if not 0.0 <= self.class_flip_tol < 1.0:
            raise ValueError(
                f"class_flip_tol must be in [0, 1), got {self.class_flip_tol}")
        if self.sparsity_beta < 0:
            raise ValueError("sparsity_beta must be >= 0")
        if self.ridge_eta is not None and self.ridge_eta < 0:
            raise ValueError("ridge_eta must be >= 0 or None")


def check_ported(cfg: SolverConfig) -> None:
    """Raise ``ValueError`` for a solve dtype the port has no storage
    for (the reference's dtypes: float32 and float64)."""
    if cfg.dtype not in ("float32", "float64"):
        raise ValueError(
            f"dtype must be 'float32' or 'float64', got {cfg.dtype!r}")


@dataclasses.dataclass(frozen=True)
class InitConfig:
    """W0/H0 initialization (reference ``nmfx.InitConfig``).

    ``svd_method`` says how NNDSVD gets its rank-k SVD: "dense"
    (``torch.linalg.svd``) or "lanczos" (``nmfx_torch.ops.lanczos_svd``,
    Lanczos on the smaller Gram operator with ``ncv`` steps; None = 2k+1
    with a floor of 20, capped to the operator's dimension)."""

    method: str = "random"
    minval: float = 0.0
    maxval: float = 1.0
    svd_method: str = "dense"
    ncv: "int | None" = None

    def __post_init__(self):
        if self.method not in INIT_METHODS:
            raise ValueError(
                f"init method must be one of {INIT_METHODS}, got "
                f"{self.method!r}")
        if self.svd_method not in ("dense", "lanczos"):
            raise ValueError(
                f"svd_method must be 'dense' or 'lanczos', got "
                f"{self.svd_method!r}")


@dataclasses.dataclass(frozen=True)
class ConsensusConfig:
    """Consensus sweep settings (reference ``nmfx.ConsensusConfig``)."""

    #: the fields the checkpoint manifest may leave out (the ranks, which
    #: each record names, finalize-only settings and the execution
    #: strategy the chunk plan replaces; ``restarts``: a wider budget
    #: extends a ledger), and the fields the finished-result cache key
    #: may leave out (none: every field shapes the finished result). The
    #: linter's NMFX007 and NMFX011 hold the live keys to them
    CHECKPOINT_EXEMPT_FIELDS: ClassVar[tuple] = (
        "ks", "linkage", "min_restarts", "keep_factors", "grid_exec",
        "grid_slots", "grid_tail_slots", "restarts")
    RESULT_CACHE_EXEMPT_FIELDS: ClassVar[tuple] = ()

    ks: Sequence[int] = (2, 3, 4, 5)
    restarts: int = 10
    seed: int = 123
    label_rule: str = "argmax"
    linkage: str = "average"
    keep_factors: bool = False
    grid_exec: str = "auto"
    #: slot-pool width of the whole-grid scheduler (nmfx_torch.ops.sched_mu)
    grid_slots: int = 48
    min_restarts: int = 1
    #: the scheduler's straggler-tail cascade: "auto", None/0 (off), an int
    #: or a decreasing tuple of pool widths
    grid_tail_slots: "int | None | str | tuple" = "auto"

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
        if self.grid_slots < 1:
            raise ValueError("grid_slots must be >= 1")
        ts = self.grid_tail_slots
        if isinstance(ts, (list, tuple)):
            ok = all(isinstance(t, int) and not isinstance(t, bool)
                     and t >= 1 for t in ts)
            if ok:
                object.__setattr__(self, "grid_tail_slots", tuple(ts))
        else:
            ok = (ts is None or ts == "auto"
                  or (isinstance(ts, int) and not isinstance(ts, bool)
                      and ts >= 0))
        if not ok:
            raise ValueError(
                f"grid_tail_slots must be 'auto', None, an int >= 0, or "
                f"a tuple of int widths >= 1, got {self.grid_tail_slots!r}")
        if self.linkage not in LINKAGE_METHODS:
            raise ValueError(
                f"linkage must be one of {LINKAGE_METHODS}, got "
                f"{self.linkage!r}")


@dataclasses.dataclass(frozen=True)
class OutputConfig:
    """File outputs (reference ``nmfx.OutputConfig``)."""

    directory: str = "./nmfx_out"
    doc_string: str = ""
    write_gcts: bool = True
    write_plots: bool = True


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """Durable-sweep policy (reference ``nmfx.CheckpointConfig``;
    ``nmfx_torch/checkpoint.py``): a manifest plus one completion record
    per (rank, restart-chunk) under ``directory``, written atomically,
    so a killed run loses at most the chunk in flight and a re-run with
    ``resume=True`` solves only the missing chunks, byte-equal to an
    uninterrupted checkpointed run."""

    #: ledger directory (manifest + per-(k, chunk) records)
    directory: str = "./nmfx_ckpt"
    #: restarts per record: the chunk plan ``[0,c), [c,2c), ...`` of
    #: every rank; None = one chunk per rank
    every_n_restarts: "int | None" = None
    #: buffer records and write them at most every this many seconds
    #: (and at rank boundaries, on ``flush()`` and from the SIGTERM /
    #: SIGINT hook); None = write each record when its chunk completes
    every_s: "float | None" = None
    #: resume from the records in ``directory`` (a manifest mismatch
    #: cold-starts); False clears the ledger first
    resume: bool = True

    def __post_init__(self):
        if not self.directory:
            raise ValueError("directory must be a non-empty path")
        if self.every_n_restarts is not None and self.every_n_restarts < 1:
            raise ValueError("every_n_restarts must be >= 1 or None")
        if self.every_s is not None and self.every_s <= 0:
            raise ValueError("every_s must be positive or None")


@dataclasses.dataclass(frozen=True)
class ExecCacheConfig:
    """Bucketed-sweep reuse policy for the serving layer (reference
    ``nmfx.ExecCacheConfig``, ``nmfx_torch/exec_cache.py``), with its
    fields, defaults and validation.

    Incoming ``(m, n)`` rounds up to a coarse lattice (multiples of a
    step that starts at the quantum and doubles once the dimension
    exceeds ``growth_steps`` steps; the defaults land 5000×500 on
    5120×512) and one built sweep serves every shape in its bucket.
    ``max_entries`` bounds the live entries (LRU; ``pipeline_ranks``
    raises the bound to a request's rank count). ``cache_dir`` holds the
    kernel-schedule autotuner's store (``<cache_dir>/autotune``); the
    reference also serializes compiled XLA executables there, and a built
    torch sweep has no serialized form, so no executable is written
    (ROADMAP §1 item 6). ``max_disk_bytes``,
    ``donate_inits`` and ``compile_workers`` validate as in the
    reference; nothing in the port reads them (no disk store, no
    donation, builds are host closures)."""

    m_quantum: int = 256
    n_quantum: int = 64
    growth_steps: int = 8
    max_entries: int = 8
    donate_inits: bool = True
    cache_dir: "str | None" = None
    max_disk_bytes: int = 2 << 30  # 2 GiB
    pipeline_ranks: bool = False
    compile_workers: int = 0

    def __post_init__(self):
        if self.m_quantum < 1 or self.n_quantum < 1:
            raise ValueError("bucket quanta must be >= 1")
        if self.growth_steps < 1:
            raise ValueError("growth_steps must be >= 1")
        if self.max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        if self.max_disk_bytes < 1:
            raise ValueError("max_disk_bytes must be >= 1")
        if self.compile_workers < 0:
            raise ValueError("compile_workers must be >= 0")


@dataclasses.dataclass(frozen=True)
class ResultCacheConfig:
    """Finished-result cache policy (reference ``nmfx.ResultCacheConfig``,
    ``nmfx_torch/result_cache.py``): an in-memory LRU of ``max_entries``
    results over an optional disk tier under ``cache_dir``, byte-capped
    at ``max_disk_bytes`` by an mtime-LRU."""

    cache_dir: "str | None" = None
    max_entries: int = 32
    max_disk_bytes: int = 4 << 30  # 4 GiB

    def __post_init__(self):
        if self.max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        if self.max_disk_bytes < 1:
            raise ValueError("max_disk_bytes must be >= 1")
