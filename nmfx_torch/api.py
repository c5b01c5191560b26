"""Top-level API (counterpart of ``nmfx/api.py``): ``nmf``, one
factorization, and ``nmfconsensus``, the consensus pipeline (reference
``runNMFinJobs`` + ``computeConsensusAndSaveFiles``,
``nmf.r:106-119, 146-253``).

Results use the reference package's ``ConsensusResult`` ``.npz`` layout,
so each package loads the other's saved files.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, NamedTuple, Sequence

import numpy as np
import torch

from nmfx_torch import cophenetic as coph
from nmfx_torch import random as _random
from nmfx_torch.config import (CheckpointConfig, ConsensusConfig,
                               InitConfig, OutputConfig, SolverConfig,
                               check_ported)
from nmfx_torch.device import resolve_device
from nmfx_torch.faults import InsufficientRestarts
from nmfx_torch.harvest import HarvestPipeline, fetch_host, start_host_fetch
from nmfx_torch.init import nndsvd_init, random_init, restart_inits
from nmfx_torch.io import Dataset, read_dataset, write_gct
from nmfx_torch.ops.hclust import rank_selection_torch
from nmfx_torch.profiling import NullProfiler
from nmfx_torch.solvers.base import SolverResult, StopReason, solve
from nmfx_torch.sweep import default_mesh, mesh_home, sweep


@dataclasses.dataclass(frozen=True)
class KResult:
    """Everything the pipeline derives at one rank k."""

    k: int
    consensus: np.ndarray  # (n, n) mean connectivity
    rho: float  # cophenetic correlation
    dispersion: float  # Kim & Park (2007): mean (2C-1)^2, 1.0 = crisp
    membership: np.ndarray  # (n,) labels 1..k from cutree
    order: np.ndarray  # (n,) dendrogram leaf order
    iterations: np.ndarray  # (restarts,)
    dnorms: np.ndarray  # (restarts,) final RMS residuals
    stop_reasons: np.ndarray  # (restarts,)
    best_w: np.ndarray  # (m, k) factors of the lowest-residual restart
    best_h: np.ndarray  # (k, n)
    all_w: np.ndarray | None = None  # (restarts, m, k) under keep_factors
    all_h: np.ndarray | None = None  # (restarts, k, n)

    @property
    def ordered_consensus(self) -> np.ndarray:
        """Consensus matrix reordered by the dendrogram (nmf.r:174)."""
        return self.consensus[np.ix_(self.order, self.order)]


#: KResult fields that may be absent from a saved result
_OPTIONAL_KRESULT = frozenset(("all_w", "all_h"))


@dataclasses.dataclass(frozen=True)
class ConsensusResult:
    ks: tuple[int, ...]
    per_k: Mapping[int, KResult]
    col_names: tuple[str, ...]
    #: solver-quality tag: "exact" for the exact engines, "sketched" when
    #: the factorizations ran the compressed engine (``backend=
    #: "sketched"``, a serve request degraded there by quality-elastic
    #: scheduling included)
    quality: str = "exact"

    @property
    def rhos(self) -> np.ndarray:
        return np.array([self.per_k[k].rho for k in self.ks])

    @property
    def dispersions(self) -> np.ndarray:
        return np.array([self.per_k[k].dispersion for k in self.ks])

    @property
    def best_k(self) -> int:
        """Rank with the highest cophenetic correlation; exact rho ties
        break toward the higher dispersion (the crisper consensus)."""
        return max(self.ks,
                   key=lambda k: (self.per_k[k].rho,
                                  self.per_k[k].dispersion))

    def summary(self) -> str:
        lines = ["k\trho\tdispersion\tmean_iters"]
        for k in self.ks:
            r = self.per_k[k]
            lines.append(f"{k}\t{r.rho:.4f}\t{r.dispersion:.4f}"
                         f"\t{r.iterations.mean():.1f}")
        lines.append(f"best k = {self.best_k}")
        if self.quality != "exact":
            lines.append(f"quality = {self.quality} (approximate engine; "
                         "statistical accuracy contract)")
        return "\n".join(lines)

    def save(self, path: str) -> None:
        """Persist the whole result as one compressed ``.npz`` (the
        reference package's layout), written to a temporary file and
        renamed into place."""
        arrays: dict[str, np.ndarray] = {
            "ks": np.asarray(self.ks, np.int64),
            "col_names": np.asarray(self.col_names, np.str_),
            "quality": np.asarray(self.quality, np.str_),
        }
        for k in self.ks:
            r = self.per_k[k]
            for f in dataclasses.fields(KResult):
                v = getattr(r, f.name)
                if v is not None:
                    arrays[f"k{k}_{f.name}"] = np.asarray(v)
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as fh:
            np.savez_compressed(fh, **arrays)
        os.replace(tmp, path)

    @staticmethod
    def load(path: str) -> "ConsensusResult":
        """Inverse of :meth:`save`."""
        with np.load(path, allow_pickle=False) as z:
            ks = tuple(int(k) for k in z["ks"])
            per_k = {}
            for k in ks:
                kwargs = {}
                for f in dataclasses.fields(KResult):
                    name = f"k{k}_{f.name}"
                    if name not in z.files and f.name in _OPTIONAL_KRESULT:
                        kwargs[f.name] = None
                        continue
                    v = z[name]  # missing REQUIRED field: fail fast
                    if f.type == "int":
                        v = int(v)
                    elif f.type == "float":
                        v = float(v)
                    kwargs[f.name] = v
                per_k[k] = KResult(**kwargs)
            return ConsensusResult(
                ks=ks, per_k=per_k,
                col_names=tuple(str(c) for c in z["col_names"]),
                quality=(str(z["quality"]) if "quality" in z.files
                         else "exact"))


def _build_k_result(k: int, out, linkage: str, selection=None,
                    min_restarts: int = 1) -> KResult:
    """One rank's host-side assembly from a host (numpy) KSweepOutput: the
    survivor floor, then hclust/cophenetic/cutree. The one implementation
    the sequential loop and the streamed harvest's workers share, so their
    results are equal byte for byte. ``selection`` is a precomputed
    ``(rho, membership, order)`` (device rank selection); without it the
    host rank selection runs here."""
    stops = np.asarray(out.stop_reasons)
    masked = ((stops == int(StopReason.NUMERIC_FAULT))
              | (stops == int(StopReason.SCREENED)))
    survivors = int((~masked).sum())
    if survivors < min_restarts:
        n_fault = int((stops == int(StopReason.NUMERIC_FAULT)).sum())
        n_screen = int((stops == int(StopReason.SCREENED)).sum())
        raise InsufficientRestarts(
            f"rank k={k}: only {survivors} of {stops.size} restarts "
            "survived the numeric quarantine / screening cut "
            f"(NUMERIC_FAULT on {n_fault}, SCREENED on {n_screen}), "
            f"below the configured floor min_restarts={min_restarts} — "
            "the consensus for this rank is not trustworthy. Inspect "
            "the input conditioning / solver settings (or raise "
            "screen_keep), or lower min_restarts to accept thinner "
            "consensus")
    cons = np.asarray(out.consensus, dtype=np.float64)
    if selection is None:
        selection = coph.rank_selection(cons, k, linkage)
    rho, membership, order = selection
    # signif(rho, 4), nmf.r:172
    rho = float(np.format_float_positional(float(rho), precision=4,
                                           fractional=False))
    return KResult(
        k=k, consensus=cons, rho=rho,
        dispersion=float(np.mean((2.0 * cons - 1.0) ** 2)),
        membership=np.asarray(membership), order=np.asarray(order),
        iterations=out.iterations, dnorms=out.dnorms,
        stop_reasons=out.stop_reasons, best_w=out.best_w,
        best_h=out.best_h, all_w=out.all_w, all_h=out.all_h)


def run_example(outdir: "str | None" = "./nmfx_out", **kwargs):
    """The reference's ``runExample`` entry (nmf.r:6-14) on equivalent
    synthetic data: a 1000x40 two-group expression matrix (the bundled
    ``20+20x1000.gct`` design), swept at the reference defaults —
    k=2..5, 10 restarts, maxiter 10000, seed 123. Returns the
    ConsensusResult; pass ``outdir=None`` to skip file outputs. Other
    keywords go to :func:`nmfconsensus`, ``device`` among them (the card
    by default)."""
    from nmfx_torch.datasets import two_group_matrix

    a = two_group_matrix(n_genes=1000, n_per_group=20, seed=123)
    output = None if outdir is None else OutputConfig(directory=outdir)
    defaults = dict(ks=(2, 3, 4, 5), restarts=10, seed=123, output=output)
    defaults.update(kwargs)
    return nmfconsensus(a, **defaults)


def _as_matrix(data) -> tuple:
    from nmfx_torch.sparse import SparseMatrix

    if isinstance(data, str):
        data = read_dataset(data)
    if isinstance(data, Dataset):
        return np.asarray(data.values), list(data.col_names)
    if isinstance(data, SparseMatrix):
        # stays sparse end to end: sweep() streams it through the
        # out-of-core tile pipeline without densifying
        return data, [str(i + 1) for i in range(data.shape[1])]
    arr = np.asarray(data)
    return arr, [str(i + 1) for i in range(arr.shape[1])]


_NP_DTYPES = {"float32": np.float32, "float64": np.float64}


def _resolve_cfgs(algorithm, max_iter, init, solver_cfg, init_cfg):
    """Merge convenience args with config objects; reject conflicts."""
    if solver_cfg is not None:
        if algorithm is not None or max_iter is not None:
            raise ValueError(
                "pass either solver_cfg or algorithm/max_iter, not both — "
                "set them on the SolverConfig instead")
        scfg = solver_cfg
    else:
        scfg = SolverConfig(algorithm=algorithm or "mu",
                            max_iter=max_iter or 10000)
    if init_cfg is not None:
        if init is not None:
            raise ValueError("pass either init_cfg or init, not both")
        icfg = init_cfg
    else:
        icfg = InitConfig(method=init or "random")
    return scfg, icfg


def nmf(a, k: int, *, seed: int = 0, algorithm: str | None = None,
        max_iter: int | None = None, init: str | None = None,
        solver_cfg: SolverConfig | None = None,
        init_cfg: InitConfig | None = None, w0=None, h0=None,
        device=None) -> SolverResult:
    """One non-negative factorization A ≈ W·H at rank k (reference
    ``nmf``), by any of the eight ``algorithm``s: "mu" (the default),
    "als", "neals", "pg", "alspg", "kl", "snmf" or "hals", in float32 or
    float64 (``solver_cfg.dtype``); mu and hals also on the compressed
    engine (``backend="sketched"``, its projections drawn from
    ``key(seed)``, the key the init draws from).

    ``w0``/``h0``: explicit initial factors (both or neither); otherwise
    they come from ``init``/``init_cfg`` with the key ``key(seed)``, the
    reference's draws bit for bit, in ``solver_cfg.dtype``. ``device``:
    None = CUDA (raising without one), or "cpu".
    """
    arr, _ = _as_matrix(a)
    if not np.isfinite(arr).all():
        raise ValueError("input matrix contains non-finite values")
    if (arr < 0).any():
        raise ValueError("input matrix must be non-negative")
    scfg, icfg = _resolve_cfgs(algorithm, max_iter, init, solver_cfg,
                               init_cfg)
    if (w0 is None) != (h0 is None):
        raise ValueError("pass both w0 and h0, or neither")
    m, n = arr.shape
    if w0 is None:
        if icfg.method == "nndsvd":
            dtype = torch.float64 if scfg.dtype == "float64" else torch.float32
            w0, h0 = nndsvd_init(torch.as_tensor(
                arr, dtype=dtype, device=resolve_device(device)), k,
                svd_method=icfg.svd_method, ncv=icfg.ncv)
        else:
            w0, h0 = random_init(_random.key(seed), m, n, k, icfg,
                                 _NP_DTYPES[scfg.dtype])
    else:
        if init is not None or init_cfg is not None:
            raise ValueError(
                "pass either explicit w0/h0 or an init scheme, not both")
        w0, h0 = np.asarray(w0), np.asarray(h0)
        if w0.shape != (m, k) or h0.shape != (k, n):
            raise ValueError(
                f"w0/h0 shapes {w0.shape}/{h0.shape} don't match "
                f"({m}, {k})/({k}, {n})")
        if not (np.isfinite(w0).all() and np.isfinite(h0).all()):
            raise ValueError("initial factors contain non-finite values")
        if (w0 < 0).any() or (h0 < 0).any():
            raise ValueError("initial factors must be non-negative")
    if scfg.screen:
        raise ValueError(
            "screen=True is a sweep-pool concept (it ranks RESTARTS); "
            "a single factorization has no pool to screen")
    if scfg.backend == "sketched":
        return _solve_sketched(arr, w0, h0, _random.key(seed), scfg,
                               device)
    return solve(arr, w0, h0, scfg, device=device)


def _solve_sketched(arr, w0, h0, key: np.ndarray, scfg: SolverConfig,
                    device) -> SolverResult:
    """One compressed factorization on ``device`` from ``key`` (the
    restart's key, which its projections fold off)."""
    from nmfx_torch.device import to_device
    from nmfx_torch.solvers.sketched import solve_sketched

    check_ported(scfg)
    dev = resolve_device(device)
    dtype = torch.float64 if scfg.dtype == "float64" else torch.float32
    a, w0, h0 = (to_device(x, dtype, dev) for x in (arr, w0, h0))
    return solve_sketched(a, w0, h0, key, scfg)


def restart_factors(a, k: int, restart: int, *, restarts: int,
                    seed: int = 123, algorithm: str | None = None,
                    max_iter: int | None = None, init: str | None = None,
                    solver_cfg: SolverConfig | None = None,
                    init_cfg: InitConfig | None = None,
                    device=None) -> SolverResult:
    """Recompute one sweep restart's (W, H, iterations) from its key
    (reference ``restart_factors``): restart ``r`` of rank ``k`` starts
    from ``split(fold_in(key(seed), k), restarts)[r]``, so any job of an
    ``nmfconsensus(seed=..., restarts=...)`` run is reproducible alone,
    without the sweep having kept its factors (``keep_factors``; a
    checkpointed sweep refuses that and names this instead). It runs the
    exact single-restart ``solve``; the sweep's packed or batched route
    sums in other orders, so the factors agree to float tolerance.

    A sketched configuration runs the compressed engine from the same
    key, whose projections the sweep's lane folds off it too (the same
    draws and trajectory, at float tolerance). A screened one runs what
    a survivor lane's exact phase ran: the screening fields stripped, on
    the batched restart route at that phase's width (``screen_keep``
    copies of this restart, the first one returned), so the products
    have the survivors' shapes and a survivor recomputes byte-equal
    wherever equal shapes take equal kernels (cuBLAS may choose another
    algorithm for another batch count); a screened-out lane gets its
    would-have-been exact result."""
    if not 0 <= restart < restarts:
        raise ValueError(
            f"restart index {restart} outside [0, {restarts})")
    arr, _ = _as_matrix(a)
    scfg, icfg = _resolve_cfgs(algorithm, max_iter, init, solver_cfg,
                               init_cfg)
    dev = resolve_device(device)
    kk = _random.split(_random.fold_in(_random.key(seed), k),
                       restarts)[restart:restart + 1]
    dtype = torch.float64 if scfg.dtype == "float64" else torch.float32
    w0, h0 = restart_inits(torch.as_tensor(arr, dtype=dtype, device=dev),
                           kk, k, icfg)
    if scfg.backend == "sketched":
        return _solve_sketched(arr, w0[0], h0[0], kk[0], scfg, dev)
    if scfg.screen:
        width = scfg.screen_keep
        scfg = dataclasses.replace(scfg, screen=False, screen_keep=None)
        return _solve_lane(w0, h0, torch.as_tensor(arr, dtype=dtype,
                                                   device=dev), scfg, width)
    return solve(arr, w0[0], h0[0], scfg, device=dev)


def _solve_lane(w0: torch.Tensor, h0: torch.Tensor, a: torch.Tensor,
                scfg: SolverConfig, width: int) -> SolverResult:
    """One restart, (1, m, k) / (1, k, n), on the batched restart route
    (a screened sweep's exact phase) as ``width`` identical lanes,
    returned as a single solve's result."""
    from nmfx_torch.solvers import SOLVERS
    from nmfx_torch.solvers.base import run_loop_batched

    check_ported(scfg)
    mod = SOLVERS[scfg.algorithm]
    w0 = w0.expand(width, -1, -1).contiguous()
    h0 = h0.expand(width, -1, -1).contiguous()
    res = run_loop_batched(a, w0, h0, scfg, mod.step,
                           mod.init_aux(a, w0, h0, scfg))
    return res._replace(w=res.w[0], h=res.h[0],
                        iterations=int(res.iterations[0]),
                        dnorm=res.dnorm[0],
                        stop_reason=int(res.stop_reason[0]))


class _Selection(NamedTuple):
    """One rank's device rank selection (``rank_selection_torch``)."""

    rho: torch.Tensor
    membership: torch.Tensor
    order: torch.Tensor


def nmfconsensus(
    data,
    ks: Sequence[int] = (2, 3, 4, 5),
    restarts: int = 10,
    *,
    seed: int = 123,
    algorithm: str | None = None,
    max_iter: int | None = None,
    init: str | None = None,
    label_rule: str = "argmax",
    linkage: str = "average",
    solver_cfg: SolverConfig | None = None,
    init_cfg: InitConfig | None = None,
    mesh=None,
    use_mesh: bool = True,
    keep_factors: bool = False,
    grid_exec: str = "auto",
    grid_slots: int = 48,
    grid_tail_slots="auto",
    min_restarts: int = 1,
    output: OutputConfig | None = None,
    device=None,
    on_rank=None,
    rank_selection: str = "host",
    harvest: str = "streamed",
    profiler=None,
    checkpoint=None,
    checkpoint_dir: str | None = None,
    exec_cache=None,
    result_cache=None,
) -> ConsensusResult:
    """Full consensus-NMF rank sweep: ``restarts`` factorizations per rank
    in ``ks``, a consensus matrix per rank on the device, cophenetic rank
    selection on the host, and optional GCT outputs.

    Routes, as the reference takes them, for the eight algorithms:

    * whole grid (``grid_exec="auto"`` with more than one rank, or
      ``"grid"``), for mu and hals under ``backend`` "auto" (the default),
      "packed" and "pallas", and for neals, als, snmf and kl under
      "packed": every (k, restart) job through one slot-scheduled solve
      of ``grid_slots`` slots with the ``grid_tail_slots`` cascade;
      ``backend="pallas"`` runs it on a hand-written block kernel (mu's,
      phased, or join-the-updates under
      ``ExperimentalConfig(fused_updates="fused")``; hals' coordinate-sweep
      kernel), the other backends on plain batched products;
    * per rank (``grid_exec="per_k"``, one rank, or any other pair): mu
      under "auto", "packed" or "pallas" solves each rank's restarts as
      one packed batch, on the hand-written per-iteration kernels under
      ``backend="pallas"``, plain products otherwise; the grid's other
      pairs run the slot scheduler at that one rank; and the rest — als,
      neals, snmf, kl, pg and alspg under "auto", and all eight under
      ``backend="vmap"`` — take the batched restart route: a rank's
      restarts as lanes of one solve on plain products, in
      ``solver_cfg.restart_chunk`` chunks. pg and alspg refuse
      ``backend="packed"``, as the reference does.

    Out of core (``nmfx_torch/tiles.py``): ``data`` may be a
    ``nmfx_torch.sparse.SparseMatrix`` or a ``.mtx`` / ``.csr.npz`` path
    (it stays sparse), and ``solver_cfg.tile_rows`` (an int or "auto")
    streams a dense host matrix. A stays on the host and its row blocks
    stream to the device on every pass while W, H and the restart pool
    stay resident there; every sparse input and every multi-tile plan
    runs this way (mu and hals, random init), rank by rank. A dense plan
    of one tile runs the routes above, byte-equal to the same call
    without ``tile_rows``.

    ``mesh`` (``grid_mesh(R, F, S)``): on a restart mesh every route runs
    restart-sharded, each shard on its own device (a device may be named
    more than once); on the CPU the result is byte-equal to the unmeshed
    run. With feature or sample axes each factorization is split over
    the genes and the samples (mu on its plain packed products, kl,
    neals, snmf or hals; the reference's refusals otherwise, and
    ``keep_factors`` is refused: ``restart_factors`` recomputes any
    restart from its key). ``use_mesh`` (the default) takes
    ``default_mesh()`` when ``device`` is None and no ``mesh`` is given:
    a restart mesh over this process's cards, None with one card. An
    explicit mesh with ``checkpoint`` is refused, as in the reference.

    ``device``: None means CUDA and raises if no CUDA device is present
    (pass ``device="cpu"`` for the plain PyTorch versions on the CPU). On
    CUDA the entry point switches TF32 off for float32 matmuls.
    ``on_rank(k, out)`` is called after each rank's solve with its
    device-side ``KSweepOutput`` (on the grid route, after the whole
    solve), before the rank is handed to the harvest.

    ``rank_selection``: "host" (default) runs hclust/cophenetic/cutree on
    the host, in the native library (``nmfx_torch/cophenetic.py``);
    "device" runs the clustering on the consensus's device
    (``nmfx_torch/ops/hclust.py``), dispatched for every rank before the
    one host transfer, and implies the sequential assembly.

    ``harvest``: "streamed" (default) hands each rank, the moment its
    output exists and its host copies are started, to worker threads that
    wait for the copies and run the host rank selection while later ranks
    still solve (``nmfx_torch/harvest.py``); "sequential" waits for every
    rank's copies after the sweep, then selects rank by rank. Both give
    byte-equal results.

    ``profiler``: an ``nmfx_torch.profiling.Profiler`` that books the
    phases (``solve.*``, ``xfer.*``, ``post.rank_selection`` or
    ``device_to_host`` / ``rank_selection``, ``write_outputs``; under a
    checkpoint ``ckpt.load``, ``solve.ckpt.k=…``, ``checkpoint`` and
    ``ckpt.finalize``).

    ``checkpoint`` (a ``CheckpointConfig`` or a directory path): the
    durable sweep ledger (``nmfx_torch/checkpoint.py``): one record per
    (rank, restart-chunk), written atomically, so a killed run loses at
    most the chunk in flight and a re-run solves only the missing chunks,
    byte-equal to an uninterrupted checkpointed run; a manifest mismatch
    cold-starts. Every rank runs the chunk executor (mu's packed solve
    under "auto", "packed" and "pallas", the batched restart route
    otherwise), whatever ``grid_exec`` says. Not with ``checkpoint_dir``
    or ``keep_factors`` (``restart_factors`` recomputes any restart).

    ``checkpoint_dir``: the per-rank registry
    (``nmfx_torch/registry.py``): each finished rank is saved there and a
    re-run loads it instead of solving it; a registry written for another
    (data, config) is refused.

    A moves to the device through the content-keyed input cache
    (``nmfx_torch/data_cache.py``): a second call over the same array
    copies nothing to the card.

    ``exec_cache`` (``nmfx_torch.ExecCache``): serve the sweep through
    the shape-bucketed cache when the configuration is cacheable
    (``ExecCache.cacheable``): A zero-padded to its bucket, the lanes
    drawn at the true shape, one pool padded to ``grid_slots``; the
    results are the serving tier's (``NMFXServer``), and agree with the
    plain sweep at the agreement tier. The sweep runs on the cache's
    device, or on a restart ``mesh`` restart-sharded; grid axes are not
    cacheable (the plain sweep runs). Not with ``checkpoint``.

    ``result_cache`` (a ``result_cache.ResultCache`` or a directory):
    a finished result stored under this request's content-addressed key
    is returned without solving, and a solved one is stored
    (``keep_factors`` requests solve through).
    """
    if rank_selection not in ("host", "device"):
        raise ValueError("rank_selection must be 'host' or 'device', got "
                         f"{rank_selection!r}")
    if harvest not in ("streamed", "sequential"):
        raise ValueError("harvest must be 'streamed' or 'sequential', got "
                         f"{harvest!r}")
    from nmfx_torch.sparse import SparseMatrix

    arr, col_names = _as_matrix(data)
    sparse_input = isinstance(arr, SparseMatrix)
    # a sparse input validates its stored nonzeros (the implicit zeros
    # are finite and non-negative)
    vals = arr.data if sparse_input else arr
    if not np.isfinite(vals).all():
        raise ValueError("input matrix contains non-finite values")
    if (vals < 0).any():
        raise ValueError("input matrix must be non-negative")
    ks = tuple(ks)
    if not ks:
        raise ValueError("ks must be non-empty")
    if max(ks) > arr.shape[1]:
        raise ValueError(
            f"k={max(ks)} exceeds the number of samples ({arr.shape[1]})")
    ccfg = ConsensusConfig(ks=ks, restarts=restarts, seed=seed,
                           label_rule=label_rule, linkage=linkage,
                           keep_factors=keep_factors, grid_exec=grid_exec,
                           grid_slots=grid_slots,
                           grid_tail_slots=grid_tail_slots,
                           min_restarts=min_restarts)
    scfg, icfg = _resolve_cfgs(algorithm, max_iter, init, solver_cfg,
                               init_cfg)
    rcache = rkey = None
    if result_cache is not None:
        from nmfx_torch.result_cache import (ResultCache, cacheable,
                                             key_for_array, request_quality)

        if cacheable(ccfg):
            rcache = (result_cache
                      if isinstance(result_cache, ResultCache)
                      else ResultCache(cache_dir=os.fspath(result_cache),
                                       layer="api"))
            # the sweep below takes the cache's route unless the legacy
            # registry runs it (a checkpoint refuses exec_cache)
            route = (exec_cache.route(arr.shape, ccfg, scfg)
                     if exec_cache is not None and checkpoint_dir is None
                     and not sparse_input else None)
            rkey = key_for_array(arr, scfg, ccfg, icfg,
                                 request_quality(scfg), device=device,
                                 route=route)
            cached = rcache.lookup(rkey)
            if cached is not None:
                if output is not None:
                    save_results(cached, output)
                return cached
    if checkpoint is not None:
        if isinstance(checkpoint, (str, os.PathLike)):
            checkpoint = CheckpointConfig(directory=os.fspath(checkpoint))
        if checkpoint_dir is not None:
            raise ValueError(
                "pass either checkpoint (the durable chunked ledger) or "
                "checkpoint_dir (the legacy per-rank registry), not both")
        if mesh is not None:
            raise ValueError(
                "checkpoint does not compose with an explicit mesh: the "
                "chunk executor owns its per-(k, restart-chunk) "
                "execution plan on the default device (use "
                "nmfx_torch.distributed's elastic shard runner for "
                "multi-device durable sweeps)")
        if exec_cache is not None:
            raise ValueError(
                "checkpoint does not compose with exec_cache: "
                "checkpointed sweeps dispatch per (rank, restart-chunk) "
                "through the durable ledger, which bypasses the "
                "bucketed executable cache")
        use_mesh = False  # the chunk plan is the parallelism unit
    if mesh is None and use_mesh and device is None:
        mesh = default_mesh()
    registry = None
    if checkpoint_dir is not None:
        from nmfx_torch.registry import SweepRegistry

        if sparse_input or scfg.tile_rows is not None:
            raise ValueError(
                "checkpoint_dir (the legacy per-rank registry) does not "
                "support sparse/tiled inputs; pass checkpoint= (the "
                "durable chunked ledger) for out-of-core resume")
        # the fingerprint sees the autotuner's resolved fields, as the
        # sweep's other keys do
        from nmfx_torch.sweep import resolve_autotune

        scfg = resolve_autotune(arr.shape, ccfg, scfg, device=device,
                                mesh=mesh, exec_cache=exec_cache)
        registry = SweepRegistry.open(checkpoint_dir, arr, scfg, icfg,
                                      restarts, seed, label_rule,
                                      keep_factors, mesh)
    if profiler is None:
        profiler = NullProfiler()
    run = dict(device=device, mesh=mesh, profiler=profiler,
               registry=registry, checkpoint=checkpoint,
               exec_cache=exec_cache)

    if harvest == "streamed" and rank_selection == "host":
        pipeline = HarvestPipeline(linkage=ccfg.linkage, profiler=profiler,
                                   min_restarts=ccfg.min_restarts)

        def rank_done(k, out):
            if on_rank is not None:
                on_rank(k, out)
            pipeline.submit(k, out)

        try:
            sweep(arr, ccfg, scfg, icfg, on_rank=rank_done, **run)
            per_k = pipeline.results()
        finally:
            pipeline.close()
        per_k = {k: per_k[k] for k in ccfg.ks}
    else:
        raw = sweep(arr, ccfg, scfg, icfg, on_rank=on_rank, **run)
        sel = {}
        if rank_selection == "device":
            # dispatched for every rank before anything is read on the
            # host, so the clustering queues behind the copies (a
            # registry's or ledger's host consensus moves there first)
            dev = (resolve_device(device) if mesh is None
                   else mesh_home(mesh))
            with profiler.phase("rank_selection_dispatch"):
                sel = {k: start_host_fetch(_Selection(*rank_selection_torch(
                    torch.as_tensor(out.consensus, device=dev), k,
                    ccfg.linkage)))
                    for k, out in raw.items()}
        # the sweep started every rank's copies; this waits for them once
        with profiler.phase("device_to_host"):
            host = {k: fetch_host(out) for k, out in raw.items()}
            sel = {k: s.wait() for k, s in sel.items()}
        per_k = {}
        for k in ccfg.ks:
            with profiler.phase("rank_selection"):
                per_k[k] = _build_k_result(
                    k, host[k], ccfg.linkage, selection=sel.get(k),
                    min_restarts=ccfg.min_restarts)
    result = ConsensusResult(ks=ccfg.ks, per_k=per_k,
                             col_names=tuple(col_names),
                             quality=("sketched"
                                      if scfg.backend == "sketched"
                                      else "exact"))
    if rcache is not None and rkey is not None:
        try:
            rcache.put(rkey, result, ccfg=ccfg)
        except Exception:  # nmfx: ignore[NMFX006] -- cache trouble
            pass  # never fails a solved request
    if output is not None:
        with profiler.phase("write_outputs"):
            save_results(result, output)
    return result


def save_results(result: ConsensusResult, out: OutputConfig) -> list[str]:
    """Write the reference's output set (nmf.r:195-252): per-k ordered
    membership GCTs, the all-k membership matrix, ``cophenetic.txt``,
    per-k consensus-matrix GCTs, per-k metagene GCTs and
    ``rank_metrics.txt``, for results of every route (checkpointed and
    registry-loaded sweeps included); with ``out.write_plots`` the plot
    set of ``nmfx_torch/plots.py``, skipped where matplotlib is missing."""
    os.makedirs(out.directory, exist_ok=True)
    doc = out.doc_string
    prefix = os.path.join(out.directory, f"{doc}." if doc else "")
    written: list[str] = []
    names = np.asarray(result.col_names)

    if out.write_gcts:
        for k in result.ks:
            r = result.per_k[k]
            ordered_names = names[r.order]
            path = f"{prefix}consensus.k.{k}.gct"
            write_gct(r.membership[r.order].reshape(-1, 1), path,
                      row_names=list(ordered_names), col_names=["membership"])
            written.append(path)
            path = f"{prefix}consensus.matrix.k.{k}.gct"
            write_gct(r.consensus, path, row_names=list(names),
                      col_names=list(names))
            written.append(path)
            path = f"{prefix}metagenes.k.{k}.gct"
            write_gct(r.best_h, path,
                      row_names=[f"metagene.{i + 1}" for i in range(k)],
                      col_names=list(names))
            written.append(path)
        all_membership = np.stack(
            [result.per_k[k].membership for k in result.ks], axis=1)
        path = f"{prefix}membership.gct"
        write_gct(all_membership, path, row_names=list(names),
                  col_names=[f"k={k}" for k in result.ks])
        written.append(path)

    path = f"{prefix}cophenetic.txt"
    with open(path, "wt") as f:
        for k in result.ks:
            f.write(f"{k}\t{result.per_k[k].rho}\n")
    written.append(path)

    path = f"{prefix}rank_metrics.txt"
    with open(path, "wt") as f:
        f.write("k\trho\tdispersion\tmean_iters\tmean_dnorm\n")
        for k in result.ks:
            r = result.per_k[k]
            f.write(f"{k}\t{r.rho}\t{r.dispersion:.6f}"
                    f"\t{r.iterations.mean():.1f}\t{r.dnorms.mean():.6g}\n")
    written.append(path)

    if out.write_plots:
        try:
            from nmfx_torch import plots
        except ImportError:  # matplotlib absent: GCT outputs still complete
            return written
        written += plots.save_all(result, prefix)
    return written
