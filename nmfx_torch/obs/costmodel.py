"""Analytic cost models + per-dispatch roofline attribution (counterpart
of the analytic half of ``nmfx/obs/costmodel.py``).

* **Cost models** — analytic per-iteration-per-lane FLOPs *and*
  bytes-moved models for every (algorithm, engine-family) pair the port
  routes, in ONE literal table (``_FLOPS``/``_BYTES``) held against the
  live routing tables (:func:`engine_universe`) both ways, so a new
  algorithm or family can never ship without a model. The formulas are
  the reference's, unchanged: the count depends on m, n, k, the
  configuration and the iteration counts only, so it is the same
  whatever implements the work. Models cover the UPDATE math only;
  convergence-check costs (cadence-amortized, O(model/check_every)) are
  excluded, as the reference excludes them.
* **Per-dispatch attribution** — the profiled sweep calls
  :func:`attribute_dispatch` with its measured solve wall and the
  per-lane iteration counts; achieved FLOP/s, model-FLOP utilization
  (MFU) against a per-device peak table, and arithmetic intensity
  export as the ``nmfx_perf_*`` histograms, and a roofline verdict
  surfaces in ``Profiler.report()``.

The byte model is PER LANE, as the reference defines it: a pooled block
kernel that reads A once per half-update for every slot of its pool is
charged one read of A per lane. So ``hbm_bw_fraction`` is a fraction of
the model's bytes, not of the bytes the card moves, and on the pooled
routes it can pass 1.

The peak is the one of the device the dispatch ran on (the device A was
placed on), never a process-wide default: a CPU device has no row and
its verdict reads "unknown device peak".

The out-of-core family "tiled" (``nmfx_torch/tiles.py``) scales its
data-sized terms by the stored-nonzero density of the sparse input the
sweep routed (:func:`set_sparse_density`, 1.0 for a dense input).

The sketched family ("sketched", ``nmfx_torch/solvers/sketched.py``)
counts one compressed iteration: no m × n term, the r-sized sketches
and the factor passes.

The communication model (:func:`comm_model`) prices a meshed
factorization's collectives, and :func:`attribute_dispatch` scales the
peak by a mesh's distinct devices of this process.

Left out, with the reason: the XLA cross-checks (``xla_iteration_cost``
with its ``_compile_*`` helpers, and ``xla_comm_cost``), which difference
XLA's compiled cost analysis and have no PyTorch counterpart; and the
``device_seconds`` aggregate of the summary.
"""

from __future__ import annotations

import threading
from collections import deque

from nmfx_torch.obs import metrics as _metrics

__all__ = [
    "COSTMODEL_EXEMPT", "DEVICE_PEAKS", "attribute_dispatch",
    "attribution_enabled", "check_costmodel_coverage", "covered_engines",
    "device_kind", "device_peak", "disable_attribution", "dispatch_cost",
    "enable_attribution", "engine_universe", "iteration_bytes",
    "iteration_flops", "perf_report", "perf_summary",
    "recent_attributions", "reset_perf", "set_device_peak",
    "set_sparse_density", "sparse_density",
]

#: algorithms deliberately WITHOUT a cost model: pg/alspg spend
#: data-dependent inner work per outer iteration (projected-gradient
#: line-search trials, alspg subproblem iterations capped by
#: ``sub_max_iter``), so no shape-derived per-iteration FLOP count
#: exists. The coverage check holds this tuple both ways: an exempt
#: algorithm must not gain a model entry, and every exemption must name
#: a registered algorithm.
COSTMODEL_EXEMPT = ("pg", "alspg")

#: defaults mirrored from SolverConfig for cfg=None callers
_DEFAULT_CHECK_EVERY = 2
_DEFAULT_PALLAS_CHECK_BLOCK = 4


# --------------------------------------------------------------------------
# analytic models: FLOPs per iteration per lane
# --------------------------------------------------------------------------

def _mu_flops(m, n, k, cfg=None):
    """The six-GEMM mu update (reference nmf_mu.c:174-216) — H: WᵀA
    (2mnk) + WᵀW (2mk²) + (WᵀW)H (2nk²); W: AHᵀ (2mnk) + HHᵀ (2nk²) +
    W(HHᵀ) (2mk²). Elementwise terms (O(mk + kn)) omitted."""
    return 4.0 * m * n * k + 4.0 * k * k * (m + n)


def _hals_flops(m, n, k, cfg=None):
    """hals matches mu to leading order: the same two big data GEMMs +
    two Grams, with the per-component coordinate passes summing to the
    same 2k²(m+n) as mu's Gram-product terms."""
    return 4.0 * m * n * k + 4.0 * k * k * (m + n)


def _kl_flops(m, n, k, cfg=None):
    """One kl (Brunet) iteration: two quotient reconstructions W@H
    (2·2mnk), two quotient contractions WᵀQ / QHᵀ (2·2mnk), and the two
    elementwise quotient passes (4mn) — 8mnk + 4mn to leading order."""
    return 8.0 * m * n * k + 4.0 * m * n


def _neals_flops(m, n, k, cfg=None):
    """Normal-equation ALS: per half-step one Gram (2mk² / 2nk²), one
    data GEMM WᵀA / HAᵀ (2mnk each), and the jittered-Cholesky k×k
    solve (k³/3 factor + 2k² per rhs column) —
    4mnk + 4k²(m+n) + (2/3)k³."""
    return (4.0 * m * n * k + 4.0 * k * k * (m + n)
            + (2.0 / 3.0) * k ** 3)


def _snmf_flops(m, n, k, cfg=None):
    """snmf = neals with the β-coupling/ridge additions on the k×k Grams
    — O(k²), invisible at model precision."""
    return _neals_flops(m, n, k, cfg)


def _als_flops(m, n, k, cfg=None):
    """SVD-based min-norm lstsq ALS: the pseudo-inverse application
    x = V·S⁻¹·(Uᵀ·A), 2mnk + 2nk² per half-step (and the transposed
    twin), plus the (m, k)/(n, k) SVD itself with a LAPACK constant of
    8 — 4mnk + 10k²(m+n)."""
    return 4.0 * m * n * k + 10.0 * k * k * (m + n)


#: stored-nonzero density of the sparse input the tiled dispatches
#: contract (1.0 = dense input). A module-level hint, because the
#: attribution call sites carry only (m, n, iteration counts): the sweep
#: stamps it when it routes an input to the tiled engine
#: (``sweep._sweep_tiled``)
_sparse_density = 1.0


def set_sparse_density(density: float) -> None:
    """Record the stored-nonzero density of the input the next tiled
    dispatches contract: the tiled models scale their data-sized FLOP
    and byte terms by it (sparse NMF pays for nnz, not m·n)."""
    global _sparse_density
    d = float(density)
    if not 0.0 <= d <= 1.0:
        raise ValueError(f"density must be in [0, 1], got {density!r}")
    _sparse_density = d


def sparse_density() -> float:
    """The current sparse-density hint the tiled models apply."""
    return _sparse_density


def _tiled_flops(m, n, k, cfg=None):
    """Out-of-core tiled mu/hals iteration: the in-core leading-order
    math — two data-sized contractions and the k²-sized Gram products —
    with the data terms over stored nonzeros only, scaled by the
    density hint: 4·d·mnk + 4k²(m + n)."""
    return (4.0 * _sparse_density * m * n * k
            + 4.0 * k * k * (m + n))


def _sketched_flops(m, n, k, cfg=None):
    """Compressed mu/hals iteration: the engine's own shape-derived
    count (``sketched.sketched_model_flops``: 4rk(m+n) + 4rk² +
    2k²(m+n)). The once-per-restart L·A / A·R sketches and the trailing
    ``polish_iters`` exact iterations amortize over the compressed loop
    and are left out, as the exact models leave out their fixed
    terms."""
    from nmfx_torch.solvers.sketched import resolve_dim, sketched_model_flops

    cfg = _resolve_cfg(cfg)
    r = resolve_dim(cfg, int(m), int(n), int(k))
    return sketched_model_flops(m, n, k, r)


def _resolve_cfg(cfg):
    if cfg is not None:
        return cfg
    from nmfx_torch.config import SolverConfig

    return SolverConfig()


# --------------------------------------------------------------------------
# analytic models: bytes moved per iteration per lane
# --------------------------------------------------------------------------
#
# Byte models count the memory traffic of the major arrays: the m×n data
# operand per read/materialization, and a small constant number of
# factor-sized (mk + kn) passes per update. k×k Grams and O(k) scalars
# are noise at model precision. The point of the model is ARITHMETIC
# INTENSITY (flops/bytes) for the roofline verdict.

def _a_itemsize(cfg, family, algorithm) -> float:
    """Bytes per element of the A operand as the iteration loop reads
    it: the packed/pallas engines stream A as bf16 under
    matmul_precision='bfloat16' (kl excluded: its quotient is
    elementwise), everything else reads the solve dtype."""
    s = _itemsize(cfg)
    if (family in ("packed", "pallas") and algorithm != "kl"
            and cfg is not None
            and getattr(cfg, "matmul_precision", "default") == "bfloat16"):
        return 2.0
    return s


def _itemsize(cfg) -> float:
    dt = getattr(cfg, "dtype", "float32") if cfg is not None else "float32"
    return 2.0 if "16" in str(dt) else 4.0


def _dense_bytes(m, n, k, cfg, family, algorithm, a_reads=2.0,
                 factor_passes=8.0, mn_passes=0.0):
    """Shared dense-update byte model: ``a_reads`` passes over the m×n
    operand, ``mn_passes`` extra m×n materializations (kl's quotients),
    ``factor_passes`` factor-sized (mk + kn) passes."""
    s = _itemsize(cfg)
    sa = _a_itemsize(cfg, family, algorithm)
    return (a_reads * m * n * sa + mn_passes * m * n * s
            + factor_passes * (m * k + k * n) * s)


def _mu_bytes(m, n, k, cfg=None, family="vmap"):
    # WᵀA + AHᵀ read A once each; W/H each: GEMM-operand reads (~2),
    # prev read + update write in the elementwise epilogue (~2)
    return _dense_bytes(m, n, k, cfg, family, "mu")


def _hals_bytes(m, n, k, cfg=None, family="vmap"):
    # the k coordinate passes each re-touch the updating factor, so
    # factor traffic scales with k: ~8 + 5k factor passes
    return _dense_bytes(m, n, k, cfg, family, "hals",
                        factor_passes=8.0 + 5.0 * k)


def _kl_bytes(m, n, k, cfg=None, family="vmap"):
    # per half-step over m×n: reconstruction write + read, quotient
    # write + read, and the A read (5 passes; ×2 halves)
    return _dense_bytes(m, n, k, cfg, family, "kl", a_reads=2.0,
                        mn_passes=8.0, factor_passes=6.0)


def _neals_bytes(m, n, k, cfg=None, family="vmap"):
    return _dense_bytes(m, n, k, cfg, family, "neals", factor_passes=8.0)


def _snmf_bytes(m, n, k, cfg=None, family="vmap"):
    return _dense_bytes(m, n, k, cfg, family, "snmf", factor_passes=8.0)


def _als_bytes(m, n, k, cfg=None, family="vmap"):
    # lstsq touches A twice plus SVD workspace passes over the factors
    return _dense_bytes(m, n, k, cfg, family, "als", factor_passes=10.0)


def _pallas_block_bytes(m, n, k, cfg, algo):
    """Per-iteration model for the slot scheduler's block kernels: A
    streams per iteration while the factors stay resident for the whole
    launch, so the W/H round-trip amortizes over the ``check_every ×
    check_block`` in-launch iterations. The phased kernels read A twice
    per iteration; the join-the-updates mu kernel
    (``experimental.fused_updates="fused"``) reads it T+1 times in a
    T-iteration launch. Per lane: a pooled launch is charged these reads
    once for every lane of its pool."""
    cfg_ce = (getattr(cfg, "check_every", _DEFAULT_CHECK_EVERY)
              if cfg is not None else _DEFAULT_CHECK_EVERY)
    cb = (getattr(cfg, "check_block", "auto")
          if cfg is not None else "auto")
    if cb == "auto":
        cb = _DEFAULT_PALLAS_CHECK_BLOCK
    launch_iters = max(cfg_ce * int(cb), 1)
    s = _itemsize(cfg)
    sa = _a_itemsize(cfg, "pallas", algo)
    fused = (algo == "mu" and cfg is not None
             and getattr(getattr(cfg, "experimental", None),
                         "fused_updates", "auto") == "fused")
    a_passes = (launch_iters + 1.0) / launch_iters if fused else 2.0
    return (a_passes * m * n * sa
            + 2.0 * (m * k + k * n) * s / launch_iters)


def _pallas_mu_bytes(m, n, k, cfg=None, family="pallas"):
    """The mu block kernels (phased or fused per
    ``experimental.fused_updates``)."""
    return _pallas_block_bytes(m, n, k, cfg, "mu")


def _pallas_hals_bytes(m, n, k, cfg=None, family="pallas"):
    """The hals block kernel: A streams twice per iteration, the
    coordinate sweeps touch only the resident work tiles, so the byte
    shape matches the phased mu kernel's."""
    return _pallas_block_bytes(m, n, k, cfg, "hals")


def _tiled_bytes_common(m, n, k, cfg, factor_passes):
    """The tiled byte model (the reference's): one pass over A an
    iteration — m×n values for a dense source, or the stored payload
    d·mn·(itemsize + 8) for a sparse one (a value and a (row, col) int32
    pair per nonzero) — plus the factor-sized passes."""
    s = _itemsize(cfg)
    d = _sparse_density
    if d < 1.0:
        a_bytes = d * m * n * (s + 8.0)
    else:
        a_bytes = m * n * s
    return a_bytes + factor_passes * (m * k + k * n) * s


def _tiled_mu_bytes(m, n, k, cfg=None, family="tiled"):
    return _tiled_bytes_common(m, n, k, cfg, 8.0)


def _tiled_hals_bytes(m, n, k, cfg=None, family="tiled"):
    # the k coordinate passes re-touch the updating factor, as in the
    # in-core hals model
    return _tiled_bytes_common(m, n, k, cfg, 8.0 + 5.0 * k)


def _sketched_bytes(m, n, k, cfg=None, family="sketched"):
    """Per compressed iteration: L·A (r×n), A·R (m×r) and the
    projections L (r×m), R (n×r) read once each (no m × n traffic),
    plus ~10 factor-sized passes (the Nesterov extrapolation reads the
    current and the previous accepted iterates)."""
    from nmfx_torch.solvers.sketched import resolve_dim

    cfg = _resolve_cfg(cfg)
    r = resolve_dim(cfg, int(m), int(n), int(k))
    s = _itemsize(cfg)
    return (2.0 * r * (m + n) * s + 10.0 * (m * k + k * n) * s)


#: THE coverage declaration: one literal entry per routed (algorithm,
#: engine-family) pair. Spelled out rather than generated from the
#: routing tables — a generated table would vacuously "cover" any new
#: engine, which is exactly the drift the coverage check exists to catch.
_FLOPS = {
    ("mu", "vmap"): _mu_flops,
    ("mu", "packed"): _mu_flops,
    ("mu", "pallas"): _mu_flops,
    ("mu", "sketched"): _sketched_flops,
    ("mu", "tiled"): _tiled_flops,
    ("hals", "vmap"): _hals_flops,
    ("hals", "packed"): _hals_flops,
    ("hals", "pallas"): _hals_flops,
    ("hals", "sketched"): _sketched_flops,
    ("hals", "tiled"): _tiled_flops,
    ("kl", "vmap"): _kl_flops,
    ("kl", "packed"): _kl_flops,
    ("als", "vmap"): _als_flops,
    ("als", "packed"): _als_flops,
    ("neals", "vmap"): _neals_flops,
    ("neals", "packed"): _neals_flops,
    ("snmf", "vmap"): _snmf_flops,
    ("snmf", "packed"): _snmf_flops,
}

_BYTES = {
    ("mu", "vmap"): _mu_bytes,
    ("mu", "packed"): _mu_bytes,
    ("mu", "pallas"): _pallas_mu_bytes,
    ("mu", "sketched"): _sketched_bytes,
    ("mu", "tiled"): _tiled_mu_bytes,
    ("hals", "vmap"): _hals_bytes,
    ("hals", "packed"): _hals_bytes,
    ("hals", "pallas"): _pallas_hals_bytes,
    ("hals", "sketched"): _sketched_bytes,
    ("hals", "tiled"): _tiled_hals_bytes,
    ("kl", "vmap"): _kl_bytes,
    ("kl", "packed"): _kl_bytes,
    ("als", "vmap"): _als_bytes,
    ("als", "packed"): _als_bytes,
    ("neals", "vmap"): _neals_bytes,
    ("neals", "packed"): _neals_bytes,
    ("snmf", "vmap"): _snmf_bytes,
    ("snmf", "packed"): _snmf_bytes,
}

assert set(_FLOPS) == set(_BYTES), \
    "every modeled engine needs BOTH a FLOPs and a bytes model"


def covered_engines() -> "frozenset[tuple[str, str]]":
    """The (algorithm, family) pairs the model table covers."""
    return frozenset(_FLOPS)


def engine_universe() -> "frozenset[tuple[str, str]]":
    """Every (algorithm, engine-family) pair a SolverConfig can execute
    on the port, derived from its routing declarations — the solver
    registry (``nmfx_torch.solvers.SOLVERS``), the packed, sketched
    and tiled algorithm tuples (``config.PACKED_ALGORITHMS``,
    ``SKETCHED_ALGORITHMS``, ``TILED_ALGORITHMS``) and the
    slot-scheduler backend table (``sweep._GRID_EXEC_BACKENDS``, whose
    'pallas' entries mark the kernel-capable algorithms) — minus
    :data:`COSTMODEL_EXEMPT`."""
    from nmfx_torch.config import (PACKED_ALGORITHMS, SKETCHED_ALGORITHMS,
                                   TILED_ALGORITHMS)
    from nmfx_torch.solvers import SOLVERS
    from nmfx_torch.sweep import _GRID_EXEC_BACKENDS

    pairs = set()
    for algo in SOLVERS:
        if algo in COSTMODEL_EXEMPT:
            continue
        pairs.add((algo, "vmap"))
        if algo in PACKED_ALGORITHMS:
            pairs.add((algo, "packed"))
        if "pallas" in _GRID_EXEC_BACKENDS.get(algo, ()):
            pairs.add((algo, "pallas"))
        if algo in SKETCHED_ALGORITHMS:
            pairs.add((algo, "sketched"))
        if algo in TILED_ALGORITHMS:
            pairs.add((algo, "tiled"))
    return frozenset(pairs)


def check_costmodel_coverage(
    universe: "frozenset[tuple[str, str]]",
    covered: "frozenset[tuple[str, str]]",
    exempt: "tuple[str, ...]",
    algorithms: "frozenset[str]",
) -> "list[str]":
    """The pure coverage contract check (tests inject mutated
    universes): routed engine families and cost-model coverage must
    match exactly, and the exemption list must stay honest."""
    problems: "list[str]" = []
    for algo, family in sorted(universe - covered):
        problems.append(
            f"engine ({algo!r}, {family!r}) is reachable from the "
            "routing tables but has no cost model in "
            "nmfx_torch.obs.costmodel — its dispatches would report no "
            "FLOPs/bytes (mfu: None, no roofline verdict); add "
            "_FLOPS/_BYTES entries (or a COSTMODEL_EXEMPT rationale)")
    for algo, family in sorted(covered - universe):
        problems.append(
            f"nmfx_torch.obs.costmodel models ({algo!r}, {family!r}), "
            "which no routing table can reach — stale entry; a renamed "
            "or removed engine would keep 'covered' status while its "
            "replacement ships unmodeled")
    for algo in sorted(set(exempt) & {a for a, _ in covered}):
        problems.append(
            f"algorithm {algo!r} is declared COSTMODEL_EXEMPT but has "
            "model entries — the exemption rationale no longer holds "
            "or the entries are wrong; keep exactly one of the two")
    for algo in sorted(set(exempt) - set(algorithms)):
        problems.append(
            f"COSTMODEL_EXEMPT names {algo!r}, which is not a "
            "registered solver algorithm — stale exemption")
    return problems


def iteration_flops(algorithm: str, family: str, m: int, n: int, k: int,
                    cfg=None) -> "float | None":
    """Model FLOPs of ONE iteration of ONE lane, or None for engines
    outside the model table (the exempt algorithms)."""
    fn = _FLOPS.get((algorithm, family))
    return None if fn is None else float(fn(m, n, k, cfg))


def iteration_bytes(algorithm: str, family: str, m: int, n: int, k: int,
                    cfg=None) -> "float | None":
    """Model bytes moved by ONE iteration of ONE lane (see the byte model
    notes above), or None for unmodeled engines."""
    fn = _BYTES.get((algorithm, family))
    if fn is None:
        return None
    return float(fn(m, n, k, cfg, family))


def dispatch_cost(scfg, m: int, n: int,
                  iters_by_k: dict, mesh=None) -> "dict | None":
    """Total model FLOPs/bytes of one dispatch: Σ_k Σ_lane iterations ×
    per-iteration model, under the engine family ``scfg`` resolves to
    (``sweep.resolve_engine_family``). ``iters_by_k`` maps rank ->
    per-lane iteration counts (host ints/arrays). Returns
    ``{"flops", "bytes", "family", "arithmetic_intensity"}`` or None for
    unmodeled engines. A restart ``mesh`` keeps the family (grid axes are
    refused by ``resolve_engine_family``)."""
    from nmfx_torch.sweep import resolve_engine_family

    family = resolve_engine_family(scfg, mesh)
    flops = bytes_ = 0.0
    for k, iters in iters_by_k.items():
        fi = iteration_flops(scfg.algorithm, family, m, n, k, scfg)
        bi = iteration_bytes(scfg.algorithm, family, m, n, k, scfg)
        if fi is None or bi is None:
            return None
        total_iters = float(sum(int(i) for i in iters))
        flops += fi * total_iters
        bytes_ += bi * total_iters
    return {"flops": flops, "bytes": bytes_, "family": family,
            "arithmetic_intensity": (flops / bytes_ if bytes_ > 0
                                     else None)}


# --------------------------------------------------------------------------
# device peak table
# --------------------------------------------------------------------------

#: per-device peaks, keyed by the name ``torch.cuda.get_device_name``
#: gives: dense bf16 matmul FLOP/s (the MFU denominator, the reference's
#: definition) and memory bandwidth in bytes/s (the roofline's other
#: axis). The H100 row is NVIDIA's H100 SXM data sheet: 989 TFLOP/s
#: dense bf16 tensor-core peak, 3.35 TB/s HBM3, both at the full 700 W
#: power limit. Extend/override at runtime with :func:`set_device_peak`.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}

_peaks_lock = threading.Lock()


def set_device_peak(kind: str, flops: float,
                    hbm_bytes_per_s: float) -> None:
    """Override/extend the peak table for a device kind."""
    if flops <= 0 or hbm_bytes_per_s <= 0:
        raise ValueError("peaks must be positive")
    with _peaks_lock:
        DEVICE_PEAKS[kind] = {"flops": float(flops),
                              "hbm_bytes_per_s": float(hbm_bytes_per_s)}


def device_kind(device) -> str:
    """The peak table's key for a torch device: the card's name for a
    CUDA device, the device type ("cpu") otherwise."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        index = (dev.index if dev.index is not None
                 else torch.cuda.current_device())
        return torch.cuda.get_device_name(index)
    return dev.type


def device_peak(kind: "str | None" = None, *,
                device=None) -> "dict | None":
    """Peak record for ``kind``, or for the kind of ``device`` (a torch
    device or its name), or None when the kind is not in the table or
    neither is given — there is no process-wide default device."""
    if kind is None:
        if device is None:
            return None
        kind = device_kind(device)
    with _peaks_lock:
        rec = DEVICE_PEAKS.get(kind)
    return None if rec is None else {**rec, "kind": kind}


# --------------------------------------------------------------------------
# per-dispatch attribution
# --------------------------------------------------------------------------

#: attribution histograms, the reference's names and buckets: MFU lives
#: in [0, 1]; achieved FLOP/s spans CPUs (~1e9) through large devices
#: (~1e15); arithmetic intensity spans bandwidth-bound small k (~1)
#: through compute-dense engines (~1e3)
_mfu_hist = _metrics.histogram(
    "nmfx_perf_mfu",
    "model-FLOP utilization per dispatch vs the device-kind peak",
    labelnames=("kind",),
    buckets=(0.01, 0.02, 0.05, 0.08, 0.12, 0.16, 0.2, 0.25, 0.35, 0.5,
             0.75, 1.0))
_flops_hist = _metrics.histogram(
    "nmfx_perf_achieved_flops",
    "achieved model FLOP/s per dispatch (model FLOPs / solve wall)",
    labelnames=("kind",),
    buckets=(1e9, 1e10, 1e11, 5e11, 1e12, 5e12, 1e13, 5e13, 1e14,
             5e14, 1e15))
_ai_hist = _metrics.histogram(
    "nmfx_perf_arithmetic_intensity",
    "model arithmetic intensity (FLOPs / HBM bytes) per dispatch",
    labelnames=("kind",),
    buckets=(0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
             512.0, 1024.0))

_attrib_enabled = True
_agg_lock = threading.Lock()
#: per-dispatch-kind aggregates behind perf_report()/perf_summary()
_agg: "dict[str, dict]" = {}
#: the device kind each dispatch kind last ran on, and the latest one
#: overall (perf_summary's headline peak)
_agg_device: "dict[str, str | None]" = {}
_last_device_kind: "str | None" = None
#: bounded ring of recent attribution records (postmortem/report tail)
_recent: "deque[dict]" = deque(maxlen=256)


def enable_attribution() -> None:
    """Turn per-dispatch attribution on (the default). The cost while
    enabled is host-side model arithmetic on iteration counts that are
    already on the host (or already being fetched) at every call site."""
    global _attrib_enabled
    _attrib_enabled = True


def disable_attribution() -> None:
    global _attrib_enabled
    _attrib_enabled = False


def attribution_enabled() -> bool:
    return _attrib_enabled


def reset_perf() -> None:
    """Drop the report aggregates. The registry histograms are monotonic
    and stay — windowed reads go through ``MetricsRegistry.delta``."""
    global _last_device_kind
    with _agg_lock:
        _agg.clear()
        _agg_device.clear()
        _last_device_kind = None
        _recent.clear()


def attribute_dispatch(kind: str, scfg, m: int, n: int,
                       iters_by_k: dict, solve_s: float,
                       device=None, mesh=None) -> "dict | None":
    """Attribute ONE dispatch: model FLOPs/bytes from the per-lane
    iteration counts, achieved FLOP/s over the measured ``solve_s``, MFU
    and bandwidth fraction against the peak of ``device`` (the device A
    was placed on), and the roofline verdict. Records the ``nmfx_perf_*``
    histograms (labeled by dispatch ``kind``) and feeds the report
    aggregates; returns the record (None when disabled, unmodeled, or
    unmeasurable).

    Call sites pass a wall that covers the device solve they measured
    and iteration counts that are already host-resident — attribution
    itself never forces a device sync. Over a ``mesh`` the peak is
    scaled by the mesh's DISTINCT devices of this process: two restart
    shards on one card are priced as that one card."""
    global _last_device_kind
    if not _attrib_enabled or solve_s is None or solve_s <= 0.0:
        return None
    cost = dispatch_cost(scfg, m, n, iters_by_k, mesh)
    if cost is None:
        return None
    achieved = cost["flops"] / solve_s
    ai = cost["arithmetic_intensity"]
    dev_kind = None if device is None else device_kind(device)
    peak = device_peak(dev_kind)
    mfu = bw_frac = ridge = None
    devices = 1 if mesh is None else len(mesh.distinct_devices())
    if peak is not None:
        mfu = achieved / (peak["flops"] * devices)
        bw_frac = (cost["bytes"] / solve_s
                   / (peak["hbm_bytes_per_s"] * devices))
        ridge = peak["flops"] / peak["hbm_bytes_per_s"]
    rec = {
        "kind": kind,
        "algorithm": scfg.algorithm,
        "family": cost["family"],
        "shape": [int(m), int(n)],
        "model_flops": cost["flops"],
        "model_bytes": cost["bytes"],
        "solve_s": float(solve_s),
        "achieved_flops_per_s": achieved,
        "arithmetic_intensity": ai,
        "mfu": mfu,
        "hbm_bw_fraction": bw_frac,
        "verdict": _verdict(ai, ridge, mfu, bw_frac),
        "device_peak": peak,
    }
    _flops_hist.observe(achieved, kind=kind)
    if ai is not None:
        _ai_hist.observe(ai, kind=kind)
    if mfu is not None:
        _mfu_hist.observe(mfu, kind=kind)
    with _agg_lock:
        agg = _agg.setdefault(kind, {
            "dispatches": 0, "flops": 0.0, "bytes": 0.0, "seconds": 0.0,
            "algorithm": scfg.algorithm, "family": cost["family"]})
        agg["dispatches"] += 1
        agg["flops"] += cost["flops"]
        agg["bytes"] += cost["bytes"]
        agg["seconds"] += float(solve_s)
        _agg_device[kind] = dev_kind
        _last_device_kind = dev_kind
        _recent.append(rec)
    return rec


def _verdict(ai, ridge, mfu, bw_frac) -> str:
    """The roofline verdict string: which wall the dispatch sits under,
    and how far up it reaches."""
    if ai is None:
        return "no byte model"
    if ridge is None:
        return (f"unknown device peak (AI {ai:.1f} FLOP/B; "
                "set_device_peak() to get a verdict)")
    if ai >= ridge:
        return (f"compute-bound (AI {ai:.1f} >= ridge {ridge:.1f} "
                f"FLOP/B) at {mfu:.2f} MFU")
    return (f"bandwidth-bound (AI {ai:.1f} < ridge {ridge:.1f} "
            f"FLOP/B) at {bw_frac:.2f} of peak HBM BW")


def recent_attributions(limit: "int | None" = None) -> "list[dict]":
    """The most recent per-dispatch attribution records (bounded ring of
    256, oldest first): each carries the shape, engine family, model
    FLOPs/bytes, measured wall, MFU/AI and the roofline verdict of ONE
    dispatch."""
    with _agg_lock:
        recs = list(_recent)
    return recs if limit is None else recs[-limit:]


def perf_summary() -> dict:
    """Aggregated attribution per dispatch kind, each against the peak
    of the device it last ran on; ``device_peak`` is the peak of the
    latest attributed dispatch's device."""
    with _agg_lock:
        items = [(kind, dict(agg), _agg_device.get(kind))
                 for kind, agg in _agg.items()]
        last = _last_device_kind
    peak = device_peak(last)
    ridge = (peak["flops"] / peak["hbm_bytes_per_s"]
             if peak is not None else None)
    out = {"device_peak": peak, "ridge_flops_per_byte": ridge,
           "kinds": {}}
    for kind, agg, dev_kind in items:
        kpeak = device_peak(dev_kind)
        kridge = (kpeak["flops"] / kpeak["hbm_bytes_per_s"]
                  if kpeak is not None else None)
        secs = agg["seconds"]
        achieved = agg["flops"] / secs if secs > 0 else None
        ai = agg["flops"] / agg["bytes"] if agg["bytes"] > 0 else None
        mfu = (agg["flops"] / (kpeak["flops"] * secs)
               if secs > 0 and kpeak is not None else None)
        bw = (agg["bytes"] / secs / kpeak["hbm_bytes_per_s"]
              if secs > 0 and kpeak is not None else None)
        out["kinds"][kind] = {
            **agg,
            "achieved_flops_per_s": achieved,
            "arithmetic_intensity": ai,
            "mfu": mfu,
            "hbm_bw_fraction": bw,
            "verdict": _verdict(ai, kridge, mfu, bw),
        }
    return out


def perf_report() -> str:
    """Human-readable roofline table over every attributed dispatch
    kind — appended to ``Profiler.report()``."""
    summary = perf_summary()
    if not summary["kinds"]:
        return ("perf attribution: no attributed dispatches "
                "(attribution disabled, or no modeled engine ran)")
    peak = summary["device_peak"]
    lines = []
    if peak is not None:
        lines.append(
            f"perf attribution — device {peak['kind']!r}: peak "
            f"{peak['flops'] / 1e12:.4g} TFLOP/s, "
            f"{peak['hbm_bytes_per_s'] / 1e9:.4g} GB/s HBM, ridge "
            f"{summary['ridge_flops_per_byte']:.4g} FLOP/B")
    else:
        lines.append(
            "perf attribution — device peak unknown "
            "(nmfx_torch.obs.costmodel.set_device_peak() enables "
            "MFU/roofline verdicts)")
    lines.append(f"{'kind':<16}{'disp':>5}{'model GFLOP':>13}"
                 f"{'GB moved':>10}{'AI':>7}{'GFLOP/s':>9}{'MFU':>7}"
                 "  verdict")
    for kind in sorted(summary["kinds"]):
        rec = summary["kinds"][kind]
        mfu = "-" if rec["mfu"] is None else f"{rec['mfu']:.3f}"
        ai = ("-" if rec["arithmetic_intensity"] is None
              else f"{rec['arithmetic_intensity']:.1f}")
        ach = ("-" if rec["achieved_flops_per_s"] is None
               else f"{rec['achieved_flops_per_s'] / 1e9:.1f}")
        lines.append(
            f"{kind:<16}{rec['dispatches']:>5}"
            f"{rec['flops'] / 1e9:>13.2f}{rec['bytes'] / 1e9:>10.2f}"
            f"{ai:>7}{ach:>9}{mfu:>7}  {rec['verdict']}")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# communication model (the reference's ``comm_model``, pure arithmetic)
# --------------------------------------------------------------------------

#: per-algorithm collective schedule of the grid-sharded update program:
#: allreduces per tiled axis per iteration, their payload in elements
#: (k, the other axis' local extent d, local lanes r), and the numeric
#: guard's i32 lane flags where the update has one
_COMM = {
    "kl": dict(ops_per_axis=2,
               payload=lambda k, d, r: r * (k * d + k),
               guard=None),
    "neals": dict(ops_per_axis=2,
                  payload=lambda k, d, r: r * (k * d + k * k),
                  guard=None),
    "snmf": dict(ops_per_axis=2,
                 payload=lambda k, d, r: r * (k * d + k * k),
                 guard=None),
    "hals": dict(ops_per_axis=2,
                 payload=lambda k, d, r: r * (k * d + k * k),
                 guard=None),
    "mu": dict(ops_per_axis=3,
               payload=lambda k, d, r: r * k * d + (r * k) ** 2,
               guard=lambda r: r),
}


def comm_covered_algorithms() -> frozenset:
    """Algorithms with a communication model (the grid-sharded driver's);
    every other algorithm is restart-parallel only."""
    return frozenset(_COMM)


def _ring_wire_bytes(payload_bytes: float, p: int) -> float:
    """Bytes a p-participant ring allreduce moves per participant:
    2(p-1)/p × payload."""
    if p <= 1:
        return 0.0
    return 2.0 * (p - 1) / p * payload_bytes


def comm_model(algorithm: str, m: int, n: int, k: int, *,
               restart_shards: int = 1, feature_shards: int = 1,
               sample_shards: int = 1, restarts: "int | None" = None,
               itemsize: int = 4) -> dict:
    """Per-iteration collective schedule of one meshed factorization, as
    the reference models it: ``collectives_per_iter`` (0 on a
    restart-only mesh: no lane talks to another while it iterates),
    ``payload_bytes_per_iter``, ``wire_bytes_per_iter`` (ring
    convention), a ``per_axis`` breakdown and the ``epilogue`` (the
    per-rank consensus reduction over the restart axis, once a solve).
    The grid axes' terms describe the port's own grid-sharded program
    (``sweep._build_grid_sharded_sweep_fn`` on
    ``nmfx_torch/collectives.py``): in one iteration off a check, kl,
    neals, snmf and hals sum two products over each tiled axis, and mu
    sums two and ors the numeric guard's lane flags (the collective
    layer's count is held to ``collectives_per_iter``). The port's
    collectives gather every shard's part to each shard and add them in
    shard order, so the ring convention's wire bytes are a model of the
    payload, not of the bytes gloo moves; check iterations add the
    label-mismatch sum and the max-change maxima, which this model does
    not price. The port's restart axis gathers each shard's per-restart
    outputs instead of reducing a consensus matrix, which it does not
    price either."""
    if algorithm not in _COMM:
        raise ValueError(
            f"no communication model for algorithm {algorithm!r} — the "
            "grid-sharded driver accepts "
            f"{sorted(_COMM)} (everything else is restart-parallel "
            "only); add a _COMM entry with the new schedule")
    for name, v in (("restart_shards", restart_shards),
                    ("feature_shards", feature_shards),
                    ("sample_shards", sample_shards)):
        if v < 1:
            raise ValueError(f"{name} must be >= 1, got {v}")
    ent = _COMM[algorithm]
    r_total = restart_shards if restarts is None else restarts
    r_loc = -(-r_total // restart_shards)
    m_loc = -(-m // feature_shards)
    n_loc = -(-n // sample_shards)
    per_axis = {}
    total_ops = 0
    total_payload = 0.0
    total_wire = 0.0
    for axis, p, dim_loc in (("features", feature_shards, n_loc),
                             ("samples", sample_shards, m_loc)):
        if p <= 1:
            continue
        payload = ent["payload"](k, dim_loc, r_loc) * itemsize
        ops = ent["ops_per_axis"]
        if ent["guard"] is not None:
            payload += ent["guard"](r_loc) * 4  # i32 lane flags
        wire = _ring_wire_bytes(payload, p)
        per_axis[axis] = dict(collectives=ops, payload_bytes=payload,
                              wire_bytes=wire, participants=p)
        total_ops += ops
        total_payload += payload
        total_wire += wire
    n_pad = n_loc * sample_shards
    epi_payload = (float(n_pad) * n_pad + 1) * itemsize \
        if restart_shards > 1 else 0.0
    epilogue = dict(
        collectives=2 if restart_shards > 1 else 0,
        payload_bytes=epi_payload,
        wire_bytes=_ring_wire_bytes(epi_payload, restart_shards))
    return dict(algorithm=algorithm,
                mesh_shape=(restart_shards, feature_shards,
                            sample_shards),
                r_loc=r_loc,
                collectives_per_iter=total_ops,
                payload_bytes_per_iter=total_payload,
                wire_bytes_per_iter=total_wire,
                per_axis=per_axis,
                epilogue=epilogue)
