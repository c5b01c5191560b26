"""Bench-trajectory judge (``nmfx-torch-perf``; counterpart of
``nmfx/obs/regress.py``, whose ``nmfx-perf`` it mirrors).

It reads every ``BENCH_r<NN>.json`` in a directory (the wrapper form
``{"parsed": record}`` and bare records alike; an unreadable round
is skipped), extracts the same curated metric set through the same
schema-drift-tolerant paths, and judges the newest round (or
``--candidate``) against the best prior value of each metric under the
same per-metric relative thresholds (``--threshold-scale`` scales them
all). :func:`compare` returns the machine-readable verdict and
:func:`markdown_report` the metric × round trend table, so a trajectory
gets the same verdict and the same report from either package.

Exit codes of :func:`main`: 0 no regression, 2 a regression against the
best prior round, 1 no usable rounds (or an unreadable candidate).

Stdlib only, like the rest of ``nmfx_torch.obs``: it imports neither
torch nor the reference.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import NamedTuple

__all__ = ["METRICS", "MetricSpec", "compare", "extract_metrics",
           "load_rounds", "main", "markdown_report"]

_ROUND_RE = re.compile(r"BENCH_r(\d+)\.json$")


class MetricSpec(NamedTuple):
    """One tracked bench metric: where it lives across schema
    generations (``paths`` tried in order — dotted keys, with
    ``list[key=value]`` selectors for the serve ladder), which
    direction is better, and the relative change vs the best prior
    round that counts as a regression."""

    name: str
    paths: tuple
    direction: str  # "lower" | "higher"
    threshold: float  # relative regression threshold
    note: str = ""


#: the tracked trajectory: the reference's metrics, paths, directions
#: and thresholds, so both judges agree. Thresholds are sized to the metric's
#: observed cross-round noise under the min-of-reps protocol: warm
#: walls swing ~±20% between sessions even at their minima (r03-r05),
#: cold/compile walls more, MFU is a ratio of same-session numbers and
#: moves little. Serving-stack metrics (exec_cache/serve/durability/
#: obs) have no prior hardware rounds yet — they enter the trajectory
#: as "new" at r06 and gate from r07 on.
METRICS = (
    MetricSpec("consensus_sweep_wall_s", ("value",), "lower", 0.25,
               "headline warm wall (min of same-session reps)"),
    MetricSpec("consensus_e2e_wall_s",
               ("detail.consensus_e2e_wall_s",), "lower", 0.25,
               "warm wall incl. rank selection (r07+ protocol)"),
    MetricSpec("restarts_per_s", ("detail.restarts_per_s",), "higher",
               0.25),
    MetricSpec("cold_wall_s", ("detail.cold_wall_s",), "lower", 0.35,
               "from-nothing first-request wall (compile included)"),
    MetricSpec("compile_wall_s", ("detail.compile_wall_s",), "lower",
               0.40),
    MetricSpec("mfu", ("detail.mfu",), "higher", 0.15),
    MetricSpec("mfu_solve", ("detail.mfu_solve",), "higher", 0.15,
               "solve-phase utilization — the kernel-work steering "
               "metric"),
    MetricSpec("pallas_min_s", ("detail.backends.pallas.min_s",),
               "lower", 0.25),
    MetricSpec("pallas_mfu_solve",
               ("detail.backends.pallas.mfu_solve",), "higher", 0.15),
    # --- serving stack (first hardware numbers land at r06) ---------
    MetricSpec("exec_hit_dispatch_s",
               ("detail.exec_cache.hit_dispatch_s",), "lower", 0.35,
               "warm-bucket compile-free dispatch"),
    MetricSpec("exec_miss_compile_s",
               ("detail.exec_cache.miss_compile_s",), "lower", 0.50),
    MetricSpec("cold_persist_wall_s",
               ("detail.exec_cache.cold_persist_wall_s",), "lower",
               0.35, "fresh-process deserialize-and-dispatch wall"),
    MetricSpec("serve_p50_latency_s",
               ("detail.serve.ladder[offered_load=1.0].p50_latency_s",),
               "lower", 0.35),
    MetricSpec("serve_p99_latency_s",
               ("detail.serve.ladder[offered_load=1.0].p99_latency_s",),
               "lower", 0.50, "tail latency is the noisiest surface"),
    MetricSpec("serve_burst_goodput_req_per_s",
               ("detail.serve.ladder[offered_load=burst]"
                ".goodput_req_per_s",), "higher", 0.35),
    MetricSpec("serve_chaos_goodput_retention",
               ("detail.serve.chaos.goodput_retention",), "higher",
               0.25),
    # --- service tier (router + replica pool) -------------
    MetricSpec("fleet_router_p50_ratio",
               ("detail.serve.fleet.overhead.p50_ratio",), "lower",
               0.25,
               "router-vs-direct p50; the bench's own gate is the "
               "hard 1.05x (+50ms) bound, this tracks drift"),
    MetricSpec("fleet_goodput_3_replicas",
               ("detail.serve.fleet.scaling[replicas=3]"
                ".goodput_req_per_s",), "higher", 0.35),
    MetricSpec("fleet_chaos_goodput_req_per_s",
               ("detail.serve.fleet.chaos.goodput_req_per_s",),
               "higher", 0.35,
               "goodput with one of 3 replicas SIGKILLed mid-ladder"),
    MetricSpec("durability_resume_overhead_s",
               ("detail.durability.resume_overhead_s",), "lower", 0.50),
    MetricSpec("obs_overhead_frac", ("detail.obs.overhead_frac",),
               "lower", 1.0,
               "telemetry overhead; the bench's own gate is the hard "
               "3% bound, this only tracks drift round-over-round"),
    MetricSpec("sketched_flops_compression",
               ("detail.sketched.flops_compression_per_restart",),
               "higher", 0.20,
               "analytic, shape-derived — hardware-independent"),
    # --- request economics (cache/coalesce/extend) --------
    MetricSpec("econ_result_cache_hit_rate",
               ("detail.serve.economics.hit_rate",), "higher", 0.50,
               "mixed-arm hit fraction; the split between hits and "
               "coalesces is timing-dependent, so the threshold is "
               "loose — reuse_rate is the deterministic sum"),
    MetricSpec("econ_coalesce_rate",
               ("detail.serve.economics.coalesce_rate",), "higher",
               0.90,
               "mixed-arm coalesce fraction; see hit-rate note"),
    MetricSpec("econ_goodput_vs_cold",
               ("detail.serve.economics.goodput_vs_cold",), "higher",
               0.35,
               "warm-replay goodput over the cold-solve baseline; "
               "the bench's own gate is the hard 5x bound"),
    MetricSpec("econ_extend_speedup",
               ("detail.serve.economics.extend_speedup",), "higher",
               0.35,
               "from-scratch wall over incremental-extend wall at a "
               "2x-widened restart budget, bit-identity gated"),
    # --- mesh tier (multi-chip solves) --------------------
    # forced-CPU-device curves: host-dependent walls, loose thresholds;
    # the bench's own exit-2 gates (bit-identity, comm-vs-HLO,
    # placement correctness) are the hard contracts
    MetricSpec("mesh_strong_restarts_per_s_x4",
               ("detail.mesh.strong[shards=4].restarts_per_s",),
               "higher", 0.50,
               "fixed-total-restart throughput on a 4-shard restart "
               "mesh (pad lanes subtracted)"),
    MetricSpec("mesh_weak_restarts_per_s_x4",
               ("detail.mesh.weak[shards=4].restarts_per_s",),
               "higher", 0.50,
               "fixed-per-shard throughput on a 4-shard restart mesh"),
    MetricSpec("mesh_fleet_wall_s",
               ("detail.mesh.fleet.wall_s",), "lower", 0.50,
               "heterogeneous-fleet rung wall (2 atlas on the mesh "
               "class + 2 small on the 1-chip class)"),
    # --- atlas-scale solves (tiles + sparse ingestion) ----
    MetricSpec("atlas_tiled_restarts_per_s",
               ("detail.atlas.out_of_core.restarts_per_s",), "higher",
               0.35,
               "throughput of the larger-than-budget multi-tile rung "
               "(forced-small budget); hardware-host measurement"),
    MetricSpec("atlas_sparse_speedup_99",
               ("detail.atlas.sparse.density_99.speedup_vs_dense",),
               "higher", 0.50,
               "99%-sparse BCOO ingestion wall vs the densified twin; "
               "crossover is host-GEMM-dependent, threshold loose"),
    MetricSpec("atlas_resume_overhead_s",
               ("detail.atlas.resume.resume_overhead_s",), "lower",
               0.50,
               "mid-matrix kill/resume overhead of the tiled durable "
               "ledger; bit-identity gated by the bench itself"),
    # --- kernel schedule (fused kernels + autotune) -------
    MetricSpec("mfu_solve_pallas_fused",
               ("detail.kernel.fused_vs_phased.fused.mfu_solve",),
               "higher", 0.15,
               "solve-phase MFU of the fused join-the-updates mu "
               "kernel at the north-star shape — the ≥0.18 steering "
               "metric; its phased twin in the same record is "
               "bit-compat gated by the bench itself"),
    MetricSpec("autotune_warm_hit",
               ("detail.kernel.autotune.warm_hit",), "higher", 0.01,
               "1.0 iff the warm-process resolution came entirely "
               "from the persisted store (hits>0, searches==0 by the "
               "nmfx_autotune_* counter deltas) — a binary contract, "
               "any drop regresses"),
)


# --------------------------------------------------------------------------
# record loading / metric extraction
# --------------------------------------------------------------------------

def _resolve_path(obj, path: str):
    """Walk one dotted path; ``seg[key=value]`` selects the first
    element of a list whose ``key`` stringifies to ``value``. Returns
    None on any miss."""
    cur = obj
    # split on dots OUTSIDE bracket selectors only ("[offered_load=1.0]"
    # keeps its dot)
    for seg in re.split(r"\.(?![^\[\]]*\])", path):
        m = re.fullmatch(r"([^\[]+)\[([^=\]]+)=([^\]]+)\]", seg)
        sel = None
        if m:
            seg, sel = m.group(1), (m.group(2), m.group(3))
        if not isinstance(cur, dict) or seg not in cur:
            return None
        cur = cur[seg]
        if sel is not None:
            if not isinstance(cur, list):
                return None
            key, want = sel
            cur = next((e for e in cur
                        if isinstance(e, dict)
                        and str(e.get(key)) == want), None)
            if cur is None:
                return None
    return cur


def extract_metrics(record: dict) -> "dict[str, float]":
    """Normalize one bench record (wrapper or bare form) into the
    tracked metric set; metrics a round's schema predates are simply
    absent."""
    parsed = record.get("parsed", record)
    if not isinstance(parsed, dict):
        return {}
    out = {}
    for spec in METRICS:
        for path in spec.paths:
            val = _resolve_path(parsed, path)
            if isinstance(val, (int, float)) and not isinstance(val,
                                                                bool):
                out[spec.name] = float(val)
                break
    return out


def load_rounds(directory: str) -> "list[dict]":
    """Every readable ``BENCH_r*.json`` in ``directory`` as
    ``{"round", "file", "metrics"}``, sorted by round number;
    unreadable or non-record files are skipped (the ``_best_prior_
    record`` discipline — a corrupt round must not kill the judge)."""
    rounds = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return []
    for name in names:
        m = _ROUND_RE.fullmatch(name)
        if not m:
            continue
        path = os.path.join(directory, name)
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(rec, dict):
            continue
        metrics = extract_metrics(rec)
        if metrics:
            rounds.append({"round": int(m.group(1)), "file": name,
                           "metrics": metrics})
    rounds.sort(key=lambda r: r["round"])
    return rounds


# --------------------------------------------------------------------------
# comparison
# --------------------------------------------------------------------------

def compare(rounds: "list[dict]", candidate: "dict | None" = None,
            threshold_scale: float = 1.0) -> dict:
    """Judge ``candidate`` (default: the newest loaded round) against
    the BEST prior value of every tracked metric.

    Rules (the min-of-reps / relative-threshold protocol): the
    candidate's value is compared against the best over ALL prior
    rounds (min for lower-better, max for higher-better — the same
    best-ever bar ``vs_best`` uses, so one lucky round permanently
    raises it), the margin is relative to that bar, and a metric
    regresses when it is worse by more than ``threshold ×
    threshold_scale``. Metrics with no prior round report as ``new``;
    metrics the candidate lacks but priors had report as ``missing``
    (a stage that silently stopped producing numbers is itself a
    finding)."""
    if candidate is None:
        if not rounds:
            return {"status": "no-data", "regressions": [],
                    "improvements": [], "new": [], "missing": [],
                    "ok": [], "candidate": None}
        candidate, rounds = rounds[-1], rounds[:-1]
    cand_metrics = candidate["metrics"]
    verdict = {"candidate": {k: candidate[k]
                             for k in ("round", "file")
                             if k in candidate},
               "prior_rounds": [r["file"] for r in rounds],
               "regressions": [], "improvements": [], "ok": [],
               "new": [], "missing": []}
    for spec in METRICS:
        cand = cand_metrics.get(spec.name)
        priors = [(r["metrics"][spec.name], r["file"]) for r in rounds
                  if spec.name in r["metrics"]]
        if cand is None:
            if priors:
                verdict["missing"].append({
                    "metric": spec.name,
                    "note": "prior rounds recorded this metric but "
                            "the candidate does not"})
            continue
        if not priors:
            verdict["new"].append({"metric": spec.name, "value": cand})
            continue
        best, best_file = (min(priors) if spec.direction == "lower"
                           else max(priors))
        # the margin denominator gets an absolute floor so a zero (or
        # rounded-to-zero) bar neither makes the metric permanently
        # unjudgeable (rel forced to 0) nor explodes the margin: with
        # best == 0 any nonzero worse candidate is a maximal regression
        # and any equal-or-better one is clean — which is what a tiny
        # floor yields
        denom = max(abs(best), 1e-9)
        if spec.direction == "lower":
            rel = (cand - best) / denom
        else:
            rel = (best - cand) / denom
        entry = {"metric": spec.name, "value": cand, "best": best,
                 "best_round": best_file,
                 "worse_by": round(rel, 4),
                 "threshold": round(spec.threshold * threshold_scale,
                                    4),
                 "direction": spec.direction}
        if spec.note:
            entry["note"] = spec.note
        if rel > spec.threshold * threshold_scale:
            verdict["regressions"].append(entry)
        elif rel < 0:
            verdict["improvements"].append(entry)
        else:
            verdict["ok"].append(entry)
    verdict["status"] = ("regression" if verdict["regressions"]
                         else "ok")
    return verdict


# --------------------------------------------------------------------------
# reporting
# --------------------------------------------------------------------------

def markdown_report(rounds: "list[dict]",
                    verdict: "dict | None" = None) -> str:
    """Metric × round trend table plus the verdict summary, as
    markdown (written by ``nmfx-torch-perf --markdown``; its title is
    the reference's, so both packages render one report)."""
    lines = ["# nmfx bench trajectory", ""]
    if not rounds:
        lines.append("_no BENCH_r*.json rounds found_")
        return "\n".join(lines)
    names = [spec.name for spec in METRICS
             if any(spec.name in r["metrics"] for r in rounds)]
    header = "| metric | " + " | ".join(r["file"]
                                        .removeprefix("BENCH_")
                                        .removesuffix(".json")
                                        for r in rounds) + " |"
    lines.append(header)
    lines.append("|" + "---|" * (len(rounds) + 1))
    by_name = {spec.name: spec for spec in METRICS}
    for name in names:
        cells = []
        for r in rounds:
            v = r["metrics"].get(name)
            cells.append("-" if v is None else f"{v:g}")
        arrow = "↓" if by_name[name].direction == "lower" else "↑"
        lines.append(f"| {name} {arrow} | " + " | ".join(cells) + " |")
    lines.append("")
    if verdict is not None:
        lines.append(f"**Verdict: {verdict['status']}**")
        for kind, rows in (("Regressions", verdict["regressions"]),
                           ("Improvements", verdict["improvements"]),
                           ("New (no prior)", verdict["new"]),
                           ("Missing", verdict["missing"])):
            if not rows:
                continue
            lines.append("")
            lines.append(f"## {kind}")
            for row in rows:
                if "worse_by" in row:
                    lines.append(
                        f"- `{row['metric']}`: {row['value']:g} vs "
                        f"best {row['best']:g} ({row['best_round']}) — "
                        f"{'worse' if row['worse_by'] > 0 else 'better'}"
                        f" by {abs(row['worse_by']):.1%} "
                        f"(threshold {row['threshold']:.0%})")
                else:
                    lines.append(
                        f"- `{row['metric']}`"
                        + (f": {row['value']:g}" if "value" in row
                           else "")
                        + (f" — {row['note']}" if "note" in row
                           else ""))
    return "\n".join(lines)


def main(argv: "list[str] | None" = None) -> int:
    """``nmfx-torch-perf`` — judge the bench trajectory. Exit codes: 0 = no
    regression, 2 = regression vs the best prior round, 1 = no usable
    rounds."""
    p = argparse.ArgumentParser(
        prog="nmfx-torch-perf",
        description="Noise-aware BENCH_r*.json trajectory judge: "
                    "compares the newest (or --candidate) round's "
                    "tracked metrics against the best prior round "
                    "under per-metric relative thresholds; prints a "
                    "trend report and exits 2 on regression "
                    "(docs/observability.md 'Regression "
                    "observatory'; this is the PyTorch port's copy).")
    p.add_argument("--dir", default=None,
                   help="directory holding BENCH_r*.json (default: "
                        "the repo root this package sits in)")
    p.add_argument("--candidate", default=None, metavar="FILE",
                   help="judge this record (wrapper or bare JSON) "
                        "against ALL loaded rounds instead of "
                        "treating the newest round as the candidate")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="write the machine-readable verdict here "
                        "('-' = stdout)")
    p.add_argument("--markdown", default=None, metavar="PATH",
                   help="write the markdown trend report here")
    p.add_argument("--threshold-scale", type=float, default=1.0,
                   help="multiply every per-metric regression "
                        "threshold (default 1.0; e.g. 0.5 = stricter)")
    args = p.parse_args(argv)
    directory = args.dir
    if directory is None:
        directory = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    rounds = load_rounds(directory)
    candidate = None
    if args.candidate is not None:
        try:
            with open(args.candidate) as f:
                rec = json.load(f)
        except (OSError, ValueError) as e:
            print(f"nmfx-torch-perf: unreadable candidate {args.candidate}: "
                  f"{e}", file=sys.stderr)
            return 1
        candidate = {"file": os.path.basename(args.candidate),
                     "metrics": extract_metrics(rec)}
    if not rounds and candidate is None:
        print(f"nmfx-torch-perf: no BENCH_r*.json rounds under {directory}",
              file=sys.stderr)
        return 1
    verdict = compare(rounds, candidate,
                      threshold_scale=args.threshold_scale)
    trend_rounds = rounds + ([candidate] if candidate is not None
                             else [])
    report = markdown_report(trend_rounds, verdict)
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write(report + "\n")
    else:
        print(report)
    if args.json == "-":
        print(json.dumps(verdict))
    elif args.json:
        with open(args.json, "w") as f:
            json.dump(verdict, f, indent=1)
    if verdict["status"] == "regression":
        print(f"nmfx-torch-perf: REGRESSION — "
              f"{len(verdict['regressions'])} metric(s) worse than "
              "their best prior round beyond threshold",
              file=sys.stderr)
        return 2
    print(f"nmfx-torch-perf: {verdict['status']} "
          f"({len(verdict['improvements'])} improved, "
          f"{len(verdict['ok'])} within threshold, "
          f"{len(verdict['new'])} new)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
