"""NMFX008 — fault-site flight-recorder coverage; NMFX010 — registry
metric naming and metric-table coverage (counterparts of
``nmfx/analysis/rules_obs.py``).

NMFX008's failure class: a chaos rehearsal whose postmortem is silent
about its own injected failure. Fault fires reach the flight recorder
(``nmfx_torch/obs/flight.py``) through one mapping,
``flight.FAULT_EVENTS``: a site registered in ``nmfx_torch.faults.SITES``
but missing from it fires under a fallback category no query looks for,
and a mapping entry for an unregistered site is a stale declaration that
can mask a rename. The rule holds ``SITES`` against
``flight.fault_event_categories()`` through the pure
``check_fault_event_coverage``.

NMFX010's failure class: a metric namespace is mergeable and queryable
only while its names stay disciplined. The fleet collector merges
registries by name, dashboards and SLO objectives address series by
name, and a metric table is the operator's index of what exists. The
rule holds every live ``nmfx_*`` series of the port's registry to the
``nmfx_<subsystem>_<what>[_<unit>]`` scheme (counters end ``_total``,
nothing else does) and to the port's metric table,
``docs/observability_torch.md``, both ways, through the pure
``check_metric_naming``.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable

from nmfx_torch.analysis.core import Finding, Rule, register


def check_fault_event_coverage(
    sites: "frozenset[str]",
    event_covered: "frozenset[str]",
) -> "list[str]":
    """The pure contract check: every registered fault site must have
    a flight-recorder event category, and every mapped category must
    correspond to a registered site (no stale declarations). Tests
    inject mutated universes; the Rule wrapper reads the live
    modules."""
    problems: "list[str]" = []
    for name in sorted(sites - event_covered):
        problems.append(
            f"fault site {name!r} is registered in nmfx_torch.faults.SITES "
            "but has no flight-recorder event category "
            "(nmfx_torch.obs.flight.FAULT_EVENTS) — an armed fire of it "
            "would reach the postmortem only under an ad-hoc fallback "
            "category no query knows to look for; add the site to "
            "FAULT_EVENTS")
    for name in sorted(event_covered - sites):
        problems.append(
            f"nmfx_torch.obs.flight.FAULT_EVENTS maps {name!r}, which is "
            "not a registered fault site (nmfx_torch.faults.SITES) — stale "
            "declaration; a renamed site would fire uncovered while "
            "the mapping still claims the old name")
    return problems


def _sites_decl_line(tree: ast.Module) -> int:
    """Line of the module-level ``SITES = (...)`` assignment, best
    effort (findings anchor there — the declaration a new site lands
    on)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == "SITES":
                    return node.lineno
    return 1


def _live_universe() -> dict:
    from nmfx_torch import faults
    from nmfx_torch.obs import flight

    return dict(sites=frozenset(faults.SITES),
                event_covered=flight.fault_event_categories())


@register
class FaultFlightCoverage(Rule):
    """NMFX008: every fault site registered in nmfx_torch/faults.py has
    a flight-recorder event category (nmfx_torch.obs.flight.FAULT_EVENTS),
    and no mapping entry goes stale."""

    rule_id = "NMFX008"
    title = "fault-site flight-recorder coverage"

    def check(self, project) -> "Iterable[Finding]":
        # a whole-package rule: runs only when the real module is
        # analyzed, and only against the checkout the imports resolve
        import inspect
        import os

        analyzed = next(
            (m for m in project.modules
             if m.path.replace("\\", "/").endswith(
                 "nmfx_torch/faults.py")),
            None)
        if analyzed is None:
            return []
        from nmfx_torch import faults

        live_file = inspect.getsourcefile(faults) or analyzed.path
        if os.path.abspath(live_file) != os.path.abspath(analyzed.path):
            # NMFX001 already reports the wrong-tree condition loudly;
            # don't double-report it per rule
            return []
        line = _sites_decl_line(analyzed.tree)
        return [self.finding(analyzed.path, line, msg)
                for msg in check_fault_event_coverage(**_live_universe())]


# --------------------------------------------------------------------------
# NMFX010 — registry metric naming and metric-table coverage
# --------------------------------------------------------------------------

#: the naming scheme: nmfx_ + at least <subsystem>_<what>, lowercase
#: alphanumeric segments (Prometheus-clean)
_METRIC_NAME_RE = re.compile(r"nmfx(_[a-z][a-z0-9]*){2,}")

#: a metric-table row's first cell: | `nmfx_...{labels}` | ...
_DOC_ROW_RE = re.compile(r"^\s*\|\s*`(nmfx_[a-z0-9_]+)(?:\{[^}]*\})?`")

#: the port's metric table (the reference's docs/observability.md is its
#: own package's index and stays as it is)
DOC = "observability_torch.md"


def check_metric_naming(live: "dict[str, str]",
                        documented: "frozenset[str]") -> "list[str]":
    """The pure contract check: every live ``nmfx_*`` registry metric
    matches the naming scheme, carries the type-appropriate suffix
    (counters end ``_total``; nothing else may) and appears in the
    metric table; every documented name exists live. ``live`` maps name
    -> instrument kind."""
    problems: "list[str]" = []
    for name in sorted(live):
        kind = live[name]
        if not _METRIC_NAME_RE.fullmatch(name):
            problems.append(
                f"metric {name!r} breaks the naming scheme "
                "nmfx_<subsystem>_<what>[_<unit>] (lowercase "
                f"alphanumeric segments; docs/{DOC} "
                "'Metric naming') — the fleet collector and every "
                "dashboard/SLO query address series by name, so the "
                "scheme is the namespace contract")
        if kind == "counter" and not name.endswith("_total"):
            problems.append(
                f"counter {name!r} must end in '_total' (the "
                "Prometheus counter convention the naming scheme "
                "adopts)")
        elif kind != "counter" and name.endswith("_total"):
            problems.append(
                f"{kind} {name!r} ends in '_total', which declares a "
                "counter to every Prometheus consumer — rename it or "
                "make it a counter")
        if name not in documented:
            problems.append(
                f"metric {name!r} is live in the registry but missing "
                f"from the docs/{DOC} metric table — an "
                "undocumented series is invisible to operators; add a "
                "table row")
    for name in sorted(documented - live.keys()):
        problems.append(
            f"docs/{DOC} documents metric {name!r}, which "
            "is not live in the registry — stale row; a renamed "
            "metric would ship while the table still claims the old "
            "name")
    return problems


def _documented_metrics(doc_path: str) -> frozenset:
    """Metric names from a metric table's rows (first cell, backticked,
    optional ``{labels}`` suffix)."""
    names = set()
    with open(doc_path, encoding="utf-8") as f:
        for line in f:
            m = _DOC_ROW_RE.match(line)
            if m:
                names.add(m.group(1))
    return frozenset(names)


#: every module of the port that declares a registry instrument
#: (declarations are module-level, so importing is registering)
METRIC_MODULES = (
    "nmfx_torch.exec_cache", "nmfx_torch.data_cache", "nmfx_torch.serve",
    "nmfx_torch.checkpoint", "nmfx_torch.distributed", "nmfx_torch.router",
    "nmfx_torch.replica", "nmfx_torch.result_cache", "nmfx_torch.tiles",
    "nmfx_torch.sparse", "nmfx_torch.sweep", "nmfx_torch.autotune",
    "nmfx_torch.obs.costmodel", "nmfx_torch.obs.export",
    "nmfx_torch.obs.slo")


def _live_metrics() -> "dict[str, str]":
    """Name -> kind of every ``nmfx_``-namespaced metric on the port's
    live registry, every declaring module imported first. Foreign names
    (test fixtures register some in-process) are out of scope."""
    import importlib

    for mod in METRIC_MODULES:
        importlib.import_module(mod)
    from nmfx_torch.obs import metrics as obs_metrics

    snap = obs_metrics.registry().snapshot()
    return {name: rec["type"] for name, rec in snap.items()
            if name.startswith("nmfx_")}


@register
class MetricNamingCoverage(Rule):
    """NMFX010: every live ``nmfx_*`` registry metric matches the
    ``nmfx_<subsystem>_<what>[_<unit>]`` scheme (counters end
    ``_total``) and appears in docs/observability_torch.md's metric
    table; no documented name goes stale."""

    rule_id = "NMFX010"
    title = "registry metric naming + docs-table coverage"

    def check(self, project) -> "Iterable[Finding]":
        # a whole-package rule, gated like NMFX008
        import inspect
        import os

        analyzed = next(
            (m for m in project.modules
             if m.path.replace("\\", "/")
             .endswith("nmfx_torch/obs/metrics.py")),
            None)
        if analyzed is None:
            return []
        from nmfx_torch.obs import metrics as obs_metrics

        live_file = inspect.getsourcefile(obs_metrics) or analyzed.path
        if os.path.abspath(live_file) != os.path.abspath(analyzed.path):
            # NMFX001 reports the wrong-tree condition
            return []
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(analyzed.path))))
        doc_path = os.path.join(repo, "docs", DOC)
        if not os.path.isfile(doc_path):
            return [self.finding(
                analyzed.path, 1,
                f"docs/{DOC} (the metric table NMFX010 cross-references) "
                "does not exist next to this checkout — the metric "
                "namespace has no operator index")]
        return [self.finding(analyzed.path, 1, msg)
                for msg in check_metric_naming(
                    _live_metrics(), _documented_metrics(doc_path))]
