"""The port's contract linter (counterpart of ``nmfx/analysis``).

Usage::

    python -m nmfx_torch.analysis nmfx_torch/            # lint the port
    python -m nmfx_torch.analysis nmfx_torch/ --json     # machine-readable
    python -m nmfx_torch.analysis nmfx_torch/ --baseline FILE

Rules (the reference's ids; each encodes one failure class):

=========  ==============================================================
NMFX001    config-key coverage: every config field reaches the registry
           fingerprint, the exec-cache bucket key and the autotune key,
           or is declared exempt
NMFX004    PRNG discipline: a threefry key (nmfx_torch.random) consumed
           by two draws with no split or fold_in between them; host RNG
           in the hot path or the key chain's draws
NMFX005    implicit host syncs in the hot path (ast_scan.HOT_ROOTS)
NMFX006    silent degradation: a broad except must re-raise, resolve a
           Future, or route through nmfx_torch.faults.warn_once
NMFX007    checkpoint-manifest coverage (nmfx_torch/checkpoint.py)
NMFX008    fault-site flight-recorder coverage (nmfx_torch/faults.py
           against nmfx_torch/obs/flight.py)
NMFX009    engine-family cost-model coverage (nmfx_torch/obs/costmodel.py)
NMFX010    registry metric naming and the metric table of
           docs/observability_torch.md
NMFX011    result-cache key coverage (nmfx_torch/result_cache.py)
NMFX012    guarded state: attributes declared through nmfx_torch.guards
           are only touched under their owning lock
NMFX013    lock order: the static lock-acquisition graph stays acyclic
           (cross-checked at run time by nmfx_torch/analysis/witness.py)
NMFX014    future-resolution completeness
NMFX015    thread lifecycle: every Thread/Timer is daemonized or joined
=========  ==============================================================

Not carried over: NMFX002 (environment reads at trace time), NMFX003
(read after donation) and NMFX101/102 (the jaxpr layer) — the port
traces nothing, donates nothing and has no jaxpr. NMFX004 and NMFX005
watch the hot path instead of traced code.

Suppress a finding inline with a required reason::

    risky()  # nmfx: ignore[NMFX006] -- best-effort cleanup
"""

from __future__ import annotations

from typing import Iterable

from nmfx_torch.analysis.core import (RULES, Finding, Rule, active,
                                      apply_baseline, load_baseline,
                                      parse_suppressions, register)
from nmfx_torch.analysis.ast_scan import Project, load_project

# registering imports: each module populates RULES at import time
from nmfx_torch.analysis import rules_config  # noqa: F401 (001/007/011)
from nmfx_torch.analysis import rules_handlers  # noqa: F401 (NMFX006)
from nmfx_torch.analysis import rules_hotpath  # noqa: F401 (NMFX004/005)
from nmfx_torch.analysis import rules_obs  # noqa: F401 (NMFX008/010)
from nmfx_torch.analysis import rules_perf  # noqa: F401 (NMFX009)
from nmfx_torch.analysis import concurrency  # noqa: F401 (NMFX012-015)

__all__ = ["run", "RULES", "Finding", "Rule", "register", "active",
           "Project", "load_project"]


def run(paths: "Iterable[str]", baseline: "str | None" = None,
        rule_ids: "Iterable[str] | None" = None) -> "list[Finding]":
    """Lint ``paths`` and return every finding, suppression- and
    baseline-annotated. ``active(findings)`` is what should gate a
    build; ``rule_ids`` restricts the run to a subset."""
    import dataclasses
    import os

    project = load_project(paths)
    findings: "list[Finding]" = []
    suppressions = {}
    for mod in project.modules:
        by_line, bad = parse_suppressions(mod.path, mod.text)
        # keyed by abspath so findings anchored through inspect (NMFX001)
        # still match the inline suppressions in the analyzed sources
        suppressions[os.path.abspath(mod.path)] = by_line
        findings.extend(bad)
    wanted = None if rule_ids is None else set(rule_ids)
    for rule_id, rule in RULES.items():
        if wanted is not None and rule_id not in wanted:
            continue
        findings.extend(rule.check(project))
    annotated = []
    for f in findings:
        ids = suppressions.get(os.path.abspath(f.file),
                               {}).get(f.line, set())
        annotated.append(dataclasses.replace(f, suppressed=True)
                         if f.rule_id in ids else f)
    annotated = apply_baseline(annotated, load_baseline(baseline))
    annotated.sort(key=lambda f: (f.file, f.line, f.rule_id))
    return annotated
