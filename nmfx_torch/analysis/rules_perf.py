"""NMFX009 — engine-family cost-model coverage (counterpart of
``nmfx/analysis/rules_perf.py``).

The failure class: an engine whose dispatches the cost model cannot see.
Every dispatch-attribution surface (``obs.costmodel.attribute_dispatch``,
the ``nmfx_perf_*`` series, ``Profiler.report()``'s roofline verdicts)
reads the model tables ``nmfx_torch.obs.costmodel._FLOPS`` / ``_BYTES``;
a new algorithm or engine-family routing (the port's "sketched" family
included) that lands without an entry reports ``mfu: None`` with no
error anywhere, and an entry for a removed engine is a stale declaration
that can mask a rename.

The rule cross-references the reachable engine universe of the live
routing tables (``costmodel.engine_universe()``) with the model tables'
coverage (``costmodel.covered_engines()``) and the ``COSTMODEL_EXEMPT``
honesty conditions, through the pure ``costmodel.check_costmodel_coverage``
(so tests inject changed universes); findings anchor at the ``_FLOPS``
declaration.
"""

from __future__ import annotations

import ast
from typing import Iterable

from nmfx_torch.analysis.core import Finding, Rule, register


def _flops_decl_line(tree: ast.Module) -> int:
    """Line of the module-level ``_FLOPS = {...}`` assignment, best
    effort (findings anchor there)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == "_FLOPS":
                    return node.lineno
    return 1


def _live_universe() -> dict:
    from nmfx_torch.obs import costmodel
    from nmfx_torch.solvers import SOLVERS

    return dict(universe=costmodel.engine_universe(),
                covered=costmodel.covered_engines(),
                exempt=tuple(costmodel.COSTMODEL_EXEMPT),
                algorithms=frozenset(SOLVERS))


@register
class CostModelCoverage(Rule):
    """NMFX009: every reachable (algorithm, engine-family) pair has a
    FLOPs and bytes model in nmfx_torch.obs.costmodel (or a
    COSTMODEL_EXEMPT rationale), and no entry goes stale."""

    rule_id = "NMFX009"
    title = "engine-family cost-model coverage"

    def check(self, project) -> "Iterable[Finding]":
        # a whole-package rule: runs only when the real module is
        # analyzed, and only against the checkout the imports resolve
        import inspect
        import os

        analyzed = next(
            (m for m in project.modules
             if m.path.replace("\\", "/").endswith(
                 "nmfx_torch/obs/costmodel.py")),
            None)
        if analyzed is None:
            return []
        from nmfx_torch.obs import costmodel

        live_file = inspect.getsourcefile(costmodel) or analyzed.path
        if os.path.abspath(live_file) != os.path.abspath(analyzed.path):
            # NMFX001 reports the wrong-tree condition
            return []
        line = _flops_decl_line(analyzed.tree)
        return [self.finding(analyzed.path, line, msg)
                for msg in costmodel.check_costmodel_coverage(
                    **_live_universe())]
