"""NMFX015 — thread lifecycle: daemonize or provably join (counterpart
of ``nmfx/analysis/concurrency/rules_threads.py``).

Failure class: the drained-replica phantom heartbeat — a non-daemon
helper thread that outlives its owner keeps a "drained" replica looking
alive, and keeps the interpreter alive at shutdown.

The contract: every ``threading.Thread`` / ``threading.Timer``
constructed in the tree is either

* daemonized at construction (``daemon=True``) or via an explicit
  ``t.daemon = True`` before ``start()``, or
* provably joined/cancelled on its owner's close path: stored into an
  instance attribute the class somewhere ``join()``s (or
  ``cancel()``s, for Timers), including container attributes drained
  by a ``for t in self._threads: t.join()`` loop, or joined locally in
  the creating function (a run-and-wait helper).

A thread that is neither is an unowned lifetime: nothing bounds it,
nothing observes its death, and process exit blocks on it.
"""

from __future__ import annotations

import ast
from typing import Iterable

from nmfx_torch.analysis.core import Finding, Rule, register
from nmfx_torch.analysis.ast_scan import Project, _attr_tail
from nmfx_torch.analysis.concurrency.model import (concurrency_model,
                                             _self_attr)


def _local_facts(fn: ast.AST, name: str) -> "dict":
    """What happens to local ``name`` in this function: daemonized,
    joined locally, or stored into a self attribute (directly or via
    ``self.<attr>.append(name)``)."""
    facts = {"daemon": False, "joined": False, "stored": None,
             "container": False}
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Attribute)):
            tgt = node.targets[0]
            if (isinstance(tgt.value, ast.Name)
                    and tgt.value.id == name
                    and tgt.attr == "daemon"
                    and isinstance(node.value, ast.Constant)
                    and node.value.value is True):
                facts["daemon"] = True
            attr = _self_attr(tgt)
            if (attr is not None and isinstance(node.value, ast.Name)
                    and node.value.id == name):
                facts["stored"] = attr
        if isinstance(node, ast.Call):
            tail = _attr_tail(node.func)
            if (tail in ("join", "cancel")
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == name):
                facts["joined"] = True
            if (tail == "append" and isinstance(node.func, ast.Attribute)
                    and any(isinstance(a, ast.Name) and a.id == name
                            for a in node.args)):
                attr = _self_attr(node.func.value)
                if attr is not None:
                    facts["stored"] = attr
                    facts["container"] = True
    return facts


@register
class ThreadLifecycleRule(Rule):
    rule_id = "NMFX015"
    title = "threads are daemonized or joined on the close path"

    def check(self, project: Project) -> "Iterable[Finding]":
        model = concurrency_model(project)
        for (mod_path, qual), mm in sorted(model.functions.items()):
            if not mm.threads:
                continue
            cls = None
            if "." in qual:
                cls = model.classes.get((mod_path, qual.split(".")[0]))
            for ts in mm.threads:
                if ts.daemon:
                    continue
                stored = ts.stored_attr
                facts = {"daemon": False, "joined": False,
                         "stored": stored, "container": False}
                if ts.name is not None:
                    f2 = _local_facts(mm.node, ts.name)
                    facts["daemon"] = f2["daemon"]
                    facts["joined"] = f2["joined"]
                    if f2["stored"] is not None:
                        facts["stored"] = f2["stored"]
                        facts["container"] = f2["container"]
                if facts["daemon"] or facts["joined"]:
                    continue
                if (facts["stored"] is not None and cls is not None
                        and facts["stored"] in cls.joined_attrs):
                    continue
                target = (f"self.{facts['stored']}"
                          if facts["stored"] else
                          (ts.name or "an unbound expression"))
                yield Finding(
                    file=mod_path, line=ts.line, rule_id=self.rule_id,
                    message=(f"{qual} starts a non-daemon "
                             f"{ts.kind} ({target}) that is never "
                             "joined"
                             + ("" if ts.kind == "Thread"
                                else "/cancelled")
                             + " on any close path — pass daemon=True "
                             "or join it where the owner shuts down"))
