"""NMFX012 — guarded-state discipline (counterpart of
``nmfx/analysis/concurrency/rules_guarded.py``).

Failure class: a close()-vs-submit admission race, a spill-claim race —
shared mutable state of a threaded class touched outside its owning
lock. The locking discipline
used to live in comments ("guarded by _lock"); a comment cannot fail a
build. ``@guarded_by("_lock", "_queue", ...)`` (``nmfx_torch/guards.py``)
turns the comment into a declaration, and this rule turns every access
to a declared attribute outside a ``with self._lock`` scope into a
finding.

The analysis is statement-ordered and scope-aware through the shared
concurrency model: ``Condition(self._lock)`` aliases collapse onto the
underlying lock, ``l = self._lock`` local aliases are followed,
``acquire()``/``release()`` pairs extend the region linearly, a nested
``def`` (done-callbacks) resets the held set to nothing (it runs later
on an unknown thread), and a PRIVATE helper called exclusively from
lock-holding sites inherits the intersection of its callers' held sets
(the ``_expire_locked`` convention, checked instead of trusted).
``__init__`` is exempt: publication of ``self`` happens-after
construction. Module-level state declared via ``module_guarded()`` is
checked the same way against its module-level lock.
"""

from __future__ import annotations

from typing import Iterable

from nmfx_torch.analysis.core import Finding, Rule, register
from nmfx_torch.analysis.ast_scan import Project
from nmfx_torch.analysis.concurrency.model import concurrency_model


@register
class GuardedStateRule(Rule):
    rule_id = "NMFX012"
    title = "guarded attributes accessed only under their lock"

    def check(self, project: Project) -> "Iterable[Finding]":
        model = concurrency_model(project)
        for cm in model.classes.values():
            if not cm.guarded:
                continue
            # stale declarations: a guard lock that is never created is
            # a discipline the rule cannot check — loudly, not silently
            for lock_attr in sorted(set(cm.guarded.values())):
                if lock_attr not in cm.locks:
                    yield Finding(
                        file=cm.module.path, line=cm.node.lineno,
                        rule_id=self.rule_id,
                        message=(f"{cm.name} declares attributes "
                                 f"guarded by self.{lock_attr}, but no "
                                 f"method ever creates that lock "
                                 "(threading.Lock/RLock/Condition)"))
            for name in sorted(cm.methods):
                if name == "__init__":
                    continue
                mm = model.functions.get(
                    (cm.module.path, f"{cm.name}.{name}"))
                if mm is None:
                    continue
                for attr, line, held, nested in mm.accesses:
                    lock_attr = cm.guarded.get(attr)
                    key = cm.lock_key(lock_attr) if lock_attr else None
                    if key is None or key in held:
                        continue
                    where = (f"{cm.name}.{name}"
                             + (" (nested callback — locks held at the"
                                " definition site are NOT held when it"
                                " runs)" if nested else ""))
                    yield Finding(
                        file=cm.module.path, line=line,
                        rule_id=self.rule_id,
                        message=(f"self.{attr} is guarded by "
                                 f"self.{lock_attr} but accessed "
                                 f"without it in {where}"))
        for mod in project.modules:
            guarded = model.module_guarded.get(mod.path)
            if not guarded:
                continue
            locks = model.module_locks.get(mod.path, {})
            owner = {name: lock for lock, names in guarded.items()
                     for name in names}
            for lock in guarded:
                if lock not in locks:
                    yield Finding(
                        file=mod.path, line=1, rule_id=self.rule_id,
                        message=(f"module_guarded({lock!r}, ...) names "
                                 "a module-level lock that is never "
                                 "created"))
            for (path, qual), mm in sorted(model.functions.items()):
                if path != mod.path:
                    continue
                for name, line, held, nested in mm.global_accesses:
                    lock = owner[name]
                    li = locks.get(lock)
                    if li is None or li.key in held:
                        continue
                    yield Finding(
                        file=mod.path, line=line, rule_id=self.rule_id,
                        message=(f"module global {name} is guarded by "
                                 f"{lock} but accessed without it in "
                                 f"{qual}"))
