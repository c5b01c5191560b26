"""NMFX013 — static lock-order / deadlock-cycle detection (counterpart
of ``nmfx/analysis/concurrency/rules_lockorder.py``).

Failure class: a Future done-callback running on a thread that still
holds the scheduler lock calls into a path that takes a second lock,
while another thread takes the two in the opposite order; or a signal
handler re-enters ``FlightRecorder.record()`` on the same thread through
a non-reentrant lock (hence an RLock there, whose reentrancy this rule's
exemption encodes).

The shared concurrency model extracts the static lock-acquisition
graph: every nested ``with``/``acquire`` (with ``Condition`` aliasing
onto its underlying lock), plus edges through TYPED call-graph edges —
holding lock A while calling a method known to acquire lock B adds
A -> B. Findings:

* a cycle among distinct locks is a potential deadlock (two threads
  walking the cycle from different entry points);
* a self-edge on a NON-reentrant lock is a guaranteed self-deadlock
  (re-acquiring a held ``threading.Lock`` blocks forever); RLock and
  bare-``Condition`` self-edges are exempt — reentrancy is the point.

Resolution is deliberately under-approximate (no by-name fallback — a
false edge would invent deadlocks the code cannot execute); the
runtime witness (``nmfx_torch/analysis/witness.py``) records the orders the
threaded suites ACTUALLY exercise and a completeness test asserts the
static graph covers them.
"""

from __future__ import annotations

from typing import Iterable

from nmfx_torch.analysis.core import Finding, Rule, register
from nmfx_torch.analysis.ast_scan import Project
from nmfx_torch.analysis.concurrency.model import concurrency_model


def _cycles(graph: "dict[str, set]") -> "list[list[str]]":
    """Elementary cycles, one representative per strongly connected
    component (Tarjan, then a shortest closed walk from the smallest
    node) — enough to NAME the deadlock without enumerating every
    rotation of it."""
    index: "dict[str, int]" = {}
    low: "dict[str, int]" = {}
    on: "set[str]" = set()
    stack: "list[str]" = []
    sccs: "list[list[str]]" = []
    counter = [0]

    def strongconnect(v: str) -> None:
        # iterative Tarjan — the lock graph is small, but recursion
        # depth must not depend on it
        work = [(v, iter(sorted(graph.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(sorted(graph.get(w, ())))))
                    advanced = True
                    break
                elif w in on:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) > 1:
                    sccs.append(sorted(comp))

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)

    out = []
    for comp in sccs:
        members = set(comp)
        start = comp[0]
        # BFS for the shortest closed walk start -> ... -> start
        frontier = [[start]]
        found = None
        while frontier and found is None:
            nxt = []
            for path in frontier:
                for w in sorted(graph.get(path[-1], ())):
                    if w == start and len(path) > 1:
                        found = path
                        break
                    if w in members and w not in path:
                        nxt.append(path + [w])
                if found:
                    break
            frontier = nxt
        out.append((found or [start]) + [start])
    return out


@register
class LockOrderRule(Rule):
    rule_id = "NMFX013"
    title = "static lock-acquisition graph stays cycle-free"

    def check(self, project: Project) -> "Iterable[Finding]":
        model = concurrency_model(project)
        graph: "dict[str, set]" = {}
        for (a, b), (path, line) in sorted(model.order_edges.items()):
            if a == b:
                li = model.lock_index.get(a)
                if li is not None and not li.reentrant:
                    yield Finding(
                        file=path, line=line, rule_id=self.rule_id,
                        message=(f"non-reentrant lock {a} is acquired "
                                 "while already held on this path — "
                                 "guaranteed self-deadlock (RLock if "
                                 "re-entry is intended)"))
                continue
            graph.setdefault(a, set()).add(b)
        for cycle in _cycles(graph):
            a, b = cycle[0], cycle[1]
            path, line = model.order_edges[(a, b)]
            order = " -> ".join(cycle)
            yield Finding(
                file=path, line=line, rule_id=self.rule_id,
                message=(f"lock-order cycle {order}: two threads "
                         "entering this cycle at different points can "
                         "deadlock; pick one global order and make "
                         "every path follow it"))
