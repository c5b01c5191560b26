"""NMFX014 — future-resolution completeness (counterpart of
``nmfx/analysis/concurrency/rules_futures.py``).

Failure class: the stranded-Future family the serve watchdog exists to
mop up — a ``Future`` handed to a waiter whose producer died between
registering it and completing the hand-off. A dead scheduler leaves
every queued future hanging; the ProcessReplica forward path writes a
spill record after registering the future, and a failed write without
the unregister-and-reraise would strand the waiter just as silently.

The rule checks every function that constructs a ``Future`` (or an
in-module subclass — ``_ServeFuture``/``_RouterFuture``):

* **dead future** — a constructed future that is never resolved
  (``set_result``/``set_exception``), returned, stored, or passed
  anywhere strands its waiter by construction;
* **unprotected publication gap** — once the future is PUBLISHED into
  an instance attribute (a pending map, a queue the scheduler drains),
  the publisher still owns the hand-off until the consumer can see a
  complete record; any later statement that can raise must sit under a
  handler that resolves the future or unpublishes it (references the
  future or the published container). Lock/condition operations and
  calls on the future itself are exempt — they are the hand-off.

The gap check is lexical (line-ordered, nested ``def`` bodies
excluded — they run later); a branch-exclusive path the analysis
cannot see is exactly what an inline suppression with a reason is
for.
"""

from __future__ import annotations

import ast
from typing import Iterable

from nmfx_torch.analysis.core import Finding, Rule, register
from nmfx_torch.analysis.ast_scan import Project, _attr_tail, own_nodes
from nmfx_torch.analysis.concurrency.model import concurrency_model

#: calls that cannot meaningfully fail mid-hand-off: lock/condition
#: protocol ops and queue/container inserts (the hand-off itself), and
#: the observability layer (counters, gauges, flight-recorder events —
#: designed to never raise into the serving path)
_SAFE_TAILS = {"notify", "notify_all", "acquire", "release", "wait",
               "locked", "append", "appendleft", "add", "setdefault",
               "put", "put_nowait", "inc", "set", "observe", "record",
               "mark",
               # non-raising builtins on in-memory values
               "len", "str", "int", "float", "bool", "repr", "sorted",
               "list", "tuple", "dict", "min", "max", "isinstance"}


def _names_in(node: ast.AST) -> "set[str]":
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _attrs_in(node: ast.AST) -> "set[str]":
    return {n.attr for n in ast.walk(node) if isinstance(n, ast.Attribute)}


def _own_statements(fn: ast.AST) -> "list[tuple[ast.stmt, list]]":
    """(statement, ancestor chain) for every statement in the function
    body, nested function bodies EXCLUDED (they run later, on another
    thread — their exceptions are not this function's exception
    paths)."""
    out: "list[tuple[ast.stmt, list]]" = []

    def walk(body, chain):
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            out.append((stmt, chain))
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if sub:
                    walk(sub, chain + [stmt])
            for handler in getattr(stmt, "handlers", []) or []:
                walk(handler.body, chain + [stmt])

    walk(fn.body, [])
    return out


def _protecting_try(chain: "list[ast.stmt]", fname: str,
                    published_attr: "str | None") -> bool:
    """Is the statement under a handler/finally that disposes the
    future — resolves ``fname`` or touches the published container?"""
    for anc in chain:
        if not isinstance(anc, ast.Try):
            continue
        bodies = [h.body for h in anc.handlers]
        if anc.finalbody:
            bodies.append(anc.finalbody)
        for body in bodies:
            for stmt in body:
                if fname in _names_in(stmt):
                    return True
                if (published_attr is not None
                        and published_attr in _attrs_in(stmt)):
                    return True
    return False


def _check_function(mod_path: str, qual: str, fn: ast.AST,
                    creations, rule_id: str) -> "Iterable[Finding]":
    stmts = _own_statements(fn)
    for crt in creations:
        fname = crt.name
        if fname is None:
            continue
        resolved_line = None
        published = None  # (line, attr name of the container)
        disposed = False
        for stmt, chain in stmts:
            if stmt.lineno < crt.line:
                continue
            names = _names_in(stmt)
            if fname not in names:
                continue
            # resolution: f.set_result(...) / futs[k].set_exception(...)
            for node in ast.walk(stmt):
                if (isinstance(node, ast.Call)
                        and _attr_tail(node.func) in ("set_result",
                                                      "set_exception")
                        and fname in _names_in(node.func)):
                    disposed = True
                    if resolved_line is None:
                        resolved_line = stmt.lineno
            if isinstance(stmt, (ast.Return, ast.Expr)) and isinstance(
                    getattr(stmt, "value", None), ast.AST):
                if fname in _names_in(stmt.value):
                    disposed = True
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call):
                    argnames = set()
                    for a in list(node.args) + [kw.value
                                                for kw in node.keywords]:
                        argnames |= _names_in(a)
                    if fname in argnames:
                        disposed = True  # ownership passed along
            if isinstance(stmt, ast.Assign) and fname in _names_in(
                    stmt.value):
                for tgt in stmt.targets:
                    if isinstance(tgt, (ast.Attribute, ast.Subscript)):
                        disposed = True
                        attrs = _attrs_in(tgt)
                        if attrs and published is None:
                            published = (stmt.lineno,
                                         sorted(attrs - {fname})[0]
                                         if sorted(attrs - {fname})
                                         else None)
        # the constructor call may itself be the transfer:
        # _Pending(future=_ServeFuture(...)) hands the future to the
        # wrapper the moment it exists
        if not disposed:
            yield Finding(
                file=mod_path, line=crt.line, rule_id=rule_id,
                message=(f"{qual} constructs a Future bound to "
                         f"{fname!r} but never resolves, returns, "
                         "stores, or passes it — its waiter can only "
                         "hang"))
            continue
        if published is None or resolved_line is not None:
            continue
        pub_line, pub_attr = published
        # gap scan: risky statements after publication
        for stmt, chain in stmts:
            if stmt.lineno <= pub_line:
                continue
            risky = None
            for node in own_nodes(stmt):
                if not isinstance(node, ast.Call):
                    continue
                tail = _attr_tail(node.func)
                if tail in _SAFE_TAILS or tail in ("set_result",
                                                   "set_exception"):
                    continue
                if fname in _names_in(node):
                    continue
                risky = node
                break
            if risky is None:
                continue
            if _protecting_try(chain, fname, pub_attr):
                continue
            yield Finding(
                file=mod_path, line=pub_line, rule_id=rule_id,
                message=(f"{qual} publishes Future {fname!r} into "
                         f"self.{pub_attr} and then calls "
                         f"{_attr_tail(risky.func) or 'a function'}() "
                         f"at line {stmt.lineno} with no handler that "
                         "resolves or unpublishes it — an exception "
                         "there strands the waiter"))
            break


@register
class FutureResolutionRule(Rule):
    rule_id = "NMFX014"
    title = "every owned Future resolves on every path"

    def check(self, project: Project) -> "Iterable[Finding]":
        model = concurrency_model(project)
        for (mod_path, qual), mm in sorted(model.functions.items()):
            if not mm.futures:
                continue
            yield from _check_function(mod_path, qual, mm.node,
                                       mm.futures, self.rule_id)
