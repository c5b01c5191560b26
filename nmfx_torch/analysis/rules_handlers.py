"""NMFX006: silent degradation, a broad exception handler that swallows
a failure without a trace (counterpart of
``nmfx/analysis/rules_handlers.py``).

The fault-tolerant serving and fleet tiers share one discipline: a broad
``except`` either **re-raises** (possibly as a typed error chaining the
cause), **resolves a Future** (``set_exception`` / ``set_result``: the
failure reaches the waiter, typed, instead of hanging it), or **routes
through the warn-once helper** (``nmfx_torch.faults.warn_once``: the
first fallback of a kind is loud). A broad handler doing none of these
is how a server "survives" a failure by hiding it: a request hangs or
quietly returns degraded output.

Scope: every ``except Exception`` / ``except BaseException`` (bare
``except:`` included) in the analyzed tree. Narrow handlers (``except
KeyError``, ``except OSError``) are out of scope.

A handler is compliant when its body (nested statements included, nested
``def`` / ``lambda`` excluded: those run later) contains any of:

* a ``raise`` statement (bare re-raise or typed ``raise X from e``);
* a call whose attribute tail is ``set_exception`` or ``set_result``;
* a call to a ``*warn_once`` helper (bare or attribute tail), such as
  ``nmfx_torch.faults.warn_once`` or ``ExecCache._warn_once``.

Suppress a deliberate swallow with a recorded reason::

    except Exception:  # nmfx: ignore[NMFX006] -- best-effort cleanup
"""

from __future__ import annotations

import ast
from typing import Iterable

from nmfx_torch.analysis.core import Finding, Rule, register

#: except types treated as "broad" (a tuple containing one counts)
_BROAD = {"Exception", "BaseException"}

#: call attribute tails that resolve a Future with the failure
_FUTURE_RESOLVERS = {"set_exception", "set_result"}

#: the shared degradation helper (nmfx_torch.faults.warn_once) and scoped
#: variants (ExecCache._warn_once) — matched by name suffix
_WARN_ONCE_SUFFIX = "warn_once"


def _broad_name(handler: ast.ExceptHandler) -> "str | None":
    """The broad class this handler catches, or None for narrow ones.
    Resolves ``except Exception``, ``except (ValueError, Exception)``,
    and the bare ``except:`` (implicitly BaseException)."""
    t = handler.type
    if t is None:
        return "BaseException (bare except)"
    candidates = t.elts if isinstance(t, ast.Tuple) else [t]
    for cand in candidates:
        if isinstance(cand, ast.Name) and cand.id in _BROAD:
            return cand.id
    return None


def _disposes(handler: ast.ExceptHandler) -> bool:
    """Whether the handler body re-raises, resolves a Future, or warns
    once — scanning nested statements but not nested function bodies
    (a callback defined here runs later; it is not this handler's
    disposal of this failure)."""
    skip: "set[int]" = set()
    for node in ast.walk(handler):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            skip.update(id(sub) for sub in ast.walk(node))
    for node in ast.walk(handler):
        if id(node) in skip or node is handler:
            continue
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and (
                    fn.attr in _FUTURE_RESOLVERS
                    or fn.attr.endswith(_WARN_ONCE_SUFFIX)):
                return True
            if isinstance(fn, ast.Name) \
                    and fn.id.endswith(_WARN_ONCE_SUFFIX):
                return True
    return False


@register
class SilentDegradation(Rule):
    """NMFX006: broad except must re-raise, resolve a Future, or
    route through the warn-once degradation helper."""

    rule_id = "NMFX006"
    title = "silent degradation in broad exception handler"

    def check(self, project) -> "Iterable[Finding]":
        for mod in project.modules:
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.ExceptHandler):
                    continue
                broad = _broad_name(node)
                if broad is None or _disposes(node):
                    continue
                yield self.finding(
                    mod.path, node.lineno,
                    f"broad handler (except {broad}) neither "
                    "re-raises, resolves a Future, nor routes through "
                    "nmfx_torch.faults.warn_once — the failure is "
                    "silently swallowed (the degradation class the "
                    "recovery paths exist to prevent). Re-raise a "
                    "typed error chaining the cause, resolve the "
                    "waiter's Future, or warn_once(category, msg); a "
                    "deliberate swallow needs a suppression with a "
                    "recorded reason")
