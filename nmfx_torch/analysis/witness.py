"""Runtime lock-order witness: instrumented locks for the port's
threaded test suites (counterpart of ``nmfx/analysis/witness.py``).

The static rules (NMFX012/013, ``nmfx_torch/analysis/concurrency/``)
derive a lock-acquisition order graph from the source; this module
observes the orders threads actually take locks in while the serving,
fleet, harvest and fault suites run, and

* records a violation when two lock creation sites are taken in both
  orders (a dynamic inversion, the precondition of every real deadlock),
  when a plain lock is re-taken by its holder, or (on request) when an
  observed order inverts an edge the static graph pins;
* exposes :func:`observed_edges`, so a test can hold the static graph's
  completeness to real executions.

Arming (``arm()`` / ``disarm()``, the :func:`armed` context manager, or
:func:`guard`, which the threaded suites use as an autouse fixture)
patches ``threading.Lock`` / ``threading.RLock`` with factories that wrap
the locks created by the port's own files (under ``nmfx_torch/``, this
package excluded) or by test files in recording proxies. The creation
site is classified by the caller's file name, so other packages' locks
(torch, the reference package, ``concurrent.futures``) pass through
untouched and pay one frame inspection at creation, nothing per
acquisition.

Blind spots, by design: locks created before arming are never wrapped
(module-level singletons such as ``nmfx_torch.faults._lock`` or the
metrics registry's lock; the static rules cover them), and a
``threading.Condition()`` without an argument allocates its RLock inside
``threading.py``, unwrapped. ``Condition(self._lock)`` on a wrapped lock
is tracked: its release / reacquire protocol goes through the proxy's
plain ``acquire`` / ``release``.

Edges are keyed by lock creation site ``(abspath, lineno)``, the identity
the static model's ``LockInfo.site`` records, so the instances of one
class collapse onto one node, as the static graph's
``module.Class._attr`` keys do.
"""

from __future__ import annotations

import os
import sys
import threading

__all__ = ["arm", "disarm", "armed", "guard", "reset", "is_armed",
           "observed_edges", "violations", "check_static_inversions",
           "static_order_edges"]

#: originals, captured at import of THIS module (before any patching)
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock

_armed_depth = 0

#: (site_a, site_b) -> (thread name, example acquire site pair count)
_edges: "dict[tuple, int]" = {}
#: recorded inversions: dicts with kind/site_a/site_b/thread
_violations: "list[dict]" = []
_state_lock = _REAL_LOCK()
_tls = threading.local()


def _held() -> list:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


class _LockWitness:
    """Proxy around one lock object, recording acquisition order by
    creation site. Context-manager and acquire/release compatible;
    everything else delegates to the wrapped lock."""

    __slots__ = ("_inner", "site", "reentrant")

    def __init__(self, inner, site: "tuple[str, int]", reentrant: bool):
        self._inner = inner
        self.site = site
        self.reentrant = reentrant

    # -- the recorded protocol ------------------------------------------
    def acquire(self, *args, **kwargs):
        blocking = bool(args[0]) if args else kwargs.get("blocking", True)
        if blocking:
            self._pre_acquire()
        got = self._inner.acquire(*args, **kwargs)
        if got:
            _held().append(self)
            self._record_edges()
        return got

    def release(self):
        stack = _held()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    # -- recording ------------------------------------------------------
    def _pre_acquire(self) -> None:
        if self.reentrant:
            return
        for h in _held():
            if h is self:
                # a plain Lock re-acquired by its owner: guaranteed
                # self-deadlock. Record BEFORE blocking so the hang's
                # postmortem names the site, then block as the real
                # lock would — the witness never changes semantics.
                with _state_lock:
                    _violations.append({
                        "kind": "self-deadlock",
                        "site_a": self.site, "site_b": self.site,
                        "thread": threading.current_thread().name})
                return

    def _record_edges(self) -> None:
        me = self.site
        seen = set()
        for h in _held():
            if h is self or h.site == me or h.site in seen:
                continue
            seen.add(h.site)
            edge = (h.site, me)
            with _state_lock:
                _edges[edge] = _edges.get(edge, 0) + 1
                if (me, h.site) in _edges:
                    _violations.append({
                        "kind": "inversion",
                        "site_a": h.site, "site_b": me,
                        "thread": threading.current_thread().name})


def _wrap_site(depth: int) -> "tuple[str, int] | None":
    """The creation call site when it lies in the port's files or in a
    test file, else None (leave the lock unwrapped)."""
    try:
        frame = sys._getframe(depth)
    except ValueError:  # pragma: no cover - no caller frame
        return None
    fn = frame.f_globals.get("__file__") or frame.f_code.co_filename
    fn = os.path.abspath(fn)
    parts = fn.replace("\\", "/")
    if "/nmfx_torch/analysis/" in parts:
        return None  # never instrument the instrumentation
    if "/nmfx_torch/" in parts or "/tests/" in parts:
        return (fn, frame.f_lineno)
    return None


def _patched_lock():
    inner = _REAL_LOCK()
    site = _wrap_site(2)
    if site is None:
        return inner
    return _LockWitness(inner, site, reentrant=False)


def _patched_rlock():
    inner = _REAL_RLOCK()
    site = _wrap_site(2)
    if site is None:
        return inner
    return _LockWitness(inner, site, reentrant=True)


# -- arming ------------------------------------------------------------
def arm() -> None:
    """Start wrapping newly created locks of the port and the tests
    (nested arms count)."""
    global _armed_depth
    with _state_lock:
        _armed_depth += 1
        if _armed_depth == 1:
            threading.Lock = _patched_lock
            threading.RLock = _patched_rlock


def disarm() -> None:
    """Undo one :func:`arm`. Locks wrapped while armed keep recording
    until garbage-collected — disarming only stops wrapping NEW ones,
    so a server outliving its test keeps a consistent proxy."""
    global _armed_depth
    with _state_lock:
        if _armed_depth == 0:
            return
        _armed_depth -= 1
        if _armed_depth == 0:
            threading.Lock = _REAL_LOCK
            threading.RLock = _REAL_RLOCK


def is_armed() -> bool:
    return _armed_depth > 0


class armed:
    """``with witness.armed():`` — arm for the block, disarm after."""

    def __enter__(self):
        arm()
        return sys.modules[__name__]

    def __exit__(self, *exc):
        disarm()
        return False


class guard:
    """``with witness.guard():`` — the threaded suites' fixture body:
    reset, arm for the block, then disarm and raise ``AssertionError``
    naming every dynamic inversion, self-deadlock or inversion of a
    static NMFX013 edge observed. ``NMFX_LOCK_WITNESS=0`` in the
    environment turns it into a no-op (when bisecting a timing issue the
    instrumentation could perturb)."""

    def __enter__(self):
        self.on = os.environ.get("NMFX_LOCK_WITNESS", "1") != "0"
        if self.on:
            reset()
            arm()
        return self

    def __exit__(self, exc_type, *exc):
        if not self.on:
            return False
        disarm()
        problems = violations() + check_static_inversions()
        reset()
        if problems and exc_type is None:
            raise AssertionError("lock-order witness caught an inversion:"
                                 "\n" + render(problems))
        return False


def reset() -> None:
    """Clear observed edges and violations (per-test isolation)."""
    with _state_lock:
        _edges.clear()
        _violations.clear()


def observed_edges() -> "dict[tuple, int]":
    """``{(site_a, site_b): count}`` — site is the lock's creation
    ``(abspath, lineno)``; the edge means a thread acquired b while
    holding a."""
    with _state_lock:
        return dict(_edges)


def violations() -> "list[dict]":
    with _state_lock:
        return list(_violations)


# -- static cross-check ------------------------------------------------
_static_cache: "dict | None" = None


def static_order_edges() -> "dict[tuple, tuple]":
    """The static model's order graph translated to creation-site
    keys: ``{(site_a, site_b): (key_a, key_b)}``. Built once per
    process (one AST pass over the package)."""
    global _static_cache
    if _static_cache is not None:
        return _static_cache
    from nmfx_torch.analysis.ast_scan import load_project
    from nmfx_torch.analysis.concurrency.model import concurrency_model

    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    model = concurrency_model(load_project([pkg_dir]))
    site_of = {key: (os.path.abspath(li.site[0]), li.site[1])
               for key, li in model.lock_index.items()}
    out = {}
    for (a, b) in model.order_edges:
        sa, sb = site_of.get(a), site_of.get(b)
        if sa is not None and sb is not None:
            out[(sa, sb)] = (a, b)
    _static_cache = out
    return out


def check_static_inversions() -> "list[dict]":
    """Observed edges whose REVERSE is a static-graph edge — a runtime
    order contradicting the order the source pins. Returned, not
    raised; :class:`guard` asserts on it at exit."""
    observed = observed_edges()
    if not observed:
        return []  # nothing to cross-check; skip the model build
    static = static_order_edges()
    out = []
    for (sa, sb) in observed:
        if (sb, sa) in static:
            ka, kb = static[(sb, sa)]
            out.append({"kind": "static-inversion",
                        "site_a": sa, "site_b": sb,
                        "static_edge": f"{kb} -> {ka}"})
    return out


def render(problems: "list[dict]") -> str:
    def site(s):
        return f"{os.path.relpath(s[0])}:{s[1]}"

    lines = []
    for v in problems:
        head = (f"lock-order {v['kind']}: "
                f"{site(v['site_a'])} -> {site(v['site_b'])}")
        if v.get("thread"):
            head += f"  [thread {v['thread']}]"
        if v.get("static_edge"):
            head += f"  (static graph pins {v['static_edge']})"
        lines.append(head)
    return "\n".join(lines)
