"""Concurrency-discipline declarations: which lock owns which state
(counterpart of ``nmfx/guards.py``).

A class decorated ``@guarded_by("_lock", "_queue", ...)`` promises that
every access to ``self._queue`` happens while ``self._lock`` is held.
The port's linter (``python -m nmfx_torch.analysis``, rule NMFX012) reads
these declarations syntactically: an access to a declared attribute
outside a ``with self._lock`` scope is a finding; NMFX013 and the runtime
witness (``nmfx_torch/analysis/witness.py``) hold the lock order.

Usage::

    from nmfx_torch.guards import guarded_by

    @guarded_by("_lock", "_events", "_recorded")
    class FlightRecorder: ...

Stacked decorators declare one guarded set per lock. Module-level state
is declared with a top-level call::

    module_guarded("_warned_lock", "_warned")

Both forms only record metadata: they import nothing and add no cost to
an access.
"""

from __future__ import annotations

#: module dotted path -> {lock name -> guarded global names}; filled by
#: :func:`module_guarded` when the declaring module is imported
GUARDED_BY: "dict[str, dict[str, tuple[str, ...]]]" = {}


def guarded_by(lock_attr: str, *attrs: str):
    """Class decorator: ``attrs`` are instance attributes that must only
    be accessed while ``self.<lock_attr>`` is held. Metadata lands in
    ``cls.__nmfx_guarded__`` (lock attr -> guarded attr tuple); the
    decorated class is returned unchanged."""

    def deco(cls):
        # copy: a subclass decorating again must not mutate the base's
        # registry through the inherited reference
        reg = dict(getattr(cls, "__nmfx_guarded__", {}))
        reg[lock_attr] = tuple(attrs)
        cls.__nmfx_guarded__ = reg
        return cls

    return deco


def module_guarded(lock_name: str, *names: str, module: "str | None" = None):
    """Declare module-level globals guarded by a module-level lock. Call
    at module top level with string literals."""
    import inspect

    if module is None:
        frame = inspect.currentframe()
        caller = frame.f_back if frame is not None else None
        module = caller.f_globals.get("__name__", "?") if caller else "?"
    GUARDED_BY.setdefault(module, {})[lock_name] = tuple(names)
