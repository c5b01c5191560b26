"""Structured tracing: thread-aware spans exported as Chrome trace JSON
(counterpart of ``nmfx/obs/trace.py``).

A sweep's wall time is spent across threads — the main thread solves
and starts the copies, harvest workers wait on them and run rank
selection — and a per-phase seconds table (``nmfx_torch/profiling.py``)
cannot show WHERE the time went. This tracer records every phase/span as
a timestamped interval on the thread that ran it, bounded in memory, and
exports the Chrome trace-event format (``chrome://tracing`` /
`Perfetto <https://ui.perfetto.dev>`_), so one sweep renders as a nested
timeline.

It records host wall intervals only. The device-side timeline is
``Profiler(trace_dir=...)``'s ``torch.profiler`` trace, a separate file.

Design rules:

* **One process-wide tracer, off by default.** ``default_tracer()`` is
  the sink every ``Profiler``/``NullProfiler`` phase writes through;
  while disabled a recording attempt costs one attribute read.
* **Bounded.** Events land in a ring of ``max_events``; overflow drops
  the OLDEST events and counts them (``dropped``) — tracing can stay on
  in a long-lived process without unbounded growth, like the flight
  recorder (``nmfx_torch/obs/flight.py``) but for spans.
* **Retroactive spans.** ``complete(name, dur_s)`` books an interval
  that just ENDED — the shape ``Profiler.add_seconds`` needs (harvest
  workers measure first, record after) — with its start back-computed,
  so worker-thread spans nest correctly without wrapping their code in
  a context manager.

Export: ``export(path)`` writes ``{"traceEvents": [...]}`` with "X"
(complete) and "i" (instant) events in microseconds plus "M" metadata
events naming each thread. The metadata keys (``nmfx_pid``,
``nmfx_t0_epoch_s``) are the reference's, so its tools merge the port's
traces.
"""

from __future__ import annotations

import contextlib
import functools
import json
import threading
import time
from collections import deque

__all__ = ["Tracer", "default_tracer", "disable", "enable",
           "merge_traces", "traced"]

#: default ring capacity — a sweep books a few dozen spans, so
#: this holds thousands of sweeps of history at ~100 B/event
_DEFAULT_MAX_EVENTS = 100_000


class Tracer:
    """Thread-aware span recorder with Chrome trace-event export.

    All mutation is lock-guarded (spans arrive concurrently from the
    main thread and the harvest workers); the ``enabled``
    check deliberately runs OUTSIDE the lock — a stale read can at
    worst drop or admit one event at the enable/disable edge, and the
    hot path must not serialize on a lock while tracing is off.
    """

    def __init__(self, max_events: int = _DEFAULT_MAX_EVENTS):
        if max_events < 1:
            raise ValueError("max_events must be >= 1")
        self.enabled = False
        self._lock = threading.Lock()
        self._events: "deque[dict]" = deque(maxlen=max_events)
        self._recorded = 0  # total admitted, including since-dropped
        self._thread_names: "dict[int, str]" = {}
        #: perf_counter epoch all timestamps are relative to
        self._t0 = time.perf_counter()
        #: the same instant on the WALL clock — exported in the trace
        #: metadata so :func:`merge_traces` can align traces recorded
        #: by different processes (each process's perf_counter zero is
        #: arbitrary; the wall clock is the shared axis)
        self._t0_epoch = time.time()

    # -- recording ---------------------------------------------------------
    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _admit(self, ev: dict) -> None:
        tid = threading.get_ident()
        ev["tid"] = tid
        with self._lock:
            if tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
            self._events.append(ev)
            self._recorded += 1

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "phase",
             args: "dict | None" = None):
        """Record the enclosed region as one complete ("X") event on
        the calling thread. Nesting is positional: Chrome/Perfetto nest
        events on one thread by interval containment, so nested
        ``span``/``phase`` calls render as a flame without explicit
        parent links."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dur = time.perf_counter() - t0
            self._admit({"name": name, "cat": cat, "ph": "X",
                         "ts": (t0 - self._t0) * 1e6, "dur": dur * 1e6,
                         "args": args})

    def complete(self, name: str, dur_s: float, cat: str = "phase",
                 args: "dict | None" = None) -> None:
        """Book a span that just ENDED (start = now − ``dur_s``) — the
        retroactive shape measured-then-recorded call sites need
        (``Profiler.add_seconds``)."""
        if not self.enabled:
            return
        end = self._now_us()
        self._admit({"name": name, "cat": cat, "ph": "X",
                     "ts": end - dur_s * 1e6, "dur": dur_s * 1e6,
                     "args": args})

    def instant(self, name: str, cat: str = "mark",
                args: "dict | None" = None) -> None:
        """Record a zero-duration event (a ``Profiler.mark``, a cache
        hit) — "i" in the Chrome format."""
        if not self.enabled:
            return
        self._admit({"name": name, "cat": cat, "ph": "i", "s": "t",
                     "ts": self._now_us(), "args": args})

    # -- lifecycle ---------------------------------------------------------
    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._recorded = 0

    @property
    def dropped(self) -> int:
        """Events lost to the ring bound since the last clear()."""
        with self._lock:
            return self._recorded - len(self._events)

    def event_count(self) -> int:
        with self._lock:
            return len(self._events)

    # -- export ------------------------------------------------------------
    def events(self) -> "list[dict]":
        """Snapshot of the retained events (oldest first)."""
        with self._lock:
            return [dict(ev) for ev in self._events]

    def chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object: retained events plus "M"
        metadata naming each thread, all on one pid (this process)."""
        import os

        pid = os.getpid()
        with self._lock:
            events = [dict(ev) for ev in self._events]
            names = dict(self._thread_names)
        out = []
        for tid, tname in sorted(names.items()):
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid, "args": {"name": tname}})
        for ev in events:
            ev["pid"] = pid
            if ev.get("args") is None:
                ev.pop("args", None)
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "metadata": {"nmfx_pid": pid,
                             "nmfx_t0_epoch_s": self._t0_epoch}}

    def export(self, path: str) -> str:
        """Write :meth:`chrome_trace` to ``path``; returns ``path``.
        Load in Perfetto (ui.perfetto.dev) or ``chrome://tracing``."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


_tracer = Tracer()


def default_tracer() -> Tracer:
    """The process-wide tracer every profiler phase records through."""
    return _tracer


def enable(max_events: "int | None" = None) -> Tracer:
    """Turn the process-wide tracer on (optionally re-bounding the
    ring). Does NOT clear already-retained events — call ``clear()``
    for a fresh window."""
    if max_events is not None and max_events != _tracer._events.maxlen:
        with _tracer._lock:
            _tracer._events = deque(_tracer._events, maxlen=max_events)
    _tracer.enabled = True
    return _tracer


def disable() -> None:
    _tracer.enabled = False


def traced(name_or_fn=None, cat: str = "fn"):
    """Decorator form of :meth:`Tracer.span` — ``@traced`` uses the
    function's qualname, ``@traced("custom.name")`` overrides it. Zero
    overhead beyond one enabled check while tracing is off."""
    def deco(fn, name=None):
        span_name = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            tr = _tracer
            if not tr.enabled:
                return fn(*a, **kw)
            with tr.span(span_name, cat=cat):
                return fn(*a, **kw)
        return wrapper

    if callable(name_or_fn):
        return deco(name_or_fn)
    return lambda fn: deco(fn, name=name_or_fn)


def merge_traces(traces, path: "str | None" = None,
                 names=None) -> dict:
    """Join N exported Chrome traces into ONE cross-process timeline.

    ``traces`` is a sequence of file paths (as written by
    :meth:`Tracer.export`) or already-loaded trace dicts. Each trace's
    timestamps are shifted onto a shared axis using the
    ``nmfx_t0_epoch_s`` wall-clock anchor the exporter embeds (the
    earliest anchor becomes zero); a trace without an anchor (foreign
    tooling) keeps its own relative time at offset zero — still
    rendered, just not aligned. Every merged trace contributes a
    ``process_name`` metadata event (from ``names``, the source
    filename, or its pid), so Perfetto shows one labeled track group
    per process, all on one wall-clock axis.

    Caveat: pids are the track-group key; two processes that genuinely
    share a pid (different hosts) would fold onto one group — name
    them apart via ``names``. Returns the merged trace dict; with
    ``path``, also writes it there."""
    loaded = []
    for i, t in enumerate(traces):
        label = None
        if isinstance(t, (str, bytes)) or hasattr(t, "__fspath__"):
            import os

            fname = os.fspath(t)
            with open(fname) as f:
                t = json.load(f)
            label = os.path.basename(fname)
        if names is not None and i < len(names):
            label = names[i]
        loaded.append((t, label))
    anchors = [t.get("metadata", {}).get("nmfx_t0_epoch_s")
               for t, _ in loaded]
    known = [a for a in anchors if a is not None]
    base = min(known) if known else None
    out: "list[dict]" = []
    for (t, label), anchor in zip(loaded, anchors):
        shift_us = ((anchor - base) * 1e6
                    if anchor is not None and base is not None else 0.0)
        pids = set()
        for ev in t.get("traceEvents", ()):
            ev = dict(ev)
            if "pid" in ev:
                pids.add(ev["pid"])
            if "ts" in ev and ev.get("ph") != "M":
                ev["ts"] = ev["ts"] + shift_us
            out.append(ev)
        for pid in sorted(pids, key=str):
            out.append({"name": "process_name", "ph": "M", "pid": pid,
                        "args": {"name": label if label is not None
                                 else f"pid {pid}"}})
    merged = {"traceEvents": out, "displayTimeUnit": "ms",
              "metadata": {"nmfx_merged": len(loaded),
                           "nmfx_t0_epoch_s": base}}
    if path is not None:
        with open(path, "w") as f:
            json.dump(merged, f)
    return merged
