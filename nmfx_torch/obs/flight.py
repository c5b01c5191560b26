"""Crash flight recorder: a bounded ring of recent structured events,
dumped as a redacted JSON postmortem when something dies (counterpart
of ``nmfx/obs/flight.py``).

The port's failure paths are loud but EPHEMERAL: a warn-once line, an
armed-site banner, degradations that scrolled away minutes earlier.
This module keeps the last ``max_events`` structured events in memory —
fault-site arms and fires, degradations, cache evictions, checkpoint
commits and extensions — and writes them as one inspectable JSON
artifact on request: cheap enough to run always, read only when
something went wrong.

Event sources (all built in — no call-site opt-in):

* ``nmfx_torch.faults.fire`` records every armed fault FIRE under the
  site's category from :data:`FAULT_EVENTS` (one entry per registered
  site, held to ``faults.SITES`` by the tests);
* ``nmfx_torch.faults.warn_once`` records every degradation, EVERY
  time (the warning itself fires once a category);
* the input cache's evictions and the checkpoint ledger's commits
  record their own categories.

Dump triggers: an explicit :func:`dump`, and SIGTERM via
:func:`install_signal_dump` (explicit installation only: nothing in the
environment alone changes behavior). ``dump()`` always builds and
retains the artifact (:func:`last_dump`); it writes to disk only when a
directory was :func:`configure`'d or an explicit path is passed —
library code never litters the cwd.

Redaction: payload values are stringified with a length cap and
payloads a key-count cap before they enter the ring — a recorded event
can reference a matrix or exception but never embed one.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from collections import deque

from nmfx_torch.guards import guarded_by

__all__ = ["FAULT_EVENTS", "FlightRecorder", "configure",
           "default_recorder", "dump", "fault_event_categories",
           "install_signal_dump", "last_dump", "record"]

#: fault site → flight-recorder event category emitted when the site
#: FIRES (``nmfx_torch.faults.fire`` routes every fire through this
#: mapping). It covers every registered site (``faults.SITES``), so a
#: chaos rehearsal's postmortem always shows its injected failures.
FAULT_EVENTS = {
    "h2d.transfer": "fault.h2d.transfer",
    "compile.build": "fault.compile.build",
    "persist.deserialize": "fault.persist.deserialize",
    "harvest.worker": "fault.harvest.worker",
    "serve.scheduler": "fault.serve.scheduler",
    "solve.nonfinite": "fault.solve.nonfinite",
    "sched.stale_reload": "fault.sched.stale_reload",
    "ckpt.write": "fault.ckpt.write",
    "ckpt.load": "fault.ckpt.load",
    "proc.preempt": "fault.proc.preempt",
    "router.forward": "fault.router.forward",
    "replica.spawn": "fault.replica.spawn",
    "replica.heartbeat": "fault.replica.heartbeat",
}


def fault_event_categories() -> frozenset:
    """The fault sites the flight recorder emits fire events for (the
    ``data_key_fields``/``manifest_key_fields`` discipline: the tests
    hold it equal to ``faults.SITES``)."""
    return frozenset(FAULT_EVENTS)


#: redaction bounds: a payload VALUE is stringified and truncated, a
#: payload itself capped in keys — events describe, never embed
_MAX_VALUE_CHARS = 240
_MAX_PAYLOAD_KEYS = 16
_DEFAULT_MAX_EVENTS = 4096


def _redact_value(v):
    if v is None or isinstance(v, (bool, int, float)):
        return v
    if isinstance(v, (list, tuple)) and len(v) <= 32 and all(
            isinstance(x, (bool, int, float, str)) for x in v):
        return [_redact_value(x) for x in v]
    s = str(v)
    if len(s) > _MAX_VALUE_CHARS:
        s = s[:_MAX_VALUE_CHARS] + f"…[{len(s)} chars]"
    return s


@guarded_by("_lock", "_events", "_recorded", "_dir", "_last_dump")
class FlightRecorder:
    """Thread-safe bounded event ring + postmortem dump."""

    def __init__(self, max_events: int = _DEFAULT_MAX_EVENTS):
        if max_events < 1:
            raise ValueError("max_events must be >= 1")
        # REENTRANT on purpose: the SIGTERM dump handler runs ON the
        # main thread, possibly while that same thread is inside
        # record() holding this lock — a plain Lock would self-deadlock
        # the process instead of dumping and exiting
        self._lock = threading.RLock()
        self._events: "deque[dict]" = deque(maxlen=max_events)
        self._recorded = 0
        self._dir: "str | None" = None
        self._last_dump: "dict | None" = None
        self._t0 = time.monotonic()

    # -- recording ---------------------------------------------------------
    def record(self, category: str, /, **payload) -> None:
        """Append one structured event. Cheap (one dict + one lock) and
        bounded; payload values are redacted at RECORD time, so nothing
        unbounded is ever retained. ``category`` is positional-only —
        payload keys that would shadow the envelope fields
        (category/thread/timestamps) are prefixed ``payload_``."""
        reserved = {"category", "thread", "t_mono_s", "t_epoch_s"}
        if reserved & payload.keys():
            payload = {(f"payload_{k}" if k in reserved else k): v
                       for k, v in payload.items()}
        items = list(payload.items())
        if len(items) > _MAX_PAYLOAD_KEYS:
            items = items[:_MAX_PAYLOAD_KEYS] + [
                ("redacted_keys", len(payload) - _MAX_PAYLOAD_KEYS)]
        ev = {"t_mono_s": round(time.monotonic() - self._t0, 6),
              "t_epoch_s": round(time.time(), 3),
              "thread": threading.current_thread().name,
              "category": category,
              **{k: _redact_value(v) for k, v in items}}
        with self._lock:
            self._events.append(ev)
            self._recorded += 1

    def events(self, category: "str | None" = None) -> "list[dict]":
        """Snapshot of retained events, oldest first; optionally
        filtered by exact category."""
        with self._lock:
            evs = [dict(e) for e in self._events]
        if category is not None:
            evs = [e for e in evs if e["category"] == category]
        return evs

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._recorded - len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._recorded = 0

    # -- dumping -----------------------------------------------------------
    def configure(self, directory: "str | None") -> None:
        """Set (or with None, unset) the dump directory. Dumps are
        written only when a directory is configured or an explicit
        path is passed — never implicitly to the cwd."""
        with self._lock:
            self._dir = directory

    def dump(self, reason: str, path: "str | None" = None,
             extra: "dict | None" = None) -> "str | None":
        """Build the postmortem artifact (always retained —
        :meth:`last_dump`) and write it when a destination exists.
        Returns the written path, or None when nothing was written.
        Best-effort by design: a failing disk must not mask the crash
        being reported (write failures degrade to the in-memory
        artifact, warn-once)."""
        from nmfx_torch import faults as _faults
        from nmfx_torch.obs import costmodel as _costmodel

        artifact = {
            "reason": reason,
            "t_epoch_s": round(time.time(), 3),
            "pid": os.getpid(),
            "armed_fault_sites": {
                site: str(_faults.armed(site))
                for site in _faults.SITES
                if _faults.armed(site) is not None},
            "dropped_events": self.dropped,
            "events": self.events(),
        }
        # what the process was DOING: the last per-dispatch roofline
        # attributions and the latest SLO status ride along
        from nmfx_torch.obs import slo as _slo

        artifact["perf_recent"] = [
            {k: _redact_value(v) for k, v in rec.items()}
            for rec in _costmodel.recent_attributions(limit=32)]
        artifact["slo"] = _slo.last_status()
        if extra:
            artifact["extra"] = {k: _redact_value(v)
                                 for k, v in extra.items()}
        with self._lock:
            self._last_dump = artifact
            directory = self._dir
        if path is None and directory is not None:
            safe = "".join(c if c.isalnum() or c in "-._" else "-"
                           for c in reason)
            path = os.path.join(
                directory, f"flight_{os.getpid()}_{safe}.json")
        if path is None:
            return None
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(artifact, f, indent=1)
            os.replace(tmp, path)
        except OSError as e:
            _faults.warn_once(
                "flight-dump-failed",
                f"could not write flight-recorder dump to {path!r} "
                f"({e}); the postmortem stays available in-process via "
                "nmfx_torch.obs.flight.last_dump()")
            return None
        return path

    def last_dump(self) -> "dict | None":
        """The most recently built postmortem artifact (written to
        disk or not)."""
        with self._lock:
            return self._last_dump


_recorder = FlightRecorder()


def default_recorder() -> FlightRecorder:
    """The process-wide recorder every nmfx_torch subsystem records
    into."""
    return _recorder


def record(category: str, /, **payload) -> None:
    """Record one event on the process-wide recorder."""
    _recorder.record(category, **payload)


def configure(directory: "str | None") -> None:
    """Point crash dumps at ``directory``."""
    _recorder.configure(directory)


def dump(reason: str, path: "str | None" = None,
         extra: "dict | None" = None) -> "str | None":
    """Dump the process-wide recorder (see :meth:`FlightRecorder.dump`)."""
    return _recorder.dump(reason, path=path, extra=extra)


def last_dump() -> "dict | None":
    return _recorder.last_dump()


def install_signal_dump():
    """Hook SIGTERM so an external kill leaves a postmortem: the
    handler dumps the flight recorder, then defers to the previous
    disposition (the ``checkpoint.install_signal_flush`` contract —
    a previously-installed handler still runs, the default disposition
    still terminates). Explicit installation only; returns a
    zero-argument restore callable, a no-op off the main thread."""
    installed: dict = {}

    def _handler(signum, frame):
        _recorder.dump(f"signal-{signal.Signals(signum).name}")
        prev = installed.get(signum)
        if callable(prev):
            prev(signum, frame)
        elif prev is signal.SIG_IGN:
            return
        else:
            raise SystemExit(128 + signum)

    try:
        installed[signal.SIGTERM] = signal.signal(signal.SIGTERM,
                                                  _handler)
    except ValueError:
        # not the main interpreter thread: nothing was installed
        return lambda: None

    def restore():
        for sig, prev in installed.items():
            signal.signal(sig, prev)
    return restore
