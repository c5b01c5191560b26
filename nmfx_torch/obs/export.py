"""Per-process telemetry export: snapshot publishing + a /metrics port
(counterpart of ``nmfx/obs/export.py``'s host half).

Each process can periodically write an atomic JSON snapshot of its
metrics registry plus its instance identity into a shared
``telemetry_dir``; a collector (``nmfx_torch.obs.aggregate``) merges N
such snapshots into one fleet view. The snapshot format is the
reference's, so either package's collector reads either package's
files.

Design rules:

* **Atomic tmp+rename, torn-tolerant.** A snapshot file is written via
  ``telemetry_<instance>.json.tmp.<pid>`` + ``os.replace`` (the
  checkpoint ledger's write discipline), so a reader can never observe
  a half-written file.
* **Heartbeat = the snapshot's ``time``.** Liveness is the file's
  embedded wall-clock timestamp, not mtime.
* **Never takes the card.** ``device_kind`` is read from torch ONLY
  when the process already imported torch and already initialized
  CUDA — a collector process that publishes reports ``"unknown"``
  instead of creating a CUDA context on the card.
* **Optional pull endpoint.** :func:`serve_metrics` exposes the same
  registry as a stdlib ``http.server`` Prometheus endpoint for
  scraper-based deployments.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time

from nmfx_torch.obs import metrics as _metrics

__all__ = ["HeartbeatLedger", "TelemetryPublisher", "build_snapshot",
           "serve_metrics", "snapshot_path"]

#: snapshot format version — the collector skips (warn-once) files
#: written by a future incompatible format instead of misreading them
FORMAT_VERSION = 1

#: telemetry snapshot filenames in a telemetry_dir; distinct from the
#: checkpoint ledger's shard_<i>.json heartbeats and flight_*.json
#: postmortems so every ledger can share one directory
FILE_PREFIX = "telemetry_"

_publishes_total = _metrics.counter(
    "nmfx_telemetry_publishes_total",
    "telemetry snapshots published to the shared telemetry_dir")


def _device_kind() -> str:
    """The card's name WITHOUT initializing CUDA: read from torch only
    when the process already imported torch and CUDA is already
    initialized there; otherwise ``"unknown"``."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return "unknown"
    return torch.cuda.get_device_name(torch.cuda.current_device())


def _safe_instance(instance: str) -> str:
    return "".join(c if c.isalnum() or c in "-._" else "-"
                   for c in instance)


def snapshot_path(telemetry_dir: str, instance: str) -> str:
    """The ledger filename one instance publishes to."""
    return os.path.join(telemetry_dir,
                        f"{FILE_PREFIX}{_safe_instance(instance)}.json")


# --------------------------------------------------------------------------
class HeartbeatLedger:
    """Atomic per-instance JSON heartbeats in a shared directory: one
    write/read discipline for every liveness consumer (the reference's
    elastic shards and replica pools; the port's serving tier, ROADMAP
    §1 item 9) — cheap cross-process "I am alive and here is my level"
    signaling without serializing a full registry snapshot.

    Semantics (the telemetry ledger's, scaled down):

    * one file per instance, ``<prefix><instance>.json``, written via
      tmp+rename — a reader can never observe a torn file from a live
      writer, and a torn file from a crashed writer reads as staleness;
    * liveness is the payload's embedded wall-clock ``time`` (what the
      process asserted), never mtime;
    * writes are best-effort: a heartbeat is a side channel, and an
      unwritable ledger must never take the heartbeating path down.
    """

    def __init__(self, directory: str, *, prefix: str = "hb_"):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.prefix = prefix

    def path(self, instance: str) -> str:
        return os.path.join(
            self.directory,
            f"{self.prefix}{_safe_instance(str(instance))}.json")

    def beat(self, instance: str, **info) -> "str | None":
        """Write one heartbeat (payload = ``info`` + pid + time);
        returns the path, or None when the write failed (best-effort
        by design — completion records / telemetry snapshots stay the
        ground truth)."""
        path = self.path(instance)
        payload = dict(info, instance=str(instance), pid=os.getpid(),
                       time=time.time())
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wt") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
        except OSError:  # liveness side-channel only: see the class
            return None  # docstring
        return path

    def read(self, instance: str) -> "dict | None":
        try:
            with open(self.path(instance)) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None  # a torn heartbeat IS staleness
        return payload if isinstance(payload, dict) else None

    def status(self, stale_after_s: "float | None" = None) -> dict:
        """``{instance: payload}`` for every readable heartbeat; with
        ``stale_after_s`` each payload gains ``stale`` and ``age_s``
        from its embedded write time."""
        out: dict = {}
        now = time.time()
        try:
            names = sorted(os.listdir(self.directory))
        except OSError:
            return out
        for name in names:
            if not (name.startswith(self.prefix)
                    and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.directory, name)) as f:
                    payload = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue  # a torn heartbeat IS staleness
            if not isinstance(payload, dict):
                continue
            age = now - float(payload.get("time", 0.0))
            if stale_after_s is not None:
                payload["age_s"] = round(age, 3)
                payload["stale"] = age > stale_after_s
            key = payload.get("instance",
                              name[len(self.prefix):-len(".json")])
            out[key] = payload
        return out


def build_snapshot(registry: "_metrics.MetricsRegistry | None" = None,
                   *, instance: str = "", role: str = "process",
                   seq: int = 0, status: "dict | None" = None) -> dict:
    """One publishable snapshot: instance identity (instance name, pid,
    host, role, device kind), the heartbeat timestamp, and the full
    registry snapshot enriched with each metric's help text and (for
    histograms) bucket bounds — everything the collector needs to
    merge and re-export without importing the publishing process's
    modules. Series label-tuples serialize as lists (JSON has no
    tuples); the collector converts them back. ``status`` is an
    optional small dict of per-INSTANCE levels (queue depth, inflight)
    riding the payload itself — the honest load signal when several
    instances share one process registry (N in-process replicas would
    overwrite each other's process-wide gauges), surfaced on the
    collector's instance rows."""
    reg = registry if registry is not None else _metrics.registry()
    snap = reg.snapshot()
    payload_metrics: dict = {}
    for name, rec in snap.items():
        m = reg.get(name)
        entry = {
            "type": rec["type"],
            "labels": list(rec["labels"]),
            "help": m.help if m is not None else "",
            "series": [{"key": list(key), "value": val}
                       for key, val in rec["series"].items()],
        }
        if rec["type"] == "histogram" and m is not None:
            entry["buckets"] = list(m.buckets)
        payload_metrics[name] = entry
    payload = {
        "format": FORMAT_VERSION,
        "instance": instance,
        "pid": os.getpid(),
        "host": socket.gethostname(),
        "role": role,
        "device_kind": _device_kind(),
        "time": time.time(),
        "seq": seq,
        "metrics": payload_metrics,
    }
    if status:
        payload["status"] = dict(status)
    return payload


class TelemetryPublisher:
    """Daemon-thread publisher: writes this process's registry snapshot
    into ``telemetry_dir`` every ``interval_s`` (atomic tmp+rename).
    ``publish_once()`` is the deterministic single-shot form tests
    drive directly; :meth:`close` publishes one final snapshot (so
    shutdown-time counters land) and stops the thread. Write failures
    degrade warn-once — telemetry is a side channel and must never take
    the path it observes down with it."""

    def __init__(self, telemetry_dir: str, *,
                 instance: "str | None" = None, role: str = "server",
                 interval_s: float = 2.0,
                 registry: "_metrics.MetricsRegistry | None" = None,
                 status_fn=None):
        if interval_s <= 0:
            raise ValueError("interval_s must be positive")
        os.makedirs(telemetry_dir, exist_ok=True)
        self.telemetry_dir = telemetry_dir
        self.role = role
        self.instance = instance if instance is not None else \
            f"{role}-{socket.gethostname()}-{os.getpid()}"
        self.path = snapshot_path(telemetry_dir, self.instance)
        self.interval_s = interval_s
        self._registry = registry
        #: optional callable returning the per-instance ``status`` dict
        #: embedded in each snapshot (see build_snapshot) — a failing
        #: status_fn degrades to no status, never a missed heartbeat
        self._status_fn = status_fn
        self._seq = 0
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None

    def __enter__(self) -> "TelemetryPublisher":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def publish_once(self) -> "str | None":
        """Build + atomically write one snapshot; returns the path, or
        None when the write failed (warn-once)."""
        from nmfx_torch.faults import warn_once

        status = None
        if self._status_fn is not None:
            try:
                status = self._status_fn()
            except Exception as e:  # degrades to a status-less (still
                # live) heartbeat, warn-once'd
                warn_once("telemetry-status-fn-failed",
                          f"telemetry status_fn failed ({e!r}); "
                          "publishing without per-instance status")
                status = None
        payload = build_snapshot(self._registry, instance=self.instance,
                                 role=self.role, seq=self._seq,
                                 status=status)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.path)
        except OSError as e:
            try:
                os.unlink(tmp)
            except OSError:  # tmp never created / already gone
                pass
            warn_once(
                "telemetry-publish-failed",
                f"could not publish telemetry snapshot to "
                f"{self.path!r} ({e}); this instance goes stale in the "
                "fleet view until a write succeeds")
            return None
        self._seq += 1
        _publishes_total.inc()
        return self.path

    def _run(self) -> None:
        while not self._stop.is_set():
            self.publish_once()
            self._stop.wait(self.interval_s)

    def start(self) -> "TelemetryPublisher":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"nmfx-telemetry-{self.instance}")
            self._thread.start()
        return self

    def close(self) -> None:
        """Stop the thread and publish one final snapshot — shutdown-
        time counter totals must reach the ledger (the collector keeps
        a dead instance's counters; only its gauges drop)."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        self.publish_once()


def serve_metrics(port: int = 0, *,
                  registry: "_metrics.MetricsRegistry | None" = None,
                  host: str = "127.0.0.1"):
    """Serve the registry's Prometheus text exposition over a stdlib
    ``http.server`` endpoint on a daemon thread (every path returns the
    payload — scrapers conventionally hit ``/metrics``). ``port=0``
    binds an ephemeral port; read the bound one from the returned
    server's ``.port``. Call ``.shutdown()`` and ``.server_close()`` to
    stop."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    reg = registry if registry is not None else _metrics.registry()

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — http.server's casing
            body = reg.prometheus_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            pass  # a scrape per interval must not spam stderr

    server = ThreadingHTTPServer((host, port), _Handler)
    server.daemon_threads = True
    server.port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name=f"nmfx-metrics-http-{server.port}")
    thread.start()
    return server
