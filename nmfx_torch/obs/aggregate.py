"""Fleet aggregation: merge N instance telemetry snapshots into one view
(counterpart of ``nmfx/obs/aggregate.py``).

The collector half of the fleet observatory: read every
``telemetry_*.json`` an instance published into a shared
``telemetry_dir`` (``nmfx_torch.obs.export``; the format is the
reference's, so either package's collector reads either package's
snapshots) and merge them into ONE
registry-snapshot-shaped fleet view, mirroring the single-process API —
:meth:`FleetCollector.fleet_snapshot` / :meth:`FleetCollector
.fleet_delta` are the cross-process ``MetricsRegistry.snapshot`` /
``delta``, and :meth:`FleetCollector.prometheus_text` renders through
the identical formatter (``metrics.render_prometheus``).

Merge semantics:

* **Counters sum** across instances — a fleet total is the sum of
  per-process totals, exactly.
* **Gauges key by instance**: a gauge is a per-process LEVEL (queue
  depth, inflight), so summing would fabricate a meaningless number;
  each series gains a leading ``instance`` label instead, and the
  fleet view keeps every replica's level addressable.
* **Histograms merge bucket-wise**: counts, sums, and per-bucket
  counts add; min/max combine. Because the state is a pure bucket sum,
  a quantile over the merged state (``metrics.bucket_quantile``)
  EQUALS the quantile of one histogram that observed the union of all
  instances' observations — the merged-quantile exactness contract.
* **Staleness drops gauges, keeps counters.** An instance whose
  heartbeat (the snapshot's embedded ``time``) is older than
  ``stale_after_s`` is dead-until-proven-alive: its gauges describe a
  level that no longer exists and drop from the fleet view, while its
  counters/histograms are monotone history that still happened and
  stay in the fleet totals.
* **Torn tolerance.** Unreadable / foreign-format / non-dict files are
  skipped warn-once (the checkpoint ledger's torn-record discipline) —
  one crashed writer can never take the fleet view down. Cross-
  instance schema conflicts (same metric name, different type, labels,
  or buckets) are resolved deterministically: the FIRST instance (by
  sorted instance name) to declare a metric fixes its schema, and
  every conflicting later instance's series for that metric is skipped
  warn-once rather than merged apples-into-oranges — a conflict is a
  deployment bug (mixed incompatible versions) the warn-once surfaces;
  the merge just refuses to hide it behind a corrupted sum.

Stdlib-only, like the rest of ``nmfx_torch.obs``.
"""

from __future__ import annotations

import json
import os
import time

from nmfx_torch.obs import metrics as _metrics
from nmfx_torch.obs.export import FILE_PREFIX, FORMAT_VERSION

__all__ = ["FleetCollector", "merge_payloads"]


def _load_payloads(telemetry_dir: str) -> "dict[str, dict]":
    """Read every telemetry snapshot in the directory; torn/foreign
    files are skipped warn-once."""
    from nmfx_torch.faults import warn_once

    out: "dict[str, dict]" = {}
    try:
        names = sorted(os.listdir(telemetry_dir))
    except OSError:
        return out
    for name in names:
        if not (name.startswith(FILE_PREFIX)
                and name.endswith(".json")):
            continue
        path = os.path.join(telemetry_dir, name)
        try:
            with open(path) as f:
                payload = json.load(f)
            if not isinstance(payload, dict) \
                    or payload.get("format") != FORMAT_VERSION \
                    or not isinstance(payload.get("metrics"), dict):
                raise ValueError("not a telemetry snapshot "
                                 f"(format {payload.get('format')!r})"
                                 if isinstance(payload, dict)
                                 else "not a JSON object")
        except (OSError, ValueError) as e:
            warn_once(
                "fleet-snapshot-torn",
                f"telemetry snapshot {path!r} is torn/corrupt/foreign "
                f"({e}); skipping it — the writing instance reads as "
                "stale until it publishes a good snapshot")
            continue
        instance = str(payload.get("instance") or name)
        out[instance] = payload
    return out


def merge_payloads(payloads: "dict[str, dict]",
                   stale: "frozenset[str] | set[str]" = frozenset()
                   ) -> dict:
    """Pure merge of instance payloads (``{instance: payload}``) into
    one registry-snapshot-shaped dict (series keyed by label-value
    TUPLES, like ``MetricsRegistry.snapshot``), applying the module
    docstring's semantics. ``stale`` names the instances whose gauges
    drop. Factored pure so tests can merge handcrafted universes."""
    from nmfx_torch.faults import warn_once

    merged: dict = {}
    for instance in sorted(payloads):
        payload = payloads[instance]
        is_stale = instance in stale
        for name, entry in payload["metrics"].items():
            kind = entry.get("type")
            labels = tuple(entry.get("labels", ()))
            buckets = tuple(entry.get("buckets", ()) or ())
            if kind == "gauge" and is_stale:
                continue
            out_labels = (("instance",) + labels if kind == "gauge"
                          else labels)
            rec = merged.get(name)
            if rec is None:
                rec = merged[name] = {
                    "type": kind, "labels": out_labels,
                    "help": entry.get("help", ""), "series": {}}
                if kind == "histogram":
                    rec["buckets"] = buckets
            elif (rec["type"] != kind or rec["labels"] != out_labels
                  or (kind == "histogram"
                      and rec["buckets"] != buckets)):
                warn_once(
                    "fleet-metric-conflict",
                    f"instance {instance!r} publishes metric {name!r} "
                    f"as {kind} labels={out_labels} "
                    f"buckets={buckets or None}, conflicting with the "
                    "schema fixed by the first (sorted) instance that "
                    "declared it; skipping this instance's series for "
                    "this metric — mixed incompatible versions in one "
                    "fleet is a deployment bug, and a merge across two "
                    "schemas would hide it behind a corrupted sum")
                continue
            for srec in entry.get("series", ()):
                key = tuple(str(v) for v in srec["key"])
                val = srec["value"]
                if kind == "counter":
                    rec["series"][key] = rec["series"].get(key, 0.0) \
                        + float(val)
                elif kind == "gauge":
                    rec["series"][(instance,) + key] = float(val)
                elif kind == "histogram":
                    cur = rec["series"].get(key)
                    if cur is None:
                        rec["series"][key] = {
                            "count": int(val["count"]),
                            "sum": float(val["sum"]),
                            "min": val["min"], "max": val["max"],
                            "bucket_counts":
                                list(val["bucket_counts"])}
                    else:
                        _metrics.merge_bucket_state(
                            cur, {"count": int(val["count"]),
                                  "sum": float(val["sum"]),
                                  "min": val["min"],
                                  "max": val["max"],
                                  "bucket_counts":
                                      val["bucket_counts"]})
                else:
                    rec["series"][(instance,) + key] = val
    return merged


class FleetCollector:
    """Merge a ``telemetry_dir``'s instance snapshots into one fleet
    view (see the module docstring for the semantics)."""

    def __init__(self, telemetry_dir: str, *,
                 stale_after_s: float = 10.0):
        if stale_after_s <= 0:
            raise ValueError("stale_after_s must be positive")
        self.telemetry_dir = telemetry_dir
        self.stale_after_s = stale_after_s

    # -- raw collection ----------------------------------------------------
    def collect(self) -> "dict[str, dict]":
        """``{instance: payload}`` of every readable snapshot."""
        return _load_payloads(self.telemetry_dir)

    def instances(self, now: "float | None" = None,
                  payloads: "dict[str, dict] | None" = None
                  ) -> "list[dict]":
        """Per-instance identity + liveness rows (the ``nmfx-top``
        instance table): instance, pid, host, role, device kind,
        heartbeat age, and the stale classification. Pass ``payloads``
        (an earlier :meth:`collect`) to derive the rows from the same
        ledger read as a sibling :meth:`fleet_snapshot` — one frame,
        one consistent cut."""
        now = time.time() if now is None else now
        if payloads is None:
            payloads = self.collect()
        rows = []
        for instance, payload in payloads.items():
            age = now - float(payload.get("time", 0.0))
            row = {
                "instance": instance,
                "pid": payload.get("pid"),
                "host": payload.get("host"),
                "role": payload.get("role"),
                "device_kind": payload.get("device_kind"),
                "seq": payload.get("seq"),
                "heartbeat_age_s": round(age, 3),
                "stale": age > self.stale_after_s,
            }
            # per-instance status levels embedded in the payload:
            # the honest queue/inflight signal when N
            # replicas share one process registry — see
            # export.build_snapshot
            status = payload.get("status")
            if isinstance(status, dict):
                row.update({k: v for k, v in status.items()
                            if k not in row})
            rows.append(row)
        return rows

    def _stale_set(self, payloads: dict,
                   now: "float | None") -> "set[str]":
        now = time.time() if now is None else now
        return {instance for instance, payload in payloads.items()
                if now - float(payload.get("time", 0.0))
                > self.stale_after_s}

    # -- the registry-API mirror -------------------------------------------
    def fleet_snapshot(self, now: "float | None" = None,
                       payloads: "dict[str, dict] | None" = None
                       ) -> dict:
        """The merged fleet view, shaped exactly like
        ``MetricsRegistry.snapshot()`` (plus ``help``/``buckets``
        enrichment) — every consumer of a process snapshot (the SLO
        engine, ``snapshot_delta``, the Prometheus renderer) consumes
        this unchanged. ``payloads`` reuses an earlier
        :meth:`collect` read instead of re-scanning the ledger."""
        if payloads is None:
            payloads = self.collect()
        return merge_payloads(payloads,
                              self._stale_set(payloads, now))

    def fleet_delta(self, prev: dict,
                    now: "float | None" = None) -> dict:
        """What changed fleet-wide since ``prev`` (an earlier
        :meth:`fleet_snapshot`) — ``metrics.snapshot_delta``, the same
        arithmetic as the single-process ``MetricsRegistry.delta``."""
        return _metrics.snapshot_delta(self.fleet_snapshot(now), prev)

    def prometheus_text(self, now: "float | None" = None) -> str:
        """Merged Prometheus exposition — the fleet's ``/metrics``."""
        return _metrics.render_prometheus(self.fleet_snapshot(now))

    def quantile(self, metric: str, q: float,
                 snapshot: "dict | None" = None,
                 **labels) -> "float | None":
        """Bucket-interpolated quantile of one merged histogram series
        (``metrics.bucket_quantile`` over the merged state — equals
        the union-of-observations quantile)."""
        snap = snapshot if snapshot is not None else \
            self.fleet_snapshot()
        rec = snap.get(metric)
        if rec is None or rec["type"] != "histogram":
            return None
        key = tuple(str(labels[name]) for name in rec["labels"]
                    if name in labels)
        if len(key) != len(rec["labels"]):
            raise ValueError(
                f"expected labels {rec['labels']}, got {tuple(labels)}")
        st = rec["series"].get(key)
        if st is None:
            return None
        return _metrics.bucket_quantile(rec["buckets"], st, q)
