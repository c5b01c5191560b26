"""Typed metrics registry: counters, gauges, histograms, one process-
wide namespace, Prometheus text exposition (counterpart of
``nmfx/obs/metrics.py``).

The port's health numbers (``checkpoint.chunks_solved_count()``,
``data_cache.transfer_count()``/``h2d_bytes()``, the cost model's
``nmfx_perf_*`` histograms) live here, in one registry a process can
snapshot atomically and export; the module functions stay as read
shims over the registry series.

Naming scheme: ``nmfx_<subsystem>_<what>`` with a ``_total`` suffix on
counters and a ``_seconds``/``_bytes`` unit suffix where applicable
(the Prometheus conventions). The names are the reference's letter for
letter, so one dashboard reads both packages.

* :class:`Counter` — monotonically increasing; labeled series.
* :class:`Gauge` — last-set value per labeled series.
* :class:`Histogram` — streaming fixed-bucket distribution (count /
  sum / min / max / cumulative bucket counts, O(1) memory per series)
  with bucket-interpolated :meth:`Histogram.quantile`.

Atomicity: ALL instrument mutation and the registry's
:meth:`MetricsRegistry.snapshot` run under ONE registry lock, so a
snapshot is a consistent cut across every series, and
``snapshot()``/``delta()`` give a windowed view. Instrument events are
coarse (transfers, chunks, dispatches — not per-iteration), so one lock
is contention-free in practice.
"""

from __future__ import annotations

import threading

from nmfx_torch.guards import guarded_by

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "bucket_quantile", "counter", "gauge", "histogram",
           "merge_bucket_state", "registry", "render_prometheus",
           "snapshot_delta"]

#: default histogram bucket upper bounds, in seconds — spans queue
#: waits (sub-ms) through cold compiles (tens of seconds)
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def bucket_quantile(buckets: "tuple[float, ...]", state: dict,
                    q: float) -> "float | None":
    """Bucket-interpolated quantile over one histogram STATE dict
    (``{"count", "min", "max", "bucket_counts"}``) — the Prometheus
    ``histogram_quantile`` estimator, factored out of
    :meth:`Histogram.quantile` so a collector (the reference's
    ``nmfx.obs.aggregate``) computes quantiles over MERGED states with
    the identical math. Because the state is a pure bucket-count sum,
    the quantile of a bucket-wise merge equals the quantile of one
    histogram that observed the union of the instances' observations.

    Returns None before any observation. ``q`` in [0, 1]."""
    if not 0.0 <= q <= 1.0:
        raise ValueError("q must be in [0, 1]")
    if not state or state.get("count", 0) == 0:
        return None
    counts = state["bucket_counts"]
    total, lo, hi = state["count"], state["min"], state["max"]
    rank = q * total
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= rank:
            lower = buckets[i - 1] if i >= 1 else 0.0
            upper = (buckets[i] if i < len(buckets)
                     else hi)  # +inf bucket: cap at observed max
            frac = (rank - cum) / c
            est = lower + (upper - lower) * max(frac, 0.0)
            # the true extremes are tracked exactly; never
            # extrapolate past them
            return min(max(est, lo), hi)
        cum += c
    return hi


def merge_bucket_state(dst: dict, src: dict) -> dict:
    """Accumulate one histogram STATE dict into another, in place:
    counts/sums/per-bucket counts add, min/max combine — the arithmetic
    :func:`bucket_quantile`'s union-exactness contract rests on.
    Returns ``dst``."""
    dst["count"] += src["count"]
    dst["sum"] += src["sum"]
    for i, c in enumerate(src["bucket_counts"]):
        dst["bucket_counts"][i] += c
    for fn, field in ((min, "min"), (max, "max")):
        vals = [v for v in (dst[field], src[field]) if v is not None]
        dst[field] = fn(vals) if vals else None
    return dst


def _label_key(labelnames: "tuple[str, ...]", labels: dict) -> tuple:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"expected labels {labelnames}, got {tuple(labels)}")
    return tuple(str(labels[name]) for name in labelnames)


class _Metric:
    """Shared series bookkeeping; subclasses define the per-series
    state and mutation. The lock is the REGISTRY's (one lock for the
    whole namespace — see the module docstring's atomicity note)."""

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: "tuple[str, ...]", lock: threading.Lock):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._series: dict = {}

    def _zero(self):
        raise NotImplementedError

    def _get_locked(self, key: tuple):
        state = self._series.get(key)
        if state is None:
            state = self._series[key] = self._zero()
        return state

    def series(self) -> dict:
        """{label-values-tuple: plain-value-or-state-dict} snapshot."""
        with self._lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> dict:
        return dict(self._series)


class Counter(_Metric):
    """Monotonic counter; ``inc()`` only (a decreasing "counter" is a
    gauge). ``value()`` reads one labeled series, ``total()`` sums
    across all series of the metric."""

    kind = "counter"

    def _zero(self) -> float:
        return 0.0

    def inc(self, amount: float = 1, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only increase; use a Gauge")
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._series[key] = self._get_locked(key) + amount

    def value(self, **labels) -> float:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            return self._series.get(key, 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._series.values())


class Gauge(_Metric):
    """Last-written value per series (queue depth, inflight count,
    resident cache bytes)."""

    kind = "gauge"

    def _zero(self) -> float:
        return 0.0

    def set(self, value: float, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._series[key] = self._get_locked(key) + amount

    def value(self, **labels) -> float:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            return self._series.get(key, 0.0)


class Histogram(_Metric):
    """Streaming fixed-bucket histogram: per series, O(1) state
    (count, sum, min, max, one count per bucket bound) regardless of
    observation volume. :meth:`quantile` interpolates inside the bucket the
    target rank lands in (the Prometheus ``histogram_quantile``
    estimator), which is exact enough for p50/p99 gating as long as
    the bounds bracket the latencies of interest."""

    kind = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets: "tuple[float, ...]" = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames, lock)
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = b

    def _zero(self) -> dict:
        return {"count": 0, "sum": 0.0, "min": None, "max": None,
                "bucket_counts": [0] * (len(self.buckets) + 1)}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        v = float(value)
        with self._lock:
            st = self._get_locked(key)
            st["count"] += 1
            st["sum"] += v
            st["min"] = v if st["min"] is None else min(st["min"], v)
            st["max"] = v if st["max"] is None else max(st["max"], v)
            for i, bound in enumerate(self.buckets):
                if v <= bound:
                    st["bucket_counts"][i] += 1
                    break
            else:
                st["bucket_counts"][-1] += 1  # +inf bucket

    def quantile(self, q: float, **labels) -> "float | None":
        """Bucket-interpolated quantile estimate for one series
        (:func:`bucket_quantile`); None before any observation.
        q in [0, 1]."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        key = _label_key(self.labelnames, labels)
        with self._lock:
            st = self._series.get(key)
            if st is None:
                return None
            st = {**st, "bucket_counts": list(st["bucket_counts"])}
        return bucket_quantile(self.buckets, st, q)

    def _snapshot_locked(self) -> dict:
        return {key: {**st, "bucket_counts": list(st["bucket_counts"])}
                for key, st in self._series.items()}


@guarded_by("_lock", "_metrics")
class MetricsRegistry:
    """One namespace of typed instruments. ``counter``/``gauge``/
    ``histogram`` are idempotent get-or-create (re-importing a module
    that declares its instruments is safe); redeclaring a name with a
    different type or label set is a loud error."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "dict[str, _Metric]" = {}

    def _declare(self, cls, name, help, labelnames, **kw) -> _Metric:
        labelnames = tuple(labelnames)
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind} with labels {m.labelnames}")
                return m
            m = cls(name, help, labelnames, self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: "tuple[str, ...]" = ()) -> Counter:
        return self._declare(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: "tuple[str, ...]" = ()) -> Gauge:
        return self._declare(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: "tuple[str, ...]" = (),
                  buckets: "tuple[float, ...]" = DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._declare(Histogram, name, help, labelnames,
                             buckets=buckets)

    def get(self, name: str) -> "_Metric | None":
        with self._lock:
            return self._metrics.get(name)

    # -- snapshot / delta --------------------------------------------------
    def snapshot(self) -> dict:
        """Atomic consistent cut of every series: one lock acquisition
        covers the whole registry, so no writer lands between two
        metrics' reads. Returns plain data —
        ``{name: {"type", "labels", "series": {label-tuple: value}}}``
        — safe to hold across a run and feed to :meth:`delta`."""
        with self._lock:
            return {name: {"type": m.kind, "labels": m.labelnames,
                           "series": m._snapshot_locked()}
                    for name, m in self._metrics.items()}

    def delta(self, prev: dict) -> dict:
        """What changed since ``prev`` (an earlier :meth:`snapshot`):
        counters and histogram counts/sums subtract, gauges report
        their CURRENT value (a gauge is a level, not a flow). Series
        absent from ``prev`` subtract from zero."""
        return snapshot_delta(self.snapshot(), prev)

    # -- exposition --------------------------------------------------------
    def prometheus_text(self) -> str:
        """The Prometheus text exposition format (the ``/metrics``
        wire format): HELP/TYPE headers then one line per series;
        histograms expose cumulative ``_bucket{le=...}`` plus ``_sum``
        and ``_count``. Served by the ``serve_metrics`` HTTP endpoint
        (``nmfx_torch.obs.export``)."""
        snap = self.snapshot()
        with self._lock:
            for name, rec in snap.items():
                m = self._metrics.get(name)
                if m is not None:
                    rec["help"] = m.help
                    if m.kind == "histogram":
                        rec["buckets"] = m.buckets
        return render_prometheus(snap)


def snapshot_delta(cur: dict, prev: dict) -> dict:
    """The windowed-view arithmetic behind :meth:`MetricsRegistry
    .delta`, over two snapshot-SHAPED dicts: counters and histogram
    counts/sums/bucket-counts subtract, gauges pass through as their
    current level. Kept apart from the registry so a collector's merged
    snapshots window with the same math."""
    out: dict = {}
    for name, rec in cur.items():
        prev_series = (prev.get(name) or {}).get("series", {})
        series = {}
        for key, val in rec["series"].items():
            if rec["type"] == "counter":
                series[key] = val - prev_series.get(key, 0.0)
            elif rec["type"] == "histogram":
                p = prev_series.get(key)
                series[key] = {
                    "count": val["count"]
                    - (p["count"] if p else 0),
                    "sum": val["sum"] - (p["sum"] if p else 0.0),
                    "bucket_counts": [
                        c - (p["bucket_counts"][i] if p else 0)
                        for i, c in
                        enumerate(val["bucket_counts"])],
                    # extremes are cumulative (cheap state holds no
                    # window); reported as-is
                    "min": val["min"], "max": val["max"],
                }
            else:
                series[key] = val
        out[name] = {"type": rec["type"], "labels": rec["labels"],
                     "series": series}
        # enrichment keys (merged and published snapshots carry them)
        # survive the windowing — a delta's histogram is only
        # interpretable against its bucket bounds
        for extra in ("help", "buckets"):
            if extra in rec:
                out[name][extra] = rec[extra]
    return out


def render_prometheus(snap: dict) -> str:
    """Render one snapshot-shaped dict as Prometheus text exposition.
    Entries may carry ``help`` (HELP header) and, for histograms, MUST
    carry ``buckets`` (the ``le=`` bounds). Factored out of the
    registry so a merged snapshot exports through the identical
    formatter."""
    def fmt_labels(labelnames, key, extra=()):
        pairs = [f'{n}="{v}"' for n, v in zip(labelnames, key)]
        pairs += [f'{n}="{v}"' for n, v in extra]
        return "{" + ",".join(pairs) + "}" if pairs else ""

    def fmt_val(v: float) -> str:
        return repr(int(v)) if float(v).is_integer() else repr(v)

    lines = []
    for name in sorted(snap):
        rec = snap[name]
        if rec["series"]:
            lines.append(f"# HELP {name} {rec.get('help', '')}")
            lines.append(f"# TYPE {name} {rec['type']}")
        for key in sorted(rec["series"]):
            val = rec["series"][key]
            if rec["type"] == "histogram":
                cum = 0
                bounds = [*rec["buckets"], "+Inf"]
                for bound, c in zip(bounds, val["bucket_counts"]):
                    cum += c
                    lines.append(
                        name + "_bucket"
                        + fmt_labels(rec["labels"], key,
                                     [("le", bound)])
                        + f" {cum}")
                lines.append(name + "_sum"
                             + fmt_labels(rec["labels"], key)
                             + f" {fmt_val(val['sum'])}")
                lines.append(name + "_count"
                             + fmt_labels(rec["labels"], key)
                             + f" {val['count']}")
            else:
                lines.append(name
                             + fmt_labels(rec["labels"], key)
                             + f" {fmt_val(val)}")
    return "\n".join(lines) + ("\n" if lines else "")


_registry = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide registry every nmfx_torch subsystem's
    instruments live in."""
    return _registry


def counter(name: str, help: str = "",
            labelnames: "tuple[str, ...]" = ()) -> Counter:
    """Get-or-create a counter on the process-wide registry."""
    return _registry.counter(name, help, labelnames)


def gauge(name: str, help: str = "",
          labelnames: "tuple[str, ...]" = ()) -> Gauge:
    return _registry.gauge(name, help, labelnames)


def histogram(name: str, help: str = "",
              labelnames: "tuple[str, ...]" = (),
              buckets: "tuple[float, ...]" = DEFAULT_BUCKETS) -> Histogram:
    return _registry.histogram(name, help, labelnames, buckets)
