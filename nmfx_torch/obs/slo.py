"""SLO engine: declarative objectives, multi-window burn-rate alerting
(counterpart of ``nmfx/obs/slo.py``, the same objectives, windows and
arithmetic over ``nmfx_torch.obs.metrics``).

Raw latency histograms and counters do not answer "should a router shed
load" or "should an autoscaler page someone"; an error BUDGET does.
This module evaluates declarative objectives over registry-snapshot
deltas as multi-window burn rates, the SRE-workbook alerting scheme: an
alert needs BOTH a short and a long window burning, so a single bad
second cannot page and a slow leak cannot hide.

Burn-rate model: every objective reduces a windowed delta to a **bad
fraction** in ``[0, 1]`` and owns an **error budget** (``1 - target``);
``burn = bad_frac / budget`` — burn 1.0 consumes the budget exactly at
the sustainable rate, burn 14.4 exhausts a 30-day budget in ~2 days.

* ``availability``: bad = requests resolving with a bad outcome
  (``outcomes_bad``) over all requests, from an outcome-labeled
  histogram's counts (``nmfx_serve_e2e_seconds{outcome}``).
* ``latency``: bad = requests slower than ``bound_s``, resolved from
  cumulative bucket counts (pick ``bound_s`` on a bucket bound; an
  off-bucket bound conservatively snaps DOWN, counting the whole
  straddling bucket as bad).
* ``floor``: a throughput/utilization floor — ``value="rate"`` reads
  events/second over the window (goodput), ``value="mean"`` reads the
  histogram's windowed mean (MFU); bad = the relative shortfall below
  ``floor`` (0 when at or above it, 1 when at zero). ``floor=0``
  disables burning while keeping the objective on the dashboard.

Window pairs default to the workbook's fast (5m & 1h at 14.4×) and
slow (6h & 3d at 1×) pairs. The engine keeps its own bounded snapshot
history, so it needs no TSDB: each ``evaluate()`` appends the current
snapshot and diffs against the closest retained cut at each window's
horizon (histories shorter than a window use the oldest cut — burn
over the observed lifetime, which is the honest answer at startup).

Alert transitions (ok → fast_burn/slow_burn and back) land in the
flight recorder (``slo.transition``) and on the
``nmfx_slo_alerts_total`` counter; every evaluation re-exports the
per-(objective, window) burn gauges. ``NMFXServer.stats_snapshot()
["slo"]`` carries the latest status; crash postmortems embed
:func:`last_status`. Stdlib-only, like the rest of ``nmfx_torch.obs``.
"""

from __future__ import annotations

import bisect
import dataclasses
import threading
import time
from collections import deque

from nmfx_torch.obs import metrics as _metrics

__all__ = ["DEFAULT_OBJECTIVES", "Objective", "SLOEngine", "WindowPair",
           "last_status", "registry_snapshot"]


def registry_snapshot(registry: "_metrics.MetricsRegistry | None" = None
                      ) -> dict:
    """A registry snapshot with histogram bucket bounds attached — the
    engine's default ``snapshot_fn``. The raw ``MetricsRegistry
    .snapshot()`` carries series state only; the latency objective
    resolves its bound against bucket bounds, which fleet snapshots
    (``nmfx.obs.aggregate`` in the reference; not ported yet) already
    embed and this helper adds for the process-local case."""
    reg = registry if registry is not None else _metrics.registry()
    snap = reg.snapshot()
    for name, rec in snap.items():
        if rec["type"] == "histogram":
            m = reg.get(name)
            if m is not None:
                rec["buckets"] = m.buckets
    return snap

_burn_gauge = _metrics.gauge(
    "nmfx_slo_burn_rate",
    "error-budget burn rate per objective and window (1.0 = budget "
    "consumed exactly at the sustainable rate)",
    labelnames=("objective", "window"))
_alerts_total = _metrics.counter(
    "nmfx_slo_alerts_total",
    "SLO alert state transitions", labelnames=("objective", "state"))


@dataclasses.dataclass(frozen=True)
class WindowPair:
    """One multi-window alert arm: the alert fires only when BOTH
    windows' burn rates exceed ``threshold``."""

    name: str          # the alert state it drives ("fast"/"slow")
    short_s: float
    long_s: float
    threshold: float


#: the SRE-workbook pairs: page-grade fast burn, ticket-grade slow burn
DEFAULT_PAIRS = (
    WindowPair("fast", short_s=300.0, long_s=3600.0, threshold=14.4),
    WindowPair("slow", short_s=21600.0, long_s=259200.0, threshold=1.0),
)


@dataclasses.dataclass(frozen=True)
class Objective:
    """One declarative objective over a registry metric (see the
    module docstring for the three kinds)."""

    name: str
    kind: str                          # "availability"|"latency"|"floor"
    metric: str = "nmfx_serve_e2e_seconds"
    #: good-fraction target; the error budget is ``1 - target``
    target: float = 0.99
    #: latency kind: the bound a request must resolve under
    bound_s: "float | None" = None
    #: availability kind: outcome label values that consume budget
    outcomes_bad: "tuple[str, ...]" = ("failed", "deadline")
    #: floor kind: the minimum acceptable value (0 = never burns)
    floor: float = 0.0
    #: floor kind: "rate" = count/window_s, "mean" = sum/count
    value: str = "rate"
    #: error-budget override (defaults to ``1 - target``)
    budget: "float | None" = None

    def __post_init__(self):
        if self.kind not in ("availability", "latency", "floor"):
            raise ValueError(f"unknown objective kind {self.kind!r}")
        if not 0.0 < self.target < 1.0:
            raise ValueError("target must be in (0, 1)")
        if self.kind == "latency" and self.bound_s is None:
            raise ValueError("latency objectives need bound_s")
        if self.kind == "floor" and self.value not in ("rate", "mean"):
            raise ValueError("floor value must be 'rate' or 'mean'")
        if self.budget is not None and self.budget <= 0:
            raise ValueError("budget must be positive")

    @property
    def error_budget(self) -> float:
        return self.budget if self.budget is not None \
            else 1.0 - self.target


#: the stock serving objectives: availability and tail latency burn by
#: default; the goodput/MFU floors ship at floor=0 (visible on the
#: dashboard, never burning) until a deployment sets real floors
DEFAULT_OBJECTIVES = (
    Objective("availability", kind="availability"),
    Objective("latency_p99", kind="latency", target=0.99, bound_s=60.0),
    Objective("goodput", kind="floor", value="rate", floor=0.0,
              budget=0.25),
    Objective("mfu", kind="floor", metric="nmfx_perf_mfu",
              value="mean", floor=0.0, budget=0.25),
)


def _series_delta(cur: dict, prev: dict, metric: str) -> "dict | None":
    """Delta of ONE metric's series between two snapshots (the
    ``metrics.snapshot_delta`` arithmetic, without walking the whole
    namespace)."""
    rec = cur.get(metric)
    if rec is None:
        return None
    one = {metric: rec}
    prev_one = {metric: prev[metric]} if metric in prev else {}
    return _metrics.snapshot_delta(one, prev_one)[metric]


def _bad_frac(obj: Objective, rec: "dict | None",
              window_s: float) -> "float | None":
    """Reduce one windowed metric delta to the objective's bad
    fraction; None when the metric is absent or the kind needs a
    histogram the snapshot doesn't carry."""
    if rec is None:
        return None
    if rec["type"] != "histogram":
        return None
    series = rec["series"]
    if obj.kind == "availability":
        try:
            idx = rec["labels"].index("outcome")
        except ValueError:
            return None
        total = sum(st["count"] for st in series.values())
        if total <= 0:
            return 0.0
        bad = sum(st["count"] for key, st in series.items()
                  if key[idx] in obj.outcomes_bad)
        return bad / total
    if obj.kind == "latency":
        buckets = rec.get("buckets")
        if not buckets:
            return None
        # conservative snap-down: the whole bucket straddling bound_s
        # counts as over-bound
        i = bisect.bisect_right(list(buckets), obj.bound_s) - 1
        total = bad = 0
        for st in series.values():
            total += st["count"]
            cum_le = sum(st["bucket_counts"][:i + 1]) if i >= 0 else 0
            bad += st["count"] - cum_le
        return bad / total if total > 0 else 0.0
    # floor
    if obj.floor <= 0:
        return 0.0
    if obj.value == "rate":
        got = sum(st["count"] for st in series.values()) \
            / max(window_s, 1e-9)
    else:
        count = sum(st["count"] for st in series.values())
        if count <= 0:
            return None  # no observations: nothing to judge a mean on
        got = sum(st["sum"] for st in series.values()) / count
    return min(max((obj.floor - got) / obj.floor, 0.0), 1.0)


class SLOEngine:
    """Evaluate objectives as multi-window burn rates over successive
    snapshots (process registry by default; pass a fleet collector's
    ``fleet_snapshot`` as ``snapshot_fn`` for the fleet-wide view)."""

    def __init__(self, objectives=DEFAULT_OBJECTIVES, *,
                 snapshot_fn=None, pairs=DEFAULT_PAIRS,
                 max_history: int = 4096):
        self.objectives = tuple(objectives)
        self.pairs = tuple(pairs)
        self._snapshot_fn = snapshot_fn if snapshot_fn is not None \
            else registry_snapshot
        self._lock = threading.Lock()
        self._history: "deque[tuple[float, dict]]" = deque()
        #: retention is TIME-spaced, not count-bounded: cuts land at
        #: least ``_spacing`` apart (the longest window's horizon
        #: resolved into max_history steps — ~95 s for the 3d default),
        #: so a caller evaluating every second cannot silently shrink
        #: the 6h/3d windows to minutes by churning a count-bounded
        #: ring; the retained count stays <= max_history by
        #: construction (age pruning at 1.5x the longest window)
        self._spacing = (max(p.long_s for p in self.pairs) * 1.5
                         / max(max_history, 2))
        self._state: "dict[str, str]" = {o.name: "ok"
                                         for o in self.objectives}
        self._last: "dict | None" = None

    def _ref(self, horizon: float) -> "tuple[float, dict] | None":
        """The newest retained cut at or before ``horizon`` (else the
        oldest — lifetime burn). Caller holds the lock."""
        if not self._history:
            return None
        ref = self._history[0]
        for t, snap in self._history:
            if t > horizon:
                break
            ref = (t, snap)
        return ref

    def evaluate(self, now: "float | None" = None) -> dict:
        """Take one snapshot, compute every objective's per-window burn
        rates and alert state, export the burn gauges, and record any
        state TRANSITION in the flight recorder + the alert counter.
        ``now`` is injectable for tests/replays (defaults to
        ``time.time()`` — the snapshot ledger's clock)."""
        from nmfx_torch.obs import flight as _flight

        now = time.time() if now is None else float(now)
        snap = self._snapshot_fn()
        with self._lock:
            # time-spaced retention: a cut lands only when the last
            # retained one is at least _spacing old (the CURRENT snap
            # is always the diff source below regardless), keeping the
            # oldest cut per slot so a baseline survives fast callers
            if not self._history \
                    or now - self._history[-1][0] >= self._spacing:
                self._history.append((now, snap))
            horizon = now - max(p.long_s for p in self.pairs) * 1.5
            while len(self._history) > 1 \
                    and self._history[0][0] < horizon:
                self._history.popleft()
            refs = {}
            windows = sorted({w for p in self.pairs
                              for w in (p.short_s, p.long_s)})
            for w in windows:
                refs[w] = self._ref(now - w)
        status = {"t": now, "objectives": {}, "alerting": []}
        for obj in self.objectives:
            burns: "dict[float, float | None]" = {}
            for w in windows:
                ref = refs[w]
                if ref is None:
                    burns[w] = None
                    continue
                ref_t, ref_snap = ref
                rec = _series_delta(snap, ref_snap, obj.metric)
                elapsed = max(now - ref_t, 1e-9)
                frac = _bad_frac(obj, rec, elapsed)
                burns[w] = (None if frac is None
                            else frac / obj.error_budget)
            state = "ok"
            for pair in self.pairs:
                bs, bl = burns.get(pair.short_s), burns.get(pair.long_s)
                if bs is not None and bl is not None \
                        and bs > pair.threshold and bl > pair.threshold:
                    state = f"{pair.name}_burn"
                    break
            for w, b in burns.items():
                if b is not None:
                    _burn_gauge.set(b, objective=obj.name,
                                    window=_window_name(w))
            with self._lock:
                prev_state = self._state[obj.name]
                self._state[obj.name] = state
            if state != prev_state:
                _alerts_total.inc(objective=obj.name, state=state)
                _flight.record("slo.transition", objective=obj.name,
                               from_state=prev_state, to_state=state,
                               burns={_window_name(w): round(b, 3)
                                      for w, b in burns.items()
                                      if b is not None})
            entry = {"kind": obj.kind, "state": state,
                     "error_budget": obj.error_budget,
                     "burn": {_window_name(w): b
                              for w, b in burns.items()}}
            if obj.kind == "latency":
                entry["bound_s"] = obj.bound_s
            if obj.kind == "floor":
                entry["floor"] = obj.floor
            status["objectives"][obj.name] = entry
            if state != "ok":
                status["alerting"].append(obj.name)
        with self._lock:
            self._last = status
        global _last_status
        _last_status = status
        return status

    def status(self) -> "dict | None":
        """The most recent :meth:`evaluate` result (None before the
        first)."""
        with self._lock:
            return self._last


def _window_name(seconds: float) -> str:
    for bound, unit in ((86400, "d"), (3600, "h"), (60, "m")):
        if seconds >= bound and seconds % bound == 0:
            return f"{int(seconds // bound)}{unit}"
    return f"{int(seconds)}s"


#: the most recent evaluation by ANY engine in this process — embedded
#: in flight-recorder postmortems so a crash artifact carries the SLO
#: context that preceded it (None until something evaluates)
_last_status: "dict | None" = None


def last_status() -> "dict | None":
    return _last_status
