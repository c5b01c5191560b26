"""nmfx_torch.obs — observability core (counterpart of ``nmfx/obs``):
tracing, metrics, flight recorder, telemetry export and the cost model.

All of it is host Python: none of these modules imports torch when it
is imported (``costmodel.device_kind`` reads torch only when it is
called), so a collector or a signal handler can load them cheaply.

* :mod:`nmfx_torch.obs.trace` — thread-aware structured span tracer
  with Chrome trace-event export. The ``Profiler``
  (``nmfx_torch/profiling.py``) books every phase on it as well.
* :mod:`nmfx_torch.obs.metrics` — typed counters/gauges/histograms
  behind one process-wide registry with labeled series, atomic
  ``snapshot()``/``delta()`` and Prometheus text exposition; the
  checkpoint ledger's and the input cache's counters live here.
* :mod:`nmfx_torch.obs.flight` — bounded ring of recent structured
  events (fault arms and fires, degradations, evictions, checkpoint
  commits) dumped as a redacted JSON postmortem.
* :mod:`nmfx_torch.obs.export` — per-process telemetry publisher
  (atomic JSON registry snapshots into a shared ``telemetry_dir``) and
  a stdlib Prometheus endpoint (``serve_metrics``).
* :mod:`nmfx_torch.obs.costmodel` — analytic per-engine FLOPs/bytes
  models, the device peak table and per-dispatch roofline attribution
  (the ``nmfx_perf_*`` histograms, ``perf_report``).
* :mod:`nmfx_torch.obs.slo` — declarative objectives evaluated as
  multi-window burn rates over registry-snapshot deltas (the serving
  tier's ``stats_snapshot()["slo"]``; flight dumps carry the last
  status).
* :mod:`nmfx_torch.obs.aggregate` — the fleet collector: merges N
  instances' telemetry snapshots (either package's) into one
  registry-shaped fleet view.
* :mod:`nmfx_torch.obs.top` — the ``nmfx-top`` dashboard (text frames,
  ``--html``) over the collector and the SLO engine; not imported here,
  it is a command (``python -m nmfx_torch.obs.top``).

Not ported: ``regress`` (the bench-trajectory judge; ROADMAP §1 item 11,
queued behind the port's own benchmark) and the cost model's XLA
cross-check (no torch counterpart). The communication half is
``costmodel.comm_model``.
"""

from __future__ import annotations

from nmfx_torch.obs import (aggregate, costmodel, export, flight, metrics,
                            slo, trace)
from nmfx_torch.obs.aggregate import FleetCollector
from nmfx_torch.obs.export import TelemetryPublisher, serve_metrics
from nmfx_torch.obs.flight import FlightRecorder
from nmfx_torch.obs.metrics import MetricsRegistry, registry
from nmfx_torch.obs.slo import Objective, SLOEngine, WindowPair
from nmfx_torch.obs.trace import Tracer, default_tracer, merge_traces, traced

__all__ = ["FleetCollector", "FlightRecorder", "MetricsRegistry",
           "Objective", "SLOEngine", "TelemetryPublisher", "Tracer",
           "WindowPair", "aggregate", "costmodel", "default_tracer",
           "export", "flight", "merge_traces", "metrics", "registry",
           "serve_metrics", "slo", "trace", "traced"]
