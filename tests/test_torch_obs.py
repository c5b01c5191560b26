"""The port's observability core (``nmfx_torch/obs``), as
``tests/test_obs.py`` pins the reference's: the tracer's export
round-trip and ring, the metrics registry's exactness under concurrent
writers, Prometheus exposition, the flight recorder's ring, redaction
and dump, and the fault-site / degradation plumbing. Beside them,
parity with ``nmfx.obs``: the same operations through both packages give
equal snapshots and deltas and byte-equal Prometheus text, the same
Chrome-trace structure and the same flight-dump payload (times
stripped); and the emission wired into the port's checkpoint ledger,
input cache and telemetry export. Host only, on the CPU."""

import http.client
import json
import os
import threading
from collections import deque

import numpy as np
import pytest

import nmfx_torch
from nmfx import faults as nfaults
from nmfx.obs import costmodel as ncm
from nmfx.obs import flight as nflight
from nmfx.obs import metrics as nmetrics
from nmfx.obs import slo as nslo
from nmfx.obs import trace as ntrace
from nmfx_torch import faults
from nmfx_torch.datasets import two_group_matrix
from nmfx_torch.obs import costmodel as cm
from nmfx_torch.obs import export, flight, metrics, trace
from nmfx_torch.obs import slo as pslo
from nmfx_torch.obs.trace import Tracer
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _pristine_faults():
    for f in (faults, nfaults):
        f.disarm()
        f._reset_warned()
    yield
    for f in (faults, nfaults):
        f.disarm()
        f._reset_warned()


# ---------------------------------------------------------------------
# tracer: recording, export round-trip, per-thread nesting
# ---------------------------------------------------------------------

def _x_events_by_tid(chrome: dict) -> dict:
    out: dict = {}
    for ev in chrome["traceEvents"]:
        if ev.get("ph") == "X":
            out.setdefault(ev["tid"], []).append(ev)
    return out


def _assert_properly_nested(events: list) -> None:
    """On one thread, complete events form a forest: two intervals are
    disjoint or one contains the other."""
    stack = []
    for ev in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
        start, end = ev["ts"], ev["ts"] + ev["dur"]
        while stack and start >= stack[-1] - 1e-6:
            stack.pop()
        if stack:
            assert end <= stack[-1] + 1e-6, \
                f"span {ev['name']} overlaps its sibling/parent"
        stack.append(end)


def test_trace_export_round_trip_nested_per_thread(tmp_path):
    """N threads of nested spans export as valid Chrome trace JSON with
    per-thread proper nesting and thread-name metadata."""
    import time

    tr = Tracer()
    tr.enabled = True
    n_threads, m = 4, 25
    # all workers alive at once: a reused thread ident would merge two
    # workers onto one trace track
    barrier = threading.Barrier(n_threads)

    def work(i):
        barrier.wait(timeout=30)
        for j in range(m):
            with tr.span("outer", args={"i": i, "j": j}):
                with tr.span("inner"):
                    pass
                # a retroactive span sized inside the post-inner gap
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < 2e-6:
                    pass
                tr.complete("retro", (time.perf_counter() - t0) / 2)

    threads = [threading.Thread(target=work, args=(i,), name=f"obs-w{i}")
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    path = tmp_path / "trace.json"
    tr.export(str(path))
    chrome = json.loads(path.read_text())
    by_tid = _x_events_by_tid(chrome)
    assert len(by_tid) == n_threads
    meta = {ev["tid"]: ev["args"]["name"]
            for ev in chrome["traceEvents"] if ev.get("ph") == "M"}
    for tid, events in by_tid.items():
        assert meta[tid].startswith("obs-w")
        names = [e["name"] for e in events]
        assert names.count("outer") == m
        assert names.count("inner") == m
        assert names.count("retro") == m
        _assert_properly_nested(events)
        outers = [(e["ts"], e["ts"] + e["dur"]) for e in events
                  if e["name"] == "outer"]
        for e in events:
            if e["name"] == "outer":
                continue
            assert any(lo - 1e-6 <= e["ts"]
                       and e["ts"] + e["dur"] <= hi + 1e-6
                       for lo, hi in outers), \
                f"{e['name']} not contained in any outer span"


def test_tracer_disabled_records_nothing():
    tr = Tracer()
    with tr.span("a"):
        pass
    tr.complete("b", 0.1)
    tr.instant("c")
    assert tr.event_count() == 0


def test_tracer_ring_bound_drops_oldest():
    tr = Tracer(max_events=10)
    tr.enabled = True
    for i in range(25):
        tr.complete(f"s{i}", 1e-6)
    assert tr.event_count() == 10
    assert tr.dropped == 15
    assert [e["name"] for e in tr.events()] == [f"s{i}"
                                                for i in range(15, 25)]


def test_traced_decorator():
    tr = trace.default_tracer()
    tr.clear()

    @trace.traced
    def plain(x):
        return x + 1

    @trace.traced("custom.name")
    def named():
        return 7

    assert plain(1) == 2 and named() == 7  # disabled: passthrough
    assert tr.event_count() == 0
    trace.enable()
    try:
        assert plain(2) == 3 and named() == 7
    finally:
        trace.disable()
    names = {e["name"] for e in tr.events()}
    assert "custom.name" in names
    assert any(n.endswith("plain") for n in names)
    tr.clear()


def test_profiler_phases_become_tracer_spans():
    """Phases, marks and worker-style add_seconds land on the process
    tracer's timeline; the NullProfiler keeps the emission but no
    books."""
    from nmfx_torch.profiling import NullProfiler, Profiler

    tr = trace.default_tracer()
    tr.clear()
    trace.enable()
    try:
        prof = Profiler()
        with prof.phase("real.phase"):
            pass
        prof.mark("real.mark")
        prof.add_seconds("post.worker", 0.005)
        null = NullProfiler()
        with null.phase("null.phase"):
            pass
        null.add_seconds("null.retro", 0.003)
        null.mark("null.mark")
    finally:
        trace.disable()
    events = tr.events()
    names = {e["name"] for e in events}
    assert {"real.phase", "real.mark", "post.worker", "null.phase",
            "null.retro", "null.mark"} <= names
    by_name = {e["name"]: e for e in events}
    assert by_name["real.phase"]["ph"] == "X"
    assert by_name["real.mark"]["ph"] == "i"
    assert by_name["null.retro"]["ph"] == "X"
    assert by_name["null.retro"]["dur"] == pytest.approx(3000, rel=1e-6)
    assert null.phases == {}
    assert prof.phases["real.phase"].count == 1
    tr.clear()


# ---------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------

def test_concurrent_writers_exact_counts():
    """N threads x M increments across S labeled series of one counter
    (plus a histogram): the final counts are exact."""
    import sys

    c = metrics.counter("test_torch_stress_total", "stress", ("series",))
    h = metrics.histogram("test_torch_stress_seconds", "stress",
                          ("series",))
    n_threads, m, n_series = 8, 250, 4

    def work(i):
        for j in range(m):
            s = str((i + j) % n_series)
            c.inc(series=s)
            h.observe(0.01 * ((i + j) % 3), series=s)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert c.total() == n_threads * m
    assert sum(st["count"] for st in h.series().values()) == n_threads * m
    for s in range(n_series):
        assert c.value(series=str(s)) == n_threads * m // n_series


def test_counter_is_monotonic_and_label_checked():
    c = metrics.counter("test_torch_mono_total", "", ("a",))
    with pytest.raises(ValueError):
        c.inc(-1, a="x")
    with pytest.raises(ValueError):
        c.inc(wrong="x")
    with pytest.raises(ValueError):  # type conflict on redeclare
        metrics.gauge("test_torch_mono_total")
    with pytest.raises(ValueError):  # label conflict on redeclare
        metrics.counter("test_torch_mono_total", "", ("b",))
    assert metrics.counter("test_torch_mono_total", "", ("a",)) is c


def test_histogram_quantiles_and_extremes():
    h = metrics.histogram("test_torch_quant_seconds", "")
    for v in [0.002, 0.004, 0.008, 0.02, 0.04, 0.08, 0.2, 0.4, 0.8, 2.0]:
        h.observe(v)
    st = h.series()[()]
    assert st["count"] == 10
    assert st["min"] == 0.002 and st["max"] == 2.0
    assert h.quantile(0.0) == 0.002
    assert h.quantile(1.0) == 2.0
    assert 0.01 <= h.quantile(0.5) <= 0.1
    assert h.quantile(0.99) <= 2.0


def test_snapshot_delta_windowing():
    c = metrics.counter("test_torch_delta_total", "", ("lab",))
    g = metrics.gauge("test_torch_delta_gauge", "")
    h = metrics.histogram("test_torch_delta_seconds", "")
    c.inc(3, lab="a")
    g.set(5)
    h.observe(0.1)
    snap = metrics.registry().snapshot()
    c.inc(2, lab="a")
    c.inc(1, lab="b")
    g.set(9)
    h.observe(0.2)
    h.observe(0.3)
    d = metrics.registry().delta(snap)
    assert d["test_torch_delta_total"]["series"][("a",)] == 2
    assert d["test_torch_delta_total"]["series"][("b",)] == 1
    assert d["test_torch_delta_gauge"]["series"][()] == 9  # a level
    hd = d["test_torch_delta_seconds"]["series"][()]
    assert hd["count"] == 2
    assert hd["sum"] == pytest.approx(0.5)


def test_prometheus_text_exposition():
    c = metrics.counter("test_torch_promtext_total", "a counter", ("lab",))
    c.inc(2, lab="x")
    h = metrics.histogram("test_torch_promtext_seconds", "a histogram",
                          buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    text = metrics.registry().prometheus_text()
    assert '# TYPE test_torch_promtext_total counter' in text
    assert 'test_torch_promtext_total{lab="x"} 2' in text
    assert '# TYPE test_torch_promtext_seconds histogram' in text
    assert 'test_torch_promtext_seconds_bucket{le="0.1"} 1' in text
    assert 'test_torch_promtext_seconds_bucket{le="1.0"} 2' in text
    assert 'test_torch_promtext_seconds_bucket{le="+Inf"} 3' in text
    assert 'test_torch_promtext_seconds_count 3' in text
    assert 'test_torch_promtext_seconds_sum' in text


def test_shim_counters_are_registry_backed():
    """The checkpoint and data-cache read shims read the same registry
    series the exposition exports, under the reference's names."""
    from nmfx_torch import checkpoint, data_cache

    reg = metrics.registry()
    pairs = [
        (data_cache.transfer_count, "nmfx_data_h2d_transfers_total"),
        (data_cache.h2d_bytes, "nmfx_data_h2d_bytes_total"),
        (checkpoint.chunks_solved_count, "nmfx_ckpt_chunks_solved_total"),
        (checkpoint.chunks_loaded_count, "nmfx_ckpt_chunks_loaded_total"),
    ]
    for shim, name in pairs:
        m = reg.get(name)
        assert m is not None, name
        assert shim() == int(sum(m.series().values())), name
    for name in ("nmfx_result_cache_extended_total",
                 "nmfx_data_cache_evictions_total"):
        assert reg.get(name) is not None, name


# ---------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------

def test_flight_ring_bounded_and_redacted():
    rec = flight.FlightRecorder(max_events=8)
    rec.record("cat.small", x=1, ok=True)
    rec.record("cat.big", blob="z" * 10_000,
               **{f"k{i}": i for i in range(40)})
    big = next(e for e in rec.events() if e["category"] == "cat.big")
    assert len(big["blob"]) < 300 and "…" in big["blob"]
    assert big["redacted_keys"] > 0
    for i in range(20):
        rec.record("cat.flood", i=i)
    assert len(rec.events()) == 8
    assert rec.dropped > 0


def test_flight_dump_writes_only_when_configured(tmp_path):
    rec = flight.FlightRecorder()
    rec.record("ev.one", detail="x")
    assert rec.dump("no-dir") is None  # never litters the cwd
    assert rec.last_dump()["reason"] == "no-dir"
    rec.configure(str(tmp_path))
    path = rec.dump("unit test/reason", extra={"err": ValueError("b")})
    assert path is not None
    art = json.loads(open(path).read())
    assert art["reason"] == "unit test/reason"
    assert art["extra"]["err"] == "b"
    assert any(e["category"] == "ev.one" for e in art["events"])
    explicit = rec.dump("explicit", path=str(tmp_path / "here.json"))
    assert explicit == str(tmp_path / "here.json")


def test_fault_fire_lands_flight_event():
    """Every armed fault FIRE books the site's FAULT_EVENTS category,
    and arming itself is on the record."""
    rec = flight.default_recorder()
    before = len(rec.events("fault.compile.build"))
    with faults.scoped("compile.build", every=2):
        assert not faults.fire("compile.build")  # hit 1: no fire
        assert faults.fire("compile.build")      # hit 2: fires
    evs = rec.events("fault.compile.build")
    assert len(evs) == before + 1
    assert evs[-1]["site"] == "compile.build"
    assert evs[-1]["hit"] == 2
    assert any(e["site"] == "compile.build"
               for e in rec.events("fault.armed"))


def test_warn_once_records_every_degradation():
    """The warning dedups per category; the flight record does not."""
    rec = flight.default_recorder()
    before = len(rec.events("degradation"))
    with pytest.warns(RuntimeWarning, match="first"):
        faults.warn_once("test-torch-obs-cat", "first")
    faults.warn_once("test-torch-obs-cat", "second (no warning)")
    evs = rec.events("degradation")
    assert len(evs) == before + 2
    assert evs[-1]["degradation"] == "test-torch-obs-cat"
    assert evs[-1]["msg"].startswith("second")


def test_armed_sites_appear_in_dump(tmp_path):
    rec = flight.default_recorder()
    with faults.scoped("h2d.transfer", every=3):
        path = rec.dump("armed-check", path=str(tmp_path / "dump.json"))
    art = json.loads(open(path).read())
    assert "h2d.transfer" in art["armed_fault_sites"]


def test_fault_events_cover_every_site():
    """FAULT_EVENTS covers the port's 13 sites, with the reference's
    categories."""
    assert flight.fault_event_categories() == frozenset(faults.SITES)
    assert len(faults.SITES) == 13
    assert flight.FAULT_EVENTS == nflight.FAULT_EVENTS


# ---------------------------------------------------------------------
# parity with nmfx.obs
# ---------------------------------------------------------------------

def _drive_registry(mod, reg):
    """One sequence of instrument operations on ``reg`` (a registry of
    ``mod``'s package); returns the snapshot taken half-way."""
    c = reg.counter("parity_requests_total", "requests", ("route",))
    g = reg.gauge("parity_depth", "queue depth")
    h = reg.histogram("parity_wait_seconds", "wait", ("route",),
                      buckets=(0.01, 0.1, 1.0))
    plain = reg.counter("parity_plain_total", "no labels")
    c.inc(route="grid")
    c.inc(2.5, route="per_k")
    g.set(3)
    h.observe(0.005, route="grid")
    h.observe(0.5, route="grid")
    snap = reg.snapshot()
    c.inc(4, route="grid")
    g.inc(2)
    h.observe(7.0, route="per_k")
    plain.inc(1e12)
    assert isinstance(reg, mod.MetricsRegistry)
    return snap


def test_registry_parity_with_reference():
    """Fresh registries of both packages through the same operations:
    equal snapshot() and delta(), byte-equal prometheus_text()."""
    mine, ref = metrics.MetricsRegistry(), nmetrics.MetricsRegistry()
    snap_mine = _drive_registry(metrics, mine)
    snap_ref = _drive_registry(nmetrics, ref)
    assert snap_mine == snap_ref
    assert mine.snapshot() == ref.snapshot()
    assert mine.delta(snap_mine) == ref.delta(snap_ref)
    assert mine.prometheus_text().encode() == ref.prometheus_text().encode()
    for q in (0.0, 0.5, 0.99, 1.0):
        assert (mine.get("parity_wait_seconds").quantile(q, route="grid")
                == ref.get("parity_wait_seconds").quantile(q, route="grid"))


def _drive_tracer(tr):
    tr.enabled = True
    with tr.span("outer", cat="phase", args={"k": 2}):
        with tr.span("inner"):
            pass
        tr.instant("mark", args={"hit": True})
    tr.complete("retro", 0.001, cat="phase")
    with tr.span("after"):
        pass


def _strip_times(chrome: dict) -> dict:
    events = [{k: v for k, v in ev.items() if k not in ("ts", "dur")}
              for ev in chrome["traceEvents"]]
    meta = {k: v for k, v in chrome["metadata"].items()
            if k != "nmfx_t0_epoch_s"}
    return {**chrome, "traceEvents": events, "metadata": meta}


def test_chrome_trace_structure_matches_reference():
    mine, ref = Tracer(), ntrace.Tracer()
    _drive_tracer(mine)
    _drive_tracer(ref)
    got, want = mine.chrome_trace(), ref.chrome_trace()
    assert set(got["metadata"]) == set(want["metadata"])
    assert _strip_times(got) == _strip_times(want)


def _strip_dump(art: dict) -> dict:
    art = {k: v for k, v in art.items() if k != "t_epoch_s"}
    art["events"] = [{k: v for k, v in ev.items()
                      if k not in ("t_mono_s", "t_epoch_s")}
                     for ev in art["events"]]
    return art


def test_flight_dump_payload_matches_reference(monkeypatch):
    """Fresh recorders of both packages, the same events, the same armed
    site: equal dump payloads once times are stripped."""
    # no attribution or SLO status left behind by earlier tests
    monkeypatch.setattr(ncm, "_recent", deque(maxlen=256))
    monkeypatch.setattr(cm, "_recent", deque(maxlen=256))
    monkeypatch.setattr(nslo, "_last_status", None)
    monkeypatch.setattr(pslo, "_last_status", None)
    payloads = []
    for rec_cls, fmod in ((flight.FlightRecorder, faults),
                          (nflight.FlightRecorder, nfaults)):
        rec = rec_cls(max_events=4)
        rec.record("cache.evict", cache="data", nbytes=123,
                   fingerprint="abcdef012345")
        rec.record("ckpt.commit", k=2, r0=0, r1=5)
        rec.record("degradation", degradation="x", msg="y" * 400)
        for i in range(3):
            rec.record("flood", i=i, category="shadowed")
        with fmod.scoped("solve.nonfinite", lanes=((2, 1),)):
            rec.dump("parity", extra={"err": RuntimeError("boom")})
        payloads.append(_strip_dump(rec.last_dump()))
    assert payloads[0] == payloads[1]
    assert payloads[0]["dropped_events"] == 2
    assert list(payloads[0]["armed_fault_sites"]) == ["solve.nonfinite"]


# ---------------------------------------------------------------------
# emission wired through the port
# ---------------------------------------------------------------------

def test_checkpointed_sweep_emits_counters_spans_and_events(tmp_path):
    """A checkpointed CPU sweep: the registry delta of the chunk counter
    equals the shim's delta and the chunk count, one ``ckpt.commit``
    span and flight event per chunk; a widened restart budget extends
    the ledger (``ckpt.extend``, ``result_cache.extend``, the extended
    counter)."""
    from nmfx_torch import checkpoint

    a = two_group_matrix(40, 6, seed=2)
    reg = metrics.registry()
    rec = flight.default_recorder()
    tr = trace.default_tracer()
    tr.clear()
    snap = reg.snapshot()
    s0 = checkpoint.chunks_solved_count()
    c0 = len(rec.events("ckpt.commit"))

    def run(restarts):
        return nmfx_torch.nmfconsensus(
            a, ks=(2, 3), restarts=restarts, max_iter=30, device="cpu",
            checkpoint=nmfx_torch.CheckpointConfig(
                directory=str(tmp_path), every_n_restarts=2))

    trace.enable()
    try:
        run(4)  # 2 ranks x 2 chunks
    finally:
        trace.disable()
    d = reg.delta(snap)
    solved = d["nmfx_ckpt_chunks_solved_total"]["series"][()]
    assert solved == checkpoint.chunks_solved_count() - s0 == 4
    assert len(rec.events("ckpt.commit")) - c0 == 4
    spans = [e for e in tr.events() if e["name"] == "ckpt.commit"]
    assert len(spans) == 4 and all(e["cat"] == "ckpt" for e in spans)
    assert {(e["args"]["k"], e["args"]["r0"]) for e in spans} == {
        (2, 0), (2, 2), (3, 0), (3, 2)}
    tr.clear()

    snap = reg.snapshot()
    e0 = len(rec.events("ckpt.extend"))
    run(6)  # one more chunk a rank: 4 loaded, 2 solved
    d = reg.delta(snap)
    assert d["nmfx_ckpt_chunks_loaded_total"]["series"][()] == 4
    assert d["nmfx_ckpt_chunks_solved_total"]["series"][()] == 2
    assert d["nmfx_result_cache_extended_total"]["series"][()] == 1
    assert len(rec.events("ckpt.extend")) == e0 + 1
    assert rec.events("result_cache.extend")[-1]["loaded"] == 4


def test_data_cache_counters_and_eviction_event():
    from nmfx_torch import data_cache
    from nmfx_torch.data_cache import DataCache

    cache = DataCache(max_entries=1)
    cfg = nmfx_torch.SolverConfig()
    reg = metrics.registry()
    snap = reg.snapshot()
    t0, b0 = data_cache.transfer_count(), data_cache.h2d_bytes()
    ev0 = len(flight.default_recorder().events("cache.evict"))
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    cache.place(x, cfg, "cpu")
    cache.place(x, cfg, "cpu")  # hit: no copy
    cache.place(x + 1, cfg, "cpu")  # evicts x
    d = reg.delta(snap)
    assert d["nmfx_data_h2d_transfers_total"]["series"][()] == 2
    assert data_cache.transfer_count() - t0 == 2
    assert d["nmfx_data_h2d_bytes_total"]["series"][()] == 96
    assert data_cache.h2d_bytes() - b0 == 96
    assert d["nmfx_data_cache_evictions_total"]["series"][()] == 1
    evs = flight.default_recorder().events("cache.evict")
    assert len(evs) == ev0 + 1 and evs[-1]["nbytes"] == 48


# ---------------------------------------------------------------------
# telemetry export
# ---------------------------------------------------------------------

def test_publisher_snapshot_and_heartbeats(tmp_path):
    """One published snapshot round-trips through JSON with the
    reference's format; the device kind stays "unknown" without
    initializing CUDA; heartbeats carry their level."""
    import torch

    reg = metrics.MetricsRegistry()
    reg.counter("pub_total", "published").inc(3)
    reg.histogram("pub_seconds", "t", buckets=(0.5,)).observe(0.1)
    pub = export.TelemetryPublisher(str(tmp_path), instance="unit/one",
                                    registry=reg, interval_s=60.0,
                                    status_fn=lambda: {"queue": 2})
    path = pub.publish_once()
    assert path == export.snapshot_path(str(tmp_path), "unit/one")
    payload = json.loads(open(path).read())
    assert payload["format"] == export.FORMAT_VERSION
    assert payload["instance"] == "unit/one" and payload["seq"] == 0
    assert payload["status"] == {"queue": 2}
    assert payload["metrics"]["pub_total"]["series"] == [
        {"key": [], "value": 3.0}]
    assert payload["metrics"]["pub_seconds"]["buckets"] == [0.5]
    if not torch.cuda.is_initialized():
        assert payload["device_kind"] == "unknown"
        assert not torch.cuda.is_initialized()
    with pub:
        pass  # start, then close: one final publish
    assert json.loads(open(path).read())["seq"] >= 1

    ledger = export.HeartbeatLedger(str(tmp_path / "hb"))
    assert ledger.beat("r 1", level=4) is not None
    assert ledger.read("r 1")["level"] == 4
    status = ledger.status(stale_after_s=60.0)
    assert status["r 1"]["stale"] is False
    open(ledger.path("torn"), "w").write("{not json")
    assert ledger.read("torn") is None
    assert "torn" not in ledger.status()


def test_serve_metrics_endpoint_serves_the_registry():
    reg = metrics.MetricsRegistry()
    reg.counter("endpoint_total", "hits").inc(5)
    server = export.serve_metrics(0, registry=reg)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=10)
        conn.request("GET", "/metrics")
        body = conn.getresponse().read().decode()
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
    assert body == reg.prometheus_text()
    assert "endpoint_total 5" in body


def test_merge_traces_aligns_two_exports(tmp_path):
    a, b = Tracer(), Tracer()
    for tr in (a, b):
        tr.enabled = True
        tr.complete("work", 0.001)
    paths = [a.export(str(tmp_path / "a.json")),
             b.export(str(tmp_path / "b.json"))]
    merged = trace.merge_traces(paths, names=["one", "two"])
    assert merged["metadata"]["nmfx_merged"] == 2
    procs = [ev["args"]["name"] for ev in merged["traceEvents"]
             if ev.get("name") == "process_name"]
    assert set(procs) <= {"one", "two"} and procs
    assert sum(ev.get("name") == "work"
               for ev in merged["traceEvents"]) == 2
    assert os.path.exists(paths[0])


def test_rate_sites_record_their_fires():
    """The lane-rate sites never pass fire(); the port records their
    FAULT_EVENTS category where the fault lands: each poisoning of a
    rank's restarts, each batch of dropped reloads."""
    from nmfx_torch.ops.sched_mu import _stale_load_mask

    rec = flight.default_recorder()
    n0 = len(rec.events("fault.solve.nonfinite"))
    a = two_group_matrix(40, 6, seed=2)
    with faults.scoped("solve.nonfinite", lanes=((2, 1), (3, 0))):
        assert faults.poison_restarts(2, 4) == (1,)  # a query: no event
        assert len(rec.events("fault.solve.nonfinite")) == n0
        res = nmfx_torch.nmfconsensus(a, ks=(2, 4), restarts=4,
                                      max_iter=20, grid_exec="per_k",
                                      device="cpu", min_restarts=1)
    evs = rec.events("fault.solve.nonfinite")
    assert len(evs) == n0 + 1  # rank 4 poisons nothing
    assert evs[-1]["lanes"] == [1] and evs[-1]["pool"] == 4
    assert int(res.per_k[2].stop_reasons[1]) == 5
    s0 = len(rec.events("fault.sched.stale_reload"))
    with faults.scoped("sched.stale_reload", rate=0.5):
        keep = _stale_load_mask(np.arange(16))
    evs = rec.events("fault.sched.stale_reload")
    assert len(evs) == s0 + 1
    assert evs[-1]["jobs"] == np.flatnonzero(~keep).tolist()
    # the counters of the hit-counted sites are untouched
    assert faults.fires("solve.nonfinite") == 0
