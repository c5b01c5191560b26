"""The port's fleet telemetry (``nmfx_torch/obs/aggregate.py``,
``nmfx_torch/obs/top.py``) against ``nmfx.obs``'s on the CPU.

The same telemetry snapshot files — written by either package's
``TelemetryPublisher`` — are read by both packages' ``FleetCollector``:
merged counters, gauges and histograms, staleness, torn and foreign
files and schema conflicts must come out equal. Both packages' ``top``
render equal text and HTML frames for one directory at one fixed
``now`` (the heartbeat ages and the HTML stamp are the only times in a
frame, and both derive from it)."""

import json
import os
import random
import warnings

import pytest

import nmfx.faults as nfaults
import nmfx.obs.aggregate as naggregate
import nmfx.obs.export as nexport
import nmfx.obs.metrics as nmetrics
import nmfx.obs.slo as nslo
import nmfx.obs.top as ntop
import nmfx_torch.faults as pfaults
import nmfx_torch.obs.aggregate as paggregate
import nmfx_torch.obs.export as pexport
import nmfx_torch.obs.metrics as pmetrics
import nmfx_torch.obs.slo as pslo
import nmfx_torch.obs.top as ptop
from nmfx_torch.analysis import witness as _witness
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _lock_order_witness():
    """The runtime lock-order witness (``nmfx_torch.analysis.witness``)
    armed for each test of this threaded suite: the port's locks record
    their acquisition orders and an inversion fails the test;
    ``NMFX_LOCK_WITNESS=0`` disarms it."""
    with _witness.guard():
        yield


WRITERS = {"nmfx": (nexport, nmetrics), "nmfx_torch": (pexport, pmetrics)}
NOW_SKEW = 5.0  # the frames' fixed "now": this many seconds after writing


@pytest.fixture(autouse=True)
def _pristine_faults():
    for f in (pfaults, nfaults):
        f.disarm()
        f._reset_warned()
    yield
    for f in (pfaults, nfaults):
        f.disarm()
        f._reset_warned()


def _registry(metrics_mod, idx, obs=()):
    reg = metrics_mod.MetricsRegistry()
    c = reg.counter("nmfx_serve_dispatches_total", "d", ("packed",))
    c.inc(10 + idx, packed="false")
    c.inc(2 * (idx + 1), packed="true")
    reg.gauge("nmfx_serve_queue_depth", "q").set(3 + idx)
    reg.gauge("nmfx_serve_inflight", "i").set(idx)
    h = reg.histogram("nmfx_serve_e2e_seconds", "e", ("outcome",))
    for v in obs:
        h.observe(v, outcome="completed" if v < 20 else "failed")
    return reg


def _publish(tdir, writer, name, idx, obs=(), role="replica",
             status=None):
    export_mod, metrics_mod = WRITERS[writer]
    pub = export_mod.TelemetryPublisher(
        str(tdir), instance=name, role=role,
        registry=_registry(metrics_mod, idx, obs),
        status_fn=(lambda: status) if status is not None else None)
    assert pub.publish_once() is not None
    return pub


def _fleet(tdir, writers, seed=7):
    """Three instances, each written by the named package, with
    histogram observations drawn from one seeded stream."""
    rng = random.Random(seed)
    for i, writer in enumerate(writers):
        obs = [rng.uniform(0.0005, 40.0) for _ in range(60)]
        _publish(tdir, writer, f"inst-{i}", i, obs,
                 status={"queue_depth": i, "inflight": 1})


def _collectors(tdir, stale_after_s=10.0):
    return (naggregate.FleetCollector(str(tdir),
                                      stale_after_s=stale_after_s),
            paggregate.FleetCollector(str(tdir),
                                      stale_after_s=stale_after_s))


def _rows(collector, now):
    return sorted((dict(r) for r in collector.instances(now)),
                  key=lambda r: r["instance"])


MIXES = [("nmfx", "nmfx", "nmfx"), ("nmfx_torch",) * 3,
         ("nmfx", "nmfx_torch", "nmfx")]


@pytest.mark.parametrize("writers", MIXES, ids=["nmfx", "port", "mixed"])
def test_merged_views_equal(tmp_path, writers):
    _fleet(tmp_path, writers)
    ncol, pcol = _collectors(tmp_path)
    nsnap, psnap = ncol.fleet_snapshot(), pcol.fleet_snapshot()
    assert psnap == nsnap
    c = psnap["nmfx_serve_dispatches_total"]["series"]
    assert c[("false",)] == sum(10 + i for i in range(3))
    g = psnap["nmfx_serve_queue_depth"]
    assert g["labels"] == ("instance",)
    assert g["series"] == {("inst-0",): 3.0, ("inst-1",): 4.0,
                           ("inst-2",): 5.0}
    assert pcol.prometheus_text() == ncol.prometheus_text()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        for outcome in ("completed", "failed"):
            assert pcol.quantile("nmfx_serve_e2e_seconds", q,
                                 snapshot=psnap, outcome=outcome) \
                == ncol.quantile("nmfx_serve_e2e_seconds", q,
                                 snapshot=nsnap, outcome=outcome)
    now = max(json.load(open(os.path.join(tmp_path, f)))["time"]
              for f in os.listdir(tmp_path)) + NOW_SKEW
    assert _rows(pcol, now) == _rows(ncol, now)


@pytest.mark.parametrize("writer", ["nmfx", "nmfx_torch"])
def test_histogram_merge_equals_union_in_both(tmp_path, writer):
    """The merged-quantile contract, read by both collectors: bucket
    counts and quantiles over the merge equal one histogram that
    observed every instance's observations."""
    rng = random.Random(11)
    all_obs = []
    for i in range(3):
        obs = [rng.uniform(0.0005, 15.0) for _ in range(80)]
        all_obs += obs
        _publish(tmp_path, writer, f"inst-{i}", i, obs)
    union = pmetrics.MetricsRegistry().histogram("u_seconds", "",
                                                 ("outcome",))
    for v in all_obs:
        union.observe(v, outcome="completed")
    for col in _collectors(tmp_path):
        snap = col.fleet_snapshot()
        st = snap["nmfx_serve_e2e_seconds"]["series"][("completed",)]
        ust = union.series()[("completed",)]
        assert st["count"] == ust["count"] == len(all_obs)
        assert st["bucket_counts"] == ust["bucket_counts"]
        for q in (0.25, 0.5, 0.99):
            assert col.quantile("nmfx_serve_e2e_seconds", q,
                                snapshot=snap, outcome="completed") \
                == union.quantile(q, outcome="completed")


@pytest.mark.parametrize("writer", ["nmfx", "nmfx_torch"])
def test_delta_equal(tmp_path, writer):
    export_mod, metrics_mod = WRITERS[writer]
    reg = _registry(metrics_mod, 0, [0.1, 0.2])
    pub = export_mod.TelemetryPublisher(str(tmp_path), instance="a",
                                        registry=reg)
    pub.publish_once()
    ncol, pcol = _collectors(tmp_path)
    nprev, pprev = ncol.fleet_snapshot(), pcol.fleet_snapshot()
    reg.counter("nmfx_serve_dispatches_total", "d",
                ("packed",)).inc(5, packed="false")
    reg.histogram("nmfx_serve_e2e_seconds", "e",
                  ("outcome",)).observe(0.3, outcome="completed")
    pub.publish_once()
    pdelta, ndelta = pcol.fleet_delta(pprev), ncol.fleet_delta(nprev)
    assert pdelta == ndelta
    assert pdelta["nmfx_serve_dispatches_total"]["series"][
        ("false",)] == 5


def test_stale_instance_handled_the_same(tmp_path):
    _publish(tmp_path, "nmfx_torch", "live", 0)
    _publish(tmp_path, "nmfx", "dead", 1)
    dead = pexport.snapshot_path(str(tmp_path), "dead")
    payload = json.load(open(dead))
    payload["time"] -= 3600.0
    json.dump(payload, open(dead, "w"))
    ncol, pcol = _collectors(tmp_path)
    now = json.load(open(pexport.snapshot_path(str(tmp_path),
                                               "live")))["time"] + 1.0
    assert _rows(pcol, now) == _rows(ncol, now)
    assert {r["instance"]: r["stale"] for r in _rows(pcol, now)} == \
        {"live": False, "dead": True}
    psnap, nsnap = pcol.fleet_snapshot(now), ncol.fleet_snapshot(now)
    assert psnap == nsnap
    # counters keep the dead instance's history, its gauges drop
    assert psnap["nmfx_serve_dispatches_total"]["series"][
        ("false",)] == 10 + 11
    assert set(psnap["nmfx_serve_queue_depth"]["series"]) == {("live",)}


def test_torn_foreign_and_conflicting_snapshots_the_same(tmp_path):
    _publish(tmp_path, "nmfx_torch", "a", 0)
    reg_b = nmetrics.MetricsRegistry()
    reg_b.gauge("nmfx_serve_dispatches_total", "now a gauge!").set(9)
    nexport.TelemetryPublisher(str(tmp_path), instance="b",
                               registry=reg_b).publish_once()
    (tmp_path / "telemetry_torn.json").write_text('{"format": 1, "met')
    (tmp_path / "telemetry_foreign.json").write_text(
        '{"format": 999, "metrics": {}}')
    (tmp_path / "telemetry_list.json").write_text("[1, 2]")
    ncol, pcol = _collectors(tmp_path)
    got = {}
    for name, col in (("nmfx", ncol), ("nmfx_torch", pcol)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            payloads = col.collect()
            snap = col.fleet_snapshot()
            # warn-once: a second read is quiet
            n_first = len(caught)
            col.collect()
            col.fleet_snapshot()
            assert len(caught) == n_first
        msgs = " ".join(str(w.message) for w in caught)
        assert "fleet-snapshot-torn" in msgs
        assert "fleet-metric-conflict" in msgs
        got[name] = (set(payloads), snap)
    assert got["nmfx_torch"] == got["nmfx"]
    assert got["nmfx_torch"][0] == {"a", "b"}
    snap = got["nmfx_torch"][1]
    assert snap["nmfx_serve_dispatches_total"]["type"] == "counter"
    assert snap["nmfx_serve_dispatches_total"]["series"][
        ("false",)] == 10


def test_collector_validation_the_same():
    for mod in (naggregate, paggregate):
        with pytest.raises(ValueError):
            mod.FleetCollector("x", stale_after_s=0)
    assert paggregate.merge_payloads({}) == naggregate.merge_payloads({})


def _frames(tdir, now):
    out = {}
    for name, agg, slo, top in (("nmfx", naggregate, nslo, ntop),
                                ("nmfx_torch", paggregate, pslo, ptop)):
        col = agg.FleetCollector(str(tdir), stale_after_s=600.0)
        frame = top.gather(col, slo.SLOEngine(
            snapshot_fn=col.fleet_snapshot), now=now)
        out[name] = (top.render_text(frame, str(tdir)),
                     top.render_html(frame, str(tdir)))
    return out


@pytest.mark.parametrize("writers", MIXES, ids=["nmfx", "port", "mixed"])
def test_top_frames_equal(tmp_path, writers):
    _fleet(tmp_path, writers)
    # a router row beside the replicas, and the request economics rows
    reg = pmetrics.MetricsRegistry()
    reg.counter("nmfx_result_cache_hits_total", "h", ("layer",)).inc(
        3, layer="router")
    reg.counter("nmfx_result_cache_misses_total", "m", ("layer",)).inc(
        1, layer="router")
    reg.histogram("nmfx_perf_mfu", "f", ("kind",)).observe(
        0.25, kind="sweep.grid")
    pexport.TelemetryPublisher(str(tmp_path), instance="router-0",
                               role="router", registry=reg).publish_once()
    now = max(json.load(open(os.path.join(tmp_path, f)))["time"]
              for f in os.listdir(tmp_path)) + NOW_SKEW
    frames = _frames(tmp_path, now)
    assert frames["nmfx_torch"] == frames["nmfx"]
    text, html_out = frames["nmfx_torch"]
    assert "roles: replica 3 live · router 1 live" in text
    assert "inst-2" in text and "slo availability" in text
    assert "economics: hit_rate=0.75" in text
    assert "mfu: sweep.grid=0.250" in text
    assert "replica 3 live" in html_out and "fleet dashboard" in html_out


def test_top_main_once_and_html_equal(tmp_path, capsys):
    _fleet(tmp_path / "t", ("nmfx_torch", "nmfx", "nmfx_torch"))
    outs = {}
    for name, top in (("nmfx", ntop), ("nmfx_torch", ptop)):
        page = tmp_path / f"{name}.html"
        assert top.main([str(tmp_path / "t"), "--once", "--html",
                         str(page), "--stale-after", "600"]) == 0
        text = capsys.readouterr().out
        # the heartbeat ages move between the two calls: compare the
        # frames with the age column (instance 34 + role 9 + pid 7 +
        # 1 + device 14 characters in, 8 wide) and the HTML stamp
        # blanked
        outs[name] = (
            [line[:65] + line[73:] for line in text.splitlines()],
            "\n".join(line for line in page.read_text().splitlines()
                      if "rendered" not in line and "s</td>" not in line))
    assert outs["nmfx_torch"] == outs["nmfx"]
    assert any("inst-1" in line for line in outs["nmfx_torch"][0])
    for top in (ntop, ptop):
        assert top.main([str(tmp_path / "empty"), "--once"]) == 0
        assert "no telemetry instances" in capsys.readouterr().out
        with pytest.raises(SystemExit):
            top.main([str(tmp_path / "t"), "--interval", "0"])
