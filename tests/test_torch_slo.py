"""The port's SLO engine (``nmfx_torch/obs/slo.py``) against
``nmfx.obs.slo``: the same registry operations in both packages, the
same injected clock, equal statuses at every evaluation (burn rates per
objective and window, alert states, transitions), equal validation; and
its wiring into the port: ``NMFXServer.stats_snapshot()["slo"]`` and the
flight dump's ``slo`` key. Host only."""

import pytest

from nmfx.obs import metrics as nmetrics
from nmfx.obs import slo as nslo
from nmfx_torch.obs import flight
from nmfx_torch.obs import metrics as pmetrics
from nmfx_torch.obs import slo as pslo
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)

PKGS = ((pmetrics, pslo), (nmetrics, nslo))


def _scripted_statuses(metrics_mod, slo_mod, steps, objectives=None):
    """Run ``steps`` (``[(now, [(metric, value, outcome), ...])]``)
    against a fresh registry of ``metrics_mod``, evaluating a fresh
    engine after each step; returns the statuses."""
    reg = metrics_mod.MetricsRegistry()
    e2e = reg.histogram("nmfx_serve_e2e_seconds", "e2e",
                        labelnames=("outcome",))
    mfu = reg.histogram("nmfx_perf_mfu", "mfu", labelnames=("kind",),
                        buckets=(0.001, 0.01, 0.1, 0.5, 1.0))
    kw = {} if objectives is None else {"objectives": objectives}
    eng = slo_mod.SLOEngine(
        snapshot_fn=lambda: slo_mod.registry_snapshot(reg), **kw)
    out = []
    for now, obs in steps:
        for metric, value, label in obs:
            if metric == "e2e":
                e2e.observe(value, outcome=label)
            else:
                mfu.observe(value, kind=label)
        out.append(eng.evaluate(now=now))
    assert eng.status() == out[-1]
    return out


#: a day of traffic: clean, then a failure burst (fast burn on
#: availability and tail latency), then recovery
STEPS = [
    (1000.0, [("e2e", 0.5, "completed")] * 20),
    (1300.0, [("e2e", 1.5, "completed")] * 40),
    (1600.0, [("e2e", 70.0, "failed")] * 30
     + [("e2e", 90.0, "deadline")] * 10),
    (1900.0, [("e2e", 0.2, "completed")] * 5),
    (6000.0, [("e2e", 0.2, "completed")] * 400),
    (30000.0, [("e2e", 2.0, "completed")] * 50
     + [("mfu", 0.004, "sweep.grid")] * 3),
    (300000.0, [("e2e", 2.0, "completed")] * 10),
]


def test_default_objectives_equal_reference():
    got, want = (_scripted_statuses(m, s, STEPS) for m, s in PKGS)
    assert got == want
    # the script really drives the alerting, both ways
    states = [st["objectives"]["availability"]["state"] for st in got]
    assert "fast_burn" in states and states[0] == "ok"
    assert any(st["alerting"] for st in got)


def test_custom_objectives_equal_reference():
    """Off-bucket latency bound (snaps down), both floor kinds and an
    explicit budget."""
    def objs(slo_mod):
        return (slo_mod.Objective("lat", kind="latency", bound_s=1.7,
                                  target=0.9),
                slo_mod.Objective("goodput", kind="floor", value="rate",
                                  floor=0.05, budget=0.5),
                slo_mod.Objective("mfu", kind="floor",
                                  metric="nmfx_perf_mfu", value="mean",
                                  floor=0.01, budget=0.25),
                slo_mod.Objective("avail", kind="availability",
                                  outcomes_bad=("failed",), target=0.95))

    got, want = (_scripted_statuses(m, s, STEPS, objs(s)) for m, s in PKGS)
    assert got == want
    assert got[-2]["objectives"]["mfu"]["burn"]["5m"] is not None


@pytest.mark.parametrize("kw", [
    dict(kind="bogus"), dict(kind="latency"), dict(kind="latency",
                                                   bound_s=1.0, target=1.0),
    dict(kind="floor", value="median"), dict(kind="availability",
                                             budget=0.0)])
def test_objective_validation_equal_reference(kw):
    for _, slo_mod in PKGS:
        with pytest.raises(ValueError):
            slo_mod.Objective("x", **kw)


def test_window_names_and_pairs_equal_reference():
    for w in (30.0, 300.0, 3600.0, 21600.0, 259200.0, 90.0):
        assert pslo._window_name(w) == nslo._window_name(w)
    assert ([tuple(vars(p).values()) for p in pslo.DEFAULT_PAIRS]
            == [tuple(vars(p).values()) for p in nslo.DEFAULT_PAIRS])
    assert ([tuple(vars(o).values()) for o in pslo.DEFAULT_OBJECTIVES]
            == [tuple(vars(o).values()) for o in nslo.DEFAULT_OBJECTIVES])


def test_server_snapshot_and_flight_dump_carry_the_status(monkeypatch):
    from nmfx_torch.serve import NMFXServer, ServeConfig

    class _Idle:
        def compatibility_key(self, req):
            return None

    monkeypatch.setattr(pslo, "_last_status", None)
    with NMFXServer(ServeConfig(), engine=_Idle(), start=False) as srv:
        snap = srv.stats_snapshot()
    status = snap["slo"]
    assert set(status["objectives"]) == {
        "availability", "latency_p99", "goodput", "mfu"}
    assert status["alerting"] == []
    assert pslo.last_status() is status
    rec = flight.FlightRecorder(max_events=4)
    rec.dump("slo-context")
    assert rec.last_dump()["slo"] == status
