"""The port's multi-tenant server (``nmfx_torch/serve.py``) on the CPU.

Queue mechanics — admission, priority and deadline order, cancellation,
close, drain and spill races, retries, coalescing, the watchdog — run
against ONE scriptable fake ``Engine`` shared by both packages and are
parametrized over ``nmfx_torch.serve.NMFXServer`` and
``nmfx.serve.NMFXServer``: each case asserts the same observable
outcome in both. Then the port's real engine (``ExecCacheEngine``,
``device="cpu"``): a packed request is byte-equal to its solo
``nmfconsensus(..., exec_cache=cache)`` run in every ``ConsensusResult``
field, for mu and hals on ``backend="auto"`` and ``"pallas"``; a served
request agrees with the same request through ``nmfx``'s server at the
whole-grid tier; a spill record of ``nmfx``'s readmits here field for
field; the refused settings name their ROADMAP item. Every
``result()`` and join has a timeout and every server closes, so a hang
fails one test and never stalls the suite."""

import dataclasses
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

import nmfx.faults as nfaults
import nmfx.serve as nserve
import nmfx.sweep as nsweep
import nmfx_torch.faults as pfaults
import nmfx_torch.serve as pserve
import nmfx_torch.sweep as psweep
from nmfx.config import InitConfig as NInitConfig
from nmfx.config import SolverConfig as NSolverConfig
from nmfx_torch import ExecCache, SolverConfig, nmfconsensus
from nmfx_torch.config import InitConfig
from nmfx_torch.datasets import two_group_matrix
from nmfx_torch.analysis import witness as _witness


@pytest.fixture(autouse=True)
def _lock_order_witness():
    """The runtime lock-order witness (``nmfx_torch.analysis.witness``)
    armed for each test of this threaded suite: the port's locks record
    their acquisition orders and an inversion fails the test;
    ``NMFX_LOCK_WITNESS=0`` disarms it."""
    with _witness.guard():
        yield


T = 60  # seconds: every future and join is bounded


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's solves: the problems are small,
    and the suite runs several worker processes on the same cores, where
    a thread pool per process oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pkg(name):
    if name == "nmfx_torch":
        return types.SimpleNamespace(name=name, serve=pserve,
                                     faults=pfaults,
                                     out_cls=psweep.KSweepOutput,
                                     SolverConfig=SolverConfig,
                                     InitConfig=InitConfig)
    return types.SimpleNamespace(name=name, serve=nserve, faults=nfaults,
                                 out_cls=nsweep.KSweepOutput,
                                 SolverConfig=NSolverConfig,
                                 InitConfig=NInitConfig)


@pytest.fixture(params=["nmfx_torch", "nmfx"])
def pkg(request):
    p = _pkg(request.param)
    for f in (pfaults, nfaults):
        f.disarm()
        f._reset_warned()
    yield p
    for f in (pfaults, nfaults):
        f.disarm()


@pytest.fixture(autouse=True)
def _pristine_port_faults():
    pfaults.disarm()
    pfaults._reset_warned()
    yield
    pfaults.disarm()


def _fake_raw(req, out_cls):
    """A host-side KSweepOutput per rank (block-diagonal consensus, so
    host rank selection is well-posed): the real harvest workers run
    end to end."""
    n, m = req.a.shape[1], req.a.shape[0]
    out = {}
    for k in req.ks:
        labels = np.arange(n) * k // n
        cons = (labels[:, None] == labels[None, :]).astype(np.float32)
        out[k] = out_cls(
            consensus=cons,
            iterations=np.full(req.restarts, 7, np.int32),
            dnorms=np.linspace(0.5, 0.6, req.restarts).astype(np.float32),
            stop_reasons=np.zeros(req.restarts, np.int32),
            labels=np.tile(labels, (req.restarts, 1)).astype(np.int32),
            best_w=np.ones((m, k), np.float32),
            best_h=np.ones((k, n), np.float32))
    return out


class FakeEngine:
    """Scriptable ``Engine`` for either package: records dispatch order,
    the SolverConfig each solo dispatch received and the requests it
    saw."""

    def __init__(self, out_cls, compat="shared", delay=0.0,
                 packed_fails=False):
        self.out_cls = out_cls
        self.compat = compat
        self.delay = delay
        self.packed_fails = packed_fails
        self.solo = []  # (seq, scfg)
        self.packed = []  # tuple of seqs per packed dispatch
        self.reqs = []
        self.started = threading.Event()

    def compatibility_key(self, req):
        return self.compat

    def place(self, req):
        return None

    def dispatch_solo(self, req, placed, scfg):
        self.started.set()
        if self.delay:
            time.sleep(self.delay)
        self.solo.append((req.seq, scfg))
        self.reqs.append(req)
        return _fake_raw(req, self.out_cls)

    def dispatch_packed(self, reqs, placed):
        self.started.set()
        if self.packed_fails:
            raise RuntimeError("packed path down")
        if self.delay:
            time.sleep(self.delay)
        self.packed.append(tuple(r.seq for r in reqs))
        self.reqs.extend(reqs)
        return [_fake_raw(r, self.out_cls) for r in reqs]


def _mat(n=6, m=8):
    return np.random.default_rng(0).random((m, n)).astype(np.float32)


def _srv(pkg, cfg=None, **kw):
    return pkg.serve.NMFXServer(cfg or pkg.serve.ServeConfig(), **kw)


def _eng(pkg, **kw):
    return FakeEngine(pkg.out_cls, **kw)


# ---------------------------------------------------------------------
# queue mechanics, both packages
# ---------------------------------------------------------------------

def test_queued_deadline_expires_typed_without_dispatch(pkg):
    eng = _eng(pkg)
    with _srv(pkg, engine=eng, start=False) as srv:
        f = srv.submit(_mat(), ks=(2,), restarts=2, timeout=0.02)
        time.sleep(0.08)
        srv.resume()
        with pytest.raises(pkg.serve.DeadlineExceeded):
            f.result(timeout=T)
    assert eng.solo == [] and eng.packed == []
    assert srv.stats()["deadline_expired"] == 1
    assert f.stats.latency_s is not None


def test_mid_solve_deadline_resolves_typed(pkg):
    eng = _eng(pkg, compat=None, delay=0.5)
    with _srv(pkg, engine=eng, start=False) as srv:
        f = srv.submit(_mat(), ks=(2,), restarts=2, timeout=0.25)
        srv.resume()
        with pytest.raises(pkg.serve.DeadlineExceeded):
            f.result(timeout=T)
    assert len(eng.solo) == 1


def test_admission_queue_depth_bound(pkg):
    srv = _srv(pkg, pkg.serve.ServeConfig(max_queue_depth=1),
               engine=_eng(pkg), start=False)
    try:
        f1 = srv.submit(_mat(), ks=(2,), restarts=2)
        with pytest.raises(pkg.serve.QueueFull):
            srv.submit(_mat(), ks=(2,), restarts=2)
        assert srv.stats()["rejected"] == 1
        srv.resume()
        f1.result(timeout=T)
    finally:
        srv.close()


def test_admission_pending_bytes_bound(pkg):
    a = _mat()
    srv = _srv(pkg, pkg.serve.ServeConfig(max_pending_bytes=a.nbytes + 1),
               engine=_eng(pkg), start=False)
    try:
        f1 = srv.submit(a, ks=(2,), restarts=2)
        with pytest.raises(pkg.serve.QueueFull):
            srv.submit(a, ks=(2,), restarts=2)
        srv.resume()
        f1.result(timeout=T)
        srv.submit(a, ks=(2,), restarts=2).result(timeout=T)
    finally:
        srv.close()


def test_priority_and_deadline_order(pkg):
    eng = _eng(pkg, compat=None)
    with _srv(pkg, engine=eng, start=False) as srv:
        futs = [srv.submit(_mat(), ks=(2,), restarts=2, priority=0),
                srv.submit(_mat(), ks=(2,), restarts=2, priority=0,
                           timeout=120.0),
                srv.submit(_mat(), ks=(2,), restarts=2, priority=5)]
        srv.resume()
        for f in futs:
            f.result(timeout=T)
    assert [s for s, _ in eng.solo] == [2, 1, 0]


def test_packing_respects_max_batch_requests(pkg):
    eng = _eng(pkg)
    with _srv(pkg, pkg.serve.ServeConfig(max_batch_requests=2), engine=eng,
              start=False) as srv:
        futs = [srv.submit(_mat(), ks=(2,), restarts=2) for _ in range(4)]
        srv.resume()
        for f in futs:
            f.result(timeout=T)
    assert all(len(p) <= 2 for p in eng.packed)
    assert sum(len(p) for p in eng.packed) + len(eng.solo) == 4


def test_budget_clamped_mate_is_not_packed(pkg):
    eng = _eng(pkg)
    cfg = pkg.serve.ServeConfig(max_batch_requests=4,
                                iter_rate_estimate=10.0)
    with _srv(pkg, cfg, engine=eng, start=False) as srv:
        f1 = srv.submit(_mat(), ks=(2,), restarts=2, priority=5)
        f2 = srv.submit(_mat(), ks=(2,), restarts=2, priority=5)
        f_dl = srv.submit(_mat(), ks=(2,), restarts=2, priority=0,
                          timeout=5.0)
        srv.resume()
        for f in (f1, f2, f_dl):
            f.result(timeout=T)
    assert eng.packed == [(0, 1)]
    assert [s for s, _ in eng.solo] == [2]
    clamped = eng.solo[0][1]
    assert clamped.max_iter < pkg.SolverConfig().max_iter
    step = clamped.max_iter // clamped.check_every
    assert clamped.max_iter % clamped.check_every == 0
    assert step & (step - 1) == 0  # a power-of-two multiple
    assert f_dl.stats.budget_iters == clamped.max_iter
    assert f_dl.stats.packed_requests == 1


@pytest.mark.parametrize("compat,pack", [(None, True), ("shared", False)])
def test_solo_only_when_incompatible_or_unpacked(pkg, compat, pack):
    eng = _eng(pkg, compat=compat)
    with _srv(pkg, pkg.serve.ServeConfig(pack=pack), engine=eng,
              start=False) as srv:
        futs = [srv.submit(_mat(), ks=(2,), restarts=2) for _ in range(3)]
        srv.resume()
        for f in futs:
            f.result(timeout=T)
    assert eng.packed == [] and len(eng.solo) == 3


def test_batch_linger_packs_near_simultaneous_arrivals(pkg):
    eng = _eng(pkg)
    with _srv(pkg, pkg.serve.ServeConfig(batch_linger_s=1.0),
              engine=eng) as srv:
        f1 = srv.submit(_mat(), ks=(2,), restarts=2)
        time.sleep(0.1)
        f2 = srv.submit(_mat(), ks=(2,), restarts=2)
        f1.result(timeout=T)
        f2.result(timeout=T)
    assert eng.packed == [(0, 1)]


def test_cancellation_before_dispatch(pkg):
    eng = _eng(pkg)
    with _srv(pkg, engine=eng, start=False) as srv:
        f = srv.submit(_mat(), ks=(2,), restarts=2)
        assert f.cancel()
        srv.resume()
        time.sleep(0.05)
    assert f.cancelled()
    assert eng.solo == [] and eng.packed == []
    assert srv.stats()["cancelled"] == 1


def test_submit_after_close_raises(pkg):
    srv = _srv(pkg, engine=_eng(pkg))
    srv.close()
    with pytest.raises(pkg.serve.ServerClosed):
        srv.submit(_mat(), ks=(2,), restarts=2)


def test_close_drains_inflight_and_queued_requests(pkg):
    eng = _eng(pkg, delay=0.05)
    srv = _srv(pkg, engine=eng, start=False)
    futs = [srv.submit(_mat(), ks=(2,), restarts=2) for _ in range(3)]
    srv.close()  # unpauses and drains: nothing is abandoned
    for f in futs:
        assert f.result(timeout=1) is not None
    assert srv.counters["spilled"] == 0


def test_close_cancel_pending_fails_queued(pkg):
    eng = _eng(pkg)
    srv = _srv(pkg, engine=eng, start=False)
    f = srv.submit(_mat(), ks=(2,), restarts=2)
    srv.close(cancel_pending=True)
    with pytest.raises(pkg.serve.ServerClosed) as exc:
        f.result(timeout=5)
    assert "spilled" not in str(exc.value)
    assert eng.solo == [] and srv.counters["spilled"] == 0


def test_close_races_inflight_packed_dispatch(pkg):
    eng = _eng(pkg, delay=0.25)
    srv = _srv(pkg, engine=eng, start=False)
    f1 = srv.submit(_mat(), ks=(2,), restarts=2)
    f2 = srv.submit(_mat(), ks=(2,), restarts=2)
    srv.resume()
    assert eng.started.wait(timeout=10)
    srv.close()
    assert f1.done() and f2.done()
    assert f1.result(timeout=0).per_k[2] is not None
    assert f2.result(timeout=0).per_k[2] is not None
    assert srv.stats()["completed"] == 2


def test_close_races_inflight_solo_fallback(pkg):
    eng = _eng(pkg, delay=0.2, packed_fails=True)
    srv = _srv(pkg, pkg.serve.ServeConfig(dispatch_retries=1,
                                          retry_backoff_s=0.01),
               engine=eng, start=False)
    f1 = srv.submit(_mat(), ks=(2,), restarts=2)
    f2 = srv.submit(_mat(), ks=(2,), restarts=2)
    with pytest.warns(RuntimeWarning, match="packed-dispatch-fallback"):
        srv.resume()
        assert eng.started.wait(timeout=10)
        srv.close()
    assert f1.result(timeout=0).per_k[2] is not None
    assert f2.result(timeout=0).per_k[2] is not None
    assert len(eng.solo) == 2
    assert srv.stats()["completed"] == 2


def test_close_cancel_pending_spares_inflight(pkg):
    eng = _eng(pkg, compat=None, delay=0.25)
    srv = _srv(pkg, pkg.serve.ServeConfig(pack=False), engine=eng,
               start=False)
    futs = [srv.submit(_mat(), ks=(2,), restarts=2) for _ in range(3)]
    srv.resume()
    assert eng.started.wait(timeout=10)
    srv.close(cancel_pending=True)
    outcomes = []
    for f in futs:
        try:
            outcomes.append(type(f.result(timeout=0)).__name__)
        except pkg.serve.ServerClosed:
            outcomes.append("ServerClosed")
    assert outcomes.count("ConsensusResult") == 1
    assert outcomes.count("ServerClosed") == 2


def test_engine_failure_resolves_request_failed(pkg):
    attempts = []

    class Boom(FakeEngine):
        def dispatch_solo(self, req, placed, scfg):
            attempts.append(time.monotonic())
            raise RuntimeError("device on fire")

    cfg = pkg.serve.ServeConfig(dispatch_retries=2, retry_backoff_s=0.01)
    with pytest.warns(RuntimeWarning, match="solo-dispatch-retry"):
        with _srv(pkg, cfg, engine=Boom(pkg.out_cls, compat=None)) as srv:
            f = srv.submit(_mat(), ks=(2,), restarts=2)
            with pytest.raises(pkg.serve.RequestFailed) as exc:
                f.result(timeout=T)
    assert isinstance(exc.value.__cause__, RuntimeError)
    assert "device on fire" in str(exc.value.__cause__)
    assert len(attempts) == 3
    assert srv.stats()["failed"] == 1


def test_concurrent_submitters(pkg):
    eng = _eng(pkg)
    results = []
    with _srv(pkg, pkg.serve.ServeConfig(max_queue_depth=64),
              engine=eng) as srv:
        def worker():
            results.append(srv.submit(_mat(), ks=(2,),
                                      restarts=2).result(timeout=T))

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=T)
    assert len(results) == 8
    s = srv.stats()
    assert s["submitted"] == 8 and s["completed"] == 8
    assert sum(len(p) for p in eng.packed) + len(eng.solo) == 8


@pytest.mark.parametrize("kw", [
    dict(max_queue_depth=0), dict(max_batch_requests=0),
    dict(batch_linger_s=-1.0), dict(default_timeout_s=0.0),
    dict(iter_rate_estimate=-2.0), dict(harvest_workers=0),
    dict(metrics_port=70000), dict(role="")])
def test_serve_config_validation(pkg, kw):
    with pytest.raises(ValueError):
        pkg.serve.ServeConfig(**kw)


def test_submit_validation(pkg):
    srv = _srv(pkg, engine=_eng(pkg), start=False)
    try:
        for bad in (dict(data=-_mat(), ks=(2,)), dict(data=_mat(), ks=()),
                    dict(data=_mat(), ks=(1,)),
                    dict(data=_mat(), ks=(2,), restarts=0),
                    dict(data=_mat(), ks=(2,), timeout=1.0,
                         deadline=time.monotonic() + 1.0)):
            bad.setdefault("restarts", 2)
            with pytest.raises(ValueError):
                srv.submit(bad.pop("data"), **bad)
    finally:
        srv.close()


def test_default_timeout_applies(pkg):
    with _srv(pkg, pkg.serve.ServeConfig(default_timeout_s=0.02),
              engine=_eng(pkg), start=False) as srv:
        f = srv.submit(_mat(), ks=(2,), restarts=2)
        time.sleep(0.08)
        srv.resume()
        with pytest.raises(pkg.serve.DeadlineExceeded):
            f.result(timeout=T)


def test_packing_efficiency_counter(pkg):
    with _srv(pkg, engine=_eng(pkg), start=False) as srv:
        f1 = srv.submit(_mat(), ks=(2,), restarts=3)
        f2 = srv.submit(_mat(), ks=(2,), restarts=3)
        srv.resume()
        f1.result(timeout=T)
        f2.result(timeout=T)
    s = srv.stats()
    assert (s["total_lanes"], s["packed_lanes"]) == (6, 6)
    assert s["packing_efficiency"] == 1.0
    eff = pkg.serve.packing_efficiency()
    assert eff is None or 0.0 <= eff <= 1.0


def test_close_cancel_pending_spills_and_readmits(pkg, tmp_path):
    spill = str(tmp_path / "spill")
    srv = _srv(pkg, pkg.serve.ServeConfig(spill_dir=spill),
               engine=_eng(pkg), start=False)
    f1 = srv.submit(_mat(), ks=(2,), restarts=2, priority=1)
    f2 = srv.submit(_mat(), ks=(2, 3), restarts=3, seed=7)
    srv.close(cancel_pending=True)
    for f in (f1, f2):
        with pytest.raises(pkg.serve.ServerClosed, match="spilled"):
            f.result(timeout=5)
    assert srv.counters["spilled"] == 2
    assert len([n for n in os.listdir(spill)
                if n.startswith("spill_")]) == 2
    eng2 = _eng(pkg)
    with _srv(pkg, pkg.serve.ServeConfig(spill_dir=spill),
              engine=eng2) as srv2:
        futs = srv2.readmit()
        assert len(futs) == 2
        for f in futs:
            assert f.result(timeout=T) is not None
    assert srv2.counters["readmitted"] == 2
    assert sorted((r.ks, r.restarts, r.seed, r.priority)
                  for r in eng2.reqs) == [((2,), 2, 123, 1),
                                          ((2, 3), 3, 7, 0)]
    assert [n for n in os.listdir(spill) if n.startswith("spill_")] == []


def test_readmit_skips_corrupt_spill_record(pkg, tmp_path):
    spill = tmp_path / "spill"
    spill.mkdir()
    (spill / "spill_0_0.npz").write_bytes(b"not a zip file")
    with _srv(pkg, pkg.serve.ServeConfig(spill_dir=str(spill)),
              engine=_eng(pkg)) as srv:
        with pytest.warns(RuntimeWarning, match="torn/corrupt"):
            futs = srv.readmit()
    assert futs == []
    assert os.path.exists(spill / "spill_0_0.npz")


def test_identical_submissions_coalesce(pkg):
    eng = _eng(pkg, compat=None)
    a = _mat()
    kw = dict(ks=(2,), restarts=2, seed=7)
    with _srv(pkg, pkg.serve.ServeConfig(coalesce_requests=True),
              engine=eng, start=False) as srv:
        leader = srv.submit(a, **kw)
        f2 = srv.submit(a, **kw)
        f3 = srv.submit(a, **dict(kw, seed=8))  # another key
        f4 = srv.submit(a, timeout=120.0, **kw)  # deadline: never
        assert srv.stats()["coalesced"] == 1
        srv.resume()
        r1 = leader.result(timeout=T)
        assert f2.result(timeout=T) is r1
        assert f3.result(timeout=T) is not r1
        assert f4.result(timeout=T) is not r1
    assert len(eng.solo) == 3
    st = srv.stats()
    assert st["submitted"] == 4 and st["completed"] == 4


def test_coalesced_error_fans_out_and_cancelled_leader_promotes(pkg):
    class Failing(FakeEngine):
        def dispatch_solo(self, req, placed, scfg):
            raise RuntimeError("engine exploded")

    a, kw = _mat(), dict(ks=(2,), restarts=2, seed=7)
    cfg = pkg.serve.ServeConfig(coalesce_requests=True, dispatch_retries=0)
    with pytest.warns(RuntimeWarning, match="solo-dispatch-retry"):
        with _srv(pkg, cfg, engine=Failing(pkg.out_cls, compat=None),
                  start=False) as srv:
            f1, f2 = srv.submit(a, **kw), srv.submit(a, **kw)
            srv.resume()
            for f in (f1, f2):
                with pytest.raises(pkg.serve.RequestFailed):
                    f.result(timeout=T)
    assert srv.stats()["failed"] == 2
    eng = _eng(pkg, compat=None)
    with _srv(pkg, pkg.serve.ServeConfig(coalesce_requests=True),
              engine=eng, start=False) as srv:
        leader, f2, f3 = (srv.submit(a, **kw) for _ in range(3))
        assert leader.cancel()
        srv.resume()
        r2 = f2.result(timeout=T)
        assert f3.result(timeout=T) is r2
    assert len(eng.solo) == 1


def test_scheduler_crash_fails_pending_then_restarts(pkg):
    pkg.faults.arm("serve.scheduler", every=1, max_fires=1)
    cfg = pkg.serve.ServeConfig(restart_scheduler=True,
                                watchdog_interval_s=0.05, pack=False)
    with _srv(pkg, cfg, engine=_eng(pkg, compat=None)) as srv:
        with pytest.warns(RuntimeWarning, match="scheduler restarted"):
            f1 = srv.submit(_mat(), ks=(2,), restarts=2)
            with pytest.raises(pkg.serve.ServerCrashed) as exc:
                f1.result(timeout=T)
        assert isinstance(exc.value.__cause__, pkg.faults.FaultInjected)
        assert exc.value.__cause__.site == "serve.scheduler"
        res = srv.submit(_mat(), ks=(2,), restarts=2).result(timeout=T)
    assert res.per_k[2] is not None
    assert srv.stats()["failed"] == 1 and srv.stats()["completed"] == 1


def test_scheduler_crash_without_restart_stays_down(pkg):
    pkg.faults.arm("serve.scheduler", every=1)
    cfg = pkg.serve.ServeConfig(restart_scheduler=False,
                                watchdog_interval_s=0.05, pack=False)
    srv = _srv(pkg, cfg, engine=_eng(pkg, compat=None), start=False)
    try:
        with pytest.warns(RuntimeWarning, match="scheduler-crash"):
            futs = [srv.submit(_mat(), ks=(2,), restarts=2)
                    for _ in range(2)]
            srv.resume()
            for f in futs:
                with pytest.raises(pkg.serve.ServerCrashed):
                    f.result(timeout=T)
        with pytest.raises(pkg.serve.ServerCrashed):
            srv.submit(_mat(), ks=(2,), restarts=2)
    finally:
        srv.close()
    assert srv.stats()["failed"] == 2


def test_stats_snapshot_and_metrics_text(pkg):
    with _srv(pkg, engine=_eng(pkg)) as srv:
        srv.submit(_mat(), ks=(2,), restarts=2).result(timeout=T)
        snap = srv.stats_snapshot()
        text = srv.metrics_text()
    assert sum(snap["nmfx_serve_dispatches_total"]["series"].values()) >= 1
    assert snap["nmfx_serve_e2e_seconds"]["series"][("completed",)][
        "count"] >= 1
    assert set(snap["slo"]["objectives"]) == {
        "availability", "latency_p99", "goodput", "mfu"}
    for series in ("nmfx_serve_e2e_seconds_bucket",
                   "nmfx_serve_queue_wait_seconds",
                   "nmfx_serve_dispatches_total"):
        assert series in text


def test_telemetry_publisher_and_metrics_endpoint(pkg, tmp_path):
    """A server configured with a telemetry directory and an ephemeral
    /metrics port publishes registry snapshots under its instance name
    and serves the Prometheus text on 127.0.0.1, then tears both down."""
    import http.client
    import json

    cfg = pkg.serve.ServeConfig(telemetry_dir=str(tmp_path / "tel"),
                                telemetry_interval_s=0.05, metrics_port=0,
                                instance="smoke-1")
    with _srv(pkg, cfg, engine=_eng(pkg)) as srv:
        srv.submit(_mat(), ks=(2,), restarts=2).result(timeout=T)
        assert srv.metrics_port
        conn = http.client.HTTPConnection("127.0.0.1", srv.metrics_port,
                                          timeout=10)
        conn.request("GET", "/metrics")
        body = conn.getresponse().read().decode()
        conn.close()
    assert "nmfx_serve_dispatches_total" in body
    snaps = [f for f in os.listdir(tmp_path / "tel")
             if f.endswith(".json") and "smoke-1" in f]
    assert snaps
    with open(tmp_path / "tel" / snaps[0]) as f:
        snap = json.load(f)
    assert snap["status"] == {"queue_depth": 0, "inflight": 0}


# ---------------------------------------------------------------------
# surface shared with the reference
# ---------------------------------------------------------------------

def test_serve_key_fields_equal_reference():
    assert pserve.serve_key_fields() == nserve.serve_key_fields()
    assert pserve.serve_key_fields() == frozenset(
        f.name for f in dataclasses.fields(pserve.ServeConfig))
    assert ({f.name: f.default
             for f in dataclasses.fields(pserve.ServeConfig)}
            == {f.name: f.default
                for f in dataclasses.fields(nserve.ServeConfig)})


@pytest.mark.parametrize("kw", [dict(mesh_spec="2x2")])
def test_unported_settings_name_roadmap(kw):
    """``mesh_spec`` is taken since the mesh tier was ported (the name
    is kept): validated at construction with the reference's errors."""
    assert pserve.ServeConfig(**kw).mesh_spec == kw["mesh_spec"]
    from nmfx_torch.distributed import MeshSpecError

    with pytest.raises(MeshSpecError) as got:
        pserve.ServeConfig(mesh_spec="2x0")
    with pytest.raises(Exception) as want:
        nserve.ServeConfig(mesh_spec="2x0")
    assert str(got.value) == str(want.value)


def test_quality_elastic_is_taken():
    assert pserve.ServeConfig(quality_elastic=True).quality_elastic
    assert not pserve.ServeConfig().quality_elastic


def test_unported_backend_refused_at_submit():
    """float64 on the kernels, once refused at submit, is admitted like
    any setting; the production engine's packing key keeps float64 and
    float32 requests on the kernels apart (the solver config and the
    input cache's key both carry the dtype)."""
    srv = pserve.NMFXServer(engine=pserve.ExecCacheEngine(device="cpu"),
                            start=False)
    try:
        for dtype in ("float64", "float32", "float64"):
            srv.submit(_mat(), ks=(2,), restarts=2,
                       solver_cfg=SolverConfig(dtype=dtype,
                                               backend="pallas"))
        reqs = sorted((r for _, r in srv._queue), key=lambda r: r.seq)
        assert [r.scfg.dtype for r in reqs] == ["float64", "float32",
                                               "float64"]
        assert None not in [r.compat for r in reqs]
        assert reqs[0].compat == reqs[2].compat != reqs[1].compat
    finally:
        srv.close()


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pserve.NMFXServer()
    with pytest.raises(ValueError, match="not the executable cache"):
        pserve.NMFXServer(exec_cache=ExecCache(device="cpu"),
                          device="cuda")


def test_reference_spill_record_readmits_field_for_field(tmp_path):
    """A record written by ``nmfx.serve.write_spill_record`` readmits
    through the port's funnel with the same request fields."""
    a = _mat(n=7, m=9)
    scfg = NSolverConfig(algorithm="hals", max_iter=44, backend="pallas",
                         class_flip_tol=0.05)
    icfg = NInitConfig(minval=0.1, maxval=0.9)
    meta = nserve.spill_meta(request_id=3, ks=(3, 2), restarts=4, seed=77,
                             scfg=scfg, icfg=icfg, label_rule="argmin",
                             linkage="complete", grid_slots=12,
                             grid_tail_slots=(6, 3), min_restarts=2,
                             priority=4, col_names=[f"s{i}" for i in
                                                    range(7)])
    path = nserve.write_spill_record(
        str(tmp_path / "spill" / "spill_1_0.npz"), a, meta)
    got_a, got_meta = pserve.load_spill_record(path)
    kw = pserve.spill_submit_kwargs(got_meta)
    want = nserve.spill_submit_kwargs(meta)
    assert np.array_equal(got_a, a)
    for name in ("ks", "restarts", "seed", "label_rule", "linkage",
                 "grid_slots", "grid_tail_slots", "min_restarts",
                 "priority"):
        assert kw[name] == want[name], name
    for cfg_name in ("solver_cfg", "init_cfg"):
        port_cfg = dataclasses.asdict(kw[cfg_name])
        ref_cfg = dataclasses.asdict(want[cfg_name])
        assert port_cfg == {k: ref_cfg[k] for k in port_cfg}, cfg_name
    eng = FakeEngine(psweep.KSweepOutput)
    with pserve.NMFXServer(pserve.ServeConfig(
            spill_dir=str(tmp_path / "spill")), engine=eng) as srv:
        futs = srv.readmit()
        assert len(futs) == 1
        res = futs[0].result(timeout=T)
    req = eng.reqs[0]
    assert (req.ks, req.restarts, req.seed, req.priority, req.linkage,
            req.min_restarts) == ((3, 2), 4, 77, 4, "complete", 2)
    assert req.scfg == kw["solver_cfg"] and req.icfg == kw["init_cfg"]
    assert res.col_names == tuple(f"s{i}" for i in range(7))


# ---------------------------------------------------------------------
# the port's real engine on the CPU
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_data():
    return two_group_matrix(n_genes=60, n_per_group=10, seed=3)


_FIELDS = ("consensus", "membership", "order", "iterations", "dnorms",
           "stop_reasons", "best_w", "best_h")


def assert_result_bit_equal(got, ref):
    assert set(got.per_k) == set(ref.per_k)
    for k in ref.per_k:
        s, q = got.per_k[k], ref.per_k[k]
        for f in _FIELDS:
            x, y = np.asarray(getattr(s, f)), np.asarray(getattr(q, f))
            assert x.dtype == y.dtype and x.shape == y.shape \
                and x.tobytes() == y.tobytes(), f"{f} k={k}"
        assert s.rho == q.rho and s.dispersion == q.dispersion
    assert got.quality == ref.quality == "exact"


def _solo(data, cache, ks, seed, scfg, restarts=2):
    return nmfconsensus(data, ks=ks, restarts=restarts, seed=seed,
                        solver_cfg=scfg, exec_cache=cache, device="cpu")


@pytest.mark.parametrize("alg,backend", [("mu", "auto"), ("mu", "pallas"),
                                         ("hals", "auto"),
                                         ("hals", "pallas")])
def test_packed_request_byte_equal_to_solo(small_data, alg, backend):
    scfg = SolverConfig(algorithm=alg, backend=backend, max_iter=40)
    cache = ExecCache(device="cpu")
    before = pserve.packed_dispatch_count()
    reqs = (((2, 3), 11), ((3, 2), 29), ((3,), 5))
    with pserve.NMFXServer(pserve.ServeConfig(max_batch_requests=4),
                           exec_cache=cache, start=False) as srv:
        futs = [srv.submit(small_data, ks=ks, restarts=2, seed=sd,
                           solver_cfg=scfg) for ks, sd in reqs]
        srv.resume()
        results = [f.result(timeout=T) for f in futs]
    assert pserve.packed_dispatch_count() == before + 1
    assert srv.stats()["packed_requests"] == 3
    assert futs[0].stats.packed_requests == 3
    assert futs[0].stats.lanes == 4
    for s in ("queue_wait_s", "pack_s", "solve_s", "latency_s"):
        assert getattr(futs[0].stats, s) is not None
    for (ks, sd), res in zip(reqs, results):
        assert_result_bit_equal(res, _solo(small_data, cache, ks, sd, scfg))


def test_different_largest_rank_dispatches_solo(small_data):
    """The compatibility key includes the largest rank (the pool's lane
    width): ks (2, 3) and (2,) never share a pool, and each still
    equals its solo run."""
    scfg = SolverConfig(max_iter=40)
    cache = ExecCache(device="cpu")
    before = pserve.packed_dispatch_count()
    with pserve.NMFXServer(exec_cache=cache, start=False) as srv:
        f1 = srv.submit(small_data, ks=(2, 3), restarts=2, seed=11,
                        solver_cfg=scfg)
        f2 = srv.submit(small_data, ks=(2,), restarts=2, seed=29,
                        solver_cfg=scfg)
        srv.resume()
        r1, r2 = f1.result(timeout=T), f2.result(timeout=T)
    assert pserve.packed_dispatch_count() == before
    assert srv.stats()["dispatches"] == 2
    assert_result_bit_equal(r1, _solo(small_data, cache, (2, 3), 11, scfg))
    assert_result_bit_equal(r2, _solo(small_data, cache, (2,), 29, scfg))


@pytest.mark.parametrize("alg,backend", [("mu", "auto"), ("hals", "pallas")])
def test_served_request_agrees_with_reference_server(small_data, alg,
                                                     backend):
    """The same two requests through both packages' servers: per rank,
    equal iterations, stop reasons and memberships, consensus within
    1e-6 and residuals within 1e-5 relative, and the same best k."""
    from nmfx.exec_cache import ExecCache as NExecCache

    kw = dict(restarts=2, seed=11)
    reqs = ((2, 3), (3, 2))
    with pserve.NMFXServer(pserve.ServeConfig(), device="cpu",
                           start=False) as srv:
        futs = [srv.submit(small_data, ks=ks, solver_cfg=SolverConfig(
            algorithm=alg, backend=backend, max_iter=40), **kw)
            for ks in reqs]
        srv.resume()
        got = [f.result(timeout=T) for f in futs]
    with nserve.NMFXServer(nserve.ServeConfig(), exec_cache=NExecCache(),
                           start=False) as nsrv:
        nfuts = [nsrv.submit(small_data, ks=ks, solver_cfg=NSolverConfig(
            algorithm=alg, backend=backend, max_iter=40), **kw)
            for ks in reqs]
        nsrv.resume()
        want = [f.result(timeout=T) for f in nfuts]
    assert srv.stats()["packed_requests"] == nsrv.stats()[
        "packed_requests"] == 2
    for g, w in zip(got, want):
        assert g.best_k == w.best_k
        for k in w.ks:
            gk, wk = g.per_k[k], w.per_k[k]
            np.testing.assert_array_equal(gk.iterations, wk.iterations)
            np.testing.assert_array_equal(gk.stop_reasons,
                                          wk.stop_reasons)
            np.testing.assert_array_equal(gk.membership, wk.membership)
            np.testing.assert_allclose(gk.consensus, wk.consensus,
                                       atol=1e-6)
            np.testing.assert_allclose(gk.dnorms, wk.dnorms, rtol=1e-5)


def test_deadline_clamp_equals_clamped_solo(small_data):
    scfg = SolverConfig(max_iter=10_000)
    cache = ExecCache(device="cpu")
    cfg = pserve.ServeConfig(iter_rate_estimate=4.0)
    with pserve.NMFXServer(cfg, exec_cache=cache, start=False) as srv:
        f = srv.submit(small_data, ks=(2,), restarts=2, seed=11,
                       solver_cfg=scfg, timeout=600.0)
        srv.resume()
        r = f.result(timeout=T)
    budget = f.stats.budget_iters
    assert budget is not None and budget < scfg.max_iter
    assert budget % scfg.check_every == 0
    step = budget // scfg.check_every
    assert step & (step - 1) == 0
    assert srv.stats()["budget_clamped"] == 1
    assert_result_bit_equal(r, _solo(small_data, cache, (2,), 11,
                                     SolverConfig(max_iter=budget)))


def test_spill_readmit_byte_equal_real_engine(small_data, tmp_path):
    scfg = SolverConfig(max_iter=40)
    cache = ExecCache(device="cpu")
    spill = str(tmp_path / "spill")
    srv = pserve.NMFXServer(pserve.ServeConfig(spill_dir=spill),
                            exec_cache=cache, start=False)
    f = srv.submit(small_data, ks=(2, 3), restarts=2, seed=11,
                   solver_cfg=scfg)
    srv.close(cancel_pending=True)
    with pytest.raises(pserve.ServerClosed):
        f.result(timeout=5)
    with pserve.NMFXServer(pserve.ServeConfig(spill_dir=spill),
                           exec_cache=cache) as srv2:
        futs = srv2.readmit()
        assert len(futs) == 1
        got = futs[0].result(timeout=T)
    assert_result_bit_equal(got, _solo(small_data, cache, (2, 3), 11,
                                       scfg))


def test_scheduler_crash_then_fresh_scheduler_byte_equal(small_data):
    scfg = SolverConfig(max_iter=40)
    cache = ExecCache(device="cpu")
    pfaults.arm("serve.scheduler", every=1, max_fires=1)
    cfg = pserve.ServeConfig(watchdog_interval_s=0.05)
    with pserve.NMFXServer(cfg, exec_cache=cache) as srv:
        with pytest.warns(RuntimeWarning, match="scheduler restarted"):
            f1 = srv.submit(small_data, ks=(2,), restarts=2, seed=3,
                            solver_cfg=scfg)
            with pytest.raises(pserve.ServerCrashed):
                f1.result(timeout=T)
        got = srv.submit(small_data, ks=(2,), restarts=2, seed=3,
                         solver_cfg=scfg).result(timeout=T)
    assert_result_bit_equal(got, _solo(small_data, cache, (2,), 3, scfg))


def test_failed_build_resolves_request_failed(small_data):
    """A build that fails on the scheduler thread (the ``compile.build``
    site, every attempt) resolves the request with a typed
    ``RequestFailed`` chaining the error, never with a result."""
    pfaults.arm("compile.build", every=1)
    cfg = pserve.ServeConfig(dispatch_retries=1, retry_backoff_s=0.01)
    with pytest.warns(RuntimeWarning, match="solo-dispatch-retry"):
        with pserve.NMFXServer(cfg, device="cpu") as srv:
            f = srv.submit(small_data, ks=(2,), restarts=2,
                           solver_cfg=SolverConfig(max_iter=20))
            with pytest.raises(pserve.RequestFailed) as exc:
                f.result(timeout=T)
    assert isinstance(exc.value.__cause__, pfaults.FaultInjected)
    assert exc.value.__cause__.site == "compile.build"


def test_served_request_traces_spans_across_threads(small_data, tmp_path):
    import json

    from nmfx_torch.obs import trace

    tracer = trace.default_tracer()
    tracer.clear()
    trace.enable()
    try:
        with pserve.NMFXServer(device="cpu") as srv:
            fut = srv.submit(small_data, ks=(2, 3), restarts=2, seed=11,
                             solver_cfg=SolverConfig(max_iter=20))
            fut.result(timeout=T)
    finally:
        trace.disable()
    path = tmp_path / "serve_trace.json"
    tracer.export(str(path))
    xs = [e for e in json.loads(path.read_text())["traceEvents"]
          if e.get("ph") == "X"]
    names = {e["name"] for e in xs}
    assert {"serve.queue_wait", "serve.dispatch", "serve.pack",
            "serve.harvest", "xfer.d2h_overlap",
            "post.rank_selection"} <= names
    rid = fut.stats.request_id
    disp = next(e for e in xs if e["name"] == "serve.dispatch")
    hv = next(e for e in xs if e["name"] == "serve.harvest")
    assert rid in disp["args"]["request_ids"]
    assert hv["args"]["request_id"] == rid
    assert disp["tid"] != hv["tid"]  # scheduler and completion worker
    tracer.clear()


def test_served_request_is_attributed_to_the_cost_model(small_data):
    """Each harvested request books one "serve" attribution: its lanes'
    model FLOPs over its dispatch-to-harvest wall, against the peak of
    the engine's device (a CPU device has no peak row)."""
    from nmfx_torch.obs import costmodel

    costmodel.reset_perf()
    with pserve.NMFXServer(device="cpu") as srv:
        srv.submit(small_data, ks=(2, 3), restarts=2, seed=11,
                   solver_cfg=SolverConfig(max_iter=20)).result(timeout=T)
    recs = [r for r in costmodel.recent_attributions()
            if r["kind"] == "serve"]
    assert len(recs) == 1 and recs[0]["model_flops"] > 0
    assert recs[0]["shape"] == list(small_data.shape)
    assert recs[0]["verdict"].startswith("unknown device peak")
    costmodel.reset_perf()
