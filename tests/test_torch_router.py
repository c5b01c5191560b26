"""The port's fleet tier (``nmfx_torch/replica.py``,
``nmfx_torch/router.py``) against ``nmfx``'s on the CPU.

Router and pool mechanics — placement, stickiness, failover, retries,
the forward timeouts, drain and stale-heartbeat eviction, deadlines,
admission, close, SLO shedding, elasticity, coalescing, the claim
protocol — run on thread replicas over ONE scriptable fake engine
(``test_torch_serve.FakeEngine``) and are parametrized over both
packages' ``ReplicaPool`` / ``NMFXRouter``: each case expects the same
outcomes and stats from both. The reference's mesh and atlas cases are
in ``test_torch_grid_serving.py``.

Three cases drive subprocess workers (``python -m nmfx_torch.replica
--device cpu``): a served request byte-equal to the port's in-process
served run, SIGKILL recovery byte-equal with ``failed == 0``, and spill
records crossing between the packages in both directions. Every
``result()`` and join is bounded, so a hang fails one test and never
stalls the suite."""

import dataclasses
import hashlib
import os
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import nmfx.faults as nfaults
import nmfx.obs.export as nexport
import nmfx.obs.flight as nflight
import nmfx.replica as nreplica
import nmfx.router as nrouter
import nmfx.serve as nserve
import nmfx.sweep as nsweep
import nmfx_torch.faults as pfaults
import nmfx_torch.obs.export as pexport
import nmfx_torch.obs.flight as pflight
import nmfx_torch.replica as preplica
import nmfx_torch.router as prouter
import nmfx_torch.serve as pserve
import nmfx_torch.sweep as psweep
from nmfx.config import InitConfig as NInitConfig
from nmfx.config import SolverConfig as NSolverConfig
from nmfx_torch.config import InitConfig, SolverConfig
from nmfx_torch.analysis import witness as _witness
from test_torch_serve import FakeEngine, _mat
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _lock_order_witness():
    """The runtime lock-order witness (``nmfx_torch.analysis.witness``)
    armed for each test of this threaded suite: the port's locks record
    their acquisition orders and an inversion fails the test;
    ``NMFX_LOCK_WITNESS=0`` disarms it."""
    with _witness.guard():
        yield


T = 60  # seconds: every future and join is bounded
TP = 180  # seconds for a subprocess worker's request
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(name):
    if name == "nmfx_torch":
        return types.SimpleNamespace(
            name=name, replica=preplica, router=prouter, serve=pserve,
            faults=pfaults, flight=pflight, out_cls=psweep.KSweepOutput,
            SolverConfig=SolverConfig, InitConfig=InitConfig)
    return types.SimpleNamespace(
        name=name, replica=nreplica, router=nrouter, serve=nserve,
        faults=nfaults, flight=nflight, out_cls=nsweep.KSweepOutput,
        SolverConfig=NSolverConfig, InitConfig=NInitConfig)


@pytest.fixture(params=["nmfx_torch", "nmfx"])
def pkg(request):
    for f in (pfaults, nfaults):
        f.disarm()
        f._reset_warned()
    yield _pkg(request.param)
    for f in (pfaults, nfaults):
        f.disarm()


def _eng(pkg, **kw):
    return FakeEngine(pkg.out_cls, **kw)


def _fast_cfg(pkg, **kw):
    base = dict(retry_backoff_s=0.01, health_interval_s=0.03)
    base.update(kw)
    return pkg.router.RouterConfig(**base)


def _pool(pkg, tmp_path, n=2, engine_factory=None, **kw):
    kw.setdefault("heartbeat_interval_s", 0.05)
    if engine_factory is None:
        def engine_factory():
            return _eng(pkg)
    return pkg.replica.ReplicaPool(n, root=str(tmp_path / "pool"),
                                   mode="thread",
                                   engine_factory=engine_factory, **kw)


def _router(pkg, pool, **kw):
    return pkg.router.NMFXRouter(pool, _fast_cfg(pkg, **kw))


def _sticky_id(pkg, router, arr) -> str:
    chash = hashlib.sha256(np.asarray(arr).tobytes()).hexdigest()
    ids = [rep.replica_id for rep in router.pool.routable()]
    return max(ids, key=lambda rid: pkg.router.NMFXRouter._hrw(chash, rid))


def _books(stats):
    """The router counters both packages must agree on."""
    keys = ("submitted", "completed", "failed", "retried", "shed",
            "degraded", "readmitted", "drained", "recovered",
            "result_cache_hits", "coalesced", "outstanding")
    return {k: stats[k] for k in keys}


# ---------------------------------------------------------------------
# config, validation, placement
# ---------------------------------------------------------------------

def test_router_config_validation(pkg):
    RC = pkg.router.RouterConfig
    for kw in (dict(max_outstanding=0), dict(forward_retries=-1),
               dict(forward_timeout_s=0.0), dict(stale_after_s=0.0),
               dict(min_replicas=3, max_replicas=2),
               dict(stickiness_slack=-1), dict(retry_backoff_s=-1.0),
               dict(health_interval_s=0.0), dict(slo_interval_s=0.0),
               dict(scale_up_outstanding=0.0), dict(scale_down_idle_s=0),
               dict(break_claims_after_s=0.0), dict(spawn_grace_s=-1.0),
               dict(drain_kill_after_s=0.0), dict(atlas_floor_bytes=0)):
        with pytest.raises(ValueError):
            RC(**kw)
    assert {f.name for f in dataclasses.fields(prouter.RouterConfig)} \
        == {f.name for f in dataclasses.fields(nrouter.RouterConfig)}
    assert prouter.RouterConfig() == prouter.RouterConfig(
        **{f.name: getattr(nrouter.RouterConfig(), f.name)
           for f in dataclasses.fields(nrouter.RouterConfig)})


def test_pool_validation(pkg, tmp_path):
    RP = pkg.replica.ReplicaPool
    with pytest.raises(ValueError):
        RP(0, root=str(tmp_path / "p"))
    with pytest.raises(ValueError):
        RP(1, root=str(tmp_path / "p"), mode="carrier-pigeon")
    with pytest.raises(ValueError):
        RP(1, root=str(tmp_path / "p"), mode="process",
           engine_factory=lambda: _eng(pkg))
    with pytest.raises(ValueError, match="mesh_specs has 1"):
        RP(2, root=str(tmp_path / "p"), mode="thread",
           engine_factory=lambda: _eng(pkg), mesh_specs=(None,))


def test_basic_forward_resolves_with_stats(pkg, tmp_path):
    with _router(pkg, _pool(pkg, tmp_path)) as router:
        fut = router.submit(_mat(), ks=(2,), restarts=2, seed=7)
        res = fut.result(timeout=T)
    assert res.per_k[2].consensus is not None
    st = fut.stats
    assert st.request_id and st.replica and st.attempts == 1
    assert st.sticky is True and st.latency_s is not None
    assert st.retried == [] and st.placement_class == 1
    assert _books(router.stats()) == dict(
        submitted=1, completed=1, failed=0, retried=0, shed=0,
        degraded=0, readmitted=0, drained=0, recovered=0,
        result_cache_hits=0, coalesced=0, outstanding=0)


def test_rendezvous_hash_equal_across_packages():
    """``_hrw`` gives the same weight, hence the same replica, for the
    same content hash and ids in both packages."""
    chash = hashlib.sha256(_mat().tobytes()).hexdigest()
    ids = [f"replica-{i}-{j}" for i in (1, 99) for j in range(4)]
    assert [prouter.NMFXRouter._hrw(chash, r) for r in ids] == \
        [nrouter.NMFXRouter._hrw(chash, r) for r in ids]


def test_content_hash_stickiness_is_deterministic(pkg, tmp_path):
    with _router(pkg, _pool(pkg, tmp_path, n=3)) as router:
        a = _mat()
        want = _sticky_id(pkg, router, a)
        for seed in range(4):
            f = router.submit(a, ks=(2,), restarts=2, seed=seed)
            f.result(timeout=T)
            assert f.stats.replica == want


def test_tensor_input_hashes_its_host_bytes(tmp_path):
    """A tensor is submitted as its host bytes: the same replica as the
    array, and the same result."""
    pkg = _pkg("nmfx_torch")
    a = _mat()
    with _router(pkg, _pool(pkg, tmp_path, n=3)) as router:
        want = _sticky_id(pkg, router, a)
        f1 = router.submit(torch.from_numpy(a), ks=(2,), restarts=2)
        f2 = router.submit(a, ks=(2,), restarts=2)
        r1, r2 = f1.result(timeout=T), f2.result(timeout=T)
    assert f1.stats.replica == f2.stats.replica == want
    assert np.array_equal(r1.per_k[2].consensus, r2.per_k[2].consensus)


def test_stickiness_breaks_to_least_loaded(pkg, tmp_path):
    pool = _pool(pkg, tmp_path)
    with _router(pkg, pool, stickiness_slack=0) as router:
        a = _mat()
        sticky = _sticky_id(pkg, router, a)
        for rep in pool.routable():
            rep.server.pause()
        f1 = router.submit(a, ks=(2,), restarts=2, seed=1)
        f2 = router.submit(a, ks=(2,), restarts=2, seed=2)
        assert f1.stats.replica == sticky
        assert f2.stats.replica != sticky
        assert f2.stats.sticky is False
        for rep in pool.routable():
            rep.server.resume()
        f1.result(timeout=T)
        f2.result(timeout=T)


# ---------------------------------------------------------------------
# failover: retry on another replica, typed exhaustion, fault site
# ---------------------------------------------------------------------

def _boom(pkg):
    eng = _eng(pkg, compat=None)

    def fail(*_a, **_k):
        raise RuntimeError("boom")

    eng.dispatch_solo = fail
    eng.dispatch_packed = fail
    return eng


def _pool_with_bad_sticky(pkg, tmp_path, arr, n=2):
    pid = os.getpid()
    ids = [f"replica-{pid}-{i}" for i in range(n)]
    chash = hashlib.sha256(np.asarray(arr).tobytes()).hexdigest()
    bad = max(ids, key=lambda rid: pkg.router.NMFXRouter._hrw(chash, rid))
    made = {}

    def factory():
        rid = ids[len(made)]
        made[rid] = (_boom(pkg) if rid == bad
                     else _eng(pkg, compat=None))
        return made[rid]

    pool = _pool(pkg, tmp_path, n=n, engine_factory=factory,
                 serve_cfg=pkg.serve.ServeConfig(dispatch_retries=0))
    assert list(made) == ids
    return pool, bad


def test_retry_on_another_replica(pkg, tmp_path):
    a = _mat()
    pool, bad = _pool_with_bad_sticky(pkg, tmp_path, a)
    with _router(pkg, pool) as router:
        fut = router.submit(a, ks=(2,), restarts=2, seed=5)
        assert fut.result(timeout=T) is not None
    assert fut.stats.attempts == 2 and fut.stats.replica != bad
    assert fut.stats.retried == ["RequestFailed"]
    assert router.stats()["retried"] == 1


def test_forward_exhaustion_resolves_typed(pkg, tmp_path):
    pool = _pool(pkg, tmp_path, engine_factory=lambda: _boom(pkg),
                 serve_cfg=pkg.serve.ServeConfig(dispatch_retries=0))
    with _router(pkg, pool, forward_retries=1) as router:
        fut = router.submit(_mat(), ks=(2,), restarts=2)
        with pytest.raises(pkg.router.ForwardFailed) as ei:
            fut.result(timeout=T)
    assert isinstance(ei.value.__cause__, pkg.serve.RequestFailed)
    assert fut.stats.attempts == 2
    assert router.stats()["failed"] == 1


def test_router_forward_fault_site_retries(pkg, tmp_path):
    with _router(pkg, _pool(pkg, tmp_path)) as router:
        with pkg.faults.scoped("router.forward", every=1, max_fires=1):
            fut = router.submit(_mat(), ks=(2,), restarts=2)
            fut.result(timeout=T)
            assert pkg.faults.fires("router.forward") == 1
    assert fut.stats.attempts == 2
    assert fut.stats.retried == ["FaultInjected"]
    fires = pkg.flight.default_recorder().events("fault.router.forward")
    assert fires and fires[-1]["site"] == "router.forward"


def test_queue_full_fails_over(pkg, tmp_path):
    a = _mat()
    pool = _pool(pkg, tmp_path,
                 serve_cfg=pkg.serve.ServeConfig(max_queue_depth=1))
    with _router(pkg, pool, stickiness_slack=5) as router:
        sticky = _sticky_id(pkg, router, a)
        pool.get(sticky).server.pause()
        f1 = router.submit(a, ks=(2,), restarts=2, seed=1)
        f2 = router.submit(a, ks=(2,), restarts=2, seed=2)
        assert f2.stats.replica != sticky
        assert f2.stats.retried == ["QueueFull"]
        f2.result(timeout=T)
        pool.get(sticky).server.resume()
        f1.result(timeout=T)


def test_no_routable_replicas_typed(pkg, tmp_path):
    with _router(pkg, _pool(pkg, tmp_path, n=1)) as router:
        router.drain_replica(next(iter(router.pool.replicas)))
        with pytest.raises(pkg.router.NoRoutableReplicas):
            router.submit(_mat(), ks=(2,), restarts=2)
    assert router.stats()["drained"] == 1


# ---------------------------------------------------------------------
# at-most-once dispatch
# ---------------------------------------------------------------------

def test_forward_timeout_waits_for_dispatched_request(pkg, tmp_path):
    engines = []

    def factory():
        engines.append(_eng(pkg, compat=None, delay=0.6))
        return engines[-1]

    pool = _pool(pkg, tmp_path, engine_factory=factory)
    with _router(pkg, pool, forward_timeout_s=0.1) as router:
        fut = router.submit(_mat(), ks=(2,), restarts=2)
        assert fut.result(timeout=T) is not None
    assert fut.stats.attempts == 1
    assert sum(len(e.solo) for e in engines) == 1


def test_forward_timeout_replaces_undispatched(pkg, tmp_path):
    a = _mat()
    pool = _pool(pkg, tmp_path)
    with _router(pkg, pool, forward_timeout_s=0.1) as router:
        sticky = _sticky_id(pkg, router, a)
        pool.get(sticky).server.pause()
        fut = router.submit(a, ks=(2,), restarts=2)
        assert fut.result(timeout=T) is not None
        pool.get(sticky).server.resume()
    assert fut.stats.replica != sticky
    assert fut.stats.retried == ["TimeoutError"]


# ---------------------------------------------------------------------
# drain + stale-heartbeat eviction
# ---------------------------------------------------------------------

def test_drain_migrates_queued_requests(pkg, tmp_path):
    a = _mat()
    pool = _pool(pkg, tmp_path)
    with _router(pkg, pool) as router:
        sticky = _sticky_id(pkg, router, a)
        victim = pool.get(sticky)
        victim.server.pause()
        futs = [router.submit(a, ks=(2,), restarts=2, seed=i)
                for i in range(3)]
        assert all(f.stats.replica == sticky for f in futs)
        router.drain_replica(sticky)
        for f in futs:
            assert f.result(timeout=T) is not None
            assert f.stats.replica != sticky
            assert f.stats.retried == ["ServerClosed"]
        s = router.stats()
        assert s["drained"] == 1 and s["readmitted"] == 3
        assert sticky not in [r.replica_id for r in pool.routable()]
        assert os.listdir(victim.spill_dir) == []
        assert victim._beater._thread is None


def test_stale_heartbeat_eviction(pkg, tmp_path):
    a = _mat()
    pool = _pool(pkg, tmp_path)
    # a 2 s staleness window: at 0.3 s (the reference test's) a loaded
    # host can stall the survivor's beat thread as long, and both
    # packages then drain the survivor too (NoRoutableReplicas)
    router = _router(pkg, pool, stale_after_s=2.0, health_interval_s=0.03)
    try:
        sticky = _sticky_id(pkg, router, a)
        victim = pool.get(sticky)
        survivor = next(rep for rep in pool.routable()
                        if rep.replica_id != sticky)
        victim.server.pause()
        futs = [router.submit(a, ks=(2,), restarts=2, seed=i)
                for i in range(3)]
        assert all(f.stats.replica == sticky for f in futs)
        survivor._beater.close()
        stop = threading.Event()

        def keep_fresh():
            while not stop.is_set():
                pool.ledger.beat(survivor.replica_id, role="replica",
                                 state="routable")
                time.sleep(0.03)

        fresh = threading.Thread(target=keep_fresh, daemon=True)
        fresh.start()
        try:
            with pkg.faults.scoped("replica.heartbeat", every=1):
                results = [f.result(timeout=T) for f in futs]
                assert pkg.faults.fires("replica.heartbeat") >= 1
            # read while the survivor still beats: once the beats stop
            # the health checker drains it too
            s = router.stats()
        finally:
            stop.set()
            fresh.join(timeout=T)
        assert all(r is not None for r in results)
        for f in futs:
            assert f.stats.replica == survivor.replica_id
            assert f.stats.retried == ["ServerClosed"]
        assert s["drained"] == 1 and s["readmitted"] == 3
    finally:
        router.close()


# ---------------------------------------------------------------------
# deadlines, admission, close
# ---------------------------------------------------------------------

def test_deadline_enforced_at_router(pkg, tmp_path):
    pool = _pool(pkg, tmp_path)
    with _router(pkg, pool) as router:
        for rep in pool.routable():
            rep.server.pause()
        fut = router.submit(_mat(), ks=(2,), restarts=2, timeout=0.05)
        with pytest.raises(pkg.serve.DeadlineExceeded):
            fut.result(timeout=T)
        for rep in pool.routable():
            rep.server.resume()
    s = router.stats()
    assert s["outstanding"] == 0 and s["failed"] == 1


def test_admission_bound_sheds_typed(pkg, tmp_path):
    pool = _pool(pkg, tmp_path)
    with _router(pkg, pool, max_outstanding=1) as router:
        for rep in pool.routable():
            rep.server.pause()
        f1 = router.submit(_mat(), ks=(2,), restarts=2)
        with pytest.raises(pkg.router.RouterOverloaded):
            router.submit(_mat(), ks=(2,), restarts=2)
        assert router.stats()["shed"] == 1
        for rep in pool.routable():
            rep.server.resume()
        f1.result(timeout=T)


def test_closed_router_rejects(pkg, tmp_path):
    router = _router(pkg, _pool(pkg, tmp_path))
    router.close()
    with pytest.raises(pkg.router.RouterClosed):
        router.submit(_mat(), ks=(2,), restarts=2)


def test_close_cancel_pending_resolves_typed(pkg, tmp_path):
    pool = _pool(pkg, tmp_path)
    router = _router(pkg, pool)
    for rep in pool.routable():
        rep.server.pause()
    fut = router.submit(_mat(), ks=(2,), restarts=2)
    router.close(cancel_pending=True)
    with pytest.raises(pkg.router.RouterClosed):
        fut.result(timeout=T)
    assert router.stats()["failed"] == 1


# ---------------------------------------------------------------------
# SLO-driven shedding
# ---------------------------------------------------------------------

class _BurnStub:
    """Scriptable SLO engine: reports the given objectives in fast
    burn."""

    def __init__(self, burning=()):
        self.burning = list(burning)
        self._last = None

    def evaluate(self, now=None):
        objs = {name: {"state": ("fast_burn" if name in self.burning
                                 else "ok"), "burn": {}}
                for name in ("availability", "latency_p99")}
        self._last = {"t": 0.0, "objectives": objs,
                      "alerting": list(self.burning)}
        return self._last

    def status(self):
        return self._last


def test_slo_burn_sheds(pkg, tmp_path):
    stub = _BurnStub(burning=["availability"])
    with pkg.router.NMFXRouter(
            _pool(pkg, tmp_path),
            _fast_cfg(pkg, shed_on_burn=True, slo_interval_s=0.01),
            slo_engine=stub) as router:
        router._last_slo = 0.0
        router._check_slo()
        with pytest.raises(pkg.router.RouterOverloaded,
                           match="fast burn"):
            router.submit(_mat(), ks=(2,), restarts=2)
        assert router.stats()["shed"] == 1
        assert router.stats()["burning"] == ["availability"]
        stub.burning = []
        router._last_slo = 0.0
        router._check_slo()
        router.submit(_mat(), ks=(2,), restarts=2).result(timeout=T)
        assert router.slo_status()["alerting"] == []


def test_quality_elastic_refused_naming_roadmap(pkg):
    # both packages take it since the port has the sketched engine
    assert pkg.router.RouterConfig(quality_elastic=True).quality_elastic
    assert not pkg.router.RouterConfig().quality_elastic


# ---------------------------------------------------------------------
# elasticity
# ---------------------------------------------------------------------

def test_scale_up_and_down(pkg, tmp_path):
    pool = _pool(pkg, tmp_path, n=1)
    with _router(pkg, pool, min_replicas=1, max_replicas=3) as router:
        assert len(pool.routable()) == 1
        assert router.scale_up() is not None
        assert len(pool.routable()) == 2
        assert router.scale_down() is True
        assert len(pool.routable()) == 1
        assert router.scale_down() is False


def test_scale_down_migrates_via_spill(pkg, tmp_path):
    a = _mat()
    pool = _pool(pkg, tmp_path)
    with _router(pkg, pool) as router:
        sticky = _sticky_id(pkg, router, a)
        pool.get(sticky).server.pause()
        futs = [router.submit(a, ks=(2,), restarts=2, seed=i)
                for i in range(2)]
        assert router.scale_down(sticky) is True
        for f in futs:
            assert f.result(timeout=T) is not None
            assert f.stats.replica != sticky


def test_spawn_fault_degrades_warn_once(pkg, tmp_path):
    pool = _pool(pkg, tmp_path, n=1)
    with _router(pkg, pool) as router:
        with pkg.faults.scoped("replica.spawn", every=1):
            with pytest.raises(pkg.replica.SpawnFailed):
                pool.spawn()
            assert router.scale_up() is None
        assert len(pool.routable()) == 1
        assert router.scale_up() is not None


def test_autoscale_tick_scales_on_load_and_burn(pkg, tmp_path):
    pool = _pool(pkg, tmp_path, n=1)
    with _router(pkg, pool, scale_up_outstanding=2.0,
                 max_replicas=3) as router:
        for rep in pool.routable():
            rep.server.pause()
        futs = [router.submit(_mat(), ks=(2,), restarts=2, seed=i)
                for i in range(2)]
        router.autoscale_tick()
        assert len(pool.routable()) == 2
        for rep in pool.routable():
            rep.server.resume()
        for f in futs:
            f.result(timeout=T)
        with router._lock:
            router._burning = ["availability"]
        router.autoscale_tick()
        assert len(pool.routable()) == 3


# ---------------------------------------------------------------------
# coalescing and the router-level result cache
# ---------------------------------------------------------------------

KW = dict(ks=(2,), restarts=2, seed=7)


def test_router_coalesce_single_forward(pkg, tmp_path):
    a = _mat()
    pool = _pool(pkg, tmp_path, engine_factory=lambda: _eng(
        pkg, compat=None, delay=0.4))
    with _router(pkg, pool, coalesce_requests=True) as router:
        leader = router.submit(a, **KW)
        f2 = router.submit(a, **KW)
        f3 = router.submit(a, **KW)
        s_mid = router.stats()
        r1 = leader.result(timeout=T)
        assert f2.result(timeout=T) is r1
        assert f3.result(timeout=T) is r1
        s = router.stats()
    assert s_mid["coalesced"] == 2
    assert s["completed"] == 3 and s["failed"] == 0
    assert leader.stats.replica is not None
    assert f2.stats.replica is None and f3.stats.replica is None


def test_router_coalesce_is_opt_in(pkg, tmp_path):
    assert pkg.router.RouterConfig().coalesce_requests is False
    a = _mat()
    pool = _pool(pkg, tmp_path, n=1, engine_factory=lambda: _eng(
        pkg, compat=None, delay=0.2))
    with _router(pkg, pool) as router:
        f1 = router.submit(a, **KW)
        f2 = router.submit(a, **KW)
        f1.result(timeout=T), f2.result(timeout=T)
    assert router.stats()["coalesced"] == 0


def test_router_result_cache_hit_forwards_nothing(pkg, tmp_path):
    engines = []

    def factory():
        engines.append(_eng(pkg, compat=None))
        return engines[-1]

    pool = _pool(pkg, tmp_path, engine_factory=factory)
    with _router(pkg, pool,
                 result_cache_dir=str(tmp_path / "rc")) as router:
        r1 = router.submit(_mat(), **KW).result(timeout=T)
        f2 = router.submit(_mat(), **KW)
        r2 = f2.result(timeout=T)
        s = router.stats()
    assert np.array_equal(r1.per_k[2].consensus, r2.per_k[2].consensus)
    assert f2.stats.replica is None
    assert s["result_cache_hits"] == 1 and s["completed"] == 2
    assert sum(len(e.solo) for e in engines) == 1


# ---------------------------------------------------------------------
# the spill claim protocol
# ---------------------------------------------------------------------

def _record(pkg, d, name="spill_x.npz"):
    meta = pkg.serve.spill_meta(request_id="x", ks=(2,), restarts=2,
                                seed=1, scfg=pkg.SolverConfig(),
                                icfg=pkg.InitConfig(),
                                col_names=("a", "b"))
    return pkg.serve.write_spill_record(str(d / name), np.ones((3, 2)),
                                        meta)


def test_claim_is_exclusive_and_breakable(pkg, tmp_path):
    serve = pkg.serve
    p = _record(pkg, tmp_path)
    assert serve.claim_spill(p, "a")
    assert not serve.claim_spill(p, "b")
    assert serve.spill_claimant(p)["claimant"] == "a"
    serve.release_spill_claim(p)
    assert serve.spill_claimant(p) is None
    assert serve.claim_spill(p, "a")
    assert not serve.break_spill_claim(p, owner_pid=1)
    assert not serve.break_spill_claim(p, older_than_s=3600)
    assert serve.break_spill_claim(p, owner_pid=os.getpid())
    assert serve.claim_spill(p, "b")
    assert serve.break_spill_claim(p, older_than_s=0.0)
    assert serve.claim_spill(p, "c")


def test_concurrent_breakers_yield_one_owner(pkg, tmp_path):
    import json

    serve = pkg.serve
    p = _record(pkg, tmp_path)
    with open(p + ".claim", "w") as f:
        json.dump({"claimant": "dead", "pid": 999999, "time": 1.0}, f)
    winners = []
    barrier = threading.Barrier(2)

    def contend(who):
        barrier.wait()
        for _ in range(50):
            if serve.break_spill_claim(p, older_than_s=60.0) \
                    and serve.claim_spill(p, who):
                winners.append(who)
                return

    threads = [threading.Thread(target=contend, args=(w,))
               for w in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=T)
    assert len(winners) == 1
    assert serve.spill_claimant(p)["claimant"] == winners[0]
    assert not os.path.exists(p + ".break")


def test_readmit_respects_claims(pkg, tmp_path):
    """Readmission skips a record claimed by someone else, breaks a
    stale claim only when asked, and cleans an orphan claim."""
    import json

    serve = pkg.serve
    spill = tmp_path / "spill"
    spill.mkdir()
    p1 = _record(pkg, spill, "spill_1.npz")
    _record(pkg, spill, "spill_2.npz")
    p3 = _record(pkg, spill, "spill_3.npz")
    assert serve.claim_spill(p1, "someone-else")
    with open(p3 + ".claim", "w") as f:
        json.dump({"claimant": "dead", "pid": 999999, "time": 1.0}, f)
    orphan = str(spill / "spill_gone.npz")
    assert serve.claim_spill(orphan, "dead-consumer")
    srv = serve.NMFXServer(serve.ServeConfig(spill_dir=str(spill)),
                           engine=_eng(pkg))
    try:
        futs = srv.readmit()
        assert len(futs) == 1
        futs[0].result(timeout=T)
        futs = srv.readmit(break_claims_after_s=60.0)
        assert len(futs) == 1
        futs[0].result(timeout=T)
    finally:
        srv.close()
    assert os.path.exists(p1)
    assert serve.spill_claimant(p1)["claimant"] == "someone-else"
    assert not os.path.exists(p3)
    assert sorted(os.listdir(spill)) == ["spill_1.npz",
                                         "spill_1.npz.claim"]


# ---------------------------------------------------------------------
# fleet view: heartbeats and roles
# ---------------------------------------------------------------------

def test_replica_heartbeats_carry_levels(pkg, tmp_path):
    pool = _pool(pkg, tmp_path, n=1)
    try:
        rep = pool.routable()[0]
        rep.server.pause()
        a = np.asarray(_mat())
        meta = pkg.serve.spill_meta(
            request_id="rid-x", ks=(2,), restarts=2, seed=1,
            scfg=pkg.SolverConfig(), icfg=pkg.InitConfig(),
            col_names=[str(i) for i in range(a.shape[1])])
        fut = rep.forward("rid-x", a, meta)
        rep._beater.beat_once()
        hb = pool.heartbeats(stale_after_s=30.0)[rep.replica_id]
        assert hb["role"] == "replica" and hb["queue_depth"] == 1
        assert hb["stale"] is False
        assert hb["devices"] == 1 and hb["mesh"] is None
        rep.server.resume()
        fut.result(timeout=T)
    finally:
        pool.close()


def test_pool_telemetry_renders_roles(pkg, tmp_path):
    """Thread replicas publish telemetry under role "replica"; the
    port's ``top`` renders them beside a router row."""
    from nmfx_torch.obs.aggregate import FleetCollector
    from nmfx_torch.obs.slo import SLOEngine
    from nmfx_torch.obs.top import gather, render_text

    tdir = str(tmp_path / "telemetry")
    pool = _pool(pkg, tmp_path, n=2, telemetry_dir=tdir)
    with _router(pkg, pool) as router:
        router.submit(_mat(), **KW).result(timeout=T)
    export_mod = pexport if pkg.name == "nmfx_torch" else nexport
    export_mod.TelemetryPublisher(tdir, role="router",
                                  instance="router-0").publish_once()
    col = FleetCollector(tdir, stale_after_s=600.0)
    text = render_text(gather(col, SLOEngine(
        snapshot_fn=col.fleet_snapshot)), tdir)
    assert "roles: replica 2 live · router 1 live" in text


# ---------------------------------------------------------------------
# priced placement, the mesh and the disk cache: one class here
# ---------------------------------------------------------------------

def test_priced_placement_one_class_equal(tmp_path):
    """On a fleet of one-device replicas priced placement is the plain
    placement; both packages record the same decision inputs."""
    small = _mat()
    atlas = np.asarray(_mat(n=32, m=64))
    got = {}
    for name in ("nmfx", "nmfx_torch"):
        pkg = _pkg(name)
        pool = _pool(pkg, tmp_path / name)
        rows = []
        with _router(pkg, pool,
                     atlas_floor_bytes=small.nbytes + 1) as router:
            for arr in (atlas, small):
                fut = router.submit(arr, ks=(2, 3), restarts=2)
                fut.result(timeout=T)
                inputs = dict(fut.stats.placement_inputs)
                rows.append((fut.stats.placement_class, inputs))
        with _router(pkg, _pool(pkg, tmp_path / f"{name}-off"),
                     price_placement=False) as router:
            fut = router.submit(small, ks=(2,), restarts=2)
            fut.result(timeout=T)
            rows.append((fut.stats.placement_class,
                         fut.stats.placement_inputs))
        got[name] = rows
    assert got["nmfx_torch"] == got["nmfx"]
    (c_atlas, i_atlas), (c_small, i_small), off = got["nmfx_torch"]
    assert c_atlas == c_small == 1 and off == (1, None)
    assert i_atlas["atlas"] is True and i_small["atlas"] is False
    assert i_atlas["classes"] == [1]
    assert i_atlas["flops_per_iter"] is not None


def test_mesh_and_disk_cache_refused_naming_roadmap(tmp_path):
    """Mesh replicas run since the mesh tier was ported, as the
    reference's do (the name is kept): device counts and specs as
    nmfx's pool gives them; a cache directory is taken as nmfx's pool
    takes it (it travels to a process worker as --cache-dir)."""
    counts = {}
    for name in ("nmfx_torch", "nmfx"):
        pk = _pkg(name)
        pool = _pool(pk, tmp_path / name, n=2, mesh_specs=(None, "4"))
        try:
            counts[name] = [(r.n_devices, r.mesh_spec)
                            for r in pool.routable()]
        finally:
            pool.close()
    assert counts["nmfx_torch"] == counts["nmfx"] == [(1, None), (4, "4")]
    pkg = _pkg("nmfx_torch")
    pool = _pool(pkg, tmp_path / "plain", n=2, mesh_specs=(None, None))
    try:
        assert [r.n_devices for r in pool.routable()] == [1, 1]
        assert pool.spawn(mesh_spec="4").n_devices == 4
    finally:
        pool.close()
    rep = preplica.ThreadReplica("r", str(tmp_path / "r"), pool.ledger,
                                 engine=_eng(pkg), mesh_spec="2")
    try:
        assert (rep.n_devices, rep._status()["mesh"]) == (2, "2")
    finally:
        rep.close()
    proc_rep = preplica.ProcessReplica("r", str(tmp_path / "rp"),
                                       pool.ledger, mesh_spec="2")
    try:
        assert proc_rep.n_devices == 2
        assert proc_rep.process.args[-2:] == ["--mesh-spec", "2"]
    finally:
        proc_rep.kill()
        proc_rep.process.wait(timeout=T)
    for name in ("nmfx_torch", "nmfx"):
        cpool = _pool(_pkg(name), tmp_path / f"c-{name}",
                      cache_dir=str(tmp_path / "x"))
        try:
            assert cpool.cache_dir == str(tmp_path / "x")
        finally:
            cpool.close()
    proc_rep = preplica.ProcessReplica("r", str(tmp_path / "rc"),
                                       pool.ledger,
                                       cache_dir=str(tmp_path / "x"))
    try:
        args = proc_rep.process.args
        i = args.index("--cache-dir")
        assert args[i + 1] == str(tmp_path / "x")
    finally:
        proc_rep.kill()
        proc_rep.process.wait(timeout=T)
    # a bad --mesh-spec is refused with the spec's own error, as the
    # reference's worker refuses it; --cache-dir is taken (the same
    # worker fails only at its mesh spec)
    for argv, item in ((["--mesh-spec", "2x0"], "non-positive axis count"),
                       (["--cache-dir", "x", "--mesh-spec", "2x0"],
                        "non-positive axis count")):
        proc = subprocess.run(
            [sys.executable, "-m", "nmfx_torch.replica", "--dir", "d",
             "--id", "i", "--pool-dir", "p", "--device", "cpu", *argv],
            cwd=str(tmp_path), env=_worker_env(), capture_output=True,
            text=True, timeout=T)
        assert proc.returncode == 2 and item in proc.stderr
        assert "--cache-dir:" not in proc.stderr


# ---------------------------------------------------------------------
# process replicas (subprocess workers on the CPU)
# ---------------------------------------------------------------------

def _worker_env():
    # nmfx's workers must see the parent's 8 virtual CPU devices (the
    # conftest's platform) to compute the parent's bits
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=8"))
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _assert_byte_equal(got, ref):
    assert tuple(got.ks) == tuple(ref.ks)
    for k in ref.per_k:
        for field in ("consensus", "membership", "order", "iterations",
                      "dnorms", "stop_reasons", "best_w", "best_h"):
            g = np.asarray(getattr(got.per_k[k], field))
            r = np.asarray(getattr(ref.per_k[k], field))
            assert g.dtype == r.dtype and np.array_equal(g, r), \
                f"{field} k={k}"
        assert got.per_k[k].rho == ref.per_k[k].rho
    assert tuple(got.col_names) == tuple(ref.col_names)


def _served_ref(a, seed, scfg, ks=(2,), restarts=2, meta=None):
    """The port's in-process served solo run: one request through an
    ``NMFXServer`` on the CPU (the path a worker runs); with ``meta``,
    the spill record's request."""
    with pserve.NMFXServer(pserve.ServeConfig(), device="cpu") as srv:
        if meta is not None:
            return srv.submit(pserve.spill_dataset(a, meta),
                              **pserve.spill_submit_kwargs(meta)
                              ).result(timeout=TP)
        return srv.submit(a, ks=ks, restarts=restarts, seed=seed,
                          solver_cfg=scfg).result(timeout=TP)


def _data():
    from nmfx_torch.datasets import two_group_matrix

    return two_group_matrix(60, 10, seed=3)


def _process_pool(tmp_path, n):
    return preplica.ReplicaPool(n, root=str(tmp_path / "pool"),
                                mode="process", env=_worker_env(),
                                worker_args=("--device", "cpu"),
                                heartbeat_interval_s=0.2)


def test_process_replica_serves_byte_equal(tmp_path):
    a = _data()
    scfg = SolverConfig(max_iter=30)
    pool = _process_pool(tmp_path, 1)
    with prouter.NMFXRouter(pool, _fast_cfg(_pkg("nmfx_torch"))) as router:
        fut = router.submit(a, ks=(2, 3), restarts=3, seed=11,
                            solver_cfg=scfg)
        res = fut.result(timeout=TP)
    _assert_byte_equal(res, _served_ref(a, 11, scfg, ks=(2, 3),
                                        restarts=3))
    rep = next(iter(pool.replicas.values()))
    assert os.listdir(rep.inbox) == [] and os.listdir(rep.outbox) == []
    assert router.stats()["completed"] == 1


def test_sigkilled_process_replica_recovers_byte_equal(tmp_path):
    a = _data()
    scfg = SolverConfig(max_iter=30)
    pkg = _pkg("nmfx_torch")
    pool = _process_pool(tmp_path, 2)
    with prouter.NMFXRouter(pool, _fast_cfg(pkg,
                                            stickiness_slack=8)) as router:
        victim_id = _sticky_id(pkg, router, a)
        victim = pool.get(victim_id)
        futs = [router.submit(a, ks=(2,), restarts=2, seed=s,
                              solver_cfg=scfg) for s in (11, 12, 13)]
        assert all(f.stats.replica == victim_id for f in futs)
        victim.kill()
        results = [f.result(timeout=TP) for f in futs]
    for seed, res in zip((11, 12, 13), results):
        _assert_byte_equal(res, _served_ref(a, seed, scfg))
    s = router.stats()
    assert s["recovered"] == 1 and s["readmitted"] >= 1
    assert s["completed"] == 3 and s["failed"] == 0


def _handle(cls, root, process, replica_id):
    """A router-side process-replica handle of ``cls`` over an already
    spawned worker (the worker may be the other package's)."""
    rep = cls.__new__(cls)
    rep.replica_id = replica_id
    rep.root = root
    rep.inbox = os.path.join(root, "inbox")
    rep.outbox = os.path.join(root, "outbox")
    rep.spill_dir = rep.inbox
    os.makedirs(rep.inbox, exist_ok=True)
    os.makedirs(rep.outbox, exist_ok=True)
    rep.state = "routable"
    rep._pending = {}
    rep._read_failures = {}
    rep._lock = threading.Lock()
    rep.process = process
    return rep


def _worker(module, root, pool_dir, replica_id, device_args):
    return subprocess.Popen(
        [sys.executable, "-m", module, "--dir", root, "--id", replica_id,
         "--pool-dir", pool_dir, "--poll-interval", "0.02",
         *device_args], env=_worker_env(),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)


def _serve_through(handle, a, meta, rid):
    fut = handle.forward(rid, a, meta)
    deadline = time.monotonic() + TP
    while not fut.done():
        if handle.process.poll() is not None:
            err = handle.process.stderr.read().decode()[-2000:]
            pytest.fail(f"worker exited: {err}")
        if time.monotonic() > deadline:
            pytest.fail("no result from the worker")
        handle.poll()
        time.sleep(0.02)
    return fut.result()


def test_spill_records_cross_between_packages(tmp_path):
    """``nmfx``'s router-side writer and reader (``ProcessReplica
    .forward`` / ``poll``) against the port's worker, and the port's
    against ``nmfx``'s worker: the records and results keep one format,
    and each result equals its own package's in-process served run."""
    a = _data()
    procs = []
    try:
        # nmfx's record -> the port's worker -> nmfx reads the result
        root = str(tmp_path / "to-port")
        procs.append(_worker("nmfx_torch.replica", root,
                             str(tmp_path), "port-w", ["--device", "cpu"]))
        h = _handle(nreplica.ProcessReplica, root, procs[-1], "port-w")
        meta = nserve.spill_meta(
            request_id="r1", ks=(2,), restarts=2, seed=21,
            scfg=NSolverConfig(max_iter=30), icfg=NInitConfig(),
            col_names=[f"c{i}" for i in range(a.shape[1])],
            router_request_id="r1")
        got = _serve_through(h, a, meta, "r1")
        assert type(got).__module__ == "nmfx.api"
        _assert_byte_equal(got, _served_ref(a, None, None, meta=meta))
        # the port's record -> nmfx's worker -> the port reads the result
        root = str(tmp_path / "to-nmfx")
        procs.append(_worker("nmfx.replica", root, str(tmp_path),
                             "nmfx-w", []))
        h = _handle(preplica.ProcessReplica, root, procs[-1], "nmfx-w")
        meta = pserve.spill_meta(
            request_id="r2", ks=(2,), restarts=2, seed=22,
            scfg=SolverConfig(max_iter=30), icfg=InitConfig(),
            col_names=[f"c{i}" for i in range(a.shape[1])],
            router_request_id="r2")
        got = _serve_through(h, a, meta, "r2")
        assert type(got).__module__ == "nmfx_torch.api"
        with nserve.NMFXServer(nserve.ServeConfig()) as srv:
            nref = srv.submit(nserve.spill_dataset(a, meta),
                              **nserve.spill_submit_kwargs(meta)
                              ).result(timeout=TP)
        _assert_byte_equal(got, nref)
        assert os.listdir(h.inbox) == [] and os.listdir(h.outbox) == []
    finally:
        for p in procs:
            p.terminate()
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            p.stderr.close()
