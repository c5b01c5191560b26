"""The port's runtime lock-order witness (``nmfx_torch.analysis.witness``),
the counterparts of ``tests/test_witness.py``: the dynamic half of the
NMFX013 contract. The witness records the orders threads actually take
the port's (and the tests') locks in, reports inversions, and feeds the
observed edges back so the static graph's completeness is testable (the
last case drives the port's server and checks every observed edge
between statically known locks is a static edge)."""

import threading
import time

import pytest

from nmfx_torch.analysis import witness


@pytest.fixture(autouse=True)
def _clean_witness_state():
    witness.reset()
    yield
    while witness.is_armed():  # a failed test must not leave the patch
        witness.disarm()
    witness.reset()


def test_seeded_inversion_detected():
    with witness.armed():
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        with b:
            with a:
                pass
    vs = witness.violations()
    assert [v["kind"] for v in vs] == ["inversion"]
    assert "fake" not in witness.render(vs)  # renders real sites
    assert "test_torch_witness.py" in witness.render(vs)


def test_consistent_order_quiet():
    with witness.armed():
        a = threading.Lock()
        b = threading.Lock()
        for _ in range(3):
            with a:
                with b:
                    pass
    assert witness.violations() == []
    assert len(witness.observed_edges()) == 1


def test_cross_thread_inversion_detected():
    """Each thread's order looks consistent alone; only the merge across
    threads shows the inversion."""
    with witness.armed():
        a = threading.Lock()
        b = threading.Lock()

        def t1():
            with a:
                with b:
                    pass

        def t2():
            with b:
                with a:
                    pass

        th1 = threading.Thread(target=t1)
        th1.start()
        th1.join()
        th2 = threading.Thread(target=t2)
        th2.start()
        th2.join()
    assert any(v["kind"] == "inversion" for v in witness.violations())


def test_rlock_reentry_no_self_edge():
    with witness.armed():
        r = threading.RLock()
        with r:
            with r:
                pass
    assert witness.violations() == []
    assert witness.observed_edges() == {}


def test_nonblocking_probe_not_a_self_deadlock():
    """A non-blocking acquire of a held lock (Condition's ownership
    probe) is not a self-deadlock; only a blocking re-acquire is."""
    with witness.armed():
        lk = threading.Lock()
        with lk:
            assert lk.acquire(False) is False
    assert witness.violations() == []


def test_condition_on_witnessed_lock_tracks_and_works():
    with witness.armed():
        lk = threading.Lock()
        cond = threading.Condition(lk)
        fired = []

        def waiter():
            with cond:
                while not fired:
                    cond.wait(timeout=5.0)

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.05)
        with cond:
            fired.append(1)
            cond.notify()
        t.join(timeout=5.0)
        assert not t.is_alive()
    assert witness.violations() == []


def test_arm_disarm_restore_and_nest():
    real_lock = threading.Lock
    witness.arm()
    witness.arm()
    assert threading.Lock is not real_lock
    witness.disarm()
    assert threading.Lock is not real_lock  # still one arm deep
    witness.disarm()
    assert threading.Lock is real_lock
    witness.disarm()  # over-disarm is a no-op
    assert threading.Lock is real_lock


def test_third_party_locks_untouched():
    """Creation sites outside the port and the tests pass through
    unwrapped: the standard library's, and the reference package's."""
    import queue

    from nmfx.obs.metrics import MetricsRegistry

    with witness.armed():
        q = queue.Queue()  # allocates its locks inside queue.py
        q.put(1)
        assert q.get() == 1
        from concurrent.futures import Future

        f = Future()
        f.set_result(3)
        assert f.result() == 3
        reg = MetricsRegistry()  # a lock created under nmfx/
        reg.counter("nmfx_witness_probe_total", "probe").inc()
        assert not isinstance(reg._lock, witness._LockWitness)
    assert witness.observed_edges() == {}


def test_static_inversion_check_flags_reversed_edge(monkeypatch):
    with witness.armed():
        a = threading.Lock()
        b = threading.Lock()
        with b:
            with a:
                pass
    (edge,) = witness.observed_edges()  # (site_b, site_a)
    sb, sa = edge
    monkeypatch.setattr(
        witness, "_static_cache",
        {(sa, sb): ("mod.Cls._a", "mod.Cls._b")})
    problems = witness.check_static_inversions()
    assert len(problems) == 1
    assert problems[0]["kind"] == "static-inversion"
    assert "mod.Cls._b -> mod.Cls._a" in witness.render(problems)


def test_static_graph_covers_observed_serve_edges():
    """Completeness: drive the port's server (submit through resolution
    and close) with the witness armed; every observed edge between locks
    the static model knows is a static order edge."""
    from nmfx_torch.serve import NMFXServer, ServeConfig
    from nmfx_torch.sweep import KSweepOutput
    from test_torch_serve import FakeEngine, _mat

    with witness.armed():
        eng = FakeEngine(KSweepOutput)
        with NMFXServer(ServeConfig(), engine=eng, start=False) as srv:
            f1 = srv.submit(_mat(), ks=(2,), restarts=2)
            srv.resume()
            assert f1.result(timeout=60)
    observed = witness.observed_edges()
    assert witness.violations() == []
    static = witness.static_order_edges()
    known_sites = {s for edge in static for s in edge}
    checked = 0
    for (sa, sb) in observed:
        if sa in known_sites and sb in known_sites:
            assert (sa, sb) in static, (
                f"observed lock order {sa} -> {sb} is missing from the "
                "static NMFX013 graph — the call-graph resolution lost "
                "a lock-taking path")
            checked += 1
    # the workload exercises the serve discipline (_lock ->
    # _tracked_lock), or this test proves nothing
    assert checked >= 1
