"""Quality-elastic serving on the port (``ServeConfig.quality_elastic``,
``RouterConfig.quality_elastic``) against ``nmfx`` on the CPU: a port of
``tests/test_serve_quality.py``.

The scheduler degrades deadline-pressured and admission-shed requests to
the sketched engine instead of clamping or rejecting them, and the
result is always tagged: ``ConsensusResult.quality``,
``RequestStats.quality`` / ``degraded_cause``, the
``nmfx_serve_quality_degraded_total{cause}`` counter and a
``serve.quality_degraded`` flight event. The servers here run the real
engine on the CPU (``device="cpu"``: plain products); each case runs
the same requests through ``nmfx``'s server and expects the same
outcome and tags. The router's burn-pressure degradation runs over both
packages' ``NMFXRouter`` on one fake engine (test_torch_router.py's
harness). The lint fixture pins that every ``ConsensusResult``
construction in ``nmfx_torch/serve.py`` passes ``quality=``.
"""

import ast
import inspect

import numpy as np
import pytest

import nmfx
import nmfx.obs.flight as nflight
import nmfx.obs.metrics as nmetrics
import nmfx.serve as nserve
import nmfx_torch.obs.flight as pflight
import nmfx_torch.obs.metrics as pmetrics
import nmfx_torch.serve as pserve
from nmfx.datasets import two_group_matrix
from nmfx_torch.config import SolverConfig
from test_torch_router import _BurnStub, _fast_cfg, _pkg, _pool
from test_torch_serve import _mat
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)

T = 300  # seconds: every future is bounded


@pytest.fixture(scope="module")
def matrix():
    return two_group_matrix(n_genes=60, n_per_group=8, seed=1).astype(
        np.float32)


PKGS = {
    "nmfx_torch": (pserve, pmetrics, pflight, SolverConfig,
                   dict(device="cpu")),
    "nmfx": (nserve, nmetrics, nflight, nmfx.SolverConfig, {}),
}


@pytest.fixture(params=sorted(PKGS))
def side(request):
    return PKGS[request.param]


def _scfg(side, **kw):
    base = dict(algorithm="mu", max_iter=150)
    base.update(kw)
    return side[3](**base)


def _degraded_metric(side, cause):
    c = side[1].registry().get("nmfx_serve_quality_degraded_total")
    return 0.0 if c is None else c.value(cause=cause)


def _server(side, cfg, **kw):
    return side[0].NMFXServer(cfg, **side[4], **kw)


# -- deadline degradation -----------------------------------------------
def test_deadline_pressure_degrades_tagged(side, matrix):
    before = _degraded_metric(side, "deadline")
    cfg = side[0].ServeConfig(quality_elastic=True, iter_rate_estimate=1.0)
    with _server(side, cfg) as srv:
        fut = srv.submit(matrix, ks=(2,), restarts=4,
                         solver_cfg=_scfg(side), timeout=60)
        res = fut.result(timeout=T)
    assert res.quality == "sketched"
    assert fut.stats.quality == "sketched"
    assert fut.stats.degraded_cause == "deadline"
    assert fut.stats.budget_iters is None
    assert srv.stats()["quality_degraded"] == 1
    assert _degraded_metric(side, "deadline") == before + 1
    events = side[2].default_recorder().events("serve.quality_degraded")
    assert any(e.get("cause") == "deadline" for e in events)


def test_deadline_without_elastic_still_clamps(side, matrix):
    cfg = side[0].ServeConfig(iter_rate_estimate=1.0)
    with _server(side, cfg) as srv:
        fut = srv.submit(matrix, ks=(2,), restarts=4,
                         solver_cfg=_scfg(side), timeout=60)
        res = fut.result(timeout=T)
    assert res.quality == "exact"
    assert fut.stats.degraded_cause is None
    assert fut.stats.budget_iters is not None


def test_ineligible_algorithm_not_degraded(side, matrix):
    cfg = side[0].ServeConfig(quality_elastic=True, iter_rate_estimate=1.0)
    with _server(side, cfg) as srv:
        fut = srv.submit(matrix, ks=(2,), restarts=3,
                         solver_cfg=_scfg(side, algorithm="als"), timeout=60)
        res = fut.result(timeout=T)
    assert res.quality == "exact"
    assert fut.stats.degraded_cause is None


# -- overload degradation -----------------------------------------------
def test_overload_soft_admission_degrades_tagged(side, matrix):
    before = _degraded_metric(side, "overload")
    cfg = side[0].ServeConfig(quality_elastic=True, max_queue_depth=1)
    with _server(side, cfg, start=False) as srv:
        f1 = srv.submit(matrix, ks=(2,), restarts=4, solver_cfg=_scfg(side))
        f2 = srv.submit(matrix, ks=(2,), restarts=4, solver_cfg=_scfg(side))
        with pytest.raises(side[0].QueueFull):
            srv.submit(matrix, ks=(2,), restarts=4, solver_cfg=_scfg(side))
        srv.resume()
        r1, r2 = f1.result(timeout=T), f2.result(timeout=T)
    assert r1.quality == "exact"
    assert r2.quality == "sketched"
    assert f2.stats.degraded_cause == "overload"
    assert f2.stats.quality == "sketched"
    assert srv.stats()["quality_degraded"] == 1
    assert _degraded_metric(side, "overload") == before + 1


def test_overload_without_elastic_rejects(side, matrix):
    cfg = side[0].ServeConfig(max_queue_depth=1)
    with _server(side, cfg, start=False) as srv:
        f1 = srv.submit(matrix, ks=(2,), restarts=3, solver_cfg=_scfg(side))
        with pytest.raises(side[0].QueueFull):
            srv.submit(matrix, ks=(2,), restarts=3, solver_cfg=_scfg(side))
        srv.resume()
        f1.result(timeout=T)


def test_pending_bytes_bound_stays_hard(side, matrix):
    cfg = side[0].ServeConfig(quality_elastic=True, max_queue_depth=8,
                              max_pending_bytes=matrix.nbytes + 1)
    with _server(side, cfg, start=False) as srv:
        f1 = srv.submit(matrix, ks=(2,), restarts=3, solver_cfg=_scfg(side))
        with pytest.raises(side[0].QueueFull, match="bytes"):
            srv.submit(matrix, ks=(2,), restarts=3, solver_cfg=_scfg(side))
        srv.resume()
        f1.result(timeout=T)


def test_degraded_request_never_packs(side, matrix):
    cfg = side[0].ServeConfig(quality_elastic=True, max_queue_depth=1)
    with _server(side, cfg, start=False) as srv:
        f1 = srv.submit(matrix, ks=(2,), restarts=4, solver_cfg=_scfg(side))
        f2 = srv.submit(matrix, ks=(2,), restarts=4, solver_cfg=_scfg(side))
        srv.resume()
        r1, r2 = f1.result(timeout=T), f2.result(timeout=T)
    assert f2.stats.packed_requests == 1
    assert r2.quality == "sketched"
    assert r1.quality == "exact"


def test_degraded_result_agrees_across_packages(matrix):
    """The same overload-degraded request through both servers: the same
    best k and k = 2 memberships (the sketched engine from the same
    keys)."""
    got = {}
    for name, side in PKGS.items():
        cfg = side[0].ServeConfig(quality_elastic=True, max_queue_depth=1)
        with _server(side, cfg, start=False) as srv:
            f1 = srv.submit(matrix, ks=(2, 3), restarts=4,
                            solver_cfg=_scfg(side))
            f2 = srv.submit(matrix, ks=(2, 3), restarts=4,
                            solver_cfg=_scfg(side))
            srv.resume()
            f1.result(timeout=T)
            got[name] = f2.result(timeout=T)
    p, n = got["nmfx_torch"], got["nmfx"]
    assert p.quality == n.quality == "sketched"
    assert p.best_k == n.best_k
    assert np.array_equal(p.per_k[2].membership,
                          np.asarray(n.per_k[2].membership))
    np.testing.assert_array_equal(p.per_k[2].iterations,
                                  np.asarray(n.per_k[2].iterations))


# -- native sketched requests -------------------------------------------
def test_native_sketched_request_tagged_not_degraded(side, matrix):
    with _server(side, side[0].ServeConfig()) as srv:
        fut = srv.submit(matrix, ks=(2,), restarts=4,
                         solver_cfg=_scfg(side, backend="sketched"))
        res = fut.result(timeout=T)
    assert res.quality == "sketched"
    assert fut.stats.quality == "sketched"
    assert fut.stats.degraded_cause is None
    assert srv.stats()["quality_degraded"] == 0


# -- the router ---------------------------------------------------------
@pytest.mark.parametrize("pkgname", ["nmfx_torch", "nmfx"])
def test_router_burn_degrades_eligible_and_sheds_the_rest(pkgname,
                                                          tmp_path):
    """Under a fast SLO burn with ``quality_elastic``, the router serves
    an eligible request sketched (``degraded_cause == "slo_burn"``, the
    engine sees ``backend="sketched"``) and still sheds an ineligible
    one; without it, both are shed."""
    pkg = _pkg(pkgname)
    engines = []

    def factory():
        from test_torch_serve import FakeEngine

        engines.append(FakeEngine(pkg.out_cls))
        return engines[-1]

    stub = _BurnStub(burning=["availability"])
    with pkg.router.NMFXRouter(
            _pool(pkg, tmp_path, engine_factory=factory),
            _fast_cfg(pkg, shed_on_burn=True, slo_interval_s=0.01,
                      quality_elastic=True),
            slo_engine=stub) as router:
        router._last_slo = 0.0
        router._check_slo()
        fut = router.submit(_mat(), ks=(2,), restarts=2)
        res = fut.result(timeout=60)
        assert fut.stats.degraded_cause == "slo_burn"
        assert res.quality == "sketched"
        with pytest.raises(pkg.router.RouterOverloaded, match="fast burn"):
            router.submit(_mat(), ks=(2,), restarts=2,
                          solver_cfg=pkg.SolverConfig(algorithm="als"))
        stats = router.stats()
        assert (stats["degraded"], stats["shed"]) == (1, 1)
    served = [scfg for eng in engines for _, scfg in eng.solo]
    assert [s.backend for s in served] == ["sketched"]


# -- config/key coverage ------------------------------------------------
def test_quality_elastic_in_serve_key_fields():
    assert "quality_elastic" in pserve.serve_key_fields()


def test_every_serve_consensusresult_sets_quality():
    """Every ``ConsensusResult(...)`` construction in the port's
    serve.py passes ``quality=``, so no path can return an untagged
    sketched result."""
    tree = ast.parse(inspect.getsource(pserve))
    sites = [node for node in ast.walk(tree)
             if isinstance(node, ast.Call)
             and getattr(node.func, "id", getattr(node.func, "attr", None))
             == "ConsensusResult"]
    assert sites
    for node in sites:
        assert "quality" in {kw.arg for kw in node.keywords}, node.lineno


def test_degradation_requires_opt_in():
    assert pserve.ServeConfig().quality_elastic is False
