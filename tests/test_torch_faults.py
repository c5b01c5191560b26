"""The port's fault registry (``nmfx_torch/faults.py``) and the recovery
paths it rehearses, against ``nmfx``:

* the registry: the same fire schedules for ``every`` / ``max_fires``,
  ``scoped`` restoring, unknown sites rejected, and the same poisoned
  restarts (``poison_restarts``) and dropped reloads (the stale-reload
  job hash) as ``nmfx`` for the same specs;
* the quarantine: with ``solve.nonfinite`` armed, on the routes
  ``nmfx``'s ``test_quarantine_exactness`` covers (the whole grid for mu
  and hals, the batched restart route) and the per-rank packed route,
  the same restarts stop NUMERIC_FAULT, the survivors' iterations, stop
  reasons and labels equal ``nmfx``'s, the consensus is within 1e-6;
  ``InsufficientRestarts`` and the all-lanes-faulted error as in
  ``nmfx``; hals' slot-scheduler layout leaves every other restart
  byte-equal to the clean run;
* the exact fallbacks: ``harvest.worker`` and ``h2d.transfer`` give
  byte-equal results with one warning;
* the stale reload: dropped jobs change the result, and after ``disarm``
  the run is byte-equal to the clean one.
"""

import numpy as np
import pytest

import nmfx
import nmfx_torch
from nmfx import faults as jfaults
from nmfx.ops import sched_mu as jsched
from nmfx_torch import faults
from nmfx_torch.datasets import two_group_matrix
from nmfx_torch.ops import sched_mu as tsched
from nmfx_torch.solvers.base import StopReason
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)

KS = (2, 3)
RESTARTS = 4
SEED = 5
MAX_ITER = 40
FAULT = int(StopReason.NUMERIC_FAULT)


@pytest.fixture(autouse=True)
def _pristine():
    for reg in (faults, jfaults):
        reg.disarm()
        reg._reset_warned()
    yield
    for reg in (faults, jfaults):
        reg.disarm()
        reg._reset_warned()


@pytest.fixture(scope="module")
def small_data():
    return two_group_matrix(n_genes=60, n_per_group=10, seed=7)


def _port(data, *, algorithm="mu", backend="auto", grid_exec="auto",
          ks=KS, restarts=RESTARTS, **kw):
    return nmfx_torch.nmfconsensus(
        data, ks=ks, restarts=restarts, seed=SEED, grid_exec=grid_exec,
        solver_cfg=nmfx_torch.SolverConfig(
            algorithm=algorithm, backend=backend, max_iter=MAX_ITER),
        device="cpu", **kw)


def _ref(data, *, algorithm="mu", backend="auto", grid_exec="auto"):
    return nmfx.nmfconsensus(
        data, ks=KS, restarts=RESTARTS, seed=SEED, grid_exec=grid_exec,
        solver_cfg=nmfx.SolverConfig(algorithm=algorithm, backend=backend,
                                     max_iter=MAX_ITER), use_mesh=False)


def assert_byte_equal(got, want):
    for k in want.per_k:
        for f in ("consensus", "rho", "membership", "order", "iterations",
                  "dnorms", "stop_reasons", "best_w", "best_h"):
            x = np.asarray(getattr(got.per_k[k], f))
            y = np.asarray(getattr(want.per_k[k], f))
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), \
                f"{f} k={k}"


# -- the registry ----------------------------------------------------------

def test_unknown_site_and_validation_rejected():
    with pytest.raises(ValueError, match="unknown fault site"):
        faults.arm("no.such.site")
    with pytest.raises(ValueError, match="every"):
        faults.arm("h2d.transfer", every=0)
    with pytest.raises(ValueError, match="max_fires"):
        faults.arm("h2d.transfer", max_fires=0)
    with pytest.raises(ValueError, match="rate"):
        faults.arm("solve.nonfinite", rate=1.5)
    with pytest.raises(ValueError, match="rate"):
        faults.arm("solve.nonfinite")
    assert faults.SITES == jfaults.SITES


@pytest.mark.parametrize("every,max_fires", [(1, None), (2, 2), (3, 1),
                                             (5, None)])
def test_fire_schedule_equals_reference(every, max_fires):
    site = "compile.build"
    faults.arm(site, every=every, max_fires=max_fires)
    jfaults.arm(site, every=every, max_fires=max_fires)
    got = [faults.fire(site) for _ in range(12)]
    assert got == [jfaults.fire(site) for _ in range(12)]
    assert (faults.hits(site), faults.fires(site)) == (
        jfaults.hits(site), jfaults.fires(site))


def test_inject_and_scoped():
    faults.arm("persist.deserialize", every=1)
    with pytest.raises(faults.FaultInjected) as exc:
        faults.inject("persist.deserialize")
    assert (exc.value.site, exc.value.hit) == ("persist.deserialize", 1)
    faults.arm("h2d.transfer", every=3)
    with faults.scoped("h2d.transfer", every=1):
        assert faults.armed("h2d.transfer").every == 1
    assert faults.armed("h2d.transfer").every == 3
    faults.disarm("h2d.transfer")
    with faults.scoped("h2d.transfer", every=5):
        assert faults.armed("h2d.transfer").every == 5
    assert faults.armed("h2d.transfer") is None
    assert nmfx_torch.InsufficientRestarts is faults.InsufficientRestarts


@pytest.mark.parametrize("spec", [dict(lanes=((2, 1), (3, 7))),
                                  dict(rate=0.5, seed=7),
                                  dict(rate=0.05, seed=0),
                                  dict(rate=0.0, seed=7)])
def test_poison_restarts_equal_reference(spec):
    faults.arm("solve.nonfinite", **spec)
    jfaults.arm("solve.nonfinite", **spec)
    for k in range(2, 11):
        for r in (3, 50, 64):
            assert faults.poison_restarts(k, r) == \
                jfaults.poison_restarts(k, r), (k, r)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_stale_reload_jobs_equal_reference(rate):
    jobs = np.arange(450)
    faults.arm("sched.stale_reload", rate=rate)
    jfaults.arm("sched.stale_reload", rate=rate)
    want = np.asarray(jsched._stale_load_mask(
        np.ones(jobs.shape, bool), jobs))
    got = tsched._stale_load_mask(jobs)
    assert np.array_equal(got, want) and 0 < (~got).sum() < jobs.size
    faults.disarm()
    assert tsched._stale_load_mask(jobs).all()


def test_warn_once_per_category():
    import warnings

    with pytest.warns(RuntimeWarning, match="first"):
        faults.warn_once("chaos-test", "first")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        faults.warn_once("chaos-test", "second (not warned)")


# -- the quarantine --------------------------------------------------------

QUARANTINE_ROUTES = [
    dict(algorithm="mu", backend="auto", grid_exec="auto"),
    dict(algorithm="mu", backend="vmap", grid_exec="per_k"),
    dict(algorithm="hals", backend="packed", grid_exec="auto"),
    dict(algorithm="mu", backend="auto", grid_exec="per_k"),
]


@pytest.mark.parametrize("route", QUARANTINE_ROUTES,
                         ids=lambda r: "-".join(r.values()))
def test_quarantine_matches_reference(small_data, route):
    lanes = ((2, 3), (3, 1))
    faults.arm("solve.nonfinite", lanes=lanes)
    jfaults.arm("solve.nonfinite", lanes=lanes)
    got = _port(small_data, **route)
    want = _ref(small_data, **route)
    for k, r_bad in lanes:
        g, w = got.per_k[k], want.per_k[k]
        assert g.stop_reasons[r_bad] == FAULT
        assert np.array_equal(g.stop_reasons, w.stop_reasons)
        assert np.array_equal(g.iterations, w.iterations)
        assert np.array_equal(g.membership, w.membership)
        np.testing.assert_allclose(g.consensus, w.consensus, atol=1e-6)


def test_quarantine_on_the_hals_pool_layout_leaves_others_exact(
        small_data):
    """hals on the slot scheduler's packed-column layout (the kernel
    route, plain versions here): a poisoned restart stops NUMERIC_FAULT
    and every other restart is byte-equal to the clean run's."""
    kw = dict(algorithm="hals", backend="pallas")
    clean = _port(small_data, **kw)
    faults.arm("solve.nonfinite", lanes=((3, 2),))
    bad = _port(small_data, **kw)
    assert bad.per_k[3].stop_reasons[2] == FAULT
    keep = [r for r in range(RESTARTS) if r != 2]
    for f in ("iterations", "stop_reasons", "dnorms"):
        assert np.array_equal(getattr(bad.per_k[3], f)[keep],
                              getattr(clean.per_k[3], f)[keep])
    for f in ("consensus", "iterations", "stop_reasons", "best_w"):
        assert np.array_equal(getattr(bad.per_k[2], f),
                              getattr(clean.per_k[2], f))


def test_quarantine_floor_and_all_faulted(small_data):
    faults.arm("solve.nonfinite", lanes=((2, 0),))
    with pytest.raises(faults.InsufficientRestarts, match="min_restarts=2"):
        _port(small_data, backend="vmap", grid_exec="per_k", ks=(2,),
              restarts=2, min_restarts=2)
    faults.arm("solve.nonfinite", lanes=((2, 0), (2, 1)))
    with pytest.raises(faults.InsufficientRestarts, match="0 of 2"):
        _port(small_data, backend="vmap", grid_exec="per_k", ks=(2,),
              restarts=2)


def test_poison_refuses_restart_chunk(small_data):
    faults.arm("solve.nonfinite", lanes=((2, 0),))
    with pytest.raises(ValueError, match="restart_chunk"):
        nmfx_torch.nmfconsensus(
            small_data, ks=(2,), restarts=4, device="cpu",
            solver_cfg=nmfx_torch.SolverConfig(backend="vmap", max_iter=10,
                                               restart_chunk=2))


# -- exact fallbacks -------------------------------------------------------

def test_harvest_worker_death_falls_back_exactly(small_data):
    clean = _port(small_data)
    faults.arm("harvest.worker", every=1)
    with pytest.warns(RuntimeWarning, match="harvest-worker-fallback"):
        got = _port(small_data, harvest="streamed")
    assert faults.fires("harvest.worker") == len(KS)
    assert_byte_equal(got, clean)


def test_h2d_transfer_fault_falls_back_direct_exactly():
    from nmfx_torch import data_cache

    fresh = two_group_matrix(n_genes=48, n_per_group=8, seed=9)
    faults.arm("h2d.transfer", every=1)
    n0 = data_cache.transfer_count()
    with pytest.warns(RuntimeWarning, match="h2d-direct-fallback"):
        faulted = _port(fresh)
    assert faults.fires("h2d.transfer") == 1
    assert data_cache.transfer_count() == n0 + 1  # the direct copy
    faults.disarm("h2d.transfer")
    assert_byte_equal(faulted, _port(fresh))


# -- stale reload ----------------------------------------------------------

def test_stale_reload_changes_results_and_disarm_restores(small_data):
    """On the slot scheduler (12 jobs through 4 slots, so slots reload)
    the dropped reloads change the result; disarmed, the run is
    byte-equal to the clean one. Both reload paths: the uniform pool and
    the ragged class-blocked pool."""
    for exp in (nmfx_torch.ExperimentalConfig(),
                nmfx_torch.ExperimentalConfig(ragged=True)):
        kw = dict(ks=(2, 3, 4), restarts=4, seed=SEED, grid_slots=4,
                  device="cpu", solver_cfg=nmfx_torch.SolverConfig(
                      backend="pallas", max_iter=MAX_ITER,
                      check_block=1, experimental=exp))
        clean = nmfx_torch.nmfconsensus(small_data, **kw)
        faults.arm("sched.stale_reload", rate=0.5)
        stale = nmfx_torch.nmfconsensus(small_data, **kw)
        faults.disarm("sched.stale_reload")
        again = nmfx_torch.nmfconsensus(small_data, **kw)
        assert any(not np.array_equal(stale.per_k[k].best_w,
                                      clean.per_k[k].best_w)
                   or not np.array_equal(stale.per_k[k].iterations,
                                         clean.per_k[k].iterations)
                   for k in clean.ks)
        assert_byte_equal(again, clean)
