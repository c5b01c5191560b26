"""The streamed harvest (``nmfx_torch/harvest.py``): per-rank host copies
and rank selection in worker threads must give KResults byte-equal to the
sequential assembly, for mu and hals, on the whole grid and per rank, run
after run; plus the pipeline's own mechanics, as ``tests/test_harvest.py``
pins them for the reference."""

import sys
import threading
import warnings

import numpy as np
import pytest
import torch

import nmfx_torch
from nmfx_torch import harvest
from nmfx_torch.api import InsufficientRestarts, _build_k_result
from nmfx_torch.datasets import two_group_matrix
from nmfx_torch.harvest import HarvestPipeline, start_host_fetch
from nmfx_torch.profiling import Profiler
from nmfx_torch.sweep import KSweepOutput
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


KS = (2, 3)
RESTARTS = 2
MAX_ITER = 30

#: every KResult field, compared byte for byte
FIELDS = ("consensus", "rho", "dispersion", "membership", "order",
          "iterations", "dnorms", "stop_reasons", "best_w", "best_h")


@pytest.fixture(autouse=True)
def _fresh_warnings():
    """The fallback warns once a process (``faults.warn_once``): each test
    starts with no category warned."""
    from nmfx_torch import faults

    faults._reset_warned()
    yield
    faults._reset_warned()


@pytest.fixture(scope="module")
def small_data():
    return two_group_matrix(n_genes=60, n_per_group=10, seed=3)


def _run(data, harvest_mode="streamed", *, algorithm="mu",
         grid_exec="auto", **kw):
    return nmfx_torch.nmfconsensus(
        data, ks=KS, restarts=RESTARTS, seed=11, algorithm=algorithm,
        max_iter=MAX_ITER, grid_exec=grid_exec, harvest=harvest_mode,
        device="cpu", **kw)


def assert_results_byte_equal(a, b):
    assert a.ks == b.ks and set(a.per_k) == set(b.per_k)
    for k in b.per_k:
        for f in FIELDS:
            x = np.asarray(getattr(a.per_k[k], f))
            y = np.asarray(getattr(b.per_k[k], f))
            assert x.dtype == y.dtype and x.shape == y.shape, (k, f)
            assert x.tobytes() == y.tobytes(), f"{f} k={k}"


@pytest.mark.parametrize("algorithm", ["mu", "hals"])
@pytest.mark.parametrize("grid_exec", ["auto", "per_k"])
def test_streamed_equals_sequential(small_data, algorithm, grid_exec):
    streamed = _run(small_data, "streamed", algorithm=algorithm,
                    grid_exec=grid_exec)
    sequential = _run(small_data, "sequential", algorithm=algorithm,
                      grid_exec=grid_exec)
    assert_results_byte_equal(streamed, sequential)


def test_streamed_run_to_run_deterministic(small_data):
    assert_results_byte_equal(_run(small_data), _run(small_data))


def test_default_harvest_is_streamed(small_data):
    prof = Profiler()
    with prof:
        nmfx_torch.nmfconsensus(small_data, ks=KS, restarts=RESTARTS,
                                max_iter=MAX_ITER, device="cpu",
                                profiler=prof)
    assert prof.phases["post.rank_selection"].count == len(KS)
    assert "rank_selection" not in prof.phases


def test_streamed_overlap_phases_recorded(small_data):
    """Workers credit their walls to the overlap phases, which the audit
    keeps out of the sequential phase sum."""
    prof = Profiler()
    with prof:
        _run(small_data, profiler=prof)
    assert prof.phases["xfer.d2h_overlap"].count == len(KS)
    assert prof.phases["post.rank_selection"].count == len(KS)
    assert prof.phases["post.rank_selection"].seconds > 0
    assert prof.phases["post.rank_selection"].overlapped
    assert prof.phases["xfer.overlap"].count == 1  # one grid solve
    assert prof.audit()["overlap_s"] > 0


def test_on_rank_fires_with_the_copies_started(small_data):
    seen = []

    def on_rank(k, out):
        assert out.fetch is not None
        assert torch.is_tensor(out.consensus)
        seen.append(k)

    _run(small_data, grid_exec="per_k", on_rank=on_rank)
    assert seen == list(KS)


def test_device_rank_selection_implies_sequential(small_data):
    prof = Profiler()
    with prof:
        r = _run(small_data, "streamed", rank_selection="device",
                 profiler=prof)
    assert "post.rank_selection" not in prof.phases
    assert prof.phases["rank_selection_dispatch"].count == 1
    host = _run(small_data)
    assert r.best_k == host.best_k
    for k in KS:
        np.testing.assert_array_equal(r.per_k[k].membership,
                                      host.per_k[k].membership)


@pytest.mark.parametrize("kw,match", [
    (dict(harvest_mode="overlapped"), "harvest"),
    (dict(rank_selection="gpu"), "rank_selection")])
def test_bad_modes_rejected(small_data, kw, match):
    with pytest.raises(ValueError, match=match):
        _run(small_data, **kw)


# ---------------------------------------------------------------- pipeline
# mechanics, no solver involved

def _host_out(n=4, stops=(0,)):
    """A host KSweepOutput with a perfect two-cluster consensus."""
    cons = np.kron(np.eye(2), np.ones((n // 2, n // 2))).astype(np.float32)
    r = len(stops)
    return KSweepOutput(
        consensus=torch.as_tensor(cons), labels=None,
        iterations=torch.ones(r, dtype=torch.int32),
        dnorms=torch.zeros(r), stop_reasons=torch.tensor(stops),
        best_w=torch.ones(3, 2), best_h=torch.ones(2, n))


def test_start_host_fetch_on_cpu_is_a_plain_copy():
    out = _host_out()._replace(labels=torch.zeros(1, 4, dtype=torch.int64))
    host = start_host_fetch(out).wait()
    assert host.labels is None and host.fetch is None
    assert isinstance(host.consensus, np.ndarray)
    np.testing.assert_array_equal(host.consensus, out.consensus.numpy())
    out.consensus.fill_(7.0)  # the host copy does not alias the tensor
    assert host.consensus.max() == 1.0


def test_pipeline_matches_the_sequential_assembly():
    pipe = HarvestPipeline(workers=2)
    outs = {k: _host_out(2 * k) for k in (2, 3, 4)}
    for k, out in outs.items():
        pipe.submit(k, out._replace(fetch=start_host_fetch(out)))
    got = pipe.results()
    assert list(got) == [2, 3, 4]
    for k, out in outs.items():
        want = _build_k_result(k, start_host_fetch(out).wait(), "average")
        assert got[k].rho == want.rho
        np.testing.assert_array_equal(got[k].membership, want.membership)


def test_pipeline_double_submit_rejected():
    pipe = HarvestPipeline()
    out = _host_out()
    pipe.submit(2, out)
    with pytest.raises(ValueError, match="submitted twice"):
        pipe.submit(2, out)
    pipe.results()


def test_pipeline_worker_error_propagates():
    pipe = HarvestPipeline()
    pipe.submit(2, None)  # not a NamedTuple: the worker raises
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with pytest.raises(AttributeError):
            pipe.results()
    assert len(caught) == 1 and "harvest worker" in str(caught[0].message)


def test_pipeline_recovers_a_dead_worker_exactly(monkeypatch):
    """A worker that dies leaves its rank to results(), which harvests it
    on the calling thread with ONE warning and the same result."""
    real = harvest.harvest_rank
    calls = {"n": 0}

    def flaky(*args, **kw):
        if threading.current_thread() is not threading.main_thread():
            calls["n"] += 1
            raise RuntimeError("worker died")
        return real(*args, **kw)

    monkeypatch.setattr(harvest, "harvest_rank", flaky)
    pipe = HarvestPipeline(workers=1)
    for k in (2, 3):
        pipe.submit(k, _host_out(4))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = pipe.results()
    assert calls["n"] == 2 and len(caught) == 1
    want = _build_k_result(2, start_host_fetch(_host_out(4)).wait(),
                           "average")
    assert got[2].rho == want.rho and got[3].rho == want.rho


def test_pipeline_insufficient_restarts_not_retried():
    from nmfx_torch.solvers.base import StopReason

    pipe = HarvestPipeline(min_restarts=2)
    pipe.submit(2, _host_out(4, stops=(0, int(StopReason.NUMERIC_FAULT))))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no fallback warning either
        with pytest.raises(InsufficientRestarts):
            pipe.results()


def test_results_leaves_no_worker_running():
    """results() joins its workers: none outlives the pipeline (a worker
    still freeing its last rank's tensors when the interpreter exits
    aborts the process on a card)."""
    pipe = HarvestPipeline(workers=3)
    for k in (2, 3, 4):
        pipe.submit(k, _host_out(2 * k))
    pipe.results()
    assert len(pipe._threads) == 3
    assert not any(t.is_alive() for t in pipe._threads)


def test_pipeline_close_idempotent_and_rejects_late_submit():
    pipe = HarvestPipeline()
    pipe.close()
    pipe.close()
    with pytest.raises(RuntimeError, match="closed"):
        pipe.submit(2, object())


def test_pipeline_workers_validation():
    with pytest.raises(ValueError, match="workers"):
        HarvestPipeline(workers=0)


def test_pipeline_failed_worker_spawn_strands_nothing(monkeypatch):
    """A thread start that fails on the first submit raises out of
    submit() with nothing published, so results() returns at once."""
    pipe = HarvestPipeline()

    def boom(*a, **kw):
        raise RuntimeError("no threads today")

    monkeypatch.setattr(threading, "Thread", boom)
    with pytest.raises(RuntimeError, match="no threads today"):
        pipe.submit(2, object())
    assert pipe._futures == {} and pipe._outs == {}
    monkeypatch.undo()
    assert pipe.results() == {}


def test_pipeline_stress_many_ranks_many_workers():
    """More workers than cores, a short switch interval and one shared
    profiler: every rank resolves, equal to its sequential assembly, and
    the overlap books count every rank exactly once."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        prof = Profiler()
        pipe = HarvestPipeline(workers=16, profiler=prof)
        outs = {k: _host_out(2 * k) for k in range(2, 42)}
        done = threading.Event()
        got = {}

        def consume():
            for k, out in outs.items():
                pipe.submit(k, out)
            got.update(pipe.results())
            done.set()

        t = threading.Thread(target=consume)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive() and done.is_set()
    finally:
        sys.setswitchinterval(old)
    assert list(got) == list(outs)
    for k, out in outs.items():
        want = _build_k_result(k, start_host_fetch(out).wait(), "average")
        assert got[k].rho == want.rho
        np.testing.assert_array_equal(got[k].membership, want.membership)
        np.testing.assert_array_equal(got[k].order, want.order)
    assert prof.phases["post.rank_selection"].count == len(outs)
    assert prof.phases["xfer.d2h_overlap"].count == len(outs)
