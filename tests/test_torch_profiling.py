"""The port's phase profiler (``nmfx_torch/profiling.py``), as
``tests/test_profiling.py`` pins the reference's: phase books, the
overlap-aware audit against the wall, thread-safe accumulation, and the
phases an ``nmfconsensus`` run books."""

import os
import threading

import pytest
import torch

import nmfx_torch
from nmfx_torch.datasets import two_group_matrix
from nmfx_torch.profiling import NullProfiler, Profiler, _cuda_devices
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def small():
    return two_group_matrix(n_genes=60, n_per_group=10, seed=3)


def _sweep(data, **kw):
    return nmfx_torch.nmfconsensus(data, ks=(2,), restarts=2, max_iter=40,
                                   device="cpu", **kw)


def test_phase_accumulation():
    prof = Profiler()
    with prof:
        with prof.phase("a") as sync:
            sync(torch.ones(8, 8) @ torch.ones(8, 8))
        with prof.phase("a"):
            pass
        with prof.phase("b"):
            pass
    assert prof.phases["a"].count == 2
    assert prof.phases["b"].count == 1
    assert prof.total_seconds() > 0
    report = prof.report()
    assert "a" in report and "b" in report and "total" in report


def test_sync_finds_the_cuda_devices_of_a_result():
    """The phase's sync walks tensors, tuples, NamedTuples and dicts; CPU
    tensors need no synchronize."""
    out = {2: (torch.ones(2), [torch.zeros(1)]), 3: None}
    assert _cuda_devices(out, set()) == set()
    assert _cuda_devices(7, set()) == set()


def test_phase_records_on_exception():
    prof = Profiler()
    with pytest.raises(RuntimeError):
        with prof.phase("boom"):
            raise RuntimeError("x")
    assert prof.phases["boom"].count == 1


def test_streamed_sweep_books_its_phases(small):
    prof = Profiler()
    with prof:
        _sweep(small, grid_exec="per_k", profiler=prof)
    assert prof.phases["solve.k=2"].seconds > 0
    assert prof.phases["xfer.overlap"].count == 1
    # the default harvest is streamed: rank selection in the workers,
    # under the overlap-classed phases
    assert prof.phases["post.rank_selection"].count == 1
    assert prof.phases["xfer.d2h_overlap"].count == 1


def test_grid_sweep_books_solve_grid(small):
    prof = Profiler()
    with prof:
        nmfx_torch.nmfconsensus(small, ks=(2, 3), restarts=2, max_iter=40,
                                device="cpu", profiler=prof)
    assert prof.phases["solve.grid"].count == 1
    assert prof.phases["xfer.overlap"].count == 1
    assert prof.phases["post.rank_selection"].count == 2


def test_sequential_harvest_books_its_phases(small, tmp_path):
    prof = Profiler()
    with prof:
        _sweep(small, harvest="sequential", profiler=prof,
               output=nmfx_torch.OutputConfig(directory=str(tmp_path)))
    assert prof.phases["rank_selection"].count == 1
    assert prof.phases["device_to_host"].count == 1
    assert prof.phases["write_outputs"].count == 1
    assert "post.rank_selection" not in prof.phases


def test_null_profiler_is_transparent(small):
    prof = NullProfiler()
    with prof:
        r = _sweep(small, profiler=prof)
    assert r.per_k[2].consensus.shape == (20, 20)
    assert prof.phases == {}
    assert prof.report() == "profiling disabled"


def test_add_seconds_concurrent_exact():
    """Harvest workers record from their own threads: N threads x M
    additions to one phase neither drop nor double-count (the increments
    are exact in binary, so the sum does not depend on the order)."""
    import sys

    prof = Profiler()
    threads_n, m = 8, 250
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(m):
                prof.add_seconds("post.rank_selection", 0.5)
                prof.mark("xfer.mark")

        threads = [threading.Thread(target=work) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    rec = prof.phases["post.rank_selection"]
    assert rec.count == threads_n * m
    assert rec.seconds == 0.5 * threads_n * m
    assert prof.phases["xfer.mark"].count == threads_n * m


def test_phase_context_concurrent_counts():
    prof = Profiler()
    m = 100

    def work(name):
        for _ in range(m):
            with prof.phase(name):
                pass

    threads = [threading.Thread(target=work, args=(f"t{i % 2}",))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert prof.phases["t0"].count == 2 * m
    assert prof.phases["t1"].count == 2 * m


def test_audit_overlap_split():
    """Overlap-classed phases (xfer.*, post.*) stay out of the
    phase-sum-vs-wall book and are reported as an overlap ratio."""
    prof = Profiler()
    prof.add_seconds("solve.grid", 1.0)
    prof.add_seconds("device_to_host", 0.25)
    prof.add_seconds("xfer.d2h_overlap", 0.4)
    prof.add_seconds("post.rank_selection", 0.3)
    assert prof.phases["xfer.d2h_overlap"].overlapped
    assert not prof.phases["solve.grid"].overlapped
    a = prof.audit(2.0)
    assert a["phase_sum_s"] == 1.25
    assert a["overlap_s"] == pytest.approx(0.7)
    assert a["unattributed_s"] == pytest.approx(0.75)
    assert a["coverage"] == pytest.approx(0.625)
    assert a["overlap_ratio"] == pytest.approx(0.35)
    assert prof.total_seconds() == 1.25
    report = prof.report()
    assert "~xfer.d2h_overlap" in report and "overlapped" in report


def test_audit_zero_wall_division_guards():
    prof = Profiler()
    assert prof.audit(0.0) == {"wall_s": 0.0, "phase_sum_s": 0.0,
                               "unattributed_s": 0.0, "coverage": 0.0,
                               "overlap_s": 0.0, "overlap_ratio": 0.0}
    prof.mark("compile.cache_hit")
    a = prof.audit()
    assert a["wall_s"] == 0.0
    assert a["coverage"] == 0.0 and a["overlap_ratio"] == 0.0
    assert "compile.cache_hit" in prof.report()


def test_audit_all_overlap_edge():
    prof = Profiler()
    prof.add_seconds("xfer.d2h_overlap", 0.4)
    prof.add_seconds("post.rank_selection", 0.6)
    assert prof.total_seconds() == 0.0
    a = prof.audit()
    assert a["wall_s"] == 0.0 and a["coverage"] == 0.0
    assert a["overlap_s"] == pytest.approx(1.0)
    assert a["overlap_ratio"] == 0.0
    assert prof.audit(2.0)["overlap_ratio"] == pytest.approx(0.5)
    for line in prof.report().splitlines():
        if "d2h_overlap" in line or "rank_selection" in line:
            assert line.startswith("~") and line.rstrip().endswith("-")


@pytest.mark.parametrize("harvest", ["streamed", "sequential"])
def test_phase_sum_audit_on_profiled_run(small, harvest):
    """On a real run the sequential phases explain most of the wall and
    never exceed it."""
    prof = Profiler()
    with prof:
        _sweep(small, harvest=harvest, profiler=prof)
    a = prof.audit()
    assert a["wall_s"] > 0
    assert a["phase_sum_s"] <= a["wall_s"] * 1.02 + 0.02
    assert a["coverage"] > 0.5


def test_trace_capture(tmp_path):
    trace_dir = str(tmp_path / "trace")
    prof = Profiler(trace_dir=trace_dir)
    with prof:
        with prof.phase("mm") as sync:
            sync(torch.ones(16, 16) @ torch.ones(16, 16))
    assert os.path.getsize(os.path.join(trace_dir, "trace.json")) > 0
    assert "device trace" in prof.report()
