"""The port's cost model (``nmfx_torch/obs/costmodel.py``) against the
reference's analytic half (``nmfx/obs/costmodel.py``): per-iteration
FLOPs and bytes equal for every (algorithm, family) pair the port
routes, at several shapes and under the settings the models read
(check_block, fused updates, bf16 operands, float64); dispatch costs
equal; coverage held both ways; attribution records and verdicts equal
under the same device peak; and the profiled CPU sweep attributing its
dispatches. Host only."""

import dataclasses

import numpy as np
import pytest

import nmfx
import nmfx_torch
from nmfx.obs import costmodel as ncm
from nmfx_torch.convert import solver_config_from_dict
from nmfx_torch.datasets import two_group_matrix
from nmfx_torch.obs import costmodel as cm
from nmfx_torch.obs import metrics

M, N, K = 48, 24, 3
SHAPES = ((48, 24, 3), (200, 30, 7), (5000, 500, 10), (1237, 77, 2))


def _pair_cfgs(algorithm: str, family: str):
    """(nmfx cfg, port cfg) pairs exercising every setting the models
    read on ``family``."""
    backend = {"vmap": "vmap", "packed": "packed", "pallas": "pallas"}[
        family]
    if algorithm in ("mu", "hals") and family == "packed":
        backend = "auto"
    variants = [dict(), dict(check_block=1), dict(check_block=2),
                dict(check_every=5, check_block=3)]
    if family == "pallas":
        variants.append(dict(matmul_precision="bfloat16"))
        if algorithm == "mu":
            variants.append(dict(experimental=nmfx.ExperimentalConfig(
                fused_updates="fused")))
    else:
        variants.append(dict(dtype="float64"))
    if family == "packed" and algorithm != "kl":
        variants.append(dict(matmul_precision="bfloat16"))
    out = []
    for kw in variants:
        ncfg = nmfx.SolverConfig(algorithm=algorithm, backend=backend, **kw)
        out.append((ncfg, solver_config_from_dict(dataclasses.asdict(ncfg))))
    return out


@pytest.fixture(autouse=True)
def _attrib_state_isolated():
    was = cm.attribution_enabled()
    yield
    cm.reset_perf()
    if was:
        cm.enable_attribution()
    else:
        cm.disable_attribution()


# ---------------------------------------------------------------------
# the models against the reference's
# ---------------------------------------------------------------------

@pytest.mark.parametrize("pair", sorted(cm.engine_universe()),
                         ids=lambda p: f"{p[0]}-{p[1]}")
def test_iteration_models_equal_reference(pair):
    algorithm, family = pair
    for ncfg, tcfg in [(None, None)] + _pair_cfgs(algorithm, family):
        for m, n, k in SHAPES:
            assert (cm.iteration_flops(algorithm, family, m, n, k, tcfg)
                    == ncm.iteration_flops(algorithm, family, m, n, k,
                                           ncfg)), (pair, ncfg, m, n, k)
            assert (cm.iteration_bytes(algorithm, family, m, n, k, tcfg)
                    == ncm.iteration_bytes(algorithm, family, m, n, k,
                                           ncfg)), (pair, ncfg, m, n, k)


@pytest.mark.parametrize("algorithm,backend", [
    ("mu", "auto"), ("mu", "pallas"), ("mu", "vmap"), ("hals", "auto"),
    ("hals", "pallas"), ("kl", "auto"), ("kl", "packed"),
    ("neals", "packed"), ("als", "auto"), ("snmf", "packed"),
    ("pg", "auto"), ("alspg", "vmap")])
def test_dispatch_cost_equal_reference(algorithm, backend):
    ncfg = nmfx.SolverConfig(algorithm=algorithm, backend=backend,
                             max_iter=50)
    tcfg = solver_config_from_dict(dataclasses.asdict(ncfg))
    iters = {2: [10, 20, 3], 3: np.array([5, 7]), 5: [1]}
    got = cm.dispatch_cost(tcfg, 300, 40, iters)
    want = ncm.dispatch_cost(ncfg, 300, 40, iters)
    assert got == want
    if algorithm in cm.COSTMODEL_EXEMPT:
        assert got is None


def test_universe_matches_coverage_both_ways():
    assert cm.engine_universe() == cm.covered_engines()
    from nmfx_torch.solvers import SOLVERS

    live = cm.check_costmodel_coverage(
        cm.engine_universe(), cm.covered_engines(), cm.COSTMODEL_EXEMPT,
        frozenset(SOLVERS))
    assert live == []
    # the port's universe is the reference's without the families it
    # does not run yet
    assert cm.engine_universe() == frozenset(
        p for p in ncm.engine_universe()
        if p[1] not in ("sketched", "tiled"))


def test_coverage_check_flags_each_drift():
    from nmfx_torch.solvers import SOLVERS

    universe, covered = cm.engine_universe(), cm.covered_engines()
    algos = frozenset(SOLVERS)
    missing = cm.check_costmodel_coverage(
        universe | {("mu", "newfam")}, covered, cm.COSTMODEL_EXEMPT, algos)
    assert len(missing) == 1 and "no cost model" in missing[0]
    stale = cm.check_costmodel_coverage(
        universe - {("kl", "packed")}, covered, cm.COSTMODEL_EXEMPT, algos)
    assert len(stale) == 1 and "stale entry" in stale[0]
    exempt = cm.check_costmodel_coverage(
        universe, covered, cm.COSTMODEL_EXEMPT + ("mu",), algos)
    assert any("COSTMODEL_EXEMPT but has model entries" in p
               for p in exempt)
    gone = cm.check_costmodel_coverage(
        universe, covered, cm.COSTMODEL_EXEMPT + ("nope",), algos)
    assert any("stale exemption" in p for p in gone)


def test_exempt_algorithms_report_none():
    for algo in cm.COSTMODEL_EXEMPT:
        assert cm.iteration_flops(algo, "vmap", M, N, K) is None
        assert cm.iteration_bytes(algo, "vmap", M, N, K) is None


def test_pallas_bytes_below_packed_and_fused_single_a_read():
    """The locality the attribution surfaces, as the reference pins it:
    the block kernels move fewer modeled bytes than the dense family at
    the same FLOPs, and the join-the-updates kernel fewer than the
    phased one by less than one A pass."""
    m, n, k = 5000, 500, 10
    for algo in ("mu", "hals"):
        cfg = nmfx_torch.SolverConfig(algorithm=algo, backend="pallas")
        assert (cm.iteration_bytes(algo, "pallas", m, n, k, cfg)
                < cm.iteration_bytes(algo, "packed", m, n, k, cfg))
        assert (cm.iteration_flops(algo, "pallas", m, n, k, cfg)
                == cm.iteration_flops(algo, "packed", m, n, k, cfg))
    phased = cm.iteration_bytes("mu", "pallas", m, n, k,
                                nmfx_torch.SolverConfig(backend="pallas"))
    fused = cm.iteration_bytes("mu", "pallas", m, n, k,
                               nmfx_torch.SolverConfig(
                                   backend="pallas",
                                   experimental=nmfx_torch.ExperimentalConfig(
                                       fused_updates="fused")))
    assert m * n * 4 / 2 < phased - fused < m * n * 4


def test_dispatch_cost_sums_lanes_and_ranks():
    """One dispatch's cost is Σ_k iteration model × Σ_lane iterations,
    its intensity the ratio of the two; no lanes cost nothing."""
    scfg = nmfx_torch.SolverConfig(backend="pallas")
    iters = {2: [10, 20, 3], 4: np.array([5, 7])}
    got = cm.dispatch_cost(scfg, M, N, iters)
    flops = sum(cm.iteration_flops("mu", "pallas", M, N, k, scfg)
                * float(sum(int(i) for i in it)) for k, it in iters.items())
    bytes_ = sum(cm.iteration_bytes("mu", "pallas", M, N, k, scfg)
                 * float(sum(int(i) for i in it)) for k, it in iters.items())
    assert got == {"flops": flops, "bytes": bytes_, "family": "pallas",
                   "arithmetic_intensity": flops / bytes_}
    assert cm.dispatch_cost(scfg, M, N, {}) == {
        "flops": 0.0, "bytes": 0.0, "family": "pallas",
        "arithmetic_intensity": None}


# ---------------------------------------------------------------------
# device peaks
# ---------------------------------------------------------------------

def test_peak_table_holds_the_card_and_no_default():
    rec = cm.device_peak("NVIDIA H100 80GB HBM3")
    assert rec == {"flops": 989e12, "hbm_bytes_per_s": 3.35e12,
                   "kind": "NVIDIA H100 80GB HBM3"}
    assert not any(k.startswith("TPU") for k in cm.DEVICE_PEAKS)
    assert cm.device_peak() is None  # no process-wide default device
    assert cm.device_kind("cpu") == "cpu"
    assert cm.device_peak(device="cpu") is None
    with pytest.raises(ValueError):
        cm.set_device_peak("x", 0, 1)


# ---------------------------------------------------------------------
# attribution against the reference
# ---------------------------------------------------------------------

def _attribute_both(kind, algorithm="mu", backend="auto", iters=None,
                    solve_s=0.25):
    ncfg = nmfx.SolverConfig(algorithm=algorithm, backend=backend,
                             max_iter=50)
    tcfg = solver_config_from_dict(dataclasses.asdict(ncfg))
    iters = iters if iters is not None else {2: [10, 10], 3: [10]}
    got = cm.attribute_dispatch(kind, tcfg, M, N, iters, solve_s,
                                device="cpu")
    want = ncm.attribute_dispatch(kind, ncfg, M, N, iters, solve_s)
    return got, want


def _drop_cpu_peaks():
    for mod in (cm, ncm):
        with mod._peaks_lock:
            mod.DEVICE_PEAKS.pop("cpu", None)


def test_attribute_dispatch_records_and_verdicts_equal_reference():
    """The reference's device kind on its CPU backend is "cpu", the
    port's CPU device's too: under the same set_device_peak both give
    the same record, on each side of the ridge, and without a peak the
    same "unknown device peak" verdict."""
    import jax

    assert str(jax.devices()[0].device_kind) == "cpu"
    cm.reset_perf()
    ncm.reset_perf()
    try:
        got, want = _attribute_both("parity.nopeak")
        assert got == want and "unknown device peak" in got["verdict"]
        for mod in (cm, ncm):
            mod.set_device_peak("cpu", 197e12, 819e9)
        for alg, backend in (("mu", "pallas"), ("hals", "auto"),
                             ("kl", "packed"), ("neals", "auto")):
            got, want = _attribute_both(f"parity.{alg}", alg, backend)
            assert got == want
            assert "bandwidth-bound" in got["verdict"]
        for mod in (cm, ncm):
            mod.set_device_peak("cpu", 1e6, 1e15)
        got, want = _attribute_both("parity.flip")
        assert got == want and "compute-bound" in got["verdict"]
        mine = cm.perf_summary()
        ref = ncm.perf_summary()
        assert mine["device_peak"] == ref["device_peak"]
        assert set(mine["kinds"]) >= {"parity.mu", "parity.flip"}
        for kind in mine["kinds"]:
            # the reference's aggregate also weights walls by device
            # count for its meshed route; on one device the weight is 1
            want = dict(ref["kinds"][kind])
            assert want.pop("device_seconds") == want["seconds"]
            assert mine["kinds"][kind] == want, kind
    finally:
        _drop_cpu_peaks()
        ncm.reset_perf()


def test_attribution_disabled_and_guards():
    cm.disable_attribution()
    scfg = nmfx_torch.SolverConfig()
    assert cm.attribute_dispatch("x", scfg, M, N, {2: [5]}, 0.1) is None
    cm.enable_attribution()
    assert cm.attribute_dispatch("x", scfg, M, N, {2: [5]}, 0.0) is None
    assert cm.attribute_dispatch("x", scfg, M, N, {2: [5]}, None) is None
    assert cm.attribute_dispatch(
        "x", nmfx_torch.SolverConfig(algorithm="pg"), M, N, {2: [5]},
        0.1) is None
    assert cm.perf_summary()["kinds"] == {}


def test_profiled_sweep_attributes_grid_and_ranks():
    """A profiled CPU sweep attributes "sweep.grid" (the whole grid) and
    "sweep.k" (each rank of the per-rank route); the model FLOPs are the
    sum of iteration_flops × iterations of the result; the report
    carries the table and the histograms export. A NullProfiler sweep
    attributes nothing."""
    from nmfx_torch.profiling import Profiler

    cm.reset_perf()
    a = two_group_matrix(60, 10, seed=3)
    scfg = nmfx_torch.SolverConfig(backend="pallas", max_iter=40)
    nmfx_torch.nmfconsensus(a, ks=(2, 3), restarts=3, solver_cfg=scfg,
                            device="cpu")
    assert cm.perf_summary()["kinds"] == {}
    prof = Profiler()
    with prof:
        grid = nmfx_torch.nmfconsensus(a, ks=(2, 3), restarts=3,
                                       solver_cfg=scfg, device="cpu",
                                       profiler=prof)
        per_k = nmfx_torch.nmfconsensus(a, ks=(2, 3), restarts=3,
                                        solver_cfg=scfg, device="cpu",
                                        grid_exec="per_k", profiler=prof)
    kinds = cm.perf_summary()["kinds"]
    assert kinds["sweep.grid"]["dispatches"] == 1
    assert kinds["sweep.k"]["dispatches"] == 2
    for kind, res in (("sweep.grid", grid), ("sweep.k", per_k)):
        want = sum(cm.iteration_flops("mu", "pallas", 60, 20, k, scfg)
                   * int(res.per_k[k].iterations.sum()) for k in (2, 3))
        assert kinds[kind]["flops"] == want
        assert kinds[kind]["family"] == "pallas"
        assert "unknown device peak" in kinds[kind]["verdict"]
    recs = cm.recent_attributions()
    assert [r["kind"] for r in recs] == ["sweep.grid", "sweep.k",
                                         "sweep.k"]
    assert recs[0]["device_peak"] is None and recs[0]["mfu"] is None
    report = prof.report()
    assert "perf attribution" in report and "sweep.grid" in report
    text = metrics.registry().prometheus_text()
    assert 'nmfx_perf_achieved_flops_bucket{kind="sweep.grid"' in text
