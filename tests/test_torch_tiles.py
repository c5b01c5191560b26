"""The port's out-of-core tile pipeline (``nmfx_torch/tiles.py``) and its
routing through the sweep, the ledger, the caches, the command line and
the server, against ``nmfx`` on the CPU.

* ``nmfx``'s ``tests/test_tiles.py``, ported: the plan, the budget, the
  config's refusals, the routing, one-tile delegation byte-equal to the
  in-core route (its slow mu-vmap case a case of the same test here),
  prefetch inertness, agreement with the dense sweep, the stream's
  counters, ``tile_rows`` in every identity key and the checkpoint
  fingerprint. Its three NMFX001 tests read ``nmfx/analysis``, which is
  not ported, and are left out.
* Byte-equal to ``nmfx``: ``TilePlan``, ``resolve_tile_rows`` and
  ``plan_for`` over a grid of shapes and budgets, dense and sparse.
* Engine against engine: ``run_tiled_pool`` in both packages on the same
  keys (the 60×20 fixture, 4 tiles, 6 restarts, mu and hals, dense and
  sparse, 30 iterations with the stop tests off): W and H within
  ``ENGINE_RTOL`` of the largest entry, iterations and stop reasons
  equal; with the stop tests on, the same.
* Full sweeps against ``nmfx``'s at its agreement tier, the same best k.
* The port against itself: prefetch on and off, a resume from a partial,
  one-tile delegation, each byte-equal.
* The repaired fault: a reference ``SolverConfig`` with ``tile_rows``
  converts with it, and a spill record carrying it readmits and runs the
  streamed engine as ``nmfx``'s server does.
"""

import dataclasses
import os

import numpy as np
import pytest

import nmfx
import nmfx.cli as ncli
import nmfx.serve as nserve
import nmfx.sparse as nsparse
import nmfx.tiles as ntiles
import nmfx_torch
import nmfx_torch.cli as pcli
import nmfx_torch.serve as pserve
from nmfx_torch import checkpoint as ckpt
from nmfx_torch import faults, tiles
from nmfx_torch import random as prandom
from nmfx_torch.config import TILED_ALGORITHMS, SolverConfig
from nmfx_torch.convert import solver_config_from_dict
from nmfx_torch.datasets import make_sparse_design, two_group_matrix
from nmfx_torch.io import write_csr_npz, write_gct
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)

KW = dict(ks=(2, 3), restarts=4, seed=5)
CPU = dict(device="cpu")
#: W and H of run_tiled_pool against nmfx's, relative to the largest
#: entry: the same float32 products summed in other orders (observed at
#: most 2.7e-6 over the eight cases)
ENGINE_RTOL = 1e-5
#: nmfx's tiled-against-dense (and sparse-against-densified) gate
MIN_ARI, MAX_RHO_GAP = 0.9, 0.1


@pytest.fixture(scope="module")
def small_data():
    return two_group_matrix(n_genes=60, n_per_group=10, seed=7)


@pytest.fixture(autouse=True)
def _tile_globals_restored():
    yield
    tiles.set_tile_budget_bytes(None)
    tiles.set_tile_prefetch(True)
    ntiles.set_tile_budget_bytes(None)
    ntiles.set_tile_prefetch(True)
    faults.disarm()


def _run(data, scfg, **kw):
    return nmfx_torch.nmfconsensus(data, solver_cfg=scfg,
                                   **{**KW, **CPU, **kw})


def assert_bit_identical(got, ref, ks=None):
    assert set(got.per_k) == set(ref.per_k)
    for k in ks or ref.per_k:
        s, q = got.per_k[k], ref.per_k[k]
        for field in ("consensus", "membership", "order", "iterations",
                      "dnorms", "stop_reasons", "best_w", "best_h"):
            sv = np.ascontiguousarray(np.asarray(getattr(s, field)))
            qv = np.ascontiguousarray(np.asarray(getattr(q, field)))
            assert sv.shape == qv.shape and sv.dtype == qv.dtype \
                and sv.tobytes() == qv.tobytes(), f"{field} k={k}"
        assert s.rho == q.rho, f"rho k={k}"


def _nsparse(sp):
    return nsparse.SparseMatrix(indptr=sp.indptr, indices=sp.indices,
                                data=sp.data, shape=sp.shape)


# ---------------------------------------------------------------------
# plan (nmfx's tests)
# ---------------------------------------------------------------------

def test_plan_boundaries_cover_matrix_exactly():
    plan = tiles.TilePlan(m=100, n=40, tile_rows=30)
    assert plan.n_tiles == 4
    assert plan.boundaries == ((0, 30), (30, 60), (60, 90), (90, 100))
    assert plan.boundaries[-1][1] == plan.m


def test_plan_clamps_tile_rows_to_m():
    plan = tiles.TilePlan(m=10, n=4, tile_rows=64)
    assert plan.tile_rows == 10 and plan.n_tiles == 1


def test_plan_rejects_degenerate():
    with pytest.raises(ValueError, match="degenerate"):
        tiles.TilePlan(m=0, n=4, tile_rows=1)
    with pytest.raises(ValueError, match="tile_rows"):
        tiles.TilePlan(m=4, n=4, tile_rows=0)


def test_resolve_auto_sizes_two_buffers_to_budget():
    rows = tiles.resolve_tile_rows("auto", m=200, n=10, itemsize=4,
                                   budget=2 * 25 * 10 * 4)
    assert rows == 25
    assert tiles.resolve_tile_rows(999, m=40, n=10, itemsize=4) == 40
    with pytest.raises(ValueError, match="resolve"):
        tiles.resolve_tile_rows("huge", m=40, n=10, itemsize=4)


def test_budget_override_feeds_plan_for(small_data):
    n = small_data.shape[1]
    tiles.set_tile_budget_bytes(2 * 16 * n * 4)
    scfg = SolverConfig(algorithm="mu", tile_rows="auto")
    plan = tiles.plan_for(small_data, scfg)
    assert plan.tile_rows == 16
    assert plan.n_tiles == -(-small_data.shape[0] // 16)
    assert tiles.plan_for(small_data, scfg) == plan
    assert plan.as_meta()["n_tiles"] == plan.n_tiles
    with pytest.raises(ValueError, match="budget"):
        tiles.set_tile_budget_bytes(0)


def test_budget_from_environment(monkeypatch):
    monkeypatch.setenv("NMFX_TILE_BUDGET_BYTES", "4096")
    assert tiles.tile_budget_bytes() == ntiles.tile_budget_bytes() == 4096
    tiles.set_tile_budget_bytes(100)
    assert tiles.tile_budget_bytes() == 100
    tiles.set_tile_budget_bytes(None)
    monkeypatch.delenv("NMFX_TILE_BUDGET_BYTES")
    assert tiles.tile_budget_bytes() == ntiles.tile_budget_bytes()


def test_config_rejects_untileable_combinations():
    with pytest.raises(ValueError, match="tile_rows"):
        SolverConfig(algorithm="als", tile_rows=8)
    with pytest.raises(ValueError, match="tile_rows"):
        SolverConfig(algorithm="mu", backend="pallas", tile_rows=8)
    with pytest.raises(ValueError, match="tile_rows"):
        SolverConfig(algorithm="mu", tile_rows=True)
    assert "als" not in TILED_ALGORITHMS and "kl" not in TILED_ALGORITHMS
    assert TILED_ALGORITHMS == nmfx.config.TILED_ALGORITHMS


@pytest.mark.parametrize("kw", [
    dict(tile_rows=0), dict(tile_rows="big"), dict(tile_rows=2.5),
    dict(algorithm="kl", tile_rows="auto"),
    dict(backend="sketched", tile_rows=4),
    dict(backend="pallas", tile_rows="auto")])
def test_config_refusals_as_reference(kw):
    with pytest.raises(ValueError) as got:
        SolverConfig(**kw)
    with pytest.raises(ValueError) as want:
        nmfx.SolverConfig(**kw)
    assert "tile_rows" in str(got.value) and "tile_rows" in str(want.value)


# ---------------------------------------------------------------------
# plan functions byte-equal to nmfx's
# ---------------------------------------------------------------------

def test_plans_equal_reference_over_a_grid():
    sp = make_sparse_design(300, 80, k=3, density=0.07, seed=1)
    sources = ((two_group_matrix(300, 40, seed=2), None),
               (sp, _nsparse(sp)))
    for src, nsrc in sources:
        nsrc = src if nsrc is None else nsrc
        for budget in (1, 640, 2 * 25 * 80 * 4, 10_000, 1 << 20, None):
            tiles.set_tile_budget_bytes(budget)
            ntiles.set_tile_budget_bytes(budget)
            for tr in (None, "auto", 1, 7, 64, 300, 10_000):
                for dtype in ("float32", "float64"):
                    got = tiles.plan_for(src, SolverConfig(
                        tile_rows=tr, dtype=dtype))
                    want = ntiles.plan_for(nsrc, nmfx.SolverConfig(
                        tile_rows=tr, dtype=dtype))
                    assert got.as_meta() == want.as_meta()
                    assert got.boundaries == want.boundaries
    for m, n in ((1, 1), (200, 10), (5000, 500), (20000, 5000)):
        for itemsize in (4, 8):
            for budget in (1, 999, 2 * 625 * 500 * 4, 256 << 20):
                for avg in (None, 0.5, 120.0):
                    for tr in ("auto", 1, 3, m, m + 5):
                        assert tiles.resolve_tile_rows(
                            tr, m, n, itemsize, avg_row_bytes=avg,
                            budget=budget) == ntiles.resolve_tile_rows(
                            tr, m, n, itemsize, avg_row_bytes=avg,
                            budget=budget)


# ---------------------------------------------------------------------
# routing (nmfx's tests)
# ---------------------------------------------------------------------

def test_tile_rows_resolves_tiled_family_and_disables_grid():
    from nmfx_torch.sweep import grid_exec_ok, resolve_engine_family

    scfg = SolverConfig(algorithm="mu", tile_rows=8)
    assert resolve_engine_family(scfg) == "tiled"
    assert ckpt.engine_family(scfg) == "tiled"
    assert not grid_exec_ok(scfg)
    assert not nmfx_torch.ExecCache(device="cpu").cacheable(
        nmfx_torch.ConsensusConfig(), scfg)


def test_base_solve_refuses_tile_rows(small_data):
    from nmfx_torch.solvers import base

    a32 = np.asarray(small_data, np.float32)
    m, n = a32.shape
    rng = np.random.default_rng(0)
    w0 = rng.uniform(0.1, 1.0, (m, 2)).astype(np.float32)
    h0 = rng.uniform(0.1, 1.0, (2, n)).astype(np.float32)
    scfg = SolverConfig(algorithm="mu", max_iter=5, tile_rows=8)
    with pytest.raises(ValueError, match="tile_rows"):
        base.solve(a32, w0, h0, scfg, **CPU)


def test_sweep_one_k_and_refusals_of_the_tiled_arm(small_data, tmp_path):
    from nmfx_torch.sweep import sweep_one_k

    scfg = SolverConfig(algorithm="mu", max_iter=5, tile_rows=8)
    with pytest.raises(ValueError, match="routed by sweep"):
        sweep_one_k(small_data, prandom.key(0), 2, 2, scfg)
    with pytest.raises(ValueError, match="grid_exec='grid'"):
        _run(small_data, scfg, grid_exec="grid")
    with pytest.raises(ValueError, match="durable chunked"):
        _run(small_data, scfg, checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="init method 'random'"):
        _run(small_data, scfg, init="nndsvd")


# ---------------------------------------------------------------------
# one tile == dense, byte for byte (nmfx's tests, its slow case merged)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("scfg", [
    SolverConfig(algorithm="mu", max_iter=30, backend="packed"),
    SolverConfig(algorithm="hals", max_iter=30),
    SolverConfig(algorithm="mu", max_iter=30, backend="vmap"),
], ids=["mu-packed", "hals", "mu-vmap"])
def test_single_tile_delegates_bit_identical(small_data, scfg):
    ref = _run(small_data, scfg)
    passes0 = tiles._tile_passes_total.total()
    got = _run(small_data, dataclasses.replace(
        scfg, tile_rows=small_data.shape[0]))
    assert tiles._tile_passes_total.total() == passes0
    assert_bit_identical(got, ref)


# ---------------------------------------------------------------------
# multi-tile: prefetch inertness, resume, agreement (nmfx's tests)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", sorted(TILED_ALGORITHMS))
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_prefetch_toggle_is_bit_inert(small_data, algorithm, sparse):
    data = (make_sparse_design(60, 20, k=2, density=0.3, seed=3)
            if sparse else small_data)
    scfg = SolverConfig(algorithm=algorithm, max_iter=30, tile_rows=16)
    on = _run(data, scfg)
    tiles.set_tile_prefetch(False)
    off = _run(data, scfg)
    tiles.set_tile_prefetch(True)
    assert_bit_identical(on, off)


def test_multi_tile_agrees_with_dense(small_data):
    from nmfx_torch.agreement import consensus_agreement

    scfg = SolverConfig(algorithm="mu", max_iter=200)
    dense = _run(small_data, scfg)
    tiled = _run(small_data, dataclasses.replace(scfg, tile_rows=16))
    rep = consensus_agreement(tiled, dense)
    assert rep["min_ari"] >= MIN_ARI
    assert rep["max_rho_gap"] <= MAX_RHO_GAP


def test_multi_tile_books_stream_counters(small_data):
    passes0 = tiles._tile_passes_total.value()
    h2d0 = tiles._tile_h2d_bytes_total.value()
    scfg = SolverConfig(algorithm="mu", max_iter=20, tile_rows=16)
    res = _run(small_data, scfg)
    # per rank: the prologue, one pass an iteration, the final pass
    passes = sum(int(res.per_k[k].iterations.max()) + 2 for k in KW["ks"])
    assert tiles._tile_passes_total.value() - passes0 == passes
    assert tiles._tile_h2d_bytes_total.value() - h2d0 == \
        passes * small_data.size * 4


def test_profiler_books_the_stream_phases(small_data):
    from nmfx_torch.profiling import Profiler

    prof = Profiler()
    with prof:
        _run(small_data, SolverConfig(max_iter=10, tile_rows=16),
             profiler=prof)
    assert prof.phases[tiles.TILE_XFER_PHASE].count > 0
    assert prof.phases[tiles.TILE_XFER_PHASE].overlapped


def test_resume_from_partial_byte_equal(small_data, tmp_path):
    """Killed by proc.preempt at a check inside the first chunk, then
    resumed from its partial: byte-equal to an uninterrupted
    checkpointed run, one partial resume booked, no partial left."""
    scfg = SolverConfig(algorithm="hals", max_iter=40, tile_rows=16)

    def run(name):
        return _run(small_data, scfg, ks=(2, 3), checkpoint=(
            nmfx_torch.CheckpointConfig(str(tmp_path / name),
                                        every_n_restarts=2)))

    whole = run("whole")
    resumes0 = tiles._tile_partial_resumes_total.total()
    faults.arm("proc.preempt", every=5, max_fires=1)
    with pytest.raises(ckpt.Preempted, match="mid-matrix at step 10"):
        run("killed")
    faults.disarm()
    assert sorted(os.listdir(tmp_path / "killed")) == [
        "k2_r0-2.part.npz", "manifest.json"]
    solved0 = ckpt.chunks_solved_count()
    resumed = run("killed")
    assert tiles._tile_partial_resumes_total.total() - resumes0 == 1
    assert ckpt.chunks_solved_count() - solved0 == 4
    assert not [f for f in os.listdir(tmp_path / "killed")
                if f.endswith(".part.npz")]
    assert_bit_identical(resumed, whole)


def test_sparse_checkpointed_sweep_resumes_and_replays(tmp_path):
    sp = make_sparse_design(60, 20, k=2, density=0.3, seed=3)
    cp = nmfx_torch.CheckpointConfig(str(tmp_path / "c"),
                                     every_n_restarts=2)
    scfg = SolverConfig(max_iter=30)
    first = _run(sp, scfg, checkpoint=cp)
    solved0 = ckpt.chunks_solved_count()
    again = _run(sp, scfg, checkpoint=cp)
    assert ckpt.chunks_solved_count() == solved0
    assert_bit_identical(again, first)
    plain = _run(sp, scfg)
    for k in KW["ks"]:
        assert np.array_equal(first.per_k[k].iterations,
                              plain.per_k[k].iterations)
        assert np.abs(first.per_k[k].consensus
                      - plain.per_k[k].consensus).max() <= 1e-6


def test_torn_partial_restarts_the_chunk(small_data, tmp_path):
    scfg = SolverConfig(algorithm="mu", max_iter=30, tile_rows=16)
    cp = nmfx_torch.CheckpointConfig(str(tmp_path / "c"),
                                     every_n_restarts=2)
    whole = _run(small_data, scfg, ks=(2,), checkpoint=cp)
    for name in os.listdir(cp.directory):
        if name.endswith(".npz"):
            os.unlink(os.path.join(cp.directory, name))
    with open(os.path.join(cp.directory, "k2_r0-2.part.npz"), "wb") as f:
        f.write(b"torn")
    faults._reset_warned()
    with pytest.warns(RuntimeWarning, match="torn/corrupt/foreign"):
        again = _run(small_data, scfg, ks=(2,), checkpoint=cp)
    assert_bit_identical(again, whole)


# ---------------------------------------------------------------------
# the engine against nmfx's, and full sweeps at the agreement tier
# ---------------------------------------------------------------------

def _sources(small_data, sparse):
    if not sparse:
        return small_data, small_data
    sp = make_sparse_design(60, 20, k=3, density=0.3, seed=3)
    return sp, _nsparse(sp)


@pytest.mark.parametrize("algorithm", ["mu", "hals"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("stops", [False, True], ids=["30-iters",
                                                      "stop-tests"])
def test_run_tiled_pool_matches_reference(small_data, algorithm, sparse,
                                          stops):
    import jax

    src, nsrc = _sources(small_data, sparse)
    kw = dict(algorithm=algorithm, tile_rows=16, max_iter=30)
    if not stops:
        kw.update(use_class_stop=False, use_tol_checks=False)
    else:
        kw.update(max_iter=200, stable_checks=5, tol_x=1e-3)
    keys_n = jax.random.split(jax.random.fold_in(jax.random.key(5), 3), 6)
    keys_p = prandom.split(prandom.fold_in(prandom.key(5), 3), 6)
    want = ntiles.run_tiled_pool(nsrc, keys_n, 3, nmfx.SolverConfig(**kw),
                                 nmfx.InitConfig())
    got = tiles.run_tiled_pool(src, keys_p, 3, SolverConfig(**kw),
                               nmfx_torch.InitConfig(), **CPU)
    assert tiles.plan_for(src, SolverConfig(**kw)).n_tiles == 4
    assert np.array_equal(got.iterations.numpy(),
                          np.asarray(want.iterations))
    assert np.array_equal(got.stop_reason.numpy(),
                          np.asarray(want.stop_reason))
    for name in ("w", "h"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert np.abs(g - w).max() <= ENGINE_RTOL * np.abs(w).max(), name
    assert np.allclose(got.dnorm.numpy(), np.asarray(want.dnorm),
                       rtol=ENGINE_RTOL, atol=ENGINE_RTOL)


@pytest.mark.parametrize("algorithm", ["mu", "hals"])
def test_tiled_sweep_agrees_with_reference(small_data, algorithm):
    from nmfx_torch.agreement import consensus_agreement

    kw = dict(algorithm=algorithm, max_iter=200, tile_rows=16)
    got = _run(small_data, SolverConfig(**kw))
    want = nmfx.nmfconsensus(small_data, solver_cfg=nmfx.SolverConfig(**kw),
                             use_mesh=False, **KW)
    rep = consensus_agreement(got, want)
    assert rep["min_ari"] >= MIN_ARI and rep["max_rho_gap"] <= MAX_RHO_GAP
    assert got.best_k == want.best_k
    for k in KW["ks"]:
        assert np.array_equal(got.per_k[k].stop_reasons,
                              want.per_k[k].stop_reasons)


def test_float64_tiled_sweep_agrees_with_float64_dense(small_data):
    from nmfx_torch.agreement import consensus_agreement

    scfg = SolverConfig(max_iter=200, dtype="float64")
    dense = _run(small_data, scfg)
    tiled = _run(small_data, dataclasses.replace(scfg, tile_rows=16))
    assert tiled.per_k[2].best_w.dtype == np.float64
    rep = consensus_agreement(tiled, dense)
    assert rep["min_ari"] >= MIN_ARI and rep["max_rho_gap"] <= MAX_RHO_GAP


# ---------------------------------------------------------------------
# cache and fingerprint keys: tile_rows reaches every identity layer
# ---------------------------------------------------------------------

def test_tile_rows_in_exec_and_persist_keys():
    from nmfx_torch.exec_cache import persist_key_fields, solver_key_fields

    assert "tile_rows" in solver_key_fields()
    assert "tile_rows" in persist_key_fields()
    a = SolverConfig(algorithm="mu", tile_rows=8)
    b = SolverConfig(algorithm="mu", tile_rows=16)
    assert a != b and hash(a) != hash(b)
    assert repr(a) != repr(b)


def test_tile_rows_in_registry_fingerprint_fields():
    from nmfx_torch.checkpoint import manifest_key_fields
    from nmfx_torch.registry import fingerprint_solver_fields

    assert "tile_rows" in fingerprint_solver_fields()
    assert "tile_rows" in manifest_key_fields()["solver"]


def test_checkpoint_fingerprint_embeds_tile_plan(small_data):
    from nmfx_torch.checkpoint import _fingerprint
    from nmfx_torch.config import ConsensusConfig, InitConfig

    ccfg = ConsensusConfig(ks=(2, 3), restarts=4, seed=5)
    icfg = InitConfig()
    a32 = np.asarray(small_data, np.float32)
    fp8 = _fingerprint(a32, ccfg,
                       SolverConfig(algorithm="mu", tile_rows=8), icfg)
    fp16 = _fingerprint(a32, ccfg,
                        SolverConfig(algorithm="mu", tile_rows=16), icfg)
    fp_dense = _fingerprint(a32, ccfg, SolverConfig(algorithm="mu"), icfg)
    assert fp8 != fp16
    assert fp8 != fp_dense and fp16 != fp_dense
    sp = make_sparse_design(60, 20, k=2, density=0.3, seed=3)
    fp_sp = _fingerprint(sp, ccfg, SolverConfig(algorithm="mu"), icfg)
    assert fp_sp not in (fp8, fp16, fp_dense)
    assert fp_sp == _fingerprint(sp, ccfg, SolverConfig(algorithm="mu"),
                                 icfg)


# ---------------------------------------------------------------------
# the repaired fault: tile_rows crosses from nmfx's configs and records
# ---------------------------------------------------------------------

@pytest.mark.parametrize("tile_rows", [16, "auto", None])
def test_reference_config_converts_with_tile_rows(tile_rows):
    ncfg = nmfx.SolverConfig(algorithm="hals", max_iter=77,
                             tile_rows=tile_rows)
    got = solver_config_from_dict(dataclasses.asdict(ncfg))
    assert got.tile_rows == tile_rows
    assert dataclasses.asdict(got) == {
        k: v for k, v in dataclasses.asdict(ncfg).items()
        if k in dataclasses.asdict(got)}


def test_spill_record_with_tile_rows_readmits_streamed(small_data, tmp_path):
    """A record nmfx's server spilled with tile_rows readmits with it;
    the port then does what nmfx's server does with such a request: the
    executable cache cannot serve it, so it dispatches solo through the
    sweep, which streams it — byte-equal to nmfconsensus, and at the
    agreement tier with nmfx's own run of it."""
    from nmfx_torch.agreement import consensus_agreement

    ncfg = nmfx.SolverConfig(max_iter=60, tile_rows=16)
    meta = nserve.spill_meta(
        request_id=7, ks=(2, 3), restarts=4, seed=5, scfg=ncfg,
        icfg=nmfx.InitConfig(), label_rule="argmax", linkage="average",
        grid_slots=48, grid_tail_slots="auto", min_restarts=1, priority=0,
        col_names=[str(i + 1) for i in range(20)])
    nserve.write_spill_record(str(tmp_path / "spill" / "spill_7_0.npz"),
                              small_data, meta)
    kw = pserve.spill_submit_kwargs(meta)
    assert kw["solver_cfg"].tile_rows == 16
    passes0 = tiles._tile_passes_total.total()
    with pserve.NMFXServer(pserve.ServeConfig(
            spill_dir=str(tmp_path / "spill")),
            exec_cache=nmfx_torch.ExecCache(device="cpu")) as srv:
        futs = srv.readmit()
        assert len(futs) == 1
        got = futs[0].result(timeout=120)
        assert srv.stats()["dispatches"] == 1
    assert tiles._tile_passes_total.total() > passes0
    assert_bit_identical(got, _run(small_data, kw["solver_cfg"]))
    want = nmfx.nmfconsensus(small_data, solver_cfg=ncfg, use_mesh=False,
                             **KW)
    rep = consensus_agreement(got, want)
    assert rep["min_ari"] >= MIN_ARI and rep["max_rho_gap"] <= MAX_RHO_GAP
    assert got.best_k == want.best_k


# ---------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------

def _usage_error(fn, argv, capsys):
    with pytest.raises(SystemExit) as ei:
        fn(argv)
    err = capsys.readouterr().err
    return ei.value.code, err.strip().splitlines()[-1].split(" error: ",
                                                              1)[1]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiles_cli")
    a = two_group_matrix(60, 10, seed=1)
    gct = str(root / "demo.gct")
    write_gct(a, gct, row_names=[f"g{i}" for i in range(60)],
              col_names=[f"s{i}" for i in range(20)])
    npz = str(root / "demo.csr.npz")
    write_csr_npz(make_sparse_design(60, 20, k=2, density=0.3, seed=3), npz)
    return gct, npz


def test_tile_usage_errors_match_reference(files, tmp_path, capsys):
    gct, npz = files
    cases = [
        [gct, "--tile-rows", "16", "--algorithm", "kl"],
        [npz, "--algorithm", "als"],
        [gct, "--tile-rows", "16", "--backend", "pallas"],
        [npz, "--backend", "pallas"],
        [gct, "--tile-rows", "16", "--restart-shards", "1"],
        [gct, "--tile-rows", "16", "--exec-cache"],
        [npz, "--warm-shapes", "60x20"],
        [gct, "--tile-rows", "auto", "--pipeline-ranks"],
        [npz, "--serve-smoke"],
        [gct, "--tile-rows", "16", "--grid-exec", "grid"],
        [gct, "--tile-budget-bytes", "4096"],
        [gct, "--tile-rows", "auto", "--tile-budget-bytes", "0"],
        [gct, "--tile-rows", "0"],
    ]
    for argv in cases:
        argv = argv + ["--no-files"]
        ref = _usage_error(ncli.main, argv, capsys)
        got = _usage_error(pcli.main, argv + ["--device", "cpu"], capsys)
        assert got[0] == ref[0] == 2, (argv, got, ref)
        if "--restart-shards" in argv:
            # sharding a streamed sweep names the port's distributed
            # module where the reference names its own
            assert got[1] == ref[1].replace("nmfx.distributed",
                                            "nmfx_torch.distributed")
        else:
            assert got == ref, (argv, got, ref)
    assert tiles._budget_override is None


@pytest.mark.parametrize("which", ["tiled", "sparse"])
def test_cli_streamed_run_equals_in_process(files, tmp_path, capsys, which):
    gct, npz = files
    path, extra = ((gct, ["--tile-rows", "auto", "--tile-budget-bytes",
                          str(2 * 16 * 20 * 4)]) if which == "tiled"
                   else (npz, ["--tile-rows", "30"]))
    out = tmp_path / "cli"
    argv = [path, "--ks", "2-3", "--restarts", "4", "--maxiter", "60",
            *extra, "--outdir", str(out), "--device", "cpu"]
    passes0 = tiles._tile_passes_total.total()
    assert pcli.main(argv) == 0
    assert tiles._tile_passes_total.total() > passes0
    assert tiles._budget_override is None
    if which == "tiled":
        tiles.set_tile_budget_bytes(2 * 16 * 20 * 4)
    res = nmfx_torch.nmfconsensus(
        path, ks=(2, 3), restarts=4, **CPU, output=nmfx_torch.OutputConfig(
            directory=str(tmp_path / "lib")),
        solver_cfg=SolverConfig(max_iter=60, tile_rows=(
            "auto" if which == "tiled" else 30)))
    assert res.summary() in capsys.readouterr().out
    names = sorted(os.listdir(out))
    assert names == sorted(os.listdir(tmp_path / "lib")) and names
    for name in names:
        with open(out / name, "rb") as f1, \
                open(tmp_path / "lib" / name, "rb") as f2:
            assert f1.read() == f2.read(), name
