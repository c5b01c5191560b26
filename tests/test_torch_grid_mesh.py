"""The feature and sample mesh axes: the grid-sharded sweep
(``nmfx_torch.sweep._build_grid_sharded_sweep_fn``) on the lockstep
collective layer (``nmfx_torch.collectives``).

Held three ways, as nmfx's grid tests hold nmfx:

* against the port unmeshed, to nmfx's own grid contracts
  (``tests/test_sharding.py:83-330``): mu and kl labels and iterations
  equal, consensus within 1e-6, dnorms rtol 1e-3, best factors rtol 5e-3
  / atol 5e-4; the Gram family labels equal with iterations only bounded;
  and ``tests/test_mesh_parity.py:52-60``'s agreement gate (atol 0.35);
* against nmfx's grid run on the same mesh shape (8 forced CPU devices),
  from the same keys, at the tier the port's unmeshed routes are held to
  nmfx (``test_torch_vmap_sweep.py``): equal iterations, stops and labels,
  consensus 1e-6, dnorms rtol 1e-4, factors rtol 2e-4 / atol 1e-4 (snmf
  5e-3 / 1e-3);
* the refusals and errors against nmfx's, ``place_input``'s tiling, and
  the collectives of one mu and one kl iteration against ``comm_model``.

On the CPU the mesh names the one CPU device several times; each grid
shard runs on its own thread."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import nmfx
from nmfx import sweep as nsweep
from nmfx_torch import collectives as coll
from nmfx_torch import random as _random
from nmfx_torch import sweep as psweep
from nmfx_torch.config import ConsensusConfig, InitConfig, SolverConfig
from nmfx_torch.obs import costmodel
from nmfx_torch.solvers import SOLVERS
from nmfx_torch.solvers import base as pbase
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)


def _gmesh(r, f, s):
    return psweep.grid_mesh(r, f, s, devices=["cpu"] * (r * f * s))


def _fmesh(r, f):
    return psweep.feature_mesh(r, f, devices=["cpu"] * (r * f))


def _one_k(a, seed, k, restarts, cfg, mesh, init_cfg=InitConfig()):
    return psweep.sweep_one_k(torch.as_tensor(np.asarray(a, np.float32)),
                              _random.key(seed), k, restarts, cfg,
                              init_cfg, mesh=mesh)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_grid_contract(got, ref, m, n, k=3):
    np.testing.assert_array_equal(_np(got.labels), _np(ref.labels))
    np.testing.assert_array_equal(_np(got.iterations), _np(ref.iterations))
    np.testing.assert_allclose(_np(got.consensus), _np(ref.consensus),
                               atol=1e-6)
    np.testing.assert_allclose(_np(got.dnorms), _np(ref.dnorms), rtol=1e-3)
    assert tuple(got.best_w.shape) == (m, k)
    assert tuple(got.best_h.shape) == (k, n)
    np.testing.assert_allclose(_np(got.best_w), _np(ref.best_w), rtol=5e-3,
                               atol=5e-4)
    np.testing.assert_allclose(_np(got.best_h), _np(ref.best_h), rtol=5e-3,
                               atol=5e-4)


# -- against the port unmeshed, nmfx's contracts ---------------------------
@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (1, 8)])
def test_feature_sharded_matches_unsharded(low_rank_data, shape):
    a, _ = low_rank_data
    cfg = SolverConfig(max_iter=150)
    ref = _one_k(a, 5, 3, 8, cfg, None)
    got = _one_k(a, 5, 3, 8, cfg, _fmesh(*shape))
    _assert_grid_contract(got, ref, *a.shape)


def test_feature_sharded_uneven_m(low_rank_data):
    a, _ = low_rank_data
    a = a[:53]  # 53 rows over 4 feature shards: padded to 56
    cfg = SolverConfig(max_iter=100)
    ref = _one_k(a, 2, 3, 4, cfg, None)
    got = _one_k(a, 2, 3, 4, cfg, _fmesh(2, 4))
    assert tuple(got.best_w.shape) == (53, 3)
    np.testing.assert_array_equal(_np(got.labels), _np(ref.labels))
    np.testing.assert_allclose(_np(got.consensus), _np(ref.consensus),
                               atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 2, 4), (2, 1, 4),
                                   (1, 1, 8)])
def test_grid_sharded_matches_unsharded(low_rank_data, shape):
    a, _ = low_rank_data
    a = a[:53, :21]  # both dims uneven across every shard count here
    cfg = SolverConfig(max_iter=120)
    ref = _one_k(a, 5, 3, 8, cfg, None)
    got = _one_k(a, 5, 3, 8, cfg, _gmesh(*shape))
    _assert_grid_contract(got, ref, 53, 21)


@pytest.mark.parametrize("algorithm,shape,dtype", [
    ("kl", (2, 2, 2), "float32"), ("kl", (1, 2, 4), "float32"),
    ("kl", (2, 1, 4), "float32"), ("kl", (1, 1, 8), "float32"),
    ("neals", (2, 2, 2), "float32"), ("neals", (1, 2, 4), "float32"),
    ("snmf", (2, 2, 2), "float32"), ("snmf", (2, 1, 4), "float64"),
    ("hals", (2, 2, 2), "float32"), ("hals", (1, 2, 4), "float32"),
])
def test_grid_solver_sharded_matches_unsharded(low_rank_data, algorithm,
                                               shape, dtype):
    """nmfx's contract: labels exactly; kl's iterations exactly, the Gram
    family's only bounded (a TolX/TolFun crossing on a plateau can slip
    with the sums' order); consensus 1e-6; dnorms rtol 1e-3 with an atol
    floor of 1e-4 (the exactly low-rank fixture drives the residual to
    numerical zero); factors compared when both crowned the same
    restart. snmf on (2, 1, 4) runs in float64: in float32 one label of
    a restart that runs to ``max_iter`` parts there (snmf amplifies
    rounding on this fixture; ROADMAP §3), and in float64 the grid run is
    the unmeshed one to 1e-11 (:func:`test_gram_family_grid_exact_in_float64`)."""
    a, _ = low_rank_data
    a = a[:53, :21]
    cfg = SolverConfig(algorithm=algorithm, max_iter=120, dtype=dtype)
    t_dt = torch.float64 if dtype == "float64" else torch.float32
    at = torch.as_tensor(np.asarray(a), dtype=t_dt)
    ref = psweep.sweep_one_k(at, _random.key(5), 3, 8, cfg)
    got = psweep.sweep_one_k(at, _random.key(5), 3, 8, cfg,
                             mesh=_gmesh(*shape))
    np.testing.assert_array_equal(_np(got.labels), _np(ref.labels))
    ref_it = _np(ref.iterations).astype(np.int64)
    if algorithm == "kl":
        np.testing.assert_array_equal(_np(got.iterations), ref_it)
    else:
        drift = np.abs(_np(got.iterations).astype(np.int64) - ref_it)
        bound = np.maximum(25 * cfg.check_every, (ref_it * 0.5).astype(int))
        assert (drift <= bound).all(), (drift, bound)
    np.testing.assert_allclose(_np(got.consensus), _np(ref.consensus),
                               atol=1e-6)
    np.testing.assert_allclose(_np(got.dnorms), _np(ref.dnorms), rtol=1e-3,
                               atol=1e-4)
    assert tuple(got.best_w.shape) == (53, 3)
    assert tuple(got.best_h.shape) == (3, 21)
    ref_best = int(np.argmin(_np(ref.dnorms)))
    got_best = int(np.argmin(_np(got.dnorms)))
    if algorithm == "kl":
        assert ref_best == got_best
    if ref_best == got_best:
        tol = ((5e-3, 5e-4) if algorithm == "kl" else (3e-2, 3e-3))
        np.testing.assert_allclose(_np(got.best_w), _np(ref.best_w),
                                   rtol=tol[0], atol=tol[1])
        np.testing.assert_allclose(_np(got.best_h), _np(ref.best_h),
                                   rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("algorithm", ["neals", "snmf", "hals"])
def test_gram_family_grid_exact_in_float64(low_rank_data, algorithm):
    """In float64 the sums' order leaves no mark: on (2, 1, 4) the Gram
    family's grid run equals the unmeshed run's labels, iterations and
    stops, its factors to 1e-9."""
    a, _ = low_rank_data
    at = torch.as_tensor(np.asarray(a[:53, :21]), dtype=torch.float64)
    cfg = SolverConfig(algorithm=algorithm, max_iter=120, dtype="float64")
    ref = psweep.sweep_one_k(at, _random.key(5), 3, 8, cfg)
    for shape in ((2, 1, 4),):
        got = psweep.sweep_one_k(at, _random.key(5), 3, 8, cfg,
                                 mesh=_gmesh(*shape))
        for f in ("labels", "iterations", "stop_reasons"):
            np.testing.assert_array_equal(_np(getattr(got, f)),
                                          _np(getattr(ref, f)))
        np.testing.assert_allclose(_np(got.best_w), _np(ref.best_w),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(_np(got.best_h), _np(ref.best_h),
                                   rtol=1e-9, atol=1e-9)


def test_kl_restart_chunk_composes_with_grid_mesh(low_rank_data):
    a, _ = low_rank_data
    mesh = _gmesh(2, 2, 2)
    ref = _one_k(a, 4, 3, 12, SolverConfig(algorithm="kl", max_iter=100),
                 mesh)
    got = _one_k(a, 4, 3, 12, SolverConfig(algorithm="kl", max_iter=100,
                                           restart_chunk=4), mesh)
    np.testing.assert_array_equal(_np(got.labels), _np(ref.labels))
    np.testing.assert_array_equal(_np(got.iterations), _np(ref.iterations))
    np.testing.assert_allclose(_np(got.consensus), _np(ref.consensus),
                               atol=1e-6)
    np.testing.assert_allclose(_np(got.dnorms), _np(ref.dnorms), rtol=1e-4)


@pytest.mark.parametrize("algorithm", ["mu", "kl"])
def test_nndsvd_on_grid_mesh(low_rank_data, algorithm):
    a, _ = low_rank_data
    a = a[:53, :21]
    cfg = SolverConfig(algorithm=algorithm, max_iter=120)
    icfg = InitConfig(method="nndsvd")
    ref = _one_k(a, 5, 3, 4, cfg, None, icfg)
    got = _one_k(a, 5, 3, 4, cfg, _gmesh(2, 2, 2), icfg)
    np.testing.assert_array_equal(_np(got.labels), _np(ref.labels))
    np.testing.assert_array_equal(_np(got.iterations), _np(ref.iterations))
    np.testing.assert_allclose(_np(got.best_w), _np(ref.best_w), rtol=5e-3,
                               atol=5e-4)
    labels = _np(got.labels)
    assert (labels == labels[0]).all()


@pytest.mark.parametrize("alg", ["hals", "kl", "mu", "neals", "snmf"])
def test_grid_mesh_agreement(two_group_data, alg):
    """``tests/test_mesh_parity.py:52-60``: the grid mesh's consensus
    within clustering tolerance of the unmeshed sweep's."""

    def run(mesh):
        return psweep.sweep(two_group_data,
                            ConsensusConfig(ks=(3,), restarts=6, seed=123),
                            SolverConfig(algorithm=alg, max_iter=60),
                            device="cpu", mesh=mesh)[3]

    ref, got = run(None), run(_gmesh(1, 2, 2))
    assert np.allclose(_np(ref.consensus), _np(got.consensus), atol=0.35)


# -- against nmfx's grid run on the same mesh shape ------------------------
@pytest.fixture(scope="module")
def grouped():
    """``test_torch_vmap_sweep.py``'s data, where the port's unmeshed
    batched route is held to nmfx at the equal-iteration tier."""
    from nmfx.datasets import grouped_matrix

    return np.asarray(grouped_matrix(200, (10, 10, 10), effect=2.0, seed=0),
                      np.float32)


@pytest.mark.parametrize("algorithm", ["mu", "kl", "neals", "snmf", "hals"])
def test_grid_mesh_agrees_with_reference_grid_mesh(grouped, algorithm):
    a = grouped
    got = _one_k(a, 5, 3, 4, SolverConfig(algorithm=algorithm,
                                          max_iter=400), _gmesh(2, 2, 2))
    want = nsweep.sweep_one_k(a, jax.random.key(5), k=3, restarts=4,
                              solver_cfg=nmfx.SolverConfig(
                                  algorithm=algorithm, max_iter=400),
                              mesh=nsweep.grid_mesh(2, 2, 2))
    np.testing.assert_array_equal(_np(got.iterations),
                                  np.asarray(want.iterations))
    np.testing.assert_array_equal(_np(got.stop_reasons),
                                  np.asarray(want.stop_reasons))
    np.testing.assert_array_equal(_np(got.labels), np.asarray(want.labels))
    np.testing.assert_allclose(_np(got.consensus),
                               np.asarray(want.consensus), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(_np(got.dnorms), np.asarray(want.dnorms),
                               rtol=1e-4, atol=1e-6)
    tol = (dict(rtol=5e-3, atol=1e-3) if algorithm == "snmf"
           else dict(rtol=2e-4, atol=1e-4))
    np.testing.assert_allclose(_np(got.best_w), np.asarray(want.best_w),
                               **tol)
    np.testing.assert_allclose(_np(got.best_h), np.asarray(want.best_h),
                               **tol)


# -- refusals, routing, placement ------------------------------------------
def _err(fn):
    try:
        fn()
    except Exception as e:  # the comparison is the point
        return type(e), str(e)
    return None


@pytest.mark.parametrize("case", ["als", "pallas", "keep_factors",
                                  "sketched", "screen", "pg", "alspg"])
def test_grid_refusals_match_reference(low_rank_data, case):
    a, _ = low_rank_data
    a = np.asarray(a, np.float32)
    kw = {"als": dict(algorithm="als"), "pallas": dict(backend="pallas"),
          "keep_factors": {}, "sketched": dict(backend="sketched"),
          "screen": dict(screen=True, screen_keep=2),
          "pg": dict(algorithm="pg"), "alspg": dict(algorithm="alspg")}[case]
    keep = case == "keep_factors"
    got = _err(lambda: psweep.sweep_one_k(
        torch.as_tensor(a), _random.key(0), 2, 4, SolverConfig(**kw),
        mesh=_fmesh(2, 4), keep_factors=keep))
    want = _err(lambda: nsweep.sweep_one_k(
        a, jax.random.key(0), k=2, restarts=4,
        solver_cfg=nmfx.SolverConfig(**kw), mesh=nsweep.feature_mesh(2, 4),
        keep_factors=keep))
    assert got is not None and got[0] is ValueError
    assert got[1].replace("nmfx_torch", "nmfx") == want[1]


@pytest.mark.parametrize("alg,backend", [("mu", "auto"), ("mu", "pallas"),
                                         ("hals", "auto"),
                                         ("hals", "packed"),
                                         ("neals", "packed"),
                                         ("kl", "auto"), ("mu", "packed")])
def test_engine_family_and_grid_exec_on_grid_axes(alg, backend):
    cfg = SolverConfig(algorithm=alg, backend=backend)
    ncfg = nmfx.SolverConfig(algorithm=alg, backend=backend)
    assert (psweep.resolve_engine_family(cfg, _gmesh(1, 2, 2))
            == nsweep.resolve_engine_family(ncfg, nsweep.grid_mesh(1, 2, 2)))
    assert not psweep.grid_exec_ok(cfg, _gmesh(1, 2, 2))


def test_place_input_tiles_grid_axes():
    """No device block is A whole: each block is A's (padded) tile, and a
    block never answers for the whole matrix in the input cache."""
    from nmfx_torch import data_cache

    a = np.arange(15 * 11, dtype=np.float32).reshape(15, 11)
    cfg = SolverConfig()
    gm = _gmesh(2, 2, 2)
    placed = psweep.place_input(a, cfg, gm)
    assert isinstance(placed, psweep.GridInput)
    assert placed.shape == (15, 11) and placed.block_shape == (8, 6)
    assert set(placed.blocks) == {(torch.device("cpu"), f, s)
                                  for f in (0, 1) for s in (0, 1)}
    pad = np.zeros((16, 12), np.float32)
    pad[:15, :11] = a
    for (_, f, s), blk in placed.blocks.items():
        np.testing.assert_array_equal(
            blk.numpy(), pad[f * 8:(f + 1) * 8, s * 6:(s + 1) * 6])
    before = data_cache.transfer_count()
    again = psweep.place_input(a, cfg, gm)
    assert data_cache.transfer_count() == before
    assert all(again.blocks[key] is placed.blocks[key] for key in
               placed.blocks)
    whole = psweep.place_input(a, cfg, None, device="cpu")
    assert tuple(whole.shape) == (15, 11)
    assert all(tuple(b.shape) != (15, 11) for b in placed.blocks.values())
    rm = psweep.grid_mesh(2, devices=["cpu"] * 2)
    rep = psweep.place_input(a, cfg, rm)
    np.testing.assert_array_equal(rep[torch.device("cpu")].numpy(), a)


def test_full_sweep_and_nmfconsensus_on_grid_mesh(two_group_data):
    import nmfx_torch

    mesh = _gmesh(2, 2, 1)
    kw = dict(ks=(2, 3), restarts=4, seed=3, max_iter=200, device="cpu")
    got = nmfx_torch.nmfconsensus(two_group_data, mesh=mesh, **kw)
    ref = nmfx_torch.nmfconsensus(two_group_data, use_mesh=False, **kw)
    assert got.best_k == ref.best_k == 2
    for k in (2, 3):
        np.testing.assert_allclose(got.per_k[k].consensus,
                                   ref.per_k[k].consensus, atol=1e-6)
        np.testing.assert_allclose(np.diag(got.per_k[k].consensus), 1.0,
                                   atol=1e-6)


def test_shard_info_errors_match_reference():
    """The residuals and the class check raise nmfx's ValueErrors when a
    grid axis comes without its true dim."""
    from nmfx_torch.ops import packed_mu

    comm = None
    a = torch.ones(4, 3)
    w = torch.ones(2, 4, 2)
    h = torch.ones(2, 2, 3)
    with pytest.raises(ValueError, match="needs m_total"):
        pbase.residual_norms(a, w, h, shard=pbase.ShardInfo(
            "features", None, None, None, comm))
    with pytest.raises(ValueError, match="needs n_total"):
        pbase.residual_norms(a, w, h, shard=pbase.ShardInfo(
            None, "samples", None, None, comm))
    wp, hp = packed_mu.pack(w, h)
    with pytest.raises(ValueError, match="needs m_total"):
        packed_mu.residual_norms_gram(a, wp, hp, 2, pbase.ShardInfo(
            "features", None, None, None, comm))
    # unsharded, the Gram identity equals the direct residual
    np.testing.assert_allclose(
        packed_mu.residual_norms_gram(a, wp, hp, 2).numpy(),
        pbase.residual_norms(a, w, h).numpy(), rtol=1e-5)


# -- the collectives of one iteration against the cost model ---------------
def _one_iteration_calls(algorithm, f, s):
    """The collectives shard (0, 0) runs in one non-check iteration of
    ``algorithm`` on an F×S grid group (both shards' threads running)."""
    rng = np.random.default_rng(0)
    m, n, k, r = 12, 10, 3, 4
    a = torch.as_tensor(rng.uniform(0.1, 1, (m, n)), dtype=torch.float32)
    w0 = torch.as_tensor(rng.uniform(0.1, 1, (r, m, k)), dtype=torch.float32)
    h0 = torch.as_tensor(rng.uniform(0.1, 1, (r, k, n)), dtype=torch.float32)
    ml, nl = m // f, n // s
    cfg = SolverConfig(algorithm=algorithm, max_iter=1)
    group = coll.GridGroup(f, s)

    def work(_, comm):
        fi, si = comm.fidx, comm.sidx
        al = a[fi * ml:(fi + 1) * ml, si * nl:(si + 1) * nl]
        wl = w0[:, fi * ml:(fi + 1) * ml]
        hl = h0[:, :, si * nl:(si + 1) * nl]
        info = pbase.ShardInfo("features" if f > 1 else None,
                               "samples" if s > 1 else None, m, n, comm)
        if algorithm == "mu":
            from nmfx_torch.ops import packed_mu

            wp, hp = packed_mu.pack(wl, hl)
            state = packed_mu.PackedState(
                wp=wp, hp=hp, wp_prev=wp, hp_prev=hp, iteration=0,
                classes=torch.full((r, nl), -1, dtype=torch.int32),
                stable=torch.zeros(r, dtype=torch.int32),
                done=torch.zeros(r, dtype=torch.bool),
                done_iter=torch.zeros(r, dtype=torch.int32),
                stop_reason=torch.zeros(r, dtype=torch.int32),
                nonfinite=torch.zeros(r, dtype=torch.bool))
            packed_mu._step(al, packed_mu.block_diag_mask(r, k, "cpu"),
                            state, cfg, r, check=False, use_kernels=False,
                            shard=info)
        else:
            mod = SOLVERS[algorithm]
            state = pbase.init_state(al, wl, hl, ())
            state = dataclasses.replace(state, iteration=1)
            mod.step(al, state, cfg, False, shard=info)

    coll.reset_calls()
    coll.run_groups([group], work)
    return dict(coll.CALLS)


@pytest.mark.parametrize("algorithm", ["mu", "kl"])
@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)],
                         ids=["features", "samples", "grid"])
def test_collectives_per_iteration_match_comm_model(algorithm, shape):
    f, s = shape
    counted = _one_iteration_calls(algorithm, f, s)
    model = costmodel.comm_model(algorithm, 12, 10, 3, feature_shards=f,
                                 sample_shards=s, restarts=4)
    assert sum(counted.values()) == model["collectives_per_iter"]
    for axis, ent in model["per_axis"].items():
        assert sum(v for (op, ax), v in counted.items()
                   if ax == axis) == ent["collectives"], (axis, counted)
