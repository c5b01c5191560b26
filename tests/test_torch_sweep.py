"""The port's consensus pipeline end to end against the reference's
per-rank Pallas route, from the same seed.

``nmfx`` runs ``backend="pallas"`` with ``grid_exec="per_k"`` (its
kernels in interpret mode off the TPU, unmeshed); ``nmfx_torch`` runs on
the CPU with its kernels' plain versions. Both draw the same initial
factors from the same key chain, so iterations, stop reasons, membership
and best k are equal, consensus agrees to atol=1e-6 and rho is equal
after the reference's signif-4 rounding.
"""

import dataclasses

import numpy as np
import pytest

import nmfx
import nmfx_torch
from nmfx.datasets import two_group_matrix
from nmfx_torch.convert import solver_config_from_dict
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)

KS = (2, 3)
RESTARTS = 4
SEED = 11


@pytest.fixture(scope="module")
def results():
    a = two_group_matrix(200, 12, seed=3)
    jcfg = nmfx.SolverConfig(backend="pallas", max_iter=300, stable_checks=30)
    want = nmfx.nmfconsensus(a, ks=KS, restarts=RESTARTS, seed=SEED,
                             solver_cfg=jcfg, grid_exec="per_k",
                             use_mesh=False, keep_factors=True)
    got = nmfx_torch.nmfconsensus(
        a, ks=KS, restarts=RESTARTS, seed=SEED,
        solver_cfg=solver_config_from_dict(dataclasses.asdict(jcfg)),
        grid_exec="per_k", keep_factors=True, device="cpu")
    return want, got


@pytest.mark.parametrize("k", KS)
def test_rank_matches_reference(results, k):
    want, got = results
    w, g = want.per_k[k], got.per_k[k]
    np.testing.assert_array_equal(g.iterations, np.asarray(w.iterations))
    np.testing.assert_array_equal(g.stop_reasons, np.asarray(w.stop_reasons))
    np.testing.assert_array_equal(g.membership, w.membership)
    np.testing.assert_array_equal(g.order, w.order)
    np.testing.assert_allclose(g.consensus, w.consensus, rtol=0, atol=1e-6)
    assert g.rho == w.rho
    np.testing.assert_allclose(g.dnorms, np.asarray(w.dnorms), rtol=1e-4)
    np.testing.assert_allclose(g.all_h, np.asarray(w.all_h), rtol=1e-4,
                               atol=1e-6)


def test_best_k_and_stops_match(results):
    want, got = results
    assert got.best_k == want.best_k
    stops = np.concatenate([got.per_k[k].stop_reasons for k in KS])
    assert (stops == int(nmfx_torch.StopReason.CLASS_STABLE)).any()


def test_each_package_loads_the_others_saved_result(results, tmp_path):
    want, got = results
    got.save(str(tmp_path / "torch.npz"))
    want.save(str(tmp_path / "jax.npz"))
    from_torch = nmfx.ConsensusResult.load(str(tmp_path / "torch.npz"))
    from_jax = nmfx_torch.ConsensusResult.load(str(tmp_path / "jax.npz"))
    assert from_torch.ks == got.ks and from_jax.ks == want.ks
    for k in KS:
        np.testing.assert_array_equal(from_torch.per_k[k].consensus,
                                      got.per_k[k].consensus)
        np.testing.assert_array_equal(from_jax.per_k[k].all_w,
                                      np.asarray(want.per_k[k].all_w))
        assert from_jax.per_k[k].rho == want.per_k[k].rho
    assert from_jax.best_k == want.best_k


@pytest.mark.parametrize("rule", ["argmax", "argmin"])
def test_labels_and_consensus_match_reference(rule):
    import jax.numpy as jnp
    import torch

    from nmfx import consensus as jcons
    from nmfx_torch import consensus as tcons

    rng = np.random.default_rng(4)
    h = rng.uniform(0.0, 1.0, (5, 3, 17)).astype(np.float32)
    # the reference labels one (k, n) H at a time
    want = np.stack([np.asarray(jcons.labels_from_h(jnp.asarray(x), rule))
                     for x in h])
    got = tcons.labels_from_h(torch.as_tensor(h), rule)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tcons.consensus_matrix(got, 3).numpy(),
        np.asarray(jcons.consensus_matrix(jnp.asarray(want), 3)))


def test_solver_config_round_trips_from_reference_dict():
    for jcfg in (nmfx.SolverConfig(),
                 nmfx.SolverConfig(backend="pallas", max_iter=77,
                                   class_flip_tol=0.1, check_block=3),
                 nmfx.SolverConfig(screen=True, screen_keep=2,
                                   sketch=nmfx.SketchConfig(dim=12)),
                 nmfx.SolverConfig(backend="sketched", algorithm="hals")):
        d = dataclasses.asdict(jcfg)
        cfg = solver_config_from_dict(d)
        got = dataclasses.asdict(cfg)
        for f in dataclasses.fields(cfg):
            assert got[f.name] == d[f.name], f.name
    # the autotuner's knob converts as it is since the autotuner was
    # ported, as the reference's config takes it
    d = dataclasses.asdict(nmfx.SolverConfig(
        experimental=nmfx.ExperimentalConfig(autotune="on")))
    assert dataclasses.asdict(
        solver_config_from_dict(d).experimental) == d["experimental"]
    with pytest.raises(ValueError):
        solver_config_from_dict({"no_such_field": 1})


@pytest.fixture
def _timing_table(monkeypatch):
    """Both packages' autotune searches under one timing table (seconds
    an iteration by candidate), so their picks are the same."""
    from nmfx import autotune as jtune
    from nmfx_torch import autotune as ptune

    def timed(mod):
        return lambda cfg, cand, *a, **k: (
            cand["block_m"] / 512 + 1 / cand["check_block"]
            + (cand["fused_updates"] == "fused"))

    monkeypatch.setattr(jtune, "_time_candidate", timed(jtune))
    monkeypatch.setattr(ptune, "_time_candidate", timed(ptune))


@pytest.mark.parametrize("kw,item", [
    # each a callable; the autotuner runs since it was ported (None), as
    # in the reference: the same best k and memberships as nmfx's
    # autotuned run
    (lambda: dict(solver_cfg=nmfx_torch.SolverConfig(
        backend="pallas",
        experimental=nmfx_torch.ExperimentalConfig(autotune="on"))),
     None),
    # float64 runs on the kernels since it was ported (None): the same
    # best k and memberships as nmfx's pallas run (float32 in a process
    # without jax_enable_x64; the float64 sweeps are held in
    # test_torch_float64.py)
    (lambda: dict(solver_cfg=nmfx_torch.SolverConfig(dtype="float64",
                                                     backend="pallas")),
     None),
    # a feature axis runs since it was ported (None), as in the
    # reference: the same best k and memberships as nmfx on it
    (lambda: dict(mesh=nmfx_torch.grid_mesh(1, 2, devices=["cpu"] * 2)),
     None),
])
def test_unported_routes_name_their_roadmap_item(kw, item, _timing_table):
    a = two_group_matrix(40, 6, seed=0)
    if item is None:
        kw = kw()
        got = nmfx_torch.nmfconsensus(a, ks=(2,), restarts=2, device="cpu",
                                      grid_exec="per_k", **kw)
        if "mesh" in kw:
            jkw = dict(mesh=nmfx.sweep.grid_mesh(1, 2))
        elif kw["solver_cfg"].dtype == "float64":
            assert np.asarray(got.per_k[2].best_w).dtype == np.float64
            jkw = dict(use_mesh=False,
                       solver_cfg=nmfx.SolverConfig(backend="pallas"))
        else:
            jkw = dict(use_mesh=False, solver_cfg=nmfx.SolverConfig(
                backend="pallas",
                experimental=nmfx.ExperimentalConfig(autotune="on")))
        want = nmfx.nmfconsensus(a, ks=(2,), restarts=2, grid_exec="per_k",
                                 **jkw)
        assert got.best_k == want.best_k
        np.testing.assert_array_equal(got.per_k[2].membership,
                                      np.asarray(want.per_k[2].membership))
        return
    with pytest.raises(NotImplementedError, match=item):
        nmfx_torch.nmfconsensus(a, ks=(2,), restarts=2, device="cpu",
                                **{"grid_exec": "per_k", **kw()})


def test_save_results_writes_reference_outputs(results, tmp_path):
    _, got = results
    written = nmfx_torch.save_results(
        got, nmfx_torch.OutputConfig(directory=str(tmp_path)))
    names = sorted(p.rsplit("/", 1)[1] for p in written)
    assert "cophenetic.txt" in names and "membership.gct" in names
    ds = nmfx.io.read_gct(str(tmp_path / "consensus.matrix.k.2.gct"))
    np.testing.assert_array_equal(ds.values, got.per_k[2].consensus)
