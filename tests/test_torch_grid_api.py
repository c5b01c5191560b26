"""The port's job-grid API against the reference's (``nmfx/sweep.py``
``RestartResult``/``grid_cells``/``reduce_grid``/``consensus_from_cells``,
``nmfx.consensus.connectivity``, ``nmfx.run_example``; the reference's
``reduceGridBy``/``runExample``, nmf.r:6-14, 72-98): one port sweep
reduced by both packages gives equal results, the port's sweep against
the reference's from the same seed agrees to the full-sweep tier
(iterations and stops equal, consensus within 1e-6, factors within
rtol 2e-4), and ``sweep_one_k`` takes the reference's keywords and
positions (ROADMAP §3 F1). On the CPU."""

import dataclasses
import inspect

import jax
import numpy as np
import pytest

import nmfx
import nmfx_torch
from nmfx import sweep as nsweep
from nmfx.consensus import connectivity as nconnectivity
from nmfx.datasets import two_group_matrix
from nmfx_torch import random as _random
from nmfx_torch import sweep as tsweep
from nmfx_torch.consensus import connectivity
from nmfx_torch.convert import solver_config_from_dict

KS = (2, 3)
RESTARTS = 4
SEED = 11


def _cfgs(**kw):
    ncfg = nmfx.SolverConfig(max_iter=200, **kw)
    return ncfg, solver_config_from_dict(dataclasses.asdict(ncfg))


@pytest.fixture(scope="module")
def sweeps():
    """The raw whole-grid sweep output of both packages (mu, backend
    "auto"), every restart's factors kept."""
    a = two_group_matrix(200, 12, seed=3)
    ncfg, tcfg = _cfgs()
    want = nsweep.sweep(a, nmfx.ConsensusConfig(
        ks=KS, restarts=RESTARTS, seed=SEED, keep_factors=True), ncfg,
        nmfx.InitConfig())
    got = tsweep.sweep(a, nmfx_torch.ConsensusConfig(
        ks=KS, restarts=RESTARTS, seed=SEED, keep_factors=True), tcfg,
        nmfx_torch.InitConfig(), device="cpu")
    return a, want, got


def _mean_w(cells):
    return np.mean([c.w for c in cells], axis=0)


def _ids(cells):
    return [(c.k, c.restart, c.iterations, c.stop_reason) for c in cells]


@pytest.mark.parametrize("by,fun", [("k", None), ("k", _mean_w),
                                    ("restart", _ids),
                                    ("restart", None)])
def test_port_sweep_reduced_by_both_packages_is_equal(sweeps, by, fun):
    _, _, got = sweeps
    mine = tsweep.reduce_grid(got, fun, by=by)
    ref = nmfx.reduce_grid(got, fun, by=by)
    assert list(mine) == list(ref)
    for g in mine:
        if isinstance(mine[g], list):
            assert mine[g] == ref[g]
        else:
            np.testing.assert_array_equal(mine[g], ref[g])


def test_grid_cells_equal_reference_cells(sweeps):
    _, _, got = sweeps
    mine, ref = tsweep.grid_cells(got), nmfx.grid_cells(got)
    assert len(mine) == len(ref) == len(KS) * RESTARTS
    for c, r in zip(mine, ref):
        assert isinstance(c, nmfx_torch.RestartResult)
        assert c._fields == r._fields
        assert (c.k, c.restart, c.iterations, c.dnorm, c.stop_reason) == (
            r.k, r.restart, r.iterations, r.dnorm, r.stop_reason)
        np.testing.assert_array_equal(c.w, r.w)
        np.testing.assert_array_equal(c.h, r.h)
    for rule in ("argmax", "argmin"):
        np.testing.assert_array_equal(
            tsweep.consensus_from_cells(mine[:RESTARTS], rule),
            nsweep.consensus_from_cells(ref[:RESTARTS], rule))


def test_reduce_grid_against_the_reference_sweep(sweeps):
    """The port's reduction of its sweep against the reference's
    reduction of its own sweep from the same seed: the full-sweep tier,
    and each rank's host consensus equal to the sweep's on-device one
    within 1e-6."""
    _, want, got = sweeps
    mine = tsweep.reduce_grid(got)
    ref = nmfx.reduce_grid(want)
    for k in KS:
        np.testing.assert_allclose(mine[k], ref[k], rtol=0, atol=1e-6)
        np.testing.assert_allclose(mine[k], got[k].consensus.numpy(),
                                   rtol=0, atol=1e-6)
    cells = tsweep.grid_cells(got)
    rcells = nmfx.grid_cells(want)
    assert [(c.k, c.restart, c.iterations, c.stop_reason)
            for c in cells] == [(c.k, c.restart, c.iterations,
                                 c.stop_reason) for c in rcells]
    for c, r in zip(cells, rcells):
        np.testing.assert_allclose(c.h, r.h, rtol=2e-4, atol=2e-5)
    # the reference's own reduction reads the port's raw output and the
    # port's reads the reference's: the same per-cell fields
    assert _ids(tsweep.grid_cells(want)) == _ids(rcells)


def test_reduce_grid_accepts_consensus_result_and_refuses_missing(sweeps):
    a, _, _ = sweeps
    _, tcfg = _cfgs()
    res = nmfx_torch.nmfconsensus(a, ks=KS, restarts=RESTARTS, seed=SEED,
                                  solver_cfg=tcfg, keep_factors=True,
                                  device="cpu")
    host = nmfx_torch.reduce_grid(res)
    for k in KS:
        np.testing.assert_allclose(host[k], res.per_k[k].consensus,
                                   atol=1e-6)
    bare = nmfx_torch.nmfconsensus(a, ks=(2,), restarts=2, solver_cfg=tcfg,
                                   device="cpu")
    with pytest.raises(ValueError, match="keep_factors=True"):
        nmfx_torch.reduce_grid(bare)
    with pytest.raises(ValueError, match="'k' or 'restart'"):
        nmfx_torch.reduce_grid(res, by="job")
    with pytest.raises(ValueError, match="label_rule"):
        nmfx_torch.consensus_from_cells(nmfx_torch.grid_cells(res), "mode")


def test_connectivity_matches_reference():
    labels = np.array([0, 1, 0, 2, 2, 1], np.int32)
    import torch

    got = connectivity(torch.as_tensor(labels))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(nconnectivity(labels)))
    np.testing.assert_array_equal(
        got.numpy(), np.equal.outer(labels, labels).astype(np.float32))


def test_run_example_gives_the_reference_best_k():
    got = nmfx_torch.run_example(outdir=None, device="cpu", ks=(2, 3),
                                 restarts=4)
    want = nmfx.run_example(outdir=None, ks=(2, 3), restarts=4)
    assert got.best_k == want.best_k == 2
    assert got.ks == want.ks == (2, 3)
    for k in (2, 3):
        np.testing.assert_array_equal(got.per_k[k].iterations,
                                      np.asarray(want.per_k[k].iterations))


def test_run_example_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nmfx_torch.run_example(outdir=None, ks=(2,), restarts=2)


# --- F1: sweep_one_k's signature is the reference's -----------------------

def test_sweep_one_k_parameters_are_the_references():
    mine = list(inspect.signature(tsweep.sweep_one_k).parameters)
    ref = list(inspect.signature(nsweep.sweep_one_k).parameters)
    assert mine == ref


@pytest.mark.parametrize("algorithm", ["mu", "hals"])
@pytest.mark.parametrize("form", ["keywords", "positions"])
def test_sweep_one_k_takes_the_references_call(algorithm, form):
    """The same keyword call and the same positional call run in both
    packages (hals at one rank consumes grid_slots and grid_tail_slots
    on the slot scheduler; mu keeps its factors)."""
    a = two_group_matrix(120, 10, seed=5)
    ncfg, tcfg = _cfgs(algorithm=algorithm)
    k = 3
    nkey = jax.random.fold_in(jax.random.key(SEED), k)
    tkey = _random.fold_in(_random.key(SEED), k)
    tail = 0

    def call(fn, key, scfg, icfg, arr):
        if form == "keywords":
            return fn(arr, key, k=k, restarts=RESTARTS, solver_cfg=scfg,
                      init_cfg=icfg, label_rule="argmax", mesh=None,
                      keep_factors=True, grid_slots=8,
                      grid_tail_slots=tail)
        return fn(arr, key, k, RESTARTS, scfg, icfg, "argmax", None, True,
                  8, tail)

    import torch

    want = call(nsweep.sweep_one_k, nkey, ncfg, nmfx.InitConfig(), a)
    got = call(tsweep.sweep_one_k, tkey, tcfg, nmfx_torch.InitConfig(),
               torch.as_tensor(a, dtype=torch.float32))
    assert got.all_w is not None and want.all_w is not None
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_array_equal(got.stop_reasons.numpy(),
                                  np.asarray(want.stop_reasons))
    np.testing.assert_allclose(got.consensus.numpy(),
                               np.asarray(want.consensus), rtol=0, atol=1e-6)


def test_sweep_one_k_refuses_a_mesh_naming_the_roadmap():
    import torch

    a = torch.as_tensor(two_group_matrix(40, 6, seed=1))
    key = _random.fold_in(_random.key(SEED), 2)
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 10"):
        tsweep.sweep_one_k(a, key, 2, 2, mesh="restarts")
    with pytest.raises(NotImplementedError, match="scale engines"):
        tsweep.sweep_one_k(a, key, 2, 2, nmfx_torch.SolverConfig(),
                           nmfx_torch.InitConfig(), "argmax", object())
