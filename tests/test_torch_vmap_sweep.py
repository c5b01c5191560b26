"""The batched restart route (``nmfx_torch.sweep._build_vmap_sweep_fn``,
``solvers.base.run_loop_batched``) against nmfx's ``jax.vmap`` of its
generic ``solve``, float32, from the same key chain.

The route is what ``backend="auto"`` runs for als, neals, snmf, kl, pg
and alspg, and ``backend="vmap"`` for all eight. Bands, as nmfx holds its
own engines to each other (``tests/test_grid_exec.py``,
``tests/test_solvers.py``): equal iterations, stop reasons and labels,
consensus within 1e-6, dnorms to rtol 1e-4, the best restart's factors to
rtol 2e-4 / atol 1e-4. Two solvers get nmfx's wider factor band, 5e-3 /
1e-3: snmf, whose dying components' near-zero trajectories amplify
rounding (nmfx's own reason), and alspg, whose inner loops stop on an
absolute projected-gradient threshold, so a float32 rounding difference
moves an inner stop; on a lane that runs all 60 outer iterations the
drift reaches 1.3e-4 (at 20 iterations 1.7e-5). Its float64
single-restart gate (``test_torch_solvers.py``) holds it to rtol 1e-8.
Every case here holds equal iterations, stop reasons and labels across
the frameworks, so none falls back to the full-sweep tier.

Also: each lane equals a single-restart solve of that lane (float64),
``restart_chunk`` leaves the results as they are, a lane poisoned with
NaN stops with NUMERIC_FAULT and leaves the consensus without raising,
and als stays finite on a rank-deficient start.
"""

import numpy as np
import pytest
import torch

import nmfx
import nmfx_torch
from nmfx.datasets import grouped_matrix
from nmfx.sweep import sweep as jsweep
from nmfx_torch import random as _random
from nmfx_torch import sweep as tsweep
from nmfx_torch.init import restart_inits
from nmfx_torch.solvers import SOLVERS
from nmfx_torch.solvers.base import StopReason, run_loop_batched, solve
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)


KS = (2, 3, 4)
RESTARTS = 4
#: the route's configurations: the six under "auto", mu and hals under
#: "vmap" (at two ranks: their steps are the ones the other routes run)
CASES = {alg: ("auto", KS) for alg in ("als", "neals", "snmf", "kl", "pg",
                                       "alspg")}
CASES.update(mu=("vmap", (2, 3)), hals=("vmap", (2, 3)))


def _budget(algorithm):
    return 60 if algorithm in ("pg", "alspg") else 400


@pytest.fixture(scope="module")
def data():
    return grouped_matrix(200, (10, 10, 10), effect=2.0, seed=0)


def _sweeps(a, algorithm, backend, ks, **kw):
    jcfg = nmfx.SolverConfig(algorithm=algorithm, backend=backend,
                             max_iter=_budget(algorithm))
    tcfg = nmfx_torch.SolverConfig(algorithm=algorithm, backend=backend,
                                   max_iter=_budget(algorithm), **kw)
    want = jsweep(a, nmfx.ConsensusConfig(ks=ks, restarts=RESTARTS), jcfg,
                  nmfx.InitConfig())
    got = tsweep.sweep(a, nmfx_torch.ConsensusConfig(ks=ks,
                                                     restarts=RESTARTS),
                       tcfg, device="cpu")
    return want, got


def assert_same_rank(g, w, algorithm, k):
    np.testing.assert_array_equal(g.iterations.numpy(),
                                  np.asarray(w.iterations))
    np.testing.assert_array_equal(g.stop_reasons.numpy(),
                                  np.asarray(w.stop_reasons))
    np.testing.assert_array_equal(g.labels.numpy(), np.asarray(w.labels))
    np.testing.assert_allclose(g.consensus.numpy(), np.asarray(w.consensus),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(g.dnorms.numpy(), np.asarray(w.dnorms),
                               rtol=1e-4)
    tol = (dict(rtol=5e-3, atol=1e-3) if algorithm in ("snmf", "alspg")
           else dict(rtol=2e-4, atol=1e-4))
    np.testing.assert_allclose(g.best_w.numpy(), np.asarray(w.best_w), **tol)
    np.testing.assert_allclose(g.best_h.numpy(), np.asarray(w.best_h), **tol)
    assert g.best_w.shape == (g.best_w.shape[0], k)


@pytest.mark.parametrize("algorithm", sorted(CASES))
def test_batched_route_matches_reference(data, algorithm):
    backend, ks = CASES[algorithm]
    want, got = _sweeps(data, algorithm, backend, ks)
    for k in ks:
        assert_same_rank(got[k], want[k], algorithm, k)
        assert got[k].host_syncs > 0 and not got[k].pool_trips


@pytest.mark.parametrize("algorithm", ("als", "neals", "snmf", "kl", "pg",
                                       "alspg", "mu", "hals"))
def test_each_lane_equals_its_single_restart_solve(data, algorithm):
    """run_loop_batched over four lanes, float64: every lane's iterations,
    stop reason and factors are a single-restart solve's."""
    a = torch.as_tensor(data, dtype=torch.float64)
    keys = _random.split(_random.fold_in(_random.key(7), 3), RESTARTS)
    w0s, h0s = restart_inits(a, keys, 3, nmfx_torch.InitConfig())
    cfg = nmfx_torch.SolverConfig(algorithm=algorithm, dtype="float64",
                                  max_iter=_budget(algorithm))
    mod = SOLVERS[algorithm]
    res = run_loop_batched(a, w0s, h0s, cfg, mod.step,
                           mod.init_aux(a, w0s, h0s, cfg))
    assert res.host_syncs > 0
    for lane in range(RESTARTS):
        one = solve(a, w0s[lane], h0s[lane], cfg, device="cpu")
        assert int(res.iterations[lane]) == one.iterations
        assert int(res.stop_reason[lane]) == one.stop_reason
        np.testing.assert_allclose(res.w[lane].numpy(), one.w.numpy(),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(res.h[lane].numpy(), one.h.numpy(),
                                   rtol=1e-9, atol=1e-12)
    # the lanes stop apart, so frozen lanes were carried through blocks
    if algorithm not in ("pg", "mu"):
        assert len(set(res.iterations.tolist())) > 1


@pytest.mark.parametrize("algorithm", ("kl", "neals", "alspg"))
def test_restart_chunk_gives_the_same_results(data, algorithm):
    """restart_chunk=3 over 4 restarts (chunks of 3 and 1) against one
    batch: the same draws and the same per-lane solves."""
    key = _random.fold_in(_random.key(11), 3)
    a = torch.as_tensor(data, dtype=torch.float32)
    outs = [tsweep.sweep_one_k(a, key, 3, RESTARTS,
                               nmfx_torch.SolverConfig(
                                   algorithm=algorithm,
                                   max_iter=_budget(algorithm),
                                   restart_chunk=chunk))
            for chunk in (None, 3)]
    full, chunked = outs
    np.testing.assert_array_equal(chunked.labels.numpy(), full.labels.numpy())
    np.testing.assert_array_equal(chunked.iterations.numpy(),
                                  full.iterations.numpy())
    np.testing.assert_array_equal(chunked.stop_reasons.numpy(),
                                  full.stop_reasons.numpy())
    np.testing.assert_allclose(chunked.consensus.numpy(),
                               full.consensus.numpy(), atol=1e-6)
    np.testing.assert_allclose(chunked.dnorms.numpy(), full.dnorms.numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(chunked.best_w.numpy(), full.best_w.numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("algorithm", ("als", "neals", "snmf", "kl"))
def test_poisoned_lane_is_quarantined(data, algorithm, monkeypatch):
    """A lane whose initial W holds a NaN stops with NUMERIC_FAULT at the
    first check, its labels are -1 and the consensus is the survivors'
    mean; the sweep does not raise and the other lanes are unchanged."""
    cfg = nmfx_torch.SolverConfig(algorithm=algorithm, max_iter=200)
    ccfg = nmfx_torch.ConsensusConfig(ks=(3,), restarts=RESTARTS)
    clean = tsweep.sweep(data, ccfg, cfg, device="cpu")[3]

    def poisoned(a, keys, k, init_cfg):
        w0s, h0s = restart_inits(a, keys, k, init_cfg)
        w0s[1, 0, 0] = float("nan")
        return w0s, h0s

    monkeypatch.setattr(tsweep, "restart_inits", poisoned)
    out = tsweep.sweep(data, ccfg, cfg, device="cpu")[3]
    stops = out.stop_reasons.numpy()
    assert stops[1] == int(StopReason.NUMERIC_FAULT)
    assert int(out.iterations[1]) == cfg.check_every
    assert (out.labels[1] == -1).all()
    keep = [0, 2, 3]
    np.testing.assert_array_equal(stops[keep], clean.stop_reasons[keep])
    np.testing.assert_array_equal(out.labels[keep].numpy(),
                                  clean.labels[keep].numpy())
    e = np.eye(3)[out.labels[keep].numpy()]
    np.testing.assert_allclose(out.consensus.numpy(),
                               np.einsum("rik,rjk->ij", e, e) / 3,
                               atol=1e-6)
    assert np.isfinite(out.best_w.numpy()).all()


def test_als_rank_deficient_start_stays_finite():
    """Every lane starts from a W of identical columns (the min-norm
    solve's case): the batched route stays finite and lowers the residual
    (nmfx's test_als_rank_deficient_stays_finite, batched)."""
    rng = np.random.default_rng(2)
    m, n, k = 40, 15, 3
    a = torch.as_tensor(rng.uniform(0.5, 1.5, (m, k))
                        @ rng.uniform(0.5, 1.5, (k, n)), dtype=torch.float32)
    w0 = torch.as_tensor(np.stack([np.repeat(rng.uniform(0.1, 1, (m, 1)), k,
                                             axis=1) for _ in range(3)]),
                         dtype=torch.float32)
    h0 = torch.as_tensor(rng.uniform(0.1, 1.0, (3, k, n)),
                         dtype=torch.float32)
    cfg = nmfx_torch.SolverConfig(algorithm="als", max_iter=40)
    mod = SOLVERS["als"]
    res = run_loop_batched(a, w0, h0, cfg, mod.step, ())
    assert torch.isfinite(res.w).all() and torch.isfinite(res.h).all()
    start = torch.sqrt(((a - w0 @ h0) ** 2).mean(dim=(1, 2)))
    assert (res.dnorm < start).all()


def test_vmap_backend_routes_every_algorithm(data):
    """backend="vmap" takes the batched restart route for all eight
    algorithms, whatever grid_exec says; "grid" is refused for it."""
    for algorithm in CASES:
        cfg = nmfx_torch.SolverConfig(algorithm=algorithm, backend="vmap",
                                      max_iter=4)
        assert not tsweep.grid_exec_ok(cfg)
        out = tsweep.sweep(data, nmfx_torch.ConsensusConfig(
            ks=(2, 3), restarts=2), cfg, device="cpu")
        assert all(not o.pool_trips for o in out.values())
        with pytest.raises(ValueError, match="grid_exec='grid'"):
            tsweep.sweep(data, nmfx_torch.ConsensusConfig(
                ks=(2, 3), restarts=2, grid_exec="grid"), cfg, device="cpu")
