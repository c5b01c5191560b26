"""neals, als, snmf and kl on the packed whole grid (``backend="packed"``:
``nmfx_torch.ops.sched_mu`` on ``ops.grid_mu``'s dense blocks), against
nmfx's packed grid and against the port's own batched restart route,
float32, from the same key chain; and the routing table that sends each
algorithm/backend pair where nmfx sends it.

Bands as in ``test_torch_vmap_sweep.py``: equal iterations, stop reasons
and labels, consensus within 1e-6, dnorms to rtol 1e-4, best factors to
rtol 2e-4 / atol 1e-4 (snmf 5e-3 / 1e-3). Against the batched route the
grid's Gram solves put trace/k_max, not trace/k, in their jitter (as
nmfx's do), a 10·eps perturbation inside the same bands.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmfx
import nmfx_torch
from nmfx.datasets import grouped_matrix
from nmfx.ops.grid_mu import pad_live_mask as jpad_live_mask
from nmfx.sweep import grid_exec_ok as jgrid_exec_ok
from nmfx.sweep import resolve_engine_family
from nmfx.sweep import sweep as jsweep
from nmfx_torch import sweep as tsweep
from nmfx_torch.ops.grid_mu import pad_live_mask
from nmfx_torch.ops.sched_mu import _kl_slot_clamp, mu_sched
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)
from test_torch_vmap_sweep import assert_same_rank


KS = (2, 3, 4)
RESTARTS = 3
GRID = ("neals", "als", "snmf", "kl")


@pytest.fixture(scope="module")
def data():
    return grouped_matrix(200, (10, 10, 10), effect=2.0, seed=0)


def _port_sweep(a, cfg, ks, restarts, grid_exec="auto", keep_factors=False):
    return tsweep.sweep(a, nmfx_torch.ConsensusConfig(
        ks=ks, restarts=restarts, grid_exec=grid_exec,
        keep_factors=keep_factors), cfg, device="cpu")


@pytest.mark.parametrize("algorithm", GRID)
def test_packed_grid_matches_reference_and_batched_route(data, algorithm):
    jcfg = nmfx.SolverConfig(algorithm=algorithm, backend="packed",
                             max_iter=400)
    want = jsweep(data, nmfx.ConsensusConfig(ks=KS, restarts=RESTARTS),
                  jcfg, nmfx.InitConfig())
    cfg = nmfx_torch.SolverConfig(algorithm=algorithm, backend="packed",
                                  max_iter=400)
    got = _port_sweep(data, cfg, KS, RESTARTS)
    batched = _port_sweep(data, nmfx_torch.SolverConfig(
        algorithm=algorithm, max_iter=400), KS, RESTARTS)
    for k in KS:
        assert got[k].pool_trips and got[k].host_syncs == sum(
            got[k].pool_trips)
        assert_same_rank(got[k], want[k], algorithm, k)
        assert not batched[k].pool_trips
        assert_same_rank(got[k], batched[k], algorithm, k)
    # one rank, or grid_exec="per_k": the scheduler at that one rank
    solo = _port_sweep(data, cfg, (3,), RESTARTS, grid_exec="per_k")[3]
    assert solo.pool_trips
    assert_same_rank(solo, got[3], algorithm, 3)


@pytest.mark.parametrize("beta", [0.5, 8.0])
def test_snmf_dead_components_match_reference(beta):
    """snmf above the data's structure kills components; the grid masks
    the L1 coupling by padding (each job's true rank), never by a dead
    W column, and kills the same components as nmfx's grid and as the
    batched route (nmfx's test_snmf_dead_component_parity)."""
    a = grouped_matrix(120, (10, 10), effect=2.0, seed=0)
    ks = (4, 5)
    kw = dict(algorithm="snmf", max_iter=400, sparsity_beta=beta)
    want = jsweep(a, nmfx.ConsensusConfig(ks=ks, restarts=4,
                                          keep_factors=True),
                  nmfx.SolverConfig(backend="packed", **kw),
                  nmfx.InitConfig())
    got = _port_sweep(a, nmfx_torch.SolverConfig(backend="packed", **kw),
                      ks, 4, keep_factors=True)
    batched = _port_sweep(a, nmfx_torch.SolverConfig(**kw), ks, 4,
                          keep_factors=True)
    deaths = 0
    for k in ks:
        dead = [int((np.abs(np.asarray(x)).sum(axis=1) == 0).sum())
                for x in (want[k].all_w, got[k].all_w, batched[k].all_w)]
        assert dead[0] == dead[1] == dead[2], (k, dead)
        deaths += dead[0]
        np.testing.assert_allclose(got[k].consensus.numpy(),
                                   np.asarray(want[k].consensus), atol=1e-6)
        np.testing.assert_array_equal(got[k].labels.numpy(),
                                      np.asarray(want[k].labels))
        np.testing.assert_array_equal(got[k].iterations.numpy(),
                                      np.asarray(want[k].iterations))
        np.testing.assert_array_equal(got[k].labels.numpy(),
                                      batched[k].labels.numpy())
    assert deaths > 0, "no component died: the case is not exercised"


def test_als_zero_padded_lanes_stay_finite(data):
    """The grid at ks (2, 5): every k = 2 job rides a lane padded with
    three zero components, exactly rank-deficient, which the min-norm
    solve keeps at zero."""
    out = _port_sweep(data, nmfx_torch.SolverConfig(
        algorithm="als", backend="packed", max_iter=200), (2, 5), 3,
        keep_factors=True)
    for k in (2, 5):
        assert torch.isfinite(out[k].all_w).all()
        assert torch.isfinite(out[k].all_h).all()
        assert torch.isfinite(out[k].consensus).all()
        assert (out[k].stop_reasons
                != int(nmfx_torch.StopReason.NUMERIC_FAULT)).all()
    assert out[2].all_w.shape[2] == 2


@pytest.mark.parametrize("job_ks", [(3, 3, 2, 2, 1), None])
def test_pad_live_mask_matches_reference(job_ks):
    rng = np.random.default_rng(1)
    ks = (3, 3, 2, 2, 1)
    w0 = rng.uniform(0.1, 1, (5, 20, 3)) * (np.arange(3) < np.array(
        ks)[:, None])[:, None, :]
    h0 = rng.uniform(0.1, 1, (5, 3, 8)) * (np.arange(3) < np.array(
        ks)[:, None])[:, :, None]
    want = np.asarray(jpad_live_mask(jnp.asarray(w0), jnp.asarray(h0),
                                     job_ks))
    got = pad_live_mask(torch.as_tensor(w0), torch.as_tensor(h0), job_ks)
    np.testing.assert_array_equal(got.numpy(), want)
    if job_ks is not None:
        with pytest.raises(ValueError, match="job_ks"):
            pad_live_mask(torch.as_tensor(w0), torch.as_tensor(h0),
                          job_ks[:-1])


def test_kl_slot_clamp(caplog):
    """3·m·n·4 bytes a lane under a 4 GB cap: no clamp at the north star,
    16 slots at 20000×1000 with a warning."""
    assert _kl_slot_clamp(48, 5000, 500) == 48
    with caplog.at_level(logging.WARNING, logger="nmfx_torch"):
        assert _kl_slot_clamp(48, 20000, 1000) == 16
    assert "clamped 48 -> 16" in caplog.text
    assert _kl_slot_clamp(48, 10**6, 10**4) == 1


@pytest.mark.parametrize("algorithm", ["pg", "alspg"])
def test_packed_is_refused_where_the_reference_refuses_it(algorithm):
    with pytest.raises(ValueError, match="dense-batched block"):
        nmfx_torch.SolverConfig(algorithm=algorithm, backend="packed")
    a = np.ones((10, 4), np.float32)
    w0, h0 = np.ones((2, 10, 2), np.float32), np.ones((2, 2, 4), np.float32)
    with pytest.raises(ValueError, match="slot scheduler implements"):
        mu_sched(a, w0, h0, nmfx_torch.SolverConfig(algorithm=algorithm),
                 device="cpu")


@pytest.mark.parametrize("algorithm", nmfx_torch.config.ALGORITHMS)
@pytest.mark.parametrize("backend", ["auto", "vmap", "packed", "pallas"])
def test_routes_follow_the_reference_table(algorithm, backend):
    """The whole grid takes a pair exactly when nmfx's does, and a rank
    takes the packed family (the packed batch or the scheduler at one
    rank) exactly when nmfx's engine family for it is not "vmap"."""
    try:
        jcfg = nmfx.SolverConfig(algorithm=algorithm, backend=backend)
    except ValueError:
        with pytest.raises(ValueError):
            nmfx_torch.SolverConfig(algorithm=algorithm, backend=backend)
        return
    cfg = nmfx_torch.SolverConfig(algorithm=algorithm, backend=backend)
    assert tsweep.grid_exec_ok(cfg) == jgrid_exec_ok(jcfg, None)
    packed = (tsweep.grid_exec_ok(cfg) or (
        algorithm == "mu" and backend in ("auto", "packed", "pallas")))
    assert packed == (resolve_engine_family(jcfg) != "vmap")
