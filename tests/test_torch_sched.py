"""The port's whole-grid slot scheduler and its block kernel against the
reference's, on the CPU.

The reference runs its Pallas kernels in interpret mode (what its
scheduler selects off the TPU); the port runs the plain versions of its
kernels. Both start from the same numpy factors (drawn through the
reference's own initializer), so per-job iterations and stop reasons
must be EQUAL; factors agree within rtol=2e-4, atol=2e-5 and final
residuals within rtol=1e-5 — the tolerances the reference's own
scheduler tests use between its engines. The block kernel's plain
version is held to the Pallas kernel within rtol=2e-5, atol=1e-6 (a
few iterations of float32 products summed in other orders), frozen
lanes bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmfx
import nmfx_torch
from nmfx.config import ExperimentalConfig, InitConfig, SolverConfig
from nmfx.datasets import grouped_matrix, two_group_matrix
from nmfx.init import initialize
from nmfx.ops.pallas_mu import fused_block_iterations as j_block
from nmfx.ops.sched_mu import mu_sched as j_sched
from nmfx_torch.convert import solver_config_from_dict
from nmfx_torch.ops import fused_mu
from nmfx_torch.ops.sched_mu import _pallas_block_geometry, mu_sched
from nmfx_torch.solvers.base import StopReason, solve
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)

KS = (4, 3, 2)  # rank-descending, as the sweep dispatches
R = 5
JOB_KS = tuple(k for k in KS for _ in range(R))


@pytest.fixture(scope="module")
def jobs():
    a = jnp.asarray(grouped_matrix(200, (10, 10, 10), effect=2.0, seed=0),
                    jnp.float32)
    k_max = max(KS)
    root = jax.random.key(123)
    w0l, h0l = [], []
    for k in KS:
        keys = jax.random.split(jax.random.fold_in(root, k), R)
        w0s, h0s = jax.vmap(
            lambda kk, k=k: initialize(kk, a, k, InitConfig(),
                                       jnp.float32))(keys)
        w0l.append(jnp.pad(w0s, ((0, 0), (0, 0), (0, k_max - k))))
        h0l.append(jnp.pad(h0s, ((0, 0), (0, k_max - k), (0, 0))))
    return (np.asarray(a), np.asarray(jnp.concatenate(w0l)),
            np.asarray(jnp.concatenate(h0l)))


def _port(cfg):
    return solver_config_from_dict(dataclasses.asdict(cfg))


def _assert_same_jobs(got, want, exact_factors=False):
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_array_equal(got.stop_reason.numpy(),
                                  np.asarray(want.stop_reason))
    for name in ("w", "h"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if exact_factors:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5,
                                       err_msg=name)


# --- the block kernel's plain version against the Pallas kernel --------

@pytest.mark.parametrize("check_block", [1, 4])
def test_block_plain_version_matches_pallas_kernel(check_block):
    rng = np.random.default_rng(0)
    m, n, k, slots = 192, 32, 3, 2
    rk = k * slots
    a, wp, hp = (rng.uniform(0.0, 1.0, s).astype(np.float32)
                 for s in ((m, n), (m, rk), (rk, n)))
    wp[:, k - 1] = 0.0  # a zero-padded column, as a k < k_max job has
    hp[k - 1] = 0.0
    frozen = np.zeros((1, rk), np.float32)
    frozen[0, k:] = 1.0  # slot 1 frozen
    # slot 0's budget runs out mid-launch (after 5 of its 8 iterations)
    budget = np.full((1, rk), 5.0 if check_block > 1 else 100.0, np.float32)
    kw = dict(k=k, iters=2, check_block=check_block)
    want = j_block(*(jnp.asarray(x) for x in (a, wp, hp, frozen)),
                   block_m=64, interpret=True,
                   budget_cols=jnp.asarray(budget) if check_block > 1
                   else None, **kw)
    got = fused_mu.fused_block_iterations(
        *(torch.as_tensor(x) for x in (a, wp, hp, frozen)),
        budget_cols=torch.as_tensor(budget) if check_block > 1 else None,
        **kw)
    assert len(got) == (7 if check_block > 1 else 6)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=1e-6)
    assert torch.equal(got[0][:, k:], torch.as_tensor(wp[:, k:]))
    assert torch.equal(got[1][k:], torch.as_tensor(hp[k:]))
    assert (got[0][:, k - 1] == 0).all() and (got[1][k - 1] == 0).all()


def test_block_budget_fence_stops_at_the_boundary():
    """A budget of 2 iterations inside a 4-block launch: the lane's
    factors after the launch are its factors after exactly 2
    iterations."""
    rng = np.random.default_rng(1)
    a, wp, hp = (torch.as_tensor(rng.uniform(0.1, 1.0, s).astype(np.float32))
                 for s in ((50, 12), (50, 4), (4, 12)))
    frozen = torch.zeros((1, 4))
    budget = torch.tensor([[2.0, 2.0, 100.0, 100.0]])
    fenced = fused_mu.fused_block_iterations(
        a, wp, hp, frozen, k=2, iters=2, check_block=4, budget_cols=budget)
    short = fused_mu.fused_block_iterations(a, wp, hp, frozen, k=2, iters=2)
    assert torch.equal(fenced[0][:, :2], short[0][:, :2])
    assert torch.equal(fenced[1][:2], short[1][:2])
    assert torch.equal(fenced[4][:2], short[4][:2])  # boundary 0's stats
    assert not torch.equal(fenced[0][:, 2:], short[0][:, 2:])


# --- the scheduler against the reference's ------------------------------

# (backend, check_block, slots, max_iter, tail_slots, evict_batch)
CASES = {
    "auto-s3": ("auto", "auto", 3, 600, "auto", 1),
    "auto-tail-evict": ("auto", "auto", 15, 600, (4, 2), 3),
    "auto-cb1-601": ("auto", 1, 3, 601, None, 1),
    "pallas-s3": ("pallas", "auto", 3, 600, "auto", 1),
    "pallas-s15-cb1": ("pallas", 1, 15, 600, "auto", 1),
    "pallas-tail-evict": ("pallas", "auto", 6, 600, (4, 2), 3),
    "pallas-fallback-601": ("pallas", "auto", 5, 601, None, 1),
    "pallas-cb1-notail": ("pallas", 1, 15, 600, None, 3),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sched_matches_reference(jobs, name):
    backend, cb, slots, max_iter, tail, evict = CASES[name]
    a, w0, h0 = jobs
    cfg = SolverConfig(max_iter=max_iter, backend=backend, check_block=cb,
                       experimental=ExperimentalConfig(evict_batch=evict))
    want = j_sched(jnp.asarray(a), jnp.asarray(w0), jnp.asarray(h0), cfg,
                   slots=slots, tail_slots=tail, job_ks=JOB_KS)
    got = mu_sched(a, w0, h0, _port(cfg), slots=slots, tail_slots=tail,
                   job_ks=JOB_KS, device="cpu")
    _assert_same_jobs(got, want)
    np.testing.assert_allclose(got.dnorm.numpy(), np.asarray(want.dnorm),
                               rtol=1e-5)
    assert got.pool_widths == tuple(np.asarray(want.pool_widths).tolist())
    assert got.pool_trips == tuple(np.asarray(want.pool_trips).tolist())
    assert got.pool_lanes == tuple(np.asarray(want.pool_lanes).tolist())
    assert got.host_syncs == sum(got.pool_trips)


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_sched_quarantines_a_nonfinite_job(jobs, backend):
    """A NaN in one job's W0 stops that job with NUMERIC_FAULT at its
    first check, as in the reference, and leaves the other lanes alone."""
    a, w0, h0 = jobs
    w0 = w0.copy()
    w0[6, 0, 0] = np.nan
    cfg = SolverConfig(max_iter=100, backend=backend)
    want = j_sched(jnp.asarray(a), jnp.asarray(w0), jnp.asarray(h0), cfg,
                   slots=4, job_ks=JOB_KS)
    got = mu_sched(a, w0, h0, _port(cfg), slots=4, job_ks=JOB_KS,
                   device="cpu")
    assert int(got.stop_reason[6]) == int(StopReason.NUMERIC_FAULT)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_array_equal(got.stop_reason.numpy(),
                                  np.asarray(want.stop_reason))
    keep = np.arange(len(JOB_KS)) != 6
    np.testing.assert_allclose(got.h.numpy()[keep],
                               np.asarray(want.h)[keep], rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_flip_floor_overrides_the_flip_budget(jobs, backend):
    """A flip budget of n columns makes every check stable: each job
    stops class-stable after stable_checks checks, as in the reference."""
    a, w0, h0 = jobs
    n = a.shape[1]
    cfg = SolverConfig(max_iter=300, backend=backend, stable_checks=5,
                       use_tol_checks=False)
    want = j_sched(jnp.asarray(a), jnp.asarray(w0), jnp.asarray(h0), cfg,
                   slots=4, flip_floor=jnp.int32(n))
    got = mu_sched(a, w0, h0, _port(cfg), slots=4, flip_floor=n,
                   device="cpu")
    assert (got.stop_reason == int(StopReason.CLASS_STABLE)).all()
    _assert_same_jobs(got, want)


def test_sched_reaches_every_stop(jobs):
    a, w0, h0 = jobs
    got = mu_sched(a, w0, h0, nmfx_torch.SolverConfig(max_iter=600),
                   slots=6, device="cpu")
    assert {int(StopReason.MAX_ITER), int(StopReason.CLASS_STABLE),
            int(StopReason.TOL_X)} <= set(got.stop_reason.tolist())


@pytest.mark.parametrize("backend", ["auto", "pallas"])
@pytest.mark.parametrize("slots,tail", [(1, None), (3, "auto"), (7, None),
                                        (7, (4, 2))])
def test_schedule_free_results(jobs, backend, slots, tail):
    """The same decisions at any slot count, with the tail on or off;
    only the schedule changes."""
    a, w0, h0 = jobs
    cfg = nmfx_torch.SolverConfig(max_iter=600, backend=backend)
    ref = mu_sched(a, w0, h0, cfg, slots=15, tail_slots=None, device="cpu")
    got = mu_sched(a, w0, h0, cfg, slots=slots, tail_slots=tail,
                   device="cpu")
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  ref.iterations.numpy())
    np.testing.assert_array_equal(got.stop_reason.numpy(),
                                  ref.stop_reason.numpy())
    np.testing.assert_allclose(got.w.numpy(), ref.w.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_single_job_matches_solve(jobs):
    a, w0, h0 = jobs
    k = KS[0]
    cfg = nmfx_torch.SolverConfig(max_iter=300)
    ref = solve(a, w0[0, :, :k], h0[0, :k, :], cfg, device="cpu")
    got = mu_sched(a, w0[:1], h0[:1], cfg, slots=8, device="cpu")
    assert ref.iterations == int(got.iterations[0])
    assert ref.stop_reason == int(got.stop_reason[0])
    np.testing.assert_allclose(got.w[0, :, :k].numpy(), ref.w.numpy(),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got.h[0, :k].numpy(), ref.h.numpy(),
                               rtol=2e-4, atol=2e-5)


def test_pallas_multi_check_max_iter_fence(jobs):
    """A cap crossing mid-launch: the in-kernel budget fence freezes every
    job at exactly max_iter, with the factors of the check-per-trip
    schedule."""
    a, w0, h0 = jobs
    cfg1 = SolverConfig(max_iter=20, backend="pallas", check_block=1)
    cfg4 = SolverConfig(max_iter=20, backend="pallas", check_block=4)
    want = j_sched(jnp.asarray(a), jnp.asarray(w0), jnp.asarray(h0), cfg4,
                   slots=4)
    got = mu_sched(a, w0, h0, _port(cfg4), slots=4, device="cpu")
    one = mu_sched(a, w0, h0, _port(cfg1), slots=4, device="cpu")
    assert (got.iterations == 20).all()
    assert (got.stop_reason == int(StopReason.MAX_ITER)).all()
    _assert_same_jobs(got, want)
    _assert_same_jobs(got, one, exact_factors=True)


def test_sched_validates(jobs):
    a, w0, h0 = jobs
    with pytest.raises(ValueError, match="job_ks"):
        mu_sched(a, w0, h0, nmfx_torch.SolverConfig(max_iter=10), slots=4,
                 job_ks=JOB_KS[:-1], device="cpu")
    with pytest.raises(ValueError, match="slot scheduler implements"):
        mu_sched(a, w0, h0, nmfx_torch.SolverConfig(algorithm="pg"),
                 device="cpu")
    # the scheduler has no sketched form: as in the reference, a sketched
    # config runs its exact dense layout (the sweep never routes it here)
    got = mu_sched(a, w0, h0, nmfx_torch.SolverConfig(backend="sketched",
                                                      max_iter=6),
                   slots=4, job_ks=JOB_KS, device="cpu")
    want = mu_sched(a, w0, h0, nmfx_torch.SolverConfig(max_iter=6),
                    slots=4, job_ks=JOB_KS, device="cpu")
    assert torch.equal(got.w, want.w) and torch.equal(got.h, want.h)
    assert _pallas_block_geometry(5000) == (10, 512, 5120)
    assert _pallas_block_geometry(200) == (1, 208, 208)


# --- the whole sweep ------------------------------------------------------

@pytest.fixture(scope="module", params=["auto", "pallas"])
def sweeps(request):
    a = two_group_matrix(200, 12, seed=3)
    jcfg = nmfx.SolverConfig(backend=request.param, max_iter=200)
    kw = dict(ks=(2, 3), restarts=4, seed=11, keep_factors=True)
    want = nmfx.nmfconsensus(a, solver_cfg=jcfg, use_mesh=False, **kw)
    got = nmfx_torch.nmfconsensus(a, solver_cfg=_port(jcfg), device="cpu",
                                  **kw)
    return want, got


def test_whole_sweep_matches_reference(sweeps):
    want, got = sweeps
    assert got.best_k == want.best_k
    for k in (2, 3):
        w, g = want.per_k[k], got.per_k[k]
        np.testing.assert_array_equal(g.iterations, np.asarray(w.iterations))
        np.testing.assert_array_equal(g.stop_reasons,
                                      np.asarray(w.stop_reasons))
        np.testing.assert_array_equal(g.membership, w.membership)
        np.testing.assert_allclose(g.consensus, w.consensus, rtol=0,
                                   atol=1e-6)
        assert g.rho == w.rho
        np.testing.assert_allclose(g.all_h, np.asarray(w.all_h), rtol=2e-4,
                                   atol=2e-5)


def test_default_call_runs_the_dense_grid():
    """Every default: backend "auto", grid_exec "auto", several ranks —
    the dense scheduler, launching no kernel."""
    a = two_group_matrix(60, 6, seed=1)
    fused_mu.reset_launch_counts()
    res = nmfx_torch.nmfconsensus(a, ks=(2, 3), restarts=3, max_iter=60,
                                  device="cpu")
    assert res.ks == (2, 3) and res.per_k[2].consensus.shape == (12, 12)
    assert all(count == 0 for count in fused_mu.LAUNCHES.values())
    with pytest.raises(ValueError, match="grid_exec='grid'"):
        nmfx_torch.nmfconsensus(a, ks=(2,), restarts=2, grid_exec="grid",
                                solver_cfg=nmfx_torch.SolverConfig(
                                    backend="vmap"), device="cpu")
