"""The port's hals against the reference's, on the CPU: the HALS block
kernel's plain version, the dense-batched block, the single-restart
solver, the slot scheduler on both layouts, its guards, and the sweep.

The reference runs its Pallas kernel in interpret mode; the port runs
the plain version of its kernel (what its wrapper runs on CPU tensors).
Both start from the same numpy factors. Tolerances:

* block kernel: rtol=1e-4, atol=1e-5 — two iterations of float32
  coordinate sweeps summed in other orders; each sweep step divides a
  difference of products by a Gram diagonal, which magnifies the
  rounding of small entries past the 2e-5 the mu block is held to;
* dense block: the same (one iteration of the same sweeps);
* solves and schedules: EQUAL iterations and stop reasons (TolFun
  included), factors within rtol=2e-4, atol=5e-5 in float32 and
  rtol=1e-9, atol=1e-11 in float64 (the reference run with
  ``jax_enable_x64`` in a subprocess, as its own float64 tests do);
* pallas against dense layout: the reference's band
  (``tests/test_fused_kernel.py::test_hals_pallas_agreement``),
  mean|ΔC|·R <= 0.6 and at most 10 % of a restart's labels flipped.
"""

import dataclasses
import json
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmfx
import nmfx_torch
from nmfx.config import (ConsensusConfig, ExperimentalConfig, InitConfig,
                         SolverConfig)
from nmfx.datasets import grouped_matrix, two_group_matrix
from nmfx.init import initialize
from nmfx.ops.grid_mu import hals_block as j_hals_block
from nmfx.ops.pallas_mu import hals_block_iterations as j_hals_kernel
from nmfx.ops.sched_mu import mu_sched as j_sched
from nmfx.solvers.base import solve as j_solve
from nmfx.sweep import sweep as j_sweep
from nmfx_torch.convert import solver_config_from_dict
from nmfx_torch.ops import fused_mu, grid_mu
from nmfx_torch.ops.packed_mu import mu_packed
from nmfx_torch.ops.sched_mu import mu_sched
from nmfx_torch.solvers.base import StopReason, solve

KS = (4, 3, 2)  # rank-descending, as the sweep dispatches
R = 5
JOB_KS = tuple(k for k in KS for _ in range(R))


def _port(cfg):
    return solver_config_from_dict(dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def jobs():
    """The reference's tests/test_fused_kernel.py fixture: 15 jobs of
    ranks 4, 3, 2 on a three-group 200 x 30 matrix, zero-padded to 4."""
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
    return (np.array(a), np.array(jnp.concatenate(w0l)),
            np.array(jnp.concatenate(h0l)))


def _assert_same_jobs(got, want, rtol=2e-4, atol=5e-5):
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_array_equal(got.stop_reason.numpy(),
                                  np.asarray(want.stop_reason))
    for name in ("w", "h"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


# --- the block kernel's plain version against the Pallas kernel --------

def _block_operands(seed=0, m=192, n=32, k=3, slots=2):
    rng = np.random.default_rng(seed)
    rk = k * slots
    a, wp, hp = (rng.uniform(0.0, 1.0, s).astype(np.float32)
                 for s in ((m, n), (m, rk), (rk, n)))
    wp[:, k - 1] = 0.0  # a zero-padded component, as a k < k_max job has
    hp[k - 1] = 0.0
    return a, wp, hp


@pytest.mark.parametrize("check_block", [1, 4])
@pytest.mark.parametrize("frozen_slot", [None, 1])
def test_hals_block_plain_version_matches_pallas_kernel(check_block,
                                                        frozen_slot):
    m, n, k, slots = 192, 32, 3, 2
    rk = k * slots
    a, wp, hp = _block_operands(m=m, n=n, k=k, slots=slots)
    frozen = np.zeros((1, rk), np.float32)
    if frozen_slot is not None:
        frozen[0, frozen_slot * k:(frozen_slot + 1) * k] = 1.0
    # slot 0's budget runs out mid-launch (after 5 of its 8 iterations)
    budget = np.full((1, rk), 5.0 if check_block > 1 else 100.0, np.float32)
    kw = dict(k=k, slots=slots, iters=2, check_block=check_block)
    want = j_hals_kernel(*(jnp.asarray(x) for x in (a, wp, hp, frozen)),
                         block_m=64, interpret=True,
                         budget_cols=jnp.asarray(budget) if check_block > 1
                         else None, **kw)
    got = fused_mu.hals_block_iterations(
        *(torch.as_tensor(x) for x in (a, wp, hp, frozen)),
        budget_cols=torch.as_tensor(budget) if check_block > 1 else None,
        **kw)
    assert len(got) == len(want) == (7 if check_block > 1 else 6)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
    # the padded component stays exactly zero
    assert (got[0][:, k - 1] == 0).all() and (got[1][k - 1] == 0).all()
    if frozen_slot is not None:
        cols = slice(frozen_slot * k, (frozen_slot + 1) * k)
        assert torch.equal(got[0][:, cols], torch.as_tensor(wp[:, cols]))
        assert torch.equal(got[1][cols], torch.as_tensor(hp[cols]))


def test_hals_block_budget_fence_stops_at_the_boundary():
    """A budget of 2 iterations inside a 4-block launch: the lane's
    factors after the launch are its factors after exactly 2
    iterations; the other lane runs on."""
    a, wp, hp = (torch.as_tensor(x) for x in _block_operands(seed=1))
    frozen = torch.zeros((1, 6))
    budget = torch.tensor([[2.0] * 3 + [100.0] * 3])
    fenced = fused_mu.hals_block_iterations(
        a, wp, hp, frozen, k=3, slots=2, iters=2, check_block=4,
        budget_cols=budget)
    short = fused_mu.hals_block_iterations(a, wp, hp, frozen, k=3, slots=2,
                                           iters=2)
    assert torch.equal(fenced[0][:, :3], short[0][:, :3])
    assert torch.equal(fenced[1][:3], short[1][:3])
    assert torch.equal(fenced[6][0], short[1])  # boundary 0's snapshot
    assert not torch.equal(fenced[0][:, 3:], short[0][:, 3:])


def test_hals_block_validates():
    a, wp, hp = (torch.as_tensor(x) for x in _block_operands())
    frozen = torch.zeros((1, 6))
    with pytest.raises(ValueError, match="k\\*slots"):
        fused_mu.hals_block_iterations(a, wp, hp, frozen, k=3, slots=3)
    with pytest.raises(ValueError, match="budget_cols"):
        fused_mu.hals_block_iterations(a, wp, hp, frozen, k=3, slots=2,
                                       check_block=2)


# --- the dense-batched block -------------------------------------------

def test_grid_hals_block_matches_reference(jobs):
    a, w0, h0 = jobs
    done = np.zeros(len(w0), bool)
    done[[2, 9]] = True
    cfg = SolverConfig(algorithm="hals")
    want = j_hals_block(jnp.asarray(a), jnp.asarray(w0), jnp.asarray(h0),
                        jnp.asarray(done), cfg)
    got = grid_mu.BLOCKS["hals"](
        torch.as_tensor(a), torch.as_tensor(w0), torch.as_tensor(h0),
        torch.as_tensor(done), _port(cfg))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
    assert torch.equal(got[0][done], torch.as_tensor(w0[done]))
    # the rank-2 jobs' padded components stay exactly zero
    assert (got[0][10:, :, 2:] == 0).all() and (got[1][10:, 2:] == 0).all()
    assert grid_mu.USES_TOLFUN["hals"] and grid_mu.USES_CLASS["hals"]


# --- the single-restart solver -----------------------------------------

#: hals solves reaching every stop of the rule set
SOLVES = {
    "tol_fun": dict(max_iter=300),
    "class_stable": dict(max_iter=300, class_flip_tol=0.0, stable_checks=20),
    "tol_x": dict(max_iter=300, tol_fun=0.0, tol_x=1e-2, stable_checks=400),
    "max_iter": dict(max_iter=120, tol_fun=0.0, stable_checks=400),
    "odd_tail": dict(max_iter=101, tol_fun=0.0, stable_checks=400,
                     check_every=3),
}
SOLVE_STOPS = {"tol_fun": StopReason.TOL_FUN,
               "class_stable": StopReason.CLASS_STABLE,
               "tol_x": StopReason.TOL_X, "max_iter": StopReason.MAX_ITER,
               "odd_tail": StopReason.MAX_ITER}


def _problem(seed=0, m=120, n_per_group=8, k=3):
    rng = np.random.default_rng(seed)
    a = two_group_matrix(m, n_per_group, seed=seed).astype(np.float32)
    w0 = rng.uniform(0.0, 1.0, (m, k)).astype(np.float32)
    h0 = rng.uniform(0.0, 1.0, (k, a.shape[1])).astype(np.float32)
    return a, w0, h0


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_hals_solve_matches_reference(name):
    a, w0, h0 = _problem()
    jcfg = nmfx.SolverConfig(algorithm="hals", **SOLVES[name])
    want = j_solve(jnp.asarray(a), jnp.asarray(w0), jnp.asarray(h0), jcfg)
    got = solve(a, w0, h0, _port(jcfg), device="cpu")
    assert got.iterations == int(want.iterations)
    assert got.stop_reason == int(want.stop_reason) == SOLVE_STOPS[name]
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=2e-4,
                               atol=5e-5)
    np.testing.assert_allclose(got.h.numpy(), np.asarray(want.h), rtol=2e-4,
                               atol=5e-5)
    np.testing.assert_allclose(float(got.dnorm), float(want.dnorm),
                               rtol=1e-4)


@pytest.fixture(scope="module")
def reference_float64(tmp_path_factory):
    """The reference's float64 hals solves of SOLVES, run once in a
    subprocess with jax_enable_x64 (a process-wide switch)."""
    out = tmp_path_factory.mktemp("x64") / "ref.npz"
    a, w0, h0 = _problem()
    inputs = out.with_name("inputs.npz")
    np.savez(inputs, a=a.astype(np.float64), w0=w0.astype(np.float64),
             h0=h0.astype(np.float64))
    code = textwrap.dedent(f"""
        import json
        import jax
        jax.config.update("jax_enable_x64", True)
        jax.config.update("jax_platforms", "cpu")
        import numpy as np
        import jax.numpy as jnp
        from nmfx.config import SolverConfig
        from nmfx.solvers.base import solve
        x = np.load({str(inputs)!r})
        res = {{}}
        for name, kw in json.loads({json.dumps(json.dumps(SOLVES))}).items():
            r = solve(jnp.asarray(x["a"]), jnp.asarray(x["w0"]),
                      jnp.asarray(x["h0"]),
                      SolverConfig(algorithm="hals", dtype="float64", **kw))
            assert r.w.dtype == jnp.float64
            res[name + "/w"] = np.asarray(r.w)
            res[name + "/h"] = np.asarray(r.h)
            res[name + "/meta"] = np.array([int(r.iterations),
                                            int(r.stop_reason)])
        np.savez({str(out)!r}, **res)
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return np.load(out), (a.astype(np.float64), w0.astype(np.float64),
                          h0.astype(np.float64))


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_hals_solve_float64_matches_reference(reference_float64, name):
    ref, (a, w0, h0) = reference_float64
    cfg = nmfx_torch.SolverConfig(algorithm="hals", dtype="float64",
                                  **SOLVES[name])
    got = solve(a, w0, h0, cfg, device="cpu")
    assert got.w.dtype == torch.float64
    iters, reason = ref[name + "/meta"].tolist()
    assert (got.iterations, got.stop_reason) == (iters, reason)
    assert got.stop_reason == SOLVE_STOPS[name]
    np.testing.assert_allclose(got.w.numpy(), ref[name + "/w"], rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(got.h.numpy(), ref[name + "/h"], rtol=1e-9,
                               atol=1e-11)


@pytest.mark.parametrize("seed,init", [(0, "random"), (3, "nndsvd")])
def test_hals_nmf_matches_reference(seed, init):
    a = two_group_matrix(150, 10, seed=seed)
    want = nmfx.nmf(a, 3, seed=seed, init=init, algorithm="hals",
                    max_iter=400)
    got = nmfx_torch.nmf(a, 3, seed=seed, init=init, algorithm="hals",
                         max_iter=400, device="cpu")
    assert got.iterations == int(want.iterations)
    assert got.stop_reason == int(want.stop_reason)
    np.testing.assert_allclose(got.h.numpy(), np.asarray(want.h), rtol=2e-4,
                               atol=5e-5)


# --- the slot scheduler on both layouts ---------------------------------

# (backend, check_block, slots, max_iter, tail_slots, evict_batch, extra)
SCHED = {
    "auto-s6": ("auto", "auto", 6, 200, "auto", 1, {}),
    "auto-tail-evict": ("auto", "auto", 15, 200, (4, 2), 3, {}),
    "auto-odd-cap": ("auto", 1, 4, 41, None, 1, {}),
    "pallas-s6": ("pallas", "auto", 6, 200, "auto", 1, {}),
    "pallas-s4-tail": ("pallas", 1, 4, 200, (2,), 1, {}),
    "pallas-tail-evict": ("pallas", "auto", 15, 200, (4, 2), 3, {}),
    "pallas-class-tolx": ("pallas", "auto", 6, 400, "auto", 1,
                          dict(tol_fun=0.0, tol_x=1e-2)),
    "pallas-multi-no-tol": ("pallas", 4, 6, 200, "auto", 1,
                            dict(use_tol_checks=False, stable_checks=10)),
}


@pytest.mark.parametrize("name", sorted(SCHED))
def test_hals_sched_matches_reference(jobs, name):
    backend, cb, slots, max_iter, tail, evict, extra = SCHED[name]
    a, w0, h0 = jobs
    cfg = SolverConfig(algorithm="hals", max_iter=max_iter, backend=backend,
                       check_block=cb,
                       experimental=ExperimentalConfig(evict_batch=evict),
                       **extra)
    want = j_sched(jnp.asarray(a), jnp.asarray(w0), jnp.asarray(h0), cfg,
                   slots=slots, tail_slots=tail, job_ks=JOB_KS)
    got = mu_sched(a, w0, h0, _port(cfg), slots=slots, tail_slots=tail,
                   job_ks=JOB_KS, device="cpu")
    _assert_same_jobs(got, want)
    np.testing.assert_allclose(got.dnorm.numpy(), np.asarray(want.dnorm),
                               rtol=1e-5)
    assert got.pool_trips == tuple(np.asarray(want.pool_trips).tolist())
    assert got.pool_lanes == tuple(np.asarray(want.pool_lanes).tolist())
    assert got.host_syncs == sum(got.pool_trips)


def test_hals_sched_reaches_every_stop(jobs):
    a, w0, h0 = jobs
    seen = set()
    for extra in ({}, dict(tol_fun=0.0, tol_x=1e-2),
                  dict(tol_fun=0.0, class_flip_tol=0.0, stable_checks=10),
                  dict(max_iter=10)):
        cfg = nmfx_torch.SolverConfig(algorithm="hals", **{
            "max_iter": 400, **extra})
        seen |= set(mu_sched(a, w0, h0, cfg, slots=6,
                             device="cpu").stop_reason.tolist())
    assert {int(StopReason.MAX_ITER), int(StopReason.CLASS_STABLE),
            int(StopReason.TOL_X), int(StopReason.TOL_FUN)} <= seen


def test_hals_guards(jobs):
    """The reference's hals fences (tests/test_fused_kernel.py
    test_fused_guards and test_hals_check_block_needs_tolfun_off)."""
    a, w0, h0 = jobs
    with pytest.raises(ValueError, match="multiple of check_every"):
        mu_sched(a, w0, h0, nmfx_torch.SolverConfig(
            algorithm="hals", max_iter=201, backend="pallas"), slots=6,
            device="cpu")
    with pytest.raises(ValueError, match="use_tol_checks"):
        mu_sched(a, w0, h0, nmfx_torch.SolverConfig(
            algorithm="hals", max_iter=200, backend="pallas",
            check_block=4), slots=6, device="cpu")
    with pytest.raises(ValueError, match="fused_updates"):
        mu_sched(a, w0, h0, nmfx_torch.SolverConfig(
            algorithm="hals", max_iter=200, backend="pallas",
            experimental=nmfx_torch.ExperimentalConfig(
                fused_updates="fused")), slots=6, device="cpu")
    with pytest.raises(ValueError, match="hals runs through"):
        mu_packed(a, w0[:2, :, :3], h0[:2, :3],
                  nmfx_torch.SolverConfig(algorithm="hals"), device="cpu")
    # the dense layout takes a cap off the check cadence (per-iteration
    # blocks), as the reference's does
    res = mu_sched(a, w0, h0, nmfx_torch.SolverConfig(
        algorithm="hals", max_iter=7, backend="auto"), slots=6,
        device="cpu")
    assert (res.iterations == 7).all()


def test_hals_check_block_needs_tolfun_off(jobs):
    """With TolFun off the multi-check launch is sound: its stop
    decisions equal the check-per-trip schedule's."""
    a, w0, h0 = jobs
    base = nmfx_torch.SolverConfig(algorithm="hals", max_iter=200,
                                   backend="pallas", use_tol_checks=False)
    ref = mu_sched(a, w0, h0, dataclasses.replace(base, check_block=1),
                   slots=6, device="cpu")
    got = mu_sched(a, w0, h0, dataclasses.replace(base, check_block=4),
                   slots=6, device="cpu")
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  ref.iterations.numpy())
    np.testing.assert_array_equal(got.stop_reason.numpy(),
                                  ref.stop_reason.numpy())
    assert sum(got.pool_trips) < sum(ref.pool_trips)


def test_hals_auto_check_block_resolves_to_one(jobs):
    """With TolFun armed (the default), "auto" on the pallas hals route is
    check-per-trip: bit-equal to an explicit 1, one trip a check."""
    a, w0, h0 = jobs
    kw = dict(algorithm="hals", max_iter=200, backend="pallas")
    auto = mu_sched(a, w0, h0, nmfx_torch.SolverConfig(**kw), slots=6,
                    device="cpu")
    one = mu_sched(a, w0, h0, nmfx_torch.SolverConfig(check_block=1, **kw),
                   slots=6, device="cpu")
    np.testing.assert_array_equal(auto.iterations.numpy(),
                                  one.iterations.numpy())
    np.testing.assert_array_equal(auto.w.numpy(), one.w.numpy())
    np.testing.assert_array_equal(auto.h.numpy(), one.h.numpy())
    assert auto.pool_trips == one.pool_trips


# --- the sweep -------------------------------------------------------------

def test_hals_pallas_agreement(jobs):
    """The port's pallas layout against the reference's dense one, the
    reference's own band (test_fused_kernel.py::test_hals_pallas_agreement)."""
    a, _, _ = jobs
    ks, r = (2, 3), 4
    want = j_sweep(jnp.asarray(a), ConsensusConfig(ks=ks, restarts=r,
                                                   grid_exec="grid"),
                   SolverConfig(algorithm="hals", max_iter=400,
                                backend="packed"), InitConfig(), None)
    got = nmfx_torch.nmfconsensus(
        a, ks=ks, restarts=r, grid_exec="grid", keep_factors=True,
        solver_cfg=nmfx_torch.SolverConfig(algorithm="hals", max_iter=400,
                                           backend="pallas"), device="cpu")
    for k in ks:
        dc = np.abs(np.asarray(want[k].consensus) - got.per_k[k].consensus)
        assert dc.mean() * r <= 0.6, (k, dc.mean() * r)
        labels = np.argmax(got.per_k[k].all_h, axis=1)
        assert (np.asarray(want[k].labels) != labels).mean(
            axis=1).max() <= 0.1, k


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_hals_consensus_routes_match_reference(backend):
    """hals through nmfconsensus on the whole grid and per rank (the
    scheduler at one rank, its key pre-folded): the two routes give the
    same jobs, and both the reference's best k and memberships."""
    a = two_group_matrix(200, 12, seed=3)
    kw = dict(ks=(2, 3), restarts=4, seed=11, keep_factors=True)
    jcfg = nmfx.SolverConfig(algorithm="hals", backend=backend,
                             max_iter=200)
    want = nmfx.nmfconsensus(a, solver_cfg=jcfg, use_mesh=False, **kw)
    runs = {route: nmfx_torch.nmfconsensus(
        a, solver_cfg=_port(jcfg), grid_exec=route, device="cpu", **kw)
        for route in ("grid", "per_k")}
    for route, got in runs.items():
        assert got.best_k == want.best_k, route
        for k in (2, 3):
            w, g = want.per_k[k], got.per_k[k]
            np.testing.assert_array_equal(g.iterations,
                                          np.asarray(w.iterations))
            np.testing.assert_array_equal(g.stop_reasons,
                                          np.asarray(w.stop_reasons))
            np.testing.assert_array_equal(g.membership, w.membership)
            np.testing.assert_allclose(g.consensus, w.consensus, rtol=0,
                                       atol=1e-6)
    for k in (2, 3):
        grid, per_k = runs["grid"].per_k[k], runs["per_k"].per_k[k]
        np.testing.assert_array_equal(grid.iterations, per_k.iterations)
        np.testing.assert_array_equal(grid.all_h, per_k.all_h)
