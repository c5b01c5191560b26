"""The port's single-restart ``solve`` and ``nmf`` against the
reference's, and the configuration converters.

Both packages start from the same factors: numpy arrays handed to both,
or the same seed through the same key chain (the port's draws are the
reference's bit for bit). In float32 the iterations and the stop reason
must be equal and the factors agree to rtol=2e-4 (products summed in
other orders over a few hundred iterations). The float64 checks hold the
port to a numpy transliteration of the update and to the reference C
binary's fixture, at that fixture's own tolerances.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmfx
import nmfx_torch
from nmfx.datasets import two_group_matrix
from nmfx.solvers.base import solve as j_solve
from nmfx_torch.convert import (consensus_config_from_dict,
                                solver_config_from_dict)
from nmfx_torch.solvers.base import solve
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "golden_ref", "reference_mu_fixture.npz")

CONFIGS = {
    "default": dict(max_iter=300, stable_checks=40),
    "tol_x": dict(max_iter=300, tol_x=2e-3, stable_checks=400),
    "strict_flips": dict(max_iter=300, class_flip_tol=0.0, stable_checks=20),
    "odd_tail": dict(max_iter=101, stable_checks=400, check_every=3),
}


def _problem(seed=0, m=120, n_per_group=8, k=3):
    rng = np.random.default_rng(seed)
    a = two_group_matrix(m, n_per_group, seed=seed).astype(np.float32)
    w0 = rng.uniform(0.0, 1.0, (m, k)).astype(np.float32)
    h0 = rng.uniform(0.0, 1.0, (k, a.shape[1])).astype(np.float32)
    return a, w0, h0


def _assert_same(got, want, rtol=2e-4):
    assert got.iterations == int(want.iterations)
    assert got.stop_reason == int(want.stop_reason)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=rtol,
                               atol=2e-5)
    np.testing.assert_allclose(got.h.numpy(), np.asarray(want.h), rtol=rtol,
                               atol=2e-5)
    np.testing.assert_allclose(float(got.dnorm), float(want.dnorm),
                               rtol=1e-4)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_solve_matches_reference(name):
    a, w0, h0 = _problem()
    jcfg = nmfx.SolverConfig(**CONFIGS[name])
    want = j_solve(jnp.asarray(a), jnp.asarray(w0), jnp.asarray(h0), jcfg)
    got = solve(a, w0, h0, solver_config_from_dict(dataclasses.asdict(jcfg)),
                device="cpu")
    _assert_same(got, want)


def test_check_convergence_tolfun_matches_reference():
    """The TolFun test (used by solvers other than mu) on two consecutive
    checks, against the reference's check_convergence."""
    from nmfx.solvers import base as j_base
    from nmfx_torch.solvers import base as t_base

    a, w0, h0 = _problem(seed=2)
    cfg = nmfx.SolverConfig(tol_fun=1e-1)
    pcfg = solver_config_from_dict(dataclasses.asdict(cfg))
    ja = jnp.asarray(a)
    js = j_base.init_state(ja, jnp.asarray(w0), jnp.asarray(h0), ())
    ts = t_base.init_state(torch.as_tensor(a), torch.as_tensor(w0),
                           torch.as_tensor(h0), ())
    for it, scale in ((2, 1.0), (4, 1.01)):
        w, h = w0 * scale, h0 * scale
        js = j_base.check_convergence(
            js._replace(w=jnp.asarray(w), h=jnp.asarray(h),
                        iteration=jnp.int32(it)),
            cfg, a=ja, use_tolfun=True)
        ts = t_base.check_convergence(
            dataclasses.replace(ts, w=torch.as_tensor(w),
                                h=torch.as_tensor(h), iteration=it),
            pcfg, a=torch.as_tensor(a), use_tolfun=True)
        assert bool(ts.done) == bool(js.done)
        assert int(ts.stop_reason) == int(js.stop_reason)
        np.testing.assert_allclose(float(ts.dnorm), float(js.dnorm),
                                   rtol=1e-5)
    assert int(ts.stop_reason) == int(nmfx_torch.StopReason.TOL_FUN)


def test_solve_stops_are_exercised():
    a, w0, h0 = _problem()
    seen = {solve(a, w0, h0, nmfx_torch.SolverConfig(**kw),
                  device="cpu").stop_reason for kw in CONFIGS.values()}
    assert {int(nmfx_torch.StopReason.MAX_ITER),
            int(nmfx_torch.StopReason.CLASS_STABLE),
            int(nmfx_torch.StopReason.TOL_X)} <= seen


@pytest.mark.parametrize("seed,init", [(0, "random"), (7, "random"),
                                       (3, "nndsvd")])
def test_nmf_matches_reference(seed, init):
    a = two_group_matrix(150, 10, seed=seed)
    want = nmfx.nmf(a, 3, seed=seed, init=init, max_iter=400)
    got = nmfx_torch.nmf(a, 3, seed=seed, init=init, max_iter=400,
                         device="cpu")
    _assert_same(got, want)


def test_nmf_validates_its_inputs():
    a = two_group_matrix(30, 4, seed=0)
    with pytest.raises(ValueError, match="both"):
        nmfx_torch.nmf(a, 2, w0=np.ones((30, 2)), device="cpu")
    with pytest.raises(ValueError, match="non-negative"):
        nmfx_torch.nmf(-a, 2, device="cpu")
    with pytest.raises(ValueError, match="no pool"):
        nmfx_torch.nmf(a, 2, solver_cfg=nmfx_torch.SolverConfig(
            screen=True, screen_keep=2), device="cpu")
    # float64 draws from the key chain are ported: a seed runs in float64
    res = nmfx_torch.nmf(a, 2, solver_cfg=nmfx_torch.SolverConfig(
        dtype="float64", max_iter=20), device="cpu")
    assert res.w.dtype == torch.float64


def _mu_numpy(a, w, h, iters, eps=1e-9):
    """The reference mu update (libnmf/nmf_mu.c:174-216) in float64."""
    for _ in range(iters):
        numerh = w.T @ a
        h_new = h * numerh / ((w.T @ w) @ h + eps)
        h_new[(h == 0) | (numerh == 0)] = 0.0
        h = h_new
        numerw = a @ h.T
        w_new = w * numerw / (w @ (h @ h.T) + eps)
        w_new[(w == 0) | (numerw == 0)] = 0.0
        w = w_new
    return w, h


def test_float64_solve_matches_numpy_update():
    rng = np.random.default_rng(12)
    a = rng.uniform(0.1, 1.0, (60, 22))
    w0 = rng.uniform(0.1, 1.0, (60, 3))
    h0 = rng.uniform(0.1, 1.0, (3, 22))
    cfg = nmfx_torch.SolverConfig(max_iter=50, dtype="float64",
                                  use_class_stop=False, use_tol_checks=False)
    got = solve(a, w0, h0, cfg, device="cpu")
    w_ref, h_ref = _mu_numpy(a, w0, h0, 50)
    assert got.w.dtype == torch.float64 and got.iterations == 50
    np.testing.assert_allclose(got.w.numpy(), w_ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got.h.numpy(), h_ref, rtol=1e-10, atol=1e-12)


def test_reproduces_reference_binary_fixture_in_float64():
    """The C reference binary's 300-iteration runs on the bundled
    20+20x1000 design, replayed through the port's float64 solve at the
    reference package's own tolerances (tests/test_reference_binary.py):
    factors to rtol=1e-7, labels and consensus exactly."""
    gct = os.environ.get("NMFX_REFERENCE_GCT", "")
    if not os.path.exists(gct):
        pytest.skip("the bundled 20+20x1000.gct is not found: set "
                    "NMFX_REFERENCE_GCT to its path")
    from nmfx_torch.io import read_gct

    fx = np.load(FIXTURE)
    a = np.asarray(read_gct(gct).values, np.float64)
    restarts, maxiter = int(fx["restarts"]), int(fx["maxiter"])
    cfg = nmfx_torch.SolverConfig(max_iter=maxiter, dtype="float64",
                                  use_tol_checks=False, class_flip_tol=0.0)
    for k in (int(k) for k in fx["ks"]):
        labels = []
        for r in range(restarts):
            rng = np.random.default_rng(1000 * k + r)
            w0 = rng.random((a.shape[0], k))
            h0 = rng.random((k, a.shape[1]))
            res = solve(a, w0, h0, cfg, device="cpu")
            assert res.iterations == maxiter
            np.testing.assert_allclose(res.h.numpy(), fx[f"h_k{k}_r{r}"],
                                       rtol=1e-7, atol=1e-9)
            if r == 0:
                np.testing.assert_allclose(res.w.numpy(), fx[f"w_k{k}_r0"],
                                           rtol=1e-7, atol=1e-9)
            labels.append(np.argmin(res.h.numpy(), axis=0))
        labels = np.stack(labels)
        np.testing.assert_array_equal(labels, fx[f"labels_k{k}"])
        cons = (labels[:, :, None] == labels[:, None, :]).mean(0)
        np.testing.assert_array_equal(cons, fx[f"consensus_k{k}"])


def test_configs_round_trip_from_reference_dicts():
    for jcfg in (nmfx.SolverConfig(),
                 nmfx.SolverConfig(
                     backend="pallas", max_iter=77, check_block=3,
                     experimental=nmfx.ExperimentalConfig(
                         evict_batch=3, fused_updates="phased"))):
        d = dataclasses.asdict(jcfg)
        assert dataclasses.asdict(solver_config_from_dict(d)) == {
            k: v for k, v in d.items()
            if k in {f.name for f in dataclasses.fields(
                nmfx_torch.SolverConfig)}}
    for ccfg in (nmfx.ConsensusConfig(),
                 nmfx.ConsensusConfig(ks=(2, 5), grid_slots=7,
                                      grid_tail_slots=(4, 2),
                                      grid_exec="grid")):
        d = dataclasses.asdict(ccfg)
        assert dataclasses.asdict(consensus_config_from_dict(d)) == d
    with pytest.raises(ValueError, match="unknown"):
        consensus_config_from_dict({"no_such_field": 1})


@pytest.mark.parametrize("knob,item", [
    # None: ported (the ragged pool, bf16 pool factors, alias_io), so the
    # knob converts as it is
    (dict(ragged=True), None),
    (dict(factor_dtype="bfloat16"), None),
    (dict(autotune="on"), "§1 item 11"),
    (dict(alias_io=True), None),
])
def test_converter_refuses_unported_experimental_knobs(knob, item):
    d = dataclasses.asdict(nmfx.SolverConfig(
        backend="pallas", experimental=nmfx.ExperimentalConfig(**knob)))
    if item is None:
        got = dataclasses.asdict(solver_config_from_dict(d).experimental)
        assert got == {f: v for f, v in d["experimental"].items()
                       if f in got}
        return
    with pytest.raises(NotImplementedError, match=item):
        solver_config_from_dict(d)
