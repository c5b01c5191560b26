"""Restart screening (``SolverConfig.screen``) on the port against
``nmfx`` on the CPU: a port of ``tests/test_screening.py``.

The screening pass ranks a rank's restarts by their compressed
objective; the ``screen_keep`` best receive exact iterations on the
batched restart route; the rest read as pad lanes. Held here:

* the survivor set equals the reference's on inputs where the keep-th
  and the (keep+1)-th scores lie further apart than the scores'
  tolerance (rtol 1e-4, the sketch's float32 products in another order;
  each case asserts that gap), and the scores themselves at rtol 1e-4;
* survivors equal ``restart_factors`` of their restart byte for byte
  (it runs the batched restart route at the exact phase's width,
  ``screen_keep`` copies of the restart, so its products have the
  survivors' shapes), and the
  single-restart ``solve`` at float tolerance with equal iterations,
  stop reasons and labels (its 2-D products take other CPU kernels). On
  the card cuBLAS may pick another algorithm for another batch count,
  so ``chip_smoke.py`` checks byte-equality there and falls back to
  equal iterations and labels at float tolerance, saying which;
* screened-out lanes behave as pad lanes, the ``min_restarts`` floor
  counts them, ``keep_factors`` and an armed ``solve.nonfinite`` are
  refused, and ``keep == restarts`` is the unscreened batched sweep byte
  for byte.
"""

import jax
import numpy as np
import pytest
import torch

import nmfx
import nmfx_torch
from nmfx.sweep import sweep_one_k as nsweep_one_k
from nmfx_torch import random as R
from nmfx_torch.config import InitConfig, SolverConfig
from nmfx_torch.datasets import two_group_matrix
from nmfx_torch.faults import InsufficientRestarts
from nmfx_torch.init import restart_inits
from nmfx_torch.solvers import sketched as sk
from nmfx_torch.solvers.base import StopReason, solve
from nmfx_torch.sweep import sweep_one_k
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)

RESTARTS = 8
KEEP = 3
RTOL = 1e-4


def small_matrix():
    return two_group_matrix(n_genes=60, n_per_group=12, seed=0).astype(
        np.float32)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def screened_cfg(**kw):
    base = dict(algorithm="mu", max_iter=200, screen=True, screen_keep=KEEP)
    base.update(kw)
    return SolverConfig(**base)


@pytest.fixture(scope="module")
def screened_out():
    a = small_matrix()
    key = R.fold_in(R.key(123), 2)
    out = sweep_one_k(_t(a), key, 2, RESTARTS, screened_cfg(), InitConfig())
    return a, key, out


def test_config_validation():
    with pytest.raises(ValueError, match="screen_keep"):
        SolverConfig(screen=True)
    with pytest.raises(ValueError, match="vmapped"):
        SolverConfig(screen=True, screen_keep=2, backend="packed")
    with pytest.raises(ValueError, match="sketched screening"):
        SolverConfig(algorithm="als", screen=True, screen_keep=2)
    with pytest.raises(ValueError, match="screen_keep"):
        SolverConfig(screen_keep=0)
    with pytest.raises(ValueError, match="in-core"):
        SolverConfig(screen=True, screen_keep=2, tile_rows=8)
    with pytest.raises(ValueError, match=r"screen_keep must be in"):
        sweep_one_k(_t(small_matrix()), R.key(0), 2, 4,
                    screened_cfg(screen_keep=9), InitConfig())


def test_exactly_keep_survivors(screened_out):
    _, _, out = screened_out
    stops = out.stop_reasons.numpy()
    surv = stops != int(StopReason.SCREENED)
    assert int(surv.sum()) == KEEP
    labels, dn, iters = (out.labels.numpy(), out.dnorms.numpy(),
                         out.iterations.numpy())
    for i in np.nonzero(~surv)[0]:
        assert np.all(labels[i] == -1)
        assert np.isinf(dn[i])
        assert iters[i] == screened_cfg().sketch.screen_iters


@pytest.mark.parametrize("algorithm,seed,keep", [
    ("mu", 123, 3), ("mu", 9, 5), ("hals", 123, 3), ("hals", 4, 2)])
def test_survivors_match_reference(algorithm, seed, keep):
    """The same survivor set as the reference, where its scores leave a
    gap wider than the tolerance at the cut; the survivors' exact
    results at the solver tests' tier (iterations, stop reasons and
    labels equal, residuals rtol 1e-4)."""
    a = small_matrix()
    key = R.fold_in(R.key(seed), 2)
    keys = R.split(key, RESTARTS)
    cfg = screened_cfg(algorithm=algorithm, screen_keep=keep)
    w0, h0 = restart_inits(_t(a), keys, 2, InitConfig())
    scores = sk.screen_pass(_t(a), w0, h0, keys, cfg).numpy()
    ordered = np.sort(scores)
    assert ordered[keep] - ordered[keep - 1] > 4 * RTOL * ordered[keep], \
        ordered
    got = sweep_one_k(_t(a), key, 2, RESTARTS, cfg, InitConfig())
    want = nsweep_one_k(a, jax.random.fold_in(jax.random.key(seed), 2), 2,
                        RESTARTS, nmfx.SolverConfig(
                            algorithm=algorithm, max_iter=200, screen=True,
                            screen_keep=keep), nmfx.InitConfig())
    stops = got.stop_reasons.numpy()
    np.testing.assert_array_equal(stops, np.asarray(want.stop_reasons))
    assert np.array_equal(np.sort(np.argsort(scores, kind="stable")[:keep]),
                          np.nonzero(stops != int(StopReason.SCREENED))[0])
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_allclose(got.dnorms.numpy(), np.asarray(want.dnorms),
                               rtol=RTOL)


def test_survivors_equal_solo_exact_runs(screened_out):
    """Each survivor equals a solo exact run of its restart from its
    canonical key: ``restart_factors`` (the batched route at the exact
    phase's width) byte for byte; the single-restart ``solve``, whose 2-D products
    take other CPU kernels, with equal iterations, stop reason and
    labels and factors within rtol 1e-4 of their largest entry."""
    a, key, out = screened_out
    stops = out.stop_reasons.numpy()
    surv = np.nonzero(stops != int(StopReason.SCREENED))[0]
    keys = R.split(key, RESTARTS)
    exact = SolverConfig(algorithm="mu", max_iter=200)
    best = surv[np.argmin(out.dnorms.numpy()[surv])]
    for i in surv:
        r = nmfx_torch.restart_factors(a, 2, int(i), restarts=RESTARTS,
                                       seed=123, solver_cfg=screened_cfg(),
                                       device="cpu")
        assert r.dnorm.numpy().tobytes() == out.dnorms.numpy()[i].tobytes()
        assert r.iterations == int(out.iterations[i])
        assert r.stop_reason == int(stops[i])
        assert np.array_equal(torch.argmax(r.h, dim=0).numpy(),
                              out.labels.numpy()[i])
        if i == best:
            assert r.w.numpy().tobytes() == out.best_w.numpy().tobytes()
            assert r.h.numpy().tobytes() == out.best_h.numpy().tobytes()
        w0, h0 = restart_inits(_t(a), keys[i:i + 1], 2, InitConfig())
        s = solve(a, w0[0], h0[0], exact, device="cpu")
        assert (s.iterations, s.stop_reason) == (r.iterations,
                                                 r.stop_reason)
        assert np.array_equal(torch.argmax(s.h, dim=0).numpy(),
                              out.labels.numpy()[i])
        for x, y in ((s.w, r.w), (s.h, r.h)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0,
                                       atol=1e-4 * float(y.abs().max()))


def test_masked_lanes_behave_like_pad_lanes(screened_out):
    _, _, out = screened_out
    stops = out.stop_reasons.numpy()
    surv = np.nonzero(stops != int(StopReason.SCREENED))[0]
    labels = out.labels.numpy()[surv]
    conn = (labels[:, :, None] == labels[:, None, :]).astype(np.float64)
    np.testing.assert_allclose(out.consensus.numpy().astype(np.float64),
                               conn.mean(axis=0), atol=1e-6)


def test_screening_deterministic(screened_out):
    a, key, out = screened_out
    out2 = sweep_one_k(_t(a), key, 2, RESTARTS, screened_cfg(),
                       InitConfig())
    assert torch.equal(out.stop_reasons, out2.stop_reasons)
    assert torch.equal(out.dnorms, out2.dnorms)


def test_min_restarts_floor_counts_screened_as_nonsurvivors():
    a = small_matrix()
    with pytest.raises(InsufficientRestarts, match="SCREENED"):
        nmfx_torch.nmfconsensus(a, ks=(2,), restarts=6, seed=1,
                                solver_cfg=screened_cfg(screen_keep=2),
                                min_restarts=4, device="cpu")
    res = nmfx_torch.nmfconsensus(a, ks=(2,), restarts=6, seed=1,
                                  solver_cfg=screened_cfg(screen_keep=4),
                                  min_restarts=4, device="cpu")
    assert res.quality == "exact"


def test_keep_factors_and_fault_injection_refused():
    from nmfx_torch import faults

    a = _t(small_matrix())
    with pytest.raises(ValueError, match="keep_factors"):
        sweep_one_k(a, R.key(0), 2, 6, screened_cfg(), InitConfig(),
                    keep_factors=True)
    faults.arm("solve.nonfinite", lanes=((2, 1),))
    try:
        with pytest.raises(ValueError, match="does not compose"):
            sweep_one_k(a, R.key(0), 2, 6, screened_cfg(), InitConfig())
    finally:
        faults.disarm()


def test_screen_keep_equal_restarts_solves_everything():
    a = _t(small_matrix())
    key = R.fold_in(R.key(5), 2)
    out_s = sweep_one_k(a, key, 2, 6, screened_cfg(screen_keep=6),
                        InitConfig())
    out_v = sweep_one_k(a, key, 2, 6, SolverConfig(
        algorithm="mu", max_iter=200, backend="vmap"), InitConfig())
    assert not np.any(out_s.stop_reasons.numpy()
                      == int(StopReason.SCREENED))
    for f in ("dnorms", "labels", "consensus", "iterations"):
        assert getattr(out_s, f).numpy().tobytes() == \
            getattr(out_v, f).numpy().tobytes(), f


def test_restart_factors_reproduces_screened_survivor(screened_out):
    """The hals survivors too, through restart_factors, byte for byte."""
    a = small_matrix()
    key = R.fold_in(R.key(123), 2)
    cfg = screened_cfg(algorithm="hals")
    out = sweep_one_k(_t(a), key, 2, RESTARTS, cfg, InitConfig())
    surv = np.nonzero(out.stop_reasons.numpy()
                      != int(StopReason.SCREENED))[0]
    for i in surv[:2]:
        r = nmfx_torch.restart_factors(a, 2, int(i), restarts=RESTARTS,
                                       seed=123, solver_cfg=cfg,
                                       device="cpu")
        assert r.dnorm.numpy().tobytes() == \
            out.dnorms.numpy()[i].tobytes()
        assert r.iterations == int(out.iterations[i])


def test_screened_sweep_through_nmfconsensus_and_grid_exec_guard():
    a = small_matrix()
    res = nmfx_torch.nmfconsensus(a, ks=(2, 3), restarts=6, seed=2,
                                  solver_cfg=screened_cfg(), device="cpu")
    assert set(res.per_k) == {2, 3}
    ref = nmfx.nmfconsensus(a, ks=(2, 3), restarts=6, seed=2,
                            use_mesh=False, solver_cfg=nmfx.SolverConfig(
                                algorithm="mu", max_iter=200, screen=True,
                                screen_keep=KEEP))
    assert res.best_k == ref.best_k
    for k in (2, 3):
        np.testing.assert_array_equal(res.per_k[k].stop_reasons,
                                      np.asarray(ref.per_k[k].stop_reasons))
    with pytest.raises(ValueError, match="grid_exec='grid'"):
        nmfx_torch.nmfconsensus(a, ks=(2, 3), restarts=6, seed=2,
                                solver_cfg=screened_cfg(), grid_exec="grid",
                                device="cpu")
