"""The port's compressed engine (``backend="sketched"``,
``nmfx_torch/solvers/sketched.py``) against ``nmfx``'s on the CPU: a
port of ``tests/test_sketched.py`` case by case, plus direct holds
against the reference from the same keys and numpy-seeded inputs.

Tolerances:

* one sketched mu or hals step from identical state (the reference's own
  projections and products): rtol 1e-5 (float32 products in another
  order);
* a 20-iteration ``solve_sketched`` from the same key: equal iterations
  and stop reason, factors within rtol 1e-4 of their largest entry (the
  projections themselves part from JAX's in the last bits, see
  test_torch_random_normal.py);
* the sweep at 60×24, 200 iterations: equal iterations, stop reasons and
  labels, residuals within rtol 1e-4;
* the statistical gate on the bundled 20+20×1000 design at k = 2, seeds
  1-5, 6 restarts, 300 iterations: min ARI >= 0.9, mean >= 0.95 and
  |Δrho| <= 0.12, against the port's exact engine and against the
  reference's sketched engine.

Determinism and prefix stability: on the CPU torch's batched products
evaluate each lane alike whatever the batch, so a 4-restart sweep is the
first 4 lanes of a 6-restart sweep byte for byte, and the test says so.
The reference's own prefix test fails on XLA's CPU backend, whose
batched reductions depend on the batch size (ROADMAP §3 caveats); on the
card cuBLAS may choose another algorithm for another batch count, so
there the card tests hold it at float tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmfx
import nmfx_torch
from nmfx.datasets import two_group_matrix
from nmfx.init import initialize
from nmfx.solvers import sketched as jsk
from nmfx.sweep import sweep_one_k as nsweep_one_k
from nmfx_torch import random as R
from nmfx_torch.agreement import consensus_agreement
from nmfx_torch.config import InitConfig, SketchConfig, SolverConfig
from nmfx_torch.solvers import sketched as sk
from nmfx_torch.solvers.base import StopReason
from nmfx_torch.sweep import resolve_engine_family, sweep_one_k
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)

#: the reference's recorded agreement gate (tests/test_sketched.py)
AGREEMENT_SEEDS = (1, 2, 3, 4, 5)
ARI_GATE_MIN = 0.9
ARI_GATE_MEAN = 0.95
RHO_GAP_GATE = 0.12


def small_matrix():
    return two_group_matrix(n_genes=60, n_per_group=12, seed=0).astype(
        np.float32)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _rank_key(seed, k):
    return R.fold_in(R.key(seed), k)


# -- engine mechanics (smallest shapes) ---------------------------------
def test_backend_validation():
    SolverConfig(algorithm="mu", backend="sketched")
    SolverConfig(algorithm="hals", backend="sketched")
    with pytest.raises(ValueError, match="sketched"):
        SolverConfig(algorithm="als", backend="sketched")
    with pytest.raises(ValueError, match="sketch.dim"):
        SketchConfig(dim=0)
    with pytest.raises(ValueError, match="screen_iters"):
        SketchConfig(screen_iters=0)
    with pytest.raises(ValueError, match="polish_iters"):
        SketchConfig(polish_iters=-1)
    with pytest.raises(ValueError, match="cannot combine"):
        SolverConfig(backend="sketched", tile_rows=8)


def test_engine_family_resolution():
    assert resolve_engine_family(
        SolverConfig(backend="sketched")) == "sketched"
    assert resolve_engine_family(
        SolverConfig(screen=True, screen_keep=2)) == "vmap"
    for cfg in (SolverConfig(backend="sketched"),
                SolverConfig(algorithm="hals", screen=True, screen_keep=3)):
        ncfg = nmfx.SolverConfig(**{
            f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(cfg)
            if f.name not in ("experimental", "sketch")})
        assert resolve_engine_family(cfg) == \
            nmfx.sweep.resolve_engine_family(ncfg)


def test_resolve_dim_clamps():
    cfg = SolverConfig(backend="sketched")
    assert sk.resolve_dim(cfg, 1000, 500, 3) == 40
    assert sk.resolve_dim(cfg, 1000, 500, 10) == 48
    assert sk.resolve_dim(cfg, 1000, 10, 3) == 10
    assert sk.resolve_dim(
        dataclasses.replace(cfg, sketch=SketchConfig(dim=6)),
        1000, 500, 3) == 6
    assert sk.resolve_dim(
        dataclasses.replace(cfg, sketch=SketchConfig(dim=2)),
        1000, 500, 5) == 6
    ncfg = nmfx.SolverConfig(backend="sketched")
    for m, n, k in ((1000, 500, 3), (5000, 500, 10), (60, 24, 2)):
        assert sk.resolve_dim(cfg, m, n, k) == jsk.resolve_dim(ncfg, m, n, k)


@pytest.mark.parametrize("algorithm", ["mu", "hals"])
def test_sketched_sweep_runs_and_reduces_residual(algorithm):
    cfg = SolverConfig(algorithm=algorithm, max_iter=200,
                       backend="sketched")
    out = sweep_one_k(_t(small_matrix()), _rank_key(123, 2), 2, 6, cfg,
                      InitConfig())
    dn = out.dnorms.numpy()
    assert dn.shape == (6,)
    assert np.all(np.isfinite(dn))
    assert dn.mean() < 0.5
    labels = out.labels.numpy()
    assert labels.shape == (6, 24)
    assert set(np.unique(labels)) <= {0, 1}
    assert out.consensus.shape == (24, 24)


@pytest.mark.parametrize("algorithm", ["mu", "hals"])
def test_sketched_sweep_matches_reference(algorithm):
    a = small_matrix()
    kw = dict(algorithm=algorithm, max_iter=200, backend="sketched")
    got = sweep_one_k(_t(a), _rank_key(123, 2), 2, 6, SolverConfig(**kw),
                      InitConfig())
    want = nsweep_one_k(a, jax.random.fold_in(jax.random.key(123), 2), 2,
                        6, nmfx.SolverConfig(**kw), nmfx.InitConfig())
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_array_equal(got.stop_reasons.numpy(),
                                  np.asarray(want.stop_reasons))
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_allclose(got.dnorms.numpy(), np.asarray(want.dnorms),
                               rtol=1e-4)


def test_sketched_deterministic_and_batch_independent():
    """Equal across calls; and the first 4 lanes of a 6-restart sweep are
    the 4-restart sweep byte for byte, because torch's CPU products
    treat each lane alike whatever the batch (what the reference's
    version of this case asserts and XLA's CPU backend does not give)."""
    a = _t(small_matrix())
    cfg = SolverConfig(algorithm="mu", max_iter=120, backend="sketched")
    key = _rank_key(7, 2)
    out1 = sweep_one_k(a, key, 2, 6, cfg, InitConfig())
    out2 = sweep_one_k(a, key, 2, 6, cfg, InitConfig())
    assert torch.equal(out1.dnorms, out2.dnorms)
    assert torch.equal(out1.labels, out2.labels)
    out4 = sweep_one_k(a, key, 2, 4, cfg, InitConfig())
    assert out1.dnorms[:4].numpy().tobytes() == out4.dnorms.numpy().tobytes()
    assert torch.equal(out1.iterations[:4], out4.iterations)


def test_momentum_off_runs():
    cfg = SolverConfig(algorithm="mu", max_iter=120, backend="sketched",
                       sketch=SketchConfig(momentum=False))
    out = sweep_one_k(_t(small_matrix()), _rank_key(3, 2), 2, 4, cfg,
                      InitConfig())
    assert np.all(np.isfinite(out.dnorms.numpy()))
    jcfg = nmfx.SolverConfig(algorithm="mu", max_iter=120,
                             backend="sketched",
                             sketch=nmfx.SketchConfig(momentum=False))
    want = nsweep_one_k(small_matrix(),
                        jax.random.fold_in(jax.random.key(3), 2), 2, 4,
                        jcfg, nmfx.InitConfig())
    np.testing.assert_array_equal(out.iterations.numpy(),
                                  np.asarray(want.iterations))


def test_sketched_result_is_quality_tagged():
    a = small_matrix()
    res = nmfx_torch.nmfconsensus(
        a, ks=(2,), restarts=4, seed=1, device="cpu",
        solver_cfg=SolverConfig(algorithm="mu", max_iter=120,
                                backend="sketched"))
    assert res.quality == "sketched"
    assert "sketched" in res.summary()
    exact = nmfx_torch.nmfconsensus(
        a, ks=(2,), restarts=4, seed=1, device="cpu",
        solver_cfg=SolverConfig(algorithm="mu", max_iter=120))
    assert exact.quality == "exact"
    assert "quality" not in exact.summary()


def test_quality_tag_roundtrips_through_save_load(tmp_path):
    res = nmfx_torch.nmfconsensus(
        small_matrix(), ks=(2,), restarts=3, seed=1, device="cpu",
        solver_cfg=SolverConfig(algorithm="mu", max_iter=100,
                                backend="sketched"))
    path = str(tmp_path / "res.npz")
    res.save(path)
    assert nmfx_torch.ConsensusResult.load(path).quality == "sketched"
    # the layout is the reference's: each package reads the other's file
    assert nmfx.ConsensusResult.load(path).quality == "sketched"


def test_sketched_refuses_bit_exact_surfaces(tmp_path):
    from nmfx_torch.config import CheckpointConfig, ConsensusConfig
    from nmfx_torch.exec_cache import ExecCache

    a = small_matrix()
    cfg = SolverConfig(algorithm="mu", max_iter=100, backend="sketched")
    for bad in (cfg, SolverConfig(screen=True, screen_keep=2)):
        with pytest.raises(ValueError, match="sketched"):
            nmfx_torch.nmfconsensus(
                a, ks=(2,), restarts=3, solver_cfg=bad, device="cpu",
                checkpoint=CheckpointConfig(str(tmp_path / "ck")))
        assert not ExecCache(device="cpu").cacheable(
            ConsensusConfig(ks=(2,), restarts=3), bad, None)


def test_model_flops_compression():
    from nmfx_torch.obs import costmodel

    m, n, k = 5000, 500, 10
    r = sk.resolve_dim(SolverConfig(backend="sketched"), m, n, k)
    ratio = (costmodel.iteration_flops("mu", "vmap", m, n, k)
             / sk.sketched_model_flops(m, n, k, r))
    assert ratio > 5.0
    assert sk.sketched_model_flops(m, n, k, r) == \
        jsk.sketched_model_flops(m, n, k, r)


# -- one step and a short solve against the reference --------------------
def _ref_state(alg):
    a = small_matrix()
    jkey = jax.random.split(jax.random.fold_in(jax.random.key(123), 2),
                            6)[1]
    w0, h0 = initialize(jkey, jnp.asarray(a), 2, nmfx.InitConfig(),
                        jnp.float32)
    r = jsk.resolve_dim(nmfx.SolverConfig(backend="sketched"), 60, 24, 2)
    left, right = jsk.sketch_operators(jkey, 60, 24, r, jnp.float32)
    return a, jkey, w0, h0, left, right


@pytest.mark.parametrize("algorithm", ["mu", "hals"])
def test_one_step_matches_reference(algorithm):
    """One sketched step with momentum from identical state (the
    reference's projections, its previous iterates one momentum step
    back), through each package's ``step``."""
    from nmfx.solvers import base as jbase

    from nmfx_torch.solvers import base as tbase

    a, jkey, w0, h0, left, right = _ref_state(algorithm)
    jcfg = nmfx.SolverConfig(algorithm=algorithm, backend="sketched")
    tcfg = SolverConfig(algorithm=algorithm, backend="sketched")
    w_acc, h_acc = w0 * 0.9, h0 * 1.1
    aj = jnp.asarray(a)
    jaux = (left @ aj, aj @ right, left, right, w_acc, h_acc,
            jnp.asarray(1.7, jnp.float32))
    js = jsk.step(aj, jbase.init_state(aj, w0, h0, jaux), jcfg, check=False)
    at = _t(a)
    tl, tr = _t(left)[None], _t(right)[None]
    taux = (tl @ at, at @ tr, tl, tr, _t(w_acc)[None], _t(h_acc)[None],
            torch.tensor([1.7]))
    ts = sk.step(at, tbase.init_state(at, _t(w0)[None], _t(h0)[None], taux),
                 tcfg, check=False)
    np.testing.assert_allclose(ts.w[0].numpy(), np.asarray(js.w),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ts.h[0].numpy(), np.asarray(js.h),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ts.aux[6].numpy()[0], float(js.aux[6]),
                               rtol=1e-7)


@pytest.mark.parametrize("algorithm", ["mu", "hals"])
def test_short_solve_matches_reference(algorithm):
    a, jkey, w0, h0, _, _ = _ref_state(algorithm)
    kw = dict(algorithm=algorithm, max_iter=20, backend="sketched")
    want = jsk.solve_sketched(jnp.asarray(a), w0, h0, jkey,
                              nmfx.SolverConfig(**kw))
    tkey = R.split(_rank_key(123, 2), 6)[1]
    got = sk.solve_sketched(_t(a), _t(w0), _t(h0), tkey, SolverConfig(**kw))
    assert got.iterations == int(want.iterations) == 23
    assert got.stop_reason == int(want.stop_reason)
    for x, y in ((got.w, want.w), (got.h, want.h)):
        y = np.asarray(y)
        np.testing.assert_allclose(x.numpy(), y, rtol=0,
                                   atol=1e-4 * np.abs(y).max())
    np.testing.assert_allclose(float(got.dnorm), float(want.dnorm),
                               rtol=1e-4)


def test_screen_pass_and_objective_match_reference():
    a = small_matrix()
    jkeys = jax.random.split(jax.random.fold_in(jax.random.key(5), 2), 4)
    tkeys = R.split(_rank_key(5, 2), 4)
    ws, hs = jax.vmap(lambda kk: initialize(
        kk, jnp.asarray(a), 2, nmfx.InitConfig(), jnp.float32))(jkeys)
    for alg in ("mu", "hals"):
        jcfg = nmfx.SolverConfig(algorithm=alg, screen=True, screen_keep=2)
        tcfg = SolverConfig(algorithm=alg, screen=True, screen_keep=2)
        want = np.asarray(jax.vmap(lambda w, h, kk: jsk.screen_pass(
            jnp.asarray(a), w, h, kk, jcfg))(ws, hs, jkeys))
        got = sk.screen_pass(_t(a), _t(ws), _t(hs), tkeys, tcfg).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4)
        obj = np.asarray(jax.vmap(lambda w, h, kk: jsk.compressed_objective(
            jnp.asarray(a), w, h, kk, jcfg))(ws, hs, jkeys))
        np.testing.assert_allclose(
            sk.compressed_objective(_t(a), _t(ws), _t(hs), tkeys,
                                    tcfg).numpy(), obj, rtol=1e-4)


# -- the statistical agreement gate -------------------------------------
def _bundled_agreement(seeds, ks, restarts, max_iter):
    a = two_group_matrix(n_genes=1000, n_per_group=20, seed=123)
    exact = SolverConfig(algorithm="mu", max_iter=max_iter)
    sketch = dataclasses.replace(exact, backend="sketched")
    nsketch = nmfx.SolverConfig(algorithm="mu", max_iter=max_iter,
                                backend="sketched")
    reports = {}
    for s in seeds:
        kw = dict(ks=ks, restarts=restarts, seed=s)
        re_ = nmfx_torch.nmfconsensus(a, solver_cfg=exact, device="cpu",
                                      **kw)
        rs_ = nmfx_torch.nmfconsensus(a, solver_cfg=sketch, device="cpu",
                                      **kw)
        rn_ = nmfx.nmfconsensus(a, solver_cfg=nsketch, use_mesh=False, **kw)
        assert rs_.quality == rn_.quality == "sketched"
        reports[s] = (consensus_agreement(re_, rs_),
                      consensus_agreement(rn_, rs_))
    return reports


def test_agreement_gate_bundled_dataset():
    """The reference's gate on the port: sketched against the port's
    exact engine and against the reference's sketched engine, k = 2,
    seeds 1-5: min ARI >= 0.9, mean >= 0.95, |Δrho| <= 0.12."""
    reports = _bundled_agreement(AGREEMENT_SEEDS, (2,), 6, 300)
    for side in (0, 1):
        aris = [rep[side]["per_k"][2]["ari"] for rep in reports.values()]
        gaps = [rep[side]["per_k"][2]["rho_gap"] for rep in reports.values()]
        assert min(aris) >= ARI_GATE_MIN, (side, aris)
        assert float(np.mean(aris)) >= ARI_GATE_MEAN, (side, aris)
        assert max(gaps) <= RHO_GAP_GATE, (side, gaps)


@pytest.mark.slow
def test_agreement_gate_heavy():
    reports = _bundled_agreement(tuple(range(1, 9)), (2, 3), 8, 500)
    aris2 = [rep[0]["per_k"][2]["ari"] for rep in reports.values()]
    aris3 = [rep[0]["per_k"][3]["ari"] for rep in reports.values()]
    assert min(aris2) >= ARI_GATE_MIN
    assert float(np.mean(aris3)) >= 0.5


# -- recompute-by-key and the solve() guard -----------------------------
def test_solve_refuses_sketched_and_screen():
    from nmfx_torch.solvers.base import solve

    a = np.ones((8, 6), np.float32)
    w0 = np.ones((8, 2), np.float32)
    h0 = np.ones((2, 6), np.float32)
    with pytest.raises(ValueError, match="per-restart key"):
        solve(a, w0, h0, SolverConfig(algorithm="mu", backend="sketched"),
              device="cpu")
    with pytest.raises(ValueError, match="sweep layer"):
        solve(a, w0, h0, SolverConfig(algorithm="mu", screen=True,
                                      screen_keep=2), device="cpu")


def test_restart_factors_reproduces_sketched_lane():
    a = small_matrix()
    cfg = SolverConfig(algorithm="mu", max_iter=100, backend="sketched")
    out = sweep_one_k(_t(a), _rank_key(123, 2), 2, 4, cfg, InitConfig())
    for i in (0, 3):
        r = nmfx_torch.restart_factors(a, 2, i, restarts=4, seed=123,
                                       solver_cfg=cfg, device="cpu")
        np.testing.assert_allclose(float(r.dnorm), float(out.dnorms[i]),
                                   rtol=1e-4)
        assert int(r.iterations) == int(out.iterations[i])
        ref = nmfx.restart_factors(a, 2, i, restarts=4, seed=123,
                                   solver_cfg=nmfx.SolverConfig(
                                       algorithm="mu", max_iter=100,
                                       backend="sketched"))
        assert int(r.iterations) == int(ref.iterations)


def test_nmf_sketched_runs_and_is_deterministic():
    a = small_matrix()
    cfg = SolverConfig(algorithm="mu", max_iter=100, backend="sketched")
    r1 = nmfx_torch.nmf(a, 2, seed=3, solver_cfg=cfg, device="cpu")
    r2 = nmfx_torch.nmf(a, 2, seed=3, solver_cfg=cfg, device="cpu")
    assert r1.w.numpy().tobytes() == r2.w.numpy().tobytes()
    ref = nmfx.nmf(a, 2, seed=3, solver_cfg=nmfx.SolverConfig(
        algorithm="mu", max_iter=100, backend="sketched"))
    assert r1.iterations == int(ref.iterations)
    np.testing.assert_allclose(float(r1.dnorm), float(ref.dnorm), rtol=1e-4)
    with pytest.raises(ValueError, match="no pool"):
        nmfx_torch.nmf(a, 2, device="cpu", solver_cfg=SolverConfig(
            algorithm="mu", screen=True, screen_keep=2))


def test_screened_stop_reason_value_is_stable():
    assert int(StopReason.SCREENED) == 6 == int(
        nmfx.solvers.base.StopReason.SCREENED)
    assert int(StopReason.NUMERIC_FAULT) == 5


# -- the command line ---------------------------------------------------
@pytest.mark.parametrize("argv", [
    ["--backend", "sketched", "--algorithm", "als"],
    ["--screen"],
    ["--screen", "--screen-keep", "2", "--algorithm", "kl"],
    ["--screen", "--screen-keep", "2", "--backend", "packed"],
    ["--screen", "--screen-keep", "0"],
    ["--screen", "--screen-keep", "99"],
    ["--screen", "--screen-keep", "2", "--keep-factors"],
    ["--screen-keep", "2"],
    ["--sketch-dim", "0", "--backend", "sketched"],
    ["--sketch-dim", "4"],
    ["--backend", "sketched", "--rank-selection", "device"],
    ["--backend", "sketched", "--checkpoint-dir", "CK"],
    ["--screen", "--screen-keep", "2", "--serve-smoke"],
    ["--backend", "sketched", "--exec-cache"],
    ["--backend", "sketched", "--grid-exec", "grid"],
    ["--backend", "sketched", "--tile-rows", "16"],
], ids=lambda a: " ".join(a))
def test_cli_usage_errors_match_reference(tmp_path, capsys, argv):
    import nmfx.cli as ncli

    import nmfx_torch.cli as pcli
    from test_torch_cli import _usage_error

    path = _demo_gct(tmp_path)
    argv = [path, "--no-files"] + [x.replace("CK", str(tmp_path / "ck"))
                                   for x in argv]
    ref = _usage_error(ncli.main, argv, capsys)
    got = _usage_error(pcli.main, argv + ["--device", "cpu"], capsys)
    assert got == ref and got[0] == 2, (got, ref)


def _demo_gct(tmp_path):
    from nmfx_torch.io import write_gct

    path = tmp_path / "demo.gct"
    a = two_group_matrix(60, 10, seed=1)
    write_gct(a, str(path), row_names=[f"g{i}" for i in range(60)],
              col_names=[f"s{i}" for i in range(20)])
    return str(path)


@pytest.mark.parametrize("extra", [
    ["--backend", "sketched"], ["--backend", "sketched", "--sketch-dim",
                                "8", "--algorithm", "hals"],
    ["--screen", "--screen-keep", "2"]], ids=lambda a: " ".join(a))
def test_cli_compressed_runs_match_reference(tmp_path, capsys, extra):
    """The same run on both command lines: the same best k, summary
    shape (the quality line under --backend sketched) and memberships."""
    import re

    import nmfx.cli as ncli

    import nmfx_torch.cli as pcli

    path = _demo_gct(tmp_path)
    argv = [path, "--ks", "2-3", "--restarts", "4", "--maxiter", "200",
            "--no-plots", *extra]
    assert ncli.main(argv + ["--outdir", str(tmp_path / "n")]) == 0
    nout = capsys.readouterr().out
    assert pcli.main(argv + ["--outdir", str(tmp_path / "p"),
                             "--device", "cpu"]) == 0
    pout = capsys.readouterr().out
    best = [int(re.search(r"best k = (\d+)", o).group(1))
            for o in (pout, nout)]
    assert best[0] == best[1]
    tagged = "--backend" in extra
    assert ("quality = sketched" in pout) == ("quality = sketched" in nout) \
        == tagged
    from nmfx.io import read_gct

    pm = read_gct(str(tmp_path / "p" / "membership.gct"))
    nm = read_gct(str(tmp_path / "n" / "membership.gct"))
    assert np.array_equal(pm.values[:, 0], nm.values[:, 0])
