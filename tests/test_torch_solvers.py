"""The port's six other solvers — als, neals, snmf, kl, pg and alspg — one
restart at a time, against nmfx.

* float64: ``nmfx.solve`` (run once in a subprocess with
  ``jax_enable_x64``, a process-wide switch) from the same factors: equal
  iterations and stop reasons, factors to rtol 1e-8 (atol 1e-12).
* numpy: the float64 transliterations of ``tests/test_golden.py`` for a
  few iterations, rtol 1e-8.
* ``nmf()`` from a seed in float32 against ``nmfx.nmf``: equal iterations
  and stop reasons, factors to rtol 2e-4 / atol 1e-4.
* the pieces: the jittered Cholesky (a failed factorization gives a NaN
  lane, not an exception), the minimum-norm least squares, the KL
  divergence, and the new config fields through ``convert``.
"""

import dataclasses
import json
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmfx
import nmfx_torch
from nmfx.datasets import grouped_matrix
from nmfx_torch.convert import solver_config_from_dict
from nmfx_torch.solvers.als import lstsq_min_norm
from nmfx_torch.solvers.base import solve, solve_gram_reg
from test_golden import (_als_numpy, _alspg_numpy, _kl_numpy, _neals_numpy,
                         _pg_numpy, _problem, _snmf_numpy,
                         _solve_gram_reg_numpy)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's solves: the problems are small,
    and the suite runs several worker processes on the same cores, where
    a thread pool per process oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


OTHER = ("als", "neals", "snmf", "kl", "pg", "alspg")
#: float64 single-restart cases: (config, which inputs)
SOLVES = {
    "als": (dict(algorithm="als", max_iter=400), "grouped"),
    "neals": (dict(algorithm="neals", max_iter=400), "grouped"),
    "snmf": (dict(algorithm="snmf", max_iter=400), "grouped"),
    "snmf_beta_eta": (dict(algorithm="snmf", max_iter=400,
                           sparsity_beta=0.5, ridge_eta=2.0), "grouped"),
    "kl": (dict(algorithm="kl", max_iter=400), "grouped"),
    "pg": (dict(algorithm="pg", max_iter=60), "grouped"),
    "pg_tol": (dict(algorithm="pg", max_iter=60, tol_pg=0.05), "grouped"),
    "alspg": (dict(algorithm="alspg", max_iter=60), "grouped"),
    "alspg_sub": (dict(algorithm="alspg", max_iter=30, sub_max_iter=5,
                       ls_max_steps=4), "grouped"),
    # duplicate W columns: min-norm least squares keeps als finite
    "als_rank_deficient": (dict(algorithm="als", max_iter=40), "deficient"),
}


def _inputs(which):
    if which == "grouped":
        a = grouped_matrix(200, (10, 10, 10), effect=2.0, seed=0)
        rng = np.random.default_rng(0)
        return a, rng.uniform(0, 1, (200, 3)), rng.uniform(0, 1, (3, 30))
    rng = np.random.default_rng(2)
    m, n, k = 40, 15, 3
    a = rng.uniform(0.5, 1.5, (m, k)) @ rng.uniform(0.5, 1.5, (k, n))
    w0 = np.repeat(rng.uniform(0.1, 1.0, (m, 1)), k, axis=1)
    return a, w0, rng.uniform(0.1, 1.0, (k, n))


@pytest.fixture(scope="module")
def reference_float64(tmp_path_factory):
    """nmfx's float64 solves of SOLVES, in one subprocess."""
    out = tmp_path_factory.mktemp("x64") / "ref.npz"
    inputs = out.with_name("inputs.npz")
    np.savez(inputs, **{f"{w}/{i}": x for w in ("grouped", "deficient")
                        for i, x in zip("awh", _inputs(w))})
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
        for name, (kw, which) in json.loads(
                {json.dumps(json.dumps(SOLVES))}).items():
            a, w0, h0 = (jnp.asarray(x[f"{{which}}/{{i}}"]) for i in "awh")
            r = solve(a, w0, h0, SolverConfig(dtype="float64", **kw))
            assert r.w.dtype == jnp.float64
            res[name + "/w"] = np.asarray(r.w)
            res[name + "/h"] = np.asarray(r.h)
            res[name + "/meta"] = np.array([int(r.iterations),
                                            int(r.stop_reason)])
            res[name + "/dnorm"] = np.asarray(r.dnorm)
        np.savez({str(out)!r}, **res)
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return np.load(out)


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_solve_float64_matches_reference(reference_float64, name):
    ref = reference_float64
    kw, which = SOLVES[name]
    a, w0, h0 = _inputs(which)
    got = solve(a, w0, h0, nmfx_torch.SolverConfig(dtype="float64", **kw),
                device="cpu")
    assert got.w.dtype == torch.float64
    assert (got.iterations, got.stop_reason) == tuple(
        ref[name + "/meta"].tolist())
    np.testing.assert_allclose(got.w.numpy(), ref[name + "/w"], rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(got.h.numpy(), ref[name + "/h"], rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(float(got.dnorm), float(ref[name + "/dnorm"]),
                               rtol=1e-10)
    assert np.isfinite(got.w.numpy()).all() and np.isfinite(
        got.h.numpy()).all()


def test_reference_cases_reach_each_stop():
    """The float64 cases cover every stop the six solvers have."""
    seen = set()
    for kw, which in SOLVES.values():
        seen.add(solve(*_inputs(which), nmfx_torch.SolverConfig(
            dtype="float64", **kw), device="cpu").stop_reason)
    assert {int(nmfx_torch.StopReason.MAX_ITER),
            int(nmfx_torch.StopReason.TOL_X),
            int(nmfx_torch.StopReason.TOL_FUN),
            int(nmfx_torch.StopReason.PG_TOL)} <= seen


GOLDEN = {
    "als": (lambda a, w, h: _als_numpy(a, w, h, 10), 5, 10),
    "neals": (lambda a, w, h: _neals_numpy(a, w, h, 8), 17, 8),
    "kl": (lambda a, w, h: _kl_numpy(a, w, h, 25), 9, 25),
    "pg": (lambda a, w, h: _pg_numpy(a, w, h, 6), 31, 6),
    "alspg": (lambda a, w, h: _alspg_numpy(a, w, h, 5), 21, 5),
    "snmf": (lambda a, w, h: _snmf_numpy(a, w, h, 15, 0.05,
                                         float(np.max(a)) ** 2), 17, 15),
}


@pytest.mark.parametrize("algorithm", sorted(GOLDEN))
def test_solve_matches_numpy_transliteration(algorithm):
    """A few iterations in float64 against the reference update math in
    numpy (the same cases as test_golden.py's, there held to float32)."""
    fn, seed, iters = GOLDEN[algorithm]
    a, w0, h0 = _problem(seed=seed)
    w_ref, h_ref = fn(a, w0, h0)
    extra = dict(sparsity_beta=0.05) if algorithm == "snmf" else {}
    cfg = nmfx_torch.SolverConfig(
        algorithm=algorithm, max_iter=iters, use_class_stop=False,
        use_tol_checks=False, tol_pg=0.0, dtype="float64", **extra)
    got = solve(a, w0, h0, cfg, device="cpu")
    assert got.iterations == iters
    np.testing.assert_allclose(got.w.numpy(), w_ref, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(got.h.numpy(), h_ref, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("algorithm", OTHER)
def test_nmf_matches_reference(algorithm):
    """nmf() from a seed, float32: the same key-chain draws and the same
    solve as nmfx.nmf."""
    a = grouped_matrix(120, (8, 8), effect=2.0, seed=1)
    kw = dict(max_iter=30 if algorithm in ("pg", "alspg") else 300)
    want = nmfx.nmf(a, 2, seed=4, algorithm=algorithm, **kw)
    got = nmfx_torch.nmf(a, 2, seed=4, algorithm=algorithm, device="cpu",
                         **kw)
    assert got.iterations == int(want.iterations)
    assert got.stop_reason == int(want.stop_reason)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=2e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got.h.numpy(), np.asarray(want.h), rtol=2e-4,
                               atol=1e-4)


def test_gram_solve_quarantines_a_failed_factorization():
    """A lane whose Gram is not positive definite comes back NaN (JAX's
    Cholesky gives NaN; torch's would raise), the others solve as
    numpy does."""
    rng = np.random.default_rng(3)
    f = rng.uniform(0, 1, (3, 30, 4))
    gram = np.einsum("bmk,bml->bkl", f, f)
    gram[1] = -np.eye(4)
    rhs = rng.uniform(0, 1, (3, 4, 7))
    got = solve_gram_reg(torch.as_tensor(gram), torch.as_tensor(rhs)).numpy()
    assert np.isnan(got[1]).all()
    for lane in (0, 2):
        np.testing.assert_allclose(
            got[lane], _solve_gram_reg_numpy(gram[lane], rhs[lane]),
            rtol=1e-10)


@pytest.mark.parametrize("case", ["full", "zero_column", "duplicate",
                                  "non_finite"])
def test_lstsq_min_norm_matches_reference(case):
    """The SVD minimum-norm solve against the pseudo-inverse and JAX's
    jnp.linalg.lstsq, lane by lane; a non-finite lane gives NaN."""
    rng = np.random.default_rng(5)
    f = rng.uniform(0, 1, (3, 25, 4))
    if case == "zero_column":
        f[1, :, 2] = 0.0
    elif case == "duplicate":
        f[1, :, 3] = f[1, :, 0]
    elif case == "non_finite":
        f[1, 4, 1] = np.nan
    b = rng.uniform(0, 1, (25, 6))
    got = lstsq_min_norm(torch.as_tensor(f), torch.as_tensor(b)).numpy()
    for lane in range(3):
        if case == "non_finite" and lane == 1:
            assert np.isnan(got[lane]).all()
            continue
        np.testing.assert_allclose(got[lane], np.linalg.pinv(f[lane]) @ b,
                                   rtol=1e-9, atol=1e-12)
        want = np.asarray(jnp.linalg.lstsq(jnp.asarray(f[lane], jnp.float32),
                                           jnp.asarray(b, jnp.float32))[0])
        got32 = lstsq_min_norm(torch.as_tensor(f[lane], dtype=torch.float32),
                               torch.as_tensor(b, dtype=torch.float32))
        np.testing.assert_allclose(got32.numpy(), want, rtol=1e-4, atol=1e-5)


def test_kl_divergence_matches_reference():
    from nmfx.solvers.kl import kl_divergence as jkl
    from nmfx_torch.solvers.kl import kl_divergence

    a, w, h = _problem(seed=4)
    a[0, :3] = 0.0
    want = float(jkl(*(jnp.asarray(x, jnp.float32) for x in (a, w, h))))
    got = kl_divergence(*(torch.as_tensor(x, dtype=torch.float32)
                          for x in (a, w, h)))
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    lanes = kl_divergence(torch.as_tensor(a), torch.as_tensor(np.stack([w,
                                                                        w])),
                          torch.as_tensor(np.stack([h, 2 * h])))
    assert lanes.shape == (2,) and float(lanes[1]) > float(lanes[0])


#: every new field at a non-default value
NEW_FIELDS = dict(tol_pg=3e-3, ls_max_steps=7, ls_beta=0.2, ls_sigma=0.05,
                  sub_max_iter=55, sparsity_beta=0.3, ridge_eta=1.5,
                  restart_chunk=4)


@pytest.mark.parametrize("algorithm", OTHER + ("mu", "hals"))
def test_solver_config_round_trips_the_new_fields(algorithm):
    jcfg = nmfx.SolverConfig(algorithm=algorithm, **NEW_FIELDS)
    d = dataclasses.asdict(jcfg)
    got = dataclasses.asdict(solver_config_from_dict(d))
    for name in NEW_FIELDS:
        assert got[name] == d[name], name
    assert got["algorithm"] == algorithm


@pytest.mark.parametrize("kw", [
    dict(sparsity_beta=-0.1), dict(ridge_eta=-1.0), dict(restart_chunk=0),
    dict(algorithm="pg", backend="packed"),
    dict(algorithm="alspg", backend="packed"),
    dict(algorithm="kl", backend="pallas"),
])
def test_solver_config_validates_as_the_reference(kw):
    with pytest.raises(ValueError):
        nmfx.SolverConfig(**kw)
    with pytest.raises(ValueError):
        nmfx_torch.SolverConfig(**kw)
