"""Float64 on the port, against ``nmfx`` under ``jax_enable_x64`` (one
subprocess for the whole file, since x64 is a process-wide switch):

* the key chain's float64 draws (``random.uniform``, ``random_init``)
  bit-equal to ``jax.random.uniform(..., dtype=float64)``;
* float64 sweeps on the batched restart route (``backend="vmap"``, and
  als under "auto"), on the dense whole grid (mu's default route, kl's
  packed opt-in) give ``nmfx``'s iterations, stop reasons and
  memberships, with factors within 1e-8; ``nmf`` in float64 from a seed
  likewise;
* the hand-written kernels (``backend="pallas"``) refuse float64 with
  ``NotImplementedError``;
* ``restart_factors`` equals ``nmfx.restart_factors`` (float32:
  iterations and stop reason equal, factors to the solver tests' band),
  and ``grouped_matrix`` is bit-equal.
"""

import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import nmfx
import nmfx_torch
from nmfx.datasets import grouped_matrix as ref_grouped
from nmfx_torch import random as trandom
from nmfx_torch.datasets import grouped_matrix, two_group_matrix
from nmfx_torch.init import random_init

SWEEPS = {
    "mu-vmap": dict(algorithm="mu", backend="vmap", max_iter=60),
    "hals-vmap": dict(algorithm="hals", backend="vmap", max_iter=60),
    "als-auto": dict(algorithm="als", max_iter=40),
    # the dense whole grid (mu's default route, kl's packed opt-in)
    "mu-grid": dict(algorithm="mu", max_iter=60),
    "kl-packed": dict(algorithm="kl", backend="packed", max_iter=60),
}
KS, RESTARTS, SEED = (2, 3), 4, 3
DRAWS = [(123, 2, (7, 5), 0.0, 1.0), (5, 9, (3, 40), 0.5, 2.0)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data():
    return grouped_matrix(80, (8, 8), effect=2.0, seed=1)


@pytest.fixture(scope="module")
def reference_x64(tmp_path_factory):
    """nmfx's float64 draws, sweeps and nmf, in one x64 subprocess."""
    out = tmp_path_factory.mktemp("x64") / "ref.npz"
    inp = out.with_name("a.npy")
    np.save(inp, _data())
    code = textwrap.dedent(f"""
        import json
        import jax
        jax.config.update("jax_enable_x64", True)
        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp
        import numpy as np
        import nmfx
        from nmfx.init import random_init
        a = np.load({str(inp)!r})
        res = {{}}
        for i, (seed, fold, shape, lo, hi) in enumerate(
                json.loads({json.dumps(json.dumps(DRAWS))})):
            key = jax.random.fold_in(jax.random.key(seed), fold)
            res[f"draw{{i}}"] = np.asarray(jax.random.uniform(
                key, tuple(shape), jnp.float64, lo, hi))
            w, h = random_init(key, 6, 9, 3, dtype=jnp.float64)
            res[f"init{{i}}/w"], res[f"init{{i}}/h"] = map(np.asarray, (w, h))
        for name, kw in json.loads({json.dumps(json.dumps(SWEEPS))}).items():
            r = nmfx.nmfconsensus(a, ks={KS}, restarts={RESTARTS},
                                  seed={SEED}, use_mesh=False,
                                  solver_cfg=nmfx.SolverConfig(
                                      dtype="float64", **kw))
            for k in {KS}:
                kr = r.per_k[k]
                assert np.asarray(kr.best_w).dtype == np.float64
                for f in ("iterations", "stop_reasons", "membership",
                          "best_w", "best_h", "consensus"):
                    res[f"{{name}}/{{k}}/{{f}}"] = np.asarray(getattr(kr, f))
        from nmfx.datasets import two_group_matrix
        b = nmfx.nmfconsensus(
            two_group_matrix(n_genes=1000, n_per_group=20, seed=123),
            ks=(2, 3, 4, 5), restarts=10, seed=123, use_mesh=False,
            solver_cfg=nmfx.SolverConfig(backend="vmap", dtype="float64"))
        res["bundled/best_k"] = np.array(b.best_k)
        s = nmfx.nmf(a, 2, seed=4, solver_cfg=nmfx.SolverConfig(
            dtype="float64", max_iter=300))
        res["nmf/w"], res["nmf/h"] = np.asarray(s.w), np.asarray(s.h)
        res["nmf/meta"] = np.array([int(s.iterations), int(s.stop_reason)])
        np.savez({str(out)!r}, **res)
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return np.load(out)


@pytest.mark.parametrize("i", range(len(DRAWS)))
def test_float64_draws_bit_equal_to_jax(reference_x64, i):
    seed, fold, shape, lo, hi = DRAWS[i]
    key = trandom.fold_in(trandom.key(seed), fold)
    got = trandom.uniform(key, shape, lo, hi, np.float64)
    want = reference_x64[f"draw{i}"]
    assert got.dtype == want.dtype == np.float64
    assert got.tobytes() == want.tobytes()
    w, h = random_init(key, 6, 9, 3, dtype=np.float64)
    assert w.tobytes() == reference_x64[f"init{i}/w"].tobytes()
    assert h.tobytes() == reference_x64[f"init{i}/h"].tobytes()


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_float64_batched_sweep_matches_reference(reference_x64, name):
    got = nmfx_torch.nmfconsensus(
        _data(), ks=KS, restarts=RESTARTS, seed=SEED, device="cpu",
        solver_cfg=nmfx_torch.SolverConfig(dtype="float64", **SWEEPS[name]))
    for k in KS:
        g = got.per_k[k]
        ref = {f: reference_x64[f"{name}/{k}/{f}"]
               for f in ("iterations", "stop_reasons", "membership",
                         "best_w", "best_h", "consensus")}
        assert np.array_equal(g.iterations, ref["iterations"])
        assert np.array_equal(g.stop_reasons, ref["stop_reasons"])
        assert np.array_equal(g.membership, ref["membership"])
        assert np.asarray(g.best_w).dtype == np.float64
        np.testing.assert_allclose(g.best_w, ref["best_w"], rtol=1e-8,
                                   atol=1e-12)
        np.testing.assert_allclose(g.best_h, ref["best_h"], rtol=1e-8,
                                   atol=1e-12)
        np.testing.assert_allclose(g.consensus, ref["consensus"], atol=1e-6)


def test_float64_nmf_from_a_seed_matches_reference(reference_x64):
    res = nmfx_torch.nmf(_data(), 2, seed=4, device="cpu",
                         solver_cfg=nmfx_torch.SolverConfig(
                             dtype="float64", max_iter=300))
    assert res.w.dtype == torch.float64
    assert [res.iterations, res.stop_reason] == list(
        reference_x64["nmf/meta"])
    np.testing.assert_allclose(res.w.numpy(), reference_x64["nmf/w"],
                               rtol=1e-8, atol=1e-12)


def test_float64_bundled_best_k_is_the_smoke_gate(reference_x64):
    """chip_smoke.py's float64 phase holds the card to nmfx's best k on
    the bundled design (ks 2..5, 10 restarts, seed 123, the batched
    restart route): that constant is nmfx's value."""
    import chip_smoke

    assert int(reference_x64["bundled/best_k"]) == chip_smoke.FLOAT64_BEST_K


@pytest.mark.parametrize("kw,words", [
    (dict(backend="pallas"), "float32"),
    (dict(algorithm="hals", backend="pallas"), "§1 item 4"),
])
def test_float32_only_routes_refuse_float64(kw, words):
    with pytest.raises(NotImplementedError, match=words):
        nmfx_torch.nmfconsensus(
            two_group_matrix(40, 6, seed=0), ks=(2, 3), restarts=2,
            device="cpu",
            solver_cfg=nmfx_torch.SolverConfig(dtype="float64", **kw))


@pytest.mark.parametrize("restart,kw", [(0, dict(max_iter=200)),
                                        (3, dict(max_iter=200)),
                                        (2, dict(algorithm="hals",
                                                 max_iter=100))])
def test_restart_factors_matches_reference(restart, kw):
    a = _data()
    got = nmfx_torch.restart_factors(a, 3, restart, restarts=5, seed=9,
                                     device="cpu", **kw)
    want = nmfx.restart_factors(a, 3, restart, restarts=5, seed=9, **kw)
    assert int(got.iterations) == int(want.iterations)
    assert int(got.stop_reason) == int(want.stop_reason)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w),
                               rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(got.h.numpy(), np.asarray(want.h),
                               rtol=2e-4, atol=1e-4)
    with pytest.raises(ValueError, match="outside"):
        nmfx_torch.restart_factors(a, 3, 5, restarts=5, device="cpu")


@pytest.mark.parametrize("args", [(100, (5, 7, 3)), (60, (10, 10))])
def test_grouped_matrix_bit_equal(args):
    got = grouped_matrix(*args, seed=3)
    assert got.tobytes() == ref_grouped(*args, seed=3).tobytes()
