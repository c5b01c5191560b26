"""The port's normal draw against ``jax.random.normal``, and its device
form against the host words.

* ``random.normal`` is ``sqrt(2)·erfinv(u)`` of the threefry uniform on
  [nextafter(-1, 0), 1), with XLA's erfinv polynomials written in torch
  operations. The uniform is bit-equal to JAX's; the polynomial is the
  same but XLA's CPU backend contracts its steps into fused
  multiply-adds and has its own log1p, so values part in the last bits.
  Tolerance: float32, erfinv within 2 ulp of ``lax.erf_inv`` and the
  normal within 2·eps relative plus 1e-6 absolute; float64 (one
  ``jax_enable_x64`` subprocess), within 1e-12 absolute.
* The device form (``random_bits_device`` / ``uniform_device`` /
  ``normal_device``: threefry in int64 torch arithmetic) gives the host's
  numpy words bit for bit, here on the CPU (the card tests hold the
  card's draws to these).
* ``solvers.sketched.sketch_operators`` against ``nmfx``'s, at the
  normal draw's tolerance scaled by 1/√r.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmfx.solvers import sketched as jsk
from nmfx_torch import random as R
from nmfx_torch.solvers import sketched as tsk
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)

EPS32 = float(np.finfo(np.float32).eps)
#: (seed, fold, split count, index): keys reached by the sweep's chain
KEYS = [(0, 2, 1, 0), (7, 3, 4, 2), (123, 10, 50, 49), (2**31 - 1, 5, 3, 1)]
SHAPES = [(1,), (1000,), (40, 61), (3, 5, 7)]


def _keys(seed, fold, num, i):
    jk = jax.random.split(jax.random.fold_in(jax.random.key(seed), fold),
                          num)[i]
    tk = R.split(R.fold_in(R.key(seed), fold), num)[i]
    return jk, tk


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("key", KEYS, ids=str)
def test_normal_float32_matches_jax(key, shape):
    jk, tk = _keys(*key)
    want = np.asarray(jax.random.normal(jk, shape, jnp.float32))
    got = R.normal(tk, shape)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.all(np.abs(got - want)
                  <= 2 * EPS32 * np.abs(want) + 1e-6), np.abs(got - want).max()


@pytest.mark.parametrize("seed", [1, 7, 123])
def test_erfinv_float32_within_two_ulp_of_xla(seed):
    lo, hi = R._normal_bounds(np.float32)
    u = R.uniform(R.key(seed), (50_000,), lo, hi)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(u)))
    got = R.erfinv(torch.from_numpy(u)).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2, np.bincount(ulps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_erfinv_ends_and_zero(dtype):
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    x = torch.tensor([-1.0, 0.0, 1.0, -0.5, 0.5], dtype=dtype)
    y = R.erfinv(x)
    assert y[0] == -np.inf and y[2] == np.inf and y[1] == 0.0
    assert y[3] == -y[4]
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(np.asarray(
        [-0.5, 0.5], np_dt))))
    np.testing.assert_allclose(y[3:].numpy(), want, rtol=4 * EPS32)


def test_normal_float64_matches_jax_x64(tmp_path):
    out = tmp_path / "ref.npz"
    code = textwrap.dedent(f"""
        import json
        import jax
        jax.config.update("jax_enable_x64", True)
        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp
        import numpy as np
        res = {{}}
        for i, (seed, fold, num, j) in enumerate(
                json.loads({json.dumps(json.dumps(KEYS))})):
            k = jax.random.split(jax.random.fold_in(jax.random.key(seed),
                                                    fold), num)[j]
            res[f"n{{i}}"] = np.asarray(jax.random.normal(k, (2000,),
                                                          jnp.float64))
        np.savez({str(out)!r}, **res)
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = np.load(out)
    for i, key in enumerate(KEYS):
        got = R.normal(_keys(*key)[1], (2000,), np.float64)
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, ref[f"n{i}"], rtol=0, atol=1e-12)


@pytest.mark.parametrize("batched", [False, True], ids=["one", "stack"])
@pytest.mark.parametrize("shape", [(1,), (33, 17), (2, 3, 5)], ids=str)
def test_device_words_bit_equal_to_numpy(shape, batched):
    keys = R.split(R.fold_in(R.key(11), 4), 5)
    use = keys if batched else keys[3]
    got32 = R.random_bits_device(use, shape, "cpu", 32).numpy()
    got52 = R.random_bits_device(use, shape, "cpu", 52).numpy()
    for b, kk in enumerate(keys if batched else keys[3:4]):
        idx = b if batched else Ellipsis
        assert np.array_equal(got32[idx].astype(np.uint32),
                              R.random_bits(kk, shape))
        want64 = R.random_bits(kk, shape, 64) >> np.uint64(12)
        assert np.array_equal(got52[idx].astype(np.uint64), want64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_device_uniform_and_normal_bit_equal_to_host(dtype):
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    keys = R.split(R.key(99), 6)
    u = R.uniform_device(keys, (7, 9), -0.25, 3.0, dtype, "cpu").numpy()
    n = R.normal_device(keys, (7, 9), dtype, "cpu").numpy()
    for b, kk in enumerate(keys):
        assert u[b].tobytes() == R.uniform(kk, (7, 9), -0.25, 3.0,
                                           np_dt).tobytes()
        assert n[b].tobytes() == R.normal(kk, (7, 9), np_dt).tobytes()
    one = R.normal_device(keys[2], (7, 9), dtype, "cpu").numpy()
    assert one.tobytes() == n[2].tobytes()


@pytest.mark.parametrize("m,n,r", [(60, 24, 24), (200, 30, 12),
                                   (1000, 40, 40)])
def test_sketch_operators_match_reference(m, n, r):
    jkeys = jax.random.split(jax.random.fold_in(jax.random.key(123), 3), 4)
    tkeys = R.split(R.fold_in(R.key(123), 3), 4)
    tl, tr = tsk.sketch_operators(tkeys, m, n, r, torch.float32, "cpu")
    assert tl.shape == (4, r, m) and tr.shape == (4, n, r)
    scale = 1.0 / np.sqrt(r)
    for i in range(4):
        jl, jr = jsk.sketch_operators(jkeys[i], m, n, r, jnp.float32)
        for got, want in ((tl[i].numpy(), np.asarray(jl)),
                          (tr[i].numpy(), np.asarray(jr))):
            assert np.all(np.abs(got - want) <= 4 * EPS32 * np.abs(want)
                          + 1e-6 * scale)
    one_l, one_r = tsk.sketch_operators(tkeys[1], m, n, r, torch.float32,
                                        "cpu")
    assert torch.equal(one_l, tl[1]) and torch.equal(one_r, tr[1])
