"""The port's threefry key chain and initializers against the reference.

``nmfx_torch.random`` reimplements JAX's partitionable threefry2x32 in
numpy; the initial factors must equal the reference's bit for bit, so
both packages start every restart from the same point.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmfx.config import InitConfig as JInitConfig
from nmfx.init import initialize, nndsvd_init as j_nndsvd
from nmfx_torch import random as R
from nmfx_torch.config import InitConfig
from nmfx_torch.init import nndsvd_init, random_init, restart_inits


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 123, 2**31 - 1])
def test_key_fold_in_split_match_jax(seed):
    root = jax.random.key(seed)
    assert np.array_equal(np.asarray(jax.random.key_data(root)), R.key(seed))
    for k in (2, 3, 10):
        jf = jax.random.fold_in(root, k)
        tf = R.fold_in(R.key(seed), k)
        assert np.array_equal(np.asarray(jax.random.key_data(jf)), tf)
        for num in (1, 2, 7):
            assert np.array_equal(
                np.asarray(jax.random.key_data(jax.random.split(jf, num))),
                R.split(tf, num))


@pytest.mark.parametrize("shape", [(1,), (13, 5), (4, 3, 2)])
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (0.25, 3.0)])
def test_uniform_matches_jax_bitwise(shape, bounds):
    jk = jax.random.split(jax.random.fold_in(jax.random.key(7), 4), 3)[2]
    tk = R.split(R.fold_in(R.key(7), 4), 3)[2]
    want = jax.random.uniform(jk, shape, jnp.float32, *bounds)
    got = R.uniform(tk, shape, *bounds)
    assert got.dtype == np.float32
    assert np.array_equal(_bits(want), _bits(got))


@pytest.mark.parametrize("seed,k,r", [(123, 2, 4), (5, 3, 6), (0, 4, 1)])
def test_sweep_key_chain_initial_factors_bitwise(seed, k, r):
    """fold_in(key(seed), k) → split(·, R) → random_init, as the sweep
    draws each rank's restarts (nmfx/sweep.py fold_in + split)."""
    m, n = 37, 11
    a = np.random.default_rng(seed).uniform(0, 1, (m, n)).astype(np.float32)
    keys = jax.random.split(jax.random.fold_in(jax.random.key(seed), k), r)
    jw, jh = jax.vmap(lambda kk: initialize(
        kk, jnp.asarray(a), k, JInitConfig(), jnp.float32))(keys)
    tkeys = R.split(R.fold_in(R.key(seed), k), r)
    tw, th = restart_inits(torch.as_tensor(a), tkeys, k, InitConfig())
    assert tw.shape == (r, m, k) and th.shape == (r, k, n)
    assert np.array_equal(_bits(jw), _bits(tw.numpy()))
    assert np.array_equal(_bits(jh), _bits(th.numpy()))
    w0, h0 = random_init(tkeys[0], m, n, k)
    assert np.array_equal(_bits(w0), _bits(jw[0]))
    assert np.array_equal(_bits(h0), _bits(jh[0]))


@pytest.mark.parametrize("k", [1, 2, 4])
def test_nndsvd_matches_reference(k):
    """Dense-SVD NNDSVD; the ± split is sign-invariant, so the two SVD
    implementations agree to f32 tolerance (rtol 1e-4: the SVDs differ
    in their last bits)."""
    a = np.random.default_rng(k).uniform(0, 1, (30, 12)).astype(np.float32)
    jw, jh = j_nndsvd(jnp.asarray(a), k)
    tw, th = nndsvd_init(torch.as_tensor(a), k)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-5)
