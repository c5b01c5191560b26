"""The fused MU half-updates: the port's plain versions against the
reference's Pallas kernels in interpret mode, the masked H-Gram against
the reference's bd_select, the pair against one block iteration, and the
CPU dispatch of the wrappers (the kernels themselves:
tests/test_torch_cuda.py).

Tolerance: float32 with rtol=1e-5, atol=1e-6 — the same products summed
in another order (interpret-mode tile accumulation vs one CPU GEMM);
rtol=1e-4 for the H-Gram (XLA's and torch's CPU GEMMs); the pair against
the block iteration exactly (the same operations).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmfx.ops import pallas_mu
from nmfx.ops.packed_mu import bd_select as j_bd_select
from nmfx.ops.packed_mu import block_diag_mask as j_block_diag_mask
from nmfx_torch.ops import fused_mu
from nmfx_torch.ops.packed_mu import (bd_select, block_diag_mask,
                                      padded_rows)

RTOL, ATOL = 1e-5, 1e-6

# (m, n, restarts, k, block_m, planted zeros, zero_threshold)
CASES = {
    # ragged m, padded the way mu_packed pads it (two 104-row tiles)
    "ragged_m": (203, 24, 4, 3, 104, False, 0.0),
    # rk = 15, not a multiple of 8
    "rk_not_8": (64, 40, 5, 3, 64, False, 0.0),
    "zeros": (96, 32, 3, 4, 48, True, 0.0),
    "zero_threshold": (80, 16, 2, 4, 40, False, 0.05),
}


def _operands(m, n, r, k, zeros, seed=0):
    rng = np.random.default_rng(seed)
    m_pad = padded_rows(m)
    a = np.zeros((m_pad, n), np.float32)
    wp = np.zeros((m_pad, r * k), np.float32)
    a[:m] = rng.uniform(0.0, 1.0, (m, n))
    wp[:m] = rng.uniform(0.0, 1.0, (m, r * k))
    hp = rng.uniform(0.0, 1.0, (r * k, n)).astype(np.float32)
    if zeros:
        a[::7] = 0.0
        a[:, 3] = 0.0
        wp[::5, ::3] = 0.0
        hp[::4, ::5] = 0.0
    return a, wp, hp


@pytest.mark.parametrize("case", sorted(CASES))
def test_h_update_ref_matches_pallas_interpret(case):
    m, n, r, k, block_m, zeros, zt = CASES[case]
    a, wp, hp = _operands(m, n, r, k, zeros)
    assert a.shape[0] % block_m == 0
    want = pallas_mu.fused_h_update(
        jnp.asarray(a), jnp.asarray(wp), jnp.asarray(hp), k=k,
        block_m=block_m, zero_threshold=zt, interpret=True)
    got = fused_mu.fused_h_update_ref(
        torch.as_tensor(a), torch.as_tensor(wp), torch.as_tensor(hp), k=k,
        zero_threshold=zt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert np.array_equal(got.numpy() == 0, np.asarray(want) == 0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_w_update_ref_matches_pallas_interpret(case):
    m, n, r, k, block_m, zeros, zt = CASES[case]
    a, wp, hp = _operands(m, n, r, k, zeros, seed=1)
    jgh = j_bd_select(jnp.asarray(hp) @ jnp.asarray(hp).T,
                      j_block_diag_mask(r, k, jnp.float32))
    want = pallas_mu.fused_w_update(
        jnp.asarray(a), jnp.asarray(wp), jnp.asarray(hp), jgh,
        block_m=block_m, zero_threshold=zt, interpret=True)
    th = torch.as_tensor(hp)
    gh = bd_select(th @ th.T, block_diag_mask(r, k, "cpu"))
    got = fused_mu.fused_w_update_ref(
        torch.as_tensor(a), torch.as_tensor(wp), th, gh, k=k,
        zero_threshold=zt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert np.array_equal(got.numpy() == 0, np.asarray(want) == 0)


def test_cpu_wrappers_run_plain_versions_without_launching():
    a, wp, hp = (torch.as_tensor(x) for x in _operands(40, 9, 3, 2, False))
    gh = bd_select(hp @ hp.T, block_diag_mask(3, 2, "cpu"))
    fused_mu.reset_launch_counts()
    h = fused_mu.fused_h_update(a, wp, hp, k=2)
    w = fused_mu.fused_w_update(a, wp, h, gh, k=2)
    assert torch.equal(fused_mu.lane_gram(hp, k=2),
                       fused_mu.lane_gram_ref(hp, k=2))
    frozen = torch.zeros((1, 6))
    blk = fused_mu.fused_block_iterations(a, wp, hp, frozen, k=2)
    assert torch.equal(h, fused_mu.fused_h_update_ref(a, wp, hp, k=2))
    assert torch.equal(w, fused_mu.fused_w_update_ref(a, wp, h, gh, k=2))
    joined = fused_mu.fused_block_iterations(a, wp, hp, frozen, k=2,
                                             fused=True)
    hals = fused_mu.hals_block_iterations(a, wp, hp, frozen, k=2, slots=3)
    for got, want in zip(blk, fused_mu.fused_block_iterations_ref(
            a, wp, hp, frozen, k=2)):
        assert torch.equal(got, want)
    for got, want in zip(joined, blk):
        assert torch.equal(got, want)
    for got, want in zip(hals, fused_mu.hals_block_iterations_ref(
            a, wp, hp, frozen, k=2, slots=3)):
        assert torch.equal(got, want)
    assert set(fused_mu.LAUNCHES) == {
        "fused_h_update", "lane_gram", "fused_w_update",
        "fused_block_iterations", "fused_block_iterations_fused",
        "hals_block_iterations"}
    assert all(count == 0 for count in fused_mu.LAUNCHES.values())


@pytest.mark.parametrize("case", sorted(CASES))
def test_lane_gram_ref_matches_bd_select(case):
    """The plain lane_gram's blocks, laid out block-diagonally, against
    the reference's masked H-Gram bd_select(Hp·Hpᵀ)."""
    m, n, r, k, _, zeros, _ = CASES[case]
    hp = _operands(m, n, r, k, zeros, seed=2)[2]
    want = j_bd_select(jnp.asarray(hp) @ jnp.asarray(hp).T,
                       j_block_diag_mask(r, k, jnp.float32))
    got = fused_mu.lane_gram_ref(torch.as_tensor(hp), k=k)
    assert got.shape == (r, k, k) and got.is_contiguous()
    np.testing.assert_allclose(torch.block_diag(*got).numpy(),
                               np.asarray(want), rtol=1e-4, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("gram", ["lane", "dense"])
def test_pair_equals_one_block_iteration(case, gram):
    """fused_h_update, the masked H-Gram (lane_gram's per-lane blocks or
    the reference's dense bd_select form), then fused_w_update, through
    the CPU wrappers: every bit of Hp and Wp equal to one iteration of
    the plain block with no lane frozen."""
    m, n, r, k, _, zeros, zt = CASES[case]
    a, wp, hp = (torch.as_tensor(x)
                 for x in _operands(m, n, r, k, zeros, seed=3))
    kw = dict(k=k, zero_threshold=zt)
    h = fused_mu.fused_h_update(a, wp, hp, **kw)
    gh = (fused_mu.lane_gram(h, k=k) if gram == "lane"
          else bd_select(h @ h.T, block_diag_mask(r, k, "cpu")))
    w = fused_mu.fused_w_update(a, wp, h, gh, **kw)
    want = fused_mu.fused_block_iterations_ref(
        a, wp, hp, torch.zeros((1, r * k)), iters=1, **kw)
    assert torch.equal(h, want[1])
    assert torch.equal(w, want[0])


@pytest.mark.parametrize("m,n,rk,k", [(5000, 500, 500, 10),
                                      (5040, 500, 150, 3),
                                      (17, 3, 2, 1), (1237, 77, 39, 3)])
def test_pair_workspace_is_one_block_iteration(m, n, rk, k):
    """The H half's partials come in SPLIT_ROWS-row chunks whatever the
    card: the shapes of the block kernel's part and gpart, from m, n,
    rk and k alone."""
    part, gpart = fused_mu.pair_workspace(m, n, rk, k)
    assert (part, gpart) == fused_mu.mu_block_workspace(m, n, rk, k)[2:4]
    splits = part[0]
    assert (splits - 1) * fused_mu.SPLIT_ROWS < m <= (
        splits * fused_mu.SPLIT_ROWS)
    assert part[1:] == (rk, n) and gpart == (splits, rk // k, k, k)

