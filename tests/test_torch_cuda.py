"""The hand-written CUDA kernels on a card, against their plain versions.

These tests need a CUDA card and skip without one. The file imports
neither JAX nor nmfx, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: rtol=1e-4, atol=1e-5 — float32 sums of up to a few hundred
non-negative products taken in another order than cuBLAS takes them.
"""

import numpy as np
import pytest
import torch

from nmfx_torch.config import SolverConfig
from nmfx_torch.ops import fused_mu
from nmfx_torch.ops.packed_mu import bd_select, block_diag_mask, mu_packed
from nmfx_torch.solvers.base import StopReason

pytestmark = pytest.mark.cuda

# (m, n, restarts, k, planted zeros, zero_threshold)
CASES = {
    "ragged_m": (203, 24, 4, 3, False, 0.0),
    "rk_not_8": (64, 40, 5, 3, False, 0.0),
    "zeros": (96, 32, 3, 4, True, 0.0),
    "zero_threshold": (80, 16, 2, 4, False, 0.05),
    "wide_k": (300, 70, 2, 17, False, 0.0),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _operands(m, n, r, k, zeros, device):
    rng = np.random.default_rng(0)
    a, wp, hp = (torch.as_tensor(rng.uniform(0.0, 1.0, shape),
                                 dtype=torch.float32, device=device)
                 for shape in ((m, n), (m, r * k), (r * k, n)))
    if zeros:
        a[::7] = 0.0
        a[:, 3] = 0.0
        wp[::5, ::3] = 0.0
        hp[::4, ::5] = 0.0
    return a, wp, hp


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_match_plain_versions(card, case):
    m, n, r, k, zeros, zt = CASES[case]
    a, wp, hp = _operands(m, n, r, k, zeros, card)
    fused_mu.reset_launch_counts()
    h = fused_mu.fused_h_update(a, wp, hp, k=k, zero_threshold=zt)
    want_h = fused_mu.fused_h_update_ref(a, wp, hp, k=k, zero_threshold=zt)
    gh = bd_select(want_h @ want_h.T, block_diag_mask(r, k, card))
    w = fused_mu.fused_w_update(a, wp, want_h, gh, k=k, zero_threshold=zt)
    want_w = fused_mu.fused_w_update_ref(a, wp, want_h, gh, k=k,
                                         zero_threshold=zt)
    torch.cuda.synchronize()
    torch.testing.assert_close(h, want_h, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(w, want_w, rtol=1e-4, atol=1e-5)
    if zeros:
        assert torch.equal(h == 0, want_h == 0)
        assert torch.equal(w == 0, want_w == 0)
    assert fused_mu.LAUNCHES == {"fused_h_update": 1, "fused_w_update": 1}


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    a, wp, hp = _operands(64, 16, 2, 3, False, card)
    with pytest.raises(TypeError, match="float32"):
        fused_mu.fused_h_update(a.double(), wp, hp, k=3)
    with pytest.raises(ValueError, match="contiguous"):
        fused_mu.fused_h_update(a.T.contiguous().T, wp, hp, k=3)
    with pytest.raises(ValueError, match="multiple"):
        fused_mu.fused_h_update(a, wp, hp, k=4)
    with pytest.raises(ValueError, match="not CUDA"):
        fused_mu.fused_w_update(a, wp, hp, torch.zeros(6, 6), k=3)


def test_packed_solve_on_card_matches_cpu(card):
    rng = np.random.default_rng(2)
    a = rng.uniform(0.1, 1.0, (150, 20)).astype(np.float32)
    w0s = rng.uniform(0.0, 1.0, (4, 150, 3)).astype(np.float32)
    h0s = rng.uniform(0.0, 1.0, (4, 3, 20)).astype(np.float32)
    w0s[1, 0, 0] = np.nan
    cfg = SolverConfig(backend="pallas", max_iter=60, stable_checks=10)
    fused_mu.reset_launch_counts()
    got = mu_packed(a, w0s, h0s, cfg, device=card)
    want = mu_packed(a, w0s, h0s, cfg, device="cpu")
    assert torch.equal(got.iterations.cpu(), want.iterations)
    assert torch.equal(got.stop_reason.cpu(), want.stop_reason)
    assert int(got.stop_reason[1]) == int(StopReason.NUMERIC_FAULT)
    torch.testing.assert_close(got.hp.cpu(), want.hp, rtol=1e-3, atol=1e-5)
    assert fused_mu.LAUNCHES["fused_h_update"] == int(got.iterations.max())
