"""The port's restart-packed mu solver against the reference's
``mu_packed``, both started from the same numpy factors.

The reference runs its Pallas kernels in interpret mode (what
``backend="pallas"`` does off the TPU); the port runs the plain versions
of its kernels on the CPU. Iterations and stop reasons must be equal —
a different stop iteration is a fault to explain, not a tolerance to
widen — and factors and final residuals agree to rtol=1e-4 (float32
products summed in different orders, compounded over the iterations).
"""

import dataclasses

import numpy as np
import pytest
import torch

from nmfx.config import SolverConfig as JSolverConfig
from nmfx.datasets import two_group_matrix
from nmfx.ops.packed_mu import mu_packed as j_mu_packed
from nmfx_torch.convert import factors_from_numpy, solver_config_from_dict
from nmfx_torch.ops.packed_mu import (flip_budget, mu_packed, pack,
                                      padded_rows, unpack_w)
from nmfx_torch.solvers.base import StopReason
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)

CONFIGS = {
    "default": dict(max_iter=300),
    "no_tol_checks": dict(max_iter=300, use_tol_checks=False,
                          stable_checks=20),
    "strict_flips": dict(max_iter=300, class_flip_tol=0.0, stable_checks=20),
    "tol_x": dict(max_iter=300, tol_x=2e-3, stable_checks=400),
    "tail_loop": dict(max_iter=99, check_block=3, stable_checks=10),
    "packed_backend": dict(max_iter=200, stable_checks=15, backend="packed"),
}


def _problem(seed=0, m=203, n_per_group=10, r=5, k=3):
    rng = np.random.default_rng(seed)
    a = two_group_matrix(m, n_per_group, seed=seed).astype(np.float32)
    n = a.shape[1]
    w0s = rng.uniform(0.0, 1.0, (r, m, k)).astype(np.float32)
    h0s = rng.uniform(0.0, 1.0, (r, k, n)).astype(np.float32)
    return a, w0s, h0s


def _both(a, w0s, h0s, **kw):
    kw.setdefault("backend", "pallas")
    jcfg = JSolverConfig(**kw)
    want = j_mu_packed(a, w0s, h0s, jcfg)
    tcfg = solver_config_from_dict(dataclasses.asdict(jcfg))
    got = mu_packed(a, w0s, h0s, tcfg, device="cpu")
    return want, got


def _assert_same_solve(want, got):
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_array_equal(got.stop_reason.numpy(),
                                  np.asarray(want.stop_reason))
    for name in ("wp", "hp", "dnorm"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mu_packed_matches_reference(name):
    a, w0s, h0s = _problem()
    want, got = _both(a, w0s, h0s, **CONFIGS[name])
    _assert_same_solve(want, got)
    assert got.host_syncs >= 1


def test_stop_reasons_are_exercised():
    """The configurations above reach every stop the route has."""
    seen = set()
    a, w0s, h0s = _problem()
    for kw in CONFIGS.values():
        cfg = solver_config_from_dict(dataclasses.asdict(
            JSolverConfig(**{"backend": "pallas", **kw})))
        seen |= set(mu_packed(a, w0s, h0s, cfg,
                              device="cpu").stop_reason.tolist())
    assert {int(StopReason.MAX_ITER), int(StopReason.CLASS_STABLE),
            int(StopReason.TOL_X)} <= seen


def test_nan_lane_is_quarantined_like_the_reference():
    a, w0s, h0s = _problem(seed=1)
    w0s[2, 0, 0] = np.nan
    want, got = _both(a, w0s, h0s, max_iter=120, stable_checks=10)
    _assert_same_solve(want, got)
    assert int(got.stop_reason[2]) == int(StopReason.NUMERIC_FAULT)
    assert int(got.iterations[2]) == 2
    others = [i for i in range(w0s.shape[0]) if i != 2]
    assert torch.isfinite(got.hp.reshape(5, 3, -1)[others]).all()


def test_host_reads_done_flags_once_per_trip():
    a, w0s, h0s = _problem()
    cfg = solver_config_from_dict(dataclasses.asdict(JSolverConfig(
        backend="pallas", max_iter=40, use_class_stop=False,
        use_tol_checks=False, check_block=2)))
    res = mu_packed(a, w0s, h0s, cfg, device="cpu")
    assert res.iterations.tolist() == [40] * 5
    assert res.host_syncs == 40 // 4  # one read per 2 x 2-iteration trip


def test_pack_roundtrip_and_padding():
    _, w0s, h0s = _problem()
    tw, th = factors_from_numpy(w0s, h0s, "cpu")
    wp, hp = pack(tw, th)
    assert torch.equal(unpack_w(wp, 5), tw)
    assert torch.equal(hp.reshape(th.shape), th)
    for m, want in ((203, 208), (512, 512), (513, 528), (5000, 5040)):
        assert padded_rows(m) == want
    assert flip_budget(0.3, 10) == 3


def test_device_none_means_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    a, w0s, h0s = _problem()
    cfg = solver_config_from_dict(dataclasses.asdict(
        JSolverConfig(backend="pallas", max_iter=4)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mu_packed(a, w0s, h0s, cfg)
