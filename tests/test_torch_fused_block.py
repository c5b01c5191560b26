"""The join-the-updates mu block kernel (``fused_updates="fused"``) in
the port against the reference's, on the CPU.

The reference's contract (``tests/test_fused_kernel.py``) is that the
fused order is byte-equal to the phased one. The port holds its fused
route to its phased route bit for bit (on the CPU both run the block
kernel's plain version; on a card ``tests/test_torch_cuda.py`` holds the
two kernels to each other byte for byte), and to the reference's fused
route with EQUAL iterations and stop reasons and factors within
rtol=2e-4, atol=2e-5 (float32 products summed in other orders, the
tolerance of ``tests/test_torch_sched.py``). The kernel's plain version
is held to the reference's fused Pallas kernel in interpret mode within
rtol=2e-5, atol=1e-6, as the phased one is.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmfx
import nmfx_torch
from nmfx.config import ExperimentalConfig, InitConfig, SolverConfig
from nmfx.datasets import grouped_matrix, two_group_matrix
from nmfx.init import initialize
from nmfx.ops.pallas_mu import fused_block_iterations as j_block
from nmfx.ops.sched_mu import mu_sched as j_sched
from nmfx_torch.convert import solver_config_from_dict
from nmfx_torch.ops import fused_mu
from nmfx_torch.ops.sched_mu import mu_sched
from nmfx_torch.solvers.base import StopReason

KS = (4, 3, 2)
R = 5


def _port(cfg):
    return solver_config_from_dict(dataclasses.asdict(cfg))


def _cfg(mode, check_block=1, max_iter=600, **kw):
    return SolverConfig(
        max_iter=max_iter, backend="pallas", check_block=check_block,
        experimental=ExperimentalConfig(fused_updates=mode), **kw)


@pytest.fixture(scope="module")
def jobs():
    """The reference's tests/test_fused_kernel.py fixture."""
    a = jnp.asarray(grouped_matrix(200, (10, 10, 10), effect=2.0, seed=0),
                    jnp.float32)
    k_max = max(KS)
    root = jax.random.key(123)
    w0l, h0l = [], []
    for k in KS:
        keys = jax.random.split(jax.random.fold_in(root, k), R)
        w0s, h0s = jax.vmap(
            lambda kk, k=k: initialize(kk, a, k, InitConfig(),
                                       jnp.float32))(keys)
        w0l.append(jnp.pad(w0s, ((0, 0), (0, 0), (0, k_max - k))))
        h0l.append(jnp.pad(h0s, ((0, 0), (0, k_max - k), (0, 0))))
    return (np.array(a), np.array(jnp.concatenate(w0l)),
            np.array(jnp.concatenate(h0l)))


def _assert_bit_equal(got, want):
    for name in ("iterations", "stop_reason", "w", "h", "dnorm"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name).numpy(),
                                      err_msg=name)


@pytest.mark.parametrize("check_block", [1, 4])
def test_fused_plain_version_matches_pallas_fused_kernel(check_block):
    """The port's fused=True wrapper (its plain version on the CPU)
    against the reference's _fused_block_kernel in interpret mode, with a
    frozen lane and a budget running out mid-launch."""
    rng = np.random.default_rng(7)
    m, n, k, slots = 192, 32, 3, 2
    rk = k * slots
    a, wp, hp = (rng.uniform(0.1, 1.0, s).astype(np.float32)
                 for s in ((m, n), (m, rk), (rk, n)))
    frozen = np.zeros((1, rk), np.float32)
    frozen[0, k:] = 1.0
    budget = np.full((1, rk), 3.0, np.float32)
    kw = dict(k=k, iters=2, check_block=check_block)
    want = j_block(*(jnp.asarray(x) for x in (a, wp, hp, frozen)),
                   fused=True, block_m=64, interpret=True,
                   budget_cols=jnp.asarray(budget) if check_block > 1
                   else None, **kw)
    got = fused_mu.fused_block_iterations(
        *(torch.as_tensor(x) for x in (a, wp, hp, frozen)), fused=True,
        budget_cols=torch.as_tensor(budget) if check_block > 1 else None,
        **kw)
    assert len(got) == len(want) == (7 if check_block > 1 else 6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=1e-6)
    assert torch.equal(got[0][:, k:], torch.as_tensor(wp[:, k:]))
    assert torch.equal(got[1][k:], torch.as_tensor(hp[k:]))


@pytest.mark.parametrize("ncheck", [1, 4])
def test_fused_sched_matches_reference_and_phased(jobs, ncheck):
    a, w0, h0 = jobs
    want = j_sched(jnp.asarray(a), jnp.asarray(w0), jnp.asarray(h0),
                   _cfg("fused", ncheck), slots=6)
    got = mu_sched(a, w0, h0, _port(_cfg("fused", ncheck)), slots=6,
                   device="cpu")
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_array_equal(got.stop_reason.numpy(),
                                  np.asarray(want.stop_reason))
    for name in ("w", "h"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=2e-4, atol=2e-5, err_msg=name)
    phased = mu_sched(a, w0, h0, _port(_cfg("phased", ncheck)), slots=6,
                      device="cpu")
    _assert_bit_equal(got, phased)


def test_fused_max_iter_fence(jobs):
    """A cap crossing mid-launch freezes every lane at exactly max_iter
    with the factors of the phased check-per-trip schedule."""
    a, w0, h0 = jobs
    ref = mu_sched(a, w0, h0, _port(_cfg("phased", 1, max_iter=20)),
                   slots=4, device="cpu")
    got = mu_sched(a, w0, h0, _port(_cfg("fused", 4, max_iter=20)),
                   slots=4, device="cpu")
    assert (got.iterations == 20).all()
    assert (got.stop_reason == int(StopReason.MAX_ITER)).all()
    np.testing.assert_array_equal(got.w.numpy(), ref.w.numpy())
    np.testing.assert_array_equal(got.h.numpy(), ref.h.numpy())


def test_fused_guards(jobs):
    """The mode is fenced off its route, as in the reference; "auto"
    stays on the phased kernel."""
    a, w0, h0 = jobs
    with pytest.raises(ValueError, match="fused_updates"):
        mu_sched(a, w0, h0, _port(_cfg("fused", algorithm="hals")),
                 slots=6, device="cpu")
    with pytest.raises(ValueError, match="fused_updates"):
        mu_sched(a, w0, h0, _port(_cfg("fused", max_iter=601)), slots=6,
                 device="cpu")
    with pytest.raises(ValueError, match="fused_updates"):
        mu_sched(a, w0, h0, dataclasses.replace(
            _port(_cfg("fused")), backend="auto"), slots=6, device="cpu")
    with pytest.raises(ValueError, match="fused_updates"):
        nmfx_torch.ExperimentalConfig(fused_updates="always")
    auto = mu_sched(a, w0, h0, nmfx_torch.SolverConfig(
        max_iter=100, backend="pallas"), slots=6, device="cpu")
    phased = mu_sched(a, w0, h0, _port(_cfg("phased", "auto",
                                            max_iter=100)),
                      slots=6, device="cpu")
    _assert_bit_equal(auto, phased)


def test_fused_config_converts_from_reference():
    jcfg = _cfg("fused", 4)
    cfg = _port(jcfg)
    assert cfg.experimental.fused_updates == "fused"
    assert cfg.check_block == 4 and cfg.backend == "pallas"


def test_fused_sweep_matches_reference_and_phased():
    """nmfconsensus on the fused route: the reference's best k,
    memberships and consensus, and byte-equal to the port's phased
    sweep."""
    a = two_group_matrix(200, 12, seed=3)
    kw = dict(ks=(2, 3), restarts=4, seed=11)
    jcfg = _cfg("fused", "auto", max_iter=200)
    want = nmfx.nmfconsensus(a, solver_cfg=jcfg, use_mesh=False, **kw)
    got = nmfx_torch.nmfconsensus(a, solver_cfg=_port(jcfg), device="cpu",
                                  **kw)
    phased = nmfx_torch.nmfconsensus(
        a, solver_cfg=_port(_cfg("phased", "auto", max_iter=200)),
        device="cpu", **kw)
    assert got.best_k == want.best_k == phased.best_k
    for k in (2, 3):
        g, w, p = got.per_k[k], want.per_k[k], phased.per_k[k]
        np.testing.assert_array_equal(g.iterations, np.asarray(w.iterations))
        np.testing.assert_array_equal(g.stop_reasons,
                                      np.asarray(w.stop_reasons))
        np.testing.assert_array_equal(g.membership, w.membership)
        np.testing.assert_allclose(g.consensus, w.consensus, rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(g.consensus, p.consensus)
        np.testing.assert_array_equal(g.iterations, p.iterations)
