"""The kernels' options against the reference's, on the CPU: bf16
operands (``matmul_precision="bfloat16"``) in rows 1-5, bf16 pool
factors (``factor_dtype``) in rows 3-5, segment ids in rows 3-4,
``alias_io`` and ``block_m``, then the scheduler and the sweep under
each option, the scheduler's preconditions and the settings that stay
refused.

The reference runs its Pallas kernels in interpret mode; the port runs
its kernels' plain versions (what its wrappers run on CPU tensors). Both
start from the same numpy inputs. Tolerances:

* bf16 operands, mu rows: rtol=1e-4, atol=1e-6 — the same bf16-rounded
  operands, float32 sums in other orders, 1 to 4 iterations;
* bf16 operands, HALS (row 5): rtol=1e-4, atol=1e-5, the float32 HALS
  kernel's own tolerance (each sweep step divides by a Gram diagonal);
* bf16 pool factors, one launch: rtol=8e-3 (one bf16 ulp: a stored
  factor that lands the other side of a rounding boundary moves by one
  ulp), the stats and the unrounded Grams with it;
* segment ids: the mu block tolerance, rtol=2e-5, atol=1e-6;
* ``alias_io`` and ``block_m``: byte-equal to the default in the port,
  within rtol=1e-5 of the reference;
* schedules: EQUAL iterations and stop reasons, factors within
  rtol=2e-4, atol=5e-5 (the reference's own scheduler tests).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmfx
import nmfx_torch
import nmfx_torch.autotune  # noqa: F401 (nmfx_torch.autotune below)
from nmfx.config import ExperimentalConfig, SolverConfig
from nmfx.datasets import two_group_matrix
from nmfx.ops import pallas_mu as jk
from nmfx.ops.sched_mu import mu_sched as j_sched
from nmfx_torch.convert import solver_config_from_dict
from nmfx_torch.ops import fused_mu
from nmfx_torch.ops.sched_mu import (_pallas_block_geometry, _ragged_layout,
                                     mu_sched,
                                     ragged_estimates_from_iterations)
from nmfx_torch.solvers.base import solve

from test_torch_sched import JOB_KS, jobs  # noqa: F401  (the fixture)
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)

BF16 = "bfloat16"


def _port(cfg):
    return solver_config_from_dict(dataclasses.asdict(cfg))


def _operands(m=192, n=32, k=3, slots=2, seed=0):
    rng = np.random.default_rng(seed)
    rk = k * slots
    a, wp, hp = (rng.uniform(0.0, 1.0, s).astype(np.float32)
                 for s in ((m, n), (m, rk), (rk, n)))
    wp[:, k - 1] = 0.0  # a zero-padded component, as a k < k_max job has
    hp[k - 1] = 0.0
    return a, wp, hp


def _close(got, want, rtol, atol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.to(torch.float32).numpy()
        w = np.asarray(jnp.asarray(w, jnp.float32))
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# --- rows 1-2: the per-iteration pair under bf16 operands ----------------

@pytest.mark.parametrize("iters", [1, 4])
def test_pair_bf16_operands_match_pallas(iters):
    """Row 1 (fused_h_update) and row 2 (fused_w_update) under bf16
    operands, chained for 1 or 4 iterations from the same inputs, the
    H-Gram between them given to both as the same matrix."""
    k, r = 3, 2
    a, wp, hp = _operands(m=128, k=k, slots=r)
    bd = np.kron(np.eye(r), np.ones((k, k))).astype(bool)
    jw, jh = jnp.asarray(wp), jnp.asarray(hp)
    tw, th = torch.as_tensor(wp), torch.as_tensor(hp)
    for _ in range(iters):
        jh_new = jk.fused_h_update(jnp.asarray(a), jw, jh, k=k, block_m=64,
                                   matmul_precision=BF16, interpret=True)
        th_new = fused_mu.fused_h_update(torch.as_tensor(a), tw, th, k=k,
                                         matmul_precision=BF16)
        _close([th_new], [jh_new], 1e-4, 1e-6)
        gh = np.where(bd, np.asarray(jh_new) @ np.asarray(jh_new).T, 0.0)
        gh = gh.astype(np.float32)
        jw = jk.fused_w_update(jnp.asarray(a), jw, jh_new, jnp.asarray(gh),
                               block_m=64, matmul_precision=BF16,
                               interpret=True)
        tw = fused_mu.fused_w_update(torch.as_tensor(a), tw, th_new,
                                     torch.as_tensor(gh), k=k,
                                     matmul_precision=BF16)
        _close([tw], [jw], 1e-4, 1e-6)
        jh, th = jh_new, th_new


def test_lane_gram_bf16_rounds_its_operand():
    """lane_gram under bf16 operands is the H-Gram of bf16(Hp), as the
    block kernel's (and the reference's hc = _maybe_cast(hn))."""
    _, _, hp = _operands()
    hp = torch.as_tensor(hp)
    hc = fused_mu.round_bf16(hp)
    want = fused_mu.lane_gram_ref(hc, k=3)
    assert torch.equal(fused_mu.lane_gram(hp, k=3, matmul_precision=BF16),
                       want)
    assert not torch.equal(want, fused_mu.lane_gram(hp, k=3))


# --- rows 3-5: the block kernels under bf16 operands ---------------------

BLOCKS = {"phased": (jk.fused_block_iterations, dict(fused=False)),
          "fused": (jk.fused_block_iterations, dict(fused=True)),
          "hals": (jk.hals_block_iterations, dict(slots=2))}


def _run_block(kernel, check_block=1, fdtype=None, j_extra=None, **kw):
    """One launch of a block kernel from the same inputs through the
    reference (interpret mode) and the port's plain version."""
    k, slots = 3, 2
    rk = k * slots
    a, wp, hp = _operands(k=k, slots=slots)
    frozen = np.zeros((1, rk), np.float32)
    budget = np.full((1, rk), 5.0, np.float32)
    jfn, extra = BLOCKS[kernel]
    port_fn = (fused_mu.hals_block_iterations if kernel == "hals"
               else fused_mu.fused_block_iterations)
    jw, jh = jnp.asarray(wp), jnp.asarray(hp)
    tw, th = torch.as_tensor(wp), torch.as_tensor(hp)
    if fdtype is not None:
        jw, tw = jw.astype(jnp.bfloat16), tw.to(torch.bfloat16)
        if fdtype == "bfloat16":
            jh, th = jh.astype(jnp.bfloat16), th.to(torch.bfloat16)
    fence = check_block > 1
    want = jfn(jnp.asarray(a), jw, jh, jnp.asarray(frozen), k=k, iters=2,
               check_block=check_block, block_m=64, interpret=True,
               budget_cols=jnp.asarray(budget) if fence else None,
               **extra, **(j_extra or {}), **kw)
    got = port_fn(torch.as_tensor(a), tw, th, torch.as_tensor(frozen), k=k,
                  iters=2, check_block=check_block,
                  budget_cols=torch.as_tensor(budget) if fence else None,
                  **extra, **kw)
    return got, want


@pytest.mark.parametrize("check_block", [1, 2])
@pytest.mark.parametrize("kernel", sorted(BLOCKS))
def test_block_bf16_operands_match_pallas(kernel, check_block):
    """2 or 4 iterations of rows 3-5 under bf16 operands, all outputs."""
    got, want = _run_block(kernel, check_block, matmul_precision=BF16)
    rtol, atol = (1e-4, 1e-5) if kernel == "hals" else (1e-4, 1e-6)
    _close(got, want, rtol, atol)
    # the zero-padded component stays exactly zero
    assert (got[0][:, 2] == 0).all() and (got[1][2] == 0).all()


@pytest.mark.parametrize("fdtype", ["bfloat16", "bfloat16_w"])
@pytest.mark.parametrize("kernel", sorted(BLOCKS))
def test_block_factor_dtype_matches_pallas(kernel, fdtype):
    """One launch of rows 3-5 with bf16 pool factors: outputs in the pool
    dtypes, within one bf16 ulp of the reference."""
    got, want = _run_block(kernel, fdtype=fdtype)
    assert got[0].dtype == torch.bfloat16
    assert got[1].dtype == (torch.bfloat16 if fdtype == "bfloat16"
                            else torch.float32)
    _close(got, want, 8e-3, 1e-6)


@pytest.mark.parametrize("kernel", ["phased", "fused"])
def test_block_factor_dtype_uses_the_unrounded_h_gram(kernel):
    """Under "bfloat16" with float32 operands the W half reads the stored
    (rounded) H but its H-Gram is the unrounded H's, as the reference's
    hc = _maybe_cast(hn): a plain version that used the stored H for both
    would differ."""
    a, wp, hp = (torch.as_tensor(x) for x in _operands())
    frozen = torch.zeros((1, 6))
    got = fused_mu.fused_block_iterations(
        a, wp.to(torch.bfloat16), hp.to(torch.bfloat16), frozen, k=3,
        iters=1, fused=kernel == "fused")
    w, h = wp, hp
    w32, h32 = fused_mu.round_bf16(w), fused_mu.round_bf16(h)
    bd = fused_mu._lane_mask(6, 3, "cpu")
    gram = torch.where(bd, w32.T @ w32, 0.0)
    hn = fused_mu._mu_update(h32, w32.T @ a, gram @ h32, 1e-9, 0.0)
    hs = fused_mu.round_bf16(hn)
    gh = torch.where(bd, hn @ hn.T, 0.0)
    wn = fused_mu._mu_update(w32, a @ hs.T, w32 @ gh, 1e-9, 0.0)
    assert torch.equal(got[1].to(torch.float32), hs)
    assert torch.equal(got[0].to(torch.float32), fused_mu.round_bf16(wn))
    # the TolX stats compare the unrounded update with the stored factor
    assert torch.equal(got[4][:, 0], (hn - h32).abs().amax(dim=1))


# --- rows 3-4: segment ids ---------------------------------------------

RAGGED_SEGS = {
    # class-major jobs of widths 4, 4, 3, 2, 2 (the ragged pool's layout)
    "classes": (4, 4, 3, 2, 2),
    # one job of each width 1..5
    "widths": (5, 4, 3, 2, 1),
}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("case", sorted(RAGGED_SEGS))
def test_block_seg_ids_match_pallas(case, fused):
    widths = RAGGED_SEGS[case]
    rk = sum(widths)
    seg = np.repeat(np.arange(len(widths)), widths).astype(np.int32)
    rng = np.random.default_rng(2)
    a, wp, hp = (rng.uniform(0.0, 1.0, s).astype(np.float32)
                 for s in ((160, 24), (160, rk), (rk, 24)))
    frozen = np.zeros((1, rk), np.float32)
    frozen[0, seg == 1] = 1.0  # the second job frozen
    want = jk.fused_block_iterations(
        *(jnp.asarray(x) for x in (a, wp, hp, frozen)), k=max(widths),
        iters=2, block_m=32, interpret=True, seg_ids=jnp.asarray(seg),
        fused=fused)
    got = fused_mu.fused_block_iterations(
        *(torch.as_tensor(x) for x in (a, wp, hp, frozen)), k=max(widths),
        iters=2, seg_ids=seg, fused=fused)
    _close(got, want, 2e-5, 1e-6)
    assert torch.equal(got[0][:, seg == 1], torch.as_tensor(wp[:, seg == 1]))


def test_block_iota_seg_ids_are_the_uniform_pool():
    a, wp, hp = (torch.as_tensor(x) for x in _operands())
    frozen = torch.zeros((1, 6))
    seg = np.arange(6) // 3
    _same(fused_mu.fused_block_iterations(a, wp, hp, frozen, k=3,
                                          seg_ids=seg),
          fused_mu.fused_block_iterations(a, wp, hp, frozen, k=3))


def test_segment_tables():
    start, width, of_col, kmax = fused_mu.segment_tables(
        np.array([0, 0, 0, 1, 1, 2]), "cpu")
    assert start.tolist() == [0, 3, 5] and width.tolist() == [3, 2, 1]
    assert of_col.tolist() == [0, 0, 0, 1, 1, 2] and kmax == 3
    with pytest.raises(ValueError, match="one run"):
        fused_mu.segment_tables(np.array([0, 1, 0]), "cpu")


# --- alias_io and block_m --------------------------------------------

@pytest.mark.parametrize("kernel", sorted(BLOCKS))
def test_alias_io_byte_equal_and_in_place(kernel):
    got, want = _run_block(kernel, check_block=2,
                           j_extra=dict(alias_io=True))
    a, wp, hp = (torch.as_tensor(x) for x in _operands())
    frozen = torch.zeros((1, 6))
    budget = torch.full((1, 6), 5.0)
    fn = (fused_mu.hals_block_iterations if kernel == "hals"
          else fused_mu.fused_block_iterations)
    extra = dict(BLOCKS[kernel][1])
    plain = fn(a, wp, hp, frozen, k=3, iters=2, check_block=2,
               budget_cols=budget, **extra)
    aliased = fn(a, wp, hp, frozen, k=3, iters=2, check_block=2,
                 budget_cols=budget, alias_io=True, **extra)
    assert aliased[0] is wp and aliased[1] is hp
    _same(aliased, plain)
    _close(got, want, 1e-5, 1e-6)


def test_block_m_sets_the_padding_only():
    assert _pallas_block_geometry(5000, 128) == (40, 128, 5120)
    assert _pallas_block_geometry(5000, 256) == (20, 256, 5120)
    assert _pallas_block_geometry(200, 96) == (3, 96, 288)
    assert _pallas_block_geometry(5000) == (10, 512, 5120)


@pytest.mark.parametrize("block_m", [96, 256])
def test_sched_block_m_byte_equal_and_matches_reference(jobs, block_m):
    a, w0, h0 = jobs
    cfg = SolverConfig(max_iter=120, backend="pallas",
                       experimental=ExperimentalConfig(block_m=block_m))
    base = mu_sched(a, w0, h0, _port(dataclasses.replace(
        cfg, experimental=ExperimentalConfig())), slots=4, job_ks=JOB_KS,
        device="cpu")
    got = mu_sched(a, w0, h0, _port(cfg), slots=4, job_ks=JOB_KS,
                   device="cpu")
    for name in ("w", "h", "iterations", "stop_reason"):
        assert torch.equal(getattr(got, name), getattr(base, name)), name
    want = j_sched(jnp.asarray(a), jnp.asarray(w0), jnp.asarray(h0), cfg,
                   slots=4, job_ks=JOB_KS)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_allclose(got.h.numpy(), np.asarray(want.h), rtol=1e-5,
                               atol=1e-6)


def test_sched_alias_io_byte_equal(jobs):
    a, w0, h0 = jobs
    cfgs = [SolverConfig(max_iter=120, backend=backend,
                         algorithm=algorithm, check_block=1,
                         use_tol_checks=algorithm == "mu",
                         experimental=ExperimentalConfig(alias_io=alias))
            for backend, algorithm in (("pallas", "mu"), ("pallas", "hals"))
            for alias in (False, True)]
    for plain, aliased in zip(cfgs[::2], cfgs[1::2]):
        p = mu_sched(a, w0, h0, _port(plain), slots=4, device="cpu")
        q = mu_sched(a, w0, h0, _port(aliased), slots=4, device="cpu")
        for name in ("w", "h", "iterations", "stop_reason"):
            assert torch.equal(getattr(p, name), getattr(q, name)), name


# --- the scheduler under the options ------------------------------------

def _assert_jobs(got, want, rtol=2e-4, atol=5e-5):
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_array_equal(got.stop_reason.numpy(),
                                  np.asarray(want.stop_reason))
    for name in ("w", "h"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("tail", ["auto", None])
def test_ragged_sched_matches_reference_and_uniform(jobs, tail):
    """The class-blocked pool on the reference's mixed-rank jobs: equal
    iterations and stop reasons to the reference's ragged pool and to the
    port's own uniform pool (check-per-trip, as the ragged stage runs)."""
    a, w0, h0 = jobs
    cfg = SolverConfig(max_iter=600, backend="pallas", check_block=1,
                       experimental=ExperimentalConfig(ragged=True))
    want = j_sched(jnp.asarray(a), jnp.asarray(w0), jnp.asarray(h0), cfg,
                   slots=6, tail_slots=tail, job_ks=JOB_KS)
    got = mu_sched(a, w0, h0, _port(cfg), slots=6, tail_slots=tail,
                   job_ks=JOB_KS, device="cpu")
    _assert_jobs(got, want)
    assert len(got.pool_widths) == 2
    assert got.pool_widths == tuple(np.asarray(want.pool_widths).tolist())
    assert got.pool_trips == tuple(np.asarray(want.pool_trips).tolist())
    assert got.pool_lanes == tuple(np.asarray(want.pool_lanes).tolist())
    assert got.host_syncs == sum(got.pool_trips)
    uniform = mu_sched(a, w0, h0, _port(dataclasses.replace(
        cfg, experimental=ExperimentalConfig())), slots=6, tail_slots=tail,
        job_ks=JOB_KS, device="cpu")
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  uniform.iterations.numpy())
    np.testing.assert_array_equal(got.stop_reason.numpy(),
                                  uniform.stop_reason.numpy())


def test_ragged_layout_matches_reference():
    from nmfx.ops.sched_mu import _ragged_layout as j_layout

    job_ks = tuple(k for k in range(10, 1, -1) for _ in range(50))
    for budget in (480, 60, 54):
        got = _ragged_layout(job_ks, budget)
        want = j_layout(job_ks, budget)
        assert [tuple(c) for c in got] == [tuple(c) for c in want]
    est = ragged_estimates_from_iterations((3, 3, 2), [10, 20, 7])
    assert est == ((2, 7.0), (3, 15.0))
    with pytest.raises(ValueError, match="budget"):
        _ragged_layout((4, 3, 2), 8)


@pytest.mark.parametrize("option", ["bf16", "bfloat16", "bfloat16_w",
                                    "bf16-hals", "bf16-fallback"])
def test_sched_options_match_reference(jobs, option):
    a, w0, h0 = jobs
    kw = dict(max_iter=120, backend="pallas")
    if option.startswith("bf16"):
        kw["matmul_precision"] = BF16
    if option == "bf16-hals":
        kw.update(algorithm="hals", use_tol_checks=False)
    if option == "bf16-fallback":
        kw["max_iter"] = 121  # the per-iteration pair (rows 1-2)
    if option.startswith("bfloat16"):
        kw["experimental"] = ExperimentalConfig(factor_dtype=option)
    cfg = SolverConfig(**kw)
    want = j_sched(jnp.asarray(a), jnp.asarray(w0), jnp.asarray(h0), cfg,
                   slots=4, job_ks=JOB_KS)
    got = mu_sched(a, w0, h0, _port(cfg), slots=4, job_ks=JOB_KS,
                   device="cpu")
    assert got.w.dtype == got.h.dtype == torch.float32
    assert torch.isfinite(got.w).all() and torch.isfinite(got.h).all()
    if option.startswith("bfloat16"):
        # labels may freeze at a bf16 fixed point: held as the reference
        # holds its own pool (tests/test_sched_mu.py), not by trajectory
        assert (got.iterations <= cfg.max_iter).all()
        assert set(got.stop_reason.tolist()) <= {0, 1, 2, 3}
        return
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_array_equal(got.stop_reason.numpy(),
                                  np.asarray(want.stop_reason))
    # bf16 operands turn the float32 sums' last-bit differences into
    # whole bf16 ulps (2^-8) wherever an operand sits at a rounding
    # boundary, and 120 iterations carry them on (HALS, ill-conditioned,
    # the most; the fallback's H-Gram also differs: the kernels' is
    # bf16, the reference takes it from XLA, which keeps float32 on the
    # CPU): equal decisions, labels equal (HALS: within the reference's
    # agreement band, here at most 1 % flipped), factors within a few
    # percent
    flipped = np.mean(got.h.argmax(dim=1).numpy()
                      != np.asarray(want.h).argmax(axis=1))
    assert flipped <= (0.01 if option == "bf16-hals" else 0.0)
    np.testing.assert_allclose(got.h.numpy(), np.asarray(want.h), rtol=0.1,
                               atol=5e-3)


# --- the sweep under each option -----------------------------------------

SWEEP_OPTIONS = {
    "bf16-grid": (dict(matmul_precision=BF16), "auto", True),
    "bf16-per-rank": (dict(matmul_precision=BF16), "per_k", True),
    "bf16-hals": (dict(matmul_precision=BF16, algorithm="hals"), "auto",
                  True),
    "ragged": (dict(check_block=1, experimental=ExperimentalConfig(
        ragged=True)), "auto", True),
    "alias_io": (dict(experimental=ExperimentalConfig(alias_io=True)),
                 "auto", True),
    "block_m": (dict(experimental=ExperimentalConfig(block_m=64)), "auto",
                True),
    "bfloat16": (dict(experimental=ExperimentalConfig(
        factor_dtype="bfloat16")), "auto", False),
    "bfloat16_w": (dict(experimental=ExperimentalConfig(
        factor_dtype="bfloat16_w")), "auto", False),
}


@pytest.mark.parametrize("option", sorted(SWEEP_OPTIONS))
def test_sweep_option_matches_reference(option):
    """nmfconsensus under each option on the small sweep input of
    test_torch_sweep.py: the reference's best k, and its memberships
    where the option keeps float32 pool factors."""
    kw, grid_exec, memberships = SWEEP_OPTIONS[option]
    a = two_group_matrix(200, 12, seed=3)
    jcfg = nmfx.SolverConfig(backend="pallas", max_iter=300,
                             stable_checks=30, **kw)
    args = dict(ks=(2, 3), restarts=4, seed=11, grid_exec=grid_exec)
    want = nmfx.nmfconsensus(a, solver_cfg=jcfg, use_mesh=False, **args)
    got = nmfx_torch.nmfconsensus(a, solver_cfg=_port(jcfg), device="cpu",
                                  **args)
    assert got.best_k == want.best_k
    for k in (2, 3):
        assert np.isfinite(got.per_k[k].consensus).all()
        if memberships:
            np.testing.assert_array_equal(got.per_k[k].membership,
                                          want.per_k[k].membership)


# --- preconditions and refusals --------------------------------------

PRECONDITIONS = {
    "ragged-not-pallas": (dict(experimental=ExperimentalConfig(ragged=True)),
                          JOB_KS, "needs backend='pallas', job_ks"),
    "ragged-no-job-ks": (dict(backend="pallas", experimental=(
        ExperimentalConfig(ragged=True))), None, "needs backend='pallas'"),
    "ragged-off-cadence": (dict(backend="pallas", max_iter=121,
                                experimental=ExperimentalConfig(
                                    ragged=True)), JOB_KS,
                           "max_iter a multiple of check_every"),
    "ragged-hals": (dict(backend="pallas", algorithm="hals",
                         experimental=ExperimentalConfig(ragged=True)),
                    JOB_KS, "mu-only"),
    "ragged-check-block": (dict(backend="pallas", check_block=4,
                                experimental=ExperimentalConfig(
                                    ragged=True)), JOB_KS,
                           "check_block > 1 requires the uniform pool"),
    "factor-dtype-dense": (dict(experimental=ExperimentalConfig(
        factor_dtype="bfloat16")), None, "pallas block-kernel pool"),
    "factor-dtype-fallback": (dict(backend="pallas", max_iter=121,
                                   experimental=ExperimentalConfig(
                                       factor_dtype="bfloat16_w")), None,
                              "pallas block-kernel pool"),
    "factor-dtype-ragged": (dict(backend="pallas", check_block=1,
                                 experimental=ExperimentalConfig(
                                     ragged=True, factor_dtype="bfloat16")),
                            JOB_KS, "uniform \\(non-ragged\\) pool"),
    "alias-dense": (dict(experimental=ExperimentalConfig(alias_io=True)),
                    None, "alias_io=True is the uniform pallas"),
    "alias-ragged": (dict(backend="pallas", check_block=1,
                          experimental=ExperimentalConfig(ragged=True,
                                                          alias_io=True)),
                     JOB_KS, "alias_io=True is the uniform pallas"),
    "fused-ragged": (dict(backend="pallas", check_block=1,
                          experimental=ExperimentalConfig(
                              ragged=True, fused_updates="fused")), JOB_KS,
                     "non-ragged"),
    "block-m-dense": (dict(experimental=ExperimentalConfig(block_m=64)),
                      None, "tile-shape override"),
}


@pytest.mark.parametrize("case", sorted(PRECONDITIONS))
def test_sched_preconditions_raise_as_the_reference(jobs, case):
    kw, job_ks, words = PRECONDITIONS[case]
    a, w0, h0 = jobs
    cfg = SolverConfig(**kw)
    with pytest.raises(ValueError, match=words):
        j_sched(jnp.asarray(a), jnp.asarray(w0), jnp.asarray(h0), cfg,
                slots=4, job_ks=job_ks)
    with pytest.raises(ValueError, match=words):
        mu_sched(a, w0, h0, _port(cfg), slots=4, job_ks=job_ks,
                 device="cpu")


STILL_REFUSED = {
    # the autotuner runs since it was ported (None): its config is
    # taken and resolves, as the reference's does
    "autotune": (lambda: nmfx_torch.autotune.resolve(
        nmfx_torch.SolverConfig(backend="pallas", max_iter=40,
                                experimental=nmfx_torch.ExperimentalConfig(
                                    autotune="on")),
        64, 32, 2, 2, device="cpu"), None),
    # bf16 operands run on every route now; on the kernels float64 stays
    # refused under them too
    "bf16-dense-grid": (lambda: nmfx_torch.nmfconsensus(
        two_group_matrix(40, 6, seed=0), ks=(2, 3), restarts=2,
        solver_cfg=nmfx_torch.SolverConfig(matmul_precision=BF16,
                                           backend="pallas",
                                           dtype="float64"),
        device="cpu"), "§1 item 4"),
    # the grid axes and serving meshes run since they were ported, as
    # in the reference (None: the call returns; the case names are kept)
    "grid-axes-mesh": (lambda: nmfx_torch.nmfconsensus(
        two_group_matrix(40, 6, seed=0), ks=(2,), restarts=2,
        mesh=nmfx_torch.grid_mesh(1, 2, devices=["cpu"] * 2)), None),
    "serving-mesh": (lambda: nmfx_torch.ExecCache(device="cpu").executable(
        (40, 12), nmfx_torch.ConsensusConfig(ks=(2,), restarts=2),
        nmfx_torch.SolverConfig(), mesh=nmfx_torch.grid_mesh(
            2, devices=["cpu"] * 2)), None),
    # float64 runs on every plain-product route now; the kernels refuse
    "float64-batched": (lambda: nmfx_torch.nmfconsensus(
        two_group_matrix(40, 6, seed=0), ks=(2,), restarts=2,
        solver_cfg=nmfx_torch.SolverConfig(dtype="float64",
                                           backend="pallas"),
        device="cpu"), "§1 item 4"),
}


@pytest.mark.parametrize("case", sorted(STILL_REFUSED))
def test_unported_settings_still_name_their_roadmap_item(case):
    fn, item = STILL_REFUSED[case]
    if item is None:
        out = fn()
        if case == "grid-axes-mesh":  # the reference's best k on it
            assert out.best_k == 2
        elif case == "autotune":  # resolved: explicit, flag off
            nmfx.ExperimentalConfig(autotune="on")
            assert out.experimental.autotune == "off"
            assert out.check_block in (1, 4)
            assert out.experimental.block_m in (256, 512)
        else:  # built now, not a hit
            assert out[1] is False and callable(out[0].fn)
        return
    with pytest.raises(NotImplementedError, match=item):
        fn()
