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

from nmfx_torch.config import InitConfig, SolverConfig
from nmfx_torch.ops import fused_mu
from nmfx_torch.ops.packed_mu import bd_select, block_diag_mask, mu_packed
from nmfx_torch.solvers.base import StopReason


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the host side of these cases (the same
    pin as ``test_torch_solvers._one_torch_thread``, defined here because
    this file runs on the card with ``--noconftest``, where the other
    test modules' reference imports are not available)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    assert fused_mu.LAUNCHES == {"fused_h_update": 1, "lane_gram": 0,
                                 "fused_w_update": 1,
                                 "fused_block_iterations": 0,
                                 "fused_block_iterations_fused": 0,
                                 "hals_block_iterations": 0}


#: the pair's pools (m, n, restarts, k, planted zeros): the per-rank
#: north star (m padded to 5040 rows, a last 256-row chunk of 176), rk =
#: 150 (rows off 16-byte alignment: 4-byte copies, scalar stores), the
#: ragged 1237 x 77 and planted exact zeros
PAIR_POOLS = {"north_star": (5040, 500, 50, 10, False),
              "rk150": (5040, 500, 50, 3, False),
              "ragged": (1237, 77, 13, 3, False),
              "zeros": (1000, 96, 7, 5, True)}


@pytest.mark.parametrize("pool", sorted(PAIR_POOLS))
def test_pair_byte_equal_to_one_block_iteration(card, pool):
    """fused_h_update, lane_gram, then fused_w_update: Hp and Wp
    byte-equal to one iteration of the phased block kernel with no lane
    frozen (the same kernels on the same chains)."""
    m, n, r, k, zeros = PAIR_POOLS[pool]
    a, wp, hp = _operands(m, n, r, k, zeros, card)
    fused_mu.reset_launch_counts()
    h = fused_mu.fused_h_update(a, wp, hp, k=k)
    w = fused_mu.fused_w_update(a, wp, h, fused_mu.lane_gram(h, k=k), k=k)
    want = fused_mu.fused_block_iterations(
        a, wp, hp, torch.zeros((1, r * k), device=card), k=k, iters=1)
    torch.cuda.synchronize()
    assert torch.equal(h.view(torch.int32), want[1].view(torch.int32))
    assert torch.equal(w.view(torch.int32), want[0].view(torch.int32))
    assert fused_mu.LAUNCHES == {"fused_h_update": 1, "lane_gram": 1,
                                 "fused_w_update": 1,
                                 "fused_block_iterations": 1,
                                 "fused_block_iterations_fused": 0,
                                 "hals_block_iterations": 0}


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


#: the block kernels' pools (m, n, slots, k): m, n and rk off every tile
#: edge; the ragged 1237 x 77 with rk = 35, whose rows are not 16-byte
#: aligned (4-byte copies); and a last 256-row chunk shorter than one
#: 128-row W tile (a cluster CTA with no rows)
BLOCK_POOLS = {"203x37": (203, 37, 5, 3), "1237x77_rk35": (1237, 77, 5, 7),
               "1100x300": (1100, 300, 9, 8)}


def _block_pool(pool, card):
    """A pool with lane 1 frozen, lane 2's budget running out mid-launch
    (3 of 2 x 4 iterations) and lane 0's last component zero-padded."""
    m, n, slots, k = BLOCK_POOLS[pool]
    a, wp, hp = _operands(m, n, slots, k, False, card)
    wp[:, k - 1] = 0.0
    hp[k - 1] = 0.0
    frozen = torch.zeros((1, slots * k), device=card)
    frozen[0, k:2 * k] = 1.0
    budget = torch.full((1, slots * k), 100.0, device=card)
    budget[0, 2 * k:3 * k] = 3.0
    return k, a, wp, hp, frozen, budget


@pytest.mark.parametrize("pool", sorted(BLOCK_POOLS))
@pytest.mark.parametrize("check_block", [1, 4])
def test_block_kernel_matches_plain_version(card, check_block, pool):
    """A ragged pool with a frozen lane, a budget that runs out mid-launch
    and a zero-padded column."""
    k, a, wp, hp, frozen, budget = _block_pool(pool, card)
    kw = dict(k=k, iters=2, check_block=check_block,
              budget_cols=budget if check_block > 1 else None)
    fused_mu.reset_launch_counts()
    got = fused_mu.fused_block_iterations(a, wp, hp, frozen, **kw)
    want = fused_mu.fused_block_iterations_ref(a, wp, hp, frozen, **kw)
    torch.cuda.synchronize()
    assert len(got) == len(want) == (7 if check_block > 1 else 6)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
        assert torch.equal(g == 0, w == 0)
    assert torch.equal(got[0][:, k:2 * k], wp[:, k:2 * k])
    assert torch.equal(got[1][k:2 * k], hp[k:2 * k])
    assert fused_mu.LAUNCHES["fused_block_iterations"] == 1


def test_whole_grid_on_card_matches_cpu(card):
    """The pallas slot scheduler on the block kernel against its plain
    versions on the CPU: the same iterations, stop reasons and labels."""
    from nmfx_torch.datasets import two_group_matrix
    from nmfx_torch.ops.sched_mu import mu_sched

    rng = np.random.default_rng(4)
    a = two_group_matrix(n_genes=200, n_per_group=12, seed=3)
    k_max, ks = 3, (3, 3, 3, 2, 2, 2)
    w0 = rng.uniform(0.0, 1.0, (len(ks), 200, k_max)).astype(np.float32)
    h0 = rng.uniform(0.0, 1.0, (len(ks), k_max, 24)).astype(np.float32)
    for j, k in enumerate(ks):
        w0[j, :, k:] = 0.0
        h0[j, k:] = 0.0
    cfg = SolverConfig(backend="pallas", max_iter=200)
    fused_mu.reset_launch_counts()
    got = mu_sched(a, w0, h0, cfg, slots=4, job_ks=ks, device=card)
    want = mu_sched(a, w0, h0, cfg, slots=4, job_ks=ks, device="cpu")
    assert torch.equal(got.iterations.cpu(), want.iterations)
    assert torch.equal(got.stop_reason.cpu(), want.stop_reason)
    assert torch.equal(got.h.cpu().argmax(dim=1), want.h.argmax(dim=1))
    torch.testing.assert_close(got.h.cpu(), want.h, rtol=1e-3, atol=1e-5)
    assert (got.h[3:, 2] == 0).all()  # the rank-2 jobs' padded row
    assert fused_mu.LAUNCHES["fused_block_iterations"] == sum(got.pool_trips)


@pytest.mark.parametrize("pool", sorted(BLOCK_POOLS))
@pytest.mark.parametrize("check_block", [1, 4])
def test_fused_block_kernel_byte_equal_to_phased(card, check_block, pool):
    """The join-the-updates order against the phased one on the card:
    every output byte-equal (the same sums in the same order)."""
    k, a, wp, hp, frozen, budget = _block_pool(pool, card)
    kw = dict(k=k, iters=2, check_block=check_block,
              budget_cols=budget if check_block > 1 else None)
    fused_mu.reset_launch_counts()
    phased = fused_mu.fused_block_iterations(a, wp, hp, frozen, **kw)
    fused = fused_mu.fused_block_iterations(a, wp, hp, frozen, fused=True,
                                            **kw)
    torch.cuda.synchronize()
    assert len(fused) == len(phased)
    for f, p in zip(fused, phased):
        assert torch.equal(f.view(torch.int32), p.view(torch.int32))
    assert fused_mu.LAUNCHES["fused_block_iterations"] == 1
    assert fused_mu.LAUNCHES["fused_block_iterations_fused"] == 1


@pytest.mark.parametrize("kernel", ["phased", "fused", "hals"])
def test_block_kernel_schedule_free(card, kernel):
    """One job's lane in slot 2 of a 5-slot pool and in slot 37 of a
    48-slot pool (other lanes random, some frozen), on the mu block
    kernel in either order or the HALS block kernel: its W columns, H
    rows, stats and snapshots bit-equal. Its budget runs out mid-launch."""
    m, n, k = 1237, 77, 7
    rng = np.random.default_rng(9)
    job_w = rng.uniform(0.0, 1.0, (m, k)).astype(np.float32)
    job_h = rng.uniform(0.0, 1.0, (k, n)).astype(np.float32)
    a = torch.as_tensor(rng.uniform(0.0, 1.0, (m, n)).astype(np.float32),
                        device=card)
    outs = []
    for slots, at in ((5, 2), (48, 37)):
        wp = rng.uniform(0.0, 1.0, (m, slots * k)).astype(np.float32)
        hp = rng.uniform(0.0, 1.0, (slots * k, n)).astype(np.float32)
        wp[:, at * k:(at + 1) * k] = job_w
        hp[at * k:(at + 1) * k] = job_h
        frozen = torch.zeros((1, slots * k), device=card)
        frozen[0, (at - 1) * k:at * k] = 1.0
        budget = torch.full((1, slots * k), 100.0, device=card)
        budget[0, at * k:(at + 1) * k] = 5.0
        operands = (a, torch.as_tensor(wp, device=card),
                    torch.as_tensor(hp, device=card), frozen)
        kw = dict(k=k, iters=2, check_block=4, budget_cols=budget)
        if kernel == "hals":
            got = fused_mu.hals_block_iterations(*operands, slots=slots, **kw)
        else:
            got = fused_mu.fused_block_iterations(
                *operands, fused=kernel == "fused", **kw)
        cols = slice(at * k, (at + 1) * k)
        wpo, hpo, wd, wm, hd, hm, hck = got
        rows = [b * slots * k + at * k + p for b in range(4)
                for p in range(k)]
        outs.append((wpo[:, cols], hpo[cols], wd[:, cols], wm[:, cols],
                     hd[rows], hm[rows], hck[:, cols]))
    torch.cuda.synchronize()
    for x, y in zip(*outs):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.parametrize("check_block", [1, 4])
def test_hals_block_kernel_matches_plain_version(card, check_block):
    """The HALS block kernel on a ragged pool with a frozen lane, a budget
    that runs out mid-launch and a zero-padded component (rtol=1e-4,
    atol=1e-5: at k=3 the sweeps' divisions magnify little)."""
    m, n, slots, k = 203, 37, 5, 3
    a, wp, hp = _operands(m, n, slots, k, False, card)
    wp[:, k - 1] = 0.0
    hp[k - 1] = 0.0
    frozen = torch.zeros((1, slots * k), device=card)
    frozen[0, k:2 * k] = 1.0
    budget = torch.full((1, slots * k), 100.0, device=card)
    budget[0, 2 * k:3 * k] = 3.0
    kw = dict(k=k, slots=slots, iters=2, check_block=check_block,
              budget_cols=budget if check_block > 1 else None)
    fused_mu.reset_launch_counts()
    got = fused_mu.hals_block_iterations(a, wp, hp, frozen, **kw)
    want = fused_mu.hals_block_iterations_ref(a, wp, hp, frozen, **kw)
    torch.cuda.synchronize()
    assert len(got) == len(want) == (7 if check_block > 1 else 6)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    assert torch.equal(got[0][:, k:2 * k], wp[:, k:2 * k])
    assert torch.equal(got[1][k:2 * k], hp[k:2 * k])
    assert (got[0][:, k - 1] == 0).all() and (got[1][k - 1] == 0).all()
    assert fused_mu.LAUNCHES["hals_block_iterations"] == 1


def test_hals_whole_grid_on_card_matches_cpu(card):
    """hals on the pallas slot scheduler (the HALS block kernel) against
    its plain versions on the CPU: the same iterations, stop reasons and
    labels, one launch a trip."""
    from nmfx_torch.datasets import two_group_matrix
    from nmfx_torch.ops.sched_mu import mu_sched

    rng = np.random.default_rng(4)
    a = two_group_matrix(n_genes=200, n_per_group=12, seed=3)
    k_max, ks = 3, (3, 3, 3, 2, 2, 2)
    w0 = rng.uniform(0.0, 1.0, (len(ks), 200, k_max)).astype(np.float32)
    h0 = rng.uniform(0.0, 1.0, (len(ks), k_max, 24)).astype(np.float32)
    for j, k in enumerate(ks):
        w0[j, :, k:] = 0.0
        h0[j, k:] = 0.0
    cfg = SolverConfig(algorithm="hals", backend="pallas", max_iter=200)
    fused_mu.reset_launch_counts()
    got = mu_sched(a, w0, h0, cfg, slots=4, job_ks=ks, device=card)
    want = mu_sched(a, w0, h0, cfg, slots=4, job_ks=ks, device="cpu")
    assert torch.equal(got.iterations.cpu(), want.iterations)
    assert torch.equal(got.stop_reason.cpu(), want.stop_reason)
    assert torch.equal(got.h.cpu().argmax(dim=1), want.h.argmax(dim=1))
    assert (got.h[3:, 2] == 0).all()  # the rank-2 jobs' padded row
    assert fused_mu.LAUNCHES["hals_block_iterations"] == sum(got.pool_trips)


#: every KResult field the streamed harvest must reproduce byte for byte
KRESULT_FIELDS = ("consensus", "rho", "dispersion", "membership", "order",
                  "iterations", "dnorms", "stop_reasons", "best_w", "best_h")


@pytest.mark.parametrize("algorithm,grid_exec", [
    ("mu", "auto"), ("hals", "auto"), ("mu", "per_k")])
def test_streamed_harvest_byte_equal_to_sequential_on_card(card, algorithm,
                                                           grid_exec):
    """Each harvest worker waits on its own rank's event before it reads
    the pinned copies: on a grid whose ranks finish at different trips (5
    slots for 4 ranks of 6 restarts) and per rank, the streamed harvest
    equals the sequential one byte for byte."""
    import nmfx_torch
    from nmfx_torch.datasets import two_group_matrix

    a = two_group_matrix(n_genes=200, n_per_group=12, seed=3)
    kw = dict(ks=(2, 3, 4, 5), restarts=6, seed=5, grid_slots=5,
              grid_exec=grid_exec, device=card,
              solver_cfg=SolverConfig(algorithm=algorithm, backend="pallas",
                                      max_iter=300))
    streamed = nmfx_torch.nmfconsensus(a, **kw)
    sequential = nmfx_torch.nmfconsensus(a, harvest="sequential", **kw)
    for k in kw["ks"]:
        for field in KRESULT_FIELDS:
            s = np.asarray(getattr(streamed.per_k[k], field))
            q = np.asarray(getattr(sequential.per_k[k], field))
            assert s.dtype == q.dtype and s.tobytes() == q.tobytes(), (
                f"k={k} {field}")


@pytest.mark.parametrize("method", ["average", "complete", "single"])
def test_rank_selection_torch_on_card_equals_cpu(card, method):
    """Device rank selection on the card against itself on the CPU: the
    merges are elementwise IEEE operations and first-minimum argmins on
    both, so linkage, cophenetic matrix, order and memberships are equal;
    rho's float32 reductions run in another order (within 1e-6)."""
    from nmfx_torch.ops.hclust import linkage_torch, rank_selection_torch

    rng = np.random.default_rng(7)
    labels = rng.integers(0, 4, (10, 60))
    cons = (labels[:, :, None] == labels[:, None, :]).mean(0)
    cons = torch.as_tensor(cons, dtype=torch.float32)
    dist = torch.where(torch.eye(60, dtype=torch.bool), 0.0, 1.0 - cons)
    got = [x.cpu() for x in linkage_torch(dist.to(card), 3, method)]
    want = linkage_torch(dist, 3, method)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    rho, memb, order = (x.cpu() for x in rank_selection_torch(
        cons.to(card), 3, method))
    rho_c, memb_c, order_c = rank_selection_torch(cons, 3, method)
    assert torch.equal(memb, memb_c) and torch.equal(order, order_c)
    assert abs(float(rho) - float(rho_c)) <= 1e-6


@pytest.mark.parametrize("algorithm,backend", [
    ("als", "auto"), ("neals", "auto"), ("snmf", "auto"), ("kl", "auto"),
    ("pg", "auto"), ("alspg", "auto"), ("mu", "vmap"), ("neals", "packed"),
    ("kl", "packed")])
def test_other_solvers_on_card_match_cpu(card, algorithm, backend):
    """The batched restart route (and, under "packed", the dense whole
    grid) on the card against the CPU at a small input: the same best k
    and k = 2 memberships, finite everywhere. Iterations may part: the
    card's float32 products round in another order, and a TolFun or
    projected-gradient threshold can move a stop by a check."""
    import nmfx_torch
    from nmfx_torch.datasets import two_group_matrix

    a = two_group_matrix(n_genes=200, n_per_group=12, seed=3)
    budget = dict(max_iter=60) if algorithm in ("pg", "alspg") else {}
    kw = dict(ks=(2, 3, 4), restarts=6, seed=5,
              solver_cfg=SolverConfig(algorithm=algorithm, backend=backend,
                                      **budget))
    got = nmfx_torch.nmfconsensus(a, device=card, **kw)
    want = nmfx_torch.nmfconsensus(a, device="cpu", **kw)
    assert got.best_k == want.best_k
    np.testing.assert_array_equal(got.per_k[2].membership,
                                  want.per_k[2].membership)
    for k in kw["ks"]:
        assert np.isfinite(got.per_k[k].consensus).all()
        assert np.isfinite(got.per_k[k].dnorms).all()


# --- the kernels' options ------------------------------------------------

def _exact_close(got, plain, exact, atol_rel=1e-6, factor=4.0):
    """A kernel held to the float64 plain version: as close to it as the
    float32 plain version is (4x its error + atol_rel max|exact|), where
    float32 itself is far from float64 (bf16 operands and pool factors
    carry a straddled rounding boundary on as a whole bf16 ulp; a bf16
    pool factor's kernel may store the neighbouring bf16 value where
    float32 and float64 round alike: atol_rel 2^-7, one ulp)."""
    exact = exact.double()
    e_k = (got.double() - exact).abs().max().item()
    e_p = (plain.double() - exact).abs().max().item()
    assert e_k <= factor * e_p + atol_rel * exact.abs().max().item()


#: (kernel, option): every option each block kernel takes
BLOCK_OPTIONS = [(kernel, option) for kernel in ("phased", "fused", "hals")
                 for option in ("bf16", "bfloat16_w", "bfloat16",
                                "alias_io")] + [
    ("phased", "seg_ids"), ("fused", "seg_ids")]


@pytest.mark.parametrize("kernel,option", BLOCK_OPTIONS)
def test_block_kernel_options_on_card(card, kernel, option):
    """Each option of rows 3-5 at the 1237 x 77 pool of 5 x k = 7 (rows
    off 16-byte alignment) with a frozen lane and a budget running out:
    bf16 operands and pool factors held to float64 as close as the plain
    version, outputs in the pool's dtypes; alias_io byte-equal to the
    unaliased launch and in place; segment ids of a class-major ragged
    pool against the plain version."""
    k, a, wp, hp, frozen, budget = _block_pool("1237x77_rk35", card)
    kw = dict(k=k, iters=2, check_block=4, budget_cols=budget)
    if kernel == "hals":
        fn, ref, extra = (fused_mu.hals_block_iterations,
                          fused_mu.hals_block_iterations_ref,
                          dict(slots=wp.shape[1] // k))
    else:
        fn, ref, extra = (fused_mu.fused_block_iterations,
                          fused_mu.fused_block_iterations_ref, {})
    kw_fn = dict(fused=kernel == "fused") if kernel != "hals" else {}
    fused_mu.reset_launch_counts()
    if option == "alias_io":
        plain = fn(a, wp, hp, frozen, **kw, **extra, **kw_fn)
        w2, h2 = wp.clone(), hp.clone()
        got = fn(a, w2, h2, frozen, alias_io=True, **kw, **extra, **kw_fn)
        torch.cuda.synchronize()
        assert got[0] is w2 and got[1] is h2
        for g, p in zip(got, plain):
            assert torch.equal(g.view(torch.int32), p.view(torch.int32))
        return
    if option == "seg_ids":
        # class-major jobs of widths 7 .. 2 over the pool's 35 columns
        seg = np.repeat(np.arange(8), [7, 6, 5, 5, 4, 3, 3, 2])
        got = fn(a, wp, hp, frozen, seg_ids=seg, **kw, **kw_fn)
        want = ref(a, wp, hp, frozen, seg_ids=seg, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
        name = "fused_block_iterations" + ("_fused" if kernel == "fused"
                                           else "")
        assert fused_mu.LAUNCHES[f"{name}[seg_ids]"] == 1
        return
    okw, pool = {}, None
    if option == "bf16":
        okw = dict(matmul_precision="bfloat16")
    else:
        pool = option
        wp = wp.to(torch.bfloat16)
        if option == "bfloat16":
            hp = hp.to(torch.bfloat16)
    got = fn(a, wp, hp, frozen, **kw, **extra, **kw_fn, **okw)
    plain = ref(a, wp, hp, frozen, **kw, **extra, **okw)
    exact = ref(a.double(), wp.double(), hp.double(), frozen.double(),
                **dict(kw, budget_cols=budget.double()), **extra, **okw,
                factor_dtype=pool)
    torch.cuda.synchronize()
    assert got[0].dtype == wp.dtype and got[1].dtype == hp.dtype
    for g, p, x in zip(got, plain, exact):
        assert torch.isfinite(g.float()).all()
        _exact_close(g, p, x, 1e-6 if pool is None else 2.0 ** -7)


@pytest.mark.parametrize("pool", sorted(PAIR_POOLS))
def test_bf16_pair_byte_equal_to_one_block_iteration(card, pool):
    """Under bf16 operands too, the pair is one block iteration."""
    m, n, r, k, zeros = PAIR_POOLS[pool]
    a, wp, hp = _operands(m, n, r, k, zeros, card)
    ab, bf = a.to(torch.bfloat16), dict(matmul_precision="bfloat16")
    h = fused_mu.fused_h_update(ab, wp, hp, k=k, **bf)
    w = fused_mu.fused_w_update(ab, wp, h, fused_mu.lane_gram(h, k=k, **bf),
                                k=k, **bf)
    want = fused_mu.fused_block_iterations(
        ab, wp, hp, torch.zeros((1, r * k), device=card), k=k, iters=1,
        **bf)
    torch.cuda.synchronize()
    assert torch.equal(h.view(torch.int32), want[1].view(torch.int32))
    assert torch.equal(w.view(torch.int32), want[0].view(torch.int32))


@pytest.mark.parametrize("option", ["bf16", "ragged", "alias_io",
                                    "block_m", "bfloat16_w"])
def test_sched_options_on_card_match_cpu(card, option, monkeypatch):
    """The whole grid under each option on the card and on the CPU: the
    same iterations, stop reasons and labels. Under bf16 operands the CPU
    sums the numerators as the card's tensor cores do
    (tensor_core_products): this k = 3 job of a two-group design parts at
    one float32 rounding, so no other order keeps its labels (exact sums
    part 3 of its 144 from the sequential sums'; PERF.md)."""
    from nmfx_torch.config import ExperimentalConfig
    from nmfx_torch.datasets import two_group_matrix
    from nmfx_torch.ops.sched_mu import mu_sched

    rng = np.random.default_rng(4)
    a = two_group_matrix(n_genes=200, n_per_group=12, seed=3)
    k_max, ks = 3, (3, 3, 3, 2, 2, 2)
    w0 = rng.uniform(0.0, 1.0, (len(ks), 200, k_max)).astype(np.float32)
    h0 = rng.uniform(0.0, 1.0, (len(ks), k_max, 24)).astype(np.float32)
    for j, k in enumerate(ks):
        w0[j, :, k:] = 0.0
        h0[j, k:] = 0.0
    kw = dict(backend="pallas", max_iter=200)
    exp = {"ragged": dict(ragged=True), "alias_io": dict(alias_io=True),
           "block_m": dict(block_m=256),
           "bfloat16_w": dict(factor_dtype="bfloat16_w")}.get(option, {})
    if option == "bf16":
        kw["matmul_precision"] = "bfloat16"
    if option == "ragged":
        kw["check_block"] = 1
    cfg = SolverConfig(experimental=ExperimentalConfig(**exp), **kw)
    got = mu_sched(a, w0, h0, cfg, slots=4, job_ks=ks, device=card)
    if option == "bf16":
        monkeypatch.setattr(fused_mu, "_numer_product", _tensor_core)
    want = mu_sched(a, w0, h0, cfg, slots=4, job_ks=ks, device="cpu")
    assert torch.equal(got.iterations.cpu(), want.iterations)
    assert torch.equal(got.stop_reason.cpu(), want.stop_reason)
    assert torch.equal(got.h.cpu().argmax(dim=1), want.h.argmax(dim=1))


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_tiled_sweep_streams_on_card(card, sparse):
    """The out-of-core tile stream on the card (pinned staging buffers,
    the copy stream, its events): prefetch on and off byte-equal, every
    pass's bytes counted, and the card's run at the agreement tier with
    the CPU's (min ARI >= 0.9, max rho gap <= 0.1, the JAX package's
    tiled-against-dense gate)."""
    import nmfx_torch
    from nmfx_torch import tiles
    from nmfx_torch.agreement import consensus_agreement
    from nmfx_torch.datasets import make_sparse_design, two_group_matrix

    data = (make_sparse_design(300, 60, k=3, density=0.1, seed=4) if sparse
            else two_group_matrix(300, 30, seed=4))
    scfg = SolverConfig(max_iter=120, tile_rows=70)
    kw = dict(ks=(2, 3), restarts=6, seed=3, solver_cfg=scfg)
    bytes0 = tiles._tile_h2d_bytes_total.total()
    passes0 = tiles._tile_passes_total.total()
    on = nmfx_torch.nmfconsensus(data, **kw)
    sent = tiles._tile_h2d_bytes_total.total() - bytes0
    passes = tiles._tile_passes_total.total() - passes0
    if not sparse:
        assert sent == passes * data.size * 4
    tiles.set_tile_prefetch(False)
    try:
        off = nmfx_torch.nmfconsensus(data, **kw)
    finally:
        tiles.set_tile_prefetch(True)
    cpu = nmfx_torch.nmfconsensus(data, device="cpu", **kw)
    for k in (2, 3):
        for field in ("consensus", "iterations", "dnorms", "stop_reasons",
                      "best_w", "best_h"):
            assert (np.asarray(getattr(on.per_k[k], field)).tobytes()
                    == np.asarray(getattr(off.per_k[k], field)).tobytes())
    rep = consensus_agreement(on, cpu)
    assert rep["min_ari"] >= 0.9 and rep["max_rho_gap"] <= 0.1


# --- the bf16 product tiles on the tensor cores --------------------------

#: pools of the bf16 wgmma tiles (m, n, slots, k): rk = 21 is not a
#: multiple of a 64-column tile and n = 77 and rk are off 4-element
#: alignment (2-byte copies); the north star's whole-grid pool is m = 5000
#: padded with zero rows to 5120, 48 slots of k = 10 (8-byte copies)
BF16_POOLS = {"1237x77_rk21": (1237, 77, 3, 7, 1237),
              "north_star": (5120, 500, 48, 10, 5000)}
BF16 = dict(matmul_precision="bfloat16")


def _bf16_pool(pool, card):
    """A pool with lane 1 frozen, lane 2's budget running out mid-launch
    (3 of 2 x 4 iterations), lane 0's last component zero-padded and the
    rows past the matrix zero (the scheduler's m_pad)."""
    m, n, slots, k, rows = BF16_POOLS[pool]
    a, wp, hp = _operands(m, n, slots, k, False, card)
    a[rows:] = 0.0
    wp[rows:] = 0.0
    wp[:, k - 1] = 0.0
    hp[k - 1] = 0.0
    frozen = torch.zeros((1, slots * k), device=card)
    frozen[0, k:2 * k] = 1.0
    budget = torch.full((1, slots * k), 100.0, device=card)
    budget[0, 2 * k:3 * k] = 3.0
    return k, a, wp, hp, frozen, budget


def _tensor_core(x, y, split=None):
    """The plain versions' numerators summed as the card's tensor cores
    sum them."""
    return fused_mu.tensor_core_products(x, y, split)


def _bits(t):
    return t.detach().cpu().contiguous().view(torch.int32)


@pytest.mark.parametrize("pool", sorted(BF16_POOLS))
def test_bf16_tiles_match_plain_versions(card, pool, monkeypatch):
    """The H tile (fused_h_update) and the W tile (fused_w_update) under
    bf16 operands: on the pool's operands within 1e-5 of their plain
    versions (sequential float32 numerators); and bit-equal to the plain
    versions that sum the numerators as the tensor cores do
    (tensor_core_products) where nothing else can part them: for H, Wp in
    quarters (every Gram sum exact in any order) and Hp = 1 (each
    denominator a sum of a lane's bf16 Gram entries, exact too); for W,
    Wp = 1, a zero H-Gram and eps = 1, so the output is the numerator
    itself."""
    k, a, wp, hp, _, _ = _bf16_pool(pool, card)
    ab = a.to(torch.bfloat16)
    fused_mu.reset_launch_counts()
    h = fused_mu.fused_h_update(ab, wp, hp, k=k, **BF16)
    want_h = fused_mu.fused_h_update_ref(a, wp, hp, k=k, **BF16)
    gh = fused_mu.lane_gram_ref(want_h, k=k, **BF16)
    w = fused_mu.fused_w_update(ab, wp, want_h, gh, k=k, **BF16)
    want_w = fused_mu.fused_w_update_ref(a, wp, want_h, gh, k=k, **BF16)
    torch.cuda.synchronize()
    for got, want in ((h, want_h), (w, want_w)):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-6 * want.abs().max().item())
    assert fused_mu.LAUNCHES["fused_h_update[bf16]"] == 1
    assert fused_mu.LAUNCHES["fused_w_update[bf16]"] == 1
    wq, ones = torch.round(wp * 4) / 4, torch.ones_like(hp)
    w1, g0 = torch.ones_like(wp), torch.zeros_like(gh)
    h = fused_mu.fused_h_update(ab, wq, ones, k=k, **BF16)
    w = fused_mu.fused_w_update(ab, w1, hp, g0, k=k, eps=1.0, **BF16)
    monkeypatch.setattr(fused_mu, "_numer_product", _tensor_core)
    a, wq, ones, w1, hp, g0 = (t.cpu() for t in (a, wq, ones, w1, hp, g0))
    assert torch.equal(_bits(h), _bits(fused_mu.fused_h_update_ref(
        a, wq, ones, k=k, **BF16)))
    assert torch.equal(_bits(w), _bits(fused_mu.fused_w_update_ref(
        a, w1, hp, g0, k=k, eps=1.0, **BF16)))


@pytest.mark.parametrize("pool", sorted(BF16_POOLS))
def test_bf16_fused_byte_equal_to_phased(card, pool):
    """Row 4 under bf16 operands (the join-the-updates pass, whose H
    product sums the new W strip from shared memory) byte-equal to row 3
    (the phased kernel) in every output: the same wgmma K steps."""
    k, a, wp, hp, frozen, budget = _bf16_pool(pool, card)
    kw = dict(k=k, iters=2, check_block=4, budget_cols=budget, **BF16)
    ab = a.to(torch.bfloat16)
    phased = fused_mu.fused_block_iterations(ab, wp, hp, frozen, **kw)
    fused = fused_mu.fused_block_iterations(ab, wp, hp, frozen, fused=True,
                                            **kw)
    torch.cuda.synchronize()
    assert len(fused) == len(phased) == 7
    for f, p in zip(fused, phased):
        assert torch.equal(f.view(torch.int32), p.view(torch.int32))
    # frozen lanes and the zero rows bit-equal
    rows = BF16_POOLS[pool][4]
    assert torch.equal(phased[0][:, k:2 * k], wp[:, k:2 * k])
    assert torch.equal(phased[1][k:2 * k], hp[k:2 * k])
    assert (phased[0][rows:] == 0).all()


@pytest.mark.parametrize("pool", sorted(BF16_POOLS))
def test_bf16_pair_byte_equal_on_tile_pools(card, pool):
    """The bf16 pair (rows 1b, 2b) byte-equal to one bf16 block iteration
    at the tile pools."""
    k, a, wp, hp, _, _ = _bf16_pool(pool, card)
    ab = a.to(torch.bfloat16)
    h = fused_mu.fused_h_update(ab, wp, hp, k=k, **BF16)
    w = fused_mu.fused_w_update(ab, wp, h, fused_mu.lane_gram(h, k=k, **BF16),
                                k=k, **BF16)
    want = fused_mu.fused_block_iterations(
        ab, wp, hp, torch.zeros((1, wp.shape[1]), device=card), k=k,
        iters=1, **BF16)
    torch.cuda.synchronize()
    assert torch.equal(h.view(torch.int32), want[1].view(torch.int32))
    assert torch.equal(w.view(torch.int32), want[0].view(torch.int32))


@pytest.mark.parametrize("pool", sorted(BF16_POOLS))
def test_bf16_hals_against_float64(card, pool):
    """Row 5b held to its float64 plain version (bf16 rounding kept) as
    close as its float32 plain version is: 4x (HALS_FACTOR) its error +
    1e-6 max|exact|."""
    k, a, wp, hp, frozen, budget = _bf16_pool(pool, card)
    kw = dict(k=k, slots=wp.shape[1] // k, iters=2, check_block=4, **BF16)
    got = fused_mu.hals_block_iterations(a.to(torch.bfloat16), wp, hp, frozen,
                                         budget_cols=budget, **kw)
    plain = fused_mu.hals_block_iterations_ref(a, wp, hp, frozen,
                                               budget_cols=budget, **kw)
    exact = fused_mu.hals_block_iterations_ref(
        a.double(), wp.double(), hp.double(), frozen.double(),
        budget_cols=budget.double(), **kw)
    torch.cuda.synchronize()
    for g, p, x in zip(got, plain, exact):
        assert torch.isfinite(g).all()
        _exact_close(g, p, x)


@pytest.mark.parametrize("pool", sorted(BF16_POOLS))
def test_bf16_block_against_float64(card, pool, monkeypatch):
    """Row 3b held to its float64 plain version (bf16 rounding kept) as
    close as its plain version summing the numerators as the tensor cores
    do is: 4x that one's error + 1e-6 max|exact|."""
    k, a, wp, hp, frozen, budget = _bf16_pool(pool, card)
    kw = dict(k=k, iters=2, check_block=4, **BF16)
    got = fused_mu.fused_block_iterations(a.to(torch.bfloat16), wp, hp,
                                          frozen, budget_cols=budget, **kw)
    exact = fused_mu.fused_block_iterations_ref(
        a.double(), wp.double(), hp.double(), frozen.double(),
        budget_cols=budget.double(), **kw)
    monkeypatch.setattr(fused_mu, "_numer_product", _tensor_core)
    plain = fused_mu.fused_block_iterations_ref(
        *(t.cpu() for t in (a, wp, hp, frozen)), budget_cols=budget.cpu(),
        **kw)
    torch.cuda.synchronize()
    for g, p, x in zip(got, plain, exact):
        assert torch.isfinite(g).all()
        _exact_close(g.cpu(), p, x.cpu())


#: sha256 (first 16 hex digits) of the float32 kernels' outputs on
#: _block_pool's stored inputs, as the block kernels' float32 chains gave
#: them on an H100 before the bf16 products moved to the tensor cores:
#: those chains must not move
F32_DIGESTS = {"fused 1100x300": "e34b7adf4b3f2423",
               "fused 1237x77_rk35": "97dfdbd8bae8fb68",
               "hals 1100x300": "416a6d3557f664b5",
               "hals 1237x77_rk35": "2803cd6afe5d6792",
               "pair 1100x300": "2b682374f4b1f721",
               "pair 1237x77_rk35": "c4f16d519015e084",
               "phased 1100x300": "e34b7adf4b3f2423",
               "phased 1237x77_rk35": "97dfdbd8bae8fb68"}


def _float32_digests(card):
    import hashlib

    digests = {}
    for pool in ("1100x300", "1237x77_rk35"):
        k, a, wp, hp, frozen, budget = _block_pool(pool, card)
        kw = dict(k=k, iters=2, check_block=4, budget_cols=budget)
        h = fused_mu.fused_h_update(a, wp, hp, k=k)
        gh = fused_mu.lane_gram(h, k=k)
        runs = {
            "phased": fused_mu.fused_block_iterations(a, wp, hp, frozen,
                                                      **kw),
            "fused": fused_mu.fused_block_iterations(a, wp, hp, frozen,
                                                     fused=True, **kw),
            "hals": fused_mu.hals_block_iterations(
                a, wp, hp, frozen, slots=wp.shape[1] // k, **kw),
            "pair": (h, gh, fused_mu.fused_w_update(a, wp, h, gh, k=k))}
        for name, outs in runs.items():
            blob = b"".join(t.cpu().numpy().tobytes() for t in outs)
            digests[f"{name} {pool}"] = hashlib.sha256(blob).hexdigest()[:16]
    return digests


def test_float32_kernels_byte_equal_to_parent(card):
    """Rows 1-5 in float32 keep their fmaf chains: every output byte-equal
    to the stored digests."""
    assert _float32_digests(card) == F32_DIGESTS


# --- the scale engines: the device draw, sketched and screened sweeps ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_device_draws_on_card_equal_cpu(card, dtype):
    """The device threefry on the card: its words equal the CPU's (and
    the numpy host's) bit for bit, the uniform too; the normal values
    within 1e-6 (the card's log1p and sqrt may part in the last bit)."""
    from nmfx_torch import random as R

    keys = R.split(R.fold_in(R.key(123), 10), 50)
    for bits in (32, 52):
        got = R.random_bits_device(keys, (48, 500), card, bits).cpu()
        want = R.random_bits_device(keys, (48, 500), "cpu", bits)
        assert torch.equal(got, want)
    assert np.array_equal(got[7].numpy().astype(np.uint64),
                          R.random_bits(keys[7], (48, 500), 64)
                          >> np.uint64(12))
    u = R.uniform_device(keys, (48, 500), -1.0, 1.0, dtype, card).cpu()
    assert torch.equal(u, R.uniform_device(keys, (48, 500), -1.0, 1.0,
                                           dtype, "cpu"))
    n = R.normal_device(keys, (48, 500), dtype, card).cpu()
    host = R.normal_device(keys, (48, 500), dtype, "cpu")
    assert n.dtype == dtype
    assert (n - host).abs().max().item() <= 1e-6


@pytest.mark.parametrize("cfg", [
    dict(algorithm="mu", backend="sketched"),
    dict(algorithm="mu", screen=True, screen_keep=3),
    dict(algorithm="hals", screen=True, screen_keep=3)],
    ids=["mu-sketched", "mu-screened", "hals-screened"])
def test_scale_engines_on_card_match_cpu(card, cfg):
    """A 200×24 sketched or screened sweep on the card against the CPU at
    the agreement tier: the same best k and k = 2 memberships, the
    quality tag, screened-out lanes masked alike in count, finite
    everywhere else. Sketched hals has no agreement tier at such a toy
    size (its consensus saturates at rho 1.0 past k = 2 on both devices,
    so best k falls to a last-bit dispersion tie; the JAX package leaves
    it ungated there too): it is held step by step below, and at the
    north star by chip_smoke.py's phase 13a."""
    import nmfx_torch
    from nmfx_torch.datasets import two_group_matrix

    a = two_group_matrix(n_genes=200, n_per_group=12, seed=3)
    kw = dict(ks=(2, 3, 4), restarts=6, seed=5,
              solver_cfg=SolverConfig(max_iter=500, **cfg))
    got = nmfx_torch.nmfconsensus(a, device=card, **kw)
    want = nmfx_torch.nmfconsensus(a, device="cpu", **kw)
    assert got.quality == want.quality
    assert got.best_k == want.best_k
    np.testing.assert_array_equal(got.per_k[2].membership,
                                  want.per_k[2].membership)
    for k in kw["ks"]:
        screened = got.per_k[k].stop_reasons == int(StopReason.SCREENED)
        assert screened.sum() == (6 - 3 if "screen" in cfg else 0)
        assert np.isfinite(got.per_k[k].consensus).all()
        assert np.isfinite(got.per_k[k].dnorms[~screened]).all()


@pytest.mark.parametrize("algorithm", ["mu", "hals"])
def test_sketched_short_solve_on_card_matches_cpu(card, algorithm):
    """20 sketched iterations (and the 3 exact polish steps) of six
    restarts at 1000×40 on the card against the CPU from the same keys:
    equal iterations and stop reasons, factors within rtol 1e-4 of their
    largest entry (the card's projections part from the CPU's by at most
    1e-6, and its float32 products sum in another order)."""
    from nmfx_torch import random as R
    from nmfx_torch.datasets import two_group_matrix
    from nmfx_torch.init import restart_inits
    from nmfx_torch.solvers import sketched as sk

    a = torch.as_tensor(two_group_matrix(1000, 20, seed=123),
                        dtype=torch.float32)
    keys = R.split(R.fold_in(R.key(123), 2), 6)
    cfg = SolverConfig(algorithm=algorithm, backend="sketched", max_iter=20)
    out = {}
    for dev in (card, torch.device("cpu")):
        ad = a.to(dev)
        w0, h0 = restart_inits(ad, keys, 2, InitConfig())
        out[dev.type] = sk.solve_sketched(ad, w0, h0, keys, cfg)
    got, want = out["cuda"], out["cpu"]
    assert torch.equal(got.iterations.cpu(), want.iterations)
    assert torch.equal(got.stop_reason.cpu(), want.stop_reason)
    for x, y in ((got.w, want.w), (got.h, want.h)):
        torch.testing.assert_close(x.cpu(), y, rtol=0,
                                   atol=1e-4 * y.abs().max().item())


@pytest.mark.parametrize("algorithm", ["mu", "hals"])
def test_two_shards_on_one_card_byte_equal_to_one(card, algorithm):
    """A restart mesh naming the one card twice: the whole grid on its
    block kernel (row 3 for mu, row 5 for hals), each shard launching,
    byte-equal per rank to the unmeshed run (the kernels' lanes do not
    depend on the pool's other lanes)."""
    from nmfx_torch import nmfconsensus
    from nmfx_torch.datasets import two_group_matrix
    from nmfx_torch.sweep import grid_mesh

    a = two_group_matrix(300, 20, seed=7)
    cfg = SolverConfig(algorithm=algorithm, backend="pallas", max_iter=400)
    kw = dict(ks=(2, 3, 4), restarts=9, seed=3, solver_cfg=cfg)
    one = nmfconsensus(a, **kw)
    card0 = torch.device("cuda", 0)
    fused_mu.reset_launch_counts()
    two = nmfconsensus(a, mesh=grid_mesh(2, devices=[card0, card0]), **kw)
    name = ("fused_block_iterations" if algorithm == "mu"
            else "hals_block_iterations")
    shards = {s: c.get(name, 0)
              for s, c in fused_mu.SCOPED_LAUNCHES.items()}
    assert sorted(shards) == ["shard0", "shard1"]
    assert min(shards.values()) >= 1
    for k in kw["ks"]:
        for f in ("consensus", "iterations", "dnorms", "stop_reasons",
                  "membership", "best_w", "best_h"):
            x = np.asarray(getattr(one.per_k[k], f))
            y = np.asarray(getattr(two.per_k[k], f))
            assert x.tobytes() == y.tobytes(), (k, f)


def test_bf16_batched_route_on_card_at_the_agreement_tier(card):
    """``matmul_precision="bfloat16"`` off the kernels: every product's
    operands rounded to bf16 on the card. The batched restart route
    (neals) against its float32 run: the same best k and k = 2
    memberships; the factors differ (the rounding is real)."""
    from nmfx_torch import nmfconsensus
    from nmfx_torch.datasets import two_group_matrix

    a = two_group_matrix(300, 20, seed=7)
    kw = dict(ks=(2, 3), restarts=8, seed=3)
    f32 = nmfconsensus(a, solver_cfg=SolverConfig(algorithm="neals",
                                                  max_iter=100), **kw)
    bf16 = nmfconsensus(a, solver_cfg=SolverConfig(
        algorithm="neals", max_iter=100, matmul_precision="bfloat16"), **kw)
    assert bf16.best_k == f32.best_k == 2
    np.testing.assert_array_equal(bf16.per_k[2].membership,
                                  f32.per_k[2].membership)
    assert not np.array_equal(bf16.per_k[2].best_w, f32.per_k[2].best_w)


def test_autotune_cold_search_on_card(card, tmp_path, monkeypatch):
    """The block-shape autotuner on the card: a cold search launches the
    hand-written block kernel of each candidate's row (once to warm,
    ``_TIME_REPS`` times timed) and no plain version; the tuned sweep is
    byte-equal to the sweep with the resolved values explicit."""
    from nmfx_torch import autotune, nmfconsensus
    from nmfx_torch.config import ExperimentalConfig
    from nmfx_torch.datasets import two_group_matrix

    plain = []
    for name in ("fused_block_iterations_ref", "hals_block_iterations_ref"):
        real = getattr(fused_mu, name)
        monkeypatch.setattr(fused_mu, name,
                            lambda *a, _f=real, **k: (plain.append(1),
                                                      _f(*a, **k))[1])
    with autotune._lock:
        autotune._memo.clear()
    cfg = SolverConfig(backend="pallas", max_iter=400,
                       experimental=ExperimentalConfig(autotune="on"))
    m, n, k_max, slots = 300, 40, 4, 9
    s0 = autotune.searches_total.total()
    fused_mu.reset_launch_counts()
    tuned_cfg = autotune.resolve(cfg, m, n, k_max, slots,
                                 cache_dir=str(tmp_path))
    m_b, n_b = autotune.shape_bucket(m, n, k_max, slots)[:2]
    cands = autotune._candidates(cfg, m_b, n_b, k_max, slots)
    reps = 1 + autotune._TIME_REPS
    phased = sum(c["fused_updates"] == "phased" for c in cands)
    assert autotune.searches_total.total() - s0 == 1
    assert fused_mu.LAUNCHES["fused_block_iterations"] == phased * reps
    assert (fused_mu.LAUNCHES["fused_block_iterations_fused"]
            == (len(cands) - phased) * reps)
    assert plain == []
    a = two_group_matrix(300, 20, seed=7)
    kw = dict(ks=(2, 3, 4), restarts=3, seed=3)
    tuned = nmfconsensus(a, solver_cfg=cfg, **kw)
    # the sweep resolves at this key (slots = min(48, 3 · 3) = 9): a hit
    explicit = nmfconsensus(a, solver_cfg=tuned_cfg, **kw)
    for k in kw["ks"]:
        for f in ("consensus", "iterations", "dnorms", "stop_reasons",
                  "membership", "best_w", "best_h"):
            x = np.asarray(getattr(tuned.per_k[k], f))
            y = np.asarray(getattr(explicit.per_k[k], f))
            assert x.tobytes() == y.tobytes(), (k, f)
