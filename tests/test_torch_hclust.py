"""Device rank selection (``nmfx_torch/ops/hclust.py``) against the
reference's ``nmfx/ops/hclust_jax.py`` on the same float32 inputs, and the
whole sweep with ``rank_selection="device"`` against the reference's.

Tolerances: linkage heights and cophenetic distances within rtol 1e-6
(the same elementwise float32 operations; XLA and PyTorch may round a
fused expression differently); memberships and leaf order equal. rho
within 1e-6 of the reference's at the reference's own test sizes; at
larger n the reference's float32 reductions are themselves up to ~3e-5
from the float64 value of the same formula, so there the port's rho must
be within 1e-6 of that float64 value and no further from the reference's
than the reference is from it, plus 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmfx
import nmfx_torch
from nmfx.datasets import two_group_matrix
from nmfx.ops.hclust_jax import linkage_jax, rank_selection_jax
from nmfx_torch import cophenetic as tcoph
from nmfx_torch.convert import solver_config_from_dict
from nmfx_torch.ops.hclust import (_first_appearance_labels, linkage_torch,
                                   rank_selection_torch)
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)

METHODS = ("average", "complete", "single")
#: the process's intra-op thread count before any module pins it
DEFAULT_THREADS = torch.get_num_threads()


@pytest.fixture
def default_torch_threads():
    """Run a case at the process's default thread count: the float32
    rho of the (200, 5, average) case lands 2.24e-6 from float64 with
    one thread and within 1e-6 with eight (ROADMAP §3)."""
    pinned = torch.get_num_threads()
    torch.set_num_threads(DEFAULT_THREADS)
    yield
    torch.set_num_threads(pinned)


def _dist32(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    d = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1))
    np.fill_diagonal(d, 0.0)
    return d


def _consensus32(n, seed, labels=3, runs=8):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, labels, (runs, n))
    return (lab[:, :, None] == lab[:, None, :]).mean(0).astype(np.float32)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n,seed", [(2, 0), (5, 1), (17, 2), (40, 3)])
def test_linkage_matches_reference(method, n, seed):
    d = _dist32(n, seed)
    for k in sorted({1, 2, n}):
        want = [np.asarray(x) for x in linkage_jax(jnp.asarray(d), k, method)]
        got = [x.numpy() for x in linkage_torch(torch.as_tensor(d), k,
                                                method)]
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=0)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.parametrize("method", METHODS)
def test_float64_linkage_equals_numpy_path(method):
    """In float64 the merges run the numpy path's arithmetic: linkage,
    cophenetic matrix, order and cut equal it exactly."""
    d = _dist32(30, 4).astype(np.float64)
    ref = tcoph.linkage_numpy(d, method)
    link, coph, order, memb = linkage_torch(torch.as_tensor(d), 4, method)
    np.testing.assert_array_equal(link.numpy(), ref.linkage)
    np.testing.assert_array_equal(coph.numpy(), ref.coph)
    np.testing.assert_array_equal(order.numpy(), ref.order)
    np.testing.assert_array_equal(memb.numpy(),
                                  tcoph.cut_tree_numpy(ref.linkage, 30, 4))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n,seed", [(12, 4), (33, 5)])
def test_rank_selection_matches_reference(method, n, seed):
    cons = _consensus32(n, seed)
    for k in (2, 3):
        rho_j, memb_j, order_j = rank_selection_jax(jnp.asarray(cons), k,
                                                    method)
        rho, memb, order = rank_selection_torch(torch.as_tensor(cons), k,
                                                method)
        assert abs(float(rho) - float(rho_j)) <= 1e-6
        np.testing.assert_array_equal(memb.numpy(), np.asarray(memb_j))
        np.testing.assert_array_equal(order.numpy(), np.asarray(order_j))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n,seed", [(120, 3), (200, 5)])
def test_rank_selection_rho_at_larger_n(method, n, seed,
                                        default_torch_threads):
    cons = _consensus32(n, seed)
    rho_j, memb_j, order_j = rank_selection_jax(jnp.asarray(cons), 3, method)
    rho, memb, order = rank_selection_torch(torch.as_tensor(cons), 3, method)
    np.testing.assert_array_equal(memb.numpy(), np.asarray(memb_j))
    np.testing.assert_array_equal(order.numpy(), np.asarray(order_j))
    dist = 1.0 - cons
    np.fill_diagonal(dist, 0.0)
    coph = linkage_torch(torch.as_tensor(dist), 3, method)[1].numpy()
    iu = np.triu_indices(n, k=1)
    x, y = dist[iu].astype(np.float64), coph[iu].astype(np.float64)
    xc, yc = x - x.mean(), y - y.mean()
    rho64 = (xc @ yc) / np.sqrt((xc @ xc) * (yc @ yc))
    assert abs(float(rho) - rho64) <= 1e-6
    assert abs(float(rho) - float(rho_j)) <= \
        abs(float(rho_j) - rho64) + 1e-6


def test_first_appearance_labels_match_a_loop():
    rng = np.random.default_rng(9)
    for n in (1, 2, 9, 40):
        raw = rng.integers(0, 6, n) * 7 + 3
        want, seen = [], {}
        for v in raw:
            seen.setdefault(v, len(seen) + 1)
            want.append(seen[v])
        got = _first_appearance_labels(torch.as_tensor(raw))
        np.testing.assert_array_equal(got.numpy(), want)


def test_perfect_consensus_rho_one():
    rho, memb, order = rank_selection_torch(torch.ones(10, 10), 1)
    assert float(rho) == 1.0
    assert (memb == 1).all()
    assert sorted(order.tolist()) == list(range(10))


@pytest.mark.parametrize("kw,match", [
    (dict(k=0), "k must be in"), (dict(k=6), "k must be in"),
    (dict(method="ward"), "linkage must be")])
def test_linkage_torch_validates(kw, match):
    with pytest.raises(ValueError, match=match):
        linkage_torch(torch.as_tensor(_dist32(5, 0)), **kw)


@pytest.fixture(scope="module")
def device_sweeps():
    """The reference's per-rank Pallas route and the port's (as in
    tests/test_torch_sweep.py), both with device rank selection."""
    a = two_group_matrix(200, 12, seed=3)
    jcfg = nmfx.SolverConfig(backend="pallas", max_iter=300, stable_checks=30)
    kw = dict(ks=(2, 3), restarts=4, seed=11, grid_exec="per_k",
              rank_selection="device")
    want = nmfx.nmfconsensus(a, solver_cfg=jcfg, use_mesh=False, **kw)
    got = nmfx_torch.nmfconsensus(
        a, solver_cfg=solver_config_from_dict(dataclasses.asdict(jcfg)),
        device="cpu", **kw)
    host = nmfx_torch.nmfconsensus(
        a, solver_cfg=solver_config_from_dict(dataclasses.asdict(jcfg)),
        device="cpu", **{**kw, "rank_selection": "host"})
    return want, got, host


def test_device_sweep_matches_reference(device_sweeps):
    want, got, _ = device_sweeps
    assert got.best_k == want.best_k
    for k in want.ks:
        np.testing.assert_array_equal(got.per_k[k].membership,
                                      want.per_k[k].membership)
        np.testing.assert_array_equal(got.per_k[k].order, want.per_k[k].order)
        # rho is rounded to 4 significant digits: at most one step apart
        assert abs(got.per_k[k].rho - want.per_k[k].rho) <= 2e-4


def test_device_sweep_matches_host_rank_selection(device_sweeps):
    _, got, host = device_sweeps
    assert got.best_k == host.best_k
    for k in host.ks:
        np.testing.assert_array_equal(got.per_k[k].membership,
                                      host.per_k[k].membership)
        np.testing.assert_array_equal(got.per_k[k].consensus,
                                      host.per_k[k].consensus)
        assert abs(got.per_k[k].rho - host.per_k[k].rho) <= 2e-4
