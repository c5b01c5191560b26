"""The port's bucketed-sweep cache (``nmfx_torch/exec_cache.py``) and the
serving build functions of ``nmfx_torch/sweep.py``, against ``nmfx``'s on the
CPU.

The bucket lattice equals the reference's; the bucketed lane init is
byte-equal to the reference's in-executable draws (``_dyn_lane_init``);
``ExecCache.run_sweep`` and the packed build function agree with the reference's
per rank at the whole-grid tier of ``tests/test_torch_sched.py`` (equal
iterations, stop reasons and labels, consensus within 1e-6, residuals
within 1e-5 relative). The reference's Pallas route runs in interpret
mode, the port's on its kernels' plain versions. Then the cache's own
contracts: a warm bucket builds nothing, the LRU bound, the per-rank
pipeline, the refusals.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmfx.exec_cache as nexec
import nmfx.sweep as nsweep
from nmfx.config import ConsensusConfig as NConsensusConfig
from nmfx.config import InitConfig as NInitConfig
from nmfx.config import SolverConfig as NSolverConfig
from nmfx_torch import faults, nmfconsensus
from nmfx_torch import random as _random
from nmfx_torch.config import (ConsensusConfig, ExecCacheConfig, InitConfig,
                               SolverConfig)
from nmfx_torch.datasets import two_group_matrix
from nmfx_torch.exec_cache import ExecCache, _unpad, bucket_dim, compile_count
from nmfx_torch.harvest import fetch_host
from nmfx_torch.ops.packed_mu import flip_budget
from nmfx_torch.sweep import (_build_packed_serve_fn, _dyn_lane_init,
                              bucketed_lane_init_fn, sweep)

#: small pools keep the reference's interpret-mode kernels quick
SLOTS = 8
CCFG = dict(ks=(2, 3), restarts=2, seed=3, grid_slots=SLOTS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's solves: the problems are small,
    and the suite runs several worker processes on the same cores, where
    a thread pool per process oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _pristine_faults():
    faults.disarm()
    faults._reset_warned()
    yield
    faults.disarm()


@pytest.fixture(scope="module")
def data():
    return two_group_matrix(n_genes=60, n_per_group=10, seed=3)


def _pair(alg, backend, max_iter=40):
    return (SolverConfig(algorithm=alg, backend=backend, max_iter=max_iter),
            NSolverConfig(algorithm=alg, backend=backend,
                          max_iter=max_iter))


def _assert_rank_tier(got, want):
    """One rank of the port against the reference: the whole-grid tier."""
    got = fetch_host(got)
    np.testing.assert_array_equal(got.iterations, np.asarray(want.iterations))
    np.testing.assert_array_equal(got.stop_reasons,
                                  np.asarray(want.stop_reasons))
    np.testing.assert_allclose(got.consensus, np.asarray(want.consensus),
                               atol=1e-6)
    np.testing.assert_allclose(got.dnorms, np.asarray(want.dnorms),
                               rtol=1e-5)
    assert got.consensus.shape == tuple(np.asarray(want.consensus).shape)
    assert got.best_w.shape == tuple(np.asarray(want.best_w).shape)


# --- the lattice ---------------------------------------------------------

@pytest.mark.parametrize("quantum,growth", [(256, 8), (64, 8), (16, 4),
                                            (1, 1)])
def test_bucket_dim_matches_reference(quantum, growth):
    xs = list(range(1, 700)) + [1000, 4832, 5000, 99999]
    assert ([bucket_dim(x, quantum, growth) for x in xs]
            == [nexec.bucket_dim(x, quantum, growth) for x in xs])
    with pytest.raises(ValueError):
        bucket_dim(0, quantum)


def test_north_star_bucket():
    cache = ExecCache(device="cpu")
    assert cache.bucket_shape(5000, 500) == (5120, 512)
    assert cache.bucket_shape(4832, 488) == (5120, 512)


# --- the lane init ------------------------------------------------------

@pytest.mark.parametrize("true_shape,bucket,ks", [
    ((60, 20), (256, 64), (3, 2)),
    ((37, 11), (64, 16), (5, 4, 2)),
])
def test_lane_init_byte_equal_to_reference(true_shape, bucket, ks):
    m_true, n_true = true_shape
    m_pad, n_pad = bucket
    k_max, r, seed = max(ks), 3, 17
    icfg = NInitConfig(minval=0.0, maxval=1.0)
    build = nsweep._dyn_lane_init(icfg, jnp.float32, n_pad, m_pad, k_max)
    root = jax.random.key(seed)
    want = jax.jit(lambda mt, nt: build(
        [(k, jax.random.split(jax.random.fold_in(root, k), r))
         for k in ks], mt, nt))(jnp.int32(m_true), jnp.int32(n_true))
    rank_keys = [(k, _random.split(_random.fold_in(_random.key(seed), k),
                                   r)) for k in ks]
    got = _dyn_lane_init(InitConfig(), "float32", n_pad, m_pad, k_max)(
        rank_keys, m_true, n_true)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().shape == w.shape and g.numpy().dtype == w.dtype
        assert g.numpy().tobytes() == w.tobytes()
    # the external route (bucketed_lane_init_fn) draws the same lanes
    ext = bucketed_lane_init_fn(true_shape, ks, r, InitConfig(), "float32",
                                bucket)(torch.zeros(true_shape),
                                        _random.key(seed))
    order = sorted(range(len(ks)), key=lambda i: -ks[i])
    perm = np.concatenate([np.arange(i * r, (i + 1) * r) for i in order])
    for g, e in zip(got, ext):
        assert torch.equal(g[perm], e)


# --- the sweep and the packed build function against the reference --------------

@pytest.mark.parametrize("alg,backend", [("mu", "auto"), ("mu", "pallas"),
                                         ("hals", "auto"),
                                         ("hals", "pallas")])
def test_run_sweep_matches_reference(data, alg, backend):
    scfg, nscfg = _pair(alg, backend)
    got = ExecCache(device="cpu").run_sweep(data, ConsensusConfig(**CCFG),
                                            scfg, InitConfig())
    want = nexec.ExecCache().run_sweep(data, NConsensusConfig(**CCFG),
                                       nscfg, NInitConfig(), None)
    for k in CCFG["ks"]:
        _assert_rank_tier(got[k], want[k])
        np.testing.assert_array_equal(
            got[k].labels.numpy(), np.asarray(want[k].labels))


@pytest.mark.parametrize("alg,backend", [("mu", "auto"), ("hals", "pallas")])
def test_packed_serve_fn_matches_reference(data, alg, backend):
    scfg, nscfg = _pair(alg, backend)
    layout = ((3, 2), (3, 3), (2, 2))  # (k, restarts) groups, LPT
    seeds = (11, 29, 11)
    bucket = (256, 64)
    m, n = data.shape
    a_pad = np.zeros(bucket, np.float32)
    a_pad[:m, :n] = data
    flip = flip_budget(scfg.class_flip_tol, n)
    got = _build_packed_serve_fn(layout, scfg, "argmax", SLOTS, "auto",
                                 bucket, InitConfig())(
        torch.as_tensor(a_pad),
        np.stack([_random.fold_in(_random.key(s), k)
                  for (k, _), s in zip(layout, seeds)]), m, n, flip)
    want = nsweep._build_packed_serve_fn(layout, nscfg, "argmax", SLOTS,
                                         "auto", bucket, NInitConfig())(
        jnp.asarray(a_pad),
        jnp.stack([jax.random.fold_in(jax.random.key(s), k)
                   for (k, _), s in zip(layout, seeds)]),
        jnp.int32(m), jnp.int32(n), jnp.int32(flip))
    assert len(got) == len(want) == len(layout)
    for g, w in zip(got, want):
        g = _unpad(g, m, n)
        _assert_rank_tier(g, nexec._unpad(w, m, n))


def test_bucketed_sweep_agrees_with_plain_sweep(data):
    """Bucketed against the plain route of the port: the agreement tier
    (best k and the k = 2 memberships)."""
    scfg = SolverConfig(max_iter=200)
    kw = dict(ks=(2, 3, 4), restarts=4, seed=11, solver_cfg=scfg,
              device="cpu")
    plain = nmfconsensus(data, **kw)
    cache = ExecCache(device="cpu")
    got = nmfconsensus(data, exec_cache=cache, **kw)
    assert cache.stats["misses"] == 1  # the sweep went through the cache
    assert got.best_k == plain.best_k
    np.testing.assert_array_equal(got.per_k[2].membership,
                                  plain.per_k[2].membership)


# --- the cache's own contracts ------------------------------------------

def test_warm_bucket_builds_nothing(data):
    cache = ExecCache(device="cpu")
    ccfg = ConsensusConfig(**CCFG)
    scfg = SolverConfig(max_iter=20)
    c0 = compile_count()
    cache.run_sweep(data, ccfg, scfg)
    assert compile_count() == c0 + 1
    other = two_group_matrix(n_genes=50, n_per_group=9, seed=1)
    assert cache.bucket_shape(*other.shape) == cache.bucket_shape(
        *data.shape)
    out = cache.run_sweep(other, ccfg, scfg)
    assert compile_count() == c0 + 1  # same bucket: nothing built
    assert cache.stats["hits"] == 1 and cache.stats["entries"] == 1
    assert fetch_host(out[2]).consensus.shape == (18, 18)
    # another config is another entry
    cache.run_sweep(data, ccfg, SolverConfig(max_iter=22))
    assert compile_count() == c0 + 2


def test_lru_bound_evicts_oldest(data):
    cache = ExecCache(ExecCacheConfig(max_entries=1), device="cpu")
    ccfg = ConsensusConfig(ks=(2,), restarts=2, seed=3, grid_slots=4)
    cache.executable(data.shape, ccfg, SolverConfig(max_iter=20))
    cache.executable((300, 20), ccfg, SolverConfig(max_iter=20))
    assert cache.stats["entries"] == 1 and cache.stats["evictions"] == 1
    _, hit = cache.executable(data.shape, ccfg, SolverConfig(max_iter=20))
    assert not hit  # evicted: built again


def test_pipeline_ranks_equal_single_rank_sweeps(data):
    scfg = SolverConfig(max_iter=30)
    cache = ExecCache(ExecCacheConfig(pipeline_ranks=True, max_entries=1),
                      device="cpu")
    ccfg = ConsensusConfig(ks=(2, 3, 4), restarts=2, seed=5, grid_slots=4)
    seen = []
    out = cache.run_sweep(data, ccfg, scfg,
                          on_rank=lambda k, o: seen.append(k))
    assert seen == [2, 3, 4]
    assert cache.stats["entries"] == 3  # the bound rose to the rank count
    solo = ExecCache(device="cpu")
    for k in ccfg.ks:
        ref = fetch_host(solo.run_sweep(
            data, dataclasses.replace(ccfg, ks=(k,)), scfg)[k])
        got = fetch_host(out[k])
        for f in ("consensus", "iterations", "dnorms", "best_w", "best_h"):
            assert np.array_equal(getattr(got, f), getattr(ref, f)), f


def test_background_warm_then_request_hits(data):
    cache = ExecCache(device="cpu")
    ccfg = ConsensusConfig(**CCFG)
    scfg = SolverConfig(max_iter=20)
    task = cache.warm([data.shape], ccfg, scfg, background=True)
    report = task.result(timeout=60)
    assert task.done() and report[0]["bucket"] == (256, 64)
    assert not report[0]["cache_hit"]
    _, hit = cache.executable(data.shape, ccfg, scfg)
    assert hit


def test_compile_build_fault_raises_before_counting(data):
    cache = ExecCache(device="cpu")
    c0 = compile_count()
    with faults.scoped("compile.build", every=1, max_fires=1):
        with pytest.raises(faults.FaultInjected):
            cache.executable(data.shape, ConsensusConfig(**CCFG),
                             SolverConfig(max_iter=20))
    assert compile_count() == c0 and cache.stats["misses"] == 0
    cache.executable(data.shape, ConsensusConfig(**CCFG),
                     SolverConfig(max_iter=20))  # disarmed: builds
    assert compile_count() == c0 + 1


def test_nndsvd_route_builds_outside_and_runs(data):
    cache = ExecCache(device="cpu")
    ccfg = ConsensusConfig(**CCFG)
    scfg = SolverConfig(max_iter=30)
    out = cache.run_sweep(data, ccfg, scfg, InitConfig(method="nndsvd"))
    ref = sweep(data, dataclasses.replace(ccfg, grid_exec="grid"), scfg,
                InitConfig(method="nndsvd"), device="cpu")
    for k in ccfg.ks:
        np.testing.assert_array_equal(fetch_host(out[k]).iterations,
                                      fetch_host(ref[k]).iterations)
    # random init under the same sweep config is another entry
    cache.executable(data.shape, ccfg, scfg, InitConfig())
    assert cache.stats["misses"] == 2


def test_refusals():
    # a cache directory is taken, as the reference's config takes it (it
    # holds the autotuner's store; no executable is serialized there)
    import nmfx

    assert (ExecCacheConfig(cache_dir="/nonexistent/exec").cache_dir
            == nmfx.ExecCacheConfig(cache_dir="/nonexistent/exec").cache_dir
            == "/nonexistent/exec")
    cache = ExecCache(device="cpu")
    assert not cache.cacheable(ConsensusConfig(grid_exec="per_k"),
                               SolverConfig())
    assert not cache.cacheable(ConsensusConfig(),
                               SolverConfig(algorithm="kl"))
    # a restart mesh serves, as in the reference (the meshed bucketed
    # sweeps); its ranks agree with the plain sweep on the same mesh
    from nmfx_torch.datasets import two_group_matrix
    from nmfx_torch.sweep import grid_mesh, sweep

    a = two_group_matrix(40, 6, seed=2).astype(np.float32)
    mesh = grid_mesh(2, devices=["cpu"] * 2)
    ccfg = ConsensusConfig(ks=(2,), restarts=3)
    served = cache.run_sweep(a, ccfg, SolverConfig(max_iter=200), mesh=mesh)
    plain = sweep(a, ccfg, SolverConfig(max_iter=200), mesh=mesh)
    assert served[2].labels.shape == (3, 12)
    np.testing.assert_allclose(served[2].consensus.numpy(),
                               plain[2].consensus.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="not cacheable"):
        cache.run_sweep(np.ones((8, 6), np.float32),
                        ConsensusConfig(ks=(2,), grid_exec="per_k"),
                        SolverConfig())


def test_nmfconsensus_refusals(data, tmp_path):
    cache = ExecCache(device="cpu")
    with pytest.raises(ValueError, match="exec_cache"):
        nmfconsensus(data, ks=(2,), restarts=2, device="cpu",
                     exec_cache=cache, checkpoint=str(tmp_path))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ExecCache()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            nmfconsensus(data, ks=(2, 3), restarts=2, exec_cache=cache)
