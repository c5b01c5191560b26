"""The port's finished-result cache (``nmfx_torch/result_cache.py``):
the reference's non-sparse cases of ``tests/test_result_cache.py`` on the
port — key sensitivity, the two-tier LRU store, the
zero-dispatch/zero-h2d warm hit through ``nmfx_torch.serve`` — plus the
port's own rule: its key differs from ``nmfx``'s for equal inputs (the
engine and the device type are in the payload), so one address never
serves both packages. On the CPU (``device="cpu"``)."""

import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

import nmfx.result_cache as nrc
import nmfx_torch.serve as serve_mod
from nmfx.config import ConsensusConfig as NConsensusConfig
from nmfx.config import InitConfig as NInitConfig
from nmfx.config import SolverConfig as NSolverConfig
from nmfx_torch import data_cache
from nmfx_torch.api import nmfconsensus
from nmfx_torch.config import (ConsensusConfig, InitConfig,
                               ResultCacheConfig, SolverConfig)
from nmfx_torch.result_cache import (ResultCache, cache_key_fields,
                                     cacheable, key_for_array,
                                     request_quality, result_key)
from nmfx_torch.serve import NMFXServer, ServeConfig

KW = dict(ks=(2,), restarts=2, seed=5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's solves: the problems are small,
    and the suite runs several worker processes on the same cores, where
    a thread pool per process oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def small_data():
    from nmfx_torch.datasets import two_group_matrix

    return two_group_matrix(n_genes=60, n_per_group=10, seed=7)


@pytest.fixture(scope="module")
def tiny_result(small_data):
    """One real finished ConsensusResult the store tests re-address."""
    return nmfconsensus(small_data, solver_cfg=SolverConfig(max_iter=20),
                        device="cpu", **KW)


def _bit_identical(got, ref):
    assert set(got.per_k) == set(ref.per_k)
    for k in ref.per_k:
        for field in ("consensus", "membership", "order", "iterations",
                      "dnorms", "stop_reasons", "best_w", "best_h"):
            a = np.ascontiguousarray(np.asarray(getattr(got.per_k[k],
                                                        field)))
            b = np.ascontiguousarray(np.asarray(getattr(ref.per_k[k],
                                                        field)))
            assert a.shape == b.shape and a.dtype == b.dtype \
                and a.tobytes() == b.tobytes(), f"{field} k={k}"
        assert got.per_k[k].rho == ref.per_k[k].rho


# ---------------------------------------------------------------------
# the key: content + config + quality sensitivity
# ---------------------------------------------------------------------

def test_key_covers_declared_fields():
    cov = cache_key_fields()
    # the consensus side keys EVERYTHING (RESULT_CACHE_EXEMPT_FIELDS is
    # deliberately empty — the checkpoint/result-cache asymmetry): a
    # finished restarts=4 answer is not a restarts=8 answer
    assert cov["consensus"] == frozenset(
        f.name for f in dataclasses.fields(ConsensusConfig))
    assert {"restarts", "ks", "seed", "linkage"} <= cov["consensus"]
    # the solver side is the checkpoint manifest's numerics coverage
    assert "algorithm" in cov["solver"]
    assert "restart_chunk" not in cov["solver"]  # execution-only
    # the same coverage as the reference's, over the fields both have
    ref = nrc.cache_key_fields()
    assert cov["consensus"] == ref["consensus"]
    assert cov["solver"] == ref["solver"] & {
        f.name for f in dataclasses.fields(SolverConfig)}


def test_key_sensitive_to_every_component():
    base = result_key("fp0", (8, 6), "<f4")
    seen = {base}

    def differs(**kw):
        args = dict(fingerprint="fp0", shape=(8, 6), src_dtype="<f4")
        args.update(kw)
        k = result_key(args.pop("fingerprint"), args.pop("shape"),
                       args.pop("src_dtype"), **args)
        assert k not in seen, f"key collision for {kw}"
        seen.add(k)

    differs(fingerprint="fp1")               # different content
    differs(shape=(6, 8))                    # same bytes, other shape
    differs(src_dtype="<f8")                 # same bytes, other dtype
    differs(scfg=SolverConfig(algorithm="hals"))
    differs(scfg=SolverConfig(max_iter=17))
    differs(scfg=SolverConfig(dtype="bfloat16"))
    differs(ccfg=ConsensusConfig(restarts=3))
    differs(ccfg=ConsensusConfig(ks=(2, 3)))
    differs(ccfg=ConsensusConfig(seed=1))
    differs(ccfg=ConsensusConfig(linkage="complete"))
    differs(icfg=InitConfig(method="nndsvd"))
    differs(quality="sketched")              # quality separation


def test_key_insensitive_to_execution_strategy():
    """NON_NUMERICS_FIELDS change scheduling, never numbers — two runs
    differing only in them share one finished result."""
    base = result_key("fp0", (8, 6), "<f4")
    assert result_key("fp0", (8, 6), "<f4",
                      scfg=SolverConfig(restart_chunk=3)) == base


def test_key_for_array_matches_content_not_object():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    assert key_for_array(a) == key_for_array(a.copy())
    assert key_for_array(a) != key_for_array(a + 1)
    # a transposed view has the same bytes under ascontiguousarray
    # normalization only if shape matches — it must NOT collide
    assert key_for_array(a) != key_for_array(a.T)


def test_request_quality_tags():
    assert request_quality(SolverConfig()) == "exact"
    assert request_quality(
        SolverConfig(backend="sketched")) == "sketched"


def test_cacheable_rejects_keep_factors():
    assert cacheable(ConsensusConfig())
    assert not cacheable(ConsensusConfig(keep_factors=True))


# ---------------------------------------------------------------------
# the store: memory LRU over the atomic disk tier
# ---------------------------------------------------------------------

def test_memory_lru_bound_and_stats(tiny_result):
    rc = ResultCache(ResultCacheConfig(max_entries=2))
    for key in ("k1", "k2", "k3"):
        assert rc.put(key, tiny_result)
    assert len(rc) == 2
    assert rc.stats["mem_evictions"] == 1
    assert rc.lookup("k1") is None          # the oldest was evicted
    assert rc.lookup("k3") is tiny_result   # memory hit: same object
    assert rc.stats["hits"] == 1 and rc.stats["misses"] == 1


def test_lru_get_refreshes_recency(tiny_result):
    rc = ResultCache(ResultCacheConfig(max_entries=2))
    rc.put("k1", tiny_result)
    rc.put("k2", tiny_result)
    rc.lookup("k1")                 # touch: k2 becomes the eviction victim
    rc.put("k3", tiny_result)
    assert rc.lookup("k1") is not None and rc.lookup("k2") is None


def test_disk_roundtrip_fresh_instance(tiny_result, tmp_path):
    key = "a" * 64
    ResultCache(cache_dir=str(tmp_path)).put(key, tiny_result)
    entries = [n for n in os.listdir(tmp_path) if n.endswith(".nmfxres")]
    assert len(entries) == 1 and not any(
        n.endswith(".part") for n in os.listdir(tmp_path))
    fresh = ResultCache(cache_dir=str(tmp_path))
    got = fresh.lookup(key)
    assert got is not None and fresh.stats["hits"] == 1
    _bit_identical(got, tiny_result)
    # the disk hit was re-admitted to memory: second get is a mem hit
    assert fresh.lookup(key) is got


def test_corrupt_entry_dropped_warn_once(tiny_result, tmp_path):
    key = "b" * 64
    rc = ResultCache(cache_dir=str(tmp_path))
    rc.put(key, tiny_result)
    path = os.path.join(str(tmp_path), key[:40] + ".nmfxres")
    with open(path, "wb") as f:
        f.write(b"not a zip at all")
    fresh = ResultCache(cache_dir=str(tmp_path))
    with pytest.warns(RuntimeWarning, match="result cache"):
        assert fresh.lookup(key) is None
    assert not os.path.exists(path)  # unusable entry was dropped
    # warn ONCE per category: a second corrupt read stays quiet
    rc.put(key, tiny_result)
    with open(path, "wb") as f:
        f.write(b"garbage again")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert fresh.lookup(key) is None


def test_key_mismatched_entry_never_served(tiny_result, tmp_path):
    """An entry renamed onto another key's path (or a hash-prefix
    collision) fails the embedded verification record — a miss, never a
    wrong result."""
    k1, k2 = "c" * 64, "c" * 40 + "d" * 24  # same 40-char disk prefix
    rc = ResultCache(cache_dir=str(tmp_path))
    rc.put(k1, tiny_result)
    fresh = ResultCache(cache_dir=str(tmp_path))
    with pytest.warns(RuntimeWarning, match="result cache"):
        assert fresh.lookup(k2) is None


def test_disk_byte_cap_evicts_oldest(tiny_result, tmp_path):
    rc = ResultCache(ResultCacheConfig(cache_dir=str(tmp_path),
                                       max_disk_bytes=1))
    rc.put("d" * 64, tiny_result)
    rc.put("e" * 64, tiny_result)
    entries = [n for n in os.listdir(tmp_path) if n.endswith(".nmfxres")]
    # the cap admits the JUST-written entry even when it alone exceeds
    # it, evicting the older one
    assert entries == ["e" * 40 + ".nmfxres"]
    assert rc.stats["disk_evictions"] >= 1


def test_keep_factors_result_refused(small_data, tmp_path):
    res = nmfconsensus(small_data, solver_cfg=SolverConfig(max_iter=10),
                       keep_factors=True, device="cpu", **KW)
    rc = ResultCache(cache_dir=str(tmp_path))
    assert not rc.put("f" * 64, res)                 # retained stacks
    assert not rc.put("f" * 64, res,
                      ccfg=ConsensusConfig(keep_factors=True))
    assert rc.lookup("f" * 64) is None
    assert os.listdir(tmp_path) == []


# ---------------------------------------------------------------------
# the serving contract: warm hit = zero dispatches, zero h2d
# ---------------------------------------------------------------------

def test_serve_warm_hit_zero_dispatch_zero_h2d(small_data, tmp_path):
    scfg = SolverConfig(max_iter=20)
    cfg = ServeConfig(result_cache_dir=str(tmp_path))
    with NMFXServer(cfg, device="cpu") as srv:
        ref = srv.submit(small_data, solver_cfg=scfg,
                         **KW).result(timeout=240)
        d0 = serve_mod.dispatch_count()
        t0 = data_cache.transfer_count()
        b0 = data_cache.h2d_bytes()
        got = srv.submit(small_data, solver_cfg=scfg,
                         **KW).result(timeout=240)
        st = srv.stats()
    assert serve_mod.dispatch_count() == d0   # ZERO solve dispatches
    assert data_cache.transfer_count() == t0  # ZERO h2d transfers
    assert data_cache.h2d_bytes() == b0
    assert st["result_cache_hits"] == 1
    assert st["submitted"] == 2 and st["completed"] == 2
    _bit_identical(got, ref)


def test_serve_warm_hit_across_server_instances(small_data, tmp_path):
    """The disk tier carries results across processes/servers: a FRESH
    server over the same directory hits without solving."""
    scfg = SolverConfig(max_iter=20)
    cfg = ServeConfig(result_cache_dir=str(tmp_path))
    with NMFXServer(cfg, device="cpu") as srv:
        ref = srv.submit(small_data, solver_cfg=scfg,
                         **KW).result(timeout=240)
    d0 = serve_mod.dispatch_count()
    with NMFXServer(cfg, device="cpu") as srv2:
        got = srv2.submit(small_data, solver_cfg=scfg,
                          **KW).result(timeout=240)
        assert srv2.stats()["result_cache_hits"] == 1
    assert serve_mod.dispatch_count() == d0
    _bit_identical(got, ref)


def test_serve_config_change_misses(small_data, tmp_path):
    """A different seed must MISS — no stale serve across configs."""
    cfg = ServeConfig(result_cache_dir=str(tmp_path))
    scfg = SolverConfig(max_iter=20)
    with NMFXServer(cfg, device="cpu") as srv:
        srv.submit(small_data, solver_cfg=scfg, **KW).result(timeout=240)
        d0 = serve_mod.dispatch_count()
        srv.submit(small_data, solver_cfg=scfg,
                   **dict(KW, seed=6)).result(timeout=240)
        st = srv.stats()
    assert serve_mod.dispatch_count() > d0    # it really solved
    assert st["result_cache_hits"] == 0


def test_deadline_requests_bypass_cache(small_data, tmp_path):
    """A deadline'd request is ineligible (a replayed result cannot
    honor a latency contract it never saw): it solves, and does not
    count as a hit."""
    cfg = ServeConfig(result_cache_dir=str(tmp_path))
    scfg = SolverConfig(max_iter=20)
    with NMFXServer(cfg, device="cpu") as srv:
        srv.submit(small_data, solver_cfg=scfg, **KW).result(timeout=240)
        d0 = serve_mod.dispatch_count()
        srv.submit(small_data, solver_cfg=scfg, timeout=240.0,
                   **KW).result(timeout=240)
        st = srv.stats()
    assert serve_mod.dispatch_count() > d0
    assert st["result_cache_hits"] == 0  # never even looked up


def test_api_result_cache_roundtrip(small_data, tmp_path):
    rc = ResultCache(cache_dir=str(tmp_path), layer="api")
    scfg = SolverConfig(max_iter=20)
    ref = nmfconsensus(small_data, solver_cfg=scfg, device="cpu",
                       result_cache=rc, **KW)
    assert rc.stats["misses"] == 1 and rc.stats["puts"] == 1
    got = nmfconsensus(small_data, solver_cfg=scfg, device="cpu",
                       result_cache=rc, **KW)
    assert rc.stats["hits"] == 1
    _bit_identical(got, ref)


# ---------------------------------------------------------------------
# the port's own address space
# ---------------------------------------------------------------------

def test_port_key_differs_from_reference_for_equal_inputs():
    """Equal inputs and configurations: the port's key is not nmfx's
    (engine tag), and the card's is not the CPU's (device type), while
    the payload is otherwise the reference's."""
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    cfgs = dict(ks=(2, 3), restarts=4, seed=9)
    port = key_for_array(a, SolverConfig(max_iter=30),
                         ConsensusConfig(**cfgs), InitConfig(),
                         device="cpu")
    ref = nrc.key_for_array(a, NSolverConfig(max_iter=30),
                            NConsensusConfig(**cfgs), NInitConfig())
    assert port != ref
    assert port != key_for_array(a, SolverConfig(max_iter=30),
                                 ConsensusConfig(**cfgs), InitConfig(),
                                 device="cuda")
    assert key_for_array(a) == key_for_array(a, device="cuda")  # None
    # deterministic across calls and instances
    assert port == key_for_array(a.copy(), SolverConfig(max_iter=30),
                                 ConsensusConfig(**cfgs), InitConfig(),
                                 device="cpu")


def test_key_records_the_route():
    """The bucketed route (``ExecCache.route``) and the plain sweep's
    (None) key apart; equal routes key alike."""
    from nmfx_torch.exec_cache import ExecCache

    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    cfgs = (SolverConfig(max_iter=30), ConsensusConfig(ks=(2,)),
            InitConfig())
    route = ExecCache(device="cpu").route(a.shape, cfgs[1], cfgs[0])
    assert route == {"bucket": [256, 64], "pipeline_ranks": False}
    bucketed = key_for_array(a, *cfgs, device="cpu", route=route)
    assert bucketed != key_for_array(a, *cfgs, device="cpu")
    assert bucketed == key_for_array(a, *cfgs, device="cpu",
                                     route=dict(route))


def test_server_entry_serves_its_route_only(small_data, tmp_path):
    """A server stores a bucketed result: a plain ``nmfconsensus`` over
    the same directory and configuration misses and solves its own
    route, while one through an executable cache hits and gets the
    server's result byte for byte."""
    from nmfx_torch.exec_cache import ExecCache

    scfg = SolverConfig(max_iter=20)
    cfg = ServeConfig(result_cache_dir=str(tmp_path))
    with NMFXServer(cfg, device="cpu") as srv:
        served = srv.submit(small_data, solver_cfg=scfg,
                            **KW).result(timeout=240)
    rc = ResultCache(cache_dir=str(tmp_path), layer="api")
    plain = nmfconsensus(small_data, solver_cfg=scfg, device="cpu",
                         result_cache=rc, **KW)
    # it solved, and stored its own result at its own address
    assert rc.stats["hits"] == 0 and rc.stats["misses"] == 1
    assert rc.stats["puts"] == 1
    assert set(plain.per_k) == set(served.per_k)
    got = nmfconsensus(small_data, solver_cfg=scfg, device="cpu",
                       result_cache=rc, exec_cache=ExecCache(device="cpu"),
                       **KW)
    assert rc.stats["hits"] == 1
    for k in served.per_k:
        for f in ("consensus", "membership", "iterations", "dnorms"):
            assert np.array_equal(getattr(got.per_k[k], f),
                                  getattr(served.per_k[k], f)), (k, f)
