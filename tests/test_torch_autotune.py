"""The block-shape autotuner (``nmfx_torch/autotune.py``) against
``nmfx/autotune.py``, on the CPU.

The counterparts of ``tests/test_autotune.py``'s eleven cases (a cold
resolve searches once; a warm one, from the memo or from disk, serves
the identical config with no search; nothing short of a full key match
is served), a fresh interpreter served from disk with no search, and the
parity with ``nmfx``: the same key fields, buckets and candidates, the
same pick under one timing table, and an autotuned sweep byte-equal to
the sweep with the resolved values explicit and, at the tier the port's
pallas grid is held to against ``nmfx`` (best k and memberships equal),
equal to ``nmfx``'s autotuned sweep. On the CPU the search times the
kernels' plain versions, as ``nmfx`` times interpret mode there: what is
pinned is the store's logic, not a kernel's speed.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import nmfx
import nmfx_torch
from nmfx import autotune as jtune
from nmfx_torch import autotune
from nmfx_torch.config import (ConsensusConfig, ExecCacheConfig,
                               ExperimentalConfig, InitConfig, SolverConfig)
from nmfx_torch.convert import solver_config_from_dict
from nmfx_torch.datasets import grouped_matrix, two_group_matrix
from nmfx_torch.harvest import fetch_host
from nmfx_torch.sweep import sweep
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)

M, N, K, SLOTS = 64, 32, 2, 2
CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clear(mod):
    with mod._lock:
        mod._memo.clear()
        mod._warned.clear()


@pytest.fixture(autouse=True)
def _fresh_store():
    """Each test starts as a fresh process would: empty memos and warn-once
    sets in both packages (the counters are process-wide: tests read
    deltas)."""
    _clear(autotune)
    _clear(jtune)
    yield
    _clear(autotune)
    _clear(jtune)


@pytest.fixture
def small_grid(monkeypatch):
    """Key-isolation tests force repeated cold searches: two candidates
    each (the full grid's cold path runs once, in
    test_cold_search_warm_memo_warm_disk)."""
    real = autotune._candidates
    monkeypatch.setattr(autotune, "_candidates",
                        lambda *a, **k: real(*a, **k)[:2])


def _cfg(**exp_kw):
    exp_kw.setdefault("autotune", "on")
    return SolverConfig(backend="pallas", max_iter=40,
                        experimental=ExperimentalConfig(**exp_kw))


def _counters():
    return autotune.searches_total.total(), autotune.hits_total.total()


def _resolve(cfg, cache_dir=None):
    return autotune.resolve(cfg, M, N, K, SLOTS, cache_dir=cache_dir,
                            device=CPU)


def _entry(d):
    return autotune._disk_path(d, autotune._key_repr(
        _cfg(), M, N, K, SLOTS, autotune.torch.device(CPU)))


# --- the counterparts of tests/test_autotune.py ------------------------

def test_cold_search_warm_memo_warm_disk(tmp_path):
    """One search cold; a memo hit warm; after a simulated restart (memo
    cleared) the stored entry serves the identical config."""
    d = str(tmp_path)
    s0, h0 = _counters()
    cold = _resolve(_cfg(), d)
    s1, h1 = _counters()
    assert (s1 - s0, h1 - h0) == (1, 0)
    assert cold.experimental.autotune == "off"
    assert cold.check_block != "auto"
    assert cold.experimental.block_m is not None
    assert cold.experimental.fused_updates in ("phased", "fused")
    warm_memo = _resolve(_cfg(), d)
    s2, h2 = _counters()
    assert (s2 - s1, h2 - h1) == (0, 1)
    assert warm_memo == cold
    with autotune._lock:
        autotune._memo.clear()
    warm_disk = _resolve(_cfg(), d)
    s3, h3 = _counters()
    assert (s3 - s2, h3 - h2) == (0, 1)
    assert warm_disk == cold


def test_corrupt_entry_warns_once_and_researches(tmp_path, small_grid):
    d = str(tmp_path)
    _resolve(_cfg(), d)
    path = _entry(d)
    assert os.path.exists(path)
    with open(path, "w") as f:
        f.write('{"format": 1, "best"')  # truncated mid-record
    with autotune._lock:
        autotune._memo.clear()
    s0, _ = _counters()
    with pytest.warns(RuntimeWarning, match="corrupt"):
        again = _resolve(_cfg(), d)
    s1, _ = _counters()
    assert s1 - s0 == 1
    assert again.check_block != "auto"
    assert again.experimental.block_m is not None
    with open(path) as f:
        assert json.load(f)["format"] == autotune._FORMAT


def test_foreign_key_entry_never_served(tmp_path, small_grid):
    d = str(tmp_path)
    _resolve(_cfg(), d)
    path = _entry(d)
    with open(path) as f:
        rec = json.load(f)
    rec["key"] = "something else entirely"
    with open(path, "w") as f:
        json.dump(rec, f)
    with autotune._lock:
        autotune._memo.clear()
    s0, _ = _counters()
    with pytest.warns(RuntimeWarning, match="different key"):
        _resolve(_cfg(), d)
    s1, _ = _counters()
    assert s1 - s0 == 1


def test_env_mismatch_not_served(tmp_path, monkeypatch, small_grid):
    """Another environment fingerprint (another card, CUDA, torch or
    kernel build) keys another entry: the warm path misses."""
    d = str(tmp_path)
    _resolve(_cfg(), d)
    with autotune._lock:
        autotune._memo.clear()
    monkeypatch.setattr(autotune, "_env_fingerprint",
                        lambda device: ("torch-9.9.9", "cuda-99.9",
                                        "NVIDIA H900", "sm_99",
                                        "libblock_mu_0.so"))
    s0, h0 = _counters()
    _resolve(_cfg(), d)
    s1, h1 = _counters()
    assert (s1 - s0, h1 - h0) == (1, 0)


def test_config_field_splits_key(tmp_path, small_grid):
    d = str(tmp_path)
    _resolve(_cfg(), d)
    s0, h0 = _counters()
    _resolve(dataclasses.replace(_cfg(), matmul_precision="highest"), d)
    s1, h1 = _counters()
    assert (s1 - s0, h1 - h0) == (1, 0)


def test_explicit_overrides_win_and_share_entry(tmp_path, small_grid):
    d = str(tmp_path)
    _resolve(_cfg(), d)
    s0, h0 = _counters()
    explicit = SolverConfig(
        backend="pallas", max_iter=40, check_block=2,
        experimental=ExperimentalConfig(autotune="on", block_m=128,
                                        fused_updates="fused"))
    got = autotune.resolve(explicit, M, N, K, SLOTS, cache_dir=d,
                           device=CPU)
    s1, h1 = _counters()
    assert (s1 - s0, h1 - h0) == (0, 1)
    assert got.check_block == 2
    assert got.experimental.block_m == 128
    assert got.experimental.fused_updates == "fused"


def test_off_and_non_pallas_are_noops():
    """"off" is the identity; "on" off the pallas route or on the ragged
    pool flips only the flag. None of them reads a device: no card is
    needed even without ``device``."""
    s0, h0 = _counters()
    off = SolverConfig(backend="pallas", max_iter=40)
    assert autotune.resolve(off, M, N, K, SLOTS) is off
    dense = autotune.resolve(SolverConfig(
        backend="auto", max_iter=40,
        experimental=ExperimentalConfig(autotune="on")), M, N, K, SLOTS)
    assert dense.experimental.autotune == "off"
    assert dense.check_block == "auto"
    assert dense.experimental.block_m is None
    ragged = autotune.resolve(_cfg(ragged=True), M, N, K, SLOTS)
    assert ragged.experimental.autotune == "off"
    assert ragged.experimental.ragged is True
    assert ragged.check_block == "auto"
    s1, h1 = _counters()
    assert (s1 - s0, h1 - h0) == (0, 0)


def test_resolve_idempotent(tmp_path, small_grid):
    d = str(tmp_path)
    once = _resolve(_cfg(), d)
    assert _resolve(once, d) is once


def test_hals_candidates_respect_tolfun():
    armed = autotune._candidates(
        SolverConfig(algorithm="hals", backend="pallas", max_iter=40),
        256, 64, K, SLOTS)
    assert armed and all(c["check_block"] == 1 for c in armed)
    assert all(c["fused_updates"] == "phased" for c in armed)
    open_ = autotune._candidates(
        SolverConfig(algorithm="hals", backend="pallas", max_iter=40,
                     use_tol_checks=False),
        256, 64, K, SLOTS)
    assert any(c["check_block"] > 1 for c in open_)
    assert all(c["fused_updates"] == "phased" for c in open_)


def test_autotune_key_fields_hook():
    solver, exp = autotune.autotune_key_fields()
    assert "check_block" not in solver
    assert "backend" in solver and "max_iter" in solver
    assert {"autotune", "block_m", "fused_updates"}.isdisjoint(exp)
    assert "factor_dtype" in exp and "ragged" in exp


def test_sweep_resolves_before_solving(tmp_path, small_grid):
    """A sweep with autotune "on" resolves once before solving (one
    search); a second identical sweep is warm and byte-equal."""
    a = grouped_matrix(96, (48, 48), effect=2.0, seed=0).astype(np.float32)
    ccfg = ConsensusConfig(ks=(2, 3), restarts=3, grid_exec="grid")
    s0, h0 = _counters()
    cold = sweep(a, ccfg, _cfg(), InitConfig(), device=CPU)
    s1, h1 = _counters()
    assert s1 - s0 == 1
    warm = sweep(a, ccfg, _cfg(), InitConfig(), device=CPU)
    s2, h2 = _counters()
    assert (s2 - s1, h2 > h1) == (0, True)
    for k in (2, 3):
        c, w = fetch_host(cold[k]), fetch_host(warm[k])
        np.testing.assert_array_equal(c.consensus, w.consensus)
        np.testing.assert_array_equal(c.iterations, w.iterations)


# --- a fresh interpreter --------------------------------------------------

_FRESH = """
import sys
from nmfx_torch import autotune
from nmfx_torch.config import ExperimentalConfig, SolverConfig
cfg = SolverConfig(backend="pallas", max_iter=40,
                   experimental=ExperimentalConfig(autotune="on"))
got = autotune.resolve(cfg, {m}, {n}, {k}, {slots}, cache_dir=sys.argv[1],
                       device="cpu")
print(repr(got))
print(int(autotune.searches_total.total()), int(autotune.hits_total.total()))
"""


def test_fresh_process_served_from_disk(tmp_path, small_grid):
    """A new interpreter at the same cache directory resolves the
    identical config with 0 searches and 1 hit."""
    d = str(tmp_path)
    cold = _resolve(_cfg(), d)
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                            "")}
    proc = subprocess.run(
        [sys.executable, "-c",
         _FRESH.format(m=M, n=N, k=K, slots=SLOTS), d],
        capture_output=True, text=True, timeout=60, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line, counts = proc.stdout.strip().splitlines()[-2:]
    assert line == repr(cold)
    assert counts.split() == ["0", "1"]


# --- parity with nmfx -----------------------------------------------------

def test_key_fields_equal_nmfx():
    assert autotune.autotune_key_fields() == jtune.autotune_key_fields()
    assert autotune.AUTOTUNE_EXEMPT_SOLVER == jtune.AUTOTUNE_EXEMPT_SOLVER
    assert (autotune.AUTOTUNE_EXEMPT_EXPERIMENTAL
            == jtune.AUTOTUNE_EXEMPT_EXPERIMENTAL)


@pytest.mark.parametrize("m", [1, 64, 255, 256, 257, 1000, 2049, 5000,
                               20000])
@pytest.mark.parametrize("n", [1, 24, 64, 65, 500, 513, 4000])
def test_shape_bucket_equals_nmfx(m, n):
    for k_max, slots in ((2, 2), (10, 48)):
        assert (autotune.shape_bucket(m, n, k_max, slots)
                == jtune.shape_bucket(m, n, k_max, slots))


@pytest.mark.parametrize("algorithm, tol", [("mu", True), ("hals", True),
                                            ("hals", False)])
def test_candidates_equal_nmfx(algorithm, tol):
    """At 64×32, k = 2, 2 slots (where nmfx's VMEM envelope prunes
    nothing) both grids are the same list, in the same order."""
    kw = dict(algorithm=algorithm, backend="pallas", max_iter=40,
              use_tol_checks=tol)
    m_b, n_b = autotune.shape_bucket(M, N, K, SLOTS)[:2]
    got = autotune._candidates(SolverConfig(**kw), m_b, n_b, K, SLOTS)
    want = jtune._candidates(nmfx.SolverConfig(**kw), m_b, n_b, K, SLOTS)
    assert got == want


#: one deterministic timing table (seconds per iteration by candidate
#: label); its winners are not the scheduler's defaults
TABLE = {"bm256_cb1_phased": 5.0, "bm256_cb1_fused": 4.0,
         "bm256_cb4_phased": 3.0, "bm256_cb4_fused": 2.5,
         "bm512_cb1_phased": 2.0, "bm512_cb1_fused": 1.0,
         "bm512_cb4_phased": 1.5, "bm512_cb4_fused": 1.2}


@pytest.fixture
def one_table(monkeypatch):
    def timed(mod):
        return lambda cfg, cand, *a, **k: TABLE[mod._cand_label(cand)]

    monkeypatch.setattr(autotune, "_time_candidate", timed(autotune))
    monkeypatch.setattr(jtune, "_time_candidate", timed(jtune))


def _picked(cfg):
    return (cfg.experimental.block_m, cfg.check_block,
            cfg.experimental.fused_updates)


@pytest.mark.parametrize("algorithm", ["mu", "hals"])
def test_same_pick_as_nmfx_under_one_table(one_table, algorithm):
    kw = dict(algorithm=algorithm, backend="pallas", max_iter=40)
    got = autotune.resolve(SolverConfig(
        **kw, experimental=ExperimentalConfig(autotune="on")),
        M, N, K, SLOTS, device=CPU)
    want = jtune.resolve(nmfx.SolverConfig(
        **kw, experimental=nmfx.ExperimentalConfig(autotune="on")),
        M, N, K, SLOTS)
    assert _picked(got) == _picked(want)
    assert _picked(got) == ((512, 1, "fused") if algorithm == "mu"
                            else (512, 1, "phased"))


SWEEP_A = dict(n_genes=200, n_per_group=12, seed=3)
SWEEP_ARGS = dict(ks=(2, 3), restarts=4, seed=11, grid_exec="grid")


def _sweep_cfg(pkg, **exp):
    return pkg.SolverConfig(backend="pallas", max_iter=300,
                            stable_checks=30,
                            experimental=pkg.ExperimentalConfig(**exp))


def test_tuned_sweep_byte_equal_to_explicit(tmp_path):
    """The autotuned sweep (its store under the executable cache's
    directory) equals, byte for byte, the sweep given the resolved
    values explicitly."""
    from nmfx_torch.exec_cache import ExecCache

    a = two_group_matrix(**SWEEP_A)
    cache = ExecCache(ExecCacheConfig(cache_dir=str(tmp_path)), device=CPU)
    s0, _ = _counters()
    tuned = nmfx_torch.nmfconsensus(
        a, solver_cfg=_sweep_cfg(nmfx_torch, autotune="on"), device=CPU,
        exec_cache=cache, **SWEEP_ARGS)
    s1, _ = _counters()
    assert s1 - s0 == 1
    (entry,) = os.listdir(tmp_path / "autotune")
    with open(tmp_path / "autotune" / entry) as f:
        best = json.load(f)["best"]
    explicit = nmfx_torch.nmfconsensus(
        a, solver_cfg=dataclasses.replace(
            _sweep_cfg(nmfx_torch, block_m=best["block_m"],
                       fused_updates=best["fused_updates"]),
            check_block=best["check_block"]),
        device=CPU, exec_cache=cache, **SWEEP_ARGS)
    assert tuned.best_k == explicit.best_k
    for k in SWEEP_ARGS["ks"]:
        t, e = tuned.per_k[k], explicit.per_k[k]
        for field in ("consensus", "membership", "iterations", "dnorms",
                      "stop_reasons"):
            got, want = np.asarray(getattr(t, field)), np.asarray(
                getattr(e, field))
            assert got.dtype == want.dtype and got.tobytes() == \
                want.tobytes(), (k, field)


def test_tuned_sweep_matches_nmfx_tuned_sweep(one_table):
    """Both packages' autotuned sweeps under one timing table: the same
    resolved schedule, the reference's best k and memberships."""
    a = two_group_matrix(**SWEEP_A)
    want = nmfx.nmfconsensus(a, solver_cfg=_sweep_cfg(nmfx, autotune="on"),
                             use_mesh=False, **SWEEP_ARGS)
    got = nmfx_torch.nmfconsensus(
        a, solver_cfg=solver_config_from_dict(dataclasses.asdict(
            _sweep_cfg(nmfx, autotune="on"))), device=CPU, **SWEEP_ARGS)
    assert got.best_k == want.best_k
    for k in SWEEP_ARGS["ks"]:
        assert np.isfinite(got.per_k[k].consensus).all()
        np.testing.assert_array_equal(got.per_k[k].membership,
                                      want.per_k[k].membership)
