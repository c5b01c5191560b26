"""Each rule of the port's contract linter (``nmfx_torch.analysis``) on
``nmfx``'s fixtures of ``tests/test_lint_rules.py``, rewritten with the
port's module names.

* The AST rules (NMFX006, NMFX012-015, the suppression machinery) run
  through both packages' ``run()`` on the same fixture file: the port's
  source, and the same text with ``nmfx_torch`` read as ``nmfx`` for the
  reference. Each gives the same set of (rule id, line, suppressed).
* The declaration rules (NMFX001, 007, 008, 009, 010, 011) keep the
  reference's pure ``check_*`` functions: each changed universe gives the
  reference's problems word for word, the package and metric-table names
  read as the reference's.
* The live tree passes each pure check, each whole-package rule fires
  through ``run()`` on a changed live declaration, anchored where the
  reference anchors it, and the command line, baselines and the NMFX001
  wrong-tree guard behave as the reference's.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

import nmfx.analysis as janalysis
from nmfx.analysis import rules_config as jconfig
from nmfx.analysis import rules_obs as jobs
from nmfx.obs import costmodel as jcost
from nmfx_torch import analysis
from nmfx_torch.analysis import active, run
from nmfx_torch.analysis import rules_config, rules_obs, rules_perf
from nmfx_torch.obs import costmodel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTED = ("NMFX001", "NMFX004", "NMFX005", "NMFX006", "NMFX007",
          "NMFX008", "NMFX009", "NMFX010", "NMFX011", "NMFX012",
          "NMFX013", "NMFX014", "NMFX015")
NOT_PORTED = ("NMFX002", "NMFX003", "NMFX101", "NMFX102")


def _as_nmfx(text: str) -> str:
    """The reference's spelling of a port message or fixture."""
    return (text.replace("nmfx_torch", "nmfx")
            .replace("observability_torch.md", "observability.md"))


def _write(tmp_path, source, name="fixture.py"):
    path = tmp_path / name
    path.write_text(textwrap.dedent(source))
    return str(path)


def _ids(findings):
    return [f.rule_id for f in active(findings)]


# --------------------------------------------------------------------------
# AST fixtures: (rules, expected active ids, the port's source)
# --------------------------------------------------------------------------

_HANDLER_BAD = """
    def fetch(cache, key):
        try:
            return cache[key].load()
        except Exception:
            return None  # silent degradation: nobody will ever know
"""

_HANDLER_CLEAN_WARN = """
    from nmfx_torch.faults import warn_once

    def fetch(cache, key, fallback):
        try:
            return cache[key].load()
        except Exception as e:
            warn_once("cache-fallback", f"degraded ({e!r})")
            return fallback()
"""

_GUARDED_HEADER = """
    import threading
    from nmfx_torch.guards import guarded_by

"""

_GUARDED_BOX = """
    @guarded_by("_lock", "_items", "count")
    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self._items = []
            self.count = 0
"""

_REC = """
    import threading

    class Rec:
        def __init__(self):
            self._lock = threading.{ctor}()

        def dump(self):
            with self._lock:
                self.snapshot()

        def snapshot(self):
            with self._lock:
                return 1
"""

FIXTURES = {
    # NMFX006
    "006-silent-swallow": (("NMFX006",), ["NMFX006"], _HANDLER_BAD),
    "006-bare-except": (("NMFX006",), ["NMFX006"], _HANDLER_BAD.replace(
        "except Exception:", "except:")),
    "006-broad-in-tuple": (("NMFX006",), ["NMFX006"], _HANDLER_BAD.replace(
        "except Exception:", "except (KeyError, Exception):")),
    "006-reraise": (("NMFX006",), [], """
        class TypedError(RuntimeError):
            pass

        def fetch(cache, key):
            try:
                return cache[key].load()
            except Exception as e:
                raise TypedError("load failed") from e
    """),
    "006-future-resolution": (("NMFX006",), [], """
        def resolve(fut, work):
            try:
                fut.set_result(work())
            except BaseException as e:
                fut.set_exception(e)
    """),
    "006-warn-once": (("NMFX006",), [], _HANDLER_CLEAN_WARN),
    "006-scoped-warn-once": (("NMFX006",), [], _HANDLER_CLEAN_WARN.replace(
        "from nmfx_torch.faults import warn_once\n", "").replace(
        'warn_once("cache-fallback"', 'cache._warn_once("cache-fallback"')),
    "006-narrow-handler": (("NMFX006",), [], """
        def fetch(cache, key):
            try:
                return cache[key].load()
            except KeyError:
                return None  # narrow: a considered, specific decision
    """),
    "006-nested-def-does-not-count": (("NMFX006",), ["NMFX006"], """
        from nmfx_torch.faults import warn_once

        def fetch(cache, key):
            try:
                return cache[key].load()
            except Exception as e:
                def later():
                    warn_once("cache", f"degraded ({e!r})")
                return later
    """),
    "006-suppression-with-reason": (("NMFX006",), [], _HANDLER_BAD.replace(
        "except Exception:",
        "except Exception:  # nmfx: ignore[NMFX006] -- best-effort")),
    # the suppression machinery (the reference's cases, on NMFX006)
    "000-suppression-in-string-literal-inert": (
        ("NMFX006",), ["NMFX006"],
        _HANDLER_BAD + '    _DOC = "example:  # nmfx: ignore[NMFX006]"\n'),
    "000-suppression-without-reason": (
        ("NMFX006",), ["NMFX000", "NMFX006"], _HANDLER_BAD.replace(
            "except Exception:",
            "except Exception:  # nmfx: ignore[NMFX006]")),
    # NMFX012
    "012-clean-twin": (("NMFX012",), [], _GUARDED_HEADER + _GUARDED_BOX
                       + """
        def push(self, x):
            with self._lock:
                self._items.append(x)
                self.count += 1

        def flush(self):
            with self._lock:
                self._drain()

        def _drain(self):
            # no with: provably called under the lock (fixpoint)
            self._items.clear()
            self.count = 0
"""),
    "012-unguarded-access": (("NMFX012",), ["NMFX012", "NMFX012"],
                             _GUARDED_HEADER + _GUARDED_BOX + """
        def push(self, x):
            self._items.append(x)
            self.count += 1
"""),
    "012-init-exempt": (("NMFX012",), [], _GUARDED_HEADER + """
    @guarded_by("_lock", "_items")
    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self._items = []
    """),
    "012-stale-declaration": (("NMFX012",), ["NMFX012"],
                              _GUARDED_HEADER + """
    @guarded_by("_missing_lock", "_items")
    class Box:
        def __init__(self):
            self._items = []
    """),
    "012-suppression-with-reason": (("NMFX012",), [],
                                    _GUARDED_HEADER + """
    @guarded_by("_lock", "count")
    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self.count = 0

        def peek(self):
            return self.count  # nmfx: ignore[NMFX012] -- racy read OK
    """),
    # NMFX013
    "013-consistent-order": (("NMFX013",), [], """
    import threading

    class Svc:
        def __init__(self):
            self._a = threading.Lock()
            self._b = threading.Lock()

        def one(self):
            with self._a:
                with self._b:
                    pass

        def two(self):
            with self._a:
                with self._b:
                    pass
    """),
    "013-inverted-order-cycle": (("NMFX013",), ["NMFX013"], """
    import threading

    class Svc:
        def __init__(self):
            self._lock = threading.Lock()
            self._tracked_lock = threading.Lock()

        def resolve(self):
            with self._lock:
                self._untrack()

        def _untrack(self):
            with self._tracked_lock:
                pass

        def expire(self):
            with self._tracked_lock:
                with self._lock:
                    pass
    """),
    "013-plain-lock-reentry": (("NMFX013",), ["NMFX013"],
                               _REC.format(ctor="Lock")),
    "013-rlock-reentry-exempt": (("NMFX013",), [],
                                 _REC.format(ctor="RLock")),
    # NMFX014
    "014-dead-future": (("NMFX014",), ["NMFX014"], """
    from concurrent.futures import Future

    class Svc:
        def submit(self, k):
            fut = Future()
            return k
    """),
    "014-unprotected-publication-gap": (("NMFX014",), ["NMFX014"], """
    from concurrent.futures import Future

    class Pipe:
        def submit(self, k):
            fut = Future()
            self._futures[k] = fut
            self._spawn_worker()

        def _spawn_worker(self):
            raise RuntimeError
    """),
    "014-protecting-handler": (("NMFX014",), [], """
    from concurrent.futures import Future

    class Rep:
        def forward(self, rid):
            fut = Future()
            self._pending[rid] = fut
            try:
                self._write_record(rid)
            except Exception:
                self._pending.pop(rid, None)
                raise
            return fut

        def _write_record(self, rid):
            raise OSError
    """),
    "014-lexical-resolution": (("NMFX014",), [], """
    from concurrent.futures import Future

    class Cache:
        def executable(self, key):
            fut = Future()
            self._inflight[key] = fut
            entry = self._build(key)
            fut.set_result(entry)
            return entry

        def _build(self, key):
            return key
    """),
    "014-ownership-transfer": (("NMFX014",), [], """
    from concurrent.futures import Future

    def dispatch(router, req):
        fut = Future()
        router.register(req, fut)
    """),
    # NMFX015
    "015-unowned-thread": (("NMFX015",), ["NMFX015"], """
    import threading

    class Svc:
        def start(self):
            t = threading.Thread(target=self._run)
            t.start()
    """),
    "015-daemon": (("NMFX015",), [], """
    import threading

    class Svc:
        def start(self):
            t = threading.Thread(target=self._run, daemon=True)
            t.start()
    """),
    "015-joined-container": (("NMFX015",), [], """
    import threading

    class Svc:
        def start(self):
            t = threading.Thread(target=self._run)
            t.start()
            self._threads.append(t)

        def close(self):
            for t in self._threads:
                t.join()
    """),
    "015-local-join": (("NMFX015",), [], """
    import threading

    def run_both(fn):
        t = threading.Thread(target=fn)
        t.start()
        fn()
        t.join()
    """),
    "015-timer-cancel": (("NMFX015",), [], """
    import threading

    class Svc:
        def start(self):
            self._timer = threading.Timer(5.0, self._fire)
            self._timer.start()

        def close(self):
            self._timer.cancel()
    """),
}


def _key(findings):
    return sorted((f.rule_id, f.line, f.suppressed) for f in findings)


@pytest.mark.parametrize("case", sorted(FIXTURES))
def test_fixture_findings_equal_nmfx(case, tmp_path):
    rules, expected, source = FIXTURES[case]
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    port_dir.mkdir()
    ref_dir.mkdir()
    got = run([_write(port_dir, source)], rule_ids=rules)
    want = janalysis.run([_write(ref_dir, _as_nmfx(source))], jaxpr=False,
                         rule_ids=rules)
    assert _ids(got) == expected
    assert _key(got) == _key(want)
    for g, w in zip(sorted(got, key=lambda f: (f.line, f.rule_id)),
                    sorted(want, key=lambda f: (f.line, f.rule_id))):
        assert _as_nmfx(g.message) == w.message or g.rule_id == "NMFX006"


def test_fixture_messages_name_the_offender(tmp_path):
    """What the reference's per-rule tests read in the messages."""
    def first(source, rules):
        return active(run([_write(tmp_path, source)], rule_ids=rules))

    assert "except Exception" in first(_HANDLER_BAD, ("NMFX006",))[0].message
    bare = first(_HANDLER_BAD.replace("except Exception:", "except:"),
                 ("NMFX006",))
    assert "bare except" in bare[0].message
    guarded = first(FIXTURES["012-unguarded-access"][2], ("NMFX012",))
    assert "self._items" in guarded[0].message
    assert "without it in Box.push" in guarded[0].message
    stale = first(FIXTURES["012-stale-declaration"][2], ("NMFX012",))
    assert "_missing_lock" in stale[0].message
    cycle = first(FIXTURES["013-inverted-order-cycle"][2], ("NMFX013",))
    assert "cycle" in cycle[0].message and "_lock" in cycle[0].message
    reentry = first(FIXTURES["013-plain-lock-reentry"][2], ("NMFX013",))
    assert "self-deadlock" in reentry[0].message
    dead = first(FIXTURES["014-dead-future"][2], ("NMFX014",))
    assert "never resolves" in dead[0].message
    gap = first(FIXTURES["014-unprotected-publication-gap"][2],
                ("NMFX014",))
    assert "publishes Future" in gap[0].message
    assert "_spawn_worker" in gap[0].message
    thread = first(FIXTURES["015-unowned-thread"][2], ("NMFX015",))
    assert "non-daemon" in thread[0].message


# --------------------------------------------------------------------------
# declaration rules: the pure checks on changed universes
# --------------------------------------------------------------------------

def _universe(**overrides):
    base = dict(
        solver_fields=frozenset({"algorithm", "tol_x", "restart_chunk",
                                 "experimental"}),
        experimental_fields=frozenset({"ragged"}),
        fingerprint_covered=frozenset({"algorithm", "tol_x",
                                       "experimental"}),
        fingerprint_excluded=("restart_chunk",),
        declared_non_numerics=("restart_chunk",),
        exec_key_covered=frozenset({"algorithm", "tol_x", "restart_chunk",
                                    "experimental"}),
        persist_key_covered=frozenset({"algorithm", "tol_x",
                                       "restart_chunk", "experimental"}),
        hashable_configs={"SolverConfig": True, "ExperimentalConfig": True},
    )
    base.update(overrides)
    return base


_AT_COVERED = frozenset({"algorithm", "tol_x", "restart_chunk",
                         "experimental"})

NMFX001 = {
    "clean": _universe(),
    "field-dropped-from-fingerprint": _universe(
        fingerprint_covered=frozenset({"algorithm", "experimental"})),
    "undeclared-exclusion": _universe(
        fingerprint_excluded=("restart_chunk", "tol_x"),
        fingerprint_covered=frozenset({"algorithm", "experimental"})),
    "stale-declaration": _universe(
        declared_non_numerics=("restart_chunk", "gone_field")),
    "stale-resolved-declaration": _universe(
        fingerprint_resolved=("gone_field",)),
    "exec-key-gap": _universe(exec_key_covered=frozenset(
        {"algorithm", "restart_chunk", "experimental"})),
    "persist-key-gap": _universe(persist_key_covered=frozenset(
        {"algorithm", "restart_chunk", "experimental"})),
    "nested-nonrepr-field": _universe(
        nonrepr_fields={"ExperimentalConfig": ("hidden",)}),
    "persist-key-not-provided": {
        k: v for k, v in _universe().items() if k != "persist_key_covered"},
    "unhashable-config": _universe(hashable_configs={
        "SolverConfig": False, "ExperimentalConfig": True}),
    "noncompare-field": _universe(
        noncompare_fields={"ExperimentalConfig": ("sneaky",)}),
    "data-key-gap": _universe(
        data_fields=frozenset({"fingerprint", "shape", "dtype"}),
        data_key_covered=frozenset({"fingerprint", "shape"})),
    "data-key-covered": _universe(
        data_fields=frozenset({"fingerprint", "shape"}),
        data_key_covered=frozenset({"fingerprint", "shape"})),
    "data-key-not-provided": _universe(
        data_fields=frozenset({"fingerprint"})),
    "serve-key-gap": _universe(
        serve_fields=frozenset({"max_queue_depth", "pack",
                                "batch_linger_s"}),
        serve_key_covered=frozenset({"max_queue_depth", "pack"})),
    "serve-key-covered": _universe(
        serve_fields=frozenset({"max_queue_depth", "pack"}),
        serve_key_covered=frozenset({"max_queue_depth", "pack"})),
    "serve-key-not-provided": _universe(
        serve_fields=frozenset({"max_queue_depth"})),
    "autotune-key-gap": _universe(
        autotune_solver_covered=frozenset({"algorithm", "experimental"}),
        autotune_experimental_covered=frozenset({"ragged"}),
        autotune_exempt_solver=("restart_chunk",)),
    "autotune-experimental-gap": _universe(
        autotune_solver_covered=_AT_COVERED,
        autotune_experimental_covered=frozenset()),
    "autotune-stale-exemption": _universe(
        autotune_solver_covered=_AT_COVERED,
        autotune_experimental_covered=frozenset({"ragged"}),
        autotune_exempt_solver=("gone_knob",)),
    "autotune-contradictory-declaration": _universe(
        autotune_solver_covered=_AT_COVERED,
        autotune_experimental_covered=frozenset({"ragged"}),
        autotune_exempt_solver=("tol_x",)),
    "autotune-clean-twin": _universe(
        autotune_solver_covered=frozenset({"algorithm", "tol_x",
                                           "experimental"}),
        autotune_experimental_covered=frozenset({"ragged"}),
        autotune_exempt_solver=("restart_chunk",)),
}


def _manifest_universe(**overrides):
    base = dict(
        solver_fields=frozenset({"algorithm", "tol_x", "restart_chunk"}),
        consensus_fields=frozenset({"restarts", "seed", "label_rule",
                                    "ks", "linkage"}),
        manifest_solver=frozenset({"algorithm", "tol_x"}),
        manifest_consensus=frozenset({"restarts", "seed", "label_rule"}),
        declared_non_numerics=("restart_chunk",),
        manifest_consensus_excluded=("ks", "linkage"),
        declared_checkpoint_exempt=("ks", "linkage"),
    )
    base.update(overrides)
    return base


NMFX007 = {
    "clean": _manifest_universe(),
    "solver-field-dropped": _manifest_universe(
        manifest_solver=frozenset({"algorithm"})),
    "consensus-field-dropped": _manifest_universe(
        manifest_consensus=frozenset({"restarts", "label_rule"})),
    "undeclared-exclusion": _manifest_universe(
        manifest_consensus=frozenset({"restarts", "label_rule"}),
        manifest_consensus_excluded=("ks", "linkage", "seed")),
    "stale-exempt-declaration": _manifest_universe(
        declared_checkpoint_exempt=("ks", "linkage", "not_a_field")),
}


def _obs_universe(**over):
    base = dict(sites=frozenset({"h2d.transfer", "serve.scheduler"}),
                event_covered=frozenset({"h2d.transfer",
                                         "serve.scheduler"}))
    base.update(over)
    return base


NMFX008 = {
    "clean": _obs_universe(),
    "missing-site": _obs_universe(event_covered=frozenset(
        {"h2d.transfer"})),
    "stale-mapping": _obs_universe(event_covered=frozenset(
        {"h2d.transfer", "serve.scheduler", "old.renamed_site"})),
}


def _perf_universe(**over):
    base = dict(
        universe=frozenset({("mu", "packed"), ("mu", "vmap"),
                            ("kl", "vmap")}),
        covered=frozenset({("mu", "packed"), ("mu", "vmap"),
                           ("kl", "vmap")}),
        exempt=("pg",),
        algorithms=frozenset({"mu", "kl", "pg"}))
    base.update(over)
    return base


NMFX009 = {
    "clean": _perf_universe(),
    "missing-model": _perf_universe(covered=frozenset(
        {("mu", "packed"), ("mu", "vmap")})),
    "stale-model-entry": _perf_universe(covered=frozenset(
        {("mu", "packed"), ("mu", "vmap"), ("kl", "vmap"),
         ("kl", "pallas")})),
    "modeled-exempt": _perf_universe(covered=frozenset(
        {("mu", "packed"), ("mu", "vmap"), ("kl", "vmap"),
         ("pg", "vmap")})),
    "stale-exemption": _perf_universe(exempt=("pg", "ghost")),
}

_LIVE = {"nmfx_serve_dispatches_total": "counter",
         "nmfx_serve_queue_wait_seconds": "histogram",
         "nmfx_serve_queue_depth": "gauge"}
_DOCUMENTED = frozenset(_LIVE)

NMFX010 = {
    "clean": dict(live=_LIVE, documented=_DOCUMENTED),
    "bad-name": dict(live=dict(_LIVE, nmfx_Weird="gauge"),
                     documented=_DOCUMENTED | {"nmfx_Weird"}),
    "counter-suffix-both-ways": dict(
        live=dict(_LIVE, nmfx_serve_dispatches_total="gauge",
                  nmfx_ckpt_chunks_solved="counter"),
        documented=_DOCUMENTED | {"nmfx_ckpt_chunks_solved"}),
    "undocumented-and-stale-rows": dict(live=_LIVE, documented=frozenset(
        {"nmfx_serve_dispatches_total", "nmfx_serve_queue_wait_seconds",
         "nmfx_ghost_metric_total"})),
}


def _rescache_universe(**over):
    base = dict(
        solver_fields=frozenset({"algorithm", "tol_x", "restart_chunk"}),
        consensus_fields=frozenset({"restarts", "seed", "ks",
                                    "linkage"}),
        cache_solver=frozenset({"algorithm", "tol_x"}),
        cache_consensus=frozenset({"restarts", "seed", "ks",
                                   "linkage"}),
        declared_non_numerics=("restart_chunk",),
        declared_result_cache_exempt=(),
    )
    base.update(over)
    return base


NMFX011 = {
    "clean": _rescache_universe(),
    "solver-field-dropped": _rescache_universe(
        cache_solver=frozenset({"algorithm"})),
    "consensus-field-dropped": _rescache_universe(
        cache_consensus=frozenset({"seed", "ks", "linkage"})),
    "declared-exemption": _rescache_universe(
        cache_consensus=frozenset({"restarts", "seed", "ks"}),
        declared_result_cache_exempt=("linkage",)),
    "stale-exempt-declaration": _rescache_universe(
        declared_result_cache_exempt=("not_a_field",)),
    "contradictory-declaration": _rescache_universe(
        declared_result_cache_exempt=("linkage",)),
}

#: rule -> (the port's check, the reference's check, its universes)
PURE = {
    "NMFX001": (rules_config.check_config_coverage,
                jconfig.check_config_coverage, NMFX001),
    "NMFX007": (rules_config.check_manifest_coverage,
                jconfig.check_manifest_coverage, NMFX007),
    "NMFX008": (rules_obs.check_fault_event_coverage,
                jobs.check_fault_event_coverage, NMFX008),
    "NMFX009": (costmodel.check_costmodel_coverage,
                jcost.check_costmodel_coverage, NMFX009),
    "NMFX010": (rules_obs.check_metric_naming, jobs.check_metric_naming,
                NMFX010),
    "NMFX011": (rules_config.check_result_cache_coverage,
                jconfig.check_result_cache_coverage, NMFX011),
}
PURE_CASES = [(rule, case) for rule, (_, _, cases) in sorted(PURE.items())
              for case in sorted(cases)]

#: what the reference's tests read in each firing case's problems
MUST_MENTION = {
    ("NMFX001", "field-dropped-from-fingerprint"): ("tol_x", "fingerprint"),
    ("NMFX001", "undeclared-exclusion"): ("tol_x", "NON_NUMERICS_FIELDS"),
    ("NMFX001", "stale-declaration"): ("gone_field", "stale"),
    ("NMFX001", "stale-resolved-declaration"): ("gone_field", "RESOLVED"),
    ("NMFX001", "exec-key-gap"): ("tol_x", "bucket key"),
    ("NMFX001", "persist-key-gap"): ("tol_x", "persistent"),
    ("NMFX001", "nested-nonrepr-field"): ("ExperimentalConfig.hidden",
                                          "repr=False"),
    ("NMFX001", "unhashable-config"): ("SolverConfig", "hashable"),
    ("NMFX001", "noncompare-field"): ("ExperimentalConfig.sneaky",
                                      "compare=False"),
    ("NMFX001", "data-key-gap"): ("DataKey.dtype", "input-cache"),
    ("NMFX001", "serve-key-gap"): ("ServeConfig.batch_linger_s",
                                   "serve_key_fields"),
    ("NMFX001", "autotune-key-gap"): ("tol_x", "autotune store key"),
    ("NMFX001", "autotune-experimental-gap"): ("ExperimentalConfig.ragged",
                                               "autotune store key"),
    ("NMFX001", "autotune-stale-exemption"): ("gone_knob", "stale"),
    ("NMFX001", "autotune-contradictory-declaration"): (
        "tol_x", "drop one declaration"),
    ("NMFX007", "solver-field-dropped"): ("SolverConfig.tol_x",
                                          "checkpoint manifest"),
    ("NMFX007", "consensus-field-dropped"): ("ConsensusConfig.seed",),
    ("NMFX007", "undeclared-exclusion"): ("ConsensusConfig.seed",
                                          "CHECKPOINT_EXEMPT_FIELDS"),
    ("NMFX007", "stale-exempt-declaration"): ("not_a_field", "stale"),
    ("NMFX008", "missing-site"): ("serve.scheduler", "FAULT_EVENTS"),
    ("NMFX008", "stale-mapping"): ("old.renamed_site", "stale"),
    ("NMFX009", "missing-model"): ("'kl'", "no cost model"),
    ("NMFX009", "stale-model-entry"): ("stale entry",),
    ("NMFX009", "modeled-exempt"): ("COSTMODEL_EXEMPT",),
    ("NMFX009", "stale-exemption"): ("'ghost'",),
    ("NMFX010", "bad-name"): ("naming scheme", "nmfx_Weird"),
    ("NMFX010", "counter-suffix-both-ways"): ("_total",),
    ("NMFX010", "undocumented-and-stale-rows"): ("nmfx_ghost_metric_total",),
    ("NMFX011", "solver-field-dropped"): ("SolverConfig.tol_x",
                                          "result-cache"),
    ("NMFX011", "consensus-field-dropped"): ("ConsensusConfig.restarts",
                                             "RESULT_CACHE_EXEMPT_FIELDS"),
    ("NMFX011", "stale-exempt-declaration"): ("not_a_field", "stale"),
    ("NMFX011", "contradictory-declaration"): ("linkage", "contradictory"),
}

#: cases that must stay quiet (the clean twins)
QUIET = {"clean", "persist-key-not-provided", "data-key-covered",
         "data-key-not-provided", "serve-key-covered",
         "serve-key-not-provided", "autotune-clean-twin",
         "declared-exemption"}


@pytest.mark.parametrize("rule, case", PURE_CASES)
def test_pure_check_equals_nmfx(rule, case):
    port_check, ref_check, cases = PURE[rule]
    got = port_check(**cases[case])
    want = ref_check(**cases[case])
    assert [_as_nmfx(p) for p in got] == want
    if case in QUIET:
        assert got == []
    else:
        assert got
        for word in MUST_MENTION.get((rule, case), ()):
            assert any(word in p for p in got), (word, got)


# --------------------------------------------------------------------------
# the live tree
# --------------------------------------------------------------------------

def _live(rule):
    if rule == "NMFX001":
        return rules_config.check_config_coverage(
            **rules_config._live_universe())
    if rule == "NMFX007":
        return rules_config.check_manifest_coverage(
            **rules_config._live_manifest_universe())
    if rule == "NMFX008":
        return rules_obs.check_fault_event_coverage(
            **rules_obs._live_universe())
    if rule == "NMFX009":
        return costmodel.check_costmodel_coverage(
            **rules_perf._live_universe())
    if rule == "NMFX010":
        return rules_obs.check_metric_naming(
            rules_obs._live_metrics(), rules_obs._documented_metrics(
                os.path.join(REPO, "docs", rules_obs.DOC)))
    live = rules_config._live_result_cache_universe()
    assert live["declared_result_cache_exempt"] == ()
    assert {"restarts", "ks", "seed"} <= live["cache_consensus"]
    return rules_config.check_result_cache_coverage(**live)


@pytest.mark.parametrize("rule", sorted(PURE))
def test_live_tree_passes_pure_check(rule):
    assert _live(rule) == []


def test_live_serve_config_covered():
    import dataclasses

    from nmfx_torch import serve

    assert serve.serve_key_fields() == frozenset(
        f.name for f in dataclasses.fields(serve.ServeConfig))


def test_live_autotune_key_is_nmfx_key():
    """The port's autotune clause reads the same field split as the
    reference's: key fields and declared tunables."""
    live = rules_config._live_universe()
    ref = jconfig._live_universe()
    for name in ("autotune_exempt_solver", "autotune_exempt_experimental"):
        assert live[name] == ref[name]


def test_live_lock_graph_acyclic():
    findings = [f for f in run([os.path.join(REPO, "nmfx_torch")],
                               rule_ids=["NMFX013"])
                if f.rule_id == "NMFX013"]
    assert findings == []


@pytest.mark.parametrize("rule", PORTED)
def test_rule_registered(rule):
    assert rule in analysis.RULES


@pytest.mark.parametrize("rule", NOT_PORTED)
def test_rule_not_ported(rule):
    """The jaxpr layer, trace-time environment reads and donation have no
    counterpart in the port."""
    assert rule not in analysis.RULES
    assert rule in janalysis.RULES


def _decl_line(module, prefix):
    import inspect

    src_lines, start = inspect.getsourcelines(module)
    return next(i for i, line in enumerate(src_lines, start=start or 1)
                if line.startswith(prefix))


def _rule_run(target, rule):
    return [f for f in run([os.path.join(REPO, target)], rule_ids=[rule])
            if f.rule_id == rule]


def test_nmfx008_fires_through_run_on_changed_mapping(monkeypatch):
    from nmfx_torch import faults
    from nmfx_torch.obs import flight

    assert _rule_run("nmfx_torch/faults.py", "NMFX008") == []
    broken = dict(flight.FAULT_EVENTS)
    broken.pop("proc.preempt")
    monkeypatch.setattr(flight, "FAULT_EVENTS", broken)
    (finding,) = _rule_run("nmfx_torch/faults.py", "NMFX008")
    assert "proc.preempt" in finding.message
    assert finding.line == _decl_line(faults, "SITES =")


def test_nmfx009_fires_through_run_on_changed_table(monkeypatch):
    assert _rule_run("nmfx_torch/obs/costmodel.py", "NMFX009") == []
    broken = dict(costmodel._FLOPS)
    broken.pop(("snmf", "packed"))
    monkeypatch.setattr(costmodel, "_FLOPS", broken)
    (finding,) = _rule_run("nmfx_torch/obs/costmodel.py", "NMFX009")
    assert "'snmf'" in finding.message
    assert finding.line == _decl_line(costmodel, "_FLOPS =")


def test_nmfx010_fires_through_run_on_changed_table(monkeypatch):
    assert _rule_run("nmfx_torch/obs/metrics.py", "NMFX010") == []
    real = rules_obs._documented_metrics(
        os.path.join(REPO, "docs", rules_obs.DOC))
    monkeypatch.setattr(
        rules_obs, "_documented_metrics",
        lambda path: frozenset(real - {"nmfx_autotune_searches_total"}))
    (finding,) = _rule_run("nmfx_torch/obs/metrics.py", "NMFX010")
    assert "nmfx_autotune_searches_total" in finding.message
    assert finding.file.endswith("nmfx_torch/obs/metrics.py")


def test_nmfx011_fires_through_run_on_changed_key(monkeypatch):
    from nmfx_torch import result_cache

    assert _rule_run("nmfx_torch/config.py", "NMFX011") == []
    real = result_cache.cache_key_fields()
    monkeypatch.setattr(
        result_cache, "cache_key_fields",
        lambda: {"solver": real["solver"],
                 "consensus": real["consensus"] - {"restarts"}})
    (finding,) = _rule_run("nmfx_torch/config.py", "NMFX011")
    assert "ConsensusConfig.restarts" in finding.message
    assert finding.file.endswith("nmfx_torch/config.py")
    monkeypatch.undo()
    assert _rule_run("nmfx_torch/config.py", "NMFX011") == []


def test_nmfx001_fires_through_run_on_changed_autotune_key(monkeypatch):
    """A config field dropped from the autotune key without a declared
    exemption turns NMFX001 red at SolverConfig's declaration."""
    from nmfx_torch import autotune

    assert _rule_run("nmfx_torch/config.py", "NMFX001") == []
    solver, exp = autotune.autotune_key_fields()
    monkeypatch.setattr(autotune, "autotune_key_fields",
                        lambda: (solver - {"tol_x"}, exp))
    (finding,) = _rule_run("nmfx_torch/config.py", "NMFX001")
    assert "SolverConfig.tol_x" in finding.message
    assert "autotune store key" in finding.message


def test_nmfx001_wrong_tree_guard(tmp_path):
    """Analyzing a copy of the package that is not the importable one
    fails loudly instead of checking the wrong tree."""
    copy = tmp_path / "nmfx_torch"
    copy.mkdir()
    shutil.copy(os.path.join(REPO, "nmfx_torch", "config.py"),
                copy / "config.py")
    findings = [f for f in run([str(copy / "config.py")],
                               rule_ids=["NMFX001"])]
    assert len(findings) == 1
    assert "resolves to" in findings[0].message
    assert "WRONG tree" in findings[0].message


# --------------------------------------------------------------------------
# command line and baselines
# --------------------------------------------------------------------------

def _cli(*args, env_extra=None):
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    return subprocess.run(
        [sys.executable, "-m", "nmfx_torch.analysis", *args],
        capture_output=True, text=True, timeout=240, cwd=REPO, env=env)


def test_cli_json_output(tmp_path):
    path = _write(tmp_path, _HANDLER_BAD, "bad.py")
    proc = _cli(path, "--json", "--rules", "NMFX006")
    assert proc.returncode == 1
    doc = json.loads(proc.stdout)
    assert doc["ok"] is False
    assert doc["summary"]["errors"] == 1
    assert doc["findings"][0]["rule_id"] == "NMFX006"


def test_cli_nonexistent_path_fails(tmp_path):
    proc = _cli(str(tmp_path / "no_such_dir"))
    assert proc.returncode == 2
    assert "no_such_dir" in proc.stderr


def test_baseline_path_normalization(tmp_path):
    path = _write(tmp_path, _HANDLER_BAD, "bad.py")
    findings = run([path], rule_ids=["NMFX006"])
    baseline = tmp_path / "baseline.json"
    rel = os.path.relpath(path)
    baseline.write_text(json.dumps(
        [{"file": rel, "rule": f.rule_id, "line": f.line}
         for f in active(findings)]))
    assert _ids(run([path], baseline=str(baseline),
                    rule_ids=["NMFX006"])) == []


def test_cli_baseline_tolerates(tmp_path):
    path = _write(tmp_path, _HANDLER_BAD, "bad.py")
    findings = run([path], rule_ids=["NMFX006"])
    baseline = tmp_path / "baseline.json"
    baseline.write_text(json.dumps(
        [{"file": f.file, "rule": f.rule_id, "line": f.line}
         for f in active(findings)]))
    rebaselined = run([path], baseline=str(baseline), rule_ids=["NMFX006"])
    assert _ids(rebaselined) == []
    assert any(f.baselined for f in rebaselined)


def test_cli_write_baseline_refresh_keeps_records(tmp_path):
    path = _write(tmp_path, _HANDLER_BAD, "bad.py")
    baseline = str(tmp_path / "baseline.json")
    proc = _cli(path, "--rules", "NMFX006", "--write-baseline", baseline)
    assert proc.returncode == 0
    first = json.loads(open(baseline).read())
    assert len(first) == 1
    proc = _cli(path, "--rules", "NMFX006", "--baseline", baseline,
                "--write-baseline", baseline)
    assert proc.returncode == 0
    assert json.loads(open(baseline).read()) == first


def _update_baseline(path, baseline):
    return _cli(str(path), "--rules", "NMFX006", "--update-baseline",
                str(baseline))


def test_cli_update_baseline_round_trip_byte_stable(tmp_path):
    path = tmp_path / "bad.py"
    path.write_text(textwrap.dedent(_HANDLER_BAD))
    baseline = tmp_path / "lint_baseline.json"
    proc = _update_baseline(path, baseline)
    assert proc.returncode == 0, proc.stderr
    records = json.loads(baseline.read_bytes())
    assert len(records) == 1 and records[0]["reason"] == ""
    assert "lack a 'reason'" in proc.stdout
    records[0]["reason"] = "a swallow audited by hand"
    baseline.write_text(json.dumps(records, indent=2) + "\n")
    proc = _update_baseline(path, baseline)
    assert proc.returncode == 0
    assert json.loads(baseline.read_text())[0]["reason"] == \
        "a swallow audited by hand"
    assert "lack a 'reason'" not in proc.stdout
    stable = baseline.read_bytes()
    assert _update_baseline(path, baseline).returncode == 0
    assert baseline.read_bytes() == stable
    # the finding moves a line: its reason follows
    path.write_text("\n" + path.read_text())
    assert _update_baseline(path, baseline).returncode == 0
    moved = json.loads(baseline.read_text())
    assert moved[0]["line"] == records[0]["line"] + 1
    assert moved[0]["reason"] == "a swallow audited by hand"


def test_cli_update_baseline_drops_fixed_findings(tmp_path):
    path = tmp_path / "bad.py"
    path.write_text(textwrap.dedent(_HANDLER_BAD))
    baseline = tmp_path / "lint_baseline.json"
    assert _update_baseline(path, baseline).returncode == 0
    assert len(json.loads(baseline.read_text())) == 1
    path.write_text("x = 1\n")  # the defect is gone
    assert _update_baseline(path, baseline).returncode == 0
    assert json.loads(baseline.read_text()) == []


# ------------------------------------------------------- NMFX004 / NMFX005
# nmfx's cases of tests/test_lint_rules.py in the port's idiom: the key
# chain of nmfx_torch.random, torch's generators and host reads, and the
# hot path (ast_scan.HOT_ROOTS) in place of traced code. A fixture that
# should be on the hot path is written where a root lives
# (nmfx_torch/tiles.py::run_tiled_pool).

_HOT = "nmfx_torch/tiles.py"


def _lint_at(tmp_path, source, rules, name="fixture.py"):
    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return run([str(tmp_path)], rule_ids=rules)


def _as_jax(source: str) -> str:
    """The reference's spelling of a key-chain fixture."""
    return source.replace("from nmfx_torch import random as jr",
                          "from jax import random as jr")


_KEY_REUSE_BAD = """
    from nmfx_torch import random as jr

    def init_factors(key, m, n, k):
        w0 = jr.uniform(key, (m, k))
        h0 = jr.uniform(key, (k, n))  # same key: the same bits
        return w0, h0
"""

_KEY_REUSE_CLEAN = """
    from nmfx_torch import random as jr

    def init_factors(key, m, n, k):
        kw, kh = jr.split(key)
        w0 = jr.uniform(kw, (m, k))
        h0 = jr.uniform(kh, (k, n))
        return w0, h0
"""

_KEY_CASES = {
    "reuse": (1, _KEY_REUSE_BAD),
    "split": (0, _KEY_REUSE_CLEAN),
    # the threading idiom rebinds the name between the draws
    "fold_in": (0, """
        from nmfx_torch import random as jr

        def chain(key, m):
            x = jr.uniform(key, (m,))
            key = jr.fold_in(key, 1)
            y = jr.normal(key, (m,))
            return x + y
    """),
    "loop_carried": (1, """
        from nmfx_torch import random as jr

        def restarts(key, m, k, r):
            out = []
            for i in range(r):
                out.append(jr.uniform(key, (m, k)))
            return out
    """),
    "loop_fold_in": (0, """
        from nmfx_torch import random as jr

        def restarts(key, m, k, r):
            out = []
            for i in range(r):
                ki = jr.fold_in(key, i)
                out.append(jr.uniform(ki, (m, k)))
            return out
    """),
    # one defect, one finding: the inner loop's pass owns it
    "nested_loop": (1, """
        from nmfx_torch import random as jr

        def grid(key, r):
            for i in range(r):
                for j in range(2):
                    x = jr.uniform(key, (3,))
            return x
    """),
    # sibling branches each draw once: no path draws twice
    "branches": (0, """
        from nmfx_torch import random as jr

        def pick(key, m, flip):
            if flip:
                return jr.uniform(key, (m,))
            else:
                return jr.normal(key, (m,))
    """),
}


@pytest.mark.parametrize("case", sorted(_KEY_CASES))
def test_nmfx004_key_chain_equals_nmfx(case, tmp_path):
    """The same key-chain fixture through both linters: the port on
    nmfx_torch.random, the reference on jax.random; the same findings
    (rule id, line), and the port's count as stated."""
    n, source = _KEY_CASES[case]
    got = active(_lint_at(tmp_path / "port", source, ["NMFX004"]))
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    want = active(janalysis.run([_write(ref_dir, _as_jax(source))],
                                jaxpr=False, rule_ids=["NMFX004"]))
    assert len(got) == n
    assert _key(got) == _key(want)
    if case == "loop_carried":
        assert "loop" in got[0].message
    elif n:
        assert "'key'" in got[0].message and "consumed" in got[0].message


@pytest.mark.parametrize("spelling", [
    "from nmfx_torch.random import uniform as draw",
    "import nmfx_torch.random as draw_mod",
    "from nmfx_torch import random",
])
def test_nmfx004_key_reuse_spellings(tmp_path, spelling):
    """The key chain resolves through the module's imports, however it is
    spelled; both draws of one key fire."""
    call = {"from nmfx_torch.random import uniform as draw": "draw",
            "import nmfx_torch.random as draw_mod": "draw_mod.uniform",
            "from nmfx_torch import random": "random.uniform"}[spelling]
    src = f"""
        {spelling}

        def init(key, m, k):
            w = {call}(key, (m, k))
            h = {call}(key, (k, m))
            return w, h
    """
    findings = active(_lint_at(tmp_path, src, ["NMFX004"]))
    assert _ids(findings) == ["NMFX004"]
    assert findings[0].line == 6


def test_nmfx004_device_draws_are_consumers(tmp_path):
    src = """
        from nmfx_torch import random as jr

        def operators(keys, shape, device):
            left = jr.normal_device(keys, shape, device)
            right = jr.normal_device(keys, shape, device)  # the same bits
            return left, right
    """
    findings = active(_lint_at(tmp_path, src, ["NMFX004"]))
    assert [(f.rule_id, f.line) for f in findings] == [("NMFX004", 6)]


def test_nmfx004_stdlib_random_not_a_key(tmp_path):
    """stdlib ``random.shuffle(data)`` twice on one list is not key
    reuse, and outside the hot path it is no host-RNG finding either."""
    src = """
        import random

        def shuffle_twice(data):
            random.shuffle(data)
            picked = random.sample(data, 3)
            return picked
    """
    assert _ids(_lint_at(tmp_path, src, ["NMFX004"])) == []


_HOST_RNG = """
    import numpy as np
    import torch

    def run_tiled_pool(x):
        return x + {draw}
"""


@pytest.mark.parametrize("imports,draw,fires", [
    ("", "np.random.normal()", True),
    ("import numpy as onp\n", "onp.random.normal()", True),
    ("from numpy import random as nprand\n", "nprand.normal()", True),
    ("import random\n", "random.random()", True),
    ("", "torch.rand(3)", True),
    ("", "torch.randn(3)", True),
    ("", "torch.randint(0, 5, (3,))", True),
    ("", "torch.empty(3).uniform_()", True),
    ("", "torch.rand(3, generator=torch.Generator())", False),
    ("", "torch.empty(3).normal_(generator=torch.Generator())", False),
    ("from nmfx_torch import random as jr\n",
     "jr.uniform(jr.key(0), (3,))", False),
])
def test_nmfx004_host_rng_on_the_hot_path(tmp_path, imports, draw, fires):
    src = textwrap.dedent(_HOST_RNG).replace("{draw}", draw)
    src = imports + src
    findings = active(_lint_at(tmp_path, src, ["NMFX004"], name=_HOT))
    assert _ids(findings) == (["NMFX004"] if fires else [])
    if fires:
        assert "host RNG" in findings[0].message
    # the same draw off the hot path is not this rule's concern
    off = active(_lint_at(tmp_path / "off", src, ["NMFX004"]))
    assert off == []


def test_nmfx004_host_rng_in_the_draws(tmp_path):
    """What init.restart_inits reaches feeds the key chain: a host draw
    there fires, reached through a call."""
    src = """
        import numpy as np

        def jitter(m):
            return np.random.rand(m)

        def restart_inits(a, keys, k, cfg):
            return jitter(a.shape[0])
    """
    findings = active(_lint_at(tmp_path, src, ["NMFX004"],
                               name="nmfx_torch/init.py"))
    assert [(f.rule_id, f.line) for f in findings] == [("NMFX004", 5)]
    assert "'jitter'" in findings[0].message


_SYNC = """
    import torch

    def run_tiled_pool(a, w, h, cfg):
        r = torch.linalg.norm(a - w @ h)
        return {sync}
"""


@pytest.mark.parametrize("sync,what", [
    ("float(r)", "float()"),
    ("int(r)", "int()"),
    ("bool(r > 0)", "bool()"),
    ("r.item()", ".item()"),
    ("r.tolist()", ".tolist()"),
    ("torch.sum(a).item()", ".item()"),
    ("w.cpu()", ".cpu()"),
    ("h.numpy()", ".numpy()"),
    ("torch.cuda.synchronize()", "torch.cuda.synchronize()"),
])
def test_nmfx005_host_sync_on_the_hot_path(tmp_path, sync, what):
    src = _SYNC.replace("{sync}", sync)
    findings = active(_lint_at(tmp_path, src, ["NMFX005"], name=_HOT))
    assert _ids(findings) == ["NMFX005"]
    assert what in findings[0].message and findings[0].line == 6
    # the same read off the hot path is quiet
    assert active(_lint_at(tmp_path / "off", src, ["NMFX005"])) == []


@pytest.mark.parametrize("expr", [
    "float(a.shape[0] * a.shape[1])",  # static shape math
    "int(cfg.check_every)",  # static config
    "bool(cfg.use_tol_checks)",
    "int(len(a))",
    "float(r.numel())",
    "w.tolist()",  # an unannotated parameter: not known to be a tensor
])
def test_nmfx005_dataflow_gate_quiet(tmp_path, expr):
    src = _SYNC.replace("{sync}", expr)
    assert _ids(_lint_at(tmp_path, src, ["NMFX005"], name=_HOT)) == []


def test_nmfx005_reached_through_calls_and_annotations(tmp_path):
    """A helper the root calls is on the hot path; a parameter annotated
    as a tensor is tainted; a helper nobody on the path calls is not."""
    src = """
        import torch

        def count(mask: torch.Tensor) -> int:
            return int(mask.sum())

        def unused(mask: torch.Tensor) -> int:
            return int(mask.sum())

        def run_tiled_pool(a, cfg):
            done = a > 0
            return count(done)
    """
    findings = active(_lint_at(tmp_path, src, ["NMFX005"], name=_HOT))
    assert [(f.rule_id, f.line) for f in findings] == [("NMFX005", 5)]
    assert "'count'" in findings[0].message


def test_nmfx005_taint_follows_assignments(tmp_path):
    src = """
        import torch

        def run_tiled_pool(a):
            done = torch.isfinite(a)
            left = ~done
            n = int(left.sum())
            return n
    """
    findings = active(_lint_at(tmp_path, src, ["NMFX005"], name=_HOT))
    assert [(f.rule_id, f.line) for f in findings] == [("NMFX005", 7)]


@pytest.mark.parametrize("comment,suppressed", [
    ("  # nmfx: ignore[NMFX005] -- the loop's one read a check", True),
    ("  # nmfx: ignore[NMFX005]", False),
])
def test_nmfx005_suppression_needs_a_reason(tmp_path, comment, suppressed):
    src = _SYNC.replace("{sync}", "r.item()" + comment)
    findings = _lint_at(tmp_path, src, ["NMFX005"], name=_HOT)
    sync = [f for f in findings if f.rule_id == "NMFX005"]
    assert len(sync) == 1 and sync[0].suppressed is suppressed
    if suppressed:
        assert active(findings) == []
    else:
        assert sorted(_ids(findings)) == ["NMFX000", "NMFX005"]


def test_hot_path_reaches_the_live_roots():
    """The live tree's hot path holds the three loops' roots and what
    they run once a trip or a check: the block kernels' wrappers, the
    scheduler's trip and its convergence check, the counted reads."""
    project = analysis.load_project([os.path.join(REPO, "nmfx_torch")])
    hot = {(os.path.basename(f.module.path), f.qualname)
           for f in project.hot_functions()}
    for want in [("sched_mu.py", "mu_sched"), ("sched_mu.py", "mu_sched.trip"),
                 ("sched_mu.py", "mu_sched.ragged_stage"),
                 ("base.py", "run_loop_batched"), ("base.py", "sum"),
                 ("tiles.py", "run_tiled_pool"), ("tiles.py", "_to_host"),
                 ("fused_mu.py", "fused_block_iterations"),
                 ("fused_mu.py", "hals_block_iterations"),
                 ("packed_mu.py", "batch_convergence")]:
        assert want in hot, want
    assert ("api.py", "nmfconsensus") not in hot
