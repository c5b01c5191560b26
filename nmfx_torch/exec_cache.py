"""Bucketed-sweep reuse for the serving layer (counterpart of the host
half of ``nmfx/exec_cache.py``).

The reference keys compiled XLA executables by shape bucket, so a new
dataset whose shape rounds up to a warm bucket costs no compile. In the
port an "executable" is a built bucketed sweep
(``sweep._build_bucketed_sweep_fn``: a host closure over the slot
scheduler, which launches the hand-written kernels under
``backend="pallas"``); the kernels themselves build once a process at
their first launch (``nmfx_torch/ops/_build.py``). The cache keeps the
reference's layout and contracts:

* **Shape buckets** (``ExecCacheConfig``): ``(m, n)`` rounds up to a
  coarse lattice (:func:`bucket_dim`); A is zero-padded to it through
  the device input cache (``data_cache.place_resilient(pad_shape=)``),
  the lanes are drawn at the TRUE shape and zero-padded, and the built
  sweep masks pad columns out of the labels and consensus and rescales
  the residuals to the true shape, so nothing a user sees depends on the
  bucket.
* **LRU of built sweeps** keyed by the bucket, the rank set, the restart
  count, the full ``SolverConfig``, the random init config (NNDSVD lanes
  are built outside, per true shape), the label rule, keep_factors, the
  slot pool, torch's version and the device type. :func:`compile_count`
  counts the builds of cold entries (``nmfx_exec_compile_total``); a
  warm bucket builds nothing. The ``compile.build`` fault site fires on
  every build.
* **Warm-up**: :meth:`ExecCache.warm` builds buckets ahead of requests,
  on a daemon thread with ``background=True`` (a request for a bucket
  being built waits for it instead of building it twice).
* **Per-rank pipeline** (``pipeline_ranks``): one built sweep a rank,
  dispatched ascending; each rank's results are a single-rank grid
  sweep's.
* **Transfers**: :meth:`ExecCache.prefetch` starts A's padded
  host→device copy; :func:`start_host_fetch` starts a finished rank's
  device→host copies (``nmfx_torch.harvest.start_host_fetch``).

Not ported: the reference's disk store of serialized executables
(``ExecCacheConfig.cache_dir`` raises ``NotImplementedError`` naming
ROADMAP §1 item 6; a built torch sweep has no serialized form, so the
``persist.deserialize`` fault site stays unfired).

A restart mesh serves through the meshed bucketed sweeps (each shard its
lanes of every rank, on its device; :meth:`ExecCache.prefetch` places
the padded matrix on each distinct device of the mesh). Feature and
sample axes are not cacheable, as in the reference: those sweeps run the
plain grid-sharded sweep.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from typing import NamedTuple, Sequence

import torch

from nmfx_torch import faults
from nmfx_torch import random as _random
from nmfx_torch.config import (ConsensusConfig, ExecCacheConfig, InitConfig,
                               SolverConfig)
from nmfx_torch.device import explicit_device, resolve_device
from nmfx_torch.guards import guarded_by
from nmfx_torch.harvest import start_host_fetch
from nmfx_torch.obs import flight as _flight
from nmfx_torch.obs import metrics as _metrics
from nmfx_torch.profiling import NullProfiler
from nmfx_torch.sweep import (KSweepOutput, _attribute_dispatch,
                              _build_bucketed_sweep_fn, _pad_count,
                              bucketed_lane_init_fn, grid_exec_ok,
                              mesh_home)

__all__ = ["ExecCache", "PlacedMatrix", "WarmTask", "bucket_dim",
           "compile_count", "persist_key_fields", "solver_key_fields",
           "start_host_fetch"]

#: builds of cold bucket entries (the reference's count of
#: ``.lower().compile()`` calls); :func:`compile_count` reads it
_compile_total = _metrics.counter(
    "nmfx_exec_compile_total",
    "executables actually compiled through the serving layer "
    "(.lower().compile() calls; deserialized disk hits do not count)")
_exec_evictions_total = _metrics.counter(
    "nmfx_exec_cache_evictions_total",
    "in-memory executable-cache entries evicted (LRU bound; the disk "
    "record, if any, survives)")


def compile_count() -> int:
    """How many bucketed sweeps this process has built through the
    serving layer (cold entries only; a warm bucket builds nothing).
    Reads the registry counter ``nmfx_exec_compile_total``."""
    return int(_compile_total.total())


def solver_key_fields() -> frozenset:
    """The SolverConfig fields an entry's key covers. The key holds the
    frozen SolverConfig value itself, whose ``__eq__`` / ``__hash__``
    compare every field declared with ``compare=True``; a field left out
    of the comparison would let two configs with different numbers (a
    tiled and an in-core one, say) share a built sweep, and shows up
    here."""
    return frozenset(f.name for f in dataclasses.fields(SolverConfig)
                     if f.compare)


def persist_key_fields() -> frozenset:
    """The SolverConfig fields the reference's persistent (disk) key
    covers: that key is the ``repr`` of the in-memory one, which renders
    the fields declared with ``repr=True``. The port keeps no disk tier
    (``ExecCacheConfig.cache_dir`` is refused); the hook keeps the
    reference's contract checkable."""
    return frozenset(f.name for f in dataclasses.fields(SolverConfig)
                     if f.repr)


def bucket_dim(x: int, quantum: int, growth_steps: int = 8) -> int:
    """Round ``x`` up to the shape lattice: multiples of a step that
    starts at ``quantum`` and doubles whenever the dimension exceeds
    ``growth_steps`` steps (the reference's lattice: 5000×500 lands on
    5120×512 under the defaults)."""
    if x < 1:
        raise ValueError(f"dimension must be >= 1, got {x}")
    step = quantum
    while step * growth_steps < x:
        step *= 2
    return -(-x // step) * step


class PlacedMatrix(NamedTuple):
    """A dataset padded to its bucket and placed on the cache's device,
    or on each distinct device of a restart mesh (the copy may still be
    in flight on the device's stream)."""

    a_pad: "torch.Tensor | dict"  # (m_pad, n_pad), zero-padded
    true_shape: tuple
    bucket: tuple


class _Entry(NamedTuple):
    fn: object  # the built bucketed sweep
    bucket: tuple
    #: seconds the build took
    compile_s: float
    source: str = "compile"


class WarmTask:
    """Handle to a background :meth:`ExecCache.warm`: ``done()`` polls,
    ``result()`` joins and returns (or raises) the warm report."""

    def __init__(self, thread: threading.Thread, box: dict):
        self._thread = thread
        self._box = box

    def done(self) -> bool:
        return not self._thread.is_alive()

    def result(self, timeout: "float | None" = None) -> "list[dict]":
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("background warmup still compiling")
        err = self._box.get("error")
        if err is not None:
            raise err
        return self._box["report"]


@guarded_by("_lock", "_entries", "_entries_cap", "_inflight", "_warned",
            "_warm_failures", "hits", "misses", "evictions")
class ExecCache:
    """LRU of built, shape-bucketed sweeps on one device.

    One instance lives for a serving process and is passed to
    ``nmfconsensus(exec_cache=...)`` / ``sweep(exec_cache=...)`` or to
    ``NMFXServer``. ``device``: None means CUDA (raising without a
    card), or "cpu" for the plain versions. Building is thread-safe: a
    background warm and a request for the same bucket share one build
    through the in-flight registry.
    """

    def __init__(self, cfg: ExecCacheConfig = ExecCacheConfig(), *,
                 device=None):
        self.cfg = cfg
        #: the cache's card, with its index (the serving threads set it
        #: as their current device)
        self.device = explicit_device(resolve_device(device))
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        #: the effective LRU bound: cfg.max_entries, raised by the
        #: per-rank mode to a request's rank count
        self._entries_cap = cfg.max_entries
        self._inflight: "dict[tuple, Future]" = {}
        self._lock = threading.RLock()
        self._warned: set = set()
        #: a background build that failed, by key: surfaced (one warning
        #: and a clean rebuild) on the next request for that bucket
        self._warm_failures: "dict[tuple, BaseException]" = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- policy ------------------------------------------------------------
    def bucket_shape(self, m: int, n: int) -> tuple:
        return (bucket_dim(m, self.cfg.m_quantum, self.cfg.growth_steps),
                bucket_dim(n, self.cfg.n_quantum, self.cfg.growth_steps))

    def cacheable(self, ccfg: ConsensusConfig, scfg: SolverConfig,
                  mesh=None) -> bool:
        """Whether this (config, mesh) can serve through the bucketed
        sweeps, the reference's predicate: the whole-grid slot scheduler
        runs it (``grid_exec_ok``) under a grid-capable ``grid_exec``, on
        no feature or sample axes, in a single-process job. A restart
        mesh passes, as in the reference, and serves restart-sharded."""
        from nmfx_torch.device import process_count
        from nmfx_torch.sweep import grid_axes_active

        return (grid_exec_ok(scfg, mesh)
                and ccfg.grid_exec in ("auto", "grid")
                and not grid_axes_active(mesh) and process_count() == 1)

    def route(self, shape: tuple, ccfg: ConsensusConfig,
              scfg: SolverConfig) -> "dict | None":
        """The route a sweep of a ``shape`` matrix takes through this
        cache, as the result-cache key records it: None where it falls
        back to the plain sweep, else its bucket and whether its ranks
        are pipelined. The padded pool sums in other orders than the
        plain sweep's, so results of different routes may part by a
        float."""
        if not self.cacheable(ccfg, scfg):
            return None
        return {"bucket": list(self.bucket_shape(*shape)),
                "pipeline_ranks": bool(self.cfg.pipeline_ranks
                                       and len(ccfg.ks) > 1)}

    def _key(self, bucket: tuple, ccfg: ConsensusConfig,
             scfg: SolverConfig, icfg: InitConfig, mesh=None) -> tuple:
        tail = ccfg.grid_tail_slots
        if isinstance(tail, list):
            tail = tuple(tail)
        # random init runs inside the built sweep, so its config keys
        # the entry; NNDSVD lane batches are built outside per true
        # shape and leave the entry init-agnostic
        init_key = icfg if icfg.method == "random" else "external"
        return (bucket, tuple(sorted(ccfg.ks, reverse=True)),
                ccfg.restarts, scfg, init_key, ccfg.label_rule,
                ccfg.keep_factors, ccfg.grid_slots, tail, mesh,
                torch.__version__, self.device.type)

    def _warn_once(self, category: str, msg: str) -> None:
        with self._lock:
            if category in self._warned:
                return
            self._warned.add(category)
        import warnings

        warnings.warn(f"nmfx_torch exec cache: {msg}", RuntimeWarning,
                      stacklevel=4)

    # -- building ----------------------------------------------------------
    def executable(self, shape: tuple, ccfg: ConsensusConfig,
                   scfg: SolverConfig = SolverConfig(),
                   icfg: InitConfig = InitConfig(), mesh=None,
                   profiler=None) -> "tuple[_Entry, bool]":
        """``(entry, was_hit)`` for a request of TRUE shape ``shape``:
        from memory, from another thread's build in flight, or built now
        (``was_hit`` False only when this call built it)."""
        prof = profiler if profiler is not None else NullProfiler()
        bucket = self.bucket_shape(*shape)
        key = self._key(bucket, ccfg, scfg, icfg, mesh)
        with self._lock:
            stale = self._warm_failures.pop(key, None)
        if stale is not None:
            self._warn_once(
                "warm-failed",
                f"background warmup failed for this bucket ({stale!r}); "
                "rebuilding in the foreground")
        wait = None
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
            else:
                wait = self._inflight.get(key)
                if wait is None:
                    fut: Future = Future()
                    self._inflight[key] = fut
        if entry is not None:
            prof.mark("compile.cache_hit")
            return entry, True
        if wait is not None:
            with prof.phase("compile.inflight_wait"):
                entry = wait.result()
            with self._lock:
                self.hits += 1
            prof.mark("compile.cache_hit")
            return entry, True
        try:
            entry = self._compile(bucket, ccfg, scfg, icfg, prof, mesh)
            with self._lock:
                self._entries[key] = entry
                while len(self._entries) > self._entries_cap:
                    evicted_key, _ = self._entries.popitem(last=False)
                    self.evictions += 1
                    _exec_evictions_total.inc()
                    _flight.record("cache.evict", cache="exec",
                                   bucket=str(evicted_key[0]))
                self._inflight.pop(key, None)
            fut.set_result(entry)
            return entry, False
        except BaseException as e:
            with self._lock:
                self._inflight.pop(key, None)
            fut.set_exception(e)
            raise

    def _compile(self, bucket, ccfg, scfg, icfg, prof,
                 mesh=None) -> _Entry:
        # fault site: the build, fired before any counter moves
        faults.inject("compile.build")
        with self._lock:
            self.misses += 1
        _compile_total.inc()
        ks = tuple(sorted(ccfg.ks))
        span = (f"compile.k={ks[0]}" if len(ks) == 1
                else f"compile.ks={ks[0]}-{ks[-1]}")
        with prof.phase("compile.cache_miss"), prof.phase(span):
            t0 = time.perf_counter()
            tail = (tuple(ccfg.grid_tail_slots)
                    if isinstance(ccfg.grid_tail_slots, list)
                    else ccfg.grid_tail_slots)
            fn = _build_bucketed_sweep_fn(
                tuple(ccfg.ks), ccfg.restarts, scfg, ccfg.label_rule, mesh,
                ccfg.keep_factors, ccfg.grid_slots, tail, bucket,
                init_cfg=icfg if icfg.method == "random" else None)
            compile_s = time.perf_counter() - t0
        return _Entry(fn, bucket, compile_s)

    def warm(self, shapes: Sequence[tuple], ccfg: ConsensusConfig,
             scfg: SolverConfig = SolverConfig(),
             icfg: InitConfig = InitConfig(), mesh=None, profiler=None,
             background: bool = False, _record_failures: bool = False):
        """Build the bucket of each shape ahead of requests (per rank
        under ``pipeline_ranks``). With ``background=True`` the builds
        run on a daemon thread and a :class:`WarmTask` returns at once.
        Returns one record per entry: shape, bucket, ranks, whether it
        was already warm (``cache_hit``), build seconds and origin.
        Builds run one after another (a build is a host closure; the
        reference compiles in parallel)."""
        if background:
            box: dict = {}

            def work():
                try:
                    box["report"] = self.warm(
                        shapes, ccfg, scfg, icfg, mesh, profiler=None,
                        background=False, _record_failures=True)
                except BaseException as e:  # WarmTask.result re-raises
                    box["error"] = e

            thread = threading.Thread(target=work, daemon=True,
                                      name="nmfx-torch-exec-warm")
            thread.start()
            return WarmTask(thread, box)
        prof = profiler if profiler is not None else NullProfiler()
        specs: "list[tuple[tuple, ConsensusConfig]]" = []
        for m, n in shapes:
            if self.cfg.pipeline_ranks and len(ccfg.ks) > 1:
                specs.extend(((m, n), dataclasses.replace(ccfg, ks=(k,)))
                             for k in sorted(ccfg.ks))
            else:
                specs.append(((m, n), ccfg))
        if self.cfg.pipeline_ranks:
            with self._lock:
                self._entries_cap = max(self._entries_cap, len(ccfg.ks))
        report = []
        for shape, c in specs:
            try:
                entry, hit = self.executable(shape, c, scfg, icfg, mesh,
                                             prof)
            except BaseException as e:
                if _record_failures:
                    key = self._key(self.bucket_shape(*shape), c, scfg,
                                    icfg, mesh)
                    with self._lock:
                        self._warm_failures[key] = e
                raise
            report.append({"shape": tuple(shape), "bucket": entry.bucket,
                           "ks": tuple(c.ks), "cache_hit": hit,
                           "source": entry.source,
                           "compile_s": round(entry.compile_s, 6)})
        return report

    @property
    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions,
                    "warm_failures": len(self._warm_failures),
                    "max_entries": self._entries_cap}

    # -- the host<->device pipeline ---------------------------------------
    def prefetch(self, a, scfg: SolverConfig = SolverConfig(), mesh=None,
                 profiler=None) -> PlacedMatrix:
        """Pad ``a`` to its bucket and start its host→device copy through
        the device input cache: a repeat request over the same matrix
        re-uses the padded device buffer (zero bytes copied)."""
        from nmfx_torch.data_cache import place_resilient

        prof = profiler if profiler is not None else NullProfiler()
        m, n = a.shape
        bucket = self.bucket_shape(m, n)
        if mesh is not None:
            return PlacedMatrix(
                {d: place_resilient(a, scfg, d, pad_shape=bucket,
                                    profiler=prof)
                 for d in mesh.distinct_devices()}, (m, n), bucket)
        a_pad = place_resilient(a, scfg, self.device, pad_shape=bucket,
                                profiler=prof)
        return PlacedMatrix(a_pad, (m, n), bucket)

    def _solve_args(self, placed: PlacedMatrix, ccfg: ConsensusConfig,
                    scfg: SolverConfig, icfg: InitConfig, prof,
                    mesh=None) -> tuple:
        """The built sweep's arguments for one request: the padded
        matrix, the init route's inputs (the root key, or the NNDSVD lane
        batch built at the true shape) and the true-dimension scalars."""
        from nmfx_torch.ops.packed_mu import flip_budget

        m_true, n_true = placed.true_shape
        flip = flip_budget(scfg.class_flip_tol, n_true)
        root = _random.key(ccfg.seed)
        if icfg.method == "random":
            return (placed.a_pad, root, m_true, n_true, flip)
        with prof.phase("exec_cache.init") as sync:
            init_fn = bucketed_lane_init_fn(
                placed.true_shape, tuple(ccfg.ks),
                _pad_count(ccfg.restarts, mesh, count=False), icfg,
                scfg.dtype, placed.bucket)
            a_true = _home(placed, mesh)[:m_true, :n_true]
            w0, h0 = sync(init_fn(a_true, root))
        return (placed.a_pad, w0, h0, m_true, n_true, flip)

    def run_sweep(self, a, ccfg: ConsensusConfig,
                  scfg: SolverConfig = SolverConfig(),
                  icfg: InitConfig = InitConfig(), mesh=None, *,
                  profiler=None, on_rank=None) -> "dict[int, KSweepOutput]":
        """One (k × restart) sweep through the bucketed sweep: the
        serving counterpart of ``sweep.sweep``, with its result contract
        (true-shape per-rank ``KSweepOutput``, host copies started in
        ``fetch``). ``a`` is a host matrix or a :class:`PlacedMatrix`
        from :meth:`prefetch`. ``on_rank(k, out)`` runs per rank once
        its copies are started. A restart ``mesh`` runs the meshed
        bucketed sweeps, the outputs on its first device."""
        prof = profiler if profiler is not None else NullProfiler()
        if not self.cacheable(ccfg, scfg, mesh):
            raise ValueError(
                "configuration is not cacheable (see ExecCache.cacheable)"
                " — route it through nmfx_torch.sweep.sweep instead")
        placed = (a if isinstance(a, PlacedMatrix)
                  else self.prefetch(a, scfg, mesh, profiler=prof))
        if self.cfg.pipeline_ranks and len(ccfg.ks) > 1:
            return self._run_sweep_ranks(placed, ccfg, scfg, icfg, prof,
                                         on_rank, mesh)
        m_true, n_true = placed.true_shape
        entry, _ = self.executable(placed.true_shape, ccfg, scfg, icfg,
                                   mesh, prof)
        args = self._solve_args(placed, ccfg, scfg, icfg, prof, mesh)
        t0 = time.perf_counter()
        with prof.phase("solve.grid") as sync:
            raw = sync(entry.fn(*args))
        solve_wall = time.perf_counter() - t0
        out = {}
        with prof.phase("xfer.overlap"):
            for k, v in raw.items():
                v = _unpad(v, m_true, n_true)
                out[k] = v._replace(fetch=start_host_fetch(v))
        for k in ccfg.ks:
            if on_rank is not None:
                on_rank(k, out[k])
        _attribute_dispatch("exec.grid", scfg, _home(placed, mesh), out,
                            solve_wall, prof, shape=placed.true_shape,
                            mesh=mesh)
        return {k: out[k] for k in ccfg.ks}

    def _run_sweep_ranks(self, placed: PlacedMatrix, ccfg: ConsensusConfig,
                         scfg: SolverConfig, icfg: InitConfig, prof,
                         on_rank, mesh=None) -> "dict[int, KSweepOutput]":
        """Per-rank serving (``ExecCacheConfig.pipeline_ranks``): one
        bucketed sweep a rank, dispatched ascending; each rank's results
        are exactly a single-rank grid sweep's (``ks=(k,)``), which
        differ from the whole grid's only in the pool's composition."""
        ks = tuple(sorted(ccfg.ks))
        m_true, n_true = placed.true_shape
        with self._lock:
            self._entries_cap = max(self._entries_cap, len(ks))
        out: "dict[int, KSweepOutput]" = {}
        for k in ks:
            ck = dataclasses.replace(ccfg, ks=(k,))
            entry, _ = self.executable(placed.true_shape, ck, scfg, icfg,
                                       mesh, prof)
            args = self._solve_args(placed, ck, scfg, icfg, prof, mesh)
            t0 = time.perf_counter()
            with prof.phase(f"solve.k={k}") as sync:
                raw = sync(entry.fn(*args))
            solve_wall = time.perf_counter() - t0
            v = _unpad(raw[k], m_true, n_true)
            with prof.phase("xfer.overlap"):
                out[k] = v._replace(fetch=start_host_fetch(v))
            if on_rank is not None:
                on_rank(k, out[k])
            _attribute_dispatch("exec.k", scfg, _home(placed, mesh),
                                {k: out[k]}, solve_wall, prof,
                                shape=placed.true_shape, mesh=mesh)
        return {k: out[k] for k in ccfg.ks}


def _home(placed: PlacedMatrix, mesh) -> torch.Tensor:
    """The placed matrix on the device a sweep's outputs land on."""
    if isinstance(placed.a_pad, dict):
        return placed.a_pad[mesh_home(mesh)]
    return placed.a_pad


def _unpad(out_k: KSweepOutput, m: int, n: int) -> KSweepOutput:
    """One rank's bucket-padded outputs sliced back to the request's true
    shape (device views; per-restart stats are already exact)."""
    return out_k._replace(
        consensus=out_k.consensus[:n, :n],
        labels=out_k.labels[:, :n],
        best_w=out_k.best_w[:m, :],
        best_h=out_k.best_h[:, :n],
        all_w=None if out_k.all_w is None else out_k.all_w[:, :m, :],
        all_h=None if out_k.all_h is None else out_k.all_h[:, :, :n])
