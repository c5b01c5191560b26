"""Durable sweeps: the per-(rank, restart-chunk) checkpoint ledger,
preemption and resume (counterpart of the in-core half of
``nmfx/checkpoint.py``).

* **Fixed chunk plan.** Each rank's restarts split at fixed boundaries
  ``[0,c), [c,2c), ...`` (``CheckpointConfig.every_n_restarts``, one
  chunk per rank by default), stored in the manifest, so a killed run,
  its resume and an uninterrupted run solve the same chunks.
* **Content-addressed manifest.** The input's ``data_cache.DataKey``
  fingerprint, the result-affecting config fields
  (:func:`manifest_key_fields`, ``backend`` as the chunk executor's
  engine family), the init config, and the environment: the torch and
  CUDA versions and the device's name. A mismatch cold-starts (warn,
  clear this ledger's records, solve again), never resumes wrongly. A
  ledger written by ``nmfx``, or on another card, therefore cold-starts.
* **One record per (rank, chunk).** Written through a temporary file and
  a rename; a torn, corrupt or foreign record is skipped with one
  warning and its chunk solved again.
* **Exact finalize.** The consensus is summed from the per-restart
  labels in restart order as int64 counts on the host, then divided once
  in float64 by the survivor count; the best restart is the global
  first-minimum ``argmin`` of the dnorms. So the result does not depend
  on which chunks were loaded and which were solved.
* **Preemption.** The ``proc.preempt`` site fires between a chunk's solve
  and its commit and raises :class:`Preempted`;
  :func:`install_signal_flush` writes the buffered (``every_s``) records
  when SIGTERM or SIGINT arrives.

Telemetry, as the reference emits it: the chunk counters are registry
instruments (``nmfx_ckpt_chunks_solved_total``,
``nmfx_ckpt_chunks_loaded_total``, ``nmfx_result_cache_extended_total``;
:func:`chunks_solved_count` and :func:`chunks_loaded_count` read them),
each record write is a ``ckpt.commit`` tracer span and flight event, and
an extended ledger records ``ckpt.extend`` (and ``result_cache.extend``
when the run reused records while solving new ones).

A checkpointed run is byte-equal to every other checkpointed run of the
same (data, config, plan), interrupted or not; against the
non-checkpointed sweep it agrees to float tolerance (the device sums the
consensus in float32 there). Left out, with ROADMAP §1 item 10: the
out-of-core chunks (tiles, sparse inputs), their mid-chunk partials, and
the shard heartbeats of the elastic runner.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import signal
import threading
import time

import numpy as np
import torch

from nmfx_torch import faults
from nmfx_torch import random as _random
from nmfx_torch.config import (CheckpointConfig, ConsensusConfig,
                               InitConfig, SolverConfig, check_ported)
from nmfx_torch.data_cache import default_cache, place_resilient
from nmfx_torch.device import resolve_device
from nmfx_torch.obs import flight as _flight
from nmfx_torch.obs import metrics as _metrics
from nmfx_torch.obs import trace as _trace
from nmfx_torch.profiling import NullProfiler

__all__ = ["MANIFEST_CONSENSUS_EXCLUDED", "Preempted", "SweepCheckpoint",
           "atomic_save_npz", "chunks_loaded_count", "chunks_solved_count",
           "engine_family", "install_signal_flush", "manifest_key_fields",
           "plan_chunks", "run_checkpointed_sweep", "solve_chunk_host"]

_MANIFEST_NAME = "manifest.json"
#: the only files a cold start may delete: this ledger's records
_RECORD_RE = re.compile(r"^k\d+_r\d+-\d+\.npz$")
#: the reference's ledger format (restarts left out of the fingerprint,
#: so a wider restart budget extends a ledger)
_FORMAT_VERSION = 2

#: ConsensusConfig fields outside the manifest: the ranks (each record
#: names its k), finalize-only settings and execution strategy the chunk
#: plan replaces
MANIFEST_CONSENSUS_EXCLUDED = ("ks", "linkage", "min_restarts",
                               "keep_factors", "grid_exec", "grid_slots",
                               "grid_tail_slots", "restarts")


class Preempted(BaseException):
    """The armed ``proc.preempt`` site fired between a chunk's solve and
    its commit. A ``BaseException``, so no ``except Exception`` recovery
    swallows a preemption."""


# registry instruments under the reference's names and help strings;
# the *_count() functions below read them
_chunks_solved_total = _metrics.counter(
    "nmfx_ckpt_chunks_solved_total",
    "restart-chunks actually solved on device through the checkpoint "
    "engine (loaded records do not count)")
_chunks_loaded_total = _metrics.counter(
    "nmfx_ckpt_chunks_loaded_total",
    "restart-chunks served from completion records on disk")
_extended_total = _metrics.counter(
    "nmfx_result_cache_extended_total",
    "checkpointed sweeps that resumed a compatible ledger under a "
    "widened budget (more restarts / more ranks) and solved only the "
    "delta chunks")


def chunks_solved_count() -> int:
    """Chunks this process solved through the ledger (loaded records do
    not count): a fully checkpointed re-run leaves it unchanged. Reads
    ``nmfx_ckpt_chunks_solved_total``."""
    return int(_chunks_solved_total.total())


def chunks_loaded_count() -> int:
    """Chunks served from records on disk
    (``nmfx_ckpt_chunks_loaded_total``)."""
    return int(_chunks_loaded_total.total())


def _note(solved: int = 0, loaded: int = 0) -> None:
    if solved:
        _chunks_solved_total.inc(solved)
    if loaded:
        _chunks_loaded_total.inc(loaded)


def engine_family(solver_cfg: SolverConfig) -> str:
    """The engine the chunk executor runs (``sweep._build_chunk_sweep_fn``),
    in the reference's words: "pallas" and "packed" for mu's packed
    solve (kernels or plain products), "vmap" for the batched restart
    route of everything else. Hashed into the manifest, so a ledger never
    resumes under another engine."""
    from nmfx_torch.sweep import _use_packed

    if solver_cfg.backend == "pallas":
        return "pallas"
    return "packed" if _use_packed(solver_cfg) else "vmap"


def manifest_key_fields() -> "dict[str, frozenset]":
    """The config fields the manifest covers, per config class."""
    from nmfx_torch.registry import FINGERPRINT_SOLVER_EXCLUDED

    return {
        "solver": (frozenset(f.name
                             for f in dataclasses.fields(SolverConfig))
                   - set(FINGERPRINT_SOLVER_EXCLUDED)),
        "consensus": (frozenset(
            f.name for f in dataclasses.fields(ConsensusConfig))
            - set(MANIFEST_CONSENSUS_EXCLUDED)),
    }


def _env_info(device) -> dict:
    """The environment half of the manifest: per-restart float
    trajectories repeat only on the same torch/CUDA build and card."""
    dev = torch.device(device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "device_kind": kind}


def _fingerprint(a: np.ndarray, ccfg: ConsensusConfig, scfg: SolverConfig,
                 icfg: InitConfig) -> str:
    """sha256 over everything that decides a record's numbers: the
    input's content key, the covered solver/consensus fields (backend as
    the engine family), the init config and the format version."""
    dkey = default_cache().key_for(a, scfg.dtype)
    covered = manifest_key_fields()
    solver = {name: getattr(scfg, name) for name in sorted(covered["solver"])}
    solver["backend"] = engine_family(scfg)
    solver["experimental"] = dataclasses.asdict(scfg.experimental)
    payload = {
        "data": {"fingerprint": dkey.fingerprint,
                 "src_dtype": dkey.src_dtype, "shape": list(dkey.shape),
                 "dtype": dkey.dtype},
        "solver": solver,
        "consensus": {name: getattr(ccfg, name)
                      for name in sorted(covered["consensus"])},
        "init": dataclasses.asdict(icfg),
        "format": _FORMAT_VERSION,
    }
    return hashlib.sha256(json.dumps(payload, sort_keys=True,
                                     default=str).encode()).hexdigest()


def plan_chunks(restarts: int, chunk: "int | None") -> tuple:
    """The chunk plan: ``[0,c), [c,2c), ...``, the last one shorter;
    ``chunk=None`` is one chunk per rank."""
    c = restarts if chunk is None else min(chunk, restarts)
    return tuple((r0, min(r0 + c, restarts))
                 for r0 in range(0, restarts, c))


def atomic_save_npz(path: str, arrays: dict) -> None:
    """``np.savez`` to a temporary file, then ``os.replace``, so a crash
    mid-write never leaves a torn record. Passes the ``ckpt.write`` site,
    which raises before any byte lands."""
    faults.inject("ckpt.write")
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:  # a handle: savez adds no ".npz"
            np.savez(fh, **arrays)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass  # never created, or gone; the first error re-raises
        raise


class SweepCheckpoint:
    """A directory of per-(rank, restart-chunk) records behind one
    content-addressed manifest."""

    def __init__(self, directory: str, fingerprint: str, env: dict,
                 plan: tuple, restarts: int, shape: tuple,
                 every_s: "float | None" = None, resume: bool = True):
        self.directory = directory
        self.fingerprint = fingerprint
        self.plan = tuple(plan)
        self.restarts = restarts
        self.shape = tuple(shape)
        self.every_s = every_s
        os.makedirs(directory, exist_ok=True)
        self._pending: "list[tuple[int, int, int, object]]" = []
        self._pending_lock = threading.Lock()
        self._last_flush = time.monotonic()
        #: this open extended a compatible ledger (same data, config and
        #: environment, another restart budget or plan): its records are
        #: kept and only the missing plan chunks solve
        self.extended = False
        meta = {"fingerprint": fingerprint, "env": env,
                "plan": [list(c) for c in self.plan],
                "restarts": restarts, "format": _FORMAT_VERSION}
        old = self._read_manifest()
        if old is None and os.path.exists(
                os.path.join(directory, "registry.json")):
            faults.warn_once(
                "ckpt-legacy-registry",
                f"{directory!r} holds a legacy per-rank SweepRegistry; "
                "the durable ledger cannot resume from its records "
                "(they are left untouched). Use "
                "nmfconsensus(checkpoint_dir=...) to resume the legacy "
                "registry, or point the checkpoint at a fresh directory")
        fresh = old is None
        if not resume and not fresh:
            faults.warn_once(
                "ckpt-no-resume",
                f"checkpoint ledger at {directory!r} cleared on request "
                "(resume=False); recomputing from scratch")
            self._clear_records()
            fresh = True
        elif not fresh and old != meta:
            if all(old.get(f) == meta[f]
                   for f in ("fingerprint", "env", "format")):
                # another restart budget or plan: chunk [r0, r1) solves
                # from keys split(fold_in(key(seed), k), R)[r0:r1], the
                # same under any budget R that holds it, so every record
                # at a boundary of the new plan is still right
                self.extended = True
                _flight.record("ckpt.extend", directory=directory,
                               old_restarts=old.get("restarts"),
                               new_restarts=restarts)
            else:
                faults.warn_once(
                    "ckpt-manifest-mismatch",
                    f"checkpoint ledger at {directory!r} was written "
                    "for a different (data, config, environment) "
                    "combination — starting a CLEAN COLD START "
                    "(existing records cleared and recomputed), never "
                    "a wrong resume")
                self._clear_records()
                fresh = True
        if fresh or self.extended:
            tmp = os.path.join(directory, _MANIFEST_NAME + ".tmp")
            with open(tmp, "wt") as f:
                json.dump(meta, f)
            os.replace(tmp, os.path.join(directory, _MANIFEST_NAME))

    def _read_manifest(self) -> "dict | None":
        path = os.path.join(self.directory, _MANIFEST_NAME)
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (json.JSONDecodeError, OSError) as e:
            faults.warn_once(
                "ckpt-manifest-corrupt",
                f"checkpoint manifest at {path!r} is unreadable ({e}); "
                "treating the ledger as foreign and cold-starting")
            return None

    @classmethod
    def open(cls, a, ccfg: ConsensusConfig, scfg: SolverConfig,
             icfg: InitConfig, cp_cfg: CheckpointConfig,
             device="cpu") -> "SweepCheckpoint":
        arr = np.asarray(a)
        return cls(cp_cfg.directory, _fingerprint(arr, ccfg, scfg, icfg),
                   _env_info(device),
                   plan_chunks(ccfg.restarts, cp_cfg.every_n_restarts),
                   ccfg.restarts, arr.shape, every_s=cp_cfg.every_s,
                   resume=cp_cfg.resume)

    def _path(self, k: int, r0: int, r1: int) -> str:
        return os.path.join(self.directory, f"k{k}_r{r0}-{r1}.npz")

    def has(self, k: int, r0: int, r1: int) -> bool:
        return os.path.exists(self._path(k, r0, r1))

    def completed_chunks(self, k: int) -> "list[tuple[int, int]]":
        return [(r0, r1) for r0, r1 in self.plan if self.has(k, r0, r1)]

    def record_count(self) -> int:
        return sum(1 for name in os.listdir(self.directory)
                   if _RECORD_RE.match(name))

    def _clear_records(self) -> None:
        # this ledger's records only: user files, a legacy registry's
        # k<k>.npz and anything else in the directory stay
        for name in os.listdir(self.directory):
            if _RECORD_RE.match(name) is None:
                continue
            try:
                os.unlink(os.path.join(self.directory, name))
            except OSError:
                pass  # a survivor fails the record checks on load

    def save(self, k: int, r0: int, r1: int, rec) -> None:
        """Commit one chunk's ``ChunkSweepOutput`` (host arrays): written
        now, or with ``every_s`` buffered until the next flush. A failed
        write (``ckpt.write``, a full disk) warns once and the run goes
        on; only that record's durability is lost."""
        if self.every_s is None:
            self._write(k, r0, r1, rec)
            return
        with self._pending_lock:
            self._pending.append((k, r0, r1, rec))
            due = time.monotonic() - self._last_flush >= self.every_s
        if due:
            self.flush()

    def flush(self) -> None:
        """Write every buffered record now (the signal hook's body; also
        at rank boundaries and at the end of the sweep)."""
        while True:
            with self._pending_lock:
                if not self._pending:
                    self._last_flush = time.monotonic()
                    return
                k, r0, r1, rec = self._pending.pop(0)
            self._write(k, r0, r1, rec)

    def _write(self, k: int, r0: int, r1: int, rec) -> None:
        arrays = {name: np.asarray(v) for name, v in zip(rec._fields, rec)}
        arrays["record_fingerprint"] = np.asarray(self.fingerprint)
        try:
            with _trace.default_tracer().span(
                    "ckpt.commit", cat="ckpt",
                    args={"k": k, "r0": r0, "r1": r1}):
                atomic_save_npz(self._path(k, r0, r1), arrays)
            _flight.record("ckpt.commit", k=k, r0=r0, r1=r1)
        except Exception as e:
            faults.warn_once(
                "ckpt-write-failed",
                f"failed to persist checkpoint record k={k} "
                f"r=[{r0},{r1}) ({e!r}); the sweep continues — only "
                "this chunk's durability is lost (it will recompute on "
                "resume)")

    def try_load(self, k: int, r0: int, r1: int):
        """One chunk's record as a host ``ChunkSweepOutput``, or None for
        a missing, torn, corrupt or foreign record (one warning; the
        chunk solves again). Passes the ``ckpt.load`` site."""
        from nmfx_torch.sweep import ChunkSweepOutput

        path = self._path(k, r0, r1)
        if not os.path.exists(path):
            return None
        c = r1 - r0
        m, n = self.shape
        try:
            faults.inject("ckpt.load")
            with np.load(path, allow_pickle=False) as z:
                if str(z["record_fingerprint"]) != self.fingerprint:
                    raise ValueError("record fingerprint does not match "
                                     "the manifest")
                rec = ChunkSweepOutput(**{f: z[f]
                                          for f in ChunkSweepOutput._fields})
            expect = {"labels": (c, n), "iterations": (c,),
                      "dnorms": (c,), "stop_reasons": (c,),
                      "best_local": (), "best_w": (m, k),
                      "best_h": (k, n)}
            for name, shape in expect.items():
                got = getattr(rec, name).shape
                if got != shape:
                    raise ValueError(f"field {name} has shape {got}, "
                                     f"expected {shape}")
            if not 0 <= int(rec.best_local) < c:
                raise ValueError("best_local out of chunk range")
        except Exception as e:
            faults.warn_once(
                "ckpt-record-corrupt",
                f"checkpoint record {path!r} is torn/corrupt/foreign "
                f"({e!r}); skipping it and re-running that chunk — "
                "results are unaffected, only that chunk's resume win "
                "is lost")
            return None
        _note(loaded=1)
        return rec


def _preempt_check(k: int, r0: int, r1: int) -> None:
    if faults.fire("proc.preempt"):
        raise Preempted(
            f"injected preemption after solving chunk k={k} "
            f"r=[{r0},{r1}) and before its commit — this chunk is "
            "lost; every committed record survives for resume")


def solve_chunk_host(a_dev: torch.Tensor, k: int, r0: int, r1: int,
                     ccfg: ConsensusConfig, scfg: SolverConfig,
                     icfg: InitConfig, keys=None):
    """Solve restarts ``[r0, r1)`` of rank ``k`` on A's device and bring
    the chunk's record to the host. ``keys`` is the rank's whole key
    array ``split(fold_in(key(seed), k), restarts)`` (computed here when
    absent), so a chunk's draws do not depend on which run solves it.
    The ``proc.preempt`` site fires after the solve, before the caller
    can commit: the in-flight chunk is lost."""
    from nmfx_torch.sweep import _build_chunk_sweep_fn

    if scfg.backend == "sketched":
        raise ValueError(
            "durable chunk execution does not support "
            "backend='sketched' or screen=True (bit-identical replay "
            "vs statistical/whole-pool contracts); use an exact "
            "unscreened engine")
    if keys is None:
        keys = _random.split(_random.fold_in(_random.key(ccfg.seed), k),
                             ccfg.restarts)
    poison = tuple(r - r0 for r in faults.poison_restarts(k, ccfg.restarts)
                   if r0 <= r < r1)
    fn = _build_chunk_sweep_fn(k, r1 - r0, scfg, icfg, ccfg.label_rule,
                               poison)
    out = fn(a_dev, keys[r0:r1])
    host = type(out)(*(x.cpu().numpy() for x in out))
    _note(solved=1)
    _preempt_check(k, r0, r1)
    return host


def _finalize_rank(k: int, recs: dict, ccfg: ConsensusConfig,
                   shape: tuple):
    """Rank ``k``'s host ``KSweepOutput`` from its chunk records, in
    restart order: int64 connectivity counts, one float64 division by
    the survivor count, and the global first-minimum ``argmin`` of the
    dnorms (quarantined lanes +inf) for the best restart."""
    from nmfx_torch.solvers.base import StopReason
    from nmfx_torch.sweep import KSweepOutput

    restarts = ccfg.restarts
    n = shape[1]
    first = next(iter(recs.values()))
    labels = np.empty((restarts, n), np.int32)
    iters = np.empty((restarts,), np.asarray(first.iterations).dtype)
    dnorms = np.empty((restarts,), np.asarray(first.dnorms).dtype)
    stops = np.empty((restarts,), np.asarray(first.stop_reasons).dtype)
    for (r0, r1), rec in sorted(recs.items()):
        labels[r0:r1] = rec.labels
        iters[r0:r1] = rec.iterations
        dnorms[r0:r1] = rec.dnorms
        stops[r0:r1] = rec.stop_reasons
    faulted = ((stops == int(StopReason.NUMERIC_FAULT))
               | (stops == int(StopReason.SCREENED)))
    onehot = (labels[~faulted][:, :, None]
              == np.arange(k)[None, None, :]).astype(np.int64)
    counts = np.einsum("rik,rjk->ij", onehot, onehot)
    n_fault = int(faulted.sum())
    div = max(restarts - n_fault, 1) if n_fault else restarts
    cons = counts / np.float64(div)
    best = int(np.argmin(np.where(faulted, np.inf,
                                  dnorms.astype(np.float64))))
    (r0_best, _), best_rec = next(
        ((r0, r1), rec) for (r0, r1), rec in sorted(recs.items())
        if r0 <= best < r1)
    if int(best_rec.best_local) + r0_best != best and n_fault < restarts:
        raise ValueError(
            f"checkpoint records for k={k} are inconsistent: chunk "
            f"[{r0_best},…) nominates restart "
            f"{int(best_rec.best_local) + r0_best} as its best but the "
            f"global replay selects {best}; the ledger is corrupt — "
            "delete the directory and re-run")
    return KSweepOutput(
        consensus=cons, iterations=iters, dnorms=dnorms,
        stop_reasons=stops, labels=labels,
        best_w=np.asarray(best_rec.best_w),
        best_h=np.asarray(best_rec.best_h))


def run_checkpointed_sweep(a, cfg: ConsensusConfig, solver_cfg: SolverConfig,
                           init_cfg: InitConfig, cp_cfg: CheckpointConfig,
                           *, device=None, profiler=None,
                           on_rank=None) -> dict:
    """The durable sweep: every (rank, chunk) of the plan through the
    ledger, solving only the chunks without a valid record, and each
    rank finalized from its records. Returns ``{k: KSweepOutput}`` of
    host arrays, which both harvest modes take as they are. Profiler
    phases: ``ckpt.load``, ``solve.ckpt.k={k}``, ``checkpoint`` and
    ``ckpt.finalize``."""
    if profiler is None:
        profiler = NullProfiler()
    if cfg.keep_factors:
        raise ValueError(
            "keep_factors is not supported on checkpointed sweeps (the "
            "ledger persists per-restart stats and best candidates, not "
            "every factor stack); recompute any restart exactly with "
            "nmfx_torch.restart_factors")
    if solver_cfg.backend == "sketched":
        raise ValueError(
            "checkpointed sweeps do not support backend='sketched' or "
            "screen=True (the durable ledger replays per-(k, chunk) "
            "records bit-identically; the sketched/screened paths are "
            "whole-pool and statistical) — drop the checkpoint or use "
            "an exact unscreened engine")
    check_ported(solver_cfg)
    dev = resolve_device(device)
    arr = np.asarray(a)
    ck = SweepCheckpoint.open(arr, cfg, solver_cfg, init_cfg, cp_cfg, dev)
    restore = install_signal_flush(ck)
    a_dev = None
    out: dict = {}
    loaded_total = solved_total = 0
    try:
        for k in cfg.ks:
            recs: dict = {}
            missing = []
            for r0, r1 in ck.plan:
                with profiler.phase("ckpt.load"):
                    rec = ck.try_load(k, r0, r1)
                if rec is None:
                    missing.append((r0, r1))
                else:
                    recs[(r0, r1)] = rec
                    loaded_total += 1
            solved_total += len(missing)
            if missing:
                if a_dev is None:  # a fully resumed sweep copies nothing
                    a_dev = place_resilient(arr, solver_cfg, dev,
                                            profiler=profiler)
                keys = _random.split(
                    _random.fold_in(_random.key(cfg.seed), k), cfg.restarts)
                for r0, r1 in missing:
                    with profiler.phase(f"solve.ckpt.k={k}"):
                        try:
                            rec = solve_chunk_host(a_dev, k, r0, r1, cfg,
                                                   solver_cfg, init_cfg,
                                                   keys=keys)
                        except Preempted:
                            ck.flush()  # committed work must survive
                            raise
                    with profiler.phase("checkpoint"):
                        ck.save(k, r0, r1, rec)
                    recs[(r0, r1)] = rec
            with profiler.phase("ckpt.finalize"):
                out[k] = _finalize_rank(k, recs, cfg, arr.shape)
            ck.flush()  # rank boundary: buffered records land
            if on_rank is not None:
                on_rank(k, out[k])
        if loaded_total > 0 and (ck.extended or solved_total > 0):
            # an incremental run that REUSED records while producing new
            # work (a widened budget, or widened ks / a partial resume);
            # a fully loaded re-run is a replay, not an extension
            _extended_total.inc()
            _flight.record("result_cache.extend", directory=ck.directory,
                           loaded=loaded_total, restarts=cfg.restarts,
                           ks=list(cfg.ks))
        return {k: out[k] for k in cfg.ks}
    finally:
        ck.flush()
        restore()


def install_signal_flush(ck: SweepCheckpoint):
    """Hook SIGTERM and SIGINT so a preemption notice writes the
    buffered records first, then defers to the handler found (a callable
    runs; an ignored signal stays ignored; the default raises
    ``KeyboardInterrupt`` / ``SystemExit(128 + signum)``). Returns a
    callable that puts the handlers found back; off the main thread
    nothing is installed and it does nothing."""
    installed: dict = {}

    def _handler(signum, frame):
        ck.flush()
        prev = installed.get(signum)
        if callable(prev):
            prev(signum, frame)
        elif prev is signal.SIG_IGN:
            return
        elif signum == signal.SIGINT:
            raise KeyboardInterrupt
        else:
            raise SystemExit(128 + signum)

    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            installed[sig] = signal.signal(sig, _handler)
    except ValueError:  # not the main thread: nothing was installed
        return lambda: None

    def restore():
        for sig, prev in installed.items():
            signal.signal(sig, prev)

    return restore
