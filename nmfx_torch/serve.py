"""Multi-tenant serving engine: async request queue + continuous
cross-request restart batching (counterpart of ``nmfx/serve.py``).

Many concurrent consensus jobs share one card through an async request
queue and a single scheduler thread that owns dispatch. The scheduler
does **continuous restart batching**: restarts from *different*
requests are packed into the lanes of one slot-scheduled dispatch
(``sweep._build_packed_serve_fn``); under ``backend="pallas"`` that
pool runs the hand-written block kernels (mu's ``csrc/block_mu.cu``,
hals' ``csrc/hals_block.cu``). Each request's rank-k restart block is
one lane group; the slot scheduler solves every lane independently, so
a request's results are **byte-equal to its solo run** through the same
executable cache (``exec_cache.ExecCache.run_sweep``). Requests that
cannot share lanes (different matrices, NNDSVD init, non-cacheable
configurations, deadline-clamped solves) dispatch solo through the same
engine.

Layering::

    submit(A, ks, ...) ──► admission control ──► priority queue
                                                     │  scheduler thread
                                                     ▼
                                  compatibility grouping + lane packing
                                                     │
                     ┌───────────────────────────────┴─────────────┐
                     ▼ (≥2 compatible requests)                    ▼ (solo)
          _build_packed_serve_fn dispatch            ExecCache.run_sweep /
          (one pool, lanes from                      sweep.sweep
           several requests)                                       │
                     └───────────────────────────────┬─────────────┘
                                                     ▼
                            completion workers: per-rank harvest
                            (``harvest.harvest_rank`` — the SAME body
                            the streamed pipeline runs) ──► Future

Admission control bounds the queue by depth AND by pending input bytes;
the priority queue orders by (priority desc, deadline asc, arrival); a
request whose deadline expires while queued resolves to a typed
:class:`DeadlineExceeded` without dispatching, and one that would expire
mid-solve is dispatched solo with its per-lane iteration budget clamped
from the remaining deadline (``ServeConfig.iter_rate_estimate``).

Exactness contract: a packed request's lanes draw the canonical
per-(seed, k, restart) key chain, the pool always has ``grid_slots``
lanes with the tail cascade off, and the compatibility key includes the
request's largest rank, so a lane's zero-padding to the pool's ``k_max``
is the same in the packed and the solo pool. Its results then equal the
solo path's byte for byte on the card's kernels and on the plain
versions alike. (The reference packs requests of any largest rank; its
``tests/test_serve.py::test_cross_request_packing_bit_identical`` packs
ks (2, 3) beside (2,), whose solo pool is two columns narrower, and the
plain products' reductions over k differ by an ulp there.) A
deadline-clamped request is exact against a solo run at the clamped
``max_iter`` (recorded in its :class:`RequestStats`).

Threads and the card: the scheduler thread launches the kernels (their
first launch builds them with ``nvcc``) and the completion workers wait
on each rank's CUDA event (``harvest.HostFetch``), never on a device
synchronize; both threads set A's device as their current device, and
every launch stays on that device's default stream. A kernel that fails
to build or launch resolves its request with a typed
:class:`RequestFailed` chaining the error, never with a plain-version
result.

Quality elasticity (``ServeConfig.quality_elastic``): a deadline that
would clamp an eligible request's iteration budget, or a queue depth
over its bound (up to twice it), degrades the request to the sketched
engine instead (``backend="sketched"``, solo, never packed). Such a
result is always tagged: ``ConsensusResult.quality == "sketched"``,
``RequestStats.quality`` / ``degraded_cause``, the
``nmfx_serve_quality_degraded_total{cause}`` counter and a
``serve.quality_degraded`` flight event. A request that asked for the
sketched backend is tagged, not counted as degraded.

The mesh tier: ``ServeConfig.mesh_spec`` ("R", "RxF" or "RxFxS",
validated at construction) makes the server a mesh replica whose
:class:`MeshEngine` runs every request solo through ``sweep()`` over its
mesh, the grid-sharded sweep on feature or sample axes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq
import itertools
import threading
import time
from concurrent.futures import Future
from typing import TYPE_CHECKING, Mapping, Protocol, Sequence

import numpy as np

from nmfx_torch.config import (SKETCHED_ALGORITHMS,
                               ConsensusConfig, InitConfig, SolverConfig,
                               check_ported)
from nmfx_torch.guards import guarded_by
from nmfx_torch.obs import costmodel as _costmodel
from nmfx_torch.obs import flight as _flight
from nmfx_torch.obs import metrics as _metrics
from nmfx_torch.obs import slo as _slo
from nmfx_torch.obs import trace as _trace

if TYPE_CHECKING:
    from nmfx_torch.api import ConsensusResult
    from nmfx_torch.sweep import KSweepOutput

__all__ = ["DeadlineExceeded", "Engine", "ExecCacheEngine", "NMFXServer",
           "QueueFull", "RequestFailed", "RequestStats", "ServeConfig",
           "ServeError", "ServerClosed", "ServerCrashed",
           "break_spill_claim", "claim_spill", "dispatch_count",
           "list_spills", "load_spill_record", "packed_dispatch_count",
           "packing_efficiency", "release_spill_claim",
           "serve_key_fields", "spill_claimant", "spill_dataset",
           "spill_meta", "spill_submit_kwargs", "verify_spill_claim",
           "write_spill_record"]


# --------------------------------------------------------------------------
# module counters — the honesty-counter discipline of
# exec_cache.compile_count() / data_cache.transfer_count(): the
# cross-request-packing contract is gated on these, not on log lines.
# The numbers live as labeled series on the process-wide metrics
# registry (nmfx_torch.obs.metrics); dispatch_count()/
# packed_dispatch_count()/packing_efficiency() are the read shims
_dispatch_total = _metrics.counter(
    "nmfx_serve_dispatches_total",
    "executable dispatches issued by serve schedulers",
    labelnames=("packed",))
_lanes_total = _metrics.counter(
    "nmfx_serve_lanes_total",
    "restart lanes dispatched by serve schedulers",
    labelnames=("packed",))
#: serve latency surfaces (docs/observability.md): streaming-quantile
#: histograms per request — queue residency, the dispatch step, the
#: device-blocked fetch, and submit→resolved end-to-end
_queue_wait_hist = _metrics.histogram(
    "nmfx_serve_queue_wait_seconds", "submit-to-dispatch queue residency")
_pack_hist = _metrics.histogram(
    "nmfx_serve_pack_seconds",
    "placement + lane packing + executable lookup + async dispatch")
_solve_hist = _metrics.histogram(
    "nmfx_serve_solve_seconds",
    "per-request device-blocked fetch wall (solve + queueing behind "
    "dispatch-mates)")
_e2e_hist = _metrics.histogram(
    "nmfx_serve_e2e_seconds",
    "submit-to-resolution request latency", labelnames=("outcome",))
#: quality-elastic degradations: requests the scheduler served through
#: the sketched engine instead of expiring or rejecting them (cause
#: "deadline" | "overload"); every increment has a tagged result and a
#: serve.quality_degraded flight event
_quality_degraded_total = _metrics.counter(
    "nmfx_serve_quality_degraded_total",
    "requests degraded to the sketched engine by quality-elastic "
    "scheduling", labelnames=("cause",))
#: request-economics counter: also declared in
#: nmfx_torch.result_cache — the registry's idempotent get-or-create
#: hands both sites one shared series
_coalesced_total = _metrics.counter(
    "nmfx_result_cache_coalesced_total",
    "requests attached as followers to an identical in-flight solve "
    "instead of dispatching their own", labelnames=("layer",))
#: level gauges for the fleet view: a router/autoscaler reads
#: per-replica queue depth and inflight load from the merged telemetry,
#: where gauges stay keyed by instance
_queue_depth_gauge = _metrics.gauge(
    "nmfx_serve_queue_depth",
    "requests queued but not yet dispatched (admission-bounded)")
_inflight_gauge = _metrics.gauge(
    "nmfx_serve_inflight",
    "requests dispatched but not yet resolved")
#: process-wide spill-record counter: per-SERVER request seqs restart
#: at 0, so a restarted server in the same process would overwrite an
#: earlier server's spill_{pid}_{seq}.npz — this counter keeps every
#: spill filename unique within the process (pid keeps it unique
#: across processes)
_spill_seq = itertools.count()


def dispatch_count() -> int:
    """Executable dispatches issued by serve schedulers in this process
    (packed and solo). Reads the registry counter
    ``nmfx_serve_dispatches_total`` summed over its ``packed`` label
    (back-compat shim)."""
    return int(_dispatch_total.total())


def packed_dispatch_count() -> int:
    """Dispatches that ACTUALLY contained lanes from >= 2 distinct
    requests — the counter the cross-request packing contract is gated
    on (a test asserting packing must watch this, not wall clocks)."""
    return int(_dispatch_total.value(packed="true"))


def packing_efficiency() -> "float | None":
    """Fraction of all dispatched lanes that rode a packed (multi-
    request) dispatch; None before the first dispatch."""
    series = _lanes_total.series()  # one atomic cut of both labels
    total = sum(series.values())
    if total == 0:
        return None
    return series.get(("true",), 0.0) / total


def _note_dispatch(n_requests: int, lanes: int) -> None:
    packed = "true" if n_requests >= 2 else "false"
    _dispatch_total.inc(packed=packed)
    _lanes_total.inc(lanes, packed=packed)


# --------------------------------------------------------------------------
# spill records + the claim protocol
#
# A spill record is ONE request's full submission payload as an atomic
# npz (``spill_*.npz``: the matrix + a JSON meta blob) — written by a
# server spilling its queue on shutdown (``ServeConfig.spill_dir``), by
# a router forwarding to a subprocess replica (the record IS the
# forward), or by anything else that needs a request to survive a
# process. Re-admitting one through :func:`spill_submit_kwargs` +
# ``NMFXServer.submit`` reproduces the original submission
# field-for-field, so results are bit-identical by the serving
# exactness contract.
#
# The CLAIM protocol makes spill directories safe for MULTIPLE
# consumers (two routers recovering one dead replica, N survivor
# replicas draining one spill dir): a consumer must own
# ``<record>.claim`` before readmitting, created with O_CREAT|O_EXCL —
# the one atomic-exclusive primitive POSIX gives us (tmp+rename
# REPLACES silently, so it cannot express mutual exclusion). Exclusion
# is by existence; the claim's JSON payload (claimant, pid, time) is
# advisory context for breaking the claim of a consumer that died
# between claiming and readmitting (:func:`break_spill_claim`). The
# record and its claim are removed only after the re-admission
# SUCCEEDED, so a consumer crash at any point leaves either an
# unclaimed record (anyone readmits) or a stale claim (broken by pid
# or age), never a lost or double-readmitted request —
# tests/test_multiprocess.py races two OS processes over one spill dir
# to pin exactly-once re-admission.
# --------------------------------------------------------------------------

#: spill record filenames: spill_<unique>.npz (+ .claim while owned)
SPILL_PREFIX = "spill_"
_CLAIM_SUFFIX = ".claim"


def spill_meta(*, request_id, ks, restarts, seed, scfg, icfg,
               label_rule="argmax", linkage="average", grid_slots=48,
               grid_tail_slots="auto", min_restarts=1, priority=0,
               col_names=(), **extra) -> dict:
    """The JSON-serializable meta half of a spill record. ``extra``
    keys (e.g. a router's own request id) ride along verbatim and come
    back from :func:`load_spill_record`."""
    import os

    meta = {
        "request_id": request_id, "spill_pid": os.getpid(),
        "ks": [int(k) for k in ks], "restarts": int(restarts),
        "seed": int(seed), "label_rule": label_rule, "linkage": linkage,
        "grid_slots": int(grid_slots),
        "grid_tail_slots": (list(grid_tail_slots)
                            if isinstance(grid_tail_slots, (list, tuple))
                            else grid_tail_slots),
        "min_restarts": int(min_restarts), "priority": int(priority),
        "col_names": [str(c) for c in col_names],
        "solver_cfg": dataclasses.asdict(scfg),
        "init_cfg": dataclasses.asdict(icfg),
    }
    meta.update(extra)
    return meta


def write_spill_record(path: str, a: np.ndarray, meta: dict) -> str:
    """Atomically persist one spill record (tmp+rename via the
    checkpoint ledger's writer, which also passes the ``ckpt.write``
    chaos site)."""
    import json
    import os

    from nmfx_torch.checkpoint import atomic_save_npz

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    atomic_save_npz(path, {"a": np.asarray(a),
                           "meta": np.asarray(json.dumps(meta))})
    return path


def load_spill_record(path: str) -> "tuple[np.ndarray, dict]":
    """Read one spill record back (raises on torn/corrupt — callers
    apply the ledger's skip-warn-once discipline). Passes the
    ``ckpt.load`` chaos site."""
    import json

    from nmfx_torch import faults

    faults.inject("ckpt.load")
    with np.load(path, allow_pickle=False) as z:
        a = z["a"]
        meta = json.loads(str(z["meta"]))
    return a, meta


def spill_submit_kwargs(meta: dict) -> dict:
    """Reconstruct ``NMFXServer.submit`` keyword arguments from a spill
    record's meta — the ONE re-admission funnel, so a readmitted request
    is field-for-field the original submission no matter who readmits
    it. The configs go through ``nmfx_torch.convert``, so a record the
    reference's server spilled readmits here too (fields the port has
    not got must be inert)."""
    from nmfx_torch.convert import (init_config_from_dict,
                                    solver_config_from_dict)

    scfg = solver_config_from_dict(dict(meta["solver_cfg"]))
    icfg = init_config_from_dict(dict(meta["init_cfg"]))
    tail = meta["grid_tail_slots"]
    if isinstance(tail, list):
        tail = tuple(tail)
    return dict(ks=tuple(meta["ks"]), restarts=meta["restarts"],
                seed=meta["seed"], solver_cfg=scfg, init_cfg=icfg,
                label_rule=meta["label_rule"], linkage=meta["linkage"],
                grid_slots=meta["grid_slots"], grid_tail_slots=tail,
                min_restarts=meta["min_restarts"],
                priority=meta["priority"])


def spill_dataset(a: np.ndarray, meta: dict):
    """A Dataset carrying the spilled col_names back through submit's
    ``_as_matrix``, so the re-admitted result is field-for-field what
    the original submission would have delivered (row names were never
    retained by the request)."""
    from nmfx_torch.io import Dataset

    names = [str(c) for c in meta["col_names"]]
    return Dataset(values=a,
                   row_names=[str(i + 1) for i in range(a.shape[0])],
                   col_names=names)


def list_spills(spill_dir: str) -> "list[str]":
    """The spill record paths in a directory, sorted (stable
    re-admission order across consumers)."""
    import os

    if not os.path.isdir(spill_dir):
        return []
    return [os.path.join(spill_dir, name)
            for name in sorted(os.listdir(spill_dir))
            if name.startswith(SPILL_PREFIX) and name.endswith(".npz")]


def claim_spill(path: str, claimant: str) -> bool:
    """Atomically claim one spill record for re-admission. True when
    THIS caller now owns it; False when another consumer already does.
    O_CREAT|O_EXCL on ``<path>.claim`` is the exclusion; the payload
    (claimant/pid/time) is advisory context for
    :func:`break_spill_claim`."""
    import json
    import os
    import time as _time

    try:
        fd = os.open(path + _CLAIM_SUFFIX,
                     os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    try:
        os.write(fd, json.dumps({"claimant": claimant,
                                 "pid": os.getpid(),
                                 "time": _time.time()}).encode())
    finally:
        os.close(fd)
    return True


def spill_claimant(path: str) -> "dict | None":
    """The advisory claim payload of a spill record, or None when
    unclaimed (a torn claim payload reads as ``{}`` — the claim still
    excludes; only its context is gone)."""
    import json
    import os

    try:
        with open(path + _CLAIM_SUFFIX) as f:
            body = f.read()
    except OSError:
        return None
    try:
        payload = json.loads(body)
        return payload if isinstance(payload, dict) else {}
    except ValueError:
        return {}


def release_spill_claim(path: str) -> None:
    """Drop a claim (after re-admission, or to hand the record back —
    e.g. a draining replica releasing what it never started)."""
    import os

    try:
        os.unlink(path + _CLAIM_SUFFIX)
    except OSError:  # already released/raced;
        pass         # exclusion is by existence, absence needs no cleanup


#: how long a ``.break`` marker may exist before it reads as a crashed
#: breaker (the marker is held for microseconds on the happy path)
_BREAK_MARKER_STALE_S = 60.0


def break_spill_claim(path: str, *, owner_pid: "int | None" = None,
                      older_than_s: "float | None" = None) -> bool:
    """Break another consumer's claim when its owner is known dead
    (``owner_pid`` matches the claim's pid — a router breaking a
    SIGKILLed replica's claims) or provably stale (``older_than_s``).
    Returns True when the record is claimable again.

    Breaking is serialized through an O_EXCL ``.break`` marker, and
    the staleness judgment happens UNDER the marker: a bare
    read-then-unlink would let breaker B (acting on a stale read of
    the OLD claim) delete breaker A's fresh re-claim, leaving both
    believing they own the record — the double-readmission the claim
    protocol exists to prevent. With the marker, exactly one breaker
    unlinks per claim generation, and a fresh re-claim is never
    judged by a stale read. A marker left by a crashed breaker is
    removed once it ages past ``_BREAK_MARKER_STALE_S`` (the caller
    retries on its next pass)."""
    import json
    import os
    import time as _time

    if spill_claimant(path) is None:
        return True  # never claimed
    marker = path + ".break"
    try:
        fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        # another breaker holds the marker; clean a crashed breaker's
        # leftover so a later pass can retry
        try:
            if _time.time() - os.stat(marker).st_mtime \
                    > _BREAK_MARKER_STALE_S:
                os.unlink(marker)
        except OSError:  # marker already
            pass         # released by its (live) owner
        return False
    try:
        os.write(fd, json.dumps({"pid": os.getpid(),
                                 "time": _time.time()}).encode())
    finally:
        os.close(fd)
    try:
        # judged under the marker: re-read the CURRENT claim
        payload = spill_claimant(path)
        if payload is None:
            return True
        ok = False
        if owner_pid is not None and payload.get("pid") == owner_pid:
            ok = True
        if older_than_s is not None:
            t = payload.get("time")
            if not isinstance(t, (int, float)) \
                    or _time.time() - t > older_than_s:
                ok = True
        if not ok:
            return False
        try:
            os.unlink(path + _CLAIM_SUFFIX)
        except OSError:  # claim released by
            pass         # its owner while we held the marker
        return True
    finally:
        try:
            os.unlink(marker)
        except OSError:  # a cleaner judged
            pass         # our marker crashed-stale; harmless


def verify_spill_claim(path: str, claimant: str) -> bool:
    """Whether ``claimant`` currently holds the record's claim (a
    belt-and-braces re-check after winning a contested break)."""
    payload = spill_claimant(path)
    return payload is not None and payload.get("claimant") == claimant


# --------------------------------------------------------------------------
class ServeError(RuntimeError):
    """Base class of the serving engine's typed failures."""


class QueueFull(ServeError):
    """Admission control rejected the request (queue depth or pending
    input bytes over bound) — back off and resubmit."""


class ServerClosed(ServeError):
    """The server no longer accepts (or will not complete) requests."""


class DeadlineExceeded(ServeError, TimeoutError):
    """The request's deadline expired — while queued (never dispatched)
    or mid-solve (its lanes were stopped by the per-lane iteration
    budget; the computed results are discarded)."""


class RequestFailed(ServeError):
    """Every dispatch attempt for the request failed — the packed
    attempt (if any) and ``ServeConfig.dispatch_retries`` solo retries
    with exponential backoff. ``__cause__`` chains the last underlying
    failure; other requests in the same batch are unaffected (failure
    isolation is per-request)."""


class ServerCrashed(ServeError):
    """The scheduler thread died with this request pending — the
    watchdog resolved the future instead of leaving it hanging forever
    (``__cause__`` chains the exception that killed the scheduler).
    With ``ServeConfig.restart_scheduler`` the server keeps accepting
    NEW requests on a fresh scheduler; work pending at crash time is
    failed loudly, never replayed silently (at-most-once dispatch)."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-engine policy (``nmfx/serve.py``).

    Every field participates in ``__eq__``/``__hash__`` (frozen
    dataclass, no ``compare=False``) — the coverage
    :func:`serve_key_fields` declares and lint rule NMFX001 enforces,
    exactly like ``DataKey``/``SolverConfig``: the server's behavior
    contract is keyed by this config (tests and the bench traffic stage
    construct comparable servers from equal configs), so a field
    invisible to comparison would alias two different serving policies.
    """

    #: admission bound on requests queued but not yet dispatched;
    #: submit raises :class:`QueueFull` beyond it
    max_queue_depth: int = 64
    #: admission bound on the total host bytes of queued input matrices
    #: (they become device-resident at dispatch through the input
    #: cache); protects the placement path from unbounded buffering
    max_pending_bytes: int = 1 << 30
    #: pack lanes from at most this many requests into one dispatch
    max_batch_requests: int = 4
    #: cap on total lanes (Σ |ks|·restarts over the batch) per dispatch
    #: — bounds the packed executable's job batch the way grid_slots
    #: bounds its concurrent lanes
    max_batch_lanes: int = 1024
    #: enable cross-request lane packing (False = every request solo —
    #: the A/B baseline the packing-efficiency counter is read against)
    pack: bool = True
    #: after popping a packable request, linger this long for more
    #: compatible arrivals before dispatching — the classic continuous-
    #: batching knob (0 = dispatch immediately with whatever is queued)
    batch_linger_s: float = 0.0
    #: deadline applied to requests submitted without one (None = no
    #: implicit deadline)
    default_timeout_s: "float | None" = None
    #: estimated per-lane solver iterations per second, used to clamp a
    #: deadline request's per-lane iteration budget
    #: (``max_iter' = remaining_s * rate``, rounded up to a power-of-two
    #: multiple of check_every to bound executable churn). None = no
    #: mid-solve budget clamping; deadlines are then enforced at queue
    #: and completion boundaries only
    iter_rate_estimate: "float | None" = None
    #: completion worker threads (device→host fetch + host rank
    #: selection per finished request)
    harvest_workers: int = 2
    #: solo dispatch retries after a failed attempt (a failed PACKED
    #: dispatch always falls back to per-request solo first; these are
    #: the additional attempts each solo dispatch gets). Exhausting them
    #: resolves the future with a typed :class:`RequestFailed` whose
    #: cause chains the last failure
    dispatch_retries: int = 1
    #: base seconds of the exponential backoff between dispatch retries
    #: (attempt i sleeps ``retry_backoff_s * 2**i``)
    retry_backoff_s: float = 0.05
    #: scheduler-death policy: True (default) = the watchdog fails every
    #: request pending at crash time with :class:`ServerCrashed` and
    #: starts a fresh scheduler thread for subsequent submits; False =
    #: the server stays down (submits raise :class:`ServerCrashed`)
    restart_scheduler: bool = True
    #: watchdog poll interval: how often the monitor thread checks the
    #: scheduler's liveness/heartbeat (bounds crash-to-resolution
    #: latency)
    watchdog_interval_s: float = 0.25
    #: quality-elastic scheduling: let the scheduler DEGRADE a request to the
    #: sketched engine (``backend="sketched"`` — the random-projection
    #: compressed solver, statistical accuracy contract) instead of
    #: failing it, in two situations: (a) a deadline that would clamp
    #: the exact solve's iteration budget (``iter_rate_estimate``)
    #: dispatches sketched at the full budget instead — cause
    #: "deadline"; (b) a submit that admission control would reject on
    #: queue DEPTH admits degraded while the depth stays under
    #: 2×``max_queue_depth`` — cause "overload" (the pending-bytes
    #: bound stays hard: it protects host memory, not latency). Only
    #: requests whose algorithm has a sketched form
    #: (``config.SKETCHED_ALGORITHMS``) and that did not opt into
    #: screening are eligible; everything else keeps today's
    #: expiry/rejection. A degraded result is ALWAYS typed and tagged:
    #: ``ConsensusResult.quality = "sketched"``,
    #: ``RequestStats.quality``/``degraded_cause``, the
    #: ``nmfx_serve_quality_degraded_total{cause=…}`` counter, and a
    #: ``serve.quality_degraded`` flight event.
    quality_elastic: bool = False
    #: request coalescing: concurrent IDENTICAL submissions — same
    #: content-addressed result key: input bytes, every
    #: result-affecting config field, seed, quality — attach as
    #: FOLLOWERS to the one in-flight leader solve instead of
    #: dispatching their own; followers share the leader's outcome
    #: (result, typed error, or degraded-and-tagged result) and are
    #: never left hanging (a cancelled leader promotes its first live
    #: follower into the queue). Only requests WITHOUT a deadline
    #: coalesce — attaching a deadline'd request to a solve that may
    #: outlive its budget would conflate two expiry semantics. Opt-in:
    #: deduplication changes dispatch-count observables that existing
    #: packing tests and A/B baselines key on.
    coalesce_requests: bool = False
    #: finished-result cache directory: with a directory
    #: (or a ``result_cache=`` instance passed to the server), a
    #: submission whose content-addressed result key is already stored
    #: resolves IMMEDIATELY from the cache — zero solve dispatches,
    #: zero host-to-device transfers (counter-gated) — and every
    #: harvested result is admitted back. None = no result caching
    #: (the default: serving stays solve-through).
    result_cache_dir: "str | None" = None
    #: spill-on-shutdown directory: ``close(cancel_pending=True)``
    #: persists each queued-but-
    #: undispatched request's full submission payload here (atomic
    #: writes, the checkpoint ledger's discipline) before resolving its
    #: future with :class:`ServerClosed`, and a restarted server
    #: re-admits them with :meth:`NMFXServer.readmit` — results are
    #: bit-identical to direct submission (the serving exactness
    #: contract; absolute deadlines do not survive the restart and are
    #: dropped). None = shutdown discards queued requests.
    spill_dir: "str | None" = None
    #: fleet-telemetry ledger: with a directory, the server runs a
    #: ``TelemetryPublisher`` daemon writing atomic registry snapshots
    #: (+ instance identity and heartbeat) here every
    #: ``telemetry_interval_s``; a ``FleetCollector`` over the same
    #: directory merges N replicas into one fleet view. None = no
    #: publishing (the single-process default).
    telemetry_dir: "str | None" = None
    #: snapshot publish cadence for ``telemetry_dir``
    telemetry_interval_s: float = 2.0
    #: fleet identity: the role this server publishes under
    #: in telemetry snapshots and heartbeats — "server" standalone,
    #: "replica" when owned by a ``ReplicaPool`` behind an
    #: ``NMFXRouter`` (the fleet view and ``nmfx-top`` render the two
    #: distinctly; a router health-checks only rows it owns)
    role: str = "server"
    #: explicit telemetry instance name (None = the publisher's
    #: ``<role>-<host>-<pid>`` default; a replica pool names its
    #: members so heartbeats and snapshots join on one identity)
    instance: "str | None" = None
    #: with a port, serve the registry's Prometheus exposition over a
    #: stdlib HTTP endpoint (``nmfx_torch.obs.export.serve_metrics``) for
    #: scraper-based deployments; 0 = ephemeral port (read it from
    #: ``NMFXServer.metrics_port``). None = no endpoint.
    metrics_port: "int | None" = None
    #: mesh tier: the device
    #: mesh this server solves over, as a ``distributed.parse_mesh_spec``
    #: string — "R" (restart-only), "RxF", or "RxFxS". None = the
    #: single-device engine stack (exec-cache, packing — today's
    #: behavior). A spec makes the server a MESH replica: dispatches run
    #: the grid-sharded sweep over ``build_replica_mesh(mesh_spec)``,
    #: the heartbeat advertises the device count, and the router prices
    #: atlas-shaped requests onto it. Participates in comparison like
    #: every field (two servers on different meshes are different
    #: serving policies).
    mesh_spec: "str | None" = None

    def __post_init__(self):
        if self.max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")
        if self.max_pending_bytes < 0:
            raise ValueError("max_pending_bytes must be >= 0")
        if self.max_batch_requests < 1:
            raise ValueError("max_batch_requests must be >= 1")
        if self.max_batch_lanes < 1:
            raise ValueError("max_batch_lanes must be >= 1")
        if self.batch_linger_s < 0:
            raise ValueError("batch_linger_s must be >= 0")
        if (self.default_timeout_s is not None
                and self.default_timeout_s <= 0):
            raise ValueError("default_timeout_s must be positive or None")
        if (self.iter_rate_estimate is not None
                and self.iter_rate_estimate <= 0):
            raise ValueError("iter_rate_estimate must be positive or None")
        if self.harvest_workers < 1:
            raise ValueError("harvest_workers must be >= 1")
        if self.dispatch_retries < 0:
            raise ValueError("dispatch_retries must be >= 0")
        if self.retry_backoff_s < 0:
            raise ValueError("retry_backoff_s must be >= 0")
        if self.watchdog_interval_s <= 0:
            raise ValueError("watchdog_interval_s must be positive")
        if self.telemetry_interval_s <= 0:
            raise ValueError("telemetry_interval_s must be positive")
        if self.metrics_port is not None and not \
                0 <= self.metrics_port <= 65535:
            raise ValueError("metrics_port must be in [0, 65535] or "
                             "None")
        if not self.role:
            raise ValueError("role must be non-empty")
        if self.mesh_spec is not None:
            from nmfx_torch.distributed import parse_mesh_spec

            parse_mesh_spec(self.mesh_spec)  # raises MeshSpecError


def serve_key_fields() -> frozenset:
    """The :class:`ServeConfig` fields that participate in comparison —
    the introspection hook lint rule NMFX001 cross-references (the
    ``DataKey``/``SolverConfig`` discipline). Reading ``field.compare``
    keeps it honest: a field added with ``compare=False`` would be
    invisible to the dataclass hash/eq two policies are compared by,
    and shows up here (and fails lint) as uncovered."""
    return frozenset(f.name for f in dataclasses.fields(ServeConfig)
                     if f.compare)


@dataclasses.dataclass
class RequestStats:
    """Per-request serving spans, readable on the returned future
    (``future.stats``) once the request resolves; partial values are
    visible earlier (queue_wait_s lands at dispatch)."""

    #: the request's server-assigned id (the submission sequence
    #: number) — the SAME id every structured-tracer span of this
    #: request carries in its ``args`` (``request_id``), so a span in
    #: an exported Chrome trace joins back to this stats record
    request_id: "int | None" = None
    #: seconds between submit and dispatch (queue residency)
    queue_wait_s: "float | None" = None
    #: seconds of the dispatch step itself: placement, lane packing,
    #: executable lookup/compile and the async dispatch call
    pack_s: "float | None" = None
    #: seconds the completion worker blocked on the device for this
    #: request's arrays (device solve + device queueing behind
    #: dispatch-mates)
    solve_s: "float | None" = None
    #: seconds of host-side harvest (hclust/cophenetic/cutree + result
    #: assembly)
    harvest_s: "float | None" = None
    #: submit → future-resolved wall
    latency_s: "float | None" = None
    #: how many requests shared this request's dispatch (1 = solo)
    packed_requests: "int | None" = None
    #: this request's lane count (Σ restarts over its ranks)
    lanes: "int | None" = None
    #: the deadline-clamped per-lane iteration budget, when the
    #: scheduler clamped one (None = dispatched at the configured
    #: max_iter); the exactness contract is then against a solo run at
    #: this max_iter
    budget_iters: "int | None" = None
    #: solver quality the request was actually served at: "exact", or
    #: "sketched" when the request ran the compressed engine — by its
    #: own config, or degraded there by quality-elastic scheduling
    #: (then ``degraded_cause`` names why). Mirrors
    #: ``ConsensusResult.quality`` on the resolved future.
    quality: str = "exact"
    #: why quality-elastic scheduling degraded this request
    #: ("deadline" | "overload"), None when it ran as requested
    degraded_cause: "str | None" = None


class _ServeFuture(Future):
    """Future[ConsensusResult] with the request's serving spans."""

    def __init__(self, stats: RequestStats):
        super().__init__()
        self.stats = stats


@dataclasses.dataclass
class _Request:
    seq: int
    a: np.ndarray
    col_names: tuple
    ks: tuple
    restarts: int
    seed: int
    scfg: SolverConfig
    icfg: InitConfig
    label_rule: str
    linkage: str
    grid_slots: int
    grid_tail_slots: object
    priority: int
    deadline: "float | None"  # absolute time.monotonic seconds
    future: _ServeFuture
    stats: RequestStats
    compat: "tuple | None"  # packing-compatibility key; None = solo only
    submitted: float = 0.0
    #: numeric-quarantine survivor floor (ConsensusConfig.min_restarts)
    min_restarts: int = 1
    #: quality-elastic degradation verdict ("deadline" | "overload"),
    #: set at soft admission or at dispatch; whenever it is set,
    #: ``quality`` below is "sketched"
    degrade_cause: "str | None" = None
    #: the quality the request will actually be served at
    quality: str = "exact"
    #: content-addressed result-cache key; None when the
    #: request is ineligible (deadline'd, or caching+coalescing off)
    cache_key: "str | None" = None
    #: the (content fingerprint, shape, src dtype) triple behind
    #: ``cache_key`` — kept so the harvest-time put can re-key a
    #: mid-flight quality degradation without re-hashing the bytes
    cache_fp: "tuple | None" = None
    #: the quality ``cache_key`` was computed under at submit
    cache_quality: str = "exact"

    @property
    def lanes(self) -> int:
        return len(self.ks) * self.restarts

    def order_key(self) -> tuple:
        dl = self.deadline if self.deadline is not None else float("inf")
        return (-self.priority, dl, self.seq)


class Engine(Protocol):
    """What the scheduler needs from the execution stack — the ONE
    interface ``sweep``/``exec_cache``/``data_cache``/``harvest`` unify
    behind (tests drive the scheduler against fakes of this; the
    MPI-FAUN-style multi-device sharding lands behind it as a psum in
    ``dispatch_*`` without touching the queue/packing logic above)."""

    def compatibility_key(self, req: _Request) -> "tuple | None":
        """Hashable key under which requests may share one dispatch's
        lanes; None when the request can only dispatch solo."""
        ...

    def place(self, req: _Request) -> object:
        """Start the request's host→device placement (asynchronous);
        the returned handle feeds ``dispatch_*``. May return None when
        the solo path does its own placement."""
        ...

    def dispatch_solo(self, req: _Request, placed: object,
                      scfg: SolverConfig) -> "Mapping[int, KSweepOutput]":
        """Dispatch one request (async) and return its per-rank device
        outputs. ``scfg`` may be the request's config with a deadline-
        clamped ``max_iter``."""
        ...

    def dispatch_packed(self, reqs: "Sequence[_Request]", placed: object
                        ) -> "list[Mapping[int, KSweepOutput]]":
        """Dispatch one packed executable whose lanes span every request
        (all sharing one compatibility key); returns per-request
        per-rank device outputs, in request order."""
        ...

    # optional: ``device`` (a torch.device). The server sets it as the
    # current device of its scheduler and completion threads when it is
    # a CUDA device, and keys the result cache by its type.
    # optional: ``route(req)``, the request's route through an
    # executable cache, which the result cache's key records
    # (``ExecCache.route``; absent means the plain sweep's).


class ExecCacheEngine:
    """The production :class:`Engine`: requests serve through the
    shape-bucketed executable cache (solo, ``ExecCache.run_sweep``), the
    packed multi-request build function (``sweep._build_packed_serve_fn``) and
    the device input cache; non-cacheable configurations fall back to
    the plain sweep so every algorithm stays servable. Everything runs
    on the cache's device."""

    def __init__(self, exec_cache=None, profiler=None, *, device=None):
        from nmfx_torch.exec_cache import ExecCache
        from nmfx_torch.profiling import NullProfiler

        if exec_cache is None:
            exec_cache = ExecCache(device=device)
        elif device is not None:
            import torch

            dev, own = torch.device(device), exec_cache.device
            if dev.type != own.type or dev.index not in (None, own.index):
                raise ValueError(
                    f"device {device!r} is not the executable cache's "
                    f"({own})")
        self.exec_cache = exec_cache
        self.device = exec_cache.device
        self._prof = profiler if profiler is not None else NullProfiler()

    # -- request shaping ---------------------------------------------------
    @staticmethod
    def _ccfg(req: _Request) -> ConsensusConfig:
        return ConsensusConfig(ks=req.ks, restarts=req.restarts,
                               seed=req.seed, label_rule=req.label_rule,
                               linkage=req.linkage,
                               grid_slots=req.grid_slots,
                               grid_tail_slots=req.grid_tail_slots,
                               min_restarts=req.min_restarts)

    def compatibility_key(self, req: _Request) -> "tuple | None":
        from nmfx_torch.data_cache import default_cache

        if req.icfg.method != "random":
            # NNDSVD lane batches are built outside the executable per
            # true shape — solo only
            return None
        ccfg = self._ccfg(req)
        if not self.exec_cache.cacheable(ccfg, req.scfg, None):
            return None
        bucket = self.exec_cache.bucket_shape(*req.a.shape)
        # the DataKey IS the data half of the compatibility contract:
        # same content fingerprint + placement = the same resident
        # padded device buffer the packed pool reads
        dkey = default_cache().key_for(req.a, req.scfg.dtype,
                                       self.device, pad_shape=bucket)
        tail = req.grid_tail_slots
        if isinstance(tail, list):
            tail = tuple(tail)
        # the largest rank sets the pool's lane width k_max: requests
        # that share it pad each lane exactly as their solo runs do
        return (dkey, bucket, req.scfg, req.icfg, req.label_rule,
                req.grid_slots, tail, max(req.ks))

    def route(self, req: _Request) -> "dict | None":
        return self.exec_cache.route(req.a.shape, self._ccfg(req),
                                     req.scfg)

    def place(self, req: _Request):
        ccfg = self._ccfg(req)
        if not self.exec_cache.cacheable(ccfg, req.scfg, None):
            return None  # the plain sweep path places through the cache
        return self.exec_cache.prefetch(req.a, req.scfg, None,
                                        profiler=self._prof)

    # -- dispatch ----------------------------------------------------------
    def dispatch_solo(self, req: _Request, placed, scfg: SolverConfig):
        ccfg = self._ccfg(req)
        if placed is not None and self.exec_cache.cacheable(ccfg, scfg,
                                                            None):
            return self.exec_cache.run_sweep(placed, ccfg, scfg,
                                             req.icfg, None,
                                             profiler=self._prof)
        from nmfx_torch.sweep import sweep

        return sweep(req.a, ccfg, scfg, req.icfg, device=self.device,
                     profiler=self._prof)

    def dispatch_packed(self, reqs, placed):
        import numpy as _np

        from nmfx_torch import random as _random
        from nmfx_torch.exec_cache import _unpad
        from nmfx_torch.harvest import start_host_fetch
        from nmfx_torch.ops.packed_mu import flip_budget
        from nmfx_torch.sweep import _build_packed_serve_fn

        req0 = reqs[0]
        # one lane group per (request, rank); LPT order (rank
        # descending), deadline/priority/arrival-aware within equal
        # ranks — urgent requests' lanes load into slots first
        groups = sorted(
            ((k, r) for r in reqs for k in r.ks),
            key=lambda g: (-g[0],) + g[1].order_key())
        layout = tuple((k, r.restarts) for k, r in groups)
        tail = req0.grid_tail_slots
        if isinstance(tail, list):
            tail = tuple(tail)
        fn = _build_packed_serve_fn(layout, req0.scfg, req0.label_rule,
                                    req0.grid_slots, tail, placed.bucket,
                                    req0.icfg)
        # canonical chain: fold_in(key(seed), k) per group, split over
        # the restart axis inside the pool's lane draw — identical draws
        # to each request's solo path (the host key chain)
        roots = _np.stack([_random.fold_in(_random.key(r.seed), k)
                           for k, r in groups])
        m_true, n_true = placed.true_shape
        flip = flip_budget(req0.scfg.class_flip_tol, n_true)
        outs = fn(placed.a_pad, roots, m_true, n_true, flip)
        per_req: "dict[int, dict]" = {r.seq: {} for r in reqs}
        with self._prof.phase("xfer.overlap"):
            for (k, r), out in zip(groups, outs):
                out = _unpad(out, m_true, n_true)
                per_req[r.seq][k] = out._replace(
                    fetch=start_host_fetch(out))
        return [per_req[r.seq] for r in reqs]


class MeshEngine:
    """The mesh-tier :class:`Engine` (the reference's ``MeshEngine``):
    every dispatch runs ``sweep()`` over one fixed mesh
    (``ServeConfig.mesh_spec`` → ``distributed.build_replica_mesh``), the
    grid-sharded sweep where the spec has feature or sample axes. Solo
    only: cross-request packing composes restarts into one pool whose
    geometry depends on the batch, which would break the meshed results'
    exactness; the mesh's parallelism comes from sharding the solve.
    ``devices``: the entries the mesh is built over (a pool's carved
    block; a card may be named more than once); None takes this
    process's cards, ``"cpu"`` the CPU named once an entry."""

    def __init__(self, mesh_spec: str, *, devices=None, profiler=None):
        from nmfx_torch.distributed import (build_replica_mesh,
                                            parse_mesh_spec)
        from nmfx_torch.profiling import NullProfiler

        self.mesh_spec = mesh_spec
        self.shape = parse_mesh_spec(mesh_spec)
        if devices == "cpu" or (devices is not None and not isinstance(
                devices, (list, tuple))):
            r, f, s = self.shape
            devices = [devices] * (r * f * s)
        self.mesh = build_replica_mesh(mesh_spec, devices=devices)
        from nmfx_torch.sweep import mesh_home

        self.device = mesh_home(self.mesh)
        self._prof = profiler if profiler is not None else NullProfiler()

    @property
    def n_devices(self) -> int:
        return int(self.mesh.devices.size)

    def compatibility_key(self, req: _Request) -> "tuple | None":
        return None  # solo only (see the class docstring)

    def route(self, req: _Request) -> "dict | None":
        # the result cache keys the mesh: a grid mesh sums in another
        # order, so its entry never answers for a plain sweep's
        return {"mesh_spec": self.mesh_spec}

    def place(self, req: _Request):
        return None  # sweep() places on the mesh

    def dispatch_solo(self, req: _Request, placed, scfg: SolverConfig):
        from nmfx_torch.sweep import sweep

        return sweep(req.a, ExecCacheEngine._ccfg(req), scfg, req.icfg,
                     mesh=self.mesh, profiler=self._prof)

    def dispatch_packed(self, reqs, placed):
        raise RuntimeError(
            "MeshEngine is solo-only (compatibility_key is always "
            "None); a packed dispatch reaching it is a scheduler bug")


@guarded_by("_lock", "_queue", "_queued", "_pending_bytes", "_closed",
            "_paused", "_inflight", "_crash", "_sched_clean", "_down",
            "_heartbeat")
@guarded_by("_tracked_lock", "_tracked", "_coalesce", "_followers")
@guarded_by("_harvest_cond", "_harvest_q", "_harvest_owned")
class NMFXServer:
    """Async multi-tenant consensus-NMF server over one device.

    ``submit(...)`` enqueues a request and returns a
    ``Future[ConsensusResult]`` immediately; a single scheduler thread
    owns the device and continuously packs compatible requests'
    restarts into shared lanes (see the module docstring); completion
    workers harvest each request the moment its copies land, so the
    card never waits on host rank selection.

    ``device``: the card the default engine serves on — None means CUDA
    (raising without one), "cpu" runs the plain versions. It is the
    ``exec_cache``'s device when one is passed; an explicit ``engine``
    owns its own device.

    Lifecycle: workers spawn lazily on the first submit; ``close()``
    (or the context manager) drains in-flight requests and joins the
    threads. One server instance per process/device is the intended
    shape — it owns the exec-cache LRU and the dispatch order.
    """

    def __init__(self, serve_cfg: ServeConfig = ServeConfig(), *,
                 engine: "Engine | None" = None, exec_cache=None,
                 result_cache=None, profiler=None, start: bool = True,
                 device=None):
        from nmfx_torch.profiling import NullProfiler

        if engine is not None and exec_cache is not None:
            raise ValueError("pass either engine or exec_cache, not both")
        if engine is not None and device is not None:
            raise ValueError("pass either engine or device, not both: "
                             "an engine owns its device")
        self.cfg = serve_cfg
        self._prof = profiler if profiler is not None else NullProfiler()
        if engine is not None:
            self.engine: Engine = engine
        elif serve_cfg.mesh_spec is not None:
            if exec_cache is not None:
                raise ValueError(
                    "mesh_spec selects the MeshEngine, which does not "
                    "serve through an executable cache — pass either "
                    "mesh_spec or exec_cache, not both")
            self.engine = MeshEngine(serve_cfg.mesh_spec, devices=device,
                                     profiler=self._prof)
        else:
            self.engine = ExecCacheEngine(exec_cache, profiler=self._prof,
                                          device=device)
        # finished-result cache: an explicit instance wins; else a
        # configured directory builds one; else caching is off
        if result_cache is None and serve_cfg.result_cache_dir is not None:
            from nmfx_torch.result_cache import ResultCache

            result_cache = ResultCache(
                cache_dir=serve_cfg.result_cache_dir, layer="server")
        self.result_cache = result_cache
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: "list[tuple[tuple, _Request]]" = []  # heap
        self._queued = 0
        self._pending_bytes = 0
        self._seq = itertools.count()
        self._closed = False
        self._paused = not start
        self._scheduler: "threading.Thread | None" = None
        self._harvest_q: "list[tuple[_Request, object, float] | None]" = []
        self._harvest_cond = threading.Condition()
        self._harvesters: "list[threading.Thread]" = []
        self._inflight = 0  # dispatched, not yet resolved
        # -- watchdog state (docs/serving.md "Failure model"): every
        # unresolved request is tracked from submit to resolution, so a
        # scheduler crash can never strand a Future — the watchdog
        # resolves whatever the dead scheduler held (ServerCrashed),
        # skipping requests the (still-alive) harvesters own
        # own lock (ordered strictly AFTER self._lock): _untrack runs
        # as a Future done-callback on whatever thread resolved the
        # future — including threads holding self._lock (_expire_locked,
        # close(cancel_pending=True)) — so it must not touch self._lock
        self._tracked_lock = threading.Lock()
        self._tracked: "dict[int, _Request]" = {}
        # in-flight coalescing registry: result-cache key →
        # leader request / attached followers. Guarded by _tracked_lock
        # (NOT self._lock): the leader's fan-out runs as a Future
        # done-callback, which may fire on threads already holding
        # self._lock (the close(cancel_pending=True) path) — same
        # constraint as _untrack; lock order stays _lock → _tracked
        self._coalesce: "dict[str, _Request]" = {}
        self._followers: "dict[str, list[_Request]]" = {}
        self._harvest_owned: "set[int]" = set()  # guarded by _harvest_cond
        self._crash: "BaseException | None" = None  # set by _scheduler_main
        self._sched_clean = False  # scheduler exited via close(), not crash
        self._down: "BaseException | None" = None  # crashed, no restart
        self._watchdog: "threading.Thread | None" = None
        self._heartbeat = 0.0  # scheduler loop progress (introspection)
        # baseline registry cut for stats_snapshot(): the delta since
        # SERVER START, not process start (several servers may share
        # one process across a test run)
        self._metrics_t0 = _metrics.registry().snapshot()
        # the SLO engine always runs (stats_snapshot()["slo"] —
        # evaluation is host-side arithmetic on snapshot deltas); the
        # telemetry publisher and the /metrics HTTP endpoint spin up
        # only when configured
        self._slo = _slo.SLOEngine()
        self._publisher = None
        self._metrics_server = None
        self.metrics_port: "int | None" = None
        try:
            if serve_cfg.metrics_port is not None:
                from nmfx_torch.obs.export import serve_metrics

                self._metrics_server = serve_metrics(
                    serve_cfg.metrics_port)
                self.metrics_port = self._metrics_server.port
            # the publisher starts LAST: it is a daemon that keeps
            # heart-beating into the fleet ledger, so nothing that can
            # still fail may run after it — a half-constructed server
            # must never read as a live replica to a router/autoscaler
            if serve_cfg.telemetry_dir is not None:
                from nmfx_torch.obs.export import TelemetryPublisher

                # status_fn: this SERVER's queue/inflight levels ride
                # the snapshot payload itself, so N in-process replicas
                # sharing one registry still publish honest per-
                # instance load rows (the process-wide gauges can only
                # carry the last writer's level)
                self._publisher = TelemetryPublisher(
                    serve_cfg.telemetry_dir, role=serve_cfg.role,
                    instance=serve_cfg.instance,
                    interval_s=serve_cfg.telemetry_interval_s,
                    status_fn=self._telemetry_status).start()
        except BaseException:
            # a failed __init__ (e.g. metrics_port already bound)
            # never runs close(): tear down whatever started, then
            # re-raise the construction failure
            if self._metrics_server is not None:
                self._metrics_server.shutdown()
                self._metrics_server.server_close()
            raise
        self.counters = {"submitted": 0, "completed": 0, "failed": 0,
                         "cancelled": 0, "deadline_expired": 0,
                         "rejected": 0, "dispatches": 0,
                         "packed_dispatches": 0, "packed_requests": 0,
                         "total_lanes": 0, "packed_lanes": 0,
                         "budget_clamped": 0, "spilled": 0,
                         "readmitted": 0, "quality_degraded": 0,
                         "result_cache_hits": 0, "coalesced": 0}

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self) -> "NMFXServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def pause(self) -> None:
        """Hold dispatch (requests keep queueing) — deterministic batch
        construction for tests and maintenance windows."""
        with self._cond:
            self._paused = True

    def resume(self) -> None:
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    def close(self, cancel_pending: bool = False) -> None:
        """Stop accepting requests; drain the queue and in-flight work,
        then join the worker threads. ``cancel_pending=True`` instead
        fails queued (not yet dispatched) requests with
        :class:`ServerClosed` — routed through the spill path first
        when ``ServeConfig.spill_dir`` is set, so an operator shutdown
        (or a supervisor's SIGTERM handler calling close) loses no
        queued work: a restarted server re-admits the spilled requests
        via :meth:`readmit`."""
        cancelled: "list[_Request]" = []
        with self._cond:
            if not self._closed:
                self._closed = True
                if cancel_pending:
                    cancelled = [req for _, req in self._queue]
                    self._queue.clear()
                    self._queued = 0
                    self._pending_bytes = 0
                    self._sync_gauges()
                self._paused = False  # a paused close must still drain
                self._cond.notify_all()
            scheduler = self._scheduler
        # spill + resolve OUTSIDE the lock: serializing up to the
        # admission bound's worth of matrices under _cond would stall
        # the watchdog and completion bookkeeping for the whole write;
        # nothing reads _queue after _closed flipped under the lock
        for req in cancelled:
            if not req.future.set_running_or_notify_cancel():
                continue  # caller already cancelled it: never spill —
                # readmit() must not resurrect cancelled work
            path = self._spill(req)
            err = ServerClosed(
                "server closed before dispatch"
                + (f"; request spilled to {path} — a restarted server "
                   "re-admits it via NMFXServer.readmit()"
                   if path else ""))
            # machine-readable spill join: a router draining
            # this replica reads the path off the typed error and
            # claims the record for re-admission on a survivor
            err.spill_path = path
            req.future.set_exception(err)
            with self._lock:
                self.counters["failed"] += 1
        if scheduler is not None:
            scheduler.join()
        with self._cond:
            self._cond.notify_all()  # wake the watchdog promptly
        # the watchdog exits once it has observed the closed+dead (or
        # closed+crashed — it still resolves the crash's strays first)
        # scheduler; join AFTER the scheduler so a crash racing close()
        # is fully handled before the harvest drain below
        watchdog = self._watchdog
        if watchdog is not None:
            watchdog.join()
        with self._harvest_cond:
            for _ in self._harvesters:
                self._harvest_q.append(None)
            self._harvest_cond.notify_all()
        for t in self._harvesters:
            t.join()
        # fleet-telemetry teardown AFTER the drain: the publisher's
        # final snapshot carries the fully-drained counters, then this
        # instance goes stale in the fleet view (counters retained,
        # gauges dropped in the fleet view)
        if self._publisher is not None:
            self._publisher.close()
        if self._metrics_server is not None:
            self._metrics_server.shutdown()
            self._metrics_server.server_close()

    # -- spill-on-shutdown / re-admission ----------------------------------
    def _spill(self, req: _Request) -> "str | None":
        """Persist one queued request's submission payload under
        ``ServeConfig.spill_dir`` (atomic tmp+rename via the checkpoint
        ledger's writer, which also passes the ``ckpt.write`` chaos
        site). Best-effort: a write failure degrades warn-once to the
        plain discard (the pre-spill behavior), never blocks close()."""
        if self.cfg.spill_dir is None:
            return None
        import os

        from nmfx_torch.faults import warn_once

        # identity for the cross-process timeline: the
        # spilling server's request id rides in the payload, the
        # readmitting server books a serve.readmit join against it,
        # and merge_traces aligns both processes' traces — a
        # spilled-and-readmitted request reads as ONE timeline
        meta = spill_meta(
            request_id=req.seq, ks=req.ks, restarts=req.restarts,
            seed=req.seed, scfg=req.scfg, icfg=req.icfg,
            label_rule=req.label_rule, linkage=req.linkage,
            grid_slots=req.grid_slots,
            grid_tail_slots=req.grid_tail_slots,
            min_restarts=req.min_restarts, priority=req.priority,
            col_names=req.col_names)
        try:
            path = write_spill_record(
                os.path.join(
                    self.cfg.spill_dir,
                    f"{SPILL_PREFIX}{os.getpid()}_"
                    f"{next(_spill_seq)}.npz"),
                req.a, meta)
        except Exception as e:
            warn_once(
                "serve-spill-failed",
                f"failed to spill queued request #{req.seq} to "
                f"{self.cfg.spill_dir!r} ({e!r}); the request is "
                "discarded like a spill-less shutdown")
            return None
        with self._lock:
            self.counters["spilled"] += 1
        _flight.record("serve.spill", request_id=req.seq, path=path)
        _trace.default_tracer().instant(
            "serve.spill", cat="serve",
            args={"request_id": req.seq})
        return path

    def readmit(self, spill_dir: "str | None" = None, *,
                claimant: "str | None" = None,
                break_claims_after_s: "float | None" = None) -> list:
        """Re-admit every request a previous server spilled on shutdown
        (``spill_dir`` defaults to this server's
        ``ServeConfig.spill_dir``): each spill record is CLAIMED
        (:func:`claim_spill` — O_EXCL exclusive, so two
        routers/survivors draining one directory partition the records
        instead of both readmitting them; tests/test_multiprocess.py
        races it), resubmitted through the normal :meth:`submit` path —
        bit-identical results to the original submission by the serving
        exactness contract — and removed (record then claim) once
        admitted. Records another consumer holds are skipped; pass
        ``break_claims_after_s`` to break claims whose owner provably
        died between claiming and readmitting (the claim's age is the
        evidence). Torn/corrupt spill records are skipped warn-once
        (the ledger's torn-record tolerance); an admission rejection
        (``QueueFull``) stops the loop warn-once, RELEASING that
        record's claim so it stays re-admittable by anyone. Returns the
        futures of everything admitted."""
        import os

        from nmfx_torch.faults import warn_once

        d = spill_dir if spill_dir is not None else self.cfg.spill_dir
        if d is None:
            raise ValueError("no spill directory: pass spill_dir= or "
                             "set ServeConfig.spill_dir")
        who = claimant if claimant is not None \
            else f"readmit-{os.getpid()}"
        futures = []
        for path in list_spills(d):
            if spill_claimant(path) is not None:
                if break_claims_after_s is None or not break_spill_claim(
                        path, older_than_s=break_claims_after_s):
                    continue  # another consumer owns it
            if not claim_spill(path, who):
                continue  # lost the claim race — the winner readmits
            try:
                a, meta = load_spill_record(path)
                kwargs = spill_submit_kwargs(meta)
                data = spill_dataset(a, meta)
            except Exception as e:
                release_spill_claim(path)
                warn_once(
                    "serve-spill-corrupt",
                    f"spilled request record {path!r} is torn/corrupt "
                    f"({e!r}); skipping it — re-submit the request "
                    "manually if it still matters")
                continue
            try:
                fut = self.submit(data, **kwargs)
            except QueueFull as e:
                release_spill_claim(path)
                warn_once(
                    "serve-readmit-queue-full",
                    f"re-admission stopped at {path!r}: {e}; this and "
                    "the remaining spill records stay on disk — call "
                    "readmit() again once the queue drains")
                break
            with self._lock:
                self.counters["readmitted"] += 1
            # the cross-process join: the readmitted
            # request's NEW id booked against the spilling server's
            # original — merge_traces lines the two processes up
            origin = meta.get("request_id")
            _flight.record("serve.readmit",
                           request_id=fut.stats.request_id,
                           origin_request_id=origin,
                           origin_pid=meta.get("spill_pid"))
            _trace.default_tracer().instant(
                "serve.readmit", cat="serve",
                args={"request_id": fut.stats.request_id,
                      "origin_request_id": origin})
            futures.append(fut)
            # record first, claim second: a crash between the two
            # leaves an ORPHAN claim (record already admitted), which
            # the sweep below — and every later consumer — cleans up;
            # the reverse order would briefly leave the record
            # unclaimed and double-admittable
            try:
                os.unlink(path)
            except OSError as e:
                warn_once("serve-spill-unlink",
                          f"could not remove re-admitted spill record "
                          f"{path!r} ({e}); remove it manually or the "
                          "next readmit will submit it again")
            release_spill_claim(path)
        # orphan-claim sweep: a claim whose record is gone marks a
        # fully-admitted request whose consumer died before releasing
        if os.path.isdir(d):
            for name in os.listdir(d):
                if not name.endswith(_CLAIM_SUFFIX):
                    continue
                rec = os.path.join(d, name[:-len(_CLAIM_SUFFIX)])
                if not os.path.exists(rec):
                    release_spill_claim(rec)
        return futures

    # -- submission --------------------------------------------------------
    def submit(self, data, ks: Sequence[int] = (2, 3, 4, 5),
               restarts: int = 10, *, seed: int = 123,
               solver_cfg: "SolverConfig | None" = None,
               init_cfg: "InitConfig | None" = None,
               label_rule: str = "argmax", linkage: str = "average",
               grid_slots: int = 48, grid_tail_slots="auto",
               min_restarts: int = 1,
               priority: int = 0, deadline: "float | None" = None,
               timeout: "float | None" = None) -> _ServeFuture:
        """Enqueue one consensus request; returns a
        ``Future[ConsensusResult]`` immediately.

        Arguments mirror ``nmfconsensus`` (the result is bit-identical
        to calling it with the same arguments — the exactness
        contract), plus the serving controls: ``priority`` (higher
        dispatches first), ``timeout`` (seconds from now) or
        ``deadline`` (absolute ``time.monotonic()`` seconds) — expiry
        while queued resolves the future to :class:`DeadlineExceeded`
        without dispatching. ``future.cancel()`` works until dispatch;
        ``future.stats`` carries the per-request serving spans.
        ``min_restarts`` is the numeric-quarantine survivor floor
        (``ConsensusConfig.min_restarts``): a rank with fewer surviving
        restarts resolves the future to a typed
        ``nmfx_torch.faults.InsufficientRestarts``. A setting the port
        has no route for (``check_ported``: bf16 operands off the kernels, ...)
        raises ``NotImplementedError`` here, before admission.
        """
        from nmfx_torch.api import _as_matrix

        arr, col_names = _as_matrix(data)
        arr = np.asarray(arr)
        if not np.isfinite(arr).all():
            raise ValueError("input matrix contains non-finite values")
        if (arr < 0).any():
            raise ValueError("input matrix must be non-negative")
        ks = tuple(dict.fromkeys(int(k) for k in ks))
        if not ks:
            raise ValueError("ks must be non-empty")
        if min(ks) < 2:
            raise ValueError("all k must be >= 2")
        if max(ks) > arr.shape[1]:
            raise ValueError(f"k={max(ks)} exceeds the number of samples "
                             f"({arr.shape[1]})")
        if restarts < 1:
            raise ValueError("restarts must be >= 1")
        if not 1 <= min_restarts <= restarts:
            raise ValueError(
                f"min_restarts must be in [1, restarts={restarts}], "
                f"got {min_restarts}")
        if deadline is not None and timeout is not None:
            raise ValueError("pass either deadline or timeout, not both")
        if timeout is None and deadline is None \
                and self.cfg.default_timeout_s is not None:
            timeout = self.cfg.default_timeout_s
        if timeout is not None:
            deadline = time.monotonic() + timeout
        scfg = solver_cfg if solver_cfg is not None else SolverConfig()
        icfg = init_cfg if init_cfg is not None else InitConfig()
        check_ported(scfg)
        seq = next(self._seq)
        stats = RequestStats(request_id=seq, lanes=len(ks) * restarts)
        req = _Request(seq=seq, a=arr,
                       col_names=tuple(col_names), ks=ks,
                       restarts=restarts, seed=seed, scfg=scfg,
                       icfg=icfg, label_rule=label_rule, linkage=linkage,
                       grid_slots=grid_slots,
                       grid_tail_slots=grid_tail_slots,
                       priority=priority, deadline=deadline,
                       future=_ServeFuture(stats), stats=stats,
                       compat=None, submitted=time.monotonic(),
                       min_restarts=min_restarts)
        if scfg.backend == "sketched":
            # the caller asked for the compressed engine: the result is
            # sketched-quality by request, tagged but not a degradation
            req.quality = "sketched"
            stats.quality = "sketched"
        degradable = self._sketch_eligible(scfg)
        # request economics: key the request content-
        # addressed and try the finished-result cache BEFORE admission
        # — a warm hit resolves without queueing, dispatching, or
        # touching the device (the zero-dispatch/zero-h2d contract,
        # counter-gated). Deadline'd requests are ineligible (a cached
        # or coalesced outcome has its own timing semantics).
        if deadline is None and (self.result_cache is not None
                                 or self.cfg.coalesce_requests):
            arr_c = np.ascontiguousarray(arr)
            fp = hashlib.sha256(
                arr_c.view(np.uint8).reshape(-1)).hexdigest()
            req.cache_fp = (fp, tuple(arr.shape), arr_c.dtype.str)
            req.cache_quality = req.quality
            req.cache_key = self._result_key(req, req.quality)
            if self.result_cache is not None:
                cached = self.result_cache.lookup(req.cache_key)
                if cached is not None:
                    req.stats.latency_s = time.monotonic() - req.submitted
                    req.stats.quality = cached.quality
                    with self._lock:
                        self.counters["submitted"] += 1
                        self.counters["completed"] += 1
                        self.counters["result_cache_hits"] += 1
                    req.future.set_result(cached)
                    _e2e_hist.observe(req.stats.latency_s,
                                      outcome="completed")
                    return req.future
        # admission pre-check BEFORE the O(bytes) fingerprint: under
        # overload QueueFull is the hot path, and rejecting must stay
        # cheap; the authoritative (race-free) check re-runs at enqueue
        with self._cond:
            self._admit_locked(arr.nbytes, degradable=degradable)
        # the compatibility fingerprint (one sha256 pass over the host
        # bytes) is computed HERE on the caller's thread, keeping the
        # scheduler thread's pop-to-dispatch path hash-free
        req.compat = self.engine.compatibility_key(req)
        with self._cond:
            coalescing = (req.cache_key is not None
                          and self.cfg.coalesce_requests
                          and not self._closed and self._down is None)
            if coalescing:
                with self._tracked_lock:
                    leader = self._coalesce.get(req.cache_key)
                    attach = (leader is not None
                              and not leader.future.done())
                    if attach:
                        self._followers.setdefault(
                            req.cache_key, []).append(req)
                if attach:
                    # follower: no admission, no queue slot, no
                    # dispatch — the leader's outcome fans out
                    self.counters["submitted"] += 1
                    self.counters["coalesced"] += 1
                    with self._tracked_lock:
                        self._tracked[req.seq] = req
                    req.future.add_done_callback(
                        lambda _f, seq=req.seq: self._untrack(seq))
                    _coalesced_total.inc(layer="server")
                    _flight.record("serve.coalesce", request_id=req.seq,
                                   leader=leader.seq,
                                   key=req.cache_key[:12])
                    return req.future
            cause = self._admit_locked(arr.nbytes, degradable=degradable)
            if coalescing:
                # admitted: register as the key's leader — strictly
                # AFTER admission, so a QueueFull raise can never
                # strand a registry entry followers would attach to.
                # Submissions serialize on self._cond, so no identical
                # submit can interleave between the attach-check above
                # and this registration; the fan-out callback only
                # REMOVES entries it still owns, so a stale leader can
                # never orphan this one's followers.
                with self._tracked_lock:
                    self._coalesce[req.cache_key] = req
                req.future.add_done_callback(
                    lambda _f, key=req.cache_key, lead=req:
                        self._coalesce_fanout(key, lead))
            if cause is not None:
                # quality-elastic soft admission: the request admission
                # control would have shed is served degraded instead —
                # solo (a degraded request must not share lanes with
                # exact mates), tagged at dispatch
                req.degrade_cause = cause
                req.quality = "sketched"
                req.compat = None
            heapq.heappush(self._queue, (req.order_key(), req))
            self._queued += 1
            self._pending_bytes += arr.nbytes
            self._sync_gauges()
            self.counters["submitted"] += 1
            # watchdog registry: tracked until the future resolves, so
            # a scheduler crash can enumerate (and fail, typed) every
            # request it would otherwise strand
            with self._tracked_lock:
                self._tracked[req.seq] = req
            req.future.add_done_callback(
                lambda _f, seq=req.seq: self._untrack(seq))
            self._ensure_workers()
            self._cond.notify_all()
        return req.future

    def _untrack(self, seq: int) -> None:
        with self._tracked_lock:
            self._tracked.pop(seq, None)

    def _result_key(self, req: _Request, quality: str) -> str:
        """The request's content-addressed result key —
        ``result_cache.result_key`` over the precomputed content
        fingerprint and the request's full consensus/solver/init
        configuration, at ``quality``, for the engine's device type and
        the request's route through its executable cache."""
        from nmfx_torch.result_cache import result_key

        fp, shape, src_dtype = req.cache_fp
        ccfg = ConsensusConfig(ks=req.ks, restarts=req.restarts,
                               seed=req.seed, label_rule=req.label_rule,
                               linkage=req.linkage,
                               grid_slots=req.grid_slots,
                               grid_tail_slots=req.grid_tail_slots,
                               min_restarts=req.min_restarts)
        route = getattr(self.engine, "route", None)
        return result_key(fp, shape, src_dtype, req.scfg, ccfg,
                          req.icfg, quality,
                          device=getattr(self.engine, "device", None),
                          route=route(req) if route is not None else None)

    def _coalesce_fanout(self, key: str, leader: _Request) -> None:
        """Leader done-callback: release the in-flight registry entry
        and share the leader's outcome with every attached follower.

        Runs on whatever thread resolved the leader's future —
        including threads holding ``self._lock`` (the
        ``close(cancel_pending=True)`` path) — so it takes ONLY
        ``_tracked_lock`` (the ``_untrack`` constraint). It pops the
        follower list only while it still owns the registry entry: if
        a new leader already replaced this one (an identical submit
        raced the resolution), the followers are inherited by the new
        leader — identical key, identical eventual outcome."""
        with self._tracked_lock:
            if self._coalesce.get(key) is not leader:
                return  # superseded: followers ride the new leader
            del self._coalesce[key]
            followers = self._followers.pop(key, [])
        if not followers:
            return
        fut = leader.future
        if fut.cancelled():
            self._coalesce_promote(key, followers)
            return
        err = fut.exception()
        result = None if err is not None else fut.result()
        now = time.monotonic()
        resolved = 0
        for f in followers:
            if f.future.done():
                continue  # e.g. the watchdog already failed it, typed
            f.stats.latency_s = now - f.submitted
            try:
                if err is not None:
                    f.future.set_exception(err)
                    _e2e_hist.observe(f.stats.latency_s,
                                      outcome="failed")
                else:
                    f.stats.quality = result.quality
                    f.future.set_result(result)
                    _e2e_hist.observe(f.stats.latency_s,
                                      outcome="completed")
                resolved += 1
            except Exception:  # nmfx: ignore[NMFX006] -- lost a
                # resolution race: the follower's Future is already
                # resolved (cancel/close), nothing is swallowed
                continue
        if resolved:
            # safe to take self._lock here: leaders are deadline-free,
            # so nothing resolves one under _cond (_expire_locked) —
            # every leader-resolution site (harvester, watchdog, the
            # close(cancel_pending=True) drain, a caller's cancel())
            # runs lock-free
            with self._lock:
                self.counters["failed" if err is not None
                              else "completed"] += resolved
        _flight.record("serve.coalesce_fanout", leader=leader.seq,
                       key=key[:12], followers=resolved,
                       outcome="error" if err is not None else "result")

    def _coalesce_promote(self, key: str,
                          followers: "list[_Request]") -> None:
        """The leader was cancelled before dispatch: promote the first
        still-live follower into the queue as the new leader and
        re-attach the rest — followers never inherit a cancellation
        they didn't ask for. Only ever reached from a caller-thread
        ``future.cancel()`` (cancellation finalizes on the cancelling
        thread), so taking the scheduler condition here is safe."""
        live = [f for f in followers if not f.future.done()]
        if not live:
            return
        head, rest = live[0], live[1:]
        err = None
        with self._cond:
            if self._closed or self._down is not None:
                err = ServerClosed(
                    "server closed while promoting coalesced followers "
                    "of a cancelled leader")
            else:
                with self._tracked_lock:
                    self._coalesce[key] = head
                    if rest:
                        self._followers.setdefault(key, []).extend(rest)
                head.future.add_done_callback(
                    lambda _f, k=key, lead=head:
                        self._coalesce_fanout(k, lead))
                heapq.heappush(self._queue, (head.order_key(), head))
                self._queued += 1
                self._pending_bytes += head.a.nbytes
                self._sync_gauges()
                self._ensure_workers()
                self._cond.notify_all()
        if err is not None:
            for f in live:
                if not f.future.done():
                    try:
                        f.future.set_exception(err)
                    except Exception:  # nmfx: ignore[NMFX006] -- lost
                        # a resolution race: the Future resolved
                        # concurrently (cancel/close), nothing swallowed
                        continue
            return
        _flight.record("serve.coalesce_promote", request_id=head.seq,
                       key=key[:12], followers=len(rest))

    def _telemetry_status(self) -> dict:
        """Per-INSTANCE load levels for the telemetry snapshot payload
        (``nmfx_torch.obs.export.build_snapshot``'s ``status``): a router's
        health checker and ``nmfx-top`` read these instead of the
        process-wide gauges, which N in-process replicas would
        overwrite each other on."""
        with self._lock:
            return {"queue_depth": self._queued,
                    "inflight": self._inflight}

    def _sync_gauges(self) -> None:
        """Export the queue/inflight LEVELS to the registry gauges the
        fleet view reads (nmfx_serve_queue_depth / nmfx_serve_inflight)
        — called wherever either level changes. The registry lock is a
        leaf, so this is safe under self._lock/self._cond."""
        _queue_depth_gauge.set(self._queued)
        _inflight_gauge.set(self._inflight)

    @staticmethod
    def _sketch_eligible(scfg: SolverConfig) -> bool:
        """Whether quality-elastic scheduling can degrade a request with
        this config to the sketched engine: the algorithm needs a
        compressed form, a screening config already owns its sketched
        pass, and a request that asked for sketched has nothing to
        degrade to."""
        return (scfg.algorithm in SKETCHED_ALGORITHMS
                and not scfg.screen and scfg.backend != "sketched")

    def _admit_locked(self, nbytes: int,
                      degradable: bool = False) -> "str | None":
        """Admission control (caller holds the lock): typed rejection
        when the queue is over its depth or pending-byte bound. Under
        ``ServeConfig.quality_elastic``, a depth overrun on a
        ``degradable`` request soft-admits instead (returns "overload",
        the degradation cause) while the depth stays under twice the
        bound; the pending-bytes bound stays hard (it protects host
        memory, not latency)."""
        if self._closed:
            raise ServerClosed("server is closed")
        if self._down is not None:
            raise ServerCrashed(
                "the scheduler crashed and ServeConfig.restart_scheduler "
                "is False — the server is down") from self._down
        cause = None
        if self._queued >= self.cfg.max_queue_depth:
            if (self.cfg.quality_elastic and degradable
                    and self._queued < 2 * self.cfg.max_queue_depth):
                cause = "overload"
            else:
                self.counters["rejected"] += 1
                raise QueueFull(
                    f"queue depth {self._queued} at the configured bound "
                    f"({self.cfg.max_queue_depth})")
        if self._pending_bytes + nbytes > self.cfg.max_pending_bytes:
            self.counters["rejected"] += 1
            raise QueueFull(
                f"pending input bytes would exceed the "
                f"{self.cfg.max_pending_bytes}-byte admission bound")
        return cause

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            c = dict(self.counters)
            c.update(queued=self._queued, inflight=self._inflight,
                     pending_bytes=self._pending_bytes,
                     packing_efficiency=(
                         c["packed_lanes"] / c["total_lanes"]
                         if c["total_lanes"] else None))
            return c

    def stats_snapshot(self) -> dict:
        """The process-wide metrics registry's DELTA since this server
        was constructed (``nmfx_torch.obs.metrics.MetricsRegistry.delta``):
        counters and histogram counts/sums are windowed to this
        server's lifetime, gauges report their current level — the
        structured successor to :meth:`stats` (docs/serving.md
        "Observability"). Plain data; each metric's ``series`` dict is
        keyed by label-value TUPLES (``()`` for unlabeled series), so
        stringify the keys before ``json.dumps`` — for wire formats
        use :meth:`metrics_text` instead.

        The ``"perf"`` key carries the per-dispatch roofline
        attribution summary (``nmfx_torch.obs.costmodel.perf_summary`` —
        model FLOPs/bytes, achieved FLOP/s, MFU, arithmetic intensity
        and the compute-vs-bandwidth verdict per dispatch kind;
        docs/observability.md "Performance attribution").

        The ``"slo"`` key carries the server's SLO engine status
        (``nmfx_torch.obs.slo`` — per-objective multi-window burn rates and
        alert states, evaluated over the process registry right now;
        alert TRANSITIONS also land in the flight recorder)."""
        snap = _metrics.registry().delta(self._metrics_t0)
        snap["perf"] = _costmodel.perf_summary()
        snap["slo"] = self._slo.evaluate()
        return snap

    def metrics_text(self) -> str:
        """Prometheus text exposition of the process-wide registry —
        the ``/metrics`` payload an operator's scraper ingests (serve
        latency histograms, dispatch/lane counters, cache and compile
        counters; docs/observability.md "Metric naming"). Process-wide
        and cumulative by Prometheus convention; for this server's
        window use :meth:`stats_snapshot`."""
        return _metrics.registry().prometheus_text()

    # -- scheduler ---------------------------------------------------------
    def _ensure_workers(self) -> None:
        # caller holds the lock
        if self._scheduler is None:
            self._sched_clean = False
            self._scheduler = threading.Thread(
                target=self._scheduler_main, daemon=True,
                name="nmfx-serve-sched")
            self._scheduler.start()
        if self._watchdog is None:
            self._watchdog = threading.Thread(
                target=self._run_watchdog, daemon=True,
                name="nmfx-serve-watchdog")
            self._watchdog.start()
        while len(self._harvesters) < self.cfg.harvest_workers:
            t = threading.Thread(target=self._run_harvester, daemon=True,
                                 name="nmfx-serve-harvest")
            t.start()
            self._harvesters.append(t)

    def _expire_locked(self, now: float) -> None:
        """Resolve queued requests whose deadline passed — typed
        DeadlineExceeded, never dispatched. Caller holds the lock."""
        keep = []
        for entry in self._queue:
            req = entry[1]
            if req.future.cancelled():
                self._drop_locked(req, "cancelled")
            elif req.deadline is not None and now >= req.deadline:
                self._drop_locked(req, "deadline")
                if req.future.set_running_or_notify_cancel():
                    req.stats.queue_wait_s = now - req.submitted
                    req.stats.latency_s = now - req.submitted
                    _e2e_hist.observe(req.stats.latency_s,
                                      outcome="deadline")
                    req.future.set_exception(DeadlineExceeded(
                        "deadline expired after "
                        f"{now - req.submitted:.3f}s in queue; the "
                        "request was never dispatched"))
            else:
                keep.append(entry)
        if len(keep) != len(self._queue):
            self._queue[:] = keep
            heapq.heapify(self._queue)

    def _drop_locked(self, req: _Request, why: str) -> None:
        self._queued -= 1
        self._pending_bytes -= req.a.nbytes
        self._sync_gauges()
        self.counters["cancelled" if why == "cancelled"
                      else "deadline_expired"] += 1

    def _next_deadline_locked(self) -> "float | None":
        dls = [r.deadline for _, r in self._queue
               if r.deadline is not None]
        return min(dls) if dls else None

    def _pop_locked(self) -> "_Request | None":
        while self._queue:
            _, req = heapq.heappop(self._queue)
            if req.future.cancelled():
                self._drop_locked(req, "cancelled")
                continue
            self._queued -= 1
            self._pending_bytes -= req.a.nbytes
            self._sync_gauges()
            return req
        return None

    def _take_compatible_locked(self, head: _Request, lanes: int,
                                taken: int) -> "list[_Request]":
        """Pull queued requests sharing ``head``'s compatibility key, in
        priority order, within the batch bounds. Caller holds the
        lock."""
        mates: "list[_Request]" = []
        keep = []
        for entry in sorted(self._queue):
            req = entry[1]
            if (taken + len(mates) < self.cfg.max_batch_requests
                    and req.compat == head.compat
                    and not req.future.cancelled()
                    and (req.deadline is None
                         or time.monotonic() < req.deadline)
                    # a request whose deadline clamps its iteration
                    # budget must dispatch SOLO (the contract above):
                    # packed lanes run at the shared max_iter, and a
                    # mate expiring mid-solve would have its computed
                    # results discarded — left queued, it pops as head
                    # and dispatches clamped
                    and not self._budget_clamps(req)
                    and lanes + req.lanes <= self.cfg.max_batch_lanes):
                mates.append(req)
                lanes += req.lanes
                self._queued -= 1
                self._pending_bytes -= req.a.nbytes
            else:
                keep.append(entry)
        if mates:
            self._queue[:] = keep
            heapq.heapify(self._queue)
            self._sync_gauges()
        return mates

    def _scheduler_main(self) -> None:
        """Scheduler thread body: the loop, plus the crash fence. An
        exception escaping ``_run_scheduler`` would kill the one thread
        that owns the device and leave every queued Future hanging; it
        is recorded instead and the watchdog resolves every stranded
        Future with a typed :class:`ServerCrashed` — never a hang."""
        try:
            self._bind_device()
            self._run_scheduler()
            with self._cond:
                self._sched_clean = True
        except BaseException as e:  # nmfx: ignore[NMFX006] -- the
            # watchdog resolves strays
            with self._cond:
                self._crash = e
                self._cond.notify_all()

    def _bind_device(self) -> None:
        """Make the engine's card the current CUDA device of this thread
        (the current device is per thread): the scheduler's launches and
        the harvesters' events then land on A's device and its default
        stream."""
        dev = getattr(self.engine, "device", None)
        if dev is not None and getattr(dev, "type", None) == "cuda":
            import torch

            torch.cuda.set_device(dev)

    def _run_scheduler(self) -> None:
        from nmfx_torch import faults

        while True:
            with self._cond:
                self._heartbeat = time.monotonic()
                while True:
                    now = time.monotonic()
                    self._expire_locked(now)
                    if self._queue and not self._paused:
                        break
                    if self._closed:
                        return
                    dl = self._next_deadline_locked()
                    self._cond.wait(timeout=None if dl is None
                                    else max(dl - now, 0.0))
                head = self._pop_locked()
                if head is None:
                    continue
                # chaos site: scheduler death with a request IN FLIGHT
                # (popped from the queue, dispatch not yet started) —
                # the worst-placed crash: the request is in no queue, so
                # only the watchdog's tracked-request registry can still
                # resolve its Future (tests/test_faults.py pins that it
                # does)
                faults.inject("serve.scheduler")
                batch = [head]
                packable = (self.cfg.pack and head.compat is not None
                            and not self._budget_clamps(head))
                if packable:
                    batch += self._take_compatible_locked(
                        head, head.lanes, 1)
            if (packable and len(batch) < self.cfg.max_batch_requests
                    and self.cfg.batch_linger_s > 0):
                batch = self._linger(head, batch)
            if head.deadline is not None \
                    and time.monotonic() >= head.deadline:
                # expired between queue and dispatch: resolve typed,
                # return its mates to the queue unharmed
                self._resolve_expired(head)
                with self._cond:
                    for req in batch[1:]:
                        heapq.heappush(self._queue,
                                       (req.order_key(), req))
                        self._queued += 1
                        self._pending_bytes += req.a.nbytes
                    self._sync_gauges()
                continue
            self._dispatch(batch)

    # -- watchdog ----------------------------------------------------------
    def _run_watchdog(self) -> None:
        """Heartbeat-checked scheduler monitor (docs/serving.md
        "Failure model"): polls every ``ServeConfig.watchdog_interval_s``
        for a recorded scheduler crash (``_scheduler_main``'s fence) or
        a scheduler thread that died WITHOUT recording one (an exotic
        interpreter-level death — the heartbeat's last reading is then
        the only evidence). On crash: every tracked, unresolved request
        the harvesters don't own resolves to a typed
        :class:`ServerCrashed` chaining the scheduler's exception —
        never a hang — and, with ``ServeConfig.restart_scheduler``, a
        fresh scheduler thread takes over NEW submissions (work pending
        at crash time is failed loudly, never replayed: at-most-once
        dispatch)."""
        from nmfx_torch.faults import warn_once

        while True:
            with self._cond:
                cause = self._crash
                sched = self._scheduler
                if cause is None and sched is not None \
                        and not sched.is_alive() and not self._sched_clean:
                    cause = RuntimeError(
                        "scheduler thread died without recording an "
                        "exception (last heartbeat "
                        f"{time.monotonic() - self._heartbeat:.1f}s ago)")
                if cause is None:
                    if self._closed and (
                            sched is None or not sched.is_alive()):
                        return
                    self._cond.wait(
                        timeout=self.cfg.watchdog_interval_s)
                    continue
                # crash: collect the strays atomically with the queue
                # reset, so a submit racing the restart lands on the
                # fresh queue and is never failed spuriously
                self._crash = None
                self._scheduler = None
                self._queue.clear()
                self._queued = 0
                self._pending_bytes = 0
                self._sync_gauges()
                restart = self.cfg.restart_scheduler and not self._closed
                if not restart:
                    self._down = cause
                with self._tracked_lock:  # lock order: _lock → _tracked
                    strays = list(self._tracked.values())
            with self._harvest_cond:
                owned = set(self._harvest_owned)
            failed = 0
            for req in strays:
                if req.seq in owned:
                    continue  # a live harvester will resolve it
                fut = req.future
                if fut.done():
                    continue
                fut.set_running_or_notify_cancel()
                if fut.done():
                    continue
                req.stats.latency_s = time.monotonic() - req.submitted
                err = ServerCrashed(
                    "the scheduler thread died while this request was "
                    "pending; it was never (or only partially) "
                    "dispatched and is failed rather than replayed "
                    "(at-most-once dispatch)")
                err.__cause__ = cause
                fut.set_exception(err)
                failed += 1
                _flight.record("serve.watchdog",
                               action="resolve_stranded",
                               request_id=req.seq)
            with self._lock:
                self.counters["failed"] += failed
            warn_once(
                "scheduler-crash",
                f"serve scheduler crashed ({cause!r}); {failed} pending "
                "request(s) resolved with ServerCrashed"
                + (", scheduler restarted" if restart
                   else ", server is down (restart_scheduler=False)"))
            _flight.record("serve.watchdog", action="scheduler_crash",
                           error=cause, resolved=failed,
                           restarted=restart)
            # the crash postmortem (docs/observability.md "Flight
            # recorder"): the retained event ring — armed/fired fault
            # sites, the dispatches and degradations leading up to the
            # crash, and the stray resolutions just booked — written as
            # one artifact (when a dump directory is configured; always
            # retained in-process via nmfx_torch.obs.flight.last_dump)
            _flight.dump("serve-scheduler-crash",
                         extra={"error": cause,
                                "resolved_requests": failed,
                                "scheduler_restarted": restart})
            if restart:
                with self._cond:
                    if not self._closed:
                        self._ensure_workers()

    def _linger(self, head: _Request,
                batch: "list[_Request]") -> "list[_Request]":
        """Continuous-batching linger: hold ``head``'s dispatch briefly
        so near-simultaneous compatible arrivals share its lanes."""
        until = time.monotonic() + self.cfg.batch_linger_s
        lanes = sum(r.lanes for r in batch)
        with self._cond:
            while (len(batch) < self.cfg.max_batch_requests
                   and not self._closed):
                remaining = until - time.monotonic()
                if remaining <= 0:
                    break
                batch += self._take_compatible_locked(head, lanes,
                                                      len(batch))
                lanes = sum(r.lanes for r in batch)
                if len(batch) >= self.cfg.max_batch_requests:
                    break
                self._cond.wait(timeout=remaining)
            batch += self._take_compatible_locked(head, lanes, len(batch))
        return batch

    def _budget_clamps(self, req: _Request) -> bool:
        return (req.deadline is not None
                and self.cfg.iter_rate_estimate is not None)

    def _budget_iters(self, req: _Request) -> "int | None":
        """Deadline → per-lane iteration budget: the remaining wall at
        the estimated iteration rate, rounded UP to a power-of-two
        multiple of check_every (bounding executable churn to
        log(max_iter) distinct budgets), clamped to the configured
        max_iter. The lanes then stop via the per-lane in-kernel budget
        — the only eviction a launched dispatch admits."""
        if not self._budget_clamps(req):
            return None
        remaining = req.deadline - time.monotonic()
        want = int(remaining * self.cfg.iter_rate_estimate)
        ce = req.scfg.check_every
        step = ce
        while step < max(want, 1):
            step *= 2
        return min(step, req.scfg.max_iter)

    def _resolve_expired(self, req: _Request,
                         mid_solve: bool = False) -> None:
        now = time.monotonic()
        req.stats.latency_s = now - req.submitted
        with self._lock:
            self.counters["deadline_expired"] += 1
        if req.future.cancelled() or req.future.done():
            return
        if not mid_solve and not req.future.set_running_or_notify_cancel():
            return
        # observed only when the future actually resolves as a
        # deadline — a cancelled request must not skew the
        # outcome-labeled latency series
        _e2e_hist.observe(req.stats.latency_s, outcome="deadline")
        msg = ("deadline expired mid-solve; the request's lanes were "
               "stopped by the per-lane iteration budget and its "
               "results discarded" if mid_solve else
               "deadline expired before dispatch")
        req.future.set_exception(DeadlineExceeded(msg))

    def _dispatch(self, batch: "list[_Request]") -> None:
        from nmfx_torch.faults import warn_once

        t0 = time.monotonic()
        live = [r for r in batch
                if r.future.set_running_or_notify_cancel()]
        with self._lock:
            self.counters["cancelled"] += len(batch) - len(live)
        if not live:
            return
        tracer = _trace.default_tracer()
        for req in live:
            req.stats.queue_wait_s = t0 - req.submitted
            # retroactive span: the queue residency that just ended at
            # this dispatch — carries the request id (RequestStats ids
            # in span args)
            tracer.complete("serve.queue_wait", req.stats.queue_wait_s,
                            cat="serve", args={"request_id": req.seq})
            _queue_wait_hist.observe(req.stats.queue_wait_s)
        if len(live) >= 2:
            try:
                with tracer.span(
                        "serve.dispatch", cat="serve",
                        args={"request_ids": [r.seq for r in live],
                              "packed": True,
                              "lanes": sum(r.lanes for r in live)}), \
                        self._prof.phase("serve.pack"):
                    placed = self.engine.place(live[0])
                    raws = self.engine.dispatch_packed(live, placed)
            except BaseException as e:
                # degradation rung 1 (docs/serving.md "Failure model"):
                # a failed PACKED dispatch retries each request solo —
                # failure isolation becomes per-request, and a fault in
                # the shared packed path cannot take down its mates
                warn_once(
                    "packed-dispatch-fallback",
                    f"packed dispatch of {len(live)} requests failed "
                    f"({e!r}); retrying each request solo — results "
                    "are unaffected, the cross-request batching win is "
                    "lost for this batch")
            else:
                self._handoff(live, raws, t0, packed=True)
                return
        # solo: a single head, or every member of a failed packed batch
        for req in live:
            scfg = req.scfg
            budget = self._budget_iters(req)
            cause = req.degrade_cause
            if (cause is None and budget is not None
                    and budget < scfg.max_iter
                    and self.cfg.quality_elastic
                    and self._sketch_eligible(scfg)):
                # quality elasticity, cause "deadline": the deadline
                # would clamp the exact solve's iteration budget —
                # serve the cheaper engine at its full budget instead
                # of a truncated exact solve
                cause = "deadline"
            if cause is not None:
                req.degrade_cause = cause
                req.quality = "sketched"
                scfg = dataclasses.replace(req.scfg, backend="sketched")
                req.stats.quality = "sketched"
                req.stats.degraded_cause = cause
                _quality_degraded_total.inc(cause=cause)
                _flight.record("serve.quality_degraded",
                               request_id=req.seq, cause=cause)
                with self._lock:
                    self.counters["quality_degraded"] += 1
            elif budget is not None and budget < scfg.max_iter:
                scfg = dataclasses.replace(scfg, max_iter=budget)
                req.stats.budget_iters = budget
                with self._lock:
                    self.counters["budget_clamped"] += 1
            try:
                with tracer.span(
                        "serve.dispatch", cat="serve",
                        args={"request_ids": [req.seq],
                              "packed": False, "lanes": req.lanes}), \
                        self._prof.phase("serve.pack"):
                    raw = self._dispatch_solo_retrying(req, scfg)
            except BaseException as e:
                with self._lock:
                    self.counters["failed"] += 1
                req.stats.latency_s = time.monotonic() - req.submitted
                if not req.future.done():
                    _e2e_hist.observe(req.stats.latency_s,
                                      outcome="failed")
                    req.future.set_exception(e)
            else:
                self._handoff([req], [raw], t0, packed=False)

    def _dispatch_solo_retrying(self, req: _Request, scfg: SolverConfig):
        """Degradation rung 2: each solo dispatch gets
        ``ServeConfig.dispatch_retries`` additional attempts with
        exponential backoff (``retry_backoff_s * 2**i`` before retry
        ``i``); exhausting them raises a typed :class:`RequestFailed`
        whose ``__cause__`` chains the last underlying failure."""
        from nmfx_torch.faults import warn_once

        last: "BaseException | None" = None
        for attempt in range(self.cfg.dispatch_retries + 1):
            if attempt:
                time.sleep(self.cfg.retry_backoff_s * 2 ** (attempt - 1))
            try:
                # a quality-degraded dispatch runs the sketched engine,
                # which the executable cache cannot serve: placing the
                # exact config would pad and copy a buffer the dispatch
                # then ignores
                placed = (None if scfg.backend == "sketched"
                          else self.engine.place(req))
                return self.engine.dispatch_solo(req, placed, scfg)
            except BaseException as e:  # retried; typed RequestFailed
                last = e                # below when exhausted
                # flight event per ATTEMPT (warn_once dedups the log
                # line; the postmortem needs every retry)
                _flight.record("serve.retry", request_id=req.seq,
                               attempt=attempt + 1,
                               retries=self.cfg.dispatch_retries,
                               error=e)
                warn_once(
                    "solo-dispatch-retry",
                    f"solo dispatch attempt {attempt + 1} failed "
                    f"({e!r}); "
                    + (f"retrying (up to {self.cfg.dispatch_retries} "
                       "retr(y/ies) with exponential backoff)"
                       if self.cfg.dispatch_retries else
                       "no retries configured"))
        raise RequestFailed(
            f"every dispatch attempt failed "
            f"({self.cfg.dispatch_retries + 1} solo attempt(s)"
            + (" after the packed attempt" if req.compat is not None
               else "") + ")") from last

    def _handoff(self, live: "list[_Request]", raws: list, t0: float,
                 packed: bool) -> None:
        """Book a successful dispatch and hand each request to the
        completion workers (who own its Future from here — the
        watchdog's ``_harvest_owned`` contract)."""
        t1 = time.monotonic()
        lanes = sum(r.lanes for r in live)
        _note_dispatch(len(live), lanes)
        _flight.record("serve.dispatch",
                       request_ids=[r.seq for r in live],
                       packed=packed, lanes=lanes,
                       pack_s=round(t1 - t0, 6))
        _pack_hist.observe(t1 - t0)
        with self._lock:
            self.counters["dispatches"] += 1
            self.counters["total_lanes"] += lanes
            if packed:
                self.counters["packed_dispatches"] += 1
                self.counters["packed_requests"] += len(live)
                self.counters["packed_lanes"] += lanes
            self._inflight += len(live)
            self._sync_gauges()
        for req, raw in zip(live, raws):
            req.stats.pack_s = t1 - t0
            req.stats.packed_requests = len(live)
            with self._harvest_cond:
                self._harvest_owned.add(req.seq)
                self._harvest_q.append((req, raw, t1))
                self._harvest_cond.notify()

    # -- completion --------------------------------------------------------
    def _run_harvester(self) -> None:
        from nmfx_torch import faults
        from nmfx_torch.api import ConsensusResult
        from nmfx_torch.faults import InsufficientRestarts, warn_once
        from nmfx_torch.harvest import harvest_rank

        self._bind_device()

        while True:
            with self._harvest_cond:
                while not self._harvest_q:
                    self._harvest_cond.wait()
                item = self._harvest_q.pop(0)
            if item is None:
                return
            req, raw, t_disp = item
            try:
                t_h0 = time.perf_counter()
                fetch_s = select_s = 0.0
                per_k = {}
                for k in req.ks:
                    try:
                        # chaos site: a completion (harvest) worker
                        # dying mid-rank — same site the streamed
                        # pipeline's workers pass (harvest.py)
                        faults.inject("harvest.worker")
                        kres, f_s, s_s = harvest_rank(
                            k, raw[k], req.linkage, self._prof,
                            req.min_restarts)
                    except InsufficientRestarts:
                        raise  # deterministic: a re-run cannot succeed
                    except BaseException as e:
                        # recovery: the same device output through the
                        # same host math, inline — exact; a second
                        # failure resolves the future via the outer
                        # handler
                        warn_once(
                            "harvest-worker-fallback",
                            f"serve completion worker failed on rank "
                            f"{k} ({e!r}); re-running that rank's "
                            "harvest inline — results are unaffected")
                        kres, f_s, s_s = harvest_rank(
                            k, raw[k], req.linkage, self._prof,
                            req.min_restarts)
                    per_k[k] = kres
                    fetch_s += f_s
                    select_s += s_s
                # retroactive span over this request's whole harvest
                # (device-blocked fetch + rank selection, every rank):
                # the per-rank xfer.d2h_overlap / post.rank_selection
                # spans harvest_rank booked nest inside it on this
                # worker thread
                _trace.default_tracer().complete(
                    "serve.harvest", time.perf_counter() - t_h0,
                    cat="serve", args={"request_id": req.seq})
                req.stats.solve_s = fetch_s
                req.stats.harvest_s = select_s
                _solve_hist.observe(fetch_s)
                now = time.monotonic()
                # per-REQUEST roofline attribution: model FLOPs of the
                # lanes this request actually ran over its
                # dispatch→harvested wall, against the peak of the
                # engine's device. Packed mates' walls overlap (each
                # counts the shared device solve), so the serve kind
                # reads as request-level throughput — the dispatch-level
                # kernel MFU lives under the exec.* / sweep.* kinds
                if _costmodel.attribution_enabled():
                    scfg_served = (
                        dataclasses.replace(req.scfg, backend="sketched")
                        if req.quality == "sketched" else req.scfg)
                    _costmodel.attribute_dispatch(
                        "serve", scfg_served, req.a.shape[0],
                        req.a.shape[1],
                        {k: np.asarray(r.iterations)
                         for k, r in per_k.items()},
                        now - t_disp,
                        device=getattr(self.engine, "device", None))
                req.stats.latency_s = now - req.submitted
                if req.deadline is not None and now >= req.deadline:
                    self._resolve_expired(req, mid_solve=True)
                else:
                    # req.quality is the one quality funnel: "sketched"
                    # whenever the compressed engine served the request
                    # (by its own config, or degraded there)
                    result = ConsensusResult(ks=req.ks, per_k=per_k,
                                             col_names=req.col_names,
                                             quality=req.quality)
                    if (self.result_cache is not None
                            and req.cache_fp is not None):
                        # a result re-keys at its ACTUAL served quality
                        pkey = (req.cache_key
                                if result.quality == req.cache_quality
                                else self._result_key(req,
                                                      result.quality))
                        try:
                            self.result_cache.put(pkey, result)
                        except Exception:  # nmfx: ignore[NMFX006] -- best-
                            # effort admission: cache trouble (disk
                            # full, perms) never fails the solve
                            pass
                    req.future.set_result(result)
                    _e2e_hist.observe(req.stats.latency_s,
                                      outcome="completed")
                    with self._lock:
                        self.counters["completed"] += 1
            except BaseException as e:  # resolves the request's Future
                with self._lock:
                    self.counters["failed"] += 1
                if not req.future.done():
                    _e2e_hist.observe(time.monotonic() - req.submitted,
                                      outcome="failed")
                    req.future.set_exception(e)
            finally:
                with self._harvest_cond:
                    self._harvest_owned.discard(req.seq)
                with self._lock:
                    self._inflight -= 1
                    self._sync_gauges()
