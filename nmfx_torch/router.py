"""NMFXRouter: the health-checked front door over a replica pool
(counterpart of ``nmfx/router.py``; ``nmfx_torch/replica.py`` is the
pool). An :class:`NMFXRouter` exposes the SAME ``submit() -> Future``
surface as one ``NMFXServer`` and places each request on one of N
replicas: no request is computed twice by design, and no replica death
strands one.

Placement — **content-hash stickiness broken by least-loaded**: the
request matrix's content hash (sha256 of its host bytes; a CUDA tensor
is copied to the host once, for the hash and the spill record) picks a
preferred replica by highest-random-weight (rendezvous) hashing, so
repeat submissions of one dataset land where its device-resident input
cache (and padded exec-cache bucket) is already warm, and the
preference is STABLE under pool membership changes (only keys owned by
a removed replica move). Stickiness yields when the preferred replica's
outstanding load exceeds the least-loaded replica's by more than
``RouterConfig.stickiness_slack``. Priced placement partitions the
routable set by capability class (devices per replica); every replica
of the port owns one device, so there is one class and placement is the
plain one. The cost model prices the request as an annotation
(``RouterStats.placement_inputs``).

Failure handling, layer by layer:

* **Forward failure / replica-side typed failure** (``QueueFull``,
  ``RequestFailed``, ``ServerCrashed``, ``ServerClosed``, the armed
  ``router.forward`` chaos site): exponential-backoff retry on ANOTHER
  replica, up to ``forward_retries`` re-forwards; exhaustion resolves
  the future with a typed :class:`ForwardFailed` chaining the last
  cause.
* **At-most-once**: a forward timeout on a LIVE replica re-forwards
  only when the original provably never dispatched — the router
  cancels the thread-replica future (succeeds until dispatch) or
  claims the process-replica inbox record back (succeeds until the
  worker claims it); otherwise it keeps waiting. Every resolution is
  keyed by the router request id, so a late duplicate (a readmitted
  copy racing its original) is discarded, never double-delivered.
* **Stale heartbeat ⇒ drain**: a replica whose heartbeat
  (``replica_<id>.json``, the shared ledger) ages past
  ``stale_after_s`` is marked unroutable, in-flight work finishes, and
  its queued requests spill — each spill record is claimed by the
  router and readmitted on a survivor, joined back to the original
  future by request id.
* **Killed replica**: a dead worker's unfinished inbox records are
  reclaimed (breaking the dead pid's claims) and readmitted on
  survivors through the one ``spill_submit_kwargs`` funnel — byte-equal
  to the original submission by the serving exactness contract.

Elasticity: ``scale_up()`` spawns a replica, ``scale_down()`` drains
via spill-migration, and overload sheds at the ROUTER on the SLO
burn-rate signal (``RouterConfig.shed_on_burn``) instead of per-replica
queue depth alone.

With ``RouterConfig(quality_elastic=True)`` a burn-shed request whose
algorithm has a sketched form is degraded to the sketched engine
(``RouterStats.degraded_cause == "slo_burn"``, the result tagged
``quality == "sketched"``) instead of being shed. The router-level
result cache keys its entries with the pool's device type and a router
route, so they never answer a server's or a plain sweep's lookup (the
port's keys record the route a result was computed on).
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq
import itertools
import os
import threading
import time
from concurrent.futures import Future

import numpy as np

from nmfx_torch.guards import guarded_by
from nmfx_torch.obs import flight as _flight
from nmfx_torch.obs import metrics as _metrics
from nmfx_torch.serve import (QueueFull, RequestFailed, ServeError,
                        ServerClosed, ServerCrashed)

__all__ = ["ForwardFailed", "NMFXRouter", "NoRoutableReplicas",
           "RouterClosed", "RouterConfig", "RouterError",
           "RouterOverloaded", "RouterStats"]


# --------------------------------------------------------------------------
# metrics (the reference's series, same names and labels)
_forwards_total = _metrics.counter(
    "nmfx_router_forwards_total",
    "requests forwarded to a replica (re-forwards included)",
    labelnames=("replica",))
_retries_total = _metrics.counter(
    "nmfx_router_retries_total",
    "re-forwards onto another replica, by cause",
    labelnames=("cause",))
_shed_total = _metrics.counter(
    "nmfx_router_shed_total",
    "requests the router shed or degraded instead of queueing",
    labelnames=("action", "cause"))
_readmits_total = _metrics.counter(
    "nmfx_router_readmits_total",
    "spilled requests claimed from a drained/dead replica and "
    "readmitted on a survivor")
_outstanding_gauge = _metrics.gauge(
    "nmfx_router_outstanding",
    "requests accepted by the router and not yet resolved")
_placement_total = _metrics.counter(
    "nmfx_router_placement_total",
    "placements by capability class — the device count of the chosen "
    "replica's mesh (1 = a plain single-device replica)",
    labelnames=("class",))
_router_e2e_hist = _metrics.histogram(
    "nmfx_router_e2e_seconds",
    "router submit-to-resolution latency", labelnames=("outcome",))
# declared identically in nmfx_torch.result_cache / serve — the registry
# get-or-creates, so whichever module imports first owns the instance
_coalesced_total = _metrics.counter(
    "nmfx_result_cache_coalesced_total",
    "requests attached as followers to an identical in-flight solve "
    "instead of dispatching their own", labelnames=("layer",))


class RouterError(ServeError):
    """Base class of the router's typed failures."""


class RouterClosed(RouterError):
    """The router no longer accepts (or will not complete) requests."""


class RouterOverloaded(RouterError):
    """The router shed this request — its outstanding bound is hit, or
    the SLO burn-rate signal says the fleet is eating error budget too
    fast to take more load (``RouterConfig.shed_on_burn``). Back off
    and resubmit."""


class NoRoutableReplicas(RouterError):
    """No replica is currently routable (all drained/dead and nothing
    respawned) — the request cannot be placed."""


class ForwardFailed(RouterError):
    """Every forward attempt failed — the initial placement plus
    ``RouterConfig.forward_retries`` re-forwards on other replicas.
    ``__cause__`` chains the last underlying failure."""


#: the route a router-level result-cache key records: served through
#: a replica pool (never the plain sweep's None nor an executable
#: cache's route, so a router entry answers only a router lookup)
_ROUTER_ROUTE = {"served_by": "router"}


def _pool_device(pool):
    """The device a pool's replicas serve on, for the result-cache key:
    a process pool's ``--device`` worker flag; a thread pool's
    executable cache's device where its replicas serve through one
    (a ``ThreadReplica`` given an ``exec_cache`` serves on the cache's
    device, whatever the pool's ``device`` says); else the pool's
    ``device``. None = the card."""
    args = list(getattr(pool, "worker_args", ()) or ())
    for i, arg in enumerate(args):
        if arg == "--device" and i + 1 < len(args):
            return args[i + 1]
        if arg.startswith("--device="):
            return arg.split("=", 1)[1]
    exec_cache = getattr(pool, "exec_cache", None)
    if exec_cache is not None and getattr(pool, "engine_factory",
                                          None) is None:
        return exec_cache.device
    return getattr(pool, "device", None)


#: replica-side failures that justify retrying ON ANOTHER replica:
#: the request provably did not (and will not) produce a result there
_RETRYABLE = (QueueFull, RequestFailed, ServerClosed, ServerCrashed)


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Router policy (frozen, all fields compare — the ``ServeConfig``
    discipline)."""

    #: router-wide admission bound on accepted-but-unresolved requests
    max_outstanding: int = 256
    #: re-forwards on OTHER replicas after a failed forward (the
    #: initial placement is not counted)
    forward_retries: int = 2
    #: base seconds of the exponential backoff between re-forwards
    #: (re-forward i waits ``retry_backoff_s * 2**(i-1)``)
    retry_backoff_s: float = 0.05
    #: per-forward timeout: a forward outstanding longer than this on a
    #: LIVE replica is re-placed only if it provably never dispatched
    #: (see the module docstring); None = no timeout
    forward_timeout_s: "float | None" = None
    #: heartbeat age past which a replica is drained (stale ⇒ mark
    #: unroutable, let in-flight finish, readmit the rest elsewhere)
    stale_after_s: float = 3.0
    #: maintenance loop cadence (health checks, outbox polling,
    #: retry dispatch, deadline enforcement)
    health_interval_s: float = 0.1
    #: how far above the least-loaded replica's outstanding count the
    #: content-sticky replica may be before stickiness yields to
    #: least-loaded placement
    stickiness_slack: int = 4
    #: shed new load while the SLO burn-rate signal reports a fast
    #: burn on one of ``shed_objectives`` (``nmfx_torch.obs.slo``)
    shed_on_burn: bool = False
    #: objectives whose fast burn triggers shedding
    shed_objectives: "tuple[str, ...]" = ("availability", "latency_p99")
    #: degrade burn-shed requests to the sketched engine (tagged,
    #: never silent) instead of rejecting them
    quality_elastic: bool = False
    #: SLO evaluation cadence inside the maintenance loop
    slo_interval_s: float = 1.0
    #: metrics-driven elasticity: run the autoscale policy in the
    #: maintenance loop (scale_up/scale_down stay callable either way)
    autoscale: bool = False
    min_replicas: int = 1
    max_replicas: int = 4
    #: mean outstanding per routable replica beyond which the
    #: autoscaler spawns one more (a burn also triggers scale-up)
    scale_up_outstanding: float = 4.0
    #: zero-outstanding streak after which the autoscaler drains one
    scale_down_idle_s: float = 30.0
    #: claims older than this on a dead replica's records are broken
    #: during recovery even when the owner pid is unknown
    break_claims_after_s: float = 30.0
    #: staleness grace for a replica that has not heartbeat YET: a
    #: subprocess worker spends seconds importing its runtime before
    #: its first beat, and draining it in that window would kill every
    #: scale-up (a dead PROCESS is still recovered immediately — the
    #: grace only covers the silent-but-alive startup window)
    spawn_grace_s: float = 120.0
    #: SIGTERM→SIGKILL escalation: a draining process replica still
    #: alive this long after its SIGTERM is presumed wedged (stuck
    #: syscall, ignored signal) and is killed so recovery can reclaim
    #: its records — an alive-but-unresponsive worker must not hold
    #: its queued requests hostage
    drain_kill_after_s: float = 60.0
    #: coalesce concurrent identical submissions (same content hash +
    #: result-affecting config) onto ONE forwarded solve: followers
    #: never forward, attach to the leader's outcome, and survive
    #: replica failover through the leader's re-forward (exactly one
    #: re-dispatch fleet-wide). Deadline'd requests never coalesce.
    #: Opt-in: deduplication changes per-replica dispatch observables
    #: that placement tests and A/B baselines key on
    coalesce_requests: bool = False
    #: directory for the router-level content-addressed result cache
    #: (``nmfx_torch.result_cache``) — a warm hit resolves at the router
    #: with zero forwards; None disables the disk tier and the cache
    result_cache_dir: "str | None" = None
    #: cost-priced placement over a heterogeneous fleet: partition the
    #: routable set into CAPABILITY CLASSES by replica device count, price
    #: each request from the analytic cost model (solve FLOPs +
    #: per-iteration comm bytes + queue depth — the inputs land in
    #: ``RouterStats.placement_inputs``), and restrict placement to one
    #: class: atlas-shaped requests (input ≥ ``atlas_floor_bytes``) go
    #: to the LARGEST routable class — never to a 1-chip replica while
    #: a mesh replica is routable — and small requests stay on the
    #: SMALLEST (mesh time is too expensive to burn on work a single
    #: chip serves at equal latency). Content-hash stickiness then
    #: operates WITHIN the chosen class. Default-on is safe: a
    #: homogeneous fleet has one class, where this is exactly the plain
    #: placement.
    price_placement: bool = True
    #: input-matrix bytes at and above which a request is atlas-class
    atlas_floor_bytes: int = 64 << 20

    def __post_init__(self):
        if self.max_outstanding < 1:
            raise ValueError("max_outstanding must be >= 1")
        if self.forward_retries < 0:
            raise ValueError("forward_retries must be >= 0")
        if self.retry_backoff_s < 0:
            raise ValueError("retry_backoff_s must be >= 0")
        if self.forward_timeout_s is not None \
                and self.forward_timeout_s <= 0:
            raise ValueError("forward_timeout_s must be positive or "
                             "None")
        if self.stale_after_s <= 0:
            raise ValueError("stale_after_s must be positive")
        if self.health_interval_s <= 0:
            raise ValueError("health_interval_s must be positive")
        if self.stickiness_slack < 0:
            raise ValueError("stickiness_slack must be >= 0")
        if self.slo_interval_s <= 0:
            raise ValueError("slo_interval_s must be positive")
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        if self.scale_up_outstanding <= 0:
            raise ValueError("scale_up_outstanding must be positive")
        if self.scale_down_idle_s <= 0:
            raise ValueError("scale_down_idle_s must be positive")
        if self.break_claims_after_s <= 0:
            raise ValueError("break_claims_after_s must be positive")
        if self.spawn_grace_s < 0:
            raise ValueError("spawn_grace_s must be >= 0")
        if self.drain_kill_after_s <= 0:
            raise ValueError("drain_kill_after_s must be positive")
        if self.atlas_floor_bytes < 1:
            raise ValueError("atlas_floor_bytes must be >= 1")


@dataclasses.dataclass
class RouterStats:
    """Per-request routing spans, readable on the returned future
    (``future.stats``)."""

    #: the router-assigned request id (rides every spill record as
    #: ``router_request_id`` — the dedup key of at-most-once delivery)
    request_id: "str | None" = None
    #: the replica that produced (or last attempted) the result
    replica: "str | None" = None
    #: forward attempts (1 = first placement succeeded)
    attempts: int = 0
    #: whether the final placement was the content-sticky choice
    sticky: "bool | None" = None
    #: submit → resolution wall
    latency_s: "float | None" = None
    #: why the router degraded this request ("slo_burn"), None when
    #: served as requested
    degraded_cause: "str | None" = None
    #: causes of the re-forwards this request survived
    retried: "list[str]" = dataclasses.field(default_factory=list)
    #: capability class the request placed into: the device count of
    #: the chosen replica's mesh (1 = plain replica); recorded on every
    #: placement, priced or not (it is telemetry); None before the
    #: first placement
    placement_class: "int | None" = None
    #: the priced-placement decision inputs: input bytes,
    #: the atlas verdict, the per-iteration solve FLOPs and meshed comm
    #: bytes the cost model priced the chosen class at, and the queue
    #: depth the load comparison saw — the audit trail for "why did
    #: this land on an 8-chip mesh"
    placement_inputs: "dict | None" = None


class _RouterFuture(Future):
    def __init__(self, stats: RouterStats):
        super().__init__()
        self.stats = stats


@dataclasses.dataclass
class _Pending:
    rid: str
    a: np.ndarray
    meta: dict
    future: _RouterFuture
    chash: str
    submitted: float
    deadline: "float | None"
    replica_id: "str | None" = None
    inner: "Future | None" = None
    attempts: int = 0
    exclude: set = dataclasses.field(default_factory=set)
    retry_due: "float | None" = None
    retry_cause: "BaseException | None" = None
    forwarded_at: float = 0.0
    #: content-addressed result key — set (leaders only) when this
    #: request coalesces or populates the result cache; None otherwise
    ckey: "str | None" = None
    #: (scfg, ccfg, icfg, requested-quality) to re-key a result the
    #: replica served degraded (a sketched answer must never be
    #: replayed to exact-quality submissions)
    ckey_parts: "tuple | None" = None


@guarded_by("_lock", "_pending", "_retryq", "_outstanding", "_closed",
            "_burning", "_coalesce", "_cofollowers", "counters")
class NMFXRouter:
    """The front door: ``submit()`` with the ``NMFXServer`` surface,
    placed across a :class:`nmfx_torch.replica.ReplicaPool` (see the module
    docstring for placement/failover/elasticity semantics)."""

    def __init__(self, pool, cfg: RouterConfig = RouterConfig(), *,
                 slo_engine=None, telemetry_dir: "str | None" = None,
                 own_pool: bool = True, result_cache=None):
        self.pool = pool
        self.cfg = cfg
        self._own_pool = own_pool
        self._key_device = _pool_device(pool)
        self._lock = threading.Lock()
        self._pending: "dict[str, _Pending]" = {}
        self._retryq: "list[tuple[float, str]]" = []  # (due, rid)
        self._outstanding: "dict[str, int]" = {}  # per replica
        self._seq = itertools.count()
        self._closed = False
        self._burning: "list[str]" = []  # objectives in fast burn
        self._last_slo = 0.0
        self._idle_since: "float | None" = None
        self._wake = threading.Event()
        if result_cache is not None:
            self.result_cache = result_cache
        elif cfg.result_cache_dir is not None:
            from nmfx_torch.result_cache import ResultCache

            self.result_cache = ResultCache(
                cache_dir=cfg.result_cache_dir, layer="router")
        else:
            self.result_cache = None
        # in-flight coalescing, guarded by self._lock:
        # result key → leader _Pending / attached follower rids.
        # Followers live in _pending (close()/stats see them) but
        # never forward — they resolve from the leader's fan-out
        self._coalesce: "dict[str, _Pending]" = {}
        self._cofollowers: "dict[str, list[str]]" = {}
        self.counters = {"submitted": 0, "completed": 0, "failed": 0,
                         "retried": 0, "shed": 0, "degraded": 0,
                         "readmitted": 0, "duplicates": 0,
                         "drained": 0, "recovered": 0,
                         "result_cache_hits": 0, "coalesced": 0}
        if slo_engine is not None:
            self._slo = slo_engine
        elif telemetry_dir is not None:
            # fleet-backed burn signal: process replicas book their
            # serve latency histograms in their OWN registries, so the
            # router must read them through the merged fleet view
            from nmfx_torch.obs.aggregate import FleetCollector
            from nmfx_torch.obs.slo import SLOEngine

            self._slo = SLOEngine(
                snapshot_fn=FleetCollector(
                    telemetry_dir,
                    stale_after_s=max(cfg.stale_after_s, 1.0)
                ).fleet_snapshot)
        else:
            from nmfx_torch.obs.slo import SLOEngine

            self._slo = SLOEngine()
        self._maint = threading.Thread(target=self._run_maintenance,
                                       daemon=True, name="nmfx-router")
        self._maint.start()

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self) -> "NMFXRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self, cancel_pending: bool = False,
              timeout: float = 600.0) -> None:
        """Stop accepting requests. Default: wait for every outstanding
        future to resolve (the pool keeps serving), then stop the
        maintenance thread and close the pool (when the router owns
        it). ``cancel_pending=True`` fails unresolved requests with a
        typed :class:`RouterClosed` instead of waiting."""
        from concurrent.futures import CancelledError
        from concurrent.futures import TimeoutError as FutTimeout

        with self._lock:
            if self._closed:
                pending = []
            else:
                self._closed = True
                pending = list(self._pending.values())
        if cancel_pending:
            for p in pending:
                self._resolve(p, error=RouterClosed(
                    "router closed with this request unresolved"))
        else:
            deadline = time.monotonic() + timeout
            for p in pending:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    p.future.exception(timeout=remaining)
                except (FutTimeout, CancelledError):
                    # close() only WAITS; the
                    # request's outcome was already booked elsewhere
                    pass
            # anything still unresolved at the timeout fails typed —
            # the maintenance thread exits only when nothing is
            # pending, so leaving a stuck future would turn close()
            # into the hang it exists to prevent
            for p in pending:
                if not p.future.done():
                    self._resolve(p, error=RouterClosed(
                        f"router close() timed out after {timeout}s "
                        "with this request unresolved"))
        self._wake.set()
        self._maint.join()
        if self._own_pool:
            self.pool.close()

    # -- submission --------------------------------------------------------
    def submit(self, data, ks=(2, 3, 4, 5), restarts: int = 10, *,
               seed: int = 123, solver_cfg=None, init_cfg=None,
               label_rule: str = "argmax", linkage: str = "average",
               grid_slots: int = 48, grid_tail_slots="auto",
               min_restarts: int = 1, priority: int = 0,
               deadline: "float | None" = None,
               timeout: "float | None" = None) -> _RouterFuture:
        """Enqueue one consensus request against the fleet; returns a
        ``Future[ConsensusResult]`` immediately. Arguments mirror
        ``NMFXServer.submit`` (results are byte-equal to a direct
        submission — the serving exactness contract holds through the
        router, including across a failover readmission). ``data`` is a
        path, a ``Dataset``, an array or a tensor; a CUDA tensor is
        copied to the host once (the content hash and the spill record
        are host bytes). Deadlines are enforced at the ROUTER (typed
        ``DeadlineExceeded``; a replica-side solve that outlives its
        deadline is discarded by request-id dedup)."""
        from nmfx_torch.api import _as_matrix
        from nmfx_torch.config import InitConfig, SolverConfig
        from nmfx_torch.serve import NMFXServer, spill_meta

        with self._lock:
            if self._closed:
                raise RouterClosed("router is closed")
            n_out = len(self._pending)
            burning = list(self._burning)
        if n_out >= self.cfg.max_outstanding:
            self._note_shed("shed", "admission")
            raise RouterOverloaded(
                f"router outstanding bound reached "
                f"({self.cfg.max_outstanding})")
        scfg = solver_cfg if solver_cfg is not None else SolverConfig()
        icfg = init_cfg if init_cfg is not None else InitConfig()
        degraded_cause = None
        if burning and self.cfg.shed_on_burn:
            if self.cfg.quality_elastic \
                    and NMFXServer._sketch_eligible(scfg):
                # burn-pressure quality elasticity: serve the cheaper
                # engine instead of shedding — tagged end to end
                # (ConsensusResult.quality == "sketched"), never silent
                scfg = dataclasses.replace(scfg, backend="sketched")
                degraded_cause = "slo_burn"
                self._note_shed("degraded", "slo_burn")
            else:
                self._note_shed("shed", "slo_burn")
                raise RouterOverloaded(
                    "SLO fast burn on "
                    f"{'/'.join(burning)} — the router is shedding "
                    "load until the burn clears "
                    "(RouterConfig.shed_on_burn)")
        if deadline is not None and timeout is not None:
            raise ValueError("pass either deadline or timeout, not both")
        if timeout is not None:
            deadline = time.monotonic() + timeout
        if type(data).__module__.startswith("torch"):
            data = data.detach().cpu().numpy()
        arr, col_names = _as_matrix(data)
        arr = np.asarray(arr)
        rid = f"req-{os.getpid()}-{next(self._seq)}"
        meta = spill_meta(
            request_id=rid, ks=ks, restarts=restarts, seed=seed,
            scfg=scfg, icfg=icfg, label_rule=label_rule,
            linkage=linkage, grid_slots=grid_slots,
            grid_tail_slots=grid_tail_slots, min_restarts=min_restarts,
            priority=priority, col_names=col_names,
            router_request_id=rid)
        stats = RouterStats(request_id=rid,
                            degraded_cause=degraded_cause)
        # zero-copy content hash (the DataCache.key_for idiom):
        # ascontiguousarray is a no-op on the common contiguous case,
        # and the uint8 view hashes in place instead of materializing
        # a full tobytes() copy of the matrix per submission
        submitted_at = time.monotonic()
        chash = hashlib.sha256(
            np.ascontiguousarray(arr).view(np.uint8)
            .reshape(-1)).hexdigest()
        # request economics: the content-addressed result key — the
        # server layer's payload, for the pool's device type and the
        # router's own route (see _key). Deadline'd requests bypass both
        # the cache and coalescing (a replayed/shared result cannot honor
        # a latency contract it never saw)
        ckey = ckey_parts = None
        if deadline is None and (self.result_cache is not None
                                 or self.cfg.coalesce_requests):
            from nmfx_torch.config import ConsensusConfig
            from nmfx_torch.result_cache import request_quality

            ccfg = ConsensusConfig(
                ks=tuple(ks), restarts=restarts, seed=seed,
                label_rule=label_rule, linkage=linkage,
                grid_slots=grid_slots,
                grid_tail_slots=grid_tail_slots,
                min_restarts=min_restarts)
            quality = request_quality(scfg)
            ckey_parts = (chash, tuple(arr.shape), arr.dtype.str,
                          scfg, ccfg, icfg, quality)
            ckey = self._key(*ckey_parts)
            if self.result_cache is not None:
                cached = self.result_cache.lookup(ckey)
                if cached is not None:
                    with self._lock:
                        if self._closed:
                            raise RouterClosed("router is closed")
                        self.counters["submitted"] += 1
                        self.counters["completed"] += 1
                        self.counters["result_cache_hits"] += 1
                    stats.latency_s = time.monotonic() - submitted_at
                    fut = _RouterFuture(stats)
                    fut.set_result(cached)
                    _router_e2e_hist.observe(stats.latency_s,
                                             outcome="completed")
                    return fut
        pending = _Pending(rid=rid, a=arr, meta=meta,
                           future=_RouterFuture(stats), chash=chash,
                           submitted=time.monotonic(),
                           deadline=deadline)
        with self._lock:
            # authoritative admission re-check at INSERTION: the cheap
            # pre-checks above ran in an earlier lock section, and a
            # close() (or a burst of submits) racing the hash/validate
            # work in between must not slip a request past the closed
            # flag — a post-close insert would hold the maintenance
            # thread (and close()'s join) hostage to a request nobody
            # will resolve
            if self._closed:
                raise RouterClosed("router is closed")
            if len(self._pending) >= self.cfg.max_outstanding:
                self.counters["shed"] += 1
                _shed_total.inc(action="shed", cause="admission")
                _flight.record("router.shed", action="shed",
                               cause="admission")
                raise RouterOverloaded(
                    f"router outstanding bound reached "
                    f"({self.cfg.max_outstanding})")
            leader = None
            if ckey is not None and self.cfg.coalesce_requests:
                cand = self._coalesce.get(ckey)
                if cand is not None and cand.rid in self._pending:
                    leader = cand
            if leader is not None:
                # attach as a follower: accounted in _pending (close()
                # and stats() must see it) but never forwarded — the
                # leader's fan-out resolves it, across re-forwards
                self._pending[rid] = pending
                self._cofollowers.setdefault(ckey, []).append(rid)
                _outstanding_gauge.set(len(self._pending))
                self.counters["submitted"] += 1
                self.counters["coalesced"] += 1
            else:
                self._pending[rid] = pending
                if ckey is not None and self.cfg.coalesce_requests:
                    # the key's in-flight leader (registered under the
                    # SAME lock section as admission — a raise above
                    # can never strand a registry entry)
                    self._coalesce[ckey] = pending
                pending.ckey = ckey
                pending.ckey_parts = ckey_parts
                _outstanding_gauge.set(len(self._pending))
                self.counters["submitted"] += 1
        if leader is not None:
            _coalesced_total.inc(layer="router")
            _flight.record("router.coalesce", request_id=rid,
                           leader=leader.rid, key=ckey[:12])
            return pending.future
        try:
            self._forward(pending)
        except RouterError as e:
            self._abort_leader(pending, e)
            raise
        return pending.future

    def _key(self, chash, shape, dt, scfg, ccfg, icfg, quality) -> str:
        """The router's result-cache key: ``result_cache.result_key``
        over the request, for the pool's device type and the route
        :data:`_ROUTER_ROUTE` — the port's keys record the route a
        result was computed on, and the router does not see its
        replicas' executable caches."""
        from nmfx_torch.result_cache import result_key

        return result_key(chash, shape, dt, scfg, ccfg, icfg, quality,
                          device=self._key_device, route=_ROUTER_ROUTE)

    def _note_shed(self, action: str, cause: str) -> None:
        _shed_total.inc(action=action, cause=cause)
        _flight.record("router.shed", action=action, cause=cause)
        with self._lock:
            self.counters["degraded" if action == "degraded"
                          else "shed"] += 1

    # -- placement ---------------------------------------------------------
    @staticmethod
    def _hrw(chash: str, replica_id: str) -> int:
        return int.from_bytes(
            hashlib.sha256(f"{chash}:{replica_id}".encode())
            .digest()[:8], "big")

    @staticmethod
    def _capability_class(rep) -> int:
        """Devices behind one replica (1 = plain single-device)."""
        return int(getattr(rep, "n_devices", 1) or 1)

    def _price_placement(self, pending: _Pending, candidates: list,
                         routable: list) -> "tuple[list, list, dict]":
        """Cost-priced class selection: restrict placement
        to ONE capability class — the largest for atlas-shaped inputs
        (the hard rule the mesh-tier acceptance test pins: an atlas
        request never lands on a 1-chip replica while a mesh replica
        is routable), the smallest otherwise — and price the request
        against it from the analytic cost model: the FLOPs an iteration
        and, for a meshed class, the wire bytes an iteration of its
        grid collectives (``costmodel.comm_model`` of the class' mesh
        spec). A class counts device entries, so a "1x2" replica whose
        two entries name one card is a class of 2."""
        classes = sorted({self._capability_class(rep)
                          for rep in candidates})
        atlas = int(pending.a.nbytes) >= self.cfg.atlas_floor_bytes
        chosen = classes[-1] if atlas else classes[0]
        candidates = [rep for rep in candidates
                      if self._capability_class(rep) == chosen]
        routable = [rep for rep in routable
                    if self._capability_class(rep) == chosen]
        inputs = {"bytes": int(pending.a.nbytes), "atlas": atlas,
                  "class": chosen, "classes": classes,
                  "flops_per_iter": None, "comm_bytes_per_iter": None}
        try:
            from nmfx_torch.obs import costmodel

            meta = pending.meta
            alg = meta["solver_cfg"]["algorithm"]
            m, n = (int(d) for d in pending.a.shape)
            kmax = max(int(k) for k in meta["ks"])
            lanes = len(meta["ks"]) * int(meta["restarts"])
            fl = costmodel.iteration_flops(alg, "vmap", m, n, kmax)
            if fl is not None:
                inputs["flops_per_iter"] = fl * lanes
            if chosen > 1 and alg in \
                    costmodel.comm_covered_algorithms():
                spec = next((rep.mesh_spec for rep in candidates
                             if getattr(rep, "mesh_spec", None)
                             is not None), None)
                if spec is not None:
                    from nmfx_torch.distributed import parse_mesh_spec

                    r_sh, f_sh, s_sh = parse_mesh_spec(spec)
                    cm = costmodel.comm_model(
                        alg, m, n, kmax, restart_shards=r_sh,
                        feature_shards=f_sh, sample_shards=s_sh,
                        restarts=int(meta["restarts"]))
                    inputs["comm_bytes_per_iter"] = \
                        cm["wire_bytes_per_iter"]
        except Exception:  # pricing is an
            pass           # annotation; a model gap must never make a
        #                    request unroutable
        return candidates, routable, inputs

    def _place(self, pending: _Pending):
        """Pick the target replica: cost-priced capability-class
        selection first (``RouterConfig.price_placement``), then
        content-sticky by rendezvous hash WITHIN the class, yielding
        to least-loaded when the sticky choice is more than
        ``stickiness_slack`` outstanding requests busier."""
        routable = self.pool.routable()
        candidates = [rep for rep in routable
                      if rep.replica_id not in pending.exclude]
        if not candidates:
            raise NoRoutableReplicas(
                "no routable replica"
                + (f" outside {sorted(pending.exclude)}"
                   if pending.exclude else ""))
        inputs = None
        if self.cfg.price_placement:
            candidates, routable, inputs = self._price_placement(
                pending, candidates, routable)
        with self._lock:
            loads = {rep.replica_id:
                     self._outstanding.get(rep.replica_id, 0)
                     for rep in candidates}
        min_load = min(loads.values())
        ranked = sorted(candidates, reverse=True,
                        key=lambda rep: self._hrw(pending.chash,
                                                  rep.replica_id))
        # the sticky flag reports cache affinity, so it is judged
        # against the FULL routable set: a failover retry that lands
        # off the (excluded) preferred replica must read sticky=False
        # — it landed on a cold replica
        sticky_id = max((rep.replica_id for rep in routable),
                        key=lambda rid: self._hrw(pending.chash, rid))
        # the loop always returns: walking the rendezvous ranking, the
        # first replica within `stickiness_slack` of the least-loaded
        # wins, and the least-loaded replica itself always qualifies
        for rep in ranked:
            if loads[rep.replica_id] \
                    <= min_load + self.cfg.stickiness_slack:
                st = pending.future.stats
                st.sticky = rep.replica_id == sticky_id
                klass = self._capability_class(rep)
                st.placement_class = klass
                if inputs is not None:
                    inputs["queue_depth"] = loads[rep.replica_id]
                    st.placement_inputs = inputs
                _placement_total.inc(**{"class": str(klass)})
                return rep
        raise AssertionError("unreachable: the min-load candidate "
                             "always satisfies the slack bound")

    # -- forwarding --------------------------------------------------------
    def _forward(self, pending: _Pending) -> None:
        from nmfx_torch import faults

        rep = self._place(pending)
        with self._lock:
            # an ATTEMPT is counted when tried, not when it succeeds —
            # a forward failing before it reaches the replica (the
            # armed router.forward site) must still burn one retry, or
            # a persistently failing path could loop forever
            pending.attempts += 1
        pending.future.stats.attempts = pending.attempts
        try:
            faults.inject("router.forward")
            inner = rep.forward(pending.rid, pending.a, pending.meta)
        except BaseException as e:  # routed
            # to _schedule_retry, which re-forwards on another replica
            # or resolves the Future with a typed ForwardFailed
            self._schedule_retry(pending, e,
                                 failed_replica=rep.replica_id)
            return
        now = time.monotonic()
        with self._lock:
            pending.replica_id = rep.replica_id
            pending.inner = inner
            pending.forwarded_at = now
            pending.retry_due = None
            self._outstanding[rep.replica_id] = \
                self._outstanding.get(rep.replica_id, 0) + 1
        st = pending.future.stats
        st.replica = rep.replica_id
        st.attempts = pending.attempts
        _forwards_total.inc(replica=rep.replica_id)
        _flight.record("router.forward", request_id=pending.rid,
                       replica=rep.replica_id,
                       attempt=pending.attempts)
        inner.add_done_callback(
            lambda f, rid=pending.rid, inner_ref=inner:
            self._on_inner_done(rid, inner_ref))

    def _unassign_locked(self, pending: _Pending) -> None:
        if pending.replica_id is not None:
            n = self._outstanding.get(pending.replica_id, 1)
            self._outstanding[pending.replica_id] = max(n - 1, 0)
        pending.replica_id = None
        pending.inner = None

    def _schedule_retry(self, pending: _Pending, cause: BaseException,
                        failed_replica: "str | None" = None) -> None:
        """Book a failed forward and either queue a backoff re-forward
        on another replica or exhaust into a typed failure."""
        cause_name = cause.__class__.__name__
        with self._lock:
            if failed_replica is not None:
                pending.exclude.add(failed_replica)
            self._unassign_locked(pending)
            exhausted = pending.attempts > self.cfg.forward_retries
            if not exhausted:
                delay = (self.cfg.retry_backoff_s
                         * 2 ** max(pending.attempts - 1, 0))
                pending.retry_due = time.monotonic() + delay
                pending.retry_cause = cause
                heapq.heappush(self._retryq,
                               (pending.retry_due, pending.rid))
                self.counters["retried"] += 1
        pending.future.stats.retried.append(cause_name)
        _retries_total.inc(cause=cause_name)
        _flight.record("router.retry", request_id=pending.rid,
                       cause=cause_name, attempt=pending.attempts,
                       exhausted=exhausted)
        if exhausted:
            err = ForwardFailed(
                f"every forward attempt failed ({pending.attempts} "
                f"placement(s), {self.cfg.forward_retries} re-forwards "
                "allowed)")
            err.__cause__ = cause
            self._resolve(pending, error=err)
        else:
            self._wake.set()

    def _on_inner_done(self, rid: str, inner: Future) -> None:
        with self._lock:
            pending = self._pending.get(rid)
            if pending is None or pending.inner is not inner:
                # a late duplicate (stale forward after a re-place or
                # after resolution) — the dedup half of at-most-once
                self.counters["duplicates"] += 1
                return
        if inner.cancelled():
            return  # the router cancelled it (timeout/deadline);
            # the canceller booked the follow-up
        exc = inner.exception()
        if exc is None:
            self._resolve(pending, result=inner.result())
            return
        if isinstance(exc, _RETRYABLE):
            spill_path = getattr(exc, "spill_path", None)
            if spill_path is not None:
                self._consume_spill(pending, spill_path)
            self._schedule_retry(pending, exc,
                                 failed_replica=pending.replica_id)
            return
        self._resolve(pending, error=exc)

    def _consume_spill(self, pending: _Pending, path: str) -> None:
        """A drained replica spilled this request; the router owns the
        payload in memory, so claim the record and consume it — the
        re-forward is the re-admission (counted as one), and no other
        consumer can double-readmit it."""
        from nmfx_torch.serve import claim_spill, release_spill_claim

        if claim_spill(path, f"router-{os.getpid()}"):
            try:
                os.unlink(path)
            except OSError:  # already gone
                pass
            release_spill_claim(path)
            with self._lock:
                self.counters["readmitted"] += 1
            _readmits_total.inc()
            _flight.record("router.readmit", request_id=pending.rid,
                           source=path)

    def _release_coalesced_locked(self,
                                  pending: _Pending) -> "list[_Pending]":
        """Pop this leader's coalesce registration and return its
        still-pending followers. Caller holds the router lock. An
        identical submit arriving after the pop becomes the key's new
        leader — attach-after-pop never strands a request."""
        if pending.ckey is None \
                or self._coalesce.get(pending.ckey) is not pending:
            return []
        del self._coalesce[pending.ckey]
        rids = self._cofollowers.pop(pending.ckey, [])
        return [self._pending[r] for r in rids if r in self._pending]

    def _resolve(self, pending: _Pending, result=None,
                 error: "BaseException | None" = None) -> None:
        now = time.monotonic()
        with self._lock:
            if pending.rid not in self._pending:
                self.counters["duplicates"] += 1
                return
            del self._pending[pending.rid]
            self._unassign_locked(pending)
            followers = self._release_coalesced_locked(pending)
            _outstanding_gauge.set(len(self._pending))
            self.counters["completed" if error is None
                          else "failed"] += 1
        if error is None and result is not None \
                and self.result_cache is not None \
                and pending.ckey_parts is not None:
            # re-key a degraded answer at its ACTUAL served quality —
            # a sketched result must never be replayed to
            # exact-quality submissions
            chash, shape, dt, scfg, ccfg, icfg, quality = \
                pending.ckey_parts
            try:
                key = pending.ckey
                if result.quality != quality or key is None:
                    key = self._key(chash, shape, dt, scfg, ccfg, icfg,
                                    result.quality)
                self.result_cache.put(key, result)
            except Exception:  # cache trouble
                # must never fail a solved request
                pass
        pending.future.stats.latency_s = now - pending.submitted
        fut = pending.future
        self._fanout(pending, followers, result, error)
        if fut.done():
            return
        fut.set_running_or_notify_cancel()
        if fut.done():
            return
        from nmfx_torch.serve import DeadlineExceeded

        if error is None:
            outcome = "completed"
            fut.set_result(result)
        else:
            outcome = ("deadline"
                       if isinstance(error, DeadlineExceeded)
                       else "failed")
            fut.set_exception(error)
        _router_e2e_hist.observe(pending.future.stats.latency_s,
                                 outcome=outcome)

    def _fanout(self, leader: _Pending, followers: "list[_Pending]",
                result, error: "BaseException | None") -> None:
        """Share the leader's outcome with its coalesced followers —
        through the ordinary `_resolve` path, so per-follower counters,
        latency spans, and the outstanding gauge stay exact. Followers
        have ``ckey=None``, so the recursion is one level deep."""
        if not followers:
            return
        _flight.record("router.coalesce_fanout", leader=leader.rid,
                       followers=len(followers),
                       outcome="error" if error is not None
                       else "result")
        for f in followers:
            self._resolve(f, result=result, error=error)

    def _abort_leader(self, pending: _Pending,
                      err: BaseException) -> None:
        """Unwind a submission whose INITIAL placement raised
        synchronously (`submit` re-raises to the caller): un-admit it
        and fail any followers that attached while `_forward` ran."""
        with self._lock:
            dropped = self._pending.pop(pending.rid, None)
            if dropped is not None:
                self._unassign_locked(pending)
                self.counters["submitted"] -= 1
            followers = self._release_coalesced_locked(pending)
            _outstanding_gauge.set(len(self._pending))
        self._fanout(pending, followers, None, err)

    # -- maintenance -------------------------------------------------------
    def _run_maintenance(self) -> None:
        while True:
            self._wake.wait(self.cfg.health_interval_s)
            self._wake.clear()
            with self._lock:
                closed = self._closed
                n_pending = len(self._pending)
            if closed and n_pending == 0:
                return
            try:
                self.pool.poll()
                self._dispatch_due_retries()
                self._check_deadlines_and_timeouts()
                self._check_health()
                self._check_slo()
                if self.cfg.autoscale and not closed:
                    self.autoscale_tick()
            except Exception as e:  # the loop
                # must survive; warn-once + flight keep it loud
                from nmfx_torch.faults import warn_once

                warn_once("router-maintenance-error",
                          f"router maintenance iteration failed "
                          f"({e!r}); continuing")

    def _dispatch_due_retries(self) -> None:
        now = time.monotonic()
        due = []
        with self._lock:
            while self._retryq and self._retryq[0][0] <= now:
                _, rid = heapq.heappop(self._retryq)
                pending = self._pending.get(rid)
                if pending is not None and pending.retry_due is not None:
                    pending.retry_due = None
                    due.append(pending)
        for pending in due:
            try:
                self._forward(pending)
            except NoRoutableReplicas as e:
                cause = pending.retry_cause or e
                err = NoRoutableReplicas(
                    "no routable replica left to re-forward to")
                err.__cause__ = cause
                self._resolve(pending, error=err)

    def _check_deadlines_and_timeouts(self) -> None:
        from nmfx_torch.serve import DeadlineExceeded

        now = time.monotonic()
        with self._lock:
            snapshot = list(self._pending.values())
        for pending in snapshot:
            if pending.deadline is not None and now >= pending.deadline:
                inner = pending.inner
                if inner is not None:
                    inner.cancel()  # best-effort; a completed solve's
                    # late result is discarded by dedup
                self._resolve(pending, error=DeadlineExceeded(
                    "deadline expired at the router after "
                    f"{now - pending.submitted:.3f}s"))
                continue
            if (self.cfg.forward_timeout_s is not None
                    and pending.inner is not None
                    and pending.retry_due is None
                    and now - pending.forwarded_at
                    > self.cfg.forward_timeout_s):
                self._try_timeout_retry(pending)

    def _try_timeout_retry(self, pending: _Pending) -> None:
        """Forward timeout: re-place ONLY when the original provably
        never dispatched (thread: future still cancellable; process:
        the inbox record is still claimable by us). Otherwise keep
        waiting — at-most-once dispatch beats tail latency."""
        from nmfx_torch.replica import ProcessReplica
        from nmfx_torch.serve import claim_spill, release_spill_claim

        rep = self.pool.get(pending.replica_id)
        undispatched = False
        if rep is None:
            undispatched = True
        elif isinstance(rep, ProcessReplica):
            record = os.path.join(rep.inbox,
                                  f"spill_{pending.rid}.npz")
            if claim_spill(record, f"router-{os.getpid()}"):
                if os.path.exists(record):
                    # the worker never claimed it — safe to move
                    try:
                        os.unlink(record)
                    except OSError:  # raced
                        pass
                    rep.forget(pending.rid)
                    undispatched = True
                # else: the record was already consumed (result
                # imminent or landed) — the claim was created against
                # nothing; drop it and keep waiting
                release_spill_claim(record)
        else:
            inner = pending.inner
            undispatched = inner is not None and inner.cancel()
        if undispatched:
            self._schedule_retry(
                pending,
                TimeoutError(f"forward timed out after "
                             f"{self.cfg.forward_timeout_s}s"),
                failed_replica=pending.replica_id)

    def _check_health(self) -> None:
        hb = self.pool.heartbeats(self.cfg.stale_after_s)
        now = time.monotonic()
        for rep in self.pool.all():
            if rep.state == "draining":
                if rep.kind != "process":
                    continue
                if not rep.alive():
                    # a SIGTERM'd worker exited: reclaim whatever it
                    # released (spill-migration's second half)
                    self._recover(rep)
                elif now - getattr(rep, "drained_at", now) \
                        > self.cfg.drain_kill_after_s:
                    # SIGTERM→SIGKILL escalation: an alive-but-wedged
                    # worker (stuck syscall, ignored signal) would
                    # otherwise hold its claimed records — and every
                    # request queued on it — forever
                    _flight.record("router.drain_escalated",
                                   replica=rep.replica_id)
                    rep.kill()
                continue
            if rep.state != "routable":
                continue
            if not rep.alive():
                self._recover(rep)
                continue
            payload = hb.get(rep.replica_id)
            if payload is None:
                # no heartbeat YET: a worker still importing its
                # runtime — grace-gated, while a dead process was
                # already caught by the alive() check above
                if now - rep.spawned_at > self.cfg.spawn_grace_s:
                    self._drain_async(rep.replica_id)
            elif payload.get("stale"):
                self._drain_async(rep.replica_id)

    # -- drain / recovery --------------------------------------------------
    def _drain_async(self, replica_id: str) -> None:
        """The maintenance loop's drain entry: claim the replica (state
        flip under the router lock, so racing health ticks drain once)
        and run the drain on its own short-lived thread — a thread
        replica's drain waits for its in-flight solves, and blocking
        the single maintenance thread on that would stall deadline
        enforcement, retries, and outbox polling fleet-wide."""
        if not self._claim_drain(replica_id):
            return
        threading.Thread(
            target=self._drain_claimed, args=(replica_id,),
            daemon=True, name=f"nmfx-router-drain-{replica_id}").start()

    def _claim_drain(self, replica_id: str) -> bool:
        rep = self.pool.get(replica_id)
        with self._lock:
            if rep is None or rep.state != "routable":
                return False
            rep.state = "draining"
            rep.drained_at = time.monotonic()
            self.counters["drained"] += 1
        return True

    def drain_replica(self, replica_id: str) -> None:
        """Stale ⇒ drain: mark unroutable, let in-flight work finish,
        and land its queued requests elsewhere — thread replicas spill
        through ``close(cancel_pending=True)`` (each ``ServerClosed``'s
        ``spill_path`` is claimed and the request re-forwarded),
        process replicas get SIGTERM (the worker releases queued
        claims; recovery reclaims them when the process exits; one
        that ignores the SIGTERM is SIGKILLed after
        ``drain_kill_after_s``). Synchronous — callers who must not
        block (the maintenance loop) go through the async wrapper."""
        if not self._claim_drain(replica_id):
            return
        self._drain_claimed(replica_id)

    def _drain_claimed(self, replica_id: str) -> None:
        from nmfx_torch.faults import warn_once

        rep = self.pool.get(replica_id)
        if rep is None:
            return
        _flight.record("router.drain", replica=replica_id)
        warn_once(
            "router-drain",
            f"replica {replica_id} drained (stale heartbeat or "
            "scale-down); its queued requests are being readmitted on "
            "the surviving replicas")
        rep.drain()  # thread: synchronous spill; process: SIGTERM
        if rep.kind == "thread":
            self.pool.remove(replica_id)

    def _recover(self, rep) -> None:
        """A replica died (process gone / server down): reclaim its
        unfinished inbox records (breaking the dead owner's claims) and
        re-place every request the router still owes an answer for."""
        from nmfx_torch.serve import (break_spill_claim, claim_spill,
                                list_spills, release_spill_claim,
                                spill_claimant)

        rep.state = "dead"
        dead_pid = getattr(rep, "pid", None)
        reclaimed = 0
        rep.poll()  # consume any results that DID land before death
        with self._lock:
            mine = [p for p in self._pending.values()
                    if p.replica_id == rep.replica_id
                    and p.retry_due is None]
        spill_dir = getattr(rep, "spill_dir", None)
        if spill_dir is not None:
            for path in list_spills(spill_dir):
                claim = spill_claimant(path)
                if claim is not None and not break_spill_claim(
                        path, owner_pid=dead_pid,
                        older_than_s=self.cfg.break_claims_after_s):
                    continue
                if not claim_spill(path, f"router-{os.getpid()}"):
                    continue
                try:
                    os.unlink(path)
                except OSError:  # raced
                    pass
                release_spill_claim(path)
                reclaimed += 1
        for pending in mine:
            self._schedule_retry(
                pending,
                ServerCrashed(f"replica {rep.replica_id} died with "
                              "this request outstanding"),
                failed_replica=rep.replica_id)
        with self._lock:
            self.counters["recovered"] += 1
            self.counters["readmitted"] += len(mine)
        if mine:
            _readmits_total.inc(len(mine))
        _flight.record("router.recover", replica=rep.replica_id,
                       readmitted=len(mine), records_reclaimed=reclaimed)
        rep.retire()  # stop side threads (a crashed thread replica's
        # beater must not keep publishing a phantom live heartbeat)
        self.pool.remove(rep.replica_id)

    # -- SLO shedding ------------------------------------------------------
    def _check_slo(self) -> None:
        if not (self.cfg.shed_on_burn or self.cfg.autoscale):
            return
        now = time.monotonic()
        if now - self._last_slo < self.cfg.slo_interval_s:
            return
        self._last_slo = now
        try:
            status = self._slo.evaluate()
        except Exception as e:  # a broken
            # burn signal degrades to no shedding, warn-once'd
            from nmfx_torch.faults import warn_once

            warn_once("router-slo-error",
                      f"SLO evaluation failed ({e!r}); the router "
                      "stops shedding until it recovers")
            status = None
        burning = []
        if status is not None:
            for name in self.cfg.shed_objectives:
                obj = status["objectives"].get(name)
                if obj is not None and obj["state"] == "fast_burn":
                    burning.append(name)
        with self._lock:
            was = self._burning
            self._burning = burning
        if burning and not was:
            _flight.record("router.shed_signal", objectives=burning)

    # -- elasticity --------------------------------------------------------
    def scale_up(self):
        """Spawn one replica against the warm cache; a failed spawn
        (the ``replica.spawn`` chaos site) degrades warn-once — the
        fleet keeps serving at its current size."""
        from nmfx_torch.faults import warn_once
        from nmfx_torch.replica import SpawnFailed

        try:
            return self.pool.spawn()
        except SpawnFailed as e:
            warn_once("router-spawn-failed",
                      f"replica scale-up failed ({e}); continuing "
                      "with the current fleet")
            _flight.record("router.spawn_failed", error=e)
            return None

    def scale_down(self, replica_id: "str | None" = None, *,
                   wait: bool = True) -> bool:
        """Drain one replica (least-loaded by default) via
        spill-migration; refuses below ``min_replicas``.
        ``wait=False`` runs the drain on its own thread — the
        autoscaler's form, so a long in-flight solve on the draining
        replica cannot stall the maintenance loop."""
        routable = self.pool.routable()
        if len(routable) <= self.cfg.min_replicas:
            return False
        if replica_id is None:
            with self._lock:
                loads = {rep.replica_id:
                         self._outstanding.get(rep.replica_id, 0)
                         for rep in routable}
            replica_id = min(loads, key=loads.get)
        if wait:
            self.drain_replica(replica_id)
        else:
            self._drain_async(replica_id)
        return True

    def autoscale_tick(self) -> None:
        """One autoscale decision (called by the maintenance loop under
        ``RouterConfig.autoscale``; callable directly for deterministic
        tests): scale up on burn or deep mean outstanding, scale down
        after a sustained idle streak."""
        routable = self.pool.routable()
        n = len(routable)
        with self._lock:
            total = len(self._pending)
            burning = bool(self._burning)
        now = time.monotonic()
        if total > 0:
            self._idle_since = None
        elif self._idle_since is None:
            self._idle_since = now
        if n < self.cfg.max_replicas and (
                burning
                or total >= self.cfg.scale_up_outstanding * max(n, 1)):
            self.scale_up()
        elif (n > self.cfg.min_replicas and total == 0
                and self._idle_since is not None
                and now - self._idle_since
                >= self.cfg.scale_down_idle_s):
            self._idle_since = now  # one drain per idle period
            self.scale_down(wait=False)  # never stall the maintenance
            # loop on a drain (it owns deadlines/retries/polling)

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            c = dict(self.counters)
            c.update(outstanding=len(self._pending),
                     outstanding_per_replica=dict(self._outstanding),
                     routable_replicas=len(self.pool.routable()),
                     burning=list(self._burning))
        return c

    def slo_status(self, evaluate: bool = False) -> "dict | None":
        """The router SLO engine's most recent evaluation — None until
        something evaluated (the maintenance loop only does under
        ``shed_on_burn``/``autoscale``). ``evaluate=True`` forces a
        fresh evaluation first (the CLI's ``--slo`` report path)."""
        if evaluate:
            return self._slo.evaluate()
        return self._slo.status()
