"""Replica pool: N serving replicas behind one router front door
(counterpart of ``nmfx/replica.py``).

One ``NMFXServer`` owns one device. A :class:`ReplicaPool` runs N
replicas, each a full ``NMFXServer`` with its own spill directory,
publishing heartbeats (:class:`nmfx_torch.obs.export.HeartbeatLedger`,
``replica_<id>.json`` in the pool root) and queue-depth/inflight levels
(telemetry snapshot ``status``) that the router's health checker and
``nmfx-top`` read. The router half lives in ``nmfx_torch/router.py``.

Two replica kinds, one contract:

* :class:`ThreadReplica` — an in-process ``NMFXServer`` on its own
  scheduler thread. Zero spawn cost, shares the process's input cache,
  and is fully deterministic to drive (pause/resume, fake engines).
  On the card every thread replica serves on the pool's device, named
  with its index (``device.explicit_device``): the current CUDA device
  is per thread, and each server binds its scheduler and harvest
  threads to it.
* :class:`ProcessReplica` — a subprocess worker (``python -m
  nmfx_torch.replica``) with its own interpreter, device and registry.
  The transport is the SPILL RECORD format + claim protocol of
  ``nmfx_torch/serve.py``, which is the reference's: the router
  forwards a request by atomically writing its full submission payload
  into the replica's ``inbox/``; the worker claims it, serves it
  through a normal ``NMFXServer.submit``, and writes the result
  (``ConsensusResult.save``) or a typed error into ``outbox/``. The
  inbox record is removed only AFTER the result lands, so it doubles as
  the write-ahead copy: a replica SIGKILLed mid-queue leaves its
  unfinished records (some under a dead pid's claim) for the router to
  claim back and readmit on survivors — byte-equal to the original
  submission, because re-admission goes through the one
  ``spill_submit_kwargs`` funnel every consumer shares. Since the
  records and results keep the reference's format, a worker of either
  package serves a router of either package.

Worker startup: a worker is a fresh interpreter (``subprocess.Popen``),
never a fork of a process that may already hold a CUDA context. The
pool builds the hand-written kernels and the host library before it
spawns one (:func:`_prebuild`); workers then load the cached ``.so``
files, which the build functions write atomically. The worker takes
``--device`` (default: the card; ``cpu`` for the plain versions): a
pool passes it through ``worker_args``. A worker that cannot open its
device exits, and the router's recovery resolves its requests typed.

Directory layout of one pool root::

    <root>/replica_<id>.json     heartbeats (HeartbeatLedger)
    <root>/<id>/inbox/           spill-format requests (+ .claim)
    <root>/<id>/outbox/          result_<rid>.npz | error_<rid>.json
    <root>/<id>/spill/           the replica server's own spill_dir
                                 (thread replicas: drain spills land
                                 here for the router to claim)

Mesh replicas (``mesh_specs``; the worker's ``--mesh-spec``) make the
fleet heterogeneous: a meshed member serves through
``serve.MeshEngine`` and its heartbeat carries its spec and device
count, which the router prices placement by. A thread member's mesh is
carved from the pool's device list, contiguous blocks in spawn order;
that list may name a card more than once, as ``device.Mesh`` does, so a
"1x2" replica and a plain one fit on one card (they then share it).

``cache_dir`` (the worker's ``--cache-dir``) is the directory the
reference's workers start their executable cache against; here it holds
the kernel-schedule autotuner's store (``ExecCacheConfig.cache_dir``),
and no executable is serialized there (a built torch sweep has no
serialized form; ROADMAP §1 item 6).
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np

from nmfx_torch.guards import guarded_by
from nmfx_torch.obs import flight as _flight
from nmfx_torch.obs import metrics as _metrics

__all__ = ["ProcessReplica", "ReplicaError", "ReplicaPool",
           "SpawnFailed", "ThreadReplica", "worker_main"]

#: heartbeat filenames in the pool root (HeartbeatLedger prefix)
HEARTBEAT_PREFIX = "replica_"

#: outbox filenames
RESULT_PREFIX = "result_"
ERROR_PREFIX = "error_"

_replicas_gauge = _metrics.gauge(
    "nmfx_replica_pool_size",
    "replicas in this process's pool, by lifecycle state",
    labelnames=("state",))


class ReplicaError(RuntimeError):
    """Base class of replica-tier failures."""


class SpawnFailed(ReplicaError):
    """Replica scale-up failed (the ``replica.spawn`` chaos site, an
    exec failure, ...). The pool keeps serving at its current size —
    a failed spawn is a degradation, never an outage."""


def _spec_devices(mesh_spec: "str | None") -> int:
    """The device entries a mesh spec needs (1 for a plain replica)."""
    if mesh_spec is None:
        return 1
    from nmfx_torch.distributed import parse_mesh_spec

    r, f, s = parse_mesh_spec(mesh_spec)
    return r * f * s


def _prebuild() -> None:
    """Build the host library, and the kernels when a card is present,
    in the parent before a worker starts: workers then only load the
    cached libraries (the build functions write them atomically, so a worker
    can never load a half-written one)."""
    import torch

    from nmfx_torch import native

    native.build()
    if torch.cuda.is_available():
        from nmfx_torch.ops import _build

        _build.build()


def _rid_of(path: str) -> str:
    """The request id a spill/result/error filename embeds."""
    name = os.path.basename(path)
    for prefix in ("spill_", RESULT_PREFIX, ERROR_PREFIX):
        if name.startswith(prefix):
            name = name[len(prefix):]
            break
    for suffix in (".npz", ".json"):
        if name.endswith(suffix):
            name = name[:-len(suffix)]
    return name


class _Beater:
    """Daemon thread writing one instance's heartbeats into the pool
    ledger every ``interval_s``. The ``replica.heartbeat`` chaos site
    fires HERE: an armed site skips the write (the frozen-publisher
    rehearsal — the instance keeps serving but its heartbeat ages, and
    the router's health checker drains it)."""

    def __init__(self, ledger, instance: str, status_fn,
                 interval_s: float):
        self.ledger = ledger
        self.instance = instance
        self.status_fn = status_fn
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None

    def beat_once(self) -> "str | None":
        from nmfx_torch import faults

        try:
            faults.inject("replica.heartbeat")
        except faults.FaultInjected:
            # the frozen publisher: the fire is on the flight recorder,
            # the heartbeat file simply does not advance — exactly what
            # a wedged writer looks like from the outside
            return None
        return self.ledger.beat(self.instance, **self.status_fn())

    def _run(self) -> None:
        while not self._stop.is_set():
            self.beat_once()
            self._stop.wait(self.interval_s)

    def launch(self) -> "_Beater":
        if self._thread is None:
            self.beat_once()  # a replica is visible the moment it exists
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"nmfx-replica-hb-{self.instance}")
            self._thread.start()
        return self

    def close(self, final_status: "dict | None" = None) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        if final_status is not None:
            # final beat OUTSIDE the chaos site: a clean shutdown
            # always leaves its terminal state in the ledger
            self.ledger.beat(self.instance, **final_status)


class ThreadReplica:
    """One in-process replica: a full ``NMFXServer`` (role="replica")
    plus a heartbeat beater. The router forwards by direct
    ``submit()``. ``device`` is the card the replica's own engine serves
    on (None = CUDA, raising without one; "cpu" for the plain versions);
    an explicit ``engine`` or ``exec_cache`` owns its device instead.
    ``mesh_spec`` (or the ``serve_cfg``'s) makes it a mesh replica,
    built over ``devices`` (its carved block) when given."""

    kind = "thread"

    def __init__(self, replica_id: str, root: str, ledger, *,
                 serve_cfg=None, engine=None, exec_cache=None,
                 mesh_spec: "str | None" = None, device=None,
                 devices=None, profiler=None,
                 telemetry_dir: "str | None" = None,
                 heartbeat_interval_s: float = 0.5):
        import dataclasses

        from nmfx_torch.serve import MeshEngine, NMFXServer, ServeConfig

        self.replica_id = replica_id
        self.root = root
        self.spawned_at = time.monotonic()
        self.spill_dir = os.path.join(root, "spill")
        os.makedirs(self.spill_dir, exist_ok=True)
        self.state = "routable"
        cfg = serve_cfg if serve_cfg is not None else ServeConfig()
        if mesh_spec is None:
            mesh_spec = cfg.mesh_spec
        self.mesh_spec = mesh_spec
        self.n_devices = _spec_devices(mesh_spec)
        cfg = dataclasses.replace(
            cfg, role="replica", instance=replica_id,
            spill_dir=self.spill_dir, mesh_spec=mesh_spec,
            telemetry_dir=(telemetry_dir if cfg.telemetry_dir is None
                           else cfg.telemetry_dir))
        if engine is None and mesh_spec is not None:
            # the mesh over exactly this replica's entries: its carved
            # block, else its device named once an entry
            engine = MeshEngine(mesh_spec, devices=(
                devices if devices is not None else device),
                profiler=profiler)
        own_device = engine is None and exec_cache is None
        self.server = NMFXServer(
            cfg, engine=engine,
            exec_cache=None if engine is not None else exec_cache,
            profiler=profiler, device=device if own_device else None)
        self._beater = _Beater(ledger, replica_id, self._status,
                               heartbeat_interval_s).launch()

    def _status(self) -> dict:
        s = self.server.stats()
        return {"role": "replica", "kind": self.kind,
                "state": self.state, "queue_depth": s["queued"],
                "inflight": s["inflight"],
                "mesh": self.mesh_spec, "devices": self.n_devices}

    def forward(self, rid: str, a: np.ndarray, meta: dict) -> Future:
        """Submit one spill-format payload to this replica's server;
        the returned future is the server's own (the router chains
        it)."""
        from nmfx_torch.serve import spill_dataset, spill_submit_kwargs

        return self.server.submit(spill_dataset(a, meta),
                                  **spill_submit_kwargs(meta))

    def alive(self) -> bool:
        return self.server._down is None and not self.server._closed

    def drain(self) -> None:
        """Stop serving: fail queued requests through the spill path
        (each ``ServerClosed`` carries its ``spill_path``; the router
        claims the records and readmits on survivors), let in-flight
        work finish, then stop — beater included, so the drained
        replica's heartbeat AGES into staleness instead of a leaked
        thread publishing a phantom live instance forever. Idempotent."""
        self.state = "draining"
        self.server.close(cancel_pending=True)
        self.state = "dead"
        self._beater.close(final_status=self._status())

    def retire(self) -> None:
        """Stop this replica's side threads without a drain — the
        router's recovery path for a crashed replica (the server is
        already down; only the beater must not outlive the pool
        membership)."""
        self._beater.close(final_status=self._status())

    def close(self) -> None:
        if self.state == "routable":
            self.state = "draining"
            self.server.close()
            self.state = "dead"
        self._beater.close(final_status=self._status())

    def poll(self) -> None:
        """Nothing to poll — thread replicas resolve their futures
        directly (uniform surface with :class:`ProcessReplica`)."""


@guarded_by("_lock", "_pending", "_read_failures")
class ProcessReplica:
    """One subprocess replica: the worker (``python -m
    nmfx_torch.replica``) serves spill-format requests from its
    ``inbox/`` and writes results into ``outbox/``; this handle writes
    forwards, polls the outbox, and owns the child's lifecycle."""

    kind = "process"

    def __init__(self, replica_id: str, root: str, ledger, *,
                 cache_dir: "str | None" = None,
                 telemetry_dir: "str | None" = None,
                 mesh_spec: "str | None" = None,
                 heartbeat_interval_s: float = 0.5,
                 poll_interval_s: float = 0.05,
                 worker_args: "tuple[str, ...]" = (),
                 env: "dict | None" = None):
        self.replica_id = replica_id
        self.root = root
        self.spawned_at = time.monotonic()
        self.mesh_spec = mesh_spec
        self.n_devices = _spec_devices(mesh_spec)
        self.inbox = os.path.join(root, "inbox")
        self.outbox = os.path.join(root, "outbox")
        #: for a process replica the INBOX is the spill dir the router
        #: recovers from — unfinished records simply stay there
        self.spill_dir = self.inbox
        os.makedirs(self.inbox, exist_ok=True)
        os.makedirs(self.outbox, exist_ok=True)
        self.state = "routable"
        self.ledger = ledger
        #: router-side pending: rid -> (future, inbox record path)
        self._pending: "dict[str, tuple[Future, str]]" = {}
        #: transient outbox read failures per rid (retried next poll)
        self._read_failures: "dict[str, int]" = {}
        self._lock = threading.Lock()
        cmd = [sys.executable, "-m", "nmfx_torch.replica",
               "--dir", root, "--id", replica_id,
               "--pool-dir", ledger.directory,
               "--heartbeat-interval", str(heartbeat_interval_s),
               "--poll-interval", str(poll_interval_s)]
        if cache_dir is not None:
            cmd += ["--cache-dir", cache_dir]
        if telemetry_dir is not None:
            cmd += ["--telemetry-dir", telemetry_dir]
        if mesh_spec is not None:
            cmd += ["--mesh-spec", mesh_spec]
        cmd += list(worker_args)
        self.process = subprocess.Popen(
            cmd, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL
            if os.environ.get("NMFX_REPLICA_WORKER_STDERR") is None
            else None)

    @property
    def pid(self) -> int:
        return self.process.pid

    def forward(self, rid: str, a: np.ndarray, meta: dict) -> Future:
        """Atomically write the request into the worker's inbox (the
        write IS the forward — and the write-ahead copy recovery
        claims back if the worker dies); returns the future the outbox
        poller resolves."""
        from nmfx_torch.serve import write_spill_record

        fut: Future = Future()
        path = os.path.join(self.inbox, f"spill_{rid}.npz")
        with self._lock:
            self._pending[rid] = (fut, path)
        try:
            write_spill_record(path, a, meta)
        except Exception:
            with self._lock:
                self._pending.pop(rid, None)
            raise
        return fut

    def alive(self) -> bool:
        return self.process.poll() is None

    def poll(self) -> None:
        """Resolve pending futures from the worker's outbox (results
        load byte-equal through ``ConsensusResult.load``; errors come
        back typed by name). Removes consumed outbox files."""
        try:
            names = os.listdir(self.outbox)
        except OSError:
            return
        for name in sorted(names):
            if name.startswith(RESULT_PREFIX) and name.endswith(".npz"):
                self._finish(name, error=False)
            elif name.startswith(ERROR_PREFIX) and name.endswith(".json"):
                self._finish(name, error=True)

    def _finish(self, name: str, error: bool) -> None:
        from nmfx_torch.faults import warn_once

        rid = _rid_of(name)
        with self._lock:
            entry = self._pending.pop(rid, None)
        path = os.path.join(self.outbox, name)
        if entry is None:
            # a result for a request this router no longer owns (a
            # duplicate after failover, or another router's) — the
            # dedup half of at-most-once delivery: consume and drop
            try:
                os.unlink(path)
            except OSError:  # raced consumer
                pass
            return
        fut, record = entry
        try:
            if error:
                with open(path) as f:
                    payload = json.load(f)
                exc = _typed_error(payload)
                if not fut.done():
                    fut.set_exception(exc)
            else:
                from nmfx_torch.api import ConsensusResult

                result = ConsensusResult.load(path)
                if not fut.done():
                    fut.set_result(result)
        except Exception as e:
            # a transiently unreadable outbox file: put the request BACK
            # in pending and leave both files in place — the next poll
            # retries the read. Only a PERSISTENTLY unreadable file
            # (several consecutive polls) fails the future typed;
            # destroying an intact result over one transient read error
            # would lose completed work
            with self._lock:
                n = self._read_failures.get(rid, 0) + 1
                self._read_failures[rid] = n
                if n < 5:
                    self._pending[rid] = (fut, record)
            if n < 5:
                return
            warn_once("replica-outbox-torn",
                      f"outbox file {path!r} unreadable on {n} "
                      f"consecutive polls ({e!r}); failing the "
                      "request typed rather than hanging")
            if not fut.done():
                fut.set_exception(ReplicaError(
                    f"replica {self.replica_id}: unreadable result "
                    f"for request {rid} ({e!r})"))
        with self._lock:
            self._read_failures.pop(rid, None)
        for p in (path, record):
            try:
                os.unlink(p)
            except OSError:  # already gone (the worker removed the
                pass         # record first)

    def pending(self) -> "dict[str, tuple[Future, str]]":
        with self._lock:
            return dict(self._pending)

    def forget(self, rid: str) -> None:
        with self._lock:
            self._pending.pop(rid, None)

    def drain(self) -> None:
        """Graceful scale-down: SIGTERM — the worker stops claiming,
        lets in-flight work finish (results still land in the outbox),
        and releases the claims of queued records so the router (or a
        survivor) reclaims them."""
        self.state = "draining"
        if self.alive():
            self.process.terminate()

    def retire(self) -> None:
        """Nothing to stop router-side — the worker owns its beater
        and it died (or will die) with the process (uniform surface
        with :class:`ThreadReplica`)."""

    def kill(self) -> None:
        """SIGKILL — the chaos path. The state is left untouched on
        purpose: an externally killed worker looks exactly like this,
        and the router's health checker must DISCOVER the death
        (``alive()`` goes false) and recover — unfinished inbox
        records survive under the dead pid's claims for recovery to
        break."""
        self.process.kill()

    def close(self, timeout: float = 30.0) -> None:
        if self.alive():
            self.process.terminate()
        try:
            self.process.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.process.kill()
            self.process.wait()
        self.state = "dead"


@guarded_by("_lock", "replicas")
class ReplicaPool:
    """N replicas sharing one pool root + heartbeat ledger.

    ``mode="thread"`` builds :class:`ThreadReplica` members on
    ``device`` (None = the card); ``mode="process"`` spawns subprocess
    workers, whose device is their ``--device`` flag — pass it in
    ``worker_args`` (e.g. ``("--device", "cpu")``). ``engine_factory``
    (thread mode) builds each replica's ``nmfx_torch.serve.Engine`` —
    the hook the router tests use to run the whole tier against
    scriptable fakes.

    ``mesh_specs`` makes the fleet heterogeneous: one spec per replica
    (None = a plain 1-device replica). In thread mode each meshed member
    is carved a contiguous block of ``mesh_devices`` (default: this
    process's cards; when the pool serves on the CPU, ``device`` or its
    executable cache's, the CPU named as often as the specs need), which
    may name a card more than once; in process mode the
    spec travels to the worker as ``--mesh-spec``. ``cache_dir`` travels
    to process workers as ``--cache-dir`` (their executable cache's
    directory: the autotuner's store)."""

    def __init__(self, replicas: int = 2, *, root: str,
                 mode: str = "thread", serve_cfg=None,
                 exec_cache=None, engine_factory=None,
                 cache_dir: "str | None" = None,
                 telemetry_dir: "str | None" = None,
                 mesh_specs=None,
                 heartbeat_interval_s: float = 0.5,
                 worker_args: "tuple[str, ...]" = (),
                 env: "dict | None" = None, device=None,
                 mesh_devices=None):
        from nmfx_torch.obs.export import HeartbeatLedger

        if mode not in ("thread", "process"):
            raise ValueError(f"unknown replica mode {mode!r}")
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        if mode == "process" and engine_factory is not None:
            raise ValueError("engine_factory is a thread-mode hook")
        if mesh_specs is not None:
            mesh_specs = tuple(mesh_specs)
            if len(mesh_specs) != replicas:
                raise ValueError(
                    f"mesh_specs has {len(mesh_specs)} entries for "
                    f"{replicas} replicas — pass one spec (or None) "
                    "per replica")
            from nmfx_torch.distributed import parse_mesh_spec

            for spec in mesh_specs:
                if spec is not None:
                    parse_mesh_spec(spec)  # raises MeshSpecError
        if mode == "process" and device is not None:
            raise ValueError(
                "a process replica's device is its worker's --device "
                "flag: pass worker_args=('--device', ...)")
        os.makedirs(root, exist_ok=True)
        self.root = root
        self.mode = mode
        self.serve_cfg = serve_cfg
        self.exec_cache = exec_cache
        self.cache_dir = cache_dir
        self.engine_factory = engine_factory
        self.telemetry_dir = telemetry_dir
        self.heartbeat_interval_s = heartbeat_interval_s
        self.worker_args = tuple(worker_args)
        self.env = env
        self.device = device
        self.mesh_devices = (None if mesh_devices is None
                             else list(mesh_devices))
        self.ledger = HeartbeatLedger(root, prefix=HEARTBEAT_PREFIX)
        self._seq = itertools.count()
        self._lock = threading.Lock()
        #: next unclaimed entry of the device list for thread-mode mesh
        #: carving (plain replicas never advance it)
        self._device_cursor = 0
        self.replicas: "dict[str, object]" = {}
        if mode == "process":
            _prebuild()
        for i in range(replicas):
            self.spawn(mesh_spec=None if mesh_specs is None
                       else mesh_specs[i])

    def _sync_gauge(self) -> None:
        states: "dict[str, int]" = {}
        for rep in self.replicas.values():
            states[rep.state] = states.get(rep.state, 0) + 1
        for state in ("routable", "draining", "dead"):
            _replicas_gauge.set(states.get(state, 0), state=state)

    def _carve_devices(self, mesh_spec: str) -> list:
        """Claim the next contiguous block of the pool's device list for
        one meshed thread replica (the reference carves ``jax.devices()``
        so no two meshed replicas alias a chip; the port's list may name
        a card more than once, and then they share it)."""
        import torch

        need = _spec_devices(mesh_spec)
        devs = self.mesh_devices
        home = (self.device if self.device is not None
                else getattr(self.exec_cache, "device", None))
        if devs is None:
            if home is not None and torch.device(home).type == "cpu":
                devs = ["cpu"] * (self._device_cursor + need)
            else:
                from nmfx_torch.sweep import local_devices

                devs = local_devices()
        with self._lock:
            lo = self._device_cursor
            if lo + need > len(devs):
                raise SpawnFailed(
                    f"mesh_spec {mesh_spec!r} needs {need} devices but "
                    f"only {len(devs) - lo} of {len(devs)} remain "
                    "unclaimed by earlier meshed replicas")
            self._device_cursor = lo + need
        return list(devs[lo:lo + need])

    def spawn(self, mesh_spec: "str | None" = None):
        """Scale-up: one new replica. Passes the ``replica.spawn`` chaos
        site; a failure raises :class:`SpawnFailed` — the caller (the
        router's autoscaler) degrades warn-once and keeps the current
        fleet. ``mesh_spec`` spawns a mesh member (see the class
        docstring)."""
        from nmfx_torch import faults

        rid = f"replica-{os.getpid()}-{next(self._seq)}"
        root = os.path.join(self.root, rid)
        try:
            faults.inject("replica.spawn")
            if self.mode == "thread":
                engine = (self.engine_factory()
                          if self.engine_factory is not None else None)
                devices = None
                if mesh_spec is not None and engine is None:
                    devices = self._carve_devices(mesh_spec)
                rep = ThreadReplica(
                    rid, root, self.ledger, serve_cfg=self.serve_cfg,
                    engine=engine,
                    exec_cache=(None if mesh_spec is not None
                                else self.exec_cache),
                    mesh_spec=mesh_spec, devices=devices,
                    device=self.device,
                    telemetry_dir=self.telemetry_dir,
                    heartbeat_interval_s=self.heartbeat_interval_s)
            else:
                rep = ProcessReplica(
                    rid, root, self.ledger, cache_dir=self.cache_dir,
                    telemetry_dir=self.telemetry_dir,
                    mesh_spec=mesh_spec,
                    heartbeat_interval_s=self.heartbeat_interval_s,
                    worker_args=self.worker_args, env=self.env)
        except faults.FaultInjected as e:
            raise SpawnFailed(f"replica spawn failed: {e}") from e
        except OSError as e:
            raise SpawnFailed(f"replica spawn failed: {e!r}") from e
        with self._lock:
            self.replicas[rid] = rep
            self._sync_gauge()
        _flight.record("replica.spawned", replica=rid, mode=self.mode)
        return rep

    def routable(self) -> list:
        """Replicas the router may place on, in a stable order."""
        with self._lock:
            return [rep for _, rep in sorted(self.replicas.items())
                    if rep.state == "routable"]

    def all(self) -> list:
        """Every pool member, snapshotted under the pool lock — the
        iteration surface for threads racing spawn()/remove()."""
        with self._lock:
            return [rep for _, rep in sorted(self.replicas.items())]

    def get(self, replica_id: str):
        with self._lock:
            return self.replicas.get(replica_id)

    def remove(self, replica_id: str) -> None:
        """Forget a dead/drained replica (its heartbeat file remains,
        aging into staleness — history, like a dead instance's
        counters in the fleet view)."""
        with self._lock:
            self.replicas.pop(replica_id, None)
            self._sync_gauge()

    def heartbeats(self, stale_after_s: "float | None" = None) -> dict:
        """``{replica_id: payload}`` from the shared ledger (with
        ``stale``/``age_s`` when ``stale_after_s`` is given) — what
        the router's health checker reads."""
        return self.ledger.status(stale_after_s)

    def poll(self) -> None:
        for rep in self.all():
            rep.poll()

    def close(self) -> None:
        with self._lock:
            reps = list(self.replicas.values())
        for rep in reps:
            rep.close()
        with self._lock:
            self._sync_gauge()


def _typed_error(payload: dict):
    """Reconstruct a typed exception from a worker's error file —
    known serving/fault types come back as themselves so a caller's
    ``except DeadlineExceeded`` works across the process boundary;
    unknown types wrap in :class:`ReplicaError`."""
    from nmfx_torch import faults as faults_mod
    from nmfx_torch import serve as serve_mod

    name = str(payload.get("type", ""))
    msg = str(payload.get("message", ""))
    for mod in (serve_mod, faults_mod):
        cls = getattr(mod, name, None)
        if isinstance(cls, type) and issubclass(cls, BaseException):
            try:
                return cls(msg)
            except Exception:  # nmfx: ignore[NMFX006] -- falls through
                break  # to the generic wrapper below
    return ReplicaError(f"{name or 'error'}: {msg}")


# --------------------------------------------------------------------------
# the subprocess worker (python -m nmfx_torch.replica)
# --------------------------------------------------------------------------

def _write_error(outbox: str, rid: str, exc: BaseException) -> None:
    path = os.path.join(outbox, f"{ERROR_PREFIX}{rid}.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump({"rid": rid, "type": exc.__class__.__name__,
                       "message": str(exc)}, f)
        os.replace(tmp, path)
    except OSError:  # the router's forward timeout turns a lost error
        pass         # file into a typed failure; never crash the loop


def _write_result(outbox: str, rid: str, result) -> None:
    path = os.path.join(outbox, f"{RESULT_PREFIX}{rid}.npz")
    tmp = os.path.join(outbox, f".tmp_{os.getpid()}_{rid}.npz")
    result.save(tmp)
    os.replace(tmp, path)


def worker_main(argv: "list[str] | None" = None) -> int:
    """The subprocess replica body: claim spill-format requests from
    ``<dir>/inbox``, serve each through a normal ``NMFXServer.submit``
    (results byte-equal to any other admission path — the
    ``spill_submit_kwargs`` funnel), write results/typed errors into
    ``<dir>/outbox``, heartbeat into the pool ledger, and on SIGTERM
    drain gracefully: stop claiming, finish in-flight work, release
    the claims of queued records so survivors reclaim them
    (spill-migration). Without a card and without ``--device cpu`` it
    exits with an error before it claims anything."""
    import argparse
    import signal

    p = argparse.ArgumentParser(prog="nmfx_torch.replica")
    p.add_argument("--dir", required=True)
    p.add_argument("--id", required=True)
    p.add_argument("--pool-dir", required=True)
    p.add_argument("--heartbeat-interval", type=float, default=0.5)
    p.add_argument("--poll-interval", type=float, default=0.05)
    p.add_argument("--cache-dir", default=None)
    p.add_argument("--telemetry-dir", default=None)
    p.add_argument("--max-queue-depth", type=int, default=64)
    p.add_argument("--mesh-spec", default=None)
    p.add_argument("--device", default=None,
                   help="the device this worker serves on: the card "
                        "(default) or 'cpu' for the plain versions")
    args = p.parse_args(argv)

    from nmfx_torch.device import explicit_device, resolve_device
    from nmfx_torch.faults import warn_once
    from nmfx_torch.obs.export import HeartbeatLedger
    from nmfx_torch.serve import (NMFXServer, QueueFull, ServeConfig,
                                  ServerClosed, claim_spill, list_spills,
                                  load_spill_record, release_spill_claim,
                                  spill_claimant, spill_dataset,
                                  spill_submit_kwargs)

    try:
        device = explicit_device(resolve_device(args.device))
    except (RuntimeError, ValueError) as e:
        p.error(f"--device: {e}")
    inbox = os.path.join(args.dir, "inbox")
    outbox = os.path.join(args.dir, "outbox")
    os.makedirs(inbox, exist_ok=True)
    os.makedirs(outbox, exist_ok=True)
    n_devices = 1
    engine = exec_cache = None
    if args.cache_dir is not None and args.mesh_spec is None:
        from nmfx_torch.config import ExecCacheConfig
        from nmfx_torch.exec_cache import ExecCache

        exec_cache = ExecCache(ExecCacheConfig(cache_dir=args.cache_dir),
                               device=device)
    if args.mesh_spec is not None:
        from nmfx_torch.distributed import MeshSpecError
        from nmfx_torch.serve import MeshEngine

        try:
            n_devices = _spec_devices(args.mesh_spec)
            # an explicit --device is named once an entry; by default
            # the mesh takes this process's first cards
            engine = MeshEngine(args.mesh_spec, devices=(
                device if args.device is not None else None))
        except (MeshSpecError, RuntimeError) as e:
            p.error(f"--mesh-spec: {e}")
    server = NMFXServer(
        ServeConfig(role="replica", instance=args.id,
                    max_queue_depth=args.max_queue_depth,
                    telemetry_dir=args.telemetry_dir,
                    mesh_spec=args.mesh_spec),
        engine=engine, exec_cache=exec_cache,
        device=None if engine is not None else device)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    inflight_lock = threading.Lock()
    inflight: "set[str]" = set()

    def status() -> dict:
        s = server.stats()
        return {"role": "replica", "kind": "process",
                "state": "draining" if stop.is_set() else "routable",
                "queue_depth": s["queued"], "inflight": s["inflight"],
                "mesh": args.mesh_spec, "devices": n_devices}

    ledger = HeartbeatLedger(args.pool_dir, prefix=HEARTBEAT_PREFIX)
    beater = _Beater(ledger, args.id, status,
                     args.heartbeat_interval).launch()

    def finish(path: str, rid: str, fut) -> None:
        exc = fut.exception()
        if isinstance(exc, ServerClosed):
            # drained before dispatch: hand the record back for a
            # survivor (or the router) to reclaim — spill-migration
            release_spill_claim(path)
        else:
            if exc is not None:
                _write_error(outbox, rid, exc)
            else:
                _write_result(outbox, rid, fut.result())
            # result first, record second: a crash between the two
            # leaves BOTH, and recovery dedups on the result file
            try:
                os.unlink(path)
            except OSError:  # already gone
                pass
            release_spill_claim(path)
        with inflight_lock:
            inflight.discard(rid)

    while not stop.is_set():
        for path in list_spills(inbox):
            if stop.is_set():
                break
            rid = _rid_of(path)
            with inflight_lock:
                if rid in inflight:
                    continue
            if os.path.exists(os.path.join(
                    outbox, f"{RESULT_PREFIX}{rid}.npz")):
                # crash-leftover: the result already landed — consume
                # the record instead of recomputing it
                try:
                    os.unlink(path)
                except OSError:  # raced
                    pass
                release_spill_claim(path)
                continue
            if spill_claimant(path) is not None:
                continue
            if not claim_spill(path, args.id):
                continue
            try:
                a, meta = load_spill_record(path)
                fut = server.submit(spill_dataset(a, meta),
                                    **spill_submit_kwargs(meta))
            except QueueFull:
                release_spill_claim(path)  # admission reopens later
                break
            except Exception as e:
                # a torn record cannot be served by ANYONE — answer
                # typed instead of leaving the router to time out
                warn_once("replica-inbox-torn",
                          f"inbox record {path!r} unreadable ({e!r}); "
                          "answering with a typed error")
                _write_error(outbox, rid, e)
                try:
                    os.unlink(path)
                except OSError:  # raced
                    pass
                release_spill_claim(path)
                continue
            with inflight_lock:
                inflight.add(rid)
            fut.add_done_callback(
                lambda f, p=path, r=rid: finish(p, r, f))
        stop.wait(args.poll_interval)
    # graceful drain: queued requests fail ServerClosed (their claims
    # are released by finish()), in-flight requests complete and land
    # in the outbox before the server joins its workers
    server.close(cancel_pending=True)
    beater.close(final_status=dict(status(), state="dead"))
    return 0


if __name__ == "__main__":
    sys.exit(worker_main())
