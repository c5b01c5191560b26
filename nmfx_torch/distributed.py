"""Several processes, one sweep (counterpart of ``nmfx/distributed.py``).

Every process runs the same script. The restart axis spans a *global*
mesh of every process's devices: each process solves the restart shards
it owns, on its own devices, and the per-restart outputs (labels,
iterations, residuals, stop reasons and the best restarts' factors) are
gathered on the host over a gloo group, so every process returns the
same ``ConsensusResult``. Only the coordinator writes files::

    import nmfx_torch.distributed as dist
    dist.initialize()      # from torchrun's or SLURM's environment
    result = dist.consensus(data, ks=range(2, 11), restarts=400)

Gloo and not NCCL: the restart axis moves only those small per-restart
outputs, the grid axes' partial sums are host-gathered and added in
shard order (so the bytes do not depend on the process layout), and
NCCL refuses a card that two processes name, which is how two processes
share one card. Initialization and every gather carry the
group's timeout, so a lost peer raises instead of hanging; the group is
torn down at exit.

A single process degenerates cleanly: :func:`initialize` is a no-op
without a cluster environment and :func:`global_mesh` is the local mesh.

The elastic half (:class:`ElasticShardRunner`, :func:`elastic_consensus`)
shards the checkpoint ledger's (k, restart-chunk) units over devices in
one process, each shard a thread; a shard that dies hands its unit back
and the survivors finish it, byte-equal to a single-device checkpointed
run of the same plan.

With ``feature_shards`` / ``sample_shards`` (``global_mesh``,
``consensus``) each factorization is split over the genes and the
samples: a grid group's shards advance in lockstep, and a group that
spans processes exchanges its partial sums over a gloo subgroup of them
every iteration (``nmfx_torch/collectives.py``).
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import datetime
import itertools
import os
import threading

import numpy as np
import torch

from nmfx_torch.device import Mesh, _process_index
from nmfx_torch.obs import metrics as _metrics
from nmfx_torch.obs import trace as _trace
from nmfx_torch.sweep import (FEATURE_AXIS, RESTART_AXIS, SAMPLE_AXIS,
                              local_devices)

#: the elastic runner's instruments: per-shard progress (the fleet view
#: sums the shards) and the live shards of this process's runner
_units_solved_total = _metrics.counter(
    "nmfx_elastic_units_solved_total",
    "work units solved and committed by elastic shards",
    labelnames=("shard",))
_shards_alive_gauge = _metrics.gauge(
    "nmfx_elastic_shards_alive",
    "elastic shards currently alive in this process's runner")

#: per-process elastic run sequence; with the pid, the trace id the
#: shard heartbeats and spans carry
_run_seq = itertools.count()

#: seconds the group's rendezvous and each gather wait for a peer
DEFAULT_TIMEOUT_S = 300.0


def _env_int(name: str) -> "int | None":
    try:
        return int(os.environ[name])
    except (KeyError, ValueError):
        return None


def _cluster_env_detected() -> bool:
    """Whether the environment looks like a multi-process job: an
    explicit coordinator, or a world size above 1 from torchrun, SLURM,
    Open MPI or PMI."""
    if os.environ.get("NMFX_COORDINATOR_ADDRESS"):
        return True
    for var in ("WORLD_SIZE", "SLURM_NTASKS", "SLURM_NPROCS",
                "OMPI_COMM_WORLD_SIZE", "PMI_SIZE"):
        if (_env_int(var) or 0) > 1:
            return True
    return False


def _env_spec():
    """``(coordinator_address, num_processes, process_id)`` from the
    environment, each None where it says nothing: torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``, SLURM's
    ``SLURM_NTASKS``/``SLURM_PROCID``, Open MPI's and PMI's, and
    ``NMFX_COORDINATOR_ADDRESS`` (``host:port``) for the address."""
    addr = os.environ.get("NMFX_COORDINATOR_ADDRESS")
    if addr is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    world = next((v for v in (_env_int(n) for n in (
        "WORLD_SIZE", "SLURM_NTASKS", "SLURM_NPROCS",
        "OMPI_COMM_WORLD_SIZE", "PMI_SIZE")) if v is not None), None)
    rank = next((v for v in (_env_int(n) for n in (
        "RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK", "PMI_RANK"))
        if v is not None), None)
    return addr, world, rank


def initialize(coordinator_address: "str | None" = None,
               num_processes: "int | None" = None,
               process_id: "int | None" = None, *,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Bring up the ``torch.distributed`` gloo group of a multi-process
    job (``jax.distributed.initialize``'s rules).

    The arguments default to the environment torchrun or SLURM set
    (:func:`_env_spec`); ``coordinator_address`` is ``host:port`` of
    process 0. A second call is a no-op, and so is a call with no
    argument and no cluster environment, so the same script runs
    unchanged as one process. Inside a cluster environment every failure
    raises (a process that believed itself alone would compute the whole
    sweep and race the coordinator's file writes), and so does an
    explicit call that names too little. ``timeout_s`` bounds the
    rendezvous and every later gather; the group is destroyed at exit."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    explicit = any(v is not None for v in (coordinator_address,
                                           num_processes, process_id))
    env_addr, env_world, env_rank = _env_spec()
    addr = coordinator_address if coordinator_address is not None \
        else env_addr
    world = num_processes if num_processes is not None else env_world
    rank = process_id if process_id is not None else env_rank
    if not explicit and not _cluster_env_detected():
        return  # one process: nothing to join
    missing = [name for name, v in (("coordinator_address", addr),
                                    ("num_processes", world),
                                    ("process_id", rank)) if v is None]
    if missing:
        raise ValueError(
            f"distributed.initialize: {', '.join(missing)} not given and "
            "not found in the environment (torchrun's MASTER_ADDR/"
            "MASTER_PORT/WORLD_SIZE/RANK, SLURM_NTASKS/SLURM_PROCID, or "
            "NMFX_COORDINATOR_ADDRESS)")
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"process_id {rank} is not in [0, {world})")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{addr}", world_size=int(world),
        rank=int(rank), timeout=datetime.timedelta(seconds=timeout_s))
    atexit.register(shutdown)


def shutdown() -> None:
    """Destroy the process group, if one is up (registered at exit by
    :func:`initialize`)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def is_coordinator() -> bool:
    return _process_index() == 0


class MeshSpecError(ValueError):
    """A mesh specification does not fit the available devices (typed,
    so callers catch the spec problem apart from other ``ValueError``s)."""


def parse_mesh_spec(spec: str) -> "tuple[int, int, int]":
    """A replica mesh spec as ``(restart_shards, feature_shards,
    sample_shards)``: ``"R"``, ``"RxF"`` or ``"RxFxS"``, each a positive
    integer (the axis order of ``grid_mesh``); anything else raises
    :class:`MeshSpecError`."""
    parts = str(spec).lower().split("x")
    if not 1 <= len(parts) <= 3:
        raise MeshSpecError(
            f"mesh spec {spec!r} must be R, RxF, or RxFxS "
            "(restarts × features × samples)")
    try:
        counts = tuple(int(p) for p in parts)
    except ValueError:
        raise MeshSpecError(
            f"mesh spec {spec!r} has a non-integer axis count") from None
    if any(c < 1 for c in counts):
        raise MeshSpecError(
            f"mesh spec {spec!r} has a non-positive axis count")
    return counts + (1,) * (3 - len(counts))


def build_replica_mesh(spec: str, devices=None) -> Mesh:
    """The mesh a replica's device set runs on, from its spec. An
    explicit ``devices`` set must be used whole (a replica that owns 8
    cards but meshes 4 would idle half of them): a mismatch is a
    :class:`MeshSpecError`. ``devices=None`` takes the first ``r·f·s`` of
    :func:`~nmfx_torch.sweep.local_devices`."""
    from nmfx_torch.sweep import grid_mesh

    r, f, s = parse_mesh_spec(spec)
    need = r * f * s
    if devices is None:
        devices = local_devices()
        if len(devices) < need:
            raise MeshSpecError(
                f"mesh spec {spec!r} needs {need} device(s) "
                f"({r}x{f}x{s}); this process has {len(devices)}")
        devices = devices[:need]
    else:
        devices = list(devices)
        if len(devices) != need:
            raise MeshSpecError(
                f"mesh spec {spec!r} needs exactly {need} device(s) "
                f"({r}x{f}x{s}); this replica owns {len(devices)}")
    if f == 1 and s == 1:
        arr = np.empty(len(devices), dtype=object)
        arr[:] = devices
        return Mesh(arr, (RESTART_AXIS,))
    return grid_mesh(r, f, s, devices=devices)


def _process_devices(devices) -> list:
    """This process's devices for the global mesh: ``devices`` as given,
    else its cards (raising without one: the port never moves to the
    CPU by itself)."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    found = local_devices()
    if not found:
        raise RuntimeError(
            "distributed.global_mesh: this process sees no CUDA device; "
            "pass devices=['cpu'] to run its shards on the CPU")
    return found


def global_mesh(feature_shards: int = 1, sample_shards: int = 1,
                devices=None) -> Mesh:
    """A mesh over every process's devices, in process order: the
    processes' device lists are learned with one host all-gather over the
    group (none without one). ``devices`` is this process's list
    (default: its cards); two processes may name the same card. With
    ``feature_shards`` or ``sample_shards`` above 1 it is the 3-D
    restarts × features × samples mesh (the reference's
    ``global_mesh``): the grid axes innermost, so a grid group's shards
    lie in as few processes as the layout allows, and its errors are the
    reference's."""
    import torch.distributed as dist

    if feature_shards < 1 or sample_shards < 1:
        raise MeshSpecError(
            "feature_shards/sample_shards must be >= 1, got "
            f"{feature_shards}×{sample_shards}")
    mine = [str(d) for d in _process_devices(devices)]
    if dist.is_available() and dist.is_initialized():
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
    else:
        every = [mine]
    flat = [(d, p) for p, devs in enumerate(every) for d in devs]
    arr = np.empty(len(flat), dtype=object)
    arr[:] = [d for d, _ in flat]
    procs = np.array([p for _, p in flat], dtype=np.int64)
    if feature_shards == 1 and sample_shards == 1:
        return Mesh(arr, (RESTART_AXIS,), processes=procs)
    grid = feature_shards * sample_shards
    if grid > len(flat):
        raise MeshSpecError(
            f"features×samples={feature_shards}×{sample_shards} needs "
            f"{grid} devices; this job has {len(flat)}")
    if len(flat) % grid:
        raise MeshSpecError(
            f"{len(flat)} devices don't divide into "
            f"features×samples={feature_shards}×{sample_shards} "
            f"(= {grid}); the restart axis would be ragged")
    shape = (len(flat) // grid, feature_shards, sample_shards)
    return Mesh(arr.reshape(shape), (RESTART_AXIS, FEATURE_AXIS, SAMPLE_AXIS),
                processes=procs.reshape(shape))


def consensus(data, ks=(2, 3, 4, 5), restarts: int = 10,
              feature_shards: int = 1, sample_shards: int = 1,
              devices=None, **kwargs):
    """``nmfx_torch.nmfconsensus`` over :func:`global_mesh`: every process
    returns the same result. File outputs (``output=``,
    ``checkpoint_dir=``) are honored on the coordinator only, so
    processes that share a file system do not race on one path.
    ``devices``: this process's devices (default: its cards)."""
    from nmfx_torch.api import nmfconsensus

    if not is_coordinator():
        kwargs = dict(kwargs, output=None, checkpoint_dir=None)
    return nmfconsensus(data, ks=ks, restarts=restarts,
                        mesh=global_mesh(feature_shards, sample_shards,
                                         devices=devices),
                        **kwargs)


# --------------------------------------------------------------------------
# elastic shard recovery: the restart grid's (k, restart-chunk) units
# over devices, completion in the shared checkpoint ledger, so a shard
# lost mid-sweep is recovered by the survivors (same keys, same results)
# --------------------------------------------------------------------------
class ElasticShardRunner:
    """Restart-grid sharding with shard-loss recovery over a durable
    ledger (the reference's runner).

    Each device (or, with ``shard_devices > 1``, each group of that many
    devices, solving over a restart sub-mesh) is one shard, driven by a
    thread that takes (k, r0, r1) units from one queue in the plan's
    order (ks-major, chunk-minor), solves each through the checkpoint's
    chunk executor on its device and commits the record to the shared
    :class:`~nmfx_torch.checkpoint.SweepCheckpoint`, beating a
    ``shard_<i>.json`` heartbeat per unit. A shard that dies (a raised
    ``checkpoint.Preempted``, the armed ``proc.preempt`` site, or any
    crash) hands its unit back to the queue, where a survivor takes it.

    A unit draws the canonical ``split(fold_in(key(seed), k),
    restarts)[r0:r1]`` keys and the finalize step counts connectivity in
    restart order, so the result is byte-equal to a single-device
    checkpointed run of the same plan however the units were spread."""

    def __init__(self, ck, ccfg, scfg, icfg, arr, devices=None,
                 telemetry_dir=None, trace_id=None,
                 shard_devices: int = 1):
        self.ck = ck
        self.ccfg = ccfg
        self.scfg = scfg
        self.icfg = icfg
        self.arr = np.asarray(arr)
        self.devices = (_process_devices(None) if devices is None
                        else [torch.device(d) for d in devices])
        if not self.devices:
            raise ValueError("need at least one device")
        if shard_devices < 1:
            raise MeshSpecError("shard_devices must be >= 1, got "
                                f"{shard_devices}")
        if shard_devices > len(self.devices):
            raise MeshSpecError(
                f"shard_devices={shard_devices} exceeds the "
                f"{len(self.devices)} available device(s)")
        if len(self.devices) % shard_devices:
            raise MeshSpecError(
                f"{len(self.devices)} device(s) don't divide into "
                f"sub-meshes of {shard_devices}; a ragged remainder "
                "would idle silently")
        if shard_devices > 1:
            from nmfx_torch.sweep import _use_packed

            if _use_packed(scfg):
                raise ValueError(
                    "meshed chunk execution supports the batched restart "
                    "route only (the packed family's pool geometry is "
                    "composition-dependent; ledger records must stay "
                    "bit-identical to the unmeshed chunk executor)")
        self.shard_devices = shard_devices
        self._groups = [self.devices[i:i + shard_devices]
                        for i in range(0, len(self.devices),
                                       shard_devices)]
        #: the sweep's identity across processes: every heartbeat and
        #: ``elastic.unit`` span carries it
        self.trace_id = trace_id if trace_id is not None else \
            f"elastic-{os.getpid()}-{next(_run_seq)}"
        self.telemetry_dir = telemetry_dir
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending = collections.deque(
            (k, r0, r1) for k in ccfg.ks for r0, r1 in ck.plan
            if not ck.has(k, r0, r1))
        self._inflight = 0  # units taken, not yet committed or returned
        self._records: dict = {}
        self.dead_shards: "list[int]" = []
        self._errors: "list[BaseException]" = []

    def _place(self, group):
        """A on the shard's device, or its per-device copies and the
        restart sub-mesh of a device group."""
        from nmfx_torch.sweep import place_input

        if len(group) == 1:
            return place_input(self.arr, self.scfg, device=group[0]), None
        arr = np.empty(len(group), dtype=object)
        arr[:] = group
        submesh = Mesh(arr, (RESTART_AXIS,))
        return place_input(self.arr, self.scfg, submesh), submesh

    def _worker(self, idx: int, group) -> None:
        from nmfx_torch import checkpoint as ckpt
        from nmfx_torch import random as _random

        done = 0
        dev = group[0]
        ctx = (torch.cuda.device(dev) if dev.type == "cuda"
               else contextlib.nullcontext())
        with ctx:
            a_dev, submesh = self._place(group)
            key_cache: dict = {}
            tracer = _trace.default_tracer()
            while True:
                with self._cond:
                    # an empty queue is not the end while units are in
                    # flight: a dying shard hands its unit back, and a
                    # survivor that had left would strand it
                    while not self._pending and self._inflight > 0:
                        self._cond.wait()
                    if not self._pending:
                        self.ck.heartbeat(idx, alive=True, done=done,
                                          unit=None,
                                          trace_id=self.trace_id)
                        _shards_alive_gauge.inc(-1)
                        return
                    unit = self._pending.popleft()
                    self._inflight += 1
                k, r0, r1 = unit
                try:
                    if k not in key_cache:
                        key_cache[k] = _random.split(_random.fold_in(
                            _random.key(self.ccfg.seed), k),
                            self.ccfg.restarts)
                    with tracer.span("elastic.unit", cat="elastic",
                                     args={"shard": idx, "k": k, "r0": r0,
                                           "r1": r1,
                                           "trace_id": self.trace_id}):
                        rec = ckpt.solve_chunk_host(
                            a_dev, k, r0, r1, self.ccfg, self.scfg,
                            self.icfg, keys=key_cache[k], device=dev,
                            mesh=submesh)
                except ckpt.Preempted:
                    # shard death: the unit goes back for a survivor
                    # (same keys, same results), and a final not-alive
                    # heartbeat lands in the ledger
                    self._retire(idx, unit, done)
                    return
                except BaseException as e:  # a crash: raised by run()
                    from nmfx_torch.faults import warn_once  # only if
                    # work strands; the unit returns, the shard retires
                    self._retire(idx, unit, done, e)
                    warn_once(
                        "elastic-shard-crash",
                        f"elastic shard {idx} ({dev}) crashed on unit "
                        f"{unit} ({e!r}); its incomplete units were "
                        "returned to the queue for the surviving shards")
                    return
                self.ck.save(k, r0, r1, rec)
                done += 1
                _units_solved_total.inc(shard=str(idx))
                self.ck.heartbeat(idx, alive=True, done=done, unit=unit,
                                  trace_id=self.trace_id)
                with self._cond:
                    self._records[unit] = rec
                    self._inflight -= 1
                    self._cond.notify_all()

    def _retire(self, idx: int, unit, done: int, error=None) -> None:
        with self._cond:
            self._pending.appendleft(unit)
            self._inflight -= 1
            self.dead_shards.append(idx)
            if error is not None:
                self._errors.append(error)
            self._cond.notify_all()
        self.ck.heartbeat(idx, alive=False, done=done, unit=unit,
                          trace_id=self.trace_id)
        _shards_alive_gauge.inc(-1)

    def shard_status(self, stale_after_s: "float | None" = None) -> dict:
        """``{shard: heartbeat_payload}`` from the ledger's heartbeats;
        with ``stale_after_s`` each carries ``stale`` and ``age_s``, so
        a supervisor across processes can spot a shard whose process died
        without a final heartbeat (completion records stay the ground
        truth)."""
        return self.ck.shard_status(stale_after_s)

    def run(self) -> dict:
        """Dispatch until every unit is committed (or every shard died);
        returns ``{(k, r0, r1): ChunkSweepOutput}`` for the units this
        process solved. Units already in the ledger load at finalize."""
        publisher = None
        if self.telemetry_dir is not None:
            from nmfx_torch.obs.export import TelemetryPublisher

            publisher = TelemetryPublisher(
                self.telemetry_dir, role="elastic",
                instance=f"elastic-{os.getpid()}",
                interval_s=1.0).start()
        _shards_alive_gauge.set(len(self._groups))
        threads = [threading.Thread(target=self._worker, args=(i, g),
                                    daemon=True, name=f"nmfx-elastic-{i}")
                   for i, g in enumerate(self._groups)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if publisher is not None:
            publisher.close()
        # every_s-buffered records land now, before the error below says
        # the committed records remain
        self.ck.flush()
        if self._pending:
            err = RuntimeError(
                f"every shard died with {len(self._pending)} unit(s) "
                "still pending; the committed records remain in "
                f"{self.ck.directory!r} — re-run to resume from them")
            if self._errors:
                raise err from self._errors[0]
            raise err
        # crashes whose units the survivors absorbed are not raised: the
        # result is whole and exact (each crash warned once)
        return dict(self._records)


def elastic_consensus(data, ks=(2, 3, 4, 5), restarts: int = 10, *,
                      checkpoint, seed: int = 123, solver_cfg=None,
                      init_cfg=None, label_rule: str = "argmax",
                      linkage: str = "average", min_restarts: int = 1,
                      devices=None, telemetry_dir=None,
                      shard_devices: int = 1):
    """A durable, elastic consensus sweep: ``checkpoint``'s (k × chunk)
    units spread over ``devices`` (default: this process's cards; a card
    may be named more than once) by :class:`ElasticShardRunner`. A shard
    lost mid-sweep is recovered by the survivors, and the result is
    byte-equal to a single-device checkpointed run of the same plan.
    ``checkpoint`` is a ``CheckpointConfig`` or a directory; a partial
    ledger resumes. ``telemetry_dir`` publishes this process's registry
    snapshots (the per-shard counters among them); ``shard_devices``
    makes each shard a restart sub-mesh of that many devices. Returns
    ``nmfconsensus``'s ``ConsensusResult``."""
    from nmfx_torch import checkpoint as ckpt
    from nmfx_torch.api import ConsensusResult, _as_matrix, _build_k_result
    from nmfx_torch.config import (CheckpointConfig, ConsensusConfig,
                                   InitConfig, SolverConfig, check_ported)

    if isinstance(checkpoint, (str, os.PathLike)):
        checkpoint = CheckpointConfig(directory=os.fspath(checkpoint))
    arr, col_names = _as_matrix(data)
    arr = np.asarray(arr)
    if not np.isfinite(arr).all():
        raise ValueError("input matrix contains non-finite values")
    if (arr < 0).any():
        raise ValueError("input matrix must be non-negative")
    ccfg = ConsensusConfig(ks=tuple(ks), restarts=restarts, seed=seed,
                           label_rule=label_rule, linkage=linkage,
                           min_restarts=min_restarts)
    scfg = solver_cfg if solver_cfg is not None else SolverConfig()
    icfg = init_cfg if init_cfg is not None else InitConfig()
    check_ported(scfg)
    runner = None
    devs = (_process_devices(None) if devices is None
            else [torch.device(d) for d in devices])
    ck = ckpt.SweepCheckpoint.open(arr, ccfg, scfg, icfg, checkpoint,
                                   devs[0])
    runner = ElasticShardRunner(ck, ccfg, scfg, icfg, arr, devices=devs,
                                telemetry_dir=telemetry_dir,
                                shard_devices=shard_devices)
    solved = runner.run()
    per_k = {}
    for k in ccfg.ks:
        recs = {}
        for r0, r1 in ck.plan:
            rec = solved.get((k, r0, r1))
            if rec is None:
                rec = ck.try_load(k, r0, r1)
            if rec is None:  # committed by a peer and then torn: solve
                # it here rather than fail the sweep
                from nmfx_torch.sweep import place_input

                rec = ckpt.solve_chunk_host(
                    place_input(arr, scfg, device=devs[0]), k, r0, r1,
                    ccfg, scfg, icfg, device=devs[0])
                ck.save(k, r0, r1, rec)
            recs[(r0, r1)] = rec
        out = ckpt._finalize_rank(k, recs, ccfg, arr.shape)
        per_k[k] = _build_k_result(k, out, ccfg.linkage,
                                   min_restarts=ccfg.min_restarts)
    ck.flush()  # the inline solves above may have buffered (every_s)
    return ConsensusResult(ks=ccfg.ks, per_k=per_k,
                           col_names=tuple(col_names))
