"""Lockstep collectives of a grid group (the port's counterpart of the
``psum`` / ``pmax`` / ``all_gather`` that ``nmfx``'s grid-sharded
programs run inside ``shard_map``, ``nmfx/solvers/base.py:43-71``).

A restart shard of a mesh with feature or sample axes is one *grid
group*: its F×S shards each hold a block of A (rows over the feature
axis, columns over the sample axis) and solve the same restarts. Every
iteration each shard needs its peers' partial sums, so the group's shards
advance in lockstep: each runs the same program on its own thread (one
thread a shard, :func:`run_groups`), and every collective is one
*exchange* in which every shard of the group deposits a tensor and
receives all of them. From the exchange:

* :meth:`ShardComm.sum` adds the parts of its axis **in shard order**,
  the same additions on every shard, so the sum is the same bytes on
  every shard, in one process or across several, whatever the layout
  (gloo's ``all_reduce`` order is not relied on);
* :meth:`ShardComm.max` takes the elementwise maximum;
* :meth:`ShardComm.all_gather` concatenates the parts in shard order;
* :meth:`ShardComm.any` is the flag ``or``;
* :meth:`ShardComm.reduce` runs several of them, over either axis, in
  one exchange (the solvers fuse the terms a half-step sums).

The shards of a group that live in this process take turns: one token
passes round them in shard order, and a shard runs only while it holds
it. At a collective a shard deposits its part and hands the token on;
when it gets the token back every shard has deposited, and it reads the
parts (double-buffered, so the next collective's deposits cannot
overwrite them). So one thread of a group runs at a time, as one host
loop over the shards would, and a group's threads never fight over the
interpreter lock. Across processes the last local shard to deposit runs
a host ``all_gather_object`` of this process's parts over a gloo
subgroup of the processes that own the group (NCCL refuses a card named
by two processes) before it hands the token on. A shard that raises
aborts its group, so its peers raise instead of waiting.

:data:`CALLS` counts the collectives shard (0, 0) of each group runs,
by (op, axis): the cost model's ``collectives_per_iter`` is held to it.
"""

from __future__ import annotations

import collections
import contextlib
import threading

import numpy as np
import torch

from nmfx_torch.device import _process_index

#: mesh axis names, the reference's (``nmfx_torch.sweep`` re-exports them)
FEATURE_AXIS = "features"
SAMPLE_AXIS = "samples"
#: both grid axes: a sum over the features, then over the samples
GRID_AXES = "grid"

#: collectives run by shard (0, 0) of every group, by (op, axis)
CALLS: collections.Counter = collections.Counter()
_calls_lock = threading.Lock()


def reset_calls() -> None:
    """Zero :data:`CALLS`."""
    with _calls_lock:
        CALLS.clear()


class GridGroup:
    """The F×S shards of one grid group and the exchange they meet at.
    ``procs`` (F, S) names the process that owns each shard (None: all
    are this process's); ``pg`` is the gloo subgroup of those processes
    when there are several."""

    def __init__(self, f_shards: int, s_shards: int, procs=None, pg=None):
        self.f_shards = f_shards
        self.s_shards = s_shards
        size = f_shards * s_shards
        self.procs = (np.zeros((f_shards, s_shards), dtype=np.int64)
                      if procs is None else np.asarray(procs).reshape(
                          f_shards, s_shards))
        rank = _process_index()
        self.local = [p for p in range(size)
                      if int(self.procs.flat[p]) == rank]
        self.remote = len(self.local) < size
        if self.remote and pg is None:
            raise ValueError("a grid group across processes needs its "
                             "gloo subgroup")
        self.pg = pg
        # one lock a shard, held while it is not its turn: a shard waits
        # by acquiring its own lock and is woken by a release of it
        self._go = {p: threading.Lock() for p in self.local}
        for p in self.local[1:]:
            self._go[p].acquire()  # the first shard starts
        self._failed = False
        self._slots = [[None] * size, [None] * size]
        self._merged = [None, None]

    def _next(self, pos: int) -> int:
        i = self.local.index(pos)
        return self.local[(i + 1) % len(self.local)]

    def _wait(self, pos: int) -> None:
        self._go[pos].acquire()
        if self._failed:
            raise GroupAborted("a shard of this grid group failed")

    def start(self, pos: int) -> None:
        """Block shard ``pos`` until its first turn."""
        self._wait(pos)

    def _hand_on(self, pos: int) -> None:
        nxt = self._go[self._next(pos)]
        if nxt.locked():
            nxt.release()

    def finish(self, pos: int) -> None:
        """Shard ``pos`` is done: hand the token on for good."""
        self._hand_on(pos)

    def abort(self) -> None:
        """Fail the group: every shard waiting for its turn raises."""
        self._failed = True
        for lock in self._go.values():
            if lock.locked():
                try:
                    lock.release()
                except RuntimeError:  # released by another thread first
                    pass

    def exchange(self, pos: int, gen: int, x: tuple) -> list:
        """Shard ``pos``'s ``gen``-th exchange: deposit the tensors ``x``,
        hand the token on, and once it comes back return every shard's
        tensors, in shard order."""
        buf = gen % 2
        self._slots[buf][pos] = x
        if self.remote and pos == self.local[-1]:
            import torch.distributed as dist

            mine = {p: tuple(t.detach().cpu() for t in self._slots[buf][p])
                    for p in self.local}
            every = [None] * dist.get_world_size(self.pg)
            dist.all_gather_object(every, mine, group=self.pg)
            merged: dict = {}
            for part in every:
                merged.update(part)
            self._merged[buf] = [merged[p] for p in range(len(merged))]
        self._hand_on(pos)
        self._wait(pos)
        return list(self._merged[buf] if self.remote else self._slots[buf])


class GroupAborted(RuntimeError):
    """A peer shard of this grid group failed."""


class ShardComm:
    """One shard's handle on its group's collectives: shard ``(fidx,
    sidx)`` of ``group``. Every shard of a group must run the same
    collectives in the same order (the program is the same on each and
    its decisions come from these collectives, so it does)."""

    def __init__(self, group: GridGroup, fidx: int, sidx: int):
        self.group = group
        self.fidx = fidx
        self.sidx = sidx
        self.pos = fidx * group.s_shards + sidx
        self._gen = 0

    def _select(self, parts: list, axis: str) -> list:
        g = self.group
        if axis == FEATURE_AXIS:
            return [parts[f * g.s_shards + self.sidx]
                    for f in range(g.f_shards)]
        return [parts[self.fidx * g.s_shards + s]
                for s in range(g.s_shards)]

    def reduce(self, items) -> list:
        """Several collectives in one exchange: ``items`` is a list of
        ``(op, tensor, axis)`` with op "sum", "max", "all_gather" (along
        the tensor's dim 0 unless the tensor is given as ``(x, dim)``) or
        "any"; returns their results in order. Each item counts as one
        collective of :data:`CALLS`."""
        ops, xs, axes, dims = [], [], [], []
        for op, x, axis in items:
            if axis not in (FEATURE_AXIS, SAMPLE_AXIS, GRID_AXES):
                raise ValueError(f"unknown grid axis {axis!r}")
            if axis == GRID_AXES and op != "sum":
                raise ValueError("only a sum runs over both grid axes")
            dim = 0
            if isinstance(x, tuple):
                x, dim = x
            ops.append(op)
            xs.append(x.to(torch.int32) if op == "any" else x)
            axes.append(axis)
            dims.append(dim)
        if self.pos == 0:
            with _calls_lock:
                for op, axis in zip(ops, axes):
                    CALLS[(op, axis)] += 1
        parts = self.group.exchange(self.pos, self._gen, tuple(xs))
        self._gen += 1
        out = []
        for i, (op, x, axis, dim) in enumerate(zip(ops, xs, axes, dims)):
            if axis == GRID_AXES:
                out.append(self._grid_sum(parts, i, x.device))
                continue
            sel = [p[i].to(x.device) for p in self._select(parts, axis)]
            if op == "all_gather":
                out.append(torch.cat(sel, dim=dim))
                continue
            acc = sel[0]
            for p in sel[1:]:  # in shard order, the same on every shard
                acc = torch.maximum(acc, p) if op == "max" else acc + p
            out.append(acc > 0 if op == "any" else acc)
        return out

    def _grid_sum(self, parts: list, i: int, device) -> torch.Tensor:
        """Item ``i`` summed over the features for each sample index, then
        over the samples, each in shard order: the bits of a feature sum
        followed by a sample sum."""
        g = self.group
        total = None
        for s in range(g.s_shards):
            acc = parts[s][i].to(device)
            for f in range(1, g.f_shards):
                acc = acc + parts[f * g.s_shards + s][i].to(device)
            total = acc if total is None else total + acc
        return total

    def sum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The axis' parts added in shard order (``lax.psum``)."""
        return self.reduce([("sum", x, axis)])[0]

    def max(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The axis' elementwise maximum (``lax.pmax``)."""
        return self.reduce([("max", x, axis)])[0]

    def all_gather(self, x: torch.Tensor, axis: str,
                   dim: int = 0) -> torch.Tensor:
        """The axis' parts concatenated along ``dim`` in shard order
        (``lax.all_gather(..., tiled=True)``)."""
        return self.reduce([("all_gather", (x, dim), axis)])[0]

    def any(self, flag: torch.Tensor, axis: str) -> torch.Tensor:
        """The flag ``or`` over the axis (a psum of the int flags, > 0)."""
        return self.reduce([("any", flag, axis)])[0]


#: gloo subgroups of grid groups that span processes, by (mesh, restart
#: shard): ``new_group`` is collective over every process, so each is
#: made once, in restart-shard order, by every process alike
_PGS: dict = {}


def group_pgs(mesh, procs_by_group: list) -> list:
    """The gloo subgroup of each grid group whose shards span several
    processes (None for one that lies in one process). Every process
    calls this with the same mesh, in the same order."""
    out = []
    for ri, procs in enumerate(procs_by_group):
        owners = sorted({int(p) for p in np.asarray(procs).flat})
        if len(owners) <= 1:
            out.append(None)
            continue
        key = (mesh, ri)
        if key not in _PGS:
            import torch.distributed as dist

            _PGS[key] = dist.new_group(ranks=owners, backend="gloo")
        out.append(_PGS[key])
    return out


def run_groups(groups: list, work) -> dict:
    """Run ``work(gi, comm)`` for every local shard of every group, one
    thread a shard, and return ``{(gi, pos): result}``. A CUDA shard's
    thread runs under its device (``work`` selects it). The first
    exception, in (group, shard) order, is raised after every thread has
    ended; a raising shard aborts its group so its peers end too."""
    results: dict = {}
    errors: dict = {}
    jobs = [(gi, pos) for gi, g in enumerate(groups) for pos in g.local]

    def serve(gi: int, pos: int) -> None:
        g = groups[gi]
        comm = ShardComm(g, pos // g.s_shards, pos % g.s_shards)
        if len(jobs) > 1:
            # a new thread starts with the default intra-op team; one
            # thread a shard keeps the shards from oversubscribing the
            # cores, and makes a CPU shard's sums the same whatever the
            # process layout
            torch.set_num_threads(1)
        try:
            g.start(pos)
            results[(gi, pos)] = work(gi, comm)
        except BaseException as e:  # nmfx: ignore[NMFX006] -- re-raised
            # by the caller
            errors[(gi, pos)] = e
            g.abort()
        else:
            g.finish(pos)

    if len(jobs) == 1:
        serve(*jobs[0])
    else:
        threads = [threading.Thread(target=serve, args=job, daemon=True,
                                    name=f"nmfx-grid-{job[0]}-{job[1]}")
                   for job in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        # an aborted group is the echo of a peer's failure: raise the cause
        real = {j: e for j, e in errors.items()
                if not isinstance(e, GroupAborted)}
        raise (real or errors)[min(real or errors)]
    return results


def device_context(dev: torch.device):
    """The context a shard's thread runs under: its card selected."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())
