"""Out-of-core tile pipeline: solves that stream A from the host
(counterpart of ``nmfx/tiles.py``).

The in-core engines keep A on the device for every update; the atlases
users submit may not fit there. Following "Distributed Out-of-Memory
NMF" (arxiv 2202.09518) on one device, A is partitioned into
feature-axis (row) blocks sized to a device budget; W, H and the whole
restart pool stay resident on the device, and the blocks stream through
the mu / hals updates. mu and hals consume A only through the
contractions WᵀA and AHᵀ (MPI-FAUN, arxiv 1609.09154), so each tile's
contribution reduces into k×n / k×k terms and the whole matrix never
needs to be on the device at once.

Per-iteration schedule, ONE pass over A:

* head (no A): the H half-step. mu reads the carried numerator
  C = WᵀA (accumulated by the previous pass) and computes
  H ← update(H, C, (WᵀW)H); hals replays its k coordinate updates from
  the carried (WᵀA, WᵀW). Then HHᵀ from the fresh H.
* tile pass (streams A): for each row block t in FIXED tile order, the W
  half-step on the resident slice W[t] from A_t·Hᵀ and the shared HHᵀ,
  then the accumulation of the NEXT iteration's carried Grams (W_newᵀA
  and, for hals, W_newᵀW_new) in float32.

The residual that hals's TolFun check and every final result need
comes from Gram terms: ‖A − WH‖² = ‖A‖² − 2⟨WᵀA, H⟩ + ⟨WᵀW, HHᵀ⟩, and the
pass already produced WᵀA.

The stream on the card (:class:`TileStream`): PyTorch copies from
pageable host memory synchronously, so a tile is staged through one of
two pinned host buffers (one per tile in flight), copied with
``non_blocking=True`` on a dedicated copy stream into one of two
persistent device buffers, and an event recorded after the copy; the
compute stream waits on that event on the device. A staging buffer is
refilled only after the host has waited on its last copy's event, and a
device buffer is overwritten only after the copy stream has waited on
the event recorded once the compute that reads it was queued. Sparse
tiles travel as CSR (``indptr``/``indices``/``data``); on the device a
stable sort orders the tile's entries by column as well. Both sparse
products are segment reductions (gather, multiply, ``segment_reduce``):
A_t·Hᵀ over each row's entries, WᵀA_t over each column's, every output
summed in stored order by one thread, with no atomics, so the results
repeat bit for bit. (cuSPARSE's CSR product, as ``torch.sparse.mm``
calls it, does not repeat on the card: measured on an H100.) Products
run in the solve dtype with TF32 off (``nmfx_torch.device.
resolve_device``). Nothing falls back: a failed pin, copy or sparse
product raises.

Engine-family contract:

* a dense input whose config resolves to ONE tile never reaches this
  module: ``sweep.sweep`` runs the in-core path with ``tile_rows``
  stripped, byte-equal to the dense sweep by construction;
* multi-tile (and every sparse) solve runs here as the engine family
  ``"tiled"``: the fixed tile order and float32 accumulators make the
  reduction deterministic, so streamed runs are byte-equal against
  themselves (prefetch on or off, resumed or uninterrupted) and agree
  with the dense ones at the agreement tier (``nmfx_torch/agreement.py``).
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import NamedTuple

import numpy as np
import torch

from nmfx_torch import random as _random
from nmfx_torch.config import TILED_ALGORITHMS, InitConfig, SolverConfig
from nmfx_torch.device import resolve_device
from nmfx_torch.init import random_init
from nmfx_torch.obs import metrics as _metrics
from nmfx_torch.profiling import NullProfiler
from nmfx_torch.solvers.base import (StopReason, bf16_operand,
                                     bf16_products, class_labels, clamp,
                                     maxchange, mm)
from nmfx_torch.solvers.mu import _mu_update
from nmfx_torch.sparse import SparseMatrix, note_sparse_tile

__all__ = [
    "TilePlan", "TileStream", "TiledState", "TiledPoolResult",
    "plan_for", "resolve_tile_rows", "tile_budget_bytes",
    "set_tile_budget_bytes", "set_tile_prefetch", "tile_prefetch_enabled",
    "run_tiled_pool", "sweep_one_k_tiled", "solve_chunk_tiled",
    "partial_payload", "resume_from_payload",
]

#: profiler phases (``xfer.`` = overlap class, ``profiling.OVERLAP_
#: PREFIXES``): the host's staging and dispatch of a tile's copy, and the
#: host's waits on a copy's event; the overlap ratio is 1 − wait/solve
TILE_XFER_PHASE = "xfer.h2d_tile"
TILE_WAIT_PHASE = "xfer.h2d_tile_wait"

_tile_passes_total = _metrics.counter(
    "nmfx_tile_passes_total",
    "full streaming passes over A by the out-of-core tile pipeline")
_tile_h2d_bytes_total = _metrics.counter(
    "nmfx_tile_h2d_bytes_total",
    "bytes of tile payloads transferred host-to-device by the tile "
    "pipeline")
_tile_partial_resumes_total = _metrics.counter(
    "nmfx_tile_partial_resumes_total",
    "tiled chunk solves resumed mid-matrix from a partial checkpoint "
    "record")


def note_partial_resume() -> None:
    """Book one mid-matrix resume."""
    _tile_partial_resumes_total.inc()


# -- device budget -----------------------------------------------------------

#: default working-set budget of the streamed tiles: two buffers (current
#: and prefetched) must fit, so a tile gets half of it
_DEFAULT_TILE_BUDGET_BYTES = 256 << 20

_budget_override: "int | None" = None


def set_tile_budget_bytes(nbytes: "int | None") -> None:
    """Process-wide override of the tile budget (None restores the
    environment / default chain)."""
    global _budget_override
    if nbytes is not None and int(nbytes) < 1:
        raise ValueError(f"tile budget must be >= 1 byte, got {nbytes}")
    _budget_override = None if nbytes is None else int(nbytes)


def tile_budget_bytes() -> int:
    """The budget of the streamed tiles: the override, else the
    environment's ``NMFX_TILE_BUDGET_BYTES``, else 256 MiB."""
    if _budget_override is not None:
        return _budget_override
    env = os.environ.get("NMFX_TILE_BUDGET_BYTES", "").strip()
    if env:
        return max(1, int(env))
    return _DEFAULT_TILE_BUDGET_BYTES


_prefetch_enabled = True


def set_tile_prefetch(on: bool) -> None:
    """Toggle the next tile's prefetch (double buffering). Results are
    byte-equal either way; the toggle lets tests pin that and measure
    what the overlap buys."""
    global _prefetch_enabled
    _prefetch_enabled = bool(on)


def tile_prefetch_enabled() -> bool:
    return _prefetch_enabled


# -- tile plan ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Deterministic feature-axis partition of an (m, n) matrix into row
    blocks of ``tile_rows`` (the last one ragged). The plan is part of a
    tiled sweep's identity: the reduction order depends on it, so the
    checkpoint fingerprint hashes ``as_meta()``."""

    m: int
    n: int
    tile_rows: int

    def __post_init__(self):
        if self.m < 1 or self.n < 1:
            raise ValueError(f"degenerate matrix ({self.m}, {self.n})")
        if not 1 <= self.tile_rows:
            raise ValueError(f"tile_rows must be >= 1, got {self.tile_rows}")
        object.__setattr__(self, "tile_rows", min(self.tile_rows, self.m))

    @property
    def n_tiles(self) -> int:
        return -(-self.m // self.tile_rows)

    @property
    def boundaries(self) -> "tuple[tuple[int, int], ...]":
        return tuple((r0, min(r0 + self.tile_rows, self.m))
                     for r0 in range(0, self.m, self.tile_rows))

    def as_meta(self) -> dict:
        return {"m": self.m, "n": self.n, "tile_rows": self.tile_rows,
                "n_tiles": self.n_tiles}


def resolve_tile_rows(tile_rows, m: int, n: int, itemsize: int,
                      avg_row_bytes: "float | None" = None,
                      budget: "int | None" = None) -> int:
    """A ``SolverConfig.tile_rows`` value as a block height: ``"auto"``
    sizes blocks so two (current and prefetched) fit the byte budget;
    ints clamp to [1, m]."""
    if isinstance(tile_rows, int) and not isinstance(tile_rows, bool):
        return max(1, min(tile_rows, m))
    if tile_rows != "auto":
        raise ValueError(
            f"cannot resolve tile_rows={tile_rows!r} (expected an int or "
            "'auto')")
    if budget is None:
        budget = tile_budget_bytes()
    row_bytes = float(avg_row_bytes) if avg_row_bytes else float(n * itemsize)
    row_bytes = max(row_bytes, 1.0)
    rows = int(budget // (2.0 * row_bytes))
    return max(1, min(rows, m))


def _itemsize(dtype: str) -> int:
    return 8 if dtype == "float64" else 4


def plan_for(source, solver_cfg: SolverConfig) -> TilePlan:
    """The tile plan a config implies for ``source`` (a dense host array
    or a :class:`~nmfx_torch.sparse.SparseMatrix`). ``tile_rows=None`` on
    a sparse source is one whole-matrix tile (sparse inputs always run
    the tiled engine: there is no dense in-core path to hand them to)."""
    m, n = int(source.shape[0]), int(source.shape[1])
    itemsize = _itemsize(solver_cfg.dtype)
    tr = solver_cfg.tile_rows
    if tr is None:
        return TilePlan(m, n, m)
    avg_row_bytes = None
    if isinstance(source, SparseMatrix):
        # the reference's stored-nonzero payload per row: the value and
        # a (row, col) int32 pair
        avg_row_bytes = (source.nnz / max(m, 1)) * (itemsize + 8)
    rows = resolve_tile_rows(tr, m, n, itemsize, avg_row_bytes=avg_row_bytes)
    return TilePlan(m, n, rows)


# -- tile stream -------------------------------------------------------------

def _np_dtype(dtype: str):
    return np.float64 if dtype == "float64" else np.float32


def _torch_dtype(dtype: str):
    return torch.float64 if dtype == "float64" else torch.float32


def _host_tensor(x) -> torch.Tensor:
    """A host array as a tensor sharing its memory (only read here, so a
    read-only source, such as a memory map, is taken without torch's
    warning about writes)."""
    arr = np.asarray(x)
    if arr.flags.writeable:
        return torch.from_numpy(arr)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr)


class _SparseTile(NamedTuple):
    """One row block's host CSR, in the order its arrays lie in a staging
    buffer: the values first (naturally aligned for the solve dtype),
    then the int32 index arrays."""

    data: np.ndarray  # (nnz,) solve dtype
    indptr: np.ndarray  # (mt + 1,) int32, local offsets
    indices: np.ndarray  # (nnz,) int32, a view of the source

    def nbytes(self, itemsize: int) -> int:
        return (len(self.data) * itemsize + self.indptr.nbytes
                + self.indices.nbytes)


def _sparse_tile(source: SparseMatrix, r0: int, r1: int,
                 np_dt) -> _SparseTile:
    """Rows ``[r0, r1)`` of ``source`` as CSR: the values cast to the
    solve dtype once here (a view when the source has it), so a pass
    stages plain copies; the indices a view, the offsets made local."""
    p0, p1 = int(source.indptr[r0]), int(source.indptr[r1])
    return _SparseTile(
        data=np.asarray(source.data[p0:p1], np_dt),
        indptr=(source.indptr[r0:r1 + 1] - p0).astype(np.int32),
        indices=source.indices[p0:p1])


class _SparseBlock(NamedTuple):
    """A streamed sparse tile on the device: its entries row-major (CSR
    order) and sorted by column (a stable sort, made on the device each
    pass), each with the segment offsets the products reduce over."""

    shape: tuple  # (mt, n)
    offsets: torch.Tensor  # (mt + 1,) int64 row offsets
    cols: torch.Tensor  # (nnz,) int64
    values: torch.Tensor  # (nnz,)
    offsets_t: torch.Tensor  # (n + 1,) int64 column offsets
    rows_t: torch.Tensor  # (nnz,) int64 row of each column-sorted entry
    values_t: torch.Tensor  # (nnz,)


def _sparse_block(indptr: torch.Tensor, indices: torch.Tensor,
                  data: torch.Tensor, mt: int, n: int) -> _SparseBlock:
    """A tile's CSR arrays as a :class:`_SparseBlock`, on their device
    and without a host read (the nonzero count is the array's length)."""
    offsets = indptr.long()
    cols = indices.long()
    dev = cols.device
    rows = torch.repeat_interleave(torch.arange(mt, device=dev),
                                   torch.diff(offsets),
                                   output_size=cols.shape[0])
    cols_sorted, perm = torch.sort(cols, stable=True)
    offsets_t = torch.searchsorted(cols_sorted, torch.arange(n + 1,
                                                             device=dev))
    return _SparseBlock((mt, n), offsets, cols, data, offsets_t,
                        rows[perm], data[perm])


class TileStream:
    """Streams a host matrix's row blocks to the device, double-buffered:
    tile t+1's copy is dispatched before tile t is consumed, so it runs
    under tile t's compute. The bytes of a tile are the same with
    prefetch on or off, so the toggle cannot change results.

    Dense sources yield ``(mt, n)`` tensors; sparse sources yield
    :class:`_SparseBlock` (the CSR arrays, and the entries sorted by
    column on the device).

    On CUDA, tiles move through two pinned staging buffers and two
    persistent device buffers with a dedicated copy stream (see the
    module docstring); on the CPU each tile is a fresh host tensor.
    Accounting: the staging and dispatch book to ``xfer.h2d_tile``, the
    host's waits on a copy's event to ``xfer.h2d_tile_wait``; the bytes
    sent to ``nmfx_tile_h2d_bytes_total``, and sparse payloads also to
    ``nmfx_sparse_nnz_total`` / ``nmfx_sparse_nnz_bytes_total``."""

    def __init__(self, source, plan: TilePlan, dtype: str = "float32",
                 device="cpu", profiler=None,
                 prefetch: "bool | None" = None):
        if tuple(int(s) for s in source.shape) != (plan.m, plan.n):
            raise ValueError(
                f"source shape {tuple(source.shape)} does not match plan "
                f"({plan.m}, {plan.n})")
        self.source = source
        self.plan = plan
        self.dtype = _torch_dtype(dtype)
        self.device = torch.device(device)
        self.profiler = profiler if profiler is not None else NullProfiler()
        self.prefetch = (tile_prefetch_enabled() if prefetch is None
                         else bool(prefetch))
        self.sparse = isinstance(source, SparseMatrix)
        self._sparse_tiles = (
            [_sparse_tile(source, r0, r1, _np_dtype(dtype))
             for r0, r1 in plan.boundaries] if self.sparse else None)
        self._cuda = self.device.type == "cuda"
        self._seq = 0
        if self._cuda:
            self._open_staging()

    def tile_nbytes(self, t: int) -> int:
        """The bytes tile t sends to the device."""
        if self.sparse:
            return self._sparse_tiles[t].nbytes(self.dtype.itemsize)
        r0, r1 = self.plan.boundaries[t]
        return (r1 - r0) * self.plan.n * self.dtype.itemsize

    def _open_staging(self) -> None:
        size = max(self.tile_nbytes(t) for t in range(self.plan.n_tiles))
        self._compute = torch.cuda.current_stream(self.device)
        self._copy = torch.cuda.Stream(device=self.device)
        self._host = [torch.empty(size, dtype=torch.uint8, pin_memory=True)
                      for _ in range(2)]
        self._dev = [torch.empty(size, dtype=torch.uint8, device=self.device)
                     for _ in range(2)]
        for buf in self._dev:
            # the copy stream writes these: the allocator must not hand
            # them out again before its work is done
            buf.record_stream(self._copy)
        self._copied = [None, None]  # event after the slot's last copy
        self._consumed = [None, None]  # event after its last reader

    # -- staging ------------------------------------------------------------
    def _fill(self, t: int, dst: torch.Tensor) -> "list[tuple[int, int]]":
        """Write tile t's payload into the byte buffer ``dst`` with
        torch's host copies, which cast to the solve dtype on the way
        and run on the intra-op threads; returns each array's (offset,
        nbytes) in the layout order."""
        r0, r1 = self.plan.boundaries[t]
        if not self.sparse:
            nb = self.tile_nbytes(t)
            dst[:nb].view(self.dtype).view(r1 - r0, self.plan.n).copy_(
                _host_tensor(self.source[r0:r1]))
            return [(0, nb)]
        tile = self._sparse_tiles[t]
        spans, off = [], 0
        for arr, dt in ((tile.data, self.dtype), (tile.indptr, torch.int32),
                        (tile.indices, torch.int32)):
            nb = len(arr) * dt.itemsize
            dst[off:off + nb].view(dt).copy_(_host_tensor(arr))
            spans.append((off, nb))
            off += nb
        return spans

    def _wrap(self, t: int, buf: torch.Tensor, spans):
        """Tile t from the (device or host) byte buffer it was copied to;
        a sparse tile's device work runs on the current stream, so on
        CUDA only after the compute stream waits for the copy."""
        r0, r1 = self.plan.boundaries[t]
        mt, n = r1 - r0, self.plan.n

        def part(i, dt):
            off, nb = spans[i]
            return buf[off:off + nb].view(dt)

        if not self.sparse:
            return part(0, self.dtype).view(mt, n)
        return _sparse_block(part(1, torch.int32), part(2, torch.int32),
                             part(0, self.dtype), mt, n)

    def _put(self, t: int):
        """Stage tile t and dispatch its host-to-device copy (on CUDA the
        slot's last copy is waited for first)."""
        nbytes = self.tile_nbytes(t)
        if not self._cuda:
            t0 = time.perf_counter()
            host = torch.empty(nbytes, dtype=torch.uint8)
            spans = self._fill(t, host)
            self._book(t, nbytes, t0)
            return self._wrap(t, host, spans)
        slot = self._seq % 2
        self._seq += 1
        if self._copied[slot] is not None:
            # never refill a staging buffer whose copy is in flight
            t0 = time.perf_counter()
            self._copied[slot].synchronize()
            self.profiler.add_seconds(TILE_WAIT_PHASE,
                                      time.perf_counter() - t0)
        t0 = time.perf_counter()
        spans = self._fill(t, self._host[slot])
        with torch.cuda.stream(self._copy):
            if self._consumed[slot] is not None:
                # the device buffer is overwritten only after the compute
                # that read its last tile
                self._copy.wait_event(self._consumed[slot])
            self._dev[slot][:nbytes].copy_(self._host[slot][:nbytes],
                                           non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._copy)
        self._copied[slot] = event
        self._book(t, nbytes, t0)
        return slot, spans

    def _book(self, t: int, nbytes: int, t0: float) -> None:
        if self.sparse:
            note_sparse_tile(len(self._sparse_tiles[t].data), nbytes)
        _tile_h2d_bytes_total.inc(nbytes)
        self.profiler.add_seconds(TILE_XFER_PHASE, time.perf_counter() - t0)

    def _wait(self, put, t: int):
        """Make the compute stream wait (on the device) for tile t's copy;
        the host's time here books to ``xfer.h2d_tile_wait``."""
        if not self._cuda:
            return put
        t0 = time.perf_counter()
        slot, spans = put
        self._compute.wait_event(self._copied[slot])
        self.profiler.add_seconds(TILE_WAIT_PHASE, time.perf_counter() - t0)
        return self._wrap(t, self._dev[slot], spans)

    def _release(self, put) -> None:
        """The compute reading tile ``put`` is queued: record the event the
        next copy into its device buffer waits on."""
        if self._cuda:
            event = torch.cuda.Event()
            event.record(self._compute)
            self._consumed[put[0]] = event

    def tiles(self):
        """One full pass over A in fixed tile order: yields
        ``(t, r0, r1, a_t)`` with ``a_t`` usable on the compute stream."""
        _tile_passes_total.inc()
        nt = self.plan.n_tiles
        pending: dict = {}
        for t in range(nt):
            if t not in pending:
                pending[t] = self._put(t)
            if self.prefetch and t + 1 < nt and t + 1 not in pending:
                pending[t + 1] = self._put(t + 1)
            put = pending.pop(t)
            a_t = self._wait(put, t)
            r0, r1 = self.plan.boundaries[t]
            yield t, r0, r1, a_t
            self._release(put)


# -- tiled engine ------------------------------------------------------------

class TiledState(NamedTuple):
    """Device-resident restart-pool carry (leading axis = restarts),
    mirroring ``solvers.base.State`` under the batched loop."""

    w: torch.Tensor  # (R, m, k)
    h: torch.Tensor  # (R, k, n)
    w_prev: torch.Tensor  # (R, m, k)
    h_prev: torch.Tensor  # (R, k, n)
    iteration: torch.Tensor  # (R,) i32
    dnorm: torch.Tensor  # (R,) residual at the last check, inf until then
    classes: torch.Tensor  # (R, n) i32
    stable: torch.Tensor  # (R,) i32
    done: torch.Tensor  # (R,) bool
    stop_reason: torch.Tensor  # (R,) i32 StopReason


class TiledPoolResult(NamedTuple):
    w: torch.Tensor  # (R, m, k)
    h: torch.Tensor  # (R, k, n)
    iterations: torch.Tensor  # (R,)
    dnorm: torch.Tensor  # (R,) final ||A - W H||_F / sqrt(m n)
    stop_reason: torch.Tensor  # (R,)
    #: device→host reads of the lanes' done flags
    host_syncs: int = 0


def _stack_lanes(h: torch.Tensor) -> torch.Tensor:
    """(R, k, n) → (n, R·k): the lanes' H as one dense operand, so a
    tile's A_t·Hᵀ is one product for the whole pool."""
    r, k, n = h.shape
    return h.permute(2, 0, 1).reshape(n, r * k)


#: elements of one sparse product's gathered (nnz × lanes) block; a wider
#: lane stack is contracted in column chunks of at most this many
_SEGMENT_ELEMS = 1 << 26


def _segment_product(values: torch.Tensor, gather: torch.Tensor,
                     offsets: torch.Tensor, dense: torch.Tensor
                     ) -> torch.Tensor:
    """``out[s] = Σ_p values[p] · dense[gather[p]]`` over each segment
    ``p ∈ [offsets[s], offsets[s + 1])``: one gather, one product, one
    ``segment_reduce``, which sums every output in the stored order in
    one thread, so the result does not change from run to run (cuSPARSE's
    CSR product, as ``torch.sparse.mm`` calls it, does on the card)."""
    nnz, width = values.shape[0], dense.shape[1]
    step = max(1, _SEGMENT_ELEMS // max(nnz, 1))
    parts = [torch.segment_reduce(
        dense[gather, c0:c0 + step].mul_(values[:, None]), "sum",
        offsets=offsets, axis=0, unsafe=True)
        for c0 in range(0, width, step)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _round_operands(bf: bool, *xs):
    """The operands as ``base.mm`` takes them: rounded to bf16 under
    ``bf`` (``base.bf16_products``)."""
    return xs if not bf else tuple(bf16_operand(x) for x in xs)


def _contract_ah(a_t, hs: torch.Tensor, r: int, k: int,
                 bf: bool = False) -> torch.Tensor:
    """(A_t)·Hᵀ over the lane stack: (mt, n) × (n, R·k) → (R, mt, k).
    A sparse tile contracts its stored nonzeros row by row (its values
    and the dense operand rounded under ``bf``, as a dense product's)."""
    if isinstance(a_t, _SparseBlock):
        values, hs = _round_operands(bf, a_t.values, hs)
        out = _segment_product(values, a_t.cols, a_t.offsets, hs)
    else:
        out = mm(a_t, hs, bf)  # (mt, R·k)
    return out.reshape(-1, r, k).permute(1, 0, 2)


def _contract_wa(a_t, w_t: torch.Tensor, bf: bool = False) -> torch.Tensor:
    """(W_t)ᵀ·A_t over the lane stack: (R, mt, k) × (mt, n) → (R, k, n),
    the tile's part of the carried numerator WᵀA. A sparse tile contracts
    column by column over its column-sorted entries."""
    r, mt, k = w_t.shape
    ws = w_t.permute(1, 0, 2).reshape(mt, r * k)
    if isinstance(a_t, _SparseBlock):
        values, ws = _round_operands(bf, a_t.values_t, ws)
        out = _segment_product(values, a_t.rows_t, a_t.offsets_t, ws)
        return out.reshape(-1, r, k).permute(1, 2, 0)
    return mm(ws.mT, a_t, bf).reshape(r, k, -1)


def _zero_carry(algorithm: str, r: int, k: int, n: int, device):
    """Fresh float32 Gram accumulators for one pass."""
    z = torch.zeros((r, k, n), dtype=torch.float32, device=device)
    if algorithm == "mu":
        return (z,)
    return (z, torch.zeros((r, k, k), dtype=torch.float32, device=device))


def _zero_inner(r: int, device) -> torch.Tensor:
    return torch.zeros((r,), dtype=torch.float32, device=device)


def _lanes(mask: torch.Tensor) -> torch.Tensor:
    return mask[:, None, None]


def _head_update(state: TiledState, carry, cfg: SolverConfig):
    """The A-free half of one iteration: previous-factor snapshots and
    per-lane iteration advance (masked as the batched loop masks them),
    the H half-step from the carried Grams, then HHᵀ from the fresh H.
    Returns the state (with a fresh W tensor the tile pass updates in
    place) and HHᵀ."""
    active = ~state.done
    mask = _lanes(active)
    w_prev = torch.where(mask, state.w, state.w_prev)
    h_prev = torch.where(mask, state.h, state.h_prev)
    iteration = state.iteration + active.to(torch.int32)
    h0 = state.h
    dtype = h0.dtype
    bf = bf16_products(cfg, h0.device)
    if cfg.algorithm == "mu":
        # H ← H ∘ (WᵀA) / ((WᵀW)H + ε), numerator from the carry
        gram = mm(state.w.mT, state.w, bf)
        h = _mu_update(h0, carry[0].to(dtype), mm(gram, h0, bf),
                       cfg.div_eps, cfg.zero_threshold)
    else:  # hals: k coordinate updates against the carried Grams
        wta = carry[0].to(dtype)
        wtw = carry[1].to(dtype)
        h = h0.clone()
        for j in range(h0.shape[1]):
            hj = h[:, j, :] + (
                wta[:, j, :] - mm(wtw[:, j, None, :], h, bf)[:, 0, :]
            ) / (wtw[:, j, j][:, None] + cfg.div_eps)
            h[:, j, :] = clamp(hj, cfg.zero_threshold)
    h = torch.where(mask, h, h0)
    hht = mm(h, h.mT, bf)
    state = state._replace(w=state.w.clone(), h=h, w_prev=w_prev,
                           h_prev=h_prev, iteration=iteration)
    return state, hht


def _accumulate(carry, inner, cw, h, w_t, algorithm: str,
                need_inner: bool = True, bf: bool = False):
    """Add one tile's WᵀA (and, for hals, WᵀW) to the float32 carry and,
    when a check or the final residual will read it, its ⟨WᵀA, H⟩ to
    ``inner``."""
    if need_inner:
        inner = inner + (cw.to(torch.float32) * h.to(torch.float32)).sum(
            dim=(1, 2))
    if algorithm == "mu":
        return (carry[0] + cw.to(torch.float32),), inner
    wtw_t = mm(w_t.mT, w_t, bf)
    return (carry[0] + cw.to(torch.float32),
            carry[1] + wtw_t.to(torch.float32)), inner


def _tile_update(state: TiledState, hht, hs, carry, inner, a_t, r0: int,
                 cfg: SolverConfig, need_inner: bool = True):
    """One tile of the W half-step and of the next carry. Frozen lanes
    keep their W slice bit for bit, and their carry part is recomputed
    from unchanged factors, so it is the same every pass (what lets a
    resumed solve replay exactly). Writes the new slice into ``state.w``
    (the head's fresh tensor). ``need_inner=False`` skips ⟨WᵀA, H⟩ on a
    pass whose check does not read it."""
    r, _, k = state.w.shape
    mt = a_t.shape[0]
    mask = _lanes(~state.done)
    w_t = state.w[:, r0:r0 + mt, :]
    bf = bf16_products(cfg, w_t.device)
    aht = _contract_ah(a_t, hs, r, k, bf)  # (R, mt, k), H is fresh
    if cfg.algorithm == "mu":
        w_new = _mu_update(w_t, aht, mm(w_t, hht, bf), cfg.div_eps,
                           cfg.zero_threshold)
    else:  # hals: coordinate updates are row-local, hence tile-local
        w_new = w_t.clone()
        for j in range(k):
            wj = w_new[:, :, j] + (
                aht[:, :, j] - mm(w_new, hht[:, j, :, None], bf)[:, :, 0]
            ) / (hht[:, j, j][:, None] + cfg.div_eps)
            w_new[:, :, j] = clamp(wj, cfg.zero_threshold)
    w_new = torch.where(mask, w_new, w_t)
    cw = _contract_wa(a_t, w_new, bf)  # (R, k, n)
    carry, inner = _accumulate(carry, inner, cw, state.h, w_new,
                               cfg.algorithm, need_inner, bf)
    state.w[:, r0:r0 + mt, :] = w_new
    return carry, inner


def _tile_accumulate(state: TiledState, carry, inner, a_t, r0: int,
                     cfg: SolverConfig, need_inner: bool = True):
    """Gram accumulation without a factor update: the prologue pass
    (iteration 1's carry from W0; its ⟨WᵀA, H⟩ is never read) and the
    final residual pass."""
    mt = a_t.shape[0]
    w_t = state.w[:, r0:r0 + mt, :]
    bf = bf16_products(cfg, w_t.device)
    cw = _contract_wa(a_t, w_t, bf)
    return _accumulate(carry, inner, cw, state.h, w_t, cfg.algorithm,
                       need_inner, bf)


def _gram_dnorm(state: TiledState, inner, nrm_a_sq,
                bf: bool = False) -> torch.Tensor:
    """RMS residual from Gram terms only (no pass over A):
    ‖A − WH‖² = ‖A‖² − 2⟨WᵀA, H⟩ + ⟨WᵀW, HHᵀ⟩, clamped at 0 against
    float32 cancellation near convergence."""
    m = state.w.shape[1]
    n = state.h.shape[2]
    gram = mm(state.w.mT, state.w, bf)
    hht = mm(state.h, state.h.mT, bf)
    cross = (gram.to(torch.float32) * hht.to(torch.float32)).sum(dim=(1, 2))
    sq = torch.clamp(nrm_a_sq - 2.0 * inner + cross, min=0.0)
    return torch.sqrt(sq / (m * n)).to(state.dnorm.dtype)


def _tiled_check(state: TiledState, inner, nrm_a_sq,
                 cfg: SolverConfig) -> TiledState:
    """Per-lane convergence tests, the reference's batched transcription
    of ``check_convergence`` (same order: nonfinite guard first, then
    class stability, TolX, TolFun). The TolFun residual is the Gram-form
    one of the pass just finished. mu checks class stability and TolX,
    hals also TolFun, as each solver's in-core step does."""
    it = state.iteration
    is_check = (it > 1) & (it % cfg.check_every == 0) & (~state.done)
    done = state.done
    reason = state.stop_reason

    if cfg.nonfinite_guard:
        bad_w = ~torch.isfinite(state.w).all(dim=2).all(dim=1)
        bad_h = ~torch.isfinite(state.h).all(dim=2).all(dim=1)
        faulted = is_check & (bad_w | bad_h)
        done = done | faulted
        is_check = is_check & ~faulted
        reason = torch.where(faulted, int(StopReason.NUMERIC_FAULT), reason)

    classes, stable = state.classes, state.stable
    if cfg.use_class_stop:
        new_classes = class_labels(state.h)
        flip_tol = int(cfg.class_flip_tol * new_classes.shape[1] + 1e-9)
        mism = (new_classes != state.classes).sum(dim=1, dtype=torch.int32)
        same = mism <= flip_tol
        stable = torch.where(is_check, torch.where(same, state.stable + 1, 0),
                             state.stable).to(torch.int32)
        classes = torch.where((is_check & ~same)[:, None], new_classes,
                              state.classes)
        hit = is_check & (stable >= cfg.stable_checks)
        done = done | hit
        reason = torch.where(hit, int(StopReason.CLASS_STABLE), reason)

    if cfg.use_tol_checks:
        delta = torch.maximum(maxchange(state.w, state.w_prev),
                              maxchange(state.h, state.h_prev))
        hit = is_check & (delta < cfg.tol_x) & ~done
        done = done | hit
        reason = torch.where(hit, int(StopReason.TOL_X), reason)

    dnorm = state.dnorm
    if cfg.algorithm == "hals" and cfg.use_tol_checks:
        new_dnorm = _gram_dnorm(state, inner, nrm_a_sq,
                                bf16_products(cfg, state.w.device))
        hit = (is_check & torch.isfinite(state.dnorm)
               & (state.dnorm - new_dnorm <= cfg.tol_fun * state.dnorm)
               & ~done)
        dnorm = torch.where(is_check, new_dnorm, state.dnorm)
        done = done | hit
        reason = torch.where(hit, int(StopReason.TOL_FUN), reason)

    return state._replace(classes=classes, stable=stable, done=done,
                          stop_reason=reason.to(torch.int32), dnorm=dnorm)


# -- partial-progress payloads (mid-matrix checkpoint records) ---------------

_STATE_FIELDS = TiledState._fields


def _to_host(t: torch.Tensor) -> np.ndarray:
    """One tensor of a partial record, copied to the host (at a check the
    checkpoint asks for, never in a pass)."""
    return t.detach().cpu().numpy()  # nmfx: ignore[NMFX005] -- a partial record


def partial_payload(state: TiledState, carry, step: int
                    ) -> "dict[str, np.ndarray]":
    """Mid-solve progress as host arrays for an npz partial record
    (``nmfx_torch/checkpoint.py``): the pool state, the carried Grams
    the next head reads, and the completed step count."""
    out = {f: _to_host(v) for f, v in zip(_STATE_FIELDS, state)}
    for i, c in enumerate(carry):
        out[f"carry{i}"] = _to_host(c)
    out["step"] = np.asarray(int(step), np.int64)
    return out


def resume_from_payload(payload, device="cpu"
                        ) -> "tuple[TiledState, tuple, int]":
    """Inverse of :func:`partial_payload`. The host round trip of the
    saved arrays is exact and every pass is deterministic on equal
    inputs, so a resumed solve is byte-equal to the uninterrupted one."""
    state = TiledState(*(torch.as_tensor(np.asarray(payload[f]),
                                         device=device)
                         for f in _STATE_FIELDS))
    n_carry = sum(1 for f in payload.keys() if str(f).startswith("carry"))
    carry = tuple(torch.as_tensor(np.asarray(payload[f"carry{i}"]),
                                  device=device)
                  for i in range(n_carry))
    note_partial_resume()
    return state, carry, int(payload["step"])


# -- host loop ---------------------------------------------------------------

def _source_sq_norm(source, dtype: str, plan: TilePlan) -> float:
    """‖A‖² of the source cast to the solve dtype, summed in float64 on
    the host tile by tile (never a dense copy of the whole matrix): the
    constant term of the Gram-form residual."""
    np_dt = _np_dtype(dtype)
    if isinstance(source, SparseMatrix):
        data = np.asarray(source.data, np_dt).astype(np.float64)
        return float(np.sum(data * data))
    total = 0.0
    for r0, r1 in plan.boundaries:
        blk = np.asarray(source[r0:r1], np_dt).astype(np.float64)
        total += float(np.sum(blk * blk))
    return total


def _initial_state(keys, m: int, n: int, k: int, init_cfg: InitConfig,
                   dtype: str, device, poison: tuple) -> TiledState:
    from nmfx_torch.sweep import _poison_restart_lanes

    np_dt = _np_dtype(dtype)
    pairs = [random_init(kk, m, n, k, init_cfg, np_dt) for kk in keys]
    w0 = torch.from_numpy(np.stack([p[0] for p in pairs])).to(device)
    h0 = torch.from_numpy(np.stack([p[1] for p in pairs])).to(device)
    w0 = _poison_restart_lanes(w0, poison)
    r = len(pairs)

    def full(shape, value, dt):
        return torch.full(shape, value, dtype=dt, device=device)

    return TiledState(
        w=w0, h=h0, w_prev=w0, h_prev=h0,
        iteration=full((r,), 0, torch.int32),
        dnorm=full((r,), float("inf"), _torch_dtype(dtype)),
        classes=full((r, n), -1, torch.int32),
        stable=full((r,), 0, torch.int32),
        done=full((r,), False, torch.bool),
        stop_reason=full((r,), int(StopReason.MAX_ITER), torch.int32))


def run_tiled_pool(source, keys, k: int, solver_cfg: SolverConfig,
                   init_cfg: InitConfig, *, plan: "TilePlan | None" = None,
                   profiler=None, poison: tuple = (), resume=None,
                   on_check=None, device=None) -> TiledPoolResult:
    """Solve a restart pool out-of-core: a host loop whose iteration is
    the head (the A-free H half-step) then one streaming W pass over A,
    with per-lane freeze masks as in the batched in-core loop (checks at
    ``check_every`` multiples past iteration 1; frozen lanes never
    advance). ``keys`` (R, 2) are the per-restart keys, a slice of the
    canonical ``split(fold_in(key(seed), k), restarts)`` chain.

    ``resume`` is a :func:`partial_payload` mapping to continue from;
    ``on_check(step, state, carry)`` runs after every convergence check
    (where the host reads the done flags anyway): the checkpoint layer
    saves partials and rehearses preemptions there. ``device``: None =
    CUDA (raising without one), or "cpu"."""
    if solver_cfg.algorithm not in TILED_ALGORITHMS:
        raise ValueError(
            "the out-of-core tile pipeline implements the Gram-"
            f"accumulation algorithms {TILED_ALGORITHMS}, got "
            f"algorithm={solver_cfg.algorithm!r}")
    if init_cfg.method != "random":
        raise ValueError(
            "tiled solves need init method 'random' (shape-only, key-"
            "deterministic); nndsvd reads the full matrix, which an "
            "out-of-core solve cannot hold")
    if profiler is None:
        profiler = NullProfiler()
    dev = resolve_device(device)
    dtype = solver_cfg.dtype
    m, n = int(source.shape[0]), int(source.shape[1])
    if plan is None:
        plan = plan_for(source, solver_cfg)
    stream = TileStream(source, plan, dtype, dev, profiler=profiler)
    nrm_a_sq = torch.tensor(_source_sq_norm(source, dtype, plan),
                            dtype=torch.float32, device=dev)
    algo = solver_cfg.algorithm
    keys = np.asarray(keys)
    r = keys.shape[0]
    if resume is None:
        state = _initial_state(keys, m, n, k, init_cfg, dtype, dev, poison)
        carry = _zero_carry(algo, r, k, n, dev)
        inner = _zero_inner(r, dev)
        # prologue: iteration 1's Gram carry from W0 (the in-core step 1
        # computes WᵀA / WᵀW from W0 directly; here it streams)
        for _, r0, _r1, a_t in stream.tiles():
            carry, inner = _tile_accumulate(state, carry, inner, a_t, r0,
                                            solver_cfg, need_inner=False)
        start = 0
    else:
        state, carry, start = resume_from_payload(resume, dev)

    syncs = 1
    done_host = state.done.cpu().numpy()  # nmfx: ignore[NMFX005] -- the done read
    for step in range(start + 1, solver_cfg.max_iter + 1):
        if done_host.all():
            break
        state, hht = _head_update(state, carry, solver_cfg)
        hs = _stack_lanes(state.h)
        carry = _zero_carry(algo, r, k, n, dev)
        inner = _zero_inner(r, dev)
        check = step > 1 and step % solver_cfg.check_every == 0
        # ⟨WᵀA, H⟩ feeds hals' TolFun residual at a check, nothing else
        need_inner = check and algo == "hals" and solver_cfg.use_tol_checks
        for _, r0, _r1, a_t in stream.tiles():
            carry, inner = _tile_update(state, hht, hs, carry, inner, a_t,
                                        r0, solver_cfg, need_inner)
        if check:
            state = _tiled_check(state, inner, nrm_a_sq, solver_cfg)
            done_host = state.done.cpu().numpy()  # nmfx: ignore[NMFX005] -- a check
            syncs += 1
            if on_check is not None:
                on_check(step, state, carry)

    # every lane's final residual, from one accumulation pass (also the
    # resumed-when-already-done case, where the loop above never ran)
    carry_f = _zero_carry(algo, r, k, n, dev)
    inner_f = _zero_inner(r, dev)
    for _, r0, _r1, a_t in stream.tiles():
        carry_f, inner_f = _tile_accumulate(state, carry_f, inner_f, a_t,
                                            r0, solver_cfg)
    dnorm = _gram_dnorm(state, inner_f, nrm_a_sq,
                        bf16_products(solver_cfg, state.w.device))
    return TiledPoolResult(w=state.w, h=state.h,
                           iterations=state.iteration, dnorm=dnorm,
                           stop_reason=state.stop_reason, host_syncs=syncs)


# -- sweep epilogues ---------------------------------------------------------

def sweep_one_k_tiled(source, key, k: int, restarts: int,
                      solver_cfg: SolverConfig, init_cfg: InitConfig,
                      label_rule: str = "argmax",
                      keep_factors: bool = False, profiler=None,
                      poison: tuple = (), *, plan: "TilePlan | None" = None,
                      device=None):
    """One rank's consensus sweep through the tiled engine, with the
    canonical key chain and the quarantine / consensus / best-restart
    epilogue the in-core routes share. ``key`` is the rank's folded
    key."""
    from nmfx_torch.consensus import labels_from_h
    from nmfx_torch.sweep import (KSweepOutput, _quarantine_lanes,
                                  _quarantined_consensus)

    keys = _random.split(key, restarts)
    res = run_tiled_pool(source, keys, k, solver_cfg, init_cfg, plan=plan,
                         profiler=profiler, poison=poison, device=device)
    labels = labels_from_h(res.h, label_rule)
    labels, dnorm_best, faulted = _quarantine_lanes(
        labels, res.dnorm, res.stop_reason)
    cons = _quarantined_consensus(labels, k, restarts, faulted)
    best = torch.argmin(dnorm_best)
    extra = (res.w, res.h) if keep_factors else (None, None)
    return KSweepOutput(cons, res.iterations, res.dnorm, res.stop_reason,
                        labels, res.w[best], res.h[best], *extra,
                        host_syncs=res.host_syncs)


def solve_chunk_tiled(source, keys, k: int, solver_cfg: SolverConfig,
                      init_cfg: InitConfig, label_rule: str,
                      poison: tuple = (), profiler=None, resume=None,
                      on_check=None, device=None):
    """One restart chunk through the tiled engine, as the durable
    ledger's ``ChunkSweepOutput`` (labels quarantine-masked to -1, raw
    dnorms, the chunk-local first-minimum best among survivors), so the
    ledger's finalize does not depend on the engine."""
    from nmfx_torch.consensus import labels_from_h
    from nmfx_torch.sweep import ChunkSweepOutput, _quarantine_lanes

    res = run_tiled_pool(source, keys, k, solver_cfg, init_cfg,
                         profiler=profiler, poison=poison, resume=resume,
                         on_check=on_check, device=device)
    labels = labels_from_h(res.h, label_rule)
    labels, dnorm_best, _ = _quarantine_lanes(labels, res.dnorm,
                                              res.stop_reason)
    best = torch.argmin(dnorm_best).to(torch.int32)
    return ChunkSweepOutput(labels, res.iterations, res.dnorm,
                            res.stop_reason, best, res.w[best], res.h[best])
