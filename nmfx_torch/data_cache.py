"""Device-resident input cache: repeat sweeps over the same matrix copy
zero bytes to the card (counterpart of ``nmfx/data_cache.py``).

* **Content key.** A placed matrix is cached under a :class:`DataKey`:
  the sha256 of the host bytes, the source dtype (a float32 matrix and
  its int32 byte view hash alike but mean other values), the shape, the
  placement dtype, the pad shape and the device. Content, never
  ``id()``: a caller who changes the array in place gets a new key and
  a new copy. The hash costs one pass over the host bytes per
  :meth:`DataCache.place`, hits included; a caller who keeps the
  placed tensor and passes it in again skips it (a tensor already on
  the target device goes straight through, uncached).
* **Chunked first touch.** On CUDA a miss copies the matrix in pinned
  row chunks, each ``copy_(non_blocking=True)`` on the current stream,
  so the copies queue ahead of the first rank's work instead of one
  blocking copy.
* **Counters.** :func:`transfer_count` and :func:`h2d_bytes` count the
  copies actually made (on the CPU, the copy into the placed tensor);
  a second sweep over the same array leaves both unchanged. They read
  the registry counters ``nmfx_data_h2d_transfers_total`` and
  ``nmfx_data_h2d_bytes_total`` (``nmfx_torch.obs.metrics``); every
  eviction counts in ``nmfx_data_cache_evictions_total`` and records a
  ``cache.evict`` flight event.

The cache holds live device tensors, so it is bounded by entries and by
bytes (8 entries / 2 GiB by default; :meth:`DataCache.resize`, where
``max_bytes=0`` keeps nothing). An array larger than ``max_bytes`` is
copied but not kept.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from nmfx_torch import faults
from nmfx_torch.obs import flight as _flight
from nmfx_torch.obs import metrics as _metrics
from nmfx_torch.profiling import NullProfiler

__all__ = ["DataCache", "DataKey", "data_key_fields", "default_cache",
           "h2d_bytes", "place_resilient", "transfer_count"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
#: below this many bytes one copy; above it, row chunks of _CHUNK_BYTES
_CHUNK_MIN_BYTES = 8 << 20
_CHUNK_BYTES = 4 << 20

# registry instruments under the reference's names and help strings;
# transfer_count() / h2d_bytes() below read them
_h2d_transfers_total = _metrics.counter(
    "nmfx_data_h2d_transfers_total",
    "input-matrix host-to-device transfers actually paid (cache hits "
    "do not count)")
_h2d_bytes_total = _metrics.counter(
    "nmfx_data_h2d_bytes_total",
    "bytes of input-matrix host-to-device transfers actually paid")
_data_evictions_total = _metrics.counter(
    "nmfx_data_cache_evictions_total",
    "device-resident input-cache entries evicted (LRU bound)")


def transfer_count() -> int:
    """Input matrices this process copied to their device through the
    cache (hits do not count); reads ``nmfx_data_h2d_transfers_total``."""
    return int(_h2d_transfers_total.total())


def h2d_bytes() -> int:
    """Bytes of those copies (``nmfx_data_h2d_bytes_total``)."""
    return int(_h2d_bytes_total.total())


def _note_transfer(nbytes: int) -> None:
    _h2d_transfers_total.inc()
    _h2d_bytes_total.inc(nbytes)


@dataclasses.dataclass(frozen=True)
class DataKey:
    """Everything that decides the device tensor a host matrix maps to;
    every field takes part in ``__eq__``/``__hash__``."""

    #: sha256 hex digest of the host bytes
    fingerprint: str
    #: the source array's dtype (``numpy.dtype.str``)
    src_dtype: str
    #: the true (m, n)
    shape: tuple
    #: the placement dtype ("float32" or "float64")
    dtype: str
    #: (m_pad, n_pad) of a zero-padded placement; None = exact shape
    pad_shape: "tuple | None"
    #: the target device, e.g. "cuda:0" or "cpu"
    device: str


def data_key_fields() -> frozenset:
    """The :class:`DataKey` fields the cache compares (a field added
    with ``compare=False`` would be missing here)."""
    return frozenset(f.name for f in dataclasses.fields(DataKey)
                     if f.compare)


def _device_name(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


class _Entry:
    __slots__ = ("tensor", "nbytes")

    def __init__(self, tensor: torch.Tensor, nbytes: int):
        self.tensor = tensor
        self.nbytes = nbytes


class DataCache:
    """LRU of device-resident input matrices keyed by :class:`DataKey`.
    Thread-safe: lookups and inserts hold a lock, copies run outside
    it."""

    def __init__(self, max_entries: int = 8, max_bytes: int = 1 << 31):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        if max_bytes < 0:
            raise ValueError("max_bytes must be >= 0")
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self._entries: "OrderedDict[DataKey, _Entry]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def key_for(self, a, dtype: str, device="cpu",
                pad_shape: "tuple | None" = None) -> DataKey:
        arr = np.ascontiguousarray(a)
        digest = hashlib.sha256(arr.view(np.uint8).reshape(-1)).hexdigest()
        return DataKey(fingerprint=digest, src_dtype=arr.dtype.str,
                       shape=tuple(arr.shape), dtype=str(dtype),
                       pad_shape=None if pad_shape is None
                       else tuple(pad_shape),
                       device=_device_name(device))

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def resize(self, max_entries: "int | None" = None,
               max_bytes: "int | None" = None) -> None:
        """Re-bound the cache; shrinking evicts least-recently-used
        entries at once, ``max_bytes=0`` keeps nothing."""
        with self._lock:
            if max_entries is not None:
                if max_entries < 1:
                    raise ValueError("max_entries must be >= 1")
                self.max_entries = max_entries
            if max_bytes is not None:
                if max_bytes < 0:
                    raise ValueError("max_bytes must be >= 0")
                self.max_bytes = max_bytes
            self._evict_locked()

    def _evict_locked(self) -> None:
        total = sum(e.nbytes for e in self._entries.values())
        while self._entries and (len(self._entries) > self.max_entries
                                 or total > self.max_bytes):
            key, dropped = self._entries.popitem(last=False)
            total -= dropped.nbytes
            self.evictions += 1
            _data_evictions_total.inc()
            _flight.record("cache.evict", cache="data",
                           nbytes=dropped.nbytes,
                           fingerprint=key.fingerprint[:12])

    @property
    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries),
                    "bytes": sum(e.nbytes for e in self._entries.values()),
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}

    def place(self, a, solver_cfg, device, *,
              pad_shape: "tuple | None" = None,
              profiler=None) -> torch.Tensor:
        """``a`` on ``device`` in ``solver_cfg.dtype``: the cached tensor
        when this (content, placement) was placed before, else a new copy
        that is cached for the next call. A tensor already on ``device``
        goes straight through (cast, and zero-padded to ``pad_shape``),
        uncached."""
        prof = profiler if profiler is not None else NullProfiler()
        dtype = _DTYPES[solver_cfg.dtype]
        dev = torch.device(device)
        if torch.is_tensor(a):
            if a.device.type == dev.type:
                return _pad(a.to(dtype), pad_shape)
            a = a.detach().cpu().numpy()
        a = np.asarray(a)
        key = self.key_for(a, solver_cfg.dtype, dev, pad_shape)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
        if entry is not None:
            prof.mark("xfer.h2d_cache_hit")
            return entry.tensor
        faults.inject("h2d.transfer")
        t0 = time.perf_counter()
        placed, nbytes = _pad_and_transfer(a, dtype, pad_shape, dev)
        prof.add_seconds("xfer.h2d_overlap", time.perf_counter() - t0)
        if nbytes <= self.max_bytes:
            with self._lock:
                self._entries[key] = _Entry(placed, nbytes)
                self._evict_locked()
        return placed


def _pad(t: torch.Tensor, pad_shape) -> torch.Tensor:
    if pad_shape is None:
        return t
    m, n = t.shape
    return torch.nn.functional.pad(t, (0, pad_shape[1] - n,
                                       0, pad_shape[0] - m))


def _chunked_copy(host: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Copy ``host`` to ``dev``: on CUDA from pinned memory with
    ``non_blocking`` copies on the current stream, in row chunks above
    _CHUNK_MIN_BYTES; on the CPU one copy."""
    src = torch.from_numpy(host)
    if dev.type != "cuda":
        return src.clone()
    out = torch.empty(host.shape, dtype=src.dtype, device=dev)
    rows = host.shape[0]
    step = rows
    if host.nbytes >= _CHUNK_MIN_BYTES and rows > 1:
        step = max(1, int(rows * _CHUNK_BYTES / host.nbytes))
    for i in range(0, rows, step):
        # the pinned block is held by the host allocator until its copy
        # is done, so it may be dropped here
        out[i:i + step].copy_(src[i:i + step].pin_memory(),
                              non_blocking=True)
    return out


def _pad_and_transfer(a: np.ndarray, dtype, pad_shape, dev
                      ) -> tuple[torch.Tensor, int]:
    """The one cast → zero-pad → copy both :meth:`DataCache.place`'s miss
    and :func:`place_resilient`'s direct fallback run, so the fallback
    places the same bytes. Books the counters."""
    host = np.asarray(a, {torch.float32: np.float32,
                          torch.float64: np.float64}[dtype])
    if pad_shape is not None:
        padded = np.zeros(pad_shape, host.dtype)
        padded[:host.shape[0], :host.shape[1]] = host
        host = padded
    host = np.ascontiguousarray(host)
    placed = _chunked_copy(host, dev)
    _note_transfer(host.nbytes)
    return placed, host.nbytes


_default = DataCache()


def default_cache() -> DataCache:
    """The process-wide cache ``sweep.sweep`` places inputs through."""
    return _default


def place_resilient(a, solver_cfg, device, *,
                    pad_shape: "tuple | None" = None,
                    profiler=None) -> torch.Tensor:
    """:meth:`DataCache.place` that degrades: a failure inside the cache
    (an injected ``h2d.transfer`` fault, an allocator error) falls back,
    with one warning a process, to a direct uncached copy of the same
    bytes to the same device, so every result stays the same."""
    try:
        return default_cache().place(a, solver_cfg, device,
                                     pad_shape=pad_shape, profiler=profiler)
    except Exception as e:
        faults.warn_once(
            "h2d-direct-fallback",
            f"input-cache placement failed ({e!r}); serving this (and "
            "only this) placement through a direct uncached transfer — "
            "results are unaffected, the resident-input optimization is "
            "bypassed")
        if torch.is_tensor(a):
            raise
        placed, _ = _pad_and_transfer(np.asarray(a),
                                      _DTYPES[solver_cfg.dtype],
                                      pad_shape, torch.device(device))
        return placed
