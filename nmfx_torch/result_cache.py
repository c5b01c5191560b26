"""Finished-result cache: content-addressed ``ConsensusResult`` reuse
(counterpart of ``nmfx/result_cache.py``).

A repeated request (the same matrix under the same configuration and
seed) is served its finished result instead of solving again:

* **Content-addressed key.** :func:`result_key` digests the input's
  content fingerprint, shape and source dtype, every result-affecting
  ``SolverConfig`` / ``ConsensusConfig`` field (:func:`cache_key_fields`:
  the checkpoint manifest's solver coverage and every consensus field),
  the init config, the quality tag and a format version. The port's
  payload adds ``"engine": "nmfx_torch"`` and the device type ("cuda" or
  "cpu"): the two packages, and the card's kernels against their plain
  versions, differ by float, and one address never serves both (the
  reference's rule for backends).
* **Quality separation.** The key includes the quality tag
  (:func:`request_quality`); the port serves every result "exact".
* **Two tiers.** An in-memory LRU over an optional disk tier of
  ``ConsensusResult.save`` archives written atomically (``.part`` file
  then ``os.replace``) with an embedded key/format record: corrupt,
  truncated or key-mismatched entries are dropped with one warning and
  treated as misses. The disk tier is byte-capped by an mtime-LRU.
* **Counters.** ``nmfx_result_cache_{hits,misses}_total`` (by serving
  layer) and the coalescing / extension counters of the request
  economics; a warm hit costs zero solve dispatches and zero bytes to
  the card (``serve.dispatch_count``, ``data_cache.transfer_count`` and
  ``h2d_bytes`` stay put).

:func:`key_for_array` hashes a dense host array's bytes, or a
``nmfx_torch.sparse.SparseMatrix``'s canonical triplets (never a
densified copy).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import threading
import time
import warnings
import zipfile
from collections import OrderedDict

import numpy as np

from nmfx_torch.api import ConsensusResult
from nmfx_torch.config import (ConsensusConfig, InitConfig,
                               ResultCacheConfig, SolverConfig)
from nmfx_torch.obs import flight as _flight
from nmfx_torch.obs import metrics as _metrics

__all__ = ["ResultCache", "cache_key_fields", "cacheable", "result_key",
           "key_for_array", "request_quality"]

#: on-disk entry format version; bumped on any serialization OR key
#: layout change so old entries fail the embedded-record check (one
#: warning, clean re-solve) instead of deserializing a stale result
_DISK_FORMAT = 1
#: the port's engine tag in every key payload
_ENGINE = "nmfx_torch"
#: suffix of persisted result entries (the eviction scan and tests key
#: on it; atomic-write temp files use ``.part`` so a crashed writer's
#: leftovers are never mistaken for entries)
_DISK_SUFFIX = ".nmfxres"
#: zip member holding the embedded verification record — npz archives
#: are zips, and ``ConsensusResult.load`` reads only its own member
#: names, so the record rides INSIDE the entry (single-file atomicity)
#: without touching the result serialization format
_META_MEMBER = "nmfxres_meta.json"
#: age after which an orphaned ``.part`` temp file (a writer killed
#: between mkstemp and the rename) is swept by the eviction scan
_PART_MAX_AGE_S = 3600.0

# -- the request-economics counters ----------------------------------------
# Declared once here; serve and checkpoint re-declare by name where
# importing this module would cycle (MetricsRegistry._declare is an
# idempotent get-or-create, so every declaration site shares one series).
_hits_total = _metrics.counter(
    "nmfx_result_cache_hits_total",
    "requests served a finished ConsensusResult straight from the "
    "content-addressed result cache (zero solve dispatches, zero h2d "
    "transfers)", labelnames=("layer",))
_misses_total = _metrics.counter(
    "nmfx_result_cache_misses_total",
    "result-cache lookups that found no finished result and fell "
    "through to a solve", labelnames=("layer",))
_coalesced_total = _metrics.counter(
    "nmfx_result_cache_coalesced_total",
    "requests attached as followers to an identical in-flight solve "
    "instead of dispatching their own", labelnames=("layer",))
_extended_total = _metrics.counter(
    "nmfx_result_cache_extended_total",
    "checkpointed sweeps that resumed a compatible ledger under a "
    "widened budget (more restarts / more ranks) and solved only the "
    "delta chunks")


def cache_key_fields() -> "dict[str, frozenset]":
    """The SolverConfig/ConsensusConfig fields the result-cache key
    covers: the solver side is the checkpoint manifest's solver coverage
    (every field but the execution-only ones, which change scheduling,
    never numbers); the consensus side is every ``ConsensusConfig``
    field minus ``ConsensusConfig.RESULT_CACHE_EXEMPT_FIELDS`` (empty:
    this cache stores FINISHED results, which every consensus field
    shapes)."""
    from nmfx_torch.checkpoint import manifest_key_fields

    consensus = frozenset(
        f.name for f in dataclasses.fields(ConsensusConfig)
    ) - frozenset(ConsensusConfig.RESULT_CACHE_EXEMPT_FIELDS)
    return {"solver": manifest_key_fields()["solver"],
            "consensus": consensus}


def cacheable(ccfg: ConsensusConfig) -> bool:
    """Whether a request's finished result may enter the cache:
    ``keep_factors=True`` results carry every restart's (W, H) stacks
    and solve through (``restart_factors`` recomputes any restart);
    everything else is cacheable."""
    return not ccfg.keep_factors


def request_quality(scfg: SolverConfig) -> str:
    """The quality tag a request's finished result carries at its
    configured fidelity, the tag lookups use ("sketched" only for the
    sketched backend, which the port refuses)."""
    return "sketched" if scfg.backend == "sketched" else "exact"


def _jsonable(v):
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return dataclasses.asdict(v)
    return v


def _device_type(device) -> str:
    """The device type a key is built for: None means CUDA, as at the
    entry points."""
    import torch

    return torch.device("cuda" if device is None else device).type


def result_key(fingerprint: str, shape: tuple, src_dtype: str,
               scfg: SolverConfig = SolverConfig(),
               ccfg: ConsensusConfig = ConsensusConfig(),
               icfg: InitConfig = InitConfig(),
               quality: str = "exact", *, device=None,
               route: "dict | None" = None) -> str:
    """The content-addressed key: sha256 over a canonical JSON payload
    of (input content identity, every covered config field, init
    config, quality tag, format version), the reference's payload, plus
    the port's engine tag, ``device``'s type (None = "cuda") and the
    sweep's ``route`` through an executable cache
    (``ExecCache.route``; None for the plain sweep).

    ``fingerprint`` is the sha256 of the raw host bytes;
    ``shape``/``src_dtype`` tell byte-identical buffers read differently
    apart. The raw ``scfg.backend`` and the route are covered: backends
    and the bucket's padded pool sum in other orders, and one address
    never serves both."""
    covered = cache_key_fields()
    payload = {
        "format": _DISK_FORMAT,
        "data": {"fingerprint": str(fingerprint),
                 "shape": [int(x) for x in shape],
                 "src_dtype": str(src_dtype)},
        "solver": {name: _jsonable(getattr(scfg, name))
                   for name in sorted(covered["solver"])},
        "consensus": {name: _jsonable(getattr(ccfg, name))
                      for name in sorted(covered["consensus"])},
        "init": dataclasses.asdict(icfg),
        "quality": str(quality),
        "engine": _ENGINE,
        "device": _device_type(device),
        "route": route,
    }
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


def key_for_array(a, scfg: SolverConfig = SolverConfig(),
                  ccfg: ConsensusConfig = ConsensusConfig(),
                  icfg: InitConfig = InitConfig(),
                  quality: str = "exact", *, device=None,
                  route: "dict | None" = None) -> str:
    """Content-hash a host matrix (one sha256 pass over a dense array's
    bytes, or a sparse matrix's triplet fingerprint) and key it
    (:func:`result_key`)."""
    from nmfx_torch.sparse import SparseMatrix

    if isinstance(a, SparseMatrix):
        return result_key(a.fingerprint(), tuple(a.shape),
                          a.data.dtype.str, scfg, ccfg, icfg, quality,
                          device=device, route=route)
    arr = np.ascontiguousarray(a)
    digest = hashlib.sha256(arr.view(np.uint8).reshape(-1)).hexdigest()
    return result_key(digest, tuple(arr.shape), arr.dtype.str, scfg, ccfg,
                      icfg, quality, device=device, route=route)


class ResultCache:
    """Two-tier finished-result store: in-memory LRU over an atomic
    tmp+rename disk tier (the exec-cache persistence idioms).

    Thread-safe; one instance can back a whole serving process (the
    server and router layers construct their own against a shared
    directory — entries are content-addressed, so concurrent writers
    last-win a complete file and readers never see a partial one).
    """

    def __init__(self, cfg: "ResultCacheConfig | None" = None, *,
                 cache_dir: "str | None" = None, layer: str = "server"):
        if cfg is None:
            cfg = ResultCacheConfig(cache_dir=cache_dir)
        elif cache_dir is not None and cfg.cache_dir != cache_dir:
            cfg = dataclasses.replace(cfg, cache_dir=cache_dir)
        self.cfg = cfg
        self.layer = str(layer)
        self._lock = threading.Lock()
        self._mem: "OrderedDict[str, ConsensusResult]" = OrderedDict()
        self._warned: set = set()
        # per-instance mirrors of the registry counters (tests and the
        # bench economics rung read these without snapshot plumbing)
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.mem_evictions = 0
        self.disk_evictions = 0

    # -- lookup ------------------------------------------------------------
    def lookup(self, key: str) -> "ConsensusResult | None":
        """O(1) lookup: memory first, then the disk tier (a disk hit is
        re-admitted to memory and touches its entry's mtime). Counts
        one hit or one miss on the registry counters per call."""
        with self._lock:
            res = self._mem.get(key)
            if res is not None:
                self._mem.move_to_end(key)
                self.hits += 1
        if res is not None:
            _hits_total.inc(layer=self.layer)
            _flight.record("result_cache.hit", layer=self.layer,
                           key=key[:12], tier="memory")
            return res
        res = self._disk_load(key)
        if res is not None:
            self._admit(key, res)
            with self._lock:
                self.hits += 1
            _hits_total.inc(layer=self.layer)
            _flight.record("result_cache.hit", layer=self.layer,
                           key=key[:12], tier="disk")
            return res
        with self._lock:
            self.misses += 1
        _misses_total.inc(layer=self.layer)
        return None

    def put(self, key: str, result: ConsensusResult,
            ccfg: "ConsensusConfig | None" = None) -> bool:
        """Admit a finished result under ``key``; refuses uncacheable
        requests (``ccfg`` with ``keep_factors``) and results that
        carry retained factor stacks. Returns whether the result is now
        addressable (memory at least; disk best-effort)."""
        if ccfg is not None and not cacheable(ccfg):
            return False
        if any(result.per_k[k].all_w is not None for k in result.ks):
            return False  # retained factor stacks: never cached
        self._admit(key, result)
        with self._lock:
            self.puts += 1
        if self.cfg.cache_dir:
            self._disk_store(key, result)
        _flight.record("result_cache.put", layer=self.layer,
                       key=key[:12], quality=result.quality)
        return True

    def _admit(self, key: str, result: ConsensusResult) -> None:
        with self._lock:
            self._mem[key] = result
            self._mem.move_to_end(key)
            while len(self._mem) > self.cfg.max_entries:
                self._mem.popitem(last=False)
                self.mem_evictions += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem)

    @property
    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._mem), "hits": self.hits,
                    "misses": self.misses, "puts": self.puts,
                    "mem_evictions": self.mem_evictions,
                    "disk_evictions": self.disk_evictions}

    # -- the persistent tier ----------------------------------------------
    def _disk_path(self, key: str) -> str:
        return os.path.join(self.cfg.cache_dir, key[:40] + _DISK_SUFFIX)

    def _warn_once(self, category: str, msg: str) -> None:
        with self._lock:
            if category in self._warned:
                return
            self._warned.add(category)
        warnings.warn(f"nmfx_torch result cache: {msg}", RuntimeWarning,
                      stacklevel=4)

    def _disk_load(self, key: str) -> "ConsensusResult | None":
        if not self.cfg.cache_dir:
            return None
        path = self._disk_path(key)
        try:
            # the embedded record first: an entry written under a
            # different key (hash-prefix collision, a hand-moved file)
            # or format version must never deserialize as a result
            with zipfile.ZipFile(path) as zf:
                # bound-method alias: a literal ``zf.read(...)`` would
                # alias every project ``read`` in the lint name-graph
                # (ast_scan's over-approximate method fallback) and drag
                # checkpoint/registry's ``open``/``_fingerprint`` into
                # the traced closure through this cache's ``get``
                read_member = zf.read
                meta = json.loads(read_member(_META_MEMBER))
        except FileNotFoundError:
            return None
        except OSError as e:
            # transient read problem — leave the entry for the other
            # processes sharing this directory, re-solve here
            self._warn_once("disk-read",
                            f"could not read cache entry ({e}); solving")
            return None
        except Exception:  # nmfx: ignore[NMFX006] -- truncated or
            meta = None  # corrupt zip: the drop-and-re-solve path
        try:
            if not (isinstance(meta, dict)
                    and meta.get("format") == _DISK_FORMAT
                    and meta.get("key") == key):
                raise ValueError(
                    f"unrecognized or mismatched cache record in {path}")
            res = ConsensusResult.load(path)
            try:
                os.utime(path)  # mtime-LRU: a hit refreshes the entry
            except OSError:
                pass
            return res
        except Exception as e:
            # content failure — the entry itself is unusable: drop it,
            # warn once, re-solve (always exact: a fresh solve is the
            # ground truth the cache was built from)
            self._warn_once(
                "disk-read",
                f"discarding unusable cache entry and solving ({e})")
            try:
                os.remove(path)
            except OSError:
                pass
            return None

    def _disk_store(self, key: str, result: ConsensusResult) -> bool:
        path = self._disk_path(key)
        try:
            d = os.path.dirname(path) or "."
            os.makedirs(d, exist_ok=True)
            # atomic publish: write a COMPLETE temp file (the result
            # archive plus the embedded verification record appended as
            # an extra zip member — npz archives are zips and the
            # loader reads only its own member names), then rename onto
            # the entry path. Concurrent writers last-win; readers
            # never see a partial file.
            fd, tmp = tempfile.mkstemp(dir=d, prefix="write-",
                                       suffix=".part")
            os.close(fd)
            try:
                result.save(tmp)
                with zipfile.ZipFile(tmp, "a") as zf:
                    zf.writestr(_META_MEMBER, json.dumps(
                        {"format": _DISK_FORMAT, "key": key,
                         "quality": result.quality}))
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                raise
            self._evict_disk(keep=path)
            return True
        except Exception as e:
            self._warn_once(
                "disk-write",
                f"could not persist result ({e}); this process caches "
                "in memory only")
            return False

    def _evict_disk(self, keep: "str | None" = None) -> None:
        """Byte-capped mtime-LRU over the cache directory (the
        exec-cache discipline): evict oldest-touched entries until the
        directory fits ``max_disk_bytes``; the just-written entry
        survives even when it alone exceeds the cap; orphaned ``.part``
        files old enough that no live writer can own them are swept."""
        d = self.cfg.cache_dir
        try:
            stats = []
            now = time.time()
            for name in os.listdir(d):
                p = os.path.join(d, name)
                if name.endswith(".part"):
                    try:
                        if now - os.stat(p).st_mtime > _PART_MAX_AGE_S:
                            os.remove(p)
                    except OSError:
                        pass
                    continue
                if not name.endswith(_DISK_SUFFIX):
                    continue
                try:
                    st = os.stat(p)
                except OSError:
                    continue  # concurrently evicted by another process
                stats.append((st.st_mtime, st.st_size, p))
            total = sum(size for _, size, _ in stats)
            keep_abs = os.path.abspath(keep) if keep is not None else None
            for _, size, p in sorted(stats):
                if total <= self.cfg.max_disk_bytes:
                    break
                if os.path.abspath(p) == keep_abs:
                    continue
                try:
                    os.remove(p)
                except OSError:
                    continue
                total -= size
                with self._lock:
                    self.disk_evictions += 1
        except OSError as e:
            self._warn_once("disk-evict",
                            f"disk eviction scan failed ({e})")
