"""On-first-run block-shape autotuner for the slot scheduler's kernel
route (counterpart of ``nmfx/autotune.py``).

The first sweep at a shape bucket with ``experimental.autotune="on"``
times a small candidate grid of (``block_m``, ``check_block``,
fused-vs-phased) with raw launches of the hand-written block kernels
(``csrc/block_mu.cu``: rows 3 and 4; ``csrc/hals_block.cu``: row 5) on
the card, picks the fastest per-iteration candidate and stores the
verdict content-addressed next to the executable cache; a second process
at the same bucket reads it and searches nothing. The counters
``nmfx_autotune_searches_total`` / ``nmfx_autotune_hits_total`` count
the cold searches and the warm hits. On the CPU the same search times
the kernels' plain versions (the wrappers' CPU path), as the reference
times interpret mode there.

:func:`resolve` rewrites the config once, on the host, before the sweep
builds anything: the result has ``autotune="off"`` and explicit
``check_block`` / ``block_m`` / ``fused_updates``, so every later key
(registry fingerprint, bucket key, ledger manifest) sees the resolved
numerics, and a warm process resolves to the identical config. Explicit
user values win: the search always times the full grid (an entry's
content does not depend on which fields were explicit) and tuned values
fill only ``"auto"`` / ``None`` gaps.

The key is the repr of ``(normalized cfg, shape bucket, environment
fingerprint)``; the normalized config pins exactly the tunable fields
(the exempt sets below, which the linter's NMFX001 reads) to sentinels.
The environment fingerprint is the port's own: torch's version, the CUDA
runtime's, the card's name and compute capability and each kernel
library's digest (``ops/_build.library_path``: the ``.cu``, every
``.cuh`` and the nvcc flags), so a redesigned kernel searches anew; on
the CPU it is ``"cpu"`` and torch's version.

On the card the kernels tile A by the fixed ``SPLIT_ROWS`` and
``MU_W_TILE_ROWS`` (``ops/fused_mu.py``), so ``block_m`` sets only the
padded row count: candidates of one ``m_pad`` time the same work and
their order is noise that changes no result. The grid stays the
reference's, so an entry's content stays comparable. The card has no
VMEM envelope: a candidate is pruned when its pool and kernel workspace
exceed the card's free memory.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import tempfile
import threading
import time
import warnings

import torch

from nmfx_torch.obs import metrics

#: Disk-entry format; a mismatched format searches again, never
#: mis-reads.
_FORMAT = 1

#: Iterations per timed launch (one check sub-block); the per-iteration
#: time divides by ``_TIME_ITERS * check_block``.
_TIME_ITERS = 4
_TIME_REPS = 3

#: Cold searches performed (one per unseen key) / warm store hits (memo
#: or disk). A warm process at a tuned bucket shows hits > 0 and
#: searches == 0.
searches_total = metrics.counter(
    "nmfx_autotune_searches_total",
    help="block-shape autotune candidate searches performed (cold path)")
hits_total = metrics.counter(
    "nmfx_autotune_hits_total",
    help="block-shape autotune store hits served without search")

#: The tunable declarations: the only fields the key normalizes away,
#: because they are what the stored entry decides. Every other field of
#: the config tree reaches the key through its repr; the linter's NMFX001
#: checks these sets against the live dataclasses.
AUTOTUNE_EXEMPT_SOLVER = frozenset({"check_block"})
AUTOTUNE_EXEMPT_EXPERIMENTAL = frozenset({
    "autotune", "block_m", "fused_updates"})

_lock = threading.Lock()
_memo: "dict[str, dict]" = {}
_warned: "set[str]" = set()


def autotune_key_fields() -> "tuple[frozenset, frozenset]":
    """The (SolverConfig, ExperimentalConfig) fields the autotune key
    covers: every repr-visible field outside the exempt sets (the key is
    the repr of the config with only the tunables pinned)."""
    from nmfx_torch.config import ExperimentalConfig, SolverConfig

    solver = frozenset(f.name for f in dataclasses.fields(SolverConfig)
                       if f.repr) - AUTOTUNE_EXEMPT_SOLVER
    exp = frozenset(f.name for f in dataclasses.fields(ExperimentalConfig)
                    if f.repr) - AUTOTUNE_EXEMPT_EXPERIMENTAL
    return solver, exp


def shape_bucket(m: int, n: int, k_max: int, slots: int) -> tuple:
    """The (m, n, k_max, slots) lattice point an entry is keyed and timed
    at: the executable cache's bucket quanta."""
    from nmfx_torch.exec_cache import bucket_dim

    return (bucket_dim(int(m), 256), bucket_dim(int(n), 64), int(k_max),
            int(slots))


def _env_fingerprint(device: torch.device) -> tuple:
    """What can change which candidate is fastest besides the key's
    config and shape: on the card torch's and CUDA's versions, the card's
    name and compute capability and the kernel libraries' digests; on the
    CPU torch's version."""
    if device.type != "cuda":
        return ("cpu", f"torch-{torch.__version__}")
    from nmfx_torch.ops import _build

    major, minor = torch.cuda.get_device_capability(device)
    return ((f"torch-{torch.__version__}", f"cuda-{torch.version.cuda}",
             torch.cuda.get_device_name(device), f"sm_{major}{minor}")
            + tuple(_build.library_path(name).name
                    for name in sorted(_build.SIGNATURES)))


def _normalized(cfg):
    """``cfg`` with exactly the tunable fields pinned to sentinels (the
    config part of the key)."""
    exp = dataclasses.replace(cfg.experimental, autotune="off",
                              block_m=None, fused_updates="auto")
    return dataclasses.replace(cfg, check_block="auto", experimental=exp)


def _key_repr(cfg, m: int, n: int, k_max: int, slots: int,
              device: torch.device) -> str:
    return repr((_normalized(cfg), shape_bucket(m, n, k_max, slots),
                 _env_fingerprint(device)))


def _warn_once(category: str, msg: str) -> None:
    with _lock:
        if category in _warned:
            return
        _warned.add(category)
    warnings.warn(f"nmfx autotune: {msg}", RuntimeWarning, stacklevel=3)


def _disk_path(cache_dir: str, key_repr: str) -> str:
    h = hashlib.sha256(key_repr.encode()).hexdigest()[:40]
    return os.path.join(cache_dir, h + ".json")


def _disk_load(cache_dir: str, key_repr: str) -> "dict | None":
    """A verified entry's ``best`` dict, or None. Anything short of a full
    match (unreadable JSON, another format, a recorded key that differs
    from the requested one) warns once, removes the entry and falls back
    to a fresh search."""
    path = _disk_path(cache_dir, key_repr)
    try:
        with open(path) as f:
            rec = json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        rec = None
    best = rec.get("best") if isinstance(rec, dict) else None
    if (not isinstance(rec, dict) or rec.get("format") != _FORMAT
            or rec.get("key") != key_repr
            or not isinstance(best, dict)
            or not {"block_m", "check_block",
                    "fused_updates"} <= set(best)):
        _warn_once(path, f"entry at {path!r} is corrupt or was written "
                         "under a different key/format; re-searching")
        try:
            os.remove(path)
        except OSError:
            pass
        return None
    return best


def _disk_store(cache_dir: str, key_repr: str, best: dict,
                timings: dict) -> None:
    """Atomic publish (temporary file, then rename): a concurrent reader
    sees nothing or a whole entry."""
    rec = {"format": _FORMAT, "key": key_repr, "best": best,
           "timings": timings}
    try:
        os.makedirs(cache_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=cache_dir, prefix="write-",
                                   suffix=".part")
    except OSError as e:
        _warn_once(cache_dir, f"cannot write under {cache_dir!r} ({e}); "
                              "tuning stays in-process only")
        return
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, _disk_path(cache_dir, key_repr))
    except OSError as e:
        _warn_once(cache_dir, f"cannot publish under {cache_dir!r} "
                              f"({e}); tuning stays in-process only")
        try:
            os.remove(tmp)
        except OSError:
            pass


def _candidate_bytes(cfg, cand: dict, m: int, n: int, k_max: int,
                     slots: int, positions: int) -> int:
    """Device bytes one timing launch holds: A, the pool's factors in and
    out, the boundary stats and snapshots, the bf16 copies and the
    kernel's workspace (``fused_mu.mu_block_workspace`` /
    ``hals_block_workspace``)."""
    from nmfx_torch.ops import fused_mu

    m_pad = -(-m // cand["block_m"]) * cand["block_m"]
    rk, cb = slots * k_max, cand["check_block"]
    exp = cfg.experimental
    bf = cfg.matmul_precision == "bfloat16"
    w_b = 2 if exp.factor_dtype else 4
    h_b = 2 if exp.factor_dtype == "bfloat16" else 4
    total = m_pad * n * (2 if bf else 4) + 2 * (m_pad * rk * w_b
                                                + rk * n * h_b)
    total += 4 * (4 * cb * rk + (cb * rk * n if cb > 1 else 0))
    if bf:
        total += 2 * m_pad * rk
    if cfg.algorithm == "hals":
        work = fused_mu.hals_block_workspace(m_pad, n, rk, k_max, positions)
    else:
        work = fused_mu.mu_block_workspace(m_pad, n, rk, k_max)
    return total + 4 * sum(math.prod(shape) for shape in work)


def _candidates(cfg, m: int, n: int, k_max: int, slots: int,
                free_bytes: "int | None" = None,
                positions: int = 1) -> "list[dict]":
    """The full candidate grid at this (bucketed) shape: ``block_m`` in
    {the scheduler's default, 256, 512}, ``check_block`` in {1, 4} (only
    1 for hals with TolFun armed, the scheduler's restriction), phased
    or fused for mu. ``free_bytes`` (the card's free memory) prunes the
    candidates whose launch would not fit; None prunes nothing.
    ``positions`` is the HALS kernel's sweep block (its workspace)."""
    from nmfx_torch.ops import sched_mu
    from nmfx_torch.ops.grid_mu import USES_TOLFUN

    default_bm = sched_mu._pallas_block_geometry(m)[1]
    bms = sorted({int(default_bm), 256, 512})
    cbs = [1, 4]
    if (cfg.algorithm == "hals" and USES_TOLFUN["hals"]
            and cfg.use_tol_checks):
        # interior boundaries cannot replay TolFun from the kernel's
        # boundary exports: the scheduler's hals restriction
        cbs = [1]
    fuseds = (["phased", "fused"] if cfg.algorithm == "mu"
              else ["phased"])
    out = []
    for bm in bms:
        for cb in cbs:
            for fu in fuseds:
                cand = {"block_m": int(bm), "check_block": int(cb),
                        "fused_updates": fu}
                if free_bytes is not None and _candidate_bytes(
                        cfg, cand, m, n, k_max, slots,
                        positions) > free_bytes:
                    continue
                out.append(cand)
    return out


def _cand_label(cand: dict) -> str:
    return (f"bm{cand['block_m']}_cb{cand['check_block']}"
            f"_{cand['fused_updates']}")


def _time_candidate(cfg, cand: dict, m: int, n: int, k_max: int,
                    slots: int, device: torch.device) -> float:
    """Per-iteration seconds of one raw block-kernel launch at the bucket
    shape, on data drawn on ``device`` from a generator seeded 0: one
    warm-up launch, then the fastest of ``_TIME_REPS`` timed ones (CUDA
    events on the card, ``perf_counter`` on the CPU, where the wrappers
    run the plain versions). Raw launches, not a scheduled solve: the
    candidates differ only inside the kernel. The operands are float32
    for either solve dtype: a float64 solve keys its own entry (``dtype``
    is a field of the key's config) and its sweep launches these same
    float32 kernels on float32 pools."""
    from nmfx_torch.ops import fused_mu

    bm, cb = cand["block_m"], cand["check_block"]
    m_pad = -(-m // bm) * bm
    rk = slots * k_max
    exp = cfg.experimental
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def draw(*shape, dtype=torch.float32):
        return torch.rand(shape, generator=gen, device=device,
                          dtype=torch.float32).to(dtype)

    a = draw(m_pad, n, dtype=(torch.bfloat16
                              if cfg.matmul_precision == "bfloat16"
                              else torch.float32))
    wp = draw(m_pad, rk, dtype=(torch.bfloat16 if exp.factor_dtype
                                else torch.float32))
    hp = draw(rk, n, dtype=(torch.bfloat16
                            if exp.factor_dtype == "bfloat16"
                            else torch.float32))
    frozen = torch.zeros((1, rk), dtype=torch.float32, device=device)
    kw = dict(k=k_max, iters=_TIME_ITERS, eps=cfg.div_eps,
              zero_threshold=cfg.zero_threshold,
              matmul_precision=cfg.matmul_precision, check_block=cb)
    if cb > 1:
        # no lane reaches its budget during a timing launch
        kw["budget_cols"] = torch.full((1, rk), 1e9, dtype=torch.float32,
                                       device=device)
    if cfg.algorithm == "hals":
        def launch():
            return fused_mu.hals_block_iterations(a, wp, hp, frozen,
                                                  slots=slots, **kw)
    else:
        fused = cand["fused_updates"] == "fused"

        def launch():
            return fused_mu.fused_block_iterations(a, wp, hp, frozen,
                                                   fused=fused, **kw)
    cuda = device.type == "cuda"
    launch()  # build and warm
    if cuda:
        torch.cuda.synchronize(device)
    best = math.inf
    for _ in range(_TIME_REPS):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch()
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            launch()
            t = time.perf_counter() - t0
        best = min(best, t)
    return best / (_TIME_ITERS * cb)


def _lookup_or_search(cfg, m: int, n: int, k_max: int, slots: int,
                      cache_dir: "str | None",
                      device: torch.device) -> "dict | None":
    key = _key_repr(cfg, m, n, k_max, slots, device)
    with _lock:
        if key in _memo:
            hits_total.inc()
            return dict(_memo[key])
    if cache_dir is not None:
        best = _disk_load(cache_dir, key)
        if best is not None:
            hits_total.inc()
            with _lock:
                _memo[key] = dict(best)
            return dict(best)
    m_b, n_b, _, _ = shape_bucket(m, n, k_max, slots)
    free, positions = None, 1
    if device.type == "cuda":
        free = torch.cuda.mem_get_info(device)[0]
        if cfg.algorithm == "hals":
            from nmfx_torch.ops import _build

            positions = _build.load("hals_block").nmfx_hals_sweep_positions()
    cands = _candidates(cfg, m_b, n_b, k_max, slots, free, positions)
    if not cands:
        # no candidate fits on the card: the scheduler's defaults run
        return None
    searches_total.inc()
    timings, best, best_t = {}, None, math.inf
    for cand in cands:
        t = _time_candidate(cfg, cand, m_b, n_b, k_max, slots, device)
        timings[_cand_label(cand)] = t
        if t < best_t:
            best, best_t = cand, t
    with _lock:
        _memo[key] = dict(best)
    if cache_dir is not None:
        _disk_store(cache_dir, key, best, timings)
    return dict(best)


def resolve(cfg, m: int, n: int, k_max: int, slots: int,
            cache_dir: "str | None" = None, *, device=None):
    """Rewrite ``cfg`` with tuned kernel-schedule values for this problem
    shape, or return it unchanged (less the ``autotune`` flag) when there
    is nothing to tune.

    Idempotent: the result always has ``autotune="off"`` and explicit
    tuned fields, so a warm process resolves to the identical config.
    Tuned values fill only ``"auto"`` / ``None`` gaps. ``cache_dir``
    (normally ``<exec cache dir>/autotune``) holds the entries across
    processes; ``None`` keeps them in-process (the memo). ``device``:
    None means the card (raising without one), ``"cpu"`` times the plain
    versions; it is read only when a search or a lookup runs."""
    exp = cfg.experimental
    if exp.autotune != "on":
        return cfg
    off = dataclasses.replace(exp, autotune="off")
    if cfg.backend != "pallas" or exp.ragged:
        # nothing to tune: the block kernels run only under "pallas", and
        # the ragged pool has no block_m / check_block / fused choice
        return dataclasses.replace(cfg, experimental=off)
    from nmfx_torch.device import explicit_device, resolve_device

    dev = explicit_device(resolve_device(device))
    best = _lookup_or_search(cfg, m, n, k_max, slots, cache_dir, dev)
    if best is None:
        return dataclasses.replace(cfg, experimental=off)
    tuned_exp = dataclasses.replace(
        off,
        block_m=(exp.block_m if exp.block_m is not None
                 else int(best["block_m"])),
        fused_updates=(exp.fused_updates if exp.fused_updates != "auto"
                       else str(best["fused_updates"])))
    tuned_cb = (cfg.check_block if cfg.check_block != "auto"
                else int(best["check_block"]))
    return dataclasses.replace(cfg, check_block=tuned_cb,
                               experimental=tuned_exp)
