"""Phase timing and device tracing (counterpart of ``nmfx/profiling.py``).

The reference instruments by recompiling: ``PROFILE_*`` macros (all shipped
commented out, reference ``libnmf/include/common.h:27-45``) bracket each C
routine with ``gettimeofday``. Here profiling is a runtime object passed to
``nmfconsensus(profiler=...)``:

* ``Profiler.phase(name)`` — wall-clock per pipeline phase; call the yielded
  ``sync`` on whatever the phase returns and the phase ends with
  ``torch.cuda.synchronize()`` on each CUDA device that result lives on, so
  the card's queued work cannot move into a later phase.
* ``Profiler(trace_dir=...)`` — also records a ``torch.profiler`` trace of
  the wrapped region (CPU, and CUDA where a card is present), written as a
  Chrome trace (``trace.json``) into ``trace_dir``.

Thread-safety: the streamed harvest's workers (``nmfx_torch/harvest.py``)
record their device→host and rank-selection walls from their own threads
while the main thread times the solve; every recording funnels through the
lock-guarded :meth:`Profiler.add_seconds`.

Overlap accounting: phases whose names start with an ``OVERLAP_PREFIXES``
prefix (``xfer.``, ``post.``) record work that runs concurrently with the
main-thread pipeline. :meth:`Profiler.audit` keeps them out of the
phase-sum-vs-wall reconciliation and reports them as an overlap ratio.

The reference's structured tracer (``nmfx.obs``) and its cost-model
columns are not ported yet.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

#: phase-name prefixes recorded as OVERLAPPED work: async-transfer
#: bookkeeping (``xfer.``) and post-solve host work streamed through
#: harvest worker threads (``post.``)
OVERLAP_PREFIXES = ("xfer.", "post.")


class PhaseRecord:
    __slots__ = ("name", "seconds", "count")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0
        self.count = 0

    @property
    def overlapped(self) -> bool:
        return self.name.startswith(OVERLAP_PREFIXES)


def _cuda_devices(x, found: set) -> set:
    """The CUDA devices of every tensor in ``x`` (tensors, and tuples,
    lists and dicts of them, NamedTuples included)."""
    if torch.is_tensor(x):
        if x.device.type == "cuda":
            found.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, found)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _cuda_devices(v, found)
    return found


class Profiler:
    """Accumulates per-phase wall-clock; optionally wraps a device trace."""

    def __init__(self, trace_dir: str | None = None):
        self.trace_dir = trace_dir
        self.phases: dict[str, PhaseRecord] = {}
        self._lock = threading.Lock()
        self._t0: float | None = None
        self._t_total: float | None = None
        self._trace = None

    # -- region ------------------------------------------------------------
    def __enter__(self) -> "Profiler":
        if self.trace_dir is not None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._trace = profile(activities=acts)
            self._trace.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._t_total = time.perf_counter() - self._t0
        if self._trace is not None:
            self._trace.__exit__(*exc)
            os.makedirs(self.trace_dir, exist_ok=True)
            self._trace.export_chrome_trace(
                os.path.join(self.trace_dir, "trace.json"))
            self._trace = None

    # -- phases ------------------------------------------------------------
    @contextlib.contextmanager
    def phase(self, name: str):
        """Time one phase; call the yielded function on the phase's result
        (any tensor, or tuple/list/dict of them) so the timer stops only
        after the card has finished that work."""
        sync_target: list = []

        def sync(x):
            sync_target.append(x)
            return x

        t0 = time.perf_counter()
        try:
            yield sync
        finally:
            for dev in _cuda_devices(sync_target, set()):
                torch.cuda.synchronize(dev)
            self.add_seconds(name, time.perf_counter() - t0)

    def mark(self, name: str) -> None:
        """Record an instantaneous event as a zero-duration phase
        occurrence (the count column is the payload)."""
        self.add_seconds(name, 0.0)

    def add_seconds(self, name: str, seconds: float, count: int = 1) -> None:
        """Credit measured wall time to a phase: the one mutation point
        every recording goes through, lock-guarded, so harvest workers
        and the main thread neither drop nor double-count a
        contribution."""
        with self._lock:
            rec = self.phases.setdefault(name, PhaseRecord(name))
            rec.seconds += seconds
            rec.count += count

    # -- reporting ---------------------------------------------------------
    def total_seconds(self) -> float:
        if self._t_total is not None:
            return self._t_total
        with self._lock:
            return sum(r.seconds for r in self.phases.values()
                       if not r.overlapped)

    def audit(self, wall_s: "float | None" = None) -> dict:
        """Phase-sum-vs-wall reconciliation and overlap summary.

        ``phase_sum_s`` sums the SEQUENTIAL phases only (the overlap-classed
        ones run concurrently with them); ``coverage`` is the share of the
        wall they explain, which keeps unsynchronized device time from
        moving between phases unnoticed. ``overlap_s`` / ``overlap_ratio``
        report the work that ran behind the sequential pipeline. Meaningful
        when the sequential phases do not nest (true of the sweep)."""
        if wall_s is None:
            wall_s = (self._t_total if self._t_total is not None
                      else self.total_seconds())
        with self._lock:
            seq = sum(r.seconds for r in self.phases.values()
                      if not r.overlapped)
            over = sum(r.seconds for r in self.phases.values()
                       if r.overlapped)
        cov = seq / wall_s if wall_s > 0 else 0.0
        return {"wall_s": round(wall_s, 3),
                "phase_sum_s": round(seq, 3),
                "unattributed_s": round(max(wall_s - seq, 0.0), 3),
                "coverage": round(cov, 3),
                "overlap_s": round(over, 3),
                "overlap_ratio": round(over / wall_s, 3)
                if wall_s > 0 else 0.0}

    def report(self) -> str:
        total = self.total_seconds()
        lines = [f"{'phase':<28}{'calls':>6}{'seconds':>10}{'share':>8}"]
        with self._lock:
            recs = list(self.phases.values())
        for rec in sorted(recs, key=lambda r: -r.seconds):
            if rec.overlapped:
                # no share: this row is not part of the sequential total
                tag, share_txt = "~", f"{'-':>7}"
            else:
                share = rec.seconds / total if total > 0 else 0.0
                tag, share_txt = "", f"{share:>7.1%}"
            lines.append(f"{tag + rec.name:<28}{rec.count:>6}"
                         f"{rec.seconds:>10.3f}{share_txt}")
        lines.append(f"{'total':<28}{'':>6}{total:>10.3f}{'':>8}")
        a = self.audit()
        lines.append(f"(~ = overlapped with the phases above; "
                     f"{a['overlap_s']:.3f}s overlapped, ratio "
                     f"{a['overlap_ratio']:.0%} of wall)")
        if self.trace_dir is not None:
            lines.append(f"device trace written to "
                         f"{os.path.join(self.trace_dir, 'trace.json')} "
                         "(chrome://tracing or Perfetto)")
        return "\n".join(lines)


class NullProfiler(Profiler):
    """No-op drop-in so call sites need no ``if profiler`` branching; its
    ``sync`` never blocks on the card."""

    def __enter__(self) -> "NullProfiler":
        return self

    def __exit__(self, *exc) -> None:
        pass

    @contextlib.contextmanager
    def phase(self, name: str):
        yield lambda x: x

    def mark(self, name: str) -> None:
        pass

    def add_seconds(self, name: str, seconds: float, count: int = 1) -> None:
        pass

    def report(self) -> str:
        return "profiling disabled"
