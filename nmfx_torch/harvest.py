"""Streaming per-rank harvest: device→host transfer and host rank
selection pipelined behind the solve (counterpart of ``nmfx/harvest.py``
and of ``nmfx/exec_cache.py``'s ``start_host_fetch``).

The sweep (``nmfx_torch/sweep.py``) starts each rank's device→host copies
(:func:`start_host_fetch`: ``non_blocking`` copies into pinned host memory
on the producing stream, then one CUDA event) the moment the rank's
device output exists, carries the :class:`HostFetch` in the output's
``fetch`` field and calls ``on_rank(k, out)``. :meth:`HarvestPipeline.submit`
is that callback: it hands the rank to a worker thread, which waits on
exactly that rank's event (the host buffers hold stale bytes until then),
runs the host rank selection (linkage / cophenetic / cutree, in the native
library, which releases the interpreter lock) and assembles the rank's
``KResult``. :meth:`HarvestPipeline.results` joins the workers.

Bit-identity: workers and the sequential path read the same copies and
run the same ``api._build_k_result``, so their results are equal byte for
byte (tests/test_torch_harvest.py).

Accounting: worker walls go to the overlap phases ``xfer.d2h_overlap``
(the wait for the copies) and ``post.rank_selection`` (the host
clustering) through the thread-safe ``Profiler.add_seconds``.
"""

from __future__ import annotations

import os
import queue
import threading
import time
import warnings
from concurrent.futures import Future

import torch

__all__ = ["HarvestPipeline", "HostFetch", "fetch_host", "harvest_rank",
           "start_host_fetch"]

#: fields never copied: labels feed the on-device consensus and are not
#: read on the host; ``fetch`` is the copy itself
_LEFT_BEHIND = ("labels", "fetch")


class HostFetch:
    """One NamedTuple's device→host copies in flight (tensor fields only;
    ``labels`` left behind). :meth:`wait` returns the NamedTuple with numpy
    arrays, after the copies have landed."""

    def __init__(self, host, event):
        self._host = host
        self._event = event

    def wait(self):
        if self._event is not None:
            self._event.synchronize()
        return self._host._replace(**{
            f: v.numpy() for f, v in zip(self._host._fields, self._host)
            if torch.is_tensor(v)})


def start_host_fetch(out) -> HostFetch:
    """Begin the device→host copies of every tensor field of ``out`` (a
    NamedTuple such as ``KSweepOutput``) except ``labels``: a
    ``non_blocking`` copy into pinned host memory on the current stream
    of the tensor's device, then one CUDA event recorded after them. On
    the CPU each field is a plain copy."""
    fields, device, event = {}, None, None
    for name, x in zip(out._fields, out):
        if name in _LEFT_BEHIND:
            fields[name] = None
        elif torch.is_tensor(x):
            x = x.detach()
            if x.device.type == "cuda":
                device = x.device
                buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                buf.copy_(x, non_blocking=True)
            else:
                buf = x.clone()
            fields[name] = buf
    if device is not None:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
    return HostFetch(out._replace(**fields), event)


def fetch_host(out):
    """``out`` with numpy host arrays: through the copies its sweep
    started (``out.fetch``), or copied now."""
    fetch = getattr(out, "fetch", None)
    return (fetch if fetch is not None else start_host_fetch(out)).wait()


def harvest_rank(k: int, out, linkage: str, profiler,
                 min_restarts: int = 1):
    """One rank's harvest: wait for rank ``k``'s host copies, then the
    host rank selection, through the SAME ``api._build_k_result`` as the
    sequential path. Returns the rank's ``KResult``; the two walls are
    credited to ``xfer.d2h_overlap`` / ``post.rank_selection`` on
    ``profiler``."""
    from nmfx_torch.api import _build_k_result

    t0 = time.perf_counter()
    host = fetch_host(out)
    t1 = time.perf_counter()
    profiler.add_seconds("xfer.d2h_overlap", t1 - t0)
    res = _build_k_result(k, host, linkage, min_restarts=min_restarts)
    profiler.add_seconds("post.rank_selection", time.perf_counter() - t1)
    return res


class HarvestPipeline:
    """Producer/consumer pipeline from per-rank device outputs to per-rank
    ``KResult``\\ s.

    ``workers`` bounds the harvest threads (default: half the CPUs, at
    most 4, so the main thread's solve loop keeps a core). Threads are
    daemons and start lazily on submit; :meth:`results` (or :meth:`close`)
    shuts them down and joins them.
    """

    def __init__(self, linkage: str = "average", profiler=None,
                 workers: "int | None" = None, min_restarts: int = 1):
        from nmfx_torch.profiling import NullProfiler

        self._linkage = linkage
        self._prof = profiler if profiler is not None else NullProfiler()
        self._min_restarts = min_restarts
        self._max_workers = (workers if workers is not None
                             else max(1, min(4, (os.cpu_count() or 2) // 2)))
        if self._max_workers < 1:
            raise ValueError("workers must be >= 1")
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._futures: "dict[int, Future]" = {}
        #: each rank's output, kept so a dead worker's rank can be
        #: harvested again in results(); dropped once the rank resolves
        self._outs: "dict[int, object]" = {}
        self._threads: "list[threading.Thread]" = []
        self._closed = False

    def submit(self, k: int, out) -> None:
        """Accept rank ``k``'s device output (its host copies already
        started by the sweep); never blocks on the card."""
        if self._closed:
            raise RuntimeError("harvest pipeline already closed")
        if k in self._futures:
            raise ValueError(f"rank {k} submitted twice")
        # grow the pool BEFORE publishing the future: a failed thread
        # start then leaves no waiter that no worker would resolve
        if len(self._threads) < min(self._max_workers,
                                    len(self._futures) + 1):
            t = threading.Thread(target=self._work, daemon=True,
                                 name="nmfx-torch-harvest")
            t.start()
            self._threads.append(t)
        fut: Future = Future()
        self._futures[k] = fut
        self._outs[k] = out
        self._queue.put((k, out, fut))

    def _work(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            k, out, fut = item
            try:
                fut.set_result(harvest_rank(k, out, self._linkage,
                                            self._prof, self._min_restarts))
                self._outs.pop(k, None)  # free its buffers progressively
            except BaseException as e:  # a worker must resolve every
                fut.set_exception(e)   # future; results() re-raises

    def results(self) -> dict:
        """Join every submitted rank and return ``{k: KResult}`` in
        submission order. A rank whose worker failed is harvested again on
        this thread, with one warning (the same copies through the same
        host math, so the result is exact); ``InsufficientRestarts`` is
        deterministic and re-raised."""
        from nmfx_torch.api import InsufficientRestarts

        warned = False
        try:
            out: dict = {}
            for k, fut in self._futures.items():
                try:
                    out[k] = fut.result()
                except InsufficientRestarts:
                    raise
                except Exception as e:
                    if not warned:
                        warnings.warn(
                            f"harvest worker for rank {k} failed ({e!r}); "
                            "harvesting that rank on the calling thread",
                            RuntimeWarning, stacklevel=2)
                        warned = True
                    out[k] = harvest_rank(k, self._outs[k], self._linkage,
                                          self._prof, self._min_restarts)
                    self._outs.pop(k, None)
            return out
        finally:
            self._outs.clear()
            self.close()

    def close(self) -> None:
        """Shut the worker threads down and wait for them to end
        (idempotent). Ranks already submitted still finish first. The
        join matters: a worker still tearing down its last rank (freeing
        a CUDA event drops the interpreter lock) when the interpreter
        finalizes is ended by pthread_exit inside PyTorch's C++, which
        aborts the process."""
        if self._closed:
            return
        self._closed = True
        for _ in self._threads:
            self._queue.put(None)
        for t in self._threads:
            t.join()
