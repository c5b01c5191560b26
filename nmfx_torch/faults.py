"""Fault injection and the typed failures of the port (counterpart of
``nmfx/faults.py``).

Every recovery path of the port is rehearsed by arming a named site of
this registry and checking the recovery contract: byte-equal results
where the recovery is exact, a typed error otherwise.

Rules, as in the reference:

* **Explicit arming only.** A site fires only after an in-process
  :func:`arm` (or :func:`scoped`) call. Environment variables are inert.
* **Deterministic and seeded.** Hit-counted sites fire on an exact
  schedule (every ``every``-th hit, at most ``max_fires`` times);
  lane-rate sites pick lanes by a splitmix of ``(seed, k, restart)``
  (:func:`poison_restarts`), never by the clock or a host RNG.
* **Loud.** Arming a site logs a warning banner: results from an armed
  process are a rehearsal.

The reference keys its traced-executable caches by the armed specs
(``trace_token``). The port traces nothing and keeps no builder cache:
each sweep reads the armed specs when it runs, so arming or disarming
between two runs always takes effect. The flight recorder
(``nmfx_torch.obs.flight``) gets a ``fault.armed`` event on every
:func:`arm`, the site's ``FAULT_EVENTS`` category on every fire (for the
lane-rate sites, where a lane or a reload is faulted), and a
``degradation`` event on every :func:`warn_once`; :func:`hits` and
:func:`fires` are plain counters.

Sites:

``h2d.transfer``        the data cache's host→device input copy
``compile.build``       building a bucketed sweep (``exec_cache``)
``persist.deserialize`` registered; fired by no port path (the port
                        keeps no serialized executables)
``harvest.worker``      a streamed-harvest or serving completion worker
``serve.scheduler``     the serving scheduler, a request popped and not
                        yet dispatched
``solve.nonfinite``     a restart's W0 gets one NaN (rate or lanes)
``sched.stale_reload``  the slot scheduler drops a reload's factor write
``ckpt.write``          a ledger record write (degrades warn-once)
``ckpt.load``           reading a ledger or spill record back (skip and
                        re-run)
``proc.preempt``        between a chunk's solve and its commit (raises
                        ``nmfx_torch.checkpoint.Preempted``)
``router.forward``, ``replica.spawn``, ``replica.heartbeat``
                        registered; fired by no port path yet
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import warnings

from nmfx_torch.obs import flight as _flight

__all__ = ["SITES", "FaultConfig", "FaultInjected", "InsufficientRestarts",
           "arm", "disarm", "armed", "fire", "fires", "hits", "inject",
           "poison_restarts", "record_rate_fire", "scoped",
           "stale_reload_fraction", "warn_once"]

#: every registered fault site: arming an unknown one is an error
SITES = ("h2d.transfer", "compile.build", "persist.deserialize",
         "harvest.worker", "serve.scheduler", "solve.nonfinite",
         "sched.stale_reload", "ckpt.write", "ckpt.load",
         "proc.preempt", "router.forward", "replica.spawn",
         "replica.heartbeat")

#: sites configured by a per-lane/per-reload ``rate`` (or ``lanes``)
#: instead of the hit counter
_RATE_SITES = ("solve.nonfinite", "sched.stale_reload")

_log = logging.getLogger("nmfx_torch")


class FaultInjected(RuntimeError):
    """Raised at an armed hit-counted site; ``site`` and ``hit`` say
    which failure a recovery test survived."""

    def __init__(self, site: str, hit: int):
        super().__init__(
            f"injected fault at site {site!r} (hit #{hit}) — this "
            "process has fault injection armed; results are part of a "
            "chaos rehearsal, not production output")
        self.site = site
        self.hit = hit


class InsufficientRestarts(RuntimeError):
    """A rank's surviving (non-quarantined) restarts fell below
    ``min_restarts``: too many lanes stopped with NUMERIC_FAULT for the
    consensus to be trustworthy."""


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """One armed site's firing policy (see :func:`arm`)."""

    site: str
    #: hit-counted sites: fire on every ``every``-th hit
    every: int = 1
    #: stop firing (armed but inert) after this many fires; None = never
    max_fires: "int | None" = None
    #: lane-rate sites: the fraction of lanes/reloads faulted
    rate: "float | None" = None
    #: seed of the lane selection
    seed: int = 0
    #: explicit ``((k, restart), ...)`` lanes for ``solve.nonfinite``,
    #: overriding ``rate``
    lanes: "tuple | None" = None

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; registered sites: "
                f"{SITES}")
        if self.every < 1:
            raise ValueError("every must be >= 1")
        if self.max_fires is not None and self.max_fires < 1:
            raise ValueError("max_fires must be >= 1 or None")
        if self.rate is not None and not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        if self.lanes is not None:
            object.__setattr__(self, "lanes", tuple(
                (int(k), int(r)) for k, r in self.lanes))
        if (self.site in _RATE_SITES and self.rate is None
                and self.lanes is None):
            raise ValueError(
                f"site {self.site!r} is lane-rate-armed: pass rate= "
                "(a fraction) or, for solve.nonfinite, explicit lanes=")


_lock = threading.Lock()
_specs: "dict[str, FaultConfig]" = {}
_hits: "dict[str, int]" = {}
_fires: "dict[str, int]" = {}


def arm(site: str, **kw) -> FaultConfig:
    """Arm ``site`` with a :class:`FaultConfig` built from ``kw``;
    re-arming replaces the policy and resets the site's counters."""
    spec = FaultConfig(site=site, **kw)
    with _lock:
        _specs[site] = spec
        _hits[site] = 0
        _fires[site] = 0
    _log.warning(
        "fault site %r ARMED (%s): failures are being injected "
        "deliberately — results from this process are a chaos "
        "rehearsal", site, spec)
    _flight.record("fault.armed", site=site, spec=spec)
    return spec


def disarm(site: "str | None" = None) -> None:
    """Disarm one site, or every site with ``None``. The counters stay
    readable until the next :func:`arm`."""
    with _lock:
        if site is None:
            _specs.clear()
        else:
            _specs.pop(site, None)


def armed(site: str) -> "FaultConfig | None":
    """The site's armed policy, or None."""
    with _lock:
        return _specs.get(site)


def hits(site: str) -> int:
    """How often the site was reached since it was last armed."""
    with _lock:
        return _hits.get(site, 0)


def fires(site: str) -> int:
    """How often the site fired since it was last armed."""
    with _lock:
        return _fires.get(site, 0)


@contextlib.contextmanager
def scoped(site: str, **kw):
    """Arm ``site`` for a ``with`` block, then restore the policy it had
    before (usually none)."""
    prev = armed(site)
    spec = arm(site, **kw)
    try:
        yield spec
    finally:
        if prev is None:
            disarm(site)
        else:
            arm(prev.site, **{f.name: getattr(prev, f.name)
                              for f in dataclasses.fields(prev)
                              if f.name != "site"})


def fire(site: str) -> bool:
    """Count one hit of ``site``; True when this hit faults. An unarmed
    site costs one dict lookup under a lock."""
    with _lock:
        spec = _specs.get(site)
        if spec is None:
            return False
        _hits[site] += 1
        if spec.max_fires is not None and _fires[site] >= spec.max_fires:
            return False
        if _hits[site] % spec.every:
            return False
        _fires[site] += 1
        hit = _hits[site]
    # one flight event per FIRE, outside the lock (the recorder has its
    # own): a chaos run's postmortem shows which failures landed
    _flight.record(_flight.FAULT_EVENTS.get(site, f"fault.{site}"),
                   site=site, hit=hit)
    return True


def inject(site: str) -> None:
    """Raise :class:`FaultInjected` when this hit of ``site`` fires."""
    if fire(site):
        raise FaultInjected(site, hits(site))


def _mix01(*vals: int) -> float:
    """A uniform [0, 1) from integers, splitmix64-style: the same in
    every process (never Python's ``hash``)."""
    x = 0
    for v in vals:
        x = (x + int(v) + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
        x = (x ^ (x >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 31
    return (x >> 32) / float(1 << 32)


def poison_restarts(k: int, restarts: int) -> tuple[int, ...]:
    """The restarts of rank ``k`` that the armed ``solve.nonfinite``
    site poisons (empty when unarmed). A lane is chosen by its (seed, k,
    restart) alone, so it is poisoned alike on every route."""
    spec = armed("solve.nonfinite")
    if spec is None:
        return ()
    if spec.lanes is not None:
        return tuple(r for kk, r in spec.lanes
                     if kk == int(k) and 0 <= r < restarts)
    return tuple(r for r in range(restarts)
                 if _mix01(spec.seed, int(k), r) < spec.rate)


def record_rate_fire(site: str, **payload) -> None:
    """The flight event of a lane-rate site's fire (its ``FAULT_EVENTS``
    category). A lane-rate site never passes :func:`fire`, so the code
    that applies the fault records it: the sweep where it poisons W0
    lanes, the scheduler where it drops reloads (the reference records
    no event for its rate sites)."""
    _flight.record(_flight.FAULT_EVENTS[site], site=site, **payload)


def stale_reload_fraction() -> float:
    """The armed ``sched.stale_reload`` rate (0.0 = off)."""
    spec = armed("sched.stale_reload")
    return float(spec.rate) if spec is not None else 0.0


_warned_lock = threading.Lock()
_warned: "set[str]" = set()


def warn_once(category: str, msg: str) -> None:
    """One ``RuntimeWarning`` per degradation category per process: the
    first fallback of a kind is loud, later ones are logged only. EVERY
    call also records a ``degradation`` flight event: a postmortem needs
    the whole sequence."""
    _flight.record("degradation", degradation=category, msg=msg)
    with _warned_lock:
        first = category not in _warned
        _warned.add(category)
    if not first:
        _log.debug("[%s] %s", category, msg)
        return
    warnings.warn(f"nmfx_torch [{category}]: {msg}", RuntimeWarning,
                  stacklevel=3)
    _log.warning("[%s] %s", category, msg)


def _reset_warned() -> None:
    """Test hook: forget which categories already warned."""
    with _warned_lock:
        _warned.clear()
