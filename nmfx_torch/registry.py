"""Per-rank sweep registry: ``nmfconsensus(checkpoint_dir=...)``
(counterpart of ``nmfx/registry.py``).

After each rank finishes, its ``KSweepOutput`` is written as one
``.npz`` (atomically: temporary file, then rename); a re-run of the same
sweep loads the finished ranks instead of solving them again. A
fingerprint of everything that decides the numbers (the data, the solver
and init configs, restarts, seed, label rule, keep_factors) guards the
directory: a registry written for another run is refused, never mixed.
A registry written by ``nmfx`` fingerprints other config fields and is
refused the same way.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os

import numpy as np

_META_NAME = "registry.json"
_FORMAT_VERSION = 1

#: SolverConfig fields left out of the fingerprint: restart_chunk only
#: changes how the batched restart route groups lanes, not the numbers
FINGERPRINT_SOLVER_EXCLUDED = ("restart_chunk",)

#: SolverConfig fields hashed by a resolved value instead of their raw
#: one (still covered): ``backend`` hashes as its engine family, so
#: "auto" and the explicit equivalent share a registry
FINGERPRINT_SOLVER_RESOLVED = ("backend",)

#: the KSweepOutput fields a record holds (all_w / all_h only under
#: keep_factors)
_RECORD_FIELDS = ("consensus", "iterations", "dnorms", "stop_reasons",
                  "labels", "best_w", "best_h", "all_w", "all_h")
_OPTIONAL = ("all_w", "all_h")


def fingerprint_solver_fields() -> frozenset:
    """The SolverConfig fields the fingerprint covers (``backend`` by
    its resolved engine family)."""
    from nmfx_torch.config import SolverConfig

    return (frozenset(f.name for f in dataclasses.fields(SolverConfig))
            - set(FINGERPRINT_SOLVER_EXCLUDED))


def _fingerprint(a: np.ndarray, solver_cfg, init_cfg, restarts: int,
                 seed: int, label_rule: str,
                 keep_factors: bool = False, mesh=None) -> str:
    """sha256 of the data (shape, dtype, bytes) and of every config value
    that affects the sweep's numbers; ``backend`` hashed as its engine
    family, so "auto" and the explicit equivalent share a registry. The
    mesh enters only through that family (the reference's rule): a
    restart mesh solves every lane as the unmeshed route does, so a
    meshed and an unmeshed run share a registry."""
    from nmfx_torch.sweep import resolve_engine_family

    h = hashlib.sha256()
    arr = np.ascontiguousarray(np.asarray(a))
    h.update(str(arr.shape).encode())
    h.update(str(arr.dtype).encode())
    h.update(arr.tobytes())
    solver = dataclasses.asdict(solver_cfg)
    for name in FINGERPRINT_SOLVER_EXCLUDED:
        solver.pop(name, None)
    solver["backend"] = resolve_engine_family(solver_cfg, mesh)
    payload = {"solver": solver, "init": dataclasses.asdict(init_cfg),
               "restarts": restarts, "seed": seed,
               "label_rule": label_rule, "keep_factors": keep_factors,
               "format": _FORMAT_VERSION, "package": "nmfx_torch"}
    h.update(json.dumps(payload, sort_keys=True, default=str).encode())
    return h.hexdigest()


class SweepRegistry:
    """Directory of per-rank sweep results, keyed by a config
    fingerprint."""

    def __init__(self, directory: str, fingerprint: str):
        self.directory = directory
        self.fingerprint = fingerprint
        os.makedirs(directory, exist_ok=True)
        meta_path = os.path.join(directory, _META_NAME)
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as f:
                    meta = json.load(f)
            except (json.JSONDecodeError, OSError) as e:
                raise ValueError(
                    f"registry metadata at {meta_path!r} is unreadable "
                    f"({e}) — the directory is corrupt; delete it (or point "
                    "checkpoint_dir at a fresh directory) to start over") \
                    from e
            if meta.get("fingerprint") != fingerprint:
                raise ValueError(
                    f"registry at {directory!r} was written for a different "
                    "(data, config, seed) combination — or by another "
                    "package whose fingerprint scheme differs. Refusing to "
                    "mix results; point checkpoint_dir at a fresh directory")
        else:
            tmp = meta_path + ".tmp"
            with open(tmp, "wt") as f:
                json.dump({"fingerprint": fingerprint,
                           "format": _FORMAT_VERSION}, f)
            os.replace(tmp, meta_path)

    @classmethod
    def open(cls, directory: str, a, solver_cfg, init_cfg, restarts: int,
             seed: int, label_rule: str, keep_factors: bool = False,
             mesh=None) -> "SweepRegistry":
        return cls(directory, _fingerprint(a, solver_cfg, init_cfg, restarts,
                                           seed, label_rule, keep_factors,
                                           mesh))

    def _path(self, k: int) -> str:
        return os.path.join(self.directory, f"k{k}.npz")

    def completed_ks(self) -> list[int]:
        ks = []
        for name in os.listdir(self.directory):
            if name.startswith("k") and name.endswith(".npz"):
                try:
                    ks.append(int(name[1:-4]))
                except ValueError:
                    continue
        return sorted(ks)

    def has(self, k: int) -> bool:
        return os.path.exists(self._path(k))

    def save(self, k: int, out) -> None:
        """Persist one rank's ``KSweepOutput`` (device or host arrays)
        atomically: written to a temporary file, then renamed."""
        from nmfx_torch.harvest import fetch_host

        host = fetch_host(out)._replace(labels=out.labels)
        arrays = {}
        for name in _RECORD_FIELDS:
            v = getattr(host, name)
            if v is not None:
                arrays[name] = (v.detach().cpu().numpy()
                                if hasattr(v, "detach") else np.asarray(v))
        path = self._path(k)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:  # a handle: savez adds no ".npz"
            np.savez(f, **arrays)
        os.replace(tmp, path)

    def load(self, k: int):
        """One rank's result as a host ``KSweepOutput``; only all_w /
        all_h may be missing (any other missing field raises, which
        :meth:`try_load` turns into a re-solve)."""
        from nmfx_torch.sweep import KSweepOutput

        with np.load(self._path(k), allow_pickle=False) as z:
            return KSweepOutput(**{
                f: None if f in _OPTIONAL and f not in z.files else z[f]
                for f in _RECORD_FIELDS})

    def try_load(self, k: int):
        """:meth:`load`, or None for a missing or unreadable record (the
        rank is solved again and the record overwritten)."""
        if not self.has(k):
            return None
        try:
            return self.load(k)
        except Exception as e:  # nmfx: ignore[NMFX006] -- logged; heals
            # by recompute
            logging.getLogger("nmfx_torch").warning(
                "checkpoint for k=%d at %s is unreadable (%s); recomputing",
                k, self._path(k), e)
            return None
