"""ctypes loader for the port's host library (``hclust.cpp``,
``gct_io.cpp``): the counterpart of ``nmfx/native/__init__.py``.

The library is built with the host C++ compiler at first use (``g++ -O3
-std=c++17 -fPIC -shared``, the reference Makefile's flags) into the
git-ignored ``nmfx_torch/_build/``, under a name keyed by a hash of the
sources, the flags and the compiler, so an edited source rebuilds and an
unchanged one loads at once. The compiler links to a temporary name that
is renamed into place, so processes that race to build never load a
half-written file. Nothing here runs at import time.

There is no quiet fallback: a failed build raises with the compiler's
log. The numpy implementations stay callable by name
(``nmfx_torch.cophenetic.linkage_numpy`` / ``cut_tree_numpy``) and are the
reference these functions are tested against. ``ctypes.CDLL`` releases
the interpreter lock for each call, so the harvest workers' rank
selection overlaps the main thread's solve loop.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import NamedTuple

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
SOURCES = ("hclust.cpp", "gct_io.cpp")
BUILD_DIR = SRC_DIR.parent / "_build"
CXX_FLAGS = ("-O3", "-Wall", "-Wextra", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None

#: calls of each entry point since the last reset_call_counts(): how a
#: run shows that its rank selection went through this library
CALLS = {"average_linkage": 0, "cut_tree": 0, "parse_gct_rows": 0,
         "format_gct_body": 0}


def reset_call_counts() -> None:
    with _lock:
        for name in CALLS:
            CALLS[name] = 0


def _count(name: str) -> None:
    with _lock:
        CALLS[name] += 1


def _compiler() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError(
        "no host C++ compiler (g++ or c++) on PATH; the port's host "
        "library (nmfx_torch/native) is built from source at first use")


def library_path(cxx: str) -> Path:
    """Where the built library for these sources, flags and compiler
    lives."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    h.update(" ".join((cxx, *CXX_FLAGS)).encode())
    return BUILD_DIR / f"libnmfx_host_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless an up-to-date one is there; returns its
    path. Raises RuntimeError with the compiler's log when the build
    fails."""
    cxx = _compiler()
    out = library_path(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, *(str(SRC_DIR / s) for s in SOURCES)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, timeout=300)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building the host library failed: "
                           f"{' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a racing process never loads half a file
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_double_p = ctypes.POINTER(ctypes.c_double)
    c_int32_p = ctypes.POINTER(ctypes.c_int32)
    c_int64_p = ctypes.POINTER(ctypes.c_int64)
    lib.nmfx_average_linkage.restype = ctypes.c_int
    lib.nmfx_average_linkage.argtypes = [c_double_p, ctypes.c_int64,
                                         c_double_p, c_double_p, c_int32_p]
    lib.nmfx_cut_tree.restype = ctypes.c_int
    lib.nmfx_cut_tree.argtypes = [c_double_p, ctypes.c_int64,
                                  ctypes.c_int64, c_int32_p]
    lib.nmfx_parse_gct_rows.restype = ctypes.c_int64
    lib.nmfx_parse_gct_rows.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        c_double_p, c_int64_p]
    lib.nmfx_format_gct_body.restype = ctypes.c_int64
    lib.nmfx_format_gct_body.argtypes = [
        c_double_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
        c_int64_p, ctypes.c_char_p, ctypes.c_int64]
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def available() -> bool:
    """Whether the host library is loaded, building it at the first call.
    Never quietly False: a failed build raises with the compiler's log."""
    return load() is not None


class NativeHClust(NamedTuple):
    linkage: np.ndarray
    coph: np.ndarray
    order: np.ndarray


def average_linkage(dist: np.ndarray) -> NativeHClust:
    """UPGMA clustering of a square distance matrix (n >= 2); the contract
    of ``nmfx_torch.cophenetic.linkage_numpy(dist, "average")``."""
    lib = load()
    d = np.ascontiguousarray(dist, dtype=np.float64)
    if d.ndim != 2 or d.shape[0] != d.shape[1] or d.shape[0] < 2:
        raise ValueError("dist must be square with n >= 2")
    n = d.shape[0]
    linkage = np.zeros((n - 1, 4), dtype=np.float64)
    coph = np.zeros((n, n), dtype=np.float64)
    order = np.zeros(n, dtype=np.int32)
    c_double_p = ctypes.POINTER(ctypes.c_double)
    rc = lib.nmfx_average_linkage(
        d.ctypes.data_as(c_double_p), n, linkage.ctypes.data_as(c_double_p),
        coph.ctypes.data_as(c_double_p),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise RuntimeError(f"nmfx_average_linkage failed with code {rc}")
    _count("average_linkage")
    return NativeHClust(linkage, coph, order.astype(np.int64))


def cut_tree(linkage: np.ndarray, n: int, k: int) -> np.ndarray:
    """Memberships 1..k from the first n - k merges; the contract of
    ``nmfx_torch.cophenetic.cut_tree_numpy``."""
    lib = load()
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, {n}]")
    lk = np.ascontiguousarray(linkage, dtype=np.float64)
    if lk.shape != (n - 1, 4):
        raise ValueError(f"linkage must be ({n - 1}, 4), got {lk.shape}")
    labels = np.zeros(n, dtype=np.int32)
    rc = lib.nmfx_cut_tree(
        lk.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, k,
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise RuntimeError(f"nmfx_cut_tree failed with code {rc}")
    _count("cut_tree")
    return labels.astype(np.int64)


def parse_gct_rows(data: bytes, n_rows: int, n_cols: int):
    """Parse the numeric block of GCT data rows (the bytes after the
    header lines) into an (n_rows, n_cols) float64 array. Returns
    ``(values, n_seen)``; raises ValueError naming the first malformed
    row."""
    lib = load()
    out = np.empty((n_rows, n_cols), dtype=np.float64)
    n_seen = ctypes.c_int64(0)
    rc = lib.nmfx_parse_gct_rows(
        data, len(data), n_rows, n_cols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(n_seen))
    if rc != 0:
        raise ValueError(f"malformed GCT data row {rc}")
    _count("parse_gct_rows")
    return out, int(n_seen.value)


def format_gct_body(values: np.ndarray, prefixes: bytes,
                    prefix_ends: np.ndarray) -> memoryview:
    """The complete GCT data block: per row its prefix bytes (the caller
    joins "name\\tdescription\\t") then the shortest round-trip values,
    tab-separated, and a newline."""
    lib = load()
    vals = np.ascontiguousarray(values, dtype=np.float64)
    if vals.ndim != 2:
        raise ValueError("values must be 2-D")
    n_rows, n_cols = vals.shape
    ends = np.ascontiguousarray(prefix_ends, dtype=np.int64)
    if ends.shape != (n_rows,) or (n_rows and ends[-1] != len(prefixes)):
        raise ValueError("prefix_ends must end each row's prefix")
    cap = n_rows * (n_cols * 32 + 1) + len(prefixes) + 64
    buf = np.empty(cap, dtype=np.uint8)
    written = lib.nmfx_format_gct_body(
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n_rows, n_cols,
        prefixes, ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        buf.ctypes.data_as(ctypes.c_char_p), cap)
    if written < 0:
        raise RuntimeError("nmfx_format_gct_body: buffer overflow")
    _count("format_gct_body")
    return memoryview(buf[:written])
