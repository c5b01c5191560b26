"""Build the port's CUDA sources with ``nvcc`` at first use and load them
through ctypes.

Each ``nmfx_torch/csrc/<name>.cu`` compiles on its own into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes); the sources share device code through
``csrc/*.cuh`` headers. The library lands in ``nmfx_torch/_build/``
(git-ignored) under a name keyed by a hash of the source, the headers
and the flags, so an edited source or header rebuilds and an unchanged
one loads at once, with ``nvcc``'s log beside it (``ptxas -v``: each
kernel's registers, static shared memory and spills, read back by
:func:`kernel_resources`). Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C signatures per library: {symbol: argtypes}; every entry point
#: returns the launch's cudaError_t as an int
SIGNATURES = {
    "block_mu": {
        "nmfx_block_abi": (),
        "nmfx_block_split_rows": (),
        "nmfx_block_w_tile_rows": (),
        "nmfx_block_iterations": (_P,) * 26 + (_I,) * 8 + (_F, _F, _P),
        "nmfx_block_iterations_fused": (_P,) * 26 + (_I,) * 8 + (_F, _F, _P),
        "nmfx_fused_h_update": (_P,) * 7 + (_I,) * 5 + (_F, _F, _P),
        "nmfx_lane_gram": (_P, _P, _I, _I, _I, _I, _P),
        "nmfx_fused_w_update": (_P,) * 5 + (_I,) * 5 + (_F, _F, _P),
    },
    "hals_block": {
        "nmfx_block_abi": (),
        "nmfx_block_split_rows": (),
        "nmfx_block_w_tile_rows": (),
        "nmfx_hals_w_tile_cols": (),
        "nmfx_hals_sweep_positions": (),
        "nmfx_hals_block_iterations": (_P,) * 24 + (_I,) * 7 + (_F, _F, _P),
    },
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the port's CUDA "
            "kernels are built from source at first use")
    return path


def library_path(name: str) -> Path:
    """Where the built library for ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(names=tuple(SIGNATURES)) -> dict[str, bool]:
    """Compile every named source that has no built library yet, one
    ``nvcc`` per source, all started together. Returns ``{name: built}``
    (False = an up-to-date library was already there)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}.cu:\n{log}")
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)  # atomic: a concurrent process never
            # loads a half-written library
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return {name: name in procs for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            for sym, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, sym)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def kernel_resources(log: str) -> dict[str, dict[str, int]]:
    """Per kernel (mangled name) of an ``nvcc -Xptxas -v`` log: its
    registers, static shared memory, stack frame and spill bytes."""
    out: dict[str, dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        hit = re.search(r"(?:Compiling entry function|Function properties "
                        r"for) '?([^' ]+)'?", line)
        if hit:
            name = hit.group(1)
            out.setdefault(name, dict(registers=0, smem=0, stack=0,
                                      spill_stores=0, spill_loads=0))
            continue
        if name is None:
            continue
        hit = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                        r"(\d+) bytes spill loads", line)
        if hit:
            out[name].update(stack=int(hit.group(1)),
                             spill_stores=int(hit.group(2)),
                             spill_loads=int(hit.group(3)))
        hit = re.search(r"Used (\d+) registers", line)
        if hit:
            out[name]["registers"] = int(hit.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["smem"] = int(smem.group(1)) if smem else 0
    return out


def build_log(name: str) -> str:
    """``nvcc``'s log of the built library for ``csrc/<name>.cu`` ("" when
    the library was built without one)."""
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""
