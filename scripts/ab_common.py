"""Helpers shared by the block kernels' A/B scripts (block_mu_ab.py,
hals_block_ab.py): build one CUDA source of a checkout (optionally with
diagnostic edits) into its own directory, load it with ctypes, time
builds in turns and profile one call's kernels per iteration."""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess


def build(nvcc, flags, src_dir, out_dir, source, edits=()):
    """Copy src_dir to out_dir, apply the edits ((file, old, new); each
    old text must occur once), start nvcc on `source` (for example
    "block_mu.cu"); returns (process, library path)."""
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(src_dir, out_dir)
    for name, old, new in edits:
        path = os.path.join(out_dir, name)
        text = open(path).read()
        if text.count(old) != 1:
            raise SystemExit(f"diagnostic edit does not apply to {name}: "
                             f"{old[:60]!r}")
        open(path, "w").write(text.replace(old, new))
    lib = os.path.join(out_dir, "lib" + source.removesuffix(".cu") + ".so")
    proc = subprocess.Popen([nvcc, *flags, "-o", lib,
                             os.path.join(out_dir, source)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, lib


def build_all(builds):
    """Wait for {name: (process, library path)} from build(); returns
    {name: library path}, or exits with the first failing log."""
    libs = {}
    for name, (proc, lib) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = lib
    return libs


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: the C interface before nmfx_block_abi() existed (version 1): no
#: segments, flags or option workspace
ABI1_SIGNATURES = {
    "block_mu": {
        "nmfx_block_split_rows": (),
        "nmfx_block_w_tile_rows": (),
        "nmfx_block_iterations": (_P,) * 19 + (_I,) * 6 + (_F, _F, _P),
        "nmfx_block_iterations_fused": (_P,) * 19 + (_I,) * 6 + (_F, _F, _P),
        "nmfx_fused_h_update": (_P,) * 6 + (_I,) * 4 + (_F, _F, _P),
        "nmfx_lane_gram": (_P, _P, _I, _I, _I, _P),
        "nmfx_fused_w_update": (_P,) * 5 + (_I,) * 4 + (_F, _F, _P),
    },
    "hals_block": {
        "nmfx_block_split_rows": (),
        "nmfx_block_w_tile_rows": (),
        "nmfx_hals_w_tile_cols": (),
        "nmfx_hals_sweep_positions": (),
        "nmfx_hals_block_iterations": (_P,) * 20 + (_I,) * 6 + (_F, _F, _P),
    },
}


def abi(lib) -> int:
    """The version of a built library's C interface."""
    fn = getattr(lib, "nmfx_block_abi", None)
    if fn is None:
        return 1
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def load(path, signatures, name=None):
    """The library at `path` with the argument types of every symbol in
    `signatures` that it has; with `name` ("block_mu" or "hals_block"), a
    library of interface version 1 takes ABI1_SIGNATURES[name] instead."""
    lib = ctypes.CDLL(path)
    if name is not None and abi(lib) == 1:
        signatures = ABI1_SIGNATURES[name]
    for sym, argtypes in signatures.items():
        fn = getattr(lib, sym, None)
        if fn is not None:
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    return lib


def turns(time_ms, fns, rounds):
    """{name: [ms, ...]}: each of {name: fn} timed by time_ms(fn) in turns
    (a, b, ..., b, a), `rounds` times."""
    order = list(fns)
    times = {name: [] for name in order}
    for _ in range(rounds):
        for name in order + order[::-1]:
            times[name].append(time_ms(fns[name]))
    return times


def profile_line(torch, fn, iters):
    """The six kernels with the most device time in 5 calls of fn, per
    iteration (each call runs `iters` iterations)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total, e.key)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)

    def name(key):
        key = key.replace("(anonymous namespace)::", "")
        return key.removeprefix("void ").split("(")[0]

    return "; ".join(f"{name(key)} {us / (5 * iters) / 1e3:.4f} ms"
                     for us, key in rows[:6])
