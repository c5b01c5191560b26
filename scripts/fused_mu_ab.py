#!/usr/bin/env python3
"""A/B of the per-iteration MU pair (fused_h_update, the masked H-Gram,
fused_w_update) on one CUDA card: this checkout's build against another
checkout's, and this build's byte gate against its own block kernel.

    python3 scripts/fused_mu_ab.py --parent DIR [--rounds 2]

DIR is another checkout of the repository (for example `git archive` of
the parent commit unpacked into a git-ignored directory). Its pair is
built from `nmfx_torch/csrc/fused_mu.cu` where that source exists (its
H half then splits m as DIR's `nmfx_torch/ops/fused_mu.py:h_splits`
says, and its masked H-Gram is the plain bd_select(Hp Hp^T) product its
callers ran), else from its `block_mu.cu`; this checkout's from
`block_mu.cu`. Both are built with the port's nvcc flags into
DIR/_ab_build_pair (helpers in scripts/ab_common.py), then:
  1. byte gate: one call each of this build's fused_h_update,
     lane_gram and fused_w_update against one iteration of this build's
     nmfx_block_iterations (iters = check_block = 1, no lane frozen):
     Hp and Wp byte-equal at the per-rank north-star pools (m 5040, n
     500, 50 restarts of k = 10 and of k = 3) and chip_smoke.py's block
     pools, plus a last 256-row chunk shorter than one W tile (fails on
     any difference); the other build's pair is reported beside it as a
     max abs difference, since it sums in other chunks;
  2. timing at the per-rank north-star pools, k = 10 and k = 3: each
     half, the H-Gram and the whole pair, CUDA events, median of 25, the
     builds in turns (other, this, this, other), `rounds` times;
  3. per-kernel device time of one pair under torch.profiler.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import sys

from ab_common import abi, build, build_all, load, profile_line, turns

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: the C signatures of a fused_mu.cu build: the H half takes the split
#: count and chunk, the W half the dense masked H-Gram
SPLIT_SIGNATURES = {
    "nmfx_fused_h_update": (_P,) * 6 + (_I,) * 6 + (_F, _F, _P),
    "nmfx_fused_w_update": (_P,) * 5 + (_I,) * 4 + (_F, _F, _P),
}

#: the per-rank route's north-star pools: (label, m, n, restarts, k)
TIMED = (("per-rank north-star", 5040, 500, 50, 10),
         ("per-rank k=3", 5040, 500, 50, 3))


class Pair:
    """One build's pair through ctypes, on buffers allocated once per
    shape: h(a, wp, hp), gram(h) and w(a, wp, h, gh) return their
    outputs; `split` is None for a block_mu.cu build, else DIR's
    h_splits(m, n, rk, sm_count)."""

    def __init__(self, torch, lib, k, split=None):
        self.torch, self.lib, self.k, self.split = torch, lib, k, split
        self.bufs = {}
        # C interface version 2 adds the bf16 workspace and the flags
        self.v2 = split is None and abi(lib) >= 2

    def _buf(self, name, *shape):
        key = (name, shape)
        if key not in self.bufs:
            self.bufs[key] = self.torch.empty(
                shape, dtype=self.torch.float32, device="cuda")
        return self.bufs[key]

    def _stream(self):
        return self.torch.cuda.current_stream().cuda_stream

    def h(self, a, wp, hp):
        m, n = a.shape
        rk, k = wp.shape[1], self.k
        out = self._buf("h", rk, n)
        if self.split is None:
            splits = -(-m // self.lib.nmfx_block_split_rows())
            extra = ()
        else:
            sms = self.torch.cuda.get_device_properties(
                0).multi_processor_count
            splits, chunk = self.split(m, n, rk, sms)
            extra = (splits, chunk)
        part = self._buf("part", splits, rk, n)
        gpart = self._buf("gpart", splits, rk // k, k, k)
        rc = self.lib.nmfx_fused_h_update(
            a.data_ptr(), wp.data_ptr(), hp.data_ptr(), out.data_ptr(),
            part.data_ptr(), gpart.data_ptr(), *([None] if self.v2 else []),
            m, n, rk, k, *extra, *([0] if self.v2 else []), 1e-9, 0.0,
            self._stream())
        if rc:
            raise RuntimeError(f"fused_h_update failed with CUDA error {rc}")
        return out

    def gram(self, h):
        rk, n = h.shape
        k = self.k
        if self.split is not None:  # the dense masked product
            key = ("mask", rk)
            if key not in self.bufs:
                lane = self.torch.arange(rk, device="cuda") // k
                self.bufs[key] = lane[:, None] == lane[None, :]
            return self.torch.where(self.bufs[key], h @ h.T, 0.0)
        gh = self._buf("gh", rk // k, k, k)
        rc = self.lib.nmfx_lane_gram(h.data_ptr(), gh.data_ptr(), n, rk, k,
                                     *([0] if self.v2 else []),
                                     self._stream())
        if rc:
            raise RuntimeError(f"lane_gram failed with CUDA error {rc}")
        return gh

    def w(self, a, wp, h, gh):
        m, n = a.shape
        rk = wp.shape[1]
        out = self._buf("w", m, rk)
        rc = self.lib.nmfx_fused_w_update(
            a.data_ptr(), wp.data_ptr(), h.data_ptr(), gh.data_ptr(),
            out.data_ptr(), m, n, rk, self.k, *([0] if self.v2 else []),
            1e-9, 0.0, self._stream())
        if rc:
            raise RuntimeError(f"fused_w_update failed with CUDA error {rc}")
        return out

    def pair(self, a, wp, hp):
        h = self.h(a, wp, hp)
        return h, self.w(a, wp, h, self.gram(h))


def block_iteration(torch, lib, a, wp, hp, k):
    """(Wp, Hp) after one iteration of the phased block kernel of `lib`,
    no lane frozen."""
    from nmfx_torch.ops.fused_mu import mu_block_workspace

    m, n = a.shape
    rk = wp.shape[1]

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device="cuda")

    frozen = torch.zeros((1, rk), device="cuda")
    outs = [empty(m, rk), empty(rk, n), empty(1, rk), empty(1, rk),
            empty(rk, 1), empty(rk, 1)]
    work = [empty(*shape) for shape in mu_block_workspace(m, n, rk, k)]
    v2 = abi(lib) >= 2
    rc = lib.nmfx_block_iterations(
        a.data_ptr(), wp.data_ptr(), hp.data_ptr(), frozen.data_ptr(), None,
        *(t.data_ptr() for t in outs), None, *(t.data_ptr() for t in work),
        *([None] * 7 if v2 else []), m, n, rk, k, *([0] if v2 else []), 1, 1,
        *([0] if v2 else []), 1e-9, 0.0,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"nmfx_block_iterations failed with CUDA error "
                           f"{rc}")
    return outs[0], outs[1]


def other_h_splits(parent):
    """h_splits from the other checkout's nmfx_torch/ops/fused_mu.py."""
    path = os.path.join(parent, "nmfx_torch", "ops", "fused_mu.py")
    spec = importlib.util.spec_from_file_location("_other_fused_mu", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.h_splits


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="another checkout of the repository")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("fused_mu_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from nmfx_torch.device import resolve_device
    from nmfx_torch.ops import _build

    resolve_device(None)
    print(f"card: {cs.smi()}", flush=True)
    parent = os.path.abspath(args.parent)
    out = os.path.join(parent, "_ab_build_pair")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    other_src = os.path.join(parent, "nmfx_torch", "csrc")
    split_layout = os.path.exists(os.path.join(other_src, "fused_mu.cu"))
    libs = build_all({
        "other": build(_build._nvcc(), flags, other_src,
                       os.path.join(out, "other"),
                       "fused_mu.cu" if split_layout else "block_mu.cu"),
        "this": build(_build._nvcc(), flags, str(_build.SRC_DIR),
                      os.path.join(out, "this"), "block_mu.cu")})
    this_lib = load(libs["this"], _build.SIGNATURES["block_mu"], "block_mu")
    other_lib = (load(libs["other"], SPLIT_SIGNATURES) if split_layout
                 else load(libs["other"], _build.SIGNATURES["block_mu"],
                           "block_mu"))
    split = other_h_splits(parent) if split_layout else None
    print("other build: " + ("fused_mu.cu (m split by h_splits, dense gh)"
                             if split_layout else "block_mu.cu"), flush=True)

    pools = [(label, m, n, r, k, dict(pad=False))
             for label, m, n, r, k in TIMED] + list(cs.MU_BLOCK_CASES) + [
        ("short-last-chunk", 1100, 300, 9, 8, dict(pad=False))]
    for label, m, n, r, k, opts in pools:
        a, wp, hp, _, _ = cs.block_operands(
            torch, m, n, r, k, seed=7,
            **{key: opts[key] for key in ("zeros", "pad", "short_k")
               if key in opts})
        h, w = Pair(torch, this_lib, k).pair(a, wp, hp)
        want_w, want_h = block_iteration(torch, this_lib, a, wp, hp, k)
        oh, ow = Pair(torch, other_lib, k, split).pair(a, wp, hp)
        torch.cuda.synchronize()
        same = (torch.equal(h.view(torch.int32), want_h.view(torch.int32))
                and torch.equal(w.view(torch.int32),
                                want_w.view(torch.int32)))
        print(f"byte-equal pair == block iteration [{label} m={a.shape[0]} "
              f"n={n} R={r} k={k}]: {same}; other build's pair max abs "
              f"diff H {(oh - h).abs().max().item():.3e} W "
              f"{(ow - w).abs().max().item():.3e}", flush=True)
        if not same:
            raise SystemExit(f"{label}: the pair differs from one block "
                             "iteration")

    for label, m, n, r, k in TIMED:
        a, wp, hp = cs.operands(torch, m, n, r, k, seed=2)
        pairs = {"other": Pair(torch, other_lib, k, split),
                 "this": Pair(torch, this_lib, k)}
        fns = {}
        for name, p in pairs.items():
            h = p.h(a, wp, hp)
            gh = p.gram(h)
            fns[(name, "fused_h_update")] = \
                lambda p=p: p.h(a, wp, hp)
            fns[(name, "gram")] = lambda p=p, h=h: p.gram(h)
            fns[(name, "fused_w_update")] = \
                lambda p=p, h=h, gh=gh: p.w(a, wp, h, gh)
            fns[(name, "pair")] = lambda p=p: p.pair(a, wp, hp)
        times = turns(lambda fn: cs.time_ms(torch, fn), fns, args.rounds)
        for (name, part), ts in times.items():
            print(f"timing {name} {part} [{label} m={m} n={n} R={r} k={k}]: "
                  + ", ".join(f"{t:.4f}" for t in ts) + " ms", flush=True)
        for name in pairs:
            print(f"profile {name} pair [{label}]: "
                  f"{profile_line(torch, fns[(name, 'pair')], 1)}",
                  flush=True)
    print(f"card: {cs.smi()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
