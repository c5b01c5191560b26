#!/usr/bin/env python3
"""A/B of the mu block kernel (nmfx_torch/csrc/block_mu.cu) on one CUDA
card: this checkout's build against another checkout's, plus diagnostic
builds of this one.

    python3 scripts/block_mu_ab.py --parent DIR [--rounds 2]

DIR is another checkout of the repository (for example `git archive` of
the parent commit unpacked into a git-ignored directory). Both
`block_mu.cu` sources are built with the port's nvcc flags into
DIR/_ab_build, then:
  1. byte-equality, with no option set: every output of both orders of
     this build against the other build's phased order at
     chip_smoke.py's block pools and a pool whose last 256-row chunk is
     shorter than one W tile, check_block 4, and the per-iteration pair
     (fused_h_update, lane_gram, fused_w_update: rows 1-2) against the
     other build's pair at those pools and the per-rank pools (fails on
     any difference);
  2. timing at the north-star pool (2 x 4 iterations), CUDA events,
     median of 25, the builds in turns (other, this, ..., this, other);
  3. per-kernel device time per iteration under torch.profiler;
  4. diagnostic builds of this source, timed and profiled like it but
     not byte-equal: `no-w-epilogue` (the W tile stores its numerators
     and skips the denominators, the update and the stats) and
     `no-w-loop` (the W product's main loop is skipped; the epilogue
     stays). Their W times split the W kernel's time between the two.
The other build's workspace is sized for its own W tile height, given by
its nmfx_block_w_tile_rows() or, where it has none, 64 rows; a build of
C interface version 1 (before segments, flags and the option workspace)
is called with its own argument list (ab_common.abi).
"""

from __future__ import annotations

import argparse
import os
import sys

from ab_common import abi, build, build_all, load, profile_line, turns

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: diagnostic edits of this source: (file, old text, new text); each old
#: text must occur once
DIAGNOSTICS = {
    "no-w-epilogue": [(
        "block_mu.cu",
        "  // the columns [cb, ce) of the segments this tile's columns belong "
        "to\n",
        "  if (k > 0) {\n"
        "    for (int u = 0; u < WTM; ++u)\n"
        "      for (int v = 0; v < WTN; ++v) {\n"
        "        const int i = i0 + w_row(u), c = c0 + w_col(v);\n"
        "        if (i < m && c < rk) out[(size_t)i * rk + c] = acc[u][v];\n"
        "      }\n"
        "    return;\n"
        "  }\n")],
    "no-w-loop": [(
        "block_gemm.cuh",
        "  const int stages = (n + GBK - 1) / GBK;\n  float ra[8], rb[4];",
        "  const int stages = 0 * n;\n  float ra[8], rb[4];")],
}


def runner(torch, lib):
    """fn(a, wp, hp, frz, budget, k, fused) -> outputs of one launch of
    2 x 4 iterations of `lib`, its workspace sized by its own tiles, no
    option set."""
    split = lib.nmfx_block_split_rows()
    w_rows = (lib.nmfx_block_w_tile_rows()
              if hasattr(lib, "nmfx_block_w_tile_rows") else 64)
    v2 = abi(lib) >= 2

    def run(a, wp, hp, frz, budget, k, fused):
        m, n = a.shape
        rk = wp.shape[1]

        def empty(*shape):
            return torch.empty(shape, dtype=torch.float32, device=a.device)

        outs = [empty(m, rk), empty(rk, n), empty(4, rk), empty(4, rk),
                empty(4 * rk, 1), empty(4 * rk, 1), empty(4, rk, n)]
        splits, tiles = -(-m // split), -(-m // w_rows)
        work = [empty(m, rk), empty(rk, n), empty(splits, rk, n),
                empty(splits, rk // k, k, k), empty(rk // k, k, k),
                empty(tiles, rk), empty(tiles, rk)]
        # version 2: no segment table, no option workspace, flags 0
        extra_p, extra_i = ([None] * 7, [0]) if v2 else ([], [])
        sym = ("nmfx_block_iterations_fused" if fused
               else "nmfx_block_iterations")
        ints = [m, n, rk, k] + extra_i + [2, 4] + ([0] if v2 else [])
        rc = getattr(lib, sym)(
            a.data_ptr(), wp.data_ptr(), hp.data_ptr(), frz.data_ptr(),
            budget.data_ptr(), *(t.data_ptr() for t in outs),
            *(t.data_ptr() for t in work), *extra_p, *ints, 1e-9, 0.0,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{sym} failed with CUDA error {rc}")
        return outs

    return run


def pair_runner(torch, lib):
    """fn(a, wp, hp, k) -> (Hp, gh, Wp): one call each of the library's
    fused_h_update, lane_gram and fused_w_update, no option set."""
    split = lib.nmfx_block_split_rows()
    v2 = abi(lib) >= 2
    flags = [0] if v2 else []

    def run(a, wp, hp, k):
        m, n = a.shape
        rk = wp.shape[1]

        def empty(*shape):
            return torch.empty(shape, dtype=torch.float32, device=a.device)

        stream = torch.cuda.current_stream().cuda_stream
        h, gh, w = empty(rk, n), empty(rk // k, k, k), empty(m, rk)
        splits = -(-m // split)
        part, gpart = empty(splits, rk, n), empty(splits, rk // k, k, k)
        rcs = [lib.nmfx_fused_h_update(
                   a.data_ptr(), wp.data_ptr(), hp.data_ptr(), h.data_ptr(),
                   part.data_ptr(), gpart.data_ptr(), *([None] if v2 else []),
                   m, n, rk, k, *flags, 1e-9, 0.0, stream),
               lib.nmfx_lane_gram(h.data_ptr(), gh.data_ptr(), n, rk, k,
                                  *flags, stream),
               lib.nmfx_fused_w_update(
                   a.data_ptr(), wp.data_ptr(), h.data_ptr(), gh.data_ptr(),
                   w.data_ptr(), m, n, rk, k, *flags, 1e-9, 0.0, stream)]
        if any(rcs):
            raise RuntimeError(f"the pair failed with CUDA errors {rcs}")
        return h, gh, w

    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="another checkout of the repository")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("block_mu_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from nmfx_torch.device import resolve_device
    from nmfx_torch.ops import _build

    resolve_device(None)
    print(f"card: {cs.smi()}", flush=True)
    out = os.path.join(os.path.abspath(args.parent), "_ab_build")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    srcs = {"other": os.path.join(args.parent, "nmfx_torch", "csrc"),
            "this": str(_build.SRC_DIR)}
    procs = {name: build(_build._nvcc(), flags, src,
                         os.path.join(out, name), "block_mu.cu")
             for name, src in srcs.items()}
    for name, edits in DIAGNOSTICS.items():
        procs[name] = build(_build._nvcc(), flags, srcs["this"],
                            os.path.join(out, name), "block_mu.cu", edits)
    libs = {name: load(lib, _build.SIGNATURES["block_mu"], "block_mu")
            for name, lib in build_all(procs).items()}
    runs = {name: runner(torch, lib) for name, lib in libs.items()}
    pairs = {name: pair_runner(torch, libs[name])
             for name in ("other", "this")}

    pools = [c for c in cs.MU_BLOCK_CASES] + [
        ("short-last-chunk", 1100, 300, 9, 8,
         dict(frozen=(4,), budgets={0: 2}, pad=False))]
    for label, m, n, slots, k, opts in pools:
        a, wp, hp, frz, budget = cs.block_operands(torch, m, n, slots, k,
                                                   seed=3, **opts)
        want = runs["other"](a, wp, hp, frz, budget, k, False)
        for fused in (False, True):
            got = runs["this"](a, wp, hp, frz, budget, k, fused)
            torch.cuda.synchronize()
            same = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                       for g, w in zip(got, want))
            print(f"byte-equal {label} m={a.shape[0]} n={n} slots={slots} "
                  f"k={k} fused={fused}: {same}", flush=True)
            if not same:
                raise SystemExit(f"{label}: this build differs from the "
                                 "other one")
    for label, m, n, slots, k, opts in pools + list(cs.PAIR_CASES):
        a, wp, hp, _, _ = cs.block_operands(
            torch, m, n, slots, k, seed=6,
            **{key: opts[key] for key in ("zeros", "pad", "short_k")
               if key in opts})
        want = pairs["other"](a, wp, hp, k)
        got = pairs["this"](a, wp, hp, k)
        torch.cuda.synchronize()
        same = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                   for g, w in zip(got, want))
        print(f"byte-equal pair (rows 1-2) {label} m={a.shape[0]} n={n} "
              f"R={slots} k={k}: Hp, gh, Wp {same}", flush=True)
        if not same:
            raise SystemExit(f"pair {label}: this build differs from the "
                             "other one")

    m, n, _, k = cs.NORTH_STAR
    a, wp, hp, frz, budget = cs.block_operands(torch, m, n, cs.SLOTS, k,
                                               seed=4)
    order = ["other", "this"] + list(DIAGNOSTICS)
    times = turns(lambda fn: cs.time_ms(torch, fn), {
        (name, fused): (lambda name=name, fused=fused: runs[name](
            a, wp, hp, frz, budget, k, fused))
        for name in order for fused in (False, True)}, args.rounds)
    for name in order:
        for fused in (False, True):
            fn = lambda: runs[name](a, wp, hp, frz, budget, k, fused)  # noqa
            ts = ", ".join(f"{t:.4f}" for t in times[(name, fused)])
            print(f"timing {name} fused={fused} m={a.shape[0]} n={n} "
                  f"slots={cs.SLOTS} k={k} (8 iterations): {ts} ms; per "
                  f"iteration: {profile_line(torch, fn, 8)}", flush=True)
    print(f"card: {cs.smi()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
