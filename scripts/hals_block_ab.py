#!/usr/bin/env python3
"""A/B of the HALS block kernel (nmfx_torch/csrc/hals_block.cu) on one
CUDA card: this checkout's build against another checkout's, plus
diagnostic builds of this one.

    python3 scripts/hals_block_ab.py --parent DIR [--rounds 2]

DIR is another checkout of the repository (for example `git archive` of
the parent commit unpacked into a git-ignored directory). Both
`hals_block.cu` sources are built with the port's nvcc flags into
DIR/_ab_build (helpers in scripts/ab_common.py), then:
  1. byte-equality, with no option set: all seven outputs of this build
     (and of the byte-equal diagnostic builds below) against the other
     build's at chip_smoke.py's HALS block pools (the north star, the
     ragged 1237x77 pool of 13 x k=3, the unaligned one of 5 x k=7, the
     zeros pool, a lane wider than a W tile) and a pool whose last
     256-row chunk is shorter than one W tile, each at check_block 1
     and 4 (fails on any difference);
  2. timing at the north-star pool, one launch of 2 x 1 iterations (the
     main path's) and of 2 x 4, CUDA events, median of 25, the builds in
     turns (other, this, ..., this, other);
  3. per-kernel device time per iteration under torch.profiler;
  4. diagnostic builds of this source, timed and profiled like it:
     `w-three-blocks` (the fused W kernel compiled for three CTAs an SM
     instead of two), `separate-gram` (the W-Gram partials by the mu
     kernels' separate h_gram_partial on h_numer_split's column tiles
     instead of folded into the H product; byte-equal too) and
     `no-w-sweep` (the fused W kernel skips its sweep; the product, the
     staging and the stores stay; not byte-equal).
Each build's workspace is sized for the larger of both layouts: the W
numerator (m, rk) and one row of maxima per `nmfx_hals_sweep_positions()`
positions of max(m, n); a build of C interface version 1 is called with
its own argument list (ab_common.abi).
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
    "w-three-blocks": [(
        "hals_block.cu",
        "template <bool VEC, bool BF>\n"
        "__global__ void __launch_bounds__(W_THREADS, 2)\nw_sweep_tile(",
        "template <bool VEC, bool BF>\n"
        "__global__ void __launch_bounds__(W_THREADS, 3)\nw_sweep_tile(")],
    "separate-gram": [(
        "hals_block.cu",
        "    if (!whole) {\n      h_numer_split<VW, VN, T>",
        "    if (!whole || k > 0) {\n      h_numer_split<VW, VN, T>")],
    "no-w-sweep": [(
        "hals_block.cu",
        "  for (int e = threadIdx.x; e < WBM * nl; e += W_THREADS) {\n",
        "  for (int e = threadIdx.x; k < 0 && e < WBM * nl; e += W_THREADS) {"
        "\n")],
}

#: the builds held byte-equal to the other one
BYTE_EQUAL = ("this", "w-three-blocks", "separate-gram")


def runner(torch, lib):
    """fn(a, wp, hp, frz, budget, k, nck) -> outputs of one launch of
    2 x nck iterations of `lib`."""
    split = lib.nmfx_block_split_rows()
    positions = lib.nmfx_hals_sweep_positions()
    v2 = abi(lib) >= 2

    def run(a, wp, hp, frz, budget, k, nck):
        m, n = a.shape
        rk = wp.shape[1]

        def empty(*shape):
            return torch.empty(shape, dtype=torch.float32, device=a.device)

        outs = [empty(m, rk), empty(rk, n), empty(nck, rk), empty(nck, rk),
                empty(nck * rk, 1), empty(nck * rk, 1)]
        if nck > 1:
            outs.append(empty(nck, rk, n))
        splits, tiles = -(-m // split), -(-max(m, n) // positions)
        work = [empty(m, rk), empty(rk, n), empty(splits, rk, n),
                empty(splits, rk // k, k, k), empty(rk // k, k, k),
                empty(m, rk), empty(tiles, rk), empty(tiles, rk)]
        rc = lib.nmfx_hals_block_iterations(
            a.data_ptr(), wp.data_ptr(), hp.data_ptr(), frz.data_ptr(),
            budget.data_ptr() if nck > 1 else None,
            *(t.data_ptr() for t in outs), *([None] if nck == 1 else []),
            *(t.data_ptr() for t in work), *([None] * 4 if v2 else []),
            m, n, rk, k, 2, nck, *([0] if v2 else []), 1e-9, 0.0,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"nmfx_hals_block_iterations failed with "
                               f"CUDA error {rc}")
        return outs

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
        print("hals_block_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from nmfx_torch.device import resolve_device
    from nmfx_torch.ops import _build

    resolve_device(None)
    print(f"card: {cs.smi()}", flush=True)
    out = os.path.join(os.path.abspath(args.parent), "_ab_build_hals")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    srcs = {"other": os.path.join(args.parent, "nmfx_torch", "csrc"),
            "this": str(_build.SRC_DIR)}
    procs = {name: build(_build._nvcc(), flags, src,
                         os.path.join(out, name), "hals_block.cu")
             for name, src in srcs.items()}
    for name, edits in DIAGNOSTICS.items():
        procs[name] = build(_build._nvcc(), flags, srcs["this"],
                            os.path.join(out, name), "hals_block.cu", edits)
    runs = {name: runner(torch, load(lib, _build.SIGNATURES["hals_block"],
                                     "hals_block"))
            for name, lib in build_all(procs).items()}

    pools = list(cs.HALS_BLOCK_CASES) + [
        cs.MU_BLOCK_CASES[-1],  # the unaligned 1237 x 77 pool of 5 x k=7
        ("short-last-chunk", 1100, 300, 9, 8,
         dict(frozen=(4,), budgets={0: 2}, pad=False))]
    for label, m, n, slots, k, opts in pools:
        a, wp, hp, frz, budget = cs.block_operands(torch, m, n, slots, k,
                                                   seed=3, **opts)
        for nck in (1, cs.CHECK_BLOCK):
            want = runs["other"](a, wp, hp, frz, budget, k, nck)
            for name in BYTE_EQUAL:
                got = runs[name](a, wp, hp, frz, budget, k, nck)
                torch.cuda.synchronize()
                same = [torch.equal(g.view(torch.int32), w.view(torch.int32))
                        for g, w in zip(got, want)]
                print(f"byte-equal {name} {label} m={a.shape[0]} n={n} "
                      f"slots={slots} k={k} check_block={nck}: all "
                      f"{len(same)} outputs {all(same)}", flush=True)
                if not all(same):
                    raise SystemExit(
                        f"{name} {label}, check_block={nck}: differs from "
                        "the other build in "
                        + ", ".join(o for o, s in zip(cs.BLOCK_OUTPUTS, same)
                                    if not s))

    m, n, _, k = cs.NORTH_STAR
    a, wp, hp, frz, budget = cs.block_operands(torch, m, n, cs.SLOTS, k,
                                               seed=4)
    order = ["other", "this"] + list(DIAGNOSTICS)
    for nck in (1, cs.CHECK_BLOCK):
        def call(name, nck=nck):
            return lambda: runs[name](a, wp, hp, frz, budget, k, nck)

        times = turns(lambda fn: cs.time_ms(torch, fn),
                      {name: call(name) for name in order}, args.rounds)
        for name in order:
            ts = ", ".join(f"{t:.4f}" for t in times[name])
            print(f"timing {name} m={a.shape[0]} n={n} slots={cs.SLOTS} "
                  f"k={k} ({cs.CHECK_EVERY * nck} iterations): {ts} ms; "
                  "per iteration: "
                  f"{profile_line(torch, call(name), cs.CHECK_EVERY * nck)}",
                  flush=True)
    print(f"card: {cs.smi()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
