#!/usr/bin/env python3
"""Drive nmfx_torch on one CUDA card and hold its kernels to their plain
versions.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --quick    # build + kernel parity only

Phases (any failure exits non-zero; nothing is caught):
  1. card and build: nvidia-smi's name and power limit, the nvcc build
     (one nvcc per source, all started together) and the host library's
     g++ build, and each block kernel function's registers, shared
     memory and spills (ptxas -v);
  2. kernel parity: each kernel against its plain PyTorch version at the
     north-star shape, a ragged shape and with planted exact zeros (the
     block kernels also with frozen lanes, budgets that run out
     mid-launch and a zero-padded rank-3 job; the mu block kernel also
     at a pool whose rows are not 16-byte aligned, the HALS kernel at a
     lane wider than its W tile); the join-the-updates mu block kernel
     against the phased one, all outputs byte-equal; the per-iteration
     pair (fused_h_update, lane_gram, fused_w_update) against one
     iteration of the phased block kernel, Hp and Wp byte-equal, at the
     block pools and the per-rank route's north-star pools (k = 10 and
     k = 3, whose rows are not 16-byte aligned);
  3. kernel timing (CUDA events, median of 25 after warm-up) beside the
     plain version, a torch.matmul composite and the card's bound;
  4. the main paths, each with every kernel's launch count set to 0 just
     before it and read just after, on the 5000x500 two-group matrix,
     ks 2..10, 50 restarts:
     a. the whole grid (backend "pallas", grid_exec "auto": the slot
        scheduler on the phased mu block kernel), beside the same sweep
        with every default (backend "auto": the dense scheduler, plain
        products);
     b. the same whole grid on the join-the-updates kernel
        (fused_updates "fused"), byte-equal to a;
     c. the per-rank route (backend "pallas", grid_exec "per_k") on the
        per-iteration kernel pair, each rank's mean iterations beside
        the whole grid's from a;
     d. hals on the whole grid (backend "pallas": the slot scheduler on
        the HALS block kernel), beside the same sweep on the dense layout
        (backend "auto"), held to the reference's agreement band;
     e. the host tail: the hals whole grid of d under a Profiler with the
        streamed harvest (the default), the sequential one and device
        rank selection, each run's wall and phases; streamed and
        sequential byte-equal, device and host the same best k and k = 2
        memberships; then the native linkage and cutree against numpy's
        on the run's n = 500 consensus matrices, byte-equal, both timed;
     the main grid lines split each wall by the profiler's phases;
  5. agreement: the bundled 1000x40 design (best k must be 2) on both
     routes and with hals, a small input on the card and on the CPU
     (plain versions), which must agree on both routes and for hals on
     both layouts, and the whole grid at other slot counts and tail
     settings, which must give the same results; the scheduler's
     per-iteration fallback (max_iter not a multiple of check_every, on
     the kernel pair) against its block route on the bundled design: the
     same per-job iterations, stop reasons and consensus;
  6. profiles: 200 packed iterations at k=2 and k=10, and 20 trips of
     the 48-slot scheduler at k=10 for mu (160 iterations, no lane
     stops) and for hals (40 iterations): time per iteration, the
     device's busy share, the kernels by device time.

The line before the last is a JSON object {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}. Without CUDA, or without the
nmfx_torch package beside this file, it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: north-star shape (m, n, restarts, k) and the sweep's ranks
NORTH_STAR = (5000, 500, 50, 10)
KS = tuple(range(2, 11))
#: the whole grid's pool at the north star: 48 slots of k_max = 10; one
#: block launch runs CHECK_BLOCK check blocks of CHECK_EVERY iterations
SLOTS, CHECK_EVERY, CHECK_BLOCK = 48, 2, 4
#: f32 tolerance of a kernel against its plain version: both sum the same
#: products in different orders (m up to 5000 terms), all terms >= 0
RTOL, ATOL_REL = 1e-4, 1e-6

#: published dense rates without tensor cores, by card (NVIDIA data
#: sheets): (float32 FLOP/s, memory bytes/s)
PEAKS = {"H100 PCIe": (51.2e12, 2.0e12), "H100 NVL": (60e12, 3.9e12),
         "H100": (67e12, 3.35e12)}


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def print_resources(build, lib: str) -> None:
    """One line per kernel function of csrc/<lib>.cu: registers, static
    shared memory and spills from the build's ptxas -v log (dynamic shared
    memory is set at launch: block_gemm.cuh's *_RING_BYTES and the HALS
    W tile's WTileSmem)."""
    res = build.kernel_resources(build.build_log(lib))
    if not res:
        raise AssertionError(f"no ptxas -v log for {lib}")
    names = list(res)
    try:
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True, check=True,
                               timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        pass  # the mangled names then
    for name, r in sorted(zip(names, res.values())):
        name = name.replace("(anonymous namespace)::", "")
        name = name.removeprefix("void ").split("(")[0]
        print(f"resources {lib} {name}: {r['registers']} "
              f"registers, {r['smem']} bytes static shared memory, "
              f"{r['stack']} bytes stack, spill stores {r['spill_stores']} "
              f"/ loads {r['spill_loads']} bytes", flush=True)


def peaks(name: str) -> tuple[float, float]:
    for key, val in PEAKS.items():  # most specific first
        if key in name:
            return val
    raise RuntimeError(f"no published peak rates recorded for {name!r}")


def time_ms(torch, fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def operands(torch, m, n, r, k, seed, zeros=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rk = r * k
    a = torch.rand((m, n), generator=g, device="cuda")
    wp = torch.rand((m, rk), generator=g, device="cuda")
    hp = torch.rand((rk, n), generator=g, device="cuda")
    if zeros:
        a[::7] = 0.0  # whole rows: zero numerators in the W update
        a[:, 3] = 0.0  # a whole column: zero numerators in the H update
        wp[::5, ::3] = 0.0
        hp[::4, ::5] = 0.0
    return a, wp, hp


def check_close(torch, name, got, want, zeros):
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    tol = RTOL * want.abs() + ATOL_REL * want.abs().max()
    if (err > tol).any():
        raise AssertionError(
            f"{name}: max abs err {err.max().item():.3e} exceeds "
            f"rtol={RTOL} atol={ATOL_REL}*max|ref|")
    if zeros and not torch.equal(got == 0, want == 0):
        raise AssertionError(f"{name}: exact zeros differ from the plain "
                             "version's")
    return err.max().item(), (err / want.abs().clamp(min=1e-30)).max().item()


def phase_parity(torch, fm):
    """Kernel vs plain version; returns the north-star max abs errors."""
    cases = [("north-star", *NORTH_STAR, False),
             ("ragged", 1237, 77, 13, 3, False),
             ("zeros", 1000, 96, 7, 5, True)]
    ns_err = {}
    for label, m, n, r, k, zeros in cases:
        a, wp, hp = operands(torch, m, n, r, k, seed=1, zeros=zeros)
        want_h = fm.fused_h_update_ref(a, wp, hp, k=k)
        got_h = fm.fused_h_update(a, wp, hp, k=k)
        eh = check_close(torch, f"fused_h_update[{label}]", got_h, want_h,
                         zeros)
        gh = fm.lane_gram_ref(want_h, k=k)
        eg = check_close(torch, f"lane_gram[{label}]",
                         fm.lane_gram(want_h, k=k), gh, zeros)
        want_w = fm.fused_w_update_ref(a, wp, want_h, gh, k=k)
        got_w = fm.fused_w_update(a, wp, want_h, gh, k=k)
        ew = check_close(torch, f"fused_w_update[{label}]", got_w, want_w,
                         zeros)
        print(f"parity {label} m={m} n={n} R={r} k={k}: fused_h_update "
              f"max abs {eh[0]:.3e} rel {eh[1]:.3e}; lane_gram max abs "
              f"{eg[0]:.3e} rel {eg[1]:.3e}; fused_w_update max "
              f"abs {ew[0]:.3e} rel {ew[1]:.3e} (rtol={RTOL}, "
              f"atol={ATOL_REL}*max|ref|)", flush=True)
        if label == "north-star":
            ns_err = {"fused_h_update": eh[0], "fused_w_update": ew[0]}
    return ns_err


BLOCK_OUTPUTS = ("wp", "hp", "wdiff", "wmax", "hdiff", "hmax", "h_checks")


def block_operands(torch, m, n, slots, k, seed, *, zeros=False, frozen=(),
                   budgets=None, pad=True, short_k=None):
    """The block kernel's operands as the scheduler builds them: A and Wp
    padded with zero rows to the scheduler's m_pad (``pad``), lane
    freezes and per-lane budgets ({slot: iterations left}; every other
    lane has 10,000). ``short_k`` makes slot 0 a rank-``short_k`` job
    zero-padded to k."""
    from nmfx_torch.ops.sched_mu import _pallas_block_geometry

    a, wp, hp = operands(torch, m, n, slots, k, seed, zeros=zeros)
    if short_k is not None:
        wp[:, short_k:k] = 0.0
        hp[short_k:k] = 0.0
    if pad:
        m_pad = _pallas_block_geometry(m)[2]
        a = torch.nn.functional.pad(a, (0, 0, 0, m_pad - m))
        wp = torch.nn.functional.pad(wp, (0, 0, 0, m_pad - m))
    lane = torch.arange(slots * k, device="cuda") // k
    frz = torch.zeros((1, slots * k), device="cuda")
    budget = torch.full((1, slots * k), 10_000.0, device="cuda")
    for s in frozen:
        frz[0, lane == s] = 1.0
    for s, left in (budgets or {}).items():
        budget[0, lane == s] = float(left)
    return a, wp, hp, frz, budget


#: the block kernels' parity cases: (label, m, n, slots, k, options); the
#: north star is the whole grid's pool (m padded to 5120, 48 slots of
#: k = 10), the zeros case carries a zero-padded rank-3 job in slot 0
BLOCK_CASES = (
    ("north-star", 5000, 500, SLOTS, 10,
     dict(frozen=(3, 11, 20, 33, 47), budgets={5: 3, 17: 5, 40: 7})),
    ("ragged", 1237, 77, 13, 3, dict(frozen=(2,), budgets={7: 4}, pad=False)),
    ("zeros", 1000, 96, 9, 5,
     dict(zeros=True, frozen=(1,), budgets={4: 6}, short_k=3)),
)


#: the mu block kernel's cases add a pool of 5 slots x k = 7 at the ragged
#: shape: rk = 35 and n = 77 leave its rows off 16-byte alignment, so its
#: products copy with 4-byte cp.async
MU_BLOCK_CASES = BLOCK_CASES + (
    ("unaligned", 1237, 77, 5, 7, dict(frozen=(1,), budgets={3: 5},
                                      pad=False)),
)

#: the HALS block kernel's cases add a pool of 3 slots x k = 70: a lane
#: wider than a W product tile (64 columns), which the kernel sweeps
#: through its W numerator workspace instead of in the product's tile
HALS_BLOCK_CASES = BLOCK_CASES + (
    ("wide-k", 400, 50, 3, 70, dict(frozen=(1,), budgets={2: 3})),
)


def phase_block_parity(torch, fm):
    """fused_block_iterations against its plain version (every output,
    exact zeros identical, frozen lanes and padded rows bit-equal to the
    input), and the join-the-updates order against the phased one (all
    outputs byte-equal). Returns the north-star max abs errors of both."""
    kw = dict(iters=CHECK_EVERY, check_block=CHECK_BLOCK)
    ns_err = {}
    for label, m, n, slots, k, opts in MU_BLOCK_CASES:
        a, wp, hp, frz, budget = block_operands(torch, m, n, slots, k,
                                                seed=3, **opts)
        want = fm.fused_block_iterations_ref(a, wp, hp, frz, k=k,
                                             budget_cols=budget, **kw)
        got = fm.fused_block_iterations(a, wp, hp, frz, k=k,
                                        budget_cols=budget, **kw)
        errs = [check_close(torch, f"fused_block_iterations[{label}].{o}",
                            g, w, zeros=True)[0]
                for o, g, w in zip(BLOCK_OUTPUTS, got, want)]
        check_padding(torch, f"fused_block_iterations[{label}]", got, wp, hp,
                      frz, m, k, opts.get("short_k"))
        print(f"parity fused_block_iterations {label} m={a.shape[0]} n={n} "
              f"slots={slots} k={k} iters={CHECK_EVERY} "
              f"check_block={CHECK_BLOCK}: max abs "
              + ", ".join(f"{o} {e:.3e}" for o, e in zip(BLOCK_OUTPUTS, errs))
              + f" (rtol={RTOL}, atol={ATOL_REL}*max|ref|); frozen lanes "
              "and padded rows bit-equal; exact zeros identical", flush=True)
        for nck in (1, CHECK_BLOCK):
            fkw = dict(k=k, iters=CHECK_EVERY, check_block=nck,
                       budget_cols=budget if nck > 1 else None)
            phased = got if nck == CHECK_BLOCK else \
                fm.fused_block_iterations(a, wp, hp, frz, **fkw)
            fused = fm.fused_block_iterations(a, wp, hp, frz, fused=True,
                                              **fkw)
            torch.cuda.synchronize()
            if len(fused) != len(phased) or not all(
                    torch.equal(f.view(torch.int32), p.view(torch.int32))
                    for f, p in zip(fused, phased)):
                raise AssertionError(
                    f"fused_block_iterations(fused=True)[{label}, "
                    f"check_block={nck}]: not byte-equal to the phased "
                    "kernel")
            print(f"parity fused_block_iterations(fused=True) {label} "
                  f"check_block={nck}: all {len(fused)} outputs byte-equal "
                  "to the phased kernel's", flush=True)
        if label == "north-star":
            ns_err["fused_block_iterations"] = max(errs)
            errs_f = [check_close(torch, f"fused[{label}].{o}", g, w,
                                  zeros=True)[0]
                      for o, g, w in zip(BLOCK_OUTPUTS, fused, want)]
            ns_err["fused_block_iterations_fused"] = max(errs_f)
    return ns_err


#: the per-rank route's north-star pools for the pair: m padded as
#: mu_packed pads it (5040 rows, a last 256-row chunk of 176), 50
#: restarts of k = 10, and of k = 3 (rk = 150: rows off 16-byte alignment)
PAIR_CASES = (("per-rank north-star", 5040, 500, 50, 10, dict(pad=False)),
              ("per-rank k=3", 5040, 500, 50, 3, dict(pad=False)))


def phase_pair_equality(torch, fm):
    """One call of fused_h_update, lane_gram and fused_w_update against
    one iteration of the phased block kernel (iters = check_block = 1, no
    lane frozen) from the same inputs: Hp and Wp byte-equal at the block
    kernel's parity pools and the per-rank pools."""
    for label, m, n, slots, k, opts in MU_BLOCK_CASES + PAIR_CASES:
        a, wp, hp, frz, _ = block_operands(
            torch, m, n, slots, k, seed=6,
            **{key: opts[key] for key in ("zeros", "pad", "short_k")
               if key in opts})
        h = fm.fused_h_update(a, wp, hp, k=k)
        w = fm.fused_w_update(a, wp, h, fm.lane_gram(h, k=k), k=k)
        want = fm.fused_block_iterations(a, wp, hp, frz, k=k, iters=1)
        torch.cuda.synchronize()
        if not (torch.equal(h.view(torch.int32), want[1].view(torch.int32))
                and torch.equal(w.view(torch.int32),
                                want[0].view(torch.int32))):
            raise AssertionError(f"pair [{label}]: Hp or Wp differs from "
                                 "one block iteration's")
        print(f"pair == block iteration [{label} m={a.shape[0]} n={n} "
              f"R={slots} k={k}]: byte-equal", flush=True)


def check_padding(torch, name, got, wp, hp, frz, m, k, short_k):
    """Frozen lanes bit-equal to the input, the zero-padded rows of Wp
    and (``short_k``) slot 0's padded components exactly zero."""
    cols = frz[0] > 0
    if not (torch.equal(got[0][:, cols], wp[:, cols])
            and torch.equal(got[1][cols], hp[cols])):
        raise AssertionError(f"{name}: a frozen lane changed")
    if not (got[0][m:] == 0).all():
        raise AssertionError(f"{name}: a zero-padded row of Wp changed")
    if short_k is not None and not ((got[0][:, short_k:k] == 0).all()
                                    and (got[1][short_k:k] == 0).all()):
        raise AssertionError(f"{name}: a zero-padded component changed")


#: HALS kernel against the float64 plain version: its max abs error per
#: output at most HALS_FACTOR times the float32 plain version's own
HALS_FACTOR = 4.0


def check_hals(torch, name, got, plain, exact):
    """The HALS kernel (``got``) and its float32 plain version
    (``plain``) against the float64 plain version (``exact``) on the same
    inputs. The coordinate sweep divides cancelling differences by the
    lanes' Gram diagonals, so from a random start float32 itself is far
    from exact (rtol 1e-4 fails for the plain version too); the kernel
    must be as close to exact as the plain version: max|got - exact| <=
    HALS_FACTOR * max|plain - exact| + ATOL_REL * max|exact|, and every
    entry exactly zero in one of got and exact but not the other within
    that bound of zero. Returns (max|got - plain|, max|got - exact|,
    max|plain - exact|, entries whose zero-ness differs from exact)."""
    torch.cuda.synchronize()
    exact = exact.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    e_k = (got - exact).abs().max().item()
    e_p = (plain - exact).abs().max().item()
    bound = HALS_FACTOR * e_p + ATOL_REL * exact.abs().max().item()
    flip = (got == 0) != (exact == 0)
    if e_k > bound or (flip & ((got.abs() > bound)
                               | (exact.abs() > bound))).any():
        raise AssertionError(
            f"{name}: max abs err against float64 {e_k:.3e} (float32 plain "
            f"version {e_p:.3e}) or a zero flip exceeds {bound:.3e}")
    return (got - plain).abs().max().item(), e_k, e_p, int(flip.sum())


def phase_hals_parity(torch, fm):
    """hals_block_iterations against its plain version in float32 and
    float64 at the HALS block cases, check_block 1 and 4 (see
    check_hals); frozen lanes, padded rows and padded components
    bit-equal. Returns the north-star max abs error against the float32
    plain version."""
    ns_err = 0.0
    for label, m, n, slots, k, opts in HALS_BLOCK_CASES:
        a, wp, hp, frz, budget = block_operands(torch, m, n, slots, k,
                                                seed=5, **opts)
        for nck in (1, CHECK_BLOCK):
            kw = dict(k=k, slots=slots, iters=CHECK_EVERY, check_block=nck)
            got = fm.hals_block_iterations(
                a, wp, hp, frz, budget_cols=budget if nck > 1 else None,
                **kw)
            plain = fm.hals_block_iterations_ref(
                a, wp, hp, frz, budget_cols=budget if nck > 1 else None,
                **kw)
            exact = fm.hals_block_iterations_ref(
                *(x.double() for x in (a, wp, hp, frz)),
                budget_cols=budget.double() if nck > 1 else None, **kw)
            res = [check_hals(torch, f"hals_block_iterations[{label}, "
                                     f"check_block={nck}].{o}", g, p, x)
                   for o, g, p, x in zip(BLOCK_OUTPUTS, got, plain, exact)]
            check_padding(torch, f"hals_block_iterations[{label}]", got, wp,
                          hp, frz, m, k, opts.get("short_k"))
            print(f"parity hals_block_iterations {label} m={a.shape[0]} "
                  f"n={n} slots={slots} k={k} iters={CHECK_EVERY} "
                  f"check_block={nck}: max abs against the float32 plain "
                  "version / kernel against float64 / float32 plain "
                  "against float64 / zero flips against float64: "
                  + ", ".join(f"{o} {r[0]:.3e} / {r[1]:.3e} / {r[2]:.3e} "
                              f"/ {r[3]}"
                              for o, r in zip(BLOCK_OUTPUTS, res))
                  + f" (bound {HALS_FACTOR} x the plain version's error + "
                  f"{ATOL_REL}*max|ref|); frozen lanes, padded rows and "
                  "components bit-equal", flush=True)
            if label == "north-star":
                ns_err = max(ns_err, *(r[0] for r in res))
    return ns_err


def library_h(torch, a, wp, hp, k):
    """torch.matmul composite of fused_h_update: numerator GEMM plus
    per-lane Grams and denominators by batched products."""
    from nmfx_torch.solvers.mu import _mu_update

    m, rk = wp.shape
    r = rk // k
    w3 = wp.reshape(m, r, k).permute(1, 0, 2)
    h3 = hp.reshape(r, k, -1)
    denom = torch.bmm(torch.bmm(w3.transpose(1, 2), w3), h3)
    return _mu_update(hp, wp.T @ a, denom.reshape(rk, -1), 1e-9, 0.0)


def library_gram(torch, hp, k):
    """torch.bmm composite of lane_gram: the lanes' Grams in one call."""
    h3 = hp.reshape(hp.shape[0] // k, k, -1)
    return torch.bmm(h3, h3.transpose(1, 2))


def library_w(torch, a, wp, hp, gh, k):
    """torch.matmul composite of fused_w_update (gh per lane)."""
    from nmfx_torch.solvers.mu import _mu_update

    m, rk = wp.shape
    r = rk // k
    denom = torch.bmm(wp.reshape(m, r, k).permute(1, 0, 2), gh)
    return _mu_update(wp, a @ hp.T, denom.permute(1, 0, 2).reshape(m, rk),
                      1e-9, 0.0)


def library_block(torch, a, wp, hp, k, iters, nck):
    """torch.matmul/bmm composite of fused_block_iterations with no lane
    frozen and no budget running out: the same iterations, per-lane
    Grams by batched products, the boundary stats and snapshots."""
    from nmfx_torch.solvers.mu import _mu_update

    m, rk = wp.shape
    n = hp.shape[1]
    r = rk // k
    wd, wm, hd, hm, hck = [], [], [], [], []
    w, h = wp, hp
    for it in range(iters * nck):
        w3 = w.reshape(m, r, k).permute(1, 0, 2)
        gw = torch.bmm(w3.transpose(1, 2), w3)
        hn = _mu_update(h, w.T @ a,
                        torch.bmm(gw, h.reshape(r, k, n)).reshape(rk, n),
                        1e-9, 0.0)
        h3 = hn.reshape(r, k, n)
        gh = torch.bmm(h3, h3.transpose(1, 2))
        denom = torch.bmm(w3, gh).permute(1, 0, 2).reshape(m, rk)
        wn = _mu_update(w, a @ hn.T, denom, 1e-9, 0.0)
        if (it + 1) % iters == 0:
            wd.append((wn - w).abs().amax(dim=0))
            wm.append(w.abs().amax(dim=0))
            hd.append((hn - h).abs().amax(dim=1))
            hm.append(h.abs().amax(dim=1))
            hck.append(hn)
        w, h = wn, hn
    return (w, h, torch.stack(wd), torch.stack(wm), torch.cat(hd)[:, None],
            torch.cat(hm)[:, None], torch.stack(hck))


def bounds(m, n, rk, k, rates):
    """Least time (ms) the card could take: bytes each input read once
    and each output written once, and the FLOPs these inputs need."""
    flops, bw = rates
    h_bytes = 4 * (m * n + m * rk + rk * n + rk * n)
    h_ops = 2 * m * n * rk + 2 * m * rk * k + 2 * rk * n * k + 5 * rk * n
    g_bytes = 4 * (rk * n + rk * k)
    g_ops = 2 * rk * k * n
    w_bytes = 4 * (m * n + m * rk + rk * n + rk * k + m * rk)
    w_ops = 2 * m * n * rk + 2 * m * rk * k + 5 * m * rk
    out = {}
    for name, nb, no in (("fused_h_update", h_bytes, h_ops),
                         ("lane_gram", g_bytes, g_ops),
                         ("fused_w_update", w_bytes, w_ops)):
        tb, to = nb / bw * 1e3, no / flops * 1e3
        out[name] = (max(tb, to), "bytes" if tb >= to else "operations")
    return out


def block_bound(m, n, rk, k, iters, nck, rates):
    """The same for fused_block_iterations with no lane frozen (every
    lane does all iters * nck iterations): inputs A, Wp, Hp, frozen and
    budget read once; outputs Wp, Hp, the 4 stat arrays and h_checks
    written once; per iteration the two numerators, the diagonal-block
    Grams, the denominators and the epilogues."""
    flops, bw = rates
    nbytes = 4 * (m * n + 2 * m * rk + 2 * rk * n + 2 * rk + 4 * nck * rk
                  + nck * rk * n)
    per_it = (2 * m * n * rk + 2 * m * rk * k + 2 * rk * n * k + 5 * rk * n
              + 2 * rk * n * k
              + 2 * m * n * rk + 2 * m * rk * k + 5 * m * rk)
    tb, to = nbytes / bw * 1e3, iters * nck * per_it / flops * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations"


def library_hals(torch, a, wp, hp, k, iters, nck):
    """torch.matmul/bmm composite of hals_block_iterations with no lane
    frozen and no budget running out: each half's numerator as one
    product over the packed pool, the lanes' Grams and the k-step sweeps
    by batched products, the boundary stats and snapshots."""
    m, rk = wp.shape
    n = hp.shape[1]
    r = rk // k
    wd, wm, hd, hm, hck = [], [], [], [], []
    w, h = wp, hp
    for it in range(iters * nck):
        w3 = w.reshape(m, r, k).permute(1, 0, 2)
        gw = torch.bmm(w3.transpose(1, 2), w3)
        wta = (w.T @ a).reshape(r, k, n)
        h3 = h.reshape(r, k, n).clone()
        for jj in range(k):
            num = wta[:, jj] - torch.bmm(gw[:, jj:jj + 1], h3)[:, 0]
            h3[:, jj] = (h3[:, jj] + num / (gw[:, jj, jj, None] + 1e-9)
                         ).clamp(min=0.0)
        hn = h3.reshape(rk, n)
        gh = torch.bmm(h3, h3.transpose(1, 2))
        aht = (a @ hn.T).reshape(m, r, k)
        w3 = w.reshape(m, r, k).clone()
        for jj in range(k):
            num = aht[:, :, jj] - torch.einsum("mrk,rk->mr", w3,
                                               gh[:, :, jj])
            w3[:, :, jj] = (w3[:, :, jj] + num / (gh[:, jj, jj] + 1e-9)
                            ).clamp(min=0.0)
        wn = w3.reshape(m, rk)
        if (it + 1) % iters == 0:
            wd.append((wn - w).abs().amax(dim=0))
            wm.append(w.abs().amax(dim=0))
            hd.append((hn - h).abs().amax(dim=1))
            hm.append(h.abs().amax(dim=1))
            hck.append(hn)
        w, h = wn, hn
    return (w, h, torch.stack(wd), torch.stack(wm), torch.cat(hd)[:, None],
            torch.cat(hm)[:, None], torch.stack(hck))


def hals_bound(m, n, rk, k, iters, nck, rates):
    """The least time of hals_block_iterations, as block_bound counts it:
    the same bytes; per iteration the two numerators, the diagonal-block
    Grams and the two k-step sweeps (2k + 4 operations a factor entry)."""
    flops, bw = rates
    nbytes = 4 * (m * n + 2 * m * rk + 2 * rk * n + 2 * rk + 4 * nck * rk
                  + nck * rk * n)
    per_it = (2 * m * n * rk + 2 * m * rk * k + rk * n * (2 * k + 4)
              + 2 * rk * n * k + 2 * m * n * rk + m * rk * (2 * k + 4))
    tb, to = nbytes / bw * 1e3, iters * nck * per_it / flops * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations"


def phase_block_timing(torch, fm, rates):
    """The three block kernels at the north-star pool (m padded to 5120,
    48 slots of k=10, 2 x 4 iterations, no lane frozen) beside their
    plain versions, the matmul/bmm composites and the bounds: the mu
    kernel in both orders, then the HALS kernel (2 x 1 iterations, as
    its main path runs it with TolFun on, and 2 x 4)."""
    m, n, _, k = NORTH_STAR
    a, wp, hp, frz, budget = block_operands(torch, m, n, SLOTS, k, seed=4)
    mp, rk = a.shape[0], SLOTS * k
    kw = dict(k=k, iters=CHECK_EVERY, check_block=CHECK_BLOCK,
              budget_cols=budget)
    table = {}
    lib = time_ms(torch, lambda: library_block(torch, a, wp, hp, k,
                                               CHECK_EVERY, CHECK_BLOCK))
    bound, by = block_bound(mp, n, rk, k, CHECK_EVERY, CHECK_BLOCK, rates)
    for name, fused in (("fused_block_iterations", False),
                        ("fused_block_iterations_fused", True)):
        ms = time_ms(torch, lambda: fm.fused_block_iterations(
            a, wp, hp, frz, fused=fused, **kw))
        plain = time_ms(torch, lambda: fm.fused_block_iterations_ref(
            a, wp, hp, frz, **kw))
        print(f"timing {name} m={mp} n={n} slots={SLOTS} k={k} "
              f"({CHECK_EVERY * CHECK_BLOCK} iterations): kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, library {lib:.4f} ms, bound "
              f"{bound:.4f} ms ({by})", flush=True)
        table[name] = (ms, plain, lib, bound, by)
    for nck in (CHECK_BLOCK, 1):
        hkw = dict(k=k, slots=SLOTS, iters=CHECK_EVERY, check_block=nck,
                   budget_cols=budget if nck > 1 else None)
        ms = time_ms(torch, lambda: fm.hals_block_iterations(a, wp, hp, frz,
                                                             **hkw))
        plain = time_ms(torch, lambda: fm.hals_block_iterations_ref(
            a, wp, hp, frz, **hkw))
        lib = time_ms(torch, lambda: library_hals(torch, a, wp, hp, k,
                                                  CHECK_EVERY, nck))
        bound, by = hals_bound(mp, n, rk, k, CHECK_EVERY, nck, rates)
        print(f"timing hals_block_iterations m={mp} n={n} slots={SLOTS} "
              f"k={k} ({CHECK_EVERY * nck} iterations): kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, library {lib:.4f} ms, bound "
              f"{bound:.4f} ms ({by})", flush=True)
    # the main path's launch: check_block 1 (TolFun on)
    table["hals_block_iterations"] = (ms, plain, lib, bound, by)
    return table


def phase_timing(torch, fm, rates):
    """Kernel, plain and library times at the north star and at k=2."""
    table = {}
    for m, n, r, k in (NORTH_STAR, (5000, 500, 50, 2)):
        a, wp, hp = operands(torch, m, n, r, k, seed=2)
        gh = fm.lane_gram_ref(hp, k=k)
        bnd = bounds(m, n, r * k, k, rates)
        row = {
            "fused_h_update": (
                time_ms(torch, lambda: fm.fused_h_update(a, wp, hp, k=k)),
                time_ms(torch, lambda: fm.fused_h_update_ref(a, wp, hp,
                                                             k=k)),
                time_ms(torch, lambda: library_h(torch, a, wp, hp, k))),
            "lane_gram": (
                time_ms(torch, lambda: fm.lane_gram(hp, k=k)),
                time_ms(torch, lambda: fm.lane_gram_ref(hp, k=k)),
                time_ms(torch, lambda: library_gram(torch, hp, k))),
            "fused_w_update": (
                time_ms(torch, lambda: fm.fused_w_update(a, wp, hp, gh,
                                                         k=k)),
                time_ms(torch, lambda: fm.fused_w_update_ref(a, wp, hp, gh,
                                                             k=k)),
                time_ms(torch, lambda: library_w(torch, a, wp, hp, gh, k))),
        }
        for name, (ms, plain, lib) in row.items():
            b, by = bnd[name]
            print(f"timing {name} m={m} n={n} R={r} k={k}: kernel "
                  f"{ms:.4f} ms, plain {plain:.4f} ms, library {lib:.4f} "
                  f"ms, bound {b:.4f} ms ({by})", flush=True)
        table[k] = {name: (*vals, *bnd[name]) for name, vals in row.items()}
    return table


def north_star_matrix():
    from nmfx_torch.datasets import two_group_matrix

    m, n, _, _ = NORTH_STAR
    return two_group_matrix(n_genes=m, n_per_group=n // 2, seed=123)


def check_sweep(res, label, n):
    """Finite consensus and residuals of the right shape at every rank,
    and best k = 2 (the matrix has two groups)."""
    for k in res.ks:
        kr = res.per_k[k]
        if not (np.isfinite(kr.consensus).all()
                and np.isfinite(kr.dnorms).all()):
            raise AssertionError(f"{label} k={k}: non-finite output")
        if kr.consensus.shape != (n, n):
            raise AssertionError(f"{label} k={k}: consensus shape "
                                 f"{kr.consensus.shape}")
    if res.best_k != 2:
        raise AssertionError(f"{label}: best k {res.best_k} != 2")


def stop_counts(kr) -> dict:
    return {int(s): int((kr.stop_reasons == s).sum())
            for s in sorted(set(kr.stop_reasons.tolist()))}


def solve_clock(torch, seen):
    """An on_rank callback keeping the first rank's output and the time
    the whole-grid solve (inits, scheduler, per-rank consensus on the
    card) ended: the first callback comes after all of it."""
    def on_rank(k, out):
        if "out" not in seen:
            torch.cuda.synchronize()
            seen["solved"] = time.perf_counter()
            seen["out"] = out

    return on_rank


#: the profiler's phases of a streamed whole-grid sweep after its solve,
#: in the order they run (all overlap the main thread)
TAIL_PHASES = ("xfer.overlap", "xfer.d2h_overlap", "post.rank_selection")


def split(prof, seen, t0, wall) -> str:
    """The wall split by the profiler's phases: solve.grid, the rest, and
    each phase after the solve; beside it the time of the first on_rank
    callback (solve_clock: the solve and the copies' start)."""
    solve = prof.phases["solve.grid"].seconds
    tail = ", ".join(f"{name} {prof.phases[name].seconds:.4f} s"
                     for name in TAIL_PHASES)
    audit = prof.audit(wall)
    return (f"solve.grid {solve:.3f} s, after it {wall - solve:.3f} s "
            f"[{tail}; overlapped], phase coverage "
            f"{audit['coverage']}; first on_rank at "
            f"{seen['solved'] - t0:.3f} s")


def phase_grid_path(torch, fm):
    """nmfconsensus at the north star through the whole grid: backend
    "pallas" with grid_exec "auto" (the slot scheduler on the block
    kernel), then every default (backend "auto": the dense scheduler)."""
    import nmfx_torch

    from nmfx_torch.profiling import Profiler

    m, n, r, _ = NORTH_STAR
    a = north_star_matrix()
    seen = {}

    prof = Profiler()
    fm.reset_launch_counts()
    t0 = time.perf_counter()
    with prof:
        res = nmfx_torch.nmfconsensus(
            a, ks=KS, restarts=r, solver_cfg=nmfx_torch.SolverConfig(
                backend="pallas"), on_rank=solve_clock(torch, seen),
            profiler=prof)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fm.LAUNCHES)
    out = seen["out"]
    check_sweep(res, "whole grid", n)
    print(f"main grid (pallas, {SLOTS} slots, check_block "
          f"{CHECK_BLOCK}): wall {wall:.3f} s "
          f"({split(prof, seen, t0, wall)}), "
          "pool_widths "
          f"{out.pool_widths}, pool_trips {out.pool_trips}, pool_lanes "
          f"{out.pool_lanes}, host syncs {out.host_syncs}, launches "
          f"{launches}, best k {res.best_k}", flush=True)
    for k in KS:
        kr = res.per_k[k]
        print(f"main grid k={k}: mean iters {kr.iterations.mean():.1f}, max "
              f"iters {int(kr.iterations.max())}, stop reasons "
              f"{stop_counts(kr)}, rho {kr.rho:.4f}", flush=True)
    need = sum(out.pool_trips)
    if launches["fused_block_iterations"] < max(need, 1):
        raise AssertionError(
            f"fused_block_iterations launched "
            f"{launches['fused_block_iterations']} times on the whole "
            f"grid; its {need} trips need one launch each")
    if out.host_syncs != need:
        raise AssertionError(f"whole grid: {out.host_syncs} host syncs "
                             f"for {need} trips")

    t0 = time.perf_counter()
    dense = nmfx_torch.nmfconsensus(a, ks=KS, restarts=r)
    torch.cuda.synchronize()
    dense_wall = time.perf_counter() - t0
    check_sweep(dense, "dense grid", n)
    print(f"main dense grid (every default, backend auto): wall "
          f"{dense_wall:.3f} s beside the pallas grid's {wall:.3f} s, best "
          f"k {dense.best_k}", flush=True)
    return launches, res, wall


def phase_fused_grid_path(torch, fm, phased, phased_wall):
    """The whole grid of phase_grid_path on the join-the-updates block
    kernel (fused_updates "fused"): one launch per trip, and iterations,
    stop reasons and consensus byte-equal to the phased run."""
    import nmfx_torch

    m, n, r, _ = NORTH_STAR
    a = north_star_matrix()
    seen = {}
    fm.reset_launch_counts()
    t0 = time.perf_counter()
    res = nmfx_torch.nmfconsensus(
        a, ks=KS, restarts=r, solver_cfg=nmfx_torch.SolverConfig(
            backend="pallas", experimental=nmfx_torch.ExperimentalConfig(
                fused_updates="fused")),
        on_rank=lambda k, out: seen.setdefault("out", out))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fm.LAUNCHES)
    out = seen["out"]
    check_sweep(res, "fused grid", n)
    same = all(
        np.array_equal(res.per_k[k].iterations, phased.per_k[k].iterations)
        and np.array_equal(res.per_k[k].stop_reasons,
                           phased.per_k[k].stop_reasons)
        and np.array_equal(res.per_k[k].consensus.view(np.int64),
                           phased.per_k[k].consensus.view(np.int64))
        for k in KS)
    print(f"main fused grid (pallas, fused_updates fused): wall {wall:.3f} s "
          f"beside the phased grid's {phased_wall:.3f} s, pool_trips "
          f"{out.pool_trips}, host syncs {out.host_syncs}, launches "
          f"{launches}; iterations, stop reasons and consensus byte-equal "
          f"to the phased run: {same}", flush=True)
    need = sum(out.pool_trips)
    if launches["fused_block_iterations_fused"] != need or need < 1:
        raise AssertionError(
            f"fused_block_iterations(fused=True) launched "
            f"{launches['fused_block_iterations_fused']} times for {need} "
            "trips")
    if launches["fused_block_iterations"]:
        raise AssertionError("the fused grid launched the phased kernel")
    if not same:
        raise AssertionError("fused grid: results differ from the phased "
                             "grid's")
    return launches


def hals_labels(res, k):
    """(restarts, n) labels of every restart of a keep_factors result."""
    return np.argmax(res.per_k[k].all_h, axis=1)


def phase_hals_path(torch, fm):
    """hals through nmfconsensus at the north star: the whole grid on the
    HALS block kernel (backend "pallas"), then the dense layout (backend
    "auto"), held to the reference's band against it (mean|dC| * R <= 0.6
    and at most 10 % of the labels of any restart flipped)."""
    import nmfx_torch
    from nmfx_torch.profiling import Profiler

    m, n, r, _ = NORTH_STAR
    a = north_star_matrix()
    seen = {}
    cfg = nmfx_torch.SolverConfig(algorithm="hals", backend="pallas")
    prof = Profiler()
    fm.reset_launch_counts()
    t0 = time.perf_counter()
    with prof:
        res = nmfx_torch.nmfconsensus(
            a, ks=KS, restarts=r, solver_cfg=cfg, keep_factors=True,
            on_rank=solve_clock(torch, seen), profiler=prof)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fm.LAUNCHES)
    out = seen["out"]
    check_sweep(res, "hals grid", n)
    need = sum(out.pool_trips)
    mean_iters = {k: round(float(res.per_k[k].iterations.mean()), 1)
                  for k in KS}
    print(f"main hals grid (pallas, {SLOTS} slots, check_block 1): wall "
          f"{wall:.3f} s ({split(prof, seen, t0, wall)}), pool_widths "
          f"{out.pool_widths}, pool_trips "
          f"{out.pool_trips}, pool_lanes {out.pool_lanes}, host syncs "
          f"{out.host_syncs}, launches {launches}, best k {res.best_k}, "
          f"mean iters per k {mean_iters}", flush=True)
    for k in KS:
        kr = res.per_k[k]
        print(f"main hals grid k={k}: mean iters {kr.iterations.mean():.1f}, "
              f"max iters {int(kr.iterations.max())}, stop reasons "
              f"{stop_counts(kr)}, rho {kr.rho:.4f}", flush=True)
    if launches["hals_block_iterations"] != need or need < 1:
        raise AssertionError(
            f"hals_block_iterations launched "
            f"{launches['hals_block_iterations']} times for {need} trips "
            "(check_block resolves to 1: one launch a trip)")
    if out.host_syncs != need:
        raise AssertionError(f"hals grid: {out.host_syncs} host syncs for "
                             f"{need} trips")

    t0 = time.perf_counter()
    dense = nmfx_torch.nmfconsensus(
        a, ks=KS, restarts=r, keep_factors=True,
        solver_cfg=nmfx_torch.SolverConfig(algorithm="hals"))
    torch.cuda.synchronize()
    dense_wall = time.perf_counter() - t0
    check_sweep(dense, "hals dense grid", n)
    bands = {}
    for k in KS:
        dc = float(np.abs(res.per_k[k].consensus
                          - dense.per_k[k].consensus).mean()) * r
        flips = float((hals_labels(res, k) != hals_labels(dense, k)).mean(
            axis=1).max())
        bands[k] = (dc, flips)
    print(f"main hals dense grid (backend auto): wall {dense_wall:.3f} s, "
          f"best k {dense.best_k}; against the pallas grid, per k "
          "(mean|dC|*R, max label flips per restart): "
          + ", ".join(f"k={k} ({dc:.4f}, {fl:.4f})"
                      for k, (dc, fl) in bands.items()), flush=True)
    bad = {k: v for k, v in bands.items() if v[0] > 0.6 or v[1] > 0.1}
    if bad:
        raise AssertionError(f"hals pallas vs dense outside the band "
                             f"(mean|dC|*R <= 0.6, flips <= 0.1): {bad}")
    return launches


def same_bytes(x, y) -> bool:
    x, y = np.asarray(x), np.asarray(y)
    return x.dtype == y.dtype and x.shape == y.shape and \
        x.tobytes() == y.tobytes()


#: the KResult fields a streamed run must reproduce byte for byte
KRESULT_FIELDS = ("consensus", "rho", "dispersion", "membership", "order",
                  "iterations", "dnorms", "stop_reasons", "best_w", "best_h")


def phase_host_tail(torch, fm):
    """The host tail of the north-star hals grid (backend "pallas"), each
    run under a Profiler and with the kernel and native call counts set to
    0 just before it: the streamed harvest (the default), the sequential
    one, and device rank selection. Streamed and sequential must be
    byte-equal and take the native library's linkage and cutree once a
    rank; device and host must give the same best k and k = 2
    memberships. Then native against numpy linkage and cutree on the
    streamed run's n = 500 consensus matrices: byte-equal, both timed."""
    import nmfx_torch
    from nmfx_torch import cophenetic, native
    from nmfx_torch.profiling import Profiler

    m, n, r, _ = NORTH_STAR
    a = north_star_matrix()
    cfg = nmfx_torch.SolverConfig(algorithm="hals", backend="pallas")
    runs = {}
    for label, kw in (("streamed", {}),
                      ("sequential", dict(harvest="sequential")),
                      ("device", dict(rank_selection="device"))):
        prof = Profiler()
        fm.reset_launch_counts()
        native.reset_call_counts()
        t0 = time.perf_counter()
        with prof:
            res = nmfx_torch.nmfconsensus(a, ks=KS, restarts=r,
                                          solver_cfg=cfg, profiler=prof,
                                          **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fm.LAUNCHES["hals_block_iterations"]
        calls = dict(native.CALLS)
        check_sweep(res, f"host tail {label}", n)
        solve = prof.phases["solve.grid"].seconds
        phases = ", ".join(f"{rec.name} {rec.seconds:.4f} s x{rec.count}"
                           for rec in prof.phases.values())
        print(f"host tail hals grid, {label}: wall {wall:.3f} s, solve.grid "
              f"{solve:.3f} s, after it {wall - solve:.3f} s; phases "
              f"{phases}; audit {prof.audit(wall)}; hals_block_iterations "
              f"launches {launches}; native calls {calls}; best k "
              f"{res.best_k}", flush=True)
        if launches < 1:
            raise AssertionError(f"host tail {label}: the hals grid launched "
                                 "no hals_block_iterations")
        want = 0 if label == "device" else len(KS)
        if (calls["average_linkage"], calls["cut_tree"]) != (want, want):
            raise AssertionError(
                f"host tail {label}: native linkage/cutree called "
                f"{calls['average_linkage']}/{calls['cut_tree']} times, "
                f"{want} expected")
        runs[label] = res
    streamed, sequential, device = runs.values()
    diff = [(k, f) for k in KS for f in KRESULT_FIELDS
            if not same_bytes(getattr(streamed.per_k[k], f),
                              getattr(sequential.per_k[k], f))]
    print(f"host tail: streamed and sequential byte-equal in "
          f"{', '.join(KRESULT_FIELDS)} at every k: {not diff}", flush=True)
    if diff:
        raise AssertionError(f"host tail: streamed differs from sequential "
                             f"at (k, field) {diff}")
    rho_gap = max(abs(device.per_k[k].rho - streamed.per_k[k].rho)
                  for k in KS)
    memb = [k for k in KS if np.array_equal(device.per_k[k].membership,
                                            streamed.per_k[k].membership)]
    print(f"host tail: device rank selection best k {device.best_k} vs host "
          f"{streamed.best_k}, memberships equal at ks {memb}, largest rho "
          f"difference {rho_gap:.3g}", flush=True)
    if device.best_k != streamed.best_k or 2 not in memb:
        raise AssertionError("host tail: device and host rank selection "
                             "disagree")

    for k in (2, KS[-1]):
        dist = 1.0 - streamed.per_k[k].consensus
        np.fill_diagonal(dist, 0.0)
        t0 = time.perf_counter()
        nat = cophenetic.average_linkage(dist)
        nat_cut = cophenetic.cut_tree(nat.linkage, n, k)
        nat_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = cophenetic.average_linkage_numpy(dist)
        ref_cut = cophenetic.cut_tree_numpy(ref.linkage, n, k)
        ref_s = time.perf_counter() - t0
        equal = all(same_bytes(x, y) for x, y in zip(
            (*nat, nat_cut), (*ref, ref_cut)))
        print(f"host tail: linkage and cutree of the k={k} consensus (n={n}):"
              f" native {nat_s:.4f} s, numpy {ref_s:.4f} s; linkage, coph, "
              f"order and memberships byte-equal {equal}", flush=True)
        if not equal:
            raise AssertionError(f"host tail: native and numpy linkage differ"
                                 f" at k={k}")


def phase_per_rank_path(torch, fm, grid):
    """nmfconsensus at the north-star width, one rank at a time, through
    the per-iteration kernel pair; each rank's iterations beside those of
    the whole grid's run ``grid`` (recorded, not a gate)."""
    import nmfx_torch

    m, n, r, _ = NORTH_STAR
    a = north_star_matrix()
    ranks = {}
    clock = [time.perf_counter()]

    def on_rank(k, out):
        torch.cuda.synchronize()
        now = time.perf_counter()
        ranks[k] = (now - clock[0], out.host_syncs)
        clock[0] = now

    fm.reset_launch_counts()
    clock[0] = time.perf_counter()
    res = nmfx_torch.nmfconsensus(
        a, ks=KS, restarts=r, solver_cfg=nmfx_torch.SolverConfig(
            backend="pallas"), grid_exec="per_k", on_rank=on_rank)
    launches = dict(fm.LAUNCHES)
    need = 0
    same = []
    for k in KS:
        kr, gr = res.per_k[k], grid.per_k[k]
        wall, syncs = ranks[k]
        jobs = np.array_equal(kr.iterations, gr.iterations)
        if jobs:
            same.append(k)
        print(f"main per-rank k={k}: wall {wall:.3f} s, mean iters "
              f"{kr.iterations.mean():.1f} (whole grid "
              f"{gr.iterations.mean():.1f}, per-job iterations equal "
              f"{jobs}), max iters "
              f"{int(kr.iterations.max())}, stop reasons {stop_counts(kr)}, "
              f"host syncs {syncs}", flush=True)
        need += int(kr.iterations.max())
    print(f"main per-rank vs whole grid: per-job iterations equal at ks "
          f"{same} of {list(KS)}", flush=True)
    check_sweep(res, "per-rank route", n)
    for name in ("fused_h_update", "lane_gram", "fused_w_update"):
        if launches[name] < need:
            raise AssertionError(
                f"{name} launched {launches[name]} times on the per-rank "
                f"route; the ranks' longest lanes need {need}")
    print(f"main per-rank launches {launches} (sum over ranks of the "
          f"longest lane: {need}); sweep wall "
          f"{sum(w for w, _ in ranks.values()):.3f} s", flush=True)
    print(res.summary(), flush=True)
    return launches


def phase_checks(torch, fm):
    """On both routes, and with hals, the bundled design must select k=2;
    on it the whole grid's per-iteration fallback must give the block
    route's results; a small input must agree between the card (kernels)
    and the CPU (plain versions); the whole grid must give the same
    results at any slot count and tail setting."""
    import nmfx_torch
    from nmfx_torch.datasets import two_group_matrix

    cfg = nmfx_torch.SolverConfig(backend="pallas")
    hals = nmfx_torch.SolverConfig(algorithm="hals", backend="pallas")
    a = two_group_matrix(n_genes=1000, n_per_group=20, seed=123)
    for label, route, scfg in (("mu", "per_k", cfg), ("mu", "auto", cfg),
                               ("hals", "auto", hals)):
        t0 = time.perf_counter()
        res = nmfx_torch.nmfconsensus(a, ks=(2, 3, 4, 5), restarts=10,
                                      seed=123, solver_cfg=scfg,
                                      grid_exec=route)
        print(f"bundled 1000x40 {label} grid_exec={route}: "
              f"{time.perf_counter() - t0:.3f} s, best k = {res.best_k}, "
              f"rho {res.rhos.tolist()}", flush=True)
        if res.best_k != 2:
            raise AssertionError(f"bundled design, {label} grid_exec="
                                 f"{route}: best k {res.best_k} != 2")

    # the reference's fallback contract (nmfx/ops/pallas_mu.py:43-45): with
    # max_iter not a multiple of check_every the whole grid runs the
    # per-iteration pair instead of the block kernel, and no job reaches
    # either cap, so per-job iterations, stop reasons and consensus match
    kw = dict(ks=(2, 3, 4, 5), restarts=10, seed=123)
    runs = {}
    for max_iter in (10_000, 10_001):
        scfg = nmfx_torch.SolverConfig(backend="pallas", max_iter=max_iter)
        fm.reset_launch_counts()
        t0 = time.perf_counter()
        runs[max_iter] = (nmfx_torch.nmfconsensus(a, solver_cfg=scfg, **kw),
                          dict(fm.LAUNCHES), time.perf_counter() - t0)
    (blk, blk_n, blk_s), (pair, pair_n, pair_s) = runs.values()
    same = {k: (np.array_equal(blk.per_k[k].iterations,
                               pair.per_k[k].iterations)
                and np.array_equal(blk.per_k[k].stop_reasons,
                                   pair.per_k[k].stop_reasons)
                and np.array_equal(blk.per_k[k].consensus.view(np.int64),
                                   pair.per_k[k].consensus.view(np.int64)))
            for k in kw["ks"]}
    capped = max(int(res.per_k[k].iterations.max())
                 for res in (blk, pair) for k in kw["ks"])
    print(f"fallback contract 1000x40 ks 2..5 x10: max_iter 10001 (the "
          f"pair, {pair_s:.3f} s, launches {pair_n}) vs 10000 (the block "
          f"kernel, {blk_s:.3f} s, launches {blk_n}): per-job iterations, "
          f"stop reasons and consensus equal per k {same}; longest job "
          f"{capped} iterations", flush=True)
    if not all(same.values()) or capped >= 10_000:
        raise AssertionError("fallback contract: the per-iteration pair "
                             "and the block kernel disagree on the whole "
                             "grid")
    if (pair_n["fused_h_update"] < 1 or pair_n["fused_block_iterations"]
            or blk_n["fused_block_iterations"] < 1 or blk_n["fused_h_update"]):
        raise AssertionError("fallback contract: a route ran the other "
                             "route's kernels")

    small = two_group_matrix(n_genes=200, n_per_group=12, seed=3)
    for label, route, scfg in (
            ("mu", "per_k", nmfx_torch.SolverConfig(backend="pallas",
                                                    max_iter=200)),
            ("mu", "auto", nmfx_torch.SolverConfig(backend="pallas",
                                                   max_iter=200)),
            ("hals packed", "auto", nmfx_torch.SolverConfig(
                algorithm="hals", backend="pallas", max_iter=200)),
            ("hals dense", "auto", nmfx_torch.SolverConfig(
                algorithm="hals", max_iter=200))):
        kw = dict(ks=(2, 3), restarts=4, seed=5, solver_cfg=scfg,
                  grid_exec=route)
        gpu = nmfx_torch.nmfconsensus(small, **kw)
        cpu = nmfx_torch.nmfconsensus(small, device="cpu", **kw)
        for k in (2, 3):
            g, c = gpu.per_k[k], cpu.per_k[k]
            diff = float(np.abs(g.consensus - c.consensus).max())
            print(f"small 200x24 {label} grid_exec={route} k={k}: card vs "
                  f"CPU iterations equal "
                  f"{np.array_equal(g.iterations, c.iterations)}, stop "
                  f"reasons equal "
                  f"{np.array_equal(g.stop_reasons, c.stop_reasons)}, max "
                  f"|dC| {diff:.3g}, rho {g.rho} vs {c.rho}", flush=True)
            if not (np.array_equal(g.membership, c.membership)
                    and np.array_equal(g.iterations, c.iterations)
                    and np.array_equal(g.stop_reasons, c.stop_reasons)
                    and diff <= 0.25):
                raise AssertionError(f"small input {label} grid_exec="
                                     f"{route} k={k}: card and CPU disagree")

    # schedule-free: the block kernel's sums do not depend on the pool
    # width or a lane's slot, so only the schedule may change
    kw = dict(ks=(2, 3, 4, 5), restarts=10, seed=5, keep_factors=True,
              solver_cfg=cfg)
    runs = {(slots, tail): nmfx_torch.nmfconsensus(
        small, grid_slots=slots, grid_tail_slots=tail, **kw)
        for slots, tail in ((SLOTS, "auto"), (5, "auto"), (SLOTS, None))}
    base = runs[(SLOTS, "auto")]
    for (slots, tail), res in runs.items():
        same = all(
            np.array_equal(res.per_k[k].iterations, base.per_k[k].iterations)
            and np.array_equal(res.per_k[k].stop_reasons,
                               base.per_k[k].stop_reasons)
            for k in kw["ks"])
        bits = all(np.array_equal(res.per_k[k].all_h, base.per_k[k].all_h)
                   for k in kw["ks"])
        print(f"schedule-free 200x24 ks 2..5 x10: grid_slots={slots} "
              f"grid_tail_slots={tail} vs {SLOTS}/auto: iterations and "
              f"stop reasons equal {same}, factors bit-equal {bits}",
              flush=True)
        if not (same and bits):
            raise AssertionError(f"whole grid at grid_slots={slots}, "
                                 f"grid_tail_slots={tail}: results depend "
                                 "on the schedule")


def profiled(torch, fn):
    """(wall s, device busy ms, rows) of one call of ``fn`` under
    torch.profiler; rows = (device us, count, kernel) by device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and e.self_device_time_total > 0), reverse=True)
    return wall, sum(row[0] for row in rows) / 1e3, rows


def profile_line(label, iters, plain_wall, wall, busy_ms, rows):
    top = "; ".join(f"{key[:40]} {us / 1e3 / iters:.4f} ms/it x{cnt}"
                    for us, cnt, key in rows[:6])
    share = (f"{busy_ms / (wall * 1e3):.3f}" if busy_ms
             else "not measured (no device time in the trace)")
    return (f"{label}: {iters} iterations {plain_wall * 1e3 / iters:.4f} "
            f"ms/it ({wall * 1e3 / iters:.4f} under the profiler), kernels "
            f"{busy_ms / iters:.4f} ms/it, device busy share {share}; top: "
            f"{top}")


def timed(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_profile(torch):
    """Where one solve iteration's time goes, on both routes, with every
    check run and no lane stopping (so the iteration count is fixed):
    a 200-iteration packed solve per rank (k=2, k=10), and 20 trips of
    the 48-slot scheduler on 48 k=10 jobs (mu: 160 iterations; hals: 40,
    its lanes reported if TolFun stops any), each timed alone after a
    warm-up and then under torch.profiler. Device busy
    share = summed device time of the CUDA kernels over the profiled
    wall."""
    from nmfx_torch import random as rnd
    from nmfx_torch.config import InitConfig, SolverConfig
    from nmfx_torch.init import restart_inits
    from nmfx_torch.ops.packed_mu import mu_packed
    from nmfx_torch.ops.sched_mu import mu_sched

    m, n, r, _ = NORTH_STAR
    a = torch.as_tensor(north_star_matrix(), dtype=torch.float32,
                        device="cuda")
    iters = 200
    cfg = SolverConfig(backend="pallas", max_iter=iters,
                       stable_checks=10**6, tol_x=0.0)
    for k in (2, 10):
        t0 = time.perf_counter()
        w0s, h0s = restart_inits(a, rnd.split(rnd.fold_in(rnd.key(123), k),
                                              r), k, InitConfig())
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        run = lambda: mu_packed(a, w0s, h0s, cfg)  # noqa: E731
        run()  # warm-up
        plain_wall = timed(torch, run)
        line = profile_line(f"profile per-rank k={k}", iters, plain_wall,
                            *profiled(torch, run))
        print(f"{line}; init draws {init_s:.3f} s", flush=True)

    k = NORTH_STAR[3]
    w0s, h0s = restart_inits(a, rnd.split(rnd.fold_in(rnd.key(123), k),
                                          SLOTS), k, InitConfig())
    # mu: 20 trips of check_block launches; hals as its main path runs
    # it, one 2-iteration launch and one check (with TolFun's direct
    # residual) a trip, 20 trips
    for algorithm, iters in (("mu", 20 * CHECK_EVERY * CHECK_BLOCK),
                             ("hals", 20 * CHECK_EVERY)):
        cfg = SolverConfig(algorithm=algorithm, backend="pallas",
                           max_iter=iters, stable_checks=10**6, tol_x=0.0,
                           tol_fun=0.0)
        out = {}

        def run():
            out["res"] = mu_sched(a, w0s, h0s, cfg, slots=SLOTS,
                                  device="cuda")

        run()  # warm-up
        plain_wall = timed(torch, run)
        prof = profiled(torch, run)
        res = out["res"]
        early = int((res.iterations < iters).sum())
        if algorithm == "mu" and early:
            raise AssertionError("scheduler profile: a lane stopped early")
        label = "grid" if algorithm == "mu" else "hals grid"
        print(profile_line(f"profile {label} {SLOTS} slots k={k} "
                           f"({sum(res.pool_trips)} trips, {res.host_syncs} "
                           f"host syncs, {early} lanes stopped early)",
                           iters, plain_wall, *prof), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and kernel parity only")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "nmfx_torch")):
        print("chip_smoke: the nmfx_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from nmfx_torch import native
    from nmfx_torch.device import resolve_device
    from nmfx_torch.ops import _build
    from nmfx_torch.ops import fused_mu as fm

    resolve_device(None)  # TF32 off for every plain product below
    card = smi()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{kind}", flush=True)
    t0 = time.perf_counter()
    built = _build.build()
    print(f"nvcc build {time.perf_counter() - t0:.2f} s "
          f"({'cold' if any(built.values()) else 'cached'}: {built})",
          flush=True)
    t0 = time.perf_counter()
    host_lib = native.build()
    native.load()
    print(f"host library g++ build {time.perf_counter() - t0:.2f} s: "
          f"{os.path.relpath(host_lib, HERE)}", flush=True)
    print_resources(_build, "block_mu")
    print_resources(_build, "hals_block")

    ns_err = phase_parity(torch, fm)
    ns_err.update(phase_block_parity(torch, fm))
    phase_pair_equality(torch, fm)
    ns_err["hals_block_iterations"] = phase_hals_parity(torch, fm)
    if not args.quick:
        rates = peaks(kind)
        timing = phase_timing(torch, fm, rates)[NORTH_STAR[3]]
        timing.update(phase_block_timing(torch, fm, rates))
        # each kernel's launches come from its own main path's run
        launches, phased, phased_wall = phase_grid_path(torch, fm)
        launches["fused_block_iterations_fused"] = phase_fused_grid_path(
            torch, fm, phased, phased_wall)["fused_block_iterations_fused"]
        per_rank = phase_per_rank_path(torch, fm, phased)
        for name in ("fused_h_update", "fused_w_update"):
            launches[name] = per_rank[name]
        launches["hals_block_iterations"] = phase_hals_path(
            torch, fm)["hals_block_iterations"]
        phase_host_tail(torch, fm)
        phase_checks(torch, fm)
        phase_profile(torch)
        kernels = []
        for name, source, line in (
                ("fused_h_update", "block_mu.cu", 147),
                ("fused_w_update", "block_mu.cu", 731),
                ("fused_block_iterations", "block_mu.cu", 539),
                ("fused_block_iterations_fused", "block_mu.cu", 382),
                ("hals_block_iterations", "hals_block.cu", 984)):
            ms, plain, lib, bound, by = timing[name]
            kernels.append({
                "name": name, "route": "cuda",
                "source": f"nmfx_torch/csrc/{source}",
                "replaces": f"nmfx/ops/pallas_mu.py:{line}",
                "launches": launches[name], "max_abs_err": ns_err[name],
                "ms": ms, "plain_ms": plain, "bound_ms": bound,
                "bound_by": by, "library_ms": lib})
        print(f"card: {smi()}", flush=True)
        print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
