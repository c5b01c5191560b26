#!/usr/bin/env python3
"""Drive nmfx_torch on one CUDA card and hold its kernels to their plain
versions.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --quick    # build + kernel parity only

Phases (any failure exits non-zero; nothing is caught):
  1. card and build: nvidia-smi's name and power limit, the nvcc build;
  2. kernel parity: each kernel against its plain PyTorch version at the
     north-star shape, a ragged shape and with planted exact zeros;
  3. kernel timing (CUDA events, median of 25 after warm-up) beside the
     plain version, a torch.matmul composite and the card's bound;
  4. the main path: nmfconsensus on the 5000x500 two-group matrix,
     ks 2..10, 50 restarts, backend "pallas", grid_exec "per_k", with
     every kernel's launch count read around it;
  5. the bundled 1000x40 design (best k must be 2) and a small input run
     on the card and on the CPU (plain versions), which must agree;
  6. a profile of 200 packed iterations at k=2 and k=10: time per
     iteration, the device's busy share and the kernels by device time.

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


def masked_h_gram(torch, hp, k):
    from nmfx_torch.ops.packed_mu import bd_select, block_diag_mask

    return bd_select(hp @ hp.T, block_diag_mask(hp.shape[0] // k, k,
                                                hp.device))


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
        gh = masked_h_gram(torch, want_h, k)
        want_w = fm.fused_w_update_ref(a, wp, want_h, gh, k=k)
        got_w = fm.fused_w_update(a, wp, want_h, gh, k=k)
        ew = check_close(torch, f"fused_w_update[{label}]", got_w, want_w,
                         zeros)
        print(f"parity {label} m={m} n={n} R={r} k={k}: fused_h_update "
              f"max abs {eh[0]:.3e} rel {eh[1]:.3e}; fused_w_update max "
              f"abs {ew[0]:.3e} rel {ew[1]:.3e} (rtol={RTOL}, "
              f"atol={ATOL_REL}*max|ref|)", flush=True)
        if label == "north-star":
            ns_err = {"fused_h_update": eh[0], "fused_w_update": ew[0]}
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


def library_w(torch, a, wp, hp, gh, k):
    from nmfx_torch.solvers.mu import _mu_update

    m, rk = wp.shape
    r = rk // k
    g3 = torch.diagonal(gh.reshape(r, k, r, k), dim1=0,
                        dim2=2).permute(2, 0, 1)
    denom = torch.bmm(wp.reshape(m, r, k).permute(1, 0, 2), g3)
    return _mu_update(wp, a @ hp.T, denom.permute(1, 0, 2).reshape(m, rk),
                      1e-9, 0.0)


def bounds(m, n, rk, k, rates):
    """Least time (ms) the card could take: bytes each input read once
    and each output written once, and the FLOPs these inputs need."""
    flops, bw = rates
    h_bytes = 4 * (m * n + m * rk + rk * n + rk * n)
    h_ops = 2 * m * n * rk + 2 * m * rk * k + 2 * rk * n * k + 5 * rk * n
    w_bytes = 4 * (m * n + m * rk + rk * n + rk * rk + m * rk)
    w_ops = 2 * m * n * rk + 2 * m * rk * k + 5 * m * rk
    out = {}
    for name, nb, no in (("fused_h_update", h_bytes, h_ops),
                         ("fused_w_update", w_bytes, w_ops)):
        tb, to = nb / bw * 1e3, no / flops * 1e3
        out[name] = (max(tb, to), "bytes" if tb >= to else "operations")
    return out


def phase_timing(torch, fm, rates):
    """Kernel, plain and library times at the north star and at k=2."""
    table = {}
    for m, n, r, k in (NORTH_STAR, (5000, 500, 50, 2)):
        a, wp, hp = operands(torch, m, n, r, k, seed=2)
        gh = masked_h_gram(torch, hp, k)
        bnd = bounds(m, n, r * k, k, rates)
        row = {
            "fused_h_update": (
                time_ms(torch, lambda: fm.fused_h_update(a, wp, hp, k=k)),
                time_ms(torch, lambda: fm.fused_h_update_ref(a, wp, hp,
                                                             k=k)),
                time_ms(torch, lambda: library_h(torch, a, wp, hp, k))),
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


def phase_main_path(torch, fm):
    """nmfconsensus at the north-star width through both kernels."""
    import nmfx_torch
    from nmfx_torch.datasets import two_group_matrix

    m, n, r, _ = NORTH_STAR
    a = two_group_matrix(n_genes=m, n_per_group=n // 2, seed=123)
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
    for k in KS:
        kr = res.per_k[k]
        stops = {int(s): int((kr.stop_reasons == s).sum())
                 for s in sorted(set(kr.stop_reasons.tolist()))}
        wall, syncs = ranks[k]
        print(f"main k={k}: wall {wall:.3f} s, mean iters "
              f"{kr.iterations.mean():.1f}, max iters "
              f"{int(kr.iterations.max())}, stop reasons {stops}, host "
              f"syncs {syncs}", flush=True)
        need += int(kr.iterations.max())
        if not (np.isfinite(kr.consensus).all()
                and np.isfinite(kr.dnorms).all()):
            raise AssertionError(f"main path k={k}: non-finite output")
        if kr.consensus.shape != (n, n):
            raise AssertionError(f"main path k={k}: consensus shape "
                                 f"{kr.consensus.shape}")
    for name, count in launches.items():
        if count < need:
            raise AssertionError(
                f"{name} launched {count} times on the main path; the "
                f"ranks' longest lanes need {need}")
    print(f"main launches {launches} (sum over ranks of the longest "
          f"lane: {need})", flush=True)
    print(res.summary(), flush=True)
    return launches


def phase_checks(torch):
    """Bundled design must select k=2; a small input must agree between
    the card (kernels) and the CPU (plain versions)."""
    import nmfx_torch
    from nmfx_torch.datasets import two_group_matrix

    cfg = nmfx_torch.SolverConfig(backend="pallas")
    a = two_group_matrix(n_genes=1000, n_per_group=20, seed=123)
    t0 = time.perf_counter()
    res = nmfx_torch.nmfconsensus(a, ks=(2, 3, 4, 5), restarts=10, seed=123,
                                  solver_cfg=cfg, grid_exec="per_k")
    print(f"bundled 1000x40: {time.perf_counter() - t0:.3f} s, best k = "
          f"{res.best_k}, rho {res.rhos.tolist()}", flush=True)
    if res.best_k != 2:
        raise AssertionError(f"bundled design: best k {res.best_k} != 2")

    small = two_group_matrix(n_genes=200, n_per_group=12, seed=3)
    scfg = nmfx_torch.SolverConfig(backend="pallas", max_iter=200)
    kw = dict(ks=(2, 3), restarts=4, seed=5, solver_cfg=scfg,
              grid_exec="per_k")
    gpu = nmfx_torch.nmfconsensus(small, **kw)
    cpu = nmfx_torch.nmfconsensus(small, device="cpu", **kw)
    for k in (2, 3):
        g, c = gpu.per_k[k], cpu.per_k[k]
        diff = float(np.abs(g.consensus - c.consensus).max())
        print(f"small 200x24 k={k}: card vs CPU iterations equal "
              f"{np.array_equal(g.iterations, c.iterations)}, max "
              f"|dC| {diff:.3g}, rho {g.rho} vs {c.rho}", flush=True)
        if not (np.array_equal(g.membership, c.membership)
                and np.array_equal(g.iterations, c.iterations)
                and np.array_equal(g.stop_reasons, c.stop_reasons)
                and diff <= 0.25):
            raise AssertionError(f"small input k={k}: card and CPU "
                                 "disagree")


def phase_profile(torch):
    """Where one solve iteration's time goes: a fixed 200-iteration packed
    solve per rank (every check runs, no lane stops) timed alone and
    under torch.profiler; device busy share = summed device time of the
    CUDA kernels over the profiled wall."""
    from torch.profiler import ProfilerActivity, profile

    from nmfx_torch import random as rnd
    from nmfx_torch.config import InitConfig, SolverConfig
    from nmfx_torch.datasets import two_group_matrix
    from nmfx_torch.init import restart_inits
    from nmfx_torch.ops.packed_mu import mu_packed

    m, n, r, _ = NORTH_STAR
    a = torch.as_tensor(two_group_matrix(n_genes=m, n_per_group=n // 2,
                                         seed=123), dtype=torch.float32,
                        device="cuda")
    iters = 200
    # every check runs but no lane ever stops: the iteration count is fixed
    cfg = SolverConfig(backend="pallas", max_iter=iters,
                       stable_checks=10**6, tol_x=0.0)
    for k in (2, 10):
        t0 = time.perf_counter()
        w0s, h0s = restart_inits(a, rnd.split(rnd.fold_in(rnd.key(123), k),
                                              r), k, InitConfig())
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        mu_packed(a, w0s, h0s, cfg)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mu_packed(a, w0s, h0s, cfg)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mu_packed(a, w0s, h0s, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = sorted(((e.self_device_time_total, e.count, e.key)
                       for e in prof.key_averages()
                       if str(e.device_type).endswith("CUDA")
                       and e.self_device_time_total > 0), reverse=True)
        busy_ms = sum(row[0] for row in rows) / 1e3
        top = "; ".join(f"{key[:40]} {us / 1e3 / iters:.4f} ms/it x{cnt}"
                        for us, cnt, key in rows[:6])
        share = (f"{busy_ms / (wall * 1e3):.3f}" if busy_ms
                 else "not measured (no device time in the trace)")
        print(f"profile k={k}: init draws {init_s:.3f} s; {iters} "
              f"iterations {plain_wall * 1e3 / iters:.4f} ms/it "
              f"({wall * 1e3 / iters:.4f} under the profiler), kernels "
              f"{busy_ms / iters:.4f} ms/it, device busy share {share}; "
              f"top: {top}", flush=True)


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

    ns_err = phase_parity(torch, fm)
    if not args.quick:
        timing = phase_timing(torch, fm, peaks(kind))
        launches = phase_main_path(torch, fm)
        phase_checks(torch)
        phase_profile(torch)
        kernels = []
        for name, line in (("fused_h_update", 147), ("fused_w_update", 731)):
            ms, plain, lib, bound, by = timing[NORTH_STAR[3]][name]
            kernels.append({
                "name": name, "route": "cuda",
                "source": "nmfx_torch/csrc/fused_mu.cu",
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
