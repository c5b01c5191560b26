#!/usr/bin/env python3
"""North-star sweep walls and their after-solve parts, this checkout
against another one (its parent), in turns on one card.

    python3 scripts/host_tail_ab.py --parent DIR [--rounds 1]

DIR is another checkout of the repository (``git archive`` of the parent
commit into a git-ignored directory such as ``_archive/``). Each turn is a
fresh process that imports ``nmfx_torch`` from one tree, warms up on a
small input, then runs ``nmfconsensus`` at the north star (the 5000x500
two-group matrix, ks 2..10, 50 restarts) three times: mu on the whole
grid and hals on the whole grid (both ``backend="pallas"``), and mu per
rank (``backend="pallas", grid_exec="per_k"``), every other argument at
the tree's defaults. The turns run parent, this, this, parent
(``--rounds`` times). The solve of a sweep ends at its last ``on_rank``
callback (after a ``torch.cuda.synchronize()``); its after-solve part is
the wall minus that. Each turn prints one JSON line; the script then
checks that both trees give the same rank tables (best k, rho and mean
iterations per k) and prints the walls and after-solve parts side by
side. Exits non-zero on a failed turn or a differing rank table.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, N, RESTARTS = 5000, 500, 50
KS = tuple(range(2, 11))
RUNS = (("mu grid", "mu", "auto"), ("hals grid", "hals", "auto"),
        ("mu per-rank", "mu", "per_k"))


def child(tree: str, label: str) -> int:
    sys.path.insert(0, tree)
    import torch

    import nmfx_torch
    from nmfx_torch.datasets import two_group_matrix

    if not nmfx_torch.__file__.startswith(os.path.abspath(tree)):
        raise SystemExit(f"imported {nmfx_torch.__file__}, not from {tree}")
    small = two_group_matrix(n_genes=200, n_per_group=12, seed=3)
    for _, algorithm, route in RUNS:  # builds, loads and warms every path
        nmfx_torch.nmfconsensus(
            small, ks=(2, 3), restarts=4, grid_exec=route,
            solver_cfg=nmfx_torch.SolverConfig(
                algorithm=algorithm, backend="pallas", max_iter=50))
    a = two_group_matrix(n_genes=M, n_per_group=N // 2, seed=123)
    for name, algorithm, route in RUNS:
        clock = {}

        def on_rank(k, out):
            torch.cuda.synchronize()
            clock["solved"] = time.perf_counter()

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = nmfx_torch.nmfconsensus(
            a, ks=KS, restarts=RESTARTS, grid_exec=route, on_rank=on_rank,
            solver_cfg=nmfx_torch.SolverConfig(algorithm=algorithm,
                                               backend="pallas"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(json.dumps({
            "tree": label, "run": name, "wall_s": wall,
            "solve_s": clock["solved"] - t0,
            "after_solve_s": wall - (clock["solved"] - t0),
            "best_k": res.best_k,
            "rho": [res.per_k[k].rho for k in KS],
            "mean_iters": [float(res.per_k[k].iterations.mean())
                           for k in KS]}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other checkout")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--label", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child, args.label)
    if not args.parent:
        ap.error("--parent is required")
    trees = {"parent": os.path.abspath(args.parent), "this": HERE}
    rows = []
    for _ in range(args.rounds):
        for label in ("parent", "this", "this", "parent"):
            proc = subprocess.run(
                [sys.executable, "-X", "faulthandler",
                 os.path.abspath(__file__), "--child", trees[label],
                 "--label", label],
                capture_output=True, text=True, timeout=1800)
            if proc.returncode:
                print(f"turn {label} failed with code {proc.returncode}:\n"
                      f"{proc.stdout}{proc.stderr[-8000:]}", file=sys.stderr)
                return 1
            for line in proc.stdout.splitlines():
                if line.startswith("{"):
                    print(line, flush=True)
                    rows.append(json.loads(line))
    ok = True
    for name, _, _ in RUNS:
        got = [r for r in rows if r["run"] == name]
        tables = {json.dumps([r["best_k"], r["rho"], r["mean_iters"]])
                  for r in got}
        same = len(tables) == 1
        ok &= same
        for label in ("parent", "this"):
            mine = [r for r in got if r["tree"] == label]
            walls = ", ".join(f"{r['wall_s']:.3f}" for r in mine)
            afters = ", ".join(f"{r['after_solve_s']:.3f}" for r in mine)
            print(f"{name} {label}: wall {walls} s, after the solve "
                  f"{afters} s, best k {mine[0]['best_k']}", flush=True)
        print(f"{name}: rank tables (best k, rho, mean iterations per k) "
              f"equal in every turn: {same}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
