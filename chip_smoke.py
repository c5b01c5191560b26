#!/usr/bin/env python3
"""Drive nmfx_torch on one CUDA card and hold its kernels to their plain
versions.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --quick    # build + kernel parity + split
    python3 chip_smoke.py --tiles    # build + kernel parity + phase 12
    python3 chip_smoke.py --scale    # build + parity + 4a, 4d + phase 13
    python3 chip_smoke.py --mesh     # build + parity + 4a, 4d + phase 14
    python3 chip_smoke.py --grid-mesh  # build + parity + phase 15
    python3 chip_smoke.py --autotune   # build + parity + phase 16

Phases (any failure exits non-zero; nothing is caught):
  1. card and build: nvidia-smi's name and power limit, the nvcc build
     (one nvcc per source, all started together) and the host library's
     g++ build, each block kernel function's registers, shared memory
     and spills (ptxas -v), and each instantiation of the kernels that
     run the product tiles with its HGMMA count from cuobjdump -sass
     (every bf16 one must issue wgmma, no float32 one may);
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
     k = 3, whose rows are not 16-byte aligned); then each kernel's
     options (phase_option_parity): bf16 operands in rows 1-5 (the pair
     also byte-equal to one bf16 block iteration; the block kernels held
     to float64 as close as their float32 plain versions), bf16 pool
     factors ("bfloat16", "bfloat16_w") in rows 3-5, segment ids of a
     ragged class-blocked pool in rows 3-4 (the north star's and one at
     1237x77; iota // k byte-equal to the k-only launch), alias_io in
     rows 3-5 and block_m None / 128 / 256, each byte-equal to the
     default launch; then float64 storage (phase_float64_parity): rows
     1, 2, 3 and 5, and row 3 under bf16 operands, on a float64 pool's
     float32 values (what a float64 solve hands the kernels) against
     their plain versions on those values at the float32 tolerance
     (rows 5 and 3b: against the float64 plain version on the float64
     pool, within HALS_FACTOR of the float32 plain version's error), and
     how far each is from the float64 plain version on the float64 pool
     (the JAX package rounds each float64 product once; printed, not
     gated);
  3. kernel timing (CUDA events, median of 25 after warm-up) beside the
     plain version, a torch.matmul composite and the card's bound, also
     for the option variants the option paths run (a bf16 variant's
     bound counts A at 2 bytes and the bf16 tensor-core peak; beside the
     float32 composite, the same composite on bf16 tensors) and for the
     join-the-updates block kernel under bf16 operands (row 4); and the
     float64 entries' kernels on a float64 pool's float32 values, with
     the casts a float64 solve adds (A once a solve, the per-rank
     check's widening);
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
        per-iteration kernel pair at ks 2..5, each rank's mean iterations
        beside the whole grid's from a;
     d. hals on the whole grid (backend "pallas": the slot scheduler on
        the HALS block kernel), beside the same sweep on the dense layout
        (backend "auto"), held to the reference's agreement band;
     e. the host tail: the hals whole grid of d under a Profiler with the
        streamed harvest (the default), the sequential one and device
        rank selection, each run's wall and phases; streamed and
        sequential byte-equal, device and host the same best k and k = 2
        memberships; then the native linkage and cutree against numpy's
        on the run's n = 500 consensus matrices, byte-equal, both timed;
     f. the options (phase_option_paths), each beside the float32 run of
        its route: the whole grid (at ks 2..5), the per-rank route (at ks
        2..3) and hals under matmul_precision "bfloat16", the grid with
        factor_dtype "bfloat16_w", the ragged class-blocked pool at ks
        2..6 (its per-job iterations and stops equal to a uniform
        check_block = 1 run's at those ks)
        and alias_io with block_m 256 (byte-equal to a); then the 200x24
        input under each option (and factor_dtype "bfloat16") on the
        card and on the CPU: the same iterations, stops and memberships;
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
     device's busy share, the kernels by device time;
  7. other solvers: kl, neals, als, snmf, pg (max_iter 100; 50 at the
     north star) and alspg
     (max_iter 20, sub_max_iter 100) through nmfconsensus at the north
     star with every other default (backend "auto": the batched restart
     route, plain products; kl, als, pg and alspg at k = 2, their depth
     cut to keep the script inside its time limit),
     then kl and neals on the packed whole grid
     (backend "packed", 48 slots), each with the kernels' launch counts
     set to 0 just before it (0 expected: no kernel lies on these
     routes): the wall split by the profiler's phases, per-k mean
     iterations, stop reasons and host syncs, best k, the grid's
     pool_trips, and packed beside batched (per-k mean iterations,
     max|dC|); then the gates: each solver's best k on the bundled
     1000x40 design (ks 2..5; kl and alspg at ks 2..3 since PR 18) on
     the card, on the CPU and as the JAX package gives it, all equal; a small input on the card and on the CPU, the same
     best k and k = 2 memberships; als on the packed grid at ks (2, 5)
     (a zero-padded lane in every pool) finite;
  8. durability (phase_durability), each run with the launch counts set
     to 0 just before it and read just after:
     a. the north-star sweep of 4c (backend "pallas") at ks 2..3
        through the checkpoint ledger, 10 restarts a record (10 chunks
        on the kernel pair; the depth cut to keep the script inside its
        time limit), the wall split by the profiler's phases;
     b. the same in a fresh directory, killed by proc.preempt at the
        5th chunk (4 records on disk), then resumed: 6 chunks solved,
        4 loaded, byte-equal to a;
     c. a's warm re-run: 0 chunks solved, 0 launches, 0 bytes copied;
     d. a against 4c at the same ranks: the same best k and k = 2
        memberships (the ranks whose memberships are equal listed),
        max|dC| <= 1e-6 and whether every per-restart iteration count
        is equal;
     e. solve.nonfinite (5 % of the restarts) on the whole grid (row 3)
        and on the hals grid (row 5): the poisoned restarts stop
        NUMERIC_FAULT, every other one is byte-equal to 4a's / 4d's run;
     f. sched.stale_reload on the bundled design's pallas grid (8
        slots): the restarts that differ from the clean run are the
        hashed set; disarmed, the run is byte-equal to the clean one;
     g. the bundled design in float64 on the batched restart route (ks
        2..3 since PR 18): its wall, best k as the JAX package gives it;
        then on the four float64 kernel routes (backend "pallas": the
        per-rank pair, the whole grid, the hals grid and the whole grid
        under bf16 operands), each beside the float32 run of the same
        call: best k as the JAX package gives it, float64 best_w, the
        route's rows launched, the k = 2 memberships equal to float32's;
  9. observability and the job grid (phase_obs), each run with the
     launch counts set to 0 just before it and read just after:
     a. the north-star whole grid (backend "pallas") with the tracer on
        under a Profiler, against 4a's untraced run of it: results and
        row 3's launches byte-equal, the exported Chrome trace one span
        (or instant) for each phase the profiler booked, nothing
        dropped; both walls;
     b. the cost model's attribution against the card's peak row of the
        traced grid, of the hals grid (row 5) and of the per-rank route
        at ks 2..4 (rows 1-2; the depth cut to keep the phase near its
        budget): model FLOPs equal to the script's own sum of
        iteration_flops x iterations, family "pallas", MFU finite in
        (0, 1.05], the per-lane bandwidth fraction finite and above 0
        (printed, no upper gate); each perf_summary() record and
        perf_report();
     c. the bundled design at ks 2..3 through the ledger (4 chunks of 5
        restarts, tracer on): the registry's chunk counter, its read
        shim, the ckpt.commit flight events and spans all 4; the Prometheus text
        names the checkpoint and input-cache series; solve.nonfinite
        armed leaves a fire event and a NUMERIC_FAULT restart, and a
        configured flight dump lists the armed site;
     d. the job grid: reduce_grid of a keep_factors sweep by k (each
        rank's consensus within 1e-6), by restart (10 groups of n x n)
        and with a custom fun; run_example's best k 2; sweep_one_k
        called with the JAX package's keywords and positions;
 10. serving (phase_serve): the multi-tenant server over the bucketed
     executable cache (5000x500 padded to its 5120x512 bucket), each run
     with the launch counts set to 0 just before it and read just after:
     a. four mu requests (backend "pallas", the JAX package's submit
        defaults: ks 2..5, 10 restarts; seeds 1-4) submitted to a paused
        server, then resumed: exactly one packed dispatch of 4 requests
        on row 3, each result byte-equal to its solo
        nmfconsensus(exec_cache=) run; one request against the plain
        nmfconsensus at the agreement tier (best k, k = 2 memberships),
        per-k mean iterations side by side;
     b. two hals requests packed on row 5, each byte-equal to its solo
        run;
     c. four requests at once (seeds 11-14) to a packing server and to
        a pack=False one: wall, requests/s, e2e p50/p95, mean queue
        wait, dispatches, packing efficiency, row 3 launches; every
        packed result byte-equal to its pack=False twin;
     d. on the bundled 1000x40 design: a result-cache warm hit (0
        dispatches, 0 copies and bytes to the card, 0 launches), three
        identical coalesced requests in 1 dispatch, close(cancel_pending)
        with a spill directory then readmit (byte-equal), an armed
        serve.scheduler failing the pending request with ServerCrashed
        and the fresh scheduler's next result byte-equal, and a
        deadline-clamped request byte-equal to a solo run at its clamped
        max_iter;
     e. mixed largest ranks: ks (2, 3) beside ks 2..5 (seeds 7-8) in one
        pool through the server's packed builder, for mu on row 3 and
        hals on row 5 (the server's compatibility key keeps such
        requests apart): each group byte-equal or not to its solo
        bucketed sweep, printed; the ks 2..5 request, whose lane width
        is its solo run's, must be byte-equal;
 11. the fleet tier and the command line (phase_fleet), each in-process
     run with the launch counts set to 0 just before it and read just
     after:
     a. python -m nmfx_torch on the north star written as a GCT (ks
        2..5, 10 restarts, backend "pallas") as a subprocess: its GCT
        outputs, cophenetic.txt and rank table byte-equal to read_gct,
        nmfconsensus and save_results of the same file in this
        process; the walls and best k;
     b. an NMFXRouter over two thread replicas sharing one ExecCache
        (the 5120x512 bucket): two mu requests of the north star and two
        of a second two-group matrix the rendezvous hash places on the
        other replica, then a hals request (backend "pallas", ks 2..5,
        10 restarts), each byte-equal to its solo
        nmfconsensus(exec_cache=) run; both replicas served; rows 3 and
        5 launched;
     c. an NMFXRouter over two process replicas on the card (each
        worker's spawn to first heartbeat): three mu requests of the
        bundled design (stickiness_slack 8) on the sticky replica, which
        is SIGKILLed right after the submits; every future resolves
        byte-equal to the in-process kernel run of its request (the
        children's launches cannot be counted here; the plain versions
        part from the kernels, so byte-equality is the proof), the
        router recovered 1, readmitted >= 1, completed 3, failed 0;
     d. python -m nmfx_torch.obs.top --once over c's telemetry
        directory: its roles line names the replicas;
 12. scale: the out-of-core tile pipeline and sparse ingestion
     (phase_tiles), each run with the launch counts set to 0 just before
     it and read just after (every kernel 0: the slice runs plain
     products), each streamed run's wall, solve, passes, H2D bytes,
     staging and wait seconds, overlap ratio 1 - wait/solve and stop
     reasons printed, beside the pinned copy rate of one pass's bytes:
     a. the north star in 8 tiles of 625 rows (tile_rows "auto" under a
        budget of two tiles), mu at ks (2, 3), 50 restarts, max_iter
        250, against the in-core run of the same sweep: min ARI >= 0.9,
        max rho gap <= 0.1 (the JAX package's tiled-against-dense
        gate), and the H2D bytes exactly passes x 10,000,000;
     b. make_sparse_design(20000, 5000, k=4, density=0.05, seed=11),
        about 5.0 M stored nonzeros, mu at ks 2..4, 10 restarts, a's
        max_iter (cut from ks 2..5, 20 restarts and 500), 4 tiles of
        5,000 rows, against
        its densified twin in
        core: the same
        gate and the same best k (whether it is the planted 4 printed);
     c. a at ks (2,) and b at ks (4,) with prefetch off, byte-equal to
        the prefetch-on runs;
     d. a's matrix in one tile (tile_rows 5000) at ks (2,), byte-equal
        to the in-core run, no pass streamed;
     e. a's plan at ks (2,), 10 restarts in ledger chunks of 5,
        max_iter 200, killed by proc.preempt at the 50th check of the
        first chunk and resumed from its partial: byte-equal to an
        uninterrupted checkpointed run, one partial resume;
     f. make_sparse_design(2000, 500, k=3, density=0.05) written as
        .csr.npz and .mtx reads back to one fingerprint, and python -m
        nmfx_torch on the bundle (--ks 2-3 --tile-rows 500, max_iter cut
        to 200) writes the files of the in-process run, byte-equal.
 13. the scale engines (phase_scale_engines), each run with the launch
     counts set to 0 just before it and read just after (every kernel
     0: no kernel lies on these routes):
     a. the sketch operators of every rank's 50 restarts drawn on the
        card alone, timed; then mu and hals with backend "sketched"
        (SketchConfig defaults) at the north star, 50 restarts, ks 2..3
        and max_iter 2000 (the depth cut to keep the phase near its
        budget: at ks 2..10 and max_iter 10000 mu took 107 s and hals
        253 s): wall, per-k iterations and stop reasons, the cost
        model's FLOPs beside the exact pallas family's; gates: quality
        "sketched", best k 2, the k = 2 memberships' ARI against phase
        4's exact result of the same algorithm (4a, 4d) >= 0.9 and
        |d rho| <= 0.12 (the JAX package's agreement gate);
     b. the screened north star at ks (2, 5) (mu, screen_keep 10 of
        50; the ranks cut from 2..10 for the same budget): exactly 10
        survivors and 40 SCREENED a rank, best k 2, the first survivor
        at k = 2 and k = 5 against restart_factors (byte-equal if the
        card gives it, else rtol 1e-5 with equal iterations and labels;
        printed which), beside the unscreened batched route's wall;
     c. an NMFXServer(quality_elastic=True) on the bundled 1000x40
        design (k = 2, max_iter 2000): a request under deadline
        pressure (120 s at an estimated 1 iteration/s) served sketched,
        tagged, counted once in nmfx_serve_quality_degraded_total, with
        one serve.quality_degraded flight event; the same request
        without quality_elastic exact with a clamped budget;
     d. Lanczos NNDSVD at k = 2, 5, 10 on the north star against the
        dense SVD's factors (the JAX package's 5e-3 band) and values,
        both timed: float32 at the default ncv (gated at k = 2, within
        the band and rtol 1e-3; past it the noise components lie below
        float32's resolution on the Gram operator) and float64 at ncv
        250 (every k within the band and rtol 1e-6); the card's normal
        draws against the CPU's: words bit-equal, values within 1e-6.

14. the restart mesh and bf16 operands off the kernels (phase_mesh),
    each run with the launch counts set to 0 just before it and read
    just after:
     a. matmul_precision "bfloat16" on routes that reach no kernel (every
        plain product's operands rounded to bf16, float32 sums): the north
        star's whole grid with every other default at ks 2..3, solve() at
        k = 2 from one random start, and kl on the batched restart route
        at k = 2 (10 restarts, max_iter 100), each beside its float32 run
        (4a's grid): best k and the k = 2 labels equal, per-k iterations
        and stop reasons printed, 0 launches;
     b. grid_mesh(2, devices=[cuda:0, cuda:0]), two restart shards on the
        one card: mu's whole grid (row 3) at 4a's full depth, byte-equal
        per rank to 4a; hals' (row 5), byte-equal to 4d, every restart's
        factors too; three shards over 50 restarts at ks 2..3 (one pad
        lane, nmfx_mesh_pad_lanes_total +1), byte-equal to the unmeshed
        grid at ks 2..3 (a pool's lanes are padded to its largest rank,
        so 4a's ranks are another geometry);
        the per-rank pallas route (rows 1-2) at ks 2..3, byte-equal to
        4c's ranks (in --mesh mode to its own unmeshed run); neals on the
        batched restart route (cuBLAS) at ks 2..3 beside its unmeshed
        run, the tier met printed (byte-equal, else the agreement tier
        gated); each shard's launches;
     c. two processes on the one card (nmfx_torch.distributed over a
        gloo group on localhost): distributed.consensus on the bundled
        1000x40 design, ks 2..5, 10 restarts, backend "pallas": both
        print the same summary, byte-equal to the one-process run; only
        the coordinator's directory holds the output files;
     d. elastic_consensus on the bundled design at ks 2..3 over
        [cuda:0, cuda:0] (ledger chunks of 5, proc.preempt armed to kill
        one shard):
        byte-equal to a single-device checkpointed run, every record
        committed, both shard_<i>.json heartbeats present (one dead).

15. the feature and sample mesh axes (phase_grid_mesh; every mesh names
    the one card several times, so its shards share it), each run with
    the launch counts set to 0 just before it and read just after (0
    everywhere: nmfx refuses the kernels on grid axes):
     a. mu (backend "packed") at the north star, ks 2..3, every restart,
        max_iter 600, on the grid meshes 1x2x1, 1x1x2 and 1x2x2 beside
        the unmeshed
        per-rank packed run: best k equal, every rank's consensus within
        nmfx's grid-mesh agreement bound (atol 0.35); max|dC|, membership
        mismatches and iteration differences printed per rank;
     b. kl on 1x2x1 at k = 2 (10 restarts, restart_chunk 5, max_iter 100)
        beside the unmeshed batched kl: memberships equal;
     c. hals, neals and snmf on 1x1x2 over the bundled 1000x40 design at
        ks 2..3 (10 restarts) beside their unmeshed runs, at the Gram
        family's tier: best k and the k = 2 memberships equal, every
        rank's consensus within the agreement bound, iterations within
        max(25 checks, half the unmeshed count);
     d. mu on 1x2x1 in two processes over gloo, one shard of the card
        each (distributed.consensus(feature_shards=2)), on the bundled
        design at ks 2..3 (max_iter 300; the interpreters start with the
        phase and run beside 15a-c): byte-equal to the same mesh in one
        process;
     e. a ServeConfig(mesh_spec="1x2") server answering two north-star
        requests (ks 2..3, 10 restarts, max_iter 300), each byte-equal to
        sweep() on its mesh; a router over ReplicaPool(mesh_specs=(None, "1x2"))
        placing a 20000x1000 two-group request (80 MB, k = 2, 4
        restarts, max_iter 200) on the mesh replica, its comm_model bytes
        an iteration printed, and a bundled-design request on the plain
        replica.

16. the block-shape autotuner (phase_autotune; nmfx_torch.autotune), its
    searches' launches of rows 3, 4 and 5 counted by wrapping the
    candidate timer, each part's launches read as above:
     a. mu at the north star, ks 2..10, 50 restarts, backend "pallas",
        experimental.autotune "on", through an ExecCache whose cache_dir
        (a fresh directory) holds the store: one search; every mu
        candidate (block_m 256 / 512 x check_block 1 / 4 x phased /
        fused) launched once to warm and 3 times timed on its row (3 or
        4), no plain version run; each candidate's ms an iteration and
        the winner printed; best k 2;
     b. hals at ks 2..5 the same way: one search, row 5 launched 4 times
        a candidate (check_block 1, phased: TolFun is armed);
     c. a fresh interpreter, started with the phase, resolves a's config
        at the same directory once a is done: 0 searches, >= 1 hit, 0
        launches, the same resolved config (equal repr);
     d. the tuned mu sweep at ks 2..5 (whole grid, no executable cache)
        byte-equal to the same sweep with the resolved values explicit,
        and best k and memberships equal to the untuned default's; the
        three walls printed.

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


#: the kernels that run block_gemm.cuh's product tiles, each with the
#: position and value of the template argument that makes an
#: instantiation bf16: those must issue HGMMA (wgmma) in their SASS, the
#: float32 ones must not (their fmaf chains stay)
TILE_KERNELS = {"h_numer_split": (2, "unsigned short"),
                "h_numer_gram": (2, "unsigned short"),
                "w_block_update": (1, "true"), "wh_pass": (1, "true"),
                "w_sweep_tile": (1, "true"), "w_numer_store": (1, "true")}


def print_hgmma(build, lib: str) -> None:
    """One line per instantiation of a TILE_KERNELS kernel in the built
    csrc/<lib>.cu library: its HGMMA count in the SASS (cuobjdump -sass),
    beside whether it is a bf16 one. Fails if a bf16 instantiation has
    none or a float32 one has any."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build.library_path(lib))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        hit = re.match(r"\s*Function : (\S+)", line)
        if hit:
            name = hit.group(1)
            counts[name] = 0
        elif name is not None and "HGMMA" in line:
            counts[name] += 1
    names = subprocess.run(["c++filt"], input="\n".join(counts),
                           capture_output=True, text=True, check=True,
                           timeout=60).stdout.splitlines()
    seen = 0
    for pretty, count in sorted(zip(names, counts.values())):
        pretty = pretty.replace("(anonymous namespace)::", "")
        pretty = pretty.removeprefix("void ").split("(")[0]
        base, _, args = pretty.partition("<")
        if base not in TILE_KERNELS:
            continue
        pos, value = TILE_KERNELS[base]
        bf16 = [x.strip() for x in args.rstrip(">").split(",")][pos] == value
        seen += 1
        print(f"sass {lib} {pretty}: {count} HGMMA "
              f"({'bf16' if bf16 else 'float32'} instantiation)", flush=True)
        if bf16 != (count > 0):
            raise AssertionError(f"{lib} {pretty}: {count} HGMMA in a "
                                 f"{'bf16' if bf16 else 'float32'} "
                                 "instantiation")
    if not seen:
        raise AssertionError(f"no product-tile kernel found in {lib}'s SASS")


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


def operands(torch, m, n, r, k, seed, zeros=False, dtype=None):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rk = r * k
    kw = dict(generator=g, device="cuda", dtype=dtype or torch.float32)
    a = torch.rand((m, n), **kw)
    wp = torch.rand((m, rk), **kw)
    hp = torch.rand((rk, n), **kw)
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
                   budgets=None, pad=True, short_k=None, dtype=None):
    """The block kernel's operands as the scheduler builds them: A and Wp
    padded with zero rows to the scheduler's m_pad (``pad``), lane
    freezes and per-lane budgets ({slot: iterations left}; every other
    lane has 10,000). ``short_k`` makes slot 0 a rank-``short_k`` job
    zero-padded to k. ``dtype`` float64 draws A, Wp and Hp as a float64
    solve holds them (the freezes and budgets stay float32)."""
    from nmfx_torch.ops.sched_mu import _pallas_block_geometry

    a, wp, hp = operands(torch, m, n, slots, k, seed, zeros=zeros,
                         dtype=dtype)
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


#: a kernel against the float64 plain version: its max abs error per
#: output at most HALS_FACTOR times the float32 plain version's own
HALS_FACTOR = 4.0


def check_exact(torch, name, got, plain, exact, atol_rel=ATOL_REL):
    """A kernel (``got``) and its float32 plain version (``plain``)
    against the float64 plain version (``exact``) on the same inputs,
    where float32 itself is far from exact: HALS, whose coordinate sweep
    divides cancelling differences by the lanes' Gram diagonals (rtol
    1e-4 fails for the plain version too), and the bf16 variants of the
    block kernels, where a float32 sum that straddles a bf16 rounding
    boundary moves an operand by a whole bf16 ulp and the iterations
    carry it on (the float32 plain version is 1 % off float64 after 8
    iterations). The kernel must be as close to exact as the plain
    version: max|got - exact| <= HALS_FACTOR * max|plain - exact| +
    atol_rel * max|exact| (ATOL_REL, or POOL_ULP for bf16 pool factors),
    and every entry exactly zero in one of got and
    exact but not the other within that bound of zero. Returns (max|got -
    plain|, max|got - exact|, max|plain - exact|, entries whose zero-ness
    differs from exact)."""
    torch.cuda.synchronize()
    exact = exact.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    e_k = (got - exact).abs().max().item()
    e_p = (plain - exact).abs().max().item()
    bound = HALS_FACTOR * e_p + atol_rel * exact.abs().max().item()
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
    check_exact); frozen lanes, padded rows and padded components
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
            res = [check_exact(torch, f"hals_block_iterations[{label}, "
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


#: float64 storage on the kernels: the operands' seeds of the parity and
#: timing pools (drawn in float64, as a float64 solve holds them)
F64_SEEDS = dict(pair=21, block=22, hals=23)


def f64_block_pool(torch, m, n, slots, k, seed, **opts):
    """A block pool drawn in float64 and the float32 values a float64
    solve's scheduler hands the kernels (A cast once a solve, the pools
    at load): ((a, wp, hp) float64, (a, wp, hp) float32, frozen,
    budget)."""
    a64, w64, h64, frz, budget = block_operands(
        torch, m, n, slots, k, seed, dtype=torch.float64, **opts)
    return (a64, w64, h64), (a64.float(), w64.float(), h64.float()), \
        frz, budget


def phase_float64_parity(torch, fm):
    """Float64 storage on the kernels: rows 1, 2, 3, 5 and 3b on a
    float64 pool's float32 values. Rows 1-3 against their plain versions
    on the same float32 values (check_close, the float32 tolerance; row 3
    also frozen lanes and padded rows bit-equal); rows 5 and 3b against
    the float64 plain version on the float64 pool (check_exact: within
    HALS_FACTOR of the float32 plain version's own error). Each line also
    prints how far the kernel is from the float64 plain version on the
    float64 pool: the JAX package reads the float64 operands and rounds
    each product once to float32, the card's kernels read float32
    operands (not gated). Returns the max abs errors against the plain
    versions, by kernel-line name."""
    errs = {}

    def far(got, exact):
        torch.cuda.synchronize()
        return max((g.double() - x.double()).abs().max().item()
                   for g, x in zip(got, exact))

    m, n, r, k = NORTH_STAR
    a64, w64, h64 = operands(torch, m, n, r, k, seed=F64_SEEDS["pair"],
                             dtype=torch.float64)
    a, wp, hp = (x.float() for x in (a64, w64, h64))
    want_h = fm.fused_h_update_ref(a, wp, hp, k=k)
    got_h = fm.fused_h_update(a, wp, hp, k=k)
    eh = check_close(torch, "fused_h_update[float64]", got_h, want_h, False)
    gh = fm.lane_gram_ref(want_h, k=k)
    want_w = fm.fused_w_update_ref(a, wp, want_h, gh, k=k)
    got_w = fm.fused_w_update(a, wp, want_h, gh, k=k)
    ew = check_close(torch, "fused_w_update[float64]", got_w, want_w, False)
    x_h = fm.fused_h_update_ref(a64, w64, h64, k=k)
    x_w = fm.fused_w_update_ref(a64, w64, want_h.double(), gh.double(), k=k)
    far_h, far_w = far([got_h], [x_h]), far([got_w], [x_w])
    print(f"float64 parity per-rank north-star m={m} n={n} R={r} k={k} "
          f"(float32 values of a float64 pool): fused_h_update max abs "
          f"{eh[0]:.3e} rel {eh[1]:.3e}, fused_w_update max abs {ew[0]:.3e} "
          f"rel {ew[1]:.3e} (rtol={RTOL}, atol={ATOL_REL}*max|ref|); from "
          f"the float64 plain version on the float64 pool {far_h:.3e} / "
          f"{far_w:.3e} (not gated)", flush=True)
    errs["fused_h_update[float64]"] = eh[0]
    errs["fused_w_update[float64]"] = ew[0]

    kw = dict(iters=CHECK_EVERY, check_block=CHECK_BLOCK)
    label, bm, bn, slots, bk, opts = BLOCK_CASES[0]
    p64, (a, wp, hp), frz, budget = f64_block_pool(
        torch, bm, bn, slots, bk, F64_SEEDS["block"], **opts)
    want = fm.fused_block_iterations_ref(a, wp, hp, frz, k=bk,
                                         budget_cols=budget, **kw)
    got = fm.fused_block_iterations(a, wp, hp, frz, k=bk,
                                    budget_cols=budget, **kw)
    e3 = [check_close(torch, f"fused_block_iterations[float64].{o}", g, w,
                      zeros=True)[0]
          for o, g, w in zip(BLOCK_OUTPUTS, got, want)]
    check_padding(torch, "fused_block_iterations[float64]", got, wp, hp,
                  frz, bm, bk, None)
    x3 = fm.fused_block_iterations_ref(*p64, frz.double(), k=bk,
                                       budget_cols=budget.double(), **kw)
    print(f"float64 parity fused_block_iterations {label} m={a.shape[0]} "
          f"n={bn} slots={slots} k={bk}: max abs "
          + ", ".join(f"{o} {e:.3e}" for o, e in zip(BLOCK_OUTPUTS, e3))
          + f" (rtol={RTOL}, atol={ATOL_REL}*max|ref|); frozen lanes and "
          f"padded rows bit-equal; from the float64 plain version "
          f"{far(got[:2], x3[:2]):.3e} (not gated)", flush=True)
    errs["fused_block_iterations[float64]"] = max(e3)

    ab = p64[0].to(torch.bfloat16)  # the route casts A once, from float64
    got = fm.fused_block_iterations(ab, wp, hp, frz, k=bk, budget_cols=budget,
                                    matmul_precision=BF16, **kw)
    plain = fm.fused_block_iterations_ref(a, wp, hp, frz, k=bk,
                                          budget_cols=budget,
                                          matmul_precision=BF16, **kw)
    exact = fm.fused_block_iterations_ref(*p64, frz.double(), k=bk,
                                          budget_cols=budget.double(),
                                          matmul_precision=BF16, **kw)
    res = [check_exact(torch, f"fused_block_iterations[bf16,float64].{o}",
                       g, pl, x)
           for o, g, pl, x in zip(BLOCK_OUTPUTS, got, plain, exact)]
    print(f"float64 parity fused_block_iterations[bf16] {label}: max abs "
          "against the float32 plain version / kernel against float64 / "
          "float32 plain against float64: "
          + ", ".join(f"{o} {q[0]:.3e} / {q[1]:.3e} / {q[2]:.3e}"
                      for o, q in zip(BLOCK_OUTPUTS, res))
          + f" (bound {HALS_FACTOR} x the plain version's error + "
          f"{ATOL_REL}*max|ref|)", flush=True)
    errs["fused_block_iterations[bf16,float64]"] = max(q[0] for q in res)

    p64, (a, wp, hp), frz, budget = f64_block_pool(
        torch, bm, bn, slots, bk, F64_SEEDS["hals"], **opts)
    hkw = dict(k=bk, slots=slots, iters=CHECK_EVERY)
    got = fm.hals_block_iterations(a, wp, hp, frz, **hkw)
    plain = fm.hals_block_iterations_ref(a, wp, hp, frz, **hkw)
    exact = fm.hals_block_iterations_ref(*p64, frz.double(), **hkw)
    res = [check_exact(torch, f"hals_block_iterations[float64].{o}", g, pl,
                       x)
           for o, g, pl, x in zip(BLOCK_OUTPUTS, got, plain, exact)]
    check_padding(torch, "hals_block_iterations[float64]", got, wp, hp, frz,
                  bm, bk, None)
    print(f"float64 parity hals_block_iterations {label} check_block=1: max "
          "abs against the float32 plain version / kernel against float64 "
          "/ float32 plain against float64: "
          + ", ".join(f"{o} {q[0]:.3e} / {q[1]:.3e} / {q[2]:.3e}"
                      for o, q in zip(BLOCK_OUTPUTS, res))
          + f" (bound {HALS_FACTOR} x the plain version's error + "
          f"{ATOL_REL}*max|ref|); frozen lanes and padded rows bit-equal",
          flush=True)
    errs["hals_block_iterations[float64]"] = max(q[0] for q in res)
    return errs


def phase_float64_timing(torch, fm, rates):
    """The float64 entries' kernels at the north-star shapes on a float64
    pool's float32 values (kernel, plain version, library composite and
    bound as for float32: the kernels read the same float32 bytes), and
    the casts a float64 solve adds: A to float32 once a solve, and the
    per-rank route's widening of W, W_prev, H and H_prev at each TolX
    check. Returns {name: (ms, plain, library, bound, by)}."""
    table = {}

    def row(name, label, kernel, plain, lib, bound):
        ms, pl, lb = (time_ms(torch, f) for f in (kernel, plain, lib))
        table[name] = (ms, pl, lb, *bound)
        print(f"timing {name} {label}: kernel {ms:.4f} ms, plain {pl:.4f} "
              f"ms, library {lb:.4f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]})", flush=True)

    m, n, r, k = NORTH_STAR
    a64, w64, h64 = operands(torch, m, n, r, k, seed=F64_SEEDS["pair"],
                             dtype=torch.float64)
    a, wp, hp = (x.float() for x in (a64, w64, h64))
    gh = fm.lane_gram_ref(hp, k=k)
    bnd = bounds(m, n, r * k, k, rates)
    label = f"m={m} n={n} R={r} k={k}"
    row("fused_h_update[float64]", label,
        lambda: fm.fused_h_update(a, wp, hp, k=k),
        lambda: fm.fused_h_update_ref(a, wp, hp, k=k),
        lambda: library_h(torch, a, wp, hp, k), bnd["fused_h_update"])
    row("fused_w_update[float64]", label,
        lambda: fm.fused_w_update(a, wp, hp, gh, k=k),
        lambda: fm.fused_w_update_ref(a, wp, hp, gh, k=k),
        lambda: library_w(torch, a, wp, hp, gh, k), bnd["fused_w_update"])
    cast_a = time_ms(torch, lambda: a64.float())
    widen = time_ms(torch, lambda: [x.double() for x in (wp, wp, hp, hp)])
    print(f"timing float64 casts {label}: A to float32 {cast_a:.4f} ms once "
          f"a solve; W, W_prev, H, H_prev widened to float64 {widen:.4f} ms "
          "once a TolX check (every check_every iterations on the "
          "per-rank route)", flush=True)

    p64, (a, wp, hp), frz, budget = f64_block_pool(
        torch, m, n, SLOTS, k, F64_SEEDS["block"])
    mp, rk = a.shape[0], SLOTS * k
    kw = dict(k=k, iters=CHECK_EVERY, check_block=CHECK_BLOCK,
              budget_cols=budget)
    label = f"m={mp} n={n} slots={SLOTS} k={k}"
    ops8 = block_ops(mp, n, rk, rk * k, CHECK_EVERY, CHECK_BLOCK)
    row("fused_block_iterations[float64]", label + " (8 iterations)",
        lambda: fm.fused_block_iterations(a, wp, hp, frz, **kw),
        lambda: fm.fused_block_iterations_ref(a, wp, hp, frz, **kw),
        lambda: library_block(torch, a, wp, hp, k, CHECK_EVERY,
                              CHECK_BLOCK),
        bound_of(block_bytes(mp, n, rk, CHECK_BLOCK), ops8, rates))
    ab = p64[0].to(torch.bfloat16)
    ar, wr, hr = (fm.round_bf16(x) for x in (a, wp, hp))
    row("fused_block_iterations[bf16,float64]", label + " (8 iterations)",
        lambda: fm.fused_block_iterations(ab, wp, hp, frz,
                                          matmul_precision=BF16, **kw),
        lambda: fm.fused_block_iterations_ref(a, wp, hp, frz,
                                              matmul_precision=BF16, **kw),
        lambda: library_block(torch, ar, wr, hr, k, CHECK_EVERY,
                              CHECK_BLOCK),
        bound_of(block_bytes(mp, n, rk, CHECK_BLOCK, a_bytes=2), ops8,
                 bf16_rates(rates)))
    cast_a = time_ms(torch, lambda: p64[0].float())
    print(f"timing float64 casts {label}: A to float32 {cast_a:.4f} ms once "
          "a solve (the scheduler's TolX stats are the kernel's float32 "
          "per-column maxima, widened per lane: no factor is cast a trip)",
          flush=True)
    p64, (a, wp, hp), frz, budget = f64_block_pool(
        torch, m, n, SLOTS, k, F64_SEEDS["hals"])
    hkw = dict(k=k, slots=SLOTS, iters=CHECK_EVERY)
    row("hals_block_iterations[float64]", label + " (2 iterations)",
        lambda: fm.hals_block_iterations(a, wp, hp, frz, **hkw),
        lambda: fm.hals_block_iterations_ref(a, wp, hp, frz, **hkw),
        lambda: library_hals(torch, a, wp, hp, k, CHECK_EVERY, 1),
        hals_bound(mp, n, rk, k, CHECK_EVERY, 1, rates))
    return table


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


def block_bytes(m, n, rk, nck, a_bytes=4, w_bytes=4, h_bytes=4):
    """Bytes of one block launch: A, Wp, Hp, frozen and budget read once;
    Wp, Hp, the 4 stat arrays and h_checks written once (h_checks counted
    at every check_block, as since PR 2)."""
    return (a_bytes * m * n + 2 * w_bytes * m * rk + 2 * h_bytes * rk * n
            + 4 * (2 * rk + 4 * nck * rk + nck * rk * n))


def block_ops(m, n, rk, kk, iters, nck):
    """Operations of iters * nck MU iterations with no lane frozen: the
    two numerators, the diagonal-block Grams, the denominators and the
    epilogues; kk = the sum over columns of their segment's width (rk * k
    for the uniform pool)."""
    per_it = (2 * m * n * rk + 2 * m * kk + 2 * n * kk + 5 * rk * n
              + 2 * n * kk + 2 * m * n * rk + 2 * m * kk + 5 * m * rk)
    return iters * nck * per_it


def bound_of(nbytes, ops, rates):
    """(ms, "bytes" or "operations"): the larger of the two least times."""
    flops, bw = rates
    tb, to = nbytes / bw * 1e3, ops / flops * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations"


def block_bound(m, n, rk, k, iters, nck, rates):
    """The least time of fused_block_iterations with no lane frozen
    (every lane does all iters * nck iterations)."""
    return bound_of(block_bytes(m, n, rk, nck),
                    block_ops(m, n, rk, rk * k, iters, nck), rates)


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


def hals_ops(m, n, rk, k, iters, nck):
    """Operations of iters * nck HALS iterations: the two numerators, the
    diagonal-block Grams and the two k-step sweeps (2k + 4 operations a
    factor entry)."""
    per_it = (2 * m * n * rk + 2 * m * rk * k + rk * n * (2 * k + 4)
              + 2 * rk * n * k + 2 * m * n * rk + m * rk * (2 * k + 4))
    return iters * nck * per_it


def hals_bound(m, n, rk, k, iters, nck, rates):
    """The least time of hals_block_iterations, as block_bound counts it."""
    return bound_of(block_bytes(m, n, rk, nck),
                    hals_ops(m, n, rk, k, iters, nck), rates)


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


def check_finite(res, label, n):
    """Finite consensus and residuals of the right shape at every rank
    (a screened-out restart's residual is +inf by design: only the
    others are read)."""
    for k in res.ks:
        kr = res.per_k[k]
        solved = kr.stop_reasons != 6  # StopReason.SCREENED
        if not (np.isfinite(kr.consensus).all()
                and np.isfinite(kr.dnorms[solved]).all()):
            raise AssertionError(f"{label} k={k}: non-finite output")
        if kr.consensus.shape != (n, n):
            raise AssertionError(f"{label} k={k}: consensus shape "
                                 f"{kr.consensus.shape}")


def check_sweep(res, label, n):
    """check_finite, and best k = 2 (the matrix has two groups)."""
    check_finite(res, label, n)
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
    return launches, res, wall


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


#: 4c's ranks: the per-rank route through the kernel pair at ks 2..5 (cut
#: from 2..10, whose ranks 6..10 took 26.7 s of its 37.9 s on one H100, to
#: pay for phase 15); its dependants read ranks 2..3
PER_RANK_KS = KS[:4]


def phase_per_rank_path(torch, fm, grid):
    """nmfconsensus at the north-star width, one rank at a time, through
    the per-iteration kernel pair (ranks ``PER_RANK_KS``); each rank's
    iterations beside those of the whole grid's run ``grid`` (recorded,
    not a gate)."""
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
        a, ks=PER_RANK_KS, restarts=r, solver_cfg=nmfx_torch.SolverConfig(
            backend="pallas"), grid_exec="per_k", on_rank=on_rank)
    launches = dict(fm.LAUNCHES)
    need = 0
    same = []
    for k in PER_RANK_KS:
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
          f"{same} of {list(PER_RANK_KS)}", flush=True)
    check_sweep(res, "per-rank route", n)
    for name in ("fused_h_update", "lane_gram", "fused_w_update"):
        if launches[name] < need:
            raise AssertionError(
                f"{name} launched {launches[name]} times on the per-rank "
                f"route; the ranks' longest lanes need {need}")
    wall = sum(w for w, _ in ranks.values())
    print(f"main per-rank launches {launches} (sum over ranks of the "
          f"longest lane: {need}); sweep wall {wall:.3f} s", flush=True)
    print(res.summary(), flush=True)
    return launches, res, wall


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


#: phase 7: the other six solvers on their default route (backend "auto",
#: the batched restart route), pg and alspg at the JAX package's own
#: budgets at this shape (benchmarks/run.py:69-73)
OTHER_SOLVERS = {"kl": {}, "neals": {}, "als": {}, "snmf": {},
                 "pg": dict(max_iter=100),
                 "alspg": dict(max_iter=20, sub_max_iter=100)}
#: ... and on the packed whole grid (backend "packed")
PACKED_SOLVERS = ("kl", "neals")
#: the slowest four at k = 2 only, their depth cut to keep the script
#: inside its time limit (kl batched ran 111-116 s and pg 72-89 s at ks
#: 2..10 on one H100; at ks 2..6 kl 43 s, pg 57 s; at ks 2..10 als 36 s,
#: alspg 21 s; at ks 2..4 pg 43.6 s). The cut from ks 2..4 (pg 2..3)
#: frees the seconds of phase 13: at ks 2..4 (pg 2..3) one H100 spent
#: 17.1, 10.6, 13.7 and 28.1 s on kl, als, alspg and pg batched and 6.9 s
#: on kl packed
SOLVER_KS = {alg: KS[:1] for alg in ("kl", "als", "pg", "alspg")}
#: pg's north-star run at a quarter of its budget (max_iter 25 of 100:
#: 16.4 s at 100 and 10.2 s at 50 on one H100, the largest line of the
#: phase), cut to pay for phase 16; its bundled-design gate keeps the JAX
#: package's budget
NORTH_STAR_BUDGETS = {"pg": dict(max_iter=25)}
#: each solver's best k on the bundled 1000x40 design (ks 2..5, 10
#: restarts, seed 123) at those budgets, as the JAX package gives it
#: (nmfconsensus on its CPU backend): neals and als stop on TolFun after
#: ~60 iterations with a k = 2 rho of 0.871, and pg's 100 iterations give
#: 0.74-0.76, so neither family recovers the two groups there
BUNDLED_BEST_K = {"kl": 2, "neals": 4, "als": 4, "snmf": 2, "pg": 3,
                  "alspg": 2}
#: the bundled design's ranks a solver's gate runs at: ks 2..5, but kl and
#: alspg at ks 2..3 to pay for phase 14 (their bundled gates took 27.5 and
#: 32.8 s, card and CPU, at ks 2..5 on one H100 in PR 18's run MM); the
#: JAX package's best k over 2..5 is 2 for both, so over 2..3 too
SOLVER_BUNDLED_KS = {"kl": (2, 3), "alspg": (2, 3)}


def solver_sweep(torch, fm, a, scfg, label, ks=KS):
    """One nmfconsensus at the north star's restarts and ``ks`` under a
    Profiler, with every kernel's launch count set to 0 just before it:
    its line and per-k lines. No kernel may launch (none lies on these
    routes)."""
    import nmfx_torch
    from nmfx_torch.profiling import Profiler

    _, n, r, _ = NORTH_STAR
    prof = Profiler()
    outs = {}
    fm.reset_launch_counts()
    t0 = time.perf_counter()
    with prof:
        res = nmfx_torch.nmfconsensus(
            a, ks=ks, restarts=r, solver_cfg=scfg, profiler=prof,
            on_rank=lambda k, out: outs.setdefault(k, out))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fm.LAUNCHES)
    check_finite(res, label, n)
    grid = bool(outs[ks[0]].pool_trips)
    syncs = (outs[ks[0]].host_syncs if grid
             else sum(out.host_syncs for out in outs.values()))
    solve = sum(rec.seconds for name, rec in prof.phases.items()
                if name.startswith("solve."))
    after = ", ".join(f"{rec.name} {rec.seconds:.4f} s"
                      for rec in prof.phases.values()
                      if not rec.name.startswith("solve."))
    mean_iters = {k: round(float(res.per_k[k].iterations.mean()), 1)
                  for k in ks}
    pool = (f", pool_widths {outs[ks[0]].pool_widths}, pool_trips "
            f"{outs[ks[0]].pool_trips}, pool_lanes {outs[ks[0]].pool_lanes}"
            if grid else "")
    print(f"solvers {label}: wall {wall:.3f} s (solve {solve:.3f} s, after "
          f"it {wall - solve:.3f} s [{after}]; audit {prof.audit(wall)}), "
          f"host syncs {syncs}{pool}, launches {launches}, best k "
          f"{res.best_k}, mean iters per k {mean_iters}", flush=True)
    for k in ks:
        kr = res.per_k[k]
        rank = prof.phases.get(f"solve.k={k}")
        print(f"solvers {label} k={k}: mean iters "
              f"{kr.iterations.mean():.1f}, max iters "
              f"{int(kr.iterations.max())}, stop reasons {stop_counts(kr)}, "
              + (f"solve {rank.seconds:.3f} s, host syncs "
                 f"{outs[k].host_syncs}, " if rank else "")
              + f"rho {kr.rho:.4f}", flush=True)
    if any(launches.values()):
        raise AssertionError(f"solvers {label}: a kernel launched on a "
                             f"route without kernels: {launches}")
    return res


def phase_solvers(torch, fm):
    """Phase 7: the other six solvers at the north star on their default
    route, kl and neals on the packed whole grid beside it, then the
    gates on the bundled design, a small input and als' padded pool."""
    import nmfx_torch
    from nmfx_torch.datasets import two_group_matrix

    _, n, r, _ = NORTH_STAR
    a = north_star_matrix()
    batched = {}
    for alg, kw in OTHER_SOLVERS.items():
        batched[alg] = solver_sweep(
            torch, fm, a, nmfx_torch.SolverConfig(
                algorithm=alg, **NORTH_STAR_BUDGETS.get(alg, kw)),
            f"{alg} batched", SOLVER_KS.get(alg, KS))
    for alg in PACKED_SOLVERS:
        packed = solver_sweep(
            torch, fm, a, nmfx_torch.SolverConfig(algorithm=alg,
                                                  backend="packed"),
            f"{alg} packed grid", SOLVER_KS.get(alg, KS))
        print(f"solvers {alg} packed grid vs batched, per k (mean iters "
              "packed / batched, max|dC|): " + ", ".join(
                  f"k={k} ({packed.per_k[k].iterations.mean():.1f} / "
                  f"{batched[alg].per_k[k].iterations.mean():.1f}, "
                  f"{np.abs(packed.per_k[k].consensus - batched[alg].per_k[k].consensus).max():.4g})"
                  for k in packed.ks), flush=True)

    bundled = two_group_matrix(n_genes=1000, n_per_group=20, seed=123)
    small = two_group_matrix(n_genes=200, n_per_group=12, seed=3)
    for alg, kw in OTHER_SOLVERS.items():
        scfg = nmfx_torch.SolverConfig(algorithm=alg, **kw)
        t0 = time.perf_counter()
        bks = SOLVER_BUNDLED_KS.get(alg, (2, 3, 4, 5))
        card = nmfx_torch.nmfconsensus(bundled, ks=bks, restarts=10,
                                       seed=123, solver_cfg=scfg)
        card_s = time.perf_counter() - t0
        cpu = nmfx_torch.nmfconsensus(bundled, ks=bks, restarts=10,
                                      seed=123, solver_cfg=scfg, device="cpu")
        cpu_s = time.perf_counter() - t0 - card_s
        print(f"solvers bundled 1000x40 {alg} (ks {bks}): card "
              f"{card_s:.3f} s, CPU "
              f"{cpu_s:.3f} s, best k "
              f"{card.best_k} (CPU {cpu.best_k}, the JAX package "
              f"{BUNDLED_BEST_K[alg]}), rho {card.rhos.tolist()} (CPU "
              f"{cpu.rhos.tolist()})", flush=True)
        if not card.best_k == cpu.best_k == BUNDLED_BEST_K[alg]:
            raise AssertionError(f"bundled design {alg}: best k {card.best_k}"
                                 f" on the card, {cpu.best_k} on the CPU, "
                                 f"{BUNDLED_BEST_K[alg]} expected")

        kw_small = dict(ks=(2, 3, 4), restarts=6, seed=5, solver_cfg=scfg)
        gpu = nmfx_torch.nmfconsensus(small, **kw_small)
        cpu = nmfx_torch.nmfconsensus(small, device="cpu", **kw_small)
        for k in (2, 3, 4):
            g, c = gpu.per_k[k], cpu.per_k[k]
            print(f"solvers small 200x24 {alg} k={k}: card vs CPU iterations "
                  f"equal {np.array_equal(g.iterations, c.iterations)}, stop "
                  f"reasons equal "
                  f"{np.array_equal(g.stop_reasons, c.stop_reasons)}, max "
                  f"|dC| {np.abs(g.consensus - c.consensus).max():.3g}, "
                  f"memberships equal "
                  f"{np.array_equal(g.membership, c.membership)}", flush=True)
        if not (gpu.best_k == cpu.best_k and np.array_equal(
                gpu.per_k[2].membership, cpu.per_k[2].membership)):
            raise AssertionError(f"small input {alg}: card and CPU disagree "
                                 f"(best k {gpu.best_k} / {cpu.best_k})")

    res = nmfx_torch.nmfconsensus(
        small, ks=(2, 5), restarts=6, seed=5, keep_factors=True,
        solver_cfg=nmfx_torch.SolverConfig(algorithm="als",
                                           backend="packed"))
    finite = all(np.isfinite(res.per_k[k].all_w).all()
                 and np.isfinite(res.per_k[k].all_h).all()
                 and np.isfinite(res.per_k[k].consensus).all()
                 for k in (2, 5))
    print(f"solvers als packed grid ks (2, 5), zero-padded k=2 lanes: "
          f"finite {finite}, best k {res.best_k}", flush=True)
    if not finite:
        raise AssertionError("als on the packed grid: non-finite output")


# --- the kernels' options (bf16 operands, bf16 pool factors, segment
# ids, alias_io, block_m) ----------------------------------------------

BF16 = "bfloat16"
#: one call of a bf16-operand pair kernel (rows 1-2) against its plain
#: version: both round the same float32 values to bf16, except where
#: the two float32 sums feeding an operand (a Gram entry) straddle a bf16
#: rounding boundary; such an operand moves by one bf16 ulp (2^-8) and an
#: output by a small fraction of it: elementwise rtol 2e-3 (half an ulp)
#: + ATOL_REL. The block kernels' bf16 variants iterate, which carries
#: such moves on: they are held to float64 (check_exact)
BF16_RTOL = 2e-3
#: bf16 pool factors: where float32 and float64 round a stored factor the
#: same way, a kernel's float32 update that straddles the boundary stores
#: the neighbouring bf16 value, one ulp (at most 2^-7 of it) away, so
#: check_exact allows one ulp at the output's largest magnitude
POOL_ULP = 2.0 ** -7
#: the bf16 bound's peak: dense bf16 tensor-core FLOP/s of an H100 SXM
#: (NVIDIA's data sheet, without sparsity); the bf16 variants' numerator
#: products run on the tensor cores (wgmma), their Grams, denominators
#: and epilogues on the CUDA cores in float32
BF16_PEAK = 989e12


def check_band(torch, name, got, want, rtol):
    """check_close with another rtol (bf16 operands or pool factors)."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    tol = rtol * want.abs() + ATOL_REL * want.abs().max()
    if (err > tol).any():
        raise AssertionError(
            f"{name}: max abs err {err.max().item():.3e} exceeds rtol={rtol} "
            f"atol={ATOL_REL}*max|ref|")
    return err.max().item(), (err / want.abs().clamp(min=1e-30)).max().item()


def byte_equal(torch, xs, ys) -> bool:
    torch.cuda.synchronize()
    return len(xs) == len(ys) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.view(torch.int16 if x.element_size() == 2
                               else torch.int32),
                        y.view(torch.int16 if y.element_size() == 2
                               else torch.int32))
        for x, y in zip(xs, ys))


def ragged_pool(torch, m, n, job_ks, budget, seed):
    """A ragged class-blocked pool as the scheduler lays it out: the
    segment ids of _ragged_layout's classes over ``job_ks`` within
    ``budget`` columns, and block_operands-style inputs at that width."""
    from nmfx_torch.ops.sched_mu import _pallas_block_geometry, _ragged_layout

    layout = _ragged_layout(job_ks, budget, max_iter=10000)
    widths = np.concatenate([np.full(c.slots, c.k) for c in layout])
    seg = np.repeat(np.arange(widths.size, dtype=np.int32), widths)
    rk = int(widths.sum())
    a, wp, hp = operands(torch, m, n, rk, 1, seed)
    m_pad = _pallas_block_geometry(m)[2]
    a = torch.nn.functional.pad(a, (0, 0, 0, m_pad - m))
    wp = torch.nn.functional.pad(wp, (0, 0, 0, m_pad - m))
    frz = torch.zeros((1, rk), device="cuda")
    frz[0, torch.as_tensor(seg == 3, device="cuda")] = 1.0
    return a, wp, hp, frz, seg, int(widths.max())


#: ragged pools: the north star's class-major columns for ks 2..10 (50
#: restarts each) in the uniform pool's 480 columns, and a mixed layout
#: at the ragged 1237 x 77 shape
RAGGED_CASES = (
    ("north-star", 5000, 500, tuple(k for k in KS[::-1] for _ in range(50)),
     SLOTS * 10),
    ("ragged", 1237, 77, (7,) * 3 + (5,) * 4 + (3,) * 6 + (2,) * 5, 60),
)


def phase_option_parity(torch, fm):
    """Every kernel under each option it takes, against its plain version
    on the same inputs: bf16 operands in rows 1-5 (the per-iteration pair
    also byte-equal to one bf16 block iteration), bf16 pool factors in
    rows 3-5, segment ids in rows 3-4 (the north star's class-major pool
    and a mixed one at 1237 x 77; iota // k byte-equal to the k-only
    launch; the join-the-updates order byte-equal to the phased one),
    alias_io in rows 3-5 and block_m None / 128 / 256 byte-equal to the
    default launch. Returns the north-star max abs errors of the variants
    the main paths run."""
    errs = {}

    def exact_line(res):
        return ", ".join(f"{o} {r[0]:.3e} / {r[1]:.3e} / {r[2]:.3e}"
                         for o, r in zip(BLOCK_OUTPUTS, res))

    def against_exact(name, got, fn, a, wp, hp, frz, budget=None, **kw):
        """check_exact of every output: fn (a plain version) in float32
        and in float64, the pool's bf16 storage kept."""
        pool = {torch.bfloat16: "bfloat16_w"}.get(wp.dtype)
        if hp.dtype == torch.bfloat16:
            pool = "bfloat16"
        plain = fn(a, wp, hp, frz, budget_cols=budget, **kw)
        exact = fn(a.double(), wp.double(), hp.double(), frz.double(),
                   budget_cols=None if budget is None else budget.double(),
                   factor_dtype=pool, **kw)
        tol = ATOL_REL if pool is None else POOL_ULP
        return [check_exact(torch, f"{name}.{o}", g.float(), p.float(),
                            x.double(), tol)
                for o, g, p, x in zip(BLOCK_OUTPUTS, got, plain, exact)]

    for label, m, n, r, k in (("per-rank north-star", 5040, 500, 50, 10),
                              ("ragged", 1237, 77, 13, 3)):
        a, wp, hp = operands(torch, m, n, r, k, seed=11)
        ab = a.to(torch.bfloat16)
        want_h = fm.fused_h_update_ref(a, wp, hp, k=k, matmul_precision=BF16)
        eh = check_band(torch, f"fused_h_update[bf16, {label}]",
                        fm.fused_h_update(ab, wp, hp, k=k,
                                          matmul_precision=BF16),
                        want_h, BF16_RTOL)
        gh = fm.lane_gram_ref(want_h, k=k, matmul_precision=BF16)
        eg = check_band(torch, f"lane_gram[bf16, {label}]",
                        fm.lane_gram(want_h, k=k, matmul_precision=BF16), gh,
                        BF16_RTOL)
        want_w = fm.fused_w_update_ref(a, wp, want_h, gh, k=k,
                                       matmul_precision=BF16)
        ew = check_band(torch, f"fused_w_update[bf16, {label}]",
                        fm.fused_w_update(ab, wp, want_h, gh, k=k,
                                          matmul_precision=BF16),
                        want_w, BF16_RTOL)
        print(f"options parity bf16 operands {label} m={m} n={n} R={r} "
              f"k={k}: fused_h_update max abs {eh[0]:.3e} rel {eh[1]:.3e}; "
              f"lane_gram {eg[0]:.3e} rel {eg[1]:.3e}; fused_w_update "
              f"{ew[0]:.3e} rel {ew[1]:.3e} (rtol={BF16_RTOL}, "
              f"atol={ATOL_REL}*max|ref|)", flush=True)
        if label.endswith("north-star"):
            errs["fused_h_update[bf16]"] = eh[0]
            errs["fused_w_update[bf16]"] = ew[0]
    for label, m, n, slots, k, opts in MU_BLOCK_CASES + PAIR_CASES:
        a, wp, hp, frz, _ = block_operands(
            torch, m, n, slots, k, seed=6,
            **{key: opts[key] for key in ("zeros", "pad", "short_k")
               if key in opts})
        ab = a.to(torch.bfloat16)
        h = fm.fused_h_update(ab, wp, hp, k=k, matmul_precision=BF16)
        w = fm.fused_w_update(ab, wp, h, fm.lane_gram(
            h, k=k, matmul_precision=BF16), k=k, matmul_precision=BF16)
        want = fm.fused_block_iterations(ab, wp, hp, frz, k=k, iters=1,
                                         matmul_precision=BF16)
        if not byte_equal(torch, (w, h), want[:2]):
            raise AssertionError(f"bf16 pair [{label}]: Hp or Wp differs "
                                 "from one bf16 block iteration's")
        print(f"options parity bf16 pair == block iteration [{label} "
              f"m={a.shape[0]} n={n} R={slots} k={k}]: byte-equal",
              flush=True)

    kw = dict(iters=CHECK_EVERY, check_block=CHECK_BLOCK)
    for label, m, n, slots, k, opts in MU_BLOCK_CASES:
        a, wp, hp, frz, budget = block_operands(torch, m, n, slots, k,
                                                seed=3, **opts)
        ab = a.to(torch.bfloat16)
        got = fm.fused_block_iterations(ab, wp, hp, frz, k=k,
                                        budget_cols=budget,
                                        matmul_precision=BF16, **kw)
        res = against_exact(f"fused_block_iterations[bf16, {label}]", got,
                            fm.fused_block_iterations_ref, a, wp, hp, frz,
                            budget, k=k, matmul_precision=BF16, **kw)
        check_padding(torch, f"fused_block_iterations[bf16, {label}]", got,
                      wp, hp, frz, m, k, opts.get("short_k"))
        fused = fm.fused_block_iterations(ab, wp, hp, frz, k=k, fused=True,
                                          budget_cols=budget,
                                          matmul_precision=BF16, **kw)
        if not byte_equal(torch, fused, got):
            raise AssertionError(f"bf16 fused[{label}]: not byte-equal to "
                                 "the phased kernel")
        print(f"options parity fused_block_iterations bf16 operands {label} "
              f"m={a.shape[0]} n={n} slots={slots} k={k}: max abs against "
              "the float32 plain version / kernel against float64 / plain "
              f"against float64: {exact_line(res)}; fused=True byte-equal "
              "to phased; frozen lanes and padded rows bit-equal",
              flush=True)
        if label == "north-star":
            errs["fused_block_iterations[bf16]"] = max(x[0] for x in res)
        # bf16 pool factors, one launch of 2 iterations
        for pool in ("bfloat16_w", "bfloat16"):
            wq = wp.to(torch.bfloat16)
            hq = hp.to(torch.bfloat16) if pool == "bfloat16" else hp
            pk = dict(k=k, iters=CHECK_EVERY)
            got = fm.fused_block_iterations(a, wq, hq, frz, **pk)
            if got[0].dtype != torch.bfloat16 or got[1].dtype != hq.dtype:
                raise AssertionError(f"{pool}: outputs not in the pool's "
                                     "dtypes")
            res = against_exact(f"fused_block_iterations[{pool}, {label}]",
                                got, fm.fused_block_iterations_ref, a, wq,
                                hq, frz, **pk)
            fused = fm.fused_block_iterations(a, wq, hq, frz, fused=True,
                                              **pk)
            if not byte_equal(torch, fused, got):
                raise AssertionError(f"{pool} fused[{label}]: not "
                                     "byte-equal to the phased kernel")
            print(f"options parity fused_block_iterations {pool} {label}: "
                  "max abs against the float32 plain version / kernel "
                  f"against float64 / plain against float64: "
                  f"{exact_line(res)}; fused=True byte-equal to phased",
                  flush=True)
            if label == "north-star" and pool == "bfloat16_w":
                errs["fused_block_iterations[bfloat16_w]"] = max(
                    x[0] for x in res)
        # alias_io: byte-equal to the unaliased launch, in place; block
        # kernels of an odd iteration count copy the input first
        for total in ((CHECK_EVERY, CHECK_BLOCK), (3, 1)):
            ak = dict(k=k, iters=total[0], check_block=total[1],
                      budget_cols=budget if total[1] > 1 else None)
            plain = fm.fused_block_iterations(a, wp, hp, frz, **ak)
            for fused in (False, True):
                w2, h2 = wp.clone(), hp.clone()
                got = fm.fused_block_iterations(a, w2, h2, frz, fused=fused,
                                                alias_io=True, **ak)
                if not (got[0] is w2 and got[1] is h2
                        and byte_equal(torch, got, plain)):
                    raise AssertionError(f"alias_io[{label}, fused={fused},"
                                         f" {total}]: not byte-equal in "
                                         "place")
        print(f"options parity fused_block_iterations alias_io {label}: "
              "both orders, 8 and 3 iterations, in place and byte-equal to "
              "the unaliased launch", flush=True)
        # iota // k segment ids: the k-only launch's chains
        seg = np.arange(slots * k) // k
        plain = fm.fused_block_iterations(a, wp, hp, frz, k=k,
                                          budget_cols=budget, **kw)
        for fused in (False, True):
            got = fm.fused_block_iterations(a, wp, hp, frz, k=k,
                                            budget_cols=budget, seg_ids=seg,
                                            fused=fused, **kw)
            if not byte_equal(torch, got, plain):
                raise AssertionError(f"seg_ids iota//k [{label}, fused="
                                     f"{fused}]: not byte-equal to k-only")
        print(f"options parity fused_block_iterations seg_ids iota//k "
              f"{label}: both orders byte-equal to the k-only launch",
              flush=True)

    for label, m, n, job_ks, budget_cols in RAGGED_CASES:
        a, wp, hp, frz, seg, kmax = ragged_pool(torch, m, n, job_ks,
                                                budget_cols, seed=7)
        for mp in ("default", BF16):
            sk = dict(k=kmax, iters=CHECK_EVERY, seg_ids=seg,
                      matmul_precision=mp)
            got = fm.fused_block_iterations(a, wp, hp, frz, **sk)
            if mp == BF16:
                res = against_exact(f"fused_block_iterations[seg_ids, bf16,"
                                    f" {label}]", got,
                                    fm.fused_block_iterations_ref, a, wp, hp,
                                    frz, **sk)
                e = [x[0] for x in res]
            else:
                want = fm.fused_block_iterations_ref(a, wp, hp, frz, **sk)
                e = [check_close(torch, f"fused_block_iterations[seg_ids, "
                                 f"{label}].{o}", g, w_, True)[0]
                     for o, g, w_ in zip(BLOCK_OUTPUTS, got, want)]
            cols = frz[0] > 0
            if not (torch.equal(got[0][:, cols], wp[:, cols])
                    and torch.equal(got[1][cols], hp[cols])):
                raise AssertionError(f"seg_ids[{label}]: a frozen job "
                                     "changed")
            fused = fm.fused_block_iterations(a, wp, hp, frz, fused=True,
                                              **sk)
            if not byte_equal(torch, fused, got):
                raise AssertionError(f"seg_ids fused[{label}, {mp}]: not "
                                     "byte-equal to the phased kernel")
            how = ("against the plain version" if mp == "default" else
                   "against the float32 plain version (float64 rule)")
            print(f"options parity fused_block_iterations seg_ids {label} "
                  f"m={a.shape[0]} n={n} rk={wp.shape[1]} segments "
                  f"{int(seg.max()) + 1} (widths <= {kmax}), {mp} "
                  f"operands: max abs {how} "
                  + ", ".join(f"{o} {x:.3e}"
                              for o, x in zip(BLOCK_OUTPUTS, e))
                  + "; frozen job bit-equal; fused=True byte-equal to "
                  "phased", flush=True)
            if label == "north-star" and mp == "default":
                errs["fused_block_iterations[seg_ids]"] = max(e)

    for label, m, n, slots, k, opts in HALS_BLOCK_CASES:
        a, wp, hp, frz, budget = block_operands(torch, m, n, slots, k,
                                                seed=5, **opts)
        ab = a.to(torch.bfloat16)
        hk = dict(k=k, slots=slots, iters=CHECK_EVERY)
        variants = {"bf16": (ab, wp, hp, dict(matmul_precision=BF16)),
                    "bfloat16_w": (a, wp.to(torch.bfloat16), hp, {}),
                    "bfloat16": (a, wp.to(torch.bfloat16),
                                 hp.to(torch.bfloat16), {})}
        for name, (av, wv, hv, okw) in variants.items():
            got = fm.hals_block_iterations(av, wv, hv, frz, **hk, **okw)
            plain = fm.hals_block_iterations_ref(a, wv, hv, frz, **hk, **okw)
            # float64, the pool's bf16 storage rounding kept
            pool = None if name == "bf16" else name
            exact = fm.hals_block_iterations_ref(
                a.double(), wv.double(), hv.double(), frz.double(),
                factor_dtype=pool, **hk, **okw)
            tol = ATOL_REL if pool is None else POOL_ULP
            res = [check_exact(torch, f"hals_block_iterations[{name}, "
                                      f"{label}].{o}", g.float(), p.float(),
                               x.double(), tol)
                   for o, g, p, x in zip(BLOCK_OUTPUTS, got, plain, exact)]
            print(f"options parity hals_block_iterations {name} {label} "
                  f"m={a.shape[0]} n={n} slots={slots} k={k}: max abs "
                  "against the float32 plain version / kernel against "
                  "float64 / plain against float64: "
                  + ", ".join(f"{o} {r[0]:.3e} / {r[1]:.3e} / {r[2]:.3e}"
                              for o, r in zip(BLOCK_OUTPUTS, res)),
                  flush=True)
            if label == "north-star" and name == "bf16":
                errs["hals_block_iterations[bf16]"] = max(r[0] for r in res)
        w2, h2 = wp.clone(), hp.clone()
        plain = fm.hals_block_iterations(a, wp, hp, frz, **hk)
        got = fm.hals_block_iterations(a, w2, h2, frz, alias_io=True, **hk)
        if not (got[0] is w2 and byte_equal(torch, got, plain)):
            raise AssertionError(f"hals alias_io[{label}]: not byte-equal")
        print(f"options parity hals_block_iterations alias_io {label}: in "
              "place, byte-equal to the unaliased launch", flush=True)

    # block_m: only m_pad changes; the first m rows, H and the stats are
    # byte-equal, the padded rows zero
    from nmfx_torch.ops.sched_mu import _pallas_block_geometry

    for m, n, slots, k in ((1237, 77, 13, 3), (5000, 500, SLOTS, 10)):
        a, wp, hp, frz, budget = block_operands(torch, m, n, slots, k,
                                                seed=8, pad=False)
        outs = {}
        for bm in (None, 128, 256):
            m_pad = _pallas_block_geometry(m, bm)[2]
            ap = torch.nn.functional.pad(a, (0, 0, 0, m_pad - m))
            wpp = torch.nn.functional.pad(wp, (0, 0, 0, m_pad - m))
            got = fm.fused_block_iterations(ap, wpp, hp, frz, k=k,
                                            budget_cols=budget, **kw)
            outs[bm] = (m_pad, (got[0][:m],) + tuple(got[1:]))
            if not (got[0][m:] == 0).all():
                raise AssertionError(f"block_m={bm}: a padded row changed")
        same = all(byte_equal(torch, outs[bm][1], outs[None][1])
                   for bm in (128, 256))
        print(f"options parity block_m m={m} n={n} slots={slots} k={k}: "
              f"m_pad {[outs[bm][0] for bm in outs]} for block_m "
              f"{list(outs)}; byte-equal: {same}", flush=True)
        if not same:
            raise AssertionError(f"block_m at m={m}: results differ")
    return errs


#: the north-star paths of the options, each beside the float32 run of
#: the same route: (label, base route, SolverConfig keywords, grid_exec,
#: variant the path must launch)
OPTION_PATHS = (
    ("grid bf16", "grid", dict(backend="pallas", matmul_precision=BF16),
     "auto", "fused_block_iterations[bf16]"),
    ("per-rank bf16", "per_k", dict(backend="pallas",
                                    matmul_precision=BF16), "per_k",
     "fused_h_update[bf16]"),
    ("hals grid bf16", "hals", dict(backend="pallas", algorithm="hals",
                                    matmul_precision=BF16), "auto",
     "hals_block_iterations[bf16]"),
    ("grid factor_dtype bfloat16_w", "grid", dict(
        backend="pallas", experimental=dict(factor_dtype="bfloat16_w")),
     "auto", "fused_block_iterations[bfloat16_w]"),
    ("grid ragged", "uniform cb1", dict(
        backend="pallas", check_block=1, experimental=dict(ragged=True)),
     "auto", "fused_block_iterations[seg_ids]"),
    ("grid alias_io block_m 256", "grid", dict(
        backend="pallas", experimental=dict(alias_io=True, block_m=256)),
     "auto", "fused_block_iterations[alias_io]"),
)
#: the per-rank route under bf16 at ks 2..3 and the whole grid under
#: bf16 at ks 2..5, their depth cut to keep the script inside its time
#: limit (69 s and 29 s at ks 2..10 on one H100; the per-rank route cut
#: from ks 2..5, 23.319 s on one H100, with phase 7 to free phase
#: 13's seconds; the grid from ks 2..6, 13.124 s on one H100, to
#: pay for phase 15); a job's iterations do not depend on the others in
#: its pool, so each rank meets the float32 run's same rank. The ragged
#: pool and its uniform check_block = 1 twin at ks 2..6 (17.460 and
#: 18.334 s at ks 2..10 on one H100, cut to pay for phase 15): per-job
#: iterations and stop reasons of one pool geometry, both at those ks
OPTION_KS = {"per-rank bf16": KS[:2], "grid bf16": KS[:4],
             "grid ragged": KS[:5], "uniform cb1": KS[:5]}


def solver_cfg(nmfx_torch, kw):
    kw = dict(kw)
    if "experimental" in kw:
        kw["experimental"] = nmfx_torch.ExperimentalConfig(
            **kw["experimental"])
    return nmfx_torch.SolverConfig(**kw)


def same_jobs(x, y) -> bool:
    return all(np.array_equal(x.per_k[k].iterations, y.per_k[k].iterations)
               and np.array_equal(x.per_k[k].stop_reasons,
                                  y.per_k[k].stop_reasons) for k in x.ks)


def pool_factors(kw) -> bool:
    return "factor_dtype" in kw.get("experimental", {})


def check_pool_sweep(res, label, n, max_iter=10_000):
    """A sweep with bf16 pool factors, held as nmfx holds its own
    (tests/test_sched_mu.py): finite, iterations within the cap and stop
    reasons of the rule set (the factors come back float32: the CPU
    tests check it). Its labels may freeze at a bf16
    fixed point, which moves best k in nmfx too (best k 3 under
    "bfloat16" at 300 x 20, ks 2..4, in nmfx and in the port, PERF.md
    §6), so best k is reported, not gated."""
    check_finite(res, label, n)
    for k in res.ks:
        kr = res.per_k[k]
        if kr.iterations.max() > max_iter or not set(
                kr.stop_reasons.tolist()) <= {0, 1, 2, 3}:
            raise AssertionError(f"{label} k={k}: iterations or stop "
                                 "reasons out of range")


def phase_option_paths(torch, fm, base):
    """nmfconsensus at the north star under each option (OPTION_PATHS),
    with every launch count set to 0 just before each run: wall, trips,
    host syncs, launches, per-k mean iterations beside the float32 run of
    the same route (``base``: route -> (result, wall)), best k (2 on
    every path but the bf16 pool factors', held as nmfx holds them:
    check_pool_sweep). The ragged run's per-job iterations and stop
    reasons must equal a uniform check_block = 1 run's; alias_io with
    block_m 256 must be byte-equal to the default grid. Then the 200 x 24
    input under each option on the card and on the CPU: the same
    iterations, stop reasons and memberships (bf16 pool factors: the same
    best k and k = 2 memberships, a float32 sum straddling a bf16
    boundary storing the neighbouring value on one of them; hals under
    bf16 operands: the same stops and memberships, iterations may part).
    Returns each path's variant launches."""
    import nmfx_torch
    from nmfx_torch.datasets import two_group_matrix

    m, n, r, _ = NORTH_STAR
    a = north_star_matrix()
    base = dict(base)
    t0 = time.perf_counter()
    base["uniform cb1"] = (nmfx_torch.nmfconsensus(
        a, ks=OPTION_KS["uniform cb1"], restarts=r,
        solver_cfg=nmfx_torch.SolverConfig(
            backend="pallas", check_block=1)), None)
    torch.cuda.synchronize()
    base["uniform cb1"] = (base["uniform cb1"][0], time.perf_counter() - t0)
    variants = {}
    for label, route, kw, grid_exec, variant in OPTION_PATHS:
        seen = {}
        syncs = []

        def on_rank(k, out):
            seen.setdefault("out", out)
            syncs.append(out.host_syncs)

        fm.reset_launch_counts()
        t0 = time.perf_counter()
        res = nmfx_torch.nmfconsensus(
            a, ks=OPTION_KS.get(label, KS), restarts=r,
            solver_cfg=solver_cfg(nmfx_torch, kw), grid_exec=grid_exec,
            on_rank=on_rank)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {key: v for key, v in fm.LAUNCHES.items() if v}
        if pool_factors(kw):
            check_pool_sweep(res, label, n)
        else:
            check_sweep(res, label, n)
        ref, ref_wall = base[route]
        out = seen["out"]
        host_syncs = out.host_syncs if grid_exec == "auto" else sum(syncs)
        iters = {k: (round(float(res.per_k[k].iterations.mean()), 1),
                     round(float(ref.per_k[k].iterations.mean()), 1))
                 for k in res.ks}
        equal = same_jobs(res, ref)
        stops = {k: stop_counts(res.per_k[k]) for k in res.ks}
        print(f"main option {label}: wall {wall:.3f} s (float32 {route} "
              f"run {ref_wall:.3f} s), pool_widths {out.pool_widths}, "
              f"pool_trips {out.pool_trips}, host syncs {host_syncs}, "
              f"launches {launches}, best k {res.best_k} (rho "
              f"{[round(float(x), 4) for x in res.rhos]}); per-job "
              f"iterations and stop reasons equal to the {route} run "
              f"{equal}; per k mean iterations (this, {route}) {iters}; "
              f"stop reasons {stops}", flush=True)
        if not launches.get(variant):
            raise AssertionError(f"{label}: {variant} never launched")
        if grid_exec == "auto" and "fused_block_iterations" in variant and \
                launches.get("fused_block_iterations", 0) < sum(
                    out.pool_trips):
            raise AssertionError(f"{label}: fewer launches than trips")
        if route == "uniform cb1" and not equal:
            raise AssertionError("ragged pool: per-job iterations or stop "
                                 "reasons differ from the uniform pool's")
        if "alias_io" in variant and not (equal and all(
                same_bytes(res.per_k[k].consensus, ref.per_k[k].consensus)
                for k in res.ks)):
            raise AssertionError("alias_io with block_m 256: not byte-equal "
                                 "to the default grid")
        variants[variant] = launches[variant]
        if label == "per-rank bf16":
            variants["fused_w_update[bf16]"] = launches[
                "fused_w_update[bf16]"]

    small = two_group_matrix(n_genes=200, n_per_group=12, seed=3)
    for label, _, kw, grid_exec, _ in OPTION_PATHS + (
            ("grid factor_dtype bfloat16", None, dict(
                backend="pallas",
                experimental=dict(factor_dtype="bfloat16")), "auto", None),):
        kw = dict(kw, max_iter=200)
        args = dict(ks=(2, 3), restarts=4, seed=5, grid_exec=grid_exec,
                    solver_cfg=solver_cfg(nmfx_torch, kw))
        gpu = nmfx_torch.nmfconsensus(small, **args)
        cpu = nmfx_torch.nmfconsensus(small, device="cpu", **args)
        for k in (2, 3):
            g, c = gpu.per_k[k], cpu.per_k[k]
            diff = float(np.abs(g.consensus - c.consensus).max())
            if pool_factors(kw):
                ok = gpu.best_k == cpu.best_k and (
                    k != 2 or np.array_equal(g.membership, c.membership))
            elif kw.get("algorithm") == "hals" and "matmul_precision" in kw:
                # HALS divides cancelling differences by Gram diagonals,
                # so a bf16 operand straddling a rounding boundary on one
                # device moves a TolX check by a block: the same stops,
                # memberships and consensus band, not the same iterations
                ok = (np.array_equal(g.membership, c.membership)
                      and np.array_equal(g.stop_reasons, c.stop_reasons)
                      and diff <= 0.25)
            else:
                ok = (np.array_equal(g.membership, c.membership)
                      and np.array_equal(g.iterations, c.iterations)
                      and np.array_equal(g.stop_reasons, c.stop_reasons)
                      and diff <= 0.25)
            print(f"small 200x24 option {label} k={k}: card vs CPU "
                  f"iterations equal "
                  f"{np.array_equal(g.iterations, c.iterations)}, stop "
                  f"reasons equal "
                  f"{np.array_equal(g.stop_reasons, c.stop_reasons)}, "
                  f"memberships equal "
                  f"{np.array_equal(g.membership, c.membership)}, max |dC| "
                  f"{diff:.3g}, best k {gpu.best_k} vs {cpu.best_k}",
                  flush=True)
            if not ok:
                raise AssertionError(f"small input, option {label}, k={k}: "
                                     "card and CPU disagree")
    return variants


def bf16_rates(rates):
    """The bound's rates for a bf16-operand variant: the bf16 dense
    tensor-core peak beside the card's memory rate."""
    return BF16_PEAK, rates[1]


def library_masked(torch, a, wp, hp, mask, iters, nck):
    """torch.matmul composite of the block iterations of a pool whose
    Gram mask is ``mask`` (rk, rk): full products, masked."""
    from nmfx_torch.solvers.mu import _mu_update

    w, h = wp, hp
    for _ in range(iters * nck):
        g = torch.where(mask, w.T @ w, 0.0)
        hn = _mu_update(h, w.T @ a, g @ h, 1e-9, 0.0)
        gh = torch.where(mask, hn @ hn.T, 0.0)
        w, h = _mu_update(w, a @ hn.T, w @ gh, 1e-9, 0.0), hn
    return w, h


#: kernels whose launch computes numerator products: how many (wh_pass
#: sums a W and an H product)
NUMERATORS = {"h_numer_split": 1, "w_block_update": 1, "wh_pass": 2,
              "h_numer_gram": 1, "w_sweep_tile": 1}


def phase_kernel_split(torch, fm, calls: int = 20):
    """With --quick: rows 1-5 and their bf16-operand variants 1b-5b at
    phase 3's north-star pools, `calls` calls each after a warm-up, timed
    by CUDA events and then under torch.profiler: a call's time, its
    device time (the kernels' sum) and its kernels by device time, each
    numerator kernel with its rate (2 m n rk FLOP a product)."""
    from torch.profiler import ProfilerActivity, profile

    m, n, r, k = NORTH_STAR
    a, wp, hp = operands(torch, m, n, r, k, seed=2)
    gh = fm.lane_gram_ref(hp, k=k)
    ab, wb, hb, frz, budget = block_operands(torch, m, n, SLOTS, k, seed=4)
    mp, rk = ab.shape[0], SLOTS * k
    blk = dict(k=k, iters=CHECK_EVERY, check_block=CHECK_BLOCK,
               budget_cols=budget)
    rows = []
    for prec, tag in (("default", ""), (BF16, "b")):
        bf = dict(matmul_precision=prec)
        a1 = a.to(torch.bfloat16) if tag else a
        a3 = ab.to(torch.bfloat16) if tag else ab
        rows += [
            (f"{1}{tag}", m * r * k, lambda bf=bf, a1=a1: fm.fused_h_update(
                a1, wp, hp, k=k, **bf)),
            (f"{2}{tag}", m * r * k, lambda bf=bf, a1=a1: fm.fused_w_update(
                a1, wp, hp, gh, k=k, **bf)),
            (f"{3}{tag}", mp * rk, lambda bf=bf, a3=a3:
                fm.fused_block_iterations(a3, wb, hb, frz, **blk, **bf)),
            (f"{4}{tag}", mp * rk, lambda bf=bf, a3=a3:
                fm.fused_block_iterations(a3, wb, hb, frz, fused=True,
                                          **blk, **bf)),
            (f"{5}{tag}", mp * rk, lambda bf=bf, a3=a3:
                fm.hals_block_iterations(a3, wb, hb, frz, k=k, slots=SLOTS,
                                         iters=CHECK_EVERY, check_block=1,
                                         **bf))]
    for name, mrk, fn in rows:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        event_ms = start.elapsed_time(end) / calls
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = sorted(((e.key, e.device_time_total / 1e3 / calls,
                           e.count / calls) for e in prof.key_averages()
                          if e.device_time_total > 0), key=lambda x: -x[1])
        parts = []
        for key, ms, per_call in kernels[:8]:
            short = key.removeprefix("void ").replace(
                "(anonymous namespace)::", "").split("(")[0]
            products = NUMERATORS.get(short.split("<")[0], 0)
            rate = ""
            if products:
                flop = 2.0 * mrk * n * products * per_call
                rate = f", {flop / (ms * 1e-3) / 1e12:.1f} TFLOP/s"
            parts.append(f"{short} {ms:.4f} ms x{per_call:g}{rate}")
        print(f"split row {name}: {event_ms:.4f} ms a call (events), device "
              f"{sum(x[1] for x in kernels):.4f} ms; " + "; ".join(parts),
              flush=True)


def phase_option_timing(torch, fm, rates):
    """The variants the option paths run, at the north-star shapes (CUDA
    events, median of 25): kernel, plain version, a torch.matmul composite
    of the same function on the same (bf16-rounded) inputs, and the bound
    (bf16 operands: A at 2 bytes and the bf16 tensor-core peak; bf16 W: W
    at 2 bytes; the ragged pool: its own columns and segment widths). A
    bf16-operand variant also gets its composite on bf16 tensors (the
    same products on the tensor cores, a yardstick the port never calls),
    and the join-the-updates block kernel under bf16 operands (row 4) its
    own line. Returns {variant: (ms, plain, library, bound, by)}."""
    table = {}

    def row(name, label, kernel, plain, lib, bound, lib16=None):
        ms = time_ms(torch, kernel)
        pl = time_ms(torch, plain)
        lb = time_ms(torch, lib)
        table[name] = (ms, pl, lb, *bound)
        extra = ""
        if lib16 is not None:
            extra = f", library bf16 {time_ms(torch, lib16):.4f} ms"
        print(f"timing {name} {label}: kernel {ms:.4f} ms, plain {pl:.4f} "
              f"ms, library {lb:.4f} ms{extra}, bound {bound[0]:.4f} ms "
              f"({bound[1]})", flush=True)

    def bf(*xs):
        return tuple(x.to(torch.bfloat16) for x in xs)

    m, n, r, k = NORTH_STAR
    a, wp, hp = operands(torch, m, n, r, k, seed=2)
    ab = a.to(torch.bfloat16)
    ar, wr, hr = (fm.round_bf16(x) for x in (a, wp, hp))
    gh = fm.lane_gram_ref(hp, k=k, matmul_precision=BF16)
    half = 2 * m * n  # A at 2 bytes, not 4
    # bounds()'s bytes and operations, A at 2 bytes
    h_ops = (2 * m * n * r * k + 2 * m * r * k * k + 2 * r * k * n * k
             + 5 * r * k * n)
    w_ops = 2 * m * n * r * k + 2 * m * r * k * k + 5 * m * r * k
    row("fused_h_update[bf16]", f"m={m} n={n} R={r} k={k}",
        lambda: fm.fused_h_update(ab, wp, hp, k=k, matmul_precision=BF16),
        lambda: fm.fused_h_update_ref(a, wp, hp, k=k, matmul_precision=BF16),
        lambda: library_h(torch, ar, wr, hr, k),
        bound_of(4 * (m * n + m * r * k + 2 * r * k * n) - half, h_ops,
                 bf16_rates(rates)),
        lambda: library_h(torch, *bf(ar, wr, hr), k))
    row("fused_w_update[bf16]", f"m={m} n={n} R={r} k={k}",
        lambda: fm.fused_w_update(ab, wp, hp, gh, k=k, matmul_precision=BF16),
        lambda: fm.fused_w_update_ref(a, wp, hp, gh, k=k,
                                      matmul_precision=BF16),
        lambda: library_w(torch, ar, wr, hr, fm.round_bf16(gh), k),
        bound_of(4 * (m * n + 2 * m * r * k + r * k * n + r * k * k) - half,
                 w_ops, bf16_rates(rates)),
        lambda: library_w(torch, *bf(ar, wr, hr, gh), k))

    a, wp, hp, frz, budget = block_operands(torch, m, n, SLOTS, k, seed=4)
    mp, rk = a.shape[0], SLOTS * k
    ab = a.to(torch.bfloat16)
    ar, wr, hr = (fm.round_bf16(x) for x in (a, wp, hp))
    kw = dict(k=k, iters=CHECK_EVERY, check_block=CHECK_BLOCK,
              budget_cols=budget)
    label = f"m={mp} n={n} slots={SLOTS} k={k} (8 iterations)"
    ops8 = block_ops(mp, n, rk, rk * k, CHECK_EVERY, CHECK_BLOCK)
    for name, fused in (("fused_block_iterations[bf16]", False),
                        ("fused_block_iterations_fused[bf16]", True)):
        row(name, label,
            lambda fused=fused: fm.fused_block_iterations(
                ab, wp, hp, frz, fused=fused, matmul_precision=BF16, **kw),
            lambda: fm.fused_block_iterations_ref(a, wp, hp, frz,
                                                  matmul_precision=BF16,
                                                  **kw),
            lambda: library_block(torch, ar, wr, hr, k, CHECK_EVERY,
                                  CHECK_BLOCK),
            bound_of(block_bytes(mp, n, rk, CHECK_BLOCK, a_bytes=2), ops8,
                     bf16_rates(rates)),
            lambda: library_block(torch, *bf(ar, wr, hr), k, CHECK_EVERY,
                                  CHECK_BLOCK))
    wq = wp.to(torch.bfloat16)
    row("fused_block_iterations[bfloat16_w]", label,
        lambda: fm.fused_block_iterations(a, wq, hp, frz, **kw),
        lambda: fm.fused_block_iterations_ref(a, wq, hp, frz, **kw),
        lambda: library_block(torch, a, wq.float(), hp, k, CHECK_EVERY,
                              CHECK_BLOCK),
        bound_of(block_bytes(mp, n, rk, CHECK_BLOCK, w_bytes=2), ops8,
                 rates))
    w2, h2 = wp.clone(), hp.clone()
    row("fused_block_iterations[alias_io]", label,
        lambda: fm.fused_block_iterations(a, w2, h2, frz, alias_io=True,
                                          **kw),
        lambda: fm.fused_block_iterations_ref(a, wp, hp, frz, **kw),
        lambda: library_block(torch, a, wp, hp, k, CHECK_EVERY,
                              CHECK_BLOCK),
        bound_of(block_bytes(mp, n, rk, CHECK_BLOCK), ops8, rates))
    hkw = dict(k=k, slots=SLOTS, iters=CHECK_EVERY)
    row("hals_block_iterations[bf16]", f"m={mp} n={n} slots={SLOTS} k={k} "
        "(2 iterations)",
        lambda: fm.hals_block_iterations(ab, wp, hp, frz,
                                         matmul_precision=BF16, **hkw),
        lambda: fm.hals_block_iterations_ref(a, wp, hp, frz,
                                             matmul_precision=BF16, **hkw),
        lambda: library_hals(torch, ar, wr, hr, k, CHECK_EVERY, 1),
        bound_of(block_bytes(mp, n, rk, 1, a_bytes=2),
                 hals_ops(mp, n, rk, k, CHECK_EVERY, 1), bf16_rates(rates)),
        lambda: library_hals(torch, *bf(ar, wr, hr), k, CHECK_EVERY, 1))
    # the ragged pool: the ragged path's launch (2 iterations, check-per-
    # trip) over the north star's class-major columns
    label_r, m_r, n_r, job_ks, budget_cols = RAGGED_CASES[0]
    a, wp, hp, frz, seg, kmax = ragged_pool(torch, m_r, n_r, job_ks,
                                            budget_cols, seed=9)
    frz.zero_()
    mp, rk = a.shape[0], wp.shape[1]
    widths = np.bincount(seg)
    mask = torch.as_tensor(seg[:, None] == seg[None, :], device="cuda")
    row("fused_block_iterations[seg_ids]", f"m={mp} n={n_r} rk={rk} "
        f"segments {widths.size} (2 iterations)",
        lambda: fm.fused_block_iterations(a, wp, hp, frz, k=kmax,
                                          iters=CHECK_EVERY, seg_ids=seg),
        lambda: fm.fused_block_iterations_ref(a, wp, hp, frz, k=kmax,
                                              iters=CHECK_EVERY,
                                              seg_ids=seg),
        lambda: library_masked(torch, a, wp, hp, mask, CHECK_EVERY, 1),
        bound_of(block_bytes(mp, n_r, rk, 1),
                 block_ops(mp, n_r, rk, int((widths ** 2).sum()),
                           CHECK_EVERY, 1), rates))
    return table


#: phase 8: restarts a ledger record holds (45 records at the north star);
#: the kill-and-resume run's ranks (its depth cut to ks 2..3, 10 chunks,
#: to keep the script inside its time limit) and the chunk solve the
#: rehearsed preemption lands on
CKPT_CHUNK, KILL_KS, KILL_AT = 10, tuple(range(2, 4)), 5
#: phase 8a/c/d: the checkpointed north star's ranks, cut to ks 2..3
#: (10 chunks) to pay for phase 14: at ks 2..10 8a took 155 s, at ks
#: 2..6 44.5 s, at ks 2..4 20.952 s (one H100, PR 18's run MM)
CKPT_KS = tuple(range(2, 4))
#: phase 8g: the float64 bundled sweep's ranks, cut from 2..5 to pay for
#: phase 14 (the JAX package's best k over 2..5 is 2, so over 2..3 too)
F64_KS = (2, 3)
#: phase 8e: the share of restarts poisoned (one NaN in W0)
POISON_RATE = 0.05
#: phase 8f: the stale reloads' rate and the pool that makes slots reload
STALE_RATE, STALE_SLOTS = 0.25, 8
#: phase 8g: the float64 kernel routes on the bundled design, each with
#: the rows it must launch: route -> (solver fields, grid_exec, rows)
F64_KERNEL_ROUTES = {
    "per-rank pair": (dict(), "per_k",
                      ("fused_h_update", "lane_gram", "fused_w_update")),
    "grid": (dict(), "auto", ("fused_block_iterations",)),
    "hals grid": (dict(algorithm="hals"), "auto",
                  ("hals_block_iterations",)),
    "grid bf16": (dict(matmul_precision=BF16), "auto",
                  ("fused_block_iterations[bf16]",)),
}
#: the kernels line's float64 entries: name -> (8g route, launch count)
F64_LAUNCHES = {
    "fused_h_update[float64]": ("per-rank pair", "fused_h_update"),
    "fused_w_update[float64]": ("per-rank pair", "fused_w_update"),
    "fused_block_iterations[float64]": ("grid", "fused_block_iterations"),
    "hals_block_iterations[float64]": ("hals grid", "hals_block_iterations"),
    "fused_block_iterations[bf16,float64]": ("grid bf16",
                                             "fused_block_iterations[bf16]"),
}
#: phase 8g: best k of the bundled 1000x40 design on the batched restart
#: route in float64 (ks 2..5, 10 restarts, seed 123), as the JAX package
#: gives it on its CPU backend under jax_enable_x64
FLOAT64_BEST_K = 2

DURABILITY_FIELDS = ("consensus", "rho", "membership", "order",
                     "iterations", "dnorms", "stop_reasons", "best_w",
                     "best_h")


def phase_seconds(prof, prefix) -> float:
    return sum(rec.seconds for name, rec in prof.phases.items()
               if name.startswith(prefix))


def results_byte_equal(x, y, fields=DURABILITY_FIELDS) -> bool:
    return x.ks == y.ks and all(
        same_bytes(getattr(x.per_k[k], f), getattr(y.per_k[k], f))
        for k in x.ks for f in fields)


def expect_preempted(fn, ckpt):
    """Run fn, which must raise checkpoint.Preempted (the rehearsed
    kill); anything else propagates."""
    try:
        fn()
    except ckpt.Preempted:
        return
    raise AssertionError("the armed proc.preempt site did not fire")


def phase_durability(torch, fm, grid, per_rank, hals, *, a=None, ks=KS,
                     restarts=None, chunk=CKPT_CHUNK, ckpt_ks=CKPT_KS,
                     kill_ks=KILL_KS, kill_at=KILL_AT, bundled=None,
                     device=None):
    """Phase 8, the durable sweep (nmfx_torch.checkpoint) at the north
    star on the per-iteration kernel pair, and the fault sites on the
    block kernels: a. uninterrupted, b. killed by proc.preempt and
    resumed (byte-equal to a), c. a's warm re-run (no solve, no launch,
    no byte copied), d. against the per-rank route's result ``per_rank``,
    e. solve.nonfinite on the whole grid and the hals grid against their
    clean runs ``grid`` and ``hals``, f. sched.stale_reload on the
    bundled design, g. float64 on the batched restart route. a, c and d
    run at ``ckpt_ks``, e at ``ks``. Returns the launches of each run by
    name."""
    import tempfile

    import nmfx_torch
    from nmfx_torch import checkpoint as ckpt
    from nmfx_torch import data_cache, faults
    from nmfx_torch.datasets import two_group_matrix
    from nmfx_torch.profiling import Profiler

    a = north_star_matrix() if a is None else a
    r = NORTH_STAR[2] if restarts is None else restarts
    n = a.shape[1]
    n_chunks = len(ckpt_ks) * -(-r // chunk)
    kill_chunks = len(kill_ks) * -(-r // chunk)
    bundled = (two_group_matrix(n_genes=1000, n_per_group=20, seed=123)
               if bundled is None else bundled)
    pallas = nmfx_torch.SolverConfig(backend="pallas")
    sync = torch.cuda.synchronize if device is None else (lambda: None)
    launches = {}

    def run(directory, ks=ckpt_ks, **kw):
        return nmfx_torch.nmfconsensus(
            a, ks=ks, restarts=r, solver_cfg=pallas, device=device,
            checkpoint=nmfx_torch.CheckpointConfig(
                directory=directory, every_n_restarts=chunk), **kw)

    def counted(label, fn):
        fm.reset_launch_counts()
        s0, l0 = ckpt.chunks_solved_count(), ckpt.chunks_loaded_count()
        b0 = data_cache.h2d_bytes()
        t0 = time.perf_counter()
        res = fn()
        sync()
        wall = time.perf_counter() - t0
        launches[label] = {k: v for k, v in fm.LAUNCHES.items() if v}
        return (res, wall, ckpt.chunks_solved_count() - s0,
                ckpt.chunks_loaded_count() - l0, data_cache.h2d_bytes() - b0)

    with tempfile.TemporaryDirectory(prefix=".ckpt_smoke_",
                                     dir=HERE) as root:
        dir_a, dir_b = os.path.join(root, "a"), os.path.join(root, "b")
        # a. uninterrupted
        prof = Profiler()

        def profiled_run():
            with prof:
                return run(dir_a, profiler=prof)

        res_a, wall_a, solved, loaded, _ = counted("a", profiled_run)
        la = launches["a"]
        print(f"durability a (uninterrupted, pallas, ks {ckpt_ks[0]}.."
              f"{ckpt_ks[-1]}, {n_chunks} chunks of {chunk}): wall {wall_a:.3f} s [solve.ckpt "
              f"{phase_seconds(prof, 'solve.ckpt'):.3f} s, ckpt.load "
              f"{phase_seconds(prof, 'ckpt.load'):.4f} s, checkpoint "
              f"{phase_seconds(prof, 'checkpoint'):.4f} s, ckpt.finalize "
              f"{phase_seconds(prof, 'ckpt.finalize'):.4f} s for "
              f"{len(ckpt_ks)} ranks, "
              f"{phase_seconds(prof, 'ckpt.finalize') / len(ckpt_ks):.4f} "
              "s a rank (an int64 einsum took 1.1307 s for 9 ranks, "
              "0.1256 s a rank), "
              f"post.rank_selection "
              f"{phase_seconds(prof, 'post.rank_selection'):.4f} s "
              f"overlapped], chunks solved {solved}, loaded {loaded}, "
              f"launches {la}, best k {res_a.best_k}", flush=True)
        check_sweep(res_a, "durability a", n)
        if solved != n_chunks or loaded:
            raise AssertionError(f"durability a: {solved} chunks solved, "
                                 f"{loaded} loaded; want {n_chunks}, 0")
        if device is None and not all(
                la.get(name, 0) > 0 for name in
                ("fused_h_update", "lane_gram", "fused_w_update")):
            raise AssertionError(f"durability a: the pair did not launch "
                                 f"({la})")

        # b. killed at the kill_at-th chunk solve, then resumed
        faults.arm("proc.preempt", every=kill_at, max_fires=1)
        try:
            _, wall_kill, _, _, _ = counted(
                "b-killed", lambda: expect_preempted(
                    lambda: run(dir_b, ks=kill_ks), ckpt))
        finally:
            faults.disarm("proc.preempt")
        records = sum(1 for f in os.listdir(dir_b) if f.endswith(".npz"))
        res_b, wall_b, solved, loaded, _ = counted(
            "b", lambda: run(dir_b, ks=kill_ks))
        same_b = all(same_bytes(getattr(res_b.per_k[k], f),
                                getattr(res_a.per_k[k], f))
                     for k in kill_ks for f in DURABILITY_FIELDS)
        print(f"durability b (ks {kill_ks[0]}..{kill_ks[-1]}, killed at "
              f"chunk {kill_at} of {kill_chunks}): killed run "
              f"{wall_kill:.3f} s with {records} records on disk; resume "
              f"{wall_b:.3f} s, chunks solved {solved}, loaded {loaded}, "
              f"launches {launches['b']}; byte-equal to a at those ranks: "
              f"{same_b}", flush=True)
        if records != kill_at - 1 or solved != kill_chunks - kill_at + 1 \
                or loaded != kill_at - 1 or not same_b:
            raise AssertionError(
                f"durability b: {records} records, resume solved {solved} "
                f"and loaded {loaded}, byte-equal {same_b}")

        # c. warm re-run of a's ledger
        res_c, wall_c, solved, loaded, copied = counted(
            "c", lambda: run(dir_a))
        same_c = results_byte_equal(res_c, res_a)
        print(f"durability c (warm re-run): wall {wall_c:.3f} s, chunks "
              f"solved {solved}, loaded {loaded}, launches "
              f"{sum(launches['c'].values())}, bytes copied to the card "
              f"{copied}; byte-equal to a: {same_c}", flush=True)
        if solved or loaded != n_chunks or launches["c"] or copied \
                or not same_c:
            raise AssertionError("durability c: the warm re-run did work")

    # d. against the per-rank route (one 50-restart batch a rank): the
    # same per-restart labels give consensus values c/50, divided in
    # float64 here and in float32 there, so the rank selection's
    # tie-heavy merges may part at higher k (as device against host
    # selection does in 4e); the gate is best k and the k = 2 memberships
    if per_rank is not None:
        dc = max(float(np.abs(res_a.per_k[k].consensus
                              - per_rank.per_k[k].consensus).max())
                 for k in ckpt_ks)
        iters = all(np.array_equal(res_a.per_k[k].iterations,
                                   per_rank.per_k[k].iterations)
                    for k in ckpt_ks)
        members = [k for k in ckpt_ks if np.array_equal(
            res_a.per_k[k].membership, per_rank.per_k[k].membership)]
        # best k over the same ranks: a's ks are a prefix of the route's
        sub_best = max(ckpt_ks, key=lambda k: (per_rank.per_k[k].rho,
                                               per_rank.per_k[k].dispersion))
        print(f"durability d (against the per-rank route at ks "
              f"{ckpt_ks[0]}..{ckpt_ks[-1]}): best k {res_a.best_k} / "
              f"{sub_best}, memberships equal at ks {members} of "
              f"{list(ckpt_ks)}, max|dC| {dc:.3e}, every per-restart "
              f"iteration count equal {iters}", flush=True)
        if res_a.best_k != sub_best or ckpt_ks[0] not in members \
                or dc > 1e-6:
            raise AssertionError("durability d: the checkpointed sweep "
                                 "parts from the per-rank route")

    # e. poisoned restarts on the block kernels (rows 3 and 5)
    faults.arm("solve.nonfinite", rate=POISON_RATE, seed=0)
    try:
        for label, clean, scfg in (
                ("grid", grid, pallas),
                ("hals grid", hals, nmfx_torch.SolverConfig(
                    algorithm="hals", backend="pallas"))):
            if clean is None:
                continue
            res_e, wall_e, _, _, _ = counted(
                f"e {label}", lambda: nmfx_torch.nmfconsensus(
                    a, ks=ks, restarts=r, solver_cfg=scfg, device=device,
                    keep_factors=clean.per_k[ks[0]].all_h is not None))
            poisoned = {k: faults.poison_restarts(k, r) for k in ks}
            ok, bad = True, {}
            for k in ks:
                g, c = res_e.per_k[k], clean.per_k[k]
                hit = np.zeros(r, bool)
                hit[list(poisoned[k])] = True
                ok &= bool((g.stop_reasons[hit] == 5).all())
                fields = ["iterations", "stop_reasons", "dnorms"]
                if c.all_h is not None:
                    fields.append("labels")
                for f in fields:
                    if f == "labels":
                        x, y = (np.argmax(res.all_h, axis=1)
                                for res in (g, c))
                    else:
                        x, y = getattr(g, f), getattr(c, f)
                    if not same_bytes(x[~hit], y[~hit]):
                        bad.setdefault(k, []).append(f)
            print(f"durability e ({label}, solve.nonfinite rate "
                  f"{POISON_RATE}): wall {wall_e:.3f} s, poisoned "
                  f"{ {k: list(v) for k, v in poisoned.items() if v} }, all "
                  f"NUMERIC_FAULT {ok}, unpoisoned restarts byte-equal to "
                  f"the clean run {not bad} {bad or ''}, launches "
                  f"{launches[f'e {label}']}, best k {res_e.best_k}",
                  flush=True)
            if not ok or bad or res_e.best_k != 2:
                raise AssertionError(f"durability e ({label}): poisoned "
                                     f"lanes leaked or were missed: {bad}")
    finally:
        faults.disarm("solve.nonfinite")

    # f. stale reloads on the bundled design's pallas grid
    bks, br = (2, 3, 4, 5), 10

    def bundled_grid():
        return nmfx_torch.nmfconsensus(
            bundled, ks=bks, restarts=br, seed=123, solver_cfg=pallas,
            grid_slots=STALE_SLOTS, device=device)

    from nmfx_torch.ops.sched_mu import _stale_load_mask

    # jobs run rank-descending, restart-major; the first STALE_SLOTS load
    # at the start, every later one through a reload
    order = [(k, rr) for k in sorted(bks, reverse=True) for rr in range(br)]
    jobs = np.arange(STALE_SLOTS, len(order))
    clean_f, _, _, _, _ = counted("f clean", bundled_grid)
    faults.arm("sched.stale_reload", rate=STALE_RATE)
    try:
        want = {order[j] for j in jobs[~_stale_load_mask(jobs)]}
        stale_f, wall_f, _, _, _ = counted("f stale", bundled_grid)
    finally:
        faults.disarm("sched.stale_reload")
    again_f, _, _, _, _ = counted("f disarmed", bundled_grid)
    got = {(k, rr) for k in bks for rr in range(br)
           if not (same_bytes(stale_f.per_k[k].dnorms[rr],
                              clean_f.per_k[k].dnorms[rr])
                   and stale_f.per_k[k].iterations[rr]
                   == clean_f.per_k[k].iterations[rr])}
    same_f = results_byte_equal(again_f, clean_f)
    print(f"durability f (sched.stale_reload rate {STALE_RATE}, "
          f"{STALE_SLOTS} slots): wall {wall_f:.3f} s, dropped reloads "
          f"{sorted(want)}, restarts that differ from the clean run "
          f"{sorted(got)}, the hashed set {got == want}; disarmed run "
          f"byte-equal to the clean one {same_f}", flush=True)
    if got != want or not want or not same_f:
        raise AssertionError("durability f: the stale reloads are not the "
                             "hashed set, or disarm did not restore")

    # g. float64 on the batched restart route
    res_g, wall_g, _, _, _ = counted(
        "g", lambda: nmfx_torch.nmfconsensus(
            bundled, ks=F64_KS, restarts=br, seed=123, device=device,
            solver_cfg=nmfx_torch.SolverConfig(backend="vmap",
                                               dtype="float64")))
    iters_g = {k: round(float(res_g.per_k[k].iterations.mean()), 1)
               for k in F64_KS}
    print(f"durability g (float64, batched restart route, bundled "
          f"1000x40): wall {wall_g:.3f} s, best k {res_g.best_k} (the JAX "
          f"package: {FLOAT64_BEST_K}), mean iters per k {iters_g}, "
          f"launches {sum(launches['g'].values())}, best_w dtype "
          f"{res_g.per_k[2].best_w.dtype}", flush=True)
    check_finite(res_g, "durability g", bundled.shape[1])
    if res_g.best_k != FLOAT64_BEST_K or launches["g"] \
            or res_g.per_k[2].best_w.dtype != np.float64:
        raise AssertionError("durability g: float64 batched sweep off")

    # g. float64 on the kernel routes, each beside float32's same call
    for route, (kw, grid_exec, rows) in F64_KERNEL_ROUTES.items():
        runs = {}
        for dtype in ("float64", "float32"):
            runs[dtype] = counted(
                f"g {route} {dtype}",
                lambda dtype=dtype: nmfx_torch.nmfconsensus(
                    bundled, ks=F64_KS, restarts=br, seed=123,
                    device=device, grid_exec=grid_exec,
                    solver_cfg=nmfx_torch.SolverConfig(
                        backend="pallas", dtype=dtype, **kw)))
        res64, wall64 = runs["float64"][:2]
        res32, wall32 = runs["float32"][:2]
        l64 = launches[f"g {route} float64"]
        check_finite(res64, f"durability g {route}", bundled.shape[1])
        same2 = np.array_equal(res64.per_k[2].membership,
                               res32.per_k[2].membership)
        iters = {dt: {k: round(float(res.per_k[k].iterations.mean()), 1)
                      for k in F64_KS}
                 for dt, res in (("float64", res64), ("float32", res32))}
        print(f"durability g float64 {route} (bundled 1000x40, ks "
              f"{F64_KS[0]}..{F64_KS[-1]}, {br} restarts): wall "
              f"{wall64:.3f} s (float32 {wall32:.3f} s), best k "
              f"{res64.best_k} (float32 {res32.best_k}; the JAX package: "
              f"{FLOAT64_BEST_K}), best_w dtype {res64.per_k[2].best_w.dtype}"
              f", launches {l64} (float32 "
              f"{launches[f'g {route} float32']}), mean iters per k {iters}"
              f", k = 2 memberships equal to float32's {same2}", flush=True)
        missing = [name for name in rows if not l64.get(name, 0) > 0]
        if (res64.best_k != FLOAT64_BEST_K or not same2
                or res64.per_k[2].best_w.dtype != np.float64
                or (device is None and missing)):
            raise AssertionError(
                f"durability g {route}: float64 kernel route off (best k "
                f"{res64.best_k}, memberships equal {same2}, rows not "
                f"launched {missing})")
    return launches


# --- phase 9: observability and the job grid ------------------------------

#: phase 9b: the per-rank route's ranks (its depth cut to keep phase 9
#: near its budget)
OBS_PER_K_KS = (2, 3, 4)
#: phase 9c/9d: the bundled design's ranks and restarts, and 9c's ledger
#: records of 5 restarts (4 chunks; the ranks cut from 2..5, 8 chunks and
#: 16.042 s on one H100, to pay for phase 15)
BUNDLED_KS, BUNDLED_RESTARTS, OBS_CHUNK = (2, 3), 10, 5
#: the peak-table row the card's attributions must use
OBS_PEAK_KIND = "NVIDIA H100 80GB HBM3"
#: MFU's ceiling: the model's FLOPs are work every lane really does, so
#: no run can pass the peak (the margin covers the wall's clock error)
MFU_MAX = 1.05
#: the phases a traced north-star grid must book as spans
OBS_PHASES = ("solve.grid", "xfer.overlap", "xfer.d2h_overlap",
              "post.rank_selection")


def model_flops(res, scfg, m, n, ks=None):
    """The script's own count: Σ_k iteration_flops(k) × the rank's
    iterations summed over its restarts, from the result."""
    from nmfx_torch.obs import costmodel as cm

    return sum(cm.iteration_flops(scfg.algorithm, "pallas", m, n, k, scfg)
               * int(res.per_k[k].iterations.astype(np.int64).sum())
               for k in (res.ks if ks is None else ks))


def check_attribution(label, rec, want_flops, peak_kind):
    """9b's gates on one attributed dispatch record: the card's peak row,
    the script's FLOP count, family "pallas", MFU finite in (0, MFU_MAX]
    and the bandwidth fraction finite and above 0 (no upper gate: it is
    a fraction of per-lane model bytes)."""
    peak = rec["device_peak"]
    kind = None if peak is None else peak["kind"]
    mfu, bw = rec["mfu"], rec["hbm_bw_fraction"]
    problems = []
    if kind != peak_kind:
        problems.append(f"device peak {kind!r}")
    if rec["model_flops"] != want_flops:
        problems.append(f"model_flops {rec['model_flops']!r} != "
                        f"{want_flops!r}")
    if rec["family"] != "pallas":
        problems.append(f"family {rec['family']!r}")
    if mfu is None or not (np.isfinite(mfu) and 0 < mfu <= MFU_MAX):
        problems.append(f"mfu {mfu!r}")
    if bw is None or not (np.isfinite(bw) and bw > 0):
        problems.append(f"hbm_bw_fraction {bw!r}")
    print(f"obs 9b {label}: model {rec['model_flops']:.6e} FLOP (script "
          f"{want_flops:.6e}), {rec['model_bytes']:.6e} B, solve wall "
          f"{rec['solve_s']:.4f} s, {rec['achieved_flops_per_s']:.6e} "
          f"FLOP/s, AI {rec['arithmetic_intensity']:.4f}, mfu {mfu!r}, "
          f"hbm_bw_fraction {bw!r}, verdict {rec['verdict']}", flush=True)
    if problems:
        raise AssertionError(f"obs 9b {label}: {problems}")


def print_perf(label):
    from nmfx_torch.obs import costmodel as cm

    summary = cm.perf_summary()
    for kind, rec in sorted(summary["kinds"].items()):
        print(f"obs 9b {label} perf_summary[{kind!r}]: "
              f"{json.dumps(rec, default=str)}", flush=True)
    print(f"obs 9b {label} perf_report:\n{cm.perf_report()}", flush=True)


def phase_obs(torch, fm, grid, *, a=None, ks=KS, restarts=None,
              per_k_ks=OBS_PER_K_KS, bundled=None, device=None,
              peak_kind=OBS_PEAK_KIND):
    """Phase 9, the observability core and the job grid: a. the
    north-star whole grid traced under a Profiler against ``grid``,
    phase 4a's untraced run of it as (result, wall, row 3's launches):
    byte-equal results and launches, one span a booked phase, nothing
    dropped; b. the per-dispatch attribution of that traced run, of the
    hals grid and of the per-rank route against the card's peak row;
    c. the checkpoint counters, commit spans and flight events on the
    bundled design's ledger, a solve.nonfinite fire event and a flight
    dump naming the armed site; d. the job-grid API on a keep_factors
    sweep, run_example, and sweep_one_k called with the reference's
    keywords and positions. Returns the launches of each run by name."""
    import tempfile

    import nmfx_torch
    from nmfx_torch import checkpoint as ckpt
    from nmfx_torch import faults
    from nmfx_torch import random as _random
    from nmfx_torch import sweep as tsweep
    from nmfx_torch.datasets import two_group_matrix
    from nmfx_torch.obs import costmodel as cm
    from nmfx_torch.obs import flight, metrics, trace
    from nmfx_torch.profiling import Profiler

    a = north_star_matrix() if a is None else a
    r = NORTH_STAR[2] if restarts is None else restarts
    m, n = a.shape
    bundled = (two_group_matrix(n_genes=1000, n_per_group=20, seed=123)
               if bundled is None else bundled)
    bn = bundled.shape[1]
    pallas = nmfx_torch.SolverConfig(backend="pallas")
    on_card = device is None
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    tr = trace.default_tracer()
    launches = {}

    def counted(label, fn):
        fm.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        sync()
        wall = time.perf_counter() - t0
        launches[label] = {k: v for k, v in fm.LAUNCHES.items() if v}
        return res, wall

    def sweep(data=a, sweep_ks=ks, sweep_r=r, scfg=pallas, **kw):
        return nmfx_torch.nmfconsensus(data, ks=sweep_ks, restarts=sweep_r,
                                       solver_cfg=scfg, device=device, **kw)

    # a. the north-star grid traced under a Profiler, against phase 4a's
    # untraced run of the same grid
    plain, plain_wall, la_plain = grid
    cm.reset_perf()
    tr.clear()
    prof = Profiler()
    trace.enable()
    try:
        def traced_run():
            with prof:
                return sweep(profiler=prof)

        traced, traced_wall = counted("a traced", traced_run)
    finally:
        trace.disable()
    with tempfile.TemporaryDirectory() as tmp:
        with open(tr.export(os.path.join(tmp, "trace.json"))) as f:
            chrome = json.load(f)
    by_name: dict = {}
    for ev in chrome["traceEvents"]:
        if ev.get("ph") in ("X", "i"):
            by_name[ev["name"]] = by_name.get(ev["name"], 0) + 1
    booked = {name: rec.count for name, rec in prof.phases.items()}
    spans_ok = (all(by_name.get(p, 0) == c for p, c in booked.items())
                and all(p in booked for p in OBS_PHASES))
    same_a = results_byte_equal(traced, plain)
    row3 = "fused_block_iterations"
    la_traced = launches["a traced"].get(row3, 0)
    print(f"obs 9a (north-star grid, pallas): untraced wall (4a) "
          f"{plain_wall:.3f} s, traced wall {traced_wall:.3f} s "
          f"(+{(traced_wall - plain_wall) / plain_wall:.2%}), row 3 "
          f"launches {la_plain} / {la_traced}, byte-equal {same_a}, best k "
          f"{plain.best_k} / {traced.best_k}; trace events "
          f"{len(chrome['traceEvents'])}, spans by phase {by_name} against "
          f"the profiler's books {booked}: {spans_ok}, dropped "
          f"{tr.dropped}", flush=True)
    if not same_a or la_plain != la_traced or (on_card and not la_plain) \
            or plain.best_k != 2 or not spans_ok or tr.dropped:
        raise AssertionError("obs 9a: tracing moved the numbers or lost "
                             "spans")
    tr.clear()

    # b. attribution: the traced grid, the hals grid, the per-rank route
    grid_rec = [x for x in cm.recent_attributions()
                if x["kind"] == "sweep.grid"]
    if len(grid_rec) != 1:
        raise AssertionError(f"obs 9b: {len(grid_rec)} sweep.grid records")
    check_attribution("grid mu", grid_rec[0],
                      model_flops(traced, pallas, m, n), peak_kind)
    print_perf("grid mu")

    cm.reset_perf()
    hals_cfg = nmfx_torch.SolverConfig(algorithm="hals", backend="pallas")
    prof = Profiler()

    def hals_run():
        with prof:
            return sweep(scfg=hals_cfg, profiler=prof)

    hals, hals_wall = counted("b hals grid", hals_run)
    (hals_rec,) = cm.recent_attributions()
    check_attribution("hals grid", hals_rec,
                      model_flops(hals, hals_cfg, m, n), peak_kind)
    print_perf("hals grid")
    print(f"obs 9b hals grid: wall {hals_wall:.3f} s, launches "
          f"{launches['b hals grid']}, best k {hals.best_k}", flush=True)

    cm.reset_perf()
    prof = Profiler()

    def per_k_run():
        with prof:
            return sweep(sweep_ks=per_k_ks, grid_exec="per_k",
                         profiler=prof)

    per_k, per_k_wall = counted("b per-rank", per_k_run)
    recs = cm.recent_attributions()
    if [x["kind"] for x in recs] != ["sweep.k"] * len(per_k_ks):
        raise AssertionError(f"obs 9b per-rank: records {recs}")
    for k, rec in zip(per_k_ks, recs):
        check_attribution(f"per-rank k={k}", rec,
                          model_flops(per_k, pallas, m, n, (k,)), peak_kind)
    print_perf("per-rank")
    print(f"obs 9b per-rank (ks {per_k_ks[0]}..{per_k_ks[-1]}): wall "
          f"{per_k_wall:.3f} s, launches {launches['b per-rank']}",
          flush=True)
    if on_card and not (launches["b hals grid"].get("hals_block_iterations")
                        and launches["b per-rank"].get("fused_h_update")
                        and launches["b per-rank"].get("fused_w_update")):
        raise AssertionError("obs 9b: rows 1-2 or 5 did not launch")

    # c. counters, spans and flight events on the durability path
    rec_f = flight.default_recorder()
    reg = metrics.registry()
    n_chunks = len(BUNDLED_KS) * -(-BUNDLED_RESTARTS // OBS_CHUNK)
    with tempfile.TemporaryDirectory(prefix=".ckpt_smoke_",
                                     dir=HERE) as root:
        snap = reg.snapshot()
        s0 = ckpt.chunks_solved_count()
        c0 = len(rec_f.events("ckpt.commit"))
        trace.enable()
        try:
            res_c, wall_c = counted("c ledger", lambda: sweep(
                bundled, BUNDLED_KS, BUNDLED_RESTARTS,
                checkpoint=nmfx_torch.CheckpointConfig(
                    directory=os.path.join(root, "ledger"),
                    every_n_restarts=OBS_CHUNK)))
        finally:
            trace.disable()
        delta = reg.delta(snap)["nmfx_ckpt_chunks_solved_total"]["series"]
        reg_solved = int(delta.get((), 0))
        shim_solved = ckpt.chunks_solved_count() - s0
        commits = len(rec_f.events("ckpt.commit")) - c0
        spans = sum(1 for ev in tr.events() if ev["name"] == "ckpt.commit")
        tr.clear()
        text = reg.prometheus_text()
        series = ("nmfx_ckpt_chunks_solved_total",
                  "nmfx_data_h2d_transfers_total",
                  "nmfx_data_h2d_bytes_total")
        named = all(f"# TYPE {s} counter" in text for s in series)
        print(f"obs 9c (bundled 1000x40 through the ledger, {n_chunks} "
              f"chunks of {OBS_CHUNK}): wall {wall_c:.3f} s, registry "
              f"delta {reg_solved}, chunks_solved_count delta "
              f"{shim_solved}, ckpt.commit flight events {commits}, spans "
              f"{spans}, exposition names {series}: {named}, launches "
              f"{launches['c ledger']}, best k {res_c.best_k}", flush=True)
        check_sweep(res_c, "obs 9c", bn)
        if not (reg_solved == shim_solved == commits == spans == n_chunks) \
                or not named:
            raise AssertionError("obs 9c: the counters, spans or commit "
                                 "events disagree")

        e0 = len(rec_f.events("fault.solve.nonfinite"))
        faults.arm("solve.nonfinite", lanes=((2, 1),))
        try:
            # through a fresh ledger: each chunk is its own pool, so
            # the other chunks of rank 2 survive even where a plain
            # version spreads the NaN across its pool (the CPU)
            res_p, _ = counted("c poisoned", lambda: sweep(
                bundled, BUNDLED_KS, BUNDLED_RESTARTS,
                checkpoint=nmfx_torch.CheckpointConfig(
                    directory=os.path.join(root, "poisoned"),
                    every_n_restarts=OBS_CHUNK)))
            fired = len(rec_f.events("fault.solve.nonfinite")) - e0
            flight.configure(os.path.join(root, "flight"))
            try:
                path = flight.dump("chip-smoke-9c")
            finally:
                flight.configure(None)
        finally:
            faults.disarm("solve.nonfinite")
        with open(path) as f:
            dumped = json.load(f)
        stops = res_p.per_k[2].stop_reasons
        print(f"obs 9c (solve.nonfinite at (k 2, restart 1)): fire events "
              f"{fired}, k=2 stop reasons {stop_counts(res_p.per_k[2])}, "
              f"dump {os.path.basename(path)} armed sites "
              f"{sorted(dumped['armed_fault_sites'])}, events "
              f"{len(dumped['events'])}, perf_recent "
              f"{len(dumped['perf_recent'])}", flush=True)
        if fired != 1 or int(stops[1]) != 5 \
                or "solve.nonfinite" not in dumped["armed_fault_sites"]:
            raise AssertionError("obs 9c: no fire event, no quarantine, or "
                                 "the dump misses the armed site")

    # d. the job grid on the card
    res_d, wall_d = counted("d keep_factors", lambda: sweep(
        bundled, BUNDLED_KS, BUNDLED_RESTARTS, keep_factors=True))
    by_k = nmfx_torch.reduce_grid(res_d, by="k")
    dk = max(float(np.abs(by_k[k] - res_d.per_k[k].consensus).max())
             for k in BUNDLED_KS)
    by_r = nmfx_torch.reduce_grid(res_d, by="restart")
    shapes = sorted({v.shape for v in by_r.values()})
    mean_w = nmfx_torch.reduce_grid(
        res_d, lambda cells: np.mean([c.w for c in cells], axis=0))
    dw = max(float(np.abs(mean_w[k] - res_d.per_k[k].all_w.mean(axis=0))
                   .max()) for k in BUNDLED_KS)
    example, wall_ex = counted("d run_example", lambda: nmfx_torch.run_example(
        outdir=None, device=device))
    a_dev = torch.as_tensor(bundled, dtype=torch.float32,
                            device="cuda" if on_card else "cpu")
    key = _random.fold_in(_random.key(123), 2)
    kw_out = tsweep.sweep_one_k(
        a_dev, key, k=2, restarts=BUNDLED_RESTARTS, solver_cfg=pallas,
        init_cfg=nmfx_torch.InitConfig(), label_rule="argmax", mesh=None,
        keep_factors=True, grid_slots=48, grid_tail_slots="auto")
    pos_out = tsweep.sweep_one_k(
        a_dev, key, 2, BUNDLED_RESTARTS, pallas, nmfx_torch.InitConfig(),
        "argmax", None, True, 48, "auto")
    same_call = all(same_bytes(x.cpu(), y.cpu()) for x, y in
                    zip(kw_out[:9], pos_out[:9]))
    print(f"obs 9d (keep_factors grid, bundled 1000x40): wall "
          f"{wall_d:.3f} s; reduce_grid by k max|dC| {dk:.3e}; by restart "
          f"{len(by_r)} groups of {shapes}; mean W max|d| {dw:.3e}; "
          f"run_example {wall_ex:.3f} s best k {example.best_k}; "
          f"sweep_one_k with the reference's keywords: all_w "
          f"{tuple(kw_out.all_w.shape)}, positional call byte-equal "
          f"{same_call}", flush=True)
    if dk > 1e-6 or len(by_r) != BUNDLED_RESTARTS or shapes != [(bn, bn)] \
            or dw > 1e-6 or example.best_k != 2 or not same_call \
            or tuple(kw_out.all_w.shape) != (BUNDLED_RESTARTS,
                                             bundled.shape[0], 2):
        raise AssertionError("obs 9d: the job grid disagrees")
    return launches


#: phase 10: nmfx's submit defaults (ks 2..5, 10 restarts), the packed
#: requests' seeds (10a), the traffic burst's (10c), the hals pair's (10b)
SERVE_KS, SERVE_RESTARTS = (2, 3, 4, 5), 10
#: (the burst cut from 8 requests to 6 to pay for phase 15, and to 4 to
#: pay for phase 16: pack=False served 8 in 25.136 s and 6 in 14.753 s on
#: one H100)
SERVE_SEEDS, TRAFFIC_SEEDS, HALS_SEEDS = (1, 2, 3, 4), tuple(range(11, 15)), \
    (5, 6)
#: phase 10d: the deadline clamp's rate estimate (iterations a second)
#: and timeout: 4 x 600 s rounds up to a budget of 4096 < 10000
CLAMP_RATE, CLAMP_TIMEOUT_S = 4.0, 600.0
#: every served future's bound (a hang fails the phase, never the call)
SERVE_TIMEOUT_S = 120.0
#: phase 10e: two requests of different largest rank in one pool
#: (seed, ks); the first's lane width is its solo run's
MIXED_REQS = ((7, (2, 3, 4, 5)), (8, (2, 3)))


def mixed_rank_pack(torch, cache, a, scfg, reqs=MIXED_REQS,
                    restarts=SERVE_RESTARTS):
    """Pack requests of different largest rank into one pool through
    the server's packed builder, as its ExecCacheEngine.dispatch_packed
    would, and hold each (seed, k) group against the same rank of the
    request's solo bucketed sweep: {(seed, k): {field: max abs
    difference} over the output fields that are not byte-equal}."""
    import nmfx_torch
    from nmfx_torch import random as rnd
    from nmfx_torch.exec_cache import _unpad
    from nmfx_torch.ops.packed_mu import flip_budget
    from nmfx_torch.sweep import _build_packed_serve_fn

    ccfgs = {seed: nmfx_torch.ConsensusConfig(ks=ks, restarts=restarts,
                                              seed=seed)
             for seed, ks in reqs}
    c0 = next(iter(ccfgs.values()))
    placed = cache.prefetch(a, scfg)
    groups = sorted(((k, seed) for seed, ks in reqs for k in ks),
                    key=lambda g: -g[0])
    fn = _build_packed_serve_fn(
        tuple((k, restarts) for k, _ in groups), scfg, c0.label_rule,
        c0.grid_slots, c0.grid_tail_slots, placed.bucket,
        nmfx_torch.InitConfig())
    roots = np.stack([rnd.fold_in(rnd.key(seed), k) for k, seed in groups])
    m, n = placed.true_shape
    outs = fn(placed.a_pad, roots, m, n, flip_budget(scfg.class_flip_tol, n))
    solo = {seed: cache.run_sweep(placed, c, scfg)
            for seed, c in ccfgs.items()}
    fields = ("consensus", "iterations", "dnorms", "stop_reasons", "labels",
              "best_w", "best_h")
    parted = {}
    for (k, seed), out in zip(groups, outs):
        out, ref = _unpad(out, m, n), solo[seed][k]
        if not bool(torch.isfinite(out.consensus).all()):
            raise AssertionError(f"serve 10e: seed {seed} k = {k} not finite")
        parted[(seed, k)] = {
            f: float((getattr(out, f).double()
                      - getattr(ref, f).double()).abs().max())
            for f in fields
            if not torch.equal(getattr(out, f), getattr(ref, f))}
    return parted


def e2e_quantiles(snap, metrics, q=(0.5, 0.95)):
    """p50/p95 of nmfx_serve_e2e_seconds{outcome="completed"} over a
    server's window (its stats_snapshot delta), bucket-interpolated."""
    rec = snap["nmfx_serve_e2e_seconds"]
    state = rec["series"].get(("completed",))
    buckets = metrics.registry().get("nmfx_serve_e2e_seconds").buckets
    return [None if state is None else
            metrics.bucket_quantile(buckets, state, x) for x in q]


def phase_serve(torch, fm, *, a=None, bundled=None, ks=SERVE_KS,
                restarts=SERVE_RESTARTS, device=None):
    """Phase 10, the serving tier (nmfx_torch.serve): a. four north-star
    mu requests packed into one dispatch on row 3, each byte-equal to
    its solo nmfconsensus(exec_cache=) run, one held to the plain
    nmfconsensus at the agreement tier; b. two hals requests packed on
    row 5, each byte-equal to its solo run; c. a burst of four requests
    to a packing server and to a pack=False one (walls, requests/s, e2e
    p50/p95, queue wait, dispatches, packing efficiency, launches),
    every packed result byte-equal to its pack=False twin; d. the
    policies on the bundled design: the result cache's warm hit (no
    dispatch, no byte to the card), coalescing, spill and readmit, a
    crashed scheduler and its fresh successor, the deadline clamp; e.
    requests of different largest rank in one pool through the packed
    builder, mu and hals, each group against its solo run (printed; the
    request at its solo lane width must be byte-equal). Returns the
    launches of each run by name."""
    import tempfile

    import nmfx_torch
    from nmfx_torch import data_cache, faults
    from nmfx_torch import serve
    from nmfx_torch.datasets import two_group_matrix
    from nmfx_torch.exec_cache import compile_count
    from nmfx_torch.obs import metrics

    a = north_star_matrix() if a is None else a
    bundled = (two_group_matrix(n_genes=1000, n_per_group=20, seed=123)
               if bundled is None else bundled)
    n = a.shape[1]
    on_card = device is None
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    pallas = nmfx_torch.SolverConfig(backend="pallas")
    hals = nmfx_torch.SolverConfig(algorithm="hals", backend="pallas")
    row3, row5 = "fused_block_iterations", "hals_block_iterations"
    launches = {}
    kw = dict(ks=ks, restarts=restarts)

    def counted(label, fn):
        fm.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        sync()
        wall = time.perf_counter() - t0
        launches[label] = {k: v for k, v in fm.LAUNCHES.items() if v}
        return res, wall

    def solo(cache, data, seed, scfg, **extra):
        return nmfx_torch.nmfconsensus(data, seed=seed, solver_cfg=scfg,
                                       exec_cache=cache, device=device,
                                       **{**kw, **extra})

    def served(srv_cfg, cache, data, seeds, scfg, **extra):
        """Submit one request a seed to a paused server, then resume:
        (results, futures, stats, stats_snapshot)."""
        with serve.NMFXServer(srv_cfg, exec_cache=cache,
                              start=False) as srv:
            futs = [srv.submit(data, seed=s, solver_cfg=scfg,
                               **{**kw, **extra}) for s in seeds]
            srv.resume()
            res = [f.result(timeout=SERVE_TIMEOUT_S) for f in futs]
            stats, snap = srv.stats(), srv.stats_snapshot()
        return res, futs, stats, snap

    # a. four north-star mu requests in one packed dispatch on row 3
    cache = nmfx_torch.ExecCache(device=device)
    p0, c0 = serve.packed_dispatch_count(), compile_count()
    (res_a, futs_a, st_a, _), wall_a = counted("a packed", lambda: served(
        serve.ServeConfig(max_batch_requests=4), cache, a, SERVE_SEEDS,
        pallas))
    la = launches["a packed"].get(row3, 0)
    packed_a = serve.packed_dispatch_count() - p0
    solos, same = [], []
    t0 = time.perf_counter()
    for s, r in zip(SERVE_SEEDS, res_a):
        solos.append(solo(cache, a, s, pallas))
        same.append(results_byte_equal(r, solos[-1], KRESULT_FIELDS))
    sync()
    wall_solo = time.perf_counter() - t0
    plain, wall_plain = counted("a plain", lambda: nmfx_torch.nmfconsensus(
        a, seed=SERVE_SEEDS[0], solver_cfg=pallas, device=device, **kw))
    agree = (plain.best_k == res_a[0].best_k and np.array_equal(
        plain.per_k[ks[0]].membership, res_a[0].per_k[ks[0]].membership))
    plain_equal = results_byte_equal(plain, res_a[0], KRESULT_FIELDS)
    means = {k: (float(res_a[0].per_k[k].iterations.mean()),
                 float(plain.per_k[k].iterations.mean())) for k in ks}
    print(f"serve 10a (north star {a.shape[0]}x{n}, bucket "
          f"{cache.bucket_shape(*a.shape)}, {len(SERVE_SEEDS)} mu requests "
          f"of ks {ks[0]}..{ks[-1]} x {restarts} restarts, pallas): wall "
          f"{wall_a:.3f} s, packed dispatches {packed_a}, packed requests "
          f"{st_a['packed_requests']}, lanes {st_a['total_lanes']}, row 3 "
          f"launches {la}, launches {launches['a packed']}, builds "
          f"{compile_count() - c0}; each byte-equal to its solo "
          f"nmfconsensus(exec_cache=) run {same} (4 solo runs "
          f"{wall_solo:.3f} s); best k {[r.best_k for r in res_a]}",
          flush=True)
    print(f"serve 10a against the plain nmfconsensus (seed "
          f"{SERVE_SEEDS[0]}, {wall_plain:.3f} s): best k {res_a[0].best_k}"
          f" / {plain.best_k}, k = {ks[0]} memberships equal {agree}, "
          f"byte-equal {plain_equal}; per-k mean iterations bucketed / "
          f"plain { {k: (round(x, 1), round(y, 1)) for k, (x, y) in means.items()} }",
          flush=True)
    if packed_a != 1 or st_a["packed_requests"] != len(SERVE_SEEDS) \
            or not all(same) or not agree or (on_card and not la):
        raise AssertionError(
            f"serve 10a: packed {packed_a}, requests "
            f"{st_a['packed_requests']}, byte-equal {same}, agreement "
            f"{agree}, row 3 launches {la}")
    for r in res_a:
        check_finite(r, "serve 10a", n)

    # b. two hals requests packed on row 5
    p0 = serve.packed_dispatch_count()
    (res_b, _, st_b, _), wall_b = counted("b hals", lambda: served(
        serve.ServeConfig(), cache, a, HALS_SEEDS, hals))
    lb = launches["b hals"].get(row5, 0)
    same_b = [results_byte_equal(r, solo(cache, a, s, hals), KRESULT_FIELDS)
              for s, r in zip(HALS_SEEDS, res_b)]
    print(f"serve 10b (hals, pallas, {len(HALS_SEEDS)} requests): wall "
          f"{wall_b:.3f} s, packed dispatches "
          f"{serve.packed_dispatch_count() - p0}, packed requests "
          f"{st_b['packed_requests']}, row 5 launches {lb}, launches "
          f"{launches['b hals']}; each byte-equal to its solo run "
          f"{same_b}; best k {[r.best_k for r in res_b]}", flush=True)
    if st_b["packed_requests"] != len(HALS_SEEDS) or not all(same_b) \
            or (on_card and not lb):
        raise AssertionError(f"serve 10b: packed requests "
                             f"{st_b['packed_requests']}, byte-equal "
                             f"{same_b}, row 5 launches {lb}")

    # c. a burst of requests, packed against pack=False
    burst = {}
    for label, pack in (("packed", True), ("pack=False", False)):
        (res, futs, st, snap), wall = counted(f"c {label}", lambda: served(
            serve.ServeConfig(pack=pack), cache, a, TRAFFIC_SEEDS, pallas))
        p50, p95 = e2e_quantiles(snap, metrics)
        lat = [f.stats.latency_s for f in futs]
        qw = [f.stats.queue_wait_s for f in futs]
        burst[label] = res
        print(f"serve 10c ({label}, {len(TRAFFIC_SEEDS)} requests at once):"
              f" wall {wall:.3f} s, {len(TRAFFIC_SEEDS) / wall:.4f} "
              f"requests/s, e2e p50 {p50:.3f} s p95 {p95:.3f} s (histogram"
              f"; exact {float(np.percentile(lat, 50)):.3f} / "
              f"{float(np.percentile(lat, 95)):.3f} s), mean queue wait "
              f"{float(np.mean(qw)):.3f} s, dispatches {st['dispatches']}, "
              f"packing efficiency {st['packing_efficiency']}, row 3 "
              f"launches {launches[f'c {label}'].get(row3, 0)}", flush=True)
    same_c = [results_byte_equal(x, y, KRESULT_FIELDS)
              for x, y in zip(burst["packed"], burst["pack=False"])]
    print(f"serve 10c: every packed result byte-equal to its pack=False "
          f"twin {same_c}; card: {smi()}", flush=True)
    if not all(same_c):
        raise AssertionError(f"serve 10c: packed against pack=False "
                             f"{same_c}")

    # d. the policies, on the bundled design
    small = dict(ks=(2, 3, 4, 5), restarts=10)
    bcache = nmfx_torch.ExecCache(device=device)

    def bsolo(seed, scfg=pallas):
        return nmfx_torch.nmfconsensus(bundled, seed=seed, solver_cfg=scfg,
                                       exec_cache=bcache, device=device,
                                       **small)

    with tempfile.TemporaryDirectory(prefix=".serve_smoke_",
                                     dir=HERE) as root:
        cfg = serve.ServeConfig(result_cache_dir=os.path.join(root, "rc"))
        with serve.NMFXServer(cfg, exec_cache=bcache) as srv:
            first = srv.submit(bundled, seed=21, solver_cfg=pallas,
                               **small).result(timeout=SERVE_TIMEOUT_S)
            d0, t0_, b0 = (serve.dispatch_count(),
                           data_cache.transfer_count(),
                           data_cache.h2d_bytes())
            fm.reset_launch_counts()
            hit = srv.submit(bundled, seed=21, solver_cfg=pallas,
                             **small).result(timeout=SERVE_TIMEOUT_S)
            moved = (serve.dispatch_count() - d0,
                     data_cache.transfer_count() - t0_,
                     data_cache.h2d_bytes() - b0, sum(fm.LAUNCHES.values()))
            hits = srv.stats()["result_cache_hits"]
        same_hit = results_byte_equal(hit, first, KRESULT_FIELDS)
        print(f"serve 10d result cache: warm hit {hits}, dispatches / "
              f"copies / bytes to the card / launches {moved}, byte-equal "
              f"{same_hit}", flush=True)
        if hits != 1 or any(moved) or not same_hit:
            raise AssertionError("serve 10d: the warm hit did work")

        d0 = serve.dispatch_count()
        with serve.NMFXServer(serve.ServeConfig(coalesce_requests=True),
                              exec_cache=bcache, start=False) as srv:
            futs = [srv.submit(bundled, seed=22, solver_cfg=pallas,
                               **small) for _ in range(3)]
            srv.resume()
            res = [f.result(timeout=SERVE_TIMEOUT_S) for f in futs]
            st = srv.stats()
        n_disp = serve.dispatch_count() - d0
        print(f"serve 10d coalescing: 3 identical requests, dispatches "
              f"{n_disp}, coalesced {st['coalesced']}, one result "
              f"{res[1] is res[0] and res[2] is res[0]}", flush=True)
        if n_disp != 1 or st["coalesced"] != 2:
            raise AssertionError("serve 10d: coalescing dispatched more "
                                 "than once")

        spill = os.path.join(root, "spill")
        srv = serve.NMFXServer(serve.ServeConfig(spill_dir=spill),
                               exec_cache=bcache, start=False)
        f = srv.submit(bundled, seed=23, solver_cfg=pallas, **small)
        srv.close(cancel_pending=True)
        try:
            f.result(timeout=SERVE_TIMEOUT_S)
            raise AssertionError("serve 10d: the spilled request resolved")
        except serve.ServerClosed:
            pass
        with serve.NMFXServer(serve.ServeConfig(spill_dir=spill),
                              exec_cache=bcache) as srv:
            readmitted = [fu.result(timeout=SERVE_TIMEOUT_S)
                          for fu in srv.readmit()]
        same_spill = (len(readmitted) == 1 and results_byte_equal(
            readmitted[0], bsolo(23), KRESULT_FIELDS))
        print(f"serve 10d spill: {len(readmitted)} readmitted, byte-equal "
              f"to the solo run {same_spill}", flush=True)
        if not same_spill:
            raise AssertionError("serve 10d: spill and readmit")

    faults.arm("serve.scheduler", every=1, max_fires=1)
    try:
        with serve.NMFXServer(serve.ServeConfig(watchdog_interval_s=0.05),
                              exec_cache=bcache) as srv:
            f = srv.submit(bundled, seed=24, solver_cfg=pallas, **small)
            try:
                f.result(timeout=SERVE_TIMEOUT_S)
                crashed = None
            except serve.ServerCrashed as e:
                crashed = e
            after = srv.submit(bundled, seed=24, solver_cfg=pallas,
                               **small).result(timeout=SERVE_TIMEOUT_S)
    finally:
        faults.disarm("serve.scheduler")
    same_crash = results_byte_equal(after, bsolo(24), KRESULT_FIELDS)
    print(f"serve 10d scheduler crash: pending request failed "
          f"{type(crashed).__name__} (cause "
          f"{type(getattr(crashed, '__cause__', None)).__name__}), the "
          f"fresh scheduler's result byte-equal to the solo run "
          f"{same_crash}", flush=True)
    if crashed is None or not same_crash:
        raise AssertionError("serve 10d: scheduler crash and restart")

    fm.reset_launch_counts()
    with serve.NMFXServer(serve.ServeConfig(iter_rate_estimate=CLAMP_RATE),
                          exec_cache=bcache) as srv:
        fut = srv.submit(bundled, seed=25, solver_cfg=pallas,
                         timeout=CLAMP_TIMEOUT_S, **small)
        got = fut.result(timeout=SERVE_TIMEOUT_S)
    launches["d clamped"] = {k: v for k, v in fm.LAUNCHES.items() if v}
    budget = fut.stats.budget_iters
    ref = bsolo(25, nmfx_torch.SolverConfig(backend="pallas",
                                            max_iter=budget or 1))
    same_clamp = budget is not None and results_byte_equal(
        got, ref, KRESULT_FIELDS)
    print(f"serve 10d deadline clamp: budget {budget} iterations "
          f"(max_iter {pallas.max_iter}), launches "
          f"{launches['d clamped']}, byte-equal to the solo run at "
          f"max_iter {budget}: {same_clamp}", flush=True)
    if budget is None or budget >= pallas.max_iter or not same_clamp:
        raise AssertionError("serve 10d: the deadline clamp")

    # e. mixed largest ranks in one pool, each group against its solo run
    for label, scfg, row in (("mu", pallas, row3), ("hals", hals, row5)):
        parted, wall = counted(f"e mixed {label}", lambda: mixed_rank_pack(
            torch, cache, a, scfg))
        print(f"serve 10e mixed largest ranks ({label}, "
              f"{' beside '.join(str(ks) for _, ks in MIXED_REQS)}): wall "
              f"{wall:.3f} s with the solo runs, {row} launches "
              f"{launches[f'e mixed {label}'].get(row, 0)}; fields parted "
              f"from the solo run by (seed, k), {{}} = byte-equal "
              f"{parted}", flush=True)
        control = MIXED_REQS[0][0]
        if any(d for (seed, _), d in parted.items() if seed == control) \
                or (on_card and not launches[f"e mixed {label}"].get(row)):
            raise AssertionError(f"serve 10e ({label}): the request at its "
                                 f"solo lane width parted {parted}")
    return launches



#: phase 11: the command line's sweep (11a), the routed requests (11b:
#: mu seeds on the north star and on the second matrix, then hals),
#: the SIGKILL rehearsal's seeds on the bundled design (11c)
FLEET_KS, FLEET_RESTARTS = (2, 3, 4, 5), 10
FLEET_MU_SEEDS, FLEET_HALS_SEED, FLEET_KILL_SEEDS = (1, 2), 5, (31, 32, 33)
#: every routed future's bound, and the process replicas' first
#: heartbeat's (a hang fails the phase, never the call)
FLEET_TIMEOUT_S, FLEET_SPAWN_TIMEOUT_S = 120.0, 120.0
#: the output files the command line and save_results write, compared
#: byte for byte (GCTs, cophenetic.txt and the rank table)
FLEET_OUTPUTS = tuple(
    [f"consensus.k.{k}.gct" for k in FLEET_KS]
    + [f"consensus.matrix.k.{k}.gct" for k in FLEET_KS]
    + [f"metagenes.k.{k}.gct" for k in FLEET_KS]
    + ["membership.gct", "cophenetic.txt", "rank_metrics.txt"])


def same_files(d1, d2, names) -> dict:
    """{name: byte-equal} of the named files in two directories."""
    out = {}
    for name in names:
        with open(os.path.join(d1, name), "rb") as f1, \
                open(os.path.join(d2, name), "rb") as f2:
            out[name] = f1.read() == f2.read()
    return out


def second_matrix(router, a, shape):
    """A second north-star-shaped two-group matrix whose rendezvous
    hash places it on another replica than ``a``'s (seeds 124, 125, ...
    until one does): (matrix, its seed, a's replica, its replica)."""
    import hashlib

    from nmfx_torch.datasets import two_group_matrix

    def sticky(x):
        chash = hashlib.sha256(np.ascontiguousarray(x).view(np.uint8)
                               .reshape(-1)).hexdigest()
        return max((rep.replica_id for rep in router.pool.routable()),
                   key=lambda rid: router._hrw(chash, rid))

    first = sticky(a)
    m, n = shape
    for seed in range(124, 164):
        b = two_group_matrix(n_genes=m, n_per_group=n // 2, seed=seed)
        if sticky(b) != first:
            return b, seed, first, sticky(b)
    raise AssertionError("fleet 11b: no second matrix on another replica")


def phase_fleet(torch, fm):
    """Phase 11, the fleet tier and the command line: a. python -m
    nmfx_torch on the north star written as a GCT (ks 2..5, 10 restarts,
    backend pallas) against the same file through read_gct,
    nmfconsensus and save_results in this process, output files
    byte-equal; b. a router over two thread replicas sharing one
    ExecCache (the 5120x512 bucket): two mu requests of the north star
    and two of a second matrix placed on the other replica, then a hals
    request, each byte-equal to its solo nmfconsensus(exec_cache=) run;
    c. a router over two process replicas on the card (their spawn to
    first heartbeat timed), three mu requests of the bundled design on
    the sticky replica, which is SIGKILLed right after the submits:
    every future resolves byte-equal to the in-process kernel run of
    its request, the router recovered the replica and readmitted its
    requests; d. python -m nmfx_torch.obs.top --once over c's telemetry
    directory renders the replica role. Returns the launches of each
    in-process run by name (a process replica's launches are its
    child's: the byte-equality to the kernel runs is the proof, and
    those runs must have launched row 3)."""
    import tempfile

    import nmfx_torch
    from nmfx_torch import replica, router as router_mod
    from nmfx_torch.datasets import two_group_matrix
    from nmfx_torch.io import read_gct, write_gct

    a = north_star_matrix()
    bundled = two_group_matrix(n_genes=1000, n_per_group=20, seed=123)
    m, n = a.shape
    pallas = nmfx_torch.SolverConfig(backend="pallas")
    hals = nmfx_torch.SolverConfig(algorithm="hals", backend="pallas")
    row3, row5 = "fused_block_iterations", "hals_block_iterations"
    kw = dict(ks=FLEET_KS, restarts=FLEET_RESTARTS)
    launches = {}
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))

    def counted(label, fn):
        fm.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        launches[label] = {k: v for k, v in fm.LAUNCHES.items() if v}
        return res, time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix=".fleet_smoke_",
                                     dir=HERE) as root:
        # a. the command line against the in-process pipeline
        gct = os.path.join(root, "north_star.gct")
        write_gct(a, gct, row_names=[f"g{i}" for i in range(m)],
                  col_names=[f"s{i}" for i in range(n)])
        cli_dir, lib_dir = (os.path.join(root, d) for d in ("cli", "lib"))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "nmfx_torch", gct, "--ks",
             f"{FLEET_KS[0]}-{FLEET_KS[-1]}", "--restarts",
             str(FLEET_RESTARTS), "--backend", "pallas", "--outdir",
             cli_dir], env=env, capture_output=True, text=True,
            timeout=FLEET_TIMEOUT_S)
        cli_wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"fleet 11a: the command line failed "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")

        def in_process():
            res = nmfx_torch.nmfconsensus(read_gct(gct), solver_cfg=pallas,
                                          **kw)
            nmfx_torch.save_results(
                res, nmfx_torch.OutputConfig(directory=lib_dir))
            return res

        res_a, wall_a = counted("a in-process", in_process)
        same_a = same_files(cli_dir, lib_dir, FLEET_OUTPUTS)
        cli_best = proc.stdout.split("best k = ")[-1].split()[0]
        print(f"fleet 11a command line (python -m nmfx_torch, {m}x{n} GCT, "
              f"ks {FLEET_KS[0]}..{FLEET_KS[-1]} x {FLEET_RESTARTS} "
              f"restarts, pallas): wall {cli_wall:.3f} s with the "
              f"interpreter's start, best k {cli_best}; in-process "
              f"read_gct/nmfconsensus/save_results {wall_a:.3f} s, best k "
              f"{res_a.best_k}, row 3 launches "
              f"{launches['a in-process'].get(row3, 0)}; {len(same_a)} "
              f"output files byte-equal {all(same_a.values())}",
              flush=True)
        if not all(same_a.values()) or cli_best != str(res_a.best_k) \
                or not launches["a in-process"].get(row3):
            raise AssertionError(f"fleet 11a: {same_a}, best k {cli_best}"
                                 f" / {res_a.best_k}")

        # b. two thread replicas on the card behind a router
        cache = nmfx_torch.ExecCache()
        pool = replica.ReplicaPool(2, root=os.path.join(root, "threads"),
                                   mode="thread", exec_cache=cache)
        with router_mod.NMFXRouter(pool) as router:
            b, b_seed, rep_a, rep_b = second_matrix(router, a, (m, n))
            reqs = ([(a, s, pallas) for s in FLEET_MU_SEEDS]
                    + [(b, s, pallas) for s in FLEET_MU_SEEDS]
                    + [(a, FLEET_HALS_SEED, hals)])

            def routed():
                futs = [router.submit(x, seed=s, solver_cfg=c, **kw)
                        for x, s, c in reqs]
                return [f.result(timeout=FLEET_TIMEOUT_S) for f in futs], \
                    futs

            (res_b, futs_b), wall_b = counted("b routed", routed)
            stats_b = router.stats()
        same_b = []
        for (x, s, c), r in zip(reqs, res_b):
            solo = nmfx_torch.nmfconsensus(x, seed=s, solver_cfg=c,
                                           exec_cache=cache, **kw)
            same_b.append(results_byte_equal(r, solo, KRESULT_FIELDS))
        placed = [f.stats.replica for f in futs_b]
        print(f"fleet 11b thread replicas (2, one ExecCache, bucket "
              f"{cache.bucket_shape(m, n)}): the north star on {rep_a}, "
              f"two_group_matrix seed {b_seed} on {rep_b}; "
              f"{len(reqs)} requests (4 mu, 1 hals) wall {wall_b:.3f} s, "
              f"replicas {placed}, row 3 launches "
              f"{launches['b routed'].get(row3, 0)}, row 5 launches "
              f"{launches['b routed'].get(row5, 0)}; each byte-equal to "
              f"its solo run {same_b}; router completed "
              f"{stats_b['completed']} failed {stats_b['failed']}",
              flush=True)
        if not all(same_b) or len(set(placed)) != 2 \
                or not (launches["b routed"].get(row3)
                        and launches["b routed"].get(row5)) \
                or stats_b["completed"] != len(reqs):
            raise AssertionError(f"fleet 11b: byte-equal {same_b}, "
                                 f"replicas {placed}")

        # c. two process replicas on the card, one SIGKILLed
        tdir = os.path.join(root, "telemetry")
        os.environ["NMFX_REPLICA_WORKER_STDERR"] = "1"
        t0 = time.perf_counter()
        try:
            pool = replica.ReplicaPool(2, root=os.path.join(root, "procs"),
                                       mode="process", telemetry_dir=tdir,
                                       env=env)
        finally:
            del os.environ["NMFX_REPLICA_WORKER_STDERR"]
        spawned = {}
        while len(spawned) < 2:
            beats = pool.heartbeats()
            for rep in pool.all():
                hb = beats.get(rep.replica_id)
                if hb is not None and hb.get("pid") == rep.pid \
                        and rep.replica_id not in spawned:
                    spawned[rep.replica_id] = time.perf_counter() - t0
            dead = [rep.process.returncode for rep in pool.all()
                    if not rep.alive()]
            if dead or time.perf_counter() - t0 > FLEET_SPAWN_TIMEOUT_S:
                pool.close()
                raise AssertionError(f"fleet 11c: heartbeats {spawned}, "
                                     f"exited workers' codes {dead}")
            time.sleep(0.05)
        cfg = router_mod.RouterConfig(stickiness_slack=8)
        t0 = time.perf_counter()
        with router_mod.NMFXRouter(pool, cfg) as router:
            futs = [router.submit(bundled, seed=s, solver_cfg=pallas, **kw)
                    for s in FLEET_KILL_SEEDS]
            victim = futs[0].stats.replica
            on_victim = [f.stats.replica == victim for f in futs]
            pool.get(victim).kill()
            res_c = [f.result(timeout=FLEET_TIMEOUT_S) for f in futs]
            stats_c = router.stats()
        wall_c = time.perf_counter() - t0
        bcache = nmfx_torch.ExecCache()
        refs, wall_ref = counted("c in-process", lambda: [
            nmfx_torch.nmfconsensus(bundled, seed=s, solver_cfg=pallas,
                                    exec_cache=bcache, **kw)
            for s in FLEET_KILL_SEEDS])
        same_c = [results_byte_equal(r, ref, KRESULT_FIELDS)
                  for r, ref in zip(res_c, refs)]
        print(f"fleet 11c process replicas (2, on the card): spawn to first "
              f"heartbeat {[round(x, 3) for x in spawned.values()]} s; 3 mu "
              f"requests of the bundled design on {victim} (all there "
              f"{all(on_victim)}), SIGKILLed after the submits; wall "
              f"{wall_c:.3f} s, served by "
              f"{[f.stats.replica for f in futs]}, retried "
              f"{[f.stats.retried for f in futs]}; router recovered "
              f"{stats_c['recovered']} readmitted {stats_c['readmitted']} "
              f"completed {stats_c['completed']} failed "
              f"{stats_c['failed']}; each byte-equal to the in-process "
              f"kernel run {same_c} (those runs {wall_ref:.3f} s, row 3 "
              f"launches {launches['c in-process'].get(row3, 0)})",
              flush=True)
        if not all(same_c) or not all(on_victim) \
                or not launches["c in-process"].get(row3) \
                or stats_c["recovered"] != 1 \
                or stats_c["readmitted"] < 1 \
                or stats_c["completed"] != len(FLEET_KILL_SEEDS) \
                or stats_c["failed"] != 0:
            raise AssertionError(f"fleet 11c: byte-equal {same_c}, "
                                 f"stats {stats_c}")

        # d. nmfx-top over c's telemetry
        proc = subprocess.run(
            [sys.executable, "-m", "nmfx_torch.obs.top", tdir, "--once",
             "--stale-after", "600"], env=env, capture_output=True,
            text=True, timeout=120)
        roles = [line for line in proc.stdout.splitlines()
                 if line.startswith("roles:")]
        print(f"fleet 11d nmfx-top --once over {len(os.listdir(tdir))} "
              f"snapshots: {roles}", flush=True)
        for line in proc.stdout.splitlines()[2:5]:
            print(f"fleet 11d   {line}", flush=True)
        if proc.returncode != 0 or not roles or "replica" not in roles[0]:
            raise AssertionError(f"fleet 11d: {proc.stdout[-1000:]}"
                                 f"{proc.stderr[-1000:]}")
    return launches


# --- phase 12: scale, the out-of-core tiles and sparse ingestion ----------

#: 12a: the north star streamed in 8 tiles of 625 rows (two 625x500
#: float32 tiles fill the budget), mu at ks (2, 3), 50 restarts, max_iter
#: 250 (the JAX package's bench caps its atlas rung at 500; halved to pay
#: for phase 16: 12a's 940 passes took 9.650 s on one H100)
TILE_KS, TILE_RESTARTS, TILE_MAX_ITER = (2, 3), 50, 250
TILE_BUDGET = 2 * 625 * 500 * 4
TILE_PASS_BYTES = 5000 * 500 * 4
#: 12b: a sparse atlas of 20,000 genes x 5,000 cells at 5 % density
#: (about 5.0 M stored nonzeros), a planted k = 4, mu at ks 2..4 (cut
#: from 2..5 to pay for phase 14: k = 5 ran every lane to the
#: 500-iteration cap), 10 restarts (the reference's default; cut from 20
#: to keep the script near its time budget), 4 tiles of 5,000 rows
ATLAS = dict(m=20000, n=5000, k=4, density=0.05, seed=11)
ATLAS_KS, ATLAS_RESTARTS, ATLAS_TILE_ROWS = (2, 3, 4), 10, 5000
#: the JAX package's gates of a tiled (or sparse) sweep against its
#: in-core (or densified) twin (tests/test_tiles.py, tests/test_sparse.py)
TILE_MIN_ARI, TILE_MAX_RHO_GAP = 0.9, 0.1
#: 12e: 10 restarts in ledger chunks of 5 at max_iter 200 (cut from 20 in
#: chunks of 10 at 500: a partial record lands at every check, so its
#: cost is the passes); proc.preempt fires at this many fire calls, the
#: 50th check of the first chunk (step 100)
TILE_CKPT_RESTARTS, TILE_CKPT_CHUNK, TILE_PREEMPT_AT = 10, 5, 50
TILE_CKPT_MAX_ITER = 200
#: 12f: the file design and the command line's depth (the reference's
#: default max_iter of 10000 is cut to 200 to keep the phase in its
#: budget)
FILES = dict(m=2000, n=500, k=3, density=0.05, seed=0)
FILES_TILE_ROWS, FILES_MAX_ITER = 500, 200
KR_FIELDS = ("consensus", "rho", "membership", "order", "iterations",
             "dnorms", "stop_reasons", "best_w", "best_h")


def ranks_byte_equal(x, y, ks) -> bool:
    """The named ranks' results of two runs equal byte for byte."""
    return all(same_bytes(getattr(x.per_k[k], f), getattr(y.per_k[k], f))
               for k in ks for f in KR_FIELDS)


def pinned_copy_rate(torch, nbytes: int, reps: int = 20) -> float:
    """Bytes/s of one pinned host-to-device copy of ``nbytes`` (CUDA
    events around ``reps`` copies after a warm-up)."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    dev.copy_(host, non_blocking=True)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        dev.copy_(host, non_blocking=True)
    end.record()
    end.synchronize()
    return nbytes * reps / (start.elapsed_time(end) / 1e3)


def write_mtx(sp, path: str) -> None:
    """A SparseMatrix as a MatrixMarket coordinate file (1-indexed,
    shortest round-trip values)."""
    rows = np.repeat(np.arange(sp.shape[0]), np.diff(sp.indptr)) + 1
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{sp.shape[0]} {sp.shape[1]} {sp.nnz}\n")
        for r, c, v in zip(rows.tolist(), (sp.indices + 1).tolist(),
                           sp.data.tolist()):
            f.write(f"{r} {c} {v!r}\n")


def phase_tiles(torch, fm):
    """Phase 12, scale: the out-of-core tile pipeline and sparse
    ingestion. a. the north star streamed in 8 tiles (mu, ks (2, 3), 50
    restarts, max_iter 250) against the in-core run of the same sweep
    (the JAX package's tiled-against-dense gate) and its bytes (passes x
    10,000,000 exactly); b. the 20,000 x 5,000 sparse atlas (5 %
    density) in 4 tiles at ks 2..5 against its densified twin in core
    (the same gate, the same best k); c. a at ks (2,) and b at ks (4,)
    with prefetch off, byte-equal to the prefetch-on runs; d. a's matrix
    in one tile, byte-equal to the in-core run; e. a's plan at ks (2,),
    10 restarts in ledger chunks of 5 (max_iter 200), killed by
    proc.preempt at a
    check of the first chunk and resumed mid-matrix: byte-equal to an
    uninterrupted checkpointed run, one partial resume; f. a design
    written as .csr.npz and .mtx reads back to one fingerprint, and
    python -m nmfx_torch on the bundle writes the in-process run's
    files. Every kernel launches 0 times in the phase. Returns the
    launches by run."""
    import tempfile

    import nmfx_torch
    from nmfx_torch import faults, tiles
    from nmfx_torch import checkpoint as ckpt
    from nmfx_torch.agreement import consensus_agreement
    from nmfx_torch.datasets import make_sparse_design
    from nmfx_torch.io import read_csr_npz, read_mtx, write_csr_npz
    from nmfx_torch.profiling import Profiler

    a = north_star_matrix()
    m, n = a.shape
    launches = {}
    mu = dict(algorithm="mu", max_iter=TILE_MAX_ITER)

    def counted(label, fn):
        fm.reset_launch_counts()
        passes0 = tiles._tile_passes_total.total()
        bytes0 = tiles._tile_h2d_bytes_total.total()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[label] = {k: v for k, v in fm.LAUNCHES.items() if v}
        return res, {"wall": wall,
                     "passes": int(tiles._tile_passes_total.total()
                                   - passes0),
                     "bytes": int(tiles._tile_h2d_bytes_total.total()
                                  - bytes0)}

    def streamed(label, data, ks, restarts, scfg, **kw):
        prof = Profiler()

        def run():
            with prof:
                return nmfx_torch.nmfconsensus(
                    data, ks=ks, restarts=restarts, solver_cfg=scfg,
                    profiler=prof, **kw)

        res, st = counted(label, run)
        solve = phase_seconds(prof, "solve.k=")
        wait, xfer = (prof.phases[name].seconds if name in prof.phases
                      else 0.0 for name in (tiles.TILE_WAIT_PHASE,
                                            tiles.TILE_XFER_PHASE))
        st.update(solve=solve, wait=wait, xfer=xfer,
                  overlap=1.0 - wait / solve)
        stops = {k: stop_counts(res.per_k[k]) for k in ks}
        iters = {k: round(float(res.per_k[k].iterations.mean()), 1)
                 for k in ks}
        print(f"tiles {label}: wall {st['wall']:.3f} s, solve "
              f"{solve:.3f} s, passes {st['passes']}, H2D bytes "
              f"{st['bytes']} ({st['bytes'] / max(st['passes'], 1):.0f} "
              f"a pass), staging and dispatch {xfer:.3f} s, waits "
              f"{wait:.3f} s, overlap 1 - wait/solve "
              f"{st['overlap']:.4f}, mean iters {iters}, stop reasons "
              f"{stops}, best k {res.best_k}", flush=True)
        return res, st

    rate = pinned_copy_rate(torch, TILE_PASS_BYTES)
    print(f"tiles pinned host-to-device copy of {TILE_PASS_BYTES} bytes: "
          f"{rate / 1e9:.2f} GB/s", flush=True)

    # a. the north star in 8 tiles against the in-core sweep
    tiles.set_tile_budget_bytes(TILE_BUDGET)
    try:
        tiled_cfg = nmfx_torch.SolverConfig(tile_rows="auto", **mu)
        plan = tiles.plan_for(a, tiled_cfg)
        if plan.n_tiles != 8 or plan.tile_rows != TILE_BUDGET // (8 * n):
            raise AssertionError(f"tiles 12a: plan {plan.as_meta()}")
        res_a, st_a = streamed("12a north star, 8 tiles", a, TILE_KS,
                               TILE_RESTARTS, tiled_cfg)
        dense_a, st_dense = counted("12a in-core", lambda: (
            nmfx_torch.nmfconsensus(a, ks=TILE_KS, restarts=TILE_RESTARTS,
                                    solver_cfg=nmfx_torch.SolverConfig(
                                        **mu))))
        rep = consensus_agreement(res_a, dense_a)
        print(f"tiles 12a against the in-core sweep ({st_dense['wall']:.3f}"
              f" s): min ARI {rep['min_ari']:.4f}, max rho gap "
              f"{rep['max_rho_gap']:.4f}, per k {rep['per_k']}",
              flush=True)
        check_finite(res_a, "tiles 12a", n)
        if rep["min_ari"] < TILE_MIN_ARI or \
                rep["max_rho_gap"] > TILE_MAX_RHO_GAP:
            raise AssertionError(f"tiles 12a: agreement {rep}")
        if st_a["bytes"] != st_a["passes"] * TILE_PASS_BYTES:
            raise AssertionError(
                f"tiles 12a: {st_a['bytes']} H2D bytes for "
                f"{st_a['passes']} passes of {TILE_PASS_BYTES}")

        # b. the sparse atlas against its densified twin
        t0 = time.perf_counter()
        atlas = make_sparse_design(ATLAS["m"], ATLAS["n"], k=ATLAS["k"],
                                   density=ATLAS["density"],
                                   seed=ATLAS["seed"])
        print(f"tiles 12b atlas {atlas.shape}, {atlas.nnz} stored "
              f"nonzeros, density {atlas.density:.4f}, made in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        atlas_cfg = nmfx_torch.SolverConfig(tile_rows=ATLAS_TILE_ROWS, **mu)
        res_b, st_b = streamed("12b sparse atlas, 4 tiles", atlas,
                               ATLAS_KS, ATLAS_RESTARTS, atlas_cfg)
        twin = atlas.toarray(np.float32)
        dense_b, st_twin = counted("12b densified twin", lambda: (
            nmfx_torch.nmfconsensus(twin, ks=ATLAS_KS,
                                    restarts=ATLAS_RESTARTS,
                                    solver_cfg=nmfx_torch.SolverConfig(
                                        **mu))))
        del twin
        rep = consensus_agreement(res_b, dense_b)
        print(f"tiles 12b against the densified twin in core "
              f"({st_twin['wall']:.3f} s): min ARI {rep['min_ari']:.4f}, "
              f"max rho gap {rep['max_rho_gap']:.4f}, best k "
              f"{res_b.best_k} / {dense_b.best_k} (the planted "
              f"{ATLAS['k']}: {res_b.best_k == ATLAS['k']}), per k "
              f"{rep['per_k']}", flush=True)
        check_finite(res_b, "tiles 12b", ATLAS["n"])
        if rep["min_ari"] < TILE_MIN_ARI or \
                rep["max_rho_gap"] > TILE_MAX_RHO_GAP or \
                res_b.best_k != dense_b.best_k:
            raise AssertionError(f"tiles 12b: agreement {rep}, best k "
                                 f"{res_b.best_k} / {dense_b.best_k}")

        # c. prefetch off: byte-equal
        tiles.set_tile_prefetch(False)
        try:
            off_a, st_ca = streamed("12c north star, prefetch off", a,
                                    (2,), TILE_RESTARTS, tiled_cfg)
            off_b, st_cb = streamed("12c sparse atlas, prefetch off",
                                    atlas, (4,), ATLAS_RESTARTS, atlas_cfg)
        finally:
            tiles.set_tile_prefetch(True)
        same_a = ranks_byte_equal(off_a, res_a, (2,))
        same_b = ranks_byte_equal(off_b, res_b, (4,))
        print(f"tiles 12c prefetch off == on: north star k=2 {same_a} "
              f"(solve {st_ca['solve']:.3f} s), atlas k=4 {same_b} "
              f"(solve {st_cb['solve']:.3f} s)", flush=True)
        if not (same_a and same_b):
            raise AssertionError(f"tiles 12c: byte-equal {same_a}, "
                                 f"{same_b}")

        # d. one tile hands the sweep to the in-core path
        one_cfg = nmfx_torch.SolverConfig(tile_rows=m, **mu)
        one, st_d = counted("12d one tile", lambda: nmfx_torch.nmfconsensus(
            a, ks=(2,), restarts=TILE_RESTARTS, solver_cfg=one_cfg))
        incore, _ = counted("12d in-core", lambda: nmfx_torch.nmfconsensus(
            a, ks=(2,), restarts=TILE_RESTARTS,
            solver_cfg=nmfx_torch.SolverConfig(**mu)))
        same_d = ranks_byte_equal(one, incore, (2,))
        print(f"tiles 12d one tile ({st_d['wall']:.3f} s, {st_d['passes']}"
              f" passes) == in-core: {same_d}", flush=True)
        if not same_d or st_d["passes"] != 0:
            raise AssertionError(f"tiles 12d: byte-equal {same_d}, "
                                 f"passes {st_d['passes']}")

        # e. killed mid-matrix, resumed from the partial
        with tempfile.TemporaryDirectory(prefix=".tiles_smoke_",
                                         dir=HERE) as root:
            def ledger(name):
                return nmfx_torch.CheckpointConfig(
                    os.path.join(root, name),
                    every_n_restarts=TILE_CKPT_CHUNK)

            ckpt_cfg = nmfx_torch.SolverConfig(
                tile_rows="auto", max_iter=TILE_CKPT_MAX_ITER)

            def durable(name):
                return nmfx_torch.nmfconsensus(
                    a, ks=(2,), restarts=TILE_CKPT_RESTARTS,
                    solver_cfg=ckpt_cfg, checkpoint=ledger(name))

            whole, st_e = counted("12e uninterrupted",
                                  lambda: durable("whole"))
            resumes0 = tiles._tile_partial_resumes_total.total()
            faults.arm("proc.preempt", every=TILE_PREEMPT_AT, max_fires=1)
            try:
                killed, _ = counted("12e killed", lambda: expect_preempted(
                    lambda: durable("killed"), ckpt))
            finally:
                faults.disarm("proc.preempt")
            left = sorted(os.listdir(os.path.join(root, "killed")))
            resumed, st_r = counted("12e resumed",
                                    lambda: durable("killed"))
            n_resumed = tiles._tile_partial_resumes_total.total() - resumes0
            same_e = ranks_byte_equal(resumed, whole, (2,))
            print(f"tiles 12e uninterrupted {st_e['wall']:.3f} s "
                  f"({st_e['passes']} passes); killed at the "
                  f"{TILE_PREEMPT_AT}th check of chunk 1, left {left}; "
                  f"resumed {st_r['wall']:.3f} s ({st_r['passes']} passes)"
                  f", partial resumes {n_resumed:.0f}, byte-equal {same_e}",
                  flush=True)
            if not same_e or n_resumed != 1:
                raise AssertionError(f"tiles 12e: byte-equal {same_e}, "
                                     f"partial resumes {n_resumed}")
    finally:
        tiles.set_tile_budget_bytes(None)

    # f. files and the command line
    design = make_sparse_design(FILES["m"], FILES["n"], k=FILES["k"],
                                density=FILES["density"],
                                seed=FILES["seed"])
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory(prefix=".tiles_files_",
                                     dir=HERE) as root:
        npz = os.path.join(root, "design.csr.npz")
        mtx = os.path.join(root, "design.mtx")
        write_csr_npz(design, npz)
        write_mtx(design, mtx)
        prints = {design.fingerprint(), read_csr_npz(npz).fingerprint(),
                  read_mtx(mtx).fingerprint()}
        cli_dir, lib_dir = (os.path.join(root, d) for d in ("cli", "lib"))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "nmfx_torch", npz, "--ks", "2-3",
             "--tile-rows", str(FILES_TILE_ROWS), "--maxiter",
             str(FILES_MAX_ITER), "--outdir", cli_dir], env=env,
            capture_output=True, text=True, timeout=300)
        cli_wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"tiles 12f: the command line failed "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")

        def in_process():
            res = nmfx_torch.nmfconsensus(
                npz, ks=(2, 3), solver_cfg=nmfx_torch.SolverConfig(
                    tile_rows=FILES_TILE_ROWS, max_iter=FILES_MAX_ITER))
            nmfx_torch.save_results(
                res, nmfx_torch.OutputConfig(directory=lib_dir))
            return res

        lib, st_f = counted("12f in-process", in_process)
        names = sorted(os.listdir(lib_dir))
        same_f = same_files(cli_dir, lib_dir, names)
        print(f"tiles 12f {design.shape} design, {design.nnz} nonzeros: "
              f".csr.npz and .mtx read back to {len(prints)} fingerprint; "
              f"command line {cli_wall:.3f} s, in-process "
              f"{st_f['wall']:.3f} s ({st_f['passes']} passes), best k "
              f"{lib.best_k}, files byte-equal "
              f"{all(same_f.values())} ({len(names)} files)", flush=True)
        if len(prints) != 1 or sorted(os.listdir(cli_dir)) != names \
                or not all(same_f.values()):
            raise AssertionError(f"tiles 12f: fingerprints {len(prints)}, "
                                 f"files {same_f}")

    launched = {label: n for label, n in launches.items() if n}
    if launched:
        raise AssertionError(f"tiles: kernels launched in phase 12: "
                             f"{launched}")
    return launches



# --- phase 13: the scale engines (the sketched engine, restart
# screening, quality-elastic serving, Lanczos NNDSVD) ------------------

#: the JAX package's agreement gate (tests/test_sketched.py): ARI of the
#: k = 2 memberships against the exact engine, and the rho gap
SKETCH_MIN_ARI, SKETCH_MAX_RHO_GAP = 0.9, 0.12
#: 13a's depth, cut to keep the phase near its 60 s budget: ks 2..3 and
#: max_iter 2000 (from 10000). At full depth (ks 2..10, max_iter 10000;
#: measured on one NVIDIA H100 80GB HBM3 at 700.00 W) mu took
#: 107.165 s and hals 252.830 s: a rank's batch runs until its slowest
#: lane stops, every rank from k = 4 up has a lane at max_iter, and an
#: iteration costs ≈ 1.3 ms (mu) to 3.4 ms (hals) of host dispatch
SKETCH_KS, SKETCH_MAX_ITER = (2, 3), 2000
#: 13b: survivors of the screening pass per rank (of the 50 restarts),
#: the ranks swept (cut from 2..10 for the same budget; 30.266 s and the
#: unscreened route's 39.008 s at ks 2..10 on that H100), and the ranks whose
#: first survivor is held to restart_factors
SCREEN_KEEP, SCREEN_KS, SCREEN_CHECK_KS = 10, (2, 5), (2, 5)
#: 13c: the served request's ranks and budget (the deadline degrades it
#: to the sketched engine, which runs the full budget)
ELASTIC_KS, ELASTIC_MAX_ITER = (2,), 2000
#: 13d: the Lanczos NNDSVD ranks; the factors' band against the dense
#: SVD's is the JAX package's (tests/test_init.py). The north star's
#: σ1/σk ≈ 1077/4.6 past k = 2 (noise components 0.1 % apart): on the Gram
#: operator float32 resolves σ_k only to ≈ eps·(σ1/σk)² (the JAX
#: package's Lanczos misses by 1.4 % at k = 5 and 12 % at k = 10, as the
#: port does at its default ncv, both on the CPU), so float32 at the
#: default ncv is gated at k = 2, and every k in float64 at ncv 250 (half
#: the operator's dimension: 20 steps leave the crowded noise values
#: unconverged in float64 too)
LANCZOS_KS, LANCZOS_BAND, LANCZOS_NCV64 = (2, 5, 10), 5e-3, 250


def no_launch(label, launches):
    if any(launches.values()):
        raise AssertionError(f"{label}: a kernel launched on a route "
                             f"without kernels: {launches}")


def phase_scale_engines(torch, fm, exact):
    """Phase 13: a. mu and hals on the sketched engine at the north star
    (SketchConfig defaults; ``SKETCH_KS``, ``SKETCH_MAX_ITER``), each
    against phase 4's exact result of the
    same algorithm (``exact``: {"mu": 4a, "hals": 4d}): quality tag, best
    k 2, k = 2 ARI >= 0.9 and |d rho| <= 0.12; the sketch draw on the
    card timed alone; the cost model's FLOPs beside the exact family's;
    b. the screened north star (mu, ``SCREEN_KS``, 10 of 50 survivors a
    rank): 10
    survivors and 40 SCREENED a rank, best k 2, a survivor at k = 2 and
    k = 5 against restart_factors (byte-equal if the card gives it, else
    rtol 1e-5 with equal iterations and labels), beside the unscreened
    batched route's wall; c. one NMFXServer(quality_elastic=True) on the
    bundled 1000x40 design: a deadline-pressured request degraded,
    tagged, counted once, with its flight event; the same request on a
    server without quality_elastic exact and clamped; d. Lanczos NNDSVD
    at k = 2, 5, 10 against the dense SVD's factors and values (float32
    at the default ncv gated at k = 2, float64 at ``LANCZOS_NCV64`` at
    every k), and the card's normal draws against the CPU's (words bit-equal, values
    within 1e-6). Every run has the launch counts set to 0 just before
    it and read just after: no kernel lies on these routes. Returns the
    launches by run."""
    import nmfx_torch
    from nmfx_torch import random as R
    from nmfx_torch.agreement import adjusted_rand_index
    from nmfx_torch.datasets import two_group_matrix
    from nmfx_torch.init import nndsvd_init
    from nmfx_torch.obs import costmodel, flight, metrics
    from nmfx_torch.ops.lanczos_svd import truncated_svd
    from nmfx_torch.profiling import Profiler
    from nmfx_torch.serve import NMFXServer, ServeConfig
    from nmfx_torch.solvers import sketched as sk
    from nmfx_torch.solvers.base import StopReason

    m, n, r, _ = NORTH_STAR
    a = north_star_matrix()
    launches = {}
    dev = torch.device("cuda")
    seed = 123

    def counted(label, fn):
        fm.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[label] = {k: v for k, v in fm.LAUNCHES.items() if v}
        return res, wall

    # 13a: the draw alone, every (k, restart) of the north star
    def draw_all():
        out = []
        for k in KS:
            keys = R.split(R.fold_in(R.key(seed), k), r)
            rk = sk.resolve_dim(nmfx_torch.SolverConfig(backend="sketched"),
                                m, n, k)
            out.append(sk.sketch_operators(keys, m, n, rk, torch.float32,
                                           dev))
        return out

    draws, draw_s = counted("13a-draw", draw_all)
    n_normals = sum(x.numel() + y.numel() for x, y in draws)
    on_card = all(x.device.type == y.device.type == "cuda"
                  for x, y in draws)
    del draws
    print(f"scale 13a sketch draw: {n_normals} normals (every rank's 50 "
          f"restarts' L and R) on the card in {draw_s:.4f} s, on the card "
          f"{on_card}, launches {launches['13a-draw']}", flush=True)
    if not on_card:
        raise AssertionError("13a: the sketch operators left the card")
    no_launch("13a draw", launches["13a-draw"])
    for alg in ("mu", "hals"):
        cfg = nmfx_torch.SolverConfig(algorithm=alg, backend="sketched",
                                      max_iter=SKETCH_MAX_ITER)
        prof = Profiler()

        def run():
            with prof:
                return nmfx_torch.nmfconsensus(a, ks=SKETCH_KS, restarts=r,
                                               seed=seed, solver_cfg=cfg,
                                               profiler=prof)

        res, wall = counted(f"13a-{alg}", run)
        check_finite(res, f"13a {alg}", n)
        ref = exact[alg]
        ari = adjusted_rand_index(res.per_k[2].membership,
                                  ref.per_k[2].membership)
        gap = abs(res.per_k[2].rho - ref.per_k[2].rho)
        flops = sum(costmodel.iteration_flops(alg, "sketched", m, n, k, cfg)
                    * float(res.per_k[k].iterations.sum())
                    for k in SKETCH_KS)
        pallas = nmfx_torch.SolverConfig(algorithm=alg, backend="pallas")
        exact_flops = sum(costmodel.iteration_flops(alg, "pallas", m, n, k,
                                                    pallas)
                          * float(ref.per_k[k].iterations.sum())
                          for k in SKETCH_KS)
        solve = phase_seconds(prof, "solve.")
        print(f"scale 13a {alg} sketched (ks {SKETCH_KS}, max_iter "
              f"{SKETCH_MAX_ITER}): wall {wall:.3f} s (solve "
              f"{solve:.3f} s), quality {res.quality}, best k "
              f"{res.best_k} (exact {ref.best_k}), k=2 ARI against phase "
              f"4 {ari:.4f}, |d rho| {gap:.4f}, model FLOPs {flops:.4g} "
              f"against the exact pallas run's {exact_flops:.4g} "
              f"({exact_flops / flops:.2f}x), launches "
              f"{launches[f'13a-{alg}']}", flush=True)
        for k in SKETCH_KS:
            kr = res.per_k[k]
            rk = sk.resolve_dim(cfg, m, n, k)
            fl_sk = costmodel.iteration_flops(alg, "sketched", m, n, k, cfg)
            fl_ex = costmodel.iteration_flops(alg, "pallas", m, n, k, pallas)
            print(f"scale 13a {alg} k={k}: r {rk}, mean iters "
                  f"{kr.iterations.mean():.1f} (exact "
                  f"{ref.per_k[k].iterations.mean():.1f}), max iters "
                  f"{int(kr.iterations.max())}, stop reasons "
                  f"{stop_counts(kr)}, rho {kr.rho:.4f} (exact "
                  f"{ref.per_k[k].rho:.4f}), per-iteration FLOPs "
                  f"{fl_sk:.4g} against {fl_ex:.4g}", flush=True)
        no_launch(f"13a {alg}", launches[f"13a-{alg}"])
        if (res.quality != "sketched" or res.best_k != 2
                or ari < SKETCH_MIN_ARI or gap > SKETCH_MAX_RHO_GAP):
            raise AssertionError(
                f"13a {alg}: quality {res.quality}, best k {res.best_k}, "
                f"ARI {ari:.4f} (>= {SKETCH_MIN_ARI}), |d rho| {gap:.4f} "
                f"(<= {SKETCH_MAX_RHO_GAP})")

    # 13b: the screened north star
    scfg = nmfx_torch.SolverConfig(algorithm="mu", screen=True,
                                   screen_keep=SCREEN_KEEP)
    outs = {}
    res, wall = counted("13b-screened", lambda: nmfx_torch.nmfconsensus(
        a, ks=SCREEN_KS, restarts=r, seed=seed, solver_cfg=scfg,
        on_rank=lambda k, out: outs.setdefault(k, out)))
    check_sweep(res, "13b screened", n)
    counts = {k: (int((res.per_k[k].stop_reasons
                       != int(StopReason.SCREENED)).sum()),
                  int((res.per_k[k].stop_reasons
                       == int(StopReason.SCREENED)).sum())) for k in SCREEN_KS}
    vmap, vwall = counted("13b-batched", lambda: nmfx_torch.nmfconsensus(
        a, ks=SCREEN_KS, restarts=r, seed=seed,
        solver_cfg=nmfx_torch.SolverConfig(algorithm="mu", backend="vmap")))
    check_sweep(vmap, "13b unscreened batched", n)
    print(f"scale 13b screened (mu, ks {SCREEN_KS}, keep {SCREEN_KEEP} of "
          f"{r}): wall "
          f"{wall:.3f} s beside the unscreened batched route's "
          f"{vwall:.3f} s, best k {res.best_k} (unscreened "
          f"{vmap.best_k}), survivors and SCREENED per k {counts}, mean "
          "survivor iters per k "
          + str({k: round(float(res.per_k[k].iterations[
              res.per_k[k].stop_reasons != int(StopReason.SCREENED)]
              .mean()), 1) for k in SCREEN_KS})
          + f", launches {launches['13b-screened']} / "
          f"{launches['13b-batched']}", flush=True)
    no_launch("13b screened", launches["13b-screened"])
    no_launch("13b batched", launches["13b-batched"])
    bad = {k: c for k, c in counts.items() if c != (SCREEN_KEEP,
                                                   r - SCREEN_KEEP)}
    if bad:
        raise AssertionError(f"13b: survivors / SCREENED per k {bad}")
    for k in SCREEN_CHECK_KS:
        stops = res.per_k[k].stop_reasons
        i = int(np.nonzero(stops != int(StopReason.SCREENED))[0][0])
        rf, rf_wall = counted(f"13b-restart_factors-k{k}",
                              lambda: nmfx_torch.restart_factors(
                                  a, k, i, restarts=r, seed=seed,
                                  solver_cfg=scfg))
        lanes_out = outs[k]
        got_d = float(res.per_k[k].dnorms[i])
        labels_equal = bool(torch.equal(
            torch.argmax(rf.h, dim=0).to(torch.int32),
            lanes_out.labels[i].to(rf.h.device)))
        iters_equal = rf.iterations == int(res.per_k[k].iterations[i])
        byte = (np.float32(rf.dnorm.item()).tobytes()
                == np.float32(got_d).tobytes())
        close = abs(rf.dnorm.item() - got_d) <= 1e-5 * abs(got_d)
        print(f"scale 13b survivor k={k} restart {i} against "
              f"restart_factors ({rf_wall:.3f} s): dnorm byte-equal "
              f"{byte} ({got_d!r} / {rf.dnorm.item()!r}), iterations "
              f"equal {iters_equal}, labels equal {labels_equal}; held "
              + ("byte-equal" if byte else "at rtol 1e-5"), flush=True)
        no_launch(f"13b restart_factors k={k}",
                  launches[f"13b-restart_factors-k{k}"])
        if not (iters_equal and labels_equal and (byte or close)):
            raise AssertionError(f"13b: survivor {i} at k={k} differs from "
                                 "restart_factors")

    # 13c: quality-elastic serving on the bundled design
    bundled = two_group_matrix(n_genes=1000, n_per_group=20, seed=123)
    req = dict(ks=ELASTIC_KS, restarts=10, seed=seed,
               solver_cfg=nmfx_torch.SolverConfig(
                   backend="pallas", max_iter=ELASTIC_MAX_ITER))
    counter = metrics.registry().get("nmfx_serve_quality_degraded_total")
    before = counter.value(cause="deadline")

    def served(elastic):
        cfg = ServeConfig(quality_elastic=elastic, iter_rate_estimate=1.0)
        with NMFXServer(cfg) as srv:
            fut = srv.submit(bundled, timeout=120, **req)
            out = fut.result(timeout=600)
            return out, fut.stats, srv.stats()

    (deg, deg_stats, deg_books), deg_wall = counted("13c-elastic",
                                                    lambda: served(True))
    (ex, ex_stats, ex_books), ex_wall = counted("13c-plain",
                                                lambda: served(False))
    counted_once = counter.value(cause="deadline") - before
    # no earlier phase degrades a request: every such event is 13c's
    events = [e for e in flight.default_recorder().events(
        "serve.quality_degraded") if e.get("cause") == "deadline"]
    print(f"scale 13c quality-elastic server (bundled 1000x40, deadline "
          f"120 s at an estimated 1 iteration/s): {deg_wall:.3f} s, "
          f"quality {deg.quality}, degraded_cause "
          f"{deg_stats.degraded_cause}, budget_iters "
          f"{deg_stats.budget_iters}, books quality_degraded "
          f"{deg_books['quality_degraded']}, counter +{counted_once:g}, "
          f"flight events {len(events)}, best k {deg.best_k}, launches "
          f"{launches['13c-elastic']}; without quality_elastic "
          f"{ex_wall:.3f} s, quality {ex.quality}, budget_iters "
          f"{ex_stats.budget_iters}, best k {ex.best_k}, launches "
          f"{launches['13c-plain']}", flush=True)
    no_launch("13c elastic", launches["13c-elastic"])
    if not (deg.quality == deg_stats.quality == "sketched"
            and deg_stats.degraded_cause == "deadline"
            and deg_books["quality_degraded"] == 1 and counted_once == 1
            and len(events) == 1 and ex.quality == "exact"
            and ex_stats.degraded_cause is None
            and ex_stats.budget_iters is not None):
        raise AssertionError("13c: the degraded request is not tagged and "
                             "counted once, or the plain one not exact")

    # 13d: Lanczos NNDSVD and the card's draws against the CPU's
    a32 = torch.as_tensor(a, dtype=torch.float32, device=dev)
    a64 = a32.double()
    s_dense = {x.dtype: torch.linalg.svd(x, full_matrices=False).S
               for x in (a32, a64)}
    for k in LANCZOS_KS:
        row = {}
        for x, ncv in ((a32, None), (a64, LANCZOS_NCV64)):
            name = f"13d-{str(x.dtype)[6:]}-k{k}"
            (wl, hl), l_wall = counted(name, lambda: nndsvd_init(
                x, k, svd_method="lanczos", ncv=ncv))
            (wd, hd), d_wall = counted(name + "-dense", lambda: nndsvd_init(
                x, k, svd_method="dense"))
            s_l = truncated_svd(x, k, ncv)[1]
            s_d = s_dense[x.dtype][:k]
            past = float(max(
                ((wl - wd).abs() - LANCZOS_BAND * wd.abs()).max(),
                ((hl - hd).abs() - LANCZOS_BAND * hd.abs()).max()))
            row[x.dtype] = (float(((s_l - s_d).abs() / s_d).max()),
                            past <= LANCZOS_BAND, l_wall, d_wall)
            no_launch(name, launches[name])
        (e32, ok32, l32, d32), (e64, ok64, l64, d64) = row.values()
        print(f"scale 13d Lanczos NNDSVD k={k}: float32, default ncv "
              f"{l32:.4f} s against the dense SVD's {d32:.4f} s, max rel "
              f"sigma error {e32:.3g}, factors within the band (rtol = "
              f"atol = {LANCZOS_BAND}) {ok32}; float64, ncv "
              f"{LANCZOS_NCV64} {l64:.4f} s against {d64:.4f} s, error "
              f"{e64:.3g}, within the band {ok64}", flush=True)
        if not (ok64 and e64 <= 1e-6) or (k == 2 and not (ok32
                                                           and e32 <= 1e-3)):
            raise AssertionError(f"13d: Lanczos NNDSVD at k={k} off the "
                                 "dense one")
    keys = np.stack([R.fold_in(kk, sk._FOLD_L)
                     for kk in R.split(R.fold_in(R.key(seed), 10), r)[:8]])
    rk = sk.resolve_dim(nmfx_torch.SolverConfig(backend="sketched"), m, n,
                        10)
    words = R.random_bits_device(keys, (rk, m), dev, 32).cpu().numpy()
    words_equal = all(np.array_equal(words[b].astype(np.uint32),
                                     R.random_bits(keys[b], (rk, m)))
                      for b in range(len(keys)))
    card = R.normal_device(keys, (rk, m), torch.float32, dev).cpu().numpy()
    host = R.normal_device(keys, (rk, m), torch.float32, "cpu").numpy()
    dmax = float(np.abs(card - host).max())
    print(f"scale 13d normal draws ({len(keys)} of k = 10's sketch keys x "
          f"{rk}x{m}): card words "
          f"bit-equal to the host's {words_equal}, max |card - CPU| "
          f"{dmax:.3g}, values byte-equal "
          f"{card.tobytes() == host.tobytes()}", flush=True)
    if not words_equal or dmax > 1e-6:
        raise AssertionError("13d: the card's draws differ from the CPU's")
    return launches


# --- phase 14: bf16 operands off the kernels, the restart mesh on one
# card, two processes on one card, elastic shards --------------------------

#: 14a's ranks of the bf16 whole grid (against 4a's float32 ranks; cut
#: from 2..4 to pay for phase 15: MM's grid took 18.3-27.2 s there, k = 4
#: its longest jobs)
MESH_BF16_KS = (2, 3)
#: 14a's kl on the batched route: k = 2, restarts and iterations cut to
#: phase 7's kl budget (max_iter 100) at a fifth of its restarts
MESH_KL_RESTARTS, MESH_KL_MAX_ITER = 10, 100
#: 14b: three shards over 50 restarts (one padded lane), the per-rank
#: pallas route against 4c's ranks and neals, all at ks 2..3 (three
#: shards and neals cut from 2..4 to pay for phase 15)
MESH_THREE_KS, MESH_PER_RANK_KS, MESH_NEALS_KS = (2, 3), (2, 3), (2, 3)
#: 14c / 14d: the bundled design's sweep (14d's elastic ranks cut to
#: 2..3: at 2..5 it and its single-device reference took 31.6 s)
MESH_BUNDLED_KS, MESH_BUNDLED_RESTARTS = (2, 3, 4, 5), 10
MESH_ELASTIC_KS = (2, 3)
#: 14c: each process's and the rendezvous' limit
MESH_PROC_TIMEOUT_S = 300.0

_MESH_WORKER = r"""
import hashlib, json, os, sys
sys.path.insert(0, sys.argv[5])
import numpy as np
import torch
coord, pid, outdir, timeout = (sys.argv[1], int(sys.argv[2]), sys.argv[3],
                               float(sys.argv[4]))
import nmfx_torch
import nmfx_torch.distributed as dist
from nmfx_torch.datasets import two_group_matrix
from nmfx_torch.ops import fused_mu as fm
dist.initialize(coordinator_address=coord, num_processes=2,
                process_id=pid, timeout_s=timeout)
a = two_group_matrix(n_genes=1000, n_per_group=20, seed=123)
fm.reset_launch_counts()
res = dist.consensus(
    a, ks=(2, 3, 4, 5), restarts=10, seed=123, devices=["cuda:0"],
    solver_cfg=nmfx_torch.SolverConfig(backend="pallas"),
    output=nmfx_torch.OutputConfig(
        directory=os.path.join(outdir, f"files{pid}"), write_plots=False))
torch.cuda.synchronize()
digest = {str(k): hashlib.sha256(b"".join(
    np.ascontiguousarray(np.asarray(getattr(res.per_k[k], f))).tobytes()
    for f in ("consensus", "rho", "dispersion", "membership", "order",
              "iterations", "dnorms", "stop_reasons", "best_w",
              "best_h"))).hexdigest()
    for k in res.ks}
with open(os.path.join(outdir, f"proc{pid}.json"), "w") as f:
    json.dump({"summary": res.summary(), "digest": digest,
               "launches": dict(fm.LAUNCHES),
               "scoped": fm.SCOPED_LAUNCHES}, f)
dist.shutdown()
"""


def kresult_digest(res) -> dict:
    import hashlib

    return {str(k): hashlib.sha256(b"".join(
        np.ascontiguousarray(np.asarray(getattr(res.per_k[k], f))).tobytes()
        for f in KRESULT_FIELDS)).hexdigest() for k in res.ks}


def byte_equal_ranks(got, want, ks, fields=KRESULT_FIELDS) -> dict:
    """``{k: [field, ...]}`` of the ranks of ``ks`` whose ``fields``
    differ between two results (empty: byte-equal)."""
    out = {k: [f for f in fields if not same_bytes(
        getattr(got.per_k[k], f), getattr(want.per_k[k], f))] for k in ks}
    return {k: v for k, v in out.items() if v}


def shard_launches(fm, name) -> dict:
    return {scope: counts.get(name, 0)
            for scope, counts in sorted(fm.SCOPED_LAUNCHES.items())}


def phase_mesh(torch, fm, grid, hals, per_rank=None):
    """Phase 14 (see the module docstring): 14a bf16 operands off the
    kernels, 14b the restart mesh on one card, 14c two processes on one
    card, 14d elastic shards. ``grid`` / ``hals`` are phase 4a's and 4d's
    results; ``per_rank`` is 4c's (None: its ranks 2..3 run here)."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix=".mesh_smoke_",
                                     dir=HERE) as scratch:
        return _phase_mesh(torch, fm, grid, hals, per_rank, scratch)


def _phase_mesh(torch, fm, grid, hals, per_rank, scratch):
    import nmfx_torch
    from nmfx_torch import distributed as dist
    from nmfx_torch import faults
    from nmfx_torch import sweep as psweep
    from nmfx_torch.datasets import two_group_matrix
    from nmfx_torch.solvers.base import solve

    m, n, r, _ = NORTH_STAR
    a = north_star_matrix()
    bundled = two_group_matrix(n_genes=1000, n_per_group=20, seed=123)
    launched = {}
    card0 = torch.device("cuda", 0)

    # -- 14a: bf16 operands off the kernels ------------------------------
    bf = nmfx_torch.SolverConfig(matmul_precision=BF16)
    fm.reset_launch_counts()
    t0 = time.perf_counter()
    res = nmfx_torch.nmfconsensus(a, ks=MESH_BF16_KS, restarts=r,
                                  solver_cfg=bf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched["14a bf16 grid"] = sum(fm.LAUNCHES.values())
    check_sweep(res, "bf16 dense grid", n)
    f32_best = MESH_BF16_KS[int(np.argmax(
        [grid.per_k[k].rho for k in MESH_BF16_KS]))]
    same2 = np.array_equal(res.per_k[2].membership, grid.per_k[2].membership)
    print(f"mesh 14a bf16 dense grid (backend auto, ks {MESH_BF16_KS}, "
          f"{r} restarts): wall {wall:.3f} s, launches "
          f"{launched['14a bf16 grid']}, best k {res.best_k} (4a's float32 "
          f"grid at these ks {f32_best}), k = 2 memberships equal {same2}",
          flush=True)
    for k in MESH_BF16_KS:
        b, g = res.per_k[k], grid.per_k[k]
        print(f"mesh 14a bf16 dense grid k={k}: mean iters "
              f"{b.iterations.mean():.1f} (float32 "
              f"{g.iterations.mean():.1f}), stop reasons {stop_counts(b)} "
              f"(float32 {stop_counts(g)}), rho {b.rho:.4f} (float32 "
              f"{g.rho:.4f})", flush=True)
    if res.best_k != f32_best or not same2:
        raise AssertionError("14a: the bf16 grid departs from 4a's float32 "
                             "grid (best k or k = 2 memberships)")
    if launched["14a bf16 grid"]:
        raise AssertionError("14a: a kernel launched on backend auto")

    rng = np.random.default_rng(0)
    w0 = rng.uniform(0.0, 1.0, (m, 2)).astype(np.float32)
    h0 = rng.uniform(0.0, 1.0, (2, n)).astype(np.float32)
    t0 = time.perf_counter()
    s32 = solve(a, w0, h0, nmfx_torch.SolverConfig())
    s16 = solve(a, w0, h0, bf)
    torch.cuda.synchronize()
    lab32 = s32.h.argmax(dim=0).cpu().numpy()
    lab16 = s16.h.argmax(dim=0).cpu().numpy()
    print(f"mesh 14a bf16 solve k=2: {time.perf_counter() - t0:.3f} s for "
          f"both; iterations {s16.iterations} (float32 {s32.iterations}), "
          f"stop reason {s16.stop_reason} (float32 {s32.stop_reason}), "
          f"dnorm {float(s16.dnorm):.6g} (float32 {float(s32.dnorm):.6g}), "
          f"labels equal {np.array_equal(lab16, lab32)}", flush=True)
    if not np.array_equal(lab16, lab32):
        raise AssertionError("14a: solve() at k = 2 under bf16 labels the "
                             "samples otherwise than float32")

    kl = {}
    for prec in ("default", BF16):
        t0 = time.perf_counter()
        kl[prec] = nmfx_torch.nmfconsensus(
            a, ks=(2,), restarts=MESH_KL_RESTARTS,
            solver_cfg=nmfx_torch.SolverConfig(
                algorithm="kl", max_iter=MESH_KL_MAX_ITER,
                matmul_precision=prec))
        torch.cuda.synchronize()
        kl[prec + "_s"] = time.perf_counter() - t0
    k16, k32 = kl[BF16].per_k[2], kl["default"].per_k[2]
    same_kl = np.array_equal(k16.membership, k32.membership)
    print(f"mesh 14a bf16 kl batched k=2 ({MESH_KL_RESTARTS} restarts, "
          f"max_iter {MESH_KL_MAX_ITER}): {kl[BF16 + '_s']:.3f} s (float32 "
          f"{kl['default_s']:.3f} s), mean iters {k16.iterations.mean():.1f}"
          f" (float32 {k32.iterations.mean():.1f}), stop reasons "
          f"{stop_counts(k16)} (float32 {stop_counts(k32)}), memberships "
          f"equal {same_kl}", flush=True)
    if not same_kl:
        raise AssertionError("14a: kl under bf16 departs from float32 at "
                             "k = 2")

    # -- 14b: the restart mesh, two shards on the one card ---------------
    mesh2 = psweep.grid_mesh(2, devices=[card0, card0])
    routes = {}
    fm.reset_launch_counts()
    t0 = time.perf_counter()
    res = nmfx_torch.nmfconsensus(
        a, ks=KS, restarts=r, mesh=mesh2,
        solver_cfg=nmfx_torch.SolverConfig(backend="pallas"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    row3 = shard_launches(fm, "fused_block_iterations")
    launched["14b mu grid"] = fm.LAUNCHES["fused_block_iterations"]
    bad = byte_equal_ranks(res, grid, KS)
    routes["mu grid (row 3)"] = not bad
    print(f"mesh 14b mu whole grid on 2 shards of one card (pallas, ks "
          f"2..10, {r} restarts): wall {wall:.3f} s, row-3 launches "
          f"{launched['14b mu grid']} by shard {row3}, best k {res.best_k}; "
          f"byte-equal to 4a per rank: {not bad} (ranks that differ: "
          f"{bad})", flush=True)
    if bad or len(row3) != 2 or min(row3.values()) < 1:
        raise AssertionError("14b: the meshed mu grid is not 4a's, or a "
                             "shard launched no row-3 kernel")

    fm.reset_launch_counts()
    t0 = time.perf_counter()
    res = nmfx_torch.nmfconsensus(
        a, ks=KS, restarts=r, mesh=mesh2, keep_factors=True,
        solver_cfg=nmfx_torch.SolverConfig(algorithm="hals",
                                           backend="pallas"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    row5 = shard_launches(fm, "hals_block_iterations")
    launched["14b hals grid"] = fm.LAUNCHES["hals_block_iterations"]
    bad = byte_equal_ranks(res, hals, KS, KRESULT_FIELDS + ("all_w", "all_h"))
    routes["hals grid (row 5)"] = not bad
    print(f"mesh 14b hals whole grid on 2 shards (pallas): wall "
          f"{wall:.3f} s, row-5 launches {launched['14b hals grid']} by "
          f"shard {row5}, best k {res.best_k}; byte-equal to 4d per rank, "
          f"every restart's factors too: {not bad} (differ: {bad})",
          flush=True)
    if bad or len(row5) != 2 or min(row5.values()) < 1:
        raise AssertionError("14b: the meshed hals grid is not 4d's, or a "
                             "shard launched no row-5 kernel")

    # the reference at these ranks: the pool's lanes are padded to the
    # largest rank, so ks 2..3 is its own pool geometry, not 4a's
    three_ref = nmfx_torch.nmfconsensus(
        a, ks=MESH_THREE_KS, restarts=r,
        solver_cfg=nmfx_torch.SolverConfig(backend="pallas"))
    mesh3 = psweep.grid_mesh(3, devices=[card0] * 3)
    pads = psweep._pad_lanes_total.value()
    fm.reset_launch_counts()
    t0 = time.perf_counter()
    res = nmfx_torch.nmfconsensus(
        a, ks=MESH_THREE_KS, restarts=r, mesh=mesh3,
        solver_cfg=nmfx_torch.SolverConfig(backend="pallas"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pads = psweep._pad_lanes_total.value() - pads
    row3 = shard_launches(fm, "fused_block_iterations")
    bad = byte_equal_ranks(res, three_ref, MESH_THREE_KS)
    routes["mu grid, 3 shards, padded"] = not bad
    print(f"mesh 14b mu whole grid on 3 shards (ks {MESH_THREE_KS}, {r} "
          f"restarts as 3 x {-(-r // 3)}): wall {wall:.3f} s, "
          f"nmfx_mesh_pad_lanes_total +{pads:g}, row-3 launches by shard "
          f"{row3}; byte-equal to the unmeshed grid at these ks: "
          f"{not bad} (differ: {bad})", flush=True)
    if bad or pads != 1 or len(row3) != 3:
        raise AssertionError("14b: three shards: not byte-equal to the "
                             f"unmeshed grid, or {pads} pad lanes booked "
                             "(1 expected)")

    if per_rank is None:
        per_rank = nmfx_torch.nmfconsensus(
            a, ks=MESH_PER_RANK_KS, restarts=r, grid_exec="per_k",
            solver_cfg=nmfx_torch.SolverConfig(backend="pallas"))
        ref_name = "its unmeshed run"
    else:
        ref_name = "4c's ranks"
    fm.reset_launch_counts()
    t0 = time.perf_counter()
    res = nmfx_torch.nmfconsensus(
        a, ks=MESH_PER_RANK_KS, restarts=r, mesh=mesh2, grid_exec="per_k",
        solver_cfg=nmfx_torch.SolverConfig(backend="pallas"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows12 = {name: shard_launches(fm, name)
              for name in ("fused_h_update", "fused_w_update")}
    launched["14b per-rank"] = fm.LAUNCHES["fused_h_update"]
    bad = byte_equal_ranks(res, per_rank, MESH_PER_RANK_KS)
    routes["per-rank pallas (rows 1-2)"] = not bad
    print(f"mesh 14b per-rank pallas route on 2 shards (ks "
          f"{MESH_PER_RANK_KS}): wall {wall:.3f} s, launches by shard "
          f"{rows12}; byte-equal to {ref_name}: {not bad} (differ: {bad})",
          flush=True)
    if bad or min(rows12["fused_h_update"].values(), default=0) < 1:
        raise AssertionError("14b: the meshed per-rank route is not the "
                             "unmeshed one's, or a shard launched no pair")

    neals = {}
    for name, mesh in (("unmeshed", None), ("2 shards", mesh2)):
        fm.reset_launch_counts()
        t0 = time.perf_counter()
        neals[name] = nmfx_torch.nmfconsensus(
            a, ks=MESH_NEALS_KS, restarts=r, mesh=mesh,
            solver_cfg=nmfx_torch.SolverConfig(algorithm="neals"))
        torch.cuda.synchronize()
        neals[name + "_s"] = time.perf_counter() - t0
        if sum(fm.LAUNCHES.values()):
            raise AssertionError("14b: a kernel launched on neals' batched "
                                 "route")
    got, want = neals["2 shards"], neals["unmeshed"]
    bad = byte_equal_ranks(got, want, MESH_NEALS_KS)
    same2 = np.array_equal(got.per_k[2].membership, want.per_k[2].membership)
    dc = max(float(np.abs(got.per_k[k].consensus
                          - want.per_k[k].consensus).max())
             for k in MESH_NEALS_KS)
    tier = "byte-equal" if not bad else (
        "agreement" if got.best_k == want.best_k and same2 else "none")
    routes["neals batched (cuBLAS)"] = tier
    print(f"mesh 14b neals batched on 2 shards (ks {MESH_NEALS_KS}): "
          f"{neals['2 shards_s']:.3f} s (unmeshed "
          f"{neals['unmeshed_s']:.3f} s), tier met: {tier} (ranks not "
          f"byte-equal {bad}, best k {got.best_k} / {want.best_k}, k = 2 "
          f"memberships equal {same2}, max|dC| {dc:.3g})", flush=True)
    if tier == "none":
        raise AssertionError("14b: meshed neals departs from unmeshed")
    print(f"mesh 14b routes byte-equal: {routes}", flush=True)

    # -- 14c: two processes on the one card over gloo --------------------
    with __import__("socket").socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    outdir = os.path.join(scratch, "procs")
    os.makedirs(outdir)
    env = dict(os.environ)
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MESH_WORKER, coord, str(i), outdir,
         str(MESH_PROC_TIMEOUT_S / 2), HERE], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=MESH_PROC_TIMEOUT_S)
            if p.returncode != 0:
                errs.append(err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    procs_s = time.perf_counter() - t0
    if errs:
        raise AssertionError(f"14c: a process failed: {errs}")
    r0, r1 = (json.load(open(os.path.join(outdir, f"proc{i}.json")))
              for i in range(2))
    t0 = time.perf_counter()
    single = nmfx_torch.nmfconsensus(
        bundled, ks=MESH_BUNDLED_KS, restarts=MESH_BUNDLED_RESTARTS,
        seed=123, solver_cfg=nmfx_torch.SolverConfig(backend="pallas"))
    single_s = time.perf_counter() - t0
    want = kresult_digest(single)
    files0 = sorted(os.listdir(os.path.join(outdir, "files0")))
    files1 = os.path.exists(os.path.join(outdir, "files1"))
    same_procs = r0["summary"] == r1["summary"] and \
        r0["digest"] == r1["digest"]
    same_single = r0["digest"] == want and \
        r0["summary"] == single.summary()
    print(f"mesh 14c two processes on one card (gloo, the bundled "
          f"{bundled.shape[0]}x{bundled.shape[1]} design, ks "
          f"{MESH_BUNDLED_KS}, {MESH_BUNDLED_RESTARTS} restarts, pallas): "
          f"{procs_s:.3f} s with the interpreters (one process "
          f"{single_s:.3f} s); row-3 launches by process "
          f"{[p['launches']['fused_block_iterations'] for p in (r0, r1)]}"
          f", by shard {[p['scoped'] for p in (r0, r1)]}; the processes' "
          f"results equal {same_procs}, byte-equal to the one-process "
          f"run {same_single}; coordinator's files {len(files0)} "
          f"({'cophenetic.txt' in files0}), process 1 wrote none "
          f"{not files1}", flush=True)
    print(r0["summary"], flush=True)
    if not (same_procs and same_single and "cophenetic.txt" in files0
            and not files1) or min(
                p["launches"]["fused_block_iterations"] for p in (r0, r1)
    ) < 1:
        raise AssertionError("14c: the two processes' results are not one "
                             "result, or a process wrote or launched wrong")

    # -- 14d: elastic shards on the one card -----------------------------
    scfg = nmfx_torch.SolverConfig(backend="pallas")
    kw = dict(ks=MESH_ELASTIC_KS, restarts=MESH_BUNDLED_RESTARTS, seed=123,
              solver_cfg=scfg)
    t0 = time.perf_counter()
    ref = nmfx_torch.nmfconsensus(
        bundled, checkpoint=nmfx_torch.CheckpointConfig(
            os.path.join(scratch, "ref"), every_n_restarts=5), **kw)
    ref_s = time.perf_counter() - t0
    el_dir = os.path.join(scratch, "elastic")
    faults.arm("proc.preempt", every=3, max_fires=1)
    fm.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        res = dist.elastic_consensus(
            bundled, checkpoint=nmfx_torch.CheckpointConfig(
                el_dir, every_n_restarts=5), devices=[card0, card0], **kw)
    finally:
        faults.disarm("proc.preempt")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched["14d elastic"] = fm.LAUNCHES["fused_h_update"]
    bad = byte_equal_ranks(res, ref, MESH_ELASTIC_KS)
    beats = sorted(f for f in os.listdir(el_dir) if f.startswith("shard_"))
    from nmfx_torch.obs.export import HeartbeatLedger

    status = HeartbeatLedger(el_dir, prefix="shard_").status()
    alive = sorted(bool(v.get("alive")) for v in status.values())
    records = len([f for f in os.listdir(el_dir)
                   if f.startswith("k") and f.endswith(".npz")])
    print(f"mesh 14d elastic shards [cuda:0, cuda:0] (the bundled design, "
          f"ks {MESH_ELASTIC_KS}, chunks of 5, proc.preempt at the 3rd "
          f"unit): {wall:.3f} s "
          f"(single-device checkpointed run {ref_s:.3f} s), pair launches "
          f"{launched['14d elastic']}, {records} records of "
          f"{2 * len(MESH_ELASTIC_KS)}, heartbeats {beats} alive {alive}; "
          f"byte-equal to the single-device checkpointed run: {not bad} "
          f"(differ: {bad})", flush=True)
    if bad or beats != ["shard_0.json", "shard_1.json"] or \
            alive != [False, True] or records != 2 * len(MESH_ELASTIC_KS):
        raise AssertionError("14d: the elastic run is not the single-device"
                             " run's, or the ledger is incomplete")
    return launched


# --- phase 15: the feature and sample mesh axes on one card, two
# processes on one card over gloo, mesh serving and priced placement --------

#: 15a: mu at the north star, ks 2..3, every restart, on these grid meshes,
#: to max_iter 600 (from the default 10000: k = 2's slowest lane ran 436
#: iterations and k = 3's 1738; each lane's stop is compared at one budget)
GRID_KS, GRID_MAX_ITER = (2, 3), 600
GRID_SHAPES = ((1, 2, 1), (1, 1, 2), (1, 2, 2))
#: nmfx's grid-mesh agreement bound (tests/test_mesh_parity.py:52-60)
GRID_AGREEMENT_ATOL = 0.35
#: 15b: kl on 1x2x1 at k = 2
GRID_KL_RESTARTS, GRID_KL_CHUNK, GRID_KL_MAX_ITER = 10, 5, 100
#: 15c: the Gram family on 1x1x2 over the bundled design
GRID_GRAM = ("hals", "neals", "snmf")
GRID_BUNDLED_RESTARTS = 10
#: 15e: the served north-star requests (max_iter cut from the default
#: 10000: the byte-equality to sweep() does not depend on convergence)
#: and the atlas request
GRID_SERVE_RESTARTS, GRID_SERVE_MAX_ITER = 10, 300
GRID_ATLAS = (20000, 500, 4, 200)  # genes, samples per group, restarts, iters
GRID_PROC_TIMEOUT_S = 300.0
#: 15d: the two processes' depth (the byte-equality does not depend on
#: convergence; at the default 10000 every iteration's exchanges over
#: gloo took the phase to 32.5 s on one H100)
GRID_PROC_MAX_ITER = 300

_GRID_WORKER = r"""
import hashlib, json, os, sys
sys.path.insert(0, sys.argv[5])
import numpy as np
import torch
coord, pid, outdir, timeout = (sys.argv[1], int(sys.argv[2]), sys.argv[3],
                               float(sys.argv[4]))
import nmfx_torch
import nmfx_torch.distributed as dist
from nmfx_torch.datasets import two_group_matrix
from nmfx_torch.ops import fused_mu as fm
dist.initialize(coordinator_address=coord, num_processes=2,
                process_id=pid, timeout_s=timeout)
a = two_group_matrix(n_genes=1000, n_per_group=20, seed=123)
fm.reset_launch_counts()
res = dist.consensus(a, ks=(2, 3), restarts=10, seed=123, feature_shards=2,
                     devices=["cuda:0"], solver_cfg=nmfx_torch.SolverConfig(
                         max_iter=int(sys.argv[6])))
torch.cuda.synchronize()
digest = {str(k): hashlib.sha256(b"".join(
    np.ascontiguousarray(np.asarray(getattr(res.per_k[k], f))).tobytes()
    for f in ("consensus", "rho", "dispersion", "membership", "order",
              "iterations", "dnorms", "stop_reasons", "best_w",
              "best_h"))).hexdigest()
    for k in res.ks}
with open(os.path.join(outdir, f"grid{pid}.json"), "w") as f:
    json.dump({"summary": res.summary(), "digest": digest,
               "launches": sum(fm.LAUNCHES.values())}, f)
dist.shutdown()
"""


def _grid_mesh(psweep, card, shape):
    r, f, s = shape
    return psweep.grid_mesh(r, f, s, devices=[card] * (r * f * s))


def _dc(got, want, ks) -> float:
    return max(float(np.abs(got.per_k[k].consensus
                            - want.per_k[k].consensus).max()) for k in ks)


def phase_grid_mesh(torch, fm):
    """Phase 15 (see the module docstring): the feature and sample axes
    on one card (every mesh names the card several times, so its shards
    share it), two processes over gloo, mesh serving and priced
    placement. Returns each run's kernel launches (0: nmfx refuses the
    kernels on grid axes)."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix=".grid_smoke_",
                                     dir=HERE) as scratch:
        return _phase_grid_mesh(torch, fm, scratch)


def _phase_grid_mesh(torch, fm, scratch):
    from nmfx_torch.datasets import two_group_matrix

    a = north_star_matrix()
    bundled = two_group_matrix(n_genes=1000, n_per_group=20, seed=123)
    card0 = torch.device("cuda", 0)
    launched = {}

    # 15d's two interpreters start first: they reach the card and meet
    # over gloo while 15a-c run (their runs share the card with them)
    with __import__("socket").socket() as sock:
        sock.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{sock.getsockname()[1]}"
    outdir = os.path.join(scratch, "procs")
    os.makedirs(outdir)
    env = dict(os.environ)
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    t_procs = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GRID_WORKER, coord, str(i), outdir,
         str(GRID_PROC_TIMEOUT_S / 2), HERE, str(GRID_PROC_MAX_ITER)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        return _grid_parts(torch, fm, a, bundled, card0, launched, procs,
                           t_procs, outdir, scratch)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _grid_parts(torch, fm, a, bundled, card0, launched, procs, t_procs,
                outdir, scratch):
    import nmfx_torch
    from nmfx_torch import collectives
    from nmfx_torch import sweep as psweep
    from nmfx_torch.datasets import two_group_matrix

    m, n, r, _ = NORTH_STAR

    def timed(label, fn):
        fm.reset_launch_counts()
        collectives.reset_calls()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        launched[label] = sum(fm.LAUNCHES.values())
        if launched[label]:
            raise AssertionError(f"{label}: a kernel launched on a grid "
                                 "mesh (nmfx refuses the kernels there)")
        return out, time.perf_counter() - t0, sum(collectives.CALLS.values())

    # -- 15a: mu at the north star on three grid meshes ------------------
    packed = nmfx_torch.SolverConfig(backend="packed",
                                     max_iter=GRID_MAX_ITER)
    ref, ref_s, _ = timed("15a unmeshed", lambda: nmfx_torch.nmfconsensus(
        a, ks=GRID_KS, restarts=r, grid_exec="per_k", solver_cfg=packed))
    check_sweep(ref, "15a unmeshed", n)
    print(f"grid 15a unmeshed packed per-rank mu (ks {GRID_KS}, {r} "
          f"restarts, max_iter {GRID_MAX_ITER}): {ref_s:.3f} s, mean iters "
          f"{[round(float(ref.per_k[k].iterations.mean()), 1) for k in GRID_KS]}",
          flush=True)
    for shape in GRID_SHAPES:
        mesh = _grid_mesh(psweep, card0, shape)
        label = "15a " + "x".join(map(str, shape))
        got, s, calls = timed(label, lambda: nmfx_torch.nmfconsensus(
            a, ks=GRID_KS, restarts=r, mesh=mesh, solver_cfg=packed))
        check_finite(got, label, n)
        for k in GRID_KS:
            g, w = got.per_k[k], ref.per_k[k]
            dc = float(np.abs(g.consensus - w.consensus).max())
            mism = int((g.membership != w.membership).sum())
            dit = int(np.abs(g.iterations.astype(np.int64)
                             - w.iterations.astype(np.int64)).max())
            print(f"grid {label} k={k}: max|dC| {dc:.3g}, membership "
                  f"mismatches {mism}, max |d iterations| {dit}, mean "
                  f"iters {g.iterations.mean():.1f}", flush=True)
            if dc > GRID_AGREEMENT_ATOL:
                raise AssertionError(f"{label} k={k}: max|dC| {dc} beyond "
                                     f"{GRID_AGREEMENT_ATOL}")
        print(f"grid {label} mu (ks {GRID_KS}, {r} restarts): {s:.3f} s "
              f"({s / ref_s:.2f}x the unmeshed run), {calls} collectives "
              f"of shard (0, 0), launches {launched[label]}, best k "
              f"{got.best_k} (unmeshed {ref.best_k})", flush=True)
        if got.best_k != ref.best_k:
            raise AssertionError(f"{label}: best k {got.best_k} != "
                                 f"{ref.best_k}")

    # -- 15b: kl on 1x2x1 ------------------------------------------------
    kl_kw = dict(ks=(2,), restarts=GRID_KL_RESTARTS)
    kl_ref, kl_ref_s, _ = timed("15b unmeshed", lambda: nmfx_torch.nmfconsensus(
        a, solver_cfg=nmfx_torch.SolverConfig(
            algorithm="kl", max_iter=GRID_KL_MAX_ITER), **kl_kw))
    mesh = _grid_mesh(psweep, card0, (1, 2, 1))
    kl, kl_s, calls = timed("15b 1x2x1", lambda: nmfx_torch.nmfconsensus(
        a, mesh=mesh, solver_cfg=nmfx_torch.SolverConfig(
            algorithm="kl", max_iter=GRID_KL_MAX_ITER,
            restart_chunk=GRID_KL_CHUNK), **kl_kw))
    same = np.array_equal(kl.per_k[2].membership, kl_ref.per_k[2].membership)
    print(f"grid 15b kl on 1x2x1 (k = 2, {GRID_KL_RESTARTS} restarts, "
          f"restart_chunk {GRID_KL_CHUNK}, max_iter {GRID_KL_MAX_ITER}): "
          f"{kl_s:.3f} s (unmeshed batched {kl_ref_s:.3f} s), {calls} "
          f"collectives, memberships equal {same}, max|dC| "
          f"{_dc(kl, kl_ref, (2,)):.3g}", flush=True)
    if not same:
        raise AssertionError("15b: kl's memberships on 1x2x1 differ")

    # -- 15c: hals, neals and snmf on 1x1x2 over the bundled design --------
    mesh = _grid_mesh(psweep, card0, (1, 1, 2))
    for alg in GRID_GRAM:
        cfg = nmfx_torch.SolverConfig(algorithm=alg)
        kw = dict(ks=GRID_KS, restarts=GRID_BUNDLED_RESTARTS, seed=123,
                  solver_cfg=cfg)
        want, want_s, _ = timed(f"15c {alg} unmeshed",
                                lambda: nmfx_torch.nmfconsensus(bundled,
                                                                **kw))
        got, s, calls = timed(f"15c {alg}", lambda: nmfx_torch.nmfconsensus(
            bundled, mesh=mesh, **kw))
        check_finite(got, f"15c {alg}", bundled.shape[1])
        for k in GRID_KS:
            g, w = got.per_k[k], want.per_k[k]
            same = np.array_equal(g.membership, w.membership)
            it_w = w.iterations.astype(np.int64)
            drift = np.abs(g.iterations.astype(np.int64) - it_w)
            bound = np.maximum(25 * cfg.check_every, it_w // 2)
            dc = _dc(got, want, (k,))
            print(f"grid 15c {alg} on 1x1x2 k={k}: memberships equal "
                  f"{same}, max|dC| {dc:.3g}, max |d iterations| "
                  f"{int(drift.max())} (bound {int(bound.min())}+), "
                  f"{s:.3f} s (unmeshed {want_s:.3f} s), {calls} "
                  f"collectives", flush=True)
            # the Gram family's tier: iterations only bounded; memberships
            # equal at the design's true rank (k = 2); at k = 3, which
            # splits a group, a TolFun/TolX crossing moved by the sums'
            # order may move a restart's labels (ROADMAP §3): held there
            # to nmfx's grid-mesh agreement bound
            if (drift > bound).any() or dc > GRID_AGREEMENT_ATOL or (
                    k == 2 and not same):
                raise AssertionError(f"15c {alg} k={k}: beyond the Gram "
                                     "family's tier")
        if got.best_k != want.best_k:
            raise AssertionError(f"15c {alg}: best k {got.best_k} != "
                                 f"{want.best_k}")

    # -- 15d: two processes, one shard each of the one card --------------
    # (started with the phase) and the one-process run of the same mesh
    one, one_s, _ = timed("15d one process", lambda: nmfx_torch.nmfconsensus(
        bundled, ks=GRID_KS, restarts=GRID_BUNDLED_RESTARTS, seed=123,
        mesh=_grid_mesh(psweep, card0, (1, 2, 1)),
        solver_cfg=nmfx_torch.SolverConfig(max_iter=GRID_PROC_MAX_ITER)))
    t0 = time.perf_counter()
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=GRID_PROC_TIMEOUT_S)
        if p.returncode != 0:
            errs.append(err[-3000:])
    procs_s = time.perf_counter() - t_procs
    waited = time.perf_counter() - t0
    if errs:
        raise AssertionError(f"15d: a process failed: {errs}")
    r0, r1 = (json.load(open(os.path.join(outdir, f"grid{i}.json")))
              for i in range(2))
    want = kresult_digest(one)
    byte_equal = r0["digest"] == r1["digest"] == want
    print(f"grid 15d mu on 1x2x1 in two processes over gloo (one shard of "
          f"the card each; the bundled design, ks {GRID_KS}, "
          f"{GRID_BUNDLED_RESTARTS} restarts, max_iter {GRID_PROC_MAX_ITER})"
          f": {procs_s:.3f} s with the "
          f"interpreters from the phase's start, {waited:.3f} s of it "
          f"waited for after 15a-c and the one-process run (one process "
          f"{one_s:.3f} s), launches "
          f"{[p['launches'] for p in (r0, r1)]}; byte-equal to the "
          f"one-process run: {byte_equal}", flush=True)
    print(r0["summary"], flush=True)
    if not byte_equal or r0["summary"] != one.summary() or \
            r0["launches"] or r1["launches"]:
        raise AssertionError("15d: two processes are not byte-equal to "
                             "one, or a kernel launched")

    # -- 15e: mesh serving and priced placement ------------------------------
    from nmfx_torch.config import ConsensusConfig
    from nmfx_torch.obs import costmodel
    from nmfx_torch.replica import ReplicaPool
    from nmfx_torch.router import NMFXRouter, RouterConfig
    from nmfx_torch.serve import NMFXServer, ServeConfig

    served_ok = True
    t0 = time.perf_counter()
    fm.reset_launch_counts()
    with NMFXServer(ServeConfig(mesh_spec="1x2"), device=card0) as srv:
        futs = [srv.submit(a, ks=GRID_KS, restarts=GRID_SERVE_RESTARTS,
                           seed=s, solver_cfg=nmfx_torch.SolverConfig(
                               max_iter=GRID_SERVE_MAX_ITER))
                for s in (1, 2)]
        answers = [f.result(timeout=GRID_PROC_TIMEOUT_S) for f in futs]
        srv_mesh = srv.engine.mesh
    serve_s = time.perf_counter() - t0
    launched["15e served"] = sum(fm.LAUNCHES.values())
    for seed, ans in zip((1, 2), answers):
        direct = psweep.sweep(a, ConsensusConfig(
            ks=GRID_KS, restarts=GRID_SERVE_RESTARTS, seed=seed),
            nmfx_torch.SolverConfig(max_iter=GRID_SERVE_MAX_ITER),
            mesh=srv_mesh)
        for k in GRID_KS:
            for f in ("consensus", "iterations", "dnorms", "stop_reasons",
                      "best_w", "best_h"):
                want = getattr(direct[k], f).cpu().numpy()
                got = np.asarray(getattr(ans.per_k[k], f)).astype(want.dtype)
                served_ok &= got.tobytes() == want.tobytes()
    print(f"grid 15e ServeConfig(mesh_spec='1x2') server: two north-star "
          f"requests (ks {GRID_KS}, {GRID_SERVE_RESTARTS} restarts, "
          f"max_iter {GRID_SERVE_MAX_ITER}) in "
          f"{serve_s:.3f} s, launches {launched['15e served']}; each "
          f"byte-equal to sweep() on the same mesh: {served_ok}", flush=True)
    if not served_ok or launched["15e served"]:
        raise AssertionError("15e: a served answer is not sweep()'s on its "
                             "mesh")

    genes, per_group, a_restarts, a_iters = GRID_ATLAS
    atlas = two_group_matrix(n_genes=genes, n_per_group=per_group, seed=7)
    atlas = atlas.astype(np.float32)
    pool = ReplicaPool(2, root=os.path.join(scratch, "pool"), mode="thread",
                       mesh_specs=(None, "1x2"), device=card0,
                       mesh_devices=[card0, card0])
    try:
        mesh_rep = [rep for rep in pool.routable() if rep.n_devices == 2][0]
        t0 = time.perf_counter()
        fm.reset_launch_counts()
        with NMFXRouter(pool, RouterConfig()) as router:
            fa = router.submit(atlas, ks=(2,), restarts=a_restarts, seed=3,
                               solver_cfg=nmfx_torch.SolverConfig(
                                   max_iter=a_iters))
            fb = router.submit(bundled, ks=GRID_KS,
                               restarts=GRID_BUNDLED_RESTARTS, seed=123)
            ra = fa.result(timeout=GRID_PROC_TIMEOUT_S)
            fb.result(timeout=GRID_PROC_TIMEOUT_S)
        route_s = time.perf_counter() - t0
    finally:
        pool.close()
    cm = costmodel.comm_model("mu", genes, 2 * per_group, 2,
                              feature_shards=2, restarts=a_restarts)
    inputs = fa.stats.placement_inputs
    print(f"grid 15e router over ReplicaPool(mesh_specs=(None, '1x2')): "
          f"the {genes}x{2 * per_group} request ({atlas.nbytes / 1e6:.1f} "
          f"MB, k = 2, {a_restarts} restarts, max_iter {a_iters}) on "
          f"{fa.stats.replica} (class {fa.stats.placement_class}, the mesh "
          f"replica {fa.stats.replica == mesh_rep.replica_id}), comm_model "
          f"{inputs['comm_bytes_per_iter']} bytes an iteration "
          f"({cm['collectives_per_iter']} collectives, model "
          f"{cm['wire_bytes_per_iter']}), best k {ra.best_k}; the bundled "
          f"request on class {fb.stats.placement_class}; {route_s:.3f} s, "
          f"launches {sum(fm.LAUNCHES.values())} (the plain replica's "
          f"whole grid)", flush=True)
    if fa.stats.replica != mesh_rep.replica_id or \
            fb.stats.placement_class != 1 or \
            inputs["comm_bytes_per_iter"] != cm["wire_bytes_per_iter"]:
        raise AssertionError("15e: the atlas request is not on the mesh "
                             "replica, or the bundled one not on the plain")
    return launched


#: phase 16: the hals search's ranks and 16d's (the tuned sweep against
#: the explicit and the default ones), cut from ks 2..10 to keep the
#: phase within its 30 s; the fresh interpreter's time limit
AUTOTUNE_HALS_KS = KS[:4]
AUTOTUNE_CHECK_KS = KS[:4]
AUTOTUNE_PROC_TIMEOUT_S = 180.0
#: the block rows an autotune search launches
TUNED_ROWS = ("fused_block_iterations", "fused_block_iterations_fused",
              "hals_block_iterations")

_AUTOTUNE_WORKER = r"""
import json, os, sys, time
here, cache_dir, go, out, limit = sys.argv[1:6]
sys.path.insert(0, here)
import torch
from nmfx_torch import autotune
from nmfx_torch.config import ExperimentalConfig, SolverConfig
from nmfx_torch.device import explicit_device, resolve_device
from nmfx_torch.ops import fused_mu
card = explicit_device(resolve_device(None))
torch.zeros(1, device=card)  # reach the card while the parent searches
deadline = time.monotonic() + float(limit)
while not os.path.exists(go):
    if time.monotonic() > deadline:
        sys.exit("autotune worker: no go file")
    time.sleep(0.05)
spec = json.load(open(go))
cfg = SolverConfig(backend="pallas",
                   experimental=ExperimentalConfig(autotune="on"))
fused_mu.reset_launch_counts()
s0, h0 = autotune.searches_total.total(), autotune.hits_total.total()
t0 = time.perf_counter()
got = autotune.resolve(cfg, *spec["shape"], cache_dir=cache_dir,
                       device=card)
seconds = time.perf_counter() - t0
with open(out, "w") as f:
    json.dump({"repr": repr(got),
               "searches": autotune.searches_total.total() - s0,
               "hits": autotune.hits_total.total() - h0,
               "launches": sum(fused_mu.LAUNCHES.values()),
               "seconds": seconds}, f)
"""


def phase_autotune(torch, fm):
    """Phase 16 (see the module docstring): the block-shape autotuner's
    cold searches on the card (raw launches of rows 3, 4 and 5), a fresh
    interpreter served from the store, and the tuned sweep against the
    explicit and the default ones. Returns each part's launches."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix=".autotune_smoke_",
                                     dir=HERE) as scratch:
        return _phase_autotune(torch, fm, scratch)


def _search_probe(fm, autotune):
    """Wrap the autotuner's candidate timer and the block rows' plain
    versions: each search's launches of rows 3, 4 and 5 and any plain
    version run inside it are counted. Returns (probe, restore)."""
    probe = {"timed": [], "launches": dict.fromkeys(TUNED_ROWS, 0),
             "plain": 0, "searching": False}
    real_time = autotune._time_candidate
    real_refs = {name: getattr(fm, name) for name in (
        "fused_block_iterations_ref", "hals_block_iterations_ref")}

    def timed(cfg, cand, *args, **kw):
        before = {name: fm.LAUNCHES.get(name, 0) for name in TUNED_ROWS}
        probe["searching"] = True
        try:
            t = real_time(cfg, cand, *args, **kw)
        finally:
            probe["searching"] = False
        for name in TUNED_ROWS:
            probe["launches"][name] += fm.LAUNCHES.get(name, 0) - before[name]
        probe["timed"].append((dict(cand), t))
        return t

    def counted(fn):
        def plain(*args, **kw):
            if probe["searching"]:
                probe["plain"] += 1
            return fn(*args, **kw)
        return plain

    autotune._time_candidate = timed
    for name, fn in real_refs.items():
        setattr(fm, name, counted(fn))

    def restore():
        autotune._time_candidate = real_time
        for name, fn in real_refs.items():
            setattr(fm, name, fn)

    return probe, restore


def _check_search(label, probe, before, store_entry, rows):
    """A cold search's gates: every candidate launched once to warm and
    three times timed on its row, no other row, no plain version."""
    timed = probe["timed"][before:]
    want = dict.fromkeys(TUNED_ROWS, 0)
    for cand, _ in timed:
        want[rows(cand)] += 4
    got = probe["launches"]
    print(f"autotune {label}: {len(timed)} candidates, search launches "
          f"{got}, plain versions run {probe['plain']}", flush=True)
    for cand, t in timed:
        print(f"autotune {label} candidate bm{cand['block_m']} cb"
              f"{cand['check_block']} {cand['fused_updates']}: "
              f"{t * 1e3:.4f} ms/iteration", flush=True)
    best = store_entry["best"]
    t_best = min(t for _, t in timed)
    print(f"autotune {label} winner {best}: {t_best * 1e3:.4f} "
          "ms/iteration", flush=True)
    if got != want or probe["plain"]:
        raise AssertionError(
            f"autotune {label}: search launches {got} (want {want}: each "
            f"candidate once to warm and {3} times timed), plain versions "
            f"run {probe['plain']}")
    if len(store_entry["timings"]) != len(timed):
        raise AssertionError(f"autotune {label}: the stored entry holds "
                             f"{len(store_entry['timings'])} timings for "
                             f"{len(timed)} candidates")


def _phase_autotune(torch, fm, scratch):
    import nmfx_torch
    from nmfx_torch import autotune
    from nmfx_torch.config import (ConsensusConfig, ExecCacheConfig,
                                   ExperimentalConfig)
    from nmfx_torch.exec_cache import ExecCache
    from nmfx_torch.sweep import resolve_autotune

    m, n, r, _ = NORTH_STAR
    a = north_star_matrix()
    card0 = torch.device("cuda", 0)
    cache_dir = os.path.join(scratch, "cache")
    store = os.path.join(cache_dir, "autotune")
    go = os.path.join(scratch, "go.json")
    out = os.path.join(scratch, "resolve.json")
    # 16c's interpreter starts first: it reaches the card while 16a-b run
    t_proc = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", _AUTOTUNE_WORKER, HERE, store, go, out,
         str(AUTOTUNE_PROC_TIMEOUT_S)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    probe, restore = _search_probe(fm, autotune)
    launched = {}
    try:
        def counters():
            return (autotune.searches_total.total(),
                    autotune.hits_total.total())

        def entries():
            return {name: json.load(open(os.path.join(store, name)))
                    for name in sorted(os.listdir(store))
                    if name.endswith(".json")}

        def tuned(**kw):
            return nmfx_torch.SolverConfig(
                backend="pallas",
                experimental=ExperimentalConfig(autotune="on"), **kw)

        # 16a: mu, cold, the whole grid through an executable cache whose
        # directory holds the store (the command line's --cache-dir)
        cache = ExecCache(ExecCacheConfig(cache_dir=cache_dir),
                          device=card0)
        cfg = tuned()
        s0, h0 = counters()
        fm.reset_launch_counts()
        t0 = time.perf_counter()
        res = nmfx_torch.nmfconsensus(a, ks=KS, restarts=r, solver_cfg=cfg,
                                      exec_cache=cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched["16a"] = dict(fm.LAUNCHES)
        s1, h1 = counters()
        check_sweep(res, "autotune 16a", n)
        (entry,) = entries().values()
        _check_search("16a mu", probe, 0, entry,
                      lambda c: ("fused_block_iterations_fused"
                                 if c["fused_updates"] == "fused"
                                 else "fused_block_iterations"))
        if s1 - s0 != 1:
            raise AssertionError(f"autotune 16a: {s1 - s0} searches, "
                                 "want 1")
        resolved = resolve_autotune((m, n), ConsensusConfig(ks=KS,
                                                            restarts=r),
                                    cfg, exec_cache=cache)
        print(f"autotune 16a: wall {wall:.3f} s with the search, best k "
              f"{res.best_k}, sweep and search launches "
              f"{launched['16a']}, searches {s1 - s0:.0f}, hits "
              f"{h1 - h0:.0f}; "
              f"resolved check_block {resolved.check_block}, block_m "
              f"{resolved.experimental.block_m}, fused_updates "
              f"{resolved.experimental.fused_updates}", flush=True)
        with open(go + ".part", "w") as f:
            json.dump({"shape": [m, n, max(KS), min(SLOTS, r * len(KS))]},
                      f)
        os.replace(go + ".part", go)

        # 16b: hals, cold (TolFun armed: check_block 1, phased only)
        n_mu = len(probe["timed"])
        for key in TUNED_ROWS:
            probe["launches"][key] = 0
        s0, _ = counters()
        fm.reset_launch_counts()
        t0 = time.perf_counter()
        hres = nmfx_torch.nmfconsensus(
            a, ks=AUTOTUNE_HALS_KS, restarts=r,
            solver_cfg=tuned(algorithm="hals"), exec_cache=cache)
        torch.cuda.synchronize()
        hwall = time.perf_counter() - t0
        launched["16b"] = dict(fm.LAUNCHES)
        s1, _ = counters()
        check_sweep(hres, "autotune 16b", n)
        (hals_entry,) = [e for e in entries().values()
                         if e["key"] != entry["key"]]
        _check_search("16b hals", probe, n_mu, hals_entry,
                      lambda c: "hals_block_iterations")
        if s1 - s0 != 1:
            raise AssertionError(f"autotune 16b: {s1 - s0} searches, "
                                 "want 1")
        print(f"autotune 16b: hals at ks {AUTOTUNE_HALS_KS[0]}.."
              f"{AUTOTUNE_HALS_KS[-1]}: wall {hwall:.3f} s with the "
              f"search, best k {hres.best_k}, launches {launched['16b']}",
              flush=True)

        # 16c: the fresh interpreter resolves 16a's config from the store
        try:
            _, err = proc.communicate(timeout=AUTOTUNE_PROC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            raise AssertionError("autotune 16c: the fresh interpreter did "
                                 f"not finish in {AUTOTUNE_PROC_TIMEOUT_S}"
                                 " s")
        if proc.returncode != 0:
            raise AssertionError(f"autotune 16c: the fresh interpreter "
                                 f"exited {proc.returncode}: {err[-2000:]}")
        warm = json.load(open(out))
        print(f"autotune 16c: a fresh interpreter resolved in "
              f"{warm['seconds']:.4f} s ({time.perf_counter() - t_proc:.3f}"
              f" s from its start): searches {warm['searches']:.0f}, hits "
              f"{warm['hits']:.0f}, launches {warm['launches']}, same config "
              f"{warm['repr'] == repr(resolved)}", flush=True)
        if (warm["searches"] != 0 or warm["hits"] < 1
                or warm["launches"] != 0 or warm["repr"] != repr(resolved)):
            raise AssertionError(f"autotune 16c: {warm} against the "
                                 f"resolved {resolved!r}")
        launched["16c"] = warm["launches"]

        # 16d: the tuned sweep against the explicit and the default ones
        ks = AUTOTUNE_CHECK_KS
        runs = {}
        for label, scfg in (("tuned", tuned()), ("explicit", None),
                            ("default", nmfx_torch.SolverConfig(
                                backend="pallas"))):
            if scfg is None:
                scfg = resolve_autotune((m, n), ConsensusConfig(
                    ks=ks, restarts=r), tuned(), device=card0)
            fm.reset_launch_counts()
            t0 = time.perf_counter()
            got = nmfx_torch.nmfconsensus(a, ks=ks, restarts=r,
                                          solver_cfg=scfg)
            torch.cuda.synchronize()
            runs[label] = (got, time.perf_counter() - t0, scfg)
            launched[f"16d {label}"] = dict(fm.LAUNCHES)
            check_sweep(got, f"autotune 16d {label}", n)
        (t_res, t_wall, _), (e_res, e_wall, e_cfg), (d_res, d_wall, _) = (
            runs["tuned"], runs["explicit"], runs["default"])
        parted = byte_equal_ranks(t_res, e_res, ks)
        parted_default = byte_equal_ranks(t_res, d_res, ks)
        print(f"autotune 16d: tuned sweep (ks {ks[0]}..{ks[-1]}, "
              f"check_block {e_cfg.check_block}, block_m "
              f"{e_cfg.experimental.block_m}, "
              f"{e_cfg.experimental.fused_updates}) byte-equal to the "
              f"explicit one: {not parted} {parted}; walls tuned "
              f"{t_wall:.3f} s (with its search), explicit {e_wall:.3f} s, "
              f"default {d_wall:.3f} s; byte-equal to the default: "
              f"{not parted_default}", flush=True)
        if parted:
            raise AssertionError(f"autotune 16d: the tuned sweep parts "
                                 f"from the explicit one at {parted}")
        if t_res.best_k != d_res.best_k or any(
                not np.array_equal(t_res.per_k[k].membership,
                                   d_res.per_k[k].membership) for k in ks):
            raise AssertionError("autotune 16d: the tuned sweep's best k "
                                 "or memberships part from the default's")
    finally:
        restore()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return launched


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build, kernel parity and the block rows' device "
                         "time by kernel only")
    ap.add_argument("--tiles", action="store_true",
                    help="build, kernel parity and phase 12 (tiles and "
                         "sparse inputs) only")
    ap.add_argument("--scale", action="store_true",
                    help="build, kernel parity, the exact grids of 4a "
                         "and 4d and phase 13 (the scale engines) only")
    ap.add_argument("--grid-mesh", action="store_true",
                    help="build, kernel parity and phase 15 (the feature "
                         "and sample mesh axes, mesh serving) only")
    ap.add_argument("--autotune", action="store_true",
                    help="build, kernel parity and phase 16 (the block-"
                         "shape autotuner) only")
    ap.add_argument("--mesh", action="store_true",
                    help="build, kernel parity, the exact grids of 4a "
                         "and 4d and phase 14 (bf16 off the kernels, the "
                         "restart mesh, two processes, elastic shards) "
                         "only")
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
    start = clock = time.perf_counter()
    spent = {}

    def done(label):
        """Book the phase that just ended. Its line goes to standard error
        as well, so a run stopped at its time limit shows how far it got
        and where the time went."""
        nonlocal clock
        now = time.perf_counter()
        spent[label] = round(now - clock, 3)
        clock = now
        print(f"chip_smoke: {label} {spent[label]:.1f} s, "
              f"{now - start:.1f} s in", file=sys.stderr, flush=True)

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
    print_hgmma(_build, "block_mu")
    print_hgmma(_build, "hals_block")
    done("1 build")

    ns_err = phase_parity(torch, fm)
    ns_err.update(phase_block_parity(torch, fm))
    phase_pair_equality(torch, fm)
    ns_err["hals_block_iterations"] = phase_hals_parity(torch, fm)
    done("2 parity")
    ns_err.update(phase_float64_parity(torch, fm))
    done("2 float64 parity")
    ns_err.update(phase_option_parity(torch, fm))
    done("2 option parity")
    if args.quick:
        phase_kernel_split(torch, fm)
        done("3 kernel split")
    if args.tiles:
        tiled = phase_tiles(torch, fm)
        done("12 tiles")
        print(f"tiles phase {spent['12 tiles']:.3f} s; launches by run "
              f"{tiled}", flush=True)
    if args.scale:
        _, phased, _ = phase_grid_path(torch, fm)
        _, hals_res, _ = phase_hals_path(torch, fm)
        done("4a,d main paths")
        scaled = phase_scale_engines(torch, fm, {"mu": phased,
                                                 "hals": hals_res})
        done("13 scale engines")
        print(f"scale phase {spent['13 scale engines']:.3f} s; launches "
              f"by run {scaled}", flush=True)
    elif args.grid_mesh:
        gridded = phase_grid_mesh(torch, fm)
        done("15 grid mesh")
        print(f"grid mesh phase {spent['15 grid mesh']:.3f} s; launches "
              f"by run {gridded}", flush=True)
    elif args.autotune:
        tuned = phase_autotune(torch, fm)
        done("16 autotune")
        print(f"autotune phase {spent['16 autotune']:.3f} s; launches by "
              f"run {tuned}", flush=True)
    elif args.mesh:
        _, phased, _ = phase_grid_path(torch, fm)
        _, hals_res, _ = phase_hals_path(torch, fm)
        done("4a,d main paths")
        meshed = phase_mesh(torch, fm, phased, hals_res)
        done("14 mesh")
        print(f"mesh phase {spent['14 mesh']:.3f} s; launches by run "
              f"{meshed}", flush=True)
    elif not args.quick and not args.tiles:
        rates = peaks(kind)
        timing = phase_timing(torch, fm, rates)[NORTH_STAR[3]]
        timing.update(phase_block_timing(torch, fm, rates))
        timing.update(phase_option_timing(torch, fm, rates))
        timing.update(phase_float64_timing(torch, fm, rates))
        done("3 timing")
        # byte-equal to the unaliased launch (phase_option_parity), so
        # its error against the plain version is the default launch's
        ns_err["fused_block_iterations[alias_io]"] = ns_err[
            "fused_block_iterations"]
        # each kernel's launches come from its own main path's run
        launches, phased, phased_wall = phase_grid_path(torch, fm)
        grid = (phased, phased_wall, launches["fused_block_iterations"])
        launches["fused_block_iterations_fused"] = phase_fused_grid_path(
            torch, fm, phased, phased_wall)["fused_block_iterations_fused"]
        per_rank, per_rank_res, per_rank_wall = phase_per_rank_path(
            torch, fm, phased)
        for name in ("fused_h_update", "fused_w_update"):
            launches[name] = per_rank[name]
        hals_n, hals_res, hals_wall = phase_hals_path(torch, fm)
        launches["hals_block_iterations"] = hals_n["hals_block_iterations"]
        done("4a-d main paths")
        launches.update(phase_option_paths(
            torch, fm, {"grid": (phased, phased_wall),
                        "per_k": (per_rank_res, per_rank_wall),
                        "hals": (hals_res, hals_wall)}))
        done("4f option paths")
        phase_host_tail(torch, fm)
        done("4e host tail")
        phase_checks(torch, fm)
        done("5 agreement")
        phase_profile(torch)
        done("6 profiles")
        phase_solvers(torch, fm)
        done("7 solvers")
        durable = phase_durability(torch, fm, phased, per_rank_res,
                                   hals_res)
        done("8 durability")
        for name, (route, row) in F64_LAUNCHES.items():
            launches[name] = durable[f"g {route} float64"].get(row, 0)
        print(f"durability phase {spent['8 durability']:.3f} s; "
              f"launches by run {durable}", flush=True)
        observed = phase_obs(torch, fm, grid)
        done("9 observability")
        print(f"observability phase {spent['9 observability']:.3f} s; "
              f"launches by run {observed}", flush=True)
        serving = phase_serve(torch, fm)
        done("10 serving")
        print(f"serving phase {spent['10 serving']:.3f} s; launches "
              f"by run {serving}", flush=True)
        fleet = phase_fleet(torch, fm)
        done("11 fleet")
        print(f"fleet phase {spent['11 fleet']:.3f} s; launches "
              f"by run {fleet}", flush=True)
        tiled = phase_tiles(torch, fm)
        done("12 tiles")
        print(f"tiles phase {spent['12 tiles']:.3f} s; launches by run "
              f"{tiled}", flush=True)
        scaled = phase_scale_engines(torch, fm, {"mu": phased,
                                                 "hals": hals_res})
        done("13 scale engines")
        print(f"scale phase {spent['13 scale engines']:.3f} s; launches "
              f"by run {scaled}", flush=True)
        meshed = phase_mesh(torch, fm, phased, hals_res, per_rank_res)
        done("14 mesh")
        print(f"mesh phase {spent['14 mesh']:.3f} s; launches by run "
              f"{meshed}", flush=True)
        gridded = phase_grid_mesh(torch, fm)
        done("15 grid mesh")
        print(f"grid mesh phase {spent['15 grid mesh']:.3f} s; launches "
              f"by run {gridded}", flush=True)
        tuned = phase_autotune(torch, fm)
        done("16 autotune")
        print(f"autotune phase {spent['16 autotune']:.3f} s; launches by "
              f"run {tuned}", flush=True)
        print(f"phase seconds {json.dumps(spent)}; "
              f"{time.perf_counter() - start:.3f} s in all", flush=True)
        kernels = []
        for name, source, line in (
                ("fused_h_update", "block_mu.cu", 147),
                ("fused_w_update", "block_mu.cu", 731),
                ("fused_block_iterations", "block_mu.cu", 539),
                ("fused_block_iterations_fused", "block_mu.cu", 382),
                ("hals_block_iterations", "hals_block.cu", 984),
                # the option variants the option paths run
                ("fused_h_update[bf16]", "block_mu.cu", 147),
                ("fused_w_update[bf16]", "block_mu.cu", 731),
                ("fused_block_iterations[bf16]", "block_mu.cu", 539),
                ("fused_block_iterations[bfloat16_w]", "block_mu.cu", 539),
                ("fused_block_iterations[seg_ids]", "block_mu.cu", 539),
                ("fused_block_iterations[alias_io]", "block_mu.cu", 539),
                ("hals_block_iterations[bf16]", "hals_block.cu", 984),
                # the float64 kernel routes of phase 8g
                ("fused_h_update[float64]", "block_mu.cu", 147),
                ("fused_w_update[float64]", "block_mu.cu", 731),
                ("fused_block_iterations[float64]", "block_mu.cu", 539),
                ("hals_block_iterations[float64]", "hals_block.cu", 984),
                ("fused_block_iterations[bf16,float64]", "block_mu.cu",
                 539)):
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
