"""Command-line entry point (counterpart of ``nmfx/cli.py``).

Mirrors the reference's ``runNMFinJobs`` arguments plus the knobs its C
layer kept behind compile flags: solver choice, init scheme,
tolerances, output directory.

    python -m nmfx_torch data.gct --ks 2-5 --restarts 10 --algorithm mu

The options are the reference package's — the same option strings,
destinations, defaults and choices — plus one it lacks, ``--device``:
the reference picks its platform through ``JAX_PLATFORMS``, the port
runs on the card unless given ``--device cpu`` (the plain PyTorch
versions). Without a card and without ``--device cpu`` every entry
point here (``main``, ``router_main``) exits with a usage error; it
never moves to the CPU by itself. Messages and exit codes are the
reference's everywhere else.

Meshes: ``--restart-shards N`` and ``--feature-shards`` /
``--sample-shards`` build the reference's N × F × S grid mesh (with
``--device cpu`` the CPU named once an entry); ``--replicas N
--replica-mesh SPECS`` gives the serving smoke run's replicas their
meshes.

Refused, each with a usage error (exit 2) that names its ROADMAP item:

* serialized XLA executables (``ROADMAP_WARM``): ``--cache-dir`` and an
  explicit ``--compile-cache DIR``. The default ``--compile-cache``
  value and ``--no-compile-cache`` are accepted and do nothing: the
  kernels' libraries are cached by source hash already;
* ``--autotune`` (``ROADMAP_TOOLING``).

Out of core: ``--tile-rows N|auto`` (and ``--tile-budget-bytes``)
streams a dense input through the tile pipeline, and a sparse ``.mtx`` /
``.csr.npz`` dataset always streams; what does not compose with that
(another algorithm, the kernels, the executable cache, the serving smoke
run, ``--grid-exec grid``) is a usage error with the reference's words.

The compressed paths: ``--backend sketched`` (the sketched engine,
result tagged ``quality = sketched``), ``--screen --screen-keep K``
(restart screening) and ``--sketch-dim R``, with the reference's
meanings and its usage errors for what does not compose with them.

Plots: the reference's plot set (``nmfx_torch/plots.py``), written as
the reference writes it, none where matplotlib is absent; ``--no-plots``
writes none.
"""

from __future__ import annotations

import argparse
import os
import sys

from nmfx_torch.config import (ALGORITHMS, INIT_METHODS, LINKAGE_METHODS,
                               PACKED_ALGORITHMS,
                               ROADMAP_TOOLING, ROADMAP_WARM, VERSION)

#: the reference's default persistent XLA compilation-cache location;
#: kept as the default so the option's default equals the reference's.
#: The port compiles no XLA program: the default and
#: ``--no-compile-cache`` do nothing, another directory is refused
_DEFAULT_COMPILE_CACHE = os.path.join(
    os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
    "nmfx", "xla")


def parse_ks(spec: str) -> tuple[int, ...]:
    """'2-5' or '2,3,4,5' or '3' -> tuple of ranks."""
    ks: list[int] = []
    for part in spec.split(","):
        part = part.strip()
        if "-" in part[1:]:
            lo, hi = part.split("-")
            ks.extend(range(int(lo), int(hi) + 1))
        else:
            ks.append(int(part))
    return tuple(ks)


def _tail_slots_arg(value: str):
    """'auto', a non-negative int, or a comma-separated decreasing
    cascade like '24,8' — validated at parse time so a bad value is a
    usage error, not a late ValueError traceback."""
    if value == "auto":
        return value
    try:
        widths = tuple(int(part) for part in value.split(","))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected 'auto', a non-negative integer, or a "
            f"comma-separated cascade (e.g. '24,8'), got {value!r}")
    if len(widths) == 1:
        if widths[0] < 0:
            raise argparse.ArgumentTypeError(
                f"expected a non-negative integer, got {value!r}")
        return widths[0]
    if any(w < 1 for w in widths):
        raise argparse.ArgumentTypeError(
            f"cascade widths must be >= 1, got {value!r}")
    if any(b >= a for a, b in zip(widths, widths[1:])):
        raise argparse.ArgumentTypeError(
            f"cascade widths must be strictly decreasing, got {value!r}")
    return widths


def _check_block_arg(value: str):
    """'auto' or a positive int — validated at parse time."""
    if value == "auto":
        return value
    try:
        n = int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected 'auto' or a positive integer, got {value!r}")
    if n < 1:
        raise argparse.ArgumentTypeError(
            f"check-block must be >= 1, got {value!r}")
    return n


def _tile_rows_arg(value: str):
    """'auto' or a positive int — validated at parse time."""
    if value == "auto":
        return value
    try:
        n = int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected 'auto' or a positive integer, got {value!r}")
    if n < 1:
        raise argparse.ArgumentTypeError(
            f"tile-rows must be >= 1, got {value!r}")
    return n


def _warm_shapes_arg(value: str) -> tuple[tuple[int, int], ...]:
    """'5000x500,20000x1000' -> ((5000, 500), (20000, 1000)); validated
    at parse time so a bad spec is a usage error."""
    shapes = []
    for part in value.split(","):
        try:
            m, n = part.strip().lower().split("x")
            shapes.append((int(m), int(n)))
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"expected comma-separated MxN shapes (e.g. "
                f"'5000x500,20000x1000'), got {value!r}")
        if shapes[-1][0] < 1 or shapes[-1][1] < 1:
            raise argparse.ArgumentTypeError(
                f"shape dims must be >= 1, got {part.strip()!r}")
    return tuple(shapes)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nmfx-torch",
        description="Consensus NMF in PyTorch with hand-written CUDA "
                    "kernels for NVIDIA Hopper (capabilities of "
                    "mschubert/NMFconsensus).")
    p.add_argument("dataset",
                   help="input .gct or .res file (dense), or a sparse "
                        ".mtx / .csr.npz file (streamed through the "
                        "out-of-core tile pipeline)")
    p.add_argument("--ks", default="2-5", type=parse_ks,
                   help="ranks to sweep, e.g. '2-5' or '2,4,8' (default 2-5)")
    p.add_argument("--restarts", type=int, default=10,
                   help="random restarts per rank (default 10)")
    p.add_argument("--maxiter", type=int, default=10000,
                   help="max solver iterations (default 10000)")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--algorithm", choices=ALGORITHMS, default="mu")
    p.add_argument("--precision", default="default",
                   choices=("default", "bfloat16", "highest"),
                   help="product precision: 'default' and 'highest' are "
                        "full float32; 'bfloat16' rounds every product's "
                        "operands to bf16 on the card (the kernels' and "
                        "the plain products'; the CPU ignores it)")
    p.add_argument("--backend", default="auto",
                   choices=("auto", "vmap", "packed", "pallas",
                            "sketched"),
                   help="restart-batch execution strategy (auto = the "
                        "whole-grid scheduler for mu/hals, the batched "
                        "restart route otherwise; 'pallas' = the "
                        "hand-written CUDA kernels; 'sketched' = the "
                        "random-projection compressed engine — "
                        "approximate, statistical accuracy contract at "
                        "the consensus level, result tagged "
                        "quality='sketched'; mu/hals only)")
    p.add_argument("--sketch-dim", type=int, default=None, metavar="R",
                   help="sketch dimension of the compressed engine / "
                        "screening pass (SketchConfig.dim; default "
                        "'auto' = 4k+8 per rank, clamped to the matrix "
                        "dims). Requires --backend sketched or --screen")
    p.add_argument("--screen", action="store_true",
                   help="restart screening (SolverConfig.screen): a "
                        "cheap sketched pass scores the full restart "
                        "pool and only the --screen-keep best lanes "
                        "get exact iterations; screened-out lanes are "
                        "masked from the consensus like pad lanes (the "
                        "min_restarts floor counts them as "
                        "non-survivors). mu/hals with --backend "
                        "auto/vmap")
    p.add_argument("--screen-keep", type=int, default=None, metavar="K",
                   help="survivors of the screening pass per rank "
                        "(required with --screen; must be <= "
                        "--restarts)")
    p.add_argument("--restart-chunk", type=int, default=None,
                   help="cap on restarts solved concurrently on the "
                        "batched restart route (bounds peak memory for "
                        "kl's m*n intermediates; results are identical)")
    p.add_argument("--tile-rows", default=None, type=_tile_rows_arg,
                   metavar="N|auto",
                   help="out-of-core tile pipeline "
                        "(SolverConfig.tile_rows): stream A from the host "
                        "in N-row feature blocks instead of keeping it on "
                        "the device. 'auto' sizes tiles to the device "
                        "budget (--tile-budget-bytes). mu/hals; where A "
                        "fits in one tile the sweep is byte-equal to the "
                        "dense one. Sparse .mtx/.csr.npz inputs stream "
                        "regardless of this flag")
    p.add_argument("--tile-budget-bytes", type=int, default=None,
                   metavar="BYTES",
                   help="device-memory budget the 'auto' tile size is "
                        "derived from (default: NMFX_TILE_BUDGET_BYTES "
                        "env or 256 MiB; two tile buffers live at once "
                        "— current + prefetched)")
    p.add_argument("--check-block", default="auto", type=_check_block_arg,
                   help="check blocks batched per scheduler trip "
                        "(SolverConfig.check_block): 'auto' (default) = "
                        "4 on the block-kernel scheduler, 1 elsewhere")
    p.add_argument("--autotune", action="store_true",
                   help="kernel-schedule autotuning (not ported, "
                        f"{ROADMAP_TOOLING})")
    p.add_argument("--rank-selection", default="host",
                   choices=("host", "device"),
                   help="where hclust/cophenetic/cutree run: the host "
                        "(native C++) or the device")
    p.add_argument("--init", choices=INIT_METHODS, default="random")
    p.add_argument("--linkage", choices=LINKAGE_METHODS,
                   default="average",
                   help="hclust linkage for rank selection (reference: "
                        "average)")
    p.add_argument("--label-rule", choices=("argmax", "argmin"),
                   default="argmax",
                   help="cluster label rule; argmin reproduces the reference "
                        "R layer's observed (buggy) assignment")
    p.add_argument("--verbose", action="store_true",
                   help="log per-rank progress while the sweep runs")
    p.add_argument("--save-result", default=None, metavar="PATH",
                   help="also persist the full ConsensusResult as one npz "
                        "(reload with nmfx_torch.ConsensusResult.load)")
    p.add_argument("--version", action="version",
                   version="%(prog)s " + VERSION)
    p.add_argument("--outdir", default="./nmfx_out")
    p.add_argument("--no-plots", action="store_true",
                   help="write no plot files")
    p.add_argument("--no-files", action="store_true",
                   help="print the summary only, write nothing")
    p.add_argument("--no-mesh", action="store_true",
                   help="disable sharding over the local device mesh")
    p.add_argument("--feature-shards", type=int, default=1,
                   help="tile each factorization's rows (A, W) across this "
                        "many devices (default 1 = off; with --device cpu "
                        "the CPU is named that many times)")
    p.add_argument("--sample-shards", type=int, default=1,
                   help="tile each factorization's columns (A, H) across "
                        "this many devices (default 1 = off)")
    p.add_argument("--restart-shards", type=int, default=None,
                   metavar="N",
                   help="restart-sharded mesh over N devices (with "
                        "--device cpu, the CPU named N times); composes "
                        "with --feature-shards/--sample-shards into an "
                        "N x F x S grid mesh")
    p.add_argument("--checkpoint-dir", default=None,
                   help="durable sweep ledger: persist per-(rank, "
                        "restart-chunk) completion records here — a "
                        "killed run loses at most the chunk in flight, "
                        "and a re-run resumes byte-equal, recomputing "
                        "only the missing chunks")
    p.add_argument("--checkpoint-every", type=int, default=None,
                   metavar="N",
                   help="restarts per completion record (default: one "
                        "record per rank). Requires --checkpoint-dir")
    p.add_argument("--resume", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="with --checkpoint-dir: resume from records "
                        "already in the ledger (the default); "
                        "--no-resume clears them and recomputes from "
                        "scratch")
    p.add_argument("--keep-factors", action="store_true",
                   help="retain every restart's (W, H) in the result; "
                        "pairs with --save-result for offline "
                        "restart-level analysis via nmfx_torch.reduce_grid")
    p.add_argument("--grid-exec", default="auto",
                   choices=("auto", "grid", "per_k"),
                   help="(k x restart) grid execution: 'auto' solves every "
                        "rank in one whole-grid slot-scheduled batch when "
                        "eligible; 'per_k' forces sequential ranks; 'grid' "
                        "demands the whole-grid path")
    p.add_argument("--grid-slots", type=int, default=48,
                   help="slot-pool width of the whole-grid scheduler "
                        "(default 48)")
    p.add_argument("--grid-tail-slots", default="auto",
                   type=_tail_slots_arg,
                   help="straggler-tail cascade of the whole-grid "
                        "scheduler: an int or comma-separated decreasing "
                        "widths (e.g. '24,8'); 'auto' (default); 0 "
                        "disables")
    p.add_argument("--exec-cache", action="store_true",
                   help="serve the sweep through the shape-bucketed "
                        "sweep cache (nmfx_torch.exec_cache): one built "
                        "sweep per padded-shape bucket")
    p.add_argument("--warm-shapes", default=None, metavar="MxN[,MxN...]",
                   type=_warm_shapes_arg,
                   help="build the exec-cache entries for these dataset "
                        "shapes' buckets before the run (e.g. "
                        "'5000x500'); implies --exec-cache")
    p.add_argument("--cache-dir", default=None, metavar="DIR",
                   help="persistent executable cache (not ported: "
                        f"serialized XLA executables, {ROADMAP_WARM})")
    p.add_argument("--result-cache-dir", default=None, metavar="DIR",
                   help="content-addressed finished-result cache "
                        "(nmfx_torch.result_cache): a repeat invocation "
                        "is served with zero solve dispatches")
    p.add_argument("--pipeline-ranks", action="store_true",
                   help="serve each rank through its own bucketed sweep "
                        "(ExecCacheConfig.pipeline_ranks); implies "
                        "--exec-cache")
    p.add_argument("--input-cache-bytes", type=int, default=None,
                   metavar="N",
                   help="byte cap for the device-resident input cache; "
                        "0 disables retention")
    p.add_argument("--warm-cache", action="store_true",
                   help="run the --warm-shapes warmup in the background. "
                        "Requires --warm-shapes")
    p.add_argument("--serve-smoke", action="store_true",
                   help="route the run through the multi-tenant serving "
                        "engine (nmfx_torch.serve.NMFXServer) and report "
                        "the serve counters and per-request spans to "
                        "stderr; results are byte-equal to a run through "
                        "the same executable cache")
    p.add_argument("--replicas", type=int, default=None, metavar="N",
                   help="with --serve-smoke: route the request through an "
                        "NMFXRouter over N in-process replica servers "
                        "(nmfx_torch.replica.ReplicaPool, thread mode)")
    p.add_argument("--router-spill-dir", default=None, metavar="DIR",
                   help="with --replicas: root directory of the replica "
                        "pool's spill/heartbeat ledger (default: a "
                        "temporary directory)")
    p.add_argument("--replica-mesh", default=None, metavar="SPECS",
                   help="with --replicas: comma-separated per-replica "
                        "mesh specs making the fleet heterogeneous; each "
                        "entry is R, RxF, or RxFxS (that replica owns a "
                        "carved block of r*f*s entries of the pool's "
                        "devices) or '-' for a plain 1-device replica, "
                        "e.g. --replicas 2 --replica-mesh -,1x2. The "
                        "router prices placement across the classes")
    p.add_argument("--compile-cache", default=_DEFAULT_COMPILE_CACHE,
                   metavar="DIR",
                   help="the reference's persistent XLA compilation "
                        "cache: the default does nothing here, another "
                        f"directory is refused ({ROADMAP_WARM})")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="accepted; there is no XLA compilation cache")
    p.add_argument("--profile", action="store_true",
                   help="print a per-phase wall-clock breakdown")
    p.add_argument("--trace-dir", default=None,
                   help="with --profile: also capture a torch.profiler "
                        "trace (Chrome JSON) into this directory")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="record the run through the structured span "
                        "tracer (nmfx_torch.obs.trace) and write Chrome "
                        "trace-event JSON here")
    p.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="write the process-wide metrics registry as "
                        "Prometheus text exposition after the run")
    p.add_argument("--perf-report", action="store_true",
                   help="print the per-dispatch roofline attribution "
                        "report after the run (nmfx_torch.obs.costmodel); "
                        "runs the sweep with phase timing enabled")
    p.add_argument("--telemetry-dir", default=None, metavar="DIR",
                   help="with --serve-smoke: publish this process's "
                        "telemetry snapshots into DIR (watch them with "
                        "python -m nmfx_torch.obs.top DIR)")
    p.add_argument("--metrics-port", type=int, default=None,
                   metavar="PORT",
                   help="with --serve-smoke: also serve the registry's "
                        "Prometheus exposition over HTTP on PORT")
    p.add_argument("--slo", action="store_true",
                   help="with --serve-smoke: print the SLO burn-rate "
                        "status to stderr after the run")
    p.add_argument("--flight-dir", default=None, metavar="DIR",
                   help="arm the crash flight recorder's disk dump (a "
                        "serve scheduler crash or SIGTERM writes the last "
                        "events here)")
    p.add_argument("--device", default=None,
                   help="the device to run on: the CUDA card (default) or "
                        "'cpu' for the plain PyTorch versions")
    return p


#: one SIGTERM flight-dump hook per process: repeated in-process
#: main() calls with --flight-dir must not chain a handler per run
_signal_dump_installed = False


def _resolve_device(parser, device):
    """``device`` resolved (None = the card); a usage error when it
    cannot run here — never a quiet move to the CPU."""
    from nmfx_torch.device import explicit_device, resolve_device

    try:
        return explicit_device(resolve_device(device))
    except (RuntimeError, ValueError) as e:
        parser.error(f"--device: {e}")


def main(argv: list[str] | None = None) -> int:
    """CLI entry. Wraps the run so the process-wide structured tracer
    and tile budget never outlive this invocation's ``--trace-out`` and
    ``--tile-budget-bytes``."""
    from nmfx_torch import tiles
    from nmfx_torch.obs import trace as obs_trace

    enabled_before = obs_trace.default_tracer().enabled
    budget_before = tiles._budget_override
    try:
        return _run_cli(argv)
    finally:
        obs_trace.default_tracer().enabled = enabled_before
        tiles._budget_override = budget_before


def _refuse_unported(parser, args) -> None:
    """The usage errors of the options the port has not got, each
    naming its ROADMAP item."""
    if args.autotune:
        parser.error("--autotune: the kernel autotuner is not ported yet "
                     f"({ROADMAP_TOOLING})")
    if args.cache_dir is not None:
        parser.error("--cache-dir: serialized XLA executables have no "
                     f"torch counterpart ({ROADMAP_WARM}); the kernels' "
                     "libraries are cached by source hash already")
    if (args.compile_cache != _DEFAULT_COMPILE_CACHE
            and not args.no_compile_cache):
        parser.error("--compile-cache: the port compiles no XLA program "
                     f"({ROADMAP_WARM}); drop the option")


def _check_sketched(parser, args) -> None:
    """The reference's usage errors of ``--backend sketched``,
    ``--screen``, ``--screen-keep`` and ``--sketch-dim``."""
    from nmfx_torch.config import SKETCHED_ALGORITHMS

    if (args.backend == "sketched"
            and args.algorithm not in SKETCHED_ALGORITHMS):
        parser.error("--backend sketched is only implemented for "
                     f"--algorithm {'/'.join(SKETCHED_ALGORITHMS)} "
                     "(the Gram-family updates the projections "
                     "compress)")
    if args.screen:
        if args.algorithm not in SKETCHED_ALGORITHMS:
            parser.error("--screen needs a sketched screening pass, "
                         "which only --algorithm "
                         f"{'/'.join(SKETCHED_ALGORITHMS)} has")
        if args.backend not in ("auto", "vmap"):
            parser.error("--screen runs its exact phase through the "
                         "vmapped driver (the survivor bit-identity "
                         "contract); use --backend auto or vmap")
        if args.screen_keep is None:
            parser.error("--screen requires --screen-keep (how many "
                         "survivors get exact iterations)")
        if not 1 <= args.screen_keep <= args.restarts:
            parser.error(f"--screen-keep must be in [1, --restarts="
                         f"{args.restarts}], got {args.screen_keep}")
        if args.keep_factors:
            parser.error("--screen does not compose with "
                         "--keep-factors (screened-out lanes never "
                         "receive exact iterations, so there is no "
                         "full factor grid to keep)")
    elif args.screen_keep is not None:
        parser.error("--screen-keep requires --screen")
    if args.sketch_dim is not None:
        if args.sketch_dim < 1:
            parser.error("--sketch-dim must be >= 1")
        if args.backend != "sketched" and not args.screen:
            parser.error("--sketch-dim only applies to the compressed "
                         "paths; pass --backend sketched or --screen")


def _check_sketched_compose(parser, args) -> None:
    """The reference's compose guards of the statistical-contract
    paths: every surface whose contract is bit-exact (or whose resume
    replays exact records) refuses them."""
    if not (args.backend == "sketched" or args.screen):
        return
    if args.rank_selection == "device":
        parser.error("--backend sketched/--screen carry a "
                     "STATISTICAL accuracy contract; "
                     "--rank-selection device exists for bit-exact "
                     "pipelines — use the host path")
    if args.checkpoint_dir is not None:
        parser.error("--backend sketched/--screen do not compose "
                     "with --checkpoint-dir (the durable ledger "
                     "replays per-chunk records bit-identically; "
                     "the sketched/screened paths are whole-pool "
                     "and statistical)")
    if args.serve_smoke:
        parser.error("--serve-smoke gates served results "
                     "bit-identical to the direct path; the "
                     "sketched/screened engines are statistical — "
                     "drop --backend sketched/--screen")
    if (args.exec_cache or args.warm_shapes or args.cache_dir
            or args.pipeline_ranks):
        parser.error("--backend sketched/--screen are not exec-"
                     "cacheable (no slot-scheduled form; see "
                     "ExecCache.cacheable) — drop --exec-cache/"
                     "--warm-shapes/--cache-dir/--pipeline-ranks")
    if args.grid_exec == "grid":
        parser.error("--grid-exec grid demands the whole-grid slot "
                     "scheduler, which has no sketched/screened "
                     "form; use auto (falls back per-k)")
    if args.feature_shards > 1 or args.sample_shards > 1:
        parser.error("--backend sketched/--screen are restart-"
                     "parallel only (per-restart projections have "
                     "no feature/sample-sharded formulation)")


def _check_tiles(parser, args) -> None:
    """The reference's usage errors for what does not compose with the
    out-of-core tile pipeline, then ``--tile-budget-bytes`` applied."""
    sparse_input = args.dataset.lower().endswith((".mtx", ".csr.npz"))
    if args.tile_rows is not None or sparse_input:
        from nmfx_torch.config import TILED_ALGORITHMS

        what = ("--tile-rows" if args.tile_rows is not None
                else "sparse inputs")
        if args.algorithm not in TILED_ALGORITHMS:
            parser.error(f"{what} require(s) the Gram-accumulating "
                         f"update family: --algorithm "
                         f"{'/'.join(TILED_ALGORITHMS)}")
        if args.backend in ("pallas", "sketched") or args.screen:
            parser.error(f"{what} stream(s) A tile-by-tile through the "
                         "out-of-core engine; --backend pallas/sketched "
                         "and --screen need the whole matrix device-"
                         "resident — use --backend auto")
        if args.feature_shards > 1 or args.sample_shards > 1 \
                or args.restart_shards is not None:
            parser.error(f"{what} do(es) not compose with --restart-"
                         "shards/--feature-shards/--sample-shards (the "
                         "tile stream owns one device; shard across "
                         "processes with nmfx_torch.distributed "
                         "instead)")
        if args.exec_cache or args.warm_shapes or args.cache_dir \
                or args.pipeline_ranks:
            parser.error(f"{what} do(es) not compose with --exec-cache/"
                         "--warm-shapes/--cache-dir/--pipeline-ranks "
                         "(the bucketed executable cache dispatches "
                         "whole-matrix device solves)")
        if args.serve_smoke:
            parser.error(f"{what} do(es) not compose with --serve-smoke "
                         "(served requests dispatch through the "
                         "executable cache)")
        if args.grid_exec == "grid":
            parser.error(f"{what} solve(s) per rank over the tile "
                         "stream; --grid-exec grid demands the whole-"
                         "grid scheduler — use auto")
    elif args.tile_budget_bytes is not None:
        parser.error("--tile-budget-bytes requires --tile-rows (or a "
                     "sparse .mtx/.csr.npz input)")
    if args.tile_budget_bytes is not None:
        from nmfx_torch import tiles

        try:
            tiles.set_tile_budget_bytes(args.tile_budget_bytes)
        except ValueError as e:
            parser.error(str(e))


def _run_cli(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not os.path.isfile(args.dataset):
        parser.error(f"dataset not found: {args.dataset}")
    if args.trace_dir and not args.profile:
        parser.error("--trace-dir requires --profile")
    if not args.ks:
        # e.g. a descending range '5-3' parses to no ranks at all
        parser.error("--ks selects no ranks (use e.g. '2-5', '2,3,4' "
                     "or '3')")
    if min(args.ks) < 2:
        parser.error(f"--ks must all be >= 2, got {min(args.ks)}")
    if args.backend == "pallas" and args.algorithm != "mu":
        parser.error("--backend pallas is only implemented for "
                     "--algorithm mu (use auto)")
    if (args.backend == "packed"
            and args.algorithm not in PACKED_ALGORITHMS):
        parser.error("--backend packed is only implemented for "
                     f"--algorithm {'/'.join(PACKED_ALGORITHMS)} "
                     "(use auto)")
    _check_sketched(parser, args)
    _refuse_unported(parser, args)
    if args.verbose:
        import logging

        logging.basicConfig(format="%(message)s")
        logging.getLogger("nmfx_torch").setLevel(logging.INFO)
    from nmfx_torch.api import nmfconsensus
    from nmfx_torch.config import OutputConfig, SolverConfig
    from nmfx_torch.profiling import NullProfiler, Profiler

    output = None
    if not args.no_files:
        output = OutputConfig(directory=args.outdir,
                              write_plots=not args.no_plots)
    # --perf-report needs the profiled (phase-synced) run: attribution
    # only annotates dispatches whose walls a real Profiler measured
    profiler = (Profiler(trace_dir=args.trace_dir)
                if args.profile or args.perf_report else NullProfiler())
    if args.flight_dir:
        from nmfx_torch.obs import flight

        flight.configure(args.flight_dir)
        global _signal_dump_installed
        if not _signal_dump_installed:
            flight.install_signal_dump()
            _signal_dump_installed = True
    if args.trace_out:
        from nmfx_torch.obs import trace as obs_trace

        # fresh ring: an earlier in-process run's spans must not leak
        # into this run's exported trace
        obs_trace.default_tracer().clear()
        obs_trace.enable()
    if args.feature_shards < 1 or args.sample_shards < 1:
        parser.error("--feature-shards/--sample-shards must be >= 1")
    if args.restart_shards is not None and args.restart_shards < 1:
        parser.error("--restart-shards must be >= 1")
    mesh = None
    grid = args.feature_shards > 1 or args.sample_shards > 1
    meshed = grid or args.restart_shards is not None
    if grid:
        if args.no_mesh:
            parser.error("--feature-shards/--sample-shards conflict with "
                         "--no-mesh")
        from nmfx_torch.sweep import GRID_SOLVERS, grid_mesh

        grid_ok = (args.algorithm == "mu"
                   and args.backend in ("auto", "packed")) \
            or args.algorithm in GRID_SOLVERS
        if not grid_ok:
            parser.error("--feature-shards/--sample-shards require "
                         "--algorithm mu with --backend auto or packed, "
                         f"or one of {'/'.join(GRID_SOLVERS)}")
        if args.keep_factors:
            parser.error("--keep-factors is not supported with grid shards "
                         "(gathering every restart's full factors would "
                         "defeat the memory bound; use nmfx.restart_factors "
                         "to recompute single restarts)")
        # the CPU is named once an entry; on the card the local cards
        # (the reference's jax.devices())
        n = ((args.restart_shards or 1) * args.feature_shards
             * args.sample_shards)
        try:
            mesh = grid_mesh(args.restart_shards, args.feature_shards,
                             args.sample_shards, devices=(
                                 ["cpu"] * n if args.device == "cpu"
                                 else None))
        except (ValueError, RuntimeError) as e:
            parser.error(str(e))
    elif args.restart_shards is not None:
        # restart-only mesh over exactly N devices (the reference's
        # reproducible-placement knob); the CPU is named N times
        if args.no_mesh:
            parser.error("--restart-shards conflicts with --no-mesh")
        from nmfx_torch.sweep import grid_mesh

        try:
            mesh = grid_mesh(args.restart_shards, 1, 1, devices=(
                ["cpu"] * args.restart_shards if args.device == "cpu"
                else None))
        except (ValueError, RuntimeError) as e:
            parser.error(str(e))
    _check_tiles(parser, args)
    _check_sketched_compose(parser, args)
    from nmfx_torch.config import ExperimentalConfig, SketchConfig

    run_scfg = SolverConfig(algorithm=args.algorithm,
                            max_iter=args.maxiter,
                            matmul_precision=args.precision,
                            backend=args.backend,
                            restart_chunk=args.restart_chunk,
                            check_block=args.check_block,
                            sketch=(SketchConfig(dim=args.sketch_dim)
                                    if args.sketch_dim is not None
                                    else SketchConfig()),
                            screen=args.screen,
                            screen_keep=args.screen_keep,
                            tile_rows=args.tile_rows,
                            experimental=ExperimentalConfig())
    ckpt_cfg = None
    if args.checkpoint_every is not None and args.checkpoint_every < 1:
        parser.error("--checkpoint-every must be >= 1")
    if args.checkpoint_dir is not None:
        if args.keep_factors:
            parser.error("--checkpoint-dir does not compose with "
                         "--keep-factors (the ledger persists per-"
                         "restart stats and best candidates, not every "
                         "factor stack; use nmfx.restart_factors to "
                         "recompute any restart exactly)")
        if meshed:
            parser.error("--checkpoint-dir does not compose with "
                         "--feature-shards/--sample-shards (the chunk "
                         "executor owns its execution plan; use "
                         "nmfx.distributed's elastic shard runner for "
                         "multi-device durable sweeps)")
        from nmfx_torch.config import CheckpointConfig

        ckpt_cfg = CheckpointConfig(directory=args.checkpoint_dir,
                                    every_n_restarts=args.checkpoint_every,
                                    resume=(True if args.resume is None
                                            else args.resume))
    elif args.checkpoint_every is not None:
        parser.error("--checkpoint-every requires --checkpoint-dir")
    elif args.resume is not None:
        parser.error("--resume/--no-resume require --checkpoint-dir")
    if args.result_cache_dir is not None and args.keep_factors:
        parser.error("--result-cache-dir does not compose with "
                     "--keep-factors (results retaining every "
                     "restart's factor stacks are not admitted to the "
                     "result cache; drop one of the flags)")
    exec_cache = None
    warm_task = None
    if args.input_cache_bytes is not None and args.input_cache_bytes < 0:
        parser.error("--input-cache-bytes must be >= 0 "
                     "(0 disables retention)")
    if args.warm_cache and not args.warm_shapes:
        parser.error("--warm-cache backgrounds the --warm-shapes warmup; "
                     "pass --warm-shapes with the shapes to pre-compile")
    if args.telemetry_dir is not None and not args.serve_smoke:
        parser.error("--telemetry-dir configures the serving engine's "
                     "telemetry publisher (ServeConfig.telemetry_dir); "
                     "pass --serve-smoke")
    if args.metrics_port is not None and not args.serve_smoke:
        parser.error("--metrics-port configures the serving engine's "
                     "Prometheus endpoint (ServeConfig.metrics_port); "
                     "pass --serve-smoke")
    if args.metrics_port is not None \
            and not 0 <= args.metrics_port <= 65535:
        parser.error("--metrics-port must be in [0, 65535]")
    if args.slo and not args.serve_smoke:
        parser.error("--slo reports the serving engine's SLO burn "
                     "status; pass --serve-smoke")
    if args.replicas is not None:
        if not args.serve_smoke:
            parser.error("--replicas runs the serving engine behind "
                         "the router front door; pass --serve-smoke")
        if args.replicas < 1:
            parser.error("--replicas must be >= 1")
        if args.metrics_port is not None:
            parser.error("--metrics-port does not compose with "
                         "--replicas (N in-process replica servers "
                         "cannot share one HTTP port; scrape the "
                         "merged fleet via --telemetry-dir + "
                         "nmfx.obs.aggregate instead)")
        if args.replica_mesh is not None:
            specs = [s.strip() for s in args.replica_mesh.split(",")]
            if len(specs) != args.replicas:
                parser.error(f"--replica-mesh names {len(specs)} "
                             f"spec(s) for --replicas {args.replicas} "
                             "— one entry per replica ('-' = plain "
                             "1-device)")
            from nmfx_torch.distributed import (MeshSpecError,
                                                parse_mesh_spec)

            for spec in specs:
                if spec in ("-", ""):
                    continue
                try:
                    parse_mesh_spec(spec)
                except MeshSpecError as e:
                    parser.error(f"--replica-mesh: {e}")
            args.replica_mesh_specs = tuple(
                None if s in ("-", "") else s for s in specs)
        else:
            args.replica_mesh_specs = None
    elif args.router_spill_dir is not None:
        parser.error("--router-spill-dir configures the replica "
                     "pool's ledger; pass --replicas")
    elif args.replica_mesh is not None:
        parser.error("--replica-mesh shapes the replica pool's device "
                     "ownership; pass --serve-smoke --replicas N")
    if args.serve_smoke:
        if meshed:
            parser.error("--serve-smoke owns ONE device (the serving "
                         "scheduler's contract); drop "
                         "--restart-shards/--feature-shards/"
                         "--sample-shards (mesh-tier serving is "
                         "per-REPLICA: --replicas N --replica-mesh ...)")
        if args.checkpoint_dir is not None:
            parser.error("--serve-smoke does not compose with "
                         "--checkpoint-dir (served requests dispatch "
                         "through the executable cache, which bypasses "
                         "the durable-ledger resume path)")
        if args.keep_factors:
            parser.error("--serve-smoke does not compose with "
                         "--keep-factors (served results carry the best "
                         "restart's factors only)")
        if args.rank_selection == "device":
            parser.error("--serve-smoke harvests on the host (the "
                         "completion workers run hclust/cophenetic "
                         "there); drop --rank-selection device")
        if args.grid_exec == "per_k":
            parser.error("--serve-smoke does not compose with "
                         "--grid-exec per_k (served requests dispatch "
                         "through the whole-grid scheduler; per-k "
                         "outputs differ by float tolerance, which "
                         "would break the serve exactness contract)")
    use_exec_cache = (args.exec_cache or args.warm_shapes
                      or args.pipeline_ranks or args.serve_smoke)
    if use_exec_cache:
        if meshed:
            parser.error("--exec-cache does not compose with "
                         "--restart-shards/--feature-shards/"
                         "--sample-shards (the grid builders do their "
                         "own shape padding, and the cache tier "
                         "already restart-shards over all devices)")
        if args.checkpoint_dir is not None:
            parser.error("--exec-cache/--warm-shapes do not compose with "
                         "--checkpoint-dir (checkpointed sweeps dispatch "
                         "per (rank, restart-chunk) through the durable "
                         "ledger, which bypasses the bucketed "
                         "executable cache)")
    device = _resolve_device(parser, args.device)
    if args.input_cache_bytes is not None:
        from nmfx_torch.data_cache import default_cache

        default_cache().resize(max_bytes=args.input_cache_bytes)
    if use_exec_cache:
        from nmfx_torch.config import (ConsensusConfig, ExecCacheConfig,
                                       InitConfig)
        from nmfx_torch.exec_cache import ExecCache

        exec_cache = ExecCache(
            ExecCacheConfig(pipeline_ranks=args.pipeline_ranks),
            device=device)
        if args.warm_shapes:
            # must mirror nmfconsensus' own ConsensusConfig construction
            # field-for-field, so the warmed entry is the one the run hits
            warm_ccfg = ConsensusConfig(
                ks=args.ks, restarts=args.restarts, seed=args.seed,
                label_rule=args.label_rule, linkage=args.linkage,
                keep_factors=args.keep_factors,
                grid_exec=args.grid_exec, grid_slots=args.grid_slots,
                grid_tail_slots=args.grid_tail_slots)
            if not exec_cache.cacheable(warm_ccfg, run_scfg, None):
                parser.error(
                    "--warm-shapes needs an exec-cacheable configuration "
                    "(an algorithm/backend the whole-grid scheduler runs "
                    "— see ExecCache.cacheable)")
            if args.warm_cache:
                warm_task = exec_cache.warm(
                    args.warm_shapes, warm_ccfg, run_scfg,
                    InitConfig(method=args.init), None, background=True)
                print(f"nmfx: warming {len(args.warm_shapes)} shape(s) "
                      "in the background", file=sys.stderr)
            else:
                for rec in exec_cache.warm(args.warm_shapes, warm_ccfg,
                                           run_scfg,
                                           InitConfig(method=args.init),
                                           None):
                    print(_warm_line(rec), file=sys.stderr)
    with profiler:
        if args.serve_smoke:
            result = _serve_smoke(args, run_scfg, exec_cache, output,
                                  profiler)
        else:
            result = nmfconsensus(
                args.dataset,
                ks=args.ks,
                restarts=args.restarts,
                seed=args.seed,
                solver_cfg=run_scfg,
                init=args.init,
                label_rule=args.label_rule,
                linkage=args.linkage,
                rank_selection=args.rank_selection,
                keep_factors=args.keep_factors,
                grid_exec=args.grid_exec,
                grid_slots=args.grid_slots,
                grid_tail_slots=args.grid_tail_slots,
                output=output,
                device=device,
                mesh=mesh,
                use_mesh=not args.no_mesh,
                checkpoint=ckpt_cfg,
                profiler=profiler,
                exec_cache=exec_cache,
                result_cache=args.result_cache_dir,
            )
    if args.save_result:
        result.save(args.save_result)
    print(result.summary())
    if args.profile:
        print(profiler.report())
    if args.perf_report:
        from nmfx_torch.obs import costmodel as obs_costmodel

        # --profile already embeds the same table in its report; avoid
        # printing it twice
        if not args.profile:
            print(obs_costmodel.perf_report())
    if args.trace_out:
        tracer = obs_trace.default_tracer()
        obs_trace.disable()  # also restored on error paths by main()
        tracer.export(args.trace_out)
        print(f"nmfx: structured trace ({tracer.event_count()} events"
              + (f", {tracer.dropped} dropped" if tracer.dropped
                 else "")
              + f") written to {args.trace_out} — load in Perfetto "
              "(ui.perfetto.dev) or chrome://tracing", file=sys.stderr)
    if args.metrics_out:
        from nmfx_torch.obs import metrics as obs_metrics

        with open(args.metrics_out, "w") as f:
            f.write(obs_metrics.registry().prometheus_text())
        print(f"nmfx: metrics written to {args.metrics_out} "
              "(Prometheus text exposition)", file=sys.stderr)
    return 0


def _print_slo(slo_status: dict) -> None:
    for name, obj in sorted(slo_status["objectives"].items()):
        burns = " ".join(
            f"{w}={'n/a' if b is None else round(b, 3)}"
            for w, b in obj["burn"].items())
        print(f"nmfx: slo {name}: state={obj['state']} "
              f"burn[{burns}]", file=sys.stderr)


def _serve_smoke(args, run_scfg, exec_cache, output, profiler):
    """Route the run through the multi-tenant serving engine: ONE
    request down the same queue → pack → dispatch → harvest path
    concurrent tenants share, then report the serve counters and this
    request's spans. Results are byte-equal to the direct path through
    the same executable cache."""
    from nmfx_torch.api import save_results
    from nmfx_torch.config import InitConfig
    from nmfx_torch.serve import NMFXServer, ServeConfig

    if args.replicas is not None:
        return _serve_smoke_router(args, run_scfg, exec_cache, output,
                                   profiler)
    serve_cfg = ServeConfig(telemetry_dir=args.telemetry_dir,
                            metrics_port=args.metrics_port,
                            result_cache_dir=args.result_cache_dir)
    with NMFXServer(serve_cfg, exec_cache=exec_cache,
                    profiler=profiler) as srv:
        if srv.metrics_port is not None:
            print(f"nmfx: serving /metrics on 127.0.0.1:"
                  f"{srv.metrics_port}", file=sys.stderr)
        fut = srv.submit(args.dataset, ks=args.ks,
                         restarts=args.restarts, seed=args.seed,
                         solver_cfg=run_scfg,
                         init_cfg=InitConfig(method=args.init),
                         label_rule=args.label_rule,
                         linkage=args.linkage,
                         grid_slots=args.grid_slots,
                         grid_tail_slots=args.grid_tail_slots)
        result = fut.result()
        if args.slo:
            _print_slo(srv.stats_snapshot()["slo"])
    if args.telemetry_dir is not None:
        print(f"nmfx: telemetry published to {args.telemetry_dir} "
              f"(fleet view: python -m nmfx_torch.obs.top "
              f"{args.telemetry_dir})", file=sys.stderr)
    s = srv.stats()
    st = fut.stats

    def fmt(v):
        return "n/a" if v is None else f"{v:.3f}s"

    print("nmfx: serve-smoke: submitted="
          f"{s['submitted']} completed={s['completed']} "
          f"dispatches={s['dispatches']} "
          f"packed_dispatches={s['packed_dispatches']} "
          f"packing_efficiency={s['packing_efficiency']}"
          + (f" result_cache_hits={s['result_cache_hits']}"
             f" coalesced={s['coalesced']}"
             if args.result_cache_dir is not None else ""),
          file=sys.stderr)
    print("nmfx: serve-smoke spans: "
          f"queue-wait={fmt(st.queue_wait_s)} pack={fmt(st.pack_s)} "
          f"solve={fmt(st.solve_s)} harvest={fmt(st.harvest_s)} "
          f"latency={fmt(st.latency_s)}", file=sys.stderr)
    if output is not None:
        with profiler.phase("write_outputs"):
            save_results(result, output)
    return result


def _serve_smoke_router(args, run_scfg, exec_cache, output, profiler):
    """The service-tier smoke: the same single request through an
    ``NMFXRouter`` over ``--replicas`` in-process replica servers that
    share the run's executable cache — results stay byte-equal to the
    direct path through it, and the router's placement/failover books
    are reported."""
    import shutil
    import tempfile

    from nmfx_torch.api import save_results
    from nmfx_torch.config import InitConfig
    from nmfx_torch.replica import ReplicaPool
    from nmfx_torch.router import NMFXRouter, RouterConfig
    from nmfx_torch.serve import ServeConfig

    ephemeral = args.router_spill_dir is None
    root = args.router_spill_dir if not ephemeral \
        else tempfile.mkdtemp(prefix="nmfx-router-")
    pool = ReplicaPool(
        args.replicas, root=root, mode="thread",
        serve_cfg=ServeConfig(),
        exec_cache=exec_cache, telemetry_dir=args.telemetry_dir,
        mesh_specs=getattr(args, "replica_mesh_specs", None))
    try:
        with NMFXRouter(pool, RouterConfig(
                result_cache_dir=args.result_cache_dir)) as router:
            fut = router.submit(args.dataset, ks=args.ks,
                                restarts=args.restarts, seed=args.seed,
                                solver_cfg=run_scfg,
                                init_cfg=InitConfig(method=args.init),
                                label_rule=args.label_rule,
                                linkage=args.linkage,
                                grid_slots=args.grid_slots,
                                grid_tail_slots=args.grid_tail_slots)
            result = fut.result()
            s = router.stats()
            if args.slo:
                _print_slo(router.slo_status(evaluate=True))
    finally:
        if ephemeral:
            # an unnamed pool root is run-scoped scratch
            shutil.rmtree(root, ignore_errors=True)
    st = fut.stats
    print("nmfx: serve-smoke (router): replicas="
          f"{args.replicas} submitted={s['submitted']} "
          f"completed={s['completed']} retried={s['retried']} "
          f"readmitted={s['readmitted']} "
          f"replica={st.replica} sticky={st.sticky} "
          f"class={st.placement_class} attempts={st.attempts} "
          f"latency={'n/a' if st.latency_s is None else f'{st.latency_s:.3f}s'}",
          file=sys.stderr)
    if args.telemetry_dir is not None:
        print(f"nmfx: telemetry published to {args.telemetry_dir} "
              f"(fleet view: python -m nmfx_torch.obs.top "
              f"{args.telemetry_dir})", file=sys.stderr)
    if output is not None:
        with profiler.phase("write_outputs"):
            save_results(result, output)
    return result


def router_main(argv: "list[str] | None" = None) -> int:
    """``nmfx-torch-router`` — run a dataset's consensus requests through
    the resilient service tier (router + replica pool) and report the
    routing books: thread replicas for one-process serving, subprocess
    replicas (``--mode process``) for the production shape."""
    import shutil
    import tempfile

    p = argparse.ArgumentParser(
        prog="nmfx-torch-router",
        description="Route consensus requests through the resilient "
                    "service tier: an NMFXRouter front door over N "
                    "replica servers with health-checked failover, "
                    "spill-migration, and SLO-driven shedding.")
    p.add_argument("dataset", help="input .gct or .res file")
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--mode", choices=("thread", "process"),
                   default="thread",
                   help="replica kind: in-process servers (thread) or "
                        "subprocess workers (process)")
    p.add_argument("--requests", type=int, default=1, metavar="R",
                   help="submit R copies of the request with distinct "
                        "seeds (seed, seed+1, ...) — a small traffic "
                        "sample through the tier")
    p.add_argument("--ks", default="2-5", type=parse_ks)
    p.add_argument("--restarts", type=int, default=10)
    p.add_argument("--maxiter", type=int, default=10000)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--algorithm", choices=ALGORITHMS, default="mu")
    p.add_argument("--spill-root", default=None, metavar="DIR",
                   help="pool root (spill records + heartbeat ledger; "
                        "default: a temporary directory)")
    p.add_argument("--cache-dir", default=None, metavar="DIR",
                   help="persistent executable cache (not ported: "
                        f"serialized XLA executables, {ROADMAP_WARM})")
    p.add_argument("--telemetry-dir", default=None, metavar="DIR",
                   help="fleet telemetry ledger (watch it with "
                        "python -m nmfx_torch.obs.top DIR)")
    p.add_argument("--autoscale", action="store_true",
                   help="enable the router's metrics-driven "
                        "autoscaler (RouterConfig.autoscale)")
    p.add_argument("--device", default=None,
                   help="the device the replicas serve on: the CUDA card "
                        "(default) or 'cpu'; process workers get it as "
                        "their --device")
    args = p.parse_args(argv)
    if not os.path.isfile(args.dataset):
        p.error(f"dataset not found: {args.dataset}")
    if args.replicas < 1:
        p.error("--replicas must be >= 1")
    if args.requests < 1:
        p.error("--requests must be >= 1")
    if args.cache_dir is not None:
        p.error("--cache-dir: serialized XLA executables have no torch "
                f"counterpart ({ROADMAP_WARM}); the kernels' libraries "
                "are cached by source hash already")
    device = _resolve_device(p, args.device)
    from nmfx_torch.config import SolverConfig
    from nmfx_torch.replica import ReplicaPool
    from nmfx_torch.router import NMFXRouter, RouterConfig

    ephemeral = args.spill_root is None
    root = args.spill_root if not ephemeral \
        else tempfile.mkdtemp(prefix="nmfx-router-")
    if args.mode == "process":
        pool_kw = dict(worker_args=(() if args.device is None
                                    else ("--device", args.device)))
    else:
        pool_kw = dict(device=device)
    pool = ReplicaPool(args.replicas, root=root, mode=args.mode,
                       telemetry_dir=args.telemetry_dir, **pool_kw)
    scfg = SolverConfig(algorithm=args.algorithm, max_iter=args.maxiter)
    try:
        with NMFXRouter(pool, RouterConfig(
                autoscale=args.autoscale)) as router:
            futs = [router.submit(args.dataset, ks=args.ks,
                                  restarts=args.restarts,
                                  seed=args.seed + i, solver_cfg=scfg)
                    for i in range(args.requests)]
            failed = 0
            for fut in futs:
                try:
                    result = fut.result()
                except Exception as e:  # each outcome is REPORTED per
                    # request; the command's exit code carries the failure
                    failed += 1
                    print(f"nmfx-router: request "
                          f"{fut.stats.request_id} FAILED: {e!r}",
                          file=sys.stderr)
                else:
                    print(f"nmfx-router: request "
                          f"{fut.stats.request_id} "
                          f"ok on {fut.stats.replica} "
                          f"(attempts={fut.stats.attempts})",
                          file=sys.stderr)
                    print(result.summary())
            s = router.stats()
    finally:
        if ephemeral:
            shutil.rmtree(root, ignore_errors=True)
    print("nmfx-router: "
          + " ".join(f"{k}={s[k]}" for k in
                     ("submitted", "completed", "failed", "retried",
                      "readmitted", "drained", "recovered",
                      "routable_replicas")), file=sys.stderr)
    return 1 if failed else 0


def _warm_line(rec: dict) -> str:
    note = " (already warm)" if rec["cache_hit"] else ""
    return (f"nmfx: warmed bucket {rec['bucket']} for shape "
            f"{rec['shape']} in {rec['compile_s']}s{note}")


if __name__ == "__main__":
    sys.exit(main())
