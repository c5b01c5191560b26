"""The port's command line (``nmfx_torch/cli.py``, ``python -m
nmfx_torch``) against ``nmfx.cli`` on the CPU.

``build_parser()`` gives the reference's option strings, destinations,
defaults and choices, plus ``--device``. Each usage error of the
reference's checks gives the same message and exit code 2 from both;
the options the port has not got are usage errors naming their ROADMAP
item, and the mesh options give the reference's outcome; without ``--device cpu`` (no card here) every entry point exits
with a usage error. On a 60×20 GCT the port's ``main`` and
``nmfx.cli.main`` write the same set of output files (``--no-plots``
on both: no PDF; test_torch_surface.py compares the plot files) and
an equal rank table at the whole-grid tier — best k, memberships and
mean iterations equal, consensus within 1e-6 — for mu under ``auto``
and ``pallas`` (the reference runs ``pallas`` in interpret mode off the
TPU) and hals under ``auto``; ``--serve-smoke`` with and without
``--replicas 2`` gives the same outcome; ``router_main`` in thread mode
books ``submitted=N completed=N failed=0`` with the served rank
table."""

import argparse
import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest

import nmfx.cli as ncli
import nmfx_torch.cli as pcli
from nmfx.io import read_gct as nread_gct
from nmfx_torch.io import write_gct
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = ["--ks", "2-3", "--restarts", "4", "--maxiter", "200"]
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def gct(tmp_path_factory):
    from nmfx_torch.datasets import two_group_matrix

    a = two_group_matrix(60, 10, seed=1)
    path = tmp_path_factory.mktemp("cli") / "demo.gct"
    write_gct(a, str(path), row_names=[f"g{i}" for i in range(60)],
              col_names=[f"s{i}" for i in range(20)])
    return str(path)


def _options(parser):
    out = {}
    for act in parser._actions:
        if isinstance(act, argparse._HelpAction):
            continue
        key = tuple(act.option_strings) or (act.dest,)
        out[key] = (act.dest, act.default, act.choices, act.nargs,
                    type(act).__name__)
    return out


def test_parser_matches_reference():
    port, ref = _options(pcli.build_parser()), _options(ncli.build_parser())
    assert port.pop(("--device",)) == ("device", None, None, None,
                                       "_StoreAction")
    # the test harness points nmfx's default compile cache at a
    # temporary directory; the port keeps the reference's own default
    key = ("--compile-cache",)
    assert port[key][1] == os.path.join(
        os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
        "nmfx", "xla")
    port[key] = port[key][:1] + (None,) + port[key][2:]
    ref[key] = ref[key][:1] + (None,) + ref[key][2:]
    assert port == ref
    assert pcli.parse_ks("2-5") == ncli.parse_ks("2-5") == (2, 3, 4, 5)
    assert pcli.parse_ks("2,4,8") == (2, 4, 8)
    assert pcli.parse_ks("3") == (3,)
    for fn in ("_tail_slots_arg", "_check_block_arg", "_tile_rows_arg",
               "_warm_shapes_arg"):
        for value in ("auto", "24,8", "3", "0", "-1", "8,24", "x",
                      "5000x500,20x10", "0x5"):
            got = []
            for mod in (pcli, ncli):
                try:
                    got.append(getattr(mod, fn)(value))
                except argparse.ArgumentTypeError as e:
                    got.append(("error", str(e)))
            assert got[0] == got[1], (fn, value)


def _usage_error(fn, argv, capsys):
    with pytest.raises(SystemExit) as ei:
        fn(argv)
    err = capsys.readouterr().err
    msg = err.strip().splitlines()[-1]
    return ei.value.code, msg.split(" error: ", 1)[1]


def _usage_cases(gct, tmp):
    missing = str(tmp / "missing.gct")
    return [
        [missing],
        [gct, "--trace-dir", str(tmp / "t")],
        [gct, "--ks", "5-3"],
        [gct, "--ks", "1-3"],
        [gct, "--backend", "pallas", "--algorithm", "hals"],
        [gct, "--backend", "packed", "--algorithm", "pg"],
        [gct, "--feature-shards", "0"],
        [gct, "--restart-shards", "0"],
        [gct, "--restart-shards", "1", "--no-mesh"],
        [gct, "--checkpoint-every", "0"],
        [gct, "--checkpoint-dir", str(tmp / "c"), "--keep-factors"],
        [gct, "--checkpoint-dir", str(tmp / "c"), "--restart-shards",
         "1"],
        [gct, "--checkpoint-every", "2"],
        [gct, "--no-resume"],
        [gct, "--result-cache-dir", str(tmp / "r"), "--keep-factors"],
        [gct, "--input-cache-bytes", "-1"],
        [gct, "--warm-cache"],
        [gct, "--telemetry-dir", str(tmp / "t")],
        [gct, "--metrics-port", "1"],
        [gct, "--serve-smoke", "--metrics-port", "70000"],
        [gct, "--slo"],
        [gct, "--replicas", "2"],
        [gct, "--serve-smoke", "--replicas", "0"],
        [gct, "--serve-smoke", "--replicas", "2", "--metrics-port", "0"],
        [gct, "--serve-smoke", "--replicas", "2", "--replica-mesh", "-"],
        [gct, "--router-spill-dir", str(tmp / "p")],
        [gct, "--replica-mesh", "-"],
        [gct, "--serve-smoke", "--restart-shards", "1"],
        [gct, "--serve-smoke", "--checkpoint-dir", str(tmp / "c")],
        [gct, "--serve-smoke", "--keep-factors"],
        [gct, "--serve-smoke", "--rank-selection", "device"],
        [gct, "--serve-smoke", "--grid-exec", "per_k"],
        [gct, "--exec-cache", "--restart-shards", "1"],
        [gct, "--exec-cache", "--checkpoint-dir", str(tmp / "c")],
        [gct, "--warm-shapes", "60x20", "--algorithm", "pg"],
        [gct, "--warm-shapes", "60x0"],
        [gct, "--grid-tail-slots", "8,24"],
        [gct, "--algorithm", "nope"],
    ]


def test_usage_errors_match_reference(gct, tmp_path, capsys):
    for argv in _usage_cases(gct, tmp_path):
        argv = argv + ["--no-files"]
        ref = _usage_error(ncli.main, argv, capsys)
        got = _usage_error(pcli.main, argv + CPU, capsys)
        assert got == ref and got[0] == 2, (argv, got, ref)


def test_router_main_usage_errors_match_reference(gct, tmp_path, capsys):
    for argv in ([str(tmp_path / "missing.gct")],
                 [gct, "--replicas", "0"], [gct, "--requests", "0"],
                 [gct, "--mode", "pigeon"]):
        ref = _usage_error(ncli.router_main, argv, capsys)
        got = _usage_error(pcli.router_main, argv + CPU, capsys)
        assert got == ref and got[0] == 2, (argv, got, ref)


@pytest.mark.parametrize("argv, item", [
    # tiles run since the tile pipeline was ported, a restart mesh since
    # the restart axis was, and the grid axes and mesh replicas since
    # they were: those cases hold the reference's outcome ("nmfx"), a
    # compose error or a run with the same best k
    (["--tile-rows", "16", "--feature-shards", "2"], "nmfx"),
    (["--tile-budget-bytes", "1024", "--tile-rows", "auto",
      "--sample-shards", "2"], "nmfx"),
    (["--feature-shards", "2"], "nmfx"),
    (["--sample-shards", "2"], "nmfx"),
    (["--restart-shards", "2", "--feature-shards", "2"], "nmfx"),
    (["--serve-smoke", "--replicas", "2", "--replica-mesh=-,4"], "nmfx"),
    # the autotuner and a cache directory run since the autotuner was
    # ported, as in the reference
    (["--autotune"], "nmfx"),
    (["--cache-dir", "CACHE"], "nmfx"),
    (["--compile-cache", "CACHE"], "item 6"),
])
def test_unported_options_refused_naming_roadmap(gct, tmp_path, capsys,
                                                 argv, item):
    argv = [a.replace("CACHE", str(tmp_path / "x")) for a in argv]
    if item != "nmfx":
        code, msg = _usage_error(pcli.main,
                                 [gct, "--no-files", *argv, *CPU], capsys)
        assert code == 2 and f"ROADMAP §1 {item}" in msg, msg
        return
    argv = [gct, "--no-files", *RUN, *argv]
    try:
        ncode = ncli.main(argv)
    except SystemExit as e:
        ncode = e.code
    nerr = capsys.readouterr()
    try:
        pcode = pcli.main(argv + CPU)
    except SystemExit as e:
        pcode = e.code
    perr = capsys.readouterr()
    assert pcode == ncode, (perr.err[-2000:], nerr.err[-2000:])
    if ncode == 2:
        assert (perr.err.strip().splitlines()[-1].split(" error: ", 1)[1]
                .replace("nmfx_torch.", "nmfx.")
                == nerr.err.strip().splitlines()[-1].split(" error: ", 1)[1])
    else:
        assert ncode == 0 and _best_k(perr.out) == _best_k(nerr.out)


def test_restart_shards_run_byte_equal_to_unmeshed(gct, tmp_path, capsys):
    """``--restart-shards N`` runs (the CPU named N times): the same
    summary and output files as the unmeshed run; with tiles it is the
    reference's compose error."""
    argv = [gct, *RUN, "--no-plots", *CPU]
    assert pcli.main(argv + ["--outdir", str(tmp_path / "a")]) == 0
    plain = capsys.readouterr().out
    assert pcli.main(argv + ["--outdir", str(tmp_path / "b"),
                             "--restart-shards", "3"]) == 0
    meshed = capsys.readouterr().out
    assert meshed == plain
    for name in sorted(os.listdir(tmp_path / "a")):
        assert (open(tmp_path / "a" / name, "rb").read()
                == open(tmp_path / "b" / name, "rb").read()), name
    ref = _usage_error(ncli.main, [gct, "--tile-rows", "16",
                                   "--restart-shards", "2", "--no-files"],
                       capsys)
    got = _usage_error(pcli.main, [gct, "--tile-rows", "16",
                                   "--restart-shards", "2", "--no-files",
                                   *CPU], capsys)
    assert got[0] == ref[0] == 2
    assert got[1] == ref[1].replace("nmfx.distributed",
                                    "nmfx_torch.distributed")


def test_unported_inputs_and_router_cache_refused(gct, tmp_path, capsys):
    mtx = tmp_path / "a.mtx"
    mtx.write_text("%%MatrixMarket matrix coordinate real general\n")
    # sparse inputs stream since the tile pipeline was ported; on grid
    # shards they are the reference's compose error
    code, msg = _usage_error(pcli.main, [str(mtx), "--feature-shards", "2",
                                         *CPU], capsys)
    assert code == 2 and ("do(es) not compose with --restart-shards/"
                          "--feature-shards/--sample-shards") in msg, msg
    # the router's --cache-dir runs since the autotuner was ported (its
    # store's directory), as the reference's does: the request completes
    # with a direct run's rank table
    assert pcli.router_main([gct, "--replicas", "1", "--requests", "1",
                             *RUN, "--cache-dir", str(tmp_path / "c"),
                             "--spill-root", str(tmp_path / "root"),
                             *CPU]) == 0
    cap = capsys.readouterr()
    assert "submitted=1 completed=1 failed=0" in cap.err
    assert pcli.main([gct, *RUN, "--no-files", *CPU]) == 0
    direct = capsys.readouterr().out
    assert (cap.out.split("best k")[0].strip()
            == direct.split("best k")[0].strip())


def test_entry_points_need_the_card_or_device_cpu(gct, tmp_path, capsys):
    """No card here: without ``--device cpu`` each entry point exits
    with a usage error, never a quiet move to the CPU."""
    import torch

    assert not torch.cuda.is_available()
    code, msg = _usage_error(pcli.main, [gct, "--no-files"], capsys)
    assert code == 2 and "--device" in msg and "CUDA" in msg
    code, msg = _usage_error(pcli.router_main, [gct], capsys)
    assert code == 2 and "--device" in msg
    from nmfx_torch.replica import worker_main

    code, msg = _usage_error(
        worker_main, ["--dir", str(tmp_path / "w"), "--id", "w",
                      "--pool-dir", str(tmp_path)], capsys)
    assert code == 2 and "CUDA" in msg
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "nmfx_torch", gct,
                           "--no-files"], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 2 and "CUDA" in proc.stderr


def _outputs(d):
    return set(os.listdir(d))


def _rank_table(path):
    with open(path) as f:
        head = f.readline().split()
        rows = [line.split() for line in f]
    assert head == ["k", "rho", "dispersion", "mean_iters", "mean_dnorm"]
    return {int(r[0]): [float(x) for x in r[1:]] for r in rows}


def _best_k(out):
    return int(re.search(r"best k = (\d+)", out).group(1))


def _assert_same_run(pdir, ndir, pout, nout, ks=(2, 3)):
    assert _outputs(pdir) == _outputs(ndir)
    assert _best_k(pout) == _best_k(nout)
    pt = _rank_table(os.path.join(pdir, "rank_metrics.txt"))
    nt = _rank_table(os.path.join(ndir, "rank_metrics.txt"))
    assert sorted(pt) == sorted(nt) == list(ks)
    for k in ks:
        # rho and dispersion follow the consensus; mean iterations equal
        np.testing.assert_allclose(pt[k][:2], nt[k][:2], rtol=0,
                                   atol=1e-6)
        assert pt[k][2] == nt[k][2], k
        # the ordered memberships: same order, same labels
        pm = nread_gct(os.path.join(pdir, f"consensus.k.{k}.gct"))
        nm = nread_gct(os.path.join(ndir, f"consensus.k.{k}.gct"))
        assert pm.row_names == nm.row_names
        assert np.array_equal(pm.values, nm.values)
        pc = nread_gct(os.path.join(pdir, f"consensus.matrix.k.{k}.gct"))
        nc = nread_gct(os.path.join(ndir, f"consensus.matrix.k.{k}.gct"))
        np.testing.assert_allclose(pc.values, nc.values, rtol=0,
                                   atol=1e-6)
    pm = nread_gct(os.path.join(pdir, "membership.gct"))
    nm = nread_gct(os.path.join(ndir, "membership.gct"))
    assert np.array_equal(pm.values, nm.values)


@pytest.mark.parametrize("algo, backend", [("mu", "auto"),
                                           ("mu", "pallas"),
                                           ("hals", "auto")])
def test_cli_run_matches_reference(gct, tmp_path, capsys, algo, backend):
    argv = [gct, *RUN, "--algorithm", algo, "--backend", backend,
            "--no-plots"]
    assert ncli.main(argv + ["--outdir", str(tmp_path / "n")]) == 0
    nout = capsys.readouterr().out
    assert pcli.main(argv + ["--outdir", str(tmp_path / "p"), *CPU]) == 0
    pout = capsys.readouterr().out
    _assert_same_run(str(tmp_path / "p"), str(tmp_path / "n"), pout, nout)


def _serve_outcome(out, err):
    """The summary table and the serve books of a smoke run."""
    books = [re.sub(r"(latency|queue-wait|pack|solve|harvest)=\S+", "",
                    re.sub(r"replica=\S+", "", line))
             for line in err.splitlines() if "serve-smoke" in line]
    return out, books


def test_serve_smoke_matches_reference(gct, tmp_path, capsys):
    got = {}
    for name, main, extra in (("nmfx", ncli.main, []),
                              ("nmfx_torch", pcli.main, CPU)):
        for replicas in ([], ["--replicas", "2"]):
            d = tmp_path / f"{name}{len(replicas)}"
            assert main([gct, *RUN, "--serve-smoke", "--no-plots",
                         "--outdir", str(d), *replicas, *extra]) == 0
            cap = capsys.readouterr()
            got[name, len(replicas)] = _serve_outcome(cap.out, cap.err)
            assert _outputs(d) == _outputs(tmp_path / "nmfx0")
    for replicas in (0, 2):
        p_out, p_books = got["nmfx_torch", replicas]
        n_out, n_books = got["nmfx", replicas]
        assert p_books == n_books, replicas
        assert _best_k(p_out) == _best_k(n_out)
        assert p_out.splitlines()[0] == n_out.splitlines()[0]
    assert "completed=1" in got["nmfx_torch", 2][1][0]
    # through the router == through one server, byte for byte
    assert got["nmfx_torch", 2][0] == got["nmfx_torch", 0][0]
    for pkg in ("nmfx_torch", "nmfx"):
        a = open(tmp_path / f"{pkg}0" / "rank_metrics.txt").read()
        b = open(tmp_path / f"{pkg}2" / "rank_metrics.txt").read()
        assert a == b


def test_router_main_thread_mode(gct, tmp_path, capsys):
    argv = [gct, "--replicas", "2", "--requests", "2", *RUN,
            "--spill-root", str(tmp_path / "root")]
    assert pcli.router_main(argv + CPU) == 0
    cap = capsys.readouterr()
    assert cap.out.count("best k = 2") == 2
    assert cap.err.count("ok on replica-") == 2
    assert "submitted=2 completed=2 failed=0" in cap.err
    # the first request's rank table is a direct run's, plain and served
    table = cap.out.split("best k")[0].strip()
    for extra in ([], ["--serve-smoke"]):
        assert pcli.main([gct, *RUN, "--no-files", *extra, *CPU]) == 0
        direct = capsys.readouterr().out
        assert table == direct.split("best k")[0].strip(), extra
    beats = [n for n in os.listdir(tmp_path / "root")
             if n.startswith("replica_") and n.endswith(".json")]
    assert len(beats) == 2


def test_cli_outputs_flags(gct, tmp_path, capsys):
    """--save-result, --trace-out, --metrics-out, --perf-report and
    --flight-dir on the port, --no-compile-cache and the default
    compile cache accepted."""
    from nmfx_torch.api import ConsensusResult

    argv = [gct, "--ks", "2", "--restarts", "3", "--maxiter", "60",
            "--no-files", "--save-result", str(tmp_path / "r.npz"),
            "--trace-out", str(tmp_path / "t.json"),
            "--metrics-out", str(tmp_path / "m.prom"), "--perf-report",
            "--no-compile-cache", "--flight-dir", str(tmp_path / "f"),
            *CPU]
    # --flight-dir hooks SIGTERM in this process; put the previous handler
    # back so later tests in the same worker see the disposition they set
    previous = signal.getsignal(signal.SIGTERM)
    try:
        assert pcli.main(argv) == 0
    finally:
        signal.signal(signal.SIGTERM, previous)
    cap = capsys.readouterr()
    assert "best k" in cap.out
    assert ConsensusResult.load(str(tmp_path / "r.npz")).ks == (2,)
    assert os.path.getsize(tmp_path / "t.json") > 0
    assert "nmfx_" in open(tmp_path / "m.prom").read()
    with pytest.raises(SystemExit) as ei:
        pcli.main(["--version"])
    assert ei.value.code == 0
    assert "0.1.0" in capsys.readouterr().out


def test_router_result_cache_keys_the_serving_device(gct, tmp_path,
                                                     capsys, monkeypatch):
    """``--device cpu --serve-smoke --replicas 2 --result-cache-dir D``:
    the replicas serve through the run's CPU executable cache, so the
    router's entry in D is keyed for the CPU, and a lookup keyed for the
    card misses it."""
    import nmfx_torch.router as prouter
    from nmfx_torch.result_cache import ResultCache, result_key

    calls = []
    real_key = prouter.NMFXRouter._key

    def spy(self, *args):
        key = real_key(self, *args)
        calls.append((args, key))
        return key

    monkeypatch.setattr(prouter.NMFXRouter, "_key", spy)
    d = str(tmp_path / "rc")
    assert pcli.main([gct, *RUN, "--serve-smoke", "--replicas", "2",
                      "--result-cache-dir", d, "--no-files", *CPU]) == 0
    capsys.readouterr()
    assert len(calls) == 1
    args, key = calls[0]
    assert key == result_key(*args, device="cpu",
                             route=prouter._ROUTER_ROUTE)
    card_key = result_key(*args, device=None, route=prouter._ROUTER_ROUTE)
    assert card_key != key
    cache = ResultCache(cache_dir=d, layer="router")
    assert cache.lookup(key) is not None
    assert cache.lookup(card_key) is None
