"""``nmfx_torch.obs.regress`` (``nmfx-torch-perf``) against
``nmfx.obs.regress`` (``nmfx-perf``): nmfx's seven regress cases of
``tests/test_costmodel.py`` on trajectories this file writes into
``tmp_path`` in the ``BENCH_r<NN>.json`` schema (the wrapper form
``{"parsed": record}`` and bare records, schema drift between rounds),
each judged by both packages: the same metrics, verdicts, JSON and
markdown report, and the same exit codes through ``main`` and
``python -m``.
"""

import json
import os
import subprocess
import sys

import pytest

from nmfx.obs import regress as ref
from nmfx_torch.obs import regress as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOTH = [pytest.param(ref, id="nmfx"), pytest.param(port, id="port")]


def _record(rnd: int, scale: float = 1.0, *, mfu: bool = True,
            serve: bool = False) -> dict:
    """One bench record whose walls scale by ``scale`` (rates by its
    inverse); ``mfu=False`` is an older schema without the utilization
    fields, ``serve=True`` adds the serving ladder's selectors."""
    detail = {"restarts_per_s": 240.0 / scale,
              "cold_wall_s": 24.0 * scale,
              "compile_wall_s": 22.0 * scale,
              "backends": {"pallas": {"min_s": 1.75 * scale}},
              "obs": {"overhead_frac": 0.01 * scale}}
    if mfu:
        detail.update(mfu=0.09 / scale, mfu_solve=0.14 / scale)
        detail["backends"]["pallas"]["mfu_solve"] = 0.16 / scale
    if serve:
        detail["serve"] = {"ladder": [
            {"offered_load": 0.5, "p50_latency_s": 9.0},
            {"offered_load": 1.0, "p50_latency_s": 3.0 * scale,
             "p99_latency_s": 5.0 * scale},
            {"offered_load": "burst", "goodput_req_per_s": 7.0 / scale}]}
    return {"metric": "consensus_sweep_wall_s", "value": 1.8 * scale,
            "unit": "s", "detail": detail, "round": rnd}


def _write(directory, rnd: int, rec: dict, wrapped: bool = True) -> None:
    body = {"n": rnd, "rc": 0, "parsed": rec} if wrapped else rec
    (directory / f"BENCH_r{rnd:02d}.json").write_text(json.dumps(body))


def _trajectory(directory) -> None:
    """Five rounds: r01 predates the utilization fields, r03 is the best,
    r02 and r04 are bare records, r05 adds the serving ladder."""
    for rnd, scale, kw in ((1, 1.20, dict(mfu=False)), (2, 1.10, {}),
                           (3, 0.90, {}), (4, 1.00, {}),
                           (5, 1.05, dict(serve=True))):
        _write(directory, rnd, _record(rnd, scale, **kw),
               wrapped=rnd not in (2, 4))


def _both_main(args: list) -> tuple:
    return ref.main(list(args)), port.main(list(args))


def test_regress_metrics_table_is_the_reference():
    assert port.METRICS == ref.METRICS
    assert port.MetricSpec._fields == ref.MetricSpec._fields
    assert port.__all__ == ref.__all__


def test_regress_loads_rounds_and_reports(tmp_path):
    _trajectory(tmp_path)
    rounds = port.load_rounds(str(tmp_path))
    assert rounds == ref.load_rounds(str(tmp_path))
    assert [r["round"] for r in rounds] == [1, 2, 3, 4, 5]
    # schema drift normalized: r01 predates mfu, r05 has it
    assert "mfu" not in rounds[0]["metrics"]
    assert "mfu" in rounds[4]["metrics"]
    verdict = port.compare(rounds)
    assert verdict == ref.compare(rounds)
    report = port.markdown_report(rounds, verdict)
    assert report == ref.markdown_report(rounds, verdict)
    assert "consensus_sweep_wall_s" in report
    assert "r01" in report and "r05" in report


def test_regress_path_selectors_and_wrapper_forms():
    rec = {"parsed": _record(1, serve=True)}
    got = port.extract_metrics(rec)
    assert got == ref.extract_metrics(rec)
    assert got["consensus_sweep_wall_s"] == 1.8
    assert got["serve_p50_latency_s"] == 3.0
    assert got["serve_burst_goodput_req_per_s"] == 7.0
    # bare (unwrapped) records normalize identically
    assert port.extract_metrics(rec["parsed"]) == got
    assert port.extract_metrics({"parsed": [1, 2]}) == {}


@pytest.mark.parametrize("scale_value,scale_rate,want", [
    (1.0, 1.0, 0),  # the best round re-measured: green
    (2.0, 2.0, 2),  # the headline wall and the rate halved: red
    (1.1, 1.0, 0),  # within the 25 % threshold
])
def test_regress_verdict_on_degraded_copy(tmp_path, scale_value,
                                          scale_rate, want):
    """A copy of the best round, degraded, as the newest round: both
    judges exit alike and write the same verdict and trend report."""
    _trajectory(tmp_path)
    best = json.loads((tmp_path / "BENCH_r03.json").read_text())
    best["parsed"]["value"] *= scale_value
    best["parsed"]["detail"]["restarts_per_s"] /= scale_rate
    (tmp_path / "BENCH_r06.json").write_text(json.dumps(best))
    out = {}
    for name, mod in (("ref", ref), ("port", port)):
        verdict, trend = tmp_path / f"{name}.json", tmp_path / f"{name}.md"
        rc = mod.main(["--dir", str(tmp_path), "--json", str(verdict),
                       "--markdown", str(trend)])
        out[name] = (rc, json.loads(verdict.read_text()),
                     trend.read_text())
    assert out["port"] == out["ref"]
    rc, verdict, trend = out["port"]
    assert rc == want
    if want == 2:
        assert verdict["status"] == "regression"
        regressed = {r["metric"] for r in verdict["regressions"]}
        assert {"consensus_sweep_wall_s", "restarts_per_s"} <= regressed
        # every regression names the round that set the bar
        assert all(r["best_round"] == "BENCH_r03.json"
                   for r in verdict["regressions"])
        assert "Regressions" in trend
    else:
        assert verdict["status"] == "ok"


@pytest.mark.parametrize("scale", [0.5, 2.0])
def test_regress_threshold_scale(tmp_path, scale):
    """--threshold-scale widens or tightens every threshold alike."""
    _trajectory(tmp_path)
    rec = _record(6, 0.9 * 1.2)  # 20 % above the best round's walls
    _write(tmp_path, 6, rec)
    args = ["--dir", str(tmp_path), "--threshold-scale", str(scale),
            "--json", str(tmp_path / "v.json")]
    rc_ref = ref.main(args)
    v_ref = (tmp_path / "v.json").read_text()
    assert port.main(args) == rc_ref == (2 if scale == 0.5 else 0)
    assert (tmp_path / "v.json").read_text() == v_ref


def test_regress_candidate_mode_and_missing_metric(tmp_path):
    """--candidate judges an out-of-tree record against all loaded
    rounds; a metric the priors had but the candidate lacks is reported
    as missing, not dropped."""
    _trajectory(tmp_path)
    rounds = port.load_rounds(str(tmp_path))
    cand = {"file": "x", "metrics": {"consensus_sweep_wall_s": 1.50}}
    verdict = port.compare(rounds, cand)
    assert verdict == ref.compare(rounds, cand)
    assert verdict["status"] == "ok"
    assert any(m["metric"] == "restarts_per_s" for m in verdict["missing"])
    improved = {m["metric"] for m in verdict["improvements"]}
    assert "consensus_sweep_wall_s" in improved  # beats r03's 1.62
    path = tmp_path / "cand.json"
    path.write_text(json.dumps({"parsed": {"value": 1.5}}))
    md = {}
    for name, mod in (("ref", ref), ("port", port)):
        md[name] = tmp_path / f"{name}.md"
        assert mod.main(["--dir", str(tmp_path), "--candidate", str(path),
                         "--markdown", str(md[name])]) == 0
    assert md["port"].read_text() == md["ref"].read_text()
    assert _both_main(["--dir", str(tmp_path), "--candidate",
                       str(tmp_path / "absent.json")]) == (1, 1)


@pytest.mark.parametrize("cand,status", [(0.5, "regression"), (0.0, "ok")])
def test_regress_zero_bar_stays_judgeable(cand, status):
    """A best prior bar of exactly 0 must not make the metric
    unjudgeable: a clearly worse candidate regresses, an equal one
    stays ok."""
    rounds = [{"round": 1, "file": "BENCH_r01.json",
               "metrics": {"obs_overhead_frac": 0.0}}]
    c = {"file": "x", "metrics": {"obs_overhead_frac": cand}}
    got = port.compare(rounds, c)
    assert got == ref.compare(rounds, c)
    assert got["status"] == status


@pytest.mark.parametrize("mod", BOTH)
def test_regress_no_rounds(tmp_path, mod):
    assert mod.load_rounds(str(tmp_path)) == []
    assert mod.load_rounds(str(tmp_path / "absent")) == []
    assert mod.main(["--dir", str(tmp_path)]) == 1
    assert mod.compare([])["status"] == "no-data"
    assert mod.markdown_report([]) == ref.markdown_report([])


def test_regress_corrupt_round_skipped(tmp_path):
    (tmp_path / "BENCH_r01.json").write_text("{not json")
    (tmp_path / "BENCH_r02.json").write_text("[1, 2]")
    (tmp_path / "BENCH_r03.json").write_text(json.dumps({"parsed": {}}))
    _write(tmp_path, 5, _record(5))
    (tmp_path / "notes.json").write_text(json.dumps(_record(9)))
    rounds = port.load_rounds(str(tmp_path))
    assert rounds == ref.load_rounds(str(tmp_path))
    assert [r["round"] for r in rounds] == [5]


@pytest.mark.parametrize("degrade,want", [(False, 0), (True, 2)])
def test_regress_module_command_exits_as_nmfx_perf(tmp_path, degrade,
                                                   want):
    """``python -m nmfx_torch.obs.regress`` exits as ``python -m
    nmfx.obs.regress`` does, with the same verdict on stdout, and loads
    neither jax nor nmfx."""
    _trajectory(tmp_path)
    rec = _record(6, 2.0 if degrade else 0.9)
    _write(tmp_path, 6, rec)
    args = ["--dir", str(tmp_path), "--json", "-",
            "--markdown", str(tmp_path / "t.md")]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    probe = ("import runpy, sys, json\n"
             "sys.argv = ['nmfx-torch-perf'] + sys.argv[1:]\n"
             "try:\n"
             "    runpy.run_module('nmfx_torch.obs.regress',"
             " run_name='__main__')\n"
             "except SystemExit as e:\n"
             "    rc = e.code\n"
             "bad = sorted(m for m in sys.modules"
             " if m.split('.')[0] in ('jax', 'jaxlib', 'nmfx'))\n"
             "print(json.dumps(bad))\n"
             "sys.exit(rc)\n")
    got = subprocess.run([sys.executable, "-c", probe, *args],
                         capture_output=True, text=True, timeout=120,
                         env=env, cwd=str(tmp_path))
    want_proc = subprocess.run(
        [sys.executable, "-m", "nmfx.obs.regress", *args],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(tmp_path))
    assert got.returncode == want_proc.returncode == want, got.stderr
    verdict, loaded = got.stdout.strip().splitlines()[-2:]
    assert json.loads(loaded) == []
    assert json.loads(verdict) == json.loads(
        want_proc.stdout.strip().splitlines()[-1])
