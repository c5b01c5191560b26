"""nmfx_torch.distributed against nmfx.distributed: the spec grammar,
replica meshes, the single-process degenerate path, the elastic shard
runner (a killed shard recovered byte-equal to the single-device
checkpointed run), the communication model, and two CPU processes over
gloo returning one result (the port's counterpart of nmfx's
``tests/test_distributed.py`` cases without grid axes and of
``tests/test_multiprocess.py``'s two-process consensus)."""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import nmfx.distributed as ndist
from nmfx.obs import costmodel as ncost
from nmfx_torch import checkpoint as pckpt
from nmfx_torch import distributed as dist
from nmfx_torch import faults as pfaults
from nmfx_torch.api import nmfconsensus
from nmfx_torch.config import (CheckpointConfig, ConsensusConfig,
                               InitConfig, SolverConfig)
from nmfx_torch.obs import costmodel as pcost
from nmfx_torch.sweep import RESTART_AXIS, grid_mesh, sweep_one_k
from nmfx_torch import random as _random
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
#: each subprocess's and rendezvous' limit
PROC_TIMEOUT_S = 120


def _bit_identical(got, ref):
    assert set(got.per_k) == set(ref.per_k)
    for k in ref.per_k:
        for field in ("consensus", "membership", "order", "iterations",
                      "dnorms", "stop_reasons", "best_w", "best_h"):
            sv = np.ascontiguousarray(
                np.asarray(getattr(got.per_k[k], field)))
            qv = np.ascontiguousarray(
                np.asarray(getattr(ref.per_k[k], field)))
            assert sv.tobytes() == qv.tobytes(), f"{field} k={k}"
        assert got.per_k[k].rho == ref.per_k[k].rho


def _ref(data, scfg, tmp, name, **kw):
    return nmfconsensus(data, solver_cfg=scfg, device="cpu",
                        checkpoint=CheckpointConfig(str(tmp / name),
                                                    every_n_restarts=2),
                        **kw)


# -- the single-process path --------------------------------------------
def test_initialize_single_process_noop(monkeypatch):
    for var in ("WORLD_SIZE", "SLURM_NTASKS", "SLURM_NPROCS",
                "OMPI_COMM_WORLD_SIZE", "PMI_SIZE",
                "NMFX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    dist.initialize()  # must not try to reach a coordinator
    assert not torch.distributed.is_initialized()
    assert dist.is_coordinator()


def test_initialize_in_a_cluster_env_needs_an_address(monkeypatch):
    """Inside a cluster environment a missing coordinator raises: every
    process believing itself alone would race the coordinator's writes."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "NMFX_COORDINATOR_ADDRESS",
                "RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SLURM_NTASKS", "2")
    monkeypatch.setenv("SLURM_PROCID", "1")
    with pytest.raises(ValueError, match="coordinator_address"):
        dist.initialize()
    assert not torch.distributed.is_initialized()


def test_global_mesh_covers_this_process():
    mesh = dist.global_mesh(devices=["cpu"] * 4)
    assert mesh.shape[RESTART_AXIS] == 4
    assert list(mesh.processes) == [0, 0, 0, 0]
    assert mesh.distinct_devices() == [CPU]
    # feature and sample axes: the reference's 3-D mesh and errors
    grid = dist.global_mesh(feature_shards=2, devices=["cpu"] * 8)
    want = ndist.global_mesh(feature_shards=2)
    assert grid.axis_names == tuple(want.axis_names)
    assert grid.shape == dict(want.shape)
    assert grid.processes.shape == grid.devices.shape
    with pytest.raises(dist.MeshSpecError) as got:
        dist.global_mesh(feature_shards=3, devices=["cpu"] * 8)
    with pytest.raises(ndist.MeshSpecError) as ref:
        ndist.global_mesh(feature_shards=3)
    assert str(got.value) == str(ref.value)
    with pytest.raises(dist.MeshSpecError, match=">= 1"):
        dist.global_mesh(sample_shards=0)


def test_global_mesh_without_a_card_names_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default devices are valid")
    with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
        dist.global_mesh()


def test_global_mesh_matches_single_device(two_group_data):
    cfg = SolverConfig(algorithm="mu", max_iter=40)
    a = torch.as_tensor(two_group_data, dtype=torch.float32)
    key = _random.key(3)
    plain = sweep_one_k(a, key, 3, 16, cfg)
    meshed = sweep_one_k(a, key, 3, 16, cfg,
                         mesh=dist.global_mesh(devices=["cpu"] * 8))
    for name, x, y in zip(plain._fields, plain, meshed):
        if x is None:
            assert y is None, name
            continue
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), name


def test_distributed_consensus_end_to_end(two_group_data):
    kw = dict(ks=(2, 3), restarts=8, max_iter=40, seed=11)
    res = dist.consensus(two_group_data, devices=["cpu"] * 4, **kw)
    want = ndist.consensus(two_group_data, **kw)
    assert res.best_k == want.best_k == 2
    assert set(res.per_k) == {2, 3}
    plain = nmfconsensus(two_group_data, device="cpu", **kw)
    for k in (2, 3):
        assert np.array_equal(res.per_k[k].consensus,
                              plain.per_k[k].consensus)


# -- replica mesh specs --------------------------------------------------
def test_parse_mesh_spec_grammar():
    for spec in ("4", "2x2", "2x2x2", "1"):
        assert dist.parse_mesh_spec(spec) == ndist.parse_mesh_spec(spec)
    for bad in ("", "ax2", "2x", "0", "2x0", "-1", "2x2x2x2"):
        with pytest.raises(dist.MeshSpecError):
            dist.parse_mesh_spec(bad)
        with pytest.raises(ndist.MeshSpecError):
            ndist.parse_mesh_spec(bad)
    assert issubclass(dist.MeshSpecError, ValueError)


def test_build_replica_mesh_explicit_devices_exact_count():
    devs = ["cpu"] * 4
    mesh = dist.build_replica_mesh("2", devices=devs[:2])
    assert mesh.shape == {RESTART_AXIS: 2}
    assert list(mesh.devices.flat) == [CPU, CPU]
    with pytest.raises(dist.MeshSpecError, match="exactly 2"):
        dist.build_replica_mesh("2", devices=devs)
    with pytest.raises(dist.MeshSpecError, match="exactly 4"):
        dist.build_replica_mesh("2x2", devices=devs[:2])
    grid = dist.build_replica_mesh("2x2", devices=devs)
    assert grid.shape == {"restarts": 2, "features": 2, "samples": 1}


def test_build_replica_mesh_default_devices():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(dist.MeshSpecError, match="needs 4 device"):
        dist.build_replica_mesh("4")  # this process has no card


# -- elastic shard recovery ----------------------------------------------
def test_elastic_shard_loss_recovers_exact(two_group_data, tmp_path):
    """One of three shards killed mid-sweep (armed proc.preempt): the
    survivors take its unit and the result is byte-equal to the
    single-device checkpointed run; every unit committed, one dead
    heartbeat and two live ones."""
    scfg = SolverConfig(algorithm="mu", max_iter=40)
    kw = dict(ks=(2, 3), restarts=6, seed=5)
    ref = _ref(two_group_data, scfg, tmp_path, "ref", **kw)
    el_cfg = CheckpointConfig(str(tmp_path / "el"), every_n_restarts=2)
    pfaults.arm("proc.preempt", every=2, max_fires=1)
    try:
        res = dist.elastic_consensus(two_group_data, solver_cfg=scfg,
                                     checkpoint=el_cfg,
                                     devices=["cpu"] * 3, **kw)
    finally:
        pfaults.disarm("proc.preempt")
    _bit_identical(res, ref)
    assert len([n for n in os.listdir(tmp_path / "el")
                if n.startswith("k") and n.endswith(".npz")]) == 6
    ck = pckpt.SweepCheckpoint.open(
        np.asarray(two_group_data),
        ConsensusConfig(ks=kw["ks"], restarts=kw["restarts"],
                        seed=kw["seed"]),
        scfg, InitConfig(), el_cfg)
    status = ck.shard_status()
    assert sorted(status) == [0, 1, 2]
    assert sum(1 for v in status.values() if not v["alive"]) == 1
    assert sum(1 for v in status.values() if v["alive"]) == 2
    assert ck.shard_status(stale_after_s=3600.0)[0]["stale"] is False


def test_elastic_resumes_preempted_single_device_ledger(two_group_data,
                                                        tmp_path):
    """A single-device checkpointed run killed mid-sweep leaves a partial
    ledger; the elastic runner solves only the missing units, byte-equal
    to the uninterrupted run."""
    scfg = SolverConfig(algorithm="mu", max_iter=40)
    kw = dict(ks=(2, 3), restarts=6, seed=5)
    ref = _ref(two_group_data, scfg, tmp_path, "ref", **kw)
    cfg = CheckpointConfig(str(tmp_path / "c"), every_n_restarts=2)
    pfaults.arm("proc.preempt", every=3, max_fires=1)
    try:
        with pytest.raises(pckpt.Preempted):
            nmfconsensus(two_group_data, solver_cfg=scfg, checkpoint=cfg,
                         device="cpu", **kw)
    finally:
        pfaults.disarm("proc.preempt")
    before = pckpt.chunks_solved_count()
    res = dist.elastic_consensus(two_group_data, solver_cfg=scfg,
                                 checkpoint=cfg, devices=["cpu"] * 2, **kw)
    assert pckpt.chunks_solved_count() - before == 4  # 6 units - 2 kept
    _bit_identical(res, ref)


def test_elastic_all_shards_dead_raises_then_resumes(two_group_data,
                                                     tmp_path):
    scfg = SolverConfig(algorithm="mu", max_iter=40)
    kw = dict(ks=(2,), restarts=4, seed=5)
    cfg = CheckpointConfig(str(tmp_path / "c"), every_n_restarts=2)
    pfaults.arm("proc.preempt", every=1)  # every attempt preempts
    try:
        with pytest.raises(RuntimeError, match="re-run to resume"):
            dist.elastic_consensus(two_group_data, solver_cfg=scfg,
                                   checkpoint=cfg, devices=["cpu"] * 2,
                                   **kw)
    finally:
        pfaults.disarm("proc.preempt")
    ref = _ref(two_group_data, scfg, tmp_path, "ref", **kw)
    res = dist.elastic_consensus(two_group_data, solver_cfg=scfg,
                                 checkpoint=cfg, devices=["cpu"] * 2, **kw)
    _bit_identical(res, ref)


def test_elastic_absorbed_crash_does_not_raise(two_group_data, tmp_path,
                                               monkeypatch):
    """A crash (not a preemption) whose unit the survivor absorbed is
    warned once and not raised: the result is whole and exact."""
    pfaults._reset_warned()
    scfg = SolverConfig(algorithm="mu", max_iter=40)
    kw = dict(ks=(2,), restarts=4, seed=5)
    ref = _ref(two_group_data, scfg, tmp_path, "ref", **kw)
    real = pckpt.solve_chunk_host
    state = {"crashed": False}

    def crash_once(*args, **kwargs):
        if not state["crashed"]:
            state["crashed"] = True
            raise RuntimeError("transient device error")
        return real(*args, **kwargs)

    monkeypatch.setattr(pckpt, "solve_chunk_host", crash_once)
    with pytest.warns(RuntimeWarning, match="crashed"):
        res = dist.elastic_consensus(
            two_group_data, solver_cfg=scfg,
            checkpoint=CheckpointConfig(str(tmp_path / "el"),
                                        every_n_restarts=2),
            devices=["cpu"] * 2, **kw)
    _bit_identical(res, ref)


def test_elastic_shard_devices_uneven_counts_typed(two_group_data,
                                                   tmp_path):
    ccfg = ConsensusConfig(ks=(2,), restarts=4, seed=5)
    # kl: the batched restart route, which a meshed shard runs
    scfg, icfg = SolverConfig(algorithm="kl", max_iter=10), InitConfig()
    ck = pckpt.SweepCheckpoint.open(
        np.asarray(two_group_data), ccfg, scfg, icfg,
        CheckpointConfig(str(tmp_path / "ck"), every_n_restarts=2))

    def mk(**kw):
        return dist.ElasticShardRunner(ck, ccfg, scfg, icfg,
                                       np.asarray(two_group_data), **kw)

    with pytest.raises(dist.MeshSpecError, match=">= 1"):
        mk(devices=["cpu"], shard_devices=0)
    with pytest.raises(dist.MeshSpecError, match="exceeds"):
        mk(devices=["cpu"] * 2, shard_devices=4)
    with pytest.raises(dist.MeshSpecError, match="divide"):
        mk(devices=["cpu"] * 6, shard_devices=4)
    r = mk(devices=["cpu"] * 6, shard_devices=2)
    assert [len(g) for g in r._groups] == [2, 2, 2]


@pytest.mark.parametrize("algorithm", ["kl", "neals"])
def test_elastic_meshed_shards_bit_identical(two_group_data, tmp_path,
                                             algorithm):
    """shard_devices=2 over four entries (two meshed shards, one chunk of
    three lanes padded to four): byte-equal to the single-device
    checkpointed run. The packed family is refused there."""
    scfg = SolverConfig(algorithm=algorithm, max_iter=40)
    kw = dict(ks=(2, 3), restarts=6, seed=5)
    ref = nmfconsensus(two_group_data, solver_cfg=scfg, device="cpu",
                       checkpoint=CheckpointConfig(str(tmp_path / "ref"),
                                                   every_n_restarts=3),
                       **kw)
    res = dist.elastic_consensus(
        two_group_data, solver_cfg=scfg,
        checkpoint=CheckpointConfig(str(tmp_path / "mesh"),
                                    every_n_restarts=3),
        devices=["cpu"] * 4, shard_devices=2, **kw)
    _bit_identical(res, ref)


def test_meshed_chunk_refuses_the_packed_family(two_group_data, tmp_path):
    with pytest.raises(ValueError, match="batched restart route only"):
        dist.elastic_consensus(
            two_group_data, ks=(2,), restarts=4,
            solver_cfg=SolverConfig(algorithm="mu", max_iter=10),
            checkpoint=str(tmp_path / "c"), devices=["cpu"] * 2,
            shard_devices=2)


def test_elastic_counters_and_heartbeat_ledger(two_group_data, tmp_path):
    from nmfx_torch.obs import metrics

    scfg = SolverConfig(algorithm="mu", max_iter=20)
    reg = metrics.registry()
    before = reg.snapshot()
    dist.elastic_consensus(two_group_data, ks=(2,), restarts=4,
                           solver_cfg=scfg,
                           checkpoint=CheckpointConfig(
                               str(tmp_path / "c"), every_n_restarts=1),
                           devices=["cpu"] * 2)
    delta = reg.delta(before)
    solved = {key: v for key, v in delta[
        "nmfx_elastic_units_solved_total"]["series"].items() if v}
    assert sum(solved.values()) == 4
    assert set(solved) <= {("0",), ("1",)}
    assert reg.snapshot()["nmfx_elastic_shards_alive"]["series"][()] == 0
    names = sorted(os.listdir(tmp_path / "c"))
    assert "shard_0.json" in names and "shard_1.json" in names


# -- the communication model ---------------------------------------------
MESHES = [(1, 1, 1), (2, 1, 1), (4, 1, 1), (8, 1, 1), (1, 2, 1),
          (1, 1, 2), (2, 2, 1), (2, 2, 2), (1, 4, 2)]


@pytest.mark.parametrize("algorithm", sorted(ncost.comm_covered_algorithms()))
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_comm_model_matches_reference(algorithm, shape):
    r, f, s = shape
    for m, n, k, restarts in ((5000, 500, 10, 50), (120, 24, 3, 7)):
        kw = dict(restart_shards=r, feature_shards=f, sample_shards=s,
                  restarts=restarts)
        assert (pcost.comm_model(algorithm, m, n, k, **kw)
                == ncost.comm_model(algorithm, m, n, k, **kw))
    assert pcost.comm_covered_algorithms() == ncost.comm_covered_algorithms()


def test_comm_model_errors_match_reference():
    for args, kw in ((("als", 10, 10, 2), {}),
                     (("mu", 10, 10, 2), {"feature_shards": 0})):
        with pytest.raises(ValueError) as got:
            pcost.comm_model(*args, **kw)
        with pytest.raises(ValueError) as want:
            ncost.comm_model(*args, **kw)
        assert str(got.value) == str(want.value)


def test_mesh_attribution_prices_distinct_devices():
    """Two restart shards on one device are priced as that device: the
    same MFU as the unmeshed dispatch."""
    scfg = SolverConfig(max_iter=10)
    saved = pcost.DEVICE_PEAKS.get("cpu")
    pcost.set_device_peak("cpu", 1e12, 1e11)
    try:
        iters = {2: np.array([10, 10])}
        one = pcost.attribute_dispatch("sweep.k", scfg, 100, 20, iters, 0.5,
                                       device=CPU)
        two = pcost.attribute_dispatch(
            "sweep.k", scfg, 100, 20, iters, 0.5, device=CPU,
            mesh=grid_mesh(2, devices=["cpu", "cpu"]))
        assert one["mfu"] == two["mfu"] and one["mfu"] is not None
        assert one["hbm_bw_fraction"] == two["hbm_bw_fraction"]
    finally:
        if saved is None:
            pcost.DEVICE_PEAKS.pop("cpu", None)
        else:
            pcost.DEVICE_PEAKS["cpu"] = saved


# -- two processes over gloo ---------------------------------------------
_WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    coord, pid, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    import nmfx_torch
    import nmfx_torch.distributed as dist
    dist.initialize(coordinator_address=coord, num_processes=2,
                    process_id=pid, timeout_s=float(sys.argv[4]))
    assert torch.distributed.get_world_size() == 2
    from nmfx_torch.config import SolverConfig
    from nmfx_torch.datasets import two_group_matrix
    a = two_group_matrix(n_genes=80, n_per_group=8, seed=1)
    # per-process output dir: only the coordinator's may appear
    result = dist.consensus(
        a, ks=(2, 3), restarts=8, seed=5, devices=["cpu", "cpu"],
        solver_cfg=SolverConfig(max_iter=150),
        output=nmfx_torch.OutputConfig(
            directory=os.path.join(outdir, f"files{pid}"),
            write_plots=False))
    plain = nmfx_torch.nmfconsensus(
        a, ks=(2, 3), restarts=8, seed=5, device="cpu",
        solver_cfg=SolverConfig(max_iter=150))
    payload = {"summary": result.summary(),
               "consensus2": np.asarray(result.per_k[2].consensus).tolist(),
               "plain_equal": all(
                   np.asarray(result.per_k[k].consensus).tobytes()
                   == np.asarray(plain.per_k[k].consensus).tobytes()
                   and np.asarray(result.per_k[k].dnorms).tobytes()
                   == np.asarray(plain.per_k[k].dnorms).tobytes()
                   for k in (2, 3))}
    with open(os.path.join(outdir, f"proc{pid}.json"), "w") as f:
        json.dump(payload, f)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_consensus(tmp_path):
    """Two OS processes, one gloo group, a global mesh of four CPU
    entries: both return the same result, byte-equal to the
    single-process run, and only the coordinator writes files."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, coord, str(i), str(tmp_path),
         str(PROC_TIMEOUT_S / 2)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=PROC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode != 0:
            errs.append(err[-3000:])
    assert not errs, errs
    r0, r1 = (json.loads((tmp_path / f"proc{i}.json").read_text())
              for i in range(2))
    assert r0["summary"] == r1["summary"]
    assert r0["consensus2"] == r1["consensus2"]
    assert r0["plain_equal"] and r1["plain_equal"]
    assert "best k = 2" in r0["summary"]
    assert "cophenetic.txt" in os.listdir(tmp_path / "files0")
    assert not (tmp_path / "files1").exists()
