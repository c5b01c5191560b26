"""The grid axes across two processes (nmfx's grid worker,
``tests/test_multiprocess.py:45-70``, ``:197-201``).

Two OS processes join one gloo group on 127.0.0.1 and build
``distributed.global_mesh(2, 2, devices=["cpu", "cpu"])``: four entries,
a (1, 2, 2) mesh whose feature axis crosses the process boundary, so
every iteration's feature sums travel over the gloo subgroup. Each
process runs kl and mu sweeps on it through ``distributed.consensus``
and, alone, the same (1, 2, 2) mesh over four CPU entries of its own.
The collective layer adds the parts in shard order whatever the layout,
so the two-process results must equal the one-process ones byte for
byte. The whole test runs under its own time limit."""

import json
import os
import socket
import subprocess
import sys
import textwrap

from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: each subprocess, and the rendezvous and every gather inside it
PROC_TIMEOUT_S = 60.0

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
    from nmfx_torch.config import SolverConfig
    from nmfx_torch.datasets import two_group_matrix
    from nmfx_torch.sweep import grid_mesh
    mesh = dist.global_mesh(2, 2, devices=["cpu", "cpu"])
    assert mesh.shape == {"restarts": 1, "features": 2, "samples": 2}
    assert mesh.processes.tolist() == [[[0, 0], [1, 1]]]
    a = two_group_matrix(n_genes=80, n_per_group=8, seed=1)
    local = grid_mesh(1, 2, 2, devices=["cpu"] * 4)
    payload = {}
    for alg in ("kl", "mu"):
        kw = dict(ks=(2,), restarts=4, seed=5,
                  solver_cfg=SolverConfig(algorithm=alg, max_iter=150))
        two = dist.consensus(a, feature_shards=2, sample_shards=2,
                             devices=["cpu", "cpu"], **kw)
        one = nmfx_torch.nmfconsensus(a, mesh=local, **kw)
        r2, r1 = two.per_k[2], one.per_k[2]
        payload[alg] = {
            "summary": two.summary(),
            "consensus2": np.asarray(r2.consensus).tolist(),
            "byte_equal": all(
                np.asarray(getattr(r2, f)).tobytes()
                == np.asarray(getattr(r1, f)).tobytes()
                for f in ("consensus", "membership", "iterations", "dnorms",
                          "stop_reasons", "best_w", "best_h"))}
    with open(os.path.join(outdir, f"grid{pid}.json"), "w") as f:
        json.dump(payload, f)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_grid_axes_byte_equal_to_one_process(tmp_path):
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
    r0, r1 = (json.loads((tmp_path / f"grid{i}.json").read_text())
              for i in range(2))
    for alg in ("kl", "mu"):
        assert r0[alg]["summary"] == r1[alg]["summary"]
        assert r0[alg]["consensus2"] == r1[alg]["consensus2"]
        assert r0[alg]["byte_equal"] and r1[alg]["byte_equal"], alg
        assert "best k = 2" in r0[alg]["summary"]
