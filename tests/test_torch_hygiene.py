"""The port stands alone: no JAX and nothing of nmfx in nmfx_torch or in
chip_smoke.py, and no silent CPU fallback."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import nmfx_torch
from nmfx_torch.datasets import two_group_matrix
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "nmfx")


def _port_files():
    for root, _, files in os.walk(os.path.join(REPO, "nmfx_torch")):
        yield from (os.path.join(root, f) for f in files if f.endswith(".py"))
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_port_files()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_nmfx_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, nmfx_torch, nmfx_torch.api, nmfx_torch.convert, "
            "nmfx_torch.ops.packed_mu, nmfx_torch.ops.fused_mu, "
            "nmfx_torch.checkpoint, nmfx_torch.data_cache, "
            "nmfx_torch.faults, nmfx_torch.registry, nmfx_torch.guards, "
            "nmfx_torch.obs, nmfx_torch.obs.metrics, nmfx_torch.obs.trace, "
            "nmfx_torch.obs.flight, nmfx_torch.obs.export, "
            "nmfx_torch.obs.costmodel, nmfx_torch.obs.slo, "
            "nmfx_torch.exec_cache, nmfx_torch.result_cache, "
            "nmfx_torch.serve, nmfx_torch.replica, nmfx_torch.router, "
            "nmfx_torch.cli, nmfx_torch.obs.aggregate, nmfx_torch.obs.top, "
            "nmfx_torch.solvers.sketched, nmfx_torch.ops.lanczos_svd, "
            "nmfx_torch.distributed; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'nmfx')); print(bad); sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # the command line's help, run as python -m nmfx_torch: jax stays
    # out of sys.modules all the way through
    code = ("import runpy, sys; sys.argv = ['nmfx_torch', '--help']\n"
            "try:\n    runpy.run_module('nmfx_torch', run_name='__main__')\n"
            "except SystemExit as e:\n    assert e.code == 0, e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'nmfx')); print(bad); sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "usage: nmfx-torch" in proc.stdout and "--device" in proc.stdout


def test_entry_point_without_device_raises_when_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    a = two_group_matrix(40, 6, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nmfx_torch.nmfconsensus(
            a, ks=(2,), restarts=2, grid_exec="per_k",
            solver_cfg=nmfx_torch.SolverConfig(backend="pallas"))


def test_kernels_available_reflects_the_card():
    assert nmfx_torch.kernels_available() == torch.cuda.is_available()
