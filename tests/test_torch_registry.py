"""The per-rank registry (``nmfx_torch/registry.py``,
``nmfconsensus(checkpoint_dir=...)``), as ``tests/test_registry.py``
pins the reference's: a save/load round trip, the fingerprint guard, a
resume that loads the finished ranks and solves only the new ones, and
a corrupt record that heals by a re-solve."""

import logging
import os

import numpy as np
import pytest

import nmfx_torch
from nmfx_torch import data_cache
from nmfx_torch.config import InitConfig, SolverConfig
from nmfx_torch.datasets import two_group_matrix
from nmfx_torch.registry import (SweepRegistry, _fingerprint,
                                 fingerprint_solver_fields)
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)

KW = dict(restarts=3, seed=2, max_iter=40, device="cpu")


@pytest.fixture(scope="module")
def data():
    return two_group_matrix(n_genes=50, n_per_group=8, seed=4)


def test_save_load_roundtrip(data, tmp_path):
    res = nmfx_torch.nmfconsensus(data, ks=(2,), **KW)
    from nmfx_torch.sweep import sweep
    from nmfx_torch.config import ConsensusConfig

    out = sweep(data, ConsensusConfig(ks=(2,), restarts=3, seed=2),
                SolverConfig(max_iter=40), InitConfig(), device="cpu")[2]
    reg = SweepRegistry.open(str(tmp_path), data, SolverConfig(max_iter=40),
                             InitConfig(), 3, 2, "argmax")
    assert not reg.has(2)
    reg.save(2, out)
    assert reg.has(2) and reg.completed_ks() == [2]
    back = reg.load(2)
    for name in ("consensus", "iterations", "dnorms", "stop_reasons",
                 "labels", "best_w", "best_h"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      getattr(back, name), err_msg=name)
    assert back.all_w is None
    np.testing.assert_array_equal(back.consensus, res.per_k[2].consensus)


def test_fingerprint_guard(data, tmp_path):
    SweepRegistry.open(str(tmp_path), data, SolverConfig(), InitConfig(),
                       3, 2, "argmax")
    with pytest.raises(ValueError, match="different"):
        SweepRegistry.open(str(tmp_path), data, SolverConfig(), InitConfig(),
                           3, 3, "argmax")
    fp = _fingerprint(data, SolverConfig(), InitConfig(), 4, 1, "argmax")
    assert _fingerprint(data, SolverConfig(backend="packed"), InitConfig(),
                        4, 1, "argmax") == fp  # the same engine family
    assert _fingerprint(data, SolverConfig(restart_chunk=2), InitConfig(),
                        4, 1, "argmax") == fp
    assert _fingerprint(data, SolverConfig(backend="vmap"), InitConfig(),
                        4, 1, "argmax") != fp
    assert "restart_chunk" not in fingerprint_solver_fields()


def test_resume_through_checkpoint_dir(data, tmp_path):
    ck = str(tmp_path / "reg")
    r1 = nmfx_torch.nmfconsensus(data, ks=(2, 3), checkpoint_dir=ck, **KW)
    t = data_cache.transfer_count()
    r2 = nmfx_torch.nmfconsensus(data, ks=(2, 3), checkpoint_dir=ck, **KW)
    assert data_cache.transfer_count() == t  # every rank loaded
    for k in (2, 3):
        np.testing.assert_array_equal(r1.per_k[k].consensus,
                                      r2.per_k[k].consensus)
        assert r1.per_k[k].rho == r2.per_k[k].rho
    r3 = nmfx_torch.nmfconsensus(data, ks=(2, 3, 4), checkpoint_dir=ck,
                                 **KW)
    assert set(r3.per_k) == {2, 3, 4}
    np.testing.assert_array_equal(r3.per_k[2].consensus,
                                  r1.per_k[2].consensus)
    plain = nmfx_torch.nmfconsensus(data, ks=(2, 3, 4), **KW)
    for k in (2, 3, 4):
        np.testing.assert_array_equal(r3.per_k[k].consensus,
                                      plain.per_k[k].consensus)


def test_corrupt_record_self_heals(data, tmp_path, caplog):
    ck = str(tmp_path / "reg")
    first = nmfx_torch.nmfconsensus(data, ks=(2, 3), checkpoint_dir=ck,
                                    harvest="sequential", **KW)
    with open(os.path.join(ck, "k3.npz"), "wb") as f:
        f.write(b"not an npz")
    with caplog.at_level(logging.WARNING, logger="nmfx_torch"):
        second = nmfx_torch.nmfconsensus(data, ks=(2, 3), checkpoint_dir=ck,
                                         **KW)
    assert any("unreadable" in r.message for r in caplog.records)
    assert second.summary() == first.summary()
    third = nmfx_torch.nmfconsensus(data, ks=(2, 3), checkpoint_dir=ck,
                                    **KW)
    assert third.summary() == first.summary()
