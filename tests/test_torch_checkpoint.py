"""The durable sweep ledger (``nmfx_torch/checkpoint.py``) against
``nmfx``'s and against its own contracts (``tests/test_checkpoint.py``
pins them for the reference):

* the port's checkpointed sweep equals ``nmfx``'s on the same input:
  per-restart iterations, stop reasons and memberships equal, the
  consensus byte-equal (int64 counts over one float64 division);
* killed at half by ``proc.preempt`` and resumed: byte-equal to an
  uninterrupted checkpointed run; a full re-run solves 0 chunks; wider
  ks reuse the finished ranks; a manifest or plan mismatch cold-starts
  (sparing every file that is not a record); ``resume=False``; a torn
  record is skipped and solved again; the ``ckpt.write`` / ``ckpt.load``
  faults; ``every_s`` buffering; the signal hook; the ``keep_factors``
  refusal and the compose guards; a ledger written by ``nmfx`` cold-starts
  cleanly.
"""

import os
import signal

import numpy as np
import pytest

import nmfx
import nmfx_torch
from nmfx import faults as jfaults
from nmfx_torch import checkpoint as ckpt
from nmfx_torch import faults
from nmfx_torch.config import (CheckpointConfig, ConsensusConfig,
                               InitConfig, SolverConfig)
from nmfx_torch.datasets import two_group_matrix
from nmfx_torch.solvers.base import StopReason

KW = dict(ks=(2, 3), restarts=4, seed=5)
MU = dict(algorithm="mu", max_iter=30)


@pytest.fixture(scope="module")
def small_data():
    return two_group_matrix(n_genes=60, n_per_group=10, seed=7)


@pytest.fixture(autouse=True)
def _fresh():
    faults._reset_warned()
    yield
    faults.disarm()
    faults._reset_warned()


def _cfg(path, chunk=2, **kw):
    return CheckpointConfig(directory=str(path), every_n_restarts=chunk,
                            **kw)


def _run(data, path, scfg=MU, chunk=2, **over):
    kw = dict(KW, **over)
    return nmfx_torch.nmfconsensus(
        data, solver_cfg=SolverConfig(**scfg),
        checkpoint=_cfg(path, chunk=chunk), device="cpu", **kw)


def assert_byte_equal(got, ref):
    assert set(got.per_k) == set(ref.per_k)
    for k in ref.per_k:
        s, q = got.per_k[k], ref.per_k[k]
        for field in ("consensus", "membership", "order", "iterations",
                      "dnorms", "stop_reasons", "best_w", "best_h"):
            sv = np.ascontiguousarray(getattr(s, field))
            qv = np.ascontiguousarray(getattr(q, field))
            assert sv.shape == qv.shape and sv.dtype == qv.dtype \
                and sv.tobytes() == qv.tobytes(), f"{field} k={k}"
        assert s.rho == q.rho


def _records(path):
    return sorted(n for n in os.listdir(path) if n.endswith(".npz"))


# -- against nmfx ----------------------------------------------------------

@pytest.mark.parametrize("scfg", [MU, dict(algorithm="hals", max_iter=30)],
                         ids=["mu-packed", "hals-vmap"])
def test_checkpointed_sweep_equals_reference(small_data, tmp_path, scfg):
    got = _run(small_data, tmp_path / "t", scfg)
    want = nmfx.nmfconsensus(
        small_data, solver_cfg=nmfx.SolverConfig(**scfg),
        checkpoint=nmfx.CheckpointConfig(str(tmp_path / "j"),
                                         every_n_restarts=2), **KW)
    for k in KW["ks"]:
        g, w = got.per_k[k], want.per_k[k]
        assert np.array_equal(g.iterations, w.iterations)
        assert np.array_equal(g.stop_reasons, w.stop_reasons)
        assert np.array_equal(g.membership, w.membership)
        gc, wc = np.asarray(g.consensus), np.asarray(w.consensus)
        assert gc.dtype == wc.dtype == np.float64
        assert gc.tobytes() == wc.tobytes()
        np.testing.assert_allclose(g.best_w, w.best_w, rtol=1e-4,
                                   atol=1e-5)


def test_ledger_written_by_reference_cold_starts(small_data, tmp_path):
    """A ledger written by nmfx (another environment) is never resumed:
    the port cold-starts, solves every chunk, and spares the files that
    are not records."""
    d = tmp_path / "c"
    nmfx.nmfconsensus(small_data, max_iter=30,
                      checkpoint=nmfx.CheckpointConfig(
                          str(d), every_n_restarts=2), **KW)
    (d / "notes.txt").write_text("keep me")
    (d / "k2.npz").write_bytes(b"legacy registry record")
    solved = ckpt.chunks_solved_count()
    with pytest.warns(RuntimeWarning, match="COLD START"):
        got = _run(small_data, d)
    assert ckpt.chunks_solved_count() == solved + 4
    assert (d / "notes.txt").read_text() == "keep me"
    assert (d / "k2.npz").exists()
    assert_byte_equal(got, _run(small_data, tmp_path / "fresh"))


# -- resume semantics ------------------------------------------------------

def test_plan_and_config_basics(tmp_path):
    assert ckpt.plan_chunks(10, 4) == ((0, 4), (4, 8), (8, 10))
    assert ckpt.plan_chunks(4, None) == ((0, 4),)
    assert ckpt.plan_chunks(3, 8) == ((0, 3),)
    with pytest.raises(ValueError, match="every_n_restarts"):
        CheckpointConfig(str(tmp_path), every_n_restarts=0)
    with pytest.raises(ValueError, match="every_s"):
        CheckpointConfig(str(tmp_path), every_s=0.0)
    with pytest.raises(ValueError, match="directory"):
        CheckpointConfig(directory="")
    assert not issubclass(ckpt.Preempted, Exception)
    assert ckpt.engine_family(SolverConfig()) == "packed"
    assert ckpt.engine_family(SolverConfig(backend="pallas")) == "pallas"
    assert ckpt.engine_family(SolverConfig(algorithm="hals")) == "vmap"


@pytest.mark.parametrize("scfg", [MU, dict(algorithm="kl", max_iter=30)],
                         ids=["mu-packed", "kl-vmap"])
def test_kill_at_half_then_resume_byte_equal(small_data, tmp_path, scfg):
    ref = _run(small_data, tmp_path / "ref", scfg)
    faults.arm("proc.preempt", every=3, max_fires=1)
    with pytest.raises(ckpt.Preempted):
        _run(small_data, tmp_path / "kill", scfg)
    faults.disarm("proc.preempt")
    assert len(_records(tmp_path / "kill")) == 2
    solved, loaded = ckpt.chunks_solved_count(), ckpt.chunks_loaded_count()
    res = _run(small_data, tmp_path / "kill", scfg)
    assert ckpt.chunks_solved_count() - solved == 2
    assert ckpt.chunks_loaded_count() - loaded == 2
    assert_byte_equal(res, ref)


def test_full_rerun_solves_nothing_and_wider_ks_reuse(small_data,
                                                      tmp_path):
    r1 = _run(small_data, tmp_path / "c", ks=(2,))
    solved = ckpt.chunks_solved_count()
    r2 = _run(small_data, tmp_path / "c", ks=(2,))
    assert ckpt.chunks_solved_count() == solved
    assert_byte_equal(r2, r1)
    r3 = _run(small_data, tmp_path / "c", ks=(2, 3))
    assert ckpt.chunks_solved_count() == solved + 2  # rank 3 only
    assert np.asarray(r3.per_k[2].consensus).tobytes() == \
        np.asarray(r1.per_k[2].consensus).tobytes()


def test_manifest_mismatch_cold_start_plan_change_extends(small_data,
                                                          tmp_path):
    """Another seed cold-starts (sparing the files that are not
    records); another chunk plan of the same run extends the ledger, as
    in the reference: the new plan's chunks solve, the old records stay,
    and the result is byte-equal to a fresh run of the new plan."""
    _run(small_data, tmp_path / "c", seed=5)
    (tmp_path / "c" / "notes.txt").write_text("keep me")
    with pytest.warns(RuntimeWarning, match="COLD START"):
        r_new = _run(small_data, tmp_path / "c", seed=6)
    assert_byte_equal(r_new, _run(small_data, tmp_path / "f", seed=6))
    assert (tmp_path / "c" / "notes.txt").exists()
    solved = ckpt.chunks_solved_count()
    r_plan = _run(small_data, tmp_path / "c", seed=6, chunk=4)
    assert ckpt.chunks_solved_count() == solved + 2
    assert len(_records(tmp_path / "c")) == 6
    assert_byte_equal(r_plan, _run(small_data, tmp_path / "g", seed=6,
                                   chunk=4))


def test_resume_false_recomputes(small_data, tmp_path):
    r1 = _run(small_data, tmp_path / "c")
    solved = ckpt.chunks_solved_count()
    with pytest.warns(RuntimeWarning, match="resume=False"):
        r2 = nmfx_torch.nmfconsensus(
            small_data, solver_cfg=SolverConfig(**MU), device="cpu",
            checkpoint=_cfg(tmp_path / "c", resume=False), **KW)
    assert ckpt.chunks_solved_count() == solved + 4
    assert_byte_equal(r2, r1)


def test_torn_record_skipped_and_rerun(small_data, tmp_path):
    ref = _run(small_data, tmp_path / "c")
    with open(tmp_path / "c" / "k2_r0-2.npz", "r+b") as fh:
        fh.truncate(32)
    with pytest.warns(RuntimeWarning, match="torn/corrupt"):
        res = _run(small_data, tmp_path / "c")
    assert_byte_equal(res, ref)


def test_ckpt_write_and_load_faults(small_data, tmp_path):
    ref = _run(small_data, tmp_path / "ref")
    faults.arm("ckpt.write", every=1)
    with pytest.warns(RuntimeWarning, match="persist"):
        res = _run(small_data, tmp_path / "w")
    faults.disarm("ckpt.write")
    assert_byte_equal(res, ref)
    assert not _records(tmp_path / "w")
    solved = ckpt.chunks_solved_count()
    faults.arm("ckpt.load", every=1)
    with pytest.warns(RuntimeWarning, match="torn/corrupt"):
        res = _run(small_data, tmp_path / "ref")
    assert ckpt.chunks_solved_count() == solved + 4
    assert_byte_equal(res, ref)


def test_quarantine_composes_with_checkpointing(small_data, tmp_path):
    faults.arm("solve.nonfinite", lanes=((2, 1),))
    jfaults.arm("solve.nonfinite", lanes=((2, 1),))
    try:
        got = _run(small_data, tmp_path / "t")
        want = nmfx.nmfconsensus(
            small_data, max_iter=30, checkpoint=nmfx.CheckpointConfig(
                str(tmp_path / "j"), every_n_restarts=2), **KW)
    finally:
        jfaults.disarm()
    stops = got.per_k[2].stop_reasons
    assert stops[1] == int(StopReason.NUMERIC_FAULT)
    assert (stops != int(StopReason.NUMERIC_FAULT)).sum() == 3
    for k in KW["ks"]:
        assert np.array_equal(got.per_k[k].stop_reasons,
                              want.per_k[k].stop_reasons)
        assert np.asarray(got.per_k[k].consensus).tobytes() == \
            np.asarray(want.per_k[k].consensus).tobytes()


def test_keep_factors_and_compose_guards(small_data, tmp_path):
    with pytest.raises(ValueError, match="keep_factors"):
        _run(small_data, tmp_path / "c", keep_factors=True)
    with pytest.raises(ValueError, match="not both"):
        nmfx_torch.nmfconsensus(small_data, checkpoint=str(tmp_path / "a"),
                                checkpoint_dir=str(tmp_path / "b"),
                                device="cpu", **KW)


def test_sequential_harvest_and_device_selection_take_the_ledger(
        small_data, tmp_path):
    ref = _run(small_data, tmp_path / "c")
    seq = _run(small_data, tmp_path / "c", harvest="sequential")
    assert_byte_equal(seq, ref)
    dev = _run(small_data, tmp_path / "c", rank_selection="device")
    assert dev.best_k == ref.best_k


# -- buffered records and the signal hook ----------------------------------

def _dummy_record(m=3, n=4, k=2, c=2):
    from nmfx_torch.sweep import ChunkSweepOutput

    return ChunkSweepOutput(
        labels=np.zeros((c, n), np.int32),
        iterations=np.zeros((c,), np.int32),
        dnorms=np.zeros((c,), np.float32),
        stop_reasons=np.zeros((c,), np.int32),
        best_local=np.int32(0), best_w=np.zeros((m, k), np.float32),
        best_h=np.zeros((k, n), np.float32))


def _open_buffered(tmp_path, every_s=3600.0):
    return ckpt.SweepCheckpoint.open(
        np.ones((3, 4), np.float32), ConsensusConfig(ks=(2,), restarts=4,
                                                     seed=0),
        SolverConfig(max_iter=10), InitConfig(),
        CheckpointConfig(str(tmp_path / "buf"), every_n_restarts=2,
                         every_s=every_s))


def test_every_s_buffers_until_flush(tmp_path):
    ck = _open_buffered(tmp_path)
    ck.save(2, 0, 2, _dummy_record())
    assert not ck.has(2, 0, 2)
    ck.flush()
    assert ck.has(2, 0, 2) and ck.try_load(2, 0, 2) is not None


def test_signal_flush_hook_flushes_then_defers(tmp_path):
    """The hook writes the buffered records, then defers to the handler
    it found: a callable runs, the default disposition exits with
    128 + SIGTERM. ``restore`` puts back exactly the handler it found,
    and the test puts back whatever the test runner had installed. The
    handler is called directly: no signal is sent."""
    found = signal.getsignal(signal.SIGTERM)
    seen = []

    def recorder(signum, frame):
        seen.append(signum)

    try:
        for prev in (recorder, signal.SIG_DFL):
            signal.signal(signal.SIGTERM, prev)
            ck = _open_buffered(tmp_path / str(len(seen)))
            restore = ckpt.install_signal_flush(ck)
            try:
                ck.save(2, 0, 2, _dummy_record())
                assert not ck.has(2, 0, 2)
                handler = signal.getsignal(signal.SIGTERM)
                if prev is recorder:
                    handler(signal.SIGTERM, None)
                    assert seen == [signal.SIGTERM]
                else:
                    with pytest.raises(SystemExit) as exc:
                        handler(signal.SIGTERM, None)
                    assert exc.value.code == 128 + signal.SIGTERM
                assert ck.has(2, 0, 2)  # flushed before deferring
            finally:
                restore()
            assert signal.getsignal(signal.SIGTERM) is prev
    finally:
        signal.signal(signal.SIGTERM, found)
    assert signal.getsignal(signal.SIGTERM) is found


def test_config_carries_across_from_the_reference(tmp_path):
    import dataclasses

    from nmfx_torch.convert import checkpoint_config_from_dict

    ref = nmfx.CheckpointConfig(str(tmp_path), every_n_restarts=3,
                                every_s=5.0, resume=False)
    assert checkpoint_config_from_dict(dataclasses.asdict(ref)) == \
        CheckpointConfig(str(tmp_path), every_n_restarts=3, every_s=5.0,
                         resume=False)
    with pytest.raises(ValueError, match="unknown"):
        checkpoint_config_from_dict({"directory": "x", "bogus": 1})
