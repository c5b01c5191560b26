"""The restart mesh: a restart-sharded sweep byte-equal to the unmeshed
one on every route (the batched restart route, mu's per-rank packed
solve, the whole grid under mu and hals, the kernels' plain versions
under ``backend="pallas"``, the durable chunk executor) at 2, 3 and 4
shards with padding; the pad counter; the mesh builders' shapes and
errors against nmfx's; grid axes running as nmfx's do (the test name
kept from when they were refused);
and the port's meshed sweep against nmfx's meshed sweep
(``grid_mesh(4, 1, 1)`` on the forced CPU devices) at the agreement tier.

On the CPU the mesh names the one CPU device several times: the port's
counterpart of the forced CPU devices nmfx's mesh tests run on."""

import numpy as np
import pytest
import torch

import nmfx
import nmfx_torch
from nmfx import sweep as nsweep
from nmfx.agreement import adjusted_rand_index
from nmfx_torch import faults as pfaults
from nmfx_torch import random as _random
from nmfx_torch import sweep as psweep
from nmfx_torch.config import (CheckpointConfig, ConsensusConfig,
                               InitConfig, SolverConfig)
from nmfx_torch.datasets import two_group_matrix
from nmfx_torch.device import Mesh
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
KS = (2, 3)
RESTARTS = 7  # padded to 8, 9 and 8 lanes at 2, 3 and 4 shards
SHARDS = (2, 3, 4)

#: route name → (ConsensusConfig kwargs, SolverConfig kwargs)
ROUTES = {
    "batched": (dict(), dict(algorithm="neals", max_iter=60)),
    "batched-chunked": (dict(ks=(2,)), dict(algorithm="kl", max_iter=60,
                                            restart_chunk=3)),
    "packed-per-rank": (dict(grid_exec="per_k"), dict(max_iter=200)),
    "grid-mu": (dict(), dict(max_iter=200)),
    "grid-hals": (dict(), dict(algorithm="hals", max_iter=200)),
    "pallas-per-rank": (dict(grid_exec="per_k"),
                        dict(max_iter=200, backend="pallas")),
    "pallas-grid-mu": (dict(), dict(max_iter=200, backend="pallas")),
    "pallas-grid-hals": (dict(), dict(algorithm="hals", max_iter=200,
                                      backend="pallas")),
}
FIELDS = ("consensus", "iterations", "dnorms", "stop_reasons", "labels",
          "best_w", "best_h", "all_w", "all_h")


def _mesh(r: int) -> Mesh:
    return psweep.grid_mesh(r, devices=["cpu"] * r)


@pytest.fixture(scope="module")
def data():
    return two_group_matrix(60, 8, seed=3).astype(np.float32)


def _sweep(data, route: str, mesh, keep_factors: bool = False):
    ckw, skw = ROUTES[route]
    cfg = ConsensusConfig(**{"ks": KS, "restarts": RESTARTS, "seed": 5,
                             "keep_factors": keep_factors, **ckw})
    return psweep.sweep(data, cfg, SolverConfig(**skw), device="cpu",
                        mesh=mesh)


def _assert_byte_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        for f in FIELDS:
            x, y = getattr(want[k], f), getattr(got[k], f)
            if x is None:
                assert y is None, (k, f)
                continue
            assert x.dtype == y.dtype and x.shape == y.shape, (k, f)
            assert x.numpy().tobytes() == y.numpy().tobytes(), (k, f)


@pytest.fixture(scope="module")
def unmeshed(data):
    return {route: _sweep(data, route, None) for route in ROUTES}


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_meshed_sweep_byte_equal_to_unmeshed(data, unmeshed, route, shards):
    _assert_byte_equal(_sweep(data, route, _mesh(shards)), unmeshed[route])


@pytest.mark.parametrize("route", ["batched", "packed-per-rank", "grid-mu"])
def test_meshed_keep_factors_byte_equal(data, route):
    _assert_byte_equal(_sweep(data, route, _mesh(3), keep_factors=True),
                       _sweep(data, route, None, keep_factors=True))


@pytest.mark.parametrize("shards", SHARDS)
def test_meshed_chunk_executor_byte_equal(data, shards):
    """The durable chunk executor over a restart sub-mesh returns the
    unmeshed executor's record, a poisoned lane included."""
    scfg = SolverConfig(algorithm="neals", max_iter=60)
    icfg = InitConfig()
    a = torch.as_tensor(data)
    keys = _random.split(_random.fold_in(_random.key(5), 2), 10)[2:7]
    want = psweep._build_chunk_sweep_fn(2, 5, scfg, icfg, "argmax",
                                        (1,))(a, keys)
    mesh = _mesh(shards)
    got = psweep._build_meshed_chunk_sweep_fn(
        2, 5, scfg, icfg, "argmax", (1,), mesh)({CPU: a}, keys)
    for f, x, y in zip(want._fields, want, got):
        assert x.dtype == y.dtype and x.numpy().tobytes() == \
            y.numpy().tobytes(), f
    assert int(got.stop_reasons[1]) == int(nmfx_torch.StopReason
                                           .NUMERIC_FAULT)


def test_pad_lanes_counted(data):
    before = psweep._pad_lanes_total.value()
    _sweep(data, "grid-mu", _mesh(3))  # 7 -> 9 lanes
    assert psweep._pad_lanes_total.value() - before == 2
    _sweep(data, "batched", _mesh(4))  # 7 -> 8 lanes, for each of 2 ranks
    assert psweep._pad_lanes_total.value() - before == 4
    _sweep(data, "grid-mu", _mesh(1))
    assert psweep._pad_lanes_total.value() - before == 4


def test_nmfconsensus_mesh_byte_equal_and_registry_shared(data, tmp_path):
    kw = dict(ks=KS, restarts=RESTARTS, seed=5, max_iter=200)
    plain = nmfx_torch.nmfconsensus(data, device="cpu", **kw)
    meshed = nmfx_torch.nmfconsensus(data, mesh=_mesh(2), **kw)
    assert meshed.best_k == plain.best_k
    for k in KS:
        for f in ("consensus", "membership", "iterations", "dnorms",
                  "stop_reasons", "best_w", "best_h"):
            assert np.asarray(getattr(meshed.per_k[k], f)).tobytes() == \
                np.asarray(getattr(plain.per_k[k], f)).tobytes(), (k, f)
    # the mesh enters the registry's fingerprint only through the engine
    # family: a meshed run resumes an unmeshed registry
    reg = str(tmp_path / "reg")
    nmfx_torch.nmfconsensus(data, device="cpu", checkpoint_dir=reg, **kw)
    again = nmfx_torch.nmfconsensus(data, mesh=_mesh(3),
                                    checkpoint_dir=reg, **kw)
    assert again.best_k == plain.best_k


def test_place_input_replicates_per_distinct_device(data):
    from nmfx_torch import data_cache

    copies = psweep.place_input(data, SolverConfig(), _mesh(3))
    assert list(copies) == [CPU]
    assert torch.equal(copies[CPU], torch.as_tensor(data))
    before = data_cache.transfer_count()
    psweep.place_input(data, SolverConfig(), _mesh(4))
    assert data_cache.transfer_count() == before  # the cached copy


def test_sketched_and_screened_ignore_a_restart_mesh(data):
    for skw in (dict(backend="sketched", max_iter=40),
                dict(screen=True, screen_keep=3, max_iter=40)):
        cfg = ConsensusConfig(ks=(2,), restarts=5, seed=5)
        want = psweep.sweep(data, cfg, SolverConfig(**skw), device="cpu")
        got = psweep.sweep(data, cfg, SolverConfig(**skw), mesh=_mesh(2))
        assert torch.equal(got[2].consensus, want[2].consensus)
        assert torch.equal(got[2].dnorms, want[2].dnorms)


def test_sharded_poison_and_checkpoint_refused(data, tmp_path):
    pfaults.arm("solve.nonfinite", lanes=((2, 1),))
    try:
        with pytest.raises(ValueError, match="restart-sharded mesh"):
            _sweep(data, "grid-mu", _mesh(2))
    finally:
        pfaults.disarm("solve.nonfinite")
    with pytest.raises(ValueError, match="elastic shard runner") as got:
        nmfx_torch.nmfconsensus(data, ks=(2,), restarts=4, mesh=_mesh(2),
                                checkpoint=CheckpointConfig(
                                    str(tmp_path / "c")))
    with pytest.raises(ValueError, match="elastic shard runner") as want:
        nmfx.nmfconsensus(data, ks=(2,), restarts=4,
                          mesh=nsweep.grid_mesh(2, 1, 1),
                          checkpoint=nmfx.CheckpointConfig(
                              str(tmp_path / "n")))
    assert str(got.value).replace("nmfx_torch", "nmfx") == str(want.value)
    with pytest.raises(ValueError, match="elastic shard runner"):
        psweep.sweep(data, ConsensusConfig(ks=(2,), restarts=4),
                     SolverConfig(), mesh=_mesh(2),
                     checkpoint=CheckpointConfig(str(tmp_path / "s")))


@pytest.mark.parametrize("shape", [(1, 2, 1), (1, 1, 2), (2, 2, 2)],
                         ids=["features", "samples", "grid"])
def test_grid_axes_refused_naming_10c_ii(data, shape):
    r, f, s = shape
    mesh = psweep.grid_mesh(r, f, s, devices=["cpu"] * (r * f * s))
    assert psweep.grid_axes_active(mesh)
    assert not psweep.grid_exec_ok(SolverConfig(), mesh)
    got = nmfx_torch.nmfconsensus(data, ks=(2,), restarts=2, mesh=mesh)
    ref = nmfx_torch.nmfconsensus(data, ks=(2,), restarts=2, device="cpu")
    np.testing.assert_array_equal(got.per_k[2].membership,
                                  ref.per_k[2].membership)
    one = psweep.sweep_one_k(torch.as_tensor(data), _random.key(0), 2, 2,
                             mesh=mesh)
    assert one.labels.shape == (2, data.shape[1])
    assert (psweep.resolve_engine_family(SolverConfig(), mesh)
            == nsweep.resolve_engine_family(nmfx.SolverConfig(),
                                            nsweep.grid_mesh(r, f, s)))


def test_engine_family_and_grid_exec_follow_reference():
    for alg, backend in (("mu", "auto"), ("mu", "pallas"), ("hals", "auto"),
                         ("neals", "packed"), ("kl", "auto"),
                         ("pg", "vmap")):
        cfg = SolverConfig(algorithm=alg, backend=backend)
        ncfg = nmfx.SolverConfig(algorithm=alg, backend=backend)
        nmesh = nsweep.grid_mesh(4, 1, 1)
        assert (psweep.resolve_engine_family(cfg, _mesh(4))
                == nsweep.resolve_engine_family(ncfg, nmesh))
        assert (psweep.grid_exec_ok(cfg, _mesh(4))
                == nsweep.grid_exec_ok(ncfg, nmesh))


# -- the mesh builders against nmfx's ------------------------------------
@pytest.mark.parametrize("args", [(4, 1, 1), (2, 2, 1), (2, 1, 2),
                                  (1, 2, 2), (None, 2, 1), (None, 1, 1),
                                  (2, 2, 2)],
                         ids=lambda a: "x".join(map(str, a)))
def test_grid_mesh_shapes_match_reference(args):
    devices = ["cpu"] * 8
    got = psweep.grid_mesh(*args, devices=devices)
    want = nsweep.grid_mesh(*args)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert got.size == want.size
    assert got.distinct_devices() == [CPU]


@pytest.mark.parametrize("args", [(0, 1, 1), (9, 1, 1), (1, 0, 1),
                                  (None, 3, 3), (2, 5, 1)],
                         ids=lambda a: "x".join(map(str, a)))
def test_grid_mesh_errors_match_reference(args):
    with pytest.raises(ValueError) as got:
        psweep.grid_mesh(*args, devices=["cpu"] * 8)
    with pytest.raises(ValueError) as want:
        nsweep.grid_mesh(*args)
    assert str(got.value) == str(want.value)


def test_feature_and_default_mesh_match_reference():
    got = psweep.feature_mesh(2, 4, devices=["cpu"] * 8)
    want = nsweep.feature_mesh(2, 4)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    auto = psweep.feature_mesh(None, 2, devices=["cpu"] * 8)
    assert auto.shape == dict(nsweep.feature_mesh(None, 2).shape)
    if not torch.cuda.is_available():
        # no card: the unmeshed route, as nmfx's on one device
        assert psweep.default_mesh() is None
        assert psweep.local_devices() == []
    assert nmfx_torch.default_mesh is psweep.default_mesh
    assert nmfx_torch.grid_mesh is psweep.grid_mesh
    assert nmfx_torch.feature_mesh is psweep.feature_mesh


def test_mesh_entries_checked():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            psweep.grid_mesh(2, devices=["cuda", "cuda"])
    with pytest.raises(ValueError, match="names"):
        Mesh(["cpu"] * 2, ("restarts", "features"))
    m = psweep.grid_mesh(2, devices=["cpu"] * 2)
    assert m == psweep.grid_mesh(2, devices=["cpu"] * 2)
    assert hash(m) == hash(psweep.grid_mesh(2, devices=["cpu"] * 2))
    assert psweep.mesh_home(m) == CPU


def test_meshed_sweep_agrees_with_reference_meshed_sweep():
    """The port's restart mesh against nmfx's ``grid_mesh(4, 1, 1)`` on
    the forced CPU devices, whole grid (mu, default backend), at the tier
    the unmeshed routes are held to against nmfx: best k, memberships,
    per-restart iterations and stops and rho equal, consensus to
    atol=1e-6."""
    a = two_group_matrix(200, 12, seed=3)
    kw = dict(ks=(2, 3, 4), restarts=10, seed=11, max_iter=300)
    want = nmfx.nmfconsensus(a, mesh=nsweep.grid_mesh(4, 1, 1), **kw)
    got = nmfx_torch.nmfconsensus(a, mesh=_mesh(4), **kw)
    assert got.best_k == want.best_k == 2
    for k in kw["ks"]:
        g, w = got.per_k[k], want.per_k[k]
        assert adjusted_rand_index(g.membership,
                                   np.asarray(w.membership)) == 1.0
        np.testing.assert_array_equal(g.iterations, np.asarray(w.iterations))
        np.testing.assert_array_equal(g.stop_reasons,
                                      np.asarray(w.stop_reasons))
        np.testing.assert_allclose(g.consensus, np.asarray(w.consensus),
                                   rtol=0, atol=1e-6)
        assert g.rho == w.rho
