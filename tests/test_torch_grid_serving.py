"""The mesh-aware serving tier: ``ServeConfig.mesh_spec`` and
``serve.MeshEngine``, mesh replicas (``ReplicaPool(mesh_specs=)``) and
priced placement — the port's counterparts of nmfx's
``tests/test_serve.py:850-890`` and ``tests/test_router.py:830-931``.

Router and pool mechanics run on thread replicas over the scriptable
fake engine (``test_torch_serve.FakeEngine``), parametrized over both
packages: each case expects the same placements and stats from both.
The served cases run the real engines on the CPU, the mesh naming the
CPU once an entry: a meshed server's result is byte-equal to
``sweep()`` on its mesh, and an atlas-sized request lands on the mesh
replica with the grid collectives' bytes priced."""

import time

import numpy as np
import pytest

import nmfx.distributed as ndist
import nmfx.obs.metrics as nmetrics
import nmfx_torch.distributed as pdist
import nmfx_torch.obs.metrics as pmetrics
import nmfx_torch.serve as pserve
from nmfx_torch.config import ConsensusConfig, SolverConfig
from nmfx_torch.datasets import two_group_matrix
from nmfx_torch.sweep import sweep
from test_torch_router import _fast_cfg, _pool, pkg  # noqa: F401
from test_torch_serve import FakeEngine, _mat
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)

T = 60  # seconds: every future and join is bounded


def _hetero_pool(pkg, tmp_path, **kw):
    """One plain 1-device replica and one 4-device mesh replica (fake
    engines: placement mechanics only)."""
    return _pool(pkg, tmp_path, n=2, mesh_specs=(None, "4"), **kw)


def _placement_count(pkg, klass) -> float:
    metrics = pmetrics if pkg.name == "nmfx_torch" else nmetrics
    rec = metrics.registry().snapshot().get("nmfx_router_placement_total")
    if not rec:
        return 0.0
    return float(rec["series"].get((str(klass),), 0.0))


# -- ServeConfig.mesh_spec and MeshEngine ------------------------------------
@pytest.mark.parametrize("spec", ["two-by-two", "0x2", "2x2x2x2"])
def test_serve_config_mesh_spec_validated_at_construction(spec):
    with pytest.raises(pdist.MeshSpecError) as got:
        pserve.ServeConfig(mesh_spec=spec)
    with pytest.raises(ndist.MeshSpecError) as want:
        __import__("nmfx.serve").serve.ServeConfig(mesh_spec=spec)
    assert str(got.value) == str(want.value)
    assert pserve.ServeConfig(mesh_spec="2x2").mesh_spec == "2x2"


def test_mesh_engine_is_solo_only():
    eng = pserve.MeshEngine("4", devices="cpu")
    assert eng.n_devices == 4
    assert eng.compatibility_key(None) is None  # never packs
    with pytest.raises(RuntimeError, match="solo-only"):
        eng.dispatch_packed([], None)
    grid = pserve.MeshEngine("1x2x2", devices=["cpu"] * 4)
    assert grid.mesh.shape == {"restarts": 1, "features": 2, "samples": 2}


@pytest.mark.parametrize("spec", ["2", "1x2", "1x1x2"])
def test_mesh_server_rejects_exec_cache_and_matches_direct(spec):
    """A meshed server is not also a cache-tier server, and its result is
    byte-equal to ``sweep()`` on its mesh: serving is placement, never
    numerics."""
    from nmfx_torch.exec_cache import ExecCache

    with pytest.raises(ValueError, match="mesh_spec"):
        pserve.NMFXServer(pserve.ServeConfig(mesh_spec="4"),
                          exec_cache=ExecCache(device="cpu"), start=False)
    a = two_group_matrix(40, 8, seed=4).astype(np.float32)
    scfg = SolverConfig(max_iter=60)
    with pserve.NMFXServer(pserve.ServeConfig(mesh_spec=spec),
                           device="cpu") as srv:
        assert isinstance(srv.engine, pserve.MeshEngine)
        res = srv.submit(a, ks=(2, 3), restarts=4, seed=7,
                         solver_cfg=scfg).result(timeout=T)
        mesh = srv.engine.mesh
    ref = sweep(a, ConsensusConfig(ks=(2, 3), restarts=4, seed=7), scfg,
                mesh=mesh)
    for k in (2, 3):
        for f in ("consensus", "iterations", "dnorms", "stop_reasons",
                  "best_w", "best_h"):
            got = np.asarray(getattr(res.per_k[k], f))
            want = getattr(ref[k], f).numpy()
            assert got.astype(want.dtype).tobytes() == want.tobytes(), (k, f)


# -- mesh replicas and priced placement (both packages) ---------------------
def test_heartbeats_advertise_mesh_class(pkg, tmp_path):
    pool = _hetero_pool(pkg, tmp_path)
    try:
        classes = sorted((str(r.mesh_spec), r.n_devices)
                         for r in pool.routable())
        assert classes == [("4", 4), ("None", 1)]
        for rep in pool.routable():
            rep._beater.beat_once()
        beats = sorted((str(hb.get("mesh")), hb.get("devices"))
                       for hb in pool.heartbeats().values())
        assert beats == classes
    finally:
        pool.close()


def test_priced_placement_small_vs_atlas(pkg, tmp_path):
    """An atlas-sized request never lands on a 1-device replica while a
    mesh replica is routable; small requests stay off the mesh."""
    small = _mat()
    atlas = np.asarray(_mat(n=32, m=64))
    floor = small.nbytes + 1
    pool = _hetero_pool(pkg, tmp_path)
    with pkg.router.NMFXRouter(pool, _fast_cfg(
            pkg, atlas_floor_bytes=floor)) as router:
        c1, c4 = _placement_count(pkg, 1), _placement_count(pkg, 4)
        for _ in range(3):
            fut = router.submit(atlas, ks=(2,), restarts=2)
            fut.result(timeout=T)
            assert fut.stats.placement_class == 4
            inputs = fut.stats.placement_inputs
            assert inputs["atlas"] is True
            assert inputs["bytes"] == atlas.nbytes
            assert inputs["classes"] == [1, 4]
            assert "queue_depth" in inputs
        for _ in range(3):
            fut = router.submit(small, ks=(2,), restarts=2)
            fut.result(timeout=T)
            assert fut.stats.placement_class == 1
            assert fut.stats.placement_inputs["atlas"] is False
        assert _placement_count(pkg, 4) - c4 == 3
        assert _placement_count(pkg, 1) - c1 == 3


def test_pricing_off_leaves_stats_unpriced(pkg, tmp_path):
    pool = _hetero_pool(pkg, tmp_path)
    with pkg.router.NMFXRouter(pool, _fast_cfg(
            pkg, price_placement=False)) as router:
        fut = router.submit(_mat(), ks=(2,), restarts=2)
        fut.result(timeout=T)
        assert fut.stats.placement_class in (1, 4)
        assert fut.stats.placement_inputs is None


def test_atlas_falls_back_when_mesh_unroutable(pkg, tmp_path):
    pool = _hetero_pool(pkg, tmp_path)
    atlas = np.asarray(_mat(n=32, m=64))
    with pkg.router.NMFXRouter(pool, _fast_cfg(
            pkg, atlas_floor_bytes=1)) as router:
        meshed = [r for r in pool.routable() if r.n_devices == 4][0]
        meshed.drain()
        deadline = time.time() + 10
        while any(r.n_devices == 4 for r in pool.routable()):
            if time.time() > deadline:
                pytest.fail("mesh replica never left the routable set")
            time.sleep(0.05)
        fut = router.submit(atlas, ks=(2,), restarts=2)
        fut.result(timeout=T)
        assert fut.stats.placement_class == 1


def test_pool_mesh_specs_validation(pkg, tmp_path):
    spec_error = (pdist.MeshSpecError if pkg.name == "nmfx_torch"
                  else ndist.MeshSpecError)
    with pytest.raises(ValueError, match="mesh_specs has 1"):
        pkg.replica.ReplicaPool(2, root=str(tmp_path / "p1"),
                                mode="thread", engine_factory=FakeEngine,
                                mesh_specs=("4",))
    with pytest.raises(spec_error):
        pkg.replica.ReplicaPool(1, root=str(tmp_path / "p2"),
                                mode="thread", engine_factory=FakeEngine,
                                mesh_specs=("zero",))


# -- the real engines on the CPU ---------------------------------------------
def test_carving_names_a_device_more_than_once(tmp_path):
    """The port carves contiguous blocks of the pool's device list, which
    may name one device several times: two meshed replicas and a plain
    one on one device, and a spec past the list's end fails typed."""
    from nmfx_torch.replica import ReplicaPool, SpawnFailed

    pool = ReplicaPool(3, root=str(tmp_path / "p"), mode="thread",
                       mesh_specs=(None, "1x2", "2"), device="cpu",
                       mesh_devices=["cpu"] * 4, heartbeat_interval_s=0.05)
    try:
        meshes = [r.server.engine.mesh for r in pool.routable()
                  if r.mesh_spec is not None]
        assert [m.size for m in meshes] == [2, 2]
        assert all(m.distinct_devices() == [pdist.torch.device("cpu")]
                   for m in meshes)
        with pytest.raises(SpawnFailed, match="remain"):
            pool.spawn(mesh_spec="2")
    finally:
        pool.close()


def test_router_places_atlas_on_real_mesh_replica(tmp_path):
    """A router over ``ReplicaPool(mesh_specs=(None, "1x2"))`` on the CPU:
    the atlas-sized request lands on the mesh replica, priced with the
    grid collectives' bytes an iteration, and its result is byte-equal
    to ``sweep()`` on that replica's mesh; a small one stays plain."""
    from nmfx_torch.obs import costmodel
    from nmfx_torch.replica import ReplicaPool
    from nmfx_torch.router import NMFXRouter, RouterConfig

    small = two_group_matrix(30, 4, seed=1).astype(np.float32)
    atlas = two_group_matrix(120, 10, seed=2).astype(np.float32)
    pool = ReplicaPool(2, root=str(tmp_path / "p"), mode="thread",
                       mesh_specs=(None, "1x2"), device="cpu",
                       heartbeat_interval_s=0.05)
    scfg = SolverConfig(max_iter=60)
    mesh = [r for r in pool.routable() if r.n_devices == 2][0]
    with NMFXRouter(pool, RouterConfig(
            atlas_floor_bytes=atlas.nbytes)) as router:
        fa = router.submit(atlas, ks=(2,), restarts=4, seed=3,
                           solver_cfg=scfg)
        fs = router.submit(small, ks=(2,), restarts=4, seed=3,
                           solver_cfg=scfg)
        ra, _ = fa.result(timeout=T), fs.result(timeout=T)
        assert fa.stats.replica == mesh.replica_id
        assert fa.stats.placement_class == 2
        assert fs.stats.placement_class == 1
        want = costmodel.comm_model("mu", *atlas.shape, 2,
                                    feature_shards=2, restarts=4)
        assert (fa.stats.placement_inputs["comm_bytes_per_iter"]
                == want["wire_bytes_per_iter"] > 0)
    ref = sweep(atlas, ConsensusConfig(ks=(2,), restarts=4, seed=3), scfg,
                mesh=mesh.server.engine.mesh)
    assert (np.asarray(ra.per_k[2].consensus, np.float32).tobytes()
            == ref[2].consensus.numpy().tobytes())
    pool.close()


def test_replica_mesh_spec_grid_on_cli(tmp_path, capsys):
    """``--serve-smoke --replicas 2 --replica-mesh -,1x2`` runs with
    ``--device cpu`` and prints the same best k as the plain run."""
    import re

    import nmfx_torch.cli as pcli
    from nmfx_torch.io import write_gct

    a = two_group_matrix(40, 6, seed=1)
    path = str(tmp_path / "d.gct")
    write_gct(a, path, row_names=[f"g{i}" for i in range(40)],
              col_names=[f"s{i}" for i in range(12)])
    run = [path, "--ks", "2-3", "--restarts", "4", "--maxiter", "100",
           "--no-files", "--device", "cpu"]
    assert pcli.main(run) == 0
    plain = capsys.readouterr().out
    assert pcli.main(run + ["--serve-smoke", "--replicas", "2",
                            "--replica-mesh=-,1x2"]) == 0
    served = capsys.readouterr().out

    def best(out):
        return int(re.search(r"best k = (\d+)", out).group(1))

    assert best(served) == best(plain)


@pytest.mark.parametrize("method", ["random", "nndsvd"])
def test_meshed_bucketed_sweep_agrees_with_plain_meshed_sweep(method):
    """The bucketed sweeps on a restart mesh (nmfx's
    ``test_padded_equivalence_to_exact_sweep`` with its mesh on): a padded
    bucket's labels and iterations equal the plain sweep's on the same
    mesh, consensus to 1e-6 and dnorms to rtol 1e-5, for two true shapes
    served by one build; the NNDSVD route draws its lanes at the padded
    restart count."""
    from nmfx_torch.config import InitConfig
    from nmfx_torch.exec_cache import ExecCache
    from nmfx_torch.sweep import grid_mesh

    mesh = grid_mesh(2, devices=["cpu"] * 2)
    cache = ExecCache(device="cpu")
    ccfg = ConsensusConfig(ks=(2, 3), restarts=5, seed=4)
    scfg = SolverConfig(max_iter=150)
    icfg = InitConfig(method=method)
    for a in (two_group_matrix(40, 6, seed=1), two_group_matrix(38, 5,
                                                                seed=2)):
        a = a.astype(np.float32)
        ref = sweep(a, ccfg, scfg, icfg, mesh=mesh)
        got = cache.run_sweep(a, ccfg, scfg, icfg, mesh)
        for k in ccfg.ks:
            np.testing.assert_array_equal(got[k].labels.numpy(),
                                          ref[k].labels.numpy())
            np.testing.assert_array_equal(got[k].iterations.numpy(),
                                          ref[k].iterations.numpy())
            np.testing.assert_allclose(got[k].consensus.numpy(),
                                       ref[k].consensus.numpy(), atol=1e-6)
            np.testing.assert_allclose(got[k].dnorms.numpy(),
                                       ref[k].dnorms.numpy(), rtol=1e-5)
            assert tuple(got[k].best_w.shape) == (a.shape[0], k)
    assert cache.stats["entries"] == 1 and cache.stats["misses"] == 1
