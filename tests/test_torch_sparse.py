"""Sparse ingestion in the port (``nmfx_torch/sparse.py``, the ``.mtx`` /
``.csr.npz`` readers of ``nmfx_torch/io.py``, ``make_sparse_design``
and the sparse keys of the caches and the cost model) against ``nmfx``
on the CPU.

* ``nmfx``'s ``tests/test_sparse.py``, ported: the CSR container's
  canonical form and validation, content addressing, tile slicing, the
  generator, the cache keys, sparse == densified at the agreement tier,
  the nnz counters, the legacy registry's refusal and the tiled cost
  terms (its two coverage tests on the port's own coverage check, not on
  ``nmfx/analysis``).
* Byte-equal to ``nmfx``: construction, ``row_block``, ``tile_coo``,
  ``block_sq_norms`` and the fingerprint; ``make_sparse_design``; the
  readers and the writer, each package reading the other's files; the
  tiled cost terms at several densities.
* A sparse sweep against ``nmfx``'s at the agreement tier, with the same
  best k.
"""

import numpy as np
import pytest

import nmfx
import nmfx.datasets as ndatasets
import nmfx.io as nio
import nmfx.sparse as nsparse
import nmfx_torch
from nmfx.obs import costmodel as ncm
from nmfx_torch import sparse as sparse_mod
from nmfx_torch.config import SolverConfig
from nmfx_torch.datasets import make_sparse_design
from nmfx_torch.obs import costmodel as cm
from nmfx_torch.sparse import SparseMatrix
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)

KW = dict(ks=(2, 3), restarts=4, seed=5)
#: the reference's gate of a sparse sweep against its densified twin
#: (tests/test_sparse.py), also the port's against nmfx's
MIN_ARI, MAX_RHO_GAP = 0.9, 0.1


@pytest.fixture()
def planted():
    return make_sparse_design(120, 40, k=3, density=0.3, seed=3)


def _both(sp: SparseMatrix) -> nsparse.SparseMatrix:
    return nsparse.SparseMatrix(indptr=sp.indptr, indices=sp.indices,
                                data=sp.data, shape=sp.shape)


def _same_csr(x, y) -> bool:
    return (x.shape == y.shape and all(
        np.asarray(getattr(x, f)).dtype == np.asarray(getattr(y, f)).dtype
        and np.asarray(getattr(x, f)).tobytes()
        == np.asarray(getattr(y, f)).tobytes()
        for f in ("indptr", "indices", "data")))


# ---------------------------------------------------------------------
# canonical form (nmfx's tests)
# ---------------------------------------------------------------------

def test_from_dense_roundtrip_exact():
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(30, 11))
    a[rng.random(a.shape) < 0.7] = 0.0
    sp = SparseMatrix.from_dense(a)
    np.testing.assert_array_equal(sp.toarray(), a)
    assert sp.nnz == np.count_nonzero(a)
    assert sp.density == pytest.approx(np.count_nonzero(a) / a.size)


def test_from_coo_sums_duplicates_and_drops_zeros():
    sp = SparseMatrix.from_coo(rows=[2, 0, 2, 1, 1],
                               cols=[1, 0, 1, 2, 2],
                               vals=[1.5, 3.0, 0.5, 2.0, -2.0],
                               shape=(3, 4))
    dense = np.zeros((3, 4))
    dense[0, 0] = 3.0
    dense[2, 1] = 2.0  # 1.5 + 0.5 summed; (1, 2) cancelled to zero
    np.testing.assert_array_equal(sp.toarray(), dense)
    assert sp.nnz == 2


def test_two_representations_fingerprint_identically():
    rng = np.random.default_rng(1)
    a = rng.uniform(size=(20, 9))
    a[rng.random(a.shape) < 0.6] = 0.0
    via_dense = SparseMatrix.from_dense(a)
    r, c = np.nonzero(a)
    perm = np.random.default_rng(2).permutation(len(r))
    via_coo = SparseMatrix.from_coo(r[perm], c[perm], a[r, c][perm],
                                    a.shape)
    assert via_dense.fingerprint() == via_coo.fingerprint()


def test_fingerprint_tracks_content_not_identity(planted):
    fp = planted.fingerprint()
    assert fp == planted.fingerprint()  # stable
    mutated = SparseMatrix(indptr=planted.indptr,
                           indices=planted.indices,
                           data=planted.data * 1.0000001,
                           shape=planted.shape)
    assert mutated.fingerprint() != fp


def test_validation_rejects_malformed():
    with pytest.raises(ValueError, match="indptr"):
        SparseMatrix(indptr=np.array([0, 1]), indices=np.array([0]),
                     data=np.array([1.0]), shape=(2, 2))
    with pytest.raises(ValueError, match="out of range"):
        SparseMatrix(indptr=np.array([0, 1, 1]), indices=np.array([5]),
                     data=np.array([1.0]), shape=(2, 2))
    with pytest.raises(ValueError, match="out of range"):
        SparseMatrix.from_coo([0], [9], [1.0], shape=(2, 2))


# ---------------------------------------------------------------------
# tiling queries (nmfx's tests)
# ---------------------------------------------------------------------

def test_row_block_matches_dense_slice(planted):
    dense = planted.toarray()
    block = planted.row_block(40, 100)
    assert block.shape == (60, planted.shape[1])
    np.testing.assert_array_equal(block.toarray(), dense[40:100])


def test_tile_coo_is_row_local_and_cast(planted):
    dense = planted.toarray()
    idx, data = planted.tile_coo(30, 90, np.float32)
    assert idx.dtype == np.int32 and data.dtype == np.float32
    rebuilt = np.zeros((60, planted.shape[1]), np.float32)
    rebuilt[idx[:, 0], idx[:, 1]] = data
    np.testing.assert_array_equal(rebuilt,
                                  dense[30:90].astype(np.float32))


def test_block_sq_norms_match_dense(planted):
    dense = planted.toarray()
    bounds = ((0, 50), (50, 120))
    got = planted.block_sq_norms(bounds)
    want = [float((dense[r0:r1].astype(np.float64) ** 2).sum())
            for r0, r1 in bounds]
    np.testing.assert_allclose(got, want, rtol=1e-12)


# ---------------------------------------------------------------------
# the container and the generator byte-equal to nmfx's
# ---------------------------------------------------------------------

def test_construction_and_queries_byte_equal_reference():
    rng = np.random.default_rng(4)
    a = rng.uniform(size=(37, 13))
    a[rng.random(a.shape) < 0.75] = 0.0
    r, c = np.nonzero(a)
    perm = rng.permutation(len(r))
    dup = np.concatenate([perm, perm[:5]])  # repeats sum
    for got, want in (
            (SparseMatrix.from_dense(a), nsparse.SparseMatrix.from_dense(a)),
            (SparseMatrix.from_coo(r[dup], c[dup], a[r, c][dup], a.shape),
             nsparse.SparseMatrix.from_coo(r[dup], c[dup], a[r, c][dup],
                                           a.shape))):
        assert _same_csr(got, want)
        assert got.fingerprint() == want.fingerprint()
        assert (got.nnz, got.density, got.nbytes) == (
            want.nnz, want.density, want.nbytes)
        assert got.toarray().tobytes() == want.toarray().tobytes()
        assert _same_csr(got.row_block(5, 30), want.row_block(5, 30))
        for dt in (np.float32, np.float64):
            gi, gd = got.tile_coo(3, 29, dt)
            wi, wd = want.tile_coo(3, 29, dt)
            assert gi.tobytes() == wi.tobytes() and gd.tobytes() == wd.tobytes()
        bounds = ((0, 10), (10, 20), (20, 37))
        assert (got.block_sq_norms(bounds).tobytes()
                == want.block_sq_norms(bounds).tobytes())


@pytest.mark.parametrize("m,n,k,density,seed", [
    (200, 50, 4, 0.08, 0), (120, 40, 3, 0.3, 3), (61, 17, 2, 0.0, 1),
    (30, 30, 5, 1.0, 9)])
def test_make_sparse_design_byte_equal_reference(m, n, k, density, seed):
    got = make_sparse_design(m, n, k=k, density=density, seed=seed)
    want = ndatasets.make_sparse_design(m, n, k=k, density=density,
                                        seed=seed)
    assert _same_csr(got, want)
    assert got.fingerprint() == want.fingerprint()


def test_make_sparse_design_properties():
    sp = make_sparse_design(200, 50, k=4, density=0.08, seed=0)
    assert isinstance(sp, SparseMatrix)
    assert sp.shape == (200, 50)
    assert sp.density == pytest.approx(0.08, rel=0.2)
    assert np.all(sp.data > 0)  # non-negative with zeros dropped
    again = make_sparse_design(200, 50, k=4, density=0.08, seed=0)
    assert again.fingerprint() == sp.fingerprint()
    with pytest.raises(ValueError, match="density"):
        make_sparse_design(10, 10, k=2, density=1.5)


# ---------------------------------------------------------------------
# files: each package reads the other's
# ---------------------------------------------------------------------

def _write_mtx(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def test_csr_npz_round_trip_across_packages(planted, tmp_path):
    p_port, p_ref = str(tmp_path / "p.csr.npz"), str(tmp_path / "n.csr.npz")
    nmfx_torch.io.write_csr_npz(planted, p_port)
    nio.write_csr_npz(_both(planted), p_ref)
    with open(p_port, "rb") as f1, open(p_ref, "rb") as f2:
        assert f1.read() == f2.read()
    for path in (p_port, p_ref):
        got, want = nmfx_torch.io.read_csr_npz(path), nio.read_csr_npz(path)
        assert _same_csr(got, want) and _same_csr(got, planted)
        assert _same_csr(nmfx_torch.io.read_dataset(path), want)
    bad = str(tmp_path / "bad.csr.npz")
    np.savez(bad, indptr=np.array([0, 1]))
    with pytest.raises(ValueError, match="not a valid CSR bundle"):
        nmfx_torch.io.read_csr_npz(bad)


@pytest.mark.parametrize("field, body, shape", [
    ("real", "3 4 5\n1 1 1.5\n3 2 0.25\n2 3 7e-3\n3 2 0.75\n1 4 -1.5\n",
     (3, 4)),
    ("integer", "% a comment\n\n2 3 3\n1 1 4\n2 3 9\n1 2 0\n", (2, 3)),
    ("pattern", "4 2 3\n4 1\n1 2\n2 2\n", (4, 2)),
])
def test_read_mtx_byte_equal_reference(tmp_path, field, body, shape):
    path = _write_mtx(tmp_path / "x.mtx",
                      f"%%MatrixMarket matrix coordinate {field} general\n"
                      + body)
    got, want = nmfx_torch.io.read_mtx(path), nio.read_mtx(path)
    assert got.shape == shape and _same_csr(got, want)
    assert got.fingerprint() == want.fingerprint()
    assert _same_csr(nmfx_torch.io.read_dataset(path), want)


def test_mtx_of_a_design_reads_to_its_fingerprint(tmp_path):
    sp = make_sparse_design(40, 12, k=2, density=0.3, seed=2)
    rows = np.repeat(np.arange(40), np.diff(sp.indptr)) + 1
    body = "".join(f"{r} {c} {v!r}\n" for r, c, v in zip(
        rows.tolist(), (sp.indices + 1).tolist(), sp.data.tolist()))
    path = _write_mtx(tmp_path / "d.mtx",
                      "%%MatrixMarket matrix coordinate real general\n"
                      f"40 12 {sp.nnz}\n" + body)
    assert nmfx_torch.io.read_mtx(path).fingerprint() == sp.fingerprint()


@pytest.mark.parametrize("text, match", [
    ("%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n",
     "coordinate"),
    ("%%MatrixMarket matrix coordinate complex general\n1 1 1\n1 1 1 0\n",
     "unsupported"),
    ("%%MatrixMarket matrix coordinate real symmetric\n1 1 1\n1 1 1\n",
     "general"),
    ("%%MatrixMarket matrix coordinate real general\n2 2 2\n1 1 1\n",
     "entries"),
])
def test_read_mtx_refusals_match_reference(tmp_path, text, match):
    path = _write_mtx(tmp_path / "bad.mtx", text)
    with pytest.raises(ValueError, match=match) as got:
        nmfx_torch.io.read_mtx(path)
    with pytest.raises(ValueError) as want:
        nio.read_mtx(path)
    assert str(got.value) == str(want.value)


def test_read_mtx_banner_only_is_a_malformed_size_line(tmp_path):
    """A file that ends after its banner: the reference's blank-line
    loop does not stop at the end of the file; the port's does."""
    path = _write_mtx(tmp_path / "empty.mtx",
                      "%%MatrixMarket matrix coordinate real general\n")
    with pytest.raises(ValueError, match="malformed MatrixMarket size"):
        nmfx_torch.io.read_mtx(path)


# ---------------------------------------------------------------------
# content addressing through the cache layers (nmfx's tests)
# ---------------------------------------------------------------------

def test_data_key_hashes_triplets_never_densifies(planted):
    from nmfx_torch.data_cache import DataCache

    cache = DataCache()
    key = cache.key_for(planted, np.float32)
    assert key.fingerprint == planted.fingerprint()
    assert key.src_dtype == planted.data.dtype.str
    mutated = SparseMatrix(indptr=planted.indptr,
                           indices=planted.indices,
                           data=planted.data + 1.0,
                           shape=planted.shape)
    assert cache.key_for(mutated, np.float32).fingerprint \
        != key.fingerprint


def test_result_cache_key_covers_sparse_content(planted):
    from nmfx_torch.config import ConsensusConfig, InitConfig
    from nmfx_torch.result_cache import key_for_array

    ccfg = ConsensusConfig(ks=(2,), restarts=2, seed=1)
    scfg = SolverConfig(algorithm="mu", max_iter=10)
    icfg = InitConfig()
    k1 = key_for_array(planted, scfg, ccfg, icfg)
    assert k1 == key_for_array(planted, scfg, ccfg, icfg)
    mutated = SparseMatrix(indptr=planted.indptr,
                           indices=planted.indices,
                           data=planted.data + 1.0,
                           shape=planted.shape)
    assert key_for_array(mutated, scfg, ccfg, icfg) != k1
    # never the densified array's key
    assert key_for_array(planted.toarray(), scfg, ccfg, icfg) != k1


# ---------------------------------------------------------------------
# the agreement contract: sparse == densified, and against nmfx
# ---------------------------------------------------------------------

def test_sparse_agrees_with_densified_consensus():
    from nmfx_torch.agreement import consensus_agreement

    sp = make_sparse_design(150, 36, k=3, density=0.25, seed=9)
    scfg = SolverConfig(algorithm="mu", max_iter=200)
    res_sp = nmfx_torch.nmfconsensus(sp, solver_cfg=scfg, device="cpu",
                                     **KW)
    res_dn = nmfx_torch.nmfconsensus(sp.toarray(), solver_cfg=scfg,
                                     device="cpu", **KW)
    rep = consensus_agreement(res_sp, res_dn)
    assert rep["min_ari"] >= MIN_ARI
    assert rep["max_rho_gap"] <= MAX_RHO_GAP


@pytest.mark.parametrize("algorithm, tile_rows", [
    ("mu", None), ("mu", 40), ("hals", 50)])
def test_sparse_sweep_agrees_with_reference(algorithm, tile_rows):
    """The port's sparse sweep against nmfx's on the same matrix (nmfx's
    BCOO products against the port's CSR ones): the agreement tier and
    the same best k."""
    from nmfx_torch.agreement import consensus_agreement

    sp = make_sparse_design(150, 36, k=3, density=0.25, seed=9)
    got = nmfx_torch.nmfconsensus(
        sp, solver_cfg=SolverConfig(algorithm=algorithm, max_iter=200,
                                    tile_rows=tile_rows),
        device="cpu", **KW)
    want = nmfx.nmfconsensus(
        _both(sp), solver_cfg=nmfx.SolverConfig(
            algorithm=algorithm, max_iter=200, tile_rows=tile_rows),
        use_mesh=False, **KW)
    rep = consensus_agreement(got, want)
    assert rep["min_ari"] >= MIN_ARI and rep["max_rho_gap"] <= MAX_RHO_GAP
    assert got.best_k == want.best_k


def test_sparse_path_input_stays_sparse(tmp_path):
    """A .csr.npz path runs the streamed engine, byte-equal to the
    SparseMatrix it holds."""
    sp = make_sparse_design(80, 24, k=2, density=0.2, seed=4)
    path = str(tmp_path / "a.csr.npz")
    nmfx_torch.io.write_csr_npz(sp, path)
    scfg = SolverConfig(max_iter=30, tile_rows=20)
    got = nmfx_torch.nmfconsensus(path, solver_cfg=scfg, device="cpu", **KW)
    want = nmfx_torch.nmfconsensus(sp, solver_cfg=scfg, device="cpu", **KW)
    for k in KW["ks"]:
        assert got.per_k[k].consensus.tobytes() == \
            want.per_k[k].consensus.tobytes()
        assert got.per_k[k].best_w.tobytes() == want.per_k[k].best_w.tobytes()


def test_sparse_input_validates_stored_values():
    sp = make_sparse_design(40, 12, k=2, density=0.3, seed=2)
    for bad, match in ((-1.0, "non-negative"), (np.nan, "non-finite")):
        data = sp.data.copy()
        data[0] = bad
        with pytest.raises(ValueError, match=match):
            nmfx_torch.nmfconsensus(
                SparseMatrix(sp.indptr, sp.indices, data, sp.shape),
                ks=(2,), restarts=2, device="cpu")


def test_sparse_books_nnz_counters():
    sp = make_sparse_design(80, 24, k=2, density=0.2, seed=4)
    nnz0 = sparse_mod._sparse_nnz_total.total()
    bytes0 = sparse_mod._sparse_nnz_bytes_total.total()
    nmfx_torch.nmfconsensus(sp, ks=(2,), restarts=2, seed=1, device="cpu",
                            solver_cfg=SolverConfig(algorithm="mu",
                                                    max_iter=10))
    # one whole-matrix tile a pass: prologue, 10 iterations, final
    assert sparse_mod._sparse_nnz_total.total() - nnz0 == 12 * sp.nnz
    assert sparse_mod._sparse_nnz_bytes_total.total() > bytes0


def test_legacy_registry_refuses_sparse(tmp_path):
    sp = make_sparse_design(40, 12, k=2, density=0.3, seed=2)
    with pytest.raises(ValueError, match="durable chunked"):
        nmfx_torch.nmfconsensus(sp, ks=(2,), restarts=2, seed=1,
                                device="cpu",
                                checkpoint_dir=str(tmp_path))


# ---------------------------------------------------------------------
# nnz-aware cost model (nmfx's tests on the port's coverage check)
# ---------------------------------------------------------------------

def test_tiled_engines_modeled_and_universe_clean():
    from nmfx_torch.config import TILED_ALGORITHMS
    from nmfx_torch.solvers import SOLVERS

    for algo in TILED_ALGORITHMS:
        assert (algo, "tiled") in cm.engine_universe()
        assert (algo, "tiled") in cm.covered_engines()
    assert cm.check_costmodel_coverage(
        cm.engine_universe(), cm.covered_engines(), cm.COSTMODEL_EXEMPT,
        frozenset(SOLVERS)) == []


def test_coverage_check_fires_if_tiled_model_dropped():
    from nmfx_torch.solvers import SOLVERS

    problems = cm.check_costmodel_coverage(
        cm.engine_universe(), cm.covered_engines() - {("mu", "tiled")},
        cm.COSTMODEL_EXEMPT, frozenset(SOLVERS))
    assert any("tiled" in p and "no cost model" in p for p in problems)


def test_sparse_density_scales_data_terms():
    m, n, k = 400, 100, 5
    cfg = SolverConfig(algorithm="mu", tile_rows=64)
    try:
        cm.set_sparse_density(1.0)
        dense_f = cm.iteration_flops("mu", "tiled", m, n, k, cfg)
        dense_b = cm.iteration_bytes("mu", "tiled", m, n, k, cfg)
        cm.set_sparse_density(0.01)
        sp_f = cm.iteration_flops("mu", "tiled", m, n, k, cfg)
        sp_b = cm.iteration_bytes("mu", "tiled", m, n, k, cfg)
    finally:
        cm.set_sparse_density(1.0)
    # data-sized terms scale with density; k-sized terms stay dense
    assert sp_f < dense_f
    assert sp_f > 4.0 * k * k * (m + n) - 1  # floor: the Gram terms
    assert sp_b < dense_b
    with pytest.raises(ValueError, match="density"):
        cm.set_sparse_density(1.5)


def test_sparse_density_hint_validated():
    assert cm.sparse_density() == 1.0
    cm.set_sparse_density(0.25)
    assert cm.sparse_density() == 0.25
    cm.set_sparse_density(1.0)


@pytest.mark.parametrize("density", [1.0, 0.5, 0.05, 0.001, 0.0])
def test_tiled_cost_terms_equal_reference(density):
    try:
        for mod in (cm, ncm):
            mod.set_sparse_density(density)
        for algo in ("mu", "hals"):
            for dtype in ("float32", "float64"):
                pcfg = SolverConfig(algorithm=algo, tile_rows=64,
                                    dtype=dtype)
                ncfg = nmfx.SolverConfig(algorithm=algo, tile_rows=64,
                                         dtype=dtype)
                for m, n, k in ((400, 100, 5), (20000, 5000, 4),
                                (61, 17, 2)):
                    assert (cm.iteration_flops(algo, "tiled", m, n, k, pcfg)
                            == ncm.iteration_flops(algo, "tiled", m, n, k,
                                                   ncfg))
                    assert (cm.iteration_bytes(algo, "tiled", m, n, k, pcfg)
                            == ncm.iteration_bytes(algo, "tiled", m, n, k,
                                                   ncfg))
                iters = {2: [10, 20], 5: np.array([3])}
                assert (cm.dispatch_cost(pcfg, 300, 40, iters)
                        == ncm.dispatch_cost(ncfg, 300, 40, iters))
    finally:
        for mod in (cm, ncm):
            mod.set_sparse_density(1.0)


def test_sparse_sweep_stamps_density_hint():
    sp = make_sparse_design(60, 20, k=2, density=0.25, seed=1)
    try:
        nmfx_torch.nmfconsensus(sp, ks=(2,), restarts=2, device="cpu",
                                solver_cfg=SolverConfig(max_iter=4))
        assert cm.sparse_density() == sp.density
        nmfx_torch.nmfconsensus(sp.toarray(), ks=(2,), restarts=2,
                                device="cpu", solver_cfg=SolverConfig(
                                    max_iter=4, tile_rows=15))
        assert cm.sparse_density() == 1.0
    finally:
        cm.set_sparse_density(1.0)
