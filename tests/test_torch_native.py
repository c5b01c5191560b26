"""The port's C++ host library (``nmfx_torch/native``) against the numpy
paths: average linkage, cophenetic matrix, leaf order and cutree byte-equal
to ``nmfx_torch.cophenetic``'s numpy functions and to ``nmfx.cophenetic``;
the GCT codec byte-equal to the Python formatter; the build keyed by the
sources and raising on a compiler error."""

import shutil
import threading

import numpy as np
import pytest

import nmfx.io as jio
from nmfx import cophenetic as jcoph
from nmfx_torch import cophenetic as tcoph
from nmfx_torch import io as tio
from nmfx_torch import native
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)


def _random_dist(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4))
    return np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1))


def _tie_heavy_dist(n, seed):
    """1 - a consensus of 4 restarts over 3 labels: distances in {0, 1/4,
    ..., 1}, so almost every merge is a tie the first-minimum rule
    breaks."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 3, (4, n))
    dist = 1.0 - (labels[:, :, None] == labels[:, None, :]).mean(0)
    np.fill_diagonal(dist, 0.0)
    return dist


def _assert_bytes_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


DISTS = [("random", n) for n in (2, 7, 40, 200)] + [("ties", 40),
                                                    ("ties", 200)]


@pytest.mark.parametrize("kind,n", DISTS)
def test_native_linkage_byte_equal_to_numpy(kind, n):
    dist = (_random_dist if kind == "random" else _tie_heavy_dist)(n, n)
    nat = tcoph.average_linkage(dist)
    for ref in (tcoph.average_linkage_numpy(dist),
                tcoph.linkage_numpy(dist, "average"),
                jcoph.linkage_numpy(dist, "average"),
                jcoph.average_linkage(dist)):
        for got, want in zip(nat, ref):
            _assert_bytes_equal(got, want)


@pytest.mark.parametrize("kind,n", DISTS)
def test_native_cut_tree_byte_equal_to_numpy(kind, n):
    dist = (_random_dist if kind == "random" else _tie_heavy_dist)(n, n + 1)
    lk = tcoph.linkage_numpy(dist).linkage
    for k in sorted({1, 2, min(3, n), n}):
        got = tcoph.cut_tree(lk, n, k)
        _assert_bytes_equal(got, tcoph.cut_tree_numpy(lk, n, k))
        _assert_bytes_equal(got, jcoph.cut_tree_numpy(lk, n, k))
        _assert_bytes_equal(got, jcoph.cut_tree(lk, n, k))


@pytest.mark.parametrize("linkage", ["average", "complete", "single"])
def test_rank_selection_dispatch_equals_numpy_composition(linkage):
    """rank_selection takes the native library for average linkage and
    numpy for the others; either way it equals the numpy functions called
    by name, and the reference's rank_selection."""
    dist = _tie_heavy_dist(30, 3)
    cons = 1.0 - dist
    rho, memb, order = tcoph.rank_selection(cons, 3, linkage)
    hc = tcoph.linkage_numpy(dist, linkage)
    assert rho == tcoph.cophenetic_rho(dist, hc.coph)
    _assert_bytes_equal(memb, tcoph.cut_tree_numpy(hc.linkage, 30, 3))
    _assert_bytes_equal(order, hc.order)
    j_rho, j_memb, j_order = jcoph.rank_selection(cons, 3, linkage)
    assert rho == j_rho
    _assert_bytes_equal(memb, j_memb)
    _assert_bytes_equal(order, j_order)


def test_native_calls_are_counted():
    native.reset_call_counts()
    hc = tcoph.average_linkage(_random_dist(9, 0))
    tcoph.cut_tree(hc.linkage, 9, 2)
    tcoph.linkage_numpy(_random_dist(9, 0), "complete")
    assert native.CALLS == {"average_linkage": 1, "cut_tree": 1,
                            "parse_gct_rows": 0, "format_gct_body": 0}
    native.reset_call_counts()
    assert set(native.CALLS.values()) == {0}


@pytest.mark.parametrize("bad", [np.zeros((1, 1)), np.zeros((3, 4)),
                                 np.zeros(3)])
def test_native_linkage_rejects_what_it_does_not_take(bad):
    with pytest.raises(ValueError, match="square"):
        native.average_linkage(bad)


def test_native_cut_tree_rejects_bad_k():
    lk = tcoph.linkage_numpy(_random_dist(5, 0)).linkage
    for k in (0, 6):
        with pytest.raises(ValueError, match="k must be in"):
            tcoph.cut_tree(lk, 5, k)
    with pytest.raises(ValueError, match="linkage must be"):
        native.cut_tree(lk[:2], 5, 2)


def test_available_loads_the_library():
    assert native.available() is True
    assert native.library_path(native._compiler()).exists()


def _matrix():
    rng = np.random.default_rng(4)
    vals = rng.uniform(0, 1, (7, 5))
    vals[0, :] = [0.0, -0.0, 1e10, 1e-7, 5e-324]
    vals[1, :] = [np.nan, np.inf, -np.inf, 1.0 / 3.0, 123456789012.0]
    vals[2, :] = [0.1, 100.0, 1e22, 1e21, -2.5e-5]
    return vals


@pytest.mark.parametrize("shape", [(7, 5), (1, 1), (3, 0)])
def test_write_gct_bytes_equal_python_formatter(tmp_path, shape):
    vals = _matrix()[:shape[0], :shape[1]]
    rows = [f"g{i}" for i in range(shape[0])]
    path = tmp_path / "x.gct"
    tio.write_gct(vals, str(path), row_names=rows)
    header = ("#1.2\n" + f"{shape[0]}\t{shape[1]}\n" + "Name\tDescription\t"
              + "\t".join(str(i + 1) for i in range(shape[1])) + "\n")
    assert path.read_bytes() == (
        header + tio.gct_body_text(vals.reshape(shape), rows, rows)).encode()


def test_write_gct_bytes_equal_reference_writer(tmp_path):
    vals = _matrix()
    tio.write_gct(vals, str(tmp_path / "t.gct"))
    jio.write_gct(vals, str(tmp_path / "j.gct"))
    assert (tmp_path / "t.gct").read_bytes() == \
        (tmp_path / "j.gct").read_bytes()


@pytest.mark.parametrize("chunk_rows", [1, 3, 2048])
def test_read_gct_round_trips(tmp_path, chunk_rows):
    vals = np.nan_to_num(_matrix(), nan=0.5, posinf=2.0, neginf=-2.0)
    rows = [f"g{i}" for i in range(7)]
    cols = list("ABCDE")
    path = str(tmp_path / "x.gct")
    native.reset_call_counts()
    tio.write_gct(vals, path, row_names=rows, col_names=cols)
    ds = tio.read_gct(path, chunk_rows=chunk_rows)
    _assert_bytes_equal(ds.values, vals)
    assert ds.row_names == rows and ds.col_names == cols
    assert native.CALLS["format_gct_body"] == 1
    assert native.CALLS["parse_gct_rows"] == -(-7 // chunk_rows)


def test_read_gct_names_a_malformed_row(tmp_path):
    path = tmp_path / "bad.gct"
    path.write_text("#1.2\n2\t2\nName\tDescription\tA\tB\n"
                    "g1\tg1\t1.0\t2.0\ng2\tg2\t3.0\tx\n")
    with pytest.raises(ValueError, match="malformed GCT data row 2"):
        tio.read_gct(str(path))


def _scratch_sources(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    for name in native.SOURCES:
        shutil.copy(native.SRC_DIR / name, src / name)
    monkeypatch.setattr(native, "SRC_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    return src


def test_build_is_keyed_by_the_sources(tmp_path, monkeypatch):
    src = _scratch_sources(tmp_path, monkeypatch)
    first = native.build()
    assert first.exists() and first.parent == tmp_path / "build"
    assert native.build() == first  # up to date: no rebuild
    with open(src / "hclust.cpp", "a") as fh:
        fh.write("// edited\n")
    second = native.build()
    assert second != first and second.exists()


def test_concurrent_builds_leave_one_complete_library(tmp_path,
                                                      monkeypatch):
    _scratch_sources(tmp_path, monkeypatch)
    paths, errors = [], []

    def work():
        try:
            paths.append(native.build())
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=work) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(set(paths)) == 1
    built = list((tmp_path / "build").iterdir())
    assert built == [paths[0]]  # no temporary file left behind
    import ctypes

    assert hasattr(ctypes.CDLL(str(paths[0])), "nmfx_average_linkage")


def test_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    src = _scratch_sources(tmp_path, monkeypatch)
    (src / "gct_io.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="(?s)building the host library "
                                           "failed.*gct_io.cpp"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))
