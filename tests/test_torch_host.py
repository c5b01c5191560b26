"""The port's host-side modules against the reference: GCT/RES I/O in
both directions, the synthetic dataset and cophenetic rank selection."""

import numpy as np
import pytest

import nmfx.io as jio
from nmfx import cophenetic as jcoph
from nmfx.datasets import two_group_matrix as j_two_group
from nmfx_torch import cophenetic as tcoph
from nmfx_torch import io as tio
from nmfx_torch.datasets import two_group_matrix


def _matrix():
    rng = np.random.default_rng(4)
    vals = rng.uniform(0, 1, (6, 4))
    vals[0, 0], vals[1, 1], vals[2, 2] = 0.0, 1e10, 1e-7
    return vals


@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_gct_round_trip_across_packages(tmp_path, direction):
    vals = _matrix()
    rows = [f"g{i}" for i in range(6)]
    cols = ["A", "B", "C", "D"]
    path = str(tmp_path / "x.gct")
    write, read = ((tio.write_gct, jio.read_gct)
                   if direction == "torch_to_jax"
                   else (jio.write_gct, tio.read_gct))
    write(vals, path, row_names=rows, col_names=cols)
    ds = read(path)
    np.testing.assert_array_equal(ds.values, vals)
    assert list(ds.row_names) == rows and list(ds.col_names) == cols


def test_gct_bytes_match_reference_numpy_writer(tmp_path, monkeypatch):
    from nmfx import native

    monkeypatch.setattr(native, "available", lambda: False)
    vals = _matrix()
    tio.write_gct(vals, str(tmp_path / "t.gct"))
    jio.write_gct(vals, str(tmp_path / "j.gct"))
    assert (tmp_path / "t.gct").read_bytes() == (tmp_path / "j.gct").read_bytes()


def test_res_and_dataset_readers_match_reference(tmp_path):
    lines = ["Description\tAccession\tS1\t\tS2\t",
             "\t\tdesc1\t\tdesc2\t",
             "2",
             "d1\tacc1\t1.5\tP\t2.0\tA",
             "d2\tacc2\t0.25\tP\t3.0\tP"]
    path = tmp_path / "x.res"
    path.write_text("\n".join(lines) + "\n")
    want, got = jio.read_res(str(path)), tio.read_res(str(path))
    np.testing.assert_array_equal(got.values, want.values)
    assert got.row_names == want.row_names and got.col_names == want.col_names
    got2 = tio.read_dataset(str(path))
    np.testing.assert_array_equal(got2.values, want.values)
    with pytest.raises(NotImplementedError):
        tio.read_dataset(str(tmp_path / "x.mtx"))


@pytest.mark.parametrize("args", [(200, 12, 3), (1000, 20, 123)])
def test_two_group_matrix_is_a_copy(args):
    n_genes, n_per_group, seed = args
    np.testing.assert_array_equal(two_group_matrix(n_genes, n_per_group,
                                                   seed=seed),
                                  j_two_group(n_genes, n_per_group,
                                              seed=seed))


@pytest.mark.parametrize("linkage", ["average", "complete", "single"])
@pytest.mark.parametrize("k", [2, 3])
def test_rank_selection_matches_reference_numpy_path(monkeypatch, linkage, k):
    from nmfx import native

    monkeypatch.setenv("NMFX_NATIVE", "0")
    monkeypatch.setattr(native, "available", lambda: False)
    rng = np.random.default_rng(k)
    labels = rng.integers(0, k, (6, 15))
    cons = (labels[:, :, None] == labels[:, None, :]).mean(axis=0)
    want = jcoph.rank_selection(cons, k, linkage)
    got = tcoph.rank_selection(cons, k, linkage)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
