"""The port's top-level surface against the reference's (ROADMAP §3 F3-F5)
on the CPU: ``nmfx_torch.__all__`` holds ``nmfx.__all__`` less the names
of unported engines (the mesh builders, item 10c); ``nmfconsensus`` takes
the reference's ``mesh`` and ``use_mesh`` keywords, refusing a mesh by its
ROADMAP item; ``save_results`` and the command line write the
reference's plot files (``nmfx/plots.py``) under its names, and none with
``write_plots=False`` / ``--no-plots``."""

import os

import numpy as np
import pytest

import nmfx
import nmfx.cli as ncli
import nmfx_torch
import nmfx_torch.cli as pcli
from nmfx.api import save_results as nsave_results
from nmfx.datasets import two_group_matrix
from nmfx_torch.io import write_gct
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)

#: the reference's names the port leaves to a later ROADMAP item (none:
#: the mesh builders came with item 10c's restart axis)
UNPORTED: set = set()
RUN = dict(ks=(2, 3), restarts=4, seed=5, max_iter=200)


def test_top_level_names_cover_the_reference():
    assert set(nmfx.__all__) - UNPORTED <= set(nmfx_torch.__all__)
    for name in nmfx_torch.__all__:
        assert hasattr(nmfx_torch, name), name
    assert nmfx_torch.read_gct.__module__ == "nmfx_torch.io"
    assert nmfx_torch.consensus_agreement.__module__ == "nmfx_torch.agreement"


def test_nmfconsensus_use_mesh_false_matches_the_reference():
    """The bundled 1000 x 40 design (run_example's) through both packages
    with ``use_mesh=False``: the same best k and memberships."""
    a = two_group_matrix(n_genes=1000, n_per_group=20, seed=123)
    kw = dict(ks=(2, 3), restarts=4, seed=123, use_mesh=False)
    got = nmfx_torch.nmfconsensus(a, device="cpu", **kw)
    want = nmfx.nmfconsensus(a, **kw)
    assert got.best_k == want.best_k == 2
    for k in (2, 3):
        np.testing.assert_array_equal(got.per_k[k].membership,
                                      np.asarray(want.per_k[k].membership))


@pytest.mark.parametrize("shape", [(1, 2, 1), (1, 1, 2)],
                         ids=["object", "name"])
def test_nmfconsensus_refuses_a_mesh_naming_item_10c(shape):
    """A mesh with a feature or sample axis runs, as the reference's does
    (the name and ids are kept from when every mesh was refused): the
    same memberships and best k as nmfx on the same mesh shape."""
    a = two_group_matrix(40, 6, seed=1)
    mesh = nmfx_torch.grid_mesh(*shape, devices=["cpu"] * 2)
    got = nmfx_torch.nmfconsensus(a, ks=(2,), restarts=2, mesh=mesh,
                                  device="cpu")
    want = nmfx.nmfconsensus(a, ks=(2,), restarts=2,
                             mesh=nmfx.sweep.grid_mesh(*shape))
    assert got.best_k == want.best_k
    np.testing.assert_array_equal(got.per_k[2].membership,
                                  np.asarray(want.per_k[2].membership))


@pytest.mark.parametrize("mesh", [object(), "restarts"],
                         ids=["object", "name"])
def test_nmfconsensus_refuses_a_mesh_that_is_not_one(mesh):
    a = two_group_matrix(40, 6, seed=1)
    with pytest.raises(TypeError, match="grid_mesh"):
        nmfx_torch.nmfconsensus(a, ks=(2,), restarts=2, mesh=mesh,
                                device="cpu")


@pytest.fixture(scope="module")
def results():
    a = two_group_matrix(60, 10, seed=1)
    return (nmfx_torch.nmfconsensus(a, device="cpu", **RUN),
            nmfx.nmfconsensus(a, **RUN))


@pytest.mark.parametrize("write_plots", [True, False])
def test_save_results_writes_the_references_files(results, tmp_path,
                                                  write_plots):
    pytest.importorskip("matplotlib")
    got, want = results
    pdir, ndir = tmp_path / "p", tmp_path / "n"
    for pkg, save, res, d in ((nmfx_torch, nmfx_torch.save_results, got,
                               pdir),
                              (nmfx, nsave_results, want, ndir)):
        written = save(res, pkg.OutputConfig(
            directory=str(d), doc_string="run", write_plots=write_plots))
        assert sorted(os.path.basename(p) for p in written) == sorted(
            os.listdir(d))
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(ndir))
    pdfs = [p for p in os.listdir(pdir) if p.endswith(".pdf")]
    # a heatmap and a metagene plot per k, the all-k grid, the curve
    assert len(pdfs) == (2 * len(RUN["ks"]) + 2 if write_plots else 0)


def test_output_config_takes_write_plots():
    assert nmfx_torch.OutputConfig().write_plots is True
    assert nmfx_torch.OutputConfig(write_plots=False).write_plots is False


@pytest.fixture(scope="module")
def gct(tmp_path_factory):
    a = two_group_matrix(60, 10, seed=1)
    path = tmp_path_factory.mktemp("surface") / "demo.gct"
    write_gct(a, str(path), row_names=[f"g{i}" for i in range(60)],
              col_names=[f"s{i}" for i in range(20)])
    return str(path)


@pytest.mark.parametrize("plots", [True, False], ids=["plots", "no-plots"])
def test_cli_plot_files_match_the_reference(gct, tmp_path, capsys, plots):
    """``main`` writes the reference CLI's files, PDFs included; with
    ``--no-plots`` no PDF."""
    pytest.importorskip("matplotlib")
    argv = [gct, "--ks", "2-3", "--restarts", "4", "--maxiter", "200"]
    argv += [] if plots else ["--no-plots"]
    assert ncli.main(argv + ["--outdir", str(tmp_path / "n")]) == 0
    assert pcli.main(argv + ["--outdir", str(tmp_path / "p"), "--device",
                             "cpu"]) == 0
    capsys.readouterr()
    got = sorted(os.listdir(tmp_path / "p"))
    assert got == sorted(os.listdir(tmp_path / "n"))
    assert any(p.endswith(".pdf") for p in got) is plots
