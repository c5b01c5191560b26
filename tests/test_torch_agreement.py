"""``nmfx_torch.agreement`` returns exactly the numbers ``nmfx.agreement``
returns: on random and degenerate labelings, on the error cases, and on
the port's and the reference's results of the same sweep."""

import dataclasses
import types

import numpy as np
import pytest

import nmfx
import nmfx.agreement as jagree
import nmfx_torch
import nmfx_torch.agreement as tagree
from nmfx.datasets import two_group_matrix
from nmfx_torch.convert import solver_config_from_dict
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)

LABELINGS = {
    "random": lambda rng: (rng.integers(0, 4, 30), rng.integers(0, 3, 30)),
    "relabeled": lambda rng: (np.repeat([1, 2, 3], 5),
                              np.repeat([9, 4, 7], 5)),
    "one cluster": lambda rng: (np.ones(12), np.ones(12)),
    "singletons": lambda rng: (np.arange(8), np.arange(8)[::-1]),
    "trivial vs not": lambda rng: (np.ones(10), np.repeat([1, 2], 5)),
    "one sample": lambda rng: ([3], [5]),
    "2-d input": lambda rng: (rng.integers(0, 2, (3, 4)),
                              rng.integers(0, 2, (3, 4))),
}


@pytest.mark.parametrize("case", sorted(LABELINGS))
@pytest.mark.parametrize("fn", ["membership_agreement",
                                "adjusted_rand_index"])
def test_label_measures_equal_reference(case, fn):
    a, b = LABELINGS[case](np.random.default_rng(3))
    got = getattr(tagree, fn)(a, b)
    want = getattr(jagree, fn)(a, b)
    assert type(got) is type(want) and got == want


@pytest.mark.parametrize("fn", ["membership_agreement",
                                "adjusted_rand_index"])
@pytest.mark.parametrize("a,b,match", [([1, 2], [1], "equal length"),
                                       ([], [], "non-empty")])
def test_label_measures_raise_like_reference(fn, a, b, match):
    for mod in (tagree, jagree):
        with pytest.raises(ValueError, match=match):
            getattr(mod, fn)(a, b)


def _result(ks, rng):
    return types.SimpleNamespace(ks=ks, per_k={
        k: types.SimpleNamespace(membership=rng.integers(1, k + 1, 25),
                                 rho=float(rng.uniform(0.5, 1.0)))
        for k in ks})


@pytest.mark.parametrize("ks", [None, (3,), (2, 4)])
def test_result_measures_equal_reference(ks):
    a = _result((2, 3, 4), np.random.default_rng(1))
    b = _result((2, 3, 4, 5), np.random.default_rng(2))
    assert tagree.cophenetic_gap(a, b, ks) == jagree.cophenetic_gap(a, b, ks)
    assert tagree.consensus_agreement(a, b, ks) == \
        jagree.consensus_agreement(a, b, ks)


@pytest.mark.parametrize("ks,match", [((6,), "not present"),
                                      (None, "share no ranks")])
def test_result_measures_raise_like_reference(ks, match):
    a = _result((2, 3), np.random.default_rng(1))
    b = _result((6,) if ks is None else (2, 3), np.random.default_rng(2))
    for mod in (tagree, jagree):
        with pytest.raises(ValueError, match=match):
            mod.consensus_agreement(a, b, ks)


def test_port_and_reference_sweeps_agree():
    """The full-sweep parity tier: the port's default sweep (streamed
    harvest, native rank selection) against the reference's per-rank
    Pallas route on the same seed; both agreement modules report the same
    perfect agreement."""
    a = two_group_matrix(200, 12, seed=3)
    jcfg = nmfx.SolverConfig(backend="pallas", max_iter=300, stable_checks=30)
    kw = dict(ks=(2, 3), restarts=4, seed=11, grid_exec="per_k")
    want = nmfx.nmfconsensus(a, solver_cfg=jcfg, use_mesh=False, **kw)
    got = nmfx_torch.nmfconsensus(
        a, solver_cfg=solver_config_from_dict(dataclasses.asdict(jcfg)),
        device="cpu", **kw)
    report = tagree.consensus_agreement(got, want)
    assert report == jagree.consensus_agreement(got, want)
    assert report["min_ari"] == 1.0 and report["max_rho_gap"] == 0.0
