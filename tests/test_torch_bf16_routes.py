"""``matmul_precision="bfloat16"`` off the kernel routes.

``nmfx`` applies the setting as ``jax.default_matmul_precision``: the
TPU rounds every product's operands to bf16 and sums in float32, the CPU
ignores it. The port rounds through one helper (``solvers.base.mm``) on
CUDA only. So on the CPU every route under the setting is byte-equal to
float32, in both packages; the helper itself, called with rounding on,
is a float32 product of explicitly rounded operands; and kl's quotient
keeps the full-precision A unless ``experimental.kl_bf16_quotient`` is
set."""

import numpy as np
import pytest
import torch

import nmfx
import nmfx_torch
from nmfx_torch import sweep as psweep
from nmfx_torch.config import (ConsensusConfig, ExperimentalConfig,
                               SolverConfig)
from nmfx_torch.datasets import two_group_matrix
from nmfx_torch.ops import grid_mu, sched_mu
from nmfx_torch.solvers import base
from nmfx_torch.solvers import kl as pkl
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)

BF16 = "bfloat16"
FIELDS = ("consensus", "iterations", "dnorms", "stop_reasons", "labels",
          "best_w", "best_h")

#: route → (ConsensusConfig kwargs, SolverConfig kwargs): the batched
#: restart route for all eight algorithms, the packed whole grid, the
#: per-rank plain route, the scheduler at one rank, the sketched engine,
#: screening and the tile pipeline
ROUTES = {
    **{f"batched-{alg}": (dict(ks=(2,)), dict(algorithm=alg, backend="vmap",
                                               max_iter=40))
       for alg in ("mu", "hals", "neals", "als", "snmf", "kl", "pg",
                   "alspg")},
    "grid-mu": (dict(), dict(max_iter=120)),
    "grid-hals": (dict(), dict(algorithm="hals", max_iter=120)),
    **{f"packed-grid-{alg}": (dict(), dict(algorithm=alg, backend="packed",
                                           max_iter=40))
       for alg in ("neals", "als", "snmf", "kl")},
    "packed-per-rank-mu": (dict(grid_exec="per_k"), dict(max_iter=120)),
    "scheduler-one-rank-hals": (dict(grid_exec="per_k"),
                                dict(algorithm="hals", max_iter=120)),
    "sketched-mu": (dict(ks=(2,)), dict(backend="sketched", max_iter=60)),
    "screened-mu": (dict(ks=(2,)), dict(screen=True, screen_keep=2,
                                        max_iter=60)),
    "tiled-mu": (dict(ks=(2,)), dict(tile_rows=20, max_iter=60)),
    "tiled-hals": (dict(ks=(2,)), dict(algorithm="hals", tile_rows=20,
                                       max_iter=60)),
}


@pytest.fixture(scope="module")
def data():
    return two_group_matrix(50, 6, seed=2).astype(np.float32)


def _run(data, route, precision):
    ckw, skw = ROUTES[route]
    cfg = ConsensusConfig(**{"ks": (2, 3), "restarts": 4, "seed": 3, **ckw})
    scfg = SolverConfig(matmul_precision=precision, **skw)
    return psweep.sweep(data, cfg, scfg, device="cpu")


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_bf16_route_byte_equal_to_float32_on_cpu(data, route):
    want = _run(data, route, "default")
    got = _run(data, route, BF16)
    for k in want:
        for f in FIELDS:
            x, y = getattr(want[k], f), getattr(got[k], f)
            x = x.numpy() if torch.is_tensor(x) else np.asarray(x)
            y = y.numpy() if torch.is_tensor(y) else np.asarray(y)
            assert x.tobytes() == y.tobytes(), (route, k, f)


def test_bf16_solve_byte_equal_to_float32_on_cpu(data):
    rng = np.random.default_rng(0)
    w0 = rng.uniform(0.1, 1, (data.shape[0], 3)).astype(np.float32)
    h0 = rng.uniform(0.1, 1, (3, data.shape[1])).astype(np.float32)
    for alg in ("mu", "kl", "pg"):
        want = base.solve(data, w0, h0, SolverConfig(algorithm=alg,
                                                     max_iter=50),
                          device="cpu")
        got = base.solve(data, w0, h0, SolverConfig(
            algorithm=alg, max_iter=50, matmul_precision=BF16),
            device="cpu")
        assert torch.equal(got.w, want.w) and torch.equal(got.h, want.h)
        assert got.iterations == want.iterations


@pytest.mark.parametrize("route", [
    (dict(), dict()),
    (dict(grid_exec="per_k"), dict()),
    (dict(ks=(2,)), dict(algorithm="kl")),
    (dict(), dict(algorithm="neals", backend="packed")),
], ids=["grid-mu", "per-rank-mu", "batched-kl", "packed-grid-neals"])
def test_reference_bf16_byte_equal_to_float32_on_cpu(route):
    """nmfx at the same seed: its CPU ignores the precision hint."""
    ckw, skw = route
    a = two_group_matrix(50, 6, seed=2)
    kw = dict({"ks": (2, 3), "restarts": 4, "seed": 3, "use_mesh": False},
              **ckw)
    want = nmfx.nmfconsensus(a, solver_cfg=nmfx.SolverConfig(
        max_iter=60, **skw), **kw)
    got = nmfx.nmfconsensus(a, solver_cfg=nmfx.SolverConfig(
        max_iter=60, matmul_precision=BF16, **skw), **kw)
    for k in want.per_k:
        for f in ("consensus", "iterations", "dnorms", "best_w"):
            assert (np.asarray(getattr(got.per_k[k], f)).tobytes()
                    == np.asarray(getattr(want.per_k[k], f)).tobytes())


def test_rounding_helper_rounds_float32_operands():
    g = torch.Generator().manual_seed(0)
    x = torch.rand((7, 5), generator=g)
    y = torch.rand((5, 3), generator=g)
    want = x.to(torch.bfloat16).to(torch.float32) @ \
        y.to(torch.bfloat16).to(torch.float32)
    assert torch.equal(base.mm(x, y, True), want)
    assert not torch.equal(base.mm(x, y, True), x @ y)
    assert torch.equal(base.mm(x, y, False), x @ y)
    xb, yb = x[None].expand(2, 7, 5), y[None].expand(2, 5, 3)
    assert torch.equal(base.einsum("bij,bjk->bik", xb, yb, True),
                       torch.stack([want, want]))
    # float64 operands are left alone (the setting rounds float32 only)
    xd, yd = x.double(), y.double()
    assert torch.equal(base.mm(xd, yd, True), xd @ yd)


def test_bf16_products_only_on_cuda_float32():
    cfg = SolverConfig(matmul_precision=BF16)
    assert base.bf16_products(cfg, "cuda")
    assert base.bf16_products(cfg, torch.device("cuda", 0))
    assert not base.bf16_products(cfg, "cpu")
    assert not base.bf16_products(SolverConfig(), "cuda")
    assert not base.bf16_products(SolverConfig(matmul_precision="highest"),
                                  "cuda")
    assert not base.bf16_products(
        SolverConfig(matmul_precision=BF16, dtype="float64"), "cuda")


def _force_rounding(monkeypatch, *modules):
    """What the card does: ``bf16_products`` true for float32 on the CPU."""
    def on(cfg, device):
        return cfg.matmul_precision == BF16 and cfg.dtype == "float32"

    for mod in modules:
        monkeypatch.setattr(mod, "bf16_products", on)


def test_kl_quotient_keeps_full_precision_a(monkeypatch):
    """Under rounding, kl's step rounds its three products' operands but
    divides the full-precision A."""
    _force_rounding(monkeypatch, base)
    g = torch.Generator().manual_seed(1)
    a = torch.rand((30, 12), generator=g) + 0.01
    w0 = torch.rand((30, 3), generator=g) + 0.1
    h0 = torch.rand((3, 12), generator=g) + 0.1
    cfg = SolverConfig(algorithm="kl", matmul_precision=BF16)
    state = base.init_state(a, w0, h0, ())
    got = pkl.step(a, state, cfg, check=False)
    eps = cfg.div_eps

    def r(x):
        return x.to(torch.bfloat16).to(torch.float32)

    def rule(a_q):
        q = a_q / (r(w0) @ r(h0) + eps)
        h = base.clamp(h0 * (r(w0.mT) @ r(q))
                       / (w0.sum(dim=-2)[:, None] + eps), 0.0)
        q = a_q / (r(w0) @ r(h) + eps)
        w = base.clamp(w0 * (r(q) @ r(h.mT))
                       / (h.sum(dim=-1)[None, :] + eps), 0.0)
        return w, h

    w, h = rule(a)
    assert torch.equal(got.h, h) and torch.equal(got.w, w)
    w_r, h_r = rule(r(a))  # a rounded quotient would differ
    assert not (torch.equal(got.h, h_r) and torch.equal(got.w, w_r))


@pytest.mark.parametrize("opt_in", [False, True], ids=["default", "opt-in"])
def test_kl_bf16_quotient_opts_the_grid_into_rounded_a(monkeypatch, opt_in):
    """On the packed whole grid, A reaches kl's block unrounded unless
    ``kl_bf16_quotient``; the other blocks take it rounded once a solve
    (nmfx's ``_streams_bf16_a``)."""
    _force_rounding(monkeypatch, sched_mu, grid_mu, base)
    seen = []
    real = grid_mu.BLOCKS["kl"]

    def spy(a, *args, **kw):
        seen.append(a)
        return real(a, *args, **kw)

    monkeypatch.setitem(grid_mu.BLOCKS, "kl", spy)
    a = torch.as_tensor(two_group_matrix(30, 5, seed=1), dtype=torch.float32)
    a = a + 0.001  # not bf16-representable
    cfg = SolverConfig(algorithm="kl", backend="packed", max_iter=4,
                       matmul_precision=BF16,
                       experimental=ExperimentalConfig(
                           kl_bf16_quotient=opt_in))
    w0 = torch.rand((2, 30, 2)) + 0.1
    h0 = torch.rand((2, 2, 10)) + 0.1
    sched_mu.mu_sched(a, w0, h0, cfg, slots=2, job_ks=(2, 2), device="cpu")
    assert seen
    rounded = a.to(torch.bfloat16).to(torch.float32)
    assert torch.equal(seen[0], rounded if opt_in else a)


def test_forced_rounding_agrees_with_float32_at_the_agreement_tier(
        data, monkeypatch):
    """The card's bf16 whole grid, simulated on the CPU by forcing the
    rounding: best k and the k = 2 memberships agree with float32
    (factors are not held)."""
    _force_rounding(monkeypatch, sched_mu, grid_mu)
    a = two_group_matrix(120, 10, seed=4)
    kw = dict(ks=(2, 3), restarts=6, seed=1, device="cpu", max_iter=300)
    want = nmfx_torch.nmfconsensus(a, **kw)
    got = nmfx_torch.nmfconsensus(
        a, solver_cfg=SolverConfig(max_iter=300, matmul_precision=BF16),
        **{k: v for k, v in kw.items() if k != "max_iter"})
    assert got.best_k == want.best_k == 2
    np.testing.assert_array_equal(got.per_k[2].membership,
                                  want.per_k[2].membership)
    assert not np.array_equal(got.per_k[3].best_w, want.per_k[3].best_w)


def test_pallas_float64_still_refused():
    """bf16 operands on the kernels under float64 storage, which the port
    refused before it ran float64 on the kernels, run as ``nmfx`` runs
    them: on the CPU the float32 bf16 kernel route's stops and
    memberships, each restart within one check of its iterations, with
    float64 factors (``nmfx``'s float64 sweep of the setting is held in
    ``tests/test_torch_float64.py``)."""
    kw = dict(ks=(2,), restarts=2, device="cpu")
    a = two_group_matrix(40, 6, seed=0)
    got = nmfx_torch.nmfconsensus(a, solver_cfg=SolverConfig(
        dtype="float64", backend="pallas", matmul_precision=BF16,
        max_iter=300), **kw).per_k[2]
    want = nmfx_torch.nmfconsensus(a, solver_cfg=SolverConfig(
        backend="pallas", matmul_precision=BF16, max_iter=300),
        **kw).per_k[2]
    assert np.asarray(got.best_w).dtype == np.float64
    assert np.asarray(want.best_w).dtype == np.float32
    assert np.abs(got.iterations - want.iterations).max() <= 10
    np.testing.assert_array_equal(got.stop_reasons, want.stop_reasons)
    np.testing.assert_array_equal(got.membership, want.membership)
