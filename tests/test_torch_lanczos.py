"""The port's Lanczos SVD (``nmfx_torch/ops/lanczos_svd.py``) and Lanczos
NNDSVD against ``nmfx``'s on the CPU (``tests/test_init.py``'s Lanczos
cases, held against the reference and ``torch.linalg.svd``).

Tolerances: singular values within rtol 1e-4 of the reference's
``truncated_svd`` (the same algorithm from the same start vector) and
within rtol 1e-3 of the dense SVD (the reference's band: ncv steps of one
restart leave the k-th value of a crowded spectrum that far off); with
ncv as large as the operator, the smallest values within 1e-4 of the
largest (float32 Lanczos resolves λ to about eps·λmax); the leading
subspaces by their principal angles (cosines above 0.999,
both sides); the rank-k reconstruction within 1e-2 of the dense
truncation's norm, as the reference's case; Lanczos NNDSVD against dense
NNDSVD within 5e-3 (rtol and atol), the reference's band. The start
vector is ``jax.random.normal(key(0), (dim,))`` through the port's
normal draw; ``ncv`` is clamped into [k + 1, dim].
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmfx
import nmfx_torch
import nmfx_torch.datasets
from nmfx.init import nndsvd_init as j_nndsvd
from nmfx.ops.lanczos_svd import truncated_svd as j_svd
from nmfx_torch.config import InitConfig
from nmfx_torch.init import nndsvd_init, restart_inits
from nmfx_torch.ops.lanczos_svd import truncated_svd
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)


def _low_rank():
    rng = np.random.default_rng(0)
    return np.asarray(rng.uniform(0.5, 1.5, (60, 3))
                      @ rng.uniform(0.5, 1.5, (3, 25)), np.float32), 3


def _cosines(x, y):
    """Cosines of the principal angles between the column spans of x and
    y (orthonormalized)."""
    qx, _ = np.linalg.qr(np.asarray(x, np.float64))
    qy, _ = np.linalg.qr(np.asarray(y, np.float64))
    return np.linalg.svd(qx.T @ qy, compute_uv=False)


@pytest.mark.parametrize("m,n", [(80, 30), (30, 80), (200, 45)])
@pytest.mark.parametrize("k", [1, 4])
def test_lanczos_svd_matches_reference_and_dense(m, n, k):
    """The reference's uniform cases, and a tall 200×45 one with six
    planted components (a uniform matrix that size crowds its 4th and
    5th values within 4 %, too close for 20 steps in both packages)."""
    rng = np.random.default_rng(11)
    if m == 200:
        a = (rng.uniform(0.0, 1.0, (m, 6)) * np.arange(6, 0, -1)
             @ rng.uniform(0.0, 1.0, (6, n))
             + rng.uniform(0.0, 0.05, (m, n))).astype(np.float32)
    else:
        a = rng.uniform(0.0, 2.0, (m, n)).astype(np.float32)
    u, s, vt = truncated_svd(torch.tensor(a), k)
    assert u.shape == (m, k) and s.shape == (k,) and vt.shape == (k, n)
    ju, js, jvt = j_svd(jnp.asarray(a), k)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4)
    ud, sd, vtd = torch.linalg.svd(torch.tensor(a, dtype=torch.float64),
                                   full_matrices=False)
    np.testing.assert_allclose(s.numpy(), sd[:k].numpy(), rtol=1e-3)
    for got, want in ((u.numpy(), ud[:, :k].numpy()),
                      (vt.numpy().T, vtd[:k].numpy().T),
                      (u.numpy(), np.asarray(ju))):
        assert _cosines(got, want).min() > 0.999
    rec = u.numpy() * s.numpy() @ vt.numpy()
    rec_d = (ud[:, :k] * sd[:k] @ vtd[:k]).numpy()
    assert np.linalg.norm(rec - rec_d) <= 1e-2 * np.linalg.norm(rec_d)


def test_lanczos_svd_degenerate_spectrum_falls_back():
    rng = np.random.default_rng(21)
    q1, _ = np.linalg.qr(rng.normal(size=(60, 4)))
    q2, _ = np.linalg.qr(rng.normal(size=(40, 4)))
    a = ((q1 * np.array([5.0, 5.0, 3.0, 1.0])) @ q2.T).astype(np.float32)
    _, s, _ = truncated_svd(torch.tensor(a), 4)
    np.testing.assert_allclose(s.numpy(), [5.0, 5.0, 3.0, 1.0], rtol=1e-3,
                               atol=1e-3)
    _, js, _ = j_svd(jnp.asarray(a), 4)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-4)


def test_lanczos_svd_float64_and_breakdown():
    """An exactly rank-3 matrix: the recurrence breaks down after three
    steps and the latched flag keeps the top values exact (float64)."""
    a, k = _low_rank()
    a64 = torch.tensor(a, dtype=torch.float64)
    u, s, vt = truncated_svd(a64, k)
    assert s.dtype == torch.float64
    sd = torch.linalg.svd(a64, full_matrices=False).S[:k]
    np.testing.assert_allclose(s.numpy(), sd.numpy(), rtol=1e-10)


@pytest.mark.parametrize("k,ncv,want", [(3, None, 20), (3, 2, 4),
                                        (10, None, 21), (4, 500, 25),
                                        (25, None, 25)])
def test_ncv_clamping(k, ncv, want):
    """The default (2k + 1, floor 20) and explicit ncv clamped into
    [k + 1, dim]: the tridiagonal's size shows in the number of steps
    (counted through the Gram operator's products)."""
    a, _ = _low_rank()
    rng = np.random.default_rng(3)
    a = a + rng.uniform(0.0, 0.1, a.shape).astype(np.float32)
    calls = []
    t = torch.tensor(a)
    orig = torch.linalg.eigh

    def eigh(x, *args, **kw):
        calls.append(x.shape[0])
        return orig(x, *args, **kw)

    torch.linalg.eigh = eigh
    try:
        u, s, vt = truncated_svd(t, k, ncv)
    finally:
        torch.linalg.eigh = orig
    assert calls == [want]
    ju, js, jvt = j_svd(jnp.asarray(a), k, ncv)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0,
                               atol=1e-4 * float(js[0]))


def test_k_out_of_range_rejected():
    a, _ = _low_rank()
    with pytest.raises(ValueError, match="k must be in"):
        truncated_svd(torch.tensor(a), 26)


@pytest.mark.parametrize("ncv", [None, 8])
def test_nndsvd_lanczos_matches_dense_and_reference(ncv):
    a, k = _low_rank()
    t = torch.tensor(a)
    w_d, h_d = nndsvd_init(t, k, svd_method="dense")
    w_l, h_l = nndsvd_init(t, k, svd_method="lanczos", ncv=ncv)
    np.testing.assert_allclose(w_l.numpy(), w_d.numpy(), rtol=5e-3,
                               atol=5e-3)
    np.testing.assert_allclose(h_l.numpy(), h_d.numpy(), rtol=5e-3,
                               atol=5e-3)
    jw, jh = j_nndsvd(jnp.asarray(a), k, svd_method="lanczos", ncv=ncv)
    np.testing.assert_allclose(w_l.numpy(), np.asarray(jw), rtol=5e-3,
                               atol=5e-3)
    np.testing.assert_allclose(h_l.numpy(), np.asarray(jh), rtol=5e-3,
                               atol=5e-3)


def test_init_config_lanczos_through_the_pipeline():
    with pytest.raises(ValueError, match="svd_method"):
        InitConfig(svd_method="arpack")
    with pytest.raises(ValueError, match="svd_method"):
        nndsvd_init(torch.tensor(_low_rank()[0]), 3, svd_method="Lanczos")
    from nmfx_torch.convert import init_config_from_dict

    cfg = init_config_from_dict({"method": "nndsvd", "minval": 0.0,
                                 "maxval": 1.0, "svd_method": "lanczos",
                                 "ncv": 12})
    assert (cfg.svd_method, cfg.ncv) == ("lanczos", 12)
    a = nmfx_torch.datasets.two_group_matrix(60, 8, seed=2).astype(
        np.float32)
    w0, h0 = restart_inits(torch.tensor(a), np.zeros((2, 2), np.uint32), 2,
                           cfg)
    wd, hd = nndsvd_init(torch.tensor(a), 2)
    np.testing.assert_allclose(w0[1].numpy(), wd.numpy(), rtol=5e-3,
                               atol=5e-3)
    kw = dict(ks=(2, 3), restarts=2, seed=1, init="nndsvd", max_iter=200)
    got = nmfx_torch.nmfconsensus(a, init_cfg=cfg, device="cpu",
                                  **{k: v for k, v in kw.items()
                                     if k != "init"})
    want = nmfx.nmfconsensus(a, init_cfg=nmfx.InitConfig(
        method="nndsvd", svd_method="lanczos", ncv=12), use_mesh=False,
        **{k: v for k, v in kw.items() if k != "init"})
    assert got.best_k == want.best_k
    assert np.array_equal(got.per_k[2].membership,
                          np.asarray(want.per_k[2].membership))
    r = nmfx_torch.nmf(a, 2, init_cfg=cfg, max_iter=50, device="cpu")
    assert np.isfinite(r.w.numpy()).all()
