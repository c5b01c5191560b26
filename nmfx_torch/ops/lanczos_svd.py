"""Truncated SVD by Lanczos on the Gram operator (counterpart of
``nmfx/ops/lanczos_svd.py``; the reference C library's ARPACK path,
``libnmf/calculatesvd.c:38-267``).

Lanczos with full reorthogonalization (two passes) runs a fixed ``ncv``
steps on the smaller Gram operator (y = Aᵀ(Ax) or A(Aᵀx)); the
tridiagonal's eigenpairs give σ = √λ and one side's vectors, the other
side comes from u = Av/σ. A latched breakdown flag (β at or below 25·eps
relative to the largest α or β seen) zeroes the rest of the recurrence,
so noise vectors cannot bring back ghost copies of the top eigenvalues.
The steps stay on A's device: the flag is a tensor, not a host read.

A single start vector holds one Ritz copy per distinct eigenvalue, so a
repeated σ would miss its second copy. The guard estimates the norm of
the deflated operator A − U S Vᵀ by 12 power iterations; above σ_k the
dense factorization (``torch.linalg.svd`` on the same device) is
returned instead, as the reference does. That test is the one host read.

The start vectors are ``jax.random.normal(key(0), (dim,))`` and
``normal(fold_in(key(0), 1), (n,))``, drawn on A's device
(``random.normal_device``).

NNDSVD initialization uses it under ``InitConfig(svd_method="lanczos")``.
"""

from __future__ import annotations

import torch

from nmfx_torch import random as _random


def truncated_svd(a: torch.Tensor, k: int, ncv: "int | None" = None):
    """Leading-k SVD of A (m×n) on A's device: (U m×k, S k, Vt k×n).

    ``ncv``: the Lanczos subspace size; None = 2k+1 with a floor of 20,
    and either is clamped into [k+1, the operator's dimension]."""
    m, n = a.shape
    big_m = m >= n  # iterate on the smaller Gram
    dim = n if big_m else m
    if not 1 <= k <= dim:
        raise ValueError(f"k must be in [1, {dim}]")
    if ncv is None:
        ncv = min(max(2 * k + 1, 20), dim)
    ncv = min(max(ncv, k + 1), dim)
    f = torch.float64 if a.dtype == torch.float64 else torch.float32
    a = a.to(f)
    dev = a.device

    def gram_matvec(x):
        return a.T @ (a @ x) if big_m else a @ (a.T @ x)

    key = _random.key(0)
    q = _random.normal_device(key, (dim,), f, dev)
    q = q / torch.linalg.norm(q)
    tol_rel = 25 * torch.finfo(f).eps
    zero = torch.zeros((), dtype=f, device=dev)
    q_prev = torch.zeros(dim, dtype=f, device=dev)
    beta_prev, scale = zero, zero
    dead = torch.zeros((), dtype=torch.bool, device=dev)
    basis = torch.zeros((ncv, dim), dtype=f, device=dev)
    alphas, betas = [], []
    for i in range(ncv):
        w = gram_matvec(q) - beta_prev * q_prev
        alpha = w @ q
        w = w - alpha * q
        # full reorthogonalization, two passes (one leaves O(eps·λmax)
        # residue at a large spectral range in float32)
        w = w - basis.T @ (basis @ w)
        w = w - basis.T @ (basis @ w)
        beta = torch.linalg.norm(w)
        scale = torch.maximum(scale, torch.maximum(alpha.abs(), beta))
        dead_next = dead | (beta <= tol_rel * scale)
        alpha = torch.where(dead, zero, alpha)
        beta = torch.where(dead_next, zero, beta)
        q_next = torch.where(dead_next, torch.zeros_like(w),
                             w / torch.where(beta > 0, beta, 1.0))
        basis[i] = q
        alphas.append(alpha)
        betas.append(beta)
        q_prev, q, beta_prev, dead = q, q_next, beta, dead_next

    alphas, betas = torch.stack(alphas), torch.stack(betas)
    t = (torch.diag(alphas) + torch.diag(betas[:-1], 1)
         + torch.diag(betas[:-1], -1))
    evals, evecs = torch.linalg.eigh(t)  # ascending
    # top-k Ritz pairs, descending (the reference's dswap reorder)
    sel = torch.flip(torch.argsort(evals, stable=True), (0,))[:k]
    lam = torch.clamp_min(evals[sel], 0.0)
    ritz = basis.T @ evecs[:, sel]  # (dim, k) eigenvectors of the Gram
    s = torch.sqrt(lam)

    safe = torch.where(s > 0, s, 1.0)
    if big_m:
        v = ritz  # (n, k)
        u = torch.where(s[None, :] > 0, (a @ v) / safe[None, :], 0.0)
    else:
        u = ritz  # (m, k)
        v = torch.where(s[None, :] > 0, (a.T @ u) / safe[None, :], 0.0)
    vt = v.T

    def deflated_matvec(x):
        return a @ x - u @ (s * (vt @ x))

    def deflated_rmatvec(y):
        return a.T @ y - vt.T @ (s * (u.T @ y))

    x = _random.normal_device(_random.fold_in(key, 1), (n,), f, dev)
    x = x / torch.linalg.norm(x)
    for _ in range(12):
        z = deflated_rmatvec(deflated_matvec(x))
        nz = torch.linalg.norm(z)
        x = z / torch.where(nz > 0, nz, 1.0)
    est = torch.linalg.norm(deflated_matvec(x))
    tiny = torch.finfo(f).tiny
    ok = est <= s[k - 1] * 1.01 + 1e-3 * torch.clamp_min(s[0], tiny)
    if bool(ok):
        return u, s, vt
    ud, sd, vtd = torch.linalg.svd(a, full_matrices=False)
    return ud[:, :k], sd[:k], vtd[:k, :]
