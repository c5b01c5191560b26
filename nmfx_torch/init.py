"""W0/H0 initialization: uniform random and NNDSVD (counterpart of
``nmfx/init.py``).

* ``random``: uniform [minval, maxval) drawn on the host from the JAX
  threefry key chain (``nmfx_torch.random``), so a key gives the same
  W0/H0 bits as the reference package.
* ``nndsvd``: Boutsidis & Gallopoulos NNDSVD (reference
  ``generatematrix.c:145-247``) through a dense ``torch.linalg.svd`` or,
  under ``svd_method="lanczos"``, the truncated Lanczos SVD
  (``nmfx_torch/ops/lanczos_svd.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from nmfx_torch import random as _random
from nmfx_torch.config import InitConfig


def random_init(key: np.ndarray, m: int, n: int, k: int,
                cfg: InitConfig = InitConfig(), dtype=np.float32
                ) -> tuple[np.ndarray, np.ndarray]:
    """Uniform random W0 (m×k), H0 (k×n) as float32 or float64 numpy
    arrays (the reference's ``random_init``: one split, then one draw per
    factor, in ``dtype``)."""
    kw, kh = _random.split(key)
    return (_random.uniform(kw, (m, k), cfg.minval, cfg.maxval, dtype),
            _random.uniform(kh, (k, n), cfg.minval, cfg.maxval, dtype))


def nndsvd_init(a: torch.Tensor, k: int, zero_threshold: float = 0.0,
                svd_method: str = "dense", ncv: "int | None" = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """NNDSVD initialization (deterministic in A), in A's dtype and on
    A's device; its rank-k SVD dense or by Lanczos (``svd_method``,
    ``ncv``)."""
    if svd_method == "lanczos":
        from nmfx_torch.ops.lanczos_svd import truncated_svd

        u, s, vt = truncated_svd(a, k, ncv)
    elif svd_method == "dense":
        u, s, vt = torch.linalg.svd(a, full_matrices=False)
        u, s, vt = u[:, :k], s[:k], vt[:k, :]
    else:
        raise ValueError(
            f"svd_method must be 'dense' or 'lanczos', got {svd_method!r}")

    # leading pair: W[:,0] = sqrt(s0)*|u0|, H[0,:] = sqrt(s0)*|v0|
    w0 = torch.sqrt(s[0]) * torch.abs(u[:, :1])
    h0 = torch.sqrt(s[0]) * torch.abs(vt[:1, :])

    if k > 1:
        uj = u[:, 1:]  # (m, k-1)
        vj = vt[1:, :].T  # (n, k-1)
        up, un = uj.clamp(min=0), (-uj).clamp(min=0)
        vp, vn = vj.clamp(min=0), (-vj).clamp(min=0)
        nup = torch.linalg.norm(up, dim=0)
        nun = torch.linalg.norm(un, dim=0)
        nvp = torch.linalg.norm(vp, dim=0)
        nvn = torch.linalg.norm(vn, dim=0)
        termp = nup * nvp
        termn = nun * nvn
        use_p = termp >= termn
        term = torch.where(use_p, termp, termn)
        scale = torch.sqrt(s[1:] * term)
        tiny = torch.finfo(a.dtype).tiny
        wcols = scale * torch.where(use_p, up / nup.clamp(min=tiny),
                                    un / nun.clamp(min=tiny))
        hrows = scale * torch.where(use_p, vp / nvp.clamp(min=tiny),
                                    vn / nvn.clamp(min=tiny))
        w0 = torch.cat([w0, wcols], dim=1)
        h0 = torch.cat([h0, hrows.T], dim=0)

    # final clamp (generatematrix.c:229-247)
    w0 = torch.where(w0 <= zero_threshold, 0.0, w0)
    h0 = torch.where(h0 <= zero_threshold, 0.0, h0)
    return w0, h0


def restart_inits(a: torch.Tensor, keys: np.ndarray, k: int,
                  cfg: InitConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Initial factors of a restart batch, stacked (R, m, k) / (R, k, n)
    on A's device and in A's dtype (random draws in float64 for a float64
    A, float32 otherwise). ``keys`` (R, 2) are the restart keys; NNDSVD
    ignores them (deterministic in A, as in the reference)."""
    m, n = a.shape
    r = keys.shape[0]
    if cfg.method == "nndsvd":
        w0, h0 = nndsvd_init(a, k, svd_method=cfg.svd_method, ncv=cfg.ncv)
        return (w0.expand(r, m, k).contiguous(),
                h0.expand(r, k, n).contiguous())
    dtype = np.float64 if a.dtype == torch.float64 else np.float32
    pairs = [random_init(kk, m, n, k, cfg, dtype) for kk in keys]
    w0s = torch.from_numpy(np.stack([p[0] for p in pairs]))
    h0s = torch.from_numpy(np.stack([p[1] for p in pairs]))
    return (w0s.to(device=a.device, dtype=a.dtype),
            h0s.to(device=a.device, dtype=a.dtype))
