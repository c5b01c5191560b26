"""Random-projection compressed NMF updates: the ``backend="sketched"``
engine (counterpart of ``nmfx/solvers/sketched.py``; "Faster-than-fast
NMF", arxiv 1812.04315).

Both factors stay full size; only the update computations compress. Per
restart two projections

    L : (r, m)   row sketch      R : (n, r)   column sketch

are drawn from the restart's canonical key (``fold_in`` of it with two
constants, so the exact engines' init draws are untouched), and the
Gram-family terms of the mu/hals updates contract against the
pre-sketched matrices instead of A:

    H update:   WᵀA  →  (LW)ᵀ(LA)        WᵀW  →  (LW)ᵀ(LW)
    W update:   AHᵀ  →  (AR)(HR)ᵀ        HHᵀ  →  (HR)(HR)ᵀ

L·A (r × n) and A·R (m × r) are computed once per restart; an
iteration's data-sized products are the four sketched ones, ~4rk(m+n)
FLOPs against mu's 4mnk (:func:`sketched_model_flops`).

The projections are drawn on A's device (``random.normal_device``: the
device threefry, whose words equal the host's), never on the host and
copied: at the north star the draws are about 10⁸ normals.

Everything here is lane-batched, as ``base.run_loop_batched`` drives the
exact solvers: factors (B, m, k) / (B, k, n), one key a lane; each
lane's step bound is its own Gram's Frobenius norm. A single restart is
a batch of one (:func:`solve_sketched` takes either).

Nesterov momentum (``SketchConfig.momentum``) evaluates each update at
``max(X + beta_t (X - X_prev), 0)`` with ``t⁺ = (1 + √(1 + 4t²))/2`` and
``beta = (t - 1)/t⁺``. The stop tests are class stability and TolX only
(TolFun would need the uncompressed m × n residual at every check);
after the compressed loop, ``SketchConfig.polish_iters`` exact
iterations run and the final residual is the uncompressed one. The
accuracy contract is statistical at the consensus level
(``nmfx_torch.agreement``), never bit-exact.

The same machinery scores restarts for screening (:func:`screen_pass`,
the doubly compressed objective ‖(LA)R − (LW)(HR)‖²).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nmfx_torch import random as _random
from nmfx_torch.config import SKETCHED_ALGORITHMS, SolverConfig
from nmfx_torch.solvers import base
from nmfx_torch.solvers.hals import hals_h_sweep_from, hals_w_sweep_from

#: fold_in constants deriving the sketch keys from a restart's key
_FOLD_L = 0x5E7C
_FOLD_R = 0x5E7D


def resolve_dim(cfg: SolverConfig, m: int, n: int, k: int) -> int:
    """The sketch dimension r at shape (m, n), rank k: ``sketch.dim``
    ("auto" → ``max(4k + 8, 40)``), clamped into [k + 1, min(m, n)]."""
    d = cfg.sketch.dim
    r = max(4 * k + 8, 40) if d == "auto" else int(d)
    return max(k + 1, min(r, m, n))


def sketched_model_flops(m: int, n: int, k: int, r: int) -> float:
    """Model FLOPs of one sketched iteration of one restart: L·W (2rmk),
    (LW)ᵀ(LA) (2krn), (LW)ᵀ(LW) (2rk²), (WᵀW)H (2nk²) for H; H·R (2knr),
    (AR)(HR)ᵀ (2mkr), (HR)(HR)ᵀ (2rk²), W(HHᵀ) (2mk²) for W. The one-time
    L·A / A·R sketches are left out, as the exact model leaves out its
    elementwise terms."""
    return 4.0 * r * k * (m + n) + 4.0 * r * k * k + 2.0 * k * k * (m + n)


def _lane_keys(keys: np.ndarray) -> np.ndarray:
    return np.asarray(keys, np.uint32).reshape(-1, 2)


def sketch_operators(keys: np.ndarray, m: int, n: int, r: int,
                     dtype: torch.dtype, device
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each lane's projections from its restart key: L ~ N(0, 1/r)^(r×m)
    from ``fold_in(key, 0x5E7C)`` and R ~ N(0, 1/r)^(n×r) from
    ``fold_in(key, 0x5E7D)``, drawn on ``device``. ``keys`` (2,) gives
    (r, m) / (n, r); (B, 2) gives (B, r, m) / (B, n, r)."""
    lanes = _lane_keys(keys)
    kl = np.stack([_random.fold_in(kk, _FOLD_L) for kk in lanes])
    kr = np.stack([_random.fold_in(kk, _FOLD_R) for kk in lanes])
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    scale = float(np_dt(1.0) / np.sqrt(np_dt(r)))
    left = _random.normal_device(kl, (r, m), dtype, device) * scale
    right = _random.normal_device(kr, (n, r), dtype, device) * scale
    if np.asarray(keys).ndim == 1:
        left, right = left[0], right[0]
    return left, right


def _h_gram_terms(w, la, left, bf=False):
    mm = base.mm
    lw = mm(left, w, bf)  # (B, r, k)
    return mm(lw.mT, la, bf), mm(lw.mT, lw, bf)  # (B, k, n), (B, k, k)


def _w_gram_terms(h, ar, right, bf=False):
    mm = base.mm
    hr = mm(h, right, bf)  # (B, k, r)
    return mm(ar, hr.mT, bf), mm(hr, hr.mT, bf)  # (B, m, k), (B, k, k)


def _objective(lar, left, right, w, h, bf=False) -> torch.Tensor:
    """Each lane's ‖(LA)R − (LW)(HR)‖²_F from its (LA)R."""
    mm = base.mm
    d = lar - mm(mm(left, w, bf), mm(h, right, bf), bf)
    return base.lane_sum(d * d)


def _frobenius(x: torch.Tensor) -> torch.Tensor:
    return base.lane_scalar(torch.sqrt(base.lane_sum(x * x)))


def _apply_mu(w, h, la, ar, left, right, cfg):
    """One projected-gradient step per factor on the sketched
    least-squares objectives. The multiplicative ratio does not carry
    over: a Gaussian sketch is not non-negative, and a transiently
    negative sketched numerator would zero an entry for good. The step
    ``max(X − ∇/L̂, 0)`` with ``L̂ = ‖Gram‖_F + ε`` (an upper bound of the
    Lipschitz constant) is always stable."""
    zt = cfg.zero_threshold
    bf, mm = base.bf16_products(cfg, w.device), base.mm
    wta, wtw = _h_gram_terms(w, la, left, bf)
    lh = _frobenius(wtw) + cfg.div_eps
    h = base.clamp(torch.clamp_min(h - (mm(wtw, h, bf) - wta) / lh, 0.0),
                   zt)
    aht, hht = _w_gram_terms(h, ar, right, bf)
    lw = _frobenius(hht) + cfg.div_eps
    w = base.clamp(torch.clamp_min(w - (mm(w, hht, bf) - aht) / lw, 0.0),
                   zt)
    return w, h


def _apply_hals(w, h, la, ar, left, right, cfg):
    """Compressed HALS: the coordinate sweeps of ``solvers/hals.py`` on
    the sketched Gram terms (the sweeps themselves never touch A)."""
    eps, zt = cfg.div_eps, cfg.zero_threshold
    bf = base.bf16_products(cfg, w.device)
    wta, wtw = _h_gram_terms(w, la, left, bf)
    h = hals_h_sweep_from(wta, wtw, h, eps, zt, bf)
    aht, hht = _w_gram_terms(h, ar, right, bf)
    w = hals_w_sweep_from(aht, hht, w, eps, zt, bf)
    return w, h


_APPLY = {"mu": _apply_mu, "hals": _apply_hals}


def _momentum_step(apply_fn, w, h, w_acc, h_acc, t, la, ar, left, right,
                   cfg):
    """One compressed iteration from (w, h) with the previous accepted
    iterates (w_acc, h_acc) and the t-sequence scalar of each lane."""
    if cfg.sketch.momentum:
        t_next = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        beta = base.lane_scalar((t - 1.0) / t_next)
        wb = torch.clamp_min(w + beta * (w - w_acc), 0.0)
        hb = torch.clamp_min(h + beta * (h - h_acc), 0.0)
        w2, h2 = apply_fn(wb, hb, la, ar, left, right, cfg)
    else:
        t_next = t
        w2, h2 = apply_fn(w, h, la, ar, left, right, cfg)
    return w2, h2, t_next


def init_aux(a, w0, h0, cfg: SolverConfig, keys: np.ndarray):
    """The carry: the one-time sketches L·A / A·R, the projections, the
    previous accepted iterates and each lane's t (Nesterov). ``w0``
    (B, m, k), ``keys`` (B, 2)."""
    m, n = a.shape
    k = w0.shape[-1]
    r = resolve_dim(cfg, m, n, k)
    left, right = sketch_operators(_lane_keys(keys), m, n, r, a.dtype,
                                   a.device)
    bf = base.bf16_products(cfg, a.device)
    la = base.mm(left, a, bf)  # (B, r, n), once per restart
    ar = base.mm(a, right, bf)  # (B, m, r), once per restart
    t = torch.ones(w0.shape[:-2], dtype=a.dtype, device=a.device)
    return (la, ar, left, right, w0, h0, t)


def step(a, state: base.State, cfg: SolverConfig,
         check: bool = True) -> base.State:
    """One compressed iteration with optional Nesterov extrapolation.
    ``state.aux = (la, ar, left, right, w_acc, h_acc, t)``; (w_acc,
    h_acc) are the previous accepted iterates, distinct from
    ``state.w_prev`` (which the loop overwrites for TolX)."""
    la, ar, left, right, w_acc, h_acc, t = state.aux
    w0, h0 = state.w, state.h
    w, h, t_next = _momentum_step(_APPLY[cfg.algorithm], w0, h0, w_acc,
                                  h_acc, t, la, ar, left, right, cfg)
    state = dataclasses.replace(
        state, w=w, h=h, aux=(la, ar, left, right, w0, h0, t_next))
    if not check:
        return state
    # class stability and TolX only: TolFun would need the uncompressed
    # residual at every check, the one cost the compression avoids
    return base.check_convergence(state, cfg, use_class=cfg.use_class_stop,
                                  use_tolx=True)


def solve_sketched(a: torch.Tensor, w0: torch.Tensor, h0: torch.Tensor,
                   keys: np.ndarray, cfg: SolverConfig
                   ) -> base.SolverResult:
    """Compressed factorizations from the restarts' keys: lanes (B, m, k)
    / (B, k, n) with keys (B, 2), or one restart's (m, k) / (k, n) with
    its key (2,) (then iterations and the stop reason are ints).

    After the compressed loop stops, ``sketch.polish_iters`` exact
    iterations (the full mu/hals rule against A) run on every lane, and
    the final residual is the uncompressed one."""
    if cfg.algorithm not in SKETCHED_ALGORITHMS:
        raise ValueError(
            f"sketched engine supports {SKETCHED_ALGORITHMS}, got "
            f"{cfg.algorithm!r}")
    from nmfx_torch.solvers import SOLVERS

    one = w0.dim() == 2
    if one:
        w0, h0, keys = w0[None], h0[None], _lane_keys(keys)
    res = base.run_loop_batched(a, w0, h0, cfg, step,
                                init_aux(a, w0, h0, cfg, keys))
    polish = cfg.sketch.polish_iters
    if polish:
        mod = SOLVERS[cfg.algorithm]
        state = base.init_state(a, res.w, res.h,
                                mod.init_aux(a, res.w, res.h, cfg))
        for _ in range(polish):
            state = dataclasses.replace(state, w_prev=state.w,
                                        h_prev=state.h,
                                        iteration=state.iteration + 1)
            state = mod.step(a, state, cfg, check=False)
        res = res._replace(w=state.w, h=state.h,
                           iterations=res.iterations + polish,
                           dnorm=base.residual_norm(
                               a, state.w, state.h,
                               base.bf16_products(cfg, a.device)))
    if one:
        res = res._replace(w=res.w[0], h=res.h[0],
                           iterations=int(res.iterations[0]),
                           dnorm=res.dnorm[0],
                           stop_reason=int(res.stop_reason[0]))
    return res


def compressed_objective(a: torch.Tensor, w: torch.Tensor, h: torch.Tensor,
                         keys: np.ndarray, cfg: SolverConfig) -> torch.Tensor:
    """Each lane's doubly compressed objective ‖(LA)R − (LW)(HR)‖²_F with
    its own projections: a proxy of the residual that only ranks
    restarts (no normalizer). Lanes (B, m, k) / (B, k, n), keys (B, 2)."""
    m, n = a.shape
    r = resolve_dim(cfg, m, n, w.shape[-1])
    left, right = sketch_operators(_lane_keys(keys), m, n, r, a.dtype,
                                   a.device)
    return _objective((left @ a) @ right, left, right, w, h)


def screen_pass(a: torch.Tensor, w0: torch.Tensor, h0: torch.Tensor,
                keys: np.ndarray, cfg: SolverConfig) -> torch.Tensor:
    """The screening pass of a pool of lanes: ``sketch.screen_iters``
    compressed iterations (no convergence tests: the budget is the
    point), then each lane's compressed objective. Returns (B,) scores;
    lower is more promising."""
    la, ar, left, right, _, _, t = init_aux(a, w0, h0, cfg, keys)
    apply_fn = _APPLY[cfg.algorithm]
    w, h, w_acc, h_acc = w0, h0, w0, h0
    for _ in range(cfg.sketch.screen_iters):
        w2, h2, t = _momentum_step(apply_fn, w, h, w_acc, h_acc, t, la, ar,
                                   left, right, cfg)
        w_acc, h_acc, w, h = w, h, w2, h2
    bf = base.bf16_products(cfg, a.device)
    return _objective(base.mm(la, right, bf), left, right, w, h, bf)


def sweep_lanes(a: torch.Tensor, w0s: torch.Tensor, h0s: torch.Tensor,
                keys: np.ndarray, cfg: SolverConfig) -> base.SolverResult:
    """The sketched engine over a batch of restarts: the sweep's form."""
    return solve_sketched(a, w0s, h0s, keys, cfg)
