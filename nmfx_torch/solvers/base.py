"""Shared solver loop (counterpart of ``nmfx/solvers/base.py``).

Every solver exposes

* ``init_aux(a, w0, h0, cfg) -> aux`` — solver-specific carry
* ``step(a, state, cfg, check) -> state`` — one full iteration, then its
  own convergence decision when ``check`` is set

and :func:`run_loop_batched` drives it. Steps are lane-polymorphic: the
factors are (m, k) / (k, n) for one restart or (B, m, k) / (B, k, n) for
B restarts ("lanes"), and each per-lane quantity is 0-d or (B,), so one
step serves the single-restart ``solve`` and the batched restart route.

The reference's ``lax.while_loop`` (and ``jax.vmap`` of it) becomes a
host loop: the iteration clock is a Python int shared by every lane still
running, the convergence bookkeeping stays on the device, and the host
reads the lanes' ``done`` flags once per ``check_every`` iterations (once
per iteration in the tail that finishes a ``max_iter`` that is not a
multiple of ``check_every``). A block of iterations runs on every lane,
and a lane that was done when the block started keeps its whole state,
as the batched ``while_loop`` keeps it; so each lane's iterations, stop
reason and factors are those of a single-restart solve of that lane. The
data-dependent inner loops of pg and alspg read "is any lane still
running" once per trial; every read is counted in ``HostReads``.

Convergence helpers mirror the reference's C utilities:
``residual_norm`` = calculateNorm (``libnmf/calculatenorm.c:44-78``),
``maxchange`` = calculateMaxchange (``libnmf/calculatemaxchange.c:42-71``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, NamedTuple

import torch

from nmfx_torch.config import SolverConfig
from nmfx_torch.device import resolve_device, to_device


class StopReason(enum.IntEnum):
    """Why a restart stopped; the integer values are the reference's, so
    saved results and stop-reason arrays compare across packages."""

    MAX_ITER = 0
    #: per-column argmax of H unchanged for `stable_checks` checks
    CLASS_STABLE = 1
    #: max-change of W and H below TolX
    TOL_X = 2
    #: relative residual decrease below TolFun
    TOL_FUN = 3
    #: projected-gradient norm below tol (pg/alspg)
    PG_TOL = 4
    #: numeric quarantine: the lane's factors went non-finite and it is
    #: masked out of the consensus like a pad lane
    NUMERIC_FAULT = 5
    #: restart screening cut the lane before its exact phase
    SCREENED = 6


class ShardInfo(NamedTuple):
    """Axis names, true dims and collectives of a solver running on one
    shard of a grid group (reference ``ShardInfo``): A is row-sharded
    over ``feature_axis`` and column-sharded over ``sample_axis`` (None:
    that axis is off), W row-sharded, H column-sharded. m-contracted
    terms sum over the feature axis, n-contracted terms over the sample
    axis. ``m_total`` / ``n_total`` are the unsharded (unpadded) dims;
    ``comm`` is the shard's ``nmfx_torch.collectives.ShardComm``."""

    feature_axis: "str | None" = None
    sample_axis: "str | None" = None
    m_total: "int | None" = None
    n_total: "int | None" = None
    comm: Any = None


def shard_reducers(shard: "ShardInfo | None"):
    """``(fsum, ssum)``: the sums over the feature / sample axis when it
    is on, else the identity (reference ``shard_reducers``). One
    definition, so no solver's placement of its sums can drift. Given
    several tensors, each returns their sums as a tuple, from one
    exchange of the collective layer."""
    f_ax = shard.feature_axis if shard is not None else None
    s_ax = shard.sample_axis if shard is not None else None

    def reducer(axis):
        def total(*xs):
            if axis is not None:
                xs = shard.comm.reduce([("sum", x, axis) for x in xs])
            return xs[0] if len(xs) == 1 else tuple(xs)
        return total

    return reducer(f_ax), reducer(s_ax)


class HostReads:
    """The device→host reads a solve's host loops make (``host_syncs``)."""

    def __init__(self):
        self.count = 0

    def any(self, mask: torch.Tensor) -> bool:
        """Whether any lane of ``mask`` is set: one read."""
        self.count += 1
        return bool(mask.any())  # nmfx: ignore[NMFX005] -- the counted read

    def sum(self, mask: torch.Tensor) -> int:
        """How many lanes of ``mask`` are set: one read."""
        self.count += 1
        return int(mask.sum())  # nmfx: ignore[NMFX005] -- the counted read


@dataclasses.dataclass
class State:
    """Loop state. ``w``/``h`` are the current factors, ``w_prev``/
    ``h_prev`` the previous iteration's (for TolX); ``iteration`` is the
    host clock (the iterations done by every lane still running); the
    rest are per-lane device tensors, 0-d or (B,) (``classes`` (…, n))."""

    w: torch.Tensor
    h: torch.Tensor
    w_prev: torch.Tensor
    h_prev: torch.Tensor
    iteration: int
    dnorm: torch.Tensor  # residual at the last check, inf until computed
    classes: torch.Tensor  # (…, n) i32 label snapshot
    stable: torch.Tensor  # i32 consecutive stable checks
    done: torch.Tensor  # bool
    stop_reason: torch.Tensor  # i32 StopReason
    aux: Any
    #: the lanes whose loop condition held when the running block started
    #: (the only lanes whose results the block keeps); None = every lane.
    #: Steps with inner loops run those loops on these lanes only
    active: "torch.Tensor | None" = None
    reads: HostReads = dataclasses.field(default_factory=HostReads)


class SolverResult(NamedTuple):
    """A solve's result: ints for one restart (``solve``), (B,) tensors
    for a batch of lanes (``run_loop_batched``)."""

    w: torch.Tensor
    h: torch.Tensor
    iterations: "int | torch.Tensor"
    dnorm: torch.Tensor  # final ||A - W H||_F / sqrt(m n)
    stop_reason: "int | torch.Tensor"
    #: device→host reads of the loop state
    host_syncs: int = 0


def bf16_products(cfg, device) -> bool:
    """Whether the plain products of a solve under ``cfg`` round their
    operands to bf16: ``matmul_precision="bfloat16"`` as ``nmfx`` applies
    it (``jax.default_matmul_precision``, ``nmfx/solvers/base.py:33-40``),
    the way the TPU applies it, one-pass bf16 operands with float32
    sums. On CUDA only: the CPU ignores the setting, as XLA's CPU backend
    ignores the hint. Float32 only: a float64 solve keeps its operands,
    as ``nmfx``'s own bf16 casts are float32-only
    (``nmfx/ops/sched_mu.py:176-180``, ``packed_mu.py:597-598``)."""
    return (cfg.matmul_precision == "bfloat16" and cfg.dtype == "float32"
            and torch.device(device).type == "cuda")


def bf16_operand(x: torch.Tensor) -> torch.Tensor:
    """A float32 operand rounded to bf16 (round to nearest even) and
    back; any other dtype as it is."""
    if x.dtype != torch.float32:
        return x
    return x.to(torch.bfloat16).to(torch.float32)


def mm(x: torch.Tensor, y: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """``x @ y``, the one helper every plain product under
    ``matmul_precision`` goes through: with ``bf16`` (see
    :func:`bf16_products`) each float32 operand is rounded to bf16 first
    and the product runs in float32 (TF32 stays off,
    ``device.resolve_device``)."""
    if bf16:
        x, y = bf16_operand(x), bf16_operand(y)
    return x @ y


def einsum(eq: str, x: torch.Tensor, y: torch.Tensor,
           bf16: bool = False) -> torch.Tensor:
    """``torch.einsum(eq, x, y)`` with :func:`mm`'s operand rounding."""
    if bf16:
        x, y = bf16_operand(x), bf16_operand(y)
    return torch.einsum(eq, x, y)


def lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Per-lane sum over the last two axes (the reference's ``jnp.sum``
    of a matrix, or ``jnp.vdot`` of two, under vmap)."""
    return x.sum(dim=(-2, -1))


def lane_scalar(x: torch.Tensor) -> torch.Tensor:
    """A per-lane scalar (0-d or (B,)) shaped to broadcast against the
    lanes' matrices."""
    return x[..., None, None]


def _sharded_rms(sq: torch.Tensor, m: int, n: int, shard,
                 what: str) -> torch.Tensor:
    """sqrt(sq / (m n)) of per-lane square sums: under ``shard`` the local
    block's sums add over the grid axes (zero-padded rows and columns
    add exact zeros) and the normalizer takes the unsharded dims."""
    if shard is not None:
        m, n = _true_dims(shard, m, n, what)
        if _sq_axis(shard) is not None:
            sq = shard.comm.sum(sq, _sq_axis(shard))
    return torch.sqrt(sq.clamp(min=0.0) / (m * n))


def _true_dims(shard: "ShardInfo", m: int, n: int, what: str) -> tuple:
    """The RMS normalizer's dims on a grid group: the unsharded count of
    each sharded axis (a ``ValueError`` when it is missing)."""
    if shard.feature_axis is not None:
        if shard.m_total is None:
            raise ValueError(
                f"{what} with feature_axis needs m_total (the "
                "unsharded row count)")
        m = shard.m_total
    if shard.sample_axis is not None:
        if shard.n_total is None:
            raise ValueError(
                f"{what} with sample_axis needs n_total (the "
                "unsharded column count)")
        n = shard.n_total
    return m, n


def _sq_axis(shard: "ShardInfo") -> str:
    """The axis a square sum reduces over: both when both are on."""
    from nmfx_torch.collectives import GRID_AXES

    if shard.feature_axis is not None and shard.sample_axis is not None:
        return GRID_AXES
    return shard.feature_axis or shard.sample_axis


def residual_norm(a: torch.Tensor, w: torch.Tensor,
                  h: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """Per-lane RMS residual ||A - W H||_F / sqrt(m n) (W H through
    :func:`mm`)."""
    m, n = a.shape
    d = a - mm(w, h, bf16)
    return torch.sqrt(lane_sum(d * d) / (m * n))


def residual_norms(a: torch.Tensor, w: torch.Tensor, h: torch.Tensor,
                   bf16: bool = False,
                   chunk: "int | None" = None,
                   shard: "ShardInfo | None" = None) -> torch.Tensor:
    """Per-lane RMS residual ‖A − WᵦHᵦ‖_F/√(mn) from (B, m, k) / (B, k, n)
    factor stacks, the direct way: one reconstruction per lane, at most
    ``chunk`` of them live at once (default: ~80 MB of them, capped at 8);
    ``bf16``: the reconstruction through :func:`mm`'s bf16 operands. The
    last chunk is zero-padded to a full one, so every lane's product and
    sum run at one batch shape whatever the stack's size: on the card a
    batched product or reduction of another batch size may take another
    algorithm, and a restart shard's stack is smaller than the whole.
    Under ``shard`` (reference ``residual_norms_direct`` with
    ``m_total`` / ``n_total``) the local square sums add over the grid
    axes and the normalizer takes the unsharded dims."""
    b, m, _ = w.shape
    n = h.shape[2]
    if chunk is None:
        budget = 80 * 2**20  # bytes of live (chunk, m, n) reconstruction
        chunk = max(1, min(8, budget // (m * n * a.element_size())))
    pad = -b % chunk
    if pad:
        w = torch.cat([w, w.new_zeros((pad,) + tuple(w.shape[1:]))])
        h = torch.cat([h, h.new_zeros((pad,) + tuple(h.shape[1:]))])
    sq = torch.cat([
        ((a[None] - mm(w[i:i + chunk], h[i:i + chunk], bf16)) ** 2
         ).sum(dim=(1, 2))
        for i in range(0, b + pad, chunk)])[:b]
    if shard is not None:
        return _sharded_rms(sq, m, n, shard, "residual_norms_direct")
    return torch.sqrt(sq.clamp(min=0.0) / (m * n))


def _sqrteps(dtype, device) -> torch.Tensor:
    return torch.sqrt(torch.tensor(torch.finfo(dtype).eps, dtype=dtype,
                                   device=device))


def maxchange(mat: torch.Tensor, mat0: torch.Tensor) -> torch.Tensor:
    """Per-lane max|mat - mat0| / (sqrt(eps) + max|mat0|)."""
    diff = (mat - mat0).abs().amax(dim=(-2, -1))
    return diff / (_sqrteps(mat.dtype, mat.device)
                   + mat0.abs().amax(dim=(-2, -1)))


def class_labels(h: torch.Tensor) -> torch.Tensor:
    """Per-sample cluster label = argmax over H's rows (ties to the first
    row, as in the reference)."""
    return torch.argmax(h, dim=-2).to(torch.int32)


def clamp(x: torch.Tensor, zero_threshold: float) -> torch.Tensor:
    """Zero out negatives and sub-threshold values (reference
    ZERO_THRESHOLD clamp)."""
    return torch.where(x <= zero_threshold, 0.0, x)


def solve_gram_reg(gram: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Cholesky-solve ``(gram + λI) x = rhs`` per lane, with the
    reference's trace-scaled Tikhonov jitter λ = 10·eps·trace/k (plus
    the dtype's tiny), batched over leading axes. Unlike JAX's,
    ``torch.linalg.cholesky`` raises on a matrix that is not positive
    definite; here the factorization reports it per lane and that lane's
    solution is NaN, so the numeric quarantine stops it as in the
    reference (``nmfx/solvers/base.py:183-196``)."""
    k = gram.shape[-1]
    fin = torch.finfo(gram.dtype)
    lam = 10 * fin.eps * (gram.diagonal(dim1=-2, dim2=-1).sum(-1) / k)
    eye = torch.eye(k, dtype=gram.dtype, device=gram.device)
    u, info = torch.linalg.cholesky_ex(
        gram + lane_scalar(lam + fin.tiny) * eye, upper=True)
    x = torch.cholesky_solve(rhs, u, upper=True)
    return torch.where(lane_scalar(info != 0), torch.nan, x)


def check_convergence(state: State, cfg, *, a=None,
                      use_class: bool = False, use_tolx: bool = False,
                      use_tolfun: bool = False,
                      shard: "ShardInfo | None" = None) -> State:
    """The generic convergence tests after a step (reference
    ``check_convergence``), per lane. They run at every
    ``check_every``-th iteration after the first, on a lane not yet done:
    numeric quarantine first, then class stability, TolX and TolFun. The
    check gate is the host clock; the rest stays on the device.

    Under ``shard`` every test reaches the same global decision on each
    shard of the grid group: the non-finite flags or over each factor's
    axis, label mismatches sum over the sample axis (the flip budget
    from ``n_total``), the max-changes reduce over the axis each factor
    is sharded on, the residual sums over both."""
    it = state.iteration
    if not (it > 1 and it % cfg.check_every == 0):
        return state
    is_check = ~state.done
    done = state.done
    reason = state.stop_reason
    use_tolx = use_tolx and cfg.use_tol_checks
    use_tolfun = use_tolfun and cfg.use_tol_checks
    glob = (_sharded_check_terms(state, cfg, a, use_class, use_tolx,
                                 use_tolfun, shard)
            if shard is not None else {})

    if cfg.nonfinite_guard:
        bad = glob.get("bad")
        if bad is None:
            bad = ~(torch.isfinite(state.w).all(dim=-1).all(dim=-1)
                    & torch.isfinite(state.h).all(dim=-1).all(dim=-1))
        faulted = is_check & bad
        done = done | faulted
        is_check = is_check & ~faulted
        reason = torch.where(faulted, int(StopReason.NUMERIC_FAULT), reason)

    classes, stable = state.classes, state.stable
    if use_class:
        # the noise-tolerant snapshot rule (see SolverConfig.class_flip_tol)
        new_classes = class_labels(state.h)
        if "mism" in glob:
            n_glob, mism = shard.n_total, glob["mism"]
        else:
            n_glob = new_classes.shape[-1]
            mism = (new_classes != state.classes).sum(dim=-1,
                                                      dtype=torch.int32)
        flip_tol = int(cfg.class_flip_tol * n_glob + 1e-9)
        same = mism <= flip_tol
        stable = torch.where(is_check, torch.where(same, state.stable + 1, 0),
                             state.stable).to(torch.int32)
        classes = torch.where((is_check & ~same)[..., None], new_classes,
                              state.classes)
        hit = is_check & (stable >= cfg.stable_checks)
        done = done | hit
        reason = torch.where(hit, int(StopReason.CLASS_STABLE), reason)

    if use_tolx:
        delta = glob.get("delta")
        if delta is None:
            delta = torch.maximum(maxchange(state.w, state.w_prev),
                                  maxchange(state.h, state.h_prev))
        hit = is_check & (delta < cfg.tol_x) & ~done
        done = done | hit
        reason = torch.where(hit, int(StopReason.TOL_X), reason)

    dnorm = state.dnorm
    if use_tolfun:
        new_dnorm = glob.get("dnorm")
        if new_dnorm is None:
            new_dnorm = residual_norm(a, state.w, state.h,
                                      bf16_products(cfg, a.device))
        hit = (is_check & torch.isfinite(state.dnorm)
               & (state.dnorm - new_dnorm <= cfg.tol_fun * state.dnorm)
               & ~done)
        dnorm = torch.where(is_check, new_dnorm, state.dnorm)
        done = done | hit
        reason = torch.where(hit, int(StopReason.TOL_FUN), reason)

    return dataclasses.replace(state, classes=classes, stable=stable,
                               done=done, stop_reason=reason.to(torch.int32),
                               dnorm=dnorm)


def _sharded_check_terms(state: State, cfg, a, use_class: bool,
                         use_tolx: bool, use_tolfun: bool,
                         shard: "ShardInfo") -> dict:
    """A grid shard's check terms, global, from one exchange: the
    non-finite flags or over each factor's axis ("bad"), the label
    mismatches sum over the samples ("mism"), each factor's max-change
    a ratio of its global maxima ("delta"), the residual's square sums
    over both axes ("dnorm")."""
    f_ax, s_ax = shard.feature_axis, shard.sample_axis
    items, keys = [], []

    def want(key, op, x, axis):
        if axis is not None:
            items.append((op, x, axis))
            keys.append(key)
        return x

    local = {}
    if cfg.nonfinite_guard:
        local["bad_w"] = want("bad_w", "any", ~torch.isfinite(state.w).all(
            dim=-1).all(dim=-1), f_ax)
        local["bad_h"] = want("bad_h", "any", ~torch.isfinite(state.h).all(
            dim=-1).all(dim=-1), s_ax)
    if use_class and s_ax is not None:
        if shard.n_total is None:
            raise ValueError(
                "class-stability check with sample_axis needs n_total "
                "(the unsharded column count); the local shard width "
                "would make the flip tolerance ~#shards too strict")
        want("mism", "sum", (class_labels(state.h) != state.classes).sum(
            dim=-1, dtype=torch.int32), s_ax)
    if use_tolx:
        for f, (cur, prev), ax in (("w", (state.w, state.w_prev), f_ax),
                                   ("h", (state.h, state.h_prev), s_ax)):
            local["diff_" + f] = want("diff_" + f, "max", (cur - prev).abs()
                                      .amax(dim=(-2, -1)), ax)
            local["ref_" + f] = want("ref_" + f, "max",
                                     prev.abs().amax(dim=(-2, -1)), ax)
    m, n = a.shape if a is not None else (0, 0)
    if use_tolfun:
        d = a - mm(state.w, state.h, bf16_products(cfg, a.device))
        m, n = _true_dims(shard, m, n, "residual_norm")
        want("sq", "sum", lane_sum(d * d), _sq_axis(shard))
    local.update(zip(keys, shard.comm.reduce(items) if items else ()))
    out = {}
    if cfg.nonfinite_guard:
        out["bad"] = local["bad_w"] | local["bad_h"]
    if "mism" in local:
        out["mism"] = local["mism"]
    if use_tolx:
        sqrteps = _sqrteps(state.w.dtype, state.w.device)
        out["delta"] = torch.maximum(
            local["diff_w"] / (sqrteps + local["ref_w"]),
            local["diff_h"] / (sqrteps + local["ref_h"]))
    if use_tolfun:
        out["dnorm"] = torch.sqrt(local["sq"].clamp(min=0.0) / (m * n))
    return out


def init_state(a: torch.Tensor, w0: torch.Tensor, h0: torch.Tensor,
               aux: Any) -> State:
    dev = w0.device
    lanes = tuple(w0.shape[:-2])
    return State(
        w=w0, h=h0, w_prev=w0, h_prev=h0, iteration=0,
        dnorm=torch.full(lanes, float("inf"), dtype=w0.dtype, device=dev),
        classes=torch.full(lanes + (h0.shape[-1],), -1, dtype=torch.int32,
                           device=dev),
        stable=torch.zeros(lanes, dtype=torch.int32, device=dev),
        done=torch.zeros(lanes, dtype=torch.bool, device=dev),
        stop_reason=torch.full(lanes, int(StopReason.MAX_ITER),
                               dtype=torch.int32, device=dev),
        aux=aux)


def keep_lanes(mask: torch.Tensor, new, old):
    """``new`` where ``mask`` (one flag a lane) is set, else ``old``, for a
    tensor or a (named) tuple of them; a value shared by every lane (a
    tensor of fewer axes than the mask, or the same object on both sides)
    passes through."""
    if new is old:
        return new
    if isinstance(new, tuple):
        parts = [keep_lanes(mask, x, y) for x, y in zip(new, old)]
        return type(new)(*parts) if hasattr(new, "_fields") else tuple(parts)
    extra = new.dim() - mask.dim()
    if extra < 0:
        return new
    return torch.where(mask.reshape(mask.shape + (1,) * extra), new, old)


_LANE_FIELDS = ("w", "h", "w_prev", "h_prev", "dnorm", "classes", "stable",
                "done", "stop_reason", "aux")


def run_loop_batched(a, w0, h0, cfg, step_fn, aux,
                     shard: "ShardInfo | None" = None) -> SolverResult:
    """Drive ``step_fn`` over a batch of lanes (the counterpart of
    ``jax.vmap(run_loop)``): blocks of ``check_every`` iterations whose
    last one runs the tests, while any lane is running and the block fits
    under ``max_iter``; then, if ``max_iter`` is not a multiple of
    ``check_every``, the last few iterations one at a time (each
    checked). Each block runs on every lane; a lane done at the block's
    start keeps its state (``keep_lanes``). One read of the running lanes'
    count a block. Factors may be (B, m, k) / (B, k, n) or one restart's
    (m, k) / (k, n). ``shard``: the step has the same ShardInfo bound
    (its collectives make every decision the same on each shard of the
    grid group, so the host loops stay in lockstep); here it scopes the
    final residuals of (B, m, k) / (B, k, n) lanes."""
    state = init_state(a, w0, h0, aux)
    reads = state.reads
    iters = torch.zeros(state.done.shape, dtype=torch.int32,
                        device=w0.device)

    def run_block(state: State, steps: int, n_live: int):
        running = ~state.done
        part = n_live < running.numel()
        start = state
        state = dataclasses.replace(state, active=running if part else None)
        for i in range(steps):
            state = dataclasses.replace(state, w_prev=state.w,
                                        h_prev=state.h,
                                        iteration=state.iteration + 1)
            state = step_fn(a, state, cfg, i == steps - 1)
        if part:
            state = dataclasses.replace(state, **{
                f: keep_lanes(running, getattr(state, f), getattr(start, f))
                for f in _LANE_FIELDS})
        return dataclasses.replace(state, active=None), torch.where(
            running, state.iteration, iters)

    n_live = state.done.numel()  # nothing is done before the first block
    while n_live and state.iteration + cfg.check_every <= cfg.max_iter:
        state, iters = run_block(state, cfg.check_every, n_live)
        n_live = reads.sum(~state.done)
    while n_live and state.iteration < cfg.max_iter:
        state, iters = run_block(state, 1, n_live)
        n_live = reads.sum(~state.done)
    bf16 = bf16_products(cfg, a.device)
    # the final residuals at one batch shape whatever the lane count (a
    # restart shard's lanes are fewer than the whole batch's)
    dnorm = (residual_norms(a, state.w, state.h, bf16, shard=shard)
             if state.w.dim() == 3
             else residual_norm(a, state.w, state.h, bf16))
    return SolverResult(w=state.w, h=state.h, iterations=iters,
                        dnorm=dnorm,
                        stop_reason=state.stop_reason,
                        host_syncs=reads.count)


def run_loop(a, w0, h0, cfg, step_fn, aux) -> SolverResult:
    """One restart's solve: :func:`run_loop_batched` on (m, k) / (k, n)
    factors, with the iterations and stop reason as ints."""
    res = run_loop_batched(a, w0, h0, cfg, step_fn, aux)
    return res._replace(iterations=int(res.iterations),
                        stop_reason=int(res.stop_reason))


_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def solve(a, w0, h0, cfg=None, *, device=None) -> SolverResult:
    """Factorize A ≈ W·H from (W0, H0) with the configured algorithm
    (reference ``solve``): any of the eight update rules.

    Plain PyTorch products on ``device`` (None = CUDA, raising if there is
    none; TF32 off there), in ``cfg.dtype``: "float32" or "float64";
    under ``matmul_precision="bfloat16"`` through :func:`mm`'s bf16
    operands on CUDA.
    ``a``, ``w0``, ``h0`` are numpy arrays or tensors.
    """
    from nmfx_torch.solvers import SOLVERS  # imports this module

    cfg = SolverConfig() if cfg is None else cfg
    if cfg.backend == "sketched" or cfg.screen:
        # the compressed engine draws per-restart projections from a key
        # this signature does not carry, and screening ranks a pool
        raise ValueError(
            "solve() runs the exact engines; backend='sketched' needs "
            "a per-restart key (use nmfx_torch.solvers.sketched."
            "solve_sketched — nmf()/restart_factors() route there "
            "automatically) and screen=True only exists at the sweep "
            "layer")
    if cfg.tile_rows is not None:
        # this signature takes the whole A; the out-of-core streaming
        # loop lives at the sweep layer
        raise ValueError(
            "tile_rows streams A from host through nmfx_torch.tiles; "
            "solve() is the in-core single-restart engine (sweep() routes "
            "tiled configs automatically)")
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {tuple(_DTYPES)}, got "
                         f"{cfg.dtype!r}")
    dev = resolve_device(device)
    dtype = _DTYPES[cfg.dtype]
    a, w0, h0 = (to_device(x, dtype, dev) for x in (a, w0, h0))
    mod = SOLVERS[cfg.algorithm]
    return run_loop(a, w0, h0, cfg, mod.step, mod.init_aux(a, w0, h0, cfg))
