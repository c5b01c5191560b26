"""The restart-packed MU kernels: hand-written CUDA and their plain
PyTorch versions (counterpart of ``nmfx/ops/pallas_mu.py``).

* ``fused_h_update``: Hp ← ep(Hp, WpᵀA, (WpᵀWp ∘ B)·Hp)
* ``lane_gram``: gh = each lane's k×k block of Hp·Hpᵀ, the masked H-Gram
  bd_select(Hp·Hpᵀ) keeps
* ``fused_w_update``: Wp ← ep(Wp, A·Hpᵀ, Wp·gh)
* ``fused_block_iterations``: ``iters · check_block`` full MU iterations
  of the slot scheduler's packed pool in one call, with lane freezes,
  the per-lane iteration budget, per-boundary TolX stats and H
  snapshots, in the phased order (``fused=False``) or the
  join-the-updates order (``fused=True``, byte-equal outputs)
* ``hals_block_iterations``: the same for HALS coordinate sweeps

where B is the block-diagonal restart mask and ep the mu epilogue
(``nmfx_torch.solvers.mu._mu_update``). The kernels live in
``nmfx_torch/csrc/block_mu.cu`` (the MU block, and the per-iteration
pair with ``lane_gram`` between its halves, which launches one block
iteration's kernels: one call each of ``fused_h_update``, ``lane_gram``
and ``fused_w_update`` is byte-equal to ``fused_block_iterations(iters=1)``
with no lane frozen) and
``nmfx_torch/csrc/hals_block.cu``, built at first use
(``nmfx_torch.ops._build``); their design notes sit at the top of those
files.

Options, as the reference's Pallas kernels take them:

* ``matmul_precision="bfloat16"`` (every kernel): each product operand is
  rounded to bf16 where the reference casts it (``_maybe_cast``), the
  sums stay float32. On the card A is loaded as bf16 (a float32 A is
  cast once per call; the scheduler and the per-rank route cast it once
  per solve). ``torch.set_float32_matmul_precision`` is not this: it
  would change library products only, and round otherwise.
* bf16 pool factors (the block kernels): a bfloat16 ``wp`` (and ``hp``)
  is read, iterated in float32, and each stored factor rounded to bf16
  where the reference stores it; outputs come back in the inputs'
  dtypes, the stats and snapshots in float32.
* ``seg_ids`` (the mu block kernel): per-column segment (job) ids of the
  ragged class-blocked pool, each id a run of consecutive columns; the
  Grams keep the pairs of one segment. None = the uniform pool's
  ``iota // k``.
* ``alias_io`` (the block kernels): the outputs are ``wp`` and ``hp``
  themselves, updated in place; the values are those of the unaliased
  call.

A wrapper given CPU tensors runs the plain version (``*_ref``), which
computes the full masked Grams (or, for HALS, the dense per-lane sweeps)
as the reference's engines do. Given CUDA tensors it launches its kernel
or raises; it never falls back. ``LAUNCHES`` counts the launches of each
kernel (never the plain runs); the two orders of the MU block kernel
count apart.
"""

from __future__ import annotations

import numpy as np
import torch

from nmfx_torch.solvers.hals import hals_h_sweep_from, hals_w_sweep_from
from nmfx_torch.solvers.mu import _mu_update

#: kernel launches, incremented only where a kernel launches
LAUNCHES = {"fused_h_update": 0, "lane_gram": 0, "fused_w_update": 0,
            "fused_block_iterations": 0, "fused_block_iterations_fused": 0,
            "hals_block_iterations": 0}


def reset_launch_counts() -> None:
    """Every kernel's count to 0; the option variants' counts
    (``name[tag]``) go until a variant launches again."""
    for name in list(LAUNCHES):
        if "[" in name:
            del LAUNCHES[name]
        else:
            LAUNCHES[name] = 0


def _count(name: str, *tags) -> None:
    """One launch of kernel ``name``, and of each option variant it ran
    (``name[tag]`` for each tag that is not None: "bf16" operands, the
    pool's "bfloat16" / "bfloat16_w" factors, "seg_ids", "alias_io")."""
    LAUNCHES[name] += 1
    for tag in tags:
        if tag is not None:
            key = f"{name}[{tag}]"
            LAUNCHES[key] = LAUNCHES.get(key, 0) + 1


def _pool_tag(wp, hp):
    if wp.dtype != torch.bfloat16:
        return None
    return "bfloat16" if hp.dtype == torch.bfloat16 else "bfloat16_w"


#: the C entries' ``flags``: bf16 operands, bf16 pool W, bf16 pool H
BF16_OPERANDS, BF16_W, BF16_H = 1, 2, 4


def _bf16_operands(matmul_precision: str) -> bool:
    if matmul_precision not in ("default", "highest", "bfloat16"):
        raise ValueError(
            "matmul_precision must be 'default', 'bfloat16' or 'highest', "
            f"got {matmul_precision!r}")
    return matmul_precision == "bfloat16"


def _work(x: torch.Tensor) -> torch.Tensor:
    """x in the plain versions' working dtype: a bf16 tensor as float32,
    float32 and float64 (the card checks' exact reference) as they are."""
    return x if x.dtype in (torch.float32, torch.float64) else x.to(
        torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (round to nearest even), in its working dtype."""
    return x.to(torch.bfloat16).to(_work(x).dtype)


def _exponent(x: torch.Tensor) -> torch.Tensor:
    """floor(log2 |x|) of nonzero x (float64), as int64."""
    return torch.frexp(x).exponent.to(torch.int64) - 1


def _toward_zero_f32(x: torch.Tensor) -> torch.Tensor:
    """float64 x rounded toward zero to float32."""
    y = x.to(torch.float32)
    over = y.to(torch.float64).abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def tensor_core_products(x: torch.Tensor, y: torch.Tensor,
                         split: "int | None" = None,
                         rows: int = 512) -> torch.Tensor:
    """x (M, K) @ y (K, N) of bf16 values, summed as the card's bf16
    product tiles sum them (``csrc/block_gemm.cuh``), in float32: each
    output a sum from +0 over K steps of 16 in order, each step added with
    one float32 add. A step aligns its 16 exact products to the largest
    exponent among them (a product's is the sum of its operands'),
    truncates each to a multiple of 2^(emax - 25), adds them exactly and
    truncates the sum to float32. ``split``: the sum restarts every
    ``split`` of K and the partials are added in float32 in order (the H
    numerator's SPLIT_ROWS chunks). ``rows``: rows of x a pass."""
    xd, yd = x.to(torch.float64), y.to(torch.float64)
    kdim = xd.shape[1]
    split = split or max(kdim, 1)
    ey = _exponent(yd)
    out = torch.zeros((xd.shape[0], yd.shape[1]), dtype=torch.float32,
                      device=xd.device)
    for r0 in range(0, xd.shape[0], rows):
        xr = xd[r0:r0 + rows]
        ex = _exponent(xr)
        total = torch.zeros_like(out[r0:r0 + rows])
        for s0 in range(0, kdim, split):
            acc = torch.zeros_like(total)
            for k0 in range(s0, min(s0 + split, kdim), 16):
                k1 = min(k0 + 16, s0 + split, kdim)
                p = xr[:, k0:k1, None] * yd[None, k0:k1]
                e = torch.where(p != 0, ex[:, k0:k1, None] + ey[None, k0:k1],
                                -2000)
                q = torch.exp2((e.amax(dim=1) - 25).clamp(min=-1000).to(
                    torch.float64))
                acc = acc + _toward_zero_f32(
                    torch.trunc(p / q[:, None]).sum(dim=1) * q)
            total = total + acc
        out[r0:r0 + rows] = total
    return out


def _numer_product(x: torch.Tensor, y: torch.Tensor,
                   split: "int | None" = None) -> torch.Tensor:
    """The mu plain versions' numerator products, Wpᵀ·A (``split``: the
    kernels' SPLIT_ROWS) and A·Hpᵀ: a matmul in the operands' dtype. A
    check that holds a card's bf16 trajectory bit for bit sets this to
    :func:`tensor_core_products`, the tiles' own sum."""
    return x @ y


def _operand(matmul_precision: str):
    """The plain versions' operand cast: the working dtype, rounded to
    bf16 under ``matmul_precision="bfloat16"`` (the reference's
    ``_maybe_cast``)."""
    if _bf16_operands(matmul_precision):
        return round_bf16
    return _work


def _lane_mask(rk: int, k: int, device) -> torch.Tensor:
    lane = torch.arange(rk, device=device) // k
    return lane[:, None] == lane[None, :]


def _seg_mask(seg_ids, rk: int, k: int, device) -> torch.Tensor:
    """The same-segment mask seg[c] == seg[c'] (the uniform pool's when
    ``seg_ids`` is None)."""
    if seg_ids is None:
        return _lane_mask(rk, k, device)
    seg = torch.as_tensor(np.asarray(seg_ids) if not torch.is_tensor(
        seg_ids) else seg_ids, device=device).reshape(rk)
    return seg[:, None] == seg[None, :]


def fused_h_update_ref(a, wp, hp, *, k: int, eps: float = 1e-9,
                       zero_threshold: float = 0.0,
                       matmul_precision: str = "default") -> torch.Tensor:
    """Plain version of :func:`fused_h_update` (full masked W-Gram)."""
    op = _operand(matmul_precision)
    wc = op(wp)
    gram = torch.where(_lane_mask(wp.shape[1], k, wp.device), wc.T @ wc,
                       torch.zeros((), dtype=wc.dtype, device=wp.device))
    return _mu_update(hp, _numer_product(wc.T, op(a), SPLIT_ROWS),
                      op(gram) @ op(hp), eps, zero_threshold)


def _lane_blocks(g: torch.Tensor, k: int) -> torch.Tensor:
    """(rk/k, k, k), contiguous: the lanes' diagonal k×k blocks of an
    (rk, rk) matrix."""
    r = g.shape[0] // k
    return torch.diagonal(g.reshape(r, k, r, k), dim1=0,
                          dim2=2).permute(2, 0, 1).contiguous()


def lane_gram_ref(hp, *, k: int,
                  matmul_precision: str = "default") -> torch.Tensor:
    """Plain version of :func:`lane_gram`: the diagonal blocks of the full
    product, the blocks bd_select(Hp·Hpᵀ) keeps."""
    hc = _operand(matmul_precision)(hp)
    return _lane_blocks(hc @ hc.T, k)


def fused_w_update_ref(a, wp, hp, gh, *, k: int, eps: float = 1e-9,
                       zero_threshold: float = 0.0,
                       matmul_precision: str = "default") -> torch.Tensor:
    """Plain version of :func:`fused_w_update`: the full product with the
    masked (rk, rk) H-Gram (a per-lane ``gh`` laid out block-diagonally
    first)."""
    if gh.dim() == 3:
        gh = torch.block_diag(*gh)
    op = _operand(matmul_precision)
    return _mu_update(wp, _numer_product(op(a), op(hp).T),
                      op(wp) @ op(gh), eps, zero_threshold)


def _check_operands(name: str, k: int, dtypes=None, **shapes) -> None:
    """Device, dtype, shape and contiguity checks before any pointer goes
    to the kernel; ``shapes`` maps operand name → (tensor, shape), with
    rk from ``wp`` or else ``hp`` (k = 0: rk need not be a multiple of
    k); ``dtypes`` maps an operand to the dtypes it may have (default
    float32)."""
    rk = shapes["wp"][1][1] if "wp" in shapes else shapes["hp"][1][0]
    if k < 0 or (k and rk % k):
        raise ValueError(f"{name}: rk={rk} is not a multiple of k={k}")
    dtypes = dtypes or {}
    ref_device = None
    for arg, (t, shape) in shapes.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, not CUDA")
        if ref_device is None:
            ref_device = t.device
        elif t.device != ref_device:
            raise ValueError(f"{name}: operands on {ref_device} and "
                             f"{t.device}")
        allowed = dtypes.get(arg, (torch.float32,))
        if t.dtype not in allowed:
            names = " or ".join(str(d).removeprefix("torch.")
                                for d in allowed)
            raise TypeError(f"{name}: {arg} must be {names}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _kernel_a(name: str, a, bf: bool):
    """A as a kernel takes it: bfloat16 under bf16 operands (a float32 A
    is cast here, once per call), else float32."""
    if bf:
        return a.to(torch.bfloat16) if a.dtype == torch.float32 else a
    if a.dtype == torch.bfloat16:
        raise TypeError(f"{name}: a bfloat16 A needs "
                        "matmul_precision='bfloat16'")
    return a


_A_DTYPES = (torch.float32, torch.bfloat16)


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


def _pair_library(name: str):
    from nmfx_torch.ops import _build

    lib = _build.load("block_mu")
    _check_library_rows(lib, name, "nmfx_block_split_rows", SPLIT_ROWS)
    return lib


def _ptr(t) -> "int | None":
    return None if t is None else t.data_ptr()


def fused_h_update(a, wp, hp, *, k: int, eps: float = 1e-9,
                   zero_threshold: float = 0.0,
                   matmul_precision: str = "default") -> torch.Tensor:
    """Hp ← mu_epilogue(Hp, WpᵀA, (WpᵀWp ∘ B)·Hp). A (m, n), Wp (m, rk),
    Hp (rk, n), float32 (A bfloat16 under bf16 operands), contiguous, on
    one CUDA device."""
    bf = _bf16_operands(matmul_precision)
    if a.device.type == "cpu":
        return fused_h_update_ref(a, wp, hp, k=k, eps=eps,
                                  zero_threshold=zero_threshold,
                                  matmul_precision=matmul_precision)
    a = _kernel_a("fused_h_update", a, bf)
    m, n = a.shape
    rk = wp.shape[1]
    _check_operands("fused_h_update", k, {"a": _A_DTYPES}, a=(a, (m, n)),
                    wp=(wp, (m, rk)), hp=(hp, (rk, n)))
    lib = _pair_library("fused_h_update")
    out = torch.empty((rk, n), dtype=torch.float32, device=a.device)
    part, gpart = (torch.empty(shape, dtype=torch.float32, device=a.device)
                   for shape in pair_workspace(m, n, rk, k))
    wb = (torch.empty((m, rk), dtype=torch.bfloat16, device=a.device)
          if bf else None)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.nmfx_fused_h_update(
        a.data_ptr(), wp.data_ptr(), hp.data_ptr(), out.data_ptr(),
        part.data_ptr(), gpart.data_ptr(), _ptr(wb), m, n, rk, k,
        BF16_OPERANDS if bf else 0, eps, zero_threshold, stream)
    _raise_on("fused_h_update", rc)
    _count("fused_h_update", "bf16" if bf else None)
    return out


def lane_gram(hp, *, k: int, matmul_precision: str = "default"
              ) -> torch.Tensor:
    """gh (rk/k, k, k): each lane's k×k block of Hp·Hpᵀ, the masked H-Gram
    that :func:`fused_w_update` reads. Hp (rk, n) float32, contiguous."""
    bf = _bf16_operands(matmul_precision)
    if hp.device.type == "cpu":
        return lane_gram_ref(hp, k=k, matmul_precision=matmul_precision)
    rk, n = hp.shape
    _check_operands("lane_gram", k, hp=(hp, (rk, n)))
    lib = _pair_library("lane_gram")
    gh = torch.empty((rk // k, k, k), dtype=torch.float32, device=hp.device)
    stream = torch.cuda.current_stream(hp.device).cuda_stream
    rc = lib.nmfx_lane_gram(hp.data_ptr(), gh.data_ptr(), n, rk, k,
                            BF16_OPERANDS if bf else 0, stream)
    _raise_on("lane_gram", rc)
    _count("lane_gram", "bf16" if bf else None)
    return gh


def fused_w_update(a, wp, hp, gh, *, k: int, eps: float = 1e-9,
                   zero_threshold: float = 0.0,
                   matmul_precision: str = "default") -> torch.Tensor:
    """Wp ← mu_epilogue(Wp, A·Hpᵀ, Wp·gh), gh the new Hp's masked H-Gram:
    :func:`lane_gram`'s (rk/k, k, k), or the (rk, rk) block-diagonal
    matrix the reference takes, of which only each lane's diagonal block
    is read."""
    bf = _bf16_operands(matmul_precision)
    if a.device.type == "cpu":
        return fused_w_update_ref(a, wp, hp, gh, k=k, eps=eps,
                                  zero_threshold=zero_threshold,
                                  matmul_precision=matmul_precision)
    a = _kernel_a("fused_w_update", a, bf)
    m, n = a.shape
    rk = wp.shape[1]
    dense = gh.dim() == 2
    _check_operands("fused_w_update", k, {"a": _A_DTYPES}, a=(a, (m, n)),
                    wp=(wp, (m, rk)), hp=(hp, (rk, n)),
                    gh=(gh, (rk, rk) if dense else (rk // k, k, k)))
    if dense:
        gh = _lane_blocks(gh, k)
    lib = _pair_library("fused_w_update")
    out = torch.empty((m, rk), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.nmfx_fused_w_update(
        a.data_ptr(), wp.data_ptr(), hp.data_ptr(), gh.data_ptr(),
        out.data_ptr(), m, n, rk, k, BF16_OPERANDS if bf else 0, eps,
        zero_threshold, stream)
    _raise_on("fused_w_update", rc)
    _count("fused_w_update", "bf16" if bf else None)
    return out


def _need_budget(check_block, budget_cols) -> None:
    if check_block > 1 and budget_cols is None:
        raise ValueError("check_block > 1 needs budget_cols (each lane's "
                         "remaining iteration allowance at launch entry)")


def _storage(t: torch.Tensor):
    """How the pool stores a factor of t's dtype: bf16 rounding for a
    bfloat16 pool factor, else unchanged."""
    if t.dtype == torch.bfloat16:
        return round_bf16
    return lambda x: x


def _block_ref(update, a, wp, hp, frozen_cols, *, iters, check_block,
               budget_cols, alias_io=False, factor_dtype=None):
    """The launch bookkeeping the plain block versions share: the lane
    freezes and budget fence, then per-boundary stats and snapshots
    around ``update(w, h, frozen, store_h) -> (wn, hn)`` (one iteration,
    frozen rows and columns kept, before the storage rounding; the W half
    reads ``store_h(hn)``). Factors work in float32; a bf16 pool factor
    is rounded to bf16 at every store, the stats compare the unrounded
    update with the stored factor, the snapshots are the stored H, and
    the outputs come back in the inputs' dtypes. With ``alias_io`` they
    are written into ``wp`` and ``hp``. ``factor_dtype`` ("bfloat16" or
    "bfloat16_w") rounds the stored factors so whatever the inputs'
    dtypes (a float64 reference of a bf16 pool)."""
    _need_budget(check_block, budget_cols)
    rk, n = hp.shape
    store_w = round_bf16 if factor_dtype else _storage(wp)
    store_h = round_bf16 if factor_dtype == "bfloat16" else _storage(hp)
    frozen = frozen_cols.reshape(rk) > 0
    budget = None if check_block == 1 else budget_cols.reshape(rk)
    f32 = dict(dtype=torch.float32, device=a.device)
    wd = torch.zeros((check_block, rk), **f32)
    wm = torch.zeros((check_block, rk), **f32)
    hd = torch.zeros((check_block * rk, 1), **f32)
    hm = torch.zeros((check_block * rk, 1), **f32)
    h_checks = (torch.zeros((check_block, rk, n), **f32)
                if check_block > 1 else None)
    w, h = _work(wp), _work(hp)
    for it in range(iters * check_block):
        fr = frozen if budget is None else frozen | (budget <= it)
        wn, hn = update(w, h, fr, store_h)
        if (it + 1) % iters == 0:
            b = (it + 1) // iters - 1
            rows = slice(b * rk, (b + 1) * rk)
            hd[rows, 0] = (hn - h).abs().amax(dim=1)
            hm[rows, 0] = h.abs().amax(dim=1)
            wd[b] = (wn - w).abs().amax(dim=0)
            wm[b] = w.abs().amax(dim=0)
            if h_checks is not None:
                h_checks[b] = store_h(hn)
        w, h = store_w(wn), store_h(hn)
    w, h = w.to(wp.dtype), h.to(hp.dtype)
    if alias_io:
        wp.copy_(w)
        hp.copy_(h)
        w, h = wp, hp
    out = (w, h, wd, wm, hd, hm)
    return out if h_checks is None else out + (h_checks,)


def fused_block_iterations_ref(a, wp, hp, frozen_cols, *, k: int,
                               iters: int = 2, eps: float = 1e-9,
                               zero_threshold: float = 0.0,
                               check_block: int = 1, budget_cols=None,
                               matmul_precision: str = "default",
                               seg_ids=None, alias_io: bool = False,
                               factor_dtype=None):
    """Plain version of :func:`fused_block_iterations` (either order):
    the same masks, fences, stats and snapshots, with full masked
    Grams (``factor_dtype``: see ``_block_ref``)."""
    op = _operand(matmul_precision)
    bd = _seg_mask(seg_ids, hp.shape[0], k, a.device)
    zero = torch.zeros((), dtype=torch.float32, device=a.device)
    ac = op(a)

    def update(w, h, fr, store_h):
        wc = op(w)
        gram = torch.where(bd, wc.T @ wc, zero)
        hn = _mu_update(h, _numer_product(wc.T, ac, SPLIT_ROWS),
                        op(gram) @ op(h), eps, zero_threshold)
        hn = torch.where(fr[:, None], h, hn)
        hc = op(hn)
        gh = torch.where(bd, hc @ hc.T, zero)
        wn = _mu_update(w, _numer_product(ac, op(store_h(hn)).T),
                        op(w) @ op(gh), eps, zero_threshold)
        return torch.where(fr[None, :], w, wn), hn

    return _block_ref(update, a, wp, hp, frozen_cols, iters=iters,
                      check_block=check_block, budget_cols=budget_cols,
                      alias_io=alias_io, factor_dtype=factor_dtype)


def hals_block_iterations_ref(a, wp, hp, frozen_cols, *, k: int,
                              slots: int, iters: int = 2, eps: float = 1e-9,
                              zero_threshold: float = 0.0,
                              check_block: int = 1, budget_cols=None,
                              matmul_precision: str = "default",
                              alias_io: bool = False, factor_dtype=None):
    """Plain version of :func:`hals_block_iterations`: the dense per-lane
    sweeps of ``grid_mu.hals_block`` on the pool's (S, m, k) / (S, k, n)
    views, with the block kernel's masks, fences, stats and snapshots;
    under bf16 operands only the products' operands are rounded (the
    sweeps stay float32, as in the reference)."""
    _check_slots(wp.shape[1], k, slots)
    m, rk = wp.shape
    n = hp.shape[1]
    op = _operand(matmul_precision)
    ac = op(a)

    def lanes_w(w):  # (m, rk) → (S, m, k)
        return w.reshape(m, slots, k).permute(1, 0, 2)

    def update(w, h, fr, store_h):
        wc = lanes_w(op(w))
        hn = hals_h_sweep_from(torch.einsum("bmk,mn->bkn", wc, ac),
                               torch.einsum("bmk,bml->bkl", wc, wc),
                               h.reshape(slots, k, n), eps,
                               zero_threshold).reshape(rk, n)
        hn = torch.where(fr[:, None], h, hn)
        hc = op(hn).reshape(slots, k, n)
        hs = op(store_h(hn)).reshape(slots, k, n)
        wn = hals_w_sweep_from(torch.einsum("mn,bkn->bmk", ac, hs),
                               torch.einsum("bkn,bln->bkl", hc, hc),
                               lanes_w(w), eps, zero_threshold)
        wn = wn.permute(1, 0, 2).reshape(m, rk)
        return torch.where(fr[None, :], w, wn), hn

    return _block_ref(update, a, wp, hp, frozen_cols, iters=iters,
                      check_block=check_block, budget_cols=budget_cols,
                      alias_io=alias_io, factor_dtype=factor_dtype)


def _check_slots(rk: int, k: int, slots: int) -> None:
    if rk != k * slots:
        raise ValueError(f"packed width {rk} != k*slots = {k}*{slots}")


#: rows of A per split of the block kernels' H numerator (SPLIT_ROWS,
#: ``csrc/block_common.cuh``), rows per W tile of both block kernels
#: (WBM, ``csrc/block_gemm.cuh``) and columns per W product tile (WBN):
#: the HALS kernel sweeps a lane of k <= WBN columns in the tile that
#: computes its numerators; each launch checks them against its library
SPLIT_ROWS = 256
MU_W_TILE_ROWS = 128
W_TILE_COLS = 64


def mu_block_workspace(m: int, n: int, rk: int, k: int,
                       ragged: bool = False):
    """Shapes of ``csrc/block_mu.cu``'s workspace, in its argument order:
    wp_tmp, hp_tmp, part (one (rk, n) block per split of the H numerator),
    gpart, gh (each column's k Gram entries within its segment: the
    uniform pool's (rk/k, k, k) lanes or, ``ragged``, (rk, k) rows with k
    the widest segment), then wdp and wmp (one row of column maxima per W
    tile)."""
    splits = -(-m // SPLIT_ROWS)
    w_tiles = -(-m // MU_W_TILE_ROWS)
    lanes = (rk, k) if ragged else (rk // k, k, k)
    return ((m, rk), (rk, n), (splits, rk, n), (splits,) + lanes, lanes,
            (w_tiles, rk), (w_tiles, rk))


def pair_workspace(m: int, n: int, rk: int, k: int):
    """Shapes of :func:`fused_h_update`'s workspace: part and gpart, as an
    iteration of ``csrc/block_mu.cu``'s block sizes them."""
    return mu_block_workspace(m, n, rk, k)[2:4]


def hals_w_tiles(m: int, rk: int, k: int, positions: int):
    """The HALS kernel's W half: (lanes per tile, column tiles, row tiles).
    For k <= W_TILE_COLS one tile of MU_W_TILE_ROWS rows takes
    W_TILE_COLS // k whole lanes; a wider lane is swept one lane and
    ``positions`` rows at a time. Each row tile writes one row of W
    maxima at a boundary."""
    lanes = rk // k
    if k <= W_TILE_COLS:
        per = W_TILE_COLS // k
        return per, -(-lanes // per), -(-m // MU_W_TILE_ROWS)
    return 1, lanes, -(-m // positions)


def hals_block_workspace(m: int, n: int, rk: int, k: int, positions: int):
    """Shapes of ``csrc/hals_block.cu``'s workspace: mu's first five, then
    the W numerator (m, rk), used only when k > W_TILE_COLS (else empty),
    and two arrays of maxima with one row per ``positions``-column block
    of the H sweep or per row tile of the W half, whichever are more."""
    tiles = max(-(-n // positions), hals_w_tiles(m, rk, k, positions)[2])
    aht = (m, rk) if k > W_TILE_COLS else (0, rk)
    return (mu_block_workspace(m, n, rk, k)[:5]
            + (aht, (tiles, rk), (tiles, rk)))


def _check_library_rows(lib, name: str, symbol: str, want: int) -> None:
    got = getattr(lib, symbol)()
    if got != want:
        raise RuntimeError(f"{name}: the built library has {symbol}() = "
                           f"{got}, the wrapper sizes its workspace for "
                           f"{want}")


#: segment tables of the ragged pools seen, by (ids' bytes, device)
_SEG_TABLES: dict = {}


def segment_tables(seg_ids, device):
    """(start, width, of_col, kmax) of a pool's segments: int32 tensors on
    ``device`` (each segment's first column and width, each column's
    segment) and the widest segment. Every id must be one run of
    consecutive columns, as the ragged class-blocked pool lays its jobs
    out. Computed on the host once per distinct layout."""
    ids = np.asarray(seg_ids.cpu() if torch.is_tensor(seg_ids) else seg_ids,
                     dtype=np.int64).reshape(-1)
    key = (ids.tobytes(), str(device))
    if key not in _SEG_TABLES:
        change = np.flatnonzero(np.diff(ids)) + 1
        start = np.concatenate([[0], change]).astype(np.int32)
        width = np.diff(np.concatenate([start, [ids.size]])).astype(np.int32)
        if len(np.unique(ids)) != start.size:
            raise ValueError("seg_ids: every segment id must be one run of "
                             "consecutive columns")
        of_col = np.repeat(np.arange(start.size, dtype=np.int32), width)
        _SEG_TABLES[key] = tuple(torch.as_tensor(x, device=device)
                                 for x in (start, width, of_col)) + (
            int(width.max()),)
    return _SEG_TABLES[key]


def _block_launch(name, symbol, lib_name, workspace, a, wp, hp,
                  frozen_cols, *, k, iters, eps, zero_threshold, check_block,
                  budget_cols, matmul_precision, alias_io, segs=None):
    """Check the operands, allocate outputs and workspace, and run one
    block kernel's C entry point (the shared argument list of
    ``block_mu.cu`` and ``hals_block.cu``; ``workspace(lib, m, n, rk)``
    gives the kernel's workspace shapes in argument order; ``segs``, the
    mu kernel's segment tables, or None for the HALS kernel, which takes
    none)."""
    bf = _bf16_operands(matmul_precision)
    a = _kernel_a(name, a, bf)
    m, n = a.shape
    rk = wp.shape[1]
    operands = {"a": (a, (m, n)), "wp": (wp, (m, rk)), "hp": (hp, (rk, n)),
                "frozen_cols": (frozen_cols, (1, rk))}
    if check_block > 1:
        operands["budget_cols"] = (budget_cols, (1, rk))
    pool = (torch.float32, torch.bfloat16)
    _check_operands(name, k if segs is None or segs[0] is None else 0,
                    {"a": _A_DTYPES, "wp": pool, "hp": pool}, **operands)
    from nmfx_torch.ops import _build

    lib = _build.load(lib_name)
    _check_library_rows(lib, name, "nmfx_block_split_rows", SPLIT_ROWS)
    nck = check_block
    rw, rh = wp.dtype == torch.bfloat16, hp.dtype == torch.bfloat16
    flags = ((BF16_OPERANDS if bf else 0) | (BF16_W if rw else 0)
             | (BF16_H if rh else 0))

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=a.device)

    if alias_io:
        wp_out, hp_out = wp, hp
    else:
        wp_out, hp_out = empty(m, rk, dtype=wp.dtype), empty(rk, n,
                                                             dtype=hp.dtype)
    wd, wm = empty(nck, rk), empty(nck, rk)
    hd, hm = empty(nck * rk, 1), empty(nck * rk, 1)
    h_checks = empty(nck, rk, n) if nck > 1 else None
    work = [empty(*shape) for shape in workspace(lib, m, n, rk)]
    options = [empty(m, rk) if rw else None, empty(rk, n) if rh else None,
               empty(rk, n) if rh else None,
               empty(m, rk, dtype=torch.bfloat16) if bf else None]
    seg_args = []
    seg_ints = []
    if segs is not None:
        start, width, of_col, kmax = segs
        seg_args = [start, width, of_col]
        seg_ints = [0 if start is None else start.numel()]
        k = kmax
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = getattr(lib, symbol)(
        a.data_ptr(), wp.data_ptr(), hp.data_ptr(), frozen_cols.data_ptr(),
        _ptr(budget_cols if nck > 1 else None), wp_out.data_ptr(),
        hp_out.data_ptr(), wd.data_ptr(), wm.data_ptr(), hd.data_ptr(),
        hm.data_ptr(), _ptr(h_checks), *(t.data_ptr() for t in work),
        *(_ptr(t) for t in seg_args), *(_ptr(t) for t in options),
        m, n, rk, k, *seg_ints, iters, nck, flags, eps, zero_threshold,
        stream)
    _raise_on(name, rc)
    out = (wp_out, hp_out, wd, wm, hd, hm)
    return out if h_checks is None else out + (h_checks,)


def fused_block_iterations(a, wp, hp, frozen_cols, *, k: int,
                           iters: int = 2, eps: float = 1e-9,
                           zero_threshold: float = 0.0,
                           check_block: int = 1, budget_cols=None,
                           fused: bool = False,
                           matmul_precision: str = "default",
                           seg_ids=None, alias_io: bool = False):
    """``iters · check_block`` full MU iterations of the packed pool
    (A (m, n), Wp (m, rk), Hp (rk, n), contiguous, one CUDA device;
    float32, or bf16 as the module's options say; the uniform pool's
    lanes are k consecutive columns, the ragged pool's given by
    ``seg_ids``).

    ``frozen_cols`` (1, rk) f32: > 0 marks a frozen lane whose columns
    must not change. ``check_block > 1`` needs ``budget_cols`` (1, rk)
    f32, each lane's remaining iteration allowance at entry: a lane
    freezes once the call-local iteration index reaches it. Returns
    ``(wp, hp, wdiff, wmax, hdiff, hmax)`` — per-column TolX
    ingredients at every check boundary, (check_block, rk) for W and
    (check_block·rk, 1) for H — plus ``h_checks`` (check_block, rk, n),
    the H snapshot at each boundary, when ``check_block > 1``.

    ``fused=True`` runs the join-the-updates order (each pass reads an A
    chunk once for the W half of one iteration and the H numerator of
    the next); its outputs are byte-equal to ``fused=False``'s.
    """
    _need_budget(check_block, budget_cols)
    _bf16_operands(matmul_precision)
    if a.device.type == "cpu":
        return fused_block_iterations_ref(
            a, wp, hp, frozen_cols, k=k, iters=iters, eps=eps,
            zero_threshold=zero_threshold, check_block=check_block,
            budget_cols=budget_cols, matmul_precision=matmul_precision,
            seg_ids=seg_ids, alias_io=alias_io)
    name = ("fused_block_iterations_fused" if fused
            else "fused_block_iterations")
    segs = ((None, None, None, k) if seg_ids is None
            else segment_tables(seg_ids, a.device))

    def work(lib, m, n, rk):
        _check_library_rows(lib, name, "nmfx_block_w_tile_rows",
                            MU_W_TILE_ROWS)
        return mu_block_workspace(m, n, rk, segs[3],
                                  ragged=seg_ids is not None)

    out = _block_launch(
        "fused_block_iterations", ("nmfx_block_iterations_fused" if fused
                                   else "nmfx_block_iterations"),
        "block_mu", work, a, wp, hp, frozen_cols, k=k, iters=iters, eps=eps,
        zero_threshold=zero_threshold, check_block=check_block,
        budget_cols=budget_cols, matmul_precision=matmul_precision,
        alias_io=alias_io, segs=segs)
    _count(name, "bf16" if _bf16_operands(matmul_precision) else None,
           _pool_tag(wp, hp), None if seg_ids is None else "seg_ids",
           "alias_io" if alias_io else None)
    return out


def hals_block_iterations(a, wp, hp, frozen_cols, *, k: int, slots: int,
                          iters: int = 2, eps: float = 1e-9,
                          zero_threshold: float = 0.0,
                          check_block: int = 1, budget_cols=None,
                          matmul_precision: str = "default",
                          alias_io: bool = False):
    """``iters · check_block`` HALS iterations of the uniform packed pool
    (``rk == k · slots``), with the operands, options, outputs, freezes,
    budget fence, stats and snapshots of :func:`fused_block_iterations`
    (no ``seg_ids``: the HALS pool is uniform)."""
    _check_slots(wp.shape[1], k, slots)
    _need_budget(check_block, budget_cols)
    _bf16_operands(matmul_precision)
    if a.device.type == "cpu":
        return hals_block_iterations_ref(
            a, wp, hp, frozen_cols, k=k, slots=slots, iters=iters, eps=eps,
            zero_threshold=zero_threshold, check_block=check_block,
            budget_cols=budget_cols, matmul_precision=matmul_precision,
            alias_io=alias_io)

    def work(lib, m, n, rk):
        name = "hals_block_iterations"
        _check_library_rows(lib, name, "nmfx_block_w_tile_rows",
                            MU_W_TILE_ROWS)
        _check_library_rows(lib, name, "nmfx_hals_w_tile_cols", W_TILE_COLS)
        return hals_block_workspace(m, n, rk, k,
                                    lib.nmfx_hals_sweep_positions())

    out = _block_launch(
        "hals_block_iterations", "nmfx_hals_block_iterations", "hals_block",
        work, a, wp, hp, frozen_cols, k=k, iters=iters, eps=eps,
        zero_threshold=zero_threshold, check_block=check_block,
        budget_cols=budget_cols, matmul_precision=matmul_precision,
        alias_io=alias_io)
    _count("hals_block_iterations",
           "bf16" if _bf16_operands(matmul_precision) else None,
           _pool_tag(wp, hp), "alias_io" if alias_io else None)
    return out
