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

A wrapper given CPU tensors runs the plain version (``*_ref``), which
computes the full masked Grams (or, for HALS, the dense per-lane sweeps)
as the reference's engines do. Given CUDA tensors it launches its kernel
or raises; it never falls back. ``LAUNCHES`` counts the launches of each
kernel (never the plain runs); the two orders of the MU block kernel
count apart.
"""

from __future__ import annotations

import torch

from nmfx_torch.solvers.hals import hals_h_sweep, hals_w_sweep
from nmfx_torch.solvers.mu import _mu_update

#: kernel launches, incremented only where a kernel launches
LAUNCHES = {"fused_h_update": 0, "lane_gram": 0, "fused_w_update": 0,
            "fused_block_iterations": 0, "fused_block_iterations_fused": 0,
            "hals_block_iterations": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lane_mask(rk: int, k: int, device) -> torch.Tensor:
    lane = torch.arange(rk, device=device) // k
    return lane[:, None] == lane[None, :]


def fused_h_update_ref(a, wp, hp, *, k: int, eps: float = 1e-9,
                       zero_threshold: float = 0.0) -> torch.Tensor:
    """Plain version of :func:`fused_h_update` (full masked W-Gram)."""
    gram = torch.where(_lane_mask(wp.shape[1], k, wp.device), wp.T @ wp,
                       torch.zeros((), dtype=wp.dtype, device=wp.device))
    return _mu_update(hp, wp.T @ a, gram @ hp, eps, zero_threshold)


def _lane_blocks(g: torch.Tensor, k: int) -> torch.Tensor:
    """(rk/k, k, k), contiguous: the lanes' diagonal k×k blocks of an
    (rk, rk) matrix."""
    r = g.shape[0] // k
    return torch.diagonal(g.reshape(r, k, r, k), dim1=0,
                          dim2=2).permute(2, 0, 1).contiguous()


def lane_gram_ref(hp, *, k: int) -> torch.Tensor:
    """Plain version of :func:`lane_gram`: the diagonal blocks of the full
    product, the blocks bd_select(Hp·Hpᵀ) keeps."""
    return _lane_blocks(hp @ hp.T, k)


def fused_w_update_ref(a, wp, hp, gh, *, k: int, eps: float = 1e-9,
                       zero_threshold: float = 0.0) -> torch.Tensor:
    """Plain version of :func:`fused_w_update`: the full product with the
    masked (rk, rk) H-Gram (a per-lane ``gh`` laid out block-diagonally
    first)."""
    if gh.dim() == 3:
        gh = torch.block_diag(*gh)
    return _mu_update(wp, a @ hp.T, wp @ gh, eps, zero_threshold)


def _check_operands(name: str, k: int, **shapes) -> None:
    """Device, dtype, shape and contiguity checks before any pointer goes
    to the kernel; ``shapes`` maps operand name → (tensor, shape), with
    rk from ``wp`` or else ``hp``."""
    rk = shapes["wp"][1][1] if "wp" in shapes else shapes["hp"][1][0]
    if k < 1 or rk % k:
        raise ValueError(f"{name}: rk={rk} is not a multiple of k={k}")
    ref_device = None
    for arg, (t, shape) in shapes.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, not CUDA")
        if ref_device is None:
            ref_device = t.device
        elif t.device != ref_device:
            raise ValueError(f"{name}: operands on {ref_device} and "
                             f"{t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


def _pair_library(name: str):
    from nmfx_torch.ops import _build

    lib = _build.load("block_mu")
    _check_library_rows(lib, name, "nmfx_block_split_rows", SPLIT_ROWS)
    return lib


def fused_h_update(a, wp, hp, *, k: int, eps: float = 1e-9,
                   zero_threshold: float = 0.0) -> torch.Tensor:
    """Hp ← mu_epilogue(Hp, WpᵀA, (WpᵀWp ∘ B)·Hp). A (m, n), Wp (m, rk),
    Hp (rk, n), float32, contiguous, on one CUDA device."""
    if a.device.type == "cpu":
        return fused_h_update_ref(a, wp, hp, k=k, eps=eps,
                                  zero_threshold=zero_threshold)
    m, n = a.shape
    rk = wp.shape[1]
    _check_operands("fused_h_update", k, a=(a, (m, n)), wp=(wp, (m, rk)),
                    hp=(hp, (rk, n)))
    lib = _pair_library("fused_h_update")
    out = torch.empty((rk, n), dtype=torch.float32, device=a.device)
    part, gpart = (torch.empty(shape, dtype=torch.float32, device=a.device)
                   for shape in pair_workspace(m, n, rk, k))
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.nmfx_fused_h_update(
        a.data_ptr(), wp.data_ptr(), hp.data_ptr(), out.data_ptr(),
        part.data_ptr(), gpart.data_ptr(), m, n, rk, k, eps, zero_threshold,
        stream)
    _raise_on("fused_h_update", rc)
    LAUNCHES["fused_h_update"] += 1
    return out


def lane_gram(hp, *, k: int) -> torch.Tensor:
    """gh (rk/k, k, k): each lane's k×k block of Hp·Hpᵀ, the masked H-Gram
    that :func:`fused_w_update` reads. Hp (rk, n) float32, contiguous."""
    if hp.device.type == "cpu":
        return lane_gram_ref(hp, k=k)
    rk, n = hp.shape
    _check_operands("lane_gram", k, hp=(hp, (rk, n)))
    lib = _pair_library("lane_gram")
    gh = torch.empty((rk // k, k, k), dtype=torch.float32, device=hp.device)
    stream = torch.cuda.current_stream(hp.device).cuda_stream
    rc = lib.nmfx_lane_gram(hp.data_ptr(), gh.data_ptr(), n, rk, k, stream)
    _raise_on("lane_gram", rc)
    LAUNCHES["lane_gram"] += 1
    return gh


def fused_w_update(a, wp, hp, gh, *, k: int, eps: float = 1e-9,
                   zero_threshold: float = 0.0) -> torch.Tensor:
    """Wp ← mu_epilogue(Wp, A·Hpᵀ, Wp·gh), gh the new Hp's masked H-Gram:
    :func:`lane_gram`'s (rk/k, k, k), or the (rk, rk) block-diagonal
    matrix the reference takes, of which only each lane's diagonal block
    is read."""
    if a.device.type == "cpu":
        return fused_w_update_ref(a, wp, hp, gh, k=k, eps=eps,
                                  zero_threshold=zero_threshold)
    m, n = a.shape
    rk = wp.shape[1]
    dense = gh.dim() == 2
    _check_operands("fused_w_update", k, a=(a, (m, n)), wp=(wp, (m, rk)),
                    hp=(hp, (rk, n)),
                    gh=(gh, (rk, rk) if dense else (rk // k, k, k)))
    if dense:
        gh = _lane_blocks(gh, k)
    lib = _pair_library("fused_w_update")
    out = torch.empty((m, rk), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.nmfx_fused_w_update(
        a.data_ptr(), wp.data_ptr(), hp.data_ptr(), gh.data_ptr(),
        out.data_ptr(), m, n, rk, k, eps, zero_threshold, stream)
    _raise_on("fused_w_update", rc)
    LAUNCHES["fused_w_update"] += 1
    return out


def _need_budget(check_block, budget_cols) -> None:
    if check_block > 1 and budget_cols is None:
        raise ValueError("check_block > 1 needs budget_cols (each lane's "
                         "remaining iteration allowance at launch entry)")


def _block_ref(update, a, wp, hp, frozen_cols, *, iters, check_block,
               budget_cols):
    """The launch bookkeeping the plain block versions share: the lane
    freezes and budget fence, then per-boundary stats and snapshots
    around ``update(w, h, frozen) -> (wn, hn)`` (one iteration, frozen
    rows and columns kept)."""
    _need_budget(check_block, budget_cols)
    rk, n = hp.shape
    frozen = frozen_cols.reshape(rk) > 0
    budget = None if check_block == 1 else budget_cols.reshape(rk)
    f32 = dict(dtype=torch.float32, device=a.device)
    wd = torch.zeros((check_block, rk), **f32)
    wm = torch.zeros((check_block, rk), **f32)
    hd = torch.zeros((check_block * rk, 1), **f32)
    hm = torch.zeros((check_block * rk, 1), **f32)
    h_checks = (torch.zeros((check_block, rk, n), **f32)
                if check_block > 1 else None)
    w, h = wp, hp
    for it in range(iters * check_block):
        fr = frozen if budget is None else frozen | (budget <= it)
        wn, hn = update(w, h, fr)
        if (it + 1) % iters == 0:
            b = (it + 1) // iters - 1
            rows = slice(b * rk, (b + 1) * rk)
            hd[rows, 0] = (hn - h).abs().amax(dim=1)
            hm[rows, 0] = h.abs().amax(dim=1)
            wd[b] = (wn - w).abs().amax(dim=0)
            wm[b] = w.abs().amax(dim=0)
            if h_checks is not None:
                h_checks[b] = hn
        w, h = wn, hn
    out = (w, h, wd, wm, hd, hm)
    return out if h_checks is None else out + (h_checks,)


def fused_block_iterations_ref(a, wp, hp, frozen_cols, *, k: int,
                               iters: int = 2, eps: float = 1e-9,
                               zero_threshold: float = 0.0,
                               check_block: int = 1, budget_cols=None):
    """Plain version of :func:`fused_block_iterations` (either order):
    the same masks, fences, stats and snapshots, with full masked
    Grams."""
    bd = _lane_mask(hp.shape[0], k, a.device)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)

    def update(w, h, fr):
        gram = torch.where(bd, w.T @ w, zero)
        hn = _mu_update(h, w.T @ a, gram @ h, eps, zero_threshold)
        hn = torch.where(fr[:, None], h, hn)
        gh = torch.where(bd, hn @ hn.T, zero)
        wn = _mu_update(w, a @ hn.T, w @ gh, eps, zero_threshold)
        return torch.where(fr[None, :], w, wn), hn

    return _block_ref(update, a, wp, hp, frozen_cols, iters=iters,
                      check_block=check_block, budget_cols=budget_cols)


def hals_block_iterations_ref(a, wp, hp, frozen_cols, *, k: int,
                              slots: int, iters: int = 2, eps: float = 1e-9,
                              zero_threshold: float = 0.0,
                              check_block: int = 1, budget_cols=None):
    """Plain version of :func:`hals_block_iterations`: the dense per-lane
    sweeps of ``grid_mu.hals_block`` on the pool's (S, m, k) / (S, k, n)
    views, with the block kernel's masks, fences, stats and snapshots."""
    _check_slots(wp.shape[1], k, slots)
    m, rk = wp.shape
    n = hp.shape[1]

    def update(w, h, fr):
        w3 = w.reshape(m, slots, k).permute(1, 0, 2)
        hn = hals_h_sweep(a, w3, h.reshape(slots, k, n), eps,
                          zero_threshold).reshape(rk, n)
        hn = torch.where(fr[:, None], h, hn)
        wn = hals_w_sweep(a, w3, hn.reshape(slots, k, n), eps,
                          zero_threshold).permute(1, 0, 2).reshape(m, rk)
        return torch.where(fr[None, :], w, wn), hn

    return _block_ref(update, a, wp, hp, frozen_cols, iters=iters,
                      check_block=check_block, budget_cols=budget_cols)


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


def mu_block_workspace(m: int, n: int, rk: int, k: int):
    """Shapes of ``csrc/block_mu.cu``'s workspace, in its argument order:
    wp_tmp, hp_tmp, part (one (rk, n) block per split of the H numerator),
    gpart, gh, then wdp and wmp (one row of column maxima per W tile)."""
    splits = -(-m // SPLIT_ROWS)
    w_tiles = -(-m // MU_W_TILE_ROWS)
    return ((m, rk), (rk, n), (splits, rk, n), (splits, rk // k, k, k),
            (rk // k, k, k), (w_tiles, rk), (w_tiles, rk))


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


def _block_launch(name, symbol, lib_name, workspace, a, wp, hp,
                  frozen_cols, *, k, iters, eps, zero_threshold, check_block,
                  budget_cols):
    """Check the operands, allocate outputs and workspace, and run one
    block kernel's C entry point (the shared argument list of
    ``block_mu.cu`` and ``hals_block.cu``; ``workspace(lib, m, n, rk)``
    gives the kernel's workspace shapes in argument order)."""
    m, n = a.shape
    rk = wp.shape[1]
    operands = {"a": (a, (m, n)), "wp": (wp, (m, rk)), "hp": (hp, (rk, n)),
                "frozen_cols": (frozen_cols, (1, rk))}
    if check_block > 1:
        operands["budget_cols"] = (budget_cols, (1, rk))
    _check_operands(name, k, **operands)
    from nmfx_torch.ops import _build

    lib = _build.load(lib_name)
    _check_library_rows(lib, name, "nmfx_block_split_rows", SPLIT_ROWS)
    nck = check_block

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=a.device)

    wp_out, hp_out = empty(m, rk), empty(rk, n)
    wd, wm = empty(nck, rk), empty(nck, rk)
    hd, hm = empty(nck * rk, 1), empty(nck * rk, 1)
    h_checks = empty(nck, rk, n) if nck > 1 else None
    work = [empty(*shape) for shape in workspace(lib, m, n, rk)]

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = getattr(lib, symbol)(
        a.data_ptr(), wp.data_ptr(), hp.data_ptr(), frozen_cols.data_ptr(),
        ptr(budget_cols if nck > 1 else None), wp_out.data_ptr(),
        hp_out.data_ptr(), wd.data_ptr(), wm.data_ptr(), hd.data_ptr(),
        hm.data_ptr(), ptr(h_checks), *(t.data_ptr() for t in work),
        m, n, rk, k, iters, nck, eps, zero_threshold, stream)
    _raise_on(name, rc)
    out = (wp_out, hp_out, wd, wm, hd, hm)
    return out if h_checks is None else out + (h_checks,)


def fused_block_iterations(a, wp, hp, frozen_cols, *, k: int,
                           iters: int = 2, eps: float = 1e-9,
                           zero_threshold: float = 0.0,
                           check_block: int = 1, budget_cols=None,
                           fused: bool = False):
    """``iters · check_block`` full MU iterations of the packed pool
    (A (m, n), Wp (m, rk), Hp (rk, n), float32, contiguous, one CUDA
    device; the uniform pool's lanes are k consecutive columns).

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
    if a.device.type == "cpu":
        return fused_block_iterations_ref(
            a, wp, hp, frozen_cols, k=k, iters=iters, eps=eps,
            zero_threshold=zero_threshold, check_block=check_block,
            budget_cols=budget_cols)
    name = ("fused_block_iterations_fused" if fused
            else "fused_block_iterations")

    def work(lib, m, n, rk):
        _check_library_rows(lib, name, "nmfx_block_w_tile_rows",
                            MU_W_TILE_ROWS)
        return mu_block_workspace(m, n, rk, k)

    out = _block_launch(
        "fused_block_iterations", ("nmfx_block_iterations_fused" if fused
                                   else "nmfx_block_iterations"),
        "block_mu", work, a, wp, hp, frozen_cols, k=k, iters=iters, eps=eps,
        zero_threshold=zero_threshold, check_block=check_block,
        budget_cols=budget_cols)
    LAUNCHES[name] += 1
    return out


def hals_block_iterations(a, wp, hp, frozen_cols, *, k: int, slots: int,
                          iters: int = 2, eps: float = 1e-9,
                          zero_threshold: float = 0.0,
                          check_block: int = 1, budget_cols=None):
    """``iters · check_block`` HALS iterations of the uniform packed pool
    (``rk == k · slots``), with the operands, outputs, freezes, budget
    fence, stats and snapshots of :func:`fused_block_iterations`."""
    _check_slots(wp.shape[1], k, slots)
    _need_budget(check_block, budget_cols)
    if a.device.type == "cpu":
        return hals_block_iterations_ref(
            a, wp, hp, frozen_cols, k=k, slots=slots, iters=iters, eps=eps,
            zero_threshold=zero_threshold, check_block=check_block,
            budget_cols=budget_cols)

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
        budget_cols=budget_cols)
    LAUNCHES["hals_block_iterations"] += 1
    return out
