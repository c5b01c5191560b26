"""The block kernels' workspace sizing (``nmfx_torch/ops/fused_mu.py``)
against the tiling of ``nmfx_torch/csrc/block_mu.cu`` and
``nmfx_torch/csrc/hals_block.cu``, on the CPU.

A workspace that is too small shows on a card as a fault, or as a W stat
read from memory no kernel wrote; here the sizes are held to a model of
which rows and tiles each kernel writes, over ragged shapes. Exact
integer arithmetic, no tolerance.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from nmfx_torch.ops import _build, fused_mu

CSRC = Path(fused_mu.__file__).resolve().parent.parent / "csrc"

# (m, n, slots, k): the north-star pool, the unaligned 5 x 7 pool at the
# ragged 1237 x 77, a last chunk of fewer than one W tile of rows, and
# shapes at and just past the split and tile edges
SHAPES = [(5120, 500, 48, 10), (1237, 77, 5, 7), (1237, 77, 13, 3),
          (1100, 300, 9, 8), (203, 37, 5, 3), (20, 8, 2, 2), (256, 1, 1, 1),
          (257, 5, 3, 1), (128, 64, 4, 16), (129, 129, 7, 5)]


def _constant(header: str, name: str) -> int:
    hit = re.search(rf"\b{name}\s*=\s*(\d+)", (CSRC / header).read_text())
    assert hit, f"{name} not found in {header}"
    return int(hit.group(1))


def test_python_constants_match_the_headers():
    assert fused_mu.SPLIT_ROWS == _constant("block_common.cuh", "SPLIT_ROWS")
    assert fused_mu.MU_W_TILE_ROWS == _constant("block_gemm.cuh", "WBM")
    assert fused_mu.W_TILE_COLS == _constant("block_gemm.cuh", "WBN")
    assert fused_mu.SPLIT_ROWS % fused_mu.MU_W_TILE_ROWS == 0


def _w_stat_rows(m: int, fused: bool) -> set[int]:
    """Rows of wdp/wmp the W half writes at a boundary: one per block row
    of w_block_update's grid, or (wh_pass) one per CTA of a cluster that
    holds rows of its chunk."""
    split, rows = fused_mu.SPLIT_ROWS, fused_mu.MU_W_TILE_ROWS
    if not fused:
        return set(range(-(-m // rows)))
    return {(s * split + r * rows) // rows
            for s in range(-(-m // split)) for r in range(split // rows)
            if s * split + r * rows < m}


@pytest.mark.parametrize("m,n,slots,k", SHAPES)
def test_mu_block_workspace_covers_every_tile(m, n, slots, k):
    rk = slots * k
    wp_tmp, hp_tmp, part, gpart, gh, wdp, wmp = fused_mu.mu_block_workspace(
        m, n, rk, k)
    assert wp_tmp == (m, rk) and hp_tmp == (rk, n)
    splits = part[0]
    split = fused_mu.SPLIT_ROWS
    assert (splits - 1) * split < m <= splits * split
    assert part == (splits, rk, n)
    assert gpart == (splits, slots, k, k) and gh == (slots, k, k)
    assert wdp == wmp and wdp[1] == rk
    # w_stats_reduce reads rows 0 .. wdp[0]-1: both orders write each one
    for fused in (False, True):
        assert _w_stat_rows(m, fused) == set(range(wdp[0]))


@pytest.mark.parametrize("m,n,slots,k", SHAPES)
def test_hals_block_workspace_keeps_its_layout(m, n, slots, k):
    """mu's first five, the W numerator only for a lane wider than a W
    tile, then one row of maxima per H sweep block or W row tile."""
    rk = slots * k
    positions = _constant("hals_block.cu", "SWEEP_POS")
    got = fused_mu.hals_block_workspace(m, n, rk, k, positions)
    splits = -(-m // fused_mu.SPLIT_ROWS)
    w_tiles = -(-m // fused_mu.MU_W_TILE_ROWS)
    tiles = max(-(-n // positions), w_tiles)
    assert got == ((m, rk), (rk, n), (splits, rk, n), (splits, slots, k, k),
                   (slots, k, k), (0, rk), (tiles, rk), (tiles, rk))
    wide = fused_mu.W_TILE_COLS + 6
    got = fused_mu.hals_block_workspace(m, n, slots * wide, wide, positions)
    tiles = -(-max(m, n) // positions)
    assert got[5:] == ((m, slots * wide), (tiles, slots * wide),
                       (tiles, slots * wide))


def _hals_w_tile_model(m: int, rk: int, k: int):
    """hals_block.cu's W half: {tile (bx, by): (columns, rows)}. For k <=
    WBN, w_sweep_tile's CTA (bx, by) owns the WBN // k whole lanes from
    lane bx * (WBN // k) and rows by * WBM ..; for a wider lane,
    hals_sweep's block (lane bx, by) owns the lane and SWEEP_POS rows."""
    wbm, wbn = _constant("block_gemm.cuh", "WBM"), _constant(
        "block_gemm.cuh", "WBN")
    pos = _constant("hals_block.cu", "SWEEP_POS")
    per, rows = (wbn // k, wbm) if k <= wbn else (1, pos)
    lanes = rk // k
    return {(bx, by): (range(bx * per * k, min(lanes, bx * per + per) * k),
                       range(by * rows, min(m, by * rows + rows)))
            for bx in range(-(-lanes // per)) for by in range(-(-m // rows))}


@pytest.mark.parametrize("k", [*range(1, 17), 70])
@pytest.mark.parametrize("m,n,slots,_k", SHAPES)
def test_hals_w_tiles_hold_whole_lanes(m, n, slots, _k, k):
    """Every lane's k columns lie in exactly one W tile of at most WBN
    columns, every (row, column) in exactly one tile, and the stat rows
    (one per row tile) cover every tile and fit the workspace."""
    rk = slots * k
    pos = _constant("hals_block.cu", "SWEEP_POS")
    model = _hals_w_tile_model(m, rk, k)
    per, ctiles, rtiles = fused_mu.hals_w_tiles(m, rk, k, pos)
    assert {bx for bx, _ in model} == set(range(ctiles))
    assert {by for _, by in model} == set(range(rtiles))
    for lane in range(slots):
        cols = set(range(lane * k, lane * k + k))
        holding = {bx for (bx, _), (c, _) in model.items()
                   if cols & set(c)}
        assert len(holding) == 1
        assert all(cols <= set(c) for (bx, _), (c, _) in model.items()
                   if bx in holding)
    writes = np.zeros((m, rk), dtype=np.int64)
    for cols, rows in model.values():
        assert cols and (len(cols) <= fused_mu.W_TILE_COLS or len(cols) == k)
        writes[rows.start:rows.stop, cols.start:cols.stop] += 1
    assert (writes == 1).all()
    dp = fused_mu.hals_block_workspace(m, n, rk, k, pos)[6]
    assert dp[0] >= rtiles and dp[0] >= -(-n // pos) and dp[1] == rk


def test_library_row_counts_are_checked():
    class Lib:
        @staticmethod
        def nmfx_block_w_tile_rows():
            return 64

    fused_mu._check_library_rows(Lib, "k", "nmfx_block_w_tile_rows", 64)
    with pytest.raises(RuntimeError, match="sizes its workspace for 128"):
        fused_mu._check_library_rows(Lib, "k", "nmfx_block_w_tile_rows", 128)


def test_kernel_resources_reads_ptxas_log():
    log = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z4wh_pv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z4wh_pv\n"
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill "
        "loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers, 400 bytes "
        "cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z3hgv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3hgv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers, 8192 bytes "
        "smem, 400 bytes cmem[0]\n")
    assert _build.kernel_resources(log) == {
        "_Z4wh_pv": dict(registers=128, smem=0, stack=0, spill_stores=8,
                         spill_loads=12),
        "_Z3hgv": dict(registers=40, smem=8192, stack=0, spill_stores=0,
                       spill_loads=0)}
