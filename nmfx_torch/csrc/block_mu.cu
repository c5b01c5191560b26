// Hand-written sm_90a block of full MU iterations for the slot scheduler.
//
// Replaces nmfx/ops/pallas_mu.py:fused_block_iterations, both its phased
// _block_kernel (fused=False, entry nmfx_block_iterations) and its
// join-the-updates _fused_block_kernel (fused=True, entry
// nmfx_block_iterations_fused): iters * check_block full MU iterations
// of the packed slot pool in one call, with per-lane freezes, the
// per-lane iteration budget fence, per-boundary TolX stats and, when
// check_block > 1, an H snapshot at every check boundary.
//
// Also replaces nmfx/ops/pallas_mu.py:fused_h_update (_h_kernel) and
// nmfx/ops/pallas_mu.py:fused_w_update (_w_kernel), the per-iteration
// pair of the per-rank route and of the scheduler's fallback: entries
// nmfx_fused_h_update (kernels 1-3 below), nmfx_lane_gram (kernel 4) and
// nmfx_fused_w_update (kernel 5), each one call with no lane frozen and
// no stats (the caller freezes). One call of each in turn is byte-equal,
// in every bit of Hp and Wp, to one iteration of nmfx_block_iterations
// with no lane frozen from the same inputs: the same kernels on the same
// chains.
//
// Layout (float32, row-major, contiguous): A (m, n), Wp (m, rk), Hp
// (rk, n). The uniform pool's rk = S*k columns fall in S segments of k
// (slot s owns columns/rows s*k .. s*k+k-1: segment ids iota // k); the
// ragged class-blocked pool passes a table of segments of their own
// widths (at most k), each one job's consecutive columns (Segs,
// block_common.cuh). A segment is what the reference's per-column
// segment ids mark: the W- and H-Gram keep only pairs (c, c') of one
// segment (seg[c] == seg[c']), and every sum over a lane runs over its
// segment. Freezes, budgets and TolX exports are per column already.
// With the ids iota // k the tables give the uniform chains, byte for
// byte.
//
// Options of the reference kernel (all of them):
//   - bf16 operands (flags & 1, matmul_precision="bfloat16"): A arrives
//     as bf16; every product operand is rounded to bf16 where the
//     reference casts it (_maybe_cast): Wp and A in the H numerator and
//     the W-Gram, the masked W-Gram and the old H in the H denominator,
//     the fresh H in the H-Gram, A and the new H in the W numerator, the
//     old W and the H-Gram in the W denominator. The epilogues' prev
//     factors stay float32. The H product reads a bf16 copy of Wp (wb),
//     written once an iteration by narrow_bf16;
//   - bf16 pool factors (flags & 2: W, flags & 4: H; factor_dtype): the
//     pool tensors are bf16; the launch widens them into float32 work
//     buffers, rounds every stored factor to bf16 where the reference
//     stores it (.astype(w_ref.dtype)), takes the TolX stats from the
//     unrounded update, the snapshot and the H-Gram as the reference
//     does (the H-Gram from the unrounded H, kept in hraw), and narrows
//     the result into the bf16 outputs;
//   - alias_io (wp_out == wp_in and hp_out == hp_in): the pool is updated
//     in place; when the first iteration would write the buffer it reads,
//     the input is first copied to the scratch buffer, so results are
//     byte-equal to the unaliased launch;
//   - block_m: the reference's row tiling changes only m_pad here (zero
//     rows add exact zeros to every chain), so it needs nothing of the
//     kernel.
//
// For launch-local iteration it in 0 .. iters*check_block-1, a lane is
// frozen when frozen[c] > 0 or, with check_block > 1, budget[c] <= it.
//   H half: hn = ep(h0, Wp^T A, G_W h0), G_W each lane's k x k block of
//           Wp^T Wp; frozen rows keep h0.
//   H-Gram: gh = each lane's k x k block of hn hn^T (computed here, not by
//           a library product).
//   W half: wn = ep(w0, A hn^T, w0 gh); frozen columns keep w0.
// At a boundary ((it + 1) % iters == 0, b = (it + 1) / iters - 1):
//   hd[b*rk + r] = max_j |hn - h0|, hm[b*rk + r] = max_j |h0|,
//   wd[b*rk + c] = max_i |wn - w0|, wm[b*rk + c] = max_i |w0|,
//   and with check_block > 1, h_checks[b] = hn.
// Maxima propagate NaN, as jnp.max does. A lane whose stop fires at an
// interior boundary keeps iterating to the end of the call, as in the
// reference (its recorded factors carry the extra iterations).
//
// What bounds it on an H100: at the north star (m = 5120 padded rows,
// n = 500, rk = 48 slots x k = 10) an iteration is 4*m*n*rk = 4.9 GFLOP
// of numerator products against ~41 MB of traffic, so a call is bound by
// operations: f32 FMA on the CUDA cores. The two numerator products run
// on block_gemm.cuh's register-tiled, pipelined tiles (W: 128 rows x 64
// lane columns, 8 x 4 outputs a thread; H: 64 lane columns x 128 columns
// of A, 8 x 8 a thread), whose every output is one in-order fmaf chain,
// so the results do not depend on the tiling. Under bf16 operands the
// same tiles are m64n64k16 wgmma products on the tensor cores, summed in
// the same K steps in every caller, whose outputs do not depend on the
// tiling either (block_gemm.cuh).
//
// What the design does about the TPU kernel's structure: the Pallas
// kernel holds all of Wp (9.8 MB here) and Hp in one core's VMEM for the
// whole launch; an SM has 227 KB. So the factors stay in device memory
// (A, Wp and Hp together fit the 50 MB L2) and one C call enqueues, per
// iteration, five kernels on the caller's stream with no host sync:
//   1. h_numer_split: Wp^T A, m split into SPLIT_ROWS-row chunks;
//   2. h_gram_partial:  each lane's k x k Wp^T Wp block per chunk;
//   3. h_block_epilogue: one block per H row; sums the partials in split
//      order, applies the epilogue and the freeze, and at a boundary the
//      row's H stats and the snapshot;
//   4. h_gram_diag: each lane's k x k block of hn hn^T, summed over n in
//      order;
//   5. w_block_update: tile-local W half with per-tile column maxima at a
//      boundary, then (boundary only) w_stats_reduce over the tiles.
// Factors ping-pong between the output and a scratch buffer so the last
// iteration lands in the output; the inputs are never written.
// No atomics, and every sum's order depends on m, n and k only, never on
// rk or a lane's slot: a job's arithmetic is the same in any pool width,
// so the scheduler's results do not depend on the schedule.
//
// The join-the-updates variant runs T + 1 passes (T = iters*check_block)
// instead of T iterations. Pass p (wh_pass) runs one thread block cluster
// of PAIR = SPLIT_ROWS / 128 CTAs per (64-column lane tile, SPLIT_ROWS-row
// chunk of A): each CTA computes the W half of iteration p-1 on its 128
// rows of the chunk (skipped at p = 0; fence <= p-1) with w_block_update's
// own tile code and keeps the new rows in its shared memory; after a
// cluster barrier each CTA copies its peers' rows through distributed
// shared memory, so it holds the chunk's whole W strip, and sums its
// share of the chunk's n columns of iteration p's H-numerator partial
// from it (skipped at p = T). Then the W-Gram partials, h_block_epilogue
// (fence <= p) and the H-Gram finish iteration p's H half. W stats land
// when p % iters == 0 (p > 0, row p/iters - 1), H stats and snapshots
// when (p+1) % iters == 0 (p < T). Every output element is the same chain
// of fmaf and adds as in the phased kernel, so all seven outputs are
// byte-equal to it. The W half needs the complete H of the previous pass,
// so a pass stays four launches. What the order saves is one of the two
// reads of A per iteration, but A (10.2 MB here) sits in L2 either way
// (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <algorithm>

#include "block_common.cuh"
#include "block_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

// out[i, j] = stored(epilogue(Hp[i, j], sum_s part[s, i, j], sum_q
//   opnd(G_i[q]) * opnd(Hp[st+q, j])), round_h) for row i = st + p of the
// segment from st of width w, G_i[q] = sum_s gpart[s, i, q] (q < w), or
// Hp[i, j] on a frozen row; `raw` (may be null) gets the value before
// the storage rounding, from which the stats are taken; grid (rk), one
// block per row.
template <bool BF>
__global__ void __launch_bounds__(ROW_THREADS)
h_block_epilogue(const float* __restrict__ hp, const float* __restrict__ part,
                 const float* __restrict__ gpart,
                 const float* __restrict__ frozen,
                 const float* __restrict__ budget, float* __restrict__ out,
                 float* __restrict__ raw, float* __restrict__ hd,
                 float* __restrict__ hm, float* __restrict__ hck, int n,
                 int rk, Segs sg, int splits, int it, int brow, int round_h,
                 float eps, float zero_threshold) {
  const int k = sg.k;
  extern __shared__ float sm[];  // grow[k], then 2 x ROW_THREADS maxima
  float* grow = sm;
  float* red_d = sm + k;
  float* red_m = red_d + ROW_THREADS;
  const int i = blockIdx.x;
  const int seg = sg.seg(i);
  const int st = sg.first(seg), w = sg.len(seg);
  for (int q = threadIdx.x; q < w; q += ROW_THREADS) {
    float g = 0.f;
    for (int s = 0; s < splits; ++s)
      g += gpart[((size_t)s * rk + i) * k + q];
    grow[q] = opnd<BF>(g);
  }
  __syncthreads();
  const bool frz = lane_frozen(frozen, budget, i, it);
  float dmax = 0.f, hmax = 0.f;
  for (int j = threadIdx.x; j < n; j += ROW_THREADS) {
    const float h0 = hp[(size_t)i * n + j];
    float hn = h0;
    if (!frz) {
      float numer = 0.f;
      for (int s = 0; s < splits; ++s)
        numer += part[((size_t)s * rk + i) * n + j];
      float denom = 0.f;
      for (int q = 0; q < w; ++q)
        denom = fmaf(grow[q], opnd<BF>(hp[(size_t)(st + q) * n + j]), denom);
      hn = mu_epilogue(h0, numer, denom, eps, zero_threshold);
    }
    const float hs = stored(hn, round_h);
    out[(size_t)i * n + j] = hs;
    if (raw != nullptr) raw[(size_t)i * n + j] = hn;
    if (brow >= 0) {
      dmax = nan_max(dmax, fabsf(hn - h0));
      hmax = nan_max(hmax, fabsf(h0));
      if (hck != nullptr) hck[((size_t)brow * rk + i) * n + j] = hs;
    }
  }
  if (brow < 0) return;  // the same for every thread of the block
  red_d[threadIdx.x] = dmax;
  red_m[threadIdx.x] = hmax;
  __syncthreads();
  for (int w2 = ROW_THREADS / 2; w2 > 0; w2 >>= 1) {
    if (threadIdx.x < w2) {
      red_d[threadIdx.x] = nan_max(red_d[threadIdx.x], red_d[threadIdx.x + w2]);
      red_m[threadIdx.x] = nan_max(red_m[threadIdx.x], red_m[threadIdx.x + w2]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    hd[(size_t)brow * rk + i] = red_d[0];
    hm[(size_t)brow * rk + i] = red_m[0];
  }
}

// The W epilogue of the WBM x WBN tile (i0, c0) whose numerators A Hp^T
// are in `acc` (w_numer_core's layout):
//   out[i, c] = stored(epilogue(Wp[i, c], acc, sum_q opnd(Wp[i, st+q])
//                               * opnd(gh[st+q, c - st])), round_w)
// over the w columns of c's segment from st, or Wp[i, c] on a frozen
// column (float4 stores with vec_out). `keep` (may be null) gets
// opnd(out), the H product's operand, from row i0 and zeros outside the
// matrix: row-major with leading dimension WBN, or under BF as bf16 in
// the wgmma layout mn_core<WBN>. With `stats`, the
// tile's column maxima of |update - Wp| (before the storage rounding)
// and |Wp| go to row `trow` of wdp / wmp. When the tile's rows of Wp
// over the segments its columns touch fit `stage` (`stage_floats`
// floats of shared memory, the ring's once the product is done), they
// are staged there, so the denominators' chains (4 interleaved a thread)
// read shared memory; otherwise they read Wp in global memory in the
// same order. Every thread of the block must call it. UNIFORM: the
// uniform pool's lanes of k and float32 storage (round_w == 0), with no
// table, width guard or rounding in the code.
template <bool BF, bool UNIFORM>
__device__ __forceinline__ void w_tile_epilogue(
    const float (&acc)[WTM][WTN], const float* __restrict__ wp,
    const float* __restrict__ gh, const float* __restrict__ frozen,
    const float* __restrict__ budget, float* __restrict__ out,
    a_t<BF>* __restrict__ keep, float* __restrict__ wdp,
    float* __restrict__ wmp, float* stage, int stage_floats, int vec_out,
    int trow, int m, int rk, const Segs& sg, int i0, int c0, int it,
    int stats, int round_w, float eps, float zero_threshold) {
  const int k = sg.k;
  // the columns [cb, ce) of the segments this tile's columns belong to
  int cb, ce;
  if constexpr (UNIFORM) {
    cb = (c0 / k) * k;
    ce = min(rk, ((min(rk, c0 + WBN) - 1) / k + 1) * k);
  } else {
    cb = sg.first(sg.seg(c0));
    const int slast = sg.seg(min(rk, c0 + WBN) - 1);
    ce = sg.first(slast) + sg.len(slast);
  }
  const int span = ce - cb;
  const bool staged = stage_floats >= WBM * span;
  int lbase[WTN], goff[WTN], wl[WTN];
  bool live[WTN], frz[WTN];
  float cd[WTN], cm[WTN];
#pragma unroll
  for (int v = 0; v < WTN; ++v) {
    const int c = c0 + w_col(v);
    live[v] = c < rk;
    if constexpr (UNIFORM) {
      const int r = live[v] ? c / k : cb / k, p = live[v] ? c - r * k : 0;
      wl[v] = k;
      lbase[v] = r * k - cb;
      goff[v] = r * k * k + p;
    } else {
      const int seg = live[v] ? sg.seg(c) : 0;
      const int st = live[v] ? sg.first(seg) : cb;
      wl[v] = live[v] ? sg.len(seg) : 0;
      lbase[v] = st - cb;
      goff[v] = st * k + (live[v] ? c - st : 0);
    }
    frz[v] = live[v] && lane_frozen(frozen, budget, c, it);
    cd[v] = cm[v] = 0.f;
  }
  if (staged) {
    // element (rl, cc) of the stage, walked without divisions
    const int dr = W_THREADS / span, dc = W_THREADS % span;
    int rl = threadIdx.x / span, cc = threadIdx.x % span;
    while (rl < WBM) {
      const int i = i0 + rl;
      const bool in = i < m;
      cp_async4(stage + rl * span + cc,
                in ? wp + (size_t)i * rk + cb + cc : wp, in ? 4 : 0);
      rl += dr;
      cc += dc;
      if (cc >= span) {
        cc -= span;
        ++rl;
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  // float4 stores of the thread's column groups that lie inside rk
  bool quad[WTN / 4];
#pragma unroll
  for (int h = 0; h < WTN / 4; ++h)
    quad[h] = vec_out && c0 + w_col(4 * h + 3) < rk;
#pragma unroll
  for (int u = 0; u < WTM; ++u) {
    const int i = i0 + w_row(u);
    float wn[WTN];
    if (i < m) {
      // srow[j] = Wp[i, cb + j]
      const float* srow =
          staged ? stage + w_row(u) * span : wp + (size_t)i * rk + cb;
      float denom[WTN];
#pragma unroll
      for (int v = 0; v < WTN; ++v) denom[v] = 0.f;
      for (int q = 0; q < k; ++q)
#pragma unroll
        for (int v = 0; v < WTN; ++v)
          if (UNIFORM || q < wl[v])
            denom[v] = fmaf(opnd<BF>(srow[lbase[v] + q]),
                            opnd<BF>(gh[goff[v] + q * k]), denom[v]);
#pragma unroll
      for (int v = 0; v < WTN; ++v) {
        wn[v] = 0.f;
        if (!live[v]) continue;
        const float w0 = srow[c0 + w_col(v) - cb];
        const float upd = frz[v] ? w0
                                 : mu_epilogue(w0, acc[u][v], denom[v], eps,
                                               zero_threshold);
        cd[v] = nan_max(cd[v], fabsf(upd - w0));
        cm[v] = nan_max(cm[v], fabsf(w0));
        wn[v] = UNIFORM ? upd : stored(upd, round_w);
      }
#pragma unroll
      for (int h = 0; h < WTN / 4; ++h) {
        float* o = out + (size_t)i * rk + c0 + w_col(4 * h);
        if (quad[h]) {
          *reinterpret_cast<float4*>(o) = make_float4(
              wn[4 * h], wn[4 * h + 1], wn[4 * h + 2], wn[4 * h + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (live[4 * h + e]) o[e] = wn[4 * h + e];
        }
      }
    } else {
#pragma unroll
      for (int v = 0; v < WTN; ++v) wn[v] = 0.f;
    }
    if (keep != nullptr)
#pragma unroll
      for (int h = 0; h < WTN / 4; ++h) {
        if constexpr (BF)
          *reinterpret_cast<uint2*>(keep +
                                    mn_core<WBN>(w_row(u), w_col(4 * h))) =
              make_uint2(bf16_bits(wn[4 * h]) | bf16_bits(wn[4 * h + 1]) << 16,
                         bf16_bits(wn[4 * h + 2]) |
                             bf16_bits(wn[4 * h + 3]) << 16);
        else
          *reinterpret_cast<float4*>(keep + w_row(u) * WBN + w_col(4 * h)) =
              make_float4(wn[4 * h], wn[4 * h + 1], wn[4 * h + 2],
                          wn[4 * h + 3]);
      }
  }
  if (!stats) return;  // the same for every thread of the block
  __syncthreads();     // the stage's last reads are done
  // column maxima over the tile: the GROUPS threads that share a column
  // each hold WTM of its rows
  constexpr int GROUPS = W_THREADS / (WBN / WTN);
  float* red_d = stage;                 // [GROUPS][WBN]
  float* red_m = stage + GROUPS * WBN;  // [GROUPS][WBN]
  const int g = w_group();
#pragma unroll
  for (int v = 0; v < WTN; ++v) {
    red_d[g * WBN + w_col(v)] = cd[v];
    red_m[g * WBN + w_col(v)] = cm[v];
  }
  __syncthreads();
  if (threadIdx.x < WBN) {
    const int c = c0 + threadIdx.x;
    float d = 0.f, mx = 0.f;
    for (int t = 0; t < GROUPS; ++t) {
      d = nan_max(d, red_d[t * WBN + threadIdx.x]);
      mx = nan_max(mx, red_m[t * WBN + threadIdx.x]);
    }
    if (c < rk) {
      wdp[(size_t)trow * rk + c] = d;
      wmp[(size_t)trow * rk + c] = mx;
    }
  }
  __syncthreads();  // the stage may be reused by the caller
}

// The tile-local W half; grid (ceil(rk / WBN), ceil(m / WBM)), max(ring,
// stage) of dynamic shared memory (w_stage_floats). VEC: 4-element loads
// of A and Hp; vec_out: float4 stores of out. Three blocks an SM: the 320
// tiles of the north star then run in one wave (at two, 1.2 waves; the
// register cap this sets costs a few spilled bytes, PERF.md).
template <bool VEC, bool BF, bool UNIFORM>
__global__ void __launch_bounds__(W_THREADS, 3)
w_block_update(const a_t<BF>* __restrict__ a, const float* __restrict__ wp,
               const float* __restrict__ hp, const float* __restrict__ gh,
               const float* __restrict__ frozen,
               const float* __restrict__ budget, float* __restrict__ out,
               float* __restrict__ wdp, float* __restrict__ wmp, int m, int n,
               int rk, Segs sg, int it, int stats, int stage_floats,
               int vec_out, int round_w, float eps, float zero_threshold) {
  extern __shared__ __align__(16) float w_ring[];
  const int c0 = blockIdx.x * WBN, i0 = blockIdx.y * WBM;
  float acc[WTM][WTN];
  w_numer_core<VEC, BF>(a, hp, m, n, rk, i0, c0, w_ring, acc);
  w_tile_epilogue<BF, UNIFORM>(acc, wp, gh, frozen, budget, out, nullptr,
                               wdp, wmp,
                      w_ring, stage_floats, vec_out, blockIdx.y, m, rk, sg,
                      i0, c0, it, stats, round_w, eps, zero_threshold);
}

// Floats of the W epilogue's stage: the WBM rows of the widest lane span a
// WBN-column tile can touch, when they fit 96 KB; else 0 (the
// denominators then read global memory).
int w_stage_floats(int rk, int k) {
  const int span = std::min(rk, WBN + 2 * (k - 1));
  return WBM * span <= 96 * 1024 / (int)sizeof(float) ? WBM * span : 0;
}

// CTAs per cluster of the join-the-updates pass: one per W tile of a chunk
constexpr int PAIR = SPLIT_ROWS / WBM;
// the fused H numerator tile: the WBN lane columns of the strip by HBN
// columns of A, FCV x 8 outputs a thread (h_step's layout)
constexpr int FCV = WBN * HBN / (W_THREADS * 8);
constexpr int FTCN = WBN / FCV, FTJN = HBN / 8;
static_assert(FCV % 4 == 0 && FTCN * FTJN == W_THREADS,
              "the fused H tile covers the strip's columns");
constexpr int FH_STAGE = GBK * HBN;
constexpr size_t STRIP_BYTES = sizeof(float) * SPLIT_ROWS * WBN;
constexpr size_t FH_RING_BYTES = sizeof(float) * GSTAGES * FH_STAGE;
// under bf16 operands the ring holds FB_NS stages of A (mn_core<HBN>) in
// the same bytes, each summed by two warpgroups, a 64-column half each
constexpr int FB_STAGE = GBK * HBN;  // bf16 per stage
constexpr int FB_NS = (int)(FH_RING_BYTES / (sizeof(bf16_t) * FB_STAGE));
static_assert(FB_NS >= 2 && W_THREADS == 2 * WG_THREADS && HBN == 128,
              "two warpgroups on the halves of a ring of two stages at "
              "least");
static_assert(2 * (W_THREADS / (WBN / WTN)) * WBN * sizeof(float) <=
                  W_RING_BYTES,
              "the W stats reduction reuses the ring");

// One pass of the join-the-updates schedule; grid (ceil(rk / WBN),
// splits * PAIR) in clusters of (1, PAIR, 1), STRIP_BYTES + max(W ring,
// H ring, stage) of dynamic shared memory: cluster (x, s) owns lane
// columns c0 .. c0+63 (c0 = x * WBN) and SPLIT_ROWS-row chunk s, and its
// CTA of rank r the chunk's rows from s * SPLIT_ROWS + r * WBM. With
// do_w, each CTA computes the W half of iteration `it` on its rows,
// exactly as w_block_update does, and keeps them (as the H product's
// operand: opnd of the stored value) in its part of the shared strip;
// without do_w the strip is opnd of the chunk's rows of wp. Then, with
// do_h, each CTA completes the strip from its peers' shared memory and
// computes the chunk's H-numerator partial part[s, c, j] = sum over the
// chunk's rows of W[row, c] * A[row, j] for the column tiles j0 = (r +
// PAIR t) * HBN, summed exactly as h_numer_split sums it: the float32
// chains, or under BF the same m64n64k16 wgmma steps over the strip
// (bf16, mn_core<WBN>: the strides of an H stage's W operand), each of
// the two warpgroups one 64-column half of the tile.
template <bool VEC, bool BF, bool UNIFORM>
__global__ void __cluster_dims__(1, PAIR, 1)
    __launch_bounds__(W_THREADS, 2)
wh_pass(const a_t<BF>* __restrict__ a, const float* __restrict__ wp,
        const float* __restrict__ hp, const float* __restrict__ gh,
        const float* __restrict__ frozen, const float* __restrict__ budget,
        float* __restrict__ out, float* __restrict__ wdp,
        float* __restrict__ wmp, float* __restrict__ part, int m, int n,
        int rk, Segs sg, int it, int do_w, int do_h, int stats,
        int stage_floats, int vec_out, int round_w, float eps,
        float zero_threshold) {
  using S = a_t<BF>;  // the strip's element
  extern __shared__ __align__(16) float pass_smem[];
  // [SPLIT_ROWS][WBN] (float32) or mn_core<WBN> (bf16): the chunk's W rows
  S* strip = reinterpret_cast<S*>(pass_smem);
  float* ring = pass_smem + SPLIT_ROWS * WBN;
  S* aring = reinterpret_cast<S*>(ring);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c0 = blockIdx.x * WBN, s = blockIdx.y / PAIR;
  const int mb = s * SPLIT_ROWS, me = min(m, mb + SPLIT_ROWS);
  const int i0 = mb + rank * WBM;
  // rank r's rows in either layout (mn_core<WBN>(r * WBM, 0) = r * WBM *
  // WBN)
  S* mine = strip + rank * WBM * WBN;
  if (do_w) {
    if (i0 < m) {  // the same for every thread of the block
      float acc[WTM][WTN];
      w_numer_core<VEC, BF>(a, hp, m, n, rk, i0, c0, ring, acc);
      w_tile_epilogue<BF, UNIFORM>(acc, wp, gh, frozen, budget, out,
                          do_h ? mine : nullptr, wdp, wmp, ring,
                          stage_floats, vec_out, i0 / WBM, m, rk, sg, i0, c0,
                          it, stats, round_w, eps, zero_threshold);
    } else if (do_h) {
      for (int e = threadIdx.x; e < WBM * WBN; e += W_THREADS) mine[e] = S(0);
    }
    if (!do_h) return;  // the same for every CTA of the cluster
    cluster.sync();     // every CTA's rows of the strip are written
    constexpr int QUADS = WBM * WBN * sizeof(S) / sizeof(float4);
    for (int peer = 0; peer < PAIR; ++peer) {
      if (peer == rank) continue;
      const float4* src = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(strip + peer * WBM * WBN, peer));
      float4* dst = reinterpret_cast<float4*>(strip + peer * WBM * WBN);
      for (int e = threadIdx.x; e < QUADS; e += W_THREADS) dst[e] = src[e];
    }
    cluster.sync();  // no CTA leaves while a peer still reads its rows
  } else {
    if (!do_h) return;
    for (int e = threadIdx.x; e < SPLIT_ROWS * WBN; e += W_THREADS) {
      const int t = e / WBN, cl = e % WBN;
      const int row = mb + t, c = c0 + cl;
      const float x =
          (row < me && c < rk) ? opnd<BF>(wp[(size_t)row * rk + c]) : 0.f;
      if constexpr (BF)
        strip[mn_core<WBN>(t, cl)] = (bf16_t)bf16_bits(x);
      else
        strip[e] = x;
    }
    __syncthreads();
  }
  const int stages = (me - mb + GBK - 1) / GBK;
  if constexpr (BF) {
    // warpgroup g sums the columns 64 g .. 64 g + 63 of each column tile
    const int wg = threadIdx.x / WG_THREADS, tid = threadIdx.x % WG_THREADS;
    for (int j0 = rank * HBN; j0 < n; j0 += PAIR * HBN) {
      auto load = [&](int kt) {
        load_mn<HBN, W_THREADS, VEC>(aring + (kt % FB_NS) * FB_STAGE, a, n,
                                     mb + kt * GBK, me, j0, threadIdx.x);
      };
#pragma unroll
      for (int kt = 0; kt < FB_NS - 1; ++kt) {
        if (kt < stages) load(kt);
        cp_async_commit();
      }
      float sum[32], d[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sum[i] = d[i] = 0.f;
      for (int kt = 0; kt < stages; ++kt) {
        cp_async_wait<FB_NS - 2>();
        fence_async_smem();
        __syncthreads();
        wg_step<1>(sum, d, h_w_desc(strip + mn_core<WBN>(kt * GBK, 0)),
                   h_a_desc(aring + (kt % FB_NS) * FB_STAGE, wg), [&] {
                     if (kt + FB_NS - 1 < stages) load(kt + FB_NS - 1);
                     cp_async_commit();
                   });
      }
      cp_async_wait<0>();
      __syncthreads();  // the ring is refilled by the next column tile
      h_store_frag<VEC>(sum, part, s, n, rk, rk, c0, j0 + 64 * wg, tid);
    }
  } else {
    const int tj = threadIdx.x % FTJN, tc = threadIdx.x / FTJN;
    for (int j0 = rank * HBN; j0 < n; j0 += PAIR * HBN) {
      float acc[FCV][8];
#pragma unroll
      for (int u = 0; u < FCV; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;
      auto load = [&](int kt) {
        load_cols<HBN, W_THREADS, VEC>(aring + (kt % GSTAGES) * FH_STAGE, a,
                                       n, mb + kt * GBK, me, j0);
      };
#pragma unroll
      for (int kt = 0; kt < GSTAGES - 1; ++kt) {
        if (kt < stages) load(kt);
        cp_async_commit();
      }
      for (int kt = 0; kt < stages; ++kt) {
        cp_async_wait<GSTAGES - 2>();
        __syncthreads();
        if (kt + GSTAGES - 1 < stages) load(kt + GSTAGES - 1);
        cp_async_commit();
        const float* as = aring + (kt % GSTAGES) * FH_STAGE;
#pragma unroll
        for (int kk = 0; kk < GBK; ++kk)
          h_step<FCV, FTCN, FTJN>(strip + (kt * GBK + kk) * WBN,
                                  as + kk * HBN, tc, tj, acc);
      }
      cp_async_wait<0>();
      __syncthreads();  // the ring is refilled by the next column tile
      h_store<FCV, FTCN, FTJN, VEC>(acc, part, s, n, rk, rk, c0, j0, tc, tj);
    }
  }
}

// The flags of a launch (the C entries' `flags`)
constexpr int BF16_OPERANDS = 1, BF16_W = 2, BF16_H = 4;

// One call's launch configuration. The pointers a call does not set stay
// null: a null frozen or budget freezes no lane, and the stats, the
// snapshots and the per-tile maxima are written only at a boundary.
struct Launch {
  const void* a = nullptr;
  const float *frozen = nullptr, *budget = nullptr;
  float *wd = nullptr, *wm = nullptr, *hd = nullptr, *hm = nullptr,
        *h_checks = nullptr, *part = nullptr, *gpart = nullptr,
        *gh = nullptr, *wdp = nullptr, *wmp = nullptr, *hraw = nullptr;
  bf16_t* wb = nullptr;  // the H product's bf16 copy of Wp
  Segs sg;
  int m, n, rk, k, nseg, iters = 1, check_block = 1, splits, mtiles;
  int round_w = 0, round_h = 0;
  float eps, zero_threshold;
  cudaStream_t st;
  size_t gram_smem, ep_smem, hg_smem, w_smem, pass_smem;
  dim3 numer_grid, gram_grid, hg_grid, w_grid;
  int red_blocks, stage_floats, vec_out = 0;

  // nseg segments; with a null `start` the uniform ones (nseg = rk / k)
  Launch(int m_, int n_, int rk_, int k_, float eps_, float zero_threshold_,
         void* stream, const int* start = nullptr,
         const int* width = nullptr, const int* of_col = nullptr,
         int nseg_ = 0) {
    m = m_, n = n_, rk = rk_, k = k_;
    sg.start = start, sg.width = width, sg.of_col = of_col, sg.k = k;
    nseg = start != nullptr ? nseg_ : rk / k;
    eps = eps_, zero_threshold = zero_threshold_;
    st = static_cast<cudaStream_t>(stream);
    splits = (m + SPLIT_ROWS - 1) / SPLIT_ROWS;
    mtiles = (m + WBM - 1) / WBM;
    stage_floats = w_stage_floats(rk, k);
    const size_t stage_bytes = sizeof(float) * stage_floats;
    gram_smem = sizeof(float) * GRAM_ROWS * k;
    ep_smem = sizeof(float) * (k + 2 * ROW_THREADS);
    hg_smem = sizeof(float) * k * (h_gram_cols(n, k) + 1);
    w_smem = std::max(W_RING_BYTES, stage_bytes);
    pass_smem =
        STRIP_BYTES + std::max({W_RING_BYTES, FH_RING_BYTES, stage_bytes});
    const int pair_blocks = (k * k + THREADS - 1) / THREADS;
    numer_grid = dim3((n + HBN - 1) / HBN, (rk + HBC - 1) / HBC, splits);
    gram_grid = dim3(nseg, splits, pair_blocks);
    hg_grid = dim3(nseg, pair_blocks);
    w_grid = dim3((rk + WBN - 1) / WBN, mtiles);
    red_blocks = (rk + ROW_THREADS - 1) / ROW_THREADS;
  }

  // the dynamic shared memory of the H half's kernels
  template <bool BF>
  cudaError_t set_h_smem() const {
    cudaError_t err;
    if ((err = set_smem((const void*)h_gram_partial<BF>, gram_smem)) !=
            cudaSuccess ||
        (err = set_smem((const void*)h_block_epilogue<BF>, ep_smem)) !=
            cudaSuccess)
      return err;
    return set_smem((const void*)h_gram_diag<BF>, hg_smem);
  }

  // the H numerator partials of w into part (VW / VA: 4-element copies
  // of the W operand / of A and stores of part); under BF the W operand
  // is wb, rounded from w first
  template <bool VW, bool VA, bool BF>
  void h_numer(const float* w) const {
    if constexpr (BF) {
      const size_t count = (size_t)m * rk;
      narrow_bf16<<<cast_blocks(count), 256, 0, st>>>(w, wb, count);
      h_numer_split<VW, VA, bf16_t><<<numer_grid, H_THREADS, H_RING_BYTES,
                                      st>>>(
          static_cast<const bf16_t*>(a), wb, part, m, n, rk);
    } else {
      h_numer_split<VW, VA, float><<<numer_grid, H_THREADS, H_RING_BYTES,
                                     st>>>(static_cast<const float*>(a), w,
                                           part, m, n, rk);
    }
  }

  // the W-Gram partials of w, then the epilogue of iteration `it` into
  // h_next from the numerator partials in part, with the stats and the
  // snapshot in boundary row brow (none when brow < 0)
  template <bool BF>
  void h_epilogue(const float* w, const float* h, float* h_next, int it,
                  int brow) const {
    h_gram_partial<BF><<<gram_grid, THREADS, gram_smem, st>>>(
        w, gpart, m, rk, sg, SPLIT_ROWS);
    h_block_epilogue<BF><<<rk, ROW_THREADS, ep_smem, st>>>(
        h, part, gpart, frozen, budget, h_next, round_h ? hraw : nullptr, hd,
        hm, check_block > 1 ? h_checks : nullptr, n, rk, sg, splits, it, brow,
        round_h, eps, zero_threshold);
  }

  // gh = the diagonal H-Gram of h
  template <bool BF>
  void h_gram(const float* h) const {
    h_gram_diag<BF><<<hg_grid, THREADS, hg_smem, st>>>(h, gh, n, sg);
  }

  // the H half of iteration `it` from the numerator partials in `part`:
  // the epilogue into h_next (stats and snapshot at a boundary), then the
  // diagonal H-Gram of the new H before its storage rounding
  template <bool BF>
  void h_half(const float* w, const float* h, float* h_next, int it) const {
    const bool boundary = (it + 1) % iters == 0;
    h_epilogue<BF>(w, h, h_next, it, boundary ? (it + 1) / iters - 1 : -1);
    h_gram<BF>(round_h ? hraw : h_next);
  }

  // the W half of iteration `it` into w_next from w, the new h and its
  // H-Gram g, with the per-tile maxima when `stats`
  template <bool VEC, bool BF, bool U>
  void w_update(const float* w, const float* h, const float* g,
                float* w_next, int it, int stats) const {
    w_block_update<VEC, BF, U><<<w_grid, W_THREADS, w_smem, st>>>(
        static_cast<const a_t<BF>*>(a), w, h, g, frozen, budget, w_next, wdp,
        wmp, m, n, rk, sg, it, stats, stage_floats, vec_out, round_w, eps,
        zero_threshold);
  }

  // the W stats of boundary row `brow` from the per-tile maxima
  void w_stats(int brow) const {
    w_stats_reduce<<<red_blocks, ROW_THREADS, 0, st>>>(
        wdp, wmp, wd + (size_t)brow * rk, wm + (size_t)brow * rk, rk, mtiles);
  }
};

// The phased iterations with the copy widths fixed: VN = 4-element copies
// of the n-strided operands (A, Hp, part), VW = of the H product's W
// operand; U: the uniform pool with float32 W (w_tile_epilogue).
template <bool VN, bool VW, bool BF, bool U>
cudaError_t phased(const Launch& L, const float* w_cur, const float* h_cur,
                   float* const (&w_dest)[2], float* const (&h_dest)[2]) {
  cudaError_t err;
  if ((err = set_smem((const void*)h_numer_split<VW, VN, a_t<BF>>,
                      H_RING_BYTES)) != cudaSuccess ||
      (err = set_smem((const void*)w_block_update<VN, BF, U>, L.w_smem)) !=
          cudaSuccess)
    return err;
  const int total = L.iters * L.check_block;
  for (int it = 0; it < total; ++it) {
    // iteration it writes the outputs when (total - 1 - it) is even, the
    // scratch buffers otherwise, so the last iteration lands in the output
    float* w_next = w_dest[(total - 1 - it) % 2];
    float* h_next = h_dest[(total - 1 - it) % 2];
    const bool boundary = (it + 1) % L.iters == 0;
    L.h_numer<VW, VN, BF>(w_cur);
    L.h_half<BF>(w_cur, h_cur, h_next, it);
    L.w_update<VN, BF, U>(w_cur, h_next, L.gh, w_next, it,
                          boundary ? 1 : 0);
    if (boundary) L.w_stats((it + 1) / L.iters - 1);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    w_cur = w_next;
    h_cur = h_next;
  }
  return cudaSuccess;
}

// The join-the-updates passes; VN and U as in phased (Wp is read by
// scalar loads only).
template <bool VN, bool BF, bool U>
cudaError_t joined(const Launch& L, const float* w_cur, const float* h_cur,
                   float* const (&w_dest)[2], float* const (&h_dest)[2]) {
  cudaError_t err;
  if ((err = set_smem((const void*)wh_pass<VN, BF, U>, L.pass_smem)) !=
      cudaSuccess)
    return err;
  const dim3 pass_grid((L.rk + WBN - 1) / WBN, L.splits * PAIR);
  const int total = L.iters * L.check_block;
  for (int p = 0; p <= total; ++p) {
    const bool do_w = p > 0, do_h = p < total;
    const bool w_boundary = do_w && p % L.iters == 0;
    float* w_next = do_w ? w_dest[(total - p) % 2] : nullptr;
    wh_pass<VN, BF, U><<<pass_grid, W_THREADS, L.pass_smem, L.st>>>(
        static_cast<const a_t<BF>*>(L.a), w_cur, h_cur, L.gh, L.frozen,
        L.budget, w_next, L.wdp, L.wmp, L.part, L.m, L.n, L.rk, L.sg, p - 1,
        do_w ? 1 : 0, do_h ? 1 : 0, w_boundary ? 1 : 0, L.stage_floats,
        L.vec_out, L.round_w, L.eps, L.zero_threshold);
    if (w_boundary) L.w_stats(p / L.iters - 1);
    if (do_w) w_cur = w_next;
    if (do_h) {
      float* h_next = h_dest[(total - 1 - p) % 2];
      L.h_half<BF>(w_cur, h_cur, h_next, p);
      h_cur = h_next;
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <bool BF, bool U>
cudaError_t run_widths(const Launch& L, bool fused, bool vn, bool vw,
                       const float* w_cur, const float* h_cur,
                       float* const (&w_dest)[2],
                       float* const (&h_dest)[2]) {
  if (fused)
    return vn ? joined<true, BF, U>(L, w_cur, h_cur, w_dest, h_dest)
              : joined<false, BF, U>(L, w_cur, h_cur, w_dest, h_dest);
  if (vn)
    return vw ? phased<true, true, BF, U>(L, w_cur, h_cur, w_dest, h_dest)
              : phased<true, false, BF, U>(L, w_cur, h_cur, w_dest, h_dest);
  return vw ? phased<false, true, BF, U>(L, w_cur, h_cur, w_dest, h_dest)
            : phased<false, false, BF, U>(L, w_cur, h_cur, w_dest, h_dest);
}

template <bool BF>
cudaError_t run_block(const Launch& L, bool fused, bool vn, bool vw,
                      const float* w_cur, const float* h_cur,
                      float* const (&w_dest)[2], float* const (&h_dest)[2]) {
  cudaError_t err = L.set_h_smem<BF>();
  if (err != cudaSuccess) return err;
  // the uniform pool with float32 W takes the epilogue without tables
  if (L.sg.start == nullptr && !L.round_w)
    return run_widths<BF, true>(L, fused, vn, vw, w_cur, h_cur, w_dest,
                                h_dest);
  return run_widths<BF, false>(L, fused, vn, vw, w_cur, h_cur, w_dest,
                               h_dest);
}

int block_iterations(const void* a, const void* wp_in, const void* hp_in,
                     const float* frozen, const float* budget, void* wp_out,
                     void* hp_out, float* wd, float* wm, float* hd,
                     float* hm, float* h_checks, float* wp_tmp,
                     float* hp_tmp, float* part, float* gpart, float* gh,
                     float* wdp, float* wmp, const int* seg_start,
                     const int* seg_width, const int* seg_of_col,
                     float* w_ext, float* h_ext, float* hraw, void* wb,
                     int m, int n, int rk, int k, int nseg, int iters,
                     int check_block, int flags, float eps,
                     float zero_threshold, void* stream, bool fused) {
  const bool bf = flags & BF16_OPERANDS, rw = flags & BF16_W,
             rh = flags & BF16_H;
  Launch L(m, n, rk, k, eps, zero_threshold, stream, seg_start, seg_width,
           seg_of_col, nseg);
  L.a = a, L.frozen = frozen, L.budget = budget;
  L.wd = wd, L.wm = wm, L.hd = hd, L.hm = hm, L.h_checks = h_checks;
  L.part = part, L.gpart = gpart, L.gh = gh, L.wdp = wdp, L.wmp = wmp;
  L.hraw = hraw, L.wb = static_cast<bf16_t*>(wb);
  L.iters = iters, L.check_block = check_block;
  L.round_w = rw ? 1 : 0, L.round_h = rh ? 1 : 0;
  // bf16 pool factors iterate in float32 work buffers (w_ext / h_ext in
  // the outputs' place) and are narrowed into the outputs at the end
  const int total = iters * check_block;
  float* const w_dest[2] = {rw ? w_ext : static_cast<float*>(wp_out),
                            wp_tmp};
  float* const h_dest[2] = {rh ? h_ext : static_cast<float*>(hp_out),
                            hp_tmp};
  // iteration 0 writes dest[(total - 1) % 2]; the entry buffer is the
  // other one
  const bool first_writes_out = total % 2 == 1;
  const float* w_cur =
      entry_buffer(wp_in, wp_out, w_dest[total % 2], (size_t)m * rk, rw,
                   first_writes_out, L.st);
  const float* h_cur =
      entry_buffer(hp_in, hp_out, h_dest[total % 2], (size_t)rk * n, rh,
                   first_writes_out, L.st);
  // the n-strided operands the products read (A, every H buffer, part)
  // and the rk-strided ones (every W buffer): 4-element copies, loads and
  // stores where all rows are aligned, 1-element ones otherwise, in the
  // same arithmetic
  const bool vn = rows_aligned(a, n, bf ? 2 : 4) &&
                  rows_aligned(h_cur, n) && rows_aligned(h_dest[0], n) &&
                  rows_aligned(h_dest[1], n) && rows_aligned(part, n);
  const bool vr = rows_aligned(w_cur, rk) && rows_aligned(w_dest[0], rk) &&
                  rows_aligned(w_dest[1], rk);
  const bool vw = bf ? rows_aligned(wb, rk, 2) : vr;
  L.vec_out = vr ? 1 : 0;
  cudaError_t err =
      bf ? run_block<true>(L, fused, vn, vw, w_cur, h_cur, w_dest, h_dest)
         : run_block<false>(L, fused, vn, vw, w_cur, h_cur, w_dest, h_dest);
  if (err != cudaSuccess) return err;
  if (rw)
    narrow_bf16<<<cast_blocks((size_t)m * rk), 256, 0, L.st>>>(
        w_dest[0], static_cast<bf16_t*>(wp_out), (size_t)m * rk);
  if (rh)
    narrow_bf16<<<cast_blocks((size_t)rk * n), 256, 0, L.st>>>(
        h_dest[0], static_cast<bf16_t*>(hp_out), (size_t)rk * n);
  return cudaGetLastError();
}

// The H half of the per-iteration pair: an iteration's h_numer_split,
// h_gram_partial and h_block_epilogue, with no lane frozen and no stats.
template <bool VW, bool VA, bool BF>
cudaError_t pair_h(const Launch& L, const float* wp, const float* hp,
                   float* out) {
  cudaError_t err = L.set_h_smem<BF>();
  if (err != cudaSuccess ||
      (err = set_smem((const void*)h_numer_split<VW, VA, a_t<BF>>,
                      H_RING_BYTES)) != cudaSuccess)
    return err;
  L.h_numer<VW, VA, BF>(wp);
  L.h_epilogue<BF>(wp, hp, out, 0, -1);
  return cudaGetLastError();
}

template <bool BF>
cudaError_t pair_h_widths(const Launch& L, const float* wp, const float* hp,
                          float* out) {
  const bool vw = BF ? rows_aligned(L.wb, L.rk, 2) : rows_aligned(wp, L.rk);
  const bool va = rows_aligned(L.a, L.n, BF ? 2 : 4) &&
                  rows_aligned(L.part, L.n);
  if (vw)
    return va ? pair_h<true, true, BF>(L, wp, hp, out)
              : pair_h<true, false, BF>(L, wp, hp, out);
  return va ? pair_h<false, true, BF>(L, wp, hp, out)
            : pair_h<false, false, BF>(L, wp, hp, out);
}

// The W half of the pair: an iteration's w_block_update, with no lane
// frozen and no stats.
template <bool VEC, bool BF>
cudaError_t pair_w(const Launch& L, const float* wp, const float* hp,
                   const float* gh, float* out) {
  cudaError_t err =
      set_smem((const void*)w_block_update<VEC, BF, true>, L.w_smem);
  if (err != cudaSuccess) return err;
  L.w_update<VEC, BF, true>(wp, hp, gh, out, 0, 0);
  return cudaGetLastError();
}

template <bool BF>
cudaError_t pair_w_widths(const Launch& L, const float* wp, const float* hp,
                          const float* gh, float* out) {
  return rows_aligned(L.a, L.n, BF ? 2 : 4) && rows_aligned(hp, L.n)
             ? pair_w<true, BF>(L, wp, hp, gh, out)
             : pair_w<false, BF>(L, wp, hp, gh, out);
}

}  // namespace

extern "C" {

// The version of this C interface (2: segments, flags and the option
// workspace).
int nmfx_block_abi() { return 2; }

// Rows of A per split of the H numerator (the caller sizes `part` and
// `gpart` with ceil(m / split_rows) splits).
int nmfx_block_split_rows() { return SPLIT_ROWS; }

// Rows of A per W tile (the caller sizes `wdp` and `wmp` with
// ceil(m / w_tile_rows) rows).
int nmfx_block_w_tile_rows() { return WBM; }

// iters * check_block MU iterations of the packed pool; see the top of
// this file. budget and h_checks may be null (check_block == 1).
// Workspace: wp_tmp (m, rk), hp_tmp (rk, n), part (splits, rk, n), gpart
// (splits, rk, k), gh (rk, k), wdp and wmp (ceil(m/128), rk); w_ext (m,
// rk) and h_ext / hraw (rk, n) float32 under bf16 W / H (flags 2 / 4),
// wb (m, rk) bf16 under bf16 operands (flags 1), else null. Segments:
// seg_start / seg_width (nseg) and seg_of_col (rk), or all null for the
// uniform pool of rk / k segments of k. Under flags & 1, a is bf16; under
// flags & 2 / 4, wp_in and wp_out / hp_in and hp_out are bf16. wp_out ==
// wp_in and hp_out == hp_in update the pool in place (alias_io).
int nmfx_block_iterations(
    const void* a, const void* wp_in, const void* hp_in, const float* frozen,
    const float* budget, void* wp_out, void* hp_out, float* wd, float* wm,
    float* hd, float* hm, float* h_checks, float* wp_tmp, float* hp_tmp,
    float* part, float* gpart, float* gh, float* wdp, float* wmp,
    const int* seg_start, const int* seg_width, const int* seg_of_col,
    float* w_ext, float* h_ext, float* hraw, void* wb, int m, int n, int rk,
    int k, int nseg, int iters, int check_block, int flags, float eps,
    float zero_threshold, void* stream) {
  return block_iterations(a, wp_in, hp_in, frozen, budget, wp_out, hp_out,
                          wd, wm, hd, hm, h_checks, wp_tmp, hp_tmp, part,
                          gpart, gh, wdp, wmp, seg_start, seg_width,
                          seg_of_col, w_ext, h_ext, hraw, wb, m, n, rk, k,
                          nseg, iters, check_block, flags, eps,
                          zero_threshold, stream, false);
}

// The same iterations in the join-the-updates order (T + 1 passes); the
// same arguments and workspace, and all outputs byte-equal to
// nmfx_block_iterations'.
int nmfx_block_iterations_fused(
    const void* a, const void* wp_in, const void* hp_in, const float* frozen,
    const float* budget, void* wp_out, void* hp_out, float* wd, float* wm,
    float* hd, float* hm, float* h_checks, float* wp_tmp, float* hp_tmp,
    float* part, float* gpart, float* gh, float* wdp, float* wmp,
    const int* seg_start, const int* seg_width, const int* seg_of_col,
    float* w_ext, float* h_ext, float* hraw, void* wb, int m, int n, int rk,
    int k, int nseg, int iters, int check_block, int flags, float eps,
    float zero_threshold, void* stream) {
  return block_iterations(a, wp_in, hp_in, frozen, budget, wp_out, hp_out,
                          wd, wm, hd, hm, h_checks, wp_tmp, hp_tmp, part,
                          gpart, gh, wdp, wmp, seg_start, seg_width,
                          seg_of_col, w_ext, h_ext, hraw, wb, m, n, rk, k,
                          nseg, iters, check_block, flags, eps,
                          zero_threshold, stream, true);
}

// The per-iteration pair. One call of each, in this order, from the same
// inputs and flags, gives Hp and Wp byte-equal to one
// nmfx_block_iterations iteration (iters = check_block = 1) with no lane
// frozen; flags & 1 (bf16 operands, a bf16) is the only flag they take:
//
// Hp -> out = epilogue(Hp, Wp^T A, (Wp^T Wp o B) Hp). Workspace: part
// (splits, rk, n), gpart (splits, rk, k), splits = ceil(m /
// split_rows); wb (m, rk) bf16 under flags & 1, else null.
int nmfx_fused_h_update(const void* a, const float* wp, const float* hp,
                        float* out, float* part, float* gpart, void* wb,
                        int m, int n, int rk, int k, int flags, float eps,
                        float zero_threshold, void* stream) {
  Launch L(m, n, rk, k, eps, zero_threshold, stream);
  L.a = a, L.part = part, L.gpart = gpart, L.wb = static_cast<bf16_t*>(wb);
  return flags & BF16_OPERANDS ? pair_h_widths<true>(L, wp, hp, out)
                               : pair_h_widths<false>(L, wp, hp, out);
}

// gh (rk/k, k, k) = each lane's k x k block of Hp Hp^T (h_gram_diag).
int nmfx_lane_gram(const float* hp, float* gh, int n, int rk, int k,
                   int flags, void* stream) {
  Launch L(0, n, rk, k, 0.f, 0.f, stream);
  L.gh = gh;
  const bool bf = flags & BF16_OPERANDS;
  const cudaError_t err =
      bf ? set_smem((const void*)h_gram_diag<true>, L.hg_smem)
         : set_smem((const void*)h_gram_diag<false>, L.hg_smem);
  if (err != cudaSuccess) return err;
  if (bf)
    L.h_gram<true>(hp);
  else
    L.h_gram<false>(hp);
  return cudaGetLastError();
}

// Wp -> out = epilogue(Wp, A Hp^T, Wp gh), gh nmfx_lane_gram's (rk/k, k,
// k) of the new Hp.
int nmfx_fused_w_update(const void* a, const float* wp, const float* hp,
                        const float* gh, float* out, int m, int n, int rk,
                        int k, int flags, float eps, float zero_threshold,
                        void* stream) {
  Launch L(m, n, rk, k, eps, zero_threshold, stream);
  L.a = a, L.vec_out = rows_aligned(out, rk) ? 1 : 0;
  return flags & BF16_OPERANDS ? pair_w_widths<true>(L, wp, hp, gh, out)
                               : pair_w_widths<false>(L, wp, hp, gh, out);
}

}  // extern "C"
