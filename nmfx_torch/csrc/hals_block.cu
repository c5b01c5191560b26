// Hand-written sm_90a block of full HALS iterations for the slot
// scheduler.
//
// Replaces nmfx/ops/pallas_mu.py:hals_block_iterations (_hals_block_kernel):
// iters * check_block HALS iterations (Cichocki-Phan coordinate sweeps)
// of the uniform packed slot pool in one call, with the operands, lane
// freezes, budget fence, per-boundary TolX stats and H snapshots of the
// mu block kernel (block_mu.cu, whose layout notes apply here).
//
// Per iteration, with the lane's factors f as updated so far
// (Gauss-Seidel, component order jj = 0..k-1):
//   H half: G = each lane's k x k block of Wp^T Wp, N = Wp^T A;
//           h[jj] <- clamp(h[jj] + (N[jj] - sum_q G[jj,q] h[q])
//                                  / (G[jj,jj] + eps))
//           for every column j; frozen rows keep h0.
//   W half: G = each lane's k x k block of hn hn^T, N = A hn^T;
//           w[jj] <- clamp(w[jj] + (N[jj] - sum_q w[q] G[q,jj])
//                                  / (G[jj,jj] + eps))
//           for every row i; frozen columns keep w0.
// clamp(x) = x <= zero_threshold ? 0 : x. A zero-padded component (a
// rank below k) has a zero numerator and a zero Gram row and column, so it
// stays exactly zero, and it adds exact zeros to the other components'
// sums. Boundary stats and snapshots are those of the mu block kernel;
// with check_block == 1 the stats come from the last iteration.
//
// Every output is one chain in a fixed order, so the results depend on
// m, n and k only (not on a lane's slot or the slot count), and on no
// tiling: the H numerator partial of split s is an fmaf chain from +0
// over the rows of SPLIT_ROWS-chunk s in order, the W-Gram partial
// likewise; the H sweep's numerator and Gram are 0 + partial 0 +
// partial 1 + ... in split order; the W numerator is an fmaf chain from
// +0 over j = 0..n-1 and the H-Gram one over the columns of H; each
// sweep step's dot is an fmaf chain over q = 0..k-1 against the
// components as updated so far. No atomics.
//
// What bounds it on an H100: as the mu block kernel, the two numerator
// products (4*m*n*rk FLOP an iteration) on the CUDA cores, f32 FMA (the
// tensor cores' TF32 would change every chain); the sweeps add
// O((m + n)*rk*k) operations. Both products run on block_gemm.cuh's
// register-tiled, pipelined tiles, whose chains are those above; under
// bf16 operands on its wgmma tiles (block_gemm.cuh's contract: the same
// K order in every caller), which return the W numerators in the same
// per-thread layout and hand the H tile's hook each stage's rows.
//
// What the design does about the TPU kernel's structure: the Pallas
// kernel conjugates the Grams with a permutation matrix (_perm_matrix)
// only because Mosaic has no strided gather; here a thread indexes a
// lane's components directly. The factors stay in device memory, as in
// the mu block kernel, and each iteration enqueues four kernels (six at a
// boundary) with no host sync. Both halves tile the lane columns in whole
// lanes (L = 64 / k a tile), so a lane's Gram and sweep stay in the CTA
// that computes its numerators:
//   1. h_numer_gram: the split-m H numerator partials (block_gemm.cuh's
//      h_numer_tile) with the W-Gram partials folded in: the CTAs of a
//      (lane tile, split) share its lanes' k x k pairs, each summed from
//      the Wp rows the product stages anyway;
//   2. hals_sweep over H: a block per (lane, SWEEP_POS columns) whose
//      warps sum the partials in split order, one warp sweeping; per-block
//      row maxima at a boundary by warp shuffles (then w_stats_reduce over
//      the column blocks) and the snapshot;
//   3. h_gram_diag (block_common.cuh): the H-Gram;
//   4. w_sweep_tile: the W product and the W sweep in one CTA per (WBM
//      rows, L lanes): w_numer_core on the tile's columns, its lanes'
//      numerators staged in shared memory beside the rows' old W (copied
//      while the product runs) and the lanes' H-Grams, each (row, lane)
//      swept there in place, then W and at a boundary the tile's column
//      maxima written from shared memory (then w_stats_reduce over the
//      row tiles).
// A lane wider than a tile (k > 64) runs the same chains on other tiles:
// h_numer_split and h_gram_partial for the H half, w_numer_store into the
// aht workspace and hals_sweep for the W half.
//
// Options, as in block_mu.cu (flags: 1 bf16 operands, 2 / 4 bf16 pool
// W / H; wp_out == wp_in and hp_out == hp_in for alias_io): under bf16
// operands the reference casts only the products' operands here (A and
// Wp in the H numerator and the W-Gram, the fresh H in the H-Gram, A and
// the new H in the W numerator); the sweeps stay float32. The pool is
// uniform (segment ids iota // k), as the reference's HALS kernel takes
// no other.

#include <cuda_runtime.h>
#include <stddef.h>

#include <algorithm>

#include "block_common.cuh"
#include "block_gemm.cuh"

namespace {

// positions (columns of H; rows of W when k > WBN) per block of
// hals_sweep
constexpr int SWEEP_POS = 32;
// threads of hals_sweep: SWEEP_WARPS warps sum the numerators, one sweeps
constexpr int SWEEP_WARPS = 8;
constexpr int SWEEP_THREADS = 32 * SWEEP_WARPS;
static_assert(SWEEP_POS == 32, "one warp sweeps the block's positions");
// groups of rows in the W tile's column maxima: one per WBN threads
constexpr int W_GROUPS = W_THREADS / WBN;
static_assert(W_THREADS % WBN == 0, "whole column groups");

// Shared memory of h_numer_gram: the ring, then per Gram pair of the CTA
// its accumulator and its two columns in the stage.
inline size_t h_numer_gram_smem(int pairs_per_cta) {
  return H_RING_BYTES + (sizeof(float) + sizeof(int)) * pairs_per_cta;
}

// The H numerator partials (h_numer_tile) on lane-aligned column tiles,
// with the W-Gram partials folded in, for k <= HBC; grid (ceil(n / HBN),
// ceil(lanes / (HBC / k)), splits), h_numer_gram_smem(ceil(HBC / k * k *
// k / gridDim.x)) of dynamic shared memory. Column tile y holds the nl
// whole lanes from lane l0 = y * (HBC / k): columns c0 = l0 * k .. cend =
// c0 + nl * k. The gridDim.x CTAs of a (column tile, split) share its nl
// * k * k Gram pairs, pair e going to CTA e % gridDim.x; each pair (lane
// l0 + ll, p, q) sums gpart[s, l0 + ll, p, q] = sum over the chunk's rows
// t of Wp[t, c0 + ll*k + p] * Wp[t, c0 + ll*k + q], fmaf from +0 in row
// order (h_gram_partial's chain), in shared memory from each stage of the
// product.
template <bool VW, bool VA, class T>
__global__ void __launch_bounds__(H_THREADS, 3)
h_numer_gram(const T* __restrict__ a, const T* __restrict__ wp,
             float* __restrict__ part, float* __restrict__ gpart, int m,
             int n, int rk, int k) {
  extern __shared__ __align__(16) float hg_smem[];
  const int hl = HBC / k, lanes = rk / k;
  const int l0 = blockIdx.y * hl, nl = min(hl, lanes - l0);
  const int c0 = l0 * k, pairs = nl * k * k;
  const int nbx = gridDim.x, bx = blockIdx.x;
  const int mine = (pairs - bx + nbx - 1) / nbx;  // this CTA's pairs
  float* gacc = hg_smem + GSTAGES * H_STAGE;
  int* gcol = reinterpret_cast<int*>(gacc + mine);
  // each thread owns pairs i = threadIdx.x + H_THREADS * round of the CTA
  // and alone reads and writes their accumulators
  for (int i = threadIdx.x; i < mine; i += H_THREADS) {
    const int e = bx + nbx * i;
    const int ll = e / (k * k), p = e / k % k, q = e % k;
    gacc[i] = 0.f;
    gcol[i] = (ll * k + p) | (ll * k + q) << 16;
  }
  auto gram_stage = [&](const T* ws) {
    for (int i = threadIdx.x; i < mine; i += H_THREADS) {
      const int cp = gcol[i] & 0xffff, cq = gcol[i] >> 16;
      float g = gacc[i];
#pragma unroll
      for (int kk = 0; kk < GBK; ++kk)
        g = fmaf(to_f(ws[h_wst<T>(kk, cp)]), to_f(ws[h_wst<T>(kk, cq)]), g);
      gacc[i] = g;
    }
  };
  h_numer_tile<VW, VA, T>(a, wp, part, m, n, rk, c0, c0 + nl * k, hg_smem,
                          gram_stage);
  for (int i = threadIdx.x; i < mine; i += H_THREADS) {
    const int e = bx + nbx * i;
    gpart[((size_t)blockIdx.z * lanes + l0) * k * k + e] = gacc[i];
  }
}

// One HALS sweep over the k components of lane r = blockIdx.x at
// positions x = blockIdx.y * SWEEP_POS + lane id < `positions`.
// Component q of the lane at position x sits at f0[x*sx + (r*k + q)*sq]
// (H: sx = 1, sq = n; W: sx = rk, sq = 1). Its numerator is the sum over
// `splits` partials, in split order from +0, of numer[s*nstride + the
// same offset]; the lane's Gram the sum over splits of gram[s*gstride +
// (r*k + p)*k + q]. The block's SWEEP_WARPS warps sum the numerators (a
// component each in turn) and the Gram into shared memory, warp 0 sweeps,
// then each warp writes its components: out (and snap, when not null) at
// the same offsets, rounded to bf16 when `round` (raw, when not null,
// unrounded), frozen components keeping f0, and with `stats` the block's
// maxima over its positions of |update - f0| (before the rounding) and
// |f0| per component c = r*k + jj, by warp shuffles, to dp / mp
// [blockIdx.y * rk + c].
__global__ void __launch_bounds__(SWEEP_THREADS)
hals_sweep(const float* __restrict__ f0, const float* __restrict__ numer,
           const float* __restrict__ gram, const float* __restrict__ frozen,
           const float* __restrict__ budget, float* __restrict__ out,
           float* __restrict__ snap, float* __restrict__ raw,
           float* __restrict__ dp, float* __restrict__ mp, int positions,
           int sx, int sq, int rk, int k, int splits, size_t nstride,
           size_t gstride, int it, int stats, int round, float eps,
           float zero_threshold) {
  extern __shared__ float sm[];
  float* g = sm;                    // [k][k] the lane's Gram
  float* num = g + k * k;           // [k][SWEEP_POS] the numerators
  float* fv = num + k * SWEEP_POS;  // [k][SWEEP_POS] the sweep
  const int r = blockIdx.x, t = threadIdx.x;
  const int lane = t % SWEEP_POS, warp = t / SWEEP_POS;
  const int x = blockIdx.y * SWEEP_POS + lane;
  const bool own = x < positions;
  for (int e = t; e < k * k; e += SWEEP_THREADS) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s)
      v += gram[(size_t)s * gstride + (size_t)r * k * k + e];
    g[e] = v;
  }
  const size_t base = (size_t)x * sx + (size_t)r * k * sq;
  if (own)
    for (int q = warp; q < k; q += SWEEP_WARPS) {
      const size_t off = base + (size_t)q * sq;
      float v = 0.f;
#pragma unroll 4
      for (int s = 0; s < splits; ++s)
        v += numer[(size_t)s * nstride + off];
      num[q * SWEEP_POS + lane] = v;
      fv[q * SWEEP_POS + lane] = f0[off];
    }
  __syncthreads();
  if (own && warp == 0) {
    for (int jj = 0; jj < k; ++jj) {
      float dot = 0.f;
      for (int q = 0; q < k; ++q)
        dot = fmaf(g[jj * k + q], fv[q * SWEEP_POS + lane], dot);
      const float v = fv[jj * SWEEP_POS + lane] +
                      (num[jj * SWEEP_POS + lane] - dot) /
                          (g[jj * k + jj] + eps);
      fv[jj * SWEEP_POS + lane] = v <= zero_threshold ? 0.f : v;
    }
  }
  __syncthreads();
  for (int jj = warp; jj < k; jj += SWEEP_WARPS) {
    const int c = r * k + jj;
    float d = 0.f, mx = 0.f;
    if (own) {
      const size_t off = base + (size_t)jj * sq;
      const float v0 = f0[off];
      const float v = lane_frozen(frozen, budget, c, it)
                          ? v0 : fv[jj * SWEEP_POS + lane];
      const float vs = stored(v, round);
      out[off] = vs;
      if (snap != nullptr) snap[off] = vs;
      if (raw != nullptr) raw[off] = v;
      d = fabsf(v - v0);
      mx = fabsf(v0);
    }
    if (!stats) continue;  // the same for every thread of the block
#pragma unroll
    for (int w = SWEEP_POS / 2; w > 0; w >>= 1) {
      d = nan_max(d, __shfl_xor_sync(0xffffffffu, d, w));
      mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    }
    if (lane == 0) {
      dp[(size_t)blockIdx.y * rk + c] = d;
      mp[(size_t)blockIdx.y * rk + c] = mx;
    }
  }
}

// Row stride of the W tile's shared stages: the widest span rounded up
// to odd, so a warp's 32 consecutive rows fall in 32 banks.
inline __host__ __device__ int w_stage_ld(int k) { return (WBN / k * k) | 1; }

// Offsets (floats) of the W tile's shared memory, for k <= WBN: the
// numerators over the ring, the rows' old W, the lanes' H-Grams, the
// columns' freeze flags, the column maxima; the last is the total.
struct WTileSmem {
  int ld, w0, gh, frz, red, total;
  __host__ __device__ explicit WTileSmem(int k)
      : ld(w_stage_ld(k)),
        w0(WBM * ld > 2 * W_STAGE ? WBM * ld : 2 * W_STAGE),
        gh(w0 + WBM * ld),
        frz(gh + WBN / k * k * k),
        red(frz + WBN),
        total(red + 2 * W_GROUPS * WBN) {}
};

// The W half of one iteration for k <= WBN; grid (ceil(lanes / L),
// ceil(m / WBM)), L = WBN / k, WTileSmem(k).total floats of dynamic
// shared memory (69 KB at k = 10), two CTAs an SM (measured faster than
// three, PERF.md). CTA (bx, by) owns rows i0 = by * WBM .. and the span =
// nl * k columns from c0 = bx * L * k of its nl <= L whole lanes; the
// rest of its WBN product columns belong to the next CTA's lanes and are
// dropped. out[i, c] is the sweep of row i's lane over 0 + (A hp^T)[i,
// c] (w_numer_core's chain), the lane's Gram 0 + gh and the row's old
// W, or wp[i, c] on a frozen column; with `stats`, the tile's column
// maxima of |update - wp| (before out's bf16 rounding under round_w)
// and |wp| go to row by of wdp / wmp. VEC: 4-element loads of A and hp.
template <bool VEC, bool BF>
__global__ void __launch_bounds__(W_THREADS, 2)
w_sweep_tile(const a_t<BF>* __restrict__ a, const float* __restrict__ hp,
             const float* __restrict__ wp, const float* __restrict__ gh,
             const float* __restrict__ frozen,
             const float* __restrict__ budget, float* __restrict__ out,
             float* __restrict__ wdp, float* __restrict__ wmp, int m, int n,
             int rk, int k, int it, int stats, int round_w, float eps,
             float zero_threshold) {
  extern __shared__ __align__(16) float w_smem[];
  const WTileSmem lay(k);
  const int ld = lay.ld;
  float* num = w_smem;  // [WBM][ld]: the numerators, then the new W
  float* w0s = w_smem + lay.w0;    // [WBM][ld]: the rows' old W
  float* ghs = w_smem + lay.gh;    // [nl][k][k]
  float* frz = w_smem + lay.frz;   // [span]: 1 on a frozen column
  float* red = w_smem + lay.red;   // [2][W_GROUPS][WBN]
  const int L = WBN / k;
  const int l0 = blockIdx.x * L, nl = min(L, rk / k - l0);
  const int span = nl * k, c0 = l0 * k;
  const int i0 = blockIdx.y * WBM, rows = min(WBM, m - i0);
  // element (rl, cl) of a rows x span stage, walked without divisions
  const int dr = W_THREADS / span, dc = W_THREADS % span;
  {
    int rl = threadIdx.x / span, cl = threadIdx.x % span;
    while (rl < rows) {
      cp_async4(w0s + rl * ld + cl, wp + (size_t)(i0 + rl) * rk + c0 + cl,
                4);
      rl += dr;
      cl += dc;
      if (cl >= span) {
        cl -= span;
        ++rl;
      }
    }
    cp_async_commit();  // in flight while the product runs
  }
  for (int e = threadIdx.x; e < span * k; e += W_THREADS)
    ghs[e] = 0.f + gh[(size_t)c0 * k + e];
  for (int cl = threadIdx.x; cl < span; cl += W_THREADS)
    frz[cl] = lane_frozen(frozen, budget, c0 + cl, it) ? 1.f : 0.f;
  float acc[WTM][WTN];
  w_numer_core<VEC, BF>(a, hp, m, n, rk, i0, c0, w_smem, acc);
  // the ring is free: the core ends on a barrier
#pragma unroll
  for (int u = 0; u < WTM; ++u)
#pragma unroll
    for (int v = 0; v < WTN; ++v)
      if (w_row(u) < rows && w_col(v) < span)
        num[w_row(u) * ld + w_col(v)] = acc[u][v];
  cp_async_wait<0>();
  __syncthreads();
  // the sweep of each (row, lane), in place over its numerators: at step
  // jj, components q < jj hold their new values in num, q >= jj their
  // old ones in w0s
  for (int e = threadIdx.x; e < WBM * nl; e += W_THREADS) {
    const int rl = e % WBM, ll = e / WBM;
    if (rl >= rows) continue;
    float* f = num + rl * ld + ll * k;
    const float* f0 = w0s + rl * ld + ll * k;
    const float* g = ghs + ll * k * k;
    for (int jj = 0; jj < k; ++jj) {
      const float nm = 0.f + f[jj];
      float dot = 0.f;
      for (int q = 0; q < jj; ++q) dot = fmaf(g[jj * k + q], f[q], dot);
      for (int q = jj; q < k; ++q) dot = fmaf(g[jj * k + q], f0[q], dot);
      const float v = f0[jj] + (nm - dot) / (g[jj * k + jj] + eps);
      f[jj] = v <= zero_threshold ? 0.f : v;
    }
  }
  __syncthreads();
  {
    int rl = threadIdx.x / span, cl = threadIdx.x % span;
    while (rl < rows) {
      const float v0 = w0s[rl * ld + cl];
      const float v = frz[cl] > 0.f ? v0 : num[rl * ld + cl];
      out[(size_t)(i0 + rl) * rk + c0 + cl] = stored(v, round_w);
      num[rl * ld + cl] = v;
      rl += dr;
      cl += dc;
      if (cl >= span) {
        cl -= span;
        ++rl;
      }
    }
  }
  if (!stats) return;  // the same for every thread of the block
  __syncthreads();
  const int cl = threadIdx.x % WBN, grp = threadIdx.x / WBN;
  if (cl < span) {
    float d = 0.f, mx = 0.f;
    for (int rl = grp; rl < rows; rl += W_GROUPS) {
      const float v0 = w0s[rl * ld + cl];
      d = nan_max(d, fabsf(num[rl * ld + cl] - v0));
      mx = nan_max(mx, fabsf(v0));
    }
    red[grp * WBN + cl] = d;
    red[(W_GROUPS + grp) * WBN + cl] = mx;
  }
  __syncthreads();
  if (threadIdx.x < span) {
    float d = 0.f, mx = 0.f;
    for (int g = 0; g < W_GROUPS; ++g) {
      d = nan_max(d, red[g * WBN + threadIdx.x]);
      mx = nan_max(mx, red[(W_GROUPS + g) * WBN + threadIdx.x]);
    }
    wdp[(size_t)blockIdx.y * rk + c0 + threadIdx.x] = d;
    wmp[(size_t)blockIdx.y * rk + c0 + threadIdx.x] = mx;
  }
}

// aht[i, c] = sum over j of A[i, j] * Hp[c, j] (w_numer_core's chain),
// for k > WBN; grid (ceil(rk / WBN), ceil(m / WBM)), W_RING_BYTES of
// dynamic shared memory.
template <bool VEC, bool BF>
__global__ void __launch_bounds__(W_THREADS, 3)
w_numer_store(const a_t<BF>* __restrict__ a, const float* __restrict__ hp,
              float* __restrict__ aht, int m, int n, int rk) {
  extern __shared__ __align__(16) float w_ring[];
  const int c0 = blockIdx.x * WBN, i0 = blockIdx.y * WBM;
  float acc[WTM][WTN];
  w_numer_core<VEC, BF>(a, hp, m, n, rk, i0, c0, w_ring, acc);
#pragma unroll
  for (int u = 0; u < WTM; ++u) {
    const int i = i0 + w_row(u);
    if (i >= m) continue;
#pragma unroll
    for (int v = 0; v < WTN; ++v) {
      const int c = c0 + w_col(v);
      if (c < rk) aht[(size_t)i * rk + c] = acc[u][v];
    }
  }
}

struct Launch {
  const void* a;
  const float *frozen, *budget;
  float *wd, *wm, *hd, *hm, *h_checks, *part, *gpart, *gh, *aht, *dp, *mp,
      *hraw;
  bf16_t* wb;
  int m, n, rk, k, iters, check_block, round_w, round_h;
  float eps, zero_threshold;
  cudaStream_t st;
};

// The iterations with the copy widths fixed: VN = 4-element copies of the
// n-strided operands (A, every H buffer, part), VW = of the H product's
// W operand (every W buffer, or its bf16 copy under BF).
template <bool VN, bool VW, bool BF>
cudaError_t iterate(const Launch& L, const float* w_cur, const float* h_cur,
                    float* const (&w_dest)[2], float* const (&h_dest)[2]) {
  using T = a_t<BF>;
  const int m = L.m, n = L.n, rk = L.rk, k = L.k;
  const T* a = static_cast<const T*>(L.a);
  const int lanes = rk / k;
  const int splits = (m + SPLIT_ROWS - 1) / SPLIT_ROWS;
  Segs sg;
  sg.k = k;
  // whole lanes in every column tile: the W-Gram folded into the H
  // product, the W sweep into the W product
  const bool whole = k <= HBC && k <= WBN;
  const int hl = whole ? HBC / k : 1, wl = whole ? WBN / k : 1;
  const dim3 numer_grid((n + HBN - 1) / HBN,
                        whole ? (lanes + hl - 1) / hl : (rk + HBC - 1) / HBC,
                        splits);
  const size_t numer_smem =
      whole ? h_numer_gram_smem((hl * k * k + numer_grid.x - 1) /
                                numer_grid.x)
            : H_RING_BYTES;
  // 4-element copies of Wp need lane-aligned tiles to start on 4 columns
  const bool vw = VW && (!whole || hl * k % 4 == 0);
  const dim3 gram_grid(lanes, splits, (k * k + THREADS - 1) / THREADS);
  const size_t gram_smem = sizeof(float) * GRAM_ROWS * k;
  const size_t hg_smem = sizeof(float) * k * (h_gram_cols(n, k) + 1);
  const dim3 hg_grid(lanes, (k * k + THREADS - 1) / THREADS);
  const size_t sweep_smem = sizeof(float) * (k * k + 2 * k * SWEEP_POS);
  const size_t tile_smem = whole ? sizeof(float) * WTileSmem(k).total : 0;
  const dim3 tile_grid((lanes + wl - 1) / wl, (m + WBM - 1) / WBM);
  const dim3 store_grid((rk + WBN - 1) / WBN, (m + WBM - 1) / WBM);
  const int jtiles = (n + SWEEP_POS - 1) / SWEEP_POS;
  const int mtiles = whole ? (m + WBM - 1) / WBM
                           : (m + SWEEP_POS - 1) / SWEEP_POS;
  const int red_blocks = (rk + ROW_THREADS - 1) / ROW_THREADS;
  cudaError_t err;
  if ((err = set_smem((const void*)h_numer_gram<true, VN, T>, numer_smem)) !=
          cudaSuccess ||
      (err = set_smem((const void*)h_numer_gram<false, VN, T>,
                      numer_smem)) != cudaSuccess ||
      (err = set_smem((const void*)h_numer_split<VW, VN, T>,
                      H_RING_BYTES)) != cudaSuccess ||
      (err = set_smem((const void*)h_gram_partial<BF>, gram_smem)) !=
          cudaSuccess ||
      (err = set_smem((const void*)hals_sweep, sweep_smem)) != cudaSuccess ||
      (err = set_smem((const void*)h_gram_diag<BF>, hg_smem)) !=
          cudaSuccess ||
      (err = set_smem((const void*)w_sweep_tile<VN, BF>, tile_smem)) !=
          cudaSuccess ||
      (err = set_smem((const void*)w_numer_store<VN, BF>, W_RING_BYTES)) !=
          cudaSuccess)
    return err;
  const int total = L.iters * L.check_block;
  for (int it = 0; it < total; ++it) {
    // iteration it writes the outputs when (total - 1 - it) is even, the
    // scratch buffers otherwise, so the last iteration lands in the output
    float* w_next = w_dest[(total - 1 - it) % 2];
    float* h_next = h_dest[(total - 1 - it) % 2];
    const bool boundary = (it + 1) % L.iters == 0;
    const int brow = boundary ? (it + 1) / L.iters - 1 : -1;
    float* snap = (boundary && L.check_block > 1)
                      ? L.h_checks + (size_t)brow * rk * n : nullptr;
    // the H product's W operand: w_cur, or its bf16 copy
    const T* wop;
    if constexpr (BF) {
      narrow_bf16<<<cast_blocks((size_t)m * rk), 256, 0, L.st>>>(
          w_cur, L.wb, (size_t)m * rk);
      wop = L.wb;
    } else {
      wop = w_cur;
    }
    if (!whole) {
      h_numer_split<VW, VN, T><<<numer_grid, H_THREADS, H_RING_BYTES, L.st>>>(
          a, wop, L.part, m, n, rk);
      h_gram_partial<BF><<<gram_grid, THREADS, gram_smem, L.st>>>(
          w_cur, L.gpart, m, rk, sg, SPLIT_ROWS);
    } else if (vw) {
      h_numer_gram<true, VN, T><<<numer_grid, H_THREADS, numer_smem, L.st>>>(
          a, wop, L.part, L.gpart, m, n, rk, k);
    } else {
      h_numer_gram<false, VN, T><<<numer_grid, H_THREADS, numer_smem, L.st>>>(
          a, wop, L.part, L.gpart, m, n, rk, k);
    }
    hals_sweep<<<dim3(lanes, jtiles), SWEEP_THREADS, sweep_smem, L.st>>>(
        h_cur, L.part, L.gpart, L.frozen, L.budget, h_next, snap,
        L.round_h ? L.hraw : nullptr, L.dp, L.mp, n, 1, n, rk, k, splits,
        (size_t)rk * n, (size_t)rk * k, it, boundary ? 1 : 0, L.round_h,
        L.eps, L.zero_threshold);
    if (boundary)
      w_stats_reduce<<<red_blocks, ROW_THREADS, 0, L.st>>>(
          L.dp, L.mp, L.hd + (size_t)brow * rk, L.hm + (size_t)brow * rk, rk,
          jtiles);
    // the H-Gram of the new H before its storage rounding
    h_gram_diag<BF><<<hg_grid, THREADS, hg_smem, L.st>>>(
        L.round_h ? L.hraw : h_next, L.gh, n, sg);
    if (whole) {
      w_sweep_tile<VN, BF><<<tile_grid, W_THREADS, tile_smem, L.st>>>(
          a, h_next, w_cur, L.gh, L.frozen, L.budget, w_next, L.dp, L.mp, m,
          n, rk, k, it, boundary ? 1 : 0, L.round_w, L.eps,
          L.zero_threshold);
    } else {
      w_numer_store<VN, BF><<<store_grid, W_THREADS, W_RING_BYTES, L.st>>>(
          a, h_next, L.aht, m, n, rk);
      hals_sweep<<<dim3(lanes, mtiles), SWEEP_THREADS, sweep_smem, L.st>>>(
          w_cur, L.aht, L.gh, L.frozen, L.budget, w_next, nullptr, nullptr,
          L.dp, L.mp, m, rk, 1, rk, k, 1, 0, 0, it, boundary ? 1 : 0,
          L.round_w, L.eps, L.zero_threshold);
    }
    if (boundary)
      w_stats_reduce<<<red_blocks, ROW_THREADS, 0, L.st>>>(
          L.dp, L.mp, L.wd + (size_t)brow * rk, L.wm + (size_t)brow * rk, rk,
          mtiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    w_cur = w_next;
    h_cur = h_next;
  }
  return cudaSuccess;
}

template <bool BF>
cudaError_t run_widths(const Launch& L, bool vn, bool vw, const float* w_cur,
                       const float* h_cur, float* const (&w_dest)[2],
                       float* const (&h_dest)[2]) {
  if (vn)
    return vw ? iterate<true, true, BF>(L, w_cur, h_cur, w_dest, h_dest)
              : iterate<true, false, BF>(L, w_cur, h_cur, w_dest, h_dest);
  return vw ? iterate<false, true, BF>(L, w_cur, h_cur, w_dest, h_dest)
            : iterate<false, false, BF>(L, w_cur, h_cur, w_dest, h_dest);
}

}  // namespace

extern "C" {

// Rows of A per split of the H numerator (the caller sizes `part` and
// `gpart` with ceil(m / split_rows) splits).
int nmfx_block_split_rows() { return SPLIT_ROWS; }

// Rows of W per tile of the W half (k <= w_tile_cols).
int nmfx_block_w_tile_rows() { return WBM; }

// Columns of the W half's product tile: a lane of k <= w_tile_cols
// columns is swept in the tile that computes its numerators; a wider one
// goes through the aht workspace.
int nmfx_hals_w_tile_cols() { return WBN; }

// Positions (columns of H; rows of W when k > w_tile_cols) per block of
// the sweeps.
int nmfx_hals_sweep_positions() { return SWEEP_POS; }

// The version of this C interface (2: flags and the option workspace).
int nmfx_block_abi() { return 2; }

// iters * check_block HALS iterations of the packed pool; see the top of
// this file and of block_mu.cu. budget and h_checks may be null
// (check_block == 1). Workspace: wp_tmp (m, rk), hp_tmp (rk, n), part
// (splits, rk, n), gpart (splits, rk/k, k, k), gh (rk/k, k, k), aht
// (m, rk) when k > w_tile_cols (unused, and may be empty, otherwise),
// dp and mp (max(ceil(n / sweep_positions), row tiles of W), rk), the W
// row tiles ceil(m / w_tile_rows) when k <= w_tile_cols, else ceil(m /
// sweep_positions); then w_ext (m, rk), h_ext and hraw (rk, n) float32
// under bf16 W / H, wb (m, rk) bf16 under bf16 operands, else null. The
// flags, the bf16 operands and outputs and alias_io as in
// nmfx_block_iterations (block_mu.cu).
int nmfx_hals_block_iterations(
    const void* a, const void* wp_in, const void* hp_in, const float* frozen,
    const float* budget, void* wp_out, void* hp_out, float* wd, float* wm,
    float* hd, float* hm, float* h_checks, float* wp_tmp, float* hp_tmp,
    float* part, float* gpart, float* gh, float* aht, float* dp, float* mp,
    float* w_ext, float* h_ext, float* hraw, void* wb, int m, int n, int rk,
    int k, int iters, int check_block, int flags, float eps,
    float zero_threshold, void* stream) {
  const bool bf = flags & 1, rw = flags & 2, rh = flags & 4;
  const Launch L{a, frozen, budget, wd, wm, hd, hm, h_checks, part, gpart,
                 gh, aht, dp, mp, hraw, static_cast<bf16_t*>(wb), m, n, rk,
                 k, iters, check_block, rw ? 1 : 0, rh ? 1 : 0, eps,
                 zero_threshold, static_cast<cudaStream_t>(stream)};
  const int total = iters * check_block;
  float* const w_dest[2] = {rw ? w_ext : static_cast<float*>(wp_out),
                            wp_tmp};
  float* const h_dest[2] = {rh ? h_ext : static_cast<float*>(hp_out),
                            hp_tmp};
  const bool first_writes_out = total % 2 == 1;
  const float* w_cur =
      entry_buffer(wp_in, wp_out, w_dest[total % 2], (size_t)m * rk, rw,
                   first_writes_out, L.st);
  const float* h_cur =
      entry_buffer(hp_in, hp_out, h_dest[total % 2], (size_t)rk * n, rh,
                   first_writes_out, L.st);
  // 4-element copies, loads and stores where all rows are aligned,
  // 1-element ones otherwise, in the same arithmetic
  const bool vn = rows_aligned(a, n, bf ? 2 : 4) &&
                  rows_aligned(h_cur, n) && rows_aligned(h_dest[0], n) &&
                  rows_aligned(h_dest[1], n) && rows_aligned(part, n);
  const bool vr = rows_aligned(w_cur, rk) && rows_aligned(w_dest[0], rk) &&
                  rows_aligned(w_dest[1], rk);
  const bool vw = bf ? rows_aligned(wb, rk, 2) : vr;
  const cudaError_t err =
      bf ? run_widths<true>(L, vn, vw, w_cur, h_cur, w_dest, h_dest)
         : run_widths<false>(L, vn, vw, w_cur, h_cur, w_dest, h_dest);
  if (err != cudaSuccess) return err;
  if (rw)
    narrow_bf16<<<cast_blocks((size_t)m * rk), 256, 0, L.st>>>(
        w_dest[0], static_cast<bf16_t*>(wp_out), (size_t)m * rk);
  if (rh)
    narrow_bf16<<<cast_blocks((size_t)rk * n), 256, 0, L.st>>>(
        h_dest[0], static_cast<bf16_t*>(hp_out), (size_t)rk * n);
  return cudaGetLastError();
}

}  // extern "C"
