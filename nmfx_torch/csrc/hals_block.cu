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
// What bounds it on an H100: as the mu block kernel, the two numerator
// products (4*m*n*rk FLOP an iteration) on the CUDA cores; the sweeps add
// O((m + n)*rk*k) operations.
//
// What the design does about the TPU kernel's structure: the Pallas
// kernel conjugates the Grams with a permutation matrix (_perm_matrix)
// only because Mosaic has no strided gather; here a thread indexes a
// lane's components directly. The factors stay in device memory, as in
// the mu block kernel, and each iteration enqueues six kernels (eight
// at a boundary) with no host sync:
//   1. h_numer_partial, 2. h_gram_partial (mu_common.cuh, the fixed
//      SPLIT_ROWS split of the m-reduction);
//   3. hals_sweep over H: one thread per (lane, column j), the partials
//      summed in split order, then the k-step sweep; per-block row maxima
//      at a boundary (then w_stats_reduce over the column tiles) and the
//      snapshot;
//   4. h_gram_diag (block_common.cuh);
//   5. w_numer_store: A hn^T into a workspace. A lane of k = 10 straddles
//      the 64-column tiles of the product, so the sweep runs in a second
//      kernel instead of in the product's epilogue;
//   6. hals_sweep over W: one thread per (lane, row i), per-block column
//      maxima at a boundary, then w_stats_reduce over the row tiles.
// No atomics; every sum's order depends on m, n and k only.

#include <cuda_runtime.h>
#include <stddef.h>

#include "block_common.cuh"

namespace {

// positions (columns of H, rows of W) per block of the sweeps
constexpr int SWEEP_THREADS = 128;

// aht[i, c] = sum over j of A[i, j] * Hp[c, j];
// grid (ceil(rk / TILE), ceil(m / TILE)).
__global__ void __launch_bounds__(THREADS)
w_numer_store(const float* __restrict__ a, const float* __restrict__ hp,
              float* __restrict__ aht, int m, int n, int rk) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int c0 = blockIdx.x * TILE, i0 = blockIdx.y * TILE;
  float acc[4][4];
  w_numer_tile(a, hp, m, n, rk, i0, c0, acc);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + ty + 16 * u;
    if (i >= m) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int c = c0 + tx + 16 * v;
      if (c < rk) aht[(size_t)i * rk + c] = acc[u][v];
    }
  }
}

// One HALS sweep over the k components of lane r = blockIdx.x at
// positions x = blockIdx.y * SWEEP_THREADS + threadIdx.x < `positions`.
// Component q of the lane at position x sits at f0[x*sx + (r*k + q)*sq]
// (H: sx = 1, sq = n; W: sx = rk, sq = 1). Its numerator is the sum over
// `splits` partials, in split order, of numer[s*nstride + the same
// offset]; the lane's Gram is the sum over splits of
// gram[s*gstride + (r*k + p)*k + q]. Writes out (and snap, when not
// null) at the same offsets, frozen components keeping f0; with `stats`,
// the block's maxima over its positions of |out - f0| and |f0| per
// component c = r*k + jj go to dp / mp [blockIdx.y * rk + c].
__global__ void __launch_bounds__(SWEEP_THREADS)
hals_sweep(const float* __restrict__ f0, const float* __restrict__ numer,
           const float* __restrict__ gram, const float* __restrict__ frozen,
           const float* __restrict__ budget, float* __restrict__ out,
           float* __restrict__ snap, float* __restrict__ dp,
           float* __restrict__ mp, int positions, int sx, int sq, int rk,
           int k, int splits, size_t nstride, size_t gstride, int it,
           int stats, float eps, float zero_threshold) {
  extern __shared__ float sm[];
  float* g = sm;                           // [k][k] the lane's Gram
  float* fv = g + k * k;                   // [k][SWEEP_THREADS] the sweep
  float* red_d = fv + k * SWEEP_THREADS;   // [SWEEP_THREADS]
  float* red_m = red_d + SWEEP_THREADS;    // [SWEEP_THREADS]
  const int r = blockIdx.x, t = threadIdx.x;
  const int x = blockIdx.y * SWEEP_THREADS + t;
  const bool own = x < positions;
  for (int e = t; e < k * k; e += SWEEP_THREADS) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s)
      v += gram[(size_t)s * gstride + (size_t)r * k * k + e];
    g[e] = v;
  }
  const size_t base = (size_t)x * sx + (size_t)r * k * sq;
  if (own)
    for (int q = 0; q < k; ++q)
      fv[q * SWEEP_THREADS + t] = f0[base + (size_t)q * sq];
  __syncthreads();
  if (own) {
    for (int jj = 0; jj < k; ++jj) {
      const size_t off = base + (size_t)jj * sq;
      float num = 0.f;
      for (int s = 0; s < splits; ++s) num += numer[(size_t)s * nstride + off];
      float dot = 0.f;
      for (int q = 0; q < k; ++q)
        dot = fmaf(g[jj * k + q], fv[q * SWEEP_THREADS + t], dot);
      const float v = fv[jj * SWEEP_THREADS + t] +
                      (num - dot) / (g[jj * k + jj] + eps);
      fv[jj * SWEEP_THREADS + t] = v <= zero_threshold ? 0.f : v;
    }
  }
  for (int jj = 0; jj < k; ++jj) {
    const int c = r * k + jj;
    float d = 0.f, mx = 0.f;
    if (own) {
      const size_t off = base + (size_t)jj * sq;
      const float v0 = f0[off];
      const float v = lane_frozen(frozen, budget, c, it)
                          ? v0 : fv[jj * SWEEP_THREADS + t];
      out[off] = v;
      if (snap != nullptr) snap[off] = v;
      d = fabsf(v - v0);
      mx = fabsf(v0);
    }
    if (!stats) continue;  // the same for every thread of the block
    red_d[t] = d;
    red_m[t] = mx;
    __syncthreads();
    for (int w = SWEEP_THREADS / 2; w > 0; w >>= 1) {
      if (t < w) {
        red_d[t] = nan_max(red_d[t], red_d[t + w]);
        red_m[t] = nan_max(red_m[t], red_m[t + w]);
      }
      __syncthreads();
    }
    if (t == 0) {
      dp[(size_t)blockIdx.y * rk + c] = red_d[0];
      mp[(size_t)blockIdx.y * rk + c] = red_m[0];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Rows of A per split of the H numerator (the caller sizes `part` and
// `gpart` with ceil(m / split_rows) splits).
int nmfx_block_split_rows() { return SPLIT_ROWS; }

// Positions (columns of H, rows of W) per block of the sweeps: the caller
// sizes dp and mp with ceil(max(m, n) / sweep_positions) rows.
int nmfx_hals_sweep_positions() { return SWEEP_THREADS; }

// iters * check_block HALS iterations of the packed pool; see the top of
// this file and of block_mu.cu. budget and h_checks may be null
// (check_block == 1). Workspace: wp_tmp (m, rk), hp_tmp (rk, n), part
// (splits, rk, n), gpart (splits, rk/k, k, k), gh (rk/k, k, k), aht
// (m, rk), dp and mp (ceil(max(m, n) / 128), rk).
int nmfx_hals_block_iterations(const float* a, const float* wp_in,
                               const float* hp_in, const float* frozen,
                               const float* budget, float* wp_out,
                               float* hp_out, float* wd, float* wm, float* hd,
                               float* hm, float* h_checks, float* wp_tmp,
                               float* hp_tmp, float* part, float* gpart,
                               float* gh, float* aht, float* dp, float* mp,
                               int m, int n, int rk, int k, int iters,
                               int check_block, float eps,
                               float zero_threshold, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lanes = rk / k;
  const int splits = (m + SPLIT_ROWS - 1) / SPLIT_ROWS;
  const int total = iters * check_block;
  const int jtiles = (n + SWEEP_THREADS - 1) / SWEEP_THREADS;
  const int itiles = (m + SWEEP_THREADS - 1) / SWEEP_THREADS;
  const size_t gram_smem = sizeof(float) * GRAM_ROWS * k;
  const size_t hg_smem = sizeof(float) * k * (GRAM_COLS + 1);
  const size_t sweep_smem =
      sizeof(float) * (k * k + k * SWEEP_THREADS + 2 * SWEEP_THREADS);
  cudaError_t err;
  if ((err = set_smem((const void*)h_gram_partial, gram_smem)) != cudaSuccess)
    return err;
  if ((err = set_smem((const void*)h_gram_diag, hg_smem)) != cudaSuccess)
    return err;
  if ((err = set_smem((const void*)hals_sweep, sweep_smem)) != cudaSuccess)
    return err;
  const dim3 numer_grid((n + TILE - 1) / TILE, (rk + TILE - 1) / TILE, splits);
  const dim3 gram_grid(lanes, splits, (k * k + THREADS - 1) / THREADS);
  const dim3 hg_grid(lanes, (k * k + THREADS - 1) / THREADS);
  const dim3 w_grid((rk + TILE - 1) / TILE, (m + TILE - 1) / TILE);
  const int red_blocks = (rk + ROW_THREADS - 1) / ROW_THREADS;
  const float* w_cur = wp_in;
  const float* h_cur = hp_in;
  for (int it = 0; it < total; ++it) {
    // the last iteration writes the outputs; earlier ones alternate
    const bool to_out = (total - 1 - it) % 2 == 0;
    float* w_next = to_out ? wp_out : wp_tmp;
    float* h_next = to_out ? hp_out : hp_tmp;
    const bool boundary = (it + 1) % iters == 0;
    const int brow = boundary ? (it + 1) / iters - 1 : -1;
    float* snap = (boundary && check_block > 1)
                      ? h_checks + (size_t)brow * rk * n : nullptr;
    h_numer_partial<<<numer_grid, THREADS, 0, st>>>(a, w_cur, part, m, n, rk,
                                                    SPLIT_ROWS);
    h_gram_partial<<<gram_grid, THREADS, gram_smem, st>>>(w_cur, gpart, m, rk,
                                                          k, SPLIT_ROWS);
    hals_sweep<<<dim3(lanes, jtiles), SWEEP_THREADS, sweep_smem, st>>>(
        h_cur, part, gpart, frozen, budget, h_next, snap, dp, mp, n, 1, n, rk,
        k, splits, (size_t)rk * n, (size_t)rk * k, it, boundary ? 1 : 0, eps,
        zero_threshold);
    if (boundary)
      w_stats_reduce<<<red_blocks, ROW_THREADS, 0, st>>>(
          dp, mp, hd + (size_t)brow * rk, hm + (size_t)brow * rk, rk, jtiles);
    h_gram_diag<<<hg_grid, THREADS, hg_smem, st>>>(h_next, gh, n, k);
    w_numer_store<<<w_grid, THREADS, 0, st>>>(a, h_next, aht, m, n, rk);
    hals_sweep<<<dim3(lanes, itiles), SWEEP_THREADS, sweep_smem, st>>>(
        w_cur, aht, gh, frozen, budget, w_next, nullptr, dp, mp, m, rk, 1, rk,
        k, 1, 0, 0, it, boundary ? 1 : 0, eps, zero_threshold);
    if (boundary)
      w_stats_reduce<<<red_blocks, ROW_THREADS, 0, st>>>(
          dp, mp, wd + (size_t)brow * rk, wm + (size_t)brow * rk, rk, itiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    w_cur = w_next;
    h_cur = h_next;
  }
  return cudaSuccess;
}

}  // extern "C"
