// Hand-written sm_90a block of full MU iterations for the slot scheduler.
//
// Replaces nmfx/ops/pallas_mu.py:fused_block_iterations with fused=False
// (the phased _block_kernel): iters * check_block full MU iterations of
// the packed slot pool in one call, with per-lane freezes, the per-lane
// iteration budget fence, per-boundary TolX stats and, when
// check_block > 1, an H snapshot at every check boundary.
//
// Layout (float32, row-major, contiguous): A (m, n), Wp (m, rk), Hp
// (rk, n), rk = S*k with slot s owning columns/rows s*k .. s*k+k-1. The
// uniform pool's segment ids are iota // k, so the kernel takes k alone
// (the ragged pool, whose segments vary, is not ported).
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
// operations (f32 FMA on the CUDA cores, as in fused_mu.cu: 64 x 64
// tiles, 16-deep shared-memory stages, 4 x 4 outputs per thread).
//
// What the design does about the TPU kernel's structure: the Pallas
// kernel holds all of Wp (9.8 MB here) and Hp in one core's VMEM for the
// whole launch; an SM has 227 KB. So the factors stay in device memory
// (A, Wp and Hp together fit the 50 MB L2) and one C call enqueues, per
// iteration, five kernels on the caller's stream with no host sync:
//   1. h_numer_partial: Wp^T A, m split into SPLIT_ROWS-row chunks;
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

#include <cuda_runtime.h>
#include <stddef.h>

#include "mu_common.cuh"

namespace {

constexpr int SPLIT_ROWS = 256;  // rows of A per split of the H numerator
constexpr int ROW_THREADS = 256;
constexpr int GRAM_COLS = 64;    // columns of H staged per H-Gram step

__device__ __forceinline__ bool lane_frozen(const float* __restrict__ frozen,
                                            const float* __restrict__ budget,
                                            int c, int it) {
  return frozen[c] > 0.f || (budget != nullptr && budget[c] <= (float)it);
}

// max that keeps a NaN once it has seen one
__device__ __forceinline__ float nan_max(float m, float x) {
  return (x > m || x != x) ? x : m;
}

// out[i, j] = epilogue(Hp[i, j], sum_s part[s, i, j],
//                      sum_q G_r[p, q] * Hp[r*k+q, j]),  i = r*k + p,
// or Hp[i, j] on a frozen row; grid (rk), one block per row.
__global__ void __launch_bounds__(ROW_THREADS)
h_block_epilogue(const float* __restrict__ hp, const float* __restrict__ part,
                 const float* __restrict__ gpart,
                 const float* __restrict__ frozen,
                 const float* __restrict__ budget, float* __restrict__ out,
                 float* __restrict__ hd, float* __restrict__ hm,
                 float* __restrict__ hck, int n, int rk, int k, int splits,
                 int it, int brow, float eps, float zero_threshold) {
  extern __shared__ float sm[];  // grow[k], then 2 x ROW_THREADS maxima
  float* grow = sm;
  float* red_d = sm + k;
  float* red_m = red_d + ROW_THREADS;
  const int i = blockIdx.x;
  const int r = i / k, p = i % k;
  const int lanes = rk / k;
  for (int q = threadIdx.x; q < k; q += ROW_THREADS) {
    float g = 0.f;
    for (int s = 0; s < splits; ++s)
      g += gpart[(((size_t)s * lanes + r) * k + p) * k + q];
    grow[q] = g;
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
      for (int q = 0; q < k; ++q)
        denom = fmaf(grow[q], hp[(size_t)(r * k + q) * n + j], denom);
      hn = mu_epilogue(h0, numer, denom, eps, zero_threshold);
    }
    out[(size_t)i * n + j] = hn;
    if (brow >= 0) {
      dmax = nan_max(dmax, fabsf(hn - h0));
      hmax = nan_max(hmax, fabsf(h0));
      if (hck != nullptr) hck[((size_t)brow * rk + i) * n + j] = hn;
    }
  }
  if (brow < 0) return;  // the same for every thread of the block
  red_d[threadIdx.x] = dmax;
  red_m[threadIdx.x] = hmax;
  __syncthreads();
  for (int w = ROW_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
      red_d[threadIdx.x] = nan_max(red_d[threadIdx.x], red_d[threadIdx.x + w]);
      red_m[threadIdx.x] = nan_max(red_m[threadIdx.x], red_m[threadIdx.x + w]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    hd[(size_t)brow * rk + i] = red_d[0];
    hm[(size_t)brow * rk + i] = red_m[0];
  }
}

// gh[r, p, q] = sum over j of H[r*k+p, j] * H[r*k+q, j];
// grid (R, ceil(k*k / THREADS)), one (p, q) pair per thread.
__global__ void __launch_bounds__(THREADS)
h_gram_diag(const float* __restrict__ h, float* __restrict__ gh, int n,
            int k) {
  extern __shared__ float htile[];  // [k][GRAM_COLS + 1]
  constexpr int LD = GRAM_COLS + 1;
  const int r = blockIdx.x;
  const int pair = blockIdx.y * THREADS + threadIdx.x;
  const bool owns = pair < k * k;
  const int p = owns ? pair / k : 0, q = owns ? pair % k : 0;
  float acc = 0.f;
  for (int j0 = 0; j0 < n; j0 += GRAM_COLS) {
    const int cols = min(GRAM_COLS, n - j0);
    for (int e = threadIdx.x; e < k * GRAM_COLS; e += THREADS) {
      const int row = e / GRAM_COLS, c = e % GRAM_COLS;
      htile[row * LD + c] =
          c < cols ? h[(size_t)(r * k + row) * n + j0 + c] : 0.f;
    }
    __syncthreads();
    if (owns)
      for (int c = 0; c < cols; ++c)
        acc = fmaf(htile[p * LD + c], htile[q * LD + c], acc);
    __syncthreads();
  }
  if (owns) gh[((size_t)r * k + p) * k + q] = acc;
}

// out[i, c] = epilogue(Wp[i, c], sum_j A[i, j] * Hp[c, j],
//                      sum_q Wp[i, r*k+q] * gh[r, q, c - r*k]),  r = c / k,
// or Wp[i, c] on a frozen column; with `stats`, the tile's column maxima
// of |out - Wp| and |Wp| go to row blockIdx.y of wdp / wmp.
// grid (ceil(rk / TILE), ceil(m / TILE)).
__global__ void __launch_bounds__(THREADS)
w_block_update(const float* __restrict__ a, const float* __restrict__ wp,
               const float* __restrict__ hp, const float* __restrict__ gh,
               const float* __restrict__ frozen,
               const float* __restrict__ budget, float* __restrict__ out,
               float* __restrict__ wdp, float* __restrict__ wmp, int m, int n,
               int rk, int k, int it, int stats, float eps,
               float zero_threshold) {
  __shared__ float red_d[16][TILE];
  __shared__ float red_m[16][TILE];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int c0 = blockIdx.x * TILE, i0 = blockIdx.y * TILE;
  float acc[4][4];
  w_numer_tile(a, hp, m, n, rk, i0, c0, acc);
  float cd[4] = {0.f, 0.f, 0.f, 0.f}, cm[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + ty + 16 * u;
    if (i >= m) continue;
    const float* wrow = wp + (size_t)i * rk;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int c = c0 + tx + 16 * v;
      if (c >= rk) continue;
      const float w0 = wrow[c];
      float wn = w0;
      if (!lane_frozen(frozen, budget, c, it)) {
        const int r = c / k, base = r * k, p = c - base;
        float denom = 0.f;
        for (int q = 0; q < k; ++q)
          denom = fmaf(wrow[base + q], gh[((size_t)r * k + q) * k + p], denom);
        wn = mu_epilogue(w0, acc[u][v], denom, eps, zero_threshold);
      }
      out[(size_t)i * rk + c] = wn;
      cd[v] = nan_max(cd[v], fabsf(wn - w0));
      cm[v] = nan_max(cm[v], fabsf(w0));
    }
  }
  if (!stats) return;  // the same for every thread of the block
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    red_d[ty][tx + 16 * v] = cd[v];
    red_m[ty][tx + 16 * v] = cm[v];
  }
  __syncthreads();
  if (threadIdx.x < TILE) {
    const int c = c0 + threadIdx.x;
    float d = 0.f, mx = 0.f;
    for (int t = 0; t < 16; ++t) {
      d = nan_max(d, red_d[t][threadIdx.x]);
      mx = nan_max(mx, red_m[t][threadIdx.x]);
    }
    if (c < rk) {
      wdp[(size_t)blockIdx.y * rk + c] = d;
      wmp[(size_t)blockIdx.y * rk + c] = mx;
    }
  }
}

// wd[c] = max over tiles t of wdp[t, c], likewise wm; one thread a column
__global__ void __launch_bounds__(ROW_THREADS)
w_stats_reduce(const float* __restrict__ wdp, const float* __restrict__ wmp,
               float* __restrict__ wd, float* __restrict__ wm, int rk,
               int tiles) {
  const int c = blockIdx.x * ROW_THREADS + threadIdx.x;
  if (c >= rk) return;
  float d = 0.f, mx = 0.f;
  for (int t = 0; t < tiles; ++t) {
    d = nan_max(d, wdp[(size_t)t * rk + c]);
    mx = nan_max(mx, wmp[(size_t)t * rk + c]);
  }
  wd[c] = d;
  wm[c] = mx;
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

// Rows of A per split of the H numerator (the caller sizes `part` and
// `gpart` with ceil(m / split_rows) splits).
int nmfx_block_split_rows() { return SPLIT_ROWS; }

// iters * check_block MU iterations of the packed pool; see the top of
// this file. budget and h_checks may be null (check_block == 1).
// Workspace: wp_tmp (m, rk), hp_tmp (rk, n), part (splits, rk, n), gpart
// (splits, rk/k, k, k), gh (rk/k, k, k), wdp and wmp (ceil(m/64), rk).
int nmfx_block_iterations(const float* a, const float* wp_in,
                          const float* hp_in, const float* frozen,
                          const float* budget, float* wp_out, float* hp_out,
                          float* wd, float* wm, float* hd, float* hm,
                          float* h_checks, float* wp_tmp, float* hp_tmp,
                          float* part, float* gpart, float* gh, float* wdp,
                          float* wmp, int m, int n, int rk, int k, int iters,
                          int check_block, float eps, float zero_threshold,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lanes = rk / k;
  const int splits = (m + SPLIT_ROWS - 1) / SPLIT_ROWS;
  const int mtiles = (m + TILE - 1) / TILE;
  const int total = iters * check_block;
  const size_t gram_smem = sizeof(float) * GRAM_ROWS * k;
  const size_t ep_smem = sizeof(float) * (k + 2 * ROW_THREADS);
  const size_t hg_smem = sizeof(float) * k * (GRAM_COLS + 1);
  cudaError_t err;
  if ((err = set_smem((const void*)h_gram_partial, gram_smem)) != cudaSuccess)
    return err;
  if ((err = set_smem((const void*)h_block_epilogue, ep_smem)) != cudaSuccess)
    return err;
  if ((err = set_smem((const void*)h_gram_diag, hg_smem)) != cudaSuccess)
    return err;
  const dim3 numer_grid((n + TILE - 1) / TILE, (rk + TILE - 1) / TILE, splits);
  const dim3 gram_grid(lanes, splits, (k * k + THREADS - 1) / THREADS);
  const dim3 hg_grid(lanes, (k * k + THREADS - 1) / THREADS);
  const dim3 w_grid((rk + TILE - 1) / TILE, mtiles);
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
    h_numer_partial<<<numer_grid, THREADS, 0, st>>>(a, w_cur, part, m, n, rk,
                                                    SPLIT_ROWS);
    h_gram_partial<<<gram_grid, THREADS, gram_smem, st>>>(w_cur, gpart, m, rk,
                                                          k, SPLIT_ROWS);
    h_block_epilogue<<<rk, ROW_THREADS, ep_smem, st>>>(
        h_cur, part, gpart, frozen, budget, h_next, hd, hm,
        check_block > 1 ? h_checks : nullptr, n, rk, k, splits, it, brow, eps,
        zero_threshold);
    h_gram_diag<<<hg_grid, THREADS, hg_smem, st>>>(h_next, gh, n, k);
    w_block_update<<<w_grid, THREADS, 0, st>>>(
        a, w_cur, h_next, gh, frozen, budget, w_next, wdp, wmp, m, n, rk, k,
        it, boundary ? 1 : 0, eps, zero_threshold);
    if (boundary)
      w_stats_reduce<<<red_blocks, ROW_THREADS, 0, st>>>(
          wdp, wmp, wd + (size_t)brow * rk, wm + (size_t)brow * rk, rk,
          mtiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    w_cur = w_next;
    h_cur = h_next;
  }
  return cudaSuccess;
}

}  // extern "C"
