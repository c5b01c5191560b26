// Device code shared by the port's block kernels (block_mu.cu,
// hals_block.cu): the mu epilogue, the fixed split of the m-reduction,
// the per-lane freeze and budget fence, the NaN-keeping maximum, cp.async
// copies, the W-Gram partials, the diagonal H-Gram and the reduction of
// per-tile TolX maxima.
//
// Layout (all float32, row-major, contiguous): A (m, n), Wp (m, rk),
// Hp (rk, n), rk = R*k with lane r owning columns/rows r*k .. r*k+k-1.
//
// Everything sits in an anonymous namespace: each source that includes
// this header compiles its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int SPLIT_ROWS = 256;  // rows of A per split of the H numerator
constexpr int ROW_THREADS = 256;
constexpr int THREADS = 256;    // threads of the Gram kernels
constexpr int GRAM_ROWS = 64;   // rows of W staged per Gram step
// most floats of H that h_gram_diag stages at a time (48 KB)
constexpr int HG_STAGE_FLOATS = 12 * 1024;

__device__ __forceinline__ float mu_epilogue(float prev, float numer,
                                             float denom, float eps,
                                             float zero_threshold) {
  float res = prev * (numer / (denom + eps));
  if (prev == 0.0f || numer == 0.0f) res = 0.0f;
  if (res <= zero_threshold) res = 0.0f;
  return res;
}

// a null frozen or budget freezes no lane
__device__ __forceinline__ bool lane_frozen(const float* __restrict__ frozen,
                                            const float* __restrict__ budget,
                                            int c, int it) {
  return (frozen != nullptr && frozen[c] > 0.f) ||
         (budget != nullptr && budget[c] <= (float)it);
}

// max that keeps a NaN once it has seen one
__device__ __forceinline__ float nan_max(float m, float x) {
  return (x > m || x != x) ? x : m;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// gpart[s, r, p, q] = sum over rows m of chunk s of Wp[m, r*k+p] * Wp[m, r*k+q]
// grid (R, splits, ceil(k*k / THREADS)); one (p, q) pair per thread.
__global__ void __launch_bounds__(THREADS)
h_gram_partial(const float* __restrict__ wp, float* __restrict__ gpart,
               int m, int rk, int k, int chunk) {
  extern __shared__ float wtile[];  // [GRAM_ROWS][k]
  const int r = blockIdx.x, s = blockIdx.y;
  const int lanes = rk / k;
  const int pair = blockIdx.z * THREADS + threadIdx.x;
  const bool owns = pair < k * k;
  const int p = owns ? pair / k : 0, q = owns ? pair % k : 0;
  const int mb = s * chunk;
  const int me = min(m, mb + chunk);
  float acc = 0.f;
  for (int m0 = mb; m0 < me; m0 += GRAM_ROWS) {
    for (int e = threadIdx.x; e < GRAM_ROWS * k; e += THREADS) {
      const int row = m0 + e / k, c = e % k;
      wtile[e] = row < me ? wp[(size_t)row * rk + r * k + c] : 0.f;
    }
    __syncthreads();
    if (owns) {
      const int rows = min(GRAM_ROWS, me - m0);
      for (int t = 0; t < rows; ++t)
        acc = fmaf(wtile[t * k + p], wtile[t * k + q], acc);
    }
    __syncthreads();
  }
  if (owns) gpart[(((size_t)s * lanes + r) * k + p) * k + q] = acc;
}

// Columns of H that h_gram_diag stages at a time: all n where the lane's
// k rows (at an odd row stride) fit 48 KB.
inline __host__ __device__ int h_gram_cols(int n, int k) {
  const int fit = HG_STAGE_FLOATS / k - 1;
  return n < fit ? n : (fit > 1 ? fit : 1);
}

// gh[r, p, q] = sum over j of H[r*k+p, j] * H[r*k+q, j], fmaf from +0
// over j in order; grid (R, ceil(k*k / THREADS)), one (p, q) pair per
// thread, sizeof(float) * k * (h_gram_cols(n, k) + 1) bytes of dynamic
// shared memory: the lane's k rows, copied h_gram_cols(n, k) columns at a
// time (all of them where they fit).
__global__ void __launch_bounds__(THREADS)
h_gram_diag(const float* __restrict__ h, float* __restrict__ gh, int n,
            int k) {
  extern __shared__ float hstage[];  // [k][cols | 1]
  const int cols = h_gram_cols(n, k);
  const int r = blockIdx.x;
  const int pair = blockIdx.y * THREADS + threadIdx.x;
  const bool owns = pair < k * k;
  const int p = owns ? pair / k : 0, q = owns ? pair % k : 0;
  float acc = 0.f;
  for (int j0 = 0; j0 < n; j0 += cols) {
    const int nc = min(cols, n - j0), ld = nc | 1;
    for (int e = threadIdx.x; e < k * nc; e += THREADS)
      cp_async4(hstage + e / nc * ld + e % nc,
                h + (size_t)(r * k + e / nc) * n + j0 + e % nc, 4);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (owns) {
      const float* hp = hstage + p * ld;
      const float* hq = hstage + q * ld;
      for (int c = 0; c < nc; ++c) acc = fmaf(hp[c], hq[c], acc);
    }
    __syncthreads();
  }
  if (owns) gh[((size_t)r * k + p) * k + q] = acc;
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
