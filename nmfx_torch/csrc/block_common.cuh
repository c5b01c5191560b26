// Device code shared by the slot scheduler's block kernels (block_mu.cu,
// hals_block.cu): the fixed split of the m-reduction, the per-lane
// freeze and budget fence, the NaN-keeping maximum, the diagonal H-Gram
// and the reduction of per-tile TolX maxima.
//
// Like mu_common.cuh, everything sits in an anonymous namespace: each
// source that includes this header compiles its own copy.

#pragma once

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
