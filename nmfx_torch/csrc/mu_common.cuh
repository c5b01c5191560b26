// Device code shared by the port's MU kernels (fused_mu.cu, block_mu.cu):
// the mu epilogue, the two split-m passes of the H half-update and the
// numerator tile of the W half-update.
//
// Layout (all float32, row-major, contiguous): A (m, n), Wp (m, rk),
// Hp (rk, n), rk = R*k with restart r owning columns/rows r*k .. r*k+k-1.
// Each pass sums its rows of one m-chunk in row order inside one thread,
// so a partial depends on the chunk's rows only, not on where the tile
// or the lane sits; callers add the partials in split order.
//
// Everything sits in an anonymous namespace: each source that includes
// this header compiles its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TILE = 64;       // output tile edge
constexpr int BK = 16;         // contraction depth per shared-memory stage
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int GRAM_ROWS = 64;  // rows of W staged per Gram step

__device__ __forceinline__ float mu_epilogue(float prev, float numer,
                                             float denom, float eps,
                                             float zero_threshold) {
  float res = prev * (numer / (denom + eps));
  if (prev == 0.0f || numer == 0.0f) res = 0.0f;
  if (res <= zero_threshold) res = 0.0f;
  return res;
}

// part[s, i, j] = sum over rows m of chunk s of Wp[m, i] * A[m, j]
__global__ void __launch_bounds__(THREADS)
h_numer_partial(const float* __restrict__ a, const float* __restrict__ wp,
                float* __restrict__ part, int m, int n, int rk, int chunk) {
  __shared__ float ws[BK][TILE];
  __shared__ float as[BK][TILE];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int j0 = blockIdx.x * TILE, i0 = blockIdx.y * TILE;
  const int s = blockIdx.z;
  const int mb = s * chunk;
  const int me = min(m, mb + chunk);
  float acc[4][4] = {};
  for (int m0 = mb; m0 < me; m0 += BK) {
    for (int e = threadIdx.x; e < BK * TILE; e += THREADS) {
      const int kk = e / TILE, c = e % TILE, row = m0 + kk;
      const bool in = row < me;
      ws[kk][c] = (in && i0 + c < rk) ? wp[(size_t)row * rk + i0 + c] : 0.f;
      as[kk][c] = (in && j0 + c < n) ? a[(size_t)row * n + j0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float wv[4], av[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        wv[u] = ws[kk][ty + 16 * u];
        av[u] = as[kk][tx + 16 * u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(wv[u], av[v], acc[u][v]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + ty + 16 * u;
    if (i >= rk) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = j0 + tx + 16 * v;
      if (j < n) part[((size_t)s * rk + i) * n + j] = acc[u][v];
    }
  }
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

// acc[u][v] = sum over j of A[i0 + ty + 16u, j] * Hp[c0 + tx + 16v, j]:
// thread (tx, ty) of THREADS (tx fastest) accumulates its 4 x 4 outputs
// of the 64 x 64 tile (i0, c0) of A * Hp^T, over j in order. Every
// thread of the block must call it.
__device__ __forceinline__ void w_numer_tile(const float* __restrict__ a,
                                             const float* __restrict__ hp,
                                             int m, int n, int rk, int i0,
                                             int c0, float (&acc)[4][4]) {
  // +1 column: the transposing stores below walk kk fastest
  __shared__ float as[BK][TILE + 1];
  __shared__ float hs[BK][TILE + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
  for (int j0 = 0; j0 < n; j0 += BK) {
    for (int e = threadIdx.x; e < BK * TILE; e += THREADS) {
      const int row = e / BK, kk = e % BK, j = j0 + kk;
      const bool in = j < n;
      as[kk][row] = (in && i0 + row < m) ? a[(size_t)(i0 + row) * n + j] : 0.f;
      hs[kk][row] = (in && c0 + row < rk) ? hp[(size_t)(c0 + row) * n + j] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], hv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        av[u] = as[kk][ty + 16 * u];
        hv[u] = hs[kk][tx + 16 * u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], hv[v], acc[u][v]);
    }
    __syncthreads();
  }
}

}  // namespace
