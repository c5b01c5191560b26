// Hand-written sm_90a kernels for the restart-packed MU iteration.
//
// Replaces nmfx/ops/pallas_mu.py:fused_h_update (_h_kernel) and
// nmfx/ops/pallas_mu.py:fused_w_update (_w_kernel).
//
// Layout (all float32, row-major, contiguous): A (m, n), Wp (m, rk),
// Hp (rk, n), rk = R*k with restart r owning columns/rows r*k .. r*k+k-1.
//
// What bounds them on an H100: at the sizes the sweep runs (m=5000,
// n=500, rk up to 500) each half-update is 2*m*n*rk FLOP of numerator
// GEMM against ~20-30 MB of traffic, so both are bound by operations,
// not bytes. These first kernels use f32 FMA on the CUDA cores (no
// tensor cores), 64x64 output tiles, 16-deep shared-memory stages and a
// 4x4 register block per thread.
//
// What the design does about the TPU kernel's structure:
// * fused_h_update: the Pallas grid walks m in order on one core and
//   carries the (rk, n) numerator in VMEM. CTAs run in parallel in no
//   order, so the m-reduction is split: pass 1 tiles the numerator over
//   CTAs and splits m into `splits` chunks, each CTA writing an f32
//   partial; pass 2 sums the partials in a fixed order and applies the
//   denominator and the epilogue. No atomics: the sums are the same on
//   every run, so the label-flip stop rules stop at the same iteration.
// * The block-diagonal mask keeps only each restart's k x k Gram block.
//   The kernels compute only those blocks (W_r^T W_r per restart), and
//   a denominator entry is k multiply-adds over its own lane, so no
//   cross-lane term exists for a NaN to leak through (the containment
//   the reference's bd_select gives).
// * fused_w_update is tile-local: each CTA owns a 64x64 tile of Wp,
//   streams A*Hp^T over n through shared memory and applies the
//   epilogue with a k-term denominator from the caller's masked H-Gram.
// * The epilogue keeps _epilogue's order: prev * (numer / (denom + eps)),
//   then the exact-zero select, then the zero-threshold clamp.
//
// The epilogue, the two split-m passes of the H half-update and the W
// numerator tile live in mu_common.cuh, shared with block_mu.cu.
//
// Every entry point launches on the given stream and returns
// cudaGetLastError(); it allocates nothing (the caller passes the
// output and the workspace).

#include <cuda_runtime.h>
#include <stddef.h>

#include "mu_common.cuh"

namespace {

// out[i, j] = epilogue(Hp[i, j], sum_s part[s, i, j],
//                      sum_q G_r[p, q] * Hp[r*k+q, j]),  i = r*k + p
// grid (ceil(n / THREADS), rk); the block first reduces its Gram row.
__global__ void __launch_bounds__(THREADS)
h_epilogue(const float* __restrict__ hp, const float* __restrict__ part,
           const float* __restrict__ gpart, float* __restrict__ out,
           int n, int rk, int k, int splits, float eps,
           float zero_threshold) {
  extern __shared__ float grow[];  // [k]
  const int i = blockIdx.y;
  const int r = i / k, p = i % k;
  const int lanes = rk / k;
  for (int q = threadIdx.x; q < k; q += THREADS) {
    float g = 0.f;
    for (int s = 0; s < splits; ++s)
      g += gpart[(((size_t)s * lanes + r) * k + p) * k + q];
    grow[q] = g;
  }
  __syncthreads();
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= n) return;
  float numer = 0.f;
  for (int s = 0; s < splits; ++s) numer += part[((size_t)s * rk + i) * n + j];
  float denom = 0.f;
  for (int q = 0; q < k; ++q)
    denom = fmaf(grow[q], hp[(size_t)(r * k + q) * n + j], denom);
  out[(size_t)i * n + j] =
      mu_epilogue(hp[(size_t)i * n + j], numer, denom, eps, zero_threshold);
}

// out[i, c] = epilogue(Wp[i, c], sum_j A[i, j] * Hp[c, j],
//                      sum_q Wp[i, r*k+q] * gh[r*k+q, c]),  r = c / k
// grid (ceil(rk / TILE), ceil(m / TILE)).
__global__ void __launch_bounds__(THREADS)
w_update(const float* __restrict__ a, const float* __restrict__ wp,
         const float* __restrict__ hp, const float* __restrict__ gh,
         float* __restrict__ out, int m, int n, int rk, int k, float eps,
         float zero_threshold) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int c0 = blockIdx.x * TILE, i0 = blockIdx.y * TILE;
  float acc[4][4];
  w_numer_tile(a, hp, m, n, rk, i0, c0, acc);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + ty + 16 * u;
    if (i >= m) continue;
    const float* wrow = wp + (size_t)i * rk;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int c = c0 + tx + 16 * v;
      if (c >= rk) continue;
      const int base = (c / k) * k;
      float denom = 0.f;
      for (int q = 0; q < k; ++q)
        denom = fmaf(wrow[base + q], gh[(size_t)(base + q) * rk + c], denom);
      out[(size_t)i * rk + c] =
          mu_epilogue(wrow[c], acc[u][v], denom, eps, zero_threshold);
    }
  }
}

}  // namespace

extern "C" {

// Hp <- epilogue(Hp, Wp^T A, (Wp^T Wp o B) Hp). Workspace: part
// (splits, rk, n), gpart (splits, rk/k, k, k). Rows [s*chunk, s*chunk+chunk)
// of A and Wp form split s; splits * chunk >= m.
int nmfx_fused_h_update(const float* a, const float* wp, const float* hp,
                        float* out, float* part, float* gpart, int m, int n,
                        int rk, int k, int splits, int chunk, float eps,
                        float zero_threshold, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 numer_grid((n + TILE - 1) / TILE, (rk + TILE - 1) / TILE, splits);
  h_numer_partial<<<numer_grid, THREADS, 0, st>>>(a, wp, part, m, n, rk,
                                                  chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t gram_smem = sizeof(float) * GRAM_ROWS * k;
  if (gram_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(h_gram_partial,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)gram_smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 gram_grid(rk / k, splits, (k * k + THREADS - 1) / THREADS);
  h_gram_partial<<<gram_grid, THREADS, gram_smem, st>>>(wp, gpart, m, rk, k,
                                                        chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 ep_grid((n + THREADS - 1) / THREADS, rk);
  h_epilogue<<<ep_grid, THREADS, sizeof(float) * k, st>>>(
      hp, part, gpart, out, n, rk, k, splits, eps, zero_threshold);
  return cudaGetLastError();
}

// Wp <- epilogue(Wp, A Hp^T, Wp gh), gh the caller's masked H-Gram (rk, rk).
int nmfx_fused_w_update(const float* a, const float* wp, const float* hp,
                        const float* gh, float* out, int m, int n, int rk,
                        int k, float eps, float zero_threshold, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((rk + TILE - 1) / TILE, (m + TILE - 1) / TILE);
  w_update<<<grid, THREADS, 0, st>>>(a, wp, hp, gh, out, m, n, rk, k, eps,
                                     zero_threshold);
  return cudaGetLastError();
}

}  // extern "C"
