// Device code shared by the port's block kernels (block_mu.cu,
// hals_block.cu): the mu epilogue, the fixed split of the m-reduction,
// the per-lane freeze and budget fence, the NaN-keeping maximum, cp.async
// copies, the bf16 operand and storage helpers, the segment (lane)
// geometry, the W-Gram partials, the diagonal H-Gram and the reduction
// of per-tile TolX maxima.
//
// Layout (all float32, row-major, contiguous): A (m, n), Wp (m, rk),
// Hp (rk, n). Columns of Wp / rows of Hp fall into segments of
// consecutive columns, one per job (Segs below): the uniform pool's
// segment r is columns r*k .. r*k+k-1; the ragged pool's segments have
// their own widths, at most k. A lane's k x k Gram blocks are stored as
// (rk, k) rows: entry (c, q) at c*k + q, q indexing c's segment, which
// for the uniform pool is the (rk/k, k, k) layout.
//
// bf16 operands (matmul_precision="bfloat16", template flag BF): every
// operand of a product is rounded to bf16 (round to nearest even) before
// it enters its sum; A arrives as bf16 (bf16_t, its bits) and is loaded
// at 2 bytes. A product of two bf16 values is exact in float32. The two
// numerator products are wgmma sums on the tensor cores
// (block_gemm.cuh); the Grams and denominators keep their fmaf chains,
// whose only roundings are the fmaf sums'. Accumulators, epilogues and
// sweeps stay float32.
//
// Everything sits in an anonymous namespace: each source that includes
// this header compiles its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// the bits of a bf16 value, the storage of bf16 operands and factors
using bf16_t = unsigned short;

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

// x rounded to bf16 (round to nearest even), as a float
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// a product operand: x itself, or rounded to bf16 under BF
template <bool BF>
__device__ __forceinline__ float opnd(float x) {
  return BF ? bf16_round(x) : x;
}

// a factor as the pool stores it: x, or rounded to bf16 when `round`
__device__ __forceinline__ float stored(float x, int round) {
  return round ? bf16_round(x) : x;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16_t x) {
  return __uint_as_float((unsigned)x << 16);
}

// 4 consecutive floats (16 bytes, aligned)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// the same through the read-only cache, from global memory
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// The segments of a pool's columns: the uniform pool's (start == null)
// are k consecutive columns each; the ragged pool passes each segment's
// first column and width and each column's segment, k being the widest.
struct Segs {
  const int* start = nullptr;
  const int* width = nullptr;
  const int* of_col = nullptr;
  int k = 1;
  __device__ __forceinline__ int first(int s) const {
    return start != nullptr ? start[s] : s * k;
  }
  __device__ __forceinline__ int len(int s) const {
    return width != nullptr ? width[s] : k;
  }
  __device__ __forceinline__ int seg(int c) const {
    return of_col != nullptr ? of_col[c] : c / k;
  }
};

// y[i] = x[i] (bf16 to float, exact), or y[i] = x[i] rounded to bf16
__global__ void __launch_bounds__(256)
widen_bf16(const bf16_t* __restrict__ x, float* __restrict__ y,
           size_t count) {
  for (size_t i = blockIdx.x * (size_t)256 + threadIdx.x; i < count;
       i += (size_t)gridDim.x * 256)
    y[i] = to_f(x[i]);
}
__global__ void __launch_bounds__(256)
narrow_bf16(const float* __restrict__ x, bf16_t* __restrict__ y,
            size_t count) {
  for (size_t i = blockIdx.x * (size_t)256 + threadIdx.x; i < count;
       i += (size_t)gridDim.x * 256)
    y[i] = __bfloat16_as_ushort(__float2bfloat16_rn(x[i]));
}

inline unsigned cast_blocks(size_t count) {
  const size_t b = (count + 255) / 256;
  return (unsigned)(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

// The block kernels' first factor buffer: a bf16 pool input widened into
// `spare`, an aliased input (alias_io) copied there when the first
// iteration would overwrite it, else the input itself.
inline const float* entry_buffer(const void* in, const void* out,
                                 float* spare, size_t count, bool bf16,
                                 bool first_writes_out, cudaStream_t st) {
  if (bf16) {
    widen_bf16<<<cast_blocks(count), 256, 0, st>>>(
        static_cast<const bf16_t*>(in), spare, count);
    return spare;
  }
  if (in == out && first_writes_out) {
    cudaMemcpyAsync(spare, in, sizeof(float) * count,
                    cudaMemcpyDeviceToDevice, st);
    return spare;
  }
  return static_cast<const float*>(in);
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

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
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

// gpart[s, c, q] = sum over rows t of chunk s of Wp[t, c] * Wp[t, st + q]
// for column c = st + p of the segment from st of width w, p, q < w
// (opnd<BF> of each factor); grid (segments, splits, ceil(k*k /
// THREADS)); one (p, q) pair per thread.
template <bool BF>
__global__ void __launch_bounds__(THREADS)
h_gram_partial(const float* __restrict__ wp, float* __restrict__ gpart,
               int m, int rk, Segs sg, int chunk) {
  extern __shared__ float wtile[];  // [GRAM_ROWS][w]
  const int k = sg.k;
  const int r = blockIdx.x, s = blockIdx.y;
  const int st = sg.first(r), w = sg.len(r);
  const int pair = blockIdx.z * THREADS + threadIdx.x;
  const bool owns = pair < w * w;
  const int p = owns ? pair / w : 0, q = owns ? pair % w : 0;
  const int mb = s * chunk;
  const int me = min(m, mb + chunk);
  float acc = 0.f;
  for (int m0 = mb; m0 < me; m0 += GRAM_ROWS) {
    for (int e = threadIdx.x; e < GRAM_ROWS * w; e += THREADS) {
      const int row = m0 + e / w, c = e % w;
      wtile[e] = row < me ? opnd<BF>(wp[(size_t)row * rk + st + c]) : 0.f;
    }
    __syncthreads();
    if (owns) {
      const int rows = min(GRAM_ROWS, me - m0);
      for (int t = 0; t < rows; ++t)
        acc = fmaf(wtile[t * w + p], wtile[t * w + q], acc);
    }
    __syncthreads();
  }
  if (owns) gpart[((size_t)s * rk + st + p) * k + q] = acc;
}

// Columns of H that h_gram_diag stages at a time: all n where the lane's
// k rows (at an odd row stride) fit 48 KB.
inline __host__ __device__ int h_gram_cols(int n, int k) {
  const int fit = HG_STAGE_FLOATS / k - 1;
  return n < fit ? n : (fit > 1 ? fit : 1);
}

// gh[st + p, q] = sum over j of H[st+p, j] * H[st+q, j] (opnd<BF> of
// each factor), fmaf from +0 over j in order, for the segment from st of
// width w; grid (segments, ceil(k*k / THREADS)), one (p, q) pair per
// thread, sizeof(float) * k * (h_gram_cols(n, k) + 1) bytes of dynamic
// shared memory: the segment's rows, copied h_gram_cols(n, k) columns at
// a time (all of them where they fit).
template <bool BF>
__global__ void __launch_bounds__(THREADS)
h_gram_diag(const float* __restrict__ h, float* __restrict__ gh, int n,
            Segs sg) {
  extern __shared__ float hstage[];  // [w][cols | 1]
  const int k = sg.k;
  const int cols = h_gram_cols(n, k);
  const int r = blockIdx.x;
  const int st = sg.first(r), w = sg.len(r);
  const int pair = blockIdx.y * THREADS + threadIdx.x;
  const bool owns = pair < w * w;
  const int p = owns ? pair / w : 0, q = owns ? pair % w : 0;
  float acc = 0.f;
  for (int j0 = 0; j0 < n; j0 += cols) {
    const int nc = min(cols, n - j0), ld = nc | 1;
    for (int e = threadIdx.x; e < w * nc; e += THREADS)
      cp_async4(hstage + e / nc * ld + e % nc,
                h + (size_t)(st + e / nc) * n + j0 + e % nc, 4);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (owns) {
      const float* hp = hstage + p * ld;
      const float* hq = hstage + q * ld;
      for (int c = 0; c < nc; ++c)
        acc = fmaf(opnd<BF>(hp[c]), opnd<BF>(hq[c]), acc);
    }
    __syncthreads();
  }
  if (owns) gh[((size_t)st + p) * k + q] = acc;
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
