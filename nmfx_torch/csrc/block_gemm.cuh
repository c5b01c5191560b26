// Register-tiled, cp.async-pipelined f32 product tiles for the block
// kernels (block_mu.cu, hals_block.cu): the W numerator A * Hp^T and the
// split-m H numerator Wp^T A.
//
// The chains: every output is one accumulator, started at +0 and
// advanced by fmaf over the contraction index in order, the W numerator
// acc(i, c) = fmaf(A[i, j], Hp[c, j], acc) for j = 0..n-1 and the H
// numerator partial acc(s, c, j) = fmaf(Wp[t, c], A[t, j], acc) for the
// rows t of SPLIT_ROWS-chunk s in row order. So an output depends on m,
// n and its own row and column only, never on the tile that computes it,
// the copy width or the shared-memory layout. Past an edge both operands
// are zero-filled, and fmaf(0, 0, acc) == acc for every acc these chains
// reach (+0 stays +0, since a sum that starts at +0 never becomes -0), so
// the padding to whole stages changes no bit either.
//
// What bounds these products on an H100: f32 FMA on the CUDA cores (the
// tensor cores' TF32 would change every chain), and, as closely, the
// shared-memory pipe that feeds them. The design keeps both fed: every
// thread advances each of its 8 x 4 (W) or 8 x 8 (H) accumulators once
// per contraction step from float4 fragments of shared-memory stages laid
// out along the outputs, and the next stage's global loads are in flight
// while the current one is summed:
//   - H ("TN": Wp (m, rk) and A (m, n) already run along the outputs):
//     a ring of GSTAGES stages filled by cp.async (16-byte copies where
//     the rows are 16-byte aligned, 4-byte zero-filling copies
//     otherwise);
//   - W ("NT": A (m, n) and Hp (rk, n) both run along the contraction j):
//     each stage of GBK columns is fetched into registers (float4 loads
//     where aligned) while the previous one is summed, then stored
//     transposed into the other of two shared buffers.
//
// Under bf16 operands (BF, block_common.cuh) A is read as bf16: 8-byte
// copies of 4 values where a float copy moves 16 bytes, 2-byte plain
// copies where it moves 4. The H product's W operand is a bf16 copy of
// Wp (or a shared strip already rounded), the W product rounds each Hp
// value as it is fetched; the chains are unchanged.
//
// Like block_common.cuh, everything sits in an anonymous namespace.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "block_common.cuh"

namespace {

// the element type of A (and of the H product's W operand) under BF
template <bool BF>
using a_t = typename std::conditional<BF, bf16_t, float>::type;

constexpr int GBK = 16;     // contraction depth per stage
constexpr int GSTAGES = 3;  // stages in the cp.async ring

// W numerator tile: WBM rows of A by WBN lanes' columns, 8 x 4 outputs a
// thread: thread t owns rows w_row(u) = 4 (t / 16) + 64 (u / 4) + u % 4 and
// columns w_col(v) = 4 (t % 16) + v of the tile; the W_THREADS / (WBN /
// WTN) threads that share columns are told apart by w_group()
constexpr int WBM = 128, WBN = 64, WTM = 8, WTN = 4;
constexpr int W_THREADS = 256;
constexpr int W_STAGE = GBK * (WBM + WBN);  // floats per buffer
constexpr size_t W_RING_BYTES = sizeof(float) * 2 * W_STAGE;
static_assert(WBM == 128 && WBN == 64 && GBK == 16 && W_THREADS == 256,
              "w_fetch, w_stash and w_row are written for this tile");

__device__ __forceinline__ int w_row(int u) {
  return 4 * (int)(threadIdx.x / 16) + 64 * (u / 4) + u % 4;
}
__device__ __forceinline__ int w_col(int v) {
  return 4 * (int)(threadIdx.x % 16) + v;
}
__device__ __forceinline__ int w_group() { return threadIdx.x / 16; }

// H numerator tile: HBC lanes' columns by HBN columns of A, HTC x 8 a
// thread; thread (tj, tc) = (t % HTJN, t / HTJN) owns columns 4 tc + 4 HTCN
// h + e of Wp and 4 tj + 4 HTJN h + e of A (e < 4)
constexpr int HBC = 64, HBN = 128, HTC = 8;
constexpr int HTCN = HBC / HTC, HTJN = HBN / 8;
constexpr int H_THREADS = HTCN * HTJN;
constexpr int H_STAGE = GBK * (HBC + HBN);
constexpr size_t H_RING_BYTES = sizeof(float) * GSTAGES * H_STAGE;

static_assert(SPLIT_ROWS % WBM == 0, "a split holds whole W tiles");
static_assert(SPLIT_ROWS % GBK == 0, "a split holds whole stages");
static_assert(HTC % 4 == 0, "whole float4 fragments");

// 4-element copies need rows aligned to 4 elements: a row stride that
// is a multiple of 4 and a base aligned to 4 elements of `elem` bytes
inline bool rows_aligned(const void* p, int ld, int elem = 4) {
  return ld % 4 == 0 && reinterpret_cast<uintptr_t>(p) % (4 * elem) == 0;
}

// dst[t][c] (leading dimension COLS) = src[t0 + t, c0 + c] for GBK rows
// and COLS columns, zero where t0 + t >= tend or c0 + c >= ld.
template <int COLS, int NT, bool VEC, class T>
__device__ __forceinline__ void load_cols(T* dst, const T* __restrict__ src,
                                          int ld, int t0, int tend, int c0) {
  constexpr int PER = VEC ? 4 : 1;
  constexpr int CHUNKS = GBK * (COLS / PER);
  for (int e = threadIdx.x; e < CHUNKS; e += NT) {
    const int t = e / (COLS / PER), c = (e % (COLS / PER)) * PER;
    const int row = t0 + t, col = c0 + c;
    const bool in = row < tend && col < ld;
    const T* g = in ? src + (size_t)row * ld + col : src;
    if constexpr (sizeof(T) == 4) {
      if (VEC)
        cp_async16(dst + t * COLS + c, g, in ? 16 : 0);
      else
        cp_async4(dst + t * COLS + c, g, in ? 4 : 0);
    } else if constexpr (VEC) {
      cp_async8(dst + t * COLS + c, g, in ? 8 : 0);
    } else {
      // no 2-byte cp.async: a plain copy, seen after the stage's barrier
      dst[t * COLS + c] = in ? *g : T(0);
    }
  }
}

// Stage j0 .. j0+GBK-1 of the W numerator into registers: ra[e] = A[i0 +
// t % WBM, j0 + 8 (t / WBM) + e] and rb[e] = opnd<BF>(Hp[c0 + t % WBN, j0
// + 4 (t / WBN) + e]), zero outside the matrices. VEC: 4-element loads
// (n % 4 == 0, so one is all in or all out).
template <bool VEC, bool BF>
__device__ __forceinline__ void w_fetch(const a_t<BF>* __restrict__ a,
                                        const float* __restrict__ hp, int m,
                                        int n, int rk, int i0, int c0, int j0,
                                        float (&ra)[8], float (&rb)[4]) {
  const int t = threadIdx.x;
  const int ai = i0 + t % WBM, aj = j0 + 8 * (t / WBM);
  const int bc = c0 + t % WBN, bj = j0 + 4 * (t / WBN);
  if (VEC) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const a_t<BF>* arow = a + (size_t)ai * n;
    const float4 x0 = (ai < m && aj < n) ? ldg4(arow + aj) : z;
    const float4 x1 = (ai < m && aj + 4 < n) ? ldg4(arow + aj + 4) : z;
    const float4 y =
        (bc < rk && bj < n) ? ldg4(hp + (size_t)bc * n + bj) : z;
    ra[0] = x0.x, ra[1] = x0.y, ra[2] = x0.z, ra[3] = x0.w;
    ra[4] = x1.x, ra[5] = x1.y, ra[6] = x1.z, ra[7] = x1.w;
    rb[0] = opnd<BF>(y.x), rb[1] = opnd<BF>(y.y), rb[2] = opnd<BF>(y.z),
    rb[3] = opnd<BF>(y.w);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      ra[e] = (ai < m && aj + e < n) ? ldg1(a + (size_t)ai * n + aj + e)
                                     : 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      rb[e] = (bc < rk && bj + e < n)
                  ? opnd<BF>(__ldg(hp + (size_t)bc * n + bj + e))
                  : 0.f;
  }
}

// Store w_fetch's registers transposed: buf[j][i] (GBK x WBM) for A, then
// buf[GBK*WBM + j*WBN + c] for Hp.
__device__ __forceinline__ void w_stash(float* buf, const float (&ra)[8],
                                        const float (&rb)[4]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    buf[(8 * (t / WBM) + e) * WBM + t % WBM] = ra[e];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    buf[GBK * WBM + (4 * (t / WBN) + e) * WBN + t % WBN] = rb[e];
}

// acc[u][v] = sum over j of A[i0 + w_row(u), j] * Hp[c0 + w_col(v), j]
// over j in order (the W chain above) on a WBM x WBN tile. `ring`
// holds W_RING_BYTES of shared memory; it is free again when this
// returns. Every thread of the block must call it.
template <bool VEC, bool BF>
__device__ __forceinline__ void w_numer_core(const a_t<BF>* __restrict__ a,
                                             const float* __restrict__ hp,
                                             int m, int n, int rk, int i0,
                                             int c0, float* ring,
                                             float (&acc)[WTM][WTN]) {
  const int ti = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll
  for (int u = 0; u < WTM; ++u)
#pragma unroll
    for (int v = 0; v < WTN; ++v) acc[u][v] = 0.f;
  const int stages = (n + GBK - 1) / GBK;
  float ra[8], rb[4];
  w_fetch<VEC, BF>(a, hp, m, n, rk, i0, c0, 0, ra, rb);
  w_stash(ring, ra, rb);
  __syncthreads();
  for (int kt = 0; kt < stages; ++kt) {
    // stage kt+1's loads fly while stage kt is summed
    if (kt + 1 < stages)
      w_fetch<VEC, BF>(a, hp, m, n, rk, i0, c0, (kt + 1) * GBK, ra, rb);
    const float* as = ring + (kt % 2) * W_STAGE + 4 * ti;
    const float* bs = ring + (kt % 2) * W_STAGE + GBK * WBM + 4 * tc;
#pragma unroll
    for (int kk = 0; kk < GBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * WBM);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * WBM + 64);
      const float4 b = *reinterpret_cast<const float4*>(bs + kk * WBN);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int u = 0; u < WTM; ++u)
#pragma unroll
        for (int v = 0; v < WTN; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
    // the other buffer was last read before the previous barrier
    if (kt + 1 < stages) w_stash(ring + ((kt + 1) % 2) * W_STAGE, ra, rb);
    __syncthreads();
  }
}

// One contraction step of the H numerator: acc[u][v] += w[cu] * a[jv] for
// the thread's CV columns cu = 4 tc + 4 TCN (u / 4) + u % 4 of `wrow` and
// 8 columns jv = 4 tj + 4 TJN (v / 4) + v % 4 of `arow` (float or bf16
// rows, each 4-element aligned).
template <int CV, int TCN, int TJN, class TW, class TA>
__device__ __forceinline__ void h_step(const TW* wrow, const TA* arow,
                                       int tc, int tj, float (&acc)[CV][8]) {
  float wv[CV], av[8];
#pragma unroll
  for (int h = 0; h < CV / 4; ++h) {
    const float4 x = ld4(wrow + 4 * TCN * h + 4 * tc);
    wv[4 * h] = x.x;
    wv[4 * h + 1] = x.y;
    wv[4 * h + 2] = x.z;
    wv[4 * h + 3] = x.w;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 x = ld4(arow + 4 * TJN * h + 4 * tj);
    av[4 * h] = x.x;
    av[4 * h + 1] = x.y;
    av[4 * h + 2] = x.z;
    av[4 * h + 3] = x.w;
  }
#pragma unroll
  for (int u = 0; u < CV; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(wv[u], av[v], acc[u][v]);
}

// part[s, c, j] for the thread's outputs (h_step's layout) of the tile
// (c0, j0), columns c < cend; float4 stores when the rows of part are
// 16-byte aligned.
template <int CV, int TCN, int TJN, bool VEC>
__device__ __forceinline__ void h_store(const float (&acc)[CV][8],
                                        float* __restrict__ part, int s,
                                        int n, int rk, int cend, int c0,
                                        int j0, int tc, int tj) {
#pragma unroll
  for (int u = 0; u < CV; ++u) {
    const int c = c0 + 4 * tc + 4 * TCN * (u / 4) + u % 4;
    if (c >= cend) continue;
    float* row = part + ((size_t)s * rk + c) * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + 4 * TJN * h + 4 * tj;
      if (VEC) {
        if (j < n)
          *reinterpret_cast<float4*>(row + j) =
              make_float4(acc[u][4 * h], acc[u][4 * h + 1], acc[u][4 * h + 2],
                          acc[u][4 * h + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j + e < n) row[j + e] = acc[u][4 * h + e];
      }
    }
  }
}

// part[s, c, j] = sum over the rows t of SPLIT_ROWS-chunk s of
// Wp[t, c] * A[t, j], in row order (the H chain above) on the HBC x
// HBN tile of columns c0 .. (stored below cend) and j0 = blockIdx.x *
// HBN, s = blockIdx.z; `ring` holds H_RING_BYTES of shared memory. After
// each stage's products, hook(ws) sees that stage's Wp rows ws[GBK][HBC]
// (type T; columns from c0; zero past the chunk and past rk) until the
// next barrier; it must not sync. Every thread of the block must call it.
// VW / VA: 4-element copies of Wp / A (and stores of part). T: float, or
// bf16 for both operands (a bf16 copy of Wp) under bf16 operands.
template <bool VW, bool VA, class T, class Hook>
__device__ __forceinline__ void h_numer_tile(const T* __restrict__ a,
                                             const T* __restrict__ wp,
                                             float* __restrict__ part, int m,
                                             int n, int rk, int c0, int cend,
                                             float* ring_f, Hook&& hook) {
  T* ring = reinterpret_cast<T*>(ring_f);
  const int tj = threadIdx.x % HTJN, tc = threadIdx.x / HTJN;
  const int j0 = blockIdx.x * HBN, s = blockIdx.z;
  const int mb = s * SPLIT_ROWS, me = min(m, mb + SPLIT_ROWS);
  float acc[HTC][8];
#pragma unroll
  for (int u = 0; u < HTC; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;
  const int stages = (me - mb + GBK - 1) / GBK;
  auto load = [&](int kt) {
    T* st = ring + (kt % GSTAGES) * H_STAGE;
    load_cols<HBC, H_THREADS, VW>(st, wp, rk, mb + kt * GBK, me, c0);
    load_cols<HBN, H_THREADS, VA>(st + GBK * HBC, a, n, mb + kt * GBK, me,
                                  j0);
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
    const T* ws = ring + (kt % GSTAGES) * H_STAGE;
    const T* as = ws + GBK * HBC;
#pragma unroll
    for (int kk = 0; kk < GBK; ++kk)
      h_step<HTC, HTCN, HTJN>(ws + kk * HBC, as + kk * HBN, tc, tj, acc);
    hook(ws);
  }
  cp_async_wait<0>();
  h_store<HTC, HTCN, HTJN, VA>(acc, part, s, n, rk, cend, c0, j0, tc, tj);
}

// h_numer_tile on the column tiles c0 = blockIdx.y * HBC; grid (ceil(n /
// HBN), ceil(rk / HBC), splits), H_RING_BYTES of dynamic shared memory.
template <bool VW, bool VA, class T>
__global__ void __launch_bounds__(H_THREADS, 3)
h_numer_split(const T* __restrict__ a, const T* __restrict__ wp,
              float* __restrict__ part, int m, int n, int rk) {
  extern __shared__ __align__(16) float h_ring[];
  h_numer_tile<VW, VA, T>(a, wp, part, m, n, rk, blockIdx.y * HBC, rk,
                          h_ring, [](const T*) {});
}

}  // namespace
