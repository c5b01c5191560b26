// Pipelined product tiles for the block kernels (block_mu.cu,
// hals_block.cu): the W numerator A * Hp^T and the split-m H numerator
// Wp^T A, register-tiled f32 chains on the CUDA cores for float32
// operands and warpgroup MMAs (wgmma) on the tensor cores for bf16 ones.
//
// float32 operands. The chains: every output is one accumulator,
// started at +0 and advanced by fmaf over the contraction index in order,
// the W numerator acc(i, c) = fmaf(A[i, j], Hp[c, j], acc) for j =
// 0..n-1 and the H numerator partial acc(s, c, j) = fmaf(Wp[t, c], A[t,
// j], acc) for the rows t of SPLIT_ROWS-chunk s in row order. So an
// output depends on m, n and its own row and column only, never on the
// tile that computes it, the copy width or the shared-memory layout. Past
// an edge both operands are zero-filled, and fmaf(0, 0, acc) == acc for
// every acc these chains reach (+0 stays +0, since a sum that starts at
// +0 never becomes -0), so the padding to whole stages changes no bit
// either.
//
// What bounds the float32 products on an H100: f32 FMA on the CUDA cores
// (the tensor cores' TF32 would change every chain), and, as closely, the
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
// bf16 operands (BF, block_common.cuh). Both products are
// wgmma.mma_async m64n64k16 bf16 x bf16 -> f32 on the tensor cores, both
// operands in shared memory (no-swizzle core matrices of 8 x 8 bf16,
// described by wgmma descriptors), filled by a multi-stage cp.async ring
// (8-byte copies of 4 values where the rows are 4-element aligned,
// 2-byte plain copies otherwise; A's rows are 1,000 bytes at the north
// star, so a tensor map, which needs 16-byte strides, cannot take it):
//   - H: one warpgroup a 64-column x 128-column tile, two products a K
//     step (the tile's halves), both operands MN-major (the transpose
//     bits): the bf16 copy of Wp (or a shared strip already rounded) and
//     A, both as they lie;
//   - W: two warpgroups of 64 rows a 128 x 64 tile, both operands
//     K-major: A as it lies, Hp rounded to bf16 (round to nearest even)
//     as it is staged.
// The numeric contract of the bf16 products replaces the chains above. A
// product of two bf16 values is exact in float32. An output is a float32
// sum from +0 over its K steps of 16 in order: the H partial of split s
// over the chunk's rows, the W numerator over j = 0..n-1, the tail of
// each zero-filled. Each step is a fresh wgmma (scale-d 0), which sums
// its 16 products as Hopper's tensor cores do: each aligned to the
// largest operand-exponent sum among them, truncated to a multiple of
// 2^(emax - 25), added exactly, the sum truncated to float32; the step
// is then added to the output's sum with one float32 add (wg_step).
// tensor_core_products in ops/fused_mu.py is the same sum in plain
// PyTorch, bit for bit. (Steps chained in the accumulator would truncate
// every product against the running sum and drift it low.) The value
// then depends only on the operands and that order. Every caller takes
// the same wgmma shape and steps for the same product, so an output does
// not depend on the tile or kernel that computes it, and the
// byte-equalities of the float32 products hold under bf16 too (the
// join-the-updates pass against the phased kernel, the per-iteration
// pair against one block iteration); zero-filled steps add +0, which
// changes no sum. The accumulator fragment of wgmma is not the float32
// tiles' layout: the W core stages its sums through shared memory, one
// warpgroup's 64 rows at a time, and returns them in w_row / w_col's
// layout, so every W epilogue reads them unchanged; the H tile stores
// its fragment itself (h_store_frag). What bounds the bf16 products: not
// the tensor cores' rate (989 TFLOP/s dense); the copies into shared
// memory, their latency and the wait and float32 adds of each step hold
// these tiles (PERF.md).
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
constexpr int GSTAGES = 3;  // stages in the float32 cp.async ring

// W numerator tile: WBM rows of A by WBN lanes' columns, 8 x 4 outputs a
// thread: thread t owns rows w_row(u) = 4 (t / 16) + 64 (u / 4) + u % 4 and
// columns w_col(v) = 4 (t % 16) + v of the tile; the W_THREADS / (WBN /
// WTN) threads that share columns are told apart by w_group()
constexpr int WBM = 128, WBN = 64, WTM = 8, WTN = 4;
constexpr int W_THREADS = 256;
constexpr int W_STAGE = GBK * (WBM + WBN);  // floats per buffer
constexpr size_t W_RING_BYTES = sizeof(float) * 2 * W_STAGE;
static_assert(WBM == 128 && WBN == 64 && GBK == 16 && W_THREADS == 256,
              "w_fetch, w_stash, w_row and the wgmma tiles are written for "
              "this tile");

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
static_assert(H_THREADS == 128 && HBC == 64 && HBN == 128,
              "the bf16 H tile is one warpgroup, two 64-column halves");

// 4-element copies need rows aligned to 4 elements: a row stride that
// is a multiple of 4 and a base aligned to 4 elements of `elem` bytes
inline bool rows_aligned(const void* p, int ld, int elem = 4) {
  return ld % 4 == 0 && reinterpret_cast<uintptr_t>(p) % (4 * elem) == 0;
}

// ---------------------------------------------------------------------
// float32 operands: the fmaf chains on the CUDA cores

// dst[t][c] (leading dimension COLS) = src[t0 + t, c0 + c] for GBK rows
// and COLS columns, zero where t0 + t >= tend or c0 + c >= ld.
template <int COLS, int NT, bool VEC>
__device__ __forceinline__ void load_cols(float* dst,
                                          const float* __restrict__ src,
                                          int ld, int t0, int tend, int c0) {
  constexpr int PER = VEC ? 4 : 1;
  constexpr int CHUNKS = GBK * (COLS / PER);
  for (int e = threadIdx.x; e < CHUNKS; e += NT) {
    const int t = e / (COLS / PER), c = (e % (COLS / PER)) * PER;
    const int row = t0 + t, col = c0 + c;
    const bool in = row < tend && col < ld;
    const float* g = in ? src + (size_t)row * ld + col : src;
    if (VEC)
      cp_async16(dst + t * COLS + c, g, in ? 16 : 0);
    else
      cp_async4(dst + t * COLS + c, g, in ? 4 : 0);
  }
}

// Stage j0 .. j0+GBK-1 of the W numerator into registers: ra[e] = A[i0 +
// t % WBM, j0 + 8 (t / WBM) + e] and rb[e] = Hp[c0 + t % WBN, j0 + 4 (t /
// WBN) + e], zero outside the matrices. VEC: 4-element loads (n % 4 ==
// 0, so one is all in or all out).
template <bool VEC>
__device__ __forceinline__ void w_fetch(const float* __restrict__ a,
                                        const float* __restrict__ hp, int m,
                                        int n, int rk, int i0, int c0, int j0,
                                        float (&ra)[8], float (&rb)[4]) {
  const int t = threadIdx.x;
  const int ai = i0 + t % WBM, aj = j0 + 8 * (t / WBM);
  const int bc = c0 + t % WBN, bj = j0 + 4 * (t / WBN);
  if (VEC) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* arow = a + (size_t)ai * n;
    const float4 x0 = (ai < m && aj < n) ? ldg4(arow + aj) : z;
    const float4 x1 = (ai < m && aj + 4 < n) ? ldg4(arow + aj + 4) : z;
    const float4 y =
        (bc < rk && bj < n) ? ldg4(hp + (size_t)bc * n + bj) : z;
    ra[0] = x0.x, ra[1] = x0.y, ra[2] = x0.z, ra[3] = x0.w;
    ra[4] = x1.x, ra[5] = x1.y, ra[6] = x1.z, ra[7] = x1.w;
    rb[0] = y.x, rb[1] = y.y, rb[2] = y.z, rb[3] = y.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      ra[e] = (ai < m && aj + e < n) ? __ldg(a + (size_t)ai * n + aj + e)
                                     : 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      rb[e] = (bc < rk && bj + e < n) ? __ldg(hp + (size_t)bc * n + bj + e)
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

// w_numer_core's float32 chains: double-buffered register stages, 8 x 4
// fmaf accumulators a thread.
template <bool VEC>
__device__ __forceinline__ void w_numer_fmaf(const float* __restrict__ a,
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
  w_fetch<VEC>(a, hp, m, n, rk, i0, c0, 0, ra, rb);
  w_stash(ring, ra, rb);
  __syncthreads();
  for (int kt = 0; kt < stages; ++kt) {
    // stage kt+1's loads fly while stage kt is summed
    if (kt + 1 < stages)
      w_fetch<VEC>(a, hp, m, n, rk, i0, c0, (kt + 1) * GBK, ra, rb);
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
// 8 columns jv = 4 tj + 4 TJN (v / 4) + v % 4 of `arow` (float rows, each
// 4-element aligned).
template <int CV, int TCN, int TJN>
__device__ __forceinline__ void h_step(const float* wrow, const float* arow,
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

// h_numer_tile's float32 chains: a GSTAGES cp.async ring, 8 x 8 fmaf
// accumulators a thread.
template <bool VW, bool VA, class Hook>
__device__ __forceinline__ void h_numer_fmaf(const float* __restrict__ a,
                                             const float* __restrict__ wp,
                                             float* __restrict__ part, int m,
                                             int n, int rk, int c0, int cend,
                                             float* ring, Hook&& hook) {
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
    float* st = ring + (kt % GSTAGES) * H_STAGE;
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
    const float* ws = ring + (kt % GSTAGES) * H_STAGE;
    const float* as = ws + GBK * HBC;
#pragma unroll
    for (int kk = 0; kk < GBK; ++kk)
      h_step<HTC, HTCN, HTJN>(ws + kk * HBC, as + kk * HBN, tc, tj, acc);
    hook(ws);
  }
  cp_async_wait<0>();
  h_store<HTC, HTCN, HTJN, VA>(acc, part, s, n, rk, cend, c0, j0, tc, tj);
}

// ---------------------------------------------------------------------
// bf16 operands: warpgroup MMAs (wgmma) on the tensor cores

constexpr int WG_THREADS = 128;  // a warpgroup

// Shared-memory layouts of the wgmma operands: no-swizzle core matrices
// of 8 x 8 bf16 (128 contiguous bytes).
// An MN-major operand of K rows t by COLS columns c (M or N): core
// matrix (t / 8, c / 8) holds 8 rows of 8 contiguous columns; the COLS
// / 8 core matrices of a row group are 128 bytes apart (the
// descriptor's stride offset), row groups 16 * COLS bytes apart (its
// leading offset).
template <int COLS>
__device__ __forceinline__ int mn_core(int t, int c) {
  return (t >> 3) * 8 * COLS + (c >> 3) * 64 + (t & 7) * 8 + (c & 7);
}
// A K-major operand of rows r (M or N) by GBK columns j (K): core matrix
// (r / 8, j / 8) holds 8 rows of 8 contiguous columns; the two core
// matrices of a row group are 128 bytes apart (leading offset), row
// groups 256 bytes apart (stride offset).
__device__ __forceinline__ int k_core(int r, int j) {
  return (r >> 3) * 128 + (j >> 3) * 64 + (r & 7) * 8 + (j & 7);
}
static_assert(GBK == 16, "k_core holds two core matrices of K a row group");

// The wgmma descriptor of a no-swizzle operand at shared address p with
// leading / stride byte offsets lbo / sbo.
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((s & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
}

// generic-proxy writes to shared memory (st.shared, cp.async) made
// visible to wgmma, which reads through the async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// orders the accumulators' uses after the wgmma that writes them
template <int N>
__device__ __forceinline__ void wg_fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64) = A (64 x 16) B (16 x 64), plus d itself when scale_d is
// not 0: both operands K-major (TRANS 0) or both MN-major (TRANS 1, the
// transpose bits). Fragment: thread t of the warpgroup holds d[4 b + 2 h
// + e] at row 16 (t / 32) + (t % 32) / 4 + 8 h, column 8 b + 2 (t % 4) +
// e.
template <int TRANS>
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS));
}

// One K step of an output fragment: d = the step's fresh product of A
// da and B db, issued by wgmma_64x64<TRANS> and waited for, then s += d
// with one float32 add an output. `overlap()` runs while the product is
// in flight. Every warp of the warpgroup calls it.
template <int TRANS, class Overlap>
__device__ __forceinline__ void wg_step(float (&s)[32], float (&d)[32],
                                        uint64_t da, uint64_t db,
                                        Overlap&& overlap) {
  wg_fence();
  wgmma_64x64<TRANS>(d, da, db, 0);
  wg_commit();
  overlap();
  wg_wait0();
  wg_fence_regs(d);
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] += d[i];
}

// the descriptors' byte offsets: an H stage's W operand (HBC or WBN
// columns; the strip of a join-the-updates pass has the same strides),
// its A operand (HBN columns), a K-major W stage's operands
constexpr uint32_t H_W_LBO = 16 * HBC, H_A_LBO = 16 * HBN, MN_SBO = 128;
constexpr uint32_t K_LBO = 128, K_SBO = 256;
static_assert(HBC == WBN, "the strip and the H stage share descriptors");

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// dst (mn_core<COLS>) = src[t0 + t, c0 + c] for GBK rows t and COLS
// columns c, zero where t0 + t >= tend or c0 + c >= ld; thread `tid` of
// NT. VEC: 8-byte copies of 4 elements (ld % 4 == 0, the base 8-byte
// aligned), else 2-byte plain copies, seen after the stage's barrier.
// Consecutive copies fill one core matrix's 8 rows, then the next row
// group's, then the next column group, so a warp writes whole 128-byte
// core matrices without a bank conflict (copies along a row would land
// 128 bytes apart, all in the same banks).
template <int COLS, int NT, bool VEC>
__device__ __forceinline__ void load_mn(bf16_t* dst,
                                        const bf16_t* __restrict__ src,
                                        int ld, int t0, int tend, int c0,
                                        int tid) {
  constexpr int PER = VEC ? 4 : 1;
  constexpr int CPR = 8 / PER;  // copies a core matrix row
  constexpr int CHUNKS = GBK * (COLS / PER);
  static_assert(GBK == 16, "two row groups a stage");
  for (int e = tid; e < CHUNKS; e += NT) {
    const int t = (e / CPR) % GBK, c = (e / (CPR * GBK)) * 8 + e % CPR * PER;
    const int row = t0 + t, col = c0 + c;
    const bool in = row < tend && col < ld;
    const bf16_t* g = in ? src + (size_t)row * ld + col : src;
    bf16_t* d = dst + mn_core<COLS>(t, c);
    if (VEC)
      cp_async8(d, g, in ? 8 : 0);
    else
      *d = in ? *g : bf16_t(0);
  }
}

// The A half of one stage of the W product in k_core layout: A[i0 + r,
// j0 + j] for the WBM rows r and GBK columns j (cp.async as load_mn), zero
// outside the matrix.
template <bool VEC>
__device__ __forceinline__ void w_stage_a(bf16_t* st,
                                          const bf16_t* __restrict__ a,
                                          int m, int n, int i0, int j0) {
  constexpr int PER = VEC ? 4 : 1;
  for (int e = threadIdx.x; e < WBM * GBK / PER; e += W_THREADS) {
    const int r = e / (GBK / PER), j = (e % (GBK / PER)) * PER;
    const int row = i0 + r, col = j0 + j;
    const bool in = row < m && col < n;
    const bf16_t* g = in ? a + (size_t)row * n + col : a;
    bf16_t* d = st + k_core(r, j);
    if (VEC)
      cp_async8(d, g, in ? 8 : 0);
    else
      *d = in ? *g : bf16_t(0);
  }
}

// The Hp half, in registers first: thread t fetches the 4 values v of
// Hp[c0 + c, j0 + j ..] (w_hp_col / w_hp_j: a warp 8 columns by the
// stage's 16 values, which w_stash_hp writes as 256 contiguous bytes),
// zero outside the matrix, and w_stash_hp stores them rounded to bf16
// (round to nearest even) into the stage.
__device__ __forceinline__ int w_hp_col() {
  return (int)(threadIdx.x % 8 + 8 * (threadIdx.x / 32));
}
__device__ __forceinline__ int w_hp_j() {
  return (int)(4 * (threadIdx.x / 8 % 4));
}
template <bool VEC>
__device__ __forceinline__ void w_fetch_hp(const float* __restrict__ hp,
                                           int n, int rk, int c0, int j0,
                                           float (&v)[4]) {
  const int bc = c0 + w_hp_col(), bj = j0 + w_hp_j();
  if (VEC) {
    const float4 y = (bc < rk && bj < n) ? ldg4(hp + (size_t)bc * n + bj)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = y.x, v[1] = y.y, v[2] = y.z, v[3] = y.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = (bc < rk && bj + e < n) ? __ldg(hp + (size_t)bc * n + bj + e)
                                     : 0.f;
  }
}
__device__ __forceinline__ void w_stash_hp(bf16_t* st, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(st + WBM * GBK + k_core(w_hp_col(), w_hp_j())) =
      make_uint2(bf16_bits(v[0]) | bf16_bits(v[1]) << 16,
                 bf16_bits(v[2]) | bf16_bits(v[3]) << 16);
}
static_assert(WBN * GBK == 4 * W_THREADS, "one Hp quad a thread a stage");

// w_numer_core under bf16 operands: a ring of W_NS stages (cp.async for A,
// registers for the rounded Hp, fetched one step before they are
// stored), warpgroup g = t / 128 summing rows 64 g .. 64 g + 63 in
// m64n64k16 steps (wg_step); the sums then staged through the ring into
// w_row / w_col's layout.
constexpr int W_BSTAGE = (WBM + WBN) * GBK;  // bf16 per stage
constexpr int W_NS = (int)(W_RING_BYTES / (sizeof(bf16_t) * W_BSTAGE));
constexpr int W_ACC_LD = WBN + 8;  // floats a row of the staged fragment
static_assert(W_NS >= 2, "a ring of two stages at least");
static_assert(sizeof(float) * (WBM / 2) * W_ACC_LD <= W_RING_BYTES,
              "half the fragments fit the ring");

template <bool VEC>
__device__ __forceinline__ void w_numer_wgmma(const bf16_t* __restrict__ a,
                                              const float* __restrict__ hp,
                                              int m, int n, int rk, int i0,
                                              int c0, float* ring_f,
                                              float (&acc)[WTM][WTN]) {
  bf16_t* ring = reinterpret_cast<bf16_t*>(ring_f);
  const int wg = threadIdx.x / WG_THREADS;
  const int stages = (n + GBK - 1) / GBK;
  float sum[32], d[32], hv[4];
#pragma unroll
  for (int i = 0; i < 32; ++i) sum[i] = d[i] = 0.f;
  // stage kt: its A, and the Hp values fetched into hv before
  auto load = [&](int kt) {
    bf16_t* st = ring + (kt % W_NS) * W_BSTAGE;
    w_stage_a<VEC>(st, a, m, n, i0, kt * GBK);
    w_stash_hp(st, hv);
  };
#pragma unroll
  for (int kt = 0; kt < W_NS - 1; ++kt) {
    if (kt < stages) {
      w_fetch_hp<VEC>(hp, n, rk, c0, kt * GBK, hv);
      load(kt);
    }
    cp_async_commit();
  }
  if (W_NS - 1 < stages)
    w_fetch_hp<VEC>(hp, n, rk, c0, (W_NS - 1) * GBK, hv);
  for (int kt = 0; kt < stages; ++kt) {
    cp_async_wait<W_NS - 2>();
    fence_async_smem();
    // stage kt has landed; every warpgroup is done with stage kt - 1
    __syncthreads();
    const bf16_t* st = ring + (kt % W_NS) * W_BSTAGE;
    wg_step<0>(sum, d, wg_desc(st + k_core(64 * wg, 0), K_LBO, K_SBO),
               wg_desc(st + WBM * GBK, K_LBO, K_SBO), [&] {
                 // into the slot of stage kt - 1 while the product runs;
                 // the next stage's Hp flies until the next step
                 if (kt + W_NS - 1 < stages) {
                   load(kt + W_NS - 1);
                   if (kt + W_NS < stages)
                     w_fetch_hp<VEC>(hp, n, rk, c0, (kt + W_NS) * GBK, hv);
                 }
                 cp_async_commit();
               });
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free
  float* buf = ring_f;  // [WBM / 2][W_ACC_LD]
  const int wr = 16 * ((threadIdx.x % WG_THREADS) / 32) + threadIdx.x % 32 / 4;
  const int wc = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    if (wg == g)
#pragma unroll
      for (int b = 0; b < 8; ++b)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(buf + (wr + 8 * h) * W_ACC_LD + 8 * b +
                                     wc) =
              make_float2(sum[4 * b + 2 * h], sum[4 * b + 2 * h + 1]);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < WTM / 2; ++u) {
      const float4 x = *reinterpret_cast<const float4*>(
          buf + w_row(u) * W_ACC_LD + w_col(0));
      acc[4 * g + u][0] = x.x;
      acc[4 * g + u][1] = x.y;
      acc[4 * g + u][2] = x.z;
      acc[4 * g + u][3] = x.w;
    }
    __syncthreads();  // the buffer is rewritten, or free for the caller
  }
}

// The H product's operand descriptors at K step kt: the W operand (an H
// stage's, or the strip of a join-the-updates pass: mn_core over WBN =
// HBC columns) and half `h` (columns 64 h ..) of an A stage.
__device__ __forceinline__ uint64_t h_w_desc(const bf16_t* w) {
  return wg_desc(w, H_W_LBO, MN_SBO);
}
__device__ __forceinline__ uint64_t h_a_desc(const bf16_t* as, int h) {
  return wg_desc(as + mn_core<HBN>(0, 64 * h), H_A_LBO, MN_SBO);
}

// part[s, c, j] of a 64 x 64 wgmma fragment's sums `sum` (wgmma_64x64's
// layout) at lane columns from c0 and columns of A from j0, for thread
// `tid` of the warpgroup, columns c < cend; float2 stores when the rows
// of part are 16-byte aligned.
template <bool VEC>
__device__ __forceinline__ void h_store_frag(const float (&sum)[32],
                                             float* __restrict__ part, int s,
                                             int n, int rk, int cend, int c0,
                                             int j0, int tid) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + 16 * (tid / 32) + tid % 32 / 4 + 8 * h;
    if (c >= cend) continue;
    float* row = part + ((size_t)s * rk + c) * n;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int j = j0 + 8 * b + 2 * (tid % 4);
      const float x = sum[4 * b + 2 * h], y = sum[4 * b + 2 * h + 1];
      if (VEC) {
        if (j < n) *reinterpret_cast<float2*>(row + j) = make_float2(x, y);
      } else {
        if (j < n) row[j] = x;
        if (j + 1 < n) row[j + 1] = y;
      }
    }
  }
}

// h_numer_tile under bf16 operands: one warpgroup, a ring of H_NS stages;
// each K step two m64n64k16 products (wg_step), the tile's A columns 0 ..
// 63 and 64 .. 127, one after the other (issued together they need 32
// more registers a thread and ran slower).
constexpr int H_BSTAGE = GBK * (HBC + HBN);  // bf16 per stage
constexpr int H_NS = (int)(H_RING_BYTES / (sizeof(bf16_t) * H_BSTAGE));
static_assert(H_NS >= 2, "a ring of two stages at least");
static_assert(HBN == 128, "two 64-column halves");

template <bool VW, bool VA, class Hook>
__device__ __forceinline__ void h_numer_wgmma(const bf16_t* __restrict__ a,
                                              const bf16_t* __restrict__ wp,
                                              float* __restrict__ part, int m,
                                              int n, int rk, int c0, int cend,
                                              float* ring_f, Hook&& hook) {
  bf16_t* ring = reinterpret_cast<bf16_t*>(ring_f);
  const int j0 = blockIdx.x * HBN, s = blockIdx.z;
  const int mb = s * SPLIT_ROWS, me = min(m, mb + SPLIT_ROWS);
  const int stages = (me - mb + GBK - 1) / GBK;
  auto load = [&](int kt) {
    bf16_t* st = ring + (kt % H_NS) * H_BSTAGE;
    load_mn<HBC, H_THREADS, VW>(st, wp, rk, mb + kt * GBK, me, c0,
                                threadIdx.x);
    load_mn<HBN, H_THREADS, VA>(st + GBK * HBC, a, n, mb + kt * GBK, me, j0,
                                threadIdx.x);
  };
#pragma unroll
  for (int kt = 0; kt < H_NS - 1; ++kt) {
    if (kt < stages) load(kt);
    cp_async_commit();
  }
  float sum[2][32], d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sum[0][i] = sum[1][i] = d[i] = 0.f;
  for (int kt = 0; kt < stages; ++kt) {
    cp_async_wait<H_NS - 2>();
    fence_async_smem();
    // stage kt has landed; the products and hook of stage kt - 1 are done
    __syncthreads();
    const bf16_t* st = ring + (kt % H_NS) * H_BSTAGE;
    const uint64_t dw = h_w_desc(st);
    wg_step<1>(sum[0], d, dw, h_a_desc(st + GBK * HBC, 0), [&] {
      // into the slot of stage kt - 1 while the products run
      if (kt + H_NS - 1 < stages) load(kt + H_NS - 1);
      cp_async_commit();
      hook(st);
    });
    wg_step<1>(sum[1], d, dw, h_a_desc(st + GBK * HBC, 1), [] {});
  }
  cp_async_wait<0>();
  h_store_frag<VA>(sum[0], part, s, n, rk, cend, c0, j0, threadIdx.x);
  h_store_frag<VA>(sum[1], part, s, n, rk, cend, c0, j0 + 64, threadIdx.x);
}

// ---------------------------------------------------------------------
// The tiles

// acc[u][v] = sum over j of A[i0 + w_row(u), j] * Hp[c0 + w_col(v), j]
// on a WBM x WBN tile: the float32 chain above, or under BF the wgmma
// product. `ring` holds W_RING_BYTES of shared memory; it is free again
// when this returns. Every thread of the block must call it.
template <bool VEC, bool BF>
__device__ __forceinline__ void w_numer_core(const a_t<BF>* __restrict__ a,
                                             const float* __restrict__ hp,
                                             int m, int n, int rk, int i0,
                                             int c0, float* ring,
                                             float (&acc)[WTM][WTN]) {
  if constexpr (BF)
    w_numer_wgmma<VEC>(a, hp, m, n, rk, i0, c0, ring, acc);
  else
    w_numer_fmaf<VEC>(a, hp, m, n, rk, i0, c0, ring, acc);
}

// Where element (row kk, column c) of an H stage's W operand lies in the
// stage (type T): row-major [GBK][HBC] for float, mn_core for bf16.
template <class T>
__device__ __forceinline__ int h_wst(int kk, int c) {
  if constexpr (sizeof(T) == sizeof(bf16_t))
    return mn_core<HBC>(kk, c);
  else
    return kk * HBC + c;
}

// part[s, c, j] = sum over the rows t of SPLIT_ROWS-chunk s of
// Wp[t, c] * A[t, j] (the float32 chain, or under bf16 the wgmma chain,
// above) on the HBC x HBN tile of columns c0 .. (stored below cend) and
// j0 = blockIdx.x * HBN, s = blockIdx.z; `ring` holds H_RING_BYTES of
// shared memory. After each stage's products are issued, hook(ws) sees
// that stage's Wp rows (type T, element (kk, c) at h_wst<T>(kk, c);
// columns from c0; zero past the chunk and past rk) until the next
// barrier; it must not sync. Every thread of the block must call it.
// VW / VA: 4-element copies of Wp / A (and stores of part). T: float, or
// bf16 for both operands (a bf16 copy of Wp) under bf16 operands.
template <bool VW, bool VA, class T, class Hook>
__device__ __forceinline__ void h_numer_tile(const T* __restrict__ a,
                                             const T* __restrict__ wp,
                                             float* __restrict__ part, int m,
                                             int n, int rk, int c0, int cend,
                                             float* ring_f, Hook&& hook) {
  if constexpr (sizeof(T) == sizeof(bf16_t))
    h_numer_wgmma<VW, VA>(a, wp, part, m, n, rk, c0, cend, ring_f, hook);
  else
    h_numer_fmaf<VW, VA>(a, wp, part, m, n, rk, c0, cend, ring_f, hook);
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
