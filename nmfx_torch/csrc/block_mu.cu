// Hand-written sm_90a block of full MU iterations for the slot scheduler.
//
// Replaces nmfx/ops/pallas_mu.py:fused_block_iterations, both its phased
// _block_kernel (fused=False, entry nmfx_block_iterations) and its
// join-the-updates _fused_block_kernel (fused=True, entry
// nmfx_block_iterations_fused): iters * check_block full MU iterations
// of the packed slot pool in one call, with per-lane freezes, the
// per-lane iteration budget fence, per-boundary TolX stats and, when
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
//
// The join-the-updates variant runs T + 1 passes (T = iters*check_block)
// instead of T iterations. Pass p runs, on each SPLIT_ROWS-row chunk of A
// in one block per (64-column lane tile, chunk) (wh_pass): the W half of
// iteration p-1 on the chunk's rows (skipped at p = 0; fence <= p-1),
// kept in shared memory, then the H-numerator partial of iteration p from
// the same A rows and that W (skipped at p = T). Then h_gram_partial,
// h_block_epilogue (fence <= p) and h_gram_diag finish iteration p's H
// half. W stats land when p % iters == 0 (p > 0, row p/iters - 1), H
// stats and snapshots when (p+1) % iters == 0 (p < T). Every output
// element is the same chain of fmaf and adds as in the phased kernel, so
// all seven outputs are byte-equal to it. The W half needs the complete
// H of the previous pass, so a pass stays four launches. What it saves
// is one of the two reads of A per iteration, but A (10.2 MB here) sits
// in L2 either way, and a pass's 8 x 20 blocks each run four W tiles
// and eight numerator tiles in series: on an H100 it is slower than the
// phased order (PERF.md).

#include <cuda_runtime.h>
#include <stddef.h>

#include "block_common.cuh"

namespace {

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

// The W epilogue of the 64 x 64 tile (i0, c0) whose numerators A Hp^T
// are in `acc` (w_numer_tile's layout):
//   out[i, c] = epilogue(Wp[i, c], acc,
//                        sum_q Wp[i, r*k+q] * gh[r, q, c - r*k]),
// r = c / k, or Wp[i, c] on a frozen column; `keep` (may be null) gets
// the same values, row-major with leading dimension TILE from row i0.
// With `stats`, the tile's column maxima of |out - Wp| and |Wp| go to
// row `trow` of wdp / wmp. Every thread of the block must call it.
__device__ __forceinline__ void w_tile_epilogue(
    const float (&acc)[4][4], const float* __restrict__ wp,
    const float* __restrict__ gh, const float* __restrict__ frozen,
    const float* __restrict__ budget, float* __restrict__ out,
    float* __restrict__ keep, float* __restrict__ wdp,
    float* __restrict__ wmp, int trow, int m, int rk, int k, int i0, int c0,
    int it, int stats, float eps, float zero_threshold) {
  __shared__ float red_d[16][TILE];
  __shared__ float red_m[16][TILE];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
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
      if (keep != nullptr) keep[(ty + 16 * u) * TILE + tx + 16 * v] = wn;
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
      wdp[(size_t)trow * rk + c] = d;
      wmp[(size_t)trow * rk + c] = mx;
    }
  }
  __syncthreads();  // red_* may be reused by the caller's next tile
}

// The tile-local W half; grid (ceil(rk / TILE), ceil(m / TILE)).
__global__ void __launch_bounds__(THREADS)
w_block_update(const float* __restrict__ a, const float* __restrict__ wp,
               const float* __restrict__ hp, const float* __restrict__ gh,
               const float* __restrict__ frozen,
               const float* __restrict__ budget, float* __restrict__ out,
               float* __restrict__ wdp, float* __restrict__ wmp, int m, int n,
               int rk, int k, int it, int stats, float eps,
               float zero_threshold) {
  const int c0 = blockIdx.x * TILE, i0 = blockIdx.y * TILE;
  float acc[4][4];
  w_numer_tile(a, hp, m, n, rk, i0, c0, acc);
  w_tile_epilogue(acc, wp, gh, frozen, budget, out, nullptr, wdp, wmp,
                  blockIdx.y, m, rk, k, i0, c0, it, stats, eps,
                  zero_threshold);
}

// One pass of the join-the-updates schedule on SPLIT_ROWS-row chunk s =
// blockIdx.y and lane columns c0 .. c0+63 (c0 = blockIdx.x * TILE):
// with do_w, the W half of iteration `it` on the chunk's rows, computed
// and written exactly as w_block_update does, and kept in shared memory
// (without do_w, the chunk's rows of wp are kept instead); then, with
// do_h, the chunk's H-numerator partial part[s, c, :] = sum over the
// chunk's rows of W[row, c] * A[row, :], summed exactly as
// h_numer_partial sums it.
__global__ void __launch_bounds__(THREADS)
wh_pass(const float* __restrict__ a, const float* __restrict__ wp,
        const float* __restrict__ hp, const float* __restrict__ gh,
        const float* __restrict__ frozen, const float* __restrict__ budget,
        float* __restrict__ out, float* __restrict__ wdp,
        float* __restrict__ wmp, float* __restrict__ part, int m, int n,
        int rk, int k, int it, int do_w, int do_h, int stats, float eps,
        float zero_threshold) {
  extern __shared__ float strip[];  // [SPLIT_ROWS][TILE]: the chunk's W
  __shared__ float wst[BK][TILE];
  __shared__ float ast[BK][TILE];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int c0 = blockIdx.x * TILE, s = blockIdx.y;
  const int mb = s * SPLIT_ROWS, me = min(m, mb + SPLIT_ROWS);
  if (do_w) {
    for (int i0 = mb; i0 < me; i0 += TILE) {
      float acc[4][4];
      w_numer_tile(a, hp, m, n, rk, i0, c0, acc);
      w_tile_epilogue(acc, wp, gh, frozen, budget, out,
                      strip + (size_t)(i0 - mb) * TILE, wdp, wmp, i0 / TILE,
                      m, rk, k, i0, c0, it, stats, eps, zero_threshold);
    }
  } else {
    for (int e = threadIdx.x; e < (me - mb) * TILE; e += THREADS) {
      const int row = mb + e / TILE, c = c0 + e % TILE;
      strip[e] = c < rk ? wp[(size_t)row * rk + c] : 0.f;
    }
  }
  if (!do_h) return;  // the same for every thread of the block
  __syncthreads();
  for (int j0 = 0; j0 < n; j0 += TILE) {
    float acc[4][4] = {};
    for (int m0 = mb; m0 < me; m0 += BK) {
      for (int e = threadIdx.x; e < BK * TILE; e += THREADS) {
        const int kk = e / TILE, c = e % TILE, row = m0 + kk;
        const bool in = row < me;
        wst[kk][c] = (in && c0 + c < rk) ? strip[(row - mb) * TILE + c] : 0.f;
        ast[kk][c] = (in && j0 + c < n) ? a[(size_t)row * n + j0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float wv[4], av[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          wv[u] = wst[kk][ty + 16 * u];
          av[u] = ast[kk][tx + 16 * u];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            acc[u][v] = fmaf(wv[u], av[v], acc[u][v]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = c0 + ty + 16 * u;
      if (i >= rk) continue;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int j = j0 + tx + 16 * v;
        if (j < n) part[((size_t)s * rk + i) * n + j] = acc[u][v];
      }
    }
  }
}

struct Launch {
  const float *a, *frozen, *budget;
  float *wd, *wm, *hd, *hm, *h_checks, *part, *gpart, *gh, *wdp, *wmp;
  int m, n, rk, k, iters, check_block, splits, mtiles;
  float eps, zero_threshold;
  cudaStream_t st;
  size_t gram_smem, ep_smem, hg_smem;
  dim3 gram_grid, hg_grid;
  int red_blocks;

  // the H half of iteration `it` from the numerator partials in `part`:
  // the W-Gram partials of w, the epilogue into h_next (stats and
  // snapshot at a boundary), then the diagonal H-Gram of h_next
  void h_half(const float* w, const float* h, float* h_next, int it) const {
    const bool boundary = (it + 1) % iters == 0;
    const int brow = boundary ? (it + 1) / iters - 1 : -1;
    h_gram_partial<<<gram_grid, THREADS, gram_smem, st>>>(w, gpart, m, rk, k,
                                                          SPLIT_ROWS);
    h_block_epilogue<<<rk, ROW_THREADS, ep_smem, st>>>(
        h, part, gpart, frozen, budget, h_next, hd, hm,
        check_block > 1 ? h_checks : nullptr, n, rk, k, splits, it, brow, eps,
        zero_threshold);
    h_gram_diag<<<hg_grid, THREADS, hg_smem, st>>>(h_next, gh, n, k);
  }

  // the W stats of boundary row `brow` from the per-tile maxima
  void w_stats(int brow) const {
    w_stats_reduce<<<red_blocks, ROW_THREADS, 0, st>>>(
        wdp, wmp, wd + (size_t)brow * rk, wm + (size_t)brow * rk, rk, mtiles);
  }
};

int block_iterations(const float* a, const float* wp_in, const float* hp_in,
                     const float* frozen, const float* budget, float* wp_out,
                     float* hp_out, float* wd, float* wm, float* hd,
                     float* hm, float* h_checks, float* wp_tmp,
                     float* hp_tmp, float* part, float* gpart, float* gh,
                     float* wdp, float* wmp, int m, int n, int rk, int k,
                     int iters, int check_block, float eps,
                     float zero_threshold, void* stream, bool fused) {
  Launch L;
  L.a = a;
  L.frozen = frozen;
  L.budget = budget;
  L.wd = wd;
  L.wm = wm;
  L.hd = hd;
  L.hm = hm;
  L.h_checks = h_checks;
  L.part = part;
  L.gpart = gpart;
  L.gh = gh;
  L.wdp = wdp;
  L.wmp = wmp;
  L.m = m;
  L.n = n;
  L.rk = rk;
  L.k = k;
  L.iters = iters;
  L.check_block = check_block;
  L.splits = (m + SPLIT_ROWS - 1) / SPLIT_ROWS;
  L.mtiles = (m + TILE - 1) / TILE;
  L.eps = eps;
  L.zero_threshold = zero_threshold;
  L.st = static_cast<cudaStream_t>(stream);
  L.gram_smem = sizeof(float) * GRAM_ROWS * k;
  L.ep_smem = sizeof(float) * (k + 2 * ROW_THREADS);
  L.hg_smem = sizeof(float) * k * (GRAM_COLS + 1);
  const int lanes = rk / k;
  L.gram_grid = dim3(lanes, L.splits, (k * k + THREADS - 1) / THREADS);
  L.hg_grid = dim3(lanes, (k * k + THREADS - 1) / THREADS);
  L.red_blocks = (rk + ROW_THREADS - 1) / ROW_THREADS;
  const size_t strip_smem = sizeof(float) * SPLIT_ROWS * TILE;
  cudaError_t err;
  if ((err = set_smem((const void*)h_gram_partial, L.gram_smem)) !=
      cudaSuccess)
    return err;
  if ((err = set_smem((const void*)h_block_epilogue, L.ep_smem)) !=
      cudaSuccess)
    return err;
  if ((err = set_smem((const void*)h_gram_diag, L.hg_smem)) != cudaSuccess)
    return err;
  if (fused &&
      (err = set_smem((const void*)wh_pass, strip_smem)) != cudaSuccess)
    return err;
  const cudaStream_t st = L.st;
  const int total = iters * check_block;
  // iteration it writes the outputs when (total - 1 - it) is even, the
  // scratch buffers otherwise, so the last iteration lands in the output
  auto w_dest = [&](int it) {
    return (total - 1 - it) % 2 == 0 ? wp_out : wp_tmp;
  };
  auto h_dest = [&](int it) {
    return (total - 1 - it) % 2 == 0 ? hp_out : hp_tmp;
  };
  const float* w_cur = wp_in;
  const float* h_cur = hp_in;
  if (!fused) {
    const dim3 numer_grid((n + TILE - 1) / TILE, (rk + TILE - 1) / TILE,
                          L.splits);
    const dim3 w_grid((rk + TILE - 1) / TILE, L.mtiles);
    for (int it = 0; it < total; ++it) {
      float* w_next = w_dest(it);
      float* h_next = h_dest(it);
      const bool boundary = (it + 1) % iters == 0;
      h_numer_partial<<<numer_grid, THREADS, 0, st>>>(a, w_cur, part, m, n,
                                                      rk, SPLIT_ROWS);
      L.h_half(w_cur, h_cur, h_next, it);
      w_block_update<<<w_grid, THREADS, 0, st>>>(
          a, w_cur, h_next, gh, frozen, budget, w_next, wdp, wmp, m, n, rk,
          k, it, boundary ? 1 : 0, eps, zero_threshold);
      if (boundary) L.w_stats((it + 1) / iters - 1);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      w_cur = w_next;
      h_cur = h_next;
    }
    return cudaSuccess;
  }
  const dim3 pass_grid((rk + TILE - 1) / TILE, L.splits);
  for (int p = 0; p <= total; ++p) {
    const bool do_w = p > 0, do_h = p < total;
    const bool w_boundary = do_w && p % iters == 0;
    float* w_next = do_w ? w_dest(p - 1) : nullptr;
    wh_pass<<<pass_grid, THREADS, strip_smem, st>>>(
        a, w_cur, h_cur, gh, frozen, budget, w_next, wdp, wmp, part, m, n,
        rk, k, p - 1, do_w ? 1 : 0, do_h ? 1 : 0, w_boundary ? 1 : 0, eps,
        zero_threshold);
    if (w_boundary) L.w_stats(p / iters - 1);
    if (do_w) w_cur = w_next;
    if (do_h) {
      float* h_next = h_dest(p);
      L.h_half(w_cur, h_cur, h_next, p);
      h_cur = h_next;
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
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
  return block_iterations(a, wp_in, hp_in, frozen, budget, wp_out, hp_out,
                          wd, wm, hd, hm, h_checks, wp_tmp, hp_tmp, part,
                          gpart, gh, wdp, wmp, m, n, rk, k, iters,
                          check_block, eps, zero_threshold, stream, false);
}

// The same iterations in the join-the-updates order (T + 1 passes); the
// same arguments and workspace, and all outputs byte-equal to
// nmfx_block_iterations'.
int nmfx_block_iterations_fused(
    const float* a, const float* wp_in, const float* hp_in,
    const float* frozen, const float* budget, float* wp_out, float* hp_out,
    float* wd, float* wm, float* hd, float* hm, float* h_checks,
    float* wp_tmp, float* hp_tmp, float* part, float* gpart, float* gh,
    float* wdp, float* wmp, int m, int n, int rk, int k, int iters,
    int check_block, float eps, float zero_threshold, void* stream) {
  return block_iterations(a, wp_in, hp_in, frozen, budget, wp_out, hp_out,
                          wd, wm, hd, hm, h_checks, wp_tmp, hp_tmp, part,
                          gpart, gh, wdp, wmp, m, n, rk, k, iters,
                          check_block, eps, zero_threshold, stream, true);
}

}  // extern "C"
