// block_topw over float32 blocks: the IVF candidate stage for Hopper
// (sm_90a), CUDA C++, on the CUDA cores.
//
// Replaces, for IVF engines built at compute_dtype=float32 (the database's
// default: quiver_tpu/core/db.py:39, index/hybrid.py:227-229):
//   * quiver_tpu/ops/ivf_kernels.py::_pairs_candidates' f32 ragged_dot
//     (ivf_kernels.py:633-636) with its windowed top-2 and the per-pair
//     constant re-keyed onto the winners, and that function's per-pair
//     top-R branch (ivf_kernels.py:716-759) as one window spanning the row;
//   * the Pallas kernel quiver_tpu/ops/ivf_pallas.py::fused_block_topw (body
//     _kernel, :145) fed f32 blocks, whose product is
//     jnp.dot(qtile.astype(bf16), blocks) (:93-96).
// The two formulations round differently: the pairs product takes the f32
// query as it is, the fused one rounds it to bf16 first; round_query picks.
// The keys are those of csrc/ivf_block_topw.cu (the bf16 kernel): the
// epilogue s = (scale * dot + row_add[pair]) * col_mul[c, j] + col_add[c, j],
// packed (score | column) int32 keys, the top R of every W-column window in
// lane r*S + w of the pair's original row (S = Cmax / W), re-keyed with
// win_add; W = 0 is row mode (the running top-R for R <= 32, every key of
// the row above that for the wrapper's top-R).
//
// What bounds it on an H100 (SXM, 700 W: 3.35 TB/s, 67 TFLOP/s f32 on the
// CUDA cores). At the serving shape (B=65536, n_probe=3, K=1405, Cmax=1280,
// d=128) the products are 64.4 GFLOP (0.96 ms at the f32 peak) against
// ~1.0 GB that must move (f32 blocks 0.92 GB, keys 63 MB, queries 34 MB:
// ~0.3 ms), so the operations bound it. Why not the tensor cores: TF32
// wgmma takes both operands K-major, and the blocks [K, d, Cmax] give B
// MN-major, which only 16-bit types may be; TF32 would also round what the
// reference computes in true f32, and the port keeps TF32 off. A 3xTF32
// split or a K-major f32 copy of the blocks is later work (ROADMAP.md).
//
// Design, simple first (the template is the port's first CUDA-core bf16
// kernel): one block of 256 threads per tile of TQ=64 sorted pairs of one
// cluster, on a sync-free map (the grid is an upper bound on the tile count;
// surplus blocks exit). The block walks the cluster block in 128-column
// slabs and each slab in 128-deep chunks of d: it gathers the chunk of its
// pairs' queries (minus the centroid for L2, rounded to bf16 when asked)
// into shared memory, transposed, and copies the chunk of the slab (128 x
// 128 f32, 64 KB) beside it; for d <= 128 the query chunk is gathered once
// per tile. Each thread accumulates a 4 x 8 register tile (columns in two
// runs of 4, 64 apart, so a warp's float4 reads of a slab row cover
// consecutive banks) with fmaf in d order. The epilogue writes packed keys
// over the consumed slab in shared memory; each warp then reduces whole
// windows (W/32 keys per lane, R passes of a warp max, each winner
// replaced by the sentinel) or, in row mode, merges the slab into each
// row's running top-R or copies it out whole. Every output row belongs to
// exactly one block: no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;        // sorted pairs per tile
constexpr int SLAB = 128;     // block columns per slab
constexpr int DK = 128;       // d per chunk
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 8 outputs each
constexpr int RM = 4;         // tile rows per thread
constexpr int CN = 8;         // slab columns per thread
constexpr int QS = TQ + 4;    // query chunk row stride (floats), 16-byte aligned
constexpr int ROW_RMAX = 32;  // row mode: running winners, one per lane
constexpr size_t SMEM = static_cast<size_t>(DK) * (QS + SLAB) * sizeof(float);

__device__ __forceinline__ int to_key(float s) {
  const int b = __float_as_int(s);
  return b ^ ((b >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ float from_key(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7FFFFFFF));
}

// the cluster of tile g (tile_start[c] <= g < tile_start[c + 1])
__device__ __forceinline__ int find_cluster(const int* tile_start, int K, int g) {
  int lo = 0, hi = K;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tile_start[mid] <= g) lo = mid; else hi = mid;
  }
  return lo;
}

// W > 0: top R per W-column window (W in {32, 64, 128}). W == 0: row mode,
// the running top r_keep (<= 32) of the row, or every key when r_keep > 32.
template <int W, int R>
__global__ void __launch_bounds__(THREADS, 2) block_topw_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ cents,
    const int* __restrict__ starts, const int* __restrict__ tile_start,
    const int* __restrict__ order, const float* __restrict__ blocks,
    const float* __restrict__ row_add, const float* __restrict__ col_mul,
    const float* __restrict__ col_add, const float* __restrict__ win_add,
    int* __restrict__ out, int K, int d, int Cmax, int P, float scale, int sub_cent,
    int round_query, int pos_bits, int sentinel, int r_keep) {
  static_assert(W == 0 || (W % 32 == 0 && SLAB % (W ? W : 1) == 0), "window");
  constexpr int EPL = W > 0 ? W / 32 : SLAB / 32;  // keys per lane
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_orig[TQ];
  __shared__ int s_run[W > 0 ? 1 : TQ * ROW_RMAX];  // row mode: running top-R
  float* qs = reinterpret_cast<float*>(smem);  // [DK][QS] query chunk, transposed
  float* bs = qs + DK * QS;                    // [DK][SLAB] chunk of the slab
  int* keys = reinterpret_cast<int*>(bs);      // [TQ][SLAB] keys, alias bs

  const int t = blockIdx.x;
  if (t >= tile_start[K]) return;  // the grid is an upper bound on the tiles
  const int c = find_cluster(tile_start, K, t);
  const int row0 = starts[c] + (t - tile_start[c]) * TQ;  // the tile's first sorted pair
  const int n_rows = min(TQ, starts[c + 1] - row0);
  const int tid = threadIdx.x;
  const bool whole = W == 0 && r_keep > ROW_RMAX;

  if (tid < TQ) s_orig[tid] = tid < n_rows ? order[row0 + tid] : -1;
  if constexpr (W == 0) {
    for (int e = tid; e < TQ * ROW_RMAX; e += THREADS) s_run[e] = sentinel;
  }
  __syncthreads();

  const int tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int pm = (1 << pos_bits) - 1;
  const int S = W > 0 ? Cmax / W : 1;
  const int out_w = W > 0 ? S * R : (whole ? Cmax : r_keep);
  const float* blk = blocks + static_cast<size_t>(c) * d * Cmax;
  const float* cent = cents + static_cast<size_t>(c) * d;
  const float* cadd = col_add + static_cast<size_t>(c) * Cmax;
  const float* cmul = col_mul != nullptr ? col_mul + static_cast<size_t>(c) * Cmax : nullptr;
  const int n_kc = (d + DK - 1) / DK;

  for (int col0 = 0; col0 < Cmax; col0 += SLAB) {
    const int ncols = min(SLAB, Cmax - col0);
    float acc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;

    for (int kc = 0; kc < n_kc; ++kc) {
      const int k0 = kc * DK, dk = min(DK, d - k0);
      __syncthreads();  // the previous chunk's reads (or the slab's keys) are done
      if (n_kc > 1 || col0 == 0) {
        // query chunk: row r is pair order[row0 + r]'s query, minus the
        // centroid (f32) for L2, rounded to bf16 when the formulation does
        for (int e = tid; e < TQ * dk; e += THREADS) {
          const int r = e / dk, kk = e - r * dk;
          const int o = s_orig[r];
          float v = 0.f;
          if (o >= 0) {
            v = q[static_cast<size_t>(o / P) * d + k0 + kk];
            if (sub_cent) v = __fsub_rn(v, cent[k0 + kk]);
            if (round_query) v = __bfloat162float(__float2bfloat16_rn(v));
          }
          qs[kk * QS + r] = v;
        }
      }
      // the chunk of the slab, zero past Cmax (Cmax % 4 == 0: whole float4s)
      for (int e = tid; e < dk * (SLAB / 4); e += THREADS) {
        const int kk = e / (SLAB / 4), j4 = (e - kk * (SLAB / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j4 < ncols)
          v = *reinterpret_cast<const float4*>(blk + static_cast<size_t>(k0 + kk) * Cmax + col0 + j4);
        *reinterpret_cast<float4*>(bs + kk * SLAB + j4) = v;
      }
      __syncthreads();
      for (int kk = 0; kk < dk; ++kk) {
        const float4 a4 = *reinterpret_cast<const float4*>(qs + kk * QS + ty * RM);
        const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * SLAB + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * SLAB + 64 + tx * 4);
        const float a[RM] = {a4.x, a4.y, a4.z, a4.w};
        const float b[CN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();  // slab reads done: the keys overwrite it

    // epilogue: packed keys; rounding per operation (no contraction), as
    // the plain version's separate multiply and add
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty * RM + i;
      const int o = s_orig[r];
      const float radd = (row_add != nullptr && o >= 0) ? row_add[o] : 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int jc = (j / 4) * 64 + tx * 4 + (j % 4);
        const int col = col0 + jc;
        int key = sentinel;
        if (jc < ncols) {
          float s = __fmul_rn(scale, acc[i][j]);
          if (row_add != nullptr) s = __fadd_rn(s, radd);
          if (cmul != nullptr) s = __fmul_rn(s, cmul[col]);
          s = __fadd_rn(s, cadd[col]);
          key = (to_key(s) & ~pm) | (col & pm);
        }
        keys[r * SLAB + jc] = key;
      }
    }
    __syncthreads();

    if constexpr (W > 0) {
      // windowed top-R: one warp per (row, window); winner r of global
      // window w goes to lane r*S + w, re-keyed with win_add
      const int wps = ncols / W, w0 = col0 / W;
      for (int task = warp; task < n_rows * wps; task += THREADS / 32) {
        const int r = task / wps, w = task - r * wps;
        int v[EPL];
#pragma unroll
        for (int e = 0; e < EPL; ++e) v[e] = keys[r * SLAB + w * W + e * 32 + lane];
        const int o = s_orig[r];
        const float wadd = win_add != nullptr ? win_add[o] : 0.f;
        int* dst = out + static_cast<size_t>(o) * out_w + w0 + w;
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          int m = v[0];
#pragma unroll
          for (int e = 1; e < EPL; ++e) m = max(m, v[e]);
          m = __reduce_max_sync(0xFFFFFFFFu, m);
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            if (v[e] == m) v[e] = sentinel;
          if (lane == 0) {
            if (win_add != nullptr)
              m = (to_key(__fadd_rn(from_key(m & ~pm), wadd)) & ~pm) | (m & pm);
            dst[rr * S] = m;
          }
        }
      }
    } else if (whole) {
      // row mode above ROW_RMAX: every key of the row, for the wrapper's top-R
      for (int r = warp; r < n_rows; r += THREADS / 32) {
#pragma unroll
        for (int e = 0; e < SLAB / 32; ++e) {
          const int jc = e * 32 + lane;
          if (jc < ncols) out[static_cast<size_t>(s_orig[r]) * Cmax + col0 + jc] = keys[r * SLAB + jc];
        }
      }
    } else {
      // row mode: merge the slab into the running top r_keep, one warp per
      // row; the winner of pass p lands in lane p
      for (int r = warp; r < n_rows; r += THREADS / 32) {
        int v[EPL + 1];
#pragma unroll
        for (int e = 0; e < EPL; ++e) v[e] = keys[r * SLAB + e * 32 + lane];
        v[EPL] = s_run[r * ROW_RMAX + lane];
        int mine = sentinel;
        for (int p = 0; p < r_keep; ++p) {
          int m = v[0];
#pragma unroll
          for (int e = 1; e <= EPL; ++e) m = max(m, v[e]);
          m = __reduce_max_sync(0xFFFFFFFFu, m);
#pragma unroll
          for (int e = 0; e <= EPL; ++e)
            if (v[e] == m) v[e] = sentinel;
          if (lane == p) mine = m;
        }
        s_run[r * ROW_RMAX + lane] = mine;
      }
    }
  }

  if constexpr (W == 0) {
    if (!whole) {
      __syncwarp();
      for (int r = warp; r < n_rows; r += THREADS / 32)
        if (lane < r_keep) out[static_cast<size_t>(s_orig[r]) * r_keep + lane] = s_run[r * ROW_RMAX + lane];
    }
  }
}

template <int W, int R>
cudaError_t launch(const float* q, const float* cents, const int* starts, const int* tile_start,
                   const int* order, const float* blocks, const float* row_add,
                   const float* col_mul, const float* col_add, const float* win_add, int* out,
                   int K, int d, int Cmax, int P, int n_tiles, float scale, int sub_cent,
                   int round_query, int pos_bits, int sentinel, int r_keep,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      block_topw_f32_kernel<W, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  block_topw_f32_kernel<W, R><<<n_tiles, THREADS, SMEM, stream>>>(
      q, cents, starts, tile_start, order, blocks, row_add, col_mul, col_add, win_add, out, K,
      d, Cmax, P, scale, sub_cent, round_query, pos_bits, sentinel, r_keep);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int ivf_block_topw_f32_tile_rows() { return TQ; }

int ivf_block_topw_f32_row_max() { return ROW_RMAX; }

// Returns the cudaError_t of the launch (0 = queued). Pointers are device
// pointers on `device`; row_add, col_mul and win_add may be null. blocks is
// f32[K, d, Cmax] with Cmax % 4 == 0 and 16-byte aligned rows. tile_start[K+1]
// counts each cluster's tiles of TQ sorted pairs; n_tiles, the grid, is an
// upper bound on their count. W = 0 is row mode: the top R <= 32 of the
// whole row, or every key of the row ([BP, Cmax]) when R > 32. The library
// links its own CUDA runtime, whose current device is set here rather than
// inherited from the caller's.
int ivf_block_topw_f32(const float* q, const float* cents, const int* starts,
                       const int* tile_start, const int* order, const float* blocks,
                       const float* row_add, const float* col_mul, const float* col_add,
                       const float* win_add, int* out, int K, int d, int Cmax, int P, int BP,
                       int n_tiles, float scale, int sub_cent, int round_query, int W, int R,
                       int pos_bits, int sentinel, int device, void* stream) {
  if (BP <= 0 || n_tiles <= 0) return 0;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  auto s = static_cast<cudaStream_t>(stream);
#define QV_CASE(WW, RR)                                                                        \
  if (W == WW && R == RR)                                                                      \
    return (int)launch<WW, RR>(q, cents, starts, tile_start, order, blocks, row_add, col_mul, \
                               col_add, win_add, out, K, d, Cmax, P, n_tiles, scale, sub_cent, \
                               round_query, pos_bits, sentinel, R, s);
  QV_CASE(32, 2)
  QV_CASE(64, 2)
  QV_CASE(128, 2)
  QV_CASE(128, 4)
#undef QV_CASE
  if (W == 0 && R >= 1 && R <= Cmax)
    return (int)launch<0, ROW_RMAX>(q, cents, starts, tile_start, order, blocks, row_add,
                                    col_mul, col_add, win_add, out, K, d, Cmax, P, n_tiles,
                                    scale, sub_cent, round_query, pos_bits, sentinel, R, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
