// block_topw: IVF candidate stage for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas kernel quiver_tpu/ops/ivf_pallas.py::fused_block_topw
// (body _kernel) and the XLA ragged_dot + windowed top-2 chain of
// quiver_tpu/ops/ivf_kernels.py::_pairs_candidates (and that function's
// per-pair top-R branch). For every (query, probe) pair, grouped by cluster,
// it scores the pair's query against the cluster's bf16 residual block with
// f32 sums, applies the epilogue
//   s = (scale * dot + row_add[pair]) * col_mul[c, j] + col_add[c, j],
// packs (score | column) into a monotone int32 key and keeps the top R keys
// of every W-column window, written straight to the pair's original row.
// W = 0 selects one window spanning the whole row (the per-pair top-R).
//
// What bounds it on an H100: at the serving shape (B=65536, n_probe=2,
// K~1400, Cmax=1280, d=128) the stage is 43 GFLOP of products against
// ~0.46 GB of blocks, plus one re-read of a cluster's block per tile of
// pairs that probe it (~1.1 GB in all, mostly from L2). Against the data
// sheet's peaks (H100 SXM at 700 W: 989 TFLOP/s bf16 tensor, 3.35 TB/s)
// the block bytes bound it, at ~0.1-0.3 ms. This first version computes
// the products on the CUDA cores in f32 (bf16 operands are exact in f32),
// so the f32 FMA rate bounds it instead (67 TFLOP/s peak: 0.64 ms). It
// measured 2.45 ms at n_probe=2 and 3.41 ms at n_probe=3 (B=65536) on an
// NVIDIA H100 80GB HBM3 at a 700 W power limit: ~26% of that f32 peak.
//
// Design, simple first: one block of 256 threads per (cluster, tile of
// TQ=64 sorted pairs); a grid of ceil(BP/TQ) + K blocks is an upper bound
// on the tile count (surplus blocks exit), so the host never syncs. Each
// block loads its own pair indices (there is no scalar prefetch), gathers
// its query tile into shared memory (f32, centroid subtracted, rounded to
// bf16), then walks the cluster block in 128-column slabs: a slab of
// d x 128 bf16 is 32 KB where the whole block (320 KB at the serving
// shape) would not fit the 227 KB of shared memory, and windows of W <= 128
// columns align with the slabs. Each thread accumulates a 4 x 8 register
// tile; the epilogue writes packed keys over the consumed slab in shared
// memory, and each warp then reduces whole windows (W/32 keys per lane, R
// passes of a warp max, the winner replaced by the sentinel). In row mode
// (W = 0) a warp merges each slab into the row's running top-R (R <= 32,
// one per lane) instead. Every output row belongs to exactly one block: no
// atomics. wgmma, TMA and a ring of slabs are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;        // sorted pairs per tile
constexpr int SLAB = 128;     // block columns per slab
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 8 outputs each
constexpr int RM = 4;         // tile rows per thread
constexpr int CN = 8;         // slab columns per thread
constexpr int QS = TQ + 4;    // query tile row stride (floats), 16 B aligned
constexpr int ROW_RMAX = 32;  // row mode: winners kept, one per lane

__device__ __forceinline__ int to_key(float s) {
  const int b = __float_as_int(s);
  return b ^ ((b >> 31) & 0x7FFFFFFF);
}

// W > 0: top R per W-column window. W == 0: top r_keep (<= 32) of the row.
template <int W, int R>
__global__ void __launch_bounds__(THREADS, 2) block_topw_kernel(
    const float* __restrict__ q, const float* __restrict__ cents,
    const int* __restrict__ starts, const int* __restrict__ tile_start,
    const int* __restrict__ order, const __nv_bfloat16* __restrict__ blocks,
    const float* __restrict__ row_add, const float* __restrict__ col_mul,
    const float* __restrict__ col_add, int* __restrict__ out, int K, int d,
    int Cmax, int P, float scale, int sub_cent, int pos_bits, int sentinel,
    int r_keep) {
  static_assert(W == 0 || (W % 32 == 0 && W <= SLAB && SLAB % (W ? W : 1) == 0),
                "window");
  constexpr int EPL = W > 0 ? W / 32 : SLAB / 32;  // keys per lane
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_orig[TQ];
  __shared__ int s_run[W > 0 ? 1 : TQ * ROW_RMAX];  // row mode: running top-R
  float* qs = reinterpret_cast<float*>(smem);  // [d][QS] query tile^T
  unsigned char* slab_raw = smem + (size_t)d * QS * sizeof(float);
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(slab_raw);  // [d][SLAB]
  int* keys = reinterpret_cast<int*>(slab_raw);  // [TQ][SLAB], aliases bs

  const int t = blockIdx.x;
  if (t >= tile_start[K]) return;  // surplus block of the upper-bound grid
  // cluster c with tile_start[c] <= t < tile_start[c + 1]
  int lo = 0, hi = K;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tile_start[mid] <= t) lo = mid; else hi = mid;
  }
  const int c = lo;
  const int row0 = starts[c] + (t - tile_start[c]) * TQ;
  const int n_rows = min(TQ, starts[c + 1] - row0);
  const int tid = threadIdx.x;

  if (tid < TQ) s_orig[tid] = tid < n_rows ? order[row0 + tid] : -1;
  if constexpr (W == 0) {
    for (int e = tid; e < TQ * ROW_RMAX; e += THREADS) s_run[e] = sentinel;
  }
  __syncthreads();

  // query tile: row r is query order[row0 + r] / P, minus the centroid
  // (f32) for L2, rounded to bf16 as the reference rounds it
  const float* cent = cents + (size_t)c * d;
  for (int e = tid; e < TQ * d; e += THREADS) {
    const int r = e / d, kk = e - r * d;
    const int o = s_orig[r];
    float v = 0.f;
    if (o >= 0) {
      v = q[(size_t)(o / P) * d + kk];
      if (sub_cent) v = __fsub_rn(v, cent[kk]);
      v = __bfloat162float(__float2bfloat16_rn(v));
    }
    qs[kk * QS + r] = v;
  }

  const int tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int pm = (1 << pos_bits) - 1;
  const int out_w = W > 0 ? (Cmax / W) * R : r_keep;
  const __nv_bfloat16* blk = blocks + (size_t)c * d * Cmax;
  const float* cadd = col_add + (size_t)c * Cmax;
  const float* cmul = col_mul ? col_mul + (size_t)c * Cmax : nullptr;

  for (int col0 = 0; col0 < Cmax; col0 += SLAB) {
    const int ncols = min(SLAB, Cmax - col0);
    __syncthreads();  // previous slab's keys consumed; query tile written
    for (int e = tid; e < d * (SLAB / 8); e += THREADS) {
      const int kk = e / (SLAB / 8), j8 = (e - kk * (SLAB / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (j8 < ncols)
        v = *reinterpret_cast<const uint4*>(blk + (size_t)kk * Cmax + col0 + j8);
      *reinterpret_cast<uint4*>(bs + kk * SLAB + j8) = v;
    }
    __syncthreads();

    float acc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;
    for (int kk = 0; kk < d; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(qs + kk * QS + ty * RM);
      const uint4 b4 = *reinterpret_cast<const uint4*>(bs + kk * SLAB + tx * CN);
      const float a[RM] = {a4.x, a4.y, a4.z, a4.w};
      const unsigned bw[4] = {b4.x, b4.y, b4.z, b4.w};
      float b[CN];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        b[2 * h] = __uint_as_float(bw[h] << 16);
        b[2 * h + 1] = __uint_as_float(bw[h] & 0xFFFF0000u);
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // slab reads done: keys overwrite it

    // epilogue: packed keys; rounding per operation (no contraction) so it
    // matches the plain version's separate multiply and add
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty * RM + i;
      const int o = s_orig[r];
      const float radd = (row_add != nullptr && o >= 0) ? row_add[o] : 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int jc = tx * CN + j;
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
      // windowed top-R: one warp per (row, window)
      const int wps = ncols / W;
      for (int task = warp; task < n_rows * wps; task += THREADS / 32) {
        const int r = task / wps, w = task - r * wps;
        int v[EPL];
#pragma unroll
        for (int e = 0; e < EPL; ++e) v[e] = keys[r * SLAB + w * W + e * 32 + lane];
        int* dst = out + (size_t)s_orig[r] * out_w + (col0 / W + w) * R;
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          int m = v[0];
#pragma unroll
          for (int e = 1; e < EPL; ++e) m = max(m, v[e]);
          m = __reduce_max_sync(0xFFFFFFFFu, m);
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            if (v[e] == m) v[e] = sentinel;
          if (lane == 0) dst[rr] = m;
        }
      }
    } else {
      // row mode: merge the slab into the running top-r_keep, one warp per
      // row; the winner of pass rr lands in lane rr
      for (int r = warp; r < n_rows; r += THREADS / 32) {
        int v[EPL + 1];
#pragma unroll
        for (int e = 0; e < EPL; ++e) v[e] = keys[r * SLAB + e * 32 + lane];
        v[EPL] = s_run[r * ROW_RMAX + lane];
        int mine = sentinel;
        for (int rr = 0; rr < r_keep; ++rr) {
          int m = v[0];
#pragma unroll
          for (int e = 1; e <= EPL; ++e) m = max(m, v[e]);
          m = __reduce_max_sync(0xFFFFFFFFu, m);
#pragma unroll
          for (int e = 0; e <= EPL; ++e)
            if (v[e] == m) v[e] = sentinel;
          if (lane == rr) mine = m;
        }
        s_run[r * ROW_RMAX + lane] = mine;
      }
    }
  }

  if constexpr (W == 0) {
    __syncwarp();
    for (int r = warp; r < n_rows; r += THREADS / 32)
      if (lane < r_keep) out[(size_t)s_orig[r] * out_w + lane] = s_run[r * ROW_RMAX + lane];
  }
}

template <int W, int R>
cudaError_t launch(const float* q, const float* cents, const int* starts,
                   const int* tile_start, const int* order,
                   const __nv_bfloat16* blocks, const float* row_add,
                   const float* col_mul, const float* col_add, int* out, int K,
                   int d, int Cmax, int P, int n_tiles_max, float scale,
                   int sub_cent, int pos_bits, int sentinel, int r_keep,
                   cudaStream_t stream) {
  const size_t slab_bytes = (size_t)d * SLAB * sizeof(__nv_bfloat16);
  const size_t key_bytes = (size_t)TQ * SLAB * sizeof(int);
  const size_t smem = (size_t)d * QS * sizeof(float) +
                      (slab_bytes > key_bytes ? slab_bytes : key_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      block_topw_kernel<W, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  block_topw_kernel<W, R><<<n_tiles_max, THREADS, smem, stream>>>(
      q, cents, starts, tile_start, order, blocks, row_add, col_mul, col_add,
      out, K, d, Cmax, P, scale, sub_cent, pos_bits, sentinel, r_keep);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int ivf_block_topw_tile_rows() { return TQ; }

int ivf_block_topw_row_max() { return ROW_RMAX; }

const char* ivf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns the cudaError_t of the launch (0 = queued). Pointers are device
// pointers on `device`; row_add and col_mul may be null. W = 0 is row mode
// (top R <= 32 of the whole row). BP (the pair count) is implied by the
// tile map and kept for the interface's self-description. The library
// links its own CUDA runtime, whose current device is set here rather than
// inherited from the caller's runtime.
int ivf_block_topw(const float* q, const float* cents, const int* starts,
                   const int* tile_start, const int* order, const void* blocks,
                   const float* row_add, const float* col_mul,
                   const float* col_add, int* out, int K, int d, int Cmax,
                   int P, int BP, int n_tiles_max, float scale, int sub_cent,
                   int W, int R, int pos_bits, int sentinel, int device,
                   void* stream) {
  (void)BP;
  if (n_tiles_max <= 0) return 0;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const auto* b = static_cast<const __nv_bfloat16*>(blocks);
  auto s = static_cast<cudaStream_t>(stream);
#define QV_CASE(WW, RR)                                                      \
  if (W == WW && R == RR)                                                    \
    return (int)launch<WW, RR>(q, cents, starts, tile_start, order, b,       \
                               row_add, col_mul, col_add, out, K, d, Cmax, P, \
                               n_tiles_max, scale, sub_cent, pos_bits,       \
                               sentinel, R, s);
  QV_CASE(32, 2)
  QV_CASE(64, 2)
  QV_CASE(128, 2)
  QV_CASE(128, 4)
#undef QV_CASE
  if (W == 0 && R >= 1 && R <= ROW_RMAX)
    return (int)launch<0, ROW_RMAX>(q, cents, starts, tile_start, order, b,
                                    row_add, col_mul, col_add, out, K, d,
                                    Cmax, P, n_tiles_max, scale, sub_cent,
                                    pos_bits, sentinel, R, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
