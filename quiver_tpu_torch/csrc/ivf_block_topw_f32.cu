// block_topw over float32 blocks: the IVF candidate stage for Hopper
// (sm_90a), CUDA C++, on the tensor cores in 3xTF32.
//
// Replaces, for IVF engines built at compute_dtype=float32 (the database's
// default: quiver_tpu/core/db.py:39, index/hybrid.py:227-229):
//   * quiver_tpu/ops/ivf_kernels.py::_pairs_candidates' f32 ragged_dot
//     (ivf_kernels.py:633-636) with its windowed top-2 (:660-693) and the
//     per-pair constant re-keyed onto the winners, and that function's
//     per-pair top-R branch (:716-759) as one window spanning the row;
//   * the Pallas kernel quiver_tpu/ops/ivf_pallas.py::fused_block_topw
//     (:145; body _kernel :55, pallas_call :189) fed f32 blocks, whose
//     product is jnp.dot(qtile.astype(bf16), blocks) (:93-96).
// The two formulations round differently: the pairs product takes the f32
// query as it is, the fused one rounds it to bf16 first; round_query picks.
// The keys are those of csrc/ivf_block_topw.cu (the bf16 kernel): the
// epilogue s = (scale * dot + row_add[pair]) * col_mul[c, j] + col_add[c, j],
// packed (score | column) int32 keys, the top R of every W-column window in
// lane r*S + w of the pair's original row (S = Cmax / W), re-keyed with
// win_add; W = 0 is row mode: the running top R <= 128 kept in the kernel
// (csrc/row_topr.cuh, shared with the bf16 kernel), or, for R > 128 (still
// to do), every key of the row for the wrapper's top-R.
//
// Products in 3xTF32. TF32 keeps 10 of f32's 23 mantissa bits, so one TF32
// product strays ~2^-11 relative from the reference's true f32, thousands
// of the units compare_keys allows (chip_smoke.py: 16 x 2^-24 x |a| |b|).
// Each operand x splits into hi = tf32_rna(x) and lo = tf32_rna(x - hi)
// (x - hi is exact), and a*b is taken as lo_a*hi_b + hi_a*lo_b + hi_a*hi_b,
// the small terms first: what is dropped (lo_a*lo_b and the lo parts' own
// rounding) is ~2^-22 relative. The bf16-rounded query (round_query) is
// exact in TF32: lo_a = 0, two products. The tensor cores truncate as they
// add into an accumulator, so summing all of d's products in one (3 x d/8
// mma.sync) let that bias build up to 14.7 units at d=768 (NVIDIA H100
// 80GB HBM3, 700 W; chip_smoke.py phase 3);
// each 32-deep chunk's products are summed from zero in the tensor cores
// and the chunk's sum added to the running sums in f32, with rounding to
// nearest. tests/test_torch_ivf_kernel.py emulates the split and this
// order in numpy against f64.
//
// What bounds it on an H100 (SXM, 700 W: 3.35 TB/s, 495 TFLOP/s TF32
// dense). At the serving shape (B=65536, n_probe=3, K=1405, Cmax=1280,
// d=128) the products are 64.4 GFLOP, three TF32 products each: 0.39 ms,
// against ~1.0 GB that must move (f32 blocks 0.92 GB, keys 63 MB, queries
// 34 MB): 0.30 ms. So the operations bound it.
//
// Why mma.sync and not wgmma. TF32 wgmma takes both operands K-major, and
// the blocks [K, d, Cmax] give B MN-major, which only 16-bit types may be:
// it would need the slab transposed in shared memory, or a K-major f32 copy
// of the blocks (+0.92 GB at 1M, and a second layout that the write path,
// refresh, maintenance and the topology sidecar would all have to keep).
// The warp-level mma.sync.m16n8k8 takes its B fragment as two registers per
// thread, each loaded from any shared address, so the MN-major slab is read
// as the TMA ring lands it.
//
// Design. A prologue kernel gathers each sorted pair's query (minus the
// centroid for L2, rounded to bf16 when round_query, zero past d) into an
// f32 [M, d_pad] scratch in sorted order (d_pad: d rounded up to 32), so
// both operands arrive by TMA. The query is split in registers: 4 values
// per thread per k8 step, shared by 16 n8 tiles, where pre-split planes
// would double the scratch and the query's shared-memory reads. The main
// kernel gives each block one tile of 64 pairs of one cluster (a sync-free
// map: the grid is an upper bound on the tiles and surplus blocks exit):
// four consumer warps and one producer thread that keeps a ring of STAGES
// stages full with TMA loads completing on mbarriers. A stage is a 32-deep
// chunk of d: the 128-column slab as four 32 x 32 f32 boxes (a 128-byte
// row each) and, when d > 128, the tile's query chunk (64 x 32); for
// d <= 128 the query tile loads once and stays resident. The slab's last
// stage also brings its col_add and col_mul rows. The 128-byte swizzle
// makes every fragment read below free of bank conflicts, and the tensor
// maps' out-of-bounds fill zeroes the rows past d, so shared memory does
// not grow with d. Warp w owns rows 16w..16w+15 of the tile across the
// whole slab: 16 n8 tiles, 64 f32 accumulators a thread. Column n of n8
// tile t is slab column 16n + t, so thread (g = lane/4, q = lane%4) reads
// the B values of four tiles with one float4 per fragment row, and holds
// slab columns [32q, 32q + 32) of its rows g and g + 8: a 32-column window
// lies in one thread, a 64-column one in two, a 128-column one in the quad.
// Each warp splits the B values it reads itself (the four warps read the
// same slab). The epilogue runs on the accumulators in registers: each
// thread keeps the top R of its share of each window, xor shuffles merge
// the threads of a window, and they store the winners straight to the
// pair's row. Row mode stages each slab's keys in shared memory per warp
// (a warp's 16 rows are its own), releases the ring stage, and merges them
// into each row's running top-R in shared memory behind a threshold filter
// (csrc/row_topr.cuh); for R > 128 it copies them out whole. The merge is
// bound by the latency of its shuffle chains, so blocks per SM set its
// pace. On a 2-stage ring the lists leave room for two blocks per SM at
// R <= 32 with the resident query tile (32 KB at d <= 128), and at R <= 64
// and R <= 112 with the query chunk brought by each stage instead; R <= 128
// (a 32 KB list) runs one block per SM. Every output row belongs to exactly
// one block: no atomics.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"
#include "row_topr.cuh"
#include "device_guard.cuh"

namespace {

constexpr int TQ = 64;                  // sorted pairs per tile (block)
constexpr int SLAB = 128;               // block columns per slab
constexpr int DK = 32;                  // d per ring stage: one 128-byte f32 row
// ring depth: 3 stages for the windowed variants; row mode's staged rows
// and lists (41-66 KB) leave room for 2
template <int W>
__host__ __device__ constexpr int stages() { return W > 0 ? 3 : 2; }
constexpr int MIN_BLOCKS = 2;           // blocks per SM, for the registers
constexpr int GATHER_ROWS = 8;          // prologue: sorted pairs per warp
constexpr int THREADS = 128 + 32;       // four consumer warps, then the producer warp
constexpr int BOX = 32 * DK * 4;        // 4 KB: 32 slab columns x 32 rows of d
constexpr int A_CHUNK = TQ * DK * 4;    // 8 KB: the tile's query chunk
// the query tile stays resident when d needs at most this many chunks
// (d <= 128); otherwise each stage brings its chunk too
constexpr int A_RES_KC = 4;
constexpr int STG = SLAB;               // row mode: staging row stride (ints)
// row mode's ints: the staged slab, the running lists of C entries, each
// row's original pair
constexpr int row_smem(int C) { return TQ * STG + TQ * C + TQ; }
// row mode's lists of C entries with the query tile resident: at C = 64 and
// 112 it streams with the slab instead, to keep two blocks per SM
constexpr bool row_resident(int C) { return C != 64 && C != 112; }

// Row mode stages column c of a row at this position of its staged row: a
// quarter-warp of the epilogue's int4 stores (rows g, g+1, the four
// threads' 32-column spans) lands in 32 distinct banks. An involution on
// [0, 128); the merge takes the keys in any order.
__device__ __forceinline__ int stg_pos(int row, int c) {
  return c ^ (((c >> 5) | ((row & 1) << 2)) << 2);
}
// the barriers' bytes (full and empty per stage, afull), so that row mode's
// staged rows after them start on 16 bytes for their int4 stores
constexpr int BARS = 64;
static_assert((2 * stages<32>() + 1) * 8 <= BARS, "barriers");

// One ring stage: the tile's query chunk (unless resident), the slab's four
// 32-column boxes, then the slab's col_add and col_mul rows.
template <bool AR>
struct Stage {
  static constexpr int B = AR ? 0 : A_CHUNK;
  static constexpr int AUX = B + 4 * BOX;
  static constexpr int BYTES = AUX + 2 * SLAB * 4;  // a multiple of 1024
};

// x rounded to TF32, to nearest with ties away from zero (cvt.rna.tf32.f32):
// the low 13 mantissa bits of the f32 pattern rounded off
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// x = hi + lo + O(2^-22 |x|), both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float h = tf32_rna(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32_rna(__fsub_rn(x, h)));
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void lds128(uint32_t addr, float (&v)[4]) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "r"(addr));
}

// d (+)= A[16 x 8] (row) * B[8 x 8] (col), TF32 in, f32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one row of the prologue: dst = q - c (or q alone), rounded to bf16 when
// asked, zero from d to d_pad
__device__ __forceinline__ float prep(float v, float c, int sub_cent, int round_query) {
  if (sub_cent) v = __fsub_rn(v, c);
  return round_query ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ void gather_row(const float* __restrict__ qr,
                                           const float* __restrict__ cr,
                                           float* __restrict__ dst, int d, int d_pad,
                                           int sub_cent, int round_query, bool vec, int lane) {
  if (vec) {  // 16-byte loads where the rows allow them
    for (int k4 = lane; k4 < d_pad / 4; k4 += 32) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (4 * k4 < d) {
        const float4 x = reinterpret_cast<const float4*>(qr)[k4];
        const float4 c = sub_cent ? reinterpret_cast<const float4*>(cr)[k4] : x;
        v = make_float4(prep(x.x, c.x, sub_cent, round_query), prep(x.y, c.y, sub_cent, round_query),
                        prep(x.z, c.z, sub_cent, round_query), prep(x.w, c.w, sub_cent, round_query));
      }
      reinterpret_cast<float4*>(dst)[k4] = v;
    }
    return;
  }
  for (int k = lane; k < d_pad; k += 32)
    dst[k] = k < d ? prep(qr[k], sub_cent ? cr[k] : 0.f, sub_cent, round_query) : 0.f;
}

// Prologue: qa[i, :] = q[order[i] / P] - cents[c_i] (no centroid for dot /
// cosine), rounded to bf16 when round_query, for sorted pair i of cluster
// c_i, zero from d to d_pad. A warp takes GATHER_ROWS consecutive pairs:
// one search of starts, then a walk.
__global__ void __launch_bounds__(256) gather_queries_f32(
    const float* __restrict__ q, const float* __restrict__ cents,
    const int* __restrict__ starts, const int* __restrict__ order, float* __restrict__ qa,
    int K, int d, int d_pad, int P, int M, int sub_cent, int round_query) {
  const int row0 = (blockIdx.x * 8 + (threadIdx.x >> 5)) * GATHER_ROWS;
  const int lane = threadIdx.x & 31;
  if (row0 >= M) return;
  const bool vec = (d & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(cents)) & 15) == 0;
  int lo = 0, hi = K;  // starts[lo] <= row0 < starts[lo + 1]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (starts[mid] <= row0) lo = mid; else hi = mid;
  }
  for (int row = row0; row < min(row0 + GATHER_ROWS, M); ++row) {
    while (starts[lo + 1] <= row) ++lo;
    gather_row(q + static_cast<size_t>(order[row] / P) * d, cents + static_cast<size_t>(lo) * d,
               qa + static_cast<size_t>(row) * d_pad, d, d_pad, sub_cent, round_query, vec, lane);
  }
}

// W > 0: top R per W-column window (W in {32, 64, 128}). W == 0: row mode,
// the running top r_keep of the row in lists of C = R entries (r_keep <= R
// <= ROW_RMAX), or every key of the row when r_keep > ROW_RMAX.
// AR: the query tile resident. SPLIT: the query is f32 (three products);
// otherwise bf16-rounded, exact in TF32 (two).
template <int W, int R, bool AR, bool SPLIT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) block_topw_f32_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
    const int* __restrict__ starts, const int* __restrict__ tile_start,
    const int* __restrict__ order, const float* __restrict__ row_add,
    const float* __restrict__ col_mul, const float* __restrict__ col_add,
    const float* __restrict__ win_add, int* __restrict__ out, int K, int n_kc, int Cmax,
    float scale, int pos_bits, int sentinel, int r_keep) {
  static_assert(W == 0 || (W % 32 == 0 && SLAB % (W ? W : 1) == 0), "window");
  const int tile = blockIdx.x;
  if (tile >= tile_start[K]) return;  // the grid is an upper bound on the tiles
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle pattern repeats every 8 rows
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  using St = Stage<AR>;
  constexpr int STAGES = stages<W>();
  // the ring, the resident query tile (AR), the barriers, row mode's rows
  unsigned char* ares = smem + STAGES * St::BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ares + (AR ? n_kc * A_CHUNK : 0));
  uint64_t* empty = full + STAGES;
  uint64_t* afull = empty + STAGES;  // AR: the tile's query chunks arrived

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // every consumer warp releases every stage
    }
    mbar_init(afull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int c = find_cluster(tile_start, K, tile);
  const int row0 = starts[c] + (tile - tile_start[c]) * TQ;  // the tile's first sorted pair

  if (tid >= 128) {
    // ---- producer: one thread keeps the ring full
    if (tid != 128) return;
    if constexpr (AR) {
      mbar_expect_tx(afull, n_kc * A_CHUNK);
      for (int kc = 0; kc < n_kc; ++kc) tma_2d(ares + kc * A_CHUNK, &map_a, afull, kc * DK, row0);
    }
    int stage = 0, phase = 0;
    for (int col0 = 0; col0 < Cmax; col0 += SLAB) {
      // boxes wholly past Cmax are not loaded: their columns are never kept
      const int nb = min(4, (Cmax - col0 + 31) / 32);
      for (int kc = 0; kc < n_kc; ++kc) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = smem + stage * St::BYTES;
        // the slab's last chunk also brings its col_add (and col_mul) row
        const int aux_bytes =
            kc + 1 < n_kc ? 0 : min(SLAB, Cmax - col0) * 4 * (col_mul != nullptr ? 2 : 1);
        mbar_expect_tx(&full[stage], nb * BOX + (AR ? 0 : A_CHUNK) + aux_bytes);
        if (aux_bytes) {
          const size_t off = static_cast<size_t>(c) * Cmax + col0;
          bulk_copy(st + St::AUX, col_add + off, min(SLAB, Cmax - col0) * 4, &full[stage]);
          if (col_mul != nullptr)
            bulk_copy(st + St::AUX + SLAB * 4, col_mul + off, min(SLAB, Cmax - col0) * 4,
                      &full[stage]);
        }
        for (int b = 0; b < nb; ++b)
          tma_3d(st + St::B + b * BOX, &map_b, &full[stage], col0 + 32 * b, kc * DK, c);
        if constexpr (!AR) tma_2d(st, &map_a, &full[stage], kc * DK, row0);
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // ---- the consumer warps
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, quad = lane & 3;
  const int rl = warp * 16 + g;  // this thread's rows: rl, rl + 8
  const int pm = (1 << pos_bits) - 1;
  // row mode: stg [TQ][STG] keys of the slab; run [TQ][R] running lists;
  // s_orig [TQ] original pair of each row
  int* stg = reinterpret_cast<int*>(full) + BARS / 4;
  int* run = stg + TQ * STG;
  int* s_orig = run + TQ * R;
  const bool whole = r_keep > ROW_RMAX;
  const int n_rows = min(TQ, starts[c + 1] - row0);
  int orow[2];
  float radd[2], wadd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rl + 8 * h;
    orow[h] = r < n_rows ? order[row0 + r] : -1;
    radd[h] = (row_add != nullptr && orow[h] >= 0) ? row_add[orow[h]] : 0.f;
    wadd[h] = (win_add != nullptr && orow[h] >= 0) ? win_add[orow[h]] : 0.f;
  }
  if constexpr (W == 0) {
    if (lane < 16) {
      const int r = warp * 16 + lane;
      s_orig[r] = r < n_rows ? order[row0 + r] : -1;
    }
    row_init<R>(run + warp * 16 * R, 16, sentinel, lane);
  }
  // Shared-memory offsets of this thread's fragments in a 32-deep chunk
  // (128-byte swizzle: 16-byte chunk j of row r sits at chunk j ^ (r % 8)).
  // A, a [64][32] box: rows rl and rl + 8 (both = g mod 8), columns
  // 8s + quad (+ 4). B, box g/2 of the slab: rows 8s + quad (+ 4), the
  // float4 of columns 16(g%2) + 4v.. that feeds n8 tiles 4v..4v+3.
  const uint32_t a_off = rl * 128 + quad * 4;
  uint32_t b_off[4];
#pragma unroll
  for (int v = 0; v < 4; ++v)
    b_off[v] = (g >> 1) * BOX + quad * 128 + ((((g & 1) * 4 + v) ^ quad) << 4);
  float acc[64];
  int stage = 0, phase = 0;

  if constexpr (AR) mbar_wait(afull, 0);
  for (int col0 = 0; col0 < Cmax; col0 += SLAB) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int last = 0;  // the slab's last stage: released after the epilogue
    for (int kc = 0; kc < n_kc; ++kc) {
      mbar_wait(&full[stage], phase);
      const uint32_t st = smem_u32(smem + stage * St::BYTES);
      const uint32_t a_s = (AR ? smem_u32(ares + kc * A_CHUNK) : st) + a_off;
      const uint32_t b_s = st + St::B;
      // the chunk's A fragments, step s: (rl, k), (rl+8, k), (rl, k+4),
      // (rl+8, k+4) at k = 8s + quad
      uint32_t ah[DK / 8][4], al[DK / 8][4];
#pragma unroll
      for (int s = 0; s < DK / 8; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t x =
              lds32(a_s + (i & 1) * 8 * 128 + (((2 * s + (i >> 1)) ^ g) << 4));
          if constexpr (SPLIT) split(__uint_as_float(x), ah[s][i], al[s][i]); else ah[s][i] = x;
        }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        // the tensor cores truncate as they add into an accumulator: n8
        // tiles 4v..4v+3 sum the chunk's products from zero, then add them
        // to the running sums in f32 with round-to-nearest
        float t[4][4] = {};
#pragma unroll
        for (int s = 0; s < DK / 8; ++s) {
          float x0[4], x1[4];  // rows 8s + quad and 8s + quad + 4 (chunk ^ 4)
          lds128(b_s + s * 1024 + b_off[v], x0);
          lds128(b_s + s * 1024 + 512 + (b_off[v] ^ 64), x1);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            uint32_t bh0, bl0, bh1, bl1;
            split(x0[e], bh0, bl0);
            split(x1[e], bh1, bl1);
            if constexpr (SPLIT) mma_tf32(t[e], al[s], bh0, bh1);
            mma_tf32(t[e], ah[s], bl0, bl1);
            mma_tf32(t[e], ah[s], bh0, bh1);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[4 * (4 * v + e) + i] = __fadd_rn(acc[4 * (4 * v + e) + i], t[e][i]);
      }
      if (kc + 1 < n_kc) release(&empty[stage], lane); else last = stage;
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }
    // the slab's col_add and col_mul, staged by the producer; this thread's
    // columns 32*quad + m, m < 32, sit in acc[4*(m%16) + m/16 + 2h] (row rl + 8h)
    const float* cadd =
        reinterpret_cast<const float*>(smem + last * St::BYTES + St::AUX) + 32 * quad;
    const float* cmul = col_mul != nullptr ? cadd + SLAB : nullptr;
    const int colq = col0 + 32 * quad;

    if constexpr (W > 0) {
      // ---- windowed top-R in registers: this thread's 32 columns lie in
      // one window, shared by TPW threads of the quad
      constexpr int TPW = W / 32;
      int top[2][R];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < R; ++r) top[h][r] = static_cast<int>(0x80000000u);
#pragma unroll
      for (int m4 = 0; m4 < 8; ++m4) {
        // past Cmax the staged values are stale: those windows are not stored
        const float4 ca = reinterpret_cast<const float4*>(cadd)[m4];
        const float4 cm = cmul != nullptr ? reinterpret_cast<const float4*>(cmul)[m4]
                                          : make_float4(1.f, 1.f, 1.f, 1.f);
        const float cav[4] = {ca.x, ca.y, ca.z, ca.w}, cmv[4] = {cm.x, cm.y, cm.z, cm.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 4 * m4 + e;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // rounding per operation (no contraction), as the plain version
            float s = __fmul_rn(scale, acc[4 * (m & 15) + (m >> 4) + 2 * h]);
            if (row_add != nullptr) s = __fadd_rn(s, radd[h]);
            if (cmul != nullptr) s = __fmul_rn(s, cmv[e]);
            s = __fadd_rn(s, cav[e]);
            insert<R>(top[h], (to_key(s) & ~pm) | ((colq + m) & pm));
          }
        }
      }
      // merge the window's threads: keys are distinct (their column bits differ)
#pragma unroll
      for (int off = 1; off < TPW; off <<= 1)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int other[R];
#pragma unroll
          for (int r = 0; r < R; ++r) other[r] = __shfl_xor_sync(0xFFFFFFFFu, top[h][r], off);
#pragma unroll
          for (int r = 0; r < R; ++r) insert<R>(top[h], other[r]);
        }
      // winner r of window w goes to lane r*S + w, from thread r % TPW of
      // the window's threads
      const int S = Cmax / W, w = colq / W;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (orow[h] < 0 || w >= S) continue;
        int* dst = out + static_cast<size_t>(orow[h]) * (S * R);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r % TPW != quad % TPW) continue;
          int m = top[h][r];
          if (win_add != nullptr)
            m = (to_key(__fadd_rn(from_key(m & ~pm), wadd[h])) & ~pm) | (m & pm);
          dst[r * S + w] = m;
        }
      }
      release(&empty[last], lane);
    } else {
      // ---- row mode: the warp stages its own 16 rows of the slab
      __syncwarp();
#pragma unroll
      for (int m4 = 0; m4 < 8; ++m4) {
        // past Cmax (Cmax % 4 == 0: a float4 of columns never straddles it)
        // the staged values are stale and the keys are the sentinel
        const float4 ca = reinterpret_cast<const float4*>(cadd)[m4];
        const float4 cm = cmul != nullptr ? reinterpret_cast<const float4*>(cmul)[m4]
                                          : make_float4(1.f, 1.f, 1.f, 1.f);
        const float cav[4] = {ca.x, ca.y, ca.z, ca.w}, cmv[4] = {cm.x, cm.y, cm.z, cm.w};
        const int col = colq + 4 * m4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int kv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = 4 * m4 + e;
            float s = __fmul_rn(scale, acc[4 * (m & 15) + (m >> 4) + 2 * h]);
            if (row_add != nullptr) s = __fadd_rn(s, radd[h]);
            if (cmul != nullptr) s = __fmul_rn(s, cmv[e]);
            s = __fadd_rn(s, cav[e]);
            kv[e] = col < Cmax ? (to_key(s) & ~pm) | ((col + e) & pm) : sentinel;
          }
          const int row = rl + 8 * h;
          *reinterpret_cast<int4*>(stg + row * STG + stg_pos(row, 32 * quad + 4 * m4)) =
              make_int4(kv[0], kv[1], kv[2], kv[3]);
        }
      }
      release(&empty[last], lane);  // syncs the warp: its staged rows are written
      if (whole) {
        for (int rr = 0; rr < 16; ++rr) {
          const int r = warp * 16 + rr;
          if (r >= n_rows) break;
#pragma unroll
          for (int e = 0; e < SLAB / 32; ++e) {
            const int col = col0 + e * 32 + lane;
            if (col < Cmax)
              out[static_cast<size_t>(s_orig[r]) * Cmax + col] =
                  stg[r * STG + stg_pos(r, e * 32 + lane)];
          }
        }
      } else {
        // 2 * ROW_NR rows at a time, ROW_NR per half-warp (a row past
        // n_rows merges into its own unused list)
        for (int rr = 0; rr < 16 && warp * 16 + rr < n_rows; rr += 2 * ROW_NR) {
          int* keys[ROW_NR];
          int* lists[ROW_NR];
#pragma unroll
          for (int q = 0; q < ROW_NR; ++q) {
            const int r = warp * 16 + rr + 2 * q + (lane >> 4);
            keys[q] = stg + r * STG;
            lists[q] = run + r * R;
          }
          row_merge<R / 16>(keys, lists, r_keep, sentinel, col0 == 0,
                            row_ins_max(R / 16, true), lane);
        }
      }
    }
  }

  if constexpr (W == 0) {
    if (!whole) {
      __syncwarp();
      for (int rr = 0; rr < 16; ++rr) {
        const int r = warp * 16 + rr;
        if (r >= n_rows) break;
        row_store(out + static_cast<size_t>(s_orig[r]) * r_keep, run + r * R, r_keep, lane);
      }
    }
  }
}

// ---------------------------------------------------------------- host

template <int W, int R, bool AR, bool SPLIT>
cudaError_t launch_ar(const CUtensorMap& map_a, const CUtensorMap& map_b, const int* starts,
                      const int* tile_start, const int* order, const float* row_add,
                      const float* col_mul, const float* col_add, const float* win_add,
                      int* out, int K, int n_kc, int Cmax, int n_tiles, float scale,
                      int pos_bits, int sentinel, int r_keep, cudaStream_t stream) {
  const size_t smem = 1024 + static_cast<size_t>(stages<W>()) * Stage<AR>::BYTES +
                      (AR ? static_cast<size_t>(n_kc) * A_CHUNK : 0) +
                      BARS + (W == 0 ? row_smem(R) * sizeof(int) : 0);
  cudaError_t err = cudaFuncSetAttribute(block_topw_f32_kernel<W, R, AR, SPLIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  block_topw_f32_kernel<W, R, AR, SPLIT><<<n_tiles, THREADS, smem, stream>>>(
      map_a, map_b, starts, tile_start, order, row_add, col_mul, col_add, win_add, out, K,
      n_kc, Cmax, scale, pos_bits, sentinel, r_keep);
  return cudaGetLastError();
}

// the query tile resident when d needs at most A_RES_KC chunks (and row
// mode's lists leave room: row_resident); the f32 query split unless it was
// rounded to bf16
template <int W, int R>
cudaError_t launch(const CUtensorMap& map_a, const CUtensorMap& map_b, const int* starts,
                   const int* tile_start, const int* order, const float* row_add,
                   const float* col_mul, const float* col_add, const float* win_add, int* out,
                   int K, int n_kc, int Cmax, int n_tiles, float scale, int round_query,
                   int pos_bits, int sentinel, int r_keep, cudaStream_t stream) {
#define QV_AR(AR, SPLIT)                                                                    \
  return launch_ar<W, R, AR, SPLIT>(map_a, map_b, starts, tile_start, order, row_add,      \
                                    col_mul, col_add, win_add, out, K, n_kc, Cmax, n_tiles, \
                                    scale, pos_bits, sentinel, r_keep, stream);
  if constexpr (W > 0 || row_resident(R)) {
    if (n_kc <= A_RES_KC) {
      if (round_query) { QV_AR(true, false) } else { QV_AR(true, true) }
    }
  }
  if (round_query) { QV_AR(false, false) } else { QV_AR(false, true) }
#undef QV_AR
}

}  // namespace

extern "C" {

int ivf_block_topw_f32_tile_rows() { return TQ; }

int ivf_block_topw_f32_row_max() { return ROW_RMAX; }

// Two counts: M, the sorted pairs to score (order[M], starts[K] == M, the rows
// of qa and of the query tensor map), and the output rows, which original
// pair ids (order[i] < B*P) index, as row_add and win_add do. The kernels
// write only the rows a sorted pair reaches: with a truncated pair list
// (M < B*P, one shard's pairs) the caller fills out with the sentinel first.
// Returns the cudaError_t of the launches (0 = queued). Pointers are device
// pointers on `device`; row_add, col_mul and win_add may be null. blocks is
// f32[K, d, Cmax] with Cmax % 4 == 0 (the tensor map's row stride is a
// multiple of 16 bytes), 16-byte aligned, as are col_add and col_mul. qa is
// scratch of M x d_pad f32 (d_pad = d rounded up to 32). tile_start[K+1]
// counts each cluster's tiles of TQ sorted pairs; n_tiles, the grid, is an
// upper bound on their count. W = 0 is row mode: the top R <= ROW_RMAX
// (128) of the whole row, or every key of the row (an out of [B*P, Cmax])
// when R > 128; row mode takes the KEY_MIN sentinel. The library
// links its own CUDA runtime, whose current device is set here
// (csrc/device_guard.cuh) and restored on return.
int ivf_block_topw_f32(const float* q, const float* cents, const int* starts,
                       const int* tile_start, const int* order, const float* blocks, float* qa,
                       const float* row_add, const float* col_mul, const float* col_add,
                       const float* win_add, int* out, int K, int d, int Cmax, int P, int M,
                       int n_tiles, float scale, int sub_cent, int round_query, int W, int R,
                       int pos_bits, int sentinel, int device, void* stream) {
  if (M <= 0 || n_tiles <= 0) return 0;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  auto s = static_cast<cudaStream_t>(stream);
  const int d_pad = (d + DK - 1) / DK * DK;
  const int per_block = 8 * GATHER_ROWS;
  gather_queries_f32<<<(M + per_block - 1) / per_block, 256, 0, s>>>(
      q, cents, starts, order, qa, K, d, d_pad, P, M, sub_cent, round_query);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_a, map_b;
  // the query tile: boxes of 32 (a 128-byte row) x 64 pairs; the slab:
  // boxes of 32 columns x 32 rows of d x 1 cluster
  const cuuint64_t dims_a[2] = {(cuuint64_t)d_pad, (cuuint64_t)M};
  const cuuint64_t strides_a[1] = {(cuuint64_t)d_pad * 4};
  const cuuint32_t box_a[2] = {DK, TQ};
  const cuuint64_t dims_b[3] = {(cuuint64_t)Cmax, (cuuint64_t)d, (cuuint64_t)K};
  const cuuint64_t strides_b[2] = {(cuuint64_t)Cmax * 4, (cuuint64_t)d * Cmax * 4};
  const cuuint32_t box_b[3] = {32, DK, 1};
  err = make_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, qa, 2, dims_a, strides_a, box_a);
  if (err == cudaSuccess)
    err = make_map(&map_b, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, blocks, 3, dims_b, strides_b, box_b);
  if (err != cudaSuccess) return (int)err;
  const int n_kc = d_pad / DK;
#define QV_CASE(WW, RR)                                                                      \
  if (W == WW && R == RR)                                                                    \
    return (int)launch<WW, RR>(map_a, map_b, starts, tile_start, order, row_add, col_mul,   \
                               col_add, win_add, out, K, n_kc, Cmax, n_tiles, scale,        \
                               round_query, pos_bits, sentinel, R, s);
  QV_CASE(32, 2)
  QV_CASE(64, 2)
  QV_CASE(128, 2)
  QV_CASE(128, 4)
#undef QV_CASE
#define QV_ROW(CC)                                                                          \
  return (int)launch<0, CC>(map_a, map_b, starts, tile_start, order, row_add, col_mul,      \
                            col_add, win_add, out, K, n_kc, Cmax, n_tiles, scale,           \
                            round_query, pos_bits, sentinel, R, s);
  if (W == 0 && R >= 1 && R <= Cmax) {
    // lists of 32, 64, 112 or 128 entries; above ROW_RMAX the whole row
    // (no list)
    if (R > ROW_RMAX || row_epl(R) == 2) { QV_ROW(32) }
    if (row_epl(R) == 4) { QV_ROW(64) }
    if (row_epl(R) == 7) { QV_ROW(112) }
    QV_ROW(128)
  }
#undef QV_ROW
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
