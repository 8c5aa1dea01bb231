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
// of every W-column window, written straight to the pair's original row in
// lane r*S + w (S = Cmax / W), each optionally re-keyed with a per-pair f32
// constant (win_add). W = 0 selects one window spanning the whole row, row
// mode: the running top R <= 128 kept in the kernel (csrc/row_topr.cuh), or,
// for R > 128 (still to do), every key of the row for the wrapper's top-R.
//
// What bounds it on an H100 (SXM, 700 W: 3.35 TB/s, 989 TFLOP/s bf16
// dense). At the serving shape (B=65536, n_probe=3, K=1405, Cmax=1280,
// d=128) the work is 64.4 GFLOP of products (0.065 ms on the tensor cores)
// against 565 MB that must move (blocks 460 MB, keys out 63 MB, queries
// 34 MB): 0.169 ms, so bytes bound it. This design takes 0.623 ms there
// (27% of that bound; 0.655 ms fused) and 1.166 ms at d=768 (B=16384,
// K=1024: 53% of its 0.623 ms bound), where the previous one (CUDA-core
// f32 FMAs, synchronous slab loads, keys through shared memory) took 3.394
// ms and could not run d=768 at all (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py phase 3). Neither the tensor cores nor device memory are
// the limit now: the time goes to the epilogue (about ten float and integer
// operations for each of the 252M scores, between a warpgroup's products)
// and to streaming each cluster's block once per 64-pair tile (~1.2 GB from
// L2). Blocks of 2 or 4 tiles sharing each slab measured slower than three
// independent one-tile blocks per SM, as did a persistent grid (PERF.md).
//
// Design. A prologue kernel gathers each sorted pair's query (minus the
// centroid for L2, rounded to bf16, zero past d) into an [M, d_pad] scratch
// in sorted order, so both operands of the product arrive by TMA. The main
// kernel gives each block one tile of 64 pairs of one cluster (a sync-free
// map: the grid is an upper bound on the tiles and surplus blocks exit). Its
// consumer warpgroup runs wgmma.m64n128k16 (bf16 -> f32; A K-major, B
// MN-major, 128-byte swizzle) over a ring of STAGES stages that one producer
// thread keeps full with TMA loads completing on mbarriers: per stage a
// 64-deep d chunk of the block slab (64 x 128 bf16) and, when d needs more
// than A_RES_KC chunks, of the tile's queries; for d <= 128 the query tile
// loads once and stays resident. The slab's last stage also brings its
// col_add and col_mul rows (a bulk copy) and is held until the epilogue has
// read them.
// Shared memory does not grow with d (any d: the tensor maps' out-of-bounds
// fill zeroes the rows past d). The epilogue runs on the accumulators in
// registers: in the m64nNk16 layout a W-column window of one row lies in
// one quad of threads, so each thread keeps its top R of its W/4 values,
// two xor-shuffle rounds merge the quad, and the quad stores the window
// winners straight to the pair's row. Row mode stages each slab's keys in
// shared memory per warp (a warp's 16 rows are its own), releases the ring
// stage, and merges them into each row's running top-R in shared memory
// behind a threshold filter (csrc/row_topr.cuh, shared with the f32 kernel);
// for R > 128 it copies them out whole. The merge is bound by the latency
// of its shuffle chains, so blocks per SM set its pace; its lists and
// staged rows cost shared memory: R <= 32 keeps the windowed variants'
// 3-stage ring with two blocks per SM, lists of 64 and 112 entries (R <=
// 64, R <= 112) take a 2-stage ring to keep two, and R <= 128 (a 32 KB
// list) runs one block per SM on a 3-stage ring.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"
#include "row_topr.cuh"
#include "device_guard.cuh"

namespace {

constexpr int TQ = 64;              // pair rows per tile (block): the wgmma M
constexpr int SLAB = 128;           // block columns per slab: the wgmma N
constexpr int DK = 64;              // d per ring stage: one 128-byte bf16 row
constexpr int MIN_BLOCKS = 3;       // windowed variants: blocks per SM, for the registers
constexpr int GATHER_ROWS = 8;      // prologue: sorted pairs per warp
constexpr int THREADS = 128 + 32;   // the consumer warpgroup, then the producer warp
constexpr int CHUNK = 64 * DK * 2;  // 8 KB: the tile's query chunk, or half a slab
// the query tile stays resident when d needs at most this many chunks
// (d <= 128); otherwise each stage brings its chunk too
constexpr int A_RES_KC = 2;
constexpr int STG = SLAB;           // row mode: staging row stride (ints)
// row mode's ints: the staged slab, the running lists of C entries, each
// row's original pair
constexpr int row_smem(int C) { return TQ * STG + TQ * C + TQ; }

// Row mode stages column c of a row at this position of its staged row: a
// 16-lane phase of the epilogue's int2 stores (rows g..g+3, four column
// pairs each) lands in 32 distinct banks. An involution on [0, 128); the
// merge takes the keys in any order.
__device__ __forceinline__ int stg_pos(int row, int c) { return c ^ ((row & 3) << 3); }
// the barriers' bytes (full and empty per stage, afull), so that row mode's
// staged rows after them start on 16 bytes for their int4 reads
constexpr int BARS = 64;

// ring depth; row mode (W = 0, R the list's C entries) takes 2 stages at
// C = 64 and 112 to keep two blocks per SM
template <int W, int R>
__host__ __device__ constexpr int stages() { return W == 0 && (R == 64 || R == 112) ? 2 : 3; }
// blocks per SM the registers are capped for
template <int W, int R>
__host__ __device__ constexpr int min_blocks() { return W > 0 ? MIN_BLOCKS : R <= 112 ? 2 : 1; }
static_assert((2 * 3 + 1) * 8 <= BARS, "barriers");

// One ring stage: the tile's query chunk (unless resident), the slab's two
// 64-column halves, then the slab's col_add and col_mul rows.
template <bool AR>
struct Stage {
  static constexpr int B = AR ? 0 : CHUNK;
  static constexpr int AUX = B + 2 * CHUNK;
  static constexpr int BYTES = AUX + 2 * SLAB * 4;  // a multiple of 1024
};

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// d[64] (+)= A[64 x 16] (K-major) * B[16 x 128] (MN-major: trans-b = 1)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// keep the compiler from touching the accumulators across wgmma's async writes
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// one row of the prologue: dst = bf16(qr - cr) (or of qr alone), zero past d
__device__ __forceinline__ void gather_row(const float* __restrict__ qr,
                                           const float* __restrict__ cr,
                                           __nv_bfloat162* __restrict__ dst, int d, int d_pad,
                                           int sub_cent, bool vec, int lane) {
  if (vec) {  // 16-byte loads where the rows allow them
    for (int k4 = lane; k4 < d_pad / 4; k4 += 32) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (4 * k4 < d) {
        v = reinterpret_cast<const float4*>(qr)[k4];
        if (sub_cent) {
          const float4 c = reinterpret_cast<const float4*>(cr)[k4];
          v = make_float4(__fsub_rn(v.x, c.x), __fsub_rn(v.y, c.y), __fsub_rn(v.z, c.z),
                          __fsub_rn(v.w, c.w));
        }
      }
      dst[2 * k4] = __floats2bfloat162_rn(v.x, v.y);
      dst[2 * k4 + 1] = __floats2bfloat162_rn(v.z, v.w);
    }
    return;
  }
  for (int k2 = lane; k2 < d_pad / 2; k2 += 32) {
    float v[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = 2 * k2 + j;
      if (k < d) v[j] = sub_cent ? __fsub_rn(qr[k], cr[k]) : qr[k];
    }
    dst[k2] = __floats2bfloat162_rn(v[0], v[1]);
  }
}

// Prologue: qa[i, :] = bf16(q[order[i] / P] - cents[c_i]) for sorted pair i
// of cluster c_i (no centroid for dot / cosine), zero from d to d_pad. A
// warp takes GATHER_ROWS consecutive pairs: one search of starts, then a
// walk (a search per pair made the prologue latency-bound).
__global__ void __launch_bounds__(256) gather_queries(
    const float* __restrict__ q, const float* __restrict__ cents,
    const int* __restrict__ starts, const int* __restrict__ order,
    __nv_bfloat162* __restrict__ qa, int K, int d, int d_pad, int P, int M, int sub_cent) {
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
               qa + static_cast<size_t>(row) * (d_pad / 2), d, d_pad, sub_cent, vec, lane);
  }
}

// W > 0: top R per W-column window (W in {32, 64, 128}). W == 0: row mode,
// the running top r_keep of the row in lists of C = R entries (r_keep <= R
// <= ROW_RMAX), or every key of the row when r_keep > ROW_RMAX.
template <int W, int R, bool AR>
__global__ void __launch_bounds__(THREADS, min_blocks<W, R>()) block_topw_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
    const int* __restrict__ starts, const int* __restrict__ tile_start,
    const int* __restrict__ order, const float* __restrict__ row_add,
    const float* __restrict__ col_mul, const float* __restrict__ col_add,
    const float* __restrict__ win_add, int* __restrict__ out, int K, int n_kc, int Cmax,
    float scale, int pos_bits, int sentinel, int r_keep) {
  static_assert(W == 0 || (W % 32 == 0 && SLAB % (W ? W : 1) == 0), "window");
  const int g = blockIdx.x;
  if (g >= tile_start[K]) return;  // the grid is an upper bound on the tiles
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle pattern repeats every 8 rows
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  using St = Stage<AR>;
  constexpr int STAGES = stages<W, R>();
  // the ring, the resident query tile (AR), the barriers, row mode's rows
  unsigned char* ares = smem + STAGES * St::BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ares + (AR ? n_kc * CHUNK : 0));
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
  const int c = find_cluster(tile_start, K, g);
  const int row0 = starts[c] + (g - tile_start[c]) * TQ;  // the tile's first sorted pair

  if (tid >= 128) {
    // ---- producer: one thread keeps the ring full
    if (tid != 128) return;
    if constexpr (AR) {
      mbar_expect_tx(afull, n_kc * CHUNK);
      for (int kc = 0; kc < n_kc; ++kc) tma_2d(ares + kc * CHUNK, &map_a, afull, kc * DK, row0);
    }
    int stage = 0, phase = 0;
    for (int col0 = 0; col0 < Cmax; col0 += SLAB) {
      const int halves = col0 + 64 < Cmax ? 2 : 1;
      for (int kc = 0; kc < n_kc; ++kc) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = smem + stage * St::BYTES;
        // the slab's last chunk also brings its col_add (and col_mul) row
        const int aux_bytes =
            kc + 1 < n_kc ? 0 : min(SLAB, Cmax - col0) * 4 * (col_mul != nullptr ? 2 : 1);
        mbar_expect_tx(&full[stage], (halves + (AR ? 0 : 1)) * CHUNK + aux_bytes);
        if (aux_bytes) {
          const size_t off = static_cast<size_t>(c) * Cmax + col0;
          bulk_copy(st + St::AUX, col_add + off, min(SLAB, Cmax - col0) * 4, &full[stage]);
          if (col_mul != nullptr)
            bulk_copy(st + St::AUX + SLAB * 4, col_mul + off, min(SLAB, Cmax - col0) * 4,
                      &full[stage]);
        }
        tma_3d(st + St::B, &map_b, &full[stage], col0, kc * DK, c);
        if (halves == 2)
          tma_3d(st + St::B + CHUNK, &map_b, &full[stage], col0 + 64, kc * DK, c);
        if constexpr (!AR) tma_2d(st, &map_a, &full[stage], kc * DK, row0);
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // ---- the consumer warpgroup
  const int warp = tid >> 5, lane = tid & 31, quad = lane & 3;
  const int rl = warp * 16 + (lane >> 2);  // this thread's rows: rl, rl + 8
  const int pm = (1 << pos_bits) - 1;
  int* stg = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(full) + BARS);
  // row mode: stg [TQ][STG] keys of the slab; run [TQ][R] running lists;
  // s_orig [TQ] original pair of each row
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
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int stage = 0, phase = 0;

  if constexpr (AR) mbar_wait(afull, 0);
  for (int col0 = 0; col0 < Cmax; col0 += SLAB) {
    int last = 0;  // the slab's last stage: released after the epilogue
    for (int kc = 0; kc < n_kc; ++kc) {
      mbar_wait(&full[stage], phase);
      unsigned char* st = smem + stage * St::BYTES;
      const uint64_t da = desc_sw128(smem_u32(AR ? ares + kc * CHUNK : st), 16, 1024);
      const uint64_t db = desc_sw128(smem_u32(st + St::B), CHUNK, 1024);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int k16 = 0; k16 < DK / 16; ++k16)  // A: +32 B along a row; B: +16 rows
        wgmma_m64n128k16(acc, da + 2 * k16, db + 128 * k16, kc > 0 || k16 > 0);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(acc);
      if (kc + 1 < n_kc) release(&empty[stage], lane); else last = stage;
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }
    // the slab's col_add and col_mul, staged by the producer
    const float* cadd = reinterpret_cast<const float*>(smem + last * St::BYTES + St::AUX);
    const float* cmul = col_mul != nullptr ? cadd + SLAB : nullptr;

    if constexpr (W > 0) {
      // ---- windowed top-R in registers: thread holds rows rl, rl + 8 at
      // columns col0 + 8i + 2*quad + {0, 1}; window w of the slab is i in
      // [w*W/8, (w+1)*W/8), shared by the 4 threads of the quad
      constexpr int NWS = SLAB / W, IPW = W / 8;
      int top[2][NWS][R];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int w = 0; w < NWS; ++w)
#pragma unroll
          for (int r = 0; r < R; ++r) top[h][w][r] = static_cast<int>(0x80000000u);
#pragma unroll
      for (int i = 0; i < SLAB / 8; ++i) {
        const int col = col0 + 8 * i + 2 * quad;
        // past Cmax the staged values are stale: those windows are not stored
        const float2 ca = *reinterpret_cast<const float2*>(cadd + 8 * i + 2 * quad);
        const float2 cm = cmul != nullptr ? *reinterpret_cast<const float2*>(cmul + 8 * i + 2 * quad)
                                          : make_float2(1.f, 1.f);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            // rounding per operation (no contraction), as the plain version
            float s = __fmul_rn(scale, acc[4 * i + 2 * h + j]);
            if (row_add != nullptr) s = __fadd_rn(s, radd[h]);
            if (cmul != nullptr) s = __fmul_rn(s, j ? cm.y : cm.x);
            s = __fadd_rn(s, j ? ca.y : ca.x);
            insert<R>(top[h][i / IPW], (to_key(s) & ~pm) | ((col + j) & pm));
          }
      }
      // merge the quad: keys are distinct (their column bits differ)
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int w = 0; w < NWS; ++w) {
            int other[R];
#pragma unroll
            for (int r = 0; r < R; ++r)
              other[r] = __shfl_xor_sync(0xFFFFFFFFu, top[h][w][r], off);
#pragma unroll
            for (int r = 0; r < R; ++r) insert<R>(top[h][w], other[r]);
          }
      // the quad stores entry e = r*NWS + w of the slab's winners from
      // thread e % 4, to lane r*S + col0/W + w of the pair's row
      const int S = Cmax / W, w0 = col0 / W;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (orow[h] < 0) continue;
        int* dst = out + static_cast<size_t>(orow[h]) * (S * R);
#pragma unroll
        for (int e = 0; e < NWS * R; ++e) {
          const int r = e / NWS, w = e % NWS;
          if ((e & 3) != quad || w0 + w >= S) continue;
          int m = top[h][w][r];
          if (win_add != nullptr)
            m = (to_key(__fadd_rn(from_key(m & ~pm), wadd[h])) & ~pm) | (m & pm);
          dst[r * S + w0 + w] = m;
        }
      }
      release(&empty[last], lane);
    } else {
      // ---- row mode: the warp stages its own 16 rows of the slab
      __syncwarp();
#pragma unroll
      for (int i = 0; i < SLAB / 8; ++i) {
        const int col = col0 + 8 * i + 2 * quad;
        // past Cmax (Cmax is even: a column pair never straddles it) the
        // staged values are stale and the keys are the sentinel
        const float2 ca = *reinterpret_cast<const float2*>(cadd + 8 * i + 2 * quad);
        const float2 cm = cmul != nullptr ? *reinterpret_cast<const float2*>(cmul + 8 * i + 2 * quad)
                                          : make_float2(1.f, 1.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int kv[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float s = __fmul_rn(scale, acc[4 * i + 2 * h + j]);
            if (row_add != nullptr) s = __fadd_rn(s, radd[h]);
            if (cmul != nullptr) s = __fmul_rn(s, j ? cm.y : cm.x);
            s = __fadd_rn(s, j ? ca.y : ca.x);
            kv[j] = col < Cmax ? (to_key(s) & ~pm) | ((col + j) & pm) : sentinel;
          }
          const int row = rl + 8 * h;
          *reinterpret_cast<int2*>(stg + row * STG + stg_pos(row, 8 * i + 2 * quad)) =
              make_int2(kv[0], kv[1]);
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
                            row_ins_max(R / 16, false), lane);
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

template <int W, int R, bool AR>
cudaError_t launch_ar(const CUtensorMap& map_a, const CUtensorMap& map_b, const int* starts,
                      const int* tile_start, const int* order, const float* row_add,
                      const float* col_mul, const float* col_add, const float* win_add,
                      int* out, int K, int n_kc, int Cmax, int n_tiles, float scale,
                      int pos_bits, int sentinel, int r_keep, cudaStream_t stream) {
  const size_t smem = 1024 + static_cast<size_t>(stages<W, R>()) * Stage<AR>::BYTES +
                      (AR ? static_cast<size_t>(n_kc) * CHUNK : 0) + BARS +
                      (W == 0 ? row_smem(R) * sizeof(int) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      block_topw_kernel<W, R, AR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  block_topw_kernel<W, R, AR><<<n_tiles, THREADS, smem, stream>>>(
      map_a, map_b, starts, tile_start, order, row_add, col_mul, col_add, win_add, out, K,
      n_kc, Cmax, scale, pos_bits, sentinel, r_keep);
  return cudaGetLastError();
}

// the query tile resident when d needs at most A_RES_KC chunks
template <int W, int R>
cudaError_t launch(const CUtensorMap& map_a, const CUtensorMap& map_b, const int* starts,
                   const int* tile_start, const int* order, const float* row_add,
                   const float* col_mul, const float* col_add, const float* win_add, int* out,
                   int K, int n_kc, int Cmax, int n_tiles, float scale, int pos_bits,
                   int sentinel, int r_keep, cudaStream_t stream) {
  return n_kc <= A_RES_KC
             ? launch_ar<W, R, true>(map_a, map_b, starts, tile_start, order, row_add, col_mul,
                                     col_add, win_add, out, K, n_kc, Cmax, n_tiles, scale,
                                     pos_bits, sentinel, r_keep, stream)
             : launch_ar<W, R, false>(map_a, map_b, starts, tile_start, order, row_add,
                                      col_mul, col_add, win_add, out, K, n_kc, Cmax, n_tiles,
                                      scale, pos_bits, sentinel, r_keep, stream);
}

}  // namespace

extern "C" {

int ivf_block_topw_tile_rows() { return TQ; }

int ivf_block_topw_row_max() { return ROW_RMAX; }

const char* ivf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Two counts: M, the sorted pairs to score (order[M], starts[K] == M, the rows
// of qa and of the query tensor map), and the output rows, which original
// pair ids (order[i] < B*P) index, as row_add and win_add do. The kernels
// write only the rows a sorted pair reaches: with a truncated pair list
// (M < B*P, one shard's pairs) the caller fills out with the sentinel first.
// Returns the cudaError_t of the launches (0 = queued). Pointers are device
// pointers on `device`; row_add, col_mul and win_add may be null. qa is
// scratch of M x d_pad bf16 (d_pad = d rounded up to 64). tile_start[K+1]
// counts each cluster's tiles of TQ sorted pairs; n_tiles, the grid, is an
// upper bound on their count.
// W = 0 is row mode: the top R <= ROW_RMAX (128) of the whole row, or every
// key of the row (an out of [B*P, Cmax]) when R > 128; row mode takes the
// KEY_MIN sentinel (below every key). The library links its own CUDA runtime,
// whose current device is set here (csrc/device_guard.cuh) and restored on return.
int ivf_block_topw(const float* q, const float* cents, const int* starts,
                   const int* tile_start, const int* order, const void* blocks, void* qa,
                   const float* row_add, const float* col_mul, const float* col_add,
                   const float* win_add, int* out, int K, int d, int Cmax, int P, int M,
                   int n_tiles, float scale, int sub_cent, int W, int R, int pos_bits,
                   int sentinel, int device, void* stream) {
  if (M <= 0 || n_tiles <= 0) return 0;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  auto s = static_cast<cudaStream_t>(stream);
  const int d_pad = (d + DK - 1) / DK * DK;
  const int per_block = 8 * GATHER_ROWS;
  gather_queries<<<(M + per_block - 1) / per_block, 256, 0, s>>>(q, cents, starts, order,
                                              static_cast<__nv_bfloat162*>(qa), K, d, d_pad, P,
                                              M, sub_cent);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_a, map_b;
  const cuuint64_t dims_a[2] = {(cuuint64_t)d_pad, (cuuint64_t)M};
  const cuuint64_t strides_a[1] = {(cuuint64_t)d_pad * 2};
  const cuuint64_t dims_b[3] = {(cuuint64_t)Cmax, (cuuint64_t)d, (cuuint64_t)K};
  const cuuint64_t strides_b[2] = {(cuuint64_t)Cmax * 2, (cuuint64_t)d * Cmax * 2};
  // 64 x 64 (x 1) boxes: a 128-byte row of 64 bf16, 64 rows
  const cuuint32_t box[3] = {64, 64, 1};
  err = make_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, qa, 2, dims_a, strides_a, box);
  if (err == cudaSuccess)
    err = make_map(&map_b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, blocks, 3, dims_b, strides_b, box);
  if (err != cudaSuccess) return (int)err;
  const int n_kc = d_pad / DK;
#define QV_CASE(WW, RR)                                                                     \
  if (W == WW && R == RR)                                                                   \
    return (int)launch<WW, RR>(map_a, map_b, starts, tile_start, order, row_add, col_mul,  \
                               col_add, win_add, out, K, n_kc, Cmax, n_tiles, scale,       \
                               pos_bits, sentinel, R, s);
  QV_CASE(32, 2)
  QV_CASE(64, 2)
  QV_CASE(128, 2)
  QV_CASE(128, 4)
#undef QV_CASE
#define QV_ROW(CC)                                                                          \
  return (int)launch<0, CC>(map_a, map_b, starts, tile_start, order, row_add, col_mul,      \
                            col_add, win_add, out, K, n_kc, Cmax, n_tiles, scale, pos_bits, \
                            sentinel, R, s);
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
