// The two probe kernels of benches/probe_pallas.py for Hopper (sm_90a),
// CUDA C++.
//
// scatter_rows replaces `kernel` in benches/probe_pallas.py::main (grid
// (nchunks, K), pallas_call at :83). For every chunk c and every cluster k
// the rows r of [starts[c*(K+1)+k], starts[c*(K+1)+k+1]) are copied as
// out[c, pos[c*BPc + r]] = 2 * vals[c, r]; output rows no copied row
// targets hold -1.0. It is the pattern by which block_topw
// (ivf_block_topw.cu) writes a pair's winners to the pair's original row.
//
// index_read replaces `kernel2` in the same function (grid (4,),
// pallas_call at :105): grid step i reads big[i * stride] and writes
// x + (float)big[i * stride] to out[i]. On the TPU `big` was
// scalar-prefetched into SMEM, which bounds its size; here each thread
// reads its own index from device memory, which is why block_topw has no
// bound on the pair count.
//
// What bounds them on an H100. scatter_rows moves bytes only: at the main
// path's shape (one chunk of BPc = 196,608 rows x 128 f32) it must read
// 100.7 MB of rows and write 100.7 MB, ~0.060 ms at the data sheet's 3.35
// TB/s. index_read moves 8 G + 4 bytes (12 KB at G = 3,072): it is bound by
// its launch.
//
// scatter_rows, three passes on the caller's stream over one-byte flags
// that the wrapper zeroes (covered rows, hit targets):
//   mark:    one block per (cluster, chunk) sets covered[r] for the rows of
//            its range, clamped to [0, BPc). The union of the ranges is what
//            the TPU kernel copies, so empty, decreasing and overlapping
//            ranges need no case of their own; the largest cluster moves
//            one byte per row here, not 512.
//   scatter: rows are split in fixed tiles of TILE rows per warp, whatever
//            the clusters' sizes. Work split by cluster scaled with the
//            largest one (5,000-10,000 rows where the mean is ~140 at the
//            main path's shape), each row a dependent chain of pos, load
//            and store. Here lane i reads row i's covered flag and target
//            up front; the warp then keeps INFLIGHT rows' 16-byte loads per
//            lane in flight before it stores any of them, and sets
//            hit[target] for each row it copies.
//   fill:    a warp reads the hit flags of TILE output rows and writes -1.0
//            into those that no copy reached. At the main path's shape pos
//            is a permutation and the ranges cover the chunk, so it writes
//            nothing: the kernel moves ~201 MB of rows plus ~0.6 MB of
//            flags and metadata, where a fill of the whole output first
//            moved another 100.7 MB.
// Targets are expected to be distinct within a chunk (a permutation, as
// the pair order is); a repeated target's winner is left open. Rows and
// targets outside [0, BPc) are skipped, never read or written.
//
// index_read is one thread per grid step: ceil(G / 256) blocks of 256.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 32;      // rows per warp: one per lane for the flags and pos
constexpr int INFLIGHT = 8;   // rows whose loads a warp has in flight before storing
constexpr unsigned FULL = 0xffffffffu;
static_assert(TILE == 32 && TILE % INFLIGHT == 0, "a tile is one row per lane");

__global__ void mark_kernel(const int* __restrict__ starts,
                            uint8_t* __restrict__ covered, int K, int BPc) {
  const int k = blockIdx.x;
  const int c = blockIdx.y;
  const int* st = starts + (size_t)c * (K + 1);
  const int lo = max(st[k], 0);
  const int hi = min(st[k + 1], BPc);
  uint8_t* cov = covered + (size_t)c * BPc;
  for (int r = lo + threadIdx.x; r < hi; r += blockDim.x) cov[r] = 1;
}

__global__ void scatter_rows_kernel(const float4* __restrict__ vals,
                                    const int* __restrict__ pos,
                                    const uint8_t* __restrict__ covered,
                                    uint8_t* __restrict__ hit,
                                    float4* __restrict__ out, int BPc,
                                    int l4) {
  const int r0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * TILE;
  if (r0 >= BPc) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const size_t chunk = (size_t)blockIdx.y * BPc;
  // lane i owns row r0 + i: its target, or -1 where the row is skipped
  int t = -1;
  const int r = r0 + lane;
  if (r < BPc && covered[chunk + r]) {
    const int p = pos[chunk + r];
    if (p >= 0 && p < BPc) {
      t = p;
      hit[chunk + p] = 1;
    }
  }
  const int n = min(TILE, BPc - r0);  // lanes at and past n hold t = -1
  const float4* src = vals + (chunk + r0) * l4;
  for (int j = lane; j - lane < l4; j += 32) {  // columns: one pass when l4 <= 32
    const bool col = j < l4;
    for (int i0 = 0; i0 < n; i0 += INFLIGHT) {
      int tt[INFLIGHT];
      float4 v[INFLIGHT];
#pragma unroll
      for (int u = 0; u < INFLIGHT; ++u) {
        tt[u] = __shfl_sync(FULL, t, i0 + u);
        if (tt[u] >= 0 && col) v[u] = __ldcs(src + (size_t)(i0 + u) * l4 + j);
      }
#pragma unroll
      for (int u = 0; u < INFLIGHT; ++u) {
        if (tt[u] >= 0 && col) {
          const float4 w = make_float4(2.0f * v[u].x, 2.0f * v[u].y,
                                       2.0f * v[u].z, 2.0f * v[u].w);
          __stcs(out + (chunk + tt[u]) * l4 + j, w);
        }
      }
    }
  }
}

__global__ void fill_unhit_kernel(const uint8_t* __restrict__ hit,
                                  float4* __restrict__ out, int BPc, int l4,
                                  float value) {
  const int r0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * TILE;
  if (r0 >= BPc) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const size_t chunk = (size_t)blockIdx.y * BPc;
  const int r = r0 + lane;
  unsigned miss = __ballot_sync(FULL, r < BPc && !hit[chunk + r]);
  const float4 f = make_float4(value, value, value, value);
  while (miss) {
    const int i = __ffs(miss) - 1;
    miss &= miss - 1;
    float4* dst = out + (chunk + r0 + i) * l4;
    for (int j = lane; j < l4; j += 32) dst[j] = f;
  }
}

__global__ void index_read_kernel(const int* __restrict__ big,
                                  const float* __restrict__ x,
                                  float* __restrict__ out, int G, int stride) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < G) out[i] = x[0] + (float)big[(size_t)i * stride];
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launches (0 = queued). vals and out are
// f32[nchunks, BPc, lanes] (lanes % 4 == 0, 16-byte aligned), starts is
// i32[nchunks * (K + 1)], pos is i32[nchunks * BPc], flags is
// u8[2 * nchunks * BPc] and zero (covered rows, then hit targets); all
// device pointers on `device`. The library links its own CUDA runtime,
// whose current device is set here (csrc/device_guard.cuh) and restored
// on return.
int probe_scatter_rows(const float* vals, const int* starts, const int* pos,
                       float* out, uint8_t* flags, int nchunks, int K,
                       int BPc, int lanes, int device, void* stream) {
  if (nchunks <= 0 || BPc <= 0 || lanes <= 0) return 0;
  if (lanes % 4 || K <= 0) return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  auto s = static_cast<cudaStream_t>(stream);
  const int l4 = lanes / 4;
  uint8_t* covered = flags;
  uint8_t* hit = flags + (size_t)nchunks * BPc;
  mark_kernel<<<dim3(K, nchunks), THREADS, 0, s>>>(starts, covered, K, BPc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 tiles((BPc + WARPS * TILE - 1) / (WARPS * TILE), nchunks);
  scatter_rows_kernel<<<tiles, THREADS, 0, s>>>(
      reinterpret_cast<const float4*>(vals), pos, covered, hit,
      reinterpret_cast<float4*>(out), BPc, l4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fill_unhit_kernel<<<tiles, THREADS, 0, s>>>(
      hit, reinterpret_cast<float4*>(out), BPc, l4, -1.0f);
  return (int)cudaGetLastError();
}

// Returns the cudaError_t of the launch (0 = queued). Thread i of G writes
// x[0] + (float)big[i * stride] to out[i]; the caller guarantees
// (G - 1) * stride < len(big).
int probe_index_read(const int* big, const float* x, float* out, int G,
                     int stride, int device, void* stream) {
  if (G <= 0) return 0;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  index_read_kernel<<<(G + THREADS - 1) / THREADS, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(big, x, out, G,
                                                           stride);
  return (int)cudaGetLastError();
}

}  // extern "C"
