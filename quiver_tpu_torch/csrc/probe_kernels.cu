// The two probe kernels of benches/probe_pallas.py for Hopper (sm_90a),
// CUDA C++.
//
// scatter_rows replaces `kernel` in benches/probe_pallas.py::main (grid
// (nchunks, K), pallas_call at :83). For every chunk c it fills the chunk's
// output [BPc, L] with -1.0, then for every cluster k copies the rows r of
// [starts[c*(K+1)+k], starts[c*(K+1)+k+1]) as out[c, pos[c*BPc + r]] =
// 2 * vals[c, r]. Rows outside every range keep -1. It is the pattern by
// which block_topw (ivf_block_topw.cu) writes a pair's winners to the
// pair's original row.
//
// index_read replaces `kernel2` in the same function (grid (4,),
// pallas_call at :105): block i reads big[i * stride] and writes
// x + (float)big[i * stride] to out[i]. On the TPU `big` was
// scalar-prefetched into SMEM, which bounds its size; here each block reads
// its own index from device memory, which is why block_topw has no bound on
// the pair count.
//
// What bounds them on an H100: scatter_rows moves bytes only: at the main
// path's shape (one chunk of BPc = 196,608 rows x 128 f32) it reads 100 MB
// and writes 100 MB of rows plus 100 MB of fill, ~0.09 ms at the data
// sheet's 3.35 TB/s. index_read moves G scalars and is bound by its launch.
//
// Design, simple first. The fill is part of the TPU kernel's body (its
// k == 0 step); on the GPU blocks of one launch run in no order, so the
// fill is a kernel of its own, launched first on the same stream. The
// scatter then runs SPLITS blocks per (chunk, cluster), which share the
// cluster's rows: clusters are uneven (at the main path's shape the mean
// is ~140 rows and the largest holds 5,000-10,000), and one block per
// cluster left the largest one's block running alone (0.63 ms where 8
// blocks took 0.22 ms, on an NVIDIA H100 80GB HBM3 at 700 W). Each warp copies whole rows, one float4 per lane per
// step (a 512-byte row of 128 lanes is one step of a warp), and every
// block reads its own starts/pos entries from device memory: no scalar
// prefetch, no SMEM bound. Targets are expected to
// be distinct within a chunk (a permutation, as the pair order is); rows
// and targets outside [0, BPc) are skipped, never read or written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SCATTER_THREADS = 256;  // 8 warps, one row per warp per step
constexpr int SPLITS = 8;             // blocks sharing one cluster's rows
constexpr int FILL_THREADS = 256;

__global__ void fill_kernel(float4* __restrict__ out, size_t n4, float v) {
  const float4 f = make_float4(v, v, v, v);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = f;
}

__global__ void scatter_rows_kernel(const float4* __restrict__ vals,
                                    const int* __restrict__ starts,
                                    const int* __restrict__ pos,
                                    float4* __restrict__ out, int K, int BPc,
                                    int l4) {
  const int k = blockIdx.x;
  const int c = blockIdx.y;
  const int base = c * (K + 1);
  const int lo = starts[base + k];
  const int hi = starts[base + k + 1];
  constexpr int WARPS = SCATTER_THREADS / 32;
  const int warp = blockIdx.z * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const size_t chunk = (size_t)c * BPc;
  for (int r = lo + warp; r < hi; r += SPLITS * WARPS) {
    if (r < 0 || r >= BPc) continue;
    const int t = pos[chunk + r];
    if (t < 0 || t >= BPc) continue;
    const float4* src = vals + (chunk + r) * l4;
    float4* dst = out + (chunk + t) * l4;
    for (int j = lane; j < l4; j += 32) {
      float4 v = src[j];
      v.x *= 2.0f;
      v.y *= 2.0f;
      v.z *= 2.0f;
      v.w *= 2.0f;
      dst[j] = v;
    }
  }
}

__global__ void index_read_kernel(const int* __restrict__ big,
                                  const float* __restrict__ x,
                                  float* __restrict__ out, int stride) {
  if (threadIdx.x == 0)
    out[blockIdx.x] = x[0] + (float)big[(size_t)blockIdx.x * stride];
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launches (0 = queued). vals and out are
// f32[nchunks, BPc, lanes] (lanes % 4 == 0, 16-byte aligned), starts is
// i32[nchunks * (K + 1)], pos is i32[nchunks * BPc]; all device pointers on
// `device`. The library links its own CUDA runtime, whose current device is
// set here rather than inherited from the caller's runtime.
int probe_scatter_rows(const float* vals, const int* starts, const int* pos,
                       float* out, int nchunks, int K, int BPc, int lanes,
                       int device, void* stream) {
  if (nchunks <= 0 || BPc <= 0 || lanes <= 0) return 0;
  if (lanes % 4 || K <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  auto s = static_cast<cudaStream_t>(stream);
  const int l4 = lanes / 4;
  const size_t n4 = (size_t)nchunks * BPc * l4;
  const size_t want = (n4 + FILL_THREADS - 1) / FILL_THREADS;
  const int fill_blocks = (int)(want < 132 * 32 ? want : 132 * 32);
  fill_kernel<<<fill_blocks, FILL_THREADS, 0, s>>>(
      reinterpret_cast<float4*>(out), n4, -1.0f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scatter_rows_kernel<<<dim3(K, nchunks, SPLITS), SCATTER_THREADS, 0, s>>>(
      reinterpret_cast<const float4*>(vals), starts, pos,
      reinterpret_cast<float4*>(out), K, BPc, l4);
  return (int)cudaGetLastError();
}

// Returns the cudaError_t of the launch (0 = queued). Block i of G writes
// x[0] + (float)big[i * stride] to out[i]; the caller guarantees
// (G - 1) * stride < len(big).
int probe_index_read(const int* big, const float* x, float* out, int G,
                     int stride, int device, void* stream) {
  if (G <= 0) return 0;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  index_read_kernel<<<G, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      big, x, out, stride);
  return (int)cudaGetLastError();
}

}  // extern "C"
