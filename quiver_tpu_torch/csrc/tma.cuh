// Helpers shared by the two block_topw kernels (csrc/ivf_block_topw.cu over
// bf16 blocks, csrc/ivf_block_topw_f32.cu over f32 ones): mbarriers, TMA
// and bulk loads into shared memory, the tensor-map encoder, the packed
// keys, the descending top-R insert and the tile map's cluster search.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// wait for the completion of the barrier's phase of the given parity; a
// wait of more than ~2^36 cycles (tens of seconds) traps, so a broken
// pipeline fails the launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  while (!done) {
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 36)) {
      __trap();
    }
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// plain bulk copy global -> shared (16-byte multiples), completion on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// a consumer warp is done with a stage
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// f32 -> monotone i32 (integer max == float max) and back: an involution
__device__ __forceinline__ int to_key(float s) {
  const int b = __float_as_int(s);
  return b ^ ((b >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ float from_key(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7FFFFFFF));
}

// insert a key into a descending top-R list
template <int R>
__device__ __forceinline__ void insert(int (&t)[R], int key) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int hi = max(t[r], key);
    key = min(t[r], key);
    t[r] = hi;
  }
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the CUDA runtime, so the
// library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a tensor map of `rank` dims with the given box, unit element strides,
// the 128-byte swizzle and a zero out-of-bounds fill
cudaError_t make_map(CUtensorMap* map, CUtensorMapDataType dtype, const void* ptr, int rank,
                     const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = fn(map, dtype, rank, const_cast<void*>(ptr), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
