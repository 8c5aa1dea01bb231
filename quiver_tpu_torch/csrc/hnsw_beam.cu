// The layer-0 beam of the HNSW search (ops/hnsw_kernels.py::beam_search)
// as one kernel for Hopper (sm_90a), CUDA C++.
//
// It replaces no Pallas kernel: the reference's beam
// (quiver_tpu/ops/hnsw_kernels.py:102-290) is an XLA lax.while_loop, and
// the port ran it as some forty torch ops a loop iteration over every row
// of the batch, with a host read of "all done" every eight iterations. It
// computes what _beam_rows computes, step for step: the same sizes
// (beam_sizes: block, beam_len, ring_len, the ring's write offset
// (i * block) % ring_len), the same selection of the `expand` nearest
// unexpanded entries and the same termination test on beam column
// min(ef, beam_len) - 1, the same refusals (a repeat of an earlier column
// of the block, then the beam and the ring, or the bitmap), the distances
// by _from_dots' formula (norms from the f32 values, products of the
// compute dtype's values as IEEE f32 FMAs), and a merge equal to
// torch.sort(stable=True) over cat([beam, block]): on equal distances the
// beam first, then the lower column.
//
// What bounds it on an H100. Each query's iteration is a chain of
// dependent random reads: pos_map of the expanded entries, their adjacency
// rows (128 bytes at degree 32), the valid byte of each neighbour, then the
// rows of the neighbours not yet visited (512 bytes at d = 128). Tensor
// cores have nothing to do. The torch loop's costs were elsewhere: the
// visited test as B x block x (beam + ring + block) compares in device
// memory (2,048 x 128 x 1,152 bools an iteration at ef 320), ~40 launches
// an iteration, and every op over the rows of queries already done (a
// query is active for ~85 of ~209 iterations).
//
// The design: one CTA of 128 threads (four warps) per query, looping on
// the card until that query's termination test holds or max_iters, so the
// batch takes about as long as its longest query and no work is spent on a
// query once it is done. The query, the beam (distance, i32 id, expanded
// flag; two buffers the merge alternates between), the ring and the
// candidate block live in dynamic shared memory (~22 KB at the cell's ef
// 320, block 128, ring 640). A query's iteration is latency-bound, so each
// step is a few dependent shared-memory accesses, never a chain of them:
//   * the visited test: with the ring, the beam's and the ring's ids go into
//     a hash in shared memory (open addressing, at most half full) while
//     the adjacency rows load, and each candidate probes it; a repeat of an
//     earlier column is found by a scan of the block's ids four at a time.
//     The bitmap's bitset stays in device memory, one per query, as the
//     torch path allocates it;
//   * only the candidates that pass are read from the vectors: eight lanes
//     a row, two rows a lane group, every load of a row in flight before
//     the sums, then a three-step shuffle reduce in a fixed order;
//   * the merge ranks each accepted candidate among the others by a
//     (distance, column) key and places it after the beam entries at or
//     below its distance (a binary search of the sorted beam); each beam
//     entry moves down by the candidates strictly below it (a binary search
//     of the sorted candidates).
// Ids are i32 (the wrapper refuses a capacity of 2**31 or more); results
// are written as (f32, i64).

// The same file holds the greedy descent through the upper layers
// (ops/hnsw_kernels.py::descend) as a second kernel, hnsw_descent, which
// shares the distance helpers (rounded, inv_norm, finish, merge_key); its
// note is above descent_kernel below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float MASKED = 3.0e38f;  // ops/scan.py::MASKED_DIST
constexpr int LANES = 8;           // lanes that share one neighbour row
constexpr int SMEM_MAX = 232448;   // a block's shared memory on sm_90

// the codes of ops/hnsw_cuda.py::METRICS
enum : int { EUCLIDEAN = 0, SQUARED_EUCLIDEAN = 1, DOT_PRODUCT = 2, COSINE = 3, MANHATTAN = 4 };
enum : int { REJECT = 0, PENDING = 1, ACCEPT = 2 };

struct Args {
  const float* queries;      // [B, d]
  const int64_t* entries;    // [B]
  const float* vectors;      // [cap, d]
  const uint8_t* valid;      // [cap]
  const int* adj;            // [rows, deg]
  const int64_t* pos_map;    // [pos_len]
  float* out_d;              // [B, ef]
  int64_t* out_i;            // [B, ef]
  int64_t* iters;            // [B]
  int64_t* accepted;         // [B]
  unsigned long long* loops; // [1]
  unsigned* bitmap;          // [B, words], zero; null for the ring
  long long cap, pos_len, rows;
  int d, deg, ef, max_iters, expand, block, beam_len, ring_len, words, metric, bf16;
};

__host__ __device__ inline int take(int& at, int bytes) {
  const int here = at;
  at += (bytes + 15) & ~15;
  return here;
}

// Slots of the ring's hash of beam and ring ids: a power of two at least
// twice their count, so a probe rarely passes two slots; none for the
// bitmap.
__host__ __device__ inline int table_slots(int beam_len, int ring_len, bool bitmap) {
  if (bitmap) return 0;
  int n = 1;
  while (n < 2 * (beam_len + ring_len)) n *= 2;
  return n;
}

// Byte offsets of the CTA's dynamic shared memory.
struct Layout {
  int q, qr, bd[2], bi[2], bx[2], ring, table, cand, state, key, sd, aid, cur, scal, bytes;
  __host__ __device__ Layout(int d, int beam_len, int ring_len, int block, int expand,
                             bool bitmap) {
    int at = 0;
    q = take(at, 4 * d);
    qr = take(at, 4 * d);
    for (int p = 0; p < 2; ++p) {
      bd[p] = take(at, 4 * beam_len);
      bi[p] = take(at, 4 * beam_len);
      bx[p] = take(at, beam_len);
    }
    ring = take(at, 4 * ring_len);
    table = take(at, 4 * table_slots(beam_len, ring_len, bitmap));
    cand = take(at, 4 * block);
    state = take(at, 4 * block);
    key = take(at, 8 * block);
    sd = take(at, 4 * block);
    aid = take(at, 4 * block);
    cur = take(at, 4 * expand);
    scal = take(at, 16);
    bytes = at;
  }
};

__device__ __forceinline__ float rounded(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// ops/distance.py::inv_norms
__device__ __forceinline__ float inv_norm(float ns) {
  const float n = sqrtf(ns);
  return n > 0.f ? 1.f / fmaxf(n, 1e-30f) : 0.f;
}

// ops/hnsw_kernels.py::_from_dots, or the Manhattan sum
__device__ __forceinline__ float finish(int metric, float dot, float qn, float iq, float vn,
                                        float l1) {
  switch (metric) {
    case DOT_PRODUCT:
      return 1.f - dot;
    case COSINE:
      return 1.f - fminf(fmaxf(dot * iq * inv_norm(vn), -1.f), 1.f);
    case MANHATTAN:
      return l1;
    default: {
      const float d2 = fmaxf(qn + vn - 2.f * dot, 0.f);
      return metric == SQUARED_EUCLIDEAN ? d2 : sqrtf(d2);
    }
  }
}

// A (distance, column) key whose unsigned order is the merge's: distance
// ascending, then the lower column.
__device__ __forceinline__ unsigned long long merge_key(float dist, int col) {
  unsigned u = __float_as_uint(dist);
  u ^= (u >> 31) ? 0xffffffffu : 0x80000000u;
  return (unsigned long long)u << 32 | (unsigned)col;
}

__device__ __forceinline__ unsigned slot_of(int x, int shift) {
  return ((unsigned)x * 2654435761u) >> shift;
}

__device__ __forceinline__ void table_put(int* t, unsigned mask, int shift, int x) {
  for (unsigned h = slot_of(x, shift);; h = (h + 1) & mask) {
    const int old = atomicCAS(t + h, -1, x);
    if (old == -1 || old == x) return;
  }
}

__device__ __forceinline__ bool table_has(const int* t, unsigned mask, int shift, int x) {
  for (unsigned h = slot_of(x, shift);; h = (h + 1) & mask) {
    const int k = t[h];
    if (k == x) return true;
    if (k == -1) return false;
  }
}

// Distances from the query to rows ids[r0, min(r0 + 32 / LANES * 2, n)):
// LANES lanes a row, two rows each, their loads in flight together; the
// sums reduce within the row's lanes in a fixed order. The row's first
// lane writes its distance to out[row].
template <bool VEC4>
__device__ __forceinline__ void warp_rows(const Args& a, const float* q, const float* qr,
                                          const int* ids, int r0, int n, float qn, float iq,
                                          float* out, int lane) {
  constexpr int PER = 32 / LANES;  // rows a warp holds at once, per unroll
  const int sub = lane % LANES;
  int row[2];
  const float* src[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    row[u] = r0 + u * PER + lane / LANES;
    src[u] = a.vectors + (size_t)ids[row[u] < n ? row[u] : r0] * a.d;
  }
  float dot[2] = {0.f, 0.f}, vn[2] = {0.f, 0.f}, l1[2] = {0.f, 0.f};
  if (VEC4) {
    const int d4 = a.d / 4;
    for (int k0 = sub; k0 < d4; k0 += 4 * LANES) {
      float4 v[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (row[u] < n && k0 + i * LANES < d4)
            v[u][i] = __ldg(reinterpret_cast<const float4*>(src[u]) + k0 + i * LANES);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + i * LANES;
        if (k >= d4) break;
        const float4 x = reinterpret_cast<const float4*>(q)[k];
        const float4 xr = reinterpret_cast<const float4*>(qr)[k];
        const float xs[4] = {x.x, x.y, x.z, x.w}, xrs[4] = {xr.x, xr.y, xr.z, xr.w};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (row[u] >= n) continue;
          const float e[4] = {v[u][i].x, v[u][i].y, v[u][i].z, v[u][i].w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            dot[u] = fmaf(xrs[c], rounded(e[c], a.bf16), dot[u]);
            vn[u] = fmaf(e[c], e[c], vn[u]);
            l1[u] += fabsf(xs[c] - e[c]);
          }
        }
      }
    }
  } else {
    for (int k = sub; k < a.d; k += LANES) {
      float v[2];
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (row[u] < n) v[u] = __ldg(src[u] + k);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (row[u] >= n) continue;
        dot[u] = fmaf(qr[k], rounded(v[u], a.bf16), dot[u]);
        vn[u] = fmaf(v[u], v[u], vn[u]);
        l1[u] += fabsf(q[k] - v[u]);
      }
    }
  }
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      dot[u] += __shfl_xor_sync(FULL, dot[u], o);
      vn[u] += __shfl_xor_sync(FULL, vn[u], o);
      l1[u] += __shfl_xor_sync(FULL, l1[u], o);
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u)
    if (sub == 0 && row[u] < n) out[row[u]] = finish(a.metric, dot[u], qn, iq, vn[u], l1[u]);
}

// The number of entries of the ascending s[0, n) below x (STRICT) or at
// or below it.
template <bool STRICT>
__device__ __forceinline__ int count_below(const float* s, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (STRICT ? s[mid] < x : s[mid] <= x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <bool VEC4>
__global__ void __launch_bounds__(THREADS) beam_kernel(Args a) {
  constexpr int ROWS_AT_ONCE = 2 * 32 / LANES;  // rows a warp_rows call covers
  extern __shared__ __align__(16) unsigned char smem[];
  const bool bitmap = a.bitmap != nullptr;
  const Layout lay(a.d, a.beam_len, a.ring_len, a.block, a.expand, bitmap);
  const int slots = table_slots(a.beam_len, a.ring_len, bitmap);
  const unsigned tmask = slots - 1;
  const int tshift = 33 - __ffs(slots);  // 32 - log2(slots)
  float* q = reinterpret_cast<float*>(smem + lay.q);
  float* qr = a.bf16 ? reinterpret_cast<float*>(smem + lay.qr) : q;
  int* ring = reinterpret_cast<int*>(smem + lay.ring);
  int* table = reinterpret_cast<int*>(smem + lay.table);
  int* cand = reinterpret_cast<int*>(smem + lay.cand);
  int* state = reinterpret_cast<int*>(smem + lay.state);
  unsigned long long* key = reinterpret_cast<unsigned long long*>(smem + lay.key);
  float* sd = reinterpret_cast<float*>(smem + lay.sd);
  int* aid = reinterpret_cast<int*>(smem + lay.aid);
  int* cur = reinterpret_cast<int*>(smem + lay.cur);
  int* scal = reinterpret_cast<int*>(smem + lay.scal);  // done, selected, accepted, masked

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned* bm = bitmap ? a.bitmap + (size_t)b * a.words : nullptr;

  // the initial beam: the entry point, then MASKED fill (_beam_rows)
  const float* qg = a.queries + (size_t)b * a.d;
  for (int k = tid; k < a.d; k += THREADS) {
    const float v = qg[k];
    q[k] = v;
    if (a.bf16) qr[k] = rounded(v, 1);
  }
  for (int p = 0; p < 2; ++p) {
    float* bd = reinterpret_cast<float*>(smem + lay.bd[p]);
    int* bi = reinterpret_cast<int*>(smem + lay.bi[p]);
    uint8_t* bx = smem + lay.bx[p];
    for (int k = tid; k < a.beam_len; k += THREADS) {
      bd[k] = MASKED;
      bi[k] = -1;
      bx[k] = 0;
    }
  }
  for (int k = tid; k < a.ring_len; k += THREADS) ring[k] = -1;
  for (int k = tid; k < slots; k += THREADS) table[k] = -1;
  const long long e = a.entries[b];
  const bool e_ok = e >= 0 && e < a.cap && a.valid[e];
  if (tid == 0) aid[0] = (int)e;
  __syncthreads();
  // every thread sums the query's norm in the same order
  float qn = 0.f;
  for (int k = 0; k < a.d; ++k) qn = fmaf(q[k], q[k], qn);
  const float iq = inv_norm(qn);
  if (e_ok && warp == 0) warp_rows<VEC4>(a, q, qr, aid, 0, 1, qn, iq, sd, lane);
  __syncthreads();
  if (tid == 0 && e_ok) {
    reinterpret_cast<float*>(smem + lay.bd[0])[0] = sd[0];
    reinterpret_cast<int*>(smem + lay.bi[0])[0] = (int)e;
    if (bitmap)
      bm[e >> 5] |= 1u << (e & 31);
    else
      ring[0] = (int)e;
  }
  __syncthreads();

  const int kk = min(a.ef, a.beam_len) - 1;  // the termination test's column
  int p = 0;
  int live = e_ok ? 1 : 0;  // the beam's entries with an id: a prefix
  int it = 0;
  long long took = 0;  // the accepted candidates, whose distances were computed
  for (; it < a.max_iters; ++it) {
    float* bd = reinterpret_cast<float*>(smem + lay.bd[p]);
    int* bi = reinterpret_cast<int*>(smem + lay.bi[p]);
    uint8_t* bx = smem + lay.bx[p];
    // 1. the `expand` nearest unexpanded entries; termination reads column kk
    if (warp == 0) {
      int n = 0;
      float d0 = MASKED;
      for (int base = 0; base < live && n < a.expand; base += 32) {
        unsigned m = __ballot_sync(FULL, base + lane < live && !bx[base + lane]);
        while (m && n < a.expand) {
          const int pos = base + __ffs(m) - 1;
          m &= m - 1;
          if (n == 0) d0 = bd[pos];
          if (lane == 0) cur[n] = pos;
          ++n;
        }
      }
      const bool done = n == 0 || (kk < live && d0 > bd[kk]);
      if (lane == 0) {
        scal[0] = done;
        scal[1] = n;
        scal[2] = 0;
        if (!done) {
          for (int s = 0; s < n; ++s) {
            bx[cur[s]] = 1;
            cur[s] = bi[cur[s]];
          }
        }
      }
    }
    __syncthreads();
    if (scal[0]) break;
    const int nsel = scal[1];

    // 2. the neighbour rows of the expanded entries; the ring's hash of the
    // beam's and the ring's ids (cleared in step 4 of the last iteration).
    // scal[3] is zeroed here, past the barrier that every read of the last
    // iteration's count precedes, the reads of a skipped merge included
    if (tid == 0) scal[3] = 0;
    for (int j = tid; j < a.block; j += THREADS) {
      int nb = -1;
      const int s = j / a.deg;
      if (s < nsel) {
        const long long id = cur[s];
        const long long row = id < a.pos_len ? a.pos_map[id] : -1;
        if (row >= 0 && row < a.rows) nb = a.adj[row * a.deg + (j - s * a.deg)];
      }
      cand[j] = nb;
      state[j] = nb >= 0 && nb < a.cap && a.valid[nb] ? PENDING : REJECT;
    }
    if (!bitmap) {
      for (int k = tid; k < live; k += THREADS) table_put(table, tmask, tshift, bi[k]);
      for (int k = tid; k < a.ring_len; k += THREADS)
        if (ring[k] >= 0) table_put(table, tmask, tshift, ring[k]);
    }
    __syncthreads();

    // 3. refuse a repeat of an earlier column, then the visited; list the rest
    for (int j0 = 0; j0 < a.block; j0 += THREADS) {
      const int j = j0 + tid;
      bool take_it = false;
      if (j < a.block && state[j] == PENDING) {
        const int x = cand[j];
        bool seen = false;
        const int4* c4 = reinterpret_cast<const int4*>(cand);
        for (int k = 0; k < (j + 3) / 4; ++k) {
          const int4 v = c4[k];
          seen |= (v.x == x) | (v.y == x && 4 * k + 1 < j) | (v.z == x && 4 * k + 2 < j) |
                  (v.w == x && 4 * k + 3 < j);
        }
        if (!seen)
          seen = bitmap ? (__ldcg(bm + (x >> 5)) >> (x & 31) & 1u) != 0
                        : table_has(table, tmask, tshift, x);
        take_it = !seen;
        state[j] = take_it ? ACCEPT : REJECT;
      }
      const unsigned got = __ballot_sync(FULL, take_it);
      int at = 0;
      if (lane == 0 && got) at = atomicAdd(&scal[2], __popc(got));
      at = __shfl_sync(FULL, at, 0) + __popc(got & ((1u << lane) - 1));
      if (take_it) {
        aid[at] = cand[j];
        key[at] = j;  // the column, until step 4 adds the distance
      }
    }
    __syncthreads();

    // 4. the ring's slot of this iteration (or the bitmap's bits), the
    // hash cleared for the next iteration, the distances of the accepted,
    // then their merge keys (the count of distances past MASKED_DIST in
    // scal[3])
    const int m = scal[2];
    took += m;
    const int offset = (int)((long long)it * a.block % a.ring_len);
    for (int j = tid; j < a.block; j += THREADS) {
      const bool ok = state[j] == ACCEPT;
      if (bitmap) {
        if (ok) atomicOr(bm + (cand[j] >> 5), 1u << (cand[j] & 31));
      } else {
        ring[offset + j] = ok ? cand[j] : -1;
      }
    }
    for (int k = tid; k < slots; k += THREADS) table[k] = -1;
    for (int r0 = warp * ROWS_AT_ONCE; r0 < m; r0 += WARPS * ROWS_AT_ONCE)
      warp_rows<VEC4>(a, q, qr, aid, r0, m, qn, iq, sd, lane);
    __syncthreads();
    for (int c = tid; c < m; c += THREADS) {
      const bool f = sd[c] < MASKED;  // a distance past MASKED_DIST goes in as masked
      key[c] = merge_key(f ? sd[c] : MASKED, (int)key[c]);
      if (!f) atomicAdd(&scal[3], 1);
    }
    __syncthreads();

    // 5. merge into the other buffer, as a stable sort of cat([beam, block]):
    // each accepted candidate goes after the beam entries at or below its
    // distance and the candidates of lower keys; each beam entry moves down
    // by the candidates strictly below it
    const int fin = m - scal[3];
    if (fin == 0) continue;  // the beam is as it was (uniform)
    const int np = p ^ 1;
    float* nbd = reinterpret_cast<float*>(smem + lay.bd[np]);
    int* nbi = reinterpret_cast<int*>(smem + lay.bi[np]);
    uint8_t* nbx = smem + lay.bx[np];
    for (int c = tid; c < m; c += THREADS) {
      const unsigned long long kc = key[c];
      int rank = 0;
#pragma unroll 8
      for (int o = 0; o < m; ++o) rank += key[o] < kc;
      const unsigned u = (unsigned)(kc >> 32);
      const float dc = __uint_as_float(u ^ ((u >> 31) ? 0x80000000u : 0xffffffffu));
      sd[rank] = dc;  // the accepted distances, sorted
      const int out = rank + count_below<false>(bd, live, dc);
      if (out < a.beam_len) {
        const bool f = dc < MASKED;
        nbd[out] = f ? dc : MASKED;
        nbi[out] = f ? aid[c] : -1;
        nbx[out] = 0;
      }
    }
    __syncthreads();
    for (int k = tid; k < live; k += THREADS) {
      const int out = k + count_below<true>(sd, m, bd[k]);
      if (out < a.beam_len) {
        nbd[out] = bd[k];
        nbi[out] = bi[k];
        nbx[out] = bx[k];
      }
    }
    live = min(live + fin, a.beam_len);
    p = np;
    __syncthreads();
  }

  // the first ef entries, the active iterations, the accepted candidates
  // and the loop's length
  const float* bd = reinterpret_cast<const float*>(smem + lay.bd[p]);
  const int* bi = reinterpret_cast<const int*>(smem + lay.bi[p]);
  for (int j = tid; j < a.ef; j += THREADS) {
    a.out_d[(size_t)b * a.ef + j] = bd[j];
    a.out_i[(size_t)b * a.ef + j] = bi[j];
  }
  if (tid == 0) {
    a.iters[b] = it;
    a.accepted[b] = took;
    atomicMax(a.loops, (unsigned long long)(it < a.max_iters ? it + 1 : a.max_iters));
  }
}

// ---------------------------------------------------------------------------
// The greedy descent through the upper layers (ops/hnsw_kernels.py::descend).
//
// It replaces no Pallas kernel: the reference's greedy_descent
// (quiver_tpu/ops/hnsw_kernels.py:294-338) is an XLA lax.while_loop, run
// once a layer, and the port ran it as some 13 torch ops a step over every
// row of the batch, rows that had stopped included, with a host read of
// "any query moved" every four steps: ~430 launches a layer, ten upper
// layers a search, the card waiting on the host most of the time. It
// computes what descend's chain of greedy_descent calls computes, layer by
// layer, top first, each layer from where the one above stopped:
//   * the layer's entry is (entry >= 0) & valid[entry], its distance
//     recomputed; else the distance is MASKED_DIST and the id -1;
//   * a step reads row = pos_map[max(ci, 0)] (the clamp of -1 to slot 0
//     stays, as in the reference), then adj[max(row, 0)]; a neighbour is ok
//     where row >= 0, nbr >= 0 and valid[nbr], and a column that is not ok
//     counts as MASKED_DIST;
//   * the distances by _from_dots' formula (norms from the f32 values,
//     products of the compute dtype's values as IEEE f32 FMAs: the beam's
//     finish), Manhattan the direct sum;
//   * the argmin by a (distance, column) key: on equal distances the lower
//     column, as torch.min(dim=1) and jnp.argmin choose;
//   * the query moves only where that distance is strictly below its own,
//     and stops the layer at its first step with no move, or after
//     max_iters steps. The torch loop tests "any moved" every four steps;
//     a query that stopped never moves again, so the results are the same.
//
// What bounds it on an H100. Each step is a chain of dependent random reads:
// pos_map (8 bytes), the adjacency row (64 bytes at m = 16), then the
// valid bytes and the rows of the neighbours (512 bytes each at d = 128),
// mostly from L2 (the ~66K upper-layer nodes of the 1M graph hold ~34 MB of
// rows). Tensor cores have nothing to do, and the bytes are few: the
// longest query's chain of steps sets the time.
//
// The design: one warp a query, looping on the card through every layer of
// the launch (four queries to a CTA of 128 threads, no block barrier, so
// 2,048 queries are one wave of 512 CTAs). A step has all its neighbours'
// rows in flight at once: 32 / P lanes a neighbour, P the layer's degree
// rounded up to a power of two (at most 32 columns a pass, more passes for
// a wider row), every load of a lane issued before its sums, the sums
// reduced within the lanes of a neighbour by shuffles in a fixed order,
// then the argmin over the warp by shuffles of the key. The query (and its
// compute-dtype copy) sits in shared memory, d floats each a warp. The
// layer table (each layer's adj and pos_map pointers, rows and degree)
// travels in the kernel's parameters, by value, at most LAYERS_MAX layers
// a launch; a deeper graph runs further launches, each from the last one's
// ids, so no call copies anything from the host or reads anything back.

constexpr int LAYERS_MAX = 16;  // HNSWConfig.max_level's default
constexpr int IN_FLIGHT = 16;   // loads of a row a lane issues before its sums

struct DescentLayer {
  const int* adj;          // [rows, deg]
  const int64_t* pos_map;  // [pos_len]
  long long rows, pos_len;
  int deg;
};

struct DescentArgs {
  const float* queries;    // [B, d]
  const int64_t* entries;  // [B] the top layer's entries
  const float* vectors;    // [cap, d]
  const uint8_t* valid;    // [cap]
  float* out_d;            // [B]
  int64_t* out_i;          // [B]
  int64_t* steps;          // [B]
  long long cap;
  int B, d, n_layers, max_iters, metric, bf16, accumulate;
  DescentLayer layers[LAYERS_MAX];
};

// The distance from the query to row `id`, summed by the L lanes of a
// neighbour (this lane the `sub`-th of them): every load of the lane in
// flight before its sums, then a shuffle reduce within the L lanes in a
// fixed order. Where `live` is false the lane loads nothing and its result
// is not used; every lane of the warp calls it (the shuffles).
template <bool VEC4, int L>
__device__ __forceinline__ float group_distance(const DescentArgs& a, const float* q,
                                                const float* qr, int id, bool live, float qn,
                                                float iq, int sub) {
  const float* src = a.vectors + (size_t)id * a.d;
  float dot = 0.f, vn = 0.f, l1 = 0.f;
  if (VEC4) {
    const int d4 = a.d / 4;
    for (int k0 = sub; k0 < d4; k0 += IN_FLIGHT * L) {
      float4 v[IN_FLIGHT];
      const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
      for (int i = 0; i < IN_FLIGHT; ++i)
        if (live && k0 + i * L < d4) v[i] = __ldg(s4 + k0 + i * L);
#pragma unroll
      for (int i = 0; i < IN_FLIGHT; ++i) {
        const int k = k0 + i * L;
        if (!live || k >= d4) break;
        const float4 x = reinterpret_cast<const float4*>(q)[k];
        const float4 xr = reinterpret_cast<const float4*>(qr)[k];
        const float xs[4] = {x.x, x.y, x.z, x.w}, xrs[4] = {xr.x, xr.y, xr.z, xr.w};
        const float e[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          dot = fmaf(xrs[c], rounded(e[c], a.bf16), dot);
          vn = fmaf(e[c], e[c], vn);
          l1 += fabsf(xs[c] - e[c]);
        }
      }
    }
  } else {
    for (int k0 = sub; k0 < a.d; k0 += IN_FLIGHT * L) {
      float v[IN_FLIGHT];
#pragma unroll
      for (int i = 0; i < IN_FLIGHT; ++i)
        if (live && k0 + i * L < a.d) v[i] = __ldg(src + k0 + i * L);
#pragma unroll
      for (int i = 0; i < IN_FLIGHT; ++i) {
        const int k = k0 + i * L;
        if (!live || k >= a.d) break;
        dot = fmaf(qr[k], rounded(v[i], a.bf16), dot);
        vn = fmaf(v[i], v[i], vn);
        l1 += fabsf(q[k] - v[i]);
      }
    }
  }
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) {
    dot += __shfl_xor_sync(FULL, dot, o);
    vn += __shfl_xor_sync(FULL, vn, o);
    l1 += __shfl_xor_sync(FULL, l1, o);
  }
  return finish(a.metric, dot, qn, iq, vn, l1);
}

// One layer's greedy walk of the warp's query (greedy_descent) from the
// layer's entry `ci`: at most max_iters steps, each over the row of ci's
// neighbours, 32 / L columns a pass. `steps` counts the steps taken, the
// one that found no better neighbour included.
template <bool VEC4, int L>
__device__ __forceinline__ void walk(const DescentArgs& a, const DescentLayer& g,
                                     const float* q, const float* qr, float qn, float iq,
                                     int lane, int& ci, float& cd, long long& steps) {
  constexpr int P = 32 / L;  // columns a pass
  const int col0 = lane / L, sub = lane % L;
  const bool e_ok = ci >= 0 && ci < a.cap && __ldg(a.valid + ci);
  const float e_dist = group_distance<VEC4, L>(a, q, qr, e_ok ? ci : 0, e_ok, qn, iq, sub);
  cd = e_ok ? e_dist : MASKED;
  ci = e_ok ? ci : -1;
  for (int it = 0; it < a.max_iters; ++it) {
    ++steps;
    const int c = max(ci, 0);
    long long row =
        c < g.pos_len ? __ldg(reinterpret_cast<const long long*>(g.pos_map) + c) : -1;
    if (row >= g.rows) row = -1;
    const int* nbrs = g.adj + (size_t)max(row, 0LL) * g.deg;
    unsigned long long best = ~0ull;
    int best_id = -1;
    for (int c0 = 0; c0 < g.deg; c0 += P) {
      const int col = c0 + col0;
      const int nb = col < g.deg ? __ldg(nbrs + col) : -1;
      const bool in = nb >= 0 && nb < a.cap;
      // the row's loads go out beside the valid byte's
      const bool ok = row >= 0 && in && __ldg(a.valid + (in ? nb : 0));
      const float dist = group_distance<VEC4, L>(a, q, qr, in ? nb : 0, in, qn, iq, sub);
      const unsigned long long key =
          col < g.deg ? merge_key(ok ? dist : MASKED, col) : ~0ull;
      if (key < best) {
        best = key;
        best_id = nb;
      }
    }
    // the argmin over the warp's neighbours: the lower key, so on equal
    // distances the lower column
#pragma unroll
    for (int o = 16; o >= L; o >>= 1) {
      const unsigned long long k2 = __shfl_xor_sync(FULL, best, o);
      const int i2 = __shfl_xor_sync(FULL, best_id, o);
      if (k2 < best) {
        best = k2;
        best_id = i2;
      }
    }
    const unsigned u = (unsigned)(best >> 32);
    const float best_d = __uint_as_float(u ^ ((u >> 31) ? 0x80000000u : 0xffffffffu));
    if (!(best_d < cd)) break;
    cd = best_d;
    ci = best_id;
  }
}

// Lanes a neighbour at degree `deg`: 32 over deg rounded up to a power of
// two, at least one.
__device__ __forceinline__ int lanes_for(int deg) {
  int p = 1;
  while (p < deg && p < 32) p *= 2;
  return 32 / p;
}

template <bool VEC4>
__global__ void __launch_bounds__(THREADS) descent_kernel(const __grid_constant__ DescentArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= a.B) return;  // the whole warp: no barrier follows
  float* q = reinterpret_cast<float*>(smem) + (size_t)warp * a.d * (a.bf16 ? 2 : 1);
  float* qr = a.bf16 ? q + a.d : q;
  const float* qg = a.queries + (size_t)b * a.d;
  for (int k = lane; k < a.d; k += 32) {
    const float v = qg[k];
    q[k] = v;
    if (a.bf16) qr[k] = rounded(v, 1);
  }
  __syncwarp();
  // every lane sums the query's norm in the same order (the beam's)
  float qn = 0.f;
  for (int k = 0; k < a.d; ++k) qn = fmaf(q[k], q[k], qn);
  const float iq = inv_norm(qn);

  const long long e = a.entries[b];
  int ci = e >= 0 && e < a.cap ? (int)e : -1;
  float cd = MASKED;
  long long steps = 0;
  for (int l = 0; l < a.n_layers; ++l) {
    const DescentLayer& g = a.layers[l];
    switch (lanes_for(g.deg)) {
      case 32: walk<VEC4, 32>(a, g, q, qr, qn, iq, lane, ci, cd, steps); break;
      case 16: walk<VEC4, 16>(a, g, q, qr, qn, iq, lane, ci, cd, steps); break;
      case 8: walk<VEC4, 8>(a, g, q, qr, qn, iq, lane, ci, cd, steps); break;
      case 4: walk<VEC4, 4>(a, g, q, qr, qn, iq, lane, ci, cd, steps); break;
      case 2: walk<VEC4, 2>(a, g, q, qr, qn, iq, lane, ci, cd, steps); break;
      default: walk<VEC4, 1>(a, g, q, qr, qn, iq, lane, ci, cd, steps); break;
    }
  }
  if (lane == 0) {
    a.out_d[b] = cd;
    a.out_i[b] = ci;
    a.steps[b] = (a.accumulate ? a.steps[b] : 0) + steps;
  }
}

__host__ __device__ inline int descent_smem_bytes(int d, int bf16) {
  return WARPS * 4 * d * (bf16 ? 2 : 1);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA, in bytes; above hnsw_beam_smem_max()
// the kernel cannot run (ops/hnsw_cuda.py raises before the launch).
int hnsw_beam_smem_bytes(int d, int beam_len, int ring_len, int block, int expand,
                         int bitmap) {
  return Layout(d, beam_len, ring_len, block, expand, bitmap != 0).bytes;
}

int hnsw_beam_smem_max() { return SMEM_MAX; }

// Returns the cudaError_t of the launch (0 = queued). One CTA per query of
// B; all pointers on `device`; out_d f32[B, ef], out_i i64[B, ef], iters
// and accepted i64[B] (each query's active iterations and the candidates
// whose distances it computed); loops u64[1] takes the atomic max of each
// query's loop length; bitmap is u32[B, words] and zero, or null for the
// ring. The sizes are ops/hnsw_kernels.py::beam_sizes'.
int hnsw_beam(const float* queries, const int64_t* entries, const float* vectors,
              const uint8_t* valid, const int* adj, const int64_t* pos_map, float* out_d,
              int64_t* out_i, int64_t* iters, int64_t* accepted, unsigned long long* loops,
              unsigned* bitmap, long long cap, long long pos_len, long long rows, int B,
              int d, int deg, int ef, int max_iters, int expand, int block, int beam_len,
              int ring_len, int words, int metric, int bf16, int device, void* stream) {
  if (B <= 0) return 0;
  if (d <= 0 || deg <= 0 || expand <= 0 || block < deg * expand || ef <= 0 ||
      ef > beam_len || ring_len % block || metric < 0 || metric > MANHATTAN)
    return (int)cudaErrorInvalidValue;
  const Layout lay(d, beam_len, ring_len, block, expand, bitmap != nullptr);
  if (lay.bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const Args a{queries, entries, vectors, valid, adj, pos_map, out_d, out_i, iters, accepted,
               loops, bitmap, cap, pos_len, rows, d, deg, ef, max_iters, expand, block, beam_len,
               ring_len, words, metric, bf16};
  const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(vectors) % 16 == 0;
  auto kernel = vec4 ? beam_kernel<true> : beam_kernel<false>;
  if (lay.bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B, THREADS, lay.bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one descent CTA (four queries), in bytes; above
// hnsw_beam_smem_max() the kernel cannot run.
int hnsw_descent_smem_bytes(int d, int bf16) { return descent_smem_bytes(d, bf16); }

// Layers one hnsw_descent launch takes (ops/hnsw_cuda.py chains launches
// past it).
int hnsw_descent_layers_max() { return LAYERS_MAX; }

// Returns the cudaError_t of the launch (0 = queued). One warp per query of
// B, four to a CTA; all pointers on `device`. The layers, top first, are
// host arrays of n_layers (1 to LAYERS_MAX) entries: adj[l] an i32[rows[l],
// deg[l]] adjacency, pos_map[l] an i64[pos_len[l]] slot -> row map; they
// are copied into the kernel's parameters. entries i64[B] start the first
// layer; out_d f32[B] and out_i i64[B] take each query's final distance and
// id (out_i may be entries: each warp reads its entry before it writes);
// steps i64[B] takes each query's steps over these layers, added to what it
// holds where `accumulate` is set.
int hnsw_descent(const float* queries, const int64_t* entries, const float* vectors,
                 const uint8_t* valid, const void* const* adj, const void* const* pos_map,
                 const long long* rows, const long long* pos_len, const int* deg, int n_layers,
                 float* out_d, int64_t* out_i, int64_t* steps, long long cap, int B, int d,
                 int max_iters, int metric, int bf16, int accumulate, int device,
                 void* stream) {
  if (B <= 0) return 0;
  if (d <= 0 || n_layers <= 0 || n_layers > LAYERS_MAX || max_iters < 0 || metric < 0 ||
      metric > MANHATTAN)
    return (int)cudaErrorInvalidValue;
  DescentArgs a{queries, entries, vectors, valid, out_d, out_i, steps, cap, B, d, n_layers,
                max_iters, metric, bf16, accumulate, {}};
  for (int l = 0; l < n_layers; ++l) {
    if (deg[l] <= 0 || rows[l] <= 0) return (int)cudaErrorInvalidValue;
    a.layers[l] = DescentLayer{static_cast<const int*>(adj[l]),
                               static_cast<const int64_t*>(pos_map[l]), rows[l], pos_len[l],
                               deg[l]};
  }
  const int smem = descent_smem_bytes(d, bf16);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(vectors) % 16 == 0;
  auto kernel = vec4 ? descent_kernel<true> : descent_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(B + WARPS - 1) / WARPS, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
