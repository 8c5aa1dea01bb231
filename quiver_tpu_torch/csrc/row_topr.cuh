// Row mode's running top-R, shared by the two block_topw kernels
// (csrc/ivf_block_topw.cu over bf16 blocks, csrc/ivf_block_topw_f32.cu over
// f32 ones): the per-pair top-R branch of the reference
// (quiver_tpu/ops/ivf_kernels.py:716-728, lax.top_k(scores, R) over a
// pair's whole row after ragged_dot), kept inside the kernel for
// R <= ROW_RMAX.
//
// Each kernel's epilogue stages a slab's 128 keys per row in shared memory
// (a warp's 16 rows are its own), releases the ring stage, and then the warp
// walks its rows four at a time: each half-warp takes two rows (ROW_NR), 8
// keys a lane, as independent chains that hide each other's latency. A row
// keeps a running list of C = 16 * E >= R keys in shared memory (E entries
// a lane; C in {32, 64, 112, 128}), sorted descending; its entry R-1 is the
// row's threshold. Each half compares its rows' keys with their thresholds
// and counts those above with __ballot_sync; the largest count of the
// warp's four rows picks the path, so the warp stays converged:
//   * none: the rows are done. This is the common case after the first
//     slabs at small R: over n keys in random order about R(1 + ln(n/R))
//     ever enter;
//   * up to row_ins_max: the survivors are packed into the front of the
//     staged row and inserted one by one, each by a shift of the list (one
//     shuffle for the entry that crosses lanes);
//   * more: the half sorts each row's 128 keys, a bitonic network over 8
//     keys a lane (its three lowest levels need no shuffle), and merges
//     them with the list: the larger of list[i] and slab[127 - i] is a
//     bitonic sequence that holds the top 128 of both, and seven
//     half-cleaner stages sort it. The first C stay. On a row's first slab
//     the list is empty and the sorted keys become the list.
// The staged row may hold its keys in any order (the kernels swizzle their
// staging stores to keep them free of bank conflicts).
// Entries from R to C-1 trail the exact order (keys at or below the
// threshold are not inserted); entries 0..R-1 are the exact top R, in
// descending order. Keys within a row are distinct (the column rides in the
// low bits), so no tie rule is needed. The sentinel must lie below every
// key (KEY_MIN): the list starts full of it and a key enters only above the
// threshold. tests/test_torch_row_topr.py emulates the merge lane by lane.

#pragma once

#include <stdint.h>

namespace {

constexpr int ROW_RMAX = 128;                // the largest R kept in the kernel
constexpr int ROW_KEYS = 128;                // a slab's keys per row
constexpr int ROW_KPL = 8;                   // keys per lane: a half-warp per row
// rows each half-warp merges at once: independent chains that hide each
// other's latency (measured on an H100, benches/row_topr_ab.py: 10-20%
// faster than one over bf16 blocks, as fast over f32 ones but at R = 128)
constexpr int ROW_NR = 2;

// list entries per lane of a half-warp for a given R: C = 16 * row_epl(R)
// >= R. The 112-entry band (R <= 112, the k=100 requests) leaves room for
// two blocks per SM where 128 entries do not.
__host__ __device__ constexpr int row_epl(int r) {
  return r <= 32 ? 2 : r <= 64 ? 4 : r <= 112 ? 7 : 8;
}

// survivors of a slab row inserted one by one, by list width E and the
// kernel's blocks (f32: true), above which the rows sort and merge. An
// insert's cost grows with E, a sort's does not; the f32 kernel, whose
// products keep the warp schedulers busy, gains from inserting more at
// E = 7 (measured on an H100: benches/row_topr_ab.py against checkouts
// with other cuts).
__host__ __device__ constexpr int row_ins_max(int e, bool f32) {
  return e <= 4 ? 48 : e == 7 && f32 ? 64 : 24;
}

// N consecutive ints as vector accesses where N allows (16-byte aligned
// for N % 4 == 0, 8-byte for N = 2), else one by one
template <int N>
__device__ __forceinline__ void ld_ints(int (&a)[N], const int* __restrict__ p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const int4 t = reinterpret_cast<const int4*>(p)[q];
      a[4 * q] = t.x, a[4 * q + 1] = t.y, a[4 * q + 2] = t.z, a[4 * q + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const int2 t = *reinterpret_cast<const int2*>(p);
    a[0] = t.x, a[1] = t.y;
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) a[q] = p[q];
  }
}

template <int N>
__device__ __forceinline__ void st_ints(int* __restrict__ p, const int (&a)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<int4*>(p)[q] =
          make_int4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(a[0], a[1]);
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) p[q] = a[q];
  }
}

// One compare-exchange stage of a bitonic network over a half-warp's 128
// keys, 8 a lane (key i = 8t + j in v[j], t the lane within the half), on
// NR independent rows at once: partners at distance S; blocks of K keys
// sorted descending where i & K is 0 and ascending elsewhere, so K = 128
// sorts all of them descending. Partners 8 or more apart are in another
// lane of the same half.
template <int K, int S, int NR>
__device__ __forceinline__ void bitonic_stage(int (&v)[NR][ROW_KPL], int t) {
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    if constexpr (S >= ROW_KPL) {
#pragma unroll
      for (int j = 0; j < ROW_KPL; ++j) {
        const int o = __shfl_xor_sync(0xFFFFFFFFu, v[q][j], S / ROW_KPL);
        const int i = ROW_KPL * t + j;
        const bool desc = (i & K) == 0, lower = (i & S) == 0;
        v[q][j] = desc == lower ? max(v[q][j], o) : min(v[q][j], o);
      }
    } else {
#pragma unroll
      for (int j = 0; j < ROW_KPL; ++j) {
        if (j & S) continue;
        const bool desc = ((ROW_KPL * t + j) & K) == 0;
        const int hi = max(v[q][j], v[q][j | S]), lo = min(v[q][j], v[q][j | S]);
        v[q][j] = desc ? hi : lo;
        v[q][j | S] = desc ? lo : hi;
      }
    }
  }
}

// the half-cleaner stages S, S/2, ..., 1 of a K-block merge
template <int K, int S, int NR>
__device__ __forceinline__ void bitonic_merge(int (&v)[NR][ROW_KPL], int t) {
  bitonic_stage<K, S>(v, t);
  if constexpr (S > 1) bitonic_merge<K, S / 2>(v, t);
}

// sort the 128 keys descending: merges of blocks of K, 2K, ..., 128
template <int K = 2, int NR>
__device__ __forceinline__ void bitonic_sort(int (&v)[NR][ROW_KPL], int t) {
  bitonic_merge<K, K / 2>(v, t);
  if constexpr (K < ROW_KEYS) bitonic_sort<2 * K>(v, t);
}

// Insert a key into a descending list held E entries a lane of a half
// (entry E * t + j in a[j]): the entries above the key stay, the key takes
// the first place below them and the rest move down one; the last drops
// off. A key at or below every entry (the sentinel) changes nothing.
template <int E>
__device__ __forceinline__ void row_insert(int (&a)[E], int key, int t) {
  const int up = __shfl_up_sync(0xFFFFFFFFu, a[E - 1], 1, 16);  // entry E * t - 1
#pragma unroll
  for (int j = E - 1; j >= 0; --j) {
    const int prev = j > 0 ? a[j - 1] : up;
    const bool prev_above = (j == 0 && t == 0) || prev > key;
    a[j] = a[j] > key ? a[j] : (prev_above ? key : prev);
  }
}

// Fill a warp's `rows` running lists of C entries with the sentinel.
template <int C>
__device__ __forceinline__ void row_init(int* __restrict__ lists, int rows, int sentinel,
                                         int lane) {
  for (int e = lane; e < rows * C; e += 32) lists[e] = sentinel;
  __syncwarp();
}

// Merge 2 * NR staged slab rows (128 keys each in any order, 16-byte
// aligned; keys past Cmax are the sentinel) into their running lists of
// C = 16 * E entries, whose top r_keep (<= C) are kept exact: each half-warp
// takes NR rows (keys[q], list[q]), independent chains that hide each
// other's latency. `first`: the rows' first slab (their lists hold only
// the sentinel); `ins_max`: the largest survivor count inserted one by one
// (row_ins_max). The whole warp calls it; the largest count of its 2 * NR
// rows picks the path.
template <int E, int NR>
__device__ __forceinline__ void row_merge(int* const (&keys)[NR], int* const (&list)[NR],
                                          int r_keep, int sentinel, bool first, int ins_max,
                                          int lane) {
  constexpr int C = 16 * E;
  const int t = lane & 15;
  const unsigned half = lane < 16 ? 0x0000FFFFu : 0xFFFF0000u;
  int thr[NR], v[NR][ROW_KPL], n[NR];
  unsigned above[NR][ROW_KPL];
  int n_max = 0;
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    thr[q] = list[q][r_keep - 1];
    // this lane's keys: 4t.. and 64 + 4t.. (a conflict-free pair of int4
    // loads); a sort takes them in any order
    int a[4], b[4];
    ld_ints<4>(a, keys[q] + 4 * t);
    ld_ints<4>(b, keys[q] + 64 + 4 * t);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[q][j] = a[j], v[q][4 + j] = b[j];
    int n_lo = 0, n_hi = 0;
#pragma unroll
    for (int j = 0; j < ROW_KPL; ++j) {
      above[q][j] = __ballot_sync(0xFFFFFFFFu, v[q][j] > thr[q]);
      n_lo += __popc(above[q][j] & 0x0000FFFFu);
      n_hi += __popc(above[q][j] & 0xFFFF0000u);
    }
    n[q] = lane < 16 ? n_lo : n_hi;
    n_max = max(n_max, max(n_lo, n_hi));
  }
  if (n_max == 0) return;
  if (n_max <= ins_max) {
    // pack each half's survivors into the front of its staged row, in
    // (j, lane) order, then insert them one by one
    const unsigned below = half & ((1u << lane) - 1u);
    __syncwarp();  // every lane has read its keys
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      int base = 0;
#pragma unroll
      for (int j = 0; j < ROW_KPL; ++j) {
        if (v[q][j] > thr[q]) keys[q][base + __popc(above[q][j] & below)] = v[q][j];
        base += __popc(above[q][j] & half);
      }
    }
    int a[NR][E];
#pragma unroll
    for (int q = 0; q < NR; ++q) ld_ints<E>(a[q], list[q] + E * t);
    __syncwarp();  // the packed survivors are written
    for (int s = 0; s < n_max; ++s) {
#pragma unroll
      for (int q = 0; q < NR; ++q) row_insert<E>(a[q], s < n[q] ? keys[q][s] : sentinel, t);
    }
    __syncwarp();  // every lane has read the lists' thresholds
#pragma unroll
    for (int q = 0; q < NR; ++q) st_ints<E>(list[q] + E * t, a[q]);
    return;
  }
  bitonic_sort(v, t);
  if (first) {  // the lists are empty: the sorted keys take their place
    __syncwarp();  // every lane has read the lists' thresholds
#pragma unroll
    for (int q = 0; q < NR; ++q)
      if (ROW_KPL * t < C) st_ints<ROW_KPL>(list[q] + ROW_KPL * t, v[q]);
    return;
  }
  // each list as 128 entries, 8 a lane (past C: the sentinel), against
  // its sorted slab reversed: max(list[i], slab[127 - i])
  int w[NR][ROW_KPL];
  const int mirror = (lane & 16) | (15 - t);  // this half's lane 15 - t
#pragma unroll
  for (int q = 0; q < NR; ++q) {
#pragma unroll
    for (int j = 0; j < ROW_KPL; ++j) w[q][j] = sentinel;
    if (ROW_KPL * t < C) ld_ints<ROW_KPL>(w[q], list[q] + ROW_KPL * t);
#pragma unroll
    for (int j = 0; j < ROW_KPL; ++j)
      w[q][j] = max(w[q][j], __shfl_sync(0xFFFFFFFFu, v[q][ROW_KPL - 1 - j], mirror));
  }
  bitonic_merge<ROW_KEYS, ROW_KEYS / 2>(w, t);
  __syncwarp();  // every lane has read the lists
#pragma unroll
  for (int q = 0; q < NR; ++q)
    if (ROW_KPL * t < C) st_ints<ROW_KPL>(list[q] + ROW_KPL * t, w[q]);
}

// Write the row's top r_keep to dst, lane p holding the p-th best.
__device__ __forceinline__ void row_store(int* __restrict__ dst, const int* __restrict__ list,
                                          int r_keep, int lane) {
  for (int p = lane; p < r_keep; p += 32) dst[p] = list[p];
}

}  // namespace
