// Top-k machinery shared by K1 (distance_topk.cu) and K2
// (distance_topk_q8.cu): warp-level sorts and merges of (dist, id) lists
// held in registers, the per-query flush of a candidate buffer into a
// running list, and the kernel that merges per-chunk lists.
//
// What bounds the selection is latency: a flush or a sort is a chain of
// dependent shuffles and device-memory round trips on one warp, and a warp
// owns 16 queries.  The scans' time split (PERF.md) put 40-60% of K2 and
// 30-50% of K1 in the chunk end and the merge, where every (query, chunk)
// list was sorted, padded to K, written, and then merged list by list.
//
// A running list is a query's k_pad best (dist, id) pairs of one corpus
// chunk.  It lives in device memory, in the chunk's own slot of the partial
// output (so it takes no shared memory and the query tile does not shrink
// as k_pad grows), and is touched only by a flush, which the one warp that
// owns the query does alone, 32 candidates at a time:
//  * fill: while the list holds fewer than K pairs, the candidates, sorted
//    across the lanes with shuffles, are appended; the append that fills it
//    sorts it (a bitonic sort of K / 32 registers a lane) and its last
//    entry becomes the query's threshold;
//  * merge: the list is loaded into registers, its last 32 slots take the
//    elementwise min against the reversed candidates (a bitonic sequence
//    that holds the K best), and one bitonic cleaner sorts it.
// At the end of a chunk a list is left sorted (a list of several pieces is
// sorted there; one piece, or a full list, is already) and unpadded: the
// scan writes its count, and the chunk merge takes from each list only the
// prefix at or below the query's bound, K entries at a time.  With one
// chunk the list is the answer, so it is sorted and padded where it lies.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace topk {

constexpr unsigned FULL = 0xffffffffu;
constexpr int CB = 32;  // candidate slots per query: one per lane

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// The order of every list: by distance, ties by id.  A total order makes
// the result the same in every run, whichever chunk admits a tied pair first.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  return a < b || (a == b && ia < ib);
}

__device__ __forceinline__ void cmp_swap(float* d, int* id, int i, int j, bool asc) {
  float di = d[i], dj = d[j];
  if (asc ? before(dj, id[j], di, id[i]) : before(di, id[i], dj, id[j])) {
    d[i] = dj;
    d[j] = di;
    int t = id[i];
    id[i] = id[j];
    id[j] = t;
  }
}

// lane's slot against lane ^ stride's: keep the smaller if (lower == up)
__device__ __forceinline__ void exch(float& v, int& id, int stride, bool up, int lane) {
  const float ov = __shfl_xor_sync(FULL, v, stride);
  const int oi = __shfl_xor_sync(FULL, id, stride);
  const bool lower = (lane & stride) == 0;
  if (lower == up ? before(ov, oi, v, id) : before(v, id, ov, oi)) {
    v = ov;
    id = oi;
  }
}

// Ascending bitonic sort of one (dist, id) pair per lane across the warp.
__device__ __forceinline__ void warp_sort32(float& v, int& id, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      exch(v, id, stride, (lane & size) == 0, lane);
    }
  }
}

// A list of 32 E (dist, id) pairs held by a warp in registers: entry
// r * 32 + lane is lane's slot r.  All loops below unroll, so the slots stay
// in registers.

// One bitonic stage over the list: pairs (i, i + STRIDE), ascending where
// i & SIZE == 0.  SIZE and STRIDE are template arguments so that every slot
// index is a constant and the list stays in registers.
template <int E, int SIZE, int STRIDE>
__device__ __forceinline__ void stage(float (&v)[E], int (&id)[E], int lane) {
  if constexpr (STRIDE >= 32) {
    constexpr int RS = STRIDE / 32;
#pragma unroll
    for (int r = 0; r < E; ++r) {
      if ((r & RS) || r + RS >= E) continue;
      const bool up = ((r * 32) & SIZE) == 0;
      float& a = v[r];
      float& b = v[r + RS];
      if (up ? before(b, id[r + RS], a, id[r]) : before(a, id[r], b, id[r + RS])) {
        const float tv = a;
        a = b;
        b = tv;
        const int ti = id[r];
        id[r] = id[r + RS];
        id[r + RS] = ti;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < E; ++r) exch(v[r], id[r], STRIDE, ((r * 32 + lane) & SIZE) == 0, lane);
  }
}

// Stages STRIDE, STRIDE / 2, ..., 1 of a bitonic pass of size SIZE.
template <int E, int SIZE, int STRIDE>
__device__ __forceinline__ void stages(float (&v)[E], int (&id)[E], int lane) {
  if constexpr (STRIDE > 0) {
    stage<E, SIZE, STRIDE>(v, id, lane);
    stages<E, SIZE, STRIDE / 2>(v, id, lane);
  }
}

// Ascending bitonic sort of the list.
template <int E, int SIZE = 2>
__device__ __forceinline__ void reg_sort(float (&v)[E], int (&id)[E], int lane) {
  if constexpr (SIZE <= 32 * E) {
    stages<E, SIZE, SIZE / 2>(v, id, lane);
    reg_sort<E, SIZE * 2>(v, id, lane);
  }
}

// Entry i (warp-uniform) of the list.
template <int E>
__device__ __forceinline__ float reg_at(const float (&v)[E], int i) {
  float x = v[0];
#pragma unroll
  for (int r = 1; r < E; ++r)
    if ((i >> 5) == r) x = v[r];
  return __shfl_sync(FULL, x, i & 31);
}

template <int E>
__device__ __forceinline__ void load_list(float (&v)[E], int (&id)[E], const float* ld,
                                          const int* li, int n, int lane) {
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int i = r * 32 + lane;
    v[r] = i < n ? ld[i] : inf_f();
    id[r] = i < n ? li[i] : -1;
  }
}

template <int E>
__device__ __forceinline__ void store_list(const float (&v)[E], const int (&id)[E], float* ld,
                                           int* li, int lane) {
#pragma unroll
  for (int r = 0; r < E; ++r) {
    ld[r * 32 + lane] = v[r];
    li[r * 32 + lane] = id[r];
  }
}

struct Flushed {
  int nl;    // pairs in the list (K once full)
  float th;  // the list's K-th best (inf until full)
  float jb;  // an upper bound of the chunk's j-th best (inf if none yet)
};

// Flush the first c <= 32 pairs of one query's buffer (bd, bi) into its
// running list (ld, li) of nl pairs.  j: the rank whose value the caller
// publishes (jb).  Called by a whole warp.
template <int K>
__device__ __forceinline__ Flushed flush(const float* bd, const int* bi, int c, int nl, int j,
                                      float* ld, int* li, int lane) {
  constexpr int E = K / 32;
  float v = lane < c ? bd[lane] : inf_f();
  int id = lane < c ? bi[lane] : -1;
  warp_sort32(v, id, lane);
  const float jb = __shfl_sync(FULL, v, min(j, 32) - 1);
  float lv[E];
  int lid[E];
  if (nl < K) {  // fill: append (empty slots as (inf, -1)), sort once full
    ld[nl + lane] = v;
    li[nl + lane] = id;
    nl += 32;
    if (nl < K) return {nl, inf_f(), j <= 32 ? jb : inf_f()};
    __syncwarp();
    load_list<E>(lv, lid, ld, li, K, lane);
    reg_sort<E>(lv, lid, lane);
  } else {  // merge: min(list, reversed buffer) is bitonic; one cleaner sorts it
    load_list<E>(lv, lid, ld, li, K, lane);
    const float rv = __shfl_sync(FULL, v, 31 - lane);
    const int ri = __shfl_sync(FULL, id, 31 - lane);
    if (before(rv, ri, lv[E - 1], lid[E - 1])) {
      lv[E - 1] = rv;
      lid[E - 1] = ri;
    }
    stages<E, 2 * K, K / 2>(lv, lid, lane);
  }
  store_list<E>(lv, lid, ld, li, lane);
  __syncwarp();
  const float jth = reg_at<E>(lv, min(j, K) - 1);
  return {K, reg_at<E>(lv, K - 1), fminf(j <= 32 ? jb : inf_f(), jth)};
}

// Sort the first n pairs of a list in place and pad it to K with (inf, -1):
// a sort of E * 32 >= n slots, then the padding.
template <int E>
__device__ __forceinline__ void sort_prefix(float* ld, int* li, int n, int K, int lane) {
  float lv[E];
  int lid[E];
  load_list<E>(lv, lid, ld, li, n, lane);
  __syncwarp();
  reg_sort<E>(lv, lid, lane);
  store_list<E>(lv, lid, ld, li, lane);
  for (int i = 32 * E + lane; i < K; i += 32) {
    ld[i] = inf_f();
    li[i] = -1;
  }
  __syncwarp();
}

template <int K>
__device__ __forceinline__ void finish_list(float* ld, int* li, int n, int lane) {
  if (n <= 32) {  // none, or one piece that its flush sorted: pad the rest
    for (int i = n + lane; i < K; i += 32) {
      ld[i] = inf_f();
      li[i] = -1;
    }
    __syncwarp();
  } else {
    sort_prefix<K / 32>(ld, li, n, K, lane);
  }
}

// The first n (a multiple of 32, at most E * 32) entries of a list sorted
// in place: a sort of E * 32 slots, those past n (inf, -1) in registers
// only.
template <int E>
__device__ __forceinline__ void sort_in_place(float* ld, int* li, int n, int lane) {
  float lv[E];
  int lid[E];
  load_list<E>(lv, lid, ld, li, n, lane);
  __syncwarp();
  reg_sort<E>(lv, lid, lane);
#pragma unroll
  for (int r = 0; r < E; ++r)
    if (r * 32 + lane < n) {
      ld[r * 32 + lane] = lv[r];
      li[r * 32 + lane] = lid[r];
    }
  __syncwarp();
}

// The end of a chunk's list of n entries.  With counts (nsplit > 1) the
// list is left sorted and its count written at counts[slot]: a full list
// and one piece are sorted already, several pieces are sorted here (a
// flush's piece of 32 is sorted; the append that fills a list sorts it).
// Without counts (one chunk: the list is the answer) it is sorted and
// padded to K.
template <int K>
__device__ __forceinline__ void end_list(float* ld, int* li, int n, int* counts, size_t slot,
                                         int lane) {
  if (counts == nullptr) {
    if (n < K) finish_list<K>(ld, li, n, lane);
    return;
  }
  if (n > 32 && n < K) {  // the smallest sort that holds the list
    if (n <= 64)
      sort_in_place<2>(ld, li, n, lane);
    else if (n <= 128)
      sort_in_place<4>(ld, li, n, lane);
    else if (n <= 256)
      sort_in_place<(K >= 256 ? 8 : 4)>(ld, li, n, lane);
    else
      sort_in_place<K / 32>(ld, li, n, lane);
  }
  if (lane == 0) counts[slot] = n;
}

// Merge the nsplit chunk lists of each query into its top K.  Chunk s's
// list is sorted and holds counts[b * K + s] entries (count slots in out_i,
// written by the scans, end_list).  The chunks' bounds are still in out_d:
// their largest over chunks 0 .. nsplit - 2, T, is at or above the query's
// K-th best, so only entries at or below T can be in it, a prefix of each
// list.  Warp w owns query blockIdx.x * MW + w: its lanes walk 32 lists at a
// time (16 bytes a load) to count each list's prefix, then take the
// prefixes K entries at a time (lane-parallel loads, a binary search of the
// prefix sums finding each entry's list), sort each batch in registers and
// merge it into the running K best with one bitonic cleaner.  With the
// bounds a list gives a few entries, so a query is a few batches, whatever
// nsplit.
template <int K>
struct MergeWarps {
  static constexpr int value = K >= 512 ? 4 : 8;
};

template <int K>
__global__ void __launch_bounds__(32 * MergeWarps<K>::value)
merge_partials_kernel(const float* __restrict__ pd, const int* __restrict__ pi,
                      float* __restrict__ out_d, int* __restrict__ out_i, int B, int nsplit) {
  constexpr int MW = MergeWarps<K>::value;
  constexpr int E = K / 32;
  __shared__ int pre_s[MW][K + 1];  // prefix sums of the entries each list gives
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * MW + w;
  if (b >= B) return;  // only warp-level barriers below
  int* pre = pre_s[w];
  const float* src_d = pd + (size_t)b * nsplit * K;
  const int* src_i = pi + (size_t)b * nsplit * K;
  float T = -inf_f();
  for (int s = lane; s < nsplit - 1; s += 32) T = fmaxf(T, out_d[(size_t)b * K + s]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) T = fmaxf(T, __shfl_xor_sync(FULL, T, o));
  int carry = 0;
  for (int s0 = 0; s0 < nsplit; s0 += 32) {
    const int s = s0 + lane;
    int v = 0;  // list s's entries at or below T
    if (s < nsplit) {
      const int n = out_i[(size_t)b * K + s];
      for (int e = 0; e < n; e += 4) {
        const float4 d = *reinterpret_cast<const float4*>(src_d + (size_t)s * K + e);
        const int k = (d.x <= T) + (d.y <= T) + (d.z <= T) + (d.w <= T);
        v += k;
        if (k < 4) break;
      }
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v += y;
    }
    if (s < nsplit) pre[s + 1] = carry + v;
    carry += __shfl_sync(FULL, v, 31);
  }
  if (lane == 0) pre[0] = 0;
  __syncwarp();
  const int total = carry;
  float rv[E];
  int rid[E];
  for (int g0 = 0; g0 < total || g0 == 0; g0 += K) {
    float v[E];
    int id[E];
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const int g = g0 + r * 32 + lane;
      v[r] = inf_f();
      id[r] = -1;
      if (g < total) {
        int lo = 0, hi = nsplit;  // the list s with pre[s] <= g < pre[s + 1]
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (pre[mid] <= g)
            lo = mid;
          else
            hi = mid;
        }
        const size_t at = (size_t)lo * K + g - pre[lo];
        v[r] = src_d[at];
        id[r] = src_i[at];
      }
    }
    reg_sort<E>(v, id, lane);
    if (g0 == 0) {
#pragma unroll
      for (int r = 0; r < E; ++r) {
        rv[r] = v[r];
        rid[r] = id[r];
      }
      continue;
    }
    // min(running, reversed batch) is bitonic and holds the K best
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const float bv = __shfl_sync(FULL, v[E - 1 - r], 31 - lane);
      const int bi = __shfl_sync(FULL, id[E - 1 - r], 31 - lane);
      if (before(bv, bi, rv[r], rid[r])) {
        rv[r] = bv;
        rid[r] = bi;
      }
    }
    stages<E, 2 * K, K / 2>(rv, rid, lane);
  }
  __syncwarp();  // every count and bound was read before the output overwrites them
  store_list<E>(rv, rid, out_d + (size_t)b * K, out_i + (size_t)b * K, lane);
}

template <int K>
cudaError_t launch_merge(const float* part_d, const int* part_i, float* out_d, int* out_i, int B,
                         int nsplit, cudaStream_t stream) {
  constexpr int MW = MergeWarps<K>::value;
  merge_partials_kernel<K><<<(B + MW - 1) / MW, 32 * MW, 0, stream>>>(part_d, part_i, out_d,
                                                                      out_i, B, nsplit);
  return cudaGetLastError();
}

}  // namespace topk
