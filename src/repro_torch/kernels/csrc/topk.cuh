// Top-k machinery shared by K1 (distance_topk.cu) and K2
// (distance_topk_q8.cu): warp-level sorts and merges of (dist, id) lists
// held in registers, the per-query flush of a candidate buffer into a
// running list, and the kernel that merges per-chunk partial lists.
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
// A list that never filled is sorted once at the end of the chunk, over the
// smallest power-of-two prefix that holds it.

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

// run <- the K smallest of run U buf, ascending; both inputs ascending.
template <int K>
__device__ void warp_merge(float* rd, int* ri, const float* bd, const int* bi, int lane) {
  for (int i = lane; i < K; i += 32) {
    float b = bd[K - 1 - i];
    if (before(b, bi[K - 1 - i], rd[i], ri[i])) {
      rd[i] = b;
      ri[i] = bi[K - 1 - i];
    }
  }
  __syncwarp();
  // min(ascending, descending) is bitonic: one half-cleaner cascade sorts it
  for (int stride = K >> 1; stride > 0; stride >>= 1) {
    for (int t = lane; t < K / 2; t += 32) {
      int i = 2 * t - (t & (stride - 1));
      cmp_swap(rd, ri, i, i + stride, true);
    }
    __syncwarp();
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
// a sort of the smallest E * 32 >= n slots, then the padding.
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
  if (n <= 128)
    sort_prefix<4>(ld, li, n, K, lane);
  else if (K >= 256 && n <= 256)
    sort_prefix<(K >= 256 ? 8 : 4)>(ld, li, n, K, lane);
  else
    sort_prefix<K / 32>(ld, li, n, K, lane);
}

// Merge nsplit ascending top-K lists per query into one.  Warp w owns query
// blockIdx.x * MW + w; MW warps per block keep the static shared memory
// under 48 KB at K = 512.
template <int K>
struct MergeWarps {
  static constexpr int value = K >= 512 ? 4 : 8;
};

template <int K>
__global__ void __launch_bounds__(32 * MergeWarps<K>::value)
merge_partials_kernel(const float* __restrict__ pd, const int* __restrict__ pi,
                      float* __restrict__ out_d, int* __restrict__ out_i, int B, int nsplit) {
  constexpr int MW = MergeWarps<K>::value;
  __shared__ float rd_s[MW][K];
  __shared__ int ri_s[MW][K];
  __shared__ float bd_s[MW][K];
  __shared__ int bi_s[MW][K];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * MW + w;
  if (b >= B) return;  // only warp-level barriers below
  float* rd = rd_s[w];
  int* ri = ri_s[w];
  float* bd = bd_s[w];
  int* bi = bi_s[w];
  const float* src_d = pd + (size_t)b * nsplit * K;
  const int* src_i = pi + (size_t)b * nsplit * K;
  for (int i = lane; i < K; i += 32) {
    rd[i] = src_d[i];
    ri[i] = src_i[i];
  }
  __syncwarp();
  for (int s = 1; s < nsplit; ++s) {
    if (!before(src_d[(size_t)s * K], src_i[(size_t)s * K], rd[K - 1], ri[K - 1]))
      continue;  // cannot improve
    for (int i = lane; i < K; i += 32) {
      bd[i] = src_d[(size_t)s * K + i];
      bi[i] = src_i[(size_t)s * K + i];
    }
    __syncwarp();
    warp_merge<K>(rd, ri, bd, bi, lane);
  }
  for (int i = lane; i < K; i += 32) {
    out_d[(size_t)b * K + i] = rd[i];
    out_i[(size_t)b * K + i] = ri[i];
  }
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
