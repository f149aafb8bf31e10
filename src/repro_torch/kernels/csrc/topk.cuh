// Streaming top-k machinery shared by K1 (distance_topk.cu) and K2
// (distance_topk_q8.cu): the shared-memory layout of a scoring block, the
// warp-level bitonic sort / merge of (dist, id) lists, the ballot-filtered
// admission of one tile's scores, and the kernel that merges per-chunk
// partial lists.
//
// A scoring block owns TQ queries and one chunk of corpus rows, walked in
// tiles of TN rows.  Warp w owns queries QPW*w .. QPW*w + QPW-1 in the top-k
// phase.  Each query keeps a sorted running list of K (dist, id) pairs and a
// candidate buffer of K pairs in shared memory.  A tile score enters the
// buffer (by warp ballot) only if it beats the query's current K-th best; a
// full buffer is sorted with a bitonic network and merged into the running
// list (elementwise min against the reversed buffer, then a half-cleaner
// cascade).  Past the first few tiles most scores cost one compare and one
// ballot per 32.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace topk {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int TN = 128;  // corpus rows per tile
constexpr int TD = 32;   // 32-bit words per shared-memory slice of a row

// Query tile: 32 queries per block, 16 at K = 512 so that the lists fit in
// shared memory (one block per SM at K >= 256).
template <int K>
struct QTile {
  static constexpr int value = K >= 512 ? 16 : 32;
};

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// Shared memory of one scoring block.  T is the word type of the staged
// tiles: float (K1) or int holding four int8 codes (K2).  x rows are padded
// to 33 words and q columns to TQ + 4 (16-byte aligned), so the reads of
// the scoring loop are conflict-free.
template <typename T, int K, int TQ>
struct TileSmem {
  static constexpr int XS_STRIDE = TD + 1;
  static constexpr int QS_STRIDE = TQ + 4;
  T xs[TN * XS_STRIDE];              // x tile, one D slice
  alignas(16) T qs[TD * QS_STRIDE];  // q tile, one D slice, [d][q]
  float tile[TQ * TN];               // scores of the current tile
  float run_d[TQ * K];               // running top-K per query, ascending
  int run_i[TQ * K];
  float buf_d[TQ * K];               // candidates waiting to be merged
  int buf_i[TQ * K];
};

__device__ __forceinline__ void cmp_swap(float* d, int* id, int i, int j, bool asc) {
  float di = d[i], dj = d[j];
  if ((di > dj) == asc && di != dj) {
    d[i] = dj;
    d[j] = di;
    int t = id[i];
    id[i] = id[j];
    id[j] = t;
  }
}

// Ascending bitonic sort of K (dist, id) pairs by one warp.
template <int K>
__device__ void warp_sort(float* d, int* id, int lane) {
  for (int size = 2; size <= K; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < K / 2; t += 32) {
        int i = 2 * t - (t & (stride - 1));
        cmp_swap(d, id, i, i + stride, (i & size) == 0);
      }
      __syncwarp();
    }
  }
}

// run <- the K smallest of run U buf, ascending; both inputs ascending.
template <int K>
__device__ void warp_merge(float* rd, int* ri, const float* bd, const int* bi, int lane) {
  for (int i = lane; i < K; i += 32) {
    float b = bd[K - 1 - i];
    if (b < rd[i]) {
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

// Sort the first cnt buffered candidates and merge them into the running
// list; returns the new K-th best distance.
template <int K>
__device__ float warp_flush(float* rd, int* ri, float* bd, int* bi, int cnt, int lane) {
  __syncwarp();
  for (int i = cnt + lane; i < K; i += 32) {
    bd[i] = inf_f();
    bi[i] = -1;
  }
  __syncwarp();
  warp_sort<K>(bd, bi, lane);
  warp_merge<K>(rd, ri, bd, bi, lane);
  return rd[K - 1];
}

// Fill every running list of the block with (inf, -1).
template <typename S, int K, int TQ>
__device__ __forceinline__ void init_lists(S& sm, int tid) {
  for (int i = tid; i < TQ * K; i += THREADS) {
    sm.run_d[i] = inf_f();
    sm.run_i[i] = -1;
  }
}

// Warp w admits the scores of the current tile (sm.tile) for its queries:
// those that beat the query's K-th best enter its buffer, a full buffer is
// flushed first.  thresh/cnt are per query of the warp and warp-uniform.
template <typename S, int K, int TQ>
__device__ __forceinline__ void admit_tile(S& sm, int tile_start, int w, int lane,
                                           float (&thresh)[TQ / WARPS],
                                           int (&cnt)[TQ / WARPS]) {
  constexpr int QPW = TQ / WARPS;
#pragma unroll
  for (int u = 0; u < QPW; ++u) {
    const int qi = w * QPW + u;
    float* rd = sm.run_d + qi * K;
    int* ri = sm.run_i + qi * K;
    float* bd = sm.buf_d + qi * K;
    int* bi = sm.buf_i + qi * K;
    const float* trow = sm.tile + qi * TN;
    for (int j = 0; j < TN / 32; ++j) {
      const int r = j * 32 + lane;
      const float s = trow[r];
      bool take = s < thresh[u];
      unsigned m = __ballot_sync(0xffffffffu, take);
      if (m == 0) continue;
      if (cnt[u] + __popc(m) > K) {
        thresh[u] = warp_flush<K>(rd, ri, bd, bi, cnt[u], lane);
        cnt[u] = 0;
        take = s < thresh[u];
        m = __ballot_sync(0xffffffffu, take);
      }
      if (take) {
        const int pos = cnt[u] + __popc(m & ((1u << lane) - 1u));
        bd[pos] = s;
        bi[pos] = tile_start + r;
      }
      cnt[u] += __popc(m);
    }
  }
}

// Flush what is left in each buffer of the warp and write each query's
// list to out[(b * nsplit + split) * K ...].
template <typename S, int K, int TQ>
__device__ __forceinline__ void write_lists(S& sm, int w, int lane, const int (&cnt)[TQ / WARPS],
                                            int q0, int B, int nsplit, int split,
                                            float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int QPW = TQ / WARPS;
#pragma unroll
  for (int u = 0; u < QPW; ++u) {
    const int qi = w * QPW + u;
    float* rd = sm.run_d + qi * K;
    int* ri = sm.run_i + qi * K;
    if (cnt[u] > 0) warp_flush<K>(rd, ri, sm.buf_d + qi * K, sm.buf_i + qi * K, cnt[u], lane);
    __syncwarp();
    const int b = q0 + qi;
    if (b < B) {
      const size_t base = ((size_t)b * nsplit + split) * K;
      for (int i = lane; i < K; i += 32) {
        out_d[base + i] = rd[i];
        out_i[base + i] = ri[i];
      }
    }
  }
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
    if (!(src_d[(size_t)s * K] < rd[K - 1])) continue;  // cannot improve
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
