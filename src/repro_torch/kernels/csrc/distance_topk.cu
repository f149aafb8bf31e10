// K1: fused distance + streaming top-k for Hopper (sm_90a), fp32 SIMT.
//
// Replaces src/repro/kernels/distance_topk.py::_distance_topk_kernel, the
// Pallas TPU kernel behind ops.distance_topk.  For each query row it returns
// the k_pad smallest scores over corpus rows < n_valid, ascending, padded
// with (inf, -1):
//   l2: ||x||^2 - 2 q.x   (the caller adds ||q||^2 back)
//   ip: -q.x               (cos is ip over rows the caller normalized)
//
// What bounds it: float32 operations.  Each (query, row) pair costs 2*D
// flops against 4*D bytes of a row that is shared by a whole tile of
// queries, so with more than a few queries per launch the card's rate of
// float32-grade products is the limit, not HBM: 165 TFLOP/s as a 3xTF32
// split on the tensor cores, 67 TFLOP/s on the fp32 SIMT pipe used here.  A
// single TF32 product rounds the inputs and breaks the parity contract with
// the reference (rtol = atol = 3e-4).  Short of that rate, what limits a SIMT
// kernel is the traffic from L2 into each SM: a block re-reads its corpus
// tile for every query tile, so the block takes TQ = 32 queries to do 8
// FMAs per byte it loads.
//
// Design:
//  * The TPU kernel carries its running top-k across a sequential grid axis.
//    Blocks here run in parallel and in no order, so each block owns a tile
//    of TQ queries and one contiguous chunk of corpus rows, walks that chunk
//    in tiles of TN = 128 rows with a loop, and writes a partial top-k_pad
//    list per (query, chunk).  Splitting N across blocks keeps the 132 SMs
//    busy when a routed batch has only a few hundred queries.  The second
//    kernel, merge_partials_kernel, merges the per-chunk lists.
//  * Scores: the x tile and the q tile are staged in shared memory one D
//    slice of TD = 32 columns at a time (x rows padded to 33 floats, q
//    columns to TQ + 4, so reads are conflict-free).  While a slice is being
//    used, each thread already holds its share of the next slice in
//    registers, so the global loads overlap the FMAs.  Each thread
//    accumulates 2 rows x TQ/4 queries in registers with plain fp32 FMAs.
//    Scores go to shared memory only.
//  * Top-k (topk.cuh, shared with K2): each query keeps a sorted running
//    list of k_pad (dist, id) pairs and a candidate buffer in shared memory;
//    a tile score enters the buffer (by warp ballot) only if it beats the
//    query's current k-th best, and full buffers are bitonic-sorted and
//    merged.  k_pad is 128, 256 or 512; at 512 the block takes TQ = 16
//    queries so that the lists fit in shared memory.
//  * n_valid is a runtime argument: rows >= n_valid are neither read nor
//    scored.  Queries past B are computed on zeros and never written.
//
// Interface: a plain C function for ctypes.  It launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk.cuh"

namespace {

using topk::TD;
using topk::THREADS;
using topk::TN;
using topk::WARPS;

static_assert(TD == 32, "one warp loads one 32-column row segment");
static_assert(THREADS == 4 * 64 && TN == 2 * 64,
              "thread t scores rows t%64 and t%64+64 for queries TQ/4*(t/64) .. +TQ/4-1");

// This thread's share of one D slice: x rows of the tile, q rows of the block.
template <int TQ>
__device__ __forceinline__ void load_slice(const float* __restrict__ x, const float* __restrict__ q,
                                           int tile_start, int c_end, int d0, int D, int q0, int B,
                                           int tid, float (&xr)[TN * TD / THREADS],
                                           float (&qr)[TQ * TD / THREADS]) {
#pragma unroll
  for (int j = 0; j < TN * TD / THREADS; ++j) {
    const int e = tid + j * THREADS;
    const int row = tile_start + e / TD, col = d0 + e % TD;
    xr[j] = (row < c_end && col < D) ? __ldg(x + (size_t)row * D + col) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < TQ * TD / THREADS; ++j) {
    const int e = tid + j * THREADS;
    const int qrow = q0 + e / TD, col = d0 + e % TD;
    qr[j] = (qrow < B && col < D) ? __ldg(q + (size_t)qrow * D + col) : 0.f;
  }
}

template <int K, int TQ>
__global__ void __launch_bounds__(THREADS, 2)
distance_topk_partial_kernel(const float* __restrict__ q, const float* __restrict__ x,
                             float* __restrict__ out_d, int* __restrict__ out_i,
                             int B, int D, int n_valid, int metric, int nsplit, int chunk) {
  using Smem = topk::TileSmem<float, K, TQ>;
  constexpr int QT = TQ / 4;  // queries per thread in the scoring loop
  constexpr int QPW = TQ / WARPS;
  constexpr int X_PER_THREAD = TN * TD / THREADS;
  constexpr int Q_PER_THREAD = TQ * TD / THREADS;
  static_assert(TQ % 16 == 0 && QT % 4 == 0, "float4 reads of the q slice");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int q0 = blockIdx.x * TQ;
  const int split = blockIdx.y;
  const int c_begin = split * chunk;
  const int c_end = min(c_begin + chunk, n_valid);

  topk::init_lists<Smem, K, TQ>(sm, tid);
  __syncthreads();
  float thresh[QPW];  // per query of this warp: k-th best so far (warp-uniform)
  int cnt[QPW];       // per query: buffered candidates (warp-uniform)
#pragma unroll
  for (int u = 0; u < QPW; ++u) {
    thresh[u] = topk::inf_f();
    cnt[u] = 0;
  }

  const int rg = tid & 63;  // this thread scores rows rg and rg + 64
  const int qg = tid >> 6;  // ... for queries QT*qg .. QT*qg + QT-1
  float xr[X_PER_THREAD], qr[Q_PER_THREAD];
  if (c_begin < c_end) load_slice<TQ>(x, q, c_begin, c_end, 0, D, q0, B, tid, xr, qr);

  for (int tile_start = c_begin; tile_start < c_end; tile_start += TN) {
    float acc[2][QT];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int j = 0; j < QT; ++j) acc[a][j] = 0.f;
    float nrm[2] = {0.f, 0.f};
    for (int d0 = 0; d0 < D; d0 += TD) {
      __syncthreads();  // every warp is done with the previous slice / tile
#pragma unroll
      for (int j = 0; j < X_PER_THREAD; ++j) {
        const int e = tid + j * THREADS;
        sm.xs[(e / TD) * Smem::XS_STRIDE + e % TD] = xr[j];
      }
#pragma unroll
      for (int j = 0; j < Q_PER_THREAD; ++j) {
        const int e = tid + j * THREADS;
        sm.qs[(e % TD) * Smem::QS_STRIDE + e / TD] = qr[j];
      }
      __syncthreads();
      // prefetch the next slice (or the next tile's first) while this one runs
      if (d0 + TD < D)
        load_slice<TQ>(x, q, tile_start, c_end, d0 + TD, D, q0, B, tid, xr, qr);
      else if (tile_start + TN < c_end)
        load_slice<TQ>(x, q, tile_start + TN, c_end, 0, D, q0, B, tid, xr, qr);
#pragma unroll 8
      for (int c = 0; c < TD; ++c) {
        const float xa = sm.xs[rg * Smem::XS_STRIDE + c];
        const float xb = sm.xs[(rg + 64) * Smem::XS_STRIDE + c];
        float qv[QT];
#pragma unroll
        for (int h = 0; h < QT / 4; ++h) {
          const float4 v =
              *reinterpret_cast<const float4*>(sm.qs + c * Smem::QS_STRIDE + qg * QT + 4 * h);
          qv[4 * h] = v.x;
          qv[4 * h + 1] = v.y;
          qv[4 * h + 2] = v.z;
          qv[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < QT; ++j) {
          acc[0][j] = fmaf(qv[j], xa, acc[0][j]);
          acc[1][j] = fmaf(qv[j], xb, acc[1][j]);
        }
        nrm[0] = fmaf(xa, xa, nrm[0]);
        nrm[1] = fmaf(xb, xb, nrm[1]);
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = rg + a * 64;
      const bool valid = tile_start + r < c_end;
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        const float s = metric == 0 ? nrm[a] - 2.f * acc[a][j] : -acc[a][j];
        sm.tile[(qg * QT + j) * TN + r] = valid ? s : topk::inf_f();
      }
    }
    __syncthreads();
    topk::admit_tile<Smem, K, TQ>(sm, tile_start, w, lane, thresh, cnt);
    // the next tile rewrites sm.tile only after the __syncthreads that opens
    // its first D slice, which every warp reaches after finishing admit_tile
  }
  topk::write_lists<Smem, K, TQ>(sm, w, lane, cnt, q0, B, nsplit, split, out_d, out_i);
}

template <int K>
cudaError_t launch(const float* q, const float* x, float* part_d, int* part_i, float* out_d,
                   int* out_i, int B, int D, int n_valid, int metric, int nsplit, int chunk,
                   cudaStream_t stream) {
  constexpr int TQ = topk::QTile<K>::value;
  const int smem = (int)sizeof(topk::TileSmem<float, K, TQ>);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(distance_topk_partial_kernel<K, TQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((B + TQ - 1) / TQ, nsplit);
  const bool direct = nsplit == 1;  // one chunk: its partial list is the answer
  distance_topk_partial_kernel<K, TQ><<<grid, THREADS, smem, stream>>>(
      q, x, direct ? out_d : part_d, direct ? out_i : part_i, B, D, n_valid, metric, nsplit,
      chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || direct) return e;
  return topk::launch_merge<K>(part_d, part_i, out_d, out_i, B, nsplit, stream);
}

}  // namespace

// q (B, D) and x (N, D) float32 row-major on the device; out_d/out_i (B,
// k_pad); part_d/part_i (B, nsplit, k_pad) scratch, unused when nsplit == 1.
// Corpus chunk s covers rows [s * chunk, min((s + 1) * chunk, n_valid)).
// metric: 0 = l2, 1 = ip.  k_pad: 128, 256 or 512.  Returns a cudaError_t.
extern "C" int repro_distance_topk(const float* q, const float* x, float* part_d, int* part_i,
                                   float* out_d, int* out_i, int B, int D, int n_valid,
                                   int k_pad, int metric, int nsplit, int chunk, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (B <= 0 || D <= 0 || n_valid <= 0 || nsplit <= 0 || chunk <= 0 || nsplit > 65535 ||
      (metric != 0 && metric != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (k_pad == 128)
    e = launch<128>(q, x, part_d, part_i, out_d, out_i, B, D, n_valid, metric, nsplit, chunk, st);
  else if (k_pad == 256)
    e = launch<256>(q, x, part_d, part_i, out_d, out_i, B, D, n_valid, metric, nsplit, chunk, st);
  else if (k_pad == 512)
    e = launch<512>(q, x, part_d, part_i, out_d, out_i, B, D, n_valid, metric, nsplit, chunk, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
