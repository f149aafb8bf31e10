// K2: fused int8 distance + streaming top-k for Hopper (sm_90a), dp4a SIMT.
//
// Replaces src/repro/kernels/distance_topk_q8.py::_distance_topk_q8_kernel,
// the Pallas TPU kernel behind ops.distance_topk_q8: stage 1 of the
// two-stage (int8 scan -> exact re-rank) search.  For each query row it
// returns the k_pad smallest quantized scores over corpus rows < n_valid,
// ascending, padded with (inf, -1):
//   qx = float(dot(q_codes[b], x_codes[n])) * q_scale[b]   (exact int dot)
//   l2: norms2[n] - 2 * qx   (the caller adds ||q||^2 back)
//   ip: -qx                  (cos is ip over rows the caller normalized)
//
// Arithmetic: the dot is an exact int32 sum of int8 products, four per
// __dp4a.  The rescale and the metric term are __fmul_rn / __fsub_rn, which
// the compiler never contracts into an FMA, so every score rounds exactly
// where the plain version (ref.q8_score_matrix) rounds: once at the int ->
// float conversion, once at the rescale, once at the subtraction.  Scores
// are bit-equal to it at every D (|dot| <= 2048 * 127^2 fits int32 easily).
//
// What bounds it: at the deployment partition shape (~345 queries x
// 156,773 rows x 512) the work is 2*B*N*D = 5.5e10 int8 operations, 0.028
// ms at the 1,979 TOPS dense int8 tensor-core peak, against N*D + 4N + B*D
// + 4B + 8*B*k_pad = 81 MB of traffic, 0.024 ms at 3.35 TB/s: both sides
// come to ~0.03 ms.  This version does not reach either: it runs on the
// SIMT integer pipe (dp4a, four MACs an instruction), not the tensor cores,
// and like K1 it is limited by how fast each SM gets its tiles from L2 and
// shared memory.  An s8 x s8 -> s32 tensor-core path (mma.sync m16n8k32,
// then wgmma) is the way toward the bound.
//
// Design: K1's, with int words in place of floats.  A block owns TQ
// queries and one chunk of corpus rows; it stages one D slice of 128 codes
// (32 int words) of a 128-row x tile and of the q tile in shared memory at
// a time, with the next slice already loaded into registers; each thread
// accumulates 2 rows x TQ/4 queries with __dp4a.  Scores go to shared
// memory only, and the top-k machinery of topk.cuh (ballot-filtered
// candidate buffers, bitonic merges, then a chunk-merge kernel) keeps the
// k_pad best per query.  Rows are given as int words: codes are zero-padded
// along D to a multiple of 4 by the caller, which leaves every dot exact.
// n_valid is a runtime argument: rows >= n_valid are neither read nor
// ranked.
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

static_assert(TD == 32, "one warp loads one 32-word (128-code) row segment");
static_assert(THREADS == 4 * 64 && TN == 2 * 64,
              "thread t scores rows t%64 and t%64+64 for queries TQ/4*(t/64) .. +TQ/4-1");

// This thread's share of one D slice (32 words = 128 codes per row).
template <int TQ>
__device__ __forceinline__ void load_slice(const int* __restrict__ x, const int* __restrict__ q,
                                           int tile_start, int c_end, int d0, int D4, int q0,
                                           int B, int tid, int (&xr)[TN * TD / THREADS],
                                           int (&qr)[TQ * TD / THREADS]) {
#pragma unroll
  for (int j = 0; j < TN * TD / THREADS; ++j) {
    const int e = tid + j * THREADS;
    const int row = tile_start + e / TD, col = d0 + e % TD;
    xr[j] = (row < c_end && col < D4) ? __ldg(x + (size_t)row * D4 + col) : 0;
  }
#pragma unroll
  for (int j = 0; j < TQ * TD / THREADS; ++j) {
    const int e = tid + j * THREADS;
    const int qrow = q0 + e / TD, col = d0 + e % TD;
    qr[j] = (qrow < B && col < D4) ? __ldg(q + (size_t)qrow * D4 + col) : 0;
  }
}

template <int K, int TQ>
__global__ void __launch_bounds__(THREADS, 2)
distance_topk_q8_partial_kernel(const int* __restrict__ q, const int* __restrict__ x,
                                const float* __restrict__ q_scale,
                                const float* __restrict__ norms2, float* __restrict__ out_d,
                                int* __restrict__ out_i, int B, int D4, int n_valid, int metric,
                                int nsplit, int chunk) {
  using Smem = topk::TileSmem<int, K, TQ>;
  constexpr int QT = TQ / 4;  // queries per thread in the scoring loop
  constexpr int QPW = TQ / WARPS;
  constexpr int X_PER_THREAD = TN * TD / THREADS;
  constexpr int Q_PER_THREAD = TQ * TD / THREADS;
  static_assert(TQ % 16 == 0 && QT % 4 == 0, "int4 reads of the q slice");
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
  float qsc[QT];
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    const int b = q0 + qg * QT + j;
    qsc[j] = b < B ? __ldg(q_scale + b) : 0.f;
  }
  int xr[X_PER_THREAD], qr[Q_PER_THREAD];
  if (c_begin < c_end) load_slice<TQ>(x, q, c_begin, c_end, 0, D4, q0, B, tid, xr, qr);

  for (int tile_start = c_begin; tile_start < c_end; tile_start += TN) {
    int acc[2][QT];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int j = 0; j < QT; ++j) acc[a][j] = 0;
    for (int d0 = 0; d0 < D4; d0 += TD) {
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
      if (d0 + TD < D4)
        load_slice<TQ>(x, q, tile_start, c_end, d0 + TD, D4, q0, B, tid, xr, qr);
      else if (tile_start + TN < c_end)
        load_slice<TQ>(x, q, tile_start + TN, c_end, 0, D4, q0, B, tid, xr, qr);
#pragma unroll 8
      for (int c = 0; c < TD; ++c) {
        const int xa = sm.xs[rg * Smem::XS_STRIDE + c];
        const int xb = sm.xs[(rg + 64) * Smem::XS_STRIDE + c];
        int qv[QT];
#pragma unroll
        for (int h = 0; h < QT / 4; ++h) {
          const int4 v =
              *reinterpret_cast<const int4*>(sm.qs + c * Smem::QS_STRIDE + qg * QT + 4 * h);
          qv[4 * h] = v.x;
          qv[4 * h + 1] = v.y;
          qv[4 * h + 2] = v.z;
          qv[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < QT; ++j) {
          acc[0][j] = __dp4a(qv[j], xa, acc[0][j]);
          acc[1][j] = __dp4a(qv[j], xb, acc[1][j]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = rg + a * 64;
      const int row = tile_start + r;
      const bool valid = row < c_end;
      const float n2 = (valid && metric == 0) ? __ldg(norms2 + row) : 0.f;
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        const float qx = __fmul_rn(__int2float_rn(acc[a][j]), qsc[j]);
        const float s = metric == 0 ? __fsub_rn(n2, __fmul_rn(2.f, qx)) : -qx;
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
cudaError_t launch(const int* q, const int* x, const float* q_scale, const float* norms2,
                   float* part_d, int* part_i, float* out_d, int* out_i, int B, int D4,
                   int n_valid, int metric, int nsplit, int chunk, cudaStream_t stream) {
  constexpr int TQ = topk::QTile<K>::value;
  const int smem = (int)sizeof(topk::TileSmem<int, K, TQ>);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(distance_topk_q8_partial_kernel<K, TQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((B + TQ - 1) / TQ, nsplit);
  const bool direct = nsplit == 1;  // one chunk: its partial list is the answer
  distance_topk_q8_partial_kernel<K, TQ><<<grid, THREADS, smem, stream>>>(
      q, x, q_scale, norms2, direct ? out_d : part_d, direct ? out_i : part_i, B, D4, n_valid,
      metric, nsplit, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || direct) return e;
  return topk::launch_merge<K>(part_d, part_i, out_d, out_i, B, nsplit, stream);
}

}  // namespace

// q (B, 4*D4) and x (N, 4*D4) int8 codes row-major on the device, read as
// D4 int32 words per row (4-byte aligned rows); q_scale (B,) and norms2
// (N,) float32 (norms2 is read for l2 only); out_d/out_i (B, k_pad);
// part_d/part_i (B, nsplit, k_pad) scratch, unused when nsplit == 1.
// Corpus chunk s covers rows [s * chunk, min((s + 1) * chunk, n_valid)).
// metric: 0 = l2, 1 = ip.  k_pad: 128, 256 or 512.  Returns a cudaError_t.
extern "C" int repro_distance_topk_q8(const void* q, const void* x, const float* q_scale,
                                      const float* norms2, float* part_d, int* part_i,
                                      float* out_d, int* out_i, int B, int D4, int n_valid,
                                      int k_pad, int metric, int nsplit, int chunk,
                                      void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (B <= 0 || D4 <= 0 || n_valid <= 0 || nsplit <= 0 || chunk <= 0 || nsplit > 65535 ||
      (metric != 0 && metric != 1) || (reinterpret_cast<uintptr_t>(q) & 3) ||
      (reinterpret_cast<uintptr_t>(x) & 3))
    return (int)cudaErrorInvalidValue;
  const int* qw = static_cast<const int*>(q);
  const int* xw = static_cast<const int*>(x);
  cudaError_t e;
  if (k_pad == 128)
    e = launch<128>(qw, xw, q_scale, norms2, part_d, part_i, out_d, out_i, B, D4, n_valid, metric,
                    nsplit, chunk, st);
  else if (k_pad == 256)
    e = launch<256>(qw, xw, q_scale, norms2, part_d, part_i, out_d, out_i, B, D4, n_valid, metric,
                    nsplit, chunk, st);
  else if (k_pad == 512)
    e = launch<512>(qw, xw, q_scale, norms2, part_d, part_i, out_d, out_i, B, D4, n_valid, metric,
                    nsplit, chunk, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
