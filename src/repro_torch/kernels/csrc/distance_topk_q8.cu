// K2: fused int8 distance + streaming top-k for Hopper (sm_90a), int8
// warpgroup MMAs.
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
// Arithmetic: the dot is an exact int32 sum of int8 products from wgmma
// m64n64k32 s8.s8 -> s32 (|dot| <= 2048 * 127^2 fits int32 easily).  The
// rescale and the metric term are __fmul_rn / __fsub_rn, which the compiler
// never contracts into an FMA, so every score rounds exactly where the
// plain version (ref.q8_score_matrix) rounds: once at the int -> float
// conversion, once at the rescale, once at the subtraction.  Scores are
// bit-equal to it at every D.
//
// What bounds it: at the deployment partition shape (~345 queries x
// 156,773 rows x 512) the work is 2*B*N*D = 5.5e10 int8 operations, 0.028
// ms at the 1,979 TOP/s dense int8 tensor-core peak, against N*D + 4N + B*D
// + 4B + 8*B*k_pad = 81 MB of traffic, 0.024 ms at 3.35 TB/s: both sides
// come to ~0.03 ms.  The products themselves are a small part of the time:
// what holds K2 back is the selection around them (PERF.md), which it
// shares with K1.
//
// Design: the batched scan of csrc/scan.cuh (see its note), with int8
// wgmmas in place of K1's 3xTF32 products.  Codes need no split, so the
// corpus slice that TMA lands is the wgmma's B as it is, and the block's q
// slice its A (both K-major under the 128-byte swizzle, 32 bytes a k-step):
// 4 m64n64k32 a slice, issued without waiting, each slice's stage released
// once the next slice's wgmmas are issued and the previous ones are done.
// With D <= 512 codes the q slices stay resident for the whole chunk.  The
// producer brings each tile's norms2 with its last slice.  Rows are given
// as int words: codes are zero-padded along D to a multiple of 4 by the
// caller, and a D that is not a multiple of 128 codes zero-fills the last
// slice, which leaves every dot exact.  n_valid is a runtime argument:
// rows >= n_valid are neither read nor ranked.
//
// Interface: a plain C function for ctypes.  It launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

using scan::NJ;

// the batched scan's operation: exact int8 dots of the q and corpus slices
struct Q8Op {
  static constexpr bool SPLIT = false;    // the slices are the operands as they land
  static constexpr bool PIPELINED = true;  // shared-memory operands only
  static constexpr int ELEM = 1;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  struct Args {
    const float* q_scale;
    const float* norms2;
    int metric;  // 0 = l2, 1 = ip
  };
  struct Lane {
    float qsc[2];     // q_scale of queries g, g + 8
    float n2[NJ][2];  // norms2 of rows 8 j + 2 t, + 1 of the current tile
  };
  struct Acc {
    int c[32];
  };
  __device__ static const float* aux_ptr(const Args& a) { return a.norms2; }
  __device__ static void init_lane(Lane& l, const Args& a, int h, int b) {
    l.qsc[h] = __ldg(a.q_scale + b);
  }
  __device__ static void read_aux(Lane& l, const float* aux, int t) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(aux + 8 * j + 2 * t);
      l.n2[j][0] = v.x;
      l.n2[j][1] = v.y;
    }
  }
  __device__ static void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc.c[i] = 0;
    wg::fence_operand(acc.c);
  }
  __device__ static void fence(Acc& acc) { wg::fence_operand(acc.c); }
  // one slice: warpgroup c's 64 query rows (A) against the tile's slice (B),
  // 4 k-steps of 32 codes, issued and committed
  __device__ static void slice(Acc& acc, const unsigned char*, uint32_t qs, uint32_t xs, int c,
                               int, int, bool accumulate) {
    const uint64_t a = wg::rows_desc<scan::SB>(qs) + ((64 * c * scan::SB) >> 4);
    const uint64_t b = wg::rows_desc<scan::SB>(xs);
    wg::fence_operand(acc.c);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < scan::KSTEPS; ++kk)
      wg::mma_ss_s8(acc.c, a + 2 * kk, b + 2 * kk, accumulate || kk > 0);
    wg::commit();
  }

  __device__ static void scores(float (&s)[NJ][4], const Acc& acc, const Lane& l,
                                const Args& args) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float qx = __fmul_rn(__int2float_rn(acc.c[4 * j + e]), l.qsc[e >> 1]);
        s[j][e] = args.metric == 0 ? __fsub_rn(l.n2[j][e & 1], __fmul_rn(2.f, qx)) : -qx;
      }
  }
};

}  // namespace

// The k_pad instance K, in its own translation unit as K1's
// (distance_topk.cu, kernels/_build.py UNITS).
template <int K>
cudaError_t k2_launch(const int* q, const int* x, const float* q_scale, const float* norms2,
                      float* part_d, int* part_i, float* out_d, int* out_i, int B, int D4,
                      int n_valid, int metric, int nsplit, int chunk, cudaStream_t stream);

#ifdef REPRO_K
template <int K>
cudaError_t k2_launch(const int* q, const int* x, const float* q_scale, const float* norms2,
                      float* part_d, int* part_i, float* out_d, int* out_i, int B, int D4,
                      int n_valid, int metric, int nsplit, int chunk, cudaStream_t stream) {
  return scan::launch<Q8Op, K>(q, x, Q8Op::Args{q_scale, norms2, metric}, part_d, part_i, out_d,
                               out_i, B, D4, n_valid, nsplit, chunk, stream);
}

template cudaError_t k2_launch<REPRO_K>(const int*, const int*, const float*, const float*,
                                        float*, int*, float*, int*, int, int, int, int, int, int,
                                        cudaStream_t);
#else

// q (B, 4*D4) and x (N, 4*D4) int8 codes row-major on the device, read as
// D4 int32 words per row (4-byte aligned rows); q_scale (B,) and norms2
// (N,) float32 (norms2 is staged for both metrics, used for l2 only);
// out_d/out_i (B, k_pad); part_d/part_i (B, nsplit, k_pad) scratch, unused
// when nsplit == 1.
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
    e = k2_launch<128>(qw, xw, q_scale, norms2, part_d, part_i, out_d, out_i, B, D4, n_valid,
                       metric, nsplit, chunk, st);
  else if (k_pad == 256)
    e = k2_launch<256>(qw, xw, q_scale, norms2, part_d, part_i, out_d, out_i, B, D4, n_valid,
                       metric, nsplit, chunk, st);
  else if (k_pad == 512)
    e = k2_launch<512>(qw, xw, q_scale, norms2, part_d, part_i, out_d, out_i, B, D4, n_valid,
                       metric, nsplit, chunk, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
#endif
