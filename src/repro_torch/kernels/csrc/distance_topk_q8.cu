// K2: fused int8 distance + streaming top-k for Hopper (sm_90a), int8
// tensor cores.
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
// Arithmetic: the dot is an exact int32 sum of int8 products from
// mma.sync m16n8k32 s8.s8 -> s32 (|dot| <= 2048 * 127^2 fits int32 easily).
// The rescale and the metric term are __fmul_rn / __fsub_rn, which the
// compiler never contracts into an FMA, so every score rounds exactly where
// the plain version (ref.q8_score_matrix) rounds: once at the int -> float
// conversion, once at the rescale, once at the subtraction.  Scores are
// bit-equal to it at every D.
//
// What bounds it: at the deployment partition shape (~345 queries x
// 156,773 rows x 512) the work is 2*B*N*D = 5.5e10 int8 operations, 0.028
// ms at the 1,979 TOP/s dense int8 tensor-core peak, against N*D + 4N + B*D
// + 4B + 8*B*k_pad = 81 MB of traffic, 0.024 ms at 3.35 TB/s: both sides
// come to ~0.03 ms.
//
// Design: K1's (csrc/scan.cuh, csrc/topk.cuh), with int8 MMAs in place of
// the 3xTF32 split.  The m16n8k32 fragments sit on the same 32-bit words as
// K1's m16n8k8 tf32 ones, so the ring, the ldmatrix reads and the top-k are
// one code.  Against the dp4a version: (1) the tensor cores in place of the
// SIMT integer pipe; (2) scores filtered in registers, no score tile; (3) a
// producer warp and an mbarrier ring in place of block barriers; (4) lists
// in the partial output, so k_pad 512 keeps the 64-query tile; (5) a
// cp.async ring of q and x slices (and each tile's norms2); and chunks
// prune each other with published bounds.  Rows are given as int words:
// codes are zero-padded along D to a multiple of 4 by the caller, and a D
// that is not a multiple of 32 codes zero-fills the last k-slice, which
// leaves every dot exact.  n_valid is a runtime argument: rows >= n_valid
// are neither read nor ranked.
//
// Interface: a plain C function for ctypes.  It launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

using scan::NJ;

// c += a (16 x 32, row) . b (32 x 8, col), s8 in, exact s32 accumulate
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Q8Op {
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
    int c[NJ][4];
  };
  static constexpr bool AUX = true;
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
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.c[j][e] = 0;
  }

  __device__ static void kstep(Acc& acc, Lane&, const uint32_t (&a)[4],
                               const uint32_t (&bf)[NJ / 2][4]) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      mma_s8(acc.c[j], a, bf[j / 2][2 * (j % 2)], bf[j / 2][2 * (j % 2) + 1]);
  }

  __device__ static void scores(float (&s)[NJ][4], const Acc& acc, const Lane& l,
                                const Args& args, int) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float qx = __fmul_rn(__int2float_rn(acc.c[j][e]), l.qsc[e >> 1]);
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
  return scan::launch<Q8Op, K>(reinterpret_cast<const uint32_t*>(q),
                               reinterpret_cast<const uint32_t*>(x),
                               Q8Op::Args{q_scale, norms2, metric}, part_d, part_i, out_d, out_i,
                               B, D4, n_valid, nsplit, chunk, stream);
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
