// K1: fused distance + streaming top-k for Hopper (sm_90a), float32 scores
// as a 3xTF32 split on the tensor cores.
//
// Replaces src/repro/kernels/distance_topk.py::_distance_topk_kernel, the
// Pallas TPU kernel behind ops.distance_topk.  For each query row it returns
// the k_pad smallest scores over corpus rows < n_valid, ascending, padded
// with (inf, -1):
//   l2: ||x||^2 - 2 q.x   (the caller adds ||q||^2 back)
//   ip: -q.x               (cos is ip over rows the caller normalized)
//
// What bounds it: float32-grade operations.  Each (query, row) pair costs
// 2*D flops against 4*D bytes of a row that a whole query tile shares, so
// with more than a few queries per launch the card's rate of float32-grade
// products is the limit, not HBM (3.35 TB/s): 165 TFLOP/s as a 3xTF32 split
// on the tensor cores (495 TFLOP/s of TF32 over three products).
//
// Design (the shared scan is csrc/scan.cuh, the top-k csrc/topk.cuh, the
// split csrc/tf32.cuh), by what held the SIMT version back:
//  1. Scores on the SIMT pipe (~15% of the f32-grade rate): now the tensor
//     cores.  mma.sync m16n8k8 takes tf32 operands, which keep 10 of the 23
//     mantissa bits, so one TF32 product breaks the parity contract with the
//     reference (rtol = atol = 3e-4).  Each operand a is split into
//     hi = cvt.rna.tf32(a) and lo = cvt.rna.tf32(a - hi) (rounded with two
//     integer operations: the conversion instruction's low issue rate made
//     it the bottleneck), and a tile accumulates a_lo.b_hi + a_hi.b_lo +
//     a_hi.b_hi in float32 (the lo.lo term is below float32's rounding).
//     ||x||^2 stays a plain float32 sum of squares of the staged row, as the
//     TPU body computes it.
//  2. A score tile through shared memory: gone.  Accumulators are scored and
//     filtered in registers; only survivors reach shared memory.
//  3. Block barriers behind a flush: a producer warp and an mbarrier ring
//     decouple the four consumer warps, and each warp flushes its own
//     queries.
//  4. k_pad 512 halving the query tile: the running lists live in the
//     partial output in device memory, so every k_pad keeps 64 queries a
//     block and two blocks per SM.
//  5. Synchronous staging: a 4-stage cp.async ring of (q, x) slices.
// And the selection work itself shrinks: chunks publish bounds of their
// best scores to each other, so a chunk admits a few candidates a query
// where it admitted a sixth to a half of its rows.
//  * Blocks run in parallel and in no order, unlike the TPU grid that
//    carries its top-k across a sequential axis: each block writes a partial
//    list per (query, chunk) and merge_partials_kernel merges them.
//  * n_valid is a runtime argument: rows >= n_valid are neither read nor
//    scored.  Queries past B are computed on zeros and never written.  A D
//    that is not a multiple of the MMA depth zero-fills the last k-slice.
//
// Interface: a plain C function for ctypes.  It launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"
#include "tf32.cuh"

namespace {

using scan::NJ;

using tf32::mma_tf32;
using tf32::split_tf32;

struct F32Op {
  struct Args {
    int metric;  // 0 = l2, 1 = ip
  };
  struct Lane {};
  struct Acc {
    float c[NJ][4];
    float nrm[NJ];  // this lane's part of ||x||^2 of row 8 j + g of the tile
  };
  static constexpr bool AUX = false;
  __device__ static const float* aux_ptr(const Args&) { return nullptr; }
  __device__ static void init_lane(Lane&, const Args&, int, int) {}
  __device__ static void read_aux(Lane&, const float*, int) {}

  __device__ static void zero(Acc& acc) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc.nrm[j] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.c[j][e] = 0.f;
    }
  }

  __device__ static void kstep(Acc& acc, Lane&, const uint32_t (&a)[4],
                               const uint32_t (&bf)[NJ / 2][4]) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const uint32_t b0 = bf[j / 2][2 * (j % 2)], b1 = bf[j / 2][2 * (j % 2) + 1];
      const float f0 = __uint_as_float(b0), f1 = __uint_as_float(b1);
      acc.nrm[j] = fmaf(f1, f1, fmaf(f0, f0, acc.nrm[j]));
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(b0, bh0, bl0);
      split_tf32(b1, bh1, bl1);
      mma_tf32(acc.c[j], al, bh0, bh1);
      mma_tf32(acc.c[j], ah, bl0, bl1);
      mma_tf32(acc.c[j], ah, bh0, bh1);
    }
  }

  __device__ static void scores(float (&s)[NJ][4], const Acc& acc, const Lane&, const Args& args,
                                int lane) {
    const int t = lane & 3;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float n = acc.nrm[j];
      n += __shfl_xor_sync(scan::FULL, n, 1);
      n += __shfl_xor_sync(scan::FULL, n, 2);
      // rows 2 t and 2 t + 1 of the n8 tile are summed by quads 2 t, 2 t + 1
      const float n_a = __shfl_sync(scan::FULL, n, 8 * t);
      const float n_b = __shfl_sync(scan::FULL, n, 8 * t + 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float c = acc.c[j][e];
        s[j][e] = args.metric == 0 ? ((e & 1) ? n_b : n_a) - 2.f * c : -c;
      }
    }
  }
};

}  // namespace

// The k_pad instance K.  The library links four translation units of this
// file (kernels/_build.py UNITS), so that the instances, the longest part of
// the build, compile in parallel: built with -DREPRO_K=K a unit defines this
// instance; built without REPRO_K, the C entry below, which calls them.
template <int K>
cudaError_t k1_launch(const float* q, const float* x, float* part_d, int* part_i, float* out_d,
                      int* out_i, int B, int D, int n_valid, int metric, int nsplit, int chunk,
                      cudaStream_t stream);

#ifdef REPRO_K
template <int K>
cudaError_t k1_launch(const float* q, const float* x, float* part_d, int* part_i, float* out_d,
                      int* out_i, int B, int D, int n_valid, int metric, int nsplit, int chunk,
                      cudaStream_t stream) {
  return scan::launch<F32Op, K>(reinterpret_cast<const uint32_t*>(q),
                                reinterpret_cast<const uint32_t*>(x), F32Op::Args{metric}, part_d,
                                part_i, out_d, out_i, B, D, n_valid, nsplit, chunk, stream);
}

template cudaError_t k1_launch<REPRO_K>(const float*, const float*, float*, int*, float*, int*,
                                        int, int, int, int, int, int, cudaStream_t);
#else

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
    e = k1_launch<128>(q, x, part_d, part_i, out_d, out_i, B, D, n_valid, metric, nsplit, chunk,
                       st);
  else if (k_pad == 256)
    e = k1_launch<256>(q, x, part_d, part_i, out_d, out_i, B, D, n_valid, metric, nsplit, chunk,
                       st);
  else if (k_pad == 512)
    e = k1_launch<512>(q, x, part_d, part_i, out_d, out_i, B, D, n_valid, metric, nsplit, chunk,
                       st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
#endif
