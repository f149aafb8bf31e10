// K1: fused distance + streaming top-k for Hopper (sm_90a), float32-grade
// scores.
//
// Replaces src/repro/kernels/distance_topk.py::_distance_topk_kernel, the
// Pallas TPU kernel behind ops.distance_topk.  For each query row it returns
// the k_pad smallest scores over corpus rows < n_valid, ascending, padded
// with (inf, -1):
//   l2: ||x||^2 - 2 q.x   (the caller adds ||q||^2 back)
//   ip: -q.x               (cos is ip over rows the caller normalized)
//
// Two kernels, chosen by the launcher by the batch alone (path below):
//
// The batched scan (csrc/scan.cuh, B > B_SMALL): each (query, row) pair
// costs 2 D flops against 4 D bytes of a row that a whole query tile
// shares, so the bound is float32-grade products: 165 TFLOP/s as a 3xTF32
// split on the tensor cores (495 TFLOP/s of TF32 over three products).  A
// single TF32 product keeps 10 of float32's 23 mantissa bits and breaks the
// parity contract with the reference (rtol = atol = 3e-4), so each operand
// is split, hi = tf32(a) and lo = tf32(a - hi) (csrc/tf32.cuh), and a
// product accumulates lo.hi + hi.lo + hi.hi.  TF32 wgmma reads B from
// shared memory and K-major only: corpus rows are B, split once a block by
// the producer warpgroup into hi and lo planes (with ||x||^2 of each row, a
// plain float32 sum of squares, as the TPU body computes it), and queries
// are A, split by each consumer in registers (F32Op below).  Queries as M
// keep the accumulator in the layout the selection reads (scan.cuh).
//
// The small-batch scan (small_scan_kernel, B <= B_SMALL = 4): a few queries
// share each row, so the work is the rows' bytes, N D 4 read once: 0.060 ms
// at 3.35 TB/s for retrieval_cand's 1,000,448 x 50, where a 128-query tile
// of tensor-core products would be nearly all padding.  Rows stream at the
// rate of device memory: one 1-D bulk copy (TMA, cp.async.bulk) a stage of
// whole rows, so a row of any D (50, 18, 7) streams as fast as D = 128,
// with the few 4-byte words of a chunk's ragged ends copied by the
// producer warp's lanes.  Scores are float32 FMAs on the CUDA cores: a warp
// takes a pass of 8 rows, each lane a strided set of dimensions of the 8
// rows and of the B queries (read through the read-only cache), and one
// reduce-scatter of the 8 B partial sums across the warp gives each group
// of lanes one (row, query) score; a stage holds a whole number of passes
// of every warp.  What bounds it on the card is the warps' latency (7
// consumer warps a SM), not the bytes: 0.19 ms at retrieval_cand (PERF.md).
// The selection is block-wide: per query a threshold and a candidate
// buffer in shared memory, slots taken with shared-memory atomics; a stage
// whose survivors could overflow a buffer, or went to a list that is not
// full, ends with the consumer warps flushing their queries' buffers
// (topk.cuh) between two named barriers, any other stage with one.  The
// producer warp reads the other chunks' bounds every REFRESH stages, off
// the consumers' path.  The grid is one wave of at most k_pad chunks of
// whole 4-row groups, merged by topk::launch_merge.  The batch alone picks
// the scan: measured, the batched scan wins from B = 8 at D = 50 and from
// B = 16 at D = 128 (tools/scan_time.py --sweep).
//
// Blocks run in parallel and in no order, unlike the TPU grid that carries
// its top-k across a sequential axis: each block writes a partial list per
// (query, chunk) and the chunk merge merges them.  n_valid is a runtime
// argument: rows >= n_valid are neither read nor scored.  Every list is
// ordered by (distance, id), so a run's output is the same every time.
//
// Interface: a plain C function for ctypes.  It launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"
#include "tf32.cuh"

namespace {

using scan::NJ;

// the batched scan's operation: 3xTF32 products of register-A q fragments
// against the producer's hi and lo planes of a corpus slice
struct F32Op {
  static constexpr bool SPLIT = true;       // the producer splits each corpus slice
  static constexpr bool PIPELINED = false;  // register A: a slice's wgmmas end before the next
  static constexpr int ELEM = 4;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  struct Args {
    int metric;  // 0 = l2, 1 = ip
  };
  struct Lane {
    float n2[NJ][2];  // ||x||^2 of rows 8 j + 2 t, + 1 of the current tile
  };
  struct Acc {
    float c[32];
  };
  __device__ static void init_lane(Lane&, const Args&, int, int) {}
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
    for (int i = 0; i < 32; ++i) acc.c[i] = 0.f;
    wg::fence_operand(acc.c);
  }
  __device__ static void fence(Acc& acc) { wg::fence_operand(acc.c); }

  // the producer's split of a raw slice (TMA's swizzled layout, in the lo
  // plane) into the hi and lo planes of a stage, in place, by its 128
  // threads: thread t takes 16 floats of row t / 2, so a phase of 8 threads
  // reads 8 distinct 16-byte bank groups.  Returns the thread's part of its
  // row's ||x||^2 over the tile's slices so far (nrm: the part before this
  // slice); on the tile's last slice the row's whole sum goes to aux.
  __device__ static float split(const unsigned char* raw, unsigned char* planes, float* aux,
                                int t, float nrm, bool last) {
    const int r = t >> 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int off = r * scan::SB + (((((t & 1) * 4 + i) ^ (r & 7))) << 4);
      const float4 v = *reinterpret_cast<const float4*>(raw + off);
      const float xs[4] = {v.x, v.y, v.z, v.w};
      uint32_t h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        nrm = fmaf(xs[e], xs[e], nrm);
        tf32::split_tf32(__float_as_uint(xs[e]), h[e], l[e]);
      }
      *reinterpret_cast<uint4*>(planes + off) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(planes + scan::X_BYTES + off) = make_uint4(l[0], l[1], l[2], l[3]);
    }
    if (last) {
      nrm += __shfl_xor_sync(scan::FULL, nrm, 1);
      if ((t & 1) == 0) aux[r] = nrm;
    }
    return nrm;
  }

  // one slice: this warp's q fragments (rows 16 wc + g, + 8 of warpgroup
  // c's 64, columns t, t + 4 of each k-step) split into tf32 hi and lo,
  // then lo.hi, hi.lo, hi.hi against the stage's planes; waits for the
  // wgmmas, which read the fragments' registers
  __device__ static void slice(Acc& acc, const unsigned char* qs, uint32_t, uint32_t xs, int c,
                               int wc, int lane, bool accumulate) {
    const int g = lane >> 2, t = lane & 3, row = 64 * c + 16 * wc + g;
    uint32_t hi[scan::KSTEPS][4], lo[scan::KSTEPS][4];
#pragma unroll
    for (int kk = 0; kk < scan::KSTEPS; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        tf32::split_tf32(*reinterpret_cast<const uint32_t*>(
                             qs + scan::swz(row + 8 * (f & 1), 8 * kk + t + 4 * (f >> 1))),
                         hi[kk][f], lo[kk][f]);
    const uint64_t xh = wg::rows_desc<scan::SB>(xs);
    const uint64_t xl = xh + (scan::X_BYTES >> 4);
    wg::fence_operand(acc.c);
    wg::fence_operand(hi);
    wg::fence_operand(lo);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < scan::KSTEPS; ++kk)
      wg::mma_rs_tf32<64>(acc.c, lo[kk], xh + 2 * kk, accumulate || kk > 0);
#pragma unroll
    for (int kk = 0; kk < scan::KSTEPS; ++kk) wg::mma_rs_tf32<64>(acc.c, hi[kk], xl + 2 * kk);
#pragma unroll
    for (int kk = 0; kk < scan::KSTEPS; ++kk) wg::mma_rs_tf32<64>(acc.c, hi[kk], xh + 2 * kk);
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(acc.c);
    wg::fence_operand(hi);
    wg::fence_operand(lo);
  }

  __device__ static void scores(float (&s)[NJ][4], const Acc& acc, const Lane& l,
                                const Args& args) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float c = acc.c[4 * j + e];
        s[j][e] = args.metric == 0 ? l.n2[j][e & 1] - 2.f * c : -c;
      }
  }
};

// ------------------------------------------------------ the small-batch scan

namespace small {

constexpr int WARPS = 7;                    // consumer warps (8 a block: 255 registers a thread)
constexpr int THREADS = 32 * (WARPS + 1);   // + the producer warp
constexpr int PR = 8;                       // rows a warp scores at once (a pass)
constexpr int QMAX = 4;                     // queries a launch takes at most (B_SMALL)
constexpr int STAGES = 4;                   // depth of the ring
constexpr int STAGE_BYTES = 32768;          // a stage's rows: the most 4-row groups that fit
constexpr int RMAX = 128;                   // rows a stage at most
constexpr int CAP = 2 * RMAX;               // buffer slots a query: a stage's rows always fit
constexpr int REFRESH = 4;                  // stages between the producer's reads of the bounds

struct Smem {
  unsigned char stage[STAGES][STAGE_BYTES + 16];  // + the source's misalignment
  float buf_d[QMAX * CAP];  // candidate buffers
  int buf_i[QMAX * CAP];
  float th[QMAX], gth[QMAX], jb[QMAX];  // own K-th best, cross-chunk bound, published bound
  int cnt[QMAX], nl[QMAX];              // buffered candidates, pairs in the list
  int flush_stage;                      // the last stage whose survivors need a flush
  unsigned long long full[STAGES], empty[STAGES];
};

// rows a stage of D-float rows holds: a multiple of one pass of every warp
// (PR * WARPS rows) where that fits, so the warps' work is even, at most
// RMAX; else whole passes; else (D > 1024) one 4-row group
__host__ __device__ constexpr int stage_rows(int D) {
  const int fit = STAGE_BYTES / (4 * D), all = PR * WARPS;
  return fit >= all ? (fit < RMAX ? fit : RMAX) / all * all : fit >= PR ? fit / PR * PR : 4;
}

// v: V (a power of two <= 32) partial sums a lane; afterwards lane l holds
// the warp's total of value idx = l / (32 / V), as do the other lanes of its
// group of 32 / V: halving exchanges while a lane has more than one value,
// then butterflies.  The order of every sum is fixed, so the bits are the
// same every run.
template <int V>
__device__ __forceinline__ float reduce_scatter(float (&v)[V], int lane, int& idx) {
  idx = 0;
  int o = 16;
#pragma unroll
  for (int n = V; n > 1; n >>= 1, o >>= 1) {
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = up ? v[i] : v[i + n / 2];
      const float keep = up ? v[i + n / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(topk::FULL, send, o);
    }
    idx += up ? n / 2 : 0;
  }
  for (; o > 0; o >>= 1) v[0] += __shfl_xor_sync(topk::FULL, v[0], o);
  return v[0];
}

// A pass's scores for NQ queries: lane l sums x^2 and x q over dimensions
// l, l + 32, ... of the pass's 8 rows (offsets ro in the stage xs), and one
// reduce-scatter of the 8 NQ partial values of ||x||^2 - 2 q.x (l2) or -q.x
// (ip) gives each lane the warp's total of one: row r of the pass, query b
// (b >= B: a padding query, never admitted).
template <int NQ>
__device__ __forceinline__ float score_pass(const float* xs, const int (&ro)[PR],
                                            const float* __restrict__ q, int B, int D,
                                            int metric, int lane, int& r, int& b) {
  float nrm[PR] = {}, acc[PR][NQ] = {};
#if !(REPRO_SCAN_OFF & 8)
  for (int d = lane; d < D; d += 32) {
    float xv[PR], qv[NQ];
#pragma unroll
    for (int i = 0; i < PR; ++i) xv[i] = xs[ro[i] + d];
#pragma unroll
    for (int j = 0; j < NQ; ++j) qv[j] = j < B ? __ldg(q + (size_t)j * D + d) : 0.f;
#pragma unroll
    for (int i = 0; i < PR; ++i) {
      nrm[i] = fmaf(xv[i], xv[i], nrm[i]);
#pragma unroll
      for (int j = 0; j < NQ; ++j) acc[i][j] = fmaf(xv[i], qv[j], acc[i][j]);
    }
  }
#endif
  float v[PR * NQ];
#pragma unroll
  for (int i = 0; i < PR; ++i)
#pragma unroll
    for (int j = 0; j < NQ; ++j)
      v[i * NQ + j] = metric == 0 ? nrm[i] - 2.f * acc[i][j] : -acc[i][j];
  int idx;
  const float sc = reduce_scatter<PR * NQ>(v, lane, idx);
  r = idx / NQ;
  b = idx % NQ;
  return sc;
}

}  // namespace small

// One block: the B (<= QMAX) queries against rows [c_begin, c_end) of chunk
// blockIdx.x, R rows a stage.  Lists, bounds and counts as the batched
// scan's.
template <int K>
__global__ void __launch_bounds__(small::THREADS, 1)
    small_scan_kernel(const float* __restrict__ q, const float* __restrict__ x,
                      float* __restrict__ list_d, int* __restrict__ list_i, float* bound,
                      int* counts, int B, int D, int n_valid, int nsplit, int chunk, int metric,
                      int R) {
  using namespace small;
  extern __shared__ __align__(16) unsigned char small_smem[];
  Smem& sm = *reinterpret_cast<Smem*>(small_smem);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int split = blockIdx.x;
  const int c_begin = split * chunk;
  const int c_end = min(c_begin + chunk, n_valid);
  const int total = c_end > c_begin ? (c_end - c_begin + R - 1) / R : 0;
  const auto full = [&](int s) { return wg::smem_u32(&sm.full[s]); };
  const auto empty = [&](int s) { return wg::smem_u32(&sm.empty[s]); };
  // byte offset of a stage's first row in its buffer: the source's address mod 16
  const auto skew = [&](int r0) {
    return (int)(reinterpret_cast<uintptr_t>(x + (size_t)r0 * D) & 15);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(full(s), 1);
      wg::mbar_init(empty(s), WARPS);
    }
    wg::mbar_fence_init();
  }
  if (tid == 0) sm.flush_stage = -1;
  if (tid < QMAX) {
    sm.th[tid] = tid < B ? topk::inf_f() : -topk::inf_f();
    sm.gth[tid] = topk::inf_f();
    sm.jb[tid] = topk::inf_f();
    sm.cnt[tid] = 0;
    sm.nl[tid] = 0;
  }
  __syncthreads();  // the only block-wide barrier

  if (w == WARPS) {  // the producer warp: a stage is one bulk copy of whole rows
    for (int s = 0; s < total; ++s) {
      // the other chunks' bounds, for the consumers' filter: the largest
      // published bound of chunks 0 .. nsplit - 2 of each query (bounds only
      // fall, so a consumer that reads an older one admits more, never less)
      if (bound != nullptr && s % REFRESH == 1)
        for (int b = 0; b < B; ++b) {
          float m = -topk::inf_f();
          for (int cc = lane; cc < nsplit - 1; cc += 32)
            m = fmaxf(m, *(volatile float*)(bound + (size_t)b * K + cc));
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(topk::FULL, m, o));
          if (lane == 0) *(volatile float*)&sm.gth[b] = m;
        }
      const int st = s % STAGES;
      if (s >= STAGES) wg::mbar_wait(empty(st), ((s / STAGES) & 1) ^ 1);
      const int r0 = c_begin + s * R;
      const int bytes = min(R, c_end - r0) * D * 4;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(x + (size_t)r0 * D);
      const int off = skew(r0);
      const int head = min((16 - off) & 15, bytes);
      const int mid = (bytes - head) & ~15;
      const int tail = bytes - head - mid;
      unsigned char* dst = sm.stage[st] + off;  // byte j of the rows at dst + j
      // the ragged ends, at most 3 words each, by the lanes
      if (lane < head / 4)
        reinterpret_cast<float*>(dst)[lane] = reinterpret_cast<const float*>(src)[lane];
      if (lane >= 4 && lane - 4 < tail / 4)
        reinterpret_cast<float*>(dst + head + mid)[lane - 4] =
            reinterpret_cast<const float*>(src + head + mid)[lane - 4];
      __syncwarp();
      if (lane == 0) {
        wg::mbar_expect_tx(full(st), mid);
        if (mid > 0) wg::bulk_load(wg::smem_u32(dst + head), src + head, mid, full(st));
      }
    }
    return;
  }

  // consumer warps
  const int jrank = bound != nullptr ? (K + nsplit - 2) / (nsplit - 1) : K;
  float sink = topk::inf_f();  // diagnostic builds without the filter
  SCAN_CLOCK_START();
  const auto list_of = [&](int b, float*& ld, int*& li) {
    const size_t base = ((size_t)b * nsplit + split) * K;
    ld = list_d + base;
    li = list_i + base;
  };
  // query b's buffer into its list (the calling warp alone), and its bound
  const auto flush_b = [&](int b) {
    SCAN_CLOCK_FLUSH_BEGIN();
    const int cn = sm.cnt[b];
    const float jb0 = sm.jb[b];
    float* ld;
    int* li;
    list_of(b, ld, li);
    topk::Flushed f = {sm.nl[b], sm.th[b], jb0};
    for (int o = 0; o < cn; o += topk::CB) {
      const topk::Flushed f1 = topk::flush<K>(sm.buf_d + b * CAP + o, sm.buf_i + b * CAP + o,
                                              min(cn - o, topk::CB), f.nl, jrank, ld, li, lane);
      f = {f1.nl, f1.th, fminf(f.jb, f1.jb)};
    }
    __syncwarp();
    if (lane == 0) {
      sm.cnt[b] = 0;
      sm.nl[b] = f.nl;
      sm.th[b] = f.th;
      sm.jb[b] = f.jb;
      if (bound != nullptr && f.jb < jb0) bound[(size_t)b * K + split] = f.jb;
    }
    __syncwarp();
    SCAN_CLOCK_FLUSH_END();
  };
  for (int s = 0; s < total; ++s) {
    const int st = s % STAGES;
    const int r0 = c_begin + s * R;
    const int rows = min(R, c_end - r0);
    SCAN_CLOCK_PRODUCTS_BEGIN();
    wg::mbar_wait(full(st), (s / STAGES) & 1);
    const float* xs = reinterpret_cast<const float*>(sm.stage[st] + skew(r0));
    // a pass: 8 rows (two 4-row groups) of the stage; rows past the stage's
    // last are read as its last and never admitted
    for (int gp = w; PR * gp < rows; gp += WARPS) {
      int ro[PR];  // offsets of the pass's rows
#pragma unroll
      for (int r = 0; r < PR; ++r) ro[r] = min(PR * gp + r, R - 1) * D;
      int r, b;  // this lane's row of the pass and query
      const float sc = B == 1   ? score_pass<1>(xs, ro, q, B, D, metric, lane, r, b)
                       : B == 2 ? score_pass<2>(xs, ro, q, B, D, metric, lane, r, b)
                                : score_pass<QMAX>(xs, ro, q, B, D, metric, lane, r, b);
      // lanes 32 / (PR nq) apart hold the same value; the first of them takes it
      const int nq = B <= 2 ? B : QMAX;
      const bool mine = (lane & (32 / (PR * nq) - 1)) == 0;
      const int row = PR * gp + r;
#if REPRO_SCAN_OFF & 4
      if (mine && b < B && row < rows) sink = fminf(sink, sc);
#else
      if (mine && b < B && row < rows && sc < topk::inf_f() &&
          sc <= fminf(sm.th[b], *(volatile float*)&sm.gth[b])) {
        const int slot = atomicAdd(&sm.cnt[b], 1);
        sm.buf_d[b * CAP + slot] = sc;
        sm.buf_i[b * CAP + slot] = r0 + row;
        if (slot >= CAP - R || sm.nl[b] < K) *(volatile int*)&sm.flush_stage = s;
      }
#endif
    }
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(empty(st));
    SCAN_CLOCK_PRODUCTS_END();
#if !(REPRO_SCAN_OFF & 4)
    // every survivor of the stage is in its buffer; if one of them filled a
    // buffer past what the next stage could add, or went to a list that is
    // not full yet, the warps flush their queries' buffers.  flush_stage is
    // written only before this barrier in stage s, so every warp reads the
    // same answer.
    wg::bar_sync<1, 32 * WARPS>();
    if (*(volatile int*)&sm.flush_stage == s) {
      for (int b = w; b < B; b += WARPS)
        if (sm.cnt[b] > CAP - R || (sm.nl[b] < K && sm.cnt[b] > 0)) flush_b(b);
      wg::bar_sync<1, 32 * WARPS>();
    }
#endif
  }
  if (sink == -1.2345f) list_d[0] = sink;
  SCAN_CLOCK_END_TILES();
#if !(REPRO_SCAN_OFF & 2)
  for (int b = w; b < B; b += WARPS) {  // the rest of each buffer; the counts, or one list
    if (sm.cnt[b] > 0) flush_b(b);
    float* ld;
    int* li;
    list_of(b, ld, li);
    topk::end_list<K>(ld, li, sm.nl[b], counts, (size_t)b * K + split, lane);
  }
#endif
  SCAN_CLOCK_END();
}

template <int K>
cudaError_t small_launch(const float* q, const float* x, float* part_d, int* part_i,
                         float* out_d, int* out_i, int B, int D, int n_valid, int metric,
                         int nsplit, int chunk, cudaStream_t stream) {
  using namespace small;
  const int R = stage_rows(D);
  if (B > QMAX || R < 4 || chunk % 4) return cudaErrorInvalidValue;
  const int bytes = (int)sizeof(Smem);
  cudaError_t e = cudaFuncSetAttribute(small_scan_kernel<K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const auto scan_ = [&](float* ld, int* li, float* bound, int* counts) {
    small_scan_kernel<K><<<nsplit, THREADS, bytes, stream>>>(q, x, ld, li, bound, counts, B, D,
                                                             n_valid, nsplit, chunk, metric, R);
    return cudaGetLastError();
  };
  return scan::launch_chunks<K>(scan_, part_d, part_i, out_d, out_i, B, nsplit, stream);
}

}  // namespace

// The instance of k_pad K and path PATH.  The library links seven
// translation units of this file (kernels/_build.py UNITS), so that the
// instances, the longest part of the build, compile in parallel: built with
// -DREPRO_K=K -DREPRO_PATH=PATH a unit defines that instance; built without
// REPRO_K, the C entry below, which calls them.
template <int K, int PATH>
cudaError_t k1_launch(const float* q, const float* x, float* part_d, int* part_i, float* out_d,
                      int* out_i, int B, int D, int n_valid, int metric, int nsplit, int chunk,
                      cudaStream_t stream);

#ifdef REPRO_K
template <int K, int PATH>
cudaError_t k1_launch(const float* q, const float* x, float* part_d, int* part_i, float* out_d,
                      int* out_i, int B, int D, int n_valid, int metric, int nsplit, int chunk,
                      cudaStream_t stream) {
  if constexpr (PATH == 1)
    return small_launch<K>(q, x, part_d, part_i, out_d, out_i, B, D, n_valid, metric, nsplit,
                           chunk, stream);
  else
    return scan::launch<F32Op, K>(q, x, F32Op::Args{metric}, part_d, part_i, out_d, out_i, B, D,
                                  n_valid, nsplit, chunk, stream);
}

template cudaError_t k1_launch<REPRO_K, REPRO_PATH>(const float*, const float*, float*, int*,
                                                    float*, int*, int, int, int, int, int, int,
                                                    cudaStream_t);
#else

// the instance of k_pad K, on the path asked for
template <int K>
cudaError_t k1_path(const float* q, const float* x, float* part_d, int* part_i, float* out_d,
                    int* out_i, int B, int D, int n_valid, int metric, int nsplit, int chunk,
                    int path, cudaStream_t stream) {
  return path == 1 ? k1_launch<K, 1>(q, x, part_d, part_i, out_d, out_i, B, D, n_valid, metric,
                                     nsplit, chunk, stream)
                   : k1_launch<K, 0>(q, x, part_d, part_i, out_d, out_i, B, D, n_valid, metric,
                                     nsplit, chunk, stream);
}

// q (B, D) and x (N, D) float32 row-major on the device; out_d/out_i (B,
// k_pad); part_d/part_i (B, nsplit, k_pad) scratch, unused when nsplit == 1.
// Corpus chunk s covers rows [s * chunk, min((s + 1) * chunk, n_valid)).
// metric: 0 = l2, 1 = ip.  k_pad: 128, 256 or 512.  path: 0 the batched
// scan, 1 the small-batch scan (B <= 4, D <= 2048, chunk a multiple of 4).
// Returns a cudaError_t.
extern "C" int repro_distance_topk(const float* q, const float* x, float* part_d, int* part_i,
                                   float* out_d, int* out_i, int B, int D, int n_valid,
                                   int k_pad, int metric, int nsplit, int chunk, int path,
                                   void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (B <= 0 || D <= 0 || n_valid <= 0 || nsplit <= 0 || chunk <= 0 || nsplit > 65535 ||
      (metric != 0 && metric != 1) || (path != 0 && path != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (k_pad == 128)
    e = k1_path<128>(q, x, part_d, part_i, out_d, out_i, B, D, n_valid, metric, nsplit, chunk,
                     path, st);
  else if (k_pad == 256)
    e = k1_path<256>(q, x, part_d, part_i, out_d, out_i, B, D, n_valid, metric, nsplit, chunk,
                     path, st);
  else if (k_pad == 512)
    e = k1_path<512>(q, x, part_d, part_i, out_d, out_i, B, D, n_valid, metric, nsplit, chunk,
                     path, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
#endif
