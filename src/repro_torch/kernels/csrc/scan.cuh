// The scan kernel shared by K1 (distance_topk.cu, float32 as a 3xTF32
// split) and K2 (distance_topk_q8.cu, int8 codes): tensor-core scores of a
// query tile against one chunk of corpus rows, fed from the accumulators
// into a streaming top-k (topk.cuh).  The two differ only in their
// operation (Op below): how a k-step of MMAs is issued and how an
// accumulator becomes a score.
//
// Layout.  Rows are read as 32-bit words (K1: floats; K2: four int8 codes).
// A block owns TQ = 64 queries and one chunk of corpus rows, walked in
// tiles of TN = 64 rows, each tile in slices of TD = 32 words.  Both MMA
// shapes (m16n8k8 tf32, m16n8k32 s8) read a k-step of 8 words, and their
// A and B fragments sit on the same words: lane (g, t) holds word t and
// t + 4 of rows g and g + 8.  So one ldmatrix.x4 on a word tile gives an A
// fragment, or the B fragments of two n8 tiles, for either kernel.  Shared
// rows are padded to 36 words, so each ldmatrix phase hits 8 distinct
// 16-byte bank groups.
//
//  * A producer warp keeps a STAGES-deep ring of (q slice, x slice) pairs
//    in flight with cp.async (16-byte copies when a row is a whole number
//    of 16-byte chunks, else 4-byte ones); each lane's copies arrive on the
//    stage's "full" mbarrier.  Rows past the chunk or past B, and words past
//    the row, are zero-filled (src-size 0) and never read from memory.
//  * Four consumer warps each own 16 queries (one m16 tile) for the whole
//    chunk and compute all 64 rows of a tile: 8 n8 accumulators a lane.  A
//    warp releases a stage with one arrive on its "empty" mbarrier; the
//    producer waits only for that.  No barrier spans the block after the
//    start, so a warp that is flushing holds no other warp back by more
//    than the ring's depth.
//  * Top-k from the registers: after a tile's last slice each lane turns
//    its accumulators into scores and compares them with the thresholds of
//    its two queries (rows g and g + 8), held in registers.  A warp with no
//    survivor moves on after one vote.  Survivors enter their query's
//    64-slot buffer in shared memory at slots a quad-wide prefix count
//    gives; a buffer that would overflow is flushed first, by the owning
//    warp alone (topk.cuh).  There is no score tile.
//  * Cross-chunk bounds.  The grid is one wave, so all chunks of a query
//    run at once.  Each publishes, after every tile, an upper bound of its
//    j-th best score, j = ceil(K / (nsplit - 1)): the largest of its lanes'
//    m-th smallest, m = ceil(j / 4), over the 4 lanes that hold the query
//    (4 m distinct rows).  The largest published bound of chunks 0 ..
//    nsplit - 2 has at least K rows at or below it, so it bounds the
//    query's final K-th best, and a chunk admits only scores below
//    min(its own K-th best, that bound).  Every pair that beats the final
//    K-th best reaches the merge; pairs equal to it may not (a tie at the
//    k-th place).  The first WARM tiles, scanned before the bounds exist,
//    admit nothing and are scanned again at the end of the chunk.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk.cuh"

namespace scan {

using topk::CB;
using topk::FULL;

constexpr int CWARPS = 4;              // consumer warps, 16 queries each
constexpr int TQ = 16 * CWARPS;        // queries per block
constexpr int TN = 64;                 // corpus rows per tile
constexpr int NJ = TN / 8;             // n8 tiles of a tile
constexpr int TD = 32;                 // words per slice
constexpr int KS = TD / 8;             // k-steps per slice
constexpr int LDW = TD + 4;            // shared row stride in words: conflict-free ldmatrix
constexpr int STAGES = 4;              // depth of the ring
constexpr int REFRESH = 2;             // tiles between reads of the cross-chunk bounds
constexpr int CAP = 2 * CB;            // buffer slots per query: a tile's 64 rows fit
constexpr int LANE_BEST = 4;           // scores a lane keeps per query for the bounds
constexpr int BEST_STRIDE = 32 * CWARPS;
constexpr int WARM = 2;                // tiles that may wait for the bounds
constexpr int THREADS = 32 * (CWARPS + 1);  // + the producer warp

struct Smem {
  uint32_t x[STAGES][TN * LDW];
  uint32_t q[STAGES][TQ * LDW];
  float aux[STAGES][TN];  // per-row term of the tile (K2: norms2), last-slice stages
  float buf_d[TQ * CAP];  // candidate buffers
  int buf_i[TQ * CAP];
  float best[2 * LANE_BEST * BEST_STRIDE];  // each lane's smallest scores
  unsigned long long full[STAGES];
  unsigned long long empty[STAGES];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared.b64 st, [%0];\n}\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// the arrival fires when this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_cp_async(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, int parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// rows [r0, r0 + ROWS) x words [d0, d0 + TD) of a (rows, DW) word matrix
// into a padded stage; rows >= r_end and words >= DW are zero-filled.
template <int ROWS, bool VEC>
__device__ __forceinline__ void load_slice(uint32_t* dst, const uint32_t* src, int r0, int r_end,
                                           int d0, int DW, int lane) {
  if (VEC) {
    constexpr int CH = TD / 4;  // 16-byte chunks per row slice
#pragma unroll 4
    for (int i = lane; i < ROWS * CH; i += 32) {
      const int r = i / CH, c = d0 + (i % CH) * 4;
      const bool in = r0 + r < r_end && c < DW;
      const uint32_t* g = src + (in ? (size_t)(r0 + r) * DW + c : 0);
      cp_async16(smem_addr(dst + r * LDW + (i % CH) * 4), g, in);
    }
  } else {
#pragma unroll 4
    for (int i = lane; i < ROWS * TD; i += 32) {
      const int r = i / TD, c = d0 + i % TD;
      const bool in = r0 + r < r_end && c < DW;
      const uint32_t* g = src + (in ? (size_t)(r0 + r) * DW + c : 0);
      cp_async4(smem_addr(dst + r * LDW + i % TD), g, in);
    }
  }
}

// One block: queries [q0, q0 + TQ) against rows [c_begin, c_end) of chunk
// blockIdx.y.  Lists go to list_d/list_i[(b * nsplit + split) * K ...];
// bound (nullptr when nsplit == 1) holds, at bound[b * K + split], an upper
// bound of chunk split's j-th best for query b, j = ceil(K / (nsplit - 1)).
template <class Op, int K, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
scan_topk_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ x,
                 typename Op::Args args, float* __restrict__ list_d, int* __restrict__ list_i,
                 float* bound, int B, int DW, int n_valid, int nsplit, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int q0 = blockIdx.x * TQ;
  const int split = blockIdx.y;
  const int c_begin = split * chunk;
  const int c_end = min(c_begin + chunk, n_valid);
  const int n_tiles = c_end > c_begin ? (c_end - c_begin + TN - 1) / TN : 0;
  // tiles scanned before the cross-chunk bounds arrive are scanned again at
  // the end (tile n_tiles + i is tile i)
  const int n_warm = bound != nullptr ? min(WARM, n_tiles) : 0;
  const int n_sl = (DW + TD - 1) / TD;
  const int total = (n_tiles + n_warm) * n_sl;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 32);
      mbar_init(&sm.empty[s], CWARPS);
    }
  }
  __syncthreads();  // the only block-wide barrier

  if (w == CWARPS) {  // producer
    for (int it = 0; it < total; ++it) {
      const int st = it % STAGES;
      if (it >= STAGES) mbar_wait(&sm.empty[st], ((it / STAGES) & 1) ^ 1);
      const int tile = it / n_sl;
      const int r0 = c_begin + (tile < n_tiles ? tile : tile - n_tiles) * TN;
      const int sl = it % n_sl;
      load_slice<TQ, VEC>(sm.q[st], q, q0, B, sl * TD, DW, lane);
      load_slice<TN, VEC>(sm.x[st], x, r0, c_end, sl * TD, DW, lane);
      if (Op::AUX && sl == n_sl - 1) {
        for (int r = lane; r < TN; r += 32) {
          const bool in = r0 + r < c_end;
          cp_async4(smem_addr(&sm.aux[st][r]), Op::aux_ptr(args) + (in ? r0 + r : 0), in);
        }
      }
      mbar_arrive_cp_async(&sm.full[st]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // consumer warp w: queries q0 + 16 w + g and + 8 (g = lane / 4, t = lane % 4)
  const int g = lane >> 2, t = lane & 3;
  const int qw = 16 * w;  // first query of the warp in the block
  float* bd = sm.buf_d + qw * CAP;
  int* bi = sm.buf_i + qw * CAP;
  float* best = sm.best + w * 32 + lane;  // slot (h, i) at best[(h * LANE_BEST + i) * BEST_STRIDE]
  float th[2], gth[2];  // own K-th best, cross-chunk bound (queries g, g + 8)
  float jb[2];          // the bound of this chunk's j-th best we published
  float bw[2];          // the largest of this lane's LANE_BEST smallest scores
  int cnt[2], nl[2];    // buffered candidates, pairs in the list
  bool qok[2];
  typename Op::Lane ol;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = q0 + qw + g + 8 * h;
    qok[h] = b < B;
    th[h] = qok[h] ? topk::inf_f() : -topk::inf_f();
    gth[h] = topk::inf_f();
    jb[h] = topk::inf_f();
    bw[h] = topk::inf_f();
    cnt[h] = 0;
    nl[h] = 0;
#pragma unroll
    for (int i = 0; i < LANE_BEST; ++i) best[(h * LANE_BEST + i) * BEST_STRIDE] = topk::inf_f();
    Op::init_lane(ol, args, h, qok[h] ? b : 0);
  }
  auto list_of = [&](int u, float*& ld, int*& li) {
    const size_t base = ((size_t)(q0 + qw + u) * nsplit + split) * K;
    ld = list_d + base;
    li = list_i + base;
  };
  // j: the rank each chunk publishes.  The j best of each of the first
  // nsplit - 1 chunks are >= K pairs, so the largest of their published
  // bounds bounds the query's K-th best over all rows (the last chunk may
  // be short, and is left out).
  const int jrank = bound != nullptr ? (K + nsplit - 2) / (nsplit - 1) : K;
  // Each lane keeps its LANE_BEST smallest scores per query, so the 4 lanes
  // of a quad hold 4 * LANE_BEST distinct rows: the largest of their
  // mrank-th smallest bounds the chunk's j-th best after every tile.
  const int mrank = (jrank + 3) / 4;
  const bool lane_bounds = bound != nullptr && mrank <= LANE_BEST;
  // flush query u's buffer (warp-uniform u; CB pairs at a time) and update
  // its owners' state
  auto flush_u = [&](int u, int h) {
    const int src = 4 * (u & 7);
    const int c = __shfl_sync(FULL, cnt[h], src);
    const int n0 = __shfl_sync(FULL, nl[h], src);
    const float jb0 = __shfl_sync(FULL, jb[h], src);
    float* ld;
    int* li;
    list_of(u, ld, li);
    topk::Flushed f = {n0, 0.f, jb0};
    for (int off = 0; off < c; off += CB) {
      const topk::Flushed f1 = topk::flush<K>(bd + u * CAP + off, bi + u * CAP + off,
                                              min(c - off, CB), f.nl, jrank, ld, li, lane);
      f = {f1.nl, f1.th, fminf(f.jb, f1.jb)};
    }
    if (g == (u & 7)) {
      cnt[h] = 0;
      nl[h] = f.nl;
      th[h] = f.th;
      jb[h] = f.jb;
    }
    if (bound != nullptr && lane == 0 && f.jb < jb0)
      bound[(size_t)(q0 + qw + u) * K + split] = f.jb;
  };
  // the cross-chunk bound of each query of the warp: the largest published
  // bound of chunks 0 .. nsplit - 2.  Lane l reads query l % 16's bounds of
  // chunks l / 16, + 2, ..., so the loads of all 16 queries are in flight
  // together.
  auto refresh = [&]() {
    const int b = q0 + qw + (lane & 15);
    float m = -topk::inf_f();
    if (b < B)
      for (int c = lane >> 4; c < nsplit - 1; c += 2)
        m = fmaxf(m, *(volatile float*)(bound + (size_t)b * K + c));
    m = fmaxf(m, __shfl_xor_sync(FULL, m, 16));
    gth[0] = __shfl_sync(FULL, m, g);
    gth[1] = __shfl_sync(FULL, m, g + 8);
  };

  int skipped = 0;  // tiles 0 .. skipped - 1 admit nothing until their second scan
  for (int tile = 0; tile < n_tiles + n_warm; ++tile) {
    const bool again = tile >= n_tiles;
    const int r0 = c_begin + (again ? tile - n_tiles : tile) * TN;
    if (bound != nullptr && tile > 0 && (tile <= WARM || tile % REFRESH == 0)) refresh();
    typename Op::Acc acc;
    Op::zero(acc);
    for (int sl = 0; sl < n_sl; ++sl) {
      const int it = tile * n_sl + sl;
      const int st = it % STAGES;
      mbar_wait(&sm.full[st], (it / STAGES) & 1);
      if (Op::AUX && sl == n_sl - 1) Op::read_aux(ol, sm.aux[st], t);
      const uint32_t* qs = sm.q[st];
      const uint32_t* xs = sm.x[st];
#pragma unroll 1  // one k-step of fragments live at a time (fewer spills)
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_addr(qs + (qw + (lane & 7) + ((lane >> 3) & 1) * 8) * LDW + kk * 8 +
                                 (lane >> 4) * 4));
        uint32_t bf[NJ / 2][4];
#pragma unroll
        for (int jp = 0; jp < NJ / 2; ++jp)
          ldmatrix_x4(bf[jp], smem_addr(xs + (16 * jp + (lane & 7) + (lane >> 4) * 8) * LDW +
                                        kk * 8 + ((lane >> 3) & 1) * 4));
        Op::kstep(acc, ol, a, bf);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[st]);
    }
    if (again && tile - n_tiles >= skipped) continue;  // admitted the first time

    // scores: s[j][e] of query g + 8 (e >> 1), row r0 + 8 j + 2 t + (e & 1)
    float s[NJ][4];
    Op::scores(s, acc, ol, args, lane);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (r0 + 8 * j + 2 * t + (e & 1) >= c_end) s[j][e] = topk::inf_f();
    if (lane_bounds && !again) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bool ins = false;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) ins |= s[j][2 * h + e] < bw[h];
        float m = topk::inf_f();
        if (ins) {  // insert this tile's scores into the lane's smallest
          float bl[LANE_BEST];
#pragma unroll
          for (int i = 0; i < LANE_BEST; ++i) bl[i] = best[(h * LANE_BEST + i) * BEST_STRIDE];
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float v = s[j][2 * h + e];
#pragma unroll
              for (int i = 0; i < LANE_BEST; ++i) {
                const float lo = fminf(bl[i], v);
                v = fmaxf(bl[i], v);
                bl[i] = lo;
              }
            }
#pragma unroll
          for (int i = 0; i < LANE_BEST; ++i) {
            best[(h * LANE_BEST + i) * BEST_STRIDE] = bl[i];
            if (i == mrank - 1) m = bl[i];
          }
          bw[h] = bl[LANE_BEST - 1];
        }
        if (__any_sync(FULL, ins)) {
          if (!ins) m = best[(h * LANE_BEST + mrank - 1) * BEST_STRIDE];
          m = fmaxf(m, __shfl_xor_sync(FULL, m, 1));
          m = fmaxf(m, __shfl_xor_sync(FULL, m, 2));
          if (m < jb[h]) {
            jb[h] = m;
            if (t == 0 && qok[h]) bound[(size_t)(q0 + qw + g + 8 * h) * K + split] = m;
          }
        }
      }
    }
    if (!again && tile == skipped && tile < n_warm &&
        __any_sync(FULL, (qok[0] && gth[0] == topk::inf_f()) ||
                             (qok[1] && gth[1] == topk::inf_f()))) {
      skipped = tile + 1;  // no bound yet: admit this tile on its second scan
      continue;
    }

    // survivors: bit 2 j + (e & 1) of mask[e >> 1]
    unsigned mask[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (s[j][e] <= fminf(th[e >> 1], gth[e >> 1]) && s[j][e] < topk::inf_f())
          mask[e >> 1] |= 1u << (2 * j + (e & 1));
    if (!__any_sync(FULL, (mask[0] | mask[1]) != 0u)) continue;

    // a query's survivors come from the 4 lanes of its quad: each lane's
    // first slot is the quad's count before it
    int pre[2], tot[2];
    auto quad_scan = [&](int h) {
      const int c = __popc(mask[h]);
      int x = c, y = __shfl_up_sync(FULL, x, 1, 4);
      if (t >= 1) x += y;
      y = __shfl_up_sync(FULL, x, 2, 4);
      if (t >= 2) x += y;
      pre[h] = x - c;
      tot[h] = __shfl_sync(FULL, x, 3, 4);
    };
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      quad_scan(h);
      unsigned need = __ballot_sync(FULL, t == 0 && cnt[h] + tot[h] > CAP);
      if (need) {  // make room: flush those queries, then filter again
        while (need) {
          const int src = __ffs(need) - 1;
          need &= need - 1;
          flush_u((src >> 2) + 8 * h, h);
        }
        const float thr = fminf(th[h], gth[h]);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (!(s[j][2 * h + e] <= thr)) mask[h] &= ~(1u << (2 * j + e));
        quad_scan(h);
      }
      int slot = (g + 8 * h) * CAP + cnt[h] + pre[h];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (mask[h] & (1u << (2 * j + e))) {
            bd[slot] = s[j][2 * h + e];
            bi[slot] = r0 + 8 * j + 2 * t + e;
            ++slot;
          }
      cnt[h] += tot[h];
    }
    __syncwarp();
  }

  // the rest of each buffer, then lists that never filled: pad and sort
  for (int u = 0; u < 16; ++u) {
    if (q0 + qw + u >= B) break;
    const int h = u >> 3;
    const int src = 4 * (u & 7);
    const int c = __shfl_sync(FULL, h ? cnt[1] : cnt[0], src);
    if (c > 0) {
      if (h)
        flush_u(u, 1);
      else
        flush_u(u, 0);
    }
    const int n0 = __shfl_sync(FULL, h ? nl[1] : nl[0], src);
    if (n0 < K) {
      float* ld;
      int* li;
      list_of(u, ld, li);
      topk::finish_list<K>(ld, li, n0, lane);
    }
  }
}

// static: every translation unit that includes this defines its own (K1 and
// K2 link several units into one library, kernels/_build.py UNITS)
static __global__ void init_bounds(float* bound, int B, int nsplit, int K) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B * nsplit) bound[(size_t)(i / nsplit) * K + i % nsplit] = topk::inf_f();
}

// Launch the scan (and, for nsplit > 1, the bound init before it and
// the chunk merge after it).  q, x: word matrices with DW words a row.
template <class Op, int K>
cudaError_t launch(const uint32_t* q, const uint32_t* x, typename Op::Args args, float* part_d,
                   int* part_i, float* out_d, int* out_i, int B, int DW, int n_valid,
                   int nsplit, int chunk, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem);
  const bool vec = DW % 4 == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  auto kernel = vec ? scan_topk_kernel<Op, K, true> : scan_topk_kernel<Op, K, false>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const bool direct = nsplit == 1;  // one chunk: its list is the answer
  float* bound = nullptr;
  if (!direct) {  // out_d is free until the merge writes it
    if (nsplit > K) return cudaErrorInvalidValue;
    bound = out_d;
    init_bounds<<<(B * nsplit + 255) / 256, 256, 0, stream>>>(bound, B, nsplit, K);
  }
  const dim3 grid((B + TQ - 1) / TQ, nsplit);
  kernel<<<grid, THREADS, smem, stream>>>(q, x, args, direct ? out_d : part_d,
                                          direct ? out_i : part_i, bound, B, DW, n_valid, nsplit,
                                          chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess || direct) return e;
  return topk::launch_merge<K>(part_d, part_i, out_d, out_i, B, nsplit, stream);
}

}  // namespace scan
