// The batched scan shared by K1 (distance_topk.cu, float32 as a 3xTF32
// split) and K2 (distance_topk_q8.cu, int8 codes): warpgroup MMAs (wgmma)
// of a query tile against one chunk of corpus rows, fed by TMA, with a
// streaming top-k taken from the accumulators (topk.cuh).  The two differ
// only in their operation (Op below): how a slice of products is issued,
// whether the producer splits the corpus slice first, and how an
// accumulator becomes a score.  K1 at a small batch runs its own kernel
// (distance_topk.cu); everything else runs here.
//
// What bounds it.  K1 does 2 B N D float32-grade operations (three TF32
// products each) on N D rows that every query tile shares: at the paper
// partition (440 x 124,606 x 128) 0.085 ms at 165 TFLOP/s against 0.065 ms
// of bytes, so the tensor cores' rate.  K2's int8 products are 2 B N D at
// 1,979 TOP/s (0.007 ms there): what bounds K2 is the selection around
// them, which these kernels share.
//
// Layout.  Rows are read in slices of one 128-byte swizzle row (K1: 32
// floats, K2: 128 codes); a tile is TN = 64 corpus rows, the wgmma's N; a
// block owns TQ = 128 queries, two consumer warpgroups of 64 (the wgmma's
// M), and one chunk of corpus rows.  Queries are A and corpus rows B: the
// accumulator of m64n64 gives warp w of a warpgroup queries 16 w + g and
// + 8 (g = lane / 4) and corpus rows 2 t, 2 t + 1 (t = lane % 4) of each
// n8 group, the layout of the m16n8 tiles this selection was written for,
// so the filter, the bounds and the flushes read the scores where they sit.
//
//  * The producer warpgroup (128 threads) keeps the ring full.  Slices
//    whose rows are a multiple of 16 bytes come by TMA (2-D tensor maps
//    built on the host, rows past n_valid and columns past D zero-filled);
//    others by 4-byte cp.async into the same swizzled layout.  The block's
//    q slices stay resident for the whole chunk when D fits QSLOTS slices
//    (K1 D <= 128, K2 D <= 512), else they stream through the ring with
//    the corpus slices.
//  * K1: TF32 wgmma reads B from shared memory only, so the corpus slice
//    lands raw (a 2-slot landing ring) and the producer's 128 threads split
//    it once a block into hi = tf32(x) and lo = tf32(x - hi) planes of the
//    stage, and sum ||x||^2 of each row on the way.  (Landing in the stage
//    and splitting in place, with no landing ring, was 7-12% slower: the
//    producer then waits for the consumers' release before each split.)  Each consumer splits
//    its own q fragments in registers, and a slice is lo.hi, hi.lo, hi.hi
//    (small terms first) as register-A wgmmas: 12 m64n64k8 a slice.  K2:
//    the raw slices are both operands, 4 m64n64k32 s8 a slice, exact s32
//    sums; the producer brings each tile's norms2 with its last slice.
//  * A consumer warp releases a stage with one arrive on its "empty"
//    mbarrier once its wgmmas have read it; the producer waits only for
//    that.  No barrier spans the block after the start.
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
//    min(its own K-th best, that bound).  Every pair at or below the final
//    K-th best reaches the merge, so the result is the same in every run.
//    The first WARM tiles, scanned before the bounds exist, admit nothing
//    and are scanned again at the end of the chunk.
//  * The chunk end flushes what is left in the buffers and leaves each list
//    sorted and unpadded with its count beside it; the chunk merge
//    (topk.cuh) takes from each list only the prefix at or below the
//    query's bound.  Sorting and padding every (query, chunk) list to K and
//    merging the lists one after another took 45% of K2's time at k_pad
//    128 and 61% at 512 (PERF.md).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk.cuh"
#include "wgmma.cuh"

// Diagnostic builds (tools/scan_time.py) split the scan's time: bits of
// REPRO_SCAN_OFF compile parts out (1 the chunk merge, 2 the chunk end, 4
// the filter with the bounds and flushes, 8 the products), and
// REPRO_SCAN_CLOCKS sums clock64 over the consumer warps.  Neither is set
// in the package's build.
#ifndef REPRO_SCAN_OFF
#define REPRO_SCAN_OFF 0
#endif
#if defined(REPRO_SCAN_CLOCKS) && defined(REPRO_K)
static __device__ unsigned long long scan_clock_sums[4];  // total, products, flushes, chunk end
#define SCAN_CLOCK_CAT(a, b, c) a##b##_##c
#define SCAN_CLOCK_FN(k, path) SCAN_CLOCK_CAT(repro_scan_clocks_, k, path)
#ifndef REPRO_PATH
#define REPRO_PATH 0
#endif
// repro_scan_clocks_<k_pad>_<path> (K2's units have path 0)
extern "C" int SCAN_CLOCK_FN(REPRO_K, REPRO_PATH)(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, scan_clock_sums, sizeof(scan_clock_sums));
  unsigned long long zero[4] = {0, 0, 0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(scan_clock_sums, zero, sizeof(zero));
  return (int)e;
}
#define SCAN_CLOCK_START() \
  long long ck_t0 = clock64(), ck_p = 0, ck_f = 0, ck_e = 0, ck_a = 0, ck_b = 0, ck_e0 = 0
#define SCAN_CLOCK_PRODUCTS_BEGIN() ck_a = clock64()
#define SCAN_CLOCK_PRODUCTS_END() ck_p += clock64() - ck_a
#define SCAN_CLOCK_FLUSH_BEGIN() ck_b = clock64()
#define SCAN_CLOCK_FLUSH_END() ck_f += clock64() - ck_b
#define SCAN_CLOCK_END_TILES() ck_e0 = clock64()
#define SCAN_CLOCK_END()                                                              \
  do {                                                                                \
    ck_e = clock64() - ck_e0;                                                         \
    if ((threadIdx.x & 31) == 0) {                                                    \
      atomicAdd(&scan_clock_sums[0], (unsigned long long)(clock64() - ck_t0));        \
      atomicAdd(&scan_clock_sums[1], (unsigned long long)ck_p);                       \
      atomicAdd(&scan_clock_sums[2], (unsigned long long)ck_f);                       \
      atomicAdd(&scan_clock_sums[3], (unsigned long long)ck_e);                       \
    }                                                                                 \
  } while (0)
#else
#define SCAN_CLOCK_START()
#define SCAN_CLOCK_PRODUCTS_BEGIN()
#define SCAN_CLOCK_PRODUCTS_END()
#define SCAN_CLOCK_FLUSH_BEGIN()
#define SCAN_CLOCK_FLUSH_END()
#define SCAN_CLOCK_END_TILES()
#define SCAN_CLOCK_END()
#endif

namespace scan {

using topk::CB;
using topk::FULL;

constexpr int WG = 128;                  // threads of a warpgroup
constexpr int CONSUMERS = 2;             // consumer warpgroups, 64 queries each
constexpr int CWARPS = 4 * CONSUMERS;    // consumer warps, 16 queries each
constexpr int TQ = 64 * CONSUMERS;       // queries per block
constexpr int TN = 64;                   // corpus rows per tile: the wgmma's N
constexpr int NJ = TN / 8;               // n8 groups of a tile
constexpr int SB = 128;                  // bytes of a slice row: one swizzle row
constexpr int SW = SB / 4;               // 32-bit words of a slice row
constexpr int KSTEPS = SB / 32;          // wgmma k-steps (32 bytes) of a slice
constexpr int STAGES = 4;                // depth of the ring
constexpr int RAWS = 2;                  // K1's landing slots of raw corpus slices
constexpr int QSLOTS = STAGES;           // q slices: resident if D fits, else with the ring
constexpr int REFRESH = 2;               // tiles between reads of the cross-chunk bounds
constexpr int CAP = 2 * CB;              // buffer slots per query: a tile's 64 rows fit
constexpr int LANE_BEST = 4;             // scores a lane keeps per query for the bounds
constexpr int BEST_STRIDE = 32 * CWARPS;
constexpr int WARM = 2;                  // tiles that may wait for the bounds
constexpr int THREADS = WG * (1 + CONSUMERS);  // + the producer warpgroup
// setmaxnreg: the producer warpgroup gives registers to the consumers, whose
// flushes at k_pad 512 hold 32 list registers a lane (56 x 128 + 224 x 256
// = 168 x 384, the launch's allotment)
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
constexpr int X_BYTES = TN * SB;         // a corpus slice of a tile
constexpr int Q_BYTES = TQ * SB;         // a q slice of the block

// byte offsets from the 1024-aligned base of the dynamic shared memory
template <class Op>
struct Layout {
  static constexpr int Q0 = 0;                                  // QSLOTS q slices
  static constexpr int RAW0 = Q0 + QSLOTS * Q_BYTES;            // K1's landing slots
  static constexpr int STAGE0 = RAW0 + (Op::SPLIT ? RAWS * X_BYTES : 0);
  static constexpr int STAGE = (Op::SPLIT ? 2 : 1) * X_BYTES;   // K1: hi, lo; K2: the slice
  static constexpr int AUX0 = STAGE0 + STAGES * STAGE;          // a tile's row terms a stage
  static constexpr int BUF_D = AUX0 + STAGES * TN * 4;          // candidate buffers
  static constexpr int BUF_I = BUF_D + TQ * CAP * 4;
  static constexpr int BEST = BUF_I + TQ * CAP * 4;             // each lane's smallest scores
  static constexpr int BARS = BEST + 2 * LANE_BEST * BEST_STRIDE * 4;
  // full and empty a stage, one a landing slot, one a q slot
  static constexpr int NBARS = 2 * STAGES + RAWS + QSLOTS;
  static constexpr int BYTES = BARS + NBARS * 8 + 1024;         // + the alignment slack
  static_assert(BYTES <= 232448, "the block's shared memory");
};

// byte offset of 32-bit word w of row r of a slice under the 128-byte swizzle
__device__ __forceinline__ uint32_t swz(int r, int w) {
  return r * SB + ((((w >> 2) ^ (r & 7)) << 4) | ((w & 3) << 2));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

// rows [r0, r0 + ROWS) x words [w0, w0 + SW) of a (rows, DW) word matrix
// into a swizzled slice at dst by 4-byte cp.async, thread t of the
// producer warpgroup; rows >= r_end and words >= DW are zero-filled.
template <int ROWS>
__device__ __forceinline__ void cp_slice(uint32_t dst, const uint32_t* src, int r0, int r_end,
                                         int w0, int DW, int t) {
#pragma unroll 4
  for (int i = t; i < ROWS * SW; i += WG) {
    const int r = i / SW, w = i % SW;
    const bool in = r0 + r < r_end && w0 + w < DW;
    cp_async4(dst + swz(r, w), src + (in ? (size_t)(r0 + r) * DW + w0 + w : 0), in);
  }
}

// One block: queries [q0, q0 + TQ) against rows [c_begin, c_end) of chunk
// blockIdx.y.  Lists go to list_d/list_i[(b * nsplit + split) * K ...];
// bound (nullptr when nsplit == 1) holds, at bound[b * K + split], an upper
// bound of chunk split's j-th best for query b, j = ceil(K / (nsplit - 1)),
// and counts[b * K + split] gets the length of that list (its entries are
// sorted pieces; the chunk merge sorts them).  With one chunk the list is
// sorted and padded to K instead.  tma: slices come by TMA through qmap /
// xmap, else by cp.async from q / x.
template <class Op, int K>
__global__ void __launch_bounds__(THREADS, 1)
    scan_topk_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap xmap, const uint32_t* __restrict__ q,
                     const uint32_t* __restrict__ x, typename Op::Args args,
                     float* __restrict__ list_d, int* __restrict__ list_i, float* bound,
                     int* counts, int B, int DW, int n_valid, int nsplit, int chunk, int tma) {
  using L = Layout<Op>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw_addr = wg::smem_u32(smem_raw);
  const uint32_t base = (raw_addr + 1023) & ~1023u;
  unsigned char* sp = smem_raw + (base - raw_addr);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * TQ;
  const int split = blockIdx.y;
  const int c_begin = split * chunk;
  const int c_end = min(c_begin + chunk, n_valid);
  const int n_tiles = c_end > c_begin ? (c_end - c_begin + TN - 1) / TN : 0;
  // tiles scanned before the cross-chunk bounds arrive are scanned again at
  // the end (tile n_tiles + i is tile i)
  const int n_warm = bound != nullptr ? min(WARM, n_tiles) : 0;
  const int n_sl = (DW + SW - 1) / SW;
  const int total = (n_tiles + n_warm) * n_sl;
  const bool q_res = n_sl <= QSLOTS;
  const uint32_t bars = base + L::BARS;
  const auto full = [&](int s) { return bars + 8 * s; };
  const auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const auto landed = [&](int r) { return bars + 8 * (2 * STAGES + r); };
  const auto q_bar = [&](int s) { return bars + 8 * (2 * STAGES + RAWS + s); };
  const auto tile_row = [&](int it) {
    const int tile = it / n_sl;
    return c_begin + (tile < n_tiles ? tile : tile - n_tiles) * TN;
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // K1: the producer's threads once their split is stored; K2: their
      // cp.async arrivals, and TMA's byte count
      wg::mbar_init(full(s), Op::SPLIT ? WG : WG + tma);
      wg::mbar_init(empty(s), CWARPS);
    }
    for (int r = 0; r < RAWS; ++r) wg::mbar_init(landed(r), tma ? 1 : WG);
    for (int s = 0; s < QSLOTS; ++s) wg::mbar_init(q_bar(s), tma ? 1 : WG);
    wg::mbar_fence_init();
  }
  __syncthreads();  // the only block-wide barrier

  if (tid < WG) {  // the producer warpgroup
    wg::regs_dec<PRODUCER_REGS>();
    const int t = tid;
    const auto load_q = [&](int sl, int slot) {
      const uint32_t dst = base + L::Q0 + slot * Q_BYTES;
      if (tma) {
        if (t == 0) {
          wg::mbar_expect_tx(q_bar(slot), Q_BYTES);
          wg::tma_load_2d(dst, &qmap, q_bar(slot), sl * (SB / Op::ELEM), q0);
        }
      } else {
        cp_slice<TQ>(dst, q, q0, B, sl * SW, DW, t);
        wg::mbar_arrive_cp_async(q_bar(slot));
      }
    };
    // the corpus slice of iteration `it` into dst; its bytes complete on bar
    // (TMA) or this thread's copies are left for the caller's arrival
    const auto load_x = [&](int it, uint32_t dst, uint32_t bar) {
      const int r0 = tile_row(it), sl = it % n_sl;
      if (tma) {
        if (t == 0) {
          wg::mbar_expect_tx(bar, X_BYTES);
          wg::tma_load_2d(dst, &xmap, bar, sl * (SB / Op::ELEM), r0);
        }
      } else {
        cp_slice<TN>(dst, x, r0, c_end, sl * SW, DW, t);
      }
    };
    if (q_res && total > 0)
      for (int sl = 0; sl < n_sl; ++sl) load_q(sl, sl);
    if constexpr (Op::SPLIT) {
      // raw slices land in RAWS slots, ahead of the stages they are split into
      const auto land = [&](int it) {
        const int r = it % RAWS;
        load_x(it, base + L::RAW0 + r * X_BYTES, landed(r));
        if (!tma) wg::mbar_arrive_cp_async(landed(r));
      };
      for (int i = 0; i < min(RAWS, total); ++i) land(i);
      float nrm = 0.f;  // this thread's part of ||x||^2 of its row of the tile
      for (int it = 0; it < total; ++it) {
        const int st = it % STAGES, r = it % RAWS, sl = it % n_sl;
        if (it >= STAGES) wg::mbar_wait(empty(st), ((it / STAGES) & 1) ^ 1);
        if (!q_res) load_q(sl, st);
        wg::mbar_wait(landed(r), (it / RAWS) & 1);
        nrm = Op::split(sp + L::RAW0 + r * X_BYTES, sp + L::STAGE0 + st * L::STAGE,
                        reinterpret_cast<float*>(sp + L::AUX0) + st * TN, t,
                        sl == 0 ? 0.f : nrm, sl == n_sl - 1);
        wg::fence_proxy_async();  // the planes, for the consumers' wgmmas
        wg::mbar_arrive(full(st));
        wg::bar_sync<1, WG>();  // every producer thread is done with slot r
        if (it + RAWS < total) land(it + RAWS);
      }
    } else {
      for (int it = 0; it < total; ++it) {
        const int st = it % STAGES, sl = it % n_sl;
        if (it >= STAGES) wg::mbar_wait(empty(st), ((it / STAGES) & 1) ^ 1);
        if (!q_res) load_q(sl, st);
        load_x(it, base + L::STAGE0 + st * L::STAGE, full(st));
        if (sl == n_sl - 1) {  // the tile's per-row term
          const int r0 = tile_row(it);
          for (int rr = t; rr < TN; rr += WG) {
            const bool in = r0 + rr < c_end;
            cp_async4(base + L::AUX0 + (st * TN + rr) * 4,
                      Op::aux_ptr(args) + (in ? r0 + rr : 0), in);
          }
        }
        wg::mbar_arrive_cp_async(full(st));
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // consumer warp cw (warp wc of warpgroup c): queries q0 + 16 cw + g and
  // + 8 (g = lane / 4, t = lane % 4)
  wg::regs_inc<CONSUMER_REGS>();
  const int c = tid / WG - 1;
  const int wc = (tid % WG) >> 5;
  const int cw = 4 * c + wc;
  const int g = lane >> 2, t = lane & 3;
  const int qw = 16 * cw;  // first query of the warp in the block
  float* bd = reinterpret_cast<float*>(sp + L::BUF_D) + qw * CAP;
  int* bi = reinterpret_cast<int*>(sp + L::BUF_I) + qw * CAP;
  // slot (h, i) at best[(h * LANE_BEST + i) * BEST_STRIDE]
  float* best = reinterpret_cast<float*>(sp + L::BEST) + cw * 32 + lane;
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
  float sink = topk::inf_f();  // diagnostic builds without the filter
  SCAN_CLOCK_START();
  auto list_of = [&](int u, float*& ld, int*& li) {
    const size_t base_l = ((size_t)(q0 + qw + u) * nsplit + split) * K;
    ld = list_d + base_l;
    li = list_i + base_l;
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
    SCAN_CLOCK_FLUSH_BEGIN();
    const int src = 4 * (u & 7);
    const int cn = __shfl_sync(FULL, cnt[h], src);
    const int n0 = __shfl_sync(FULL, nl[h], src);
    const float jb0 = __shfl_sync(FULL, jb[h], src);
    float* ld;
    int* li;
    list_of(u, ld, li);
    topk::Flushed f = {n0, 0.f, jb0};
    for (int off = 0; off < cn; off += CB) {
      const topk::Flushed f1 = topk::flush<K>(bd + u * CAP + off, bi + u * CAP + off,
                                              min(cn - off, CB), f.nl, jrank, ld, li, lane);
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
    SCAN_CLOCK_FLUSH_END();
  };
  // the cross-chunk bound of each query of the warp: the largest published
  // bound of chunks 0 .. nsplit - 2.  Lane l reads query l % 16's bounds of
  // chunks l / 16, + 2, ..., so the loads of all 16 queries are in flight
  // together.
  auto refresh = [&]() {
    const int b = q0 + qw + (lane & 15);
    float m = -topk::inf_f();
    if (b < B)
      for (int cc = lane >> 4; cc < nsplit - 1; cc += 2)
        m = fmaxf(m, *(volatile float*)(bound + (size_t)b * K + cc));
    m = fmaxf(m, __shfl_xor_sync(FULL, m, 16));
    gth[0] = __shfl_sync(FULL, m, g);
    gth[1] = __shfl_sync(FULL, m, g + 8);
  };
  const auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(empty(st));
  };

  int skipped = 0;  // tiles 0 .. skipped - 1 admit nothing until their second scan
  for (int tile = 0; tile < n_tiles + n_warm; ++tile) {
    const bool again = tile >= n_tiles;
    const int r0 = c_begin + (again ? tile - n_tiles : tile) * TN;
    if (bound != nullptr && tile > 0 && (tile <= WARM || tile % REFRESH == 0)) refresh();
    SCAN_CLOCK_PRODUCTS_BEGIN();
    // defined here, so it holds no registers through the filter and flushes
    typename Op::Acc acc;
    Op::zero(acc);
    int st = 0;
    for (int sl = 0; sl < n_sl; ++sl) {
      const int it = tile * n_sl + sl;
      st = it % STAGES;
      const int qs = q_res ? sl : st;
      wg::mbar_wait(full(st), (it / STAGES) & 1);
      wg::mbar_wait(q_bar(qs), q_res ? 0 : (it / STAGES) & 1);
#if !(REPRO_SCAN_OFF & 8)
      Op::slice(acc, sp + L::Q0 + qs * Q_BYTES, base + L::Q0 + qs * Q_BYTES,
                base + L::STAGE0 + st * L::STAGE, c, wc, lane, sl > 0);
#endif
      if constexpr (Op::PIPELINED) {  // the previous slice's stage, once its wgmmas are done
        if (sl > 0) {
          wg::wait<1>();
          release((it - 1) % STAGES);
        }
      } else {
        wg::wait<0>();
        if (sl < n_sl - 1) release(st);
      }
    }
    wg::wait<0>();
    Op::fence(acc);
    Op::read_aux(ol, reinterpret_cast<const float*>(sp + L::AUX0) + st * TN, t);
    release(st);
    SCAN_CLOCK_PRODUCTS_END();
    if (again && tile - n_tiles >= skipped) continue;  // admitted the first time

    // scores: s[j][e] of query g + 8 (e >> 1), row r0 + 8 j + 2 t + (e & 1)
    float s[NJ][4];
    Op::scores(s, acc, ol, args);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (r0 + 8 * j + 2 * t + (e & 1) >= c_end) s[j][e] = topk::inf_f();
#if REPRO_SCAN_OFF & 4
    for (int j = 0; j < NJ; ++j)
      for (int e = 0; e < 4; ++e) sink = fminf(sink, s[j][e]);
    continue;
#endif
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
      const int cn = __popc(mask[h]);
      int xs = cn, y = __shfl_up_sync(FULL, xs, 1, 4);
      if (t >= 1) xs += y;
      y = __shfl_up_sync(FULL, xs, 2, 4);
      if (t >= 2) xs += y;
      pre[h] = xs - cn;
      tot[h] = __shfl_sync(FULL, xs, 3, 4);
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
  if (sink == -1.2345f) list_d[0] = sink;
  SCAN_CLOCK_END_TILES();

#if !(REPRO_SCAN_OFF & 2)
  // the rest of each buffer; then each list's count for the chunk merge, or,
  // with one chunk, the list padded and sorted
  for (int u = 0; u < 16; ++u) {
    if (q0 + qw + u >= B) break;
    const int h = u >> 3;
    const int src = 4 * (u & 7);
    const int cn = __shfl_sync(FULL, h ? cnt[1] : cnt[0], src);
    if (cn > 0) {
      if (h)
        flush_u(u, 1);
      else
        flush_u(u, 0);
    }
    const int n0 = __shfl_sync(FULL, h ? nl[1] : nl[0], src);
    float* ld;
    int* li;
    list_of(u, ld, li);
    topk::end_list<K>(ld, li, n0, counts, (size_t)(q0 + qw + u) * K + split, lane);
  }
#endif
  SCAN_CLOCK_END();
}

// static: every translation unit that includes this defines its own (K1 and
// K2 link several units into one library, kernels/_build.py UNITS)
static __global__ void init_bounds(float* bound, int B, int nsplit, int K) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B * nsplit) bound[(size_t)(i / nsplit) * K + i % nsplit] = topk::inf_f();
}

// The chunk bounds and the lists' counts (nsplit > 1; out_d and out_i are
// free until the merge writes them), then `run` (a launch of one scan
// kernel, given its lists, and the bounds and counts or nullptr), then the
// chunk merge.  Shared by the batched scan and K1's small-batch scan.
template <int K, class Run>
cudaError_t launch_chunks(Run run, float* part_d, int* part_i, float* out_d, int* out_i,
                          int B, int nsplit, cudaStream_t stream) {
  const bool direct = nsplit == 1;  // one chunk: its list is the answer
  float* bound = nullptr;
  if (!direct) {
    if (nsplit > K) return cudaErrorInvalidValue;
    bound = out_d;
    init_bounds<<<(B * nsplit + 255) / 256, 256, 0, stream>>>(bound, B, nsplit, K);
  }
  cudaError_t e = run(direct ? out_d : part_d, direct ? out_i : part_i, bound,
                      direct ? nullptr : out_i);
  if (e != cudaSuccess || direct) return e;
#if REPRO_SCAN_OFF & 1
  return cudaSuccess;
#else
  return topk::launch_merge<K>(part_d, part_i, out_d, out_i, B, nsplit, stream);
#endif
}

// Launch the batched scan.  q (B rows) and x (n_valid rows read) are word
// matrices of DW 32-bit words a row (K1: floats; K2: four int8 codes).
template <class Op, int K>
cudaError_t launch(const void* q, const void* x, typename Op::Args args, float* part_d,
                   int* part_i, float* out_d, int* out_i, int B, int DW, int n_valid,
                   int nsplit, int chunk, cudaStream_t stream) {
  using L = Layout<Op>;
  // TMA needs rows of a multiple of 16 bytes and 16-byte aligned bases
  const int tma = DW % 4 == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  CUtensorMap qmap = {}, xmap = {};
  if (tma) {
    const int cols = DW * 4 / Op::ELEM;
    if (!wg::matrix_map(&qmap, q, B, cols, Op::ELEM, TQ, Op::TMA_TYPE) ||
        !wg::matrix_map(&xmap, x, n_valid, cols, Op::ELEM, TN, Op::TMA_TYPE))
      return cudaErrorInvalidValue;
  }
  auto kernel = scan_topk_kernel<Op, K>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid((B + TQ - 1) / TQ, nsplit);
  const auto run = [&](float* ld, int* li, float* bound, int* counts) {
    kernel<<<grid, THREADS, L::BYTES, stream>>>(qmap, xmap, static_cast<const uint32_t*>(q),
                                                static_cast<const uint32_t*>(x), args, ld, li,
                                                bound, counts, B, DW, n_valid, nsplit, chunk,
                                                tma);
    return cudaGetLastError();
  };
  return launch_chunks<K>(run, part_d, part_i, out_d, out_i, B, nsplit, stream);
}

}  // namespace scan
