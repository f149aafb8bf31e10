// K3: attention forward with an online softmax for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py::_flash_fwd_kernel, the
// Pallas TPU kernel of the LM substrate's chunked attention.  For q, k of
// shape (BH, S, DQK) and v of shape (BH, S, DV), row-major, float32 or
// bfloat16, it writes o (BH, S, DV):
//   o[b, i] = sum_j softmax_j(scale * q[b, i] . k[b, j]) v[b, j]
// over j <= i (causal) or all j < S, in the input dtype.  The instances are
// DQK = DV in {16, 32, 64, 128} and (DQK, DV) = (192, 128), MLA's
// (DeepSeek-V2: 128 nope + 64 rope dims of q . k, 128 of v).  The TPU kernel
// widens q and k to float32 before the dot, keeps p in float32 for p @ v and
// carries (m, l, acc) in float32; both dtypes here compute that function to
// float32 grade.
//
// What bounds it: operations.  A (64-row q tile, 64-row kv tile) pair does
// 2 * 64 * 64 * (DQK + DV) flops against 64 * (DQK + DV) loaded values, so
// the card's arithmetic rate is the limit: 989 TFLOP/s of dense bf16 on the
// tensor cores for bf16 inputs; for float32 inputs, 165 TFLOP/s of
// float32-grade products as a 3xTF32 split on the tensor cores (495 / 3).
// Beside the products, every score takes an exponent on the SFU (16 a clock
// an SM, against 4,096 bf16 flops a clock), so the softmax has to run while
// the tensor cores work, not between their products.
//
// Both paths: the tensor cores' f32 accumulation truncates, so no chain of
// MMAs runs longer than one kv tile: a tile's p @ v starts from zero and is
// folded into acc with one rounded fmaf (acc * corr + tile), as the TPU
// kernel adds each block's product.  Row max and row sum of the online
// softmax are shuffles over the 4 lanes that share a row of the m16n8
// accumulator layout (wgmma's 64-row accumulator is four of them, one a
// warp).  The exponent runs in base 2 (ex2.approx.ftz, 2^-22 relative error;
// outputs below 2^-126 flush to 0) with scale * log2(e) folded into the
// score.  Blocks take q tiles in reverse order, so that the longest causal
// rows start first.  kv tiles wholly above the diagonal are never loaded,
// and only tiles that cross the diagonal or S are masked.  Any S is taken
// with no padding copy: rows past S are not written.  The guards of the TPU
// kernel: m_safe = 0 for a fully masked row, corr = 0 while m is -inf, l
// floored at 1e-30 in the final division.  No atomics and no split over
// kv: an output row is one warpgroup's work in a fixed order, so a launch
// repeats its bits.
//
// bfloat16 (flash_fwd_wgmma_kernel): warpgroup MMAs fed by TMA
// (csrc/wgmma.cuh), the block K3-bwd runs (flash_attention_bwd.cu).
//  * A block is three warpgroups: a producer and two consumers, each
//    consumer owning 64 q rows (wgmma's M), 128 a block.  setmaxnreg moves
//    the producer's registers to the consumers (24 / 240).
//  * The producer's first thread loads the block's q tile once, then k and
//    v tiles of BK rows through a ring of 4 stages under full / empty
//    mbarriers: 3-D tensor maps over (BH, S, D), so rows past S zero-fill
//    inside a head.  Tiles are panels of up to 64 columns under the TMA's
//    128-byte swizzle (64- and 32-byte at D = 32 and 16).
//  * s = q k^T runs SS: q and k K-major in shared memory, DQK / 16 k-steps
//    of m64nBKk16 into BK / 2 float32 registers a thread; q . k is bf16 x
//    bf16 into float32, exact products, the TPU kernel's float32 dot.
//  * p @ v: a bf16 p would keep 8 significant bits of a value the TPU kernel
//    keeps in float32, which is different arithmetic (off by up to a bf16
//    ulp of p before the output's own rounding: ref.bf16_agreement fails).
//    So p is split into two bf16 terms, p_hi = bf16(p) and p_lo = bf16(p -
//    p_hi), about 16 significant bits, straight from the accumulators into
//    RS A fragments (the accumulator layout is the A-fragment layout), and
//    p @ v is two wgmmas a k-step, v read MN-major from the stage it landed
//    in: 1.5x the tensor-core work of a bf16-p kernel at DQK = DV.
//  * Overlap, two kinds.  Inside a warpgroup, tile i's scores and tile i -
//    1's p v are issued together, and tile i's softmax runs while that p v
//    does (FA3's intra-warpgroup pipelining); p is split after the p v's
//    wait, so this takes no registers beyond the serial loop's.  Between
//    the two, the consumers issue in turns under two named barriers (a
//    ping-pong), so that one's softmax runs under the other's products.
//  * Registers: a consumer holds s and p's hi and lo (BK / 2 each), a
//    tile's p v and acc (DV / 2 each): 192 at D = 64 with BK = 128 and at
//    D = 128 with BK = 64, of the 240 setmaxnreg gives (0 bytes spilled at
//    every instance).  BK = 128 at DV = 128 would need 256.
//  * Shared memory: q (128 x DQK) and 4 stages of a k and a v tile: 144 KB
//    at D = 64, 160 KB at D = 128, 208 KB at (192, 128), of the 227 KB.
//  * At D = 64 the exponents (16 a clock an SM) take 2/3 of the time of the
//    tile's hi + lo products, and at D >= 128 a score wgmma of N = 64 reads
//    shared memory at the SM's 128 bytes a clock; taking q from registers
//    (RS) there was slower (PERF.md).
//  * Left for later: kv tiles of 128 rows past DV = 64 (a tile's p v folded
//    a panel at a time, to free 32 registers), part of the exponents on the
//    FMA pipe at D = 64.
//
// float32 (flash_fwd_tf32_kernel): 3xTF32 (csrc/tf32.cuh) on mma.sync.  A
// block owns one q tile of one (batch, head), each of its 8 warps 16 q rows
// in the m16n8 accumulator layout; q . k^T and p @ v run as mma.sync on the
// tensor cores; p never leaves registers.  One TF32 product keeps 10
// mantissa bits and misses the float32 limit of 3e-5 by 30-150x; the split
// (a = hi + lo, products lo.hi + hi.lo + hi.hi, lo.lo dropped, rounded with
// two integer operations) meets it.
//  * Both products are mma.sync m16n8k8 tf32.  A score tile is one chain of
//    DQK / 8 k-steps of three MMAs (past DQK = 64 the small terms of all k-steps
//    come first); a tile's p @ v one chain of BK / 8.
//  * p in registers: the m16n8 accumulator holds columns 2t, 2t + 1 in lane
//    (g, t), where an m16n8k8 A fragment wants columns t, t + 4.  p @ v sums
//    over kv, so the kv index is permuted instead of the data: the A
//    fragment is (c0, c2, c1, c3), and v is stored with kv row 2t of each
//    k-step at t and 2t + 1 at t + 4 (kv_pos).  No shuffle, no round trip
//    through shared memory.  Each warp splits its own p.
//  * k and v are split once per block, not once per warp: a kv tile lands
//    in raw planes by 16-byte cp.async copies (rows at or past S
//    zero-fill), then all 256 threads split it into hi and lo planes (v
//    transposed, in kv_pos order, so both operands load with ldmatrix), and
//    the next tile's copies go out while the warps compute on the planes.
//    The split pass is ALU work (5 operations an element) that stalls the
//    block's MMAs, so 8 warps (128 q rows) share each split tile: at
//    (15, 4096, 64) on an H100 SXM (700 W) they took 0.655 ms where 4
//    warps took 0.707, and a per-warp split in registers 0.73
//    (tools/k3_time.py, PERF.md).  One block an SM (245 registers a
//    thread and 102 KB of shared memory at D = 64).  Past D = 64 the kv
//    tile is 32 rows; at (192, 128) the planes take 224 KB of the 227 KB a
//    block may hold (F32Tile's static_assert).
//  * q's hi + lo fragments are split once and stay in registers up to
//    DQK = 64; past it q is read from shared memory and split per k-step.
//  * float32 inputs must be 16-byte aligned (the copies are 16 bytes).
//
// For training the caller may pass an lse buffer (BH, S) float32: each row's
// log-sum-exp of the scaled scores in natural-log units, with the same
// guards, which the backward kernel (flash_attention_bwd.cu) reads to
// rebuild p.  Each kernel has an instance with and one without the lse
// store (template flag LSE), so with lse null nothing else changes.
//
// Build: the library links three translation units of this file
// (kernels/_build.py UNITS), so that the instances compile in parallel:
// built with -DREPRO_K3_BF16 a unit defines the bfloat16 instances, with
// -DREPRO_K3_F32 the float32 ones; built with neither, the C entry below,
// which calls them.
//
// Interface: a plain C function for ctypes.  It launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"
#include "tf32.cuh"
#include "wgmma.cuh"

// the instances, each defined in its own unit
#define K3_LAUNCH_ARGS                                                                      \
  const void *q, const void *k, const void *v, void *o, float *lse, int BH, int S, int causal, \
      float scale, cudaStream_t stream
template <int DQK, int DV, bool LSE>
cudaError_t k3_launch_bf16(K3_LAUNCH_ARGS);
template <int DQK, int DV, bool LSE>
cudaError_t k3_launch_f32(K3_LAUNCH_ARGS);

namespace {

using namespace mma;

// a row's log-sum-exp in natural-log units of the scaled scores,
// log sum_j exp(scale * q . k_j), from the base-2 running max m (-inf for a
// fully masked row, taken as 0 like m_safe) and the floored row sum den
__device__ __forceinline__ float row_lse(float m, float den) {
  return ((isfinite(m) ? m : 0.f) + log2f(den)) * 0.6931471805599453f;
}

#ifdef REPRO_K3_BF16
// --------------------------------------------------------------- bfloat16

using bf16 = __nv_bfloat16;
using wg::Panels;

constexpr int WG_THREADS = 128;
constexpr int CONSUMERS = 2;        // consumer warpgroups, 64 q rows each
constexpr int BQ = 64 * CONSUMERS;  // q rows a block
constexpr int BLOCK_THREADS = WG_THREADS * (1 + CONSUMERS);
// setmaxnreg: the producer warpgroup gives its registers to the consumers
// (24 x 128 + 2 x 240 x 128 = 168 x 384, the launch's allotment)
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int STAGES = 4;   // depth of the k / v ring
// named barriers of the ping-pong: consumer c waits on TURN + c
constexpr int TURN = 1;
constexpr int PAIR = CONSUMERS * WG_THREADS;

// consumer c's turn to issue its wgmmas (the ping-pong of the two)
__device__ __forceinline__ void take_turn(int c) {
  if (c == 0) wg::bar_sync<TURN, PAIR>();
  else wg::bar_sync<TURN + 1, PAIR>();
}

// consumer c's end of its turn: the other consumer may issue (consumer 1
// gives no turn after its last slot, so that no arrival is left pending)
__device__ __forceinline__ void pass_turn(int c, bool more) {
  if (c == 0) wg::bar_arrive<TURN + 1, PAIR>();
  else if (more) wg::bar_arrive<TURN, PAIR>();
}

// a block's kv tiles and shared memory: q (BQ x DQK), then the ring of (k,
// v) tiles, then the barriers, as byte offsets from the 1024-aligned base
template <int DQK, int DV>
struct Tiles {
  using A = Panels<DQK>;
  using B = Panels<DV>;
  // kv rows a tile, the N of the score wgmma: 128 where the registers allow
  // it; past DV = 64 a consumer's tile of p v and acc take DV / 2 each
  static constexpr int BK = DV <= 64 ? 128 : 64;
  static constexpr int OWN = BQ * DQK * 2;   // bytes of the q tile
  static constexpr int TILE_K = BK * DQK * 2;
  static constexpr int TILE_V = BK * DV * 2;
  static constexpr int STAGE = TILE_K + TILE_V;
  static constexpr int STAGE0 = OWN;
  static constexpr int BARS = STAGE0 + STAGES * STAGE;
  static constexpr int BYTES = BARS + (2 * STAGES + 1) * 8 + 1024;  // + the alignment slack
  static_assert(OWN % 1024 == 0 && TILE_K % 1024 == 0 && TILE_V % 1024 == 0,
                "every tile on a 1024-byte boundary (the 128-byte swizzle)");
  // (192, 128): 214,088 bytes
  static_assert(BYTES <= 232448, "the tiles fit the 227 KB a block may hold");
};

// scale (base 2), mask, and the online-softmax update of one score tile of
// a warpgroup's 64 rows (first row r0), in place: sc becomes p, (m, l)
// advance, and corr is each of the thread's rows' factor for acc.  Only a
// tile that crosses S or the diagonal is masked.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int k0, int S, int causal, int r0,
                                             int row_a, int col_t, float scale_log2) {
  const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > r0);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e] * scale_log2;
      if (edge) {
        const int col = k0 + 8 * j + col_t + (e & 1);
        const int row = row_a + (e >> 1) * 8;
        if (col >= S || (causal && col > row)) x = -INFINITY;
      }
      sc[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float m_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    m_safe[r] = isfinite(m_new) ? m_new : 0.f;
    corr[r] = isfinite(m[r]) ? ex2(m[r] - m_safe[r]) : 0.f;
    m[r] = m_new;
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(sc[4 * j + e] - m_safe[e >> 1]);  // 0 where masked
      sc[4 * j + e] = p;
      ps[e >> 1] += p;
    }
  l[0] = l[0] * corr[0] + ps[0];
  l[1] = l[1] * corr[1] + ps[1];
}

// tile = p v from zero for a warpgroup's 64 rows: p as its hi and lo A
// fragments, v (BK rows, DV columns) MN-major at descriptor vt, one chain a
// 64-column panel of v; issued, not committed
template <int DV, int BK>
__device__ __forceinline__ void issue_pv(float (&tile)[Panels<DV>::NP][Panels<DV>::CW / 2],
                                         const uint32_t (&hi)[BK / 16][4],
                                         const uint32_t (&lo)[BK / 16][4], uint64_t vt) {
#pragma unroll
  for (int p = 0; p < Panels<DV>::NP; ++p)
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const uint64_t bv = vt + wg::mn_step<DV, BK>(p, kc);
      wg::mma_rs<Panels<DV>::CW, 1>(tile[p], lo[kc], bv, kc > 0);
      wg::mma_rs<Panels<DV>::CW, 1>(tile[p], hi[kc], bv);
    }
}

// sc (64 x BK) = a warpgroup's 64 q rows (descriptor own, in the block's q
// tile) . k^T (descriptor kt), both K-major; issued, not committed
template <int DQK, int BK>
__device__ __forceinline__ void issue_scores(float (&sc)[BK / 2], uint64_t own, uint64_t kt) {
#pragma unroll
  for (int kk = 0; kk < DQK / 16; ++kk)
    wg::mma_ss<BK, 0>(sc, own + wg::k_step<DQK, BQ>(kk), kt + wg::k_step<DQK, BK>(kk), kk > 0);
}

// an operand fence on each panel of a p v tile
template <int NP, int CH>
__device__ __forceinline__ void fence_tile(float (&tile)[NP][CH]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) wg::fence_operand(tile[p]);
}

// acc = acc * corr + tile, one rounding: the TPU kernel's add of a block
template <int NP, int CH>
__device__ __forceinline__ void fold(float (&acc)[NP * CH], const float (&tile)[NP][CH],
                                     const float (&corr)[2]) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int e = 0; e < CH; ++e)
      acc[p * CH + e] = fmaf(acc[p * CH + e], corr[(e >> 1) & 1], tile[p][e]);
}

template <int DQK, int DV, bool LSE>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                           float* __restrict__ lse, int S, int causal, float scale_log2) {
  using T = Tiles<DQK, DV>;
  using PA = typename T::A;
  using PB = typename T::B;
  constexpr int BK = T::BK;
  constexpr int CW = PB::CW;  // the N of one p v wgmma
  static_assert(DQK % 16 == 0 && DV % 16 == 0, "k-steps of 16");
  extern __shared__ __align__(1024) unsigned char k3_smem[];
  const uint32_t raw = wg::smem_u32(k3_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full = base + T::BARS, empty = full + 8 * STAGES, own = empty + 8 * STAGES;
  const int bh = blockIdx.y;
  const int q0 = ((S + BQ - 1) / BQ - 1 - (int)blockIdx.x) * BQ;
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int n = (kv_end + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(full + 8 * s, 1);               // the producer's expect_tx
      wg::mbar_init(empty + 8 * s, 4 * CONSUMERS);  // one arrival a consumer warp
    }
    wg::mbar_init(own, 1);
    wg::mbar_fence_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / WG_THREADS;
  if (wgi == 0) {  // producer: one thread issues every copy
    wg::regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      wg::mbar_expect_tx(own, T::OWN);
      wg::load_rows_tma<PA, BK>(base, &tq, own, q0, BQ, bh);
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        wg::mbar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
        const uint32_t f = full + 8 * s, st = base + T::STAGE0 + s * T::STAGE;
        wg::mbar_expect_tx(f, T::STAGE);
        wg::load_rows_tma<PA, BK>(st, &tk, f, i * BK, BK, bh);
        wg::load_rows_tma<PB, BK>(st + T::TILE_K, &tv, f, i * BK, BK, bh);
      }
    }
  } else {
    wg::regs_inc<CONSUMER_REGS>();
    // warp-uniform (a shuffle shows the compiler), so that the descriptors
    // below live in uniform registers and cost no instructions per wgmma
    const int c = __shfl_sync(0xffffffffu, wgi, 0) - 1;
    const uint32_t b = __shfl_sync(0xffffffffu, base, 0);
    const int t = threadIdx.x % WG_THREADS, lane = t & 31;
    const int r0 = q0 + 64 * c;                          // this warpgroup's first q row
    const int row_a = r0 + (t >> 5) * 16 + (lane >> 2);  // a thread's rows: row_a, row_a + 8
    const int col_t = 2 * (lane & 3);
    const uint64_t own_q = wg::tile_desc<DQK>(b) + (64 * c * PA::RB >> 4);
    const uint64_t stage_k = wg::tile_desc<DQK>(b + T::STAGE0);
    const uint64_t stage_v = wg::tile_desc<DV>(b + T::STAGE0 + T::TILE_K);
    // the kv tiles this warpgroup's rows see (causal: up to its last row)
    const int n_c = causal ? min(n, (r0 + 63) / BK + 1) : n;
    float acc[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // this thread's part of the row sums
    float corr[2];            // the factor of acc for the tile whose p v is in flight
    float sc[BK / 2];         // a score tile, then its p
    uint32_t hi[BK / 16][4], lo[BK / 16][4];  // p as bf16 hi + lo A fragments
    float tile[PB::NP][CW / 2];               // a tile's p v
    // the descriptor offset of tile i's stage
    const auto stage = [](int i) -> uint64_t { return (i % STAGES) * T::STAGE >> 4; };

    // Slot i of the ping-pong issues tile i's scores and tile i - 1's p v
    // together, so that tile i's softmax runs under that p v.  Both
    // consumers take n + 1 turns: consumer 0's last tile may be wholly above
    // its diagonal (n_c = n - 1), and its slots past n_c are empty.  Each
    // issue sits in one branch with its waits (ptxas serializes wgmmas whose
    // stage it sees open on another path), and the accumulators are defined
    // (an operand fence) before a stage opens.
    if (c == 1) wg::bar_arrive<TURN, PAIR>();  // consumer 0 takes the first turn
    wg::mbar_wait(own, 0);
    wg::mbar_wait(full, 0);
    take_turn(c);
    wg::fence_operand(sc);
    wg::fence();
    issue_scores<DQK, BK>(sc, own_q, stage_k);
    wg::commit();
    pass_turn(c, true);
    wg::wait<0>();
    wg::fence_operand(sc);
    softmax_tile<BK>(sc, m, l, corr, 0, S, causal, r0, row_a, col_t, scale_log2);
    wg::split_frags<BK>(sc, hi, lo);
    for (int i = 1; i < n_c; ++i) {
      wg::mbar_wait(full + 8 * (i % STAGES), (i / STAGES) & 1);
      take_turn(c);
      wg::fence_operand(sc);
      fence_tile(tile);
      wg::fence();
      issue_scores<DQK, BK>(sc, own_q, stage_k + stage(i));
      wg::commit();
      issue_pv<DV, BK>(tile, hi, lo, stage_v + stage(i - 1));
      wg::commit();
      pass_turn(c, true);
      wg::wait<1>();  // the scores
      wg::fence_operand(sc);
      float corr_i[2];
      softmax_tile<BK>(sc, m, l, corr_i, i * BK, S, causal, r0, row_a, col_t, scale_log2);
      wg::wait<0>();  // the p v
      fence_tile(tile);
      wg::fence_operand(hi);
      wg::fence_operand(lo);
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(empty + 8 * ((i - 1) % STAGES));  // the stage is free
      fold(acc, tile, corr);
      wg::split_frags<BK>(sc, hi, lo);
      corr[0] = corr_i[0];
      corr[1] = corr_i[1];
    }
    take_turn(c);  // slot n_c: the last tile's p v
    fence_tile(tile);
    wg::fence();
    issue_pv<DV, BK>(tile, hi, lo, stage_v + stage(n_c - 1));
    wg::commit();
    pass_turn(c, n_c < n);
    wg::wait<0>();
    fence_tile(tile);
    wg::fence_operand(hi);
    wg::fence_operand(lo);
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(empty + 8 * ((n_c - 1) % STAGES));
    fold(acc, tile, corr);
    for (int i = n_c + 1; i <= n; ++i) {  // empty slots
      take_turn(c);
      pass_turn(c, i < n);
    }

    bf16* ob = o + (size_t)bh * S * DV;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float den = fmaxf(quad_sum(l[r]), 1e-30f);  // all lanes shuffle
      const int row = row_a + 8 * r;
      if (row >= S) continue;
      if constexpr (LSE)
        if ((lane & 3) == 0) lse[(size_t)bh * S + row] = row_lse(m[r], den);
#pragma unroll
      for (int p = 0; p < PB::NP; ++p)
#pragma unroll
        for (int j = 0; j < CW / 8; ++j) {
          const int e = p * CW / 2 + 4 * j + 2 * r;
          *reinterpret_cast<__nv_bfloat162*>(&ob[(size_t)row * DV + p * CW + 8 * j + col_t]) =
              __floats2bfloat162_rn(acc[e] / den, acc[e + 1] / den);
        }
    }
  }
}

template <int DQK, int DV, bool LSE>
cudaError_t launch_bf16(K3_LAUNCH_ARGS) {
  using T = Tiles<DQK, DV>;
  CUtensorMap m[3];
  constexpr CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!(wg::tensor_map<typename T::A, T::BK>(&m[0], q, BH, S, type) &&
        wg::tensor_map<typename T::A, T::BK>(&m[1], k, BH, S, type) &&
        wg::tensor_map<typename T::B, T::BK>(&m[2], v, BH, S, type)))
    return cudaErrorInvalidValue;
  static bool attr_set = false;
  cudaError_t e = mma::allow_smem(flash_fwd_wgmma_kernel<DQK, DV, LSE>, T::BYTES, attr_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + BQ - 1) / BQ, BH);
  flash_fwd_wgmma_kernel<DQK, DV, LSE><<<grid, BLOCK_THREADS, T::BYTES, stream>>>(
      m[0], m[1], m[2], static_cast<bf16*>(o), lse, S, causal,
      (float)(scale * 1.4426950408889634));
  return cudaGetLastError();
}
#endif  // REPRO_K3_BF16

#ifdef REPRO_K3_F32
// ---------------------------------------------------------------- float32

using tf32::mma_tf32;
using tf32::split_tf32;

constexpr int F32_WARPS = 8;  // 16 q rows each
constexpr int F32_BQ = 16 * F32_WARPS;
constexpr int F32_THREADS = 32 * F32_WARPS;

// The float32 kernel's tiles.  kv tiles of 64 rows, or 32 past DQK = 64,
// where 64 rows of raw and split planes beside q's own plane would pass the
// 227 KB a block may hold.  q's hi + lo fragments stay in registers up to
// DQK = 64 (64 registers there) and are read from shared memory and split
// per k-step past it.  Word offsets into shared memory:
//   raw k         (BK, LD)   the cp.async targets, float32 as loaded
//   raw v         (BK, LDV)
//   k hi, k lo    (BK, LD)   the split of k, in k's layout
//   vT hi, vT lo  (DV, LDT)  the split of v, transposed, kv in k-step order
//   q         (F32_BQ, LD)   staged once; in the k planes when it is split
//                            into registers, else a plane of its own
// LD, LDV and LDT are 4 mod 32 words, so each ldmatrix phase (8 rows of 16
// bytes) hits 8 distinct bank groups, and so do the split pass's
// transposed stores (32 lanes on 32 consecutive kv rows).
template <int DQK, int DV>
struct F32Tile {
  static constexpr int BK = DQK <= 64 ? 64 : 32;
  static constexpr bool QREG = DQK <= 64;
  static constexpr int LD = DQK + 4;
  static constexpr int LDV = DV + 4;
  static constexpr int LDT = BK + 4;
  static constexpr int RAW_K = 0;
  static constexpr int RAW_V = RAW_K + BK * LD;
  static constexpr int K_HI = RAW_V + BK * LDV;
  static constexpr int K_LO = K_HI + BK * LD;
  static constexpr int VT_HI = K_LO + BK * LD;
  static constexpr int VT_LO = VT_HI + DV * LDT;
  static constexpr int SPLIT_END = VT_LO + DV * LDT;
  static constexpr int Q = QREG ? K_HI : SPLIT_END;
  static constexpr int WORDS = QREG ? SPLIT_END : SPLIT_END + F32_BQ * LD;
  static_assert(!QREG || F32_BQ * LD <= SPLIT_END - K_HI, "q is staged in the split planes");
  static_assert(BK % 32 == 0 && BK * DQK / 4 % F32_THREADS == 0 && BK * DV / 4 % F32_THREADS == 0,
                "whole 16-byte pieces a thread");
  // (192, 128): 57,344 words, 229,376 bytes
  static_assert(WORDS * 4 <= 232448, "the planes fit the 227 KB a block may hold");
};

// position of kv row r in the vT planes: in each k-step of 8 rows, row 2t
// sits at t and row 2t + 1 at t + 4, the order in which a score tile's
// m16n8 accumulator holds p as an m16n8k8 A fragment (columns 2t, 2t + 1)
__device__ __forceinline__ int kv_pos(int r) { return (r & ~7) | ((r & 1) << 2) | ((r >> 1) & 3); }

// rows [row0, row0 + ROWS) of a (S, D) float32 matrix into a tile of row
// stride LD words, in 16-byte copies; rows at or past S zero-fill
template <int D, int LD, int ROWS>
__device__ __forceinline__ void load_rows_f32(uint32_t* dst, const float* src, int row0, int S,
                                              int tid) {
  constexpr int CH = D / 4;
  static_assert(ROWS * CH % F32_THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int j = 0; j < ROWS * CH / F32_THREADS; ++j) {
    const int i = tid + j * F32_THREADS;
    const int r = i / CH, ch = i % CH;
    const bool in = row0 + r < S;
    cp_async16(smem_addr(dst + r * LD + ch * 4), src + (size_t)(in ? row0 + r : 0) * D + ch * 4,
               in);
  }
}

// the landed raw k and v tile into its hi and lo planes, once for the block
template <int DQK, int DV>
__device__ __forceinline__ void split_tile(uint32_t* sm, int tid) {
  using T = F32Tile<DQK, DV>;
  constexpr int CH = DQK / 4;
  constexpr int PER = T::BK * CH / F32_THREADS;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * F32_THREADS;
    const int off = (i / CH) * T::LD + (i % CH) * 4;
    const uint4 a = *reinterpret_cast<const uint4*>(sm + T::RAW_K + off);
    uint4 hi, lo;
    split_tf32(a.x, hi.x, lo.x);
    split_tf32(a.y, hi.y, lo.y);
    split_tf32(a.z, hi.z, lo.z);
    split_tf32(a.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(sm + T::K_HI + off) = hi;
    *reinterpret_cast<uint4*>(sm + T::K_LO + off) = lo;
  }
  // v: a warp takes 32 consecutive kv rows of one 4-column piece
  constexpr int PER_V = T::BK * (DV / 4) / F32_THREADS;
#pragma unroll
  for (int j = 0; j < PER_V; ++j) {
    const int i = tid + j * F32_THREADS;
    const int w = i >> 5;
    const int r = (w % (T::BK / 32)) * 32 + (i & 31), ch = w / (T::BK / 32);
    const uint4 a = *reinterpret_cast<const uint4*>(sm + T::RAW_V + r * T::LDV + ch * 4);
    const uint32_t x[4] = {a.x, a.y, a.z, a.w};
    const int col = (ch * 4) * T::LDT + kv_pos(r);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t hi, lo;
      split_tf32(x[e], hi, lo);
      sm[T::VT_HI + col + e * T::LDT] = hi;
      sm[T::VT_LO + col + e * T::LDT] = lo;
    }
  }
}

template <int DQK, int DV, bool LSE>
__global__ void __launch_bounds__(F32_THREADS)
    flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int S, int causal, float scale_log2) {
  using T = F32Tile<DQK, DV>;
  constexpr int BKT = T::BK, LD = T::LD, LDV = T::LDV, LDT = T::LDT;
  constexpr int KD = DQK / 8;  // k-steps of q k^T
  constexpr int ND = DV / 8;   // n8 tiles of the output
  constexpr int NS = BKT / 8;  // n8 tiles of a score tile, and k-steps of p v
  static_assert(DQK % 16 == 0 && DV % 16 == 0, "pairs of n8 tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nq = (S + F32_BQ - 1) / F32_BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * F32_BQ;
  const size_t rows = (size_t)blockIdx.y * (size_t)S;  // this (batch, head)'s first row
  const float* kb = k + rows * DQK;
  const float* vb = v + rows * DV;
  const int kv_end = causal ? min(S, q0 + F32_BQ) : S;
  const int n_tiles = (kv_end + BKT - 1) / BKT;

  // one copy group: q and kv tile 0
  load_rows_f32<DQK, LD, F32_BQ>(sm + T::Q, q + rows * DQK, q0, S, tid);
  load_rows_f32<DQK, LD, BKT>(sm + T::RAW_K, kb, 0, S, tid);
  load_rows_f32<DV, LDV, BKT>(sm + T::RAW_V, vb, 0, S, tid);
  cp_async_commit();

  // ldmatrix lane addresses (bytes): q rows as A fragments (rows g, g + 8;
  // words t, t + 4); k rows and vT rows as the B fragments of two n8 tiles
  const uint32_t q_addr = smem_addr(
      sm + T::Q + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 4);
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_word = ((lane >> 3) & 1) * 4;
  const uint32_t kh_addr = smem_addr(sm + T::K_HI + b_row * LD + b_word);
  const uint32_t kl_addr = smem_addr(sm + T::K_LO + b_row * LD + b_word);
  const uint32_t vh_addr = smem_addr(sm + T::VT_HI + b_row * LDT + b_word);
  const uint32_t vl_addr = smem_addr(sm + T::VT_LO + b_row * LDT + b_word);

  // this warp's 16 q rows as hi + lo A fragments, for the whole kv loop
  uint32_t qh[T::QREG ? KD : 1][4], ql[T::QREG ? KD : 1][4];
  if constexpr (T::QREG) {
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, q_addr + 32 * kk);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(a[i], qh[kk][i], ql[kk][i]);
    }
  }

  // a thread's rows in the m16n8 layout: g and g + 8 of the warp's 16
  const int row_a = q0 + warp * 16 + (lane >> 2);
  const int col_t = 2 * (lane & 3);
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's part of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it is in the raw planes; no warp reads the split planes (or q) now
    split_tile<DQK, DV>(sm, tid);
    __syncthreads();  // the split planes hold tile it; the raw planes are free
    if (it + 1 < n_tiles) {
      load_rows_f32<DQK, LD, BKT>(sm + T::RAW_K, kb, (it + 1) * BKT, S, tid);
      load_rows_f32<DV, LDV, BKT>(sm + T::RAW_V, vb, (it + 1) * BKT, S, tid);
      cp_async_commit();
    }
    const int k0 = it * BKT;

    // s = q k^T for this warp's 16 rows: one chain of KD k-steps of three
    // MMAs per n8 tile.  Each MMA truncates the running sum, so the longer
    // chains past DQK = 64 take every small term (lo.hi, hi.lo) in a first pass
    // and the hi.hi terms in a second: 16 truncations at the score's full
    // magnitude, not 48 (the worst f32 error at q x 4 fell from 2.2e-5 to
    // 1.5e-5 on an H100).  At D <= 64 the second pass would cost 6% of the
    // kernel for 13% of the error.
    constexpr bool TWO_PASS = KD > 8;
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < (TWO_PASS ? 2 : 1) * KD; ++kk) {
      const int ks = kk % KD;
      const bool small = !TWO_PASS || kk < KD, big = !TWO_PASS || kk >= KD;
      uint32_t ah[4], al[4];
      if constexpr (T::QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) ah[i] = qh[ks][i], al[i] = ql[ks][i];
      } else {
        uint32_t a[4];
        ldmatrix_x4(a, q_addr + 32 * ks);
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
      }
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t bh[4], bl[4];
        ldmatrix_x4(bh, kh_addr + 4 * (jp * 16 * LD + ks * 8));
        if (small) ldmatrix_x4(bl, kl_addr + 4 * (jp * 16 * LD + ks * 8));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float(&c)[4] = s[2 * jp + h];
          if (small) {
            mma_tf32(c, al, bh[2 * h], bh[2 * h + 1]);
            mma_tf32(c, ah, bl[2 * h], bl[2 * h + 1]);
          }
          if (big) mma_tf32(c, ah, bh[2 * h], bh[2 * h + 1]);
        }
      }
    }

    // scale (base 2), mask, and the online-softmax update
    const bool edge = k0 + BKT > S || (causal && k0 + BKT - 1 > q0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float t = s[j][e] * scale_log2;
        if (edge) {
          const int col = k0 + j * 8 + col_t + (e & 1);
          const int row = row_a + (e >> 1) * 8;
          if (col >= S || (causal && col > row)) t = -INFINITY;
        }
        s[j][e] = t;
        mx[e >> 1] = fmaxf(mx[e >> 1], t);
      }
    float m_safe[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      m_safe[r] = isfinite(m_new) ? m_new : 0.f;
      corr[r] = isfinite(m[r]) ? ex2(m[r] - m_safe[r]) : 0.f;
      m[r] = m_new;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[j][e] - m_safe[e >> 1]);  // 0 where masked
        s[j][e] = p;
        ps[e >> 1] += p;
      }
    l[0] = l[0] * corr[0] + ps[0];
    l[1] = l[1] * corr[1] + ps[1];

    // t = p v from zero, k-step c being score tile c: its accumulator is
    // the A fragment a0 = c0, a1 = c2, a2 = c1, a3 = c3 over kv in vT's
    // order (kv_pos), so p never leaves registers
    float t[ND][4];
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[j][e] = 0.f;
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      const float pa[4] = {s[c][0], s[c][2], s[c][1], s[c][3]};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(__float_as_uint(pa[i]), ah[i], al[i]);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t bh[4], bl[4];
        ldmatrix_x4(bh, vh_addr + 4 * (dp * 16 * LDT + c * 8));
        ldmatrix_x4(bl, vl_addr + 4 * (dp * 16 * LDT + c * 8));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float(&d)[4] = t[2 * dp + h];
          mma_tf32(d, al, bh[2 * h], bh[2 * h + 1]);
          mma_tf32(d, ah, bl[2 * h], bl[2 * h + 1]);
          mma_tf32(d, ah, bh[2 * h], bh[2 * h + 1]);
        }
      }
    }
    // acc = acc * corr + t, one rounding, as the TPU kernel adds each block
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = fmaf(acc[j][e], corr[e >> 1], t[j][e]);
  }

  float* ob = o + rows * DV;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = fmaxf(quad_sum(l[r]), 1e-30f);  // all lanes shuffle
    const int row = row_a + 8 * r;
    if (row >= S) continue;
    if constexpr (LSE)
      if ((lane & 3) == 0) lse[rows + row] = row_lse(m[r], den);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<float2*>(&ob[(size_t)row * DV + j * 8 + col_t]) =
          make_float2(acc[j][2 * r] / den, acc[j][2 * r + 1] / den);
  }
}

template <int DQK, int DV, bool LSE>
cudaError_t launch_f32(K3_LAUNCH_ARGS) {
  const int smem = (int)(F32Tile<DQK, DV>::WORDS * sizeof(uint32_t));
  static bool attr_set = false;
  cudaError_t e = mma::allow_smem(flash_fwd_tf32_kernel<DQK, DV, LSE>, smem, attr_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + F32_BQ - 1) / F32_BQ, BH);
  flash_fwd_tf32_kernel<DQK, DV, LSE><<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, S, causal, (float)(scale * 1.4426950408889634));
  return cudaGetLastError();
}
#endif  // REPRO_K3_F32

}  // namespace

// the exported instances: thin wrappers, so that each launcher's static
// (whether its kernel may take the shared memory it asks for) keeps
// internal linkage, one a library, where two builds loaded side by side
// (tools/k3_time.py) would otherwise share it
#ifdef REPRO_K3_BF16
template <int DQK, int DV, bool LSE>
cudaError_t k3_launch_bf16(K3_LAUNCH_ARGS) {
  return launch_bf16<DQK, DV, LSE>(q, k, v, o, lse, BH, S, causal, scale, stream);
}
#define K3_INSTANCE(DQK, DV)                                          \
  template cudaError_t k3_launch_bf16<DQK, DV, false>(K3_LAUNCH_ARGS); \
  template cudaError_t k3_launch_bf16<DQK, DV, true>(K3_LAUNCH_ARGS);
#endif

#ifdef REPRO_K3_F32
template <int DQK, int DV, bool LSE>
cudaError_t k3_launch_f32(K3_LAUNCH_ARGS) {
  return launch_f32<DQK, DV, LSE>(q, k, v, o, lse, BH, S, causal, scale, stream);
}
#define K3_INSTANCE(DQK, DV)                                         \
  template cudaError_t k3_launch_f32<DQK, DV, false>(K3_LAUNCH_ARGS); \
  template cudaError_t k3_launch_f32<DQK, DV, true>(K3_LAUNCH_ARGS);
#endif

#ifdef K3_INSTANCE
K3_INSTANCE(16, 16)
K3_INSTANCE(32, 32)
K3_INSTANCE(64, 64)
K3_INSTANCE(128, 128)
K3_INSTANCE(192, 128)
#else

namespace {

template <int DQK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                   int S, int dtype, int causal, float scale, cudaStream_t st) {
  // the row log-sum-exp is a separate instance, so inference runs the code
  // it ran before the backward existed
  if (dtype == 0)
    return lse ? k3_launch_f32<DQK, DV, true>(q, k, v, o, lse, BH, S, causal, scale, st)
               : k3_launch_f32<DQK, DV, false>(q, k, v, o, lse, BH, S, causal, scale, st);
  if (dtype == 1)
    return lse ? k3_launch_bf16<DQK, DV, true>(q, k, v, o, lse, BH, S, causal, scale, st)
               : k3_launch_bf16<DQK, DV, false>(q, k, v, o, lse, BH, S, causal, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k (BH, S, D) and v, o (BH, S, Dv) row-major on the device, all of one
// dtype: 0 = float32, 1 = bfloat16, 16-byte aligned.  (D, Dv): (16, 16),
// (32, 32), (64, 64), (128, 128) or (192, 128).
// lse: null, or (BH, S) float32 that receives each row's log-sum-exp of the
// scaled scores in natural-log units (what the backward kernel reads).
// causal: 0 or 1.  Returns a cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int BH, int S, int D, int Dv, int dtype,
                                     int causal, float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (BH <= 0 || BH > 65535 || S <= 0 || (causal != 0 && causal != 1))
    return (int)cudaErrorInvalidValue;
  if (D == 192 && Dv == 128)
    return (int)launch<192, 128>(q, k, v, o, l, BH, S, dtype, causal, scale, st);
  if (Dv != D) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return (int)launch<16, 16>(q, k, v, o, l, BH, S, dtype, causal, scale, st);
    case 32: return (int)launch<32, 32>(q, k, v, o, l, BH, S, dtype, causal, scale, st);
    case 64: return (int)launch<64, 64>(q, k, v, o, l, BH, S, dtype, causal, scale, st);
    case 128: return (int)launch<128, 128>(q, k, v, o, l, BH, S, dtype, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif
