// K3-bwd: the gradient of K3 (flash_attention.cu) for Hopper (sm_90a).
//
// Replaces what the JAX package gets from autodiff of
// src/repro/models/layers.py::chunked_attention (the TPU kernel K3 has no
// backward of its own).  For q, k of shape (BH, S, DQK) and v, o, dO of
// shape (BH, S, DV), row-major, float32 or bfloat16, and lse (BH, S)
// float32 from K3's forward (each row's log-sum-exp of the scaled scores,
// natural log), it writes dq, dk (BH, S, DQK) and dv (BH, S, DV) in the
// input dtype, at K3's instances: DQK = DV in {16, 32, 64, 128}, and MLA's
// (DQK, DV) = (192, 128) (DeepSeek-V2: q . k over 128 + 64 rope dims):
//   p_ij  = exp(scale q_i . k_j - lse_i), 0 where masked (j > i when
//           causal, and every row or column at or past S)
//   dp_ij = dO_i . v_j,   delta_i = dO_i . o_i,   ds_ij = p_ij (dp_ij - delta_i)
//   dv_j = sum_i p_ij dO_i,  dk_j = scale sum_i ds_ij q_i,  dq_i = scale sum_j ds_ij k_j
// with every product and sum to float32 grade.
//
// s and dq run over DQK, dp and dv over DV, delta over DV.
//
// What bounds it: operations.  The gradient needs 5 products of the
// forward's size (s, dp, dv, dk, dq).  This design does 7 (both passes
// rebuild s and dp), as 10 bf16 MMA units (p and ds enter dv, dk and dq as
// two bf16 terms each) or 21 tf32 units (3xTF32: three MMAs a product).
// On the H100 the bf16 path issues its wgmmas at ~40% of the tensor cores'
// peak, ~5x its bound (PERF.md): each consumer warpgroup runs its tile's
// scores, softmax and products in series, and only the other warpgroup
// overlaps it.
//
// Three launches, no atomics, so a run gives the same bits every time:
//  * a rows pass: per row (lse log2 e, delta = rowsum(dO o)) in float32,
//    one warp a row, into a (BH, S_pad) array of pairs;
//  * dkdv: a block owns kv rows of one (batch, head) and walks the q tiles
//    that see them (causal: from its own diagonal on), rebuilding p and ds
//    for each tile and summing dk and dv in registers;
//  * dq: a block owns q rows and walks the kv tiles they see, rebuilding p
//    and ds and summing dq.  Blocks take q rows in reverse order, so the
//    longest causal rows start first.
//
// bfloat16 (bwd_dkdv_wgmma_kernel, bwd_dq_wgmma_kernel): warpgroup MMAs
// fed by TMA (csrc/wgmma.cuh).  A block is three warpgroups: one producer
// and two consumers, each consumer owning 64 rows (wgmma's M), 128 a block.
//  * The producer's first thread loads the owned pair (k, v or q, dO) once,
//    then streams the walked tiles (64 rows; 32 at D = 128 and 16 at (192,
//    128), for registers) through a 4-stage ring (8 at 16 rows) under full /
//    empty mbarriers: 3-D tensor maps over (BH, S, D), so rows past S
//    zero-fill inside a head.  The dkdv
//    ring also carries each tile's (lse log2 e, delta) pairs, bulk-copied
//    from the rows pass's padded array.  setmaxnreg moves the producer's
//    registers to the consumers (24 / 240).
//  * s^T and dp^T (dkdv) run SS: both operands K-major in shared memory.
//    s and dp (dq) run RS at D <= 64: each consumer reads its owned q and
//    dO rows once into A fragments (ldmatrix through the swizzle), which
//    halves the shared-memory reads of those products; at D = 128 they
//    run SS, for registers.
//  * p and ds are float32 in the accumulators; as K3's forward does for p,
//    each is split into two bf16 terms (hi = bf16(x), lo = bf16(x - hi)),
//    about 16 significant bits, straight into RS A fragments (the
//    accumulator layout is the A-fragment layout).  dv += p^T dO, dk +=
//    ds^T q and dq += ds k run RS against the walked tile read MN-major,
//    two wgmmas per k-step.
//  * Descriptors are built once per consumer from warp-uniform values (a
//    shuffle shows the compiler that they are), so each wgmma's operands
//    are a uniform register plus an immediate, with no address arithmetic
//    between the wgmmas of a chain.
//  * The tensor cores' f32 accumulation truncates, so each walked tile's
//    product starts from zero and is added into the float32 sum with one
//    rounded add, as K3's forward folds each kv tile.
//  * Causal: a consumer skips a walked tile that its rows cannot see, and
//    masks only the tiles that cross the diagonal or S.
//  * (192, 128): a dk/dv consumer holds dk (64 x 192) and dv (64 x 128)
//    in float32, 160 registers a thread, so the walked tile is 16 rows
//    (scores of 8 registers each, an m64n16 wgmma) and the products into dk
//    and dv keep their 64-column panels: no spills within the 240 of
//    setmaxnreg.  Shared memory: 80 KB owned, 8 stages of 10 KB.
//  * Left for later: one pass for dk, dv and dq (8 products instead of 10),
//    and overlapping a tile's softmax with the next tile's MMAs inside a
//    warpgroup (registers are the limit at D = 64).
//
// float32 (bwd_dkdv_tf32_kernel, bwd_dq_tf32_kernel): the same walk on
// tf32 warpgroup MMAs, every product a 3xTF32 split (csrc/tf32.cuh: a =
// hi + lo, hi = tf32(a), lo = tf32(a - hi); lo.hi + hi.lo + hi.hi, small
// terms first, lo.lo dropped).  The block's pieces (the split, the
// producer, the scores and the products against transposed planes) are in
// csrc/tf32_wgmma.cuh, which K3's float32 forward runs too.  A single TF32
// product keeps 10 mantissa bits, 30-150x over the float32 limit
// (flash_attention.cu).
//  * tf32 wgmma reads shared memory K-major only: s and dp read the owned
//    and walked rows as stored, but dv += p^T dO, dk += ds^T q and dq +=
//    ds k sum over the walked rows, so they read a transposed copy of the
//    walked tile.  TMA cannot split or transpose, so the producer
//    warpgroup does both: TMA lands each walked tile in a raw ring (2
//    stages), and the producer's 128 threads split it into hi and lo
//    planes as stored and hi and lo planes of the transpose (q and dO for
//    dk/dv, k for dq).  The owned pair is split once, in place.
//  * The split is ALU and shared-memory work (5 operations and 2 or 4
//    stores an element) that the consumers would otherwise wait for: at
//    D = 64 it cost 18% of the time in series.  So each stage is handed on
//    in two parts under two full / empty pairs: the planes as stored once
//    the consumers' scores have read the previous tile's, the transposed
//    planes once their products have (a third of the split's cost came
//    back: dk/dv 3.43 -> 3.20 ms at (60, 4096, 64); splitting in the
//    consumers instead, 256 threads once a tile, was slower: 6.27 against
//    6.08 ms, PERF.md).
//  * p and ds go from the accumulators straight into RS A fragments,
//    split hi + lo in registers.  A tf32 fragment holds columns t, t + 4
//    of a k-step where the accumulator holds 2t, 2t + 1, so the transposed
//    planes store walked row 2t of each 8 at k position t and 2t + 1 at
//    t + 4 (kpos): the K index is permuted, not the data.
//  * Shared memory: an f32 plane is twice a bf16 tile, and each operand
//    is two planes (hi, lo), four with the transpose.  Walked tiles are 32
//    rows (16 at D = 128); the plane ring has 2 stages at D <= 32 and 1
//    at D = 64 and 128, where the owned planes take 128 KB.  At D = 128 a
//    block owns 64 rows (one consumer warpgroup), else 128 (two).
//  * (192, 128), run only in training's float32 card-vs-CPU checks: one
//    consumer warpgroup of 64 owned rows, whose hi and lo planes take 160
//    KB; walked tiles of 8 rows (m64n8 scores, transposed planes of 32-byte
//    rows under the 32-byte swizzle), one stage: 221 KB of the 227 KB.
//    dk / dv and dq spill (PERF.md); right first, not fast.
//  * s and dp run SS (the owned hi and lo planes as A), but for dq at
//    D <= 64 the owned hi terms are A fragments in registers, read once:
//    hi.lo and hi.hi run RS (dq 2.57 -> 2.01 ms).  The products into dk,
//    dv and dq run RS in column chunks of up to 64 (32 at D = 128, for
//    registers), each chunk's product started from zero and folded into
//    the float32 sum with one rounded add.  The rows pass's (lse2, delta)
//    pairs ride with each walked tile, as in the bf16 path.
//
// Interface: a plain C function for ctypes.  It launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"
#include "tf32_wgmma.cuh"
#include "wgmma.cuh"

namespace {

using namespace mma;
using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// --------------------------------------------------------------- bfloat16

constexpr int WG_THREADS = 128;
constexpr int CONSUMERS = 2;                // consumer warpgroups, 64 owned rows each
constexpr int BR = 64 * CONSUMERS;          // rows a block owns
constexpr int BLOCK_THREADS = WG_THREADS * (1 + CONSUMERS);
// setmaxnreg: the producer warpgroup gives its registers to the consumers
// (24 x 128 + 2 x 240 x 128 = 168 x 384, the launch's allotment)
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

// a bf16 matrix as panels, its TMA loads and tensor maps, and the split of
// an accumulator tile into hi and lo A fragments: csrc/wgmma.cuh, shared
// with K3's forward
using wg::load_rows_tma;
using wg::Panels;
using wg::split_frags;
using wg::tensor_map;

// a block's tiles: owned BR rows, walked tiles of BT rows.  A pair of
// matrices is (a, b): a of DQK columns (k or q), b of DV columns (v or dO).
template <int DQK, int DV>
struct Tiles {
  using A = Panels<DQK>;
  using B = Panels<DV>;
  // rows of a walked tile: fewer as the accumulators grow (registers)
  static constexpr int BT = DQK + DV > 256 ? 16 : DQK == 128 ? 32 : 64;
  static constexpr int STAGES = BT == 16 ? 8 : 4;  // depth of the ring
  static constexpr int OWN_A = BR * DQK * 2;       // bytes of the owned a, b
  static constexpr int OWN_B = BR * DV * 2;
  static constexpr int TILE_A = BT * DQK * 2;      // bytes of a walked a, b
  static constexpr int TILE_B = BT * DV * 2;
  static constexpr int STAGE = TILE_A + TILE_B;    // bytes of a walked pair
  static constexpr int ROWS = BT * 8;              // bytes of a walked tile's (lse2, delta) pairs
  // byte offsets from the 1024-aligned base: the owned pair, the ring of
  // walked pairs, the ring's (lse2, delta), then the barriers
  static constexpr int STAGE0 = OWN_A + OWN_B;
  static constexpr int ROWS0 = STAGE0 + STAGES * STAGE;
  static constexpr int BARS = ROWS0 + STAGES * ROWS;
  static constexpr int BYTES = BARS + (2 * STAGES + 1) * 8 + 1024;  // + the alignment slack
  static_assert(OWN_A % 1024 == 0 && TILE_A % 1024 == 0 && STAGE % 1024 == 0,
                "every tile on a 1024-byte boundary (the 128-byte swizzle)");
};

// the rows pass: per (batch-head, row) the pair (lse * log2 e, delta =
// rowsum(dO o) in float32, over o's D columns) in a (BH, S_pad) array,
// zero past S; one warp a row
template <typename T, int D>
__global__ void __launch_bounds__(256)
    rows_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                const float* __restrict__ lse, float2* __restrict__ rows, int S, int S_pad) {
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= S_pad) return;
  float s = 0.f, l2 = 0.f;
  if (r < S) {
    const size_t base = ((size_t)blockIdx.y * S + r) * D;
    for (int d = lane; d < D; d += 32) s = fmaf(to_f32(o[base + d]), to_f32(dO[base + d]), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    l2 = lse[(size_t)blockIdx.y * S + r] * LOG2E;
  }
  if (lane == 0) rows[(size_t)blockIdx.y * S_pad + r] = make_float2(l2, s);
}

// acc (64 x D) += x tile, x (64 x KR) given as its hi and lo fragments,
// tile (KR rows, D columns; descriptor `tile`) read MN-major; each panel's
// product starts from zero and folds into acc with one rounded add
template <int D, int KR>
__device__ __forceinline__ void accumulate(float (&acc)[D / 2], uint32_t (&hi)[KR / 16][4],
                                           uint32_t (&lo)[KR / 16][4], uint64_t tile) {
  constexpr int CW = Panels<D>::CW;
#pragma unroll
  for (int p = 0; p < Panels<D>::NP; ++p) {
    float t[CW / 2];
    wg::fence();
#pragma unroll
    for (int c = 0; c < KR / 16; ++c) {
      const uint64_t b = tile + wg::mn_step<D, KR>(p, c);
      wg::mma_rs<CW, 1>(t, lo[c], b, c > 0);
      wg::mma_rs<CW, 1>(t, hi[c], b);
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(t);
    wg::fence_operand(hi);
    wg::fence_operand(lo);
#pragma unroll
    for (int i = 0; i < CW / 2; ++i) acc[p * CW / 2 + i] += t[i];
  }
}

// s (64 x BT) = 64 owned rows . tile^T, both K-major in shared memory
// (descriptors: `own` at the warpgroup's first row of a BR-row matrix,
// `tile`); started with wgmma.fence, left uncommitted
template <int D, int BT>
__device__ __forceinline__ void scores(float (&s)[BT / 2], uint64_t own, uint64_t tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wg::mma_ss<BT, 0>(s, own + wg::k_step<D, BR>(kk), tile + wg::k_step<D, BT>(kk), kk > 0);
}

// the A fragments of rows [r0, r0 + 64) of an owned matrix (BR rows, D
// columns, TMA-swizzled panels at generic address `own`): for each k-step,
// this warp's 16 rows in the RS A layout
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const unsigned char* own, int r0,
                                       int warp, int lane) {
  using T = Panels<D>;
  constexpr int B = T::RB == 128 ? 3 : T::RB == 64 ? 2 : 1;  // swizzle bits
  const int row = r0 + warp * 16 + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = row * T::RB + ((kk % (T::CW / 16)) * 2 + (lane >> 4)) * 16;
    const int phys = off ^ (((off >> 7) & ((1 << B) - 1)) << 4);
    ldmatrix_x4(a[kk], smem_addr(own + (kk / (T::CW / 16)) * BR * T::RB + phys));
  }
}

// s (64 x BT) = this warpgroup's 64 owned rows (A fragments) . tile^T
// (K-major in shared memory); started with wgmma.fence, left uncommitted
template <int D, int BT>
__device__ __forceinline__ void scores_rs(float (&s)[BT / 2], uint32_t (&a)[D / 16][4],
                                          uint64_t tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wg::mma_rs<BT, 0>(s, a[kk], tile + wg::k_step<D, BT>(kk), kk > 0);
}

// this thread's rows of acc * mul into out (S, D) as bf16; rows past S skipped
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[D / 2], float mul,
                                           int row_a, int S, int lane) {
  constexpr int CW = Panels<D>::CW;
  const int col_t = 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int p = 0; p < Panels<D>::NP; ++p)
#pragma unroll
      for (int j = 0; j < CW / 8; ++j) {
        const int i = p * CW / 2 + 4 * j + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(&out[(size_t)row * D + p * CW + 8 * j + col_t]) =
            __floats2bfloat162_rn(acc[i] * mul, acc[i + 1] * mul);
      }
  }
}

// the block's shared memory, 1024-aligned, and its barriers: full[s] (one
// expect_tx arrival from the producer), empty[s] (one arrival per consumer
// warp), own (the owned pair)
template <typename T>
struct Ring {
  uint32_t base, full, empty, own;
  unsigned char* ptr;  // generic address of base
  __device__ __forceinline__ Ring(unsigned char* raw) {
    const uint32_t a = wg::smem_u32(raw);
    base = (a + 1023) & ~1023u;
    ptr = raw + (base - a);
    full = base + T::BARS;
    empty = full + 8 * T::STAGES;
    own = empty + 8 * T::STAGES;
  }
  __device__ __forceinline__ uint32_t stage(int s) const { return base + T::STAGE0 + s * T::STAGE; }
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < T::STAGES; ++s) {
      wg::mbar_init(full + 8 * s, 1);
      wg::mbar_init(empty + 8 * s, 4 * CONSUMERS);
    }
    wg::mbar_init(own, 1);
    wg::mbar_fence_init();
  }
};

// dk, dv: a block owns BR kv rows of one batch-head, each consumer
// warpgroup 64 of them, and walks the q tiles that see them (causal: from
// the block's diagonal on).  Per tile: s^T = k q^T (over DQK) and dp^T =
// v dO^T (over DV) (SS), p^T and ds^T in registers, dv += p^T dO and dk +=
// ds^T q (RS, hi + lo).
template <int DQK, int DV>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
    bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo, const float2* __restrict__ rows,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int S_pad,
                          int causal, float scale, float scale_log2) {
  using T = Tiles<DQK, DV>;
  using PA = typename T::A;
  using PB = typename T::B;
  constexpr int BT = T::BT;
  extern __shared__ __align__(1024) unsigned char ring_smem[];
  const Ring<T> ring(ring_smem);
  const int bh = blockIdx.y, kv0 = blockIdx.x * BR;
  const int first = causal ? kv0 / BT : 0;  // q tiles before it see none of these kv rows
  const int n = (S + BT - 1) / BT - first;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int wgi = threadIdx.x / WG_THREADS;
  if (wgi == 0) {  // producer: one thread issues every copy
    wg::regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      wg::mbar_expect_tx(ring.own, T::OWN_A + T::OWN_B);
      load_rows_tma<PA, BT>(ring.base, &tk, ring.own, kv0, BR, bh);
      load_rows_tma<PB, BT>(ring.base + T::OWN_A, &tv, ring.own, kv0, BR, bh);
      for (int i = 0; i < n; ++i) {
        const int s = i % T::STAGES, q0 = (first + i) * BT;
        wg::mbar_wait(ring.empty + 8 * s, ((i / T::STAGES) & 1) ^ 1);
        const uint32_t full = ring.full + 8 * s, st = ring.stage(s);
        wg::mbar_expect_tx(full, T::STAGE + T::ROWS);
        load_rows_tma<PA, BT>(st, &tq, full, q0, BT, bh);
        load_rows_tma<PB, BT>(st + T::TILE_A, &tdo, full, q0, BT, bh);
        wg::bulk_load(ring.base + T::ROWS0 + s * T::ROWS, rows + (size_t)bh * S_pad + q0, T::ROWS,
                      full);
      }
    }
  } else {
    wg::regs_inc<CONSUMER_REGS>();
    // warp-uniform (a shuffle shows the compiler), so that the descriptors
    // below live in uniform registers and cost no instructions per wgmma
    const int c = __shfl_sync(0xffffffffu, wgi, 0) - 1;
    const uint32_t base = __shfl_sync(0xffffffffu, ring.base, 0);
    const int t = threadIdx.x % WG_THREADS, lane = t & 31;
    const int r0 = kv0 + 64 * c;                    // this warpgroup's first kv row
    const int row_a = r0 + (t >> 5) * 16 + (lane >> 2);  // a thread's kv rows: row_a, row_a + 8
    const int col_t = 2 * (lane & 3);
    float dk_acc[DQK / 2], dv_acc[DV / 2];
#pragma unroll
    for (int i = 0; i < DQK / 2; ++i) dk_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dv_acc[i] = 0.f;
    const uint64_t own_k = wg::tile_desc<DQK>(base) + (64 * c * PA::RB >> 4);
    const uint64_t own_v = wg::tile_desc<DV>(base + T::OWN_A) + (64 * c * PB::RB >> 4);
    const uint64_t stage_a = wg::tile_desc<DQK>(base + T::STAGE0);
    const uint64_t stage_b = wg::tile_desc<DV>(base + T::STAGE0 + T::TILE_A);
    wg::mbar_wait(ring.own, 0);

    for (int i = 0; i < n; ++i) {
      const int s = i % T::STAGES, q0 = (first + i) * BT;
      wg::mbar_wait(ring.full + 8 * s, (i / T::STAGES) & 1);
      const uint64_t qt = stage_a + (s * T::STAGE >> 4), dot = stage_b + (s * T::STAGE >> 4);
      if (!causal || q0 + BT > r0) {  // else every q row of the tile precedes these kv rows
        float sT[BT / 2], dpT[BT / 2];
        wg::fence();
        scores<DQK, BT>(sT, own_k, qt);
        scores<DV, BT>(dpT, own_v, dot);
        wg::commit();
        wg::wait<0>();
        wg::fence_operand(sT);
        wg::fence_operand(dpT);

        // p^T and ds^T, masked; a tile's (lse2, delta) pairs sit in the ring
        const float4* lr = reinterpret_cast<const float4*>(ring.ptr + T::ROWS0 + s * T::ROWS);
        const bool edge = q0 + BT > S || r0 + 64 > S || (causal && q0 < r0 + 63);
#pragma unroll
        for (int j = 0; j < BT / 8; ++j) {
          const float4 w = lr[4 * j + (lane & 3)];  // q columns 8 j + col_t and + 1
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float l2 = e & 1 ? w.z : w.x, dl = e & 1 ? w.w : w.y;
            float p = ex2(sT[4 * j + e] * scale_log2 - l2);
            if (edge) {
              const int kv = row_a + (e >> 1) * 8, qr = q0 + 8 * j + col_t + (e & 1);
              if (qr >= S || kv >= S || (causal && kv > qr)) p = 0.f;
            }
            sT[4 * j + e] = p;
            dpT[4 * j + e] = p * (dpT[4 * j + e] - dl);
          }
        }

        // dv += p^T dO and dk += ds^T q
        uint32_t hi[BT / 16][4], lo[BT / 16][4];
        split_frags<BT>(sT, hi, lo);
        accumulate<DV, BT>(dv_acc, hi, lo, dot);
        split_frags<BT>(dpT, hi, lo);
        accumulate<DQK, BT>(dk_acc, hi, lo, qt);
      }
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(ring.empty + 8 * s);
    }
    store_rows<DQK>(dk + (size_t)bh * S * DQK, dk_acc, scale, row_a, S, lane);
    store_rows<DV>(dv + (size_t)bh * S * DV, dv_acc, 1.f, row_a, S, lane);
  }
}

// dq: a block owns BR q rows, each consumer warpgroup 64 of them, and walks
// the kv tiles they see.  Blocks take q rows in reverse order, so the
// longest causal rows start first.  Per tile: s = q k^T and dp = dO v^T
// (SS), ds in registers, dq += ds k (RS, hi + lo).
template <int DQK, int DV>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
    bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo, const float2* __restrict__ rows,
                        bf16* __restrict__ dq, int S, int S_pad, int causal, float scale,
                        float scale_log2) {
  using T = Tiles<DQK, DV>;
  using PA = typename T::A;
  using PB = typename T::B;
  constexpr int BT = T::BT;
  extern __shared__ __align__(1024) unsigned char ring_smem[];
  const Ring<T> ring(ring_smem);
  const int bh = blockIdx.y;
  const int q0 = ((S + BR - 1) / BR - 1 - (int)blockIdx.x) * BR;
  const int kv_end = causal ? min(S, q0 + BR) : S;
  const int n = (kv_end + BT - 1) / BT;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int wgi = threadIdx.x / WG_THREADS;
  if (wgi == 0) {
    wg::regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      wg::mbar_expect_tx(ring.own, T::OWN_A + T::OWN_B);
      load_rows_tma<PA, BT>(ring.base, &tq, ring.own, q0, BR, bh);
      load_rows_tma<PB, BT>(ring.base + T::OWN_A, &tdo, ring.own, q0, BR, bh);
      for (int i = 0; i < n; ++i) {
        const int s = i % T::STAGES;
        wg::mbar_wait(ring.empty + 8 * s, ((i / T::STAGES) & 1) ^ 1);
        const uint32_t full = ring.full + 8 * s, st = ring.stage(s);
        wg::mbar_expect_tx(full, T::STAGE);
        load_rows_tma<PA, BT>(st, &tk, full, i * BT, BT, bh);
        load_rows_tma<PB, BT>(st + T::TILE_A, &tv, full, i * BT, BT, bh);
      }
    }
  } else {
    wg::regs_inc<CONSUMER_REGS>();
    const int c = __shfl_sync(0xffffffffu, wgi, 0) - 1;  // warp-uniform, as in dkdv
    const uint32_t base = __shfl_sync(0xffffffffu, ring.base, 0);
    const int t = threadIdx.x % WG_THREADS, lane = t & 31;
    const int r0 = q0 + 64 * c;
    const int row_a = r0 + (t >> 5) * 16 + (lane >> 2);  // a thread's q rows: row_a, row_a + 8
    const int col_t = 2 * (lane & 3);
    float2 lr[2];  // (lse2, delta) of the thread's rows; S_pad covers the block
#pragma unroll
    for (int r = 0; r < 2; ++r) lr[r] = rows[(size_t)bh * S_pad + row_a + 8 * r];
    float dq_acc[DQK / 2];
#pragma unroll
    for (int i = 0; i < DQK / 2; ++i) dq_acc[i] = 0.f;
    const uint64_t own_q = wg::tile_desc<DQK>(base) + (64 * c * PA::RB >> 4);
    const uint64_t own_do = wg::tile_desc<DV>(base + T::OWN_A) + (64 * c * PB::RB >> 4);
    const uint64_t stage_a = wg::tile_desc<DQK>(base + T::STAGE0);
    const uint64_t stage_b = wg::tile_desc<DV>(base + T::STAGE0 + T::TILE_A);
    wg::mbar_wait(ring.own, 0);
    constexpr bool AREG = DQK <= 64 && DV <= 64;  // the owned rows' A fragments in registers
    uint32_t qa[AREG ? DQK / 16 : 1][4], ga[AREG ? DV / 16 : 1][4];
    if constexpr (AREG) {
      load_a<DQK>(qa, ring.ptr, 64 * c, t >> 5, lane);
      load_a<DV>(ga, ring.ptr + T::OWN_A, 64 * c, t >> 5, lane);
    }

    for (int i = 0; i < n; ++i) {
      const int s = i % T::STAGES, k0 = i * BT;
      wg::mbar_wait(ring.full + 8 * s, (i / T::STAGES) & 1);
      const uint64_t kt = stage_a + (s * T::STAGE >> 4), vt = stage_b + (s * T::STAGE >> 4);
      if (!causal || k0 <= r0 + 63) {  // else every kv row of the tile follows these q rows
        float sc[BT / 2], dp[BT / 2];
        wg::fence();
        if constexpr (AREG) {
          scores_rs<DQK, BT>(sc, qa, kt);
          scores_rs<DV, BT>(dp, ga, vt);
        } else {
          scores<DQK, BT>(sc, own_q, kt);
          scores<DV, BT>(dp, own_do, vt);
        }
        wg::commit();
        wg::wait<0>();
        wg::fence_operand(sc);
        wg::fence_operand(dp);
        if constexpr (AREG) {
          wg::fence_operand(qa);
          wg::fence_operand(ga);
        }

        const bool edge = k0 + BT > S || r0 + 64 > S || (causal && k0 + BT - 1 > r0);
#pragma unroll
        for (int j = 0; j < BT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 w = lr[e >> 1];
            float p = ex2(sc[4 * j + e] * scale_log2 - w.x);
            if (edge) {
              const int row = row_a + (e >> 1) * 8, col = k0 + 8 * j + col_t + (e & 1);
              if (col >= S || row >= S || (causal && col > row)) p = 0.f;
            }
            sc[4 * j + e] = p * (dp[4 * j + e] - w.y);
          }

        // dq += ds k
        uint32_t hi[BT / 16][4], lo[BT / 16][4];
        split_frags<BT>(sc, hi, lo);
        accumulate<DQK, BT>(dq_acc, hi, lo, kt);
      }
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(ring.empty + 8 * s);
    }
    store_rows<DQK>(dq + (size_t)bh * S * DQK, dq_acc, scale, row_a, S, lane);
  }
}

// ---------------------------------------------------------------- float32

// the float32 block's pieces (panels, the split, the scores, the products
// against the transposed planes, the ring and its producer warpgroup):
// csrc/tf32_wgmma.cuh, shared with K3's forward
using tf32::accumulate_tf32;
using tf32::F32Panels;
using tf32::F32Ring;
using tf32::f32_nw;
using tf32::f32_producer;
using tf32::load_a_tf32;
using tf32::scores_tf32;
using tf32::scores_tf32_rs;

// the float32 path's block (see the header); DKDV: the dk/dv kernel, else
// dq.  A pair of matrices is (a, b): a of DQK columns (k or q), b of DV
// columns (v or dO).
template <int DQK_, int DV_, bool DKDV>
struct F32Tiles {
  static constexpr int DQK = DQK_, DV = DV_;
  using A = F32Panels<DQK>;
  using B = F32Panels<DV>;
  static constexpr bool WIDE = DQK + DV > 256;        // MLA's (192, 128)
  static constexpr int C = DQK >= 128 ? 1 : 2;        // consumer warpgroups (shared memory)
  static constexpr int BR = 64 * C;                   // rows a block owns
  static constexpr int THREADS = WG_THREADS * (1 + C);
  static constexpr int BT = WIDE ? 8 : DQK == 128 ? 16 : 32;  // rows of a walked tile
  static constexpr int KW = BT < 32 ? BT : 32;        // k positions of a transposed panel row
  static constexpr int RBT = 4 * KW;                  // its bytes
  static constexpr int OWN_A = BR * DQK * 4;          // bytes of one owned plane of a, of b
  static constexpr int OWN_B = BR * DV * 4;
  static constexpr int TILE_A = BT * DQK * 4;         // bytes of one walked plane of a, of b
  static constexpr int TILE_B = BT * DV * 4;
  static constexpr int ROWS = BT * 8;                 // a walked tile's (lse2, delta) pairs
  static constexpr int RAWS = 2;                      // raw stages (TMA's landing ring)
  // the planes the producer writes: a and b as stored, a transposed, b
  // transposed for dk/dv; the (lse2, delta) pairs ride with dk/dv's tiles
  static constexpr bool STORED_B = true, TRANS_A = true, TRANS_B = DKDV, ROWS_RIDE = DKDV;
  // a stage of the plane ring: a hi, a lo, b hi, b lo as stored, then the
  // transposed a hi, a lo and, for dk/dv, b hi, b lo (byte offsets)
  static constexpr int A_LO = TILE_A, B_HI = 2 * TILE_A, B_LO = B_HI + TILE_B;
  static constexpr int TA_HI = B_LO + TILE_B, TA_LO = TA_HI + TILE_A;
  static constexpr int TB_HI = TA_LO + TILE_A, TB_LO = TB_HI + TILE_B;
  static constexpr int PLANES = DKDV ? TB_LO + TILE_B : TB_HI;  // bytes of a stage
  // byte offsets from the 1024-aligned base: the owned planes (a hi, a lo,
  // b hi, b lo), the raw ring (a, b), the plane ring, the raw ring's
  // (lse2, delta) pairs and STAGES + 1 buffers of them beside the plane
  // ring, the barriers
  static constexpr int RAW0 = 2 * OWN_A + 2 * OWN_B;
  static constexpr int RAW = TILE_A + TILE_B;          // bytes of a raw stage
  static constexpr int PLANE0 = RAW0 + RAWS * RAW;
  static constexpr int FIXED = PLANE0 + (RAWS + 1) * ROWS + 1024 + 128;
  static constexpr int STAGES = tf32::SMEM_LIMIT - FIXED >= 2 * (PLANES + ROWS) ? 2 : 1;
  static constexpr int ROWBUFS = STAGES + 1;
  static constexpr int ROWS0 = PLANE0 + STAGES * PLANES;
  static constexpr int BARS = ROWS0 + (RAWS + ROWBUFS) * ROWS;
  static constexpr int BYTES = BARS + (RAWS + 4 * STAGES + 2) * 8 + 1024;
  static_assert(BYTES <= tf32::SMEM_LIMIT, "the float32 block's shared memory");
  static_assert(OWN_A % 1024 == 0 && OWN_B % 1024 == 0 && TILE_A % 1024 == 0 &&
                    TILE_B % 1024 == 0,
                "every plane on a 1024-byte boundary (the 128-byte swizzle)");
};

// acc += x . the walked tile: each column chunk's product folded in with
// one rounded add
struct AddFold {
  __device__ __forceinline__ float operator()(float a, float t, int) const { return a + t; }
};

template <typename T, int D>
__device__ __forceinline__ void accumulate_f32(float (&acc)[D / 2], const float (&x)[T::BT / 2],
                                               uint64_t bt_hi, uint64_t bt_lo) {
  accumulate_tf32<T, D, f32_nw<D>()>(acc, x, bt_hi, bt_lo, AddFold());
}

// this thread's rows of acc * mul into out (S, D) float32; rows past S skipped
template <int D>
__device__ __forceinline__ void store_rows_f32(float* out, const float (&acc)[D / 2], float mul,
                                               int row_a, int S, int lane) {
  const int col_t = 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(&out[(size_t)row * D + 8 * j + col_t]) =
          make_float2(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

// dk, dv in float32: a block owns BR kv rows of one batch-head, each
// consumer warpgroup 64 of them, and walks the q tiles that see them
// (causal: from the block's diagonal on).  Per tile: s^T = k q^T and
// dp^T = v dO^T (SS, 3xTF32), p^T and ds^T in registers, dv += p^T dO and
// dk += ds^T q (RS, 3xTF32 against the transposed planes).
template <int DQK, int DV>
__global__ void __launch_bounds__(F32Tiles<DQK, DV, true>::THREADS, 1)
    bwd_dkdv_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo, const float2* __restrict__ rows,
                         float* __restrict__ dk, float* __restrict__ dv, int S, int S_pad,
                         int causal, float scale, float scale_log2) {
  using T = F32Tiles<DQK, DV, true>;
  using PA = typename T::A;
  using PB = typename T::B;
  constexpr int BT = T::BT, BR = T::BR;
  extern __shared__ __align__(1024) unsigned char f32_smem[];
  const F32Ring<T> ring(f32_smem);
  const int bh = blockIdx.y, kv0 = blockIdx.x * BR;
  const int first = causal ? kv0 / BT : 0;  // q tiles before it see none of these kv rows
  const int n = (S + BT - 1) / BT - first;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int wgi = threadIdx.x / WG_THREADS;
  if (wgi == 0) {
    if constexpr (T::C > 1) wg::regs_dec<tf32::PRODUCER_REGS>();
    f32_producer<T>(ring, &tk, &tv, &tq, &tdo, rows, kv0, first, n, bh, S_pad);
  } else {
    if constexpr (T::C > 1) wg::regs_inc<tf32::CONSUMER_REGS>();
    // warp-uniform (a shuffle shows the compiler), as in the bf16 kernels
    const int c = __shfl_sync(0xffffffffu, wgi, 0) - 1;
    const uint32_t base = __shfl_sync(0xffffffffu, ring.base, 0);
    const int t = threadIdx.x % WG_THREADS, lane = t & 31;
    const int r0 = kv0 + 64 * c;                         // this warpgroup's first kv row
    const int row_a = r0 + (t >> 5) * 16 + (lane >> 2);  // a thread's kv rows: row_a, row_a + 8
    const int col_t = 2 * (lane & 3);
    float dk_acc[DQK / 2], dv_acc[DV / 2];
#pragma unroll
    for (int i = 0; i < DQK / 2; ++i) dk_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dv_acc[i] = 0.f;
    const uint64_t k_hi = wg::rows_desc<PA::RB>(base) + (64 * c * PA::RB >> 4);
    const uint64_t k_lo = k_hi + (T::OWN_A >> 4);
    const uint64_t v_hi = wg::rows_desc<PB::RB>(base + 2 * T::OWN_A) + (64 * c * PB::RB >> 4);
    const uint64_t v_lo = v_hi + (T::OWN_B >> 4);
    const uint64_t plane_a = wg::rows_desc<PA::RB>(base + T::PLANE0);
    const uint64_t plane_b = wg::rows_desc<PB::RB>(base + T::PLANE0);
    const uint64_t plane_t = wg::rows_desc<T::RBT>(base + T::PLANE0);
    wg::mbar_wait(ring.own, 0);

    for (int i = 0; i < n; ++i) {
      const int s = i % T::STAGES, ph = (i / T::STAGES) & 1, q0 = (first + i) * BT;
      const uint64_t st = (uint64_t)(s * T::PLANES) >> 4;
      const bool sees = !causal || q0 + BT > r0;  // else every q row precedes these kv rows
      float sT[BT / 2], dpT[BT / 2];
      wg::mbar_wait(ring.full + 8 * s, ph);
      if (sees) {
        wg::fence();
        scores_tf32<PA, BR, BT>(sT, k_hi, k_lo, plane_a + st, plane_a + st + (T::A_LO >> 4));
        scores_tf32<PB, BR, BT>(dpT, v_hi, v_lo, plane_b + st + (T::B_HI >> 4),
                                plane_b + st + (T::B_LO >> 4));
        wg::commit();
        wg::wait<0>();
        wg::fence_operand(sT);
        wg::fence_operand(dpT);
      }
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(ring.empty + 8 * s);
      if (sees) {
        // p^T and ds^T, masked; a tile's (lse2, delta) pairs sit beside the plane ring
        const float4* lr = reinterpret_cast<const float4*>(ring.rows(i));
        const bool edge = q0 + BT > S || r0 + 64 > S || (causal && q0 < r0 + 63);
#pragma unroll
        for (int j = 0; j < BT / 8; ++j) {
          const float4 w = lr[4 * j + (lane & 3)];  // q columns 8 j + col_t and + 1
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float l2 = e & 1 ? w.z : w.x, dl = e & 1 ? w.w : w.y;
            float p = ex2(sT[4 * j + e] * scale_log2 - l2);
            if (edge) {
              const int kv = row_a + (e >> 1) * 8, qr = q0 + 8 * j + col_t + (e & 1);
              if (qr >= S || kv >= S || (causal && kv > qr)) p = 0.f;
            }
            sT[4 * j + e] = p;
            dpT[4 * j + e] = p * (dpT[4 * j + e] - dl);
          }
        }

        // dv += p^T dO and dk += ds^T q
        wg::mbar_wait(ring.full_t + 8 * s, ph);
        accumulate_f32<T, DV>(dv_acc, sT, plane_t + st + (T::TB_HI >> 4),
                               plane_t + st + (T::TB_LO >> 4));
        accumulate_f32<T, DQK>(dk_acc, dpT, plane_t + st + (T::TA_HI >> 4),
                                plane_t + st + (T::TA_LO >> 4));
      } else {
        wg::mbar_wait(ring.full_t + 8 * s, ph);
      }
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(ring.empty_t + 8 * s);
    }
    store_rows_f32<DQK>(dk + (size_t)bh * S * DQK, dk_acc, scale, row_a, S, lane);
    store_rows_f32<DV>(dv + (size_t)bh * S * DV, dv_acc, 1.f, row_a, S, lane);
  }
}

// dq in float32: a block owns BR q rows, each consumer warpgroup 64 of
// them, and walks the kv tiles they see; blocks take q rows in reverse
// order.  Per tile: s = q k^T and dp = dO v^T (SS, 3xTF32), ds in
// registers, dq += ds k (RS, 3xTF32 against k's transposed planes).
template <int DQK, int DV>
__global__ void __launch_bounds__(F32Tiles<DQK, DV, false>::THREADS, 1)
    bwd_dq_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo, const float2* __restrict__ rows,
                       float* __restrict__ dq, int S, int S_pad, int causal, float scale,
                       float scale_log2) {
  using T = F32Tiles<DQK, DV, false>;
  using PA = typename T::A;
  using PB = typename T::B;
  constexpr int BT = T::BT, BR = T::BR;
  extern __shared__ __align__(1024) unsigned char f32_smem[];
  const F32Ring<T> ring(f32_smem);
  const int bh = blockIdx.y;
  const int q0 = ((S + BR - 1) / BR - 1 - (int)blockIdx.x) * BR;
  const int kv_end = causal ? min(S, q0 + BR) : S;
  const int n = (kv_end + BT - 1) / BT;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int wgi = threadIdx.x / WG_THREADS;
  if (wgi == 0) {
    if constexpr (T::C > 1) wg::regs_dec<tf32::PRODUCER_REGS>();
    f32_producer<T>(ring, &tq, &tdo, &tk, &tv, rows, q0, 0, n, bh, S_pad);
  } else {
    if constexpr (T::C > 1) wg::regs_inc<tf32::CONSUMER_REGS>();
    const int c = __shfl_sync(0xffffffffu, wgi, 0) - 1;  // warp-uniform, as in dkdv
    const uint32_t base = __shfl_sync(0xffffffffu, ring.base, 0);
    const int t = threadIdx.x % WG_THREADS, lane = t & 31;
    const int r0 = q0 + 64 * c;
    const int row_a = r0 + (t >> 5) * 16 + (lane >> 2);  // a thread's q rows: row_a, row_a + 8
    const int col_t = 2 * (lane & 3);
    float2 lr[2];  // (lse2, delta) of the thread's rows; S_pad covers the block
#pragma unroll
    for (int r = 0; r < 2; ++r) lr[r] = rows[(size_t)bh * S_pad + row_a + 8 * r];
    float dq_acc[DQK / 2];
#pragma unroll
    for (int i = 0; i < DQK / 2; ++i) dq_acc[i] = 0.f;
    const uint64_t q_hi = wg::rows_desc<PA::RB>(base) + (64 * c * PA::RB >> 4);
    const uint64_t q_lo = q_hi + (T::OWN_A >> 4);
    const uint64_t do_hi = wg::rows_desc<PB::RB>(base + 2 * T::OWN_A) + (64 * c * PB::RB >> 4);
    const uint64_t do_lo = do_hi + (T::OWN_B >> 4);
    const uint64_t plane_a = wg::rows_desc<PA::RB>(base + T::PLANE0);
    const uint64_t plane_b = wg::rows_desc<PB::RB>(base + T::PLANE0);
    const uint64_t plane_t = wg::rows_desc<T::RBT>(base + T::PLANE0);
    wg::mbar_wait(ring.own, 0);
    // the owned rows' hi terms as A fragments in registers
    constexpr bool AREG = DQK <= 64 && DV <= 64;
    uint32_t qa[AREG ? DQK / 8 : 1][4], ga[AREG ? DV / 8 : 1][4];
    if constexpr (AREG) {
      load_a_tf32<PA, BR>(qa, ring.ptr, 64 * c, t >> 5, lane);
      load_a_tf32<PB, BR>(ga, ring.ptr + 2 * T::OWN_A, 64 * c, t >> 5, lane);
    }

    for (int i = 0; i < n; ++i) {
      const int s = i % T::STAGES, ph = (i / T::STAGES) & 1, k0 = i * BT;
      const uint64_t st = (uint64_t)(s * T::PLANES) >> 4;
      const bool sees = !causal || k0 <= r0 + 63;  // else every kv row follows these q rows
      float sc[BT / 2], dp[BT / 2];
      wg::mbar_wait(ring.full + 8 * s, ph);
      if (sees) {
        wg::fence();
        if constexpr (AREG) {
          scores_tf32_rs<PA, BR, BT>(sc, qa, q_lo, plane_a + st, plane_a + st + (T::A_LO >> 4));
          scores_tf32_rs<PB, BR, BT>(dp, ga, do_lo, plane_b + st + (T::B_HI >> 4),
                                     plane_b + st + (T::B_LO >> 4));
        } else {
          scores_tf32<PA, BR, BT>(sc, q_hi, q_lo, plane_a + st, plane_a + st + (T::A_LO >> 4));
          scores_tf32<PB, BR, BT>(dp, do_hi, do_lo, plane_b + st + (T::B_HI >> 4),
                                  plane_b + st + (T::B_LO >> 4));
        }
        wg::commit();
        wg::wait<0>();
        wg::fence_operand(sc);
        wg::fence_operand(dp);
        if constexpr (AREG) {
          wg::fence_operand(qa);
          wg::fence_operand(ga);
        }
      }
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(ring.empty + 8 * s);
      if (sees) {
        const bool edge = k0 + BT > S || r0 + 64 > S || (causal && k0 + BT - 1 > r0);
#pragma unroll
        for (int j = 0; j < BT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 w = lr[e >> 1];
            float p = ex2(sc[4 * j + e] * scale_log2 - w.x);
            if (edge) {
              const int row = row_a + (e >> 1) * 8, col = k0 + 8 * j + col_t + (e & 1);
              if (col >= S || row >= S || (causal && col > row)) p = 0.f;
            }
            sc[4 * j + e] = p * (dp[4 * j + e] - w.y);
          }

        // dq += ds k
        wg::mbar_wait(ring.full_t + 8 * s, ph);
        accumulate_f32<T, DQK>(dq_acc, sc, plane_t + st + (T::TA_HI >> 4),
                                plane_t + st + (T::TA_LO >> 4));
      } else {
        wg::mbar_wait(ring.full_t + 8 * s, ph);
      }
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(ring.empty_t + 8 * s);
    }
    store_rows_f32<DQK>(dq + (size_t)bh * S * DQK, dq_acc, scale, row_a, S, lane);
  }
}

// ------------------------------------------------------------- launchers

struct Args {
  const void *q, *k, *v, *o, *dO;
  const float* lse;
  float* scratch;
  void *dq, *dk, *dv;
  int BH, S, causal;
  float scale;
  cudaStream_t stream;
};

// q, k (panels PA) and v, dO's (panels PB) maps
template <typename PA, typename PB, int BOX>
bool tensor_maps(CUtensorMap (&m)[4], const Args& a, CUtensorMapDataType type) {
  return tensor_map<PA, BOX>(&m[0], a.q, a.BH, a.S, type) &&
         tensor_map<PA, BOX>(&m[1], a.k, a.BH, a.S, type) &&
         tensor_map<PB, BOX>(&m[2], a.v, a.BH, a.S, type) &&
         tensor_map<PB, BOX>(&m[3], a.dO, a.BH, a.S, type);
}

template <int DQK, int DV>
cudaError_t launch_bf16(const Args& a) {
  using T = Tiles<DQK, DV>;
  const int nb = (a.S + BR - 1) / BR, S_pad = nb * BR;
  float2* rows = reinterpret_cast<float2*>(a.scratch);
  rows_kernel<bf16, DV><<<dim3(S_pad / 8, a.BH), 256, 0, a.stream>>>(
      static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dO), a.lse, rows, a.S, S_pad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  CUtensorMap m[4];
  if (!tensor_maps<typename T::A, typename T::B, T::BT>(m, a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16))
    return cudaErrorInvalidValue;
  const CUtensorMap &tq = m[0], &tk = m[1], &tv = m[2], &tdo = m[3];
  static bool kv_set = false, q_set = false;
  if ((e = allow_smem(bwd_dkdv_wgmma_kernel<DQK, DV>, T::BYTES, kv_set)) != cudaSuccess) return e;
  if ((e = allow_smem(bwd_dq_wgmma_kernel<DQK, DV>, T::BYTES, q_set)) != cudaSuccess) return e;
  const dim3 grid(nb, a.BH);
  const float sl2 = a.scale * LOG2E;
  bwd_dkdv_wgmma_kernel<DQK, DV><<<grid, BLOCK_THREADS, T::BYTES, a.stream>>>(
      tq, tk, tv, tdo, rows, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.S, S_pad,
      a.causal, a.scale, sl2);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  bwd_dq_wgmma_kernel<DQK, DV><<<grid, BLOCK_THREADS, T::BYTES, a.stream>>>(
      tq, tk, tv, tdo, rows, static_cast<bf16*>(a.dq), a.S, S_pad, a.causal, a.scale, sl2);
  return cudaGetLastError();
}

template <int DQK, int DV>
cudaError_t launch_f32(const Args& a) {
  using TK = F32Tiles<DQK, DV, true>;
  using TQ = F32Tiles<DQK, DV, false>;
  const int S_pad = (a.S + BR - 1) / BR * BR;  // as the bf16 path's scratch
  float2* rows = reinterpret_cast<float2*>(a.scratch);
  rows_kernel<float, DV><<<dim3(S_pad / 8, a.BH), 256, 0, a.stream>>>(
      static_cast<const float*>(a.o), static_cast<const float*>(a.dO), a.lse, rows, a.S, S_pad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  CUtensorMap m[4];  // one box shape serves both kernels
  if (!tensor_maps<typename TK::A, typename TK::B, TK::BT>(m, a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return cudaErrorInvalidValue;
  static bool kv_set = false, q_set = false;
  if ((e = allow_smem(bwd_dkdv_tf32_kernel<DQK, DV>, TK::BYTES, kv_set)) != cudaSuccess) return e;
  if ((e = allow_smem(bwd_dq_tf32_kernel<DQK, DV>, TQ::BYTES, q_set)) != cudaSuccess) return e;
  const dim3 grid((a.S + TK::BR - 1) / TK::BR, a.BH);
  const float sl2 = a.scale * LOG2E;
  bwd_dkdv_tf32_kernel<DQK, DV><<<grid, TK::THREADS, TK::BYTES, a.stream>>>(
      m[0], m[1], m[2], m[3], rows, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.S,
      S_pad, a.causal, a.scale, sl2);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  bwd_dq_tf32_kernel<DQK, DV><<<grid, TQ::THREADS, TQ::BYTES, a.stream>>>(
      m[0], m[1], m[2], m[3], rows, static_cast<float*>(a.dq), a.S, S_pad, a.causal, a.scale,
      sl2);
  return cudaGetLastError();
}

template <int DQK, int DV>
cudaError_t launch(const Args& a, int dtype) {
  if (dtype == 0) return launch_f32<DQK, DV>(a);
  if (dtype == 1) return launch_bf16<DQK, DV>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, dq, dk (BH, S, D) and v, o, dO, dv (BH, S, Dv) row-major on the
// device, all of one dtype: 0 = float32, 1 = bfloat16, 16-byte aligned.
// lse (BH, S) float32 from K3's forward (natural log of the scaled scores'
// row sums).  scratch: float32 (BH, S_pad, 2), (lse log2 e, delta) per row
// with S_pad = S rounded up to 128, 16-byte aligned.  (D, Dv): (16, 16),
// (32, 32), (64, 64), (128, 128) or MLA's (192, 128).  causal: 0 or 1.
// Returns a cudaError_t.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dO, const void* lse,
                                         void* scratch, void* dq, void* dk, void* dv, int BH,
                                         int S, int D, int Dv, int dtype, int causal, float scale,
                                         void* stream) {
  if (BH <= 0 || BH > 65535 || S <= 0 || (causal != 0 && causal != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, dO, static_cast<const float*>(lse), static_cast<float*>(scratch),
               dq, dk, dv, BH, S, causal, scale, reinterpret_cast<cudaStream_t>(stream)};
  if (D == 192 && Dv == 128) return (int)launch<192, 128>(a, dtype);
  if (D != Dv) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return (int)launch<16, 16>(a, dtype);
    case 32: return (int)launch<32, 32>(a, dtype);
    case 64: return (int)launch<64, 64>(a, dtype);
    case 128: return (int)launch<128, 128>(a, dtype);
    default: return (int)cudaErrorInvalidValue;
  }
}
