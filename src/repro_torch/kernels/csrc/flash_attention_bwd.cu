// K3-bwd: the gradient of K3 (flash_attention.cu) for Hopper (sm_90a).
//
// Replaces what the JAX package gets from autodiff of
// src/repro/models/layers.py::chunked_attention (the TPU kernel K3 has no
// backward of its own).  For q, k, v, o, dO of shape (BH, S, D), row-major,
// float32 or bfloat16, and lse (BH, S) float32 from K3's forward (each
// row's log-sum-exp of the scaled scores, natural log), it writes dq, dk,
// dv in the input dtype:
//   p_ij  = exp(scale q_i . k_j - lse_i), 0 where masked (j > i when
//           causal, and every row or column at or past S)
//   dp_ij = dO_i . v_j,   delta_i = dO_i . o_i,   ds_ij = p_ij (dp_ij - delta_i)
//   dv_j = sum_i p_ij dO_i,  dk_j = scale sum_i ds_ij q_i,  dq_i = scale sum_j ds_ij k_j
// with every product and sum to float32 grade.
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
//    then streams the walked tiles (64 rows; 32 at D = 128, for registers)
//    through a 4-stage ring under full / empty mbarriers: 3-D tensor maps
//    over (BH, S, D), so rows past S zero-fill inside a head.  The dkdv
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
//  * Left for later: one pass for dk, dv and dq (8 products instead of 10),
//    and overlapping a tile's softmax with the next tile's MMAs inside a
//    warpgroup (registers are the limit at D = 64).
//
// float32 (bwd_dkdv_tf32_kernel, bwd_dq_tf32_kernel): the same walk on
// tf32 warpgroup MMAs, every product a 3xTF32 split (csrc/tf32.cuh: a =
// hi + lo, hi = tf32(a), lo = tf32(a - hi); lo.hi + hi.lo + hi.hi, small
// terms first, lo.lo dropped).  A single TF32 product keeps 10 mantissa
// bits, 30-150x over the float32 limit (flash_attention.cu).
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
#include "tf32.cuh"
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

// a matrix of D columns as panels of one swizzle row each
template <int D>
struct Panels {
  static constexpr int CW = D < 64 ? D : 64;  // columns of a panel
  static constexpr int NP = D / CW;           // panels
  static constexpr int RB = 2 * CW;           // bytes of a panel row
};

// a block's tiles: owned BR rows, walked tiles of BT rows
template <int D>
struct Tiles : Panels<D> {
  static constexpr int BT = D == 128 ? 32 : 64;  // rows of a walked tile (D = 128: registers)
  static constexpr int STAGES = 4;               // depth of the ring
  static constexpr int OWN = BR * D * 2;         // bytes of one owned matrix
  static constexpr int TILE = BT * D * 2;        // bytes of one walked matrix
  static constexpr int ROWS = BT * 8;            // bytes of a walked tile's (lse2, delta) pairs
  // byte offsets from the 1024-aligned base: the owned pair, the ring of
  // walked pairs, the ring's (lse2, delta), then the barriers
  static constexpr int STAGE0 = 2 * OWN;
  static constexpr int ROWS0 = STAGE0 + STAGES * 2 * TILE;
  static constexpr int BARS = ROWS0 + STAGES * ROWS;
  static constexpr int BYTES = BARS + (2 * STAGES + 1) * 8 + 1024;  // + the alignment slack
};

// the rows pass: per (batch-head, row) the pair (lse * log2 e, delta =
// rowsum(dO o) in float32) in a (BH, S_pad) array, zero past S; one warp a
// row
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

// a 64 x KR float32 tile in the accumulator layout -> bf16 hi and lo A
// fragments, one per 16 columns
template <int KR>
__device__ __forceinline__ void split_frags(const float (&x)[KR / 2], uint32_t (&hi)[KR / 16][4],
                                            uint32_t (&lo)[KR / 16][4]) {
#pragma unroll
  for (int c = 0; c < KR / 16; ++c)
#pragma unroll
    for (int f = 0; f < 4; ++f)
      split_bf16(x[8 * c + 2 * f], x[8 * c + 2 * f + 1], hi[c][f], lo[c][f]);
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
  __device__ __forceinline__ uint32_t stage(int s) const {
    return base + T::STAGE0 + s * 2 * T::TILE;
  }
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < T::STAGES; ++s) {
      wg::mbar_init(full + 8 * s, 1);
      wg::mbar_init(empty + 8 * s, 4 * CONSUMERS);
    }
    wg::mbar_init(own, 1);
    wg::mbar_fence_init();
  }
};

// the producer's loads of one matrix's rows [row0, row0 + rows) at batch-head
// bh into a tile of `rows` rows at dst, one box of BT rows and CW columns
// at a time
template <typename T>
__device__ __forceinline__ void load_rows_tma(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int row0, int rows, int bh) {
  for (int p = 0; p < T::NP; ++p)
    for (int r = 0; r < rows; r += T::BT)
      wg::tma_load_3d(dst + (p * rows + r) * T::RB, map, bar, p * T::CW, row0 + r, bh);
}

// dk, dv: a block owns BR kv rows of one batch-head, each consumer
// warpgroup 64 of them, and walks the q tiles that see them (causal: from
// the block's diagonal on).  Per tile: s^T = k q^T and dp^T = v dO^T (SS),
// p^T and ds^T in registers, dv += p^T dO and dk += ds^T q (RS, hi + lo).
template <int D>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
    bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo, const float2* __restrict__ rows,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int S_pad,
                          int causal, float scale, float scale_log2) {
  using T = Tiles<D>;
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
      wg::mbar_expect_tx(ring.own, 2 * T::OWN);
      load_rows_tma<T>(ring.base, &tk, ring.own, kv0, BR, bh);
      load_rows_tma<T>(ring.base + T::OWN, &tv, ring.own, kv0, BR, bh);
      for (int i = 0; i < n; ++i) {
        const int s = i % T::STAGES, q0 = (first + i) * BT;
        wg::mbar_wait(ring.empty + 8 * s, ((i / T::STAGES) & 1) ^ 1);
        const uint32_t full = ring.full + 8 * s, st = ring.stage(s);
        wg::mbar_expect_tx(full, 2 * T::TILE + T::ROWS);
        load_rows_tma<T>(st, &tq, full, q0, BT, bh);
        load_rows_tma<T>(st + T::TILE, &tdo, full, q0, BT, bh);
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
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    const uint64_t own_k = wg::tile_desc<D>(base) + (64 * c * T::RB >> 4);
    const uint64_t own_v = own_k + (T::OWN >> 4);
    const uint64_t stage0 = wg::tile_desc<D>(base + T::STAGE0);
    wg::mbar_wait(ring.own, 0);

    for (int i = 0; i < n; ++i) {
      const int s = i % T::STAGES, q0 = (first + i) * BT;
      wg::mbar_wait(ring.full + 8 * s, (i / T::STAGES) & 1);
      const uint64_t qt = stage0 + (s * 2 * T::TILE >> 4), dot = qt + (T::TILE >> 4);
      if (!causal || q0 + BT > r0) {  // else every q row of the tile precedes these kv rows
        float sT[BT / 2], dpT[BT / 2];
        wg::fence();
        scores<D, BT>(sT, own_k, qt);
        scores<D, BT>(dpT, own_v, dot);
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
        accumulate<D, BT>(dv_acc, hi, lo, dot);
        split_frags<BT>(dpT, hi, lo);
        accumulate<D, BT>(dk_acc, hi, lo, qt);
      }
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(ring.empty + 8 * s);
    }
    const size_t at = (size_t)bh * S * D;
    store_rows<D>(dk + at, dk_acc, scale, row_a, S, lane);
    store_rows<D>(dv + at, dv_acc, 1.f, row_a, S, lane);
  }
}

// dq: a block owns BR q rows, each consumer warpgroup 64 of them, and walks
// the kv tiles they see.  Blocks take q rows in reverse order, so the
// longest causal rows start first.  Per tile: s = q k^T and dp = dO v^T
// (SS), ds in registers, dq += ds k (RS, hi + lo).
template <int D>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
    bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo, const float2* __restrict__ rows,
                        bf16* __restrict__ dq, int S, int S_pad, int causal, float scale,
                        float scale_log2) {
  using T = Tiles<D>;
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
      wg::mbar_expect_tx(ring.own, 2 * T::OWN);
      load_rows_tma<T>(ring.base, &tq, ring.own, q0, BR, bh);
      load_rows_tma<T>(ring.base + T::OWN, &tdo, ring.own, q0, BR, bh);
      for (int i = 0; i < n; ++i) {
        const int s = i % T::STAGES;
        wg::mbar_wait(ring.empty + 8 * s, ((i / T::STAGES) & 1) ^ 1);
        const uint32_t full = ring.full + 8 * s, st = ring.stage(s);
        wg::mbar_expect_tx(full, 2 * T::TILE);
        load_rows_tma<T>(st, &tk, full, i * BT, BT, bh);
        load_rows_tma<T>(st + T::TILE, &tv, full, i * BT, BT, bh);
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
    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
    const uint64_t own_q = wg::tile_desc<D>(base) + (64 * c * T::RB >> 4);
    const uint64_t own_do = own_q + (T::OWN >> 4);
    const uint64_t stage0 = wg::tile_desc<D>(base + T::STAGE0);
    wg::mbar_wait(ring.own, 0);
    constexpr bool AREG = D <= 64;  // the owned rows' A fragments in registers
    uint32_t qa[AREG ? D / 16 : 1][4], ga[AREG ? D / 16 : 1][4];
    if constexpr (AREG) {
      load_a<D>(qa, ring.ptr, 64 * c, t >> 5, lane);
      load_a<D>(ga, ring.ptr + T::OWN, 64 * c, t >> 5, lane);
    }

    for (int i = 0; i < n; ++i) {
      const int s = i % T::STAGES, k0 = i * BT;
      wg::mbar_wait(ring.full + 8 * s, (i / T::STAGES) & 1);
      const uint64_t kt = stage0 + (s * 2 * T::TILE >> 4), vt = kt + (T::TILE >> 4);
      if (!causal || k0 <= r0 + 63) {  // else every kv row of the tile follows these q rows
        float sc[BT / 2], dp[BT / 2];
        wg::fence();
        if constexpr (AREG) {
          scores_rs<D, BT>(sc, qa, kt);
          scores_rs<D, BT>(dp, ga, vt);
        } else {
          scores<D, BT>(sc, own_q, kt);
          scores<D, BT>(dp, own_do, vt);
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
        accumulate<D, BT>(dq_acc, hi, lo, kt);
      }
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(ring.empty + 8 * s);
    }
    store_rows<D>(dq + (size_t)bh * S * D, dq_acc, scale, row_a, S, lane);
  }
}

// ---------------------------------------------------------------- float32

constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may take

// the float32 path's block (see the header); DKDV: the dk/dv kernel, else dq
template <int D_, bool DKDV>
struct F32Tiles {
  static constexpr int D = D_;
  static constexpr int CW = D < 32 ? D : 32;     // floats of a panel row
  static constexpr int NP = D / CW;              // panels
  static constexpr int RB = 4 * CW;              // bytes of a panel row (64 or 128)
  static constexpr int C = D == 128 ? 1 : 2;     // consumer warpgroups (shared memory)
  static constexpr int BR = 64 * C;              // rows a block owns
  static constexpr int THREADS = WG_THREADS * (1 + C);
  static constexpr int BT = D == 128 ? 16 : 32;  // rows of a walked tile
  static constexpr int KW = BT < 32 ? BT : 32;   // k positions of a transposed panel row
  static constexpr int RBT = 4 * KW;             // its bytes
  // the N of one accumulating wgmma; 32 at D = 128, where dk/dv's registers
  // spill: fewer spills than at 64, and 4% faster when measured
  static constexpr int NW = D < 64 ? D : D == 128 ? 32 : 64;
  static constexpr int OWN = BR * D * 4;         // bytes of one owned plane
  static constexpr int TILE = BT * D * 4;        // bytes of one walked plane
  static constexpr int ROWS = BT * 8;            // a walked tile's (lse2, delta) pairs
  static constexpr int PLANES = DKDV ? 8 : 6;    // walked planes a stage
  static constexpr int RAWS = 2;                 // raw stages (TMA's landing ring)
  // byte offsets from the 1024-aligned base: the owned planes (a hi, a lo,
  // b hi, b lo), the raw ring (a, b), the plane ring (a hi, a lo, b hi,
  // b lo, then the transposed a hi, a lo and, for dk/dv, b hi, b lo), the
  // raw ring's (lse2, delta) pairs and STAGES + 1 buffers of them beside
  // the plane ring, the barriers
  static constexpr int RAW0 = 4 * OWN;
  static constexpr int PLANE0 = RAW0 + RAWS * 2 * TILE;
  static constexpr int FIXED = PLANE0 + (RAWS + 1) * ROWS + 1024 + 128;
  static constexpr int STAGES = SMEM_LIMIT - FIXED >= 2 * (PLANES * TILE + ROWS) ? 2 : 1;
  static constexpr int ROWBUFS = STAGES + 1;
  static constexpr int ROWS0 = PLANE0 + STAGES * PLANES * TILE;
  static constexpr int BARS = ROWS0 + (RAWS + ROWBUFS) * ROWS;
  static constexpr int BYTES = BARS + (RAWS + 4 * STAGES + 2) * 8 + 1024;
  static_assert(BYTES <= SMEM_LIMIT, "the float32 block's shared memory");
};

// setmaxnreg with two consumers: 56 x 128 + 2 x 224 x 128 = 168 x 384
constexpr int F32_PRODUCER_REGS = 56, F32_CONSUMER_REGS = 224;

// the byte offset of logical offset w in rows of RB bytes under the TMA
// swizzle (an involution: it also maps a physical offset to its logical one)
template <int RB>
__device__ __forceinline__ int swz(int w) {
  constexpr int M = RB == 128 ? 7 : RB == 64 ? 3 : 1;
  return w ^ (((w >> 7) & M) << 4);
}

// a transposed plane's k position of walked row r: in each 8 rows, row 2t
// at t and row 2t + 1 at t + 4, so that an accumulator tile read as tf32 A
// fragments (columns 2t, 2t + 1 where the fragment holds t, t + 4) meets
// its rows of B
__device__ __forceinline__ int kpos(int r) {
  return (r & ~7) | ((r & 1) << 2) | ((r >> 1) & 3);
}

__device__ __forceinline__ float4 split4(float4 x, float4& lo) {
  uint32_t h[4], l[4];
  const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) tf32::split_tf32(__float_as_uint(xs[i]), h[i], l[i]);
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                   __uint_as_float(l[3]));
  return make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                     __uint_as_float(h[3]));
}

// the producer warpgroup's split of one walked matrix: the raw tile at src
// (BT rows, TMA's layout) into hi and lo planes of the same layout
// (STORED) or of its transpose (D rows of BT k positions in kpos order,
// panels of KW); thread t of 128.  A warp takes 32 rows of one 16-byte
// column chunk, so its reads and writes hit distinct banks.
template <typename T, bool STORED>
__device__ __forceinline__ void split_walked(const unsigned char* src, unsigned char* hi,
                                             unsigned char* lo, int t) {
  constexpr int CHUNKS = T::BT * T::D / 4;
  static_assert(CHUNKS % WG_THREADS == 0, "whole passes");
#pragma unroll
  for (int it = 0; it < CHUNKS / WG_THREADS; ++it) {
    const int e = t + it * WG_THREADS;
    const int r = e % T::BT, cc = e / T::BT;  // row, 4-column chunk
    const int off =
        (cc / (T::CW / 4)) * T::BT * T::RB + swz<T::RB>(r * T::RB + (cc % (T::CW / 4)) * 16);
    float4 l;
    const float4 h = split4(*reinterpret_cast<const float4*>(src + off), l);
    if constexpr (STORED) {
      *reinterpret_cast<float4*>(hi + off) = h;
      *reinterpret_cast<float4*>(lo + off) = l;
    } else {
      const int kp = kpos(r);
      const float hs[4] = {h.x, h.y, h.z, h.w}, ls[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = 4 * cc + i;
        const int o = (kp / T::KW) * T::D * T::RBT + swz<T::RBT>(n * T::RBT + (kp % T::KW) * 4);
        *reinterpret_cast<float*>(hi + o) = hs[i];
        *reinterpret_cast<float*>(lo + o) = ls[i];
      }
    }
  }
}

// s (64 x BT) = 64 owned rows . tile^T to float32 grade: lo.hi, hi.lo,
// hi.hi over every k-step, small terms first.  Descriptors: the owned hi
// and lo planes at the warpgroup's first row, the walked tile's hi and lo
// planes, all K-major.  Started with wgmma.fence, left uncommitted.
template <typename T>
__device__ __forceinline__ void scores_tf32(float (&s)[T::BT / 2], uint64_t a_hi, uint64_t a_lo,
                                            uint64_t b_hi, uint64_t b_lo) {
  constexpr int KS = T::D / 8, BR = T::BR, BT = T::BT, RB = T::RB;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wg::mma_ss_tf32<BT>(s, a_lo + wg::k_off<RB, BR>(kk), b_hi + wg::k_off<RB, BT>(kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wg::mma_ss_tf32<BT>(s, a_hi + wg::k_off<RB, BR>(kk), b_lo + wg::k_off<RB, BT>(kk), 1);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wg::mma_ss_tf32<BT>(s, a_hi + wg::k_off<RB, BR>(kk), b_hi + wg::k_off<RB, BT>(kk), 1);
}

// the same with the owned rows' hi terms as tf32 A fragments in registers
// (a_hi, from load_a_tf32): lo.hi reads the owned lo plane (SS), hi.lo and
// hi.hi only the walked tile (RS), a third of the shared-memory reads of
// scores_tf32's
template <typename T>
__device__ __forceinline__ void scores_tf32_rs(float (&s)[T::BT / 2],
                                               const uint32_t (&a_hi)[T::D / 8][4], uint64_t a_lo,
                                               uint64_t b_hi, uint64_t b_lo) {
  constexpr int KS = T::D / 8, BR = T::BR, BT = T::BT, RB = T::RB;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wg::mma_ss_tf32<BT>(s, a_lo + wg::k_off<RB, BR>(kk), b_hi + wg::k_off<RB, BT>(kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) wg::mma_rs_tf32<BT>(s, a_hi[kk], b_lo + wg::k_off<RB, BT>(kk));
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) wg::mma_rs_tf32<BT>(s, a_hi[kk], b_hi + wg::k_off<RB, BT>(kk));
}

// the tf32 A fragments of 64 rows from r0 of an owned plane (BR rows, TMA's
// layout, at generic address `plane`), this warp's 16 of them: for k-step
// kk, a[kk] = (row g, column t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
template <typename T>
__device__ __forceinline__ void load_a_tf32(uint32_t (&a)[T::D / 8][4], const unsigned char* plane,
                                            int r0, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < T::D / 8; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int row = r0 + 16 * warp + g + 8 * (f & 1), col = 8 * kk + t + 4 * (f >> 1);
      a[kk][f] = *reinterpret_cast<const uint32_t*>(
          plane + (col / T::CW) * T::BR * T::RB + swz<T::RB>(row * T::RB + (col % T::CW) * 4));
    }
}

// acc (64 x D) += x tile (64 x BT, the accumulator layout) . the walked
// tile (BT rows, D columns), read from its transposed hi and lo planes
// (descriptors bt_hi, bt_lo).  x is split into tf32 hi and lo A fragments
// (c0, c2, c1, c3 of each 8 columns: kpos's order); each NW-column
// product starts from zero and folds into acc with one rounded add.
template <typename T>
__device__ __forceinline__ void accumulate_tf32(float (&acc)[T::D / 2], const float (&x)[T::BT / 2],
                                                uint64_t bt_hi, uint64_t bt_lo) {
  constexpr int KS = T::BT / 8, NW = T::NW, KP = T::KW / 8;
  uint32_t hi[KS][4], lo[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int f = 0; f < 4; ++f)
      tf32::split_tf32(__float_as_uint(x[4 * j + (f == 1 ? 2 : f == 2 ? 1 : f)]), hi[j][f],
                       lo[j][f]);
#pragma unroll
  for (int nc = 0; nc < T::D / NW; ++nc) {
    float t[NW / 2];
    const auto at = [&](int c) -> uint64_t {
      return ((c / KP) * T::D * T::RBT + nc * NW * T::RBT + (c % KP) * 32) >> 4;
    };
    wg::fence();
#pragma unroll
    for (int c = 0; c < KS; ++c) wg::mma_rs_tf32<NW>(t, lo[c], bt_hi + at(c), c > 0);
#pragma unroll
    for (int c = 0; c < KS; ++c) wg::mma_rs_tf32<NW>(t, hi[c], bt_lo + at(c));
#pragma unroll
    for (int c = 0; c < KS; ++c) wg::mma_rs_tf32<NW>(t, hi[c], bt_hi + at(c));
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(t);
    wg::fence_operand(hi);
    wg::fence_operand(lo);
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[nc * NW / 2 + i] += t[i];
  }
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

// the float32 block's shared memory, 1024-aligned, and its barriers:
// raw[r] (TMA's arrival, one expect_tx); for each stage of the plane ring
// two full / empty pairs, one for the planes as stored (the scores read
// them) and one for the transposed planes (the products into dk, dv and
// dq read them): full (the producer's split, one arrival), empty (one
// arrival per consumer warp); own_raw (the owned pair's TMA), own (the
// owned pair split)
template <typename T>
struct F32Ring {
  uint32_t base, raw, full, empty, full_t, empty_t, own_raw, own;
  unsigned char* ptr;  // generic address of base
  __device__ __forceinline__ F32Ring(unsigned char* smem) {
    const uint32_t a = wg::smem_u32(smem);
    base = (a + 1023) & ~1023u;
    ptr = smem + (base - a);
    raw = base + T::BARS;
    full = raw + 8 * T::RAWS;
    empty = full + 8 * T::STAGES;
    full_t = empty + 8 * T::STAGES;
    empty_t = full_t + 8 * T::STAGES;
    own_raw = empty_t + 8 * T::STAGES;
    own = own_raw + 8;
  }
  // the (lse2, delta) pairs of walked tile i beside the plane ring
  __device__ __forceinline__ unsigned char* rows(int i) const {
    return ptr + T::ROWS0 + (T::RAWS + i % T::ROWBUFS) * T::ROWS;
  }
  __device__ __forceinline__ void init() const {
    for (int r = 0; r < T::RAWS; ++r) wg::mbar_init(raw + 8 * r, 1);
    for (int s = 0; s < T::STAGES; ++s) {
      wg::mbar_init(full + 8 * s, 1);
      wg::mbar_init(empty + 8 * s, 4 * T::C);
      wg::mbar_init(full_t + 8 * s, 1);
      wg::mbar_init(empty_t + 8 * s, 4 * T::C);
    }
    wg::mbar_init(own_raw, 1);
    wg::mbar_init(own, 1);
    wg::mbar_fence_init();
  }
};

// The producer warpgroup of both float32 kernels.  Its first thread loads
// the owned pair (a, b: k, v or q, dO) into the owned hi planes and keeps
// RAWS walked tiles in flight in the raw ring; the 128 threads split the
// owned pair in place (hi) and into the lo planes once, then each walked
// tile into a stage of the plane ring in two parts, each handed on under
// its own full / empty pair: the planes as stored with the tile's (lse2,
// delta) pairs, as soon as the consumers' scores are done with the
// previous tile's, then the transposed planes (a; b too for dk/dv), once
// their products are.  So the split overlaps the consumers' scores,
// softmax and products.  Walked tile i covers rows (first + i) * BT.
template <typename T>
__device__ __forceinline__ void f32_producer(const F32Ring<T>& ring, const CUtensorMap* ma,
                                             const CUtensorMap* mb, const CUtensorMap* wa,
                                             const CUtensorMap* wb, const float2* rows,
                                             int own0, int first, int n, int bh, int S_pad) {
  constexpr int BT = T::BT, TILE = T::TILE;
  const int t = threadIdx.x;
  const auto load_walked = [&](int i) {
    const int r = i % T::RAWS, w0 = (first + i) * BT;
    const uint32_t bar = ring.raw + 8 * r, dst = ring.base + T::RAW0 + r * 2 * TILE;
    wg::mbar_expect_tx(bar, 2 * TILE + (T::PLANES == 8 ? T::ROWS : 0));
    load_rows_tma<T>(dst, wa, bar, w0, BT, bh);
    load_rows_tma<T>(dst + TILE, wb, bar, w0, BT, bh);
    if constexpr (T::PLANES == 8)
      wg::bulk_load(ring.base + T::ROWS0 + r * T::ROWS, rows + (size_t)bh * S_pad + w0, T::ROWS,
                    bar);
  };
  if (t == 0) {
    wg::mbar_expect_tx(ring.own_raw, 2 * T::OWN);
    load_rows_tma<T>(ring.base, ma, ring.own_raw, own0, T::BR, bh);
    load_rows_tma<T>(ring.base + 2 * T::OWN, mb, ring.own_raw, own0, T::BR, bh);
    for (int i = 0; i < T::RAWS && i < n; ++i) load_walked(i);
  }
  unsigned char* const p = ring.ptr;
  wg::mbar_wait(ring.own_raw, 0);
  for (int m = 0; m < 2; ++m)  // the owned pair: hi in place, lo beside it
    for (int off = 16 * t; off < T::OWN; off += 16 * WG_THREADS) {
      float4* x = reinterpret_cast<float4*>(p + 2 * m * T::OWN + off);
      float4 l;
      *x = split4(*x, l);
      *reinterpret_cast<float4*>(p + (2 * m + 1) * T::OWN + off) = l;
    }
  wg::fence_proxy_async();
  wg::bar_sync<1, WG_THREADS>();
  if (t == 0) wg::mbar_arrive(ring.own);

  for (int i = 0; i < n; ++i) {
    const int r = i % T::RAWS, s = i % T::STAGES, ph = ((i / T::STAGES) & 1) ^ 1;
    const unsigned char* raw = p + T::RAW0 + r * 2 * TILE;
    unsigned char* pl = p + T::PLANE0 + s * T::PLANES * TILE;
    wg::mbar_wait(ring.raw + 8 * r, (i / T::RAWS) & 1);
    wg::mbar_wait(ring.empty + 8 * s, ph);
    split_walked<T, true>(raw, pl, pl + TILE, t);
    split_walked<T, true>(raw + TILE, pl + 2 * TILE, pl + 3 * TILE, t);
    if (T::PLANES == 8 && t < BT / 2)
      reinterpret_cast<float4*>(ring.rows(i))[t] =
          reinterpret_cast<const float4*>(p + T::ROWS0 + r * T::ROWS)[t];
    wg::fence_proxy_async();
    wg::bar_sync<1, WG_THREADS>();
    if (t == 0) wg::mbar_arrive(ring.full + 8 * s);
    wg::mbar_wait(ring.empty_t + 8 * s, ph);
    split_walked<T, false>(raw, pl + 4 * TILE, pl + 5 * TILE, t);
    if constexpr (T::PLANES == 8) split_walked<T, false>(raw + TILE, pl + 6 * TILE, pl + 7 * TILE, t);
    wg::fence_proxy_async();
    wg::bar_sync<1, WG_THREADS>();  // the raw stage is read, the planes written
    if (t == 0) {
      wg::mbar_arrive(ring.full_t + 8 * s);
      if (i + T::RAWS < n) load_walked(i + T::RAWS);
    }
  }
}

// dk, dv in float32: a block owns BR kv rows of one batch-head, each
// consumer warpgroup 64 of them, and walks the q tiles that see them
// (causal: from the block's diagonal on).  Per tile: s^T = k q^T and
// dp^T = v dO^T (SS, 3xTF32), p^T and ds^T in registers, dv += p^T dO and
// dk += ds^T q (RS, 3xTF32 against the transposed planes).
template <int D>
__global__ void __launch_bounds__(F32Tiles<D, true>::THREADS, 1)
    bwd_dkdv_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo, const float2* __restrict__ rows,
                         float* __restrict__ dk, float* __restrict__ dv, int S, int S_pad,
                         int causal, float scale, float scale_log2) {
  using T = F32Tiles<D, true>;
  constexpr int BT = T::BT, TILE = T::TILE;
  extern __shared__ __align__(1024) unsigned char f32_smem[];
  const F32Ring<T> ring(f32_smem);
  const int bh = blockIdx.y, kv0 = blockIdx.x * T::BR;
  const int first = causal ? kv0 / BT : 0;  // q tiles before it see none of these kv rows
  const int n = (S + BT - 1) / BT - first;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int wgi = threadIdx.x / WG_THREADS;
  if (wgi == 0) {
    if constexpr (T::C > 1) wg::regs_dec<F32_PRODUCER_REGS>();
    f32_producer<T>(ring, &tk, &tv, &tq, &tdo, rows, kv0, first, n, bh, S_pad);
  } else {
    if constexpr (T::C > 1) wg::regs_inc<F32_CONSUMER_REGS>();
    // warp-uniform (a shuffle shows the compiler), as in the bf16 kernels
    const int c = __shfl_sync(0xffffffffu, wgi, 0) - 1;
    const uint32_t base = __shfl_sync(0xffffffffu, ring.base, 0);
    const int t = threadIdx.x % WG_THREADS, lane = t & 31;
    const int r0 = kv0 + 64 * c;                         // this warpgroup's first kv row
    const int row_a = r0 + (t >> 5) * 16 + (lane >> 2);  // a thread's kv rows: row_a, row_a + 8
    const int col_t = 2 * (lane & 3);
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    const uint64_t k_hi = wg::rows_desc<T::RB>(base) + (64 * c * T::RB >> 4);
    const uint64_t k_lo = k_hi + (T::OWN >> 4), v_hi = k_hi + (2 * T::OWN >> 4),
                   v_lo = k_hi + (3 * T::OWN >> 4);
    const uint64_t plane0 = wg::rows_desc<T::RB>(base + T::PLANE0);
    const uint64_t plane0_t = wg::rows_desc<T::RBT>(base + T::PLANE0);
    wg::mbar_wait(ring.own, 0);

    for (int i = 0; i < n; ++i) {
      const int s = i % T::STAGES, ph = (i / T::STAGES) & 1, q0 = (first + i) * BT;
      const uint64_t st = (uint64_t)(s * T::PLANES * TILE) >> 4, pl = TILE >> 4;
      const bool sees = !causal || q0 + BT > r0;  // else every q row precedes these kv rows
      float sT[BT / 2], dpT[BT / 2];
      wg::mbar_wait(ring.full + 8 * s, ph);
      if (sees) {
        wg::fence();
        scores_tf32<T>(sT, k_hi, k_lo, plane0 + st, plane0 + st + pl);
        scores_tf32<T>(dpT, v_hi, v_lo, plane0 + st + 2 * pl, plane0 + st + 3 * pl);
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
        accumulate_tf32<T>(dv_acc, sT, plane0_t + st + 6 * pl, plane0_t + st + 7 * pl);
        accumulate_tf32<T>(dk_acc, dpT, plane0_t + st + 4 * pl, plane0_t + st + 5 * pl);
      } else {
        wg::mbar_wait(ring.full_t + 8 * s, ph);
      }
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(ring.empty_t + 8 * s);
    }
    const size_t at = (size_t)bh * S * D;
    store_rows_f32<D>(dk + at, dk_acc, scale, row_a, S, lane);
    store_rows_f32<D>(dv + at, dv_acc, 1.f, row_a, S, lane);
  }
}

// dq in float32: a block owns BR q rows, each consumer warpgroup 64 of
// them, and walks the kv tiles they see; blocks take q rows in reverse
// order.  Per tile: s = q k^T and dp = dO v^T (SS, 3xTF32), ds in
// registers, dq += ds k (RS, 3xTF32 against k's transposed planes).
template <int D>
__global__ void __launch_bounds__(F32Tiles<D, false>::THREADS, 1)
    bwd_dq_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo, const float2* __restrict__ rows,
                       float* __restrict__ dq, int S, int S_pad, int causal, float scale,
                       float scale_log2) {
  using T = F32Tiles<D, false>;
  constexpr int BT = T::BT, TILE = T::TILE;
  extern __shared__ __align__(1024) unsigned char f32_smem[];
  const F32Ring<T> ring(f32_smem);
  const int bh = blockIdx.y;
  const int q0 = ((S + T::BR - 1) / T::BR - 1 - (int)blockIdx.x) * T::BR;
  const int kv_end = causal ? min(S, q0 + T::BR) : S;
  const int n = (kv_end + BT - 1) / BT;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int wgi = threadIdx.x / WG_THREADS;
  if (wgi == 0) {
    if constexpr (T::C > 1) wg::regs_dec<F32_PRODUCER_REGS>();
    f32_producer<T>(ring, &tq, &tdo, &tk, &tv, rows, q0, 0, n, bh, S_pad);
  } else {
    if constexpr (T::C > 1) wg::regs_inc<F32_CONSUMER_REGS>();
    const int c = __shfl_sync(0xffffffffu, wgi, 0) - 1;  // warp-uniform, as in dkdv
    const uint32_t base = __shfl_sync(0xffffffffu, ring.base, 0);
    const int t = threadIdx.x % WG_THREADS, lane = t & 31;
    const int r0 = q0 + 64 * c;
    const int row_a = r0 + (t >> 5) * 16 + (lane >> 2);  // a thread's q rows: row_a, row_a + 8
    const int col_t = 2 * (lane & 3);
    float2 lr[2];  // (lse2, delta) of the thread's rows; S_pad covers the block
#pragma unroll
    for (int r = 0; r < 2; ++r) lr[r] = rows[(size_t)bh * S_pad + row_a + 8 * r];
    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
    const uint64_t q_hi = wg::rows_desc<T::RB>(base) + (64 * c * T::RB >> 4);
    const uint64_t q_lo = q_hi + (T::OWN >> 4), do_hi = q_hi + (2 * T::OWN >> 4),
                   do_lo = q_hi + (3 * T::OWN >> 4);
    const uint64_t plane0 = wg::rows_desc<T::RB>(base + T::PLANE0);
    const uint64_t plane0_t = wg::rows_desc<T::RBT>(base + T::PLANE0);
    wg::mbar_wait(ring.own, 0);
    constexpr bool AREG = D <= 64;  // the owned rows' hi terms as A fragments in registers
    uint32_t qa[AREG ? D / 8 : 1][4], ga[AREG ? D / 8 : 1][4];
    if constexpr (AREG) {
      load_a_tf32<T>(qa, ring.ptr, 64 * c, t >> 5, lane);
      load_a_tf32<T>(ga, ring.ptr + 2 * T::OWN, 64 * c, t >> 5, lane);
    }

    for (int i = 0; i < n; ++i) {
      const int s = i % T::STAGES, ph = (i / T::STAGES) & 1, k0 = i * BT;
      const uint64_t st = (uint64_t)(s * T::PLANES * TILE) >> 4, pl = TILE >> 4;
      const bool sees = !causal || k0 <= r0 + 63;  // else every kv row follows these q rows
      float sc[BT / 2], dp[BT / 2];
      wg::mbar_wait(ring.full + 8 * s, ph);
      if (sees) {
        wg::fence();
        if constexpr (AREG) {
          scores_tf32_rs<T>(sc, qa, q_lo, plane0 + st, plane0 + st + pl);
          scores_tf32_rs<T>(dp, ga, do_lo, plane0 + st + 2 * pl, plane0 + st + 3 * pl);
        } else {
          scores_tf32<T>(sc, q_hi, q_lo, plane0 + st, plane0 + st + pl);
          scores_tf32<T>(dp, do_hi, do_lo, plane0 + st + 2 * pl, plane0 + st + 3 * pl);
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
        accumulate_tf32<T>(dq_acc, sc, plane0_t + st + 4 * pl, plane0_t + st + 5 * pl);
      } else {
        wg::mbar_wait(ring.full_t + 8 * s, ph);
      }
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(ring.empty_t + 8 * s);
    }
    store_rows_f32<D>(dq + (size_t)bh * S * D, dq_acc, scale, row_a, S, lane);
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime so that the
// library links no libcuda; null where it is missing
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a 3-D map over (BH, S, D) elements of `type` with boxes of T::BT rows and
// T::CW columns, swizzled as wide as a box row (T::RB bytes); rows at or
// past S zero-fill inside a batch-head, and never reach the next one's rows
template <int D, typename T>
bool tensor_map(CUtensorMap* map, const void* ptr, int BH, int S, CUtensorMapDataType type) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  constexpr int ES = T::RB / T::CW;  // bytes of an element
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * ES, (cuuint64_t)S * D * ES};
  const cuuint32_t box[3] = {(cuuint32_t)T::CW, (cuuint32_t)T::BT, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = T::RB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : T::RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// q, k, v and dO's maps
template <int D, typename T>
bool tensor_maps(CUtensorMap (&m)[4], const Args& a, CUtensorMapDataType type) {
  const void* ptrs[4] = {a.q, a.k, a.v, a.dO};
  for (int i = 0; i < 4; ++i)
    if (!tensor_map<D, T>(&m[i], ptrs[i], a.BH, a.S, type)) return false;
  return true;
}

template <int D>
cudaError_t launch_bf16(const Args& a) {
  using T = Tiles<D>;
  const int nb = (a.S + BR - 1) / BR, S_pad = nb * BR;
  float2* rows = reinterpret_cast<float2*>(a.scratch);
  rows_kernel<bf16, D><<<dim3(S_pad / 8, a.BH), 256, 0, a.stream>>>(
      static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dO), a.lse, rows, a.S, S_pad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  CUtensorMap m[4];
  if (!tensor_maps<D, T>(m, a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16)) return cudaErrorInvalidValue;
  const CUtensorMap &tq = m[0], &tk = m[1], &tv = m[2], &tdo = m[3];
  static bool kv_set = false, q_set = false;
  if ((e = allow_smem(bwd_dkdv_wgmma_kernel<D>, T::BYTES, kv_set)) != cudaSuccess) return e;
  if ((e = allow_smem(bwd_dq_wgmma_kernel<D>, T::BYTES, q_set)) != cudaSuccess) return e;
  const dim3 grid(nb, a.BH);
  const float sl2 = a.scale * LOG2E;
  bwd_dkdv_wgmma_kernel<D><<<grid, BLOCK_THREADS, T::BYTES, a.stream>>>(
      tq, tk, tv, tdo, rows, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.S, S_pad,
      a.causal, a.scale, sl2);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  bwd_dq_wgmma_kernel<D><<<grid, BLOCK_THREADS, T::BYTES, a.stream>>>(
      tq, tk, tv, tdo, rows, static_cast<bf16*>(a.dq), a.S, S_pad, a.causal, a.scale, sl2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Args& a) {
  using TK = F32Tiles<D, true>;
  using TQ = F32Tiles<D, false>;
  const int S_pad = (a.S + BR - 1) / BR * BR;  // as the bf16 path's scratch
  float2* rows = reinterpret_cast<float2*>(a.scratch);
  rows_kernel<float, D><<<dim3(S_pad / 8, a.BH), 256, 0, a.stream>>>(
      static_cast<const float*>(a.o), static_cast<const float*>(a.dO), a.lse, rows, a.S, S_pad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  CUtensorMap m[4];  // one box shape serves both kernels
  if (!tensor_maps<D, TK>(m, a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32)) return cudaErrorInvalidValue;
  static bool kv_set = false, q_set = false;
  if ((e = allow_smem(bwd_dkdv_tf32_kernel<D>, TK::BYTES, kv_set)) != cudaSuccess) return e;
  if ((e = allow_smem(bwd_dq_tf32_kernel<D>, TQ::BYTES, q_set)) != cudaSuccess) return e;
  const dim3 grid((a.S + TK::BR - 1) / TK::BR, a.BH);
  const float sl2 = a.scale * LOG2E;
  bwd_dkdv_tf32_kernel<D><<<grid, TK::THREADS, TK::BYTES, a.stream>>>(
      m[0], m[1], m[2], m[3], rows, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.S,
      S_pad, a.causal, a.scale, sl2);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  bwd_dq_tf32_kernel<D><<<grid, TQ::THREADS, TQ::BYTES, a.stream>>>(
      m[0], m[1], m[2], m[3], rows, static_cast<float*>(a.dq), a.S, S_pad, a.causal, a.scale,
      sl2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Args& a, int dtype) {
  if (dtype == 0) return launch_f32<D>(a);
  if (dtype == 1) return launch_bf16<D>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o, dO, dq, dk, dv (BH, S, D) row-major on the device, all of one
// dtype: 0 = float32, 1 = bfloat16, 16-byte aligned.  lse (BH, S) float32
// from K3's forward (natural log of the scaled scores' row sums).  scratch:
// float32 (BH, S_pad, 2), (lse log2 e, delta) per row with S_pad = S
// rounded up to 128, 16-byte aligned.  D: 16, 32, 64 or 128.  causal: 0 or 1.  Returns a cudaError_t.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dO, const void* lse,
                                         void* scratch, void* dq, void* dk, void* dv, int BH,
                                         int S, int D, int dtype, int causal, float scale,
                                         void* stream) {
  if (BH <= 0 || BH > 65535 || S <= 0 || (causal != 0 && causal != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, dO, static_cast<const float*>(lse), static_cast<float*>(scratch),
               dq, dk, dv, BH, S, causal, scale, reinterpret_cast<cudaStream_t>(stream)};
  switch (D) {
    case 16: return (int)launch<16>(a, dtype);
    case 32: return (int)launch<32>(a, dtype);
    case 64: return (int)launch<64>(a, dtype);
    case 128: return (int)launch<128>(a, dtype);
    default: return (int)cudaErrorInvalidValue;
  }
}
