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
// forward's size (s, dp, dv, dk, dq).  This design does 10: both passes
// rebuild s and dp, and p and ds enter dv, dk and dq as two bf16 terms each.
// On the H100 the bf16 path issues its wgmmas at ~40% of the tensor cores'
// peak, ~5x its bound (PERF.md): each consumer warpgroup runs its tile's
// scores, softmax and products in series, and only the other warpgroup
// overlaps it.
//
// Three launches, no atomics, so a run gives the same bits every time:
//  * a rows pass: per row delta = rowsum(dO o) in float32 (and, for bf16,
//    lse log2 e beside it), one warp a row;
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
// float32 (bwd_dkdv_simt_kernel, bwd_dq_simt_kernel): plain float32 FMAs,
// 256 threads; the block's tiles in shared memory with rows padded to an
// odd stride, scores 64 x 32 at a time.  Slow and simple.
//
// Interface: a plain C function for ctypes.  It launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"
#include "wgmma.cuh"

namespace {

using namespace mma;
using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

// ------------------------------------------------------------------ delta

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// delta[r] = sum_d dO[r, d] o[r, d] in float32, one warp a row
template <typename T>
__global__ void __launch_bounds__(256)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dO, float* __restrict__ delta,
                 int rows, int D) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t base = (size_t)row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(to_f32(o[base + d]), to_f32(dO[base + d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

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
// row, delta summed as delta_kernel sums it
template <int D>
__global__ void __launch_bounds__(256)
    rows_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dO,
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

constexpr int SIMT_THREADS = 256;
constexpr int SR = 64;  // rows a block owns
constexpr int SC = 32;  // rows of a walked tile
constexpr int LDP = SC + 1;

template <int D>
struct SimtTile {
  static constexpr int LD = D + 1;  // odd stride: a warp's 32 rows hit 32 banks
  // word offsets: owned rows (a, b), walked rows (c, d), then the scratch
  static constexpr int A = 0;
  static constexpr int B = A + SR * LD;
  static constexpr int C = B + SR * LD;
  static constexpr int DD = C + SC * LD;
  static constexpr int P = DD + SC * LD;  // (SR, LDP): p (dkdv) or ds (dq)
  static constexpr int DS = P + SR * LDP;  // (SR, LDP): ds (dkdv)
  static constexpr int LSE = DS + SR * LDP;
  static constexpr int DELTA = LSE + SR;
  static constexpr int WORDS = DELTA + SR;
};

// rows [row0, row0 + ROWS) of a (S, D) float32 matrix into a padded tile
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int S,
                                          int tid) {
  constexpr int LD = SimtTile<D>::LD;
  for (int i = tid; i < ROWS * D; i += SIMT_THREADS) {
    const int r = i / D, c = i % D;
    dst[r * LD + c] = row0 + r < S ? src[(size_t)(row0 + r) * D + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(SIMT_THREADS)
    bwd_dkdv_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dO,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int S, int causal,
                         float scale, float scale_log2) {
  using T = SimtTile<D>;
  constexpr int LD = T::LD;
  constexpr int NJ = D / 4;  // output columns a thread owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const float* K = sm + T::A;
  const float* V = sm + T::B;
  const float* Q = sm + T::C;
  const float* G = sm + T::DD;  // dO
  float* P = sm + T::P;
  float* DS = sm + T::DS;
  float* L = sm + T::LSE;
  float* DL = sm + T::DELTA;

  const int tid = threadIdx.x;
  const int kv0 = blockIdx.x * SR;
  const size_t base = (size_t)blockIdx.y * (size_t)S * D;
  const size_t rbase = (size_t)blockIdx.y * S;
  load_rows<D, SR>(sm + T::A, k + base, kv0, S, tid);
  load_rows<D, SR>(sm + T::B, v + base, kv0, S, tid);

  const int rr = tid >> 2, cj = tid & 3;  // the accumulation's row and column phase
  const int qc = tid & 31, kw = tid >> 5;  // the scores' q column and first kv row
  float dk_acc[NJ], dv_acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  for (int q0 = causal ? kv0 : 0; q0 < S; q0 += SC) {
    __syncthreads();  // the previous tile is no longer read
    load_rows<D, SC>(sm + T::C, q + base, q0, S, tid);
    load_rows<D, SC>(sm + T::DD, dO + base, q0, S, tid);
    if (tid < SC) {
      L[tid] = q0 + tid < S ? lse[rbase + q0 + tid] * LOG2E : 0.f;
      DL[tid] = q0 + tid < S ? delta[rbase + q0 + tid] : 0.f;
    }
    __syncthreads();

    // scores of q column qc against kv rows kw, kw + 8, ..., kw + 56
    float s[SR / 8], dp[SR / 8];
#pragma unroll
    for (int i = 0; i < SR / 8; ++i) s[i] = dp[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = Q[qc * LD + d], gd = G[qc * LD + d];
#pragma unroll
      for (int i = 0; i < SR / 8; ++i) {
        s[i] = fmaf(K[(kw + 8 * i) * LD + d], qd, s[i]);
        dp[i] = fmaf(V[(kw + 8 * i) * LD + d], gd, dp[i]);
      }
    }
    const int qr = q0 + qc;
#pragma unroll
    for (int i = 0; i < SR / 8; ++i) {
      const int kr = kw + 8 * i, kv = kv0 + kr;
      const bool in = qr < S && kv < S && (!causal || kv <= qr);
      const float p = in ? exp2f(s[i] * scale_log2 - L[qc]) : 0.f;
      P[kr * LDP + qc] = p;
      DS[kr * LDP + qc] = p * (dp[i] - DL[qc]);
    }
    __syncthreads();

    // dv[rr] += sum_q p[rr, q] dO[q], dk[rr] += sum_q ds[rr, q] q[q]
    for (int c = 0; c < SC; ++c) {
      const float p = P[rr * LDP + c], ds = DS[rr * LDP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        dv_acc[j] = fmaf(p, G[c * LD + cj + 4 * j], dv_acc[j]);
        dk_acc[j] = fmaf(ds, Q[c * LD + cj + 4 * j], dk_acc[j]);
      }
    }
  }
  if (kv0 + rr < S) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[base + (size_t)(kv0 + rr) * D + cj + 4 * j] = dk_acc[j] * scale;
      dv[base + (size_t)(kv0 + rr) * D + cj + 4 * j] = dv_acc[j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(SIMT_THREADS)
    bwd_dq_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dO,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dq, int S, int causal, float scale,
                       float scale_log2) {
  using T = SimtTile<D>;
  constexpr int LD = T::LD;
  constexpr int NJ = D / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const float* Q = sm + T::A;
  const float* G = sm + T::B;  // dO
  const float* K = sm + T::C;
  const float* V = sm + T::DD;
  float* DS = sm + T::P;
  float* L = sm + T::LSE;
  float* DL = sm + T::DELTA;

  const int tid = threadIdx.x;
  const int nq = (S + SR - 1) / SR;
  const int q0 = (nq - 1 - (int)blockIdx.x) * SR;
  const size_t base = (size_t)blockIdx.y * (size_t)S * D;
  const size_t rbase = (size_t)blockIdx.y * S;
  load_rows<D, SR>(sm + T::A, q + base, q0, S, tid);
  load_rows<D, SR>(sm + T::B, dO + base, q0, S, tid);
  if (tid < SR) {
    L[tid] = q0 + tid < S ? lse[rbase + q0 + tid] * LOG2E : 0.f;
    DL[tid] = q0 + tid < S ? delta[rbase + q0 + tid] : 0.f;
  }

  const int rr = tid >> 2, cj = tid & 3;
  const int kc = tid & 31, qw = tid >> 5;  // the scores' kv column and first q row
  float dq_acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) dq_acc[j] = 0.f;
  const int kv_end = causal ? min(S, q0 + SR) : S;

  for (int k0 = 0; k0 < kv_end; k0 += SC) {
    __syncthreads();
    load_rows<D, SC>(sm + T::C, k + base, k0, S, tid);
    load_rows<D, SC>(sm + T::DD, v + base, k0, S, tid);
    __syncthreads();

    float s[SR / 8], dp[SR / 8];
#pragma unroll
    for (int i = 0; i < SR / 8; ++i) s[i] = dp[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = K[kc * LD + d], vd = V[kc * LD + d];
#pragma unroll
      for (int i = 0; i < SR / 8; ++i) {
        s[i] = fmaf(Q[(qw + 8 * i) * LD + d], kd, s[i]);
        dp[i] = fmaf(G[(qw + 8 * i) * LD + d], vd, dp[i]);
      }
    }
    const int kv = k0 + kc;
#pragma unroll
    for (int i = 0; i < SR / 8; ++i) {
      const int qrow = qw + 8 * i, qr = q0 + qrow;
      const bool in = qr < S && kv < S && (!causal || kv <= qr);
      const float p = in ? exp2f(s[i] * scale_log2 - L[qrow]) : 0.f;
      DS[qrow * LDP + kc] = p * (dp[i] - DL[qrow]);
    }
    __syncthreads();

    // dq[rr] += sum_kv ds[rr, kv] k[kv]
    for (int c = 0; c < SC; ++c) {
      const float ds = DS[rr * LDP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) dq_acc[j] = fmaf(ds, K[c * LD + cj + 4 * j], dq_acc[j]);
    }
  }
  if (q0 + rr < S) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[base + (size_t)(q0 + rr) * D + cj + 4 * j] = dq_acc[j] * scale;
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

template <typename T>
cudaError_t launch_delta(const Args& a, int D) {
  const int rows = a.BH * a.S;
  delta_kernel<T><<<(rows + 7) / 8, 256, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dO), a.scratch, rows, D);
  return cudaGetLastError();
}

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

// a 3-D map over (BH, S, D) bf16 with boxes of BT rows and CW columns,
// swizzled as wide as a box row; rows at or past S zero-fill inside a
// batch-head, and never reach the next one's rows
template <int D>
bool tensor_map(CUtensorMap* map, const void* ptr, int BH, int S) {
  using T = Tiles<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)T::CW, (cuuint32_t)T::BT, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = T::RB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : T::RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_bf16(const Args& a) {
  using T = Tiles<D>;
  const int nb = (a.S + BR - 1) / BR, S_pad = nb * BR;
  float2* rows = reinterpret_cast<float2*>(a.scratch);
  rows_kernel<D><<<dim3(S_pad / 8, a.BH), 256, 0, a.stream>>>(
      static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dO), a.lse, rows, a.S, S_pad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  CUtensorMap tq, tk, tv, tdo;
  if (!(tensor_map<D>(&tq, a.q, a.BH, a.S) && tensor_map<D>(&tk, a.k, a.BH, a.S) &&
        tensor_map<D>(&tv, a.v, a.BH, a.S) && tensor_map<D>(&tdo, a.dO, a.BH, a.S)))
    return cudaErrorInvalidValue;
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
  cudaError_t e = launch_delta<float>(a, D);
  if (e != cudaSuccess) return e;
  const int smem = (int)(SimtTile<D>::WORDS * sizeof(float));
  static bool kv_set = false, q_set = false;
  if ((e = allow_smem(bwd_dkdv_simt_kernel<D>, smem, kv_set)) != cudaSuccess) return e;
  if ((e = allow_smem(bwd_dq_simt_kernel<D>, smem, q_set)) != cudaSuccess) return e;
  const dim3 grid((a.S + SR - 1) / SR, a.BH);
  const float sl2 = a.scale * LOG2E;
  const float *q = static_cast<const float*>(a.q), *k = static_cast<const float*>(a.k),
              *v = static_cast<const float*>(a.v), *dO = static_cast<const float*>(a.dO);
  bwd_dkdv_simt_kernel<D><<<grid, SIMT_THREADS, smem, a.stream>>>(
      q, k, v, dO, a.lse, a.scratch, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.S,
      a.causal, a.scale, sl2);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  bwd_dq_simt_kernel<D><<<grid, SIMT_THREADS, smem, a.stream>>>(
      q, k, v, dO, a.lse, a.scratch, static_cast<float*>(a.dq), a.S, a.causal, a.scale, sl2);
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
// float32, (BH, S) for float32 inputs (delta), (BH, S_pad, 2) for bfloat16
// ((lse log2 e, delta) per row, S_pad = S rounded up to 128), 16-byte
// aligned.  D: 16, 32, 64 or 128.  causal: 0 or 1.  Returns a cudaError_t.
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
