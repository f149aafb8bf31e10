// K3: attention forward with an online softmax for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py::_flash_fwd_kernel, the
// Pallas TPU kernel of the LM substrate's chunked attention.  For q, k, v of
// shape (BH, S, D), row-major, float32 or bfloat16, it writes
//   o[b, i] = sum_j softmax_j(scale * q[b, i] . k[b, j]) v[b, j]
// over j <= i (causal) or all j < S, in the input dtype.  The TPU kernel
// widens q and k to float32 before the dot, keeps p in float32 for p @ v and
// carries (m, l, acc) in float32; both instantiations here compute that
// function to float32 grade.
//
// What bounds it: operations.  A (64-row q tile, 64-row kv tile) pair does
// 4 * 64 * 64 * D flops against 2 * 64 * D loaded values, so the card's
// arithmetic rate is the limit: 989 TFLOP/s of dense bf16 on the tensor
// cores for bf16 inputs; for float32 inputs, 165 TFLOP/s of float32-grade
// products as a 3xTF32 split on the tensor cores (495 / 3).
//
// Both paths share a shape: a block owns one q tile of one (batch, head),
// each warp 16 q rows in the m16n8 accumulator layout (bf16: 4 warps, f32:
// 8); q . k^T and p @ v run as mma.sync on the tensor cores; p never
// leaves registers.  The tensor cores' f32 accumulation truncates, so no
// chain of MMAs runs longer than one kv tile: a tile's p @ v starts from
// zero and is folded into acc with one rounded fmaf (acc * corr + tile), as
// the TPU kernel adds each block's product.  Row max and row sum of the
// online softmax are shuffles over the 4 lanes that share a row.  The
// exponent runs in base 2 (ex2.approx.ftz, 2^-22 relative error; outputs
// below 2^-126 flush to 0) with scale * log2(e) folded into the score.
//
// bfloat16 (flash_fwd_mma_kernel):
//  * q . k^T: q and k are bf16, so each product is exact and the
//    mma.sync m16n8k16 bf16 -> f32 accumulator gives the float32 dot of the
//    TPU kernel.
//  * p @ v: a bf16 p would keep 8 significant bits of a value the TPU kernel
//    keeps in float32, which is different arithmetic (off by up to a bf16 ulp
//    of p before the output's own rounding).  So p is split into two bf16
//    terms, p = p_hi + p_lo with p_hi = bf16(p) and p_lo = bf16(p - p_hi),
//    about 16 significant bits, and p @ v is two MMAs into one f32
//    accumulator: 1.5x the MMA work of a bf16-p loop.  The m16n8
//    accumulators of two adjacent score tiles are exactly one m16n8k16 A
//    fragment.
//  * q is copied to shared memory once (cp.async) and read into A fragments
//    (ldmatrix) that stay in registers for the whole kv loop.  k and v
//    tiles of 64 rows flow through a two-stage cp.async ring: the next
//    tile's 16-byte copies are in flight while the current tile is
//    computed.  Shared rows are padded by 16 bytes, so every ldmatrix phase
//    hits 8 distinct bank groups.
//  * Left for later: wgmma with p from registers, a TMA ring with mbarriers,
//    warp specialisation (a producer warp and two consumer warpgroups).
//
// float32 (flash_fwd_tf32_kernel): 3xTF32 (csrc/tf32.cuh).  One TF32
// product keeps 10 mantissa bits and misses the float32 limit of 3e-5 by
// 30-150x; the split (a = hi + lo, products lo.hi + hi.lo + hi.hi, lo.lo
// dropped, rounded with two integer operations) meets it.
//  * Both products are mma.sync m16n8k8 tf32.  A score tile is one chain of
//    D / 8 k-steps of three MMAs (at D = 128 the small terms of all k-steps
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
//    thread and 102 KB of shared memory at D = 64).  At D = 128 the kv
//    tile is 32 rows.
//  * q's hi + lo fragments are split once and stay in registers up to
//    D = 64; at D = 128 q is read from shared memory and split per k-step.
//  * float32 inputs must be 16-byte aligned (the copies are 16 bytes).
//
// Both: blocks take q tiles in reverse order, so that the longest causal
// rows start first.  kv tiles wholly above the diagonal are never loaded.
// Any S is taken with no padding copy: rows past S are not written.  The
// guards of the TPU kernel: m_safe = 0 for a fully masked row, corr = 0
// while m is -inf, l floored at 1e-30 in the final division.
//
// For training the caller may pass an lse buffer (BH, S) float32: each row's
// log-sum-exp of the scaled scores in natural-log units, with the same
// guards, which the backward kernel (flash_attention_bwd.cu) reads to
// rebuild p.  Each kernel has an instance with and one without the lse
// store (template flag LSE), so with lse null nothing else changes.
//
// Interface: a plain C function for ctypes.  It launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"
#include "tf32.cuh"

namespace {

using namespace mma;

constexpr int BK = 64;  // kv rows per tile of the bfloat16 kernel

// --------------------------------------------------------------- bfloat16

using bf16 = __nv_bfloat16;
constexpr int MMA_WARPS = 4;              // 16 q rows each
constexpr int MMA_BQ = 16 * MMA_WARPS;    // q rows per block
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int STAGES = 2;                 // depth of the k / v ring
static_assert(MMA_BQ % BK == 0 && BK % 16 == 0, "whole kv tiles per q tile");

template <int D>
struct MmaSmem {
  static constexpr int LD = D + 8;  // bf16 per row: 16 bytes of padding
  bf16 q[MMA_BQ * LD];
  bf16 k[STAGES][BK * LD];  // the ring: tile i in stage i % STAGES
  bf16 v[STAGES][BK * LD];
};

// a row's log-sum-exp in natural-log units of the scaled scores,
// log sum_j exp(scale * q . k_j), from the base-2 running max m (-inf for a
// fully masked row, taken as 0 like m_safe) and the floored row sum den
__device__ __forceinline__ float row_lse(float m, float den) {
  return ((isfinite(m) ? m : 0.f) + log2f(den)) * 0.6931471805599453f;
}

// rows [row0, row0 + ROWS) of a (S, D) matrix into a padded shared tile
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int S, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  constexpr int LD = MmaSmem<D>::LD;
  static_assert(ROWS * CH % MMA_THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int j = 0; j < ROWS * CH / MMA_THREADS; ++j) {
    const int i = tid + j * MMA_THREADS;
    const int r = i / CH, ch = i % CH;
    const bool in = row0 + r < S;
    const bf16* g = src + (size_t)(in ? row0 + r : 0) * D + ch * 8;
    cp_async16(smem_addr(dst + r * LD + ch * 8), g, in);
  }
}

template <int D, bool LSE>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, int S, int causal, float scale_log2) {
  static_assert(D % 16 == 0, "k-steps of 16 and pairs of n8 tiles");
  constexpr int LD = MmaSmem<D>::LD;
  constexpr int KD = D / 16;   // k-steps of q k^T
  constexpr int ND = D / 8;    // n8 tiles of the output
  constexpr int NS = BK / 8;   // n8 tiles of a score tile
  constexpr int KC = BK / 16;  // k-steps of p v
  extern __shared__ __align__(16) unsigned char smem_raw[];
  MmaSmem<D>& sm = *reinterpret_cast<MmaSmem<D>*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nq = (S + MMA_BQ - 1) / MMA_BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * MMA_BQ;
  const size_t base = (size_t)blockIdx.y * (size_t)S * D;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  const int kv_end = causal ? min(S, q0 + MMA_BQ) : S;
  const int n_tiles = (kv_end + BK - 1) / BK;

  // one copy group for q, then one per kv tile, the first STAGES - 1 now
  load_tile<D, MMA_BQ>(sm.q, qb, q0, S, tid);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles) {
      load_tile<D, BK>(sm.k[i], kb, i * BK, S, tid);
      load_tile<D, BK>(sm.v[i], vb, i * BK, S, tid);
    }
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();  // q has landed; kv tiles may still be in flight
  __syncthreads();

  // this warp's 16 q rows as A fragments, for the whole kv loop
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldmatrix_x4(qf[kk], smem_addr(&sm.q[(warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8]));

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
    const int st = it % STAGES;
    const int k0 = it * BK;
    const int ahead = it + STAGES - 1;  // into the stage read at iteration it - 1
    if (ahead < n_tiles) {
      load_tile<D, BK>(sm.k[ahead % STAGES], kb, ahead * BK, S, tid);
      load_tile<D, BK>(sm.v[ahead % STAGES], vb, ahead * BK, S, tid);
    }
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // tile it has landed; later tiles stay in flight
    __syncthreads();

    // s = q k^T for this warp's 16 rows and the tile's 64 columns
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const bf16* kt = sm.k[st];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, smem_addr(&kt[(jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                                     kk * 16 + ((lane >> 3) & 1) * 8]));
        mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale (base 2), mask, and the online-softmax update
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0);
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

    // p as hi + lo A fragments: score tiles 2c and 2c + 1 are k-step c
    uint32_t ph[KC][4], pl[KC][4];
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      split_bf16(s[2 * c][0], s[2 * c][1], ph[c][0], pl[c][0]);
      split_bf16(s[2 * c][2], s[2 * c][3], ph[c][1], pl[c][1]);
      split_bf16(s[2 * c + 1][0], s[2 * c + 1][1], ph[c][2], pl[c][2]);
      split_bf16(s[2 * c + 1][2], s[2 * c + 1][3], ph[c][3], pl[c][3]);
    }

    // acc = acc * corr + p v, 16 output columns at a time
    const bf16* vt = sm.v[st];
#pragma unroll
    for (int dp = 0; dp < ND / 2; ++dp) {
      float t[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_addr(&vt[(c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                           dp * 16 + (lane >> 4) * 8]));
        mma_bf16(t[0], ph[c], b[0], b[1]);
        mma_bf16(t[0], pl[c], b[0], b[1]);
        mma_bf16(t[1], ph[c], b[2], b[3]);
        mma_bf16(t[1], pl[c], b[2], b[3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[2 * dp + h][e] = fmaf(acc[2 * dp + h][e], corr[e >> 1], t[h][e]);
    }
    __syncthreads();  // stage st is refilled by the next iteration's copies
  }

  bf16* ob = o + base;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = fmaxf(quad_sum(l[r]), 1e-30f);  // all lanes shuffle
    const int row = row_a + 8 * r;
    if (row >= S) continue;
    if constexpr (LSE)
      if ((lane & 3) == 0) lse[blockIdx.y * (size_t)S + row] = row_lse(m[r], den);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(&ob[(size_t)row * D + j * 8 + col_t]) =
          __floats2bfloat162_rn(acc[j][2 * r] / den, acc[j][2 * r + 1] / den);
  }
}

// ---------------------------------------------------------------- float32

using tf32::mma_tf32;
using tf32::split_tf32;

constexpr int F32_WARPS = 8;  // 16 q rows each
constexpr int F32_BQ = 16 * F32_WARPS;
constexpr int F32_THREADS = 32 * F32_WARPS;

// The float32 kernel's tiles.  kv tiles of 64 rows, or 32 at D = 128, where
// 64 rows of raw and split planes beside q's own plane would pass the
// 227 KB a block may hold.  q's hi + lo fragments stay in registers up to
// D = 64 (64 registers there) and are read from shared memory and split
// per k-step at D = 128.  Word offsets into shared memory:
//   raw k, raw v  (BK, LD)  the cp.async targets, float32 as loaded
//   k hi, k lo    (BK, LD)  the split of k, in k's layout
//   vT hi, vT lo  (D, LDT)  the split of v, transposed, kv in k-step order
//   q         (F32_BQ, LD)  staged once; in the k planes when it is split
//                           into registers, else a plane of its own
// LD and LDT are 4 mod 32 words, so each ldmatrix phase (8 rows of 16
// bytes) hits 8 distinct bank groups, and so do the split pass's
// transposed stores (32 lanes on 32 consecutive kv rows).
template <int D>
struct F32Tile {
  static constexpr int BK = D <= 64 ? 64 : 32;
  static constexpr bool QREG = D <= 64;
  static constexpr int LD = D + 4;
  static constexpr int LDT = BK + 4;
  static constexpr int RAW_K = 0;
  static constexpr int RAW_V = RAW_K + BK * LD;
  static constexpr int K_HI = RAW_V + BK * LD;
  static constexpr int K_LO = K_HI + BK * LD;
  static constexpr int VT_HI = K_LO + BK * LD;
  static constexpr int VT_LO = VT_HI + D * LDT;
  static constexpr int SPLIT_END = VT_LO + D * LDT;
  static constexpr int Q = QREG ? K_HI : SPLIT_END;
  static constexpr int WORDS = QREG ? SPLIT_END : SPLIT_END + F32_BQ * LD;
  static_assert(!QREG || F32_BQ * LD <= SPLIT_END - K_HI, "q is staged in the split planes");
  static_assert(BK % 32 == 0 && BK * D / 4 % F32_THREADS == 0, "whole 16-byte pieces a thread");
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
template <int D>
__device__ __forceinline__ void split_tile(uint32_t* sm, int tid) {
  using T = F32Tile<D>;
  constexpr int CH = D / 4;
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
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * F32_THREADS;
    const int w = i >> 5;
    const int r = (w % (T::BK / 32)) * 32 + (i & 31), ch = w / (T::BK / 32);
    const uint4 a = *reinterpret_cast<const uint4*>(sm + T::RAW_V + r * T::LD + ch * 4);
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

template <int D, bool LSE>
__global__ void __launch_bounds__(F32_THREADS)
    flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int S, int causal, float scale_log2) {
  using T = F32Tile<D>;
  constexpr int BKT = T::BK, LD = T::LD, LDT = T::LDT;
  constexpr int KD = D / 8;    // k-steps of q k^T
  constexpr int ND = D / 8;    // n8 tiles of the output
  constexpr int NS = BKT / 8;  // n8 tiles of a score tile, and k-steps of p v
  static_assert(D % 16 == 0, "pairs of n8 tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nq = (S + F32_BQ - 1) / F32_BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * F32_BQ;
  const size_t base = (size_t)blockIdx.y * (size_t)S * D;
  const float* kb = k + base;
  const float* vb = v + base;
  const int kv_end = causal ? min(S, q0 + F32_BQ) : S;
  const int n_tiles = (kv_end + BKT - 1) / BKT;

  // one copy group: q and kv tile 0
  load_rows_f32<D, LD, F32_BQ>(sm + T::Q, q + base, q0, S, tid);
  load_rows_f32<D, LD, BKT>(sm + T::RAW_K, kb, 0, S, tid);
  load_rows_f32<D, LD, BKT>(sm + T::RAW_V, vb, 0, S, tid);
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
    split_tile<D>(sm, tid);
    __syncthreads();  // the split planes hold tile it; the raw planes are free
    if (it + 1 < n_tiles) {
      load_rows_f32<D, LD, BKT>(sm + T::RAW_K, kb, (it + 1) * BKT, S, tid);
      load_rows_f32<D, LD, BKT>(sm + T::RAW_V, vb, (it + 1) * BKT, S, tid);
      cp_async_commit();
    }
    const int k0 = it * BKT;

    // s = q k^T for this warp's 16 rows: one chain of KD k-steps of three
    // MMAs per n8 tile.  Each MMA truncates the running sum, so the longer
    // chains of D = 128 take every small term (lo.hi, hi.lo) in a first pass
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

  float* ob = o + base;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = fmaxf(quad_sum(l[r]), 1e-30f);  // all lanes shuffle
    const int row = row_a + 8 * r;
    if (row >= S) continue;
    if constexpr (LSE)
      if ((lane & 3) == 0) lse[blockIdx.y * (size_t)S + row] = row_lse(m[r], den);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<float2*>(&ob[(size_t)row * D + j * 8 + col_t]) =
          make_float2(acc[j][2 * r] / den, acc[j][2 * r + 1] / den);
  }
}

// ------------------------------------------------------------- launchers

template <int D, bool LSE>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                       int S, int causal, float scale, cudaStream_t stream) {
  const int smem = (int)(F32Tile<D>::WORDS * sizeof(uint32_t));
  static bool attr_set = false;
  cudaError_t e = allow_smem(flash_fwd_tf32_kernel<D, LSE>, smem, attr_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + F32_BQ - 1) / F32_BQ, BH);
  flash_fwd_tf32_kernel<D, LSE><<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, S, causal, (float)(scale * 1.4426950408889634));
  return cudaGetLastError();
}

template <int D, bool LSE>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                        int S, int causal, float scale, cudaStream_t stream) {
  const int smem = (int)sizeof(MmaSmem<D>);
  static bool attr_set = false;
  cudaError_t e = allow_smem(flash_fwd_mma_kernel<D, LSE>, smem, attr_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + MMA_BQ - 1) / MMA_BQ, BH);
  flash_fwd_mma_kernel<D, LSE><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, S, causal, (float)(scale * 1.4426950408889634));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                   int S, int dtype, int causal, float scale, cudaStream_t st) {
  // the row log-sum-exp is a separate instance, so inference runs the code
  // it ran before the backward existed
  if (dtype == 0)
    return lse ? launch_f32<D, true>(q, k, v, o, lse, BH, S, causal, scale, st)
               : launch_f32<D, false>(q, k, v, o, lse, BH, S, causal, scale, st);
  if (dtype == 1)
    return lse ? launch_bf16<D, true>(q, k, v, o, lse, BH, S, causal, scale, st)
               : launch_bf16<D, false>(q, k, v, o, lse, BH, S, causal, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o (BH, S, D) row-major on the device, all of one dtype:
// 0 = float32, 1 = bfloat16, 16-byte aligned.  D: 16, 32, 64 or 128.
// lse: null, or (BH, S) float32 that receives each row's log-sum-exp of the
// scaled scores in natural-log units (what the backward kernel reads).
// causal: 0 or 1.  Returns a cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int BH, int S, int D, int dtype, int causal,
                                     float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (BH <= 0 || BH > 65535 || S <= 0 || (causal != 0 && causal != 1))
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return (int)launch<16>(q, k, v, o, l, BH, S, dtype, causal, scale, st);
    case 32: return (int)launch<32>(q, k, v, o, l, BH, S, dtype, causal, scale, st);
    case 64: return (int)launch<64>(q, k, v, o, l, BH, S, dtype, causal, scale, st);
    case 128: return (int)launch<128>(q, k, v, o, l, BH, S, dtype, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
