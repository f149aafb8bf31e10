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
// products as a 3xTF32 split on the tensor cores (495 / 3), above the
// 67 TFLOP/s of the fp32 SIMT pipe that the float32 path uses.
//
// bfloat16 (flash_fwd_mma_kernel): the tensor cores, at float32 grade.
//  * q . k^T: q and k are bf16, so each product is exact and the
//    mma.sync m16n8k16 bf16 -> f32 accumulator gives the float32 dot of the
//    TPU kernel.  The scale is applied after the dot.
//  * p @ v: a bf16 p would keep 8 significant bits of a value the TPU kernel
//    keeps in float32, which is different arithmetic (off by up to a bf16 ulp
//    of p before the output's own rounding).  So p is split into two bf16
//    terms, p = p_hi + p_lo with p_hi = bf16(p) and p_lo = bf16(p - p_hi),
//    about 16 significant bits, and p @ v is two MMAs into one f32
//    accumulator: 1.5x the MMA work of a bf16-p loop, still on the tensor
//    cores.  p never leaves registers: the m16n8 accumulators of two adjacent
//    score tiles are exactly one m16n8k16 A fragment.
//  * The tensor cores' f32 accumulation truncates, so no chain of MMAs runs
//    longer than one kv tile: a tile's p @ v starts from zero and is folded
//    into acc with one rounded fmaf (acc * corr + tile), as the TPU kernel
//    adds each block's product.
//  * A block is 4 warps over one 64-row q tile of one (batch, head); each
//    warp owns 16 q rows.  q is copied to shared memory once (cp.async) and
//    read into A fragments (ldmatrix) that stay in registers for the whole
//    kv loop.  k and v tiles of 64 rows flow through a two-stage cp.async
//    ring: the next tile's 16-byte copies are in flight while the current
//    tile is computed.  Rows at or past S zero-fill.  Shared rows are padded
//    by 16 bytes, so every ldmatrix phase hits 8 distinct bank groups.
//  * Row max and row sum of the online softmax are shuffles over the 4 lanes
//    that share a row in the m16n8 layout.  The causal mask is applied on the
//    diagonal tile only; the ragged last tile masks its columns >= S to
//    -inf (zero-filled k rows would score 0).  The exponent runs in base 2
//    (ex2.approx.ftz, 2^-22 relative error; outputs below 2^-126 flush to
//    0) with scale * log2(e) folded into the score.
//  * Left for later: wgmma with p from registers, a TMA ring with mbarriers,
//    warp specialisation (a producer warp and two consumer warpgroups).
//
// float32 (flash_fwd_kernel): fp32 SIMT.  A single TF32 product would break
// the float32 limit of 3e-5; a 3xTF32 split is left for later.  One block of 256 threads owns one 64-row q tile; thread t owns 4
// q rows and, in each 64-column score tile, the columns t % 16 + 16 j.  The
// 16 threads that share rows form a half-warp, so row max and row sum are
// shuffles and p goes through shared memory with only __syncwarp.  q, k and
// v (transposed) are staged as float32, rows padded by 4 floats, so every
// inner-loop read is a conflict-free or broadcast float4.
//
// Both: blocks take q tiles in reverse order, so that the longest causal
// rows start first.  kv tiles wholly above the diagonal are never loaded.
// Any S is taken with no padding copy: rows past S are not written.  The
// guards of the TPU kernel: m_safe = 0 for a fully masked row, corr = 0
// while m is -inf, l floored at 1e-30 in the final division.
//
// Interface: a plain C function for ctypes.  It launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // q rows per block
constexpr int BK = 64;  // kv rows per tile

// ---------------------------------------------------------------- float32

constexpr int THREADS = 256;
constexpr int RPT = 4;  // q rows per thread
constexpr int PAD = 4;  // floats of padding per shared-memory row
static_assert(THREADS == 16 * (BQ / RPT) && BK == 4 * 16, "thread layout");

template <int D>
struct Smem {
  static constexpr int QS = D + PAD;   // row stride of the q and k tiles
  static constexpr int VS = BK + PAD;  // row stride of the transposed v tile and of p
  float q[BQ * QS];
  float k[BK * QS];
  float vt[D * VS];
  float p[BQ * VS];
};

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int S, int causal,
                     float scale) {
  static_assert(D % 16 == 0, "each thread owns D / 16 output columns");
  constexpr int QS = Smem<D>::QS;
  constexpr int VS = Smem<D>::VS;
  constexpr int CJ = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);

  const int tid = threadIdx.x;
  const int r0 = (tid >> 4) * RPT;  // this thread's first row in the tile
  const int c = tid & 15;           // its columns: c + 16 j
  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;
  const size_t base = (size_t)blockIdx.y * (size_t)S * D;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    sm.q[r * QS + d] = q0 + r < S ? qb[(size_t)(q0 + r) * D + d] : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][CJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's k / vt are no longer read (and q is stored)
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, d = idx % D;
      const bool in = k0 + r < S;
      const size_t g = (size_t)(k0 + r) * D + d;
      sm.k[r * QS + d] = in ? kb[g] : 0.f;
      sm.vt[d * VS + r] = in ? vb[g] : 0.f;
    }
    __syncthreads();

    float s[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RPT], kv[4];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&sm.q[(r0 + i) * QS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&sm.k[(c + 16 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(qv[i], kv[j], s[i][j]);
    }

    // mask, then the online-softmax update of the TPU kernel, row by row
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int q_pos = q0 + r0 + i;
      bool valid[4];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + c + 16 * j;
        valid[j] = k_pos < S && (!causal || k_pos <= q_pos);
        s[i][j] = valid[j] ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_safe) : 0.f;
        sm.p[(r0 + i) * VS + c + 16 * j] = p;
        ps += p;
      }
      const float corr = isfinite(m[i]) ? expf(m[i] - m_safe) : 0.f;
      l[i] = l[i] * corr + half_warp_sum(ps);
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= corr;
      m[i] = m_new;
    }
    __syncwarp();  // p of these rows was written by the other lanes of the half-warp

#pragma unroll 4
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&sm.p[(r0 + i) * VS + kk]);
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(&sm.vt[(c + 16 * j) * VS + kk]);
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = dot4(pv[i], vv, acc[i][j]);
      }
    }
    __syncwarp();  // the next tile rewrites p
  }

  float* ob = o + base;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + r0 + i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < CJ; ++j) ob[(size_t)row * D + c + 16 * j] = acc[i][j] / den;
  }
}

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, asynchronously; zero-fills when !in
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x; 0 for -inf
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) -> the bf16 pairs hi = bf16(x, y) and lo = bf16((x, y) - hi)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o, int S, int causal,
                         float scale_log2) {
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
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(&ob[(size_t)row * D + j * 8 + col_t]) =
          __floats2bfloat162_rn(acc[j][2 * r] / den, acc[j][2 * r + 1] / den);
  }
}

// ------------------------------------------------------------- launchers

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  done = e == cudaSuccess;
  return e;
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int BH, int S,
                       int causal, float scale, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<D>);
  static bool attr_set = false;
  cudaError_t e = allow_smem(flash_fwd_kernel<D>, smem, attr_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + BQ - 1) / BQ, BH);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int BH, int S,
                        int causal, float scale, cudaStream_t stream) {
  const int smem = (int)sizeof(MmaSmem<D>);
  static bool attr_set = false;
  cudaError_t e = allow_smem(flash_fwd_mma_kernel<D>, smem, attr_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + MMA_BQ - 1) / MMA_BQ, BH);
  flash_fwd_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), S, causal, (float)(scale * 1.4426950408889634));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int BH, int S,
                   int dtype, int causal, float scale, cudaStream_t st) {
  if (dtype == 0) return launch_f32<D>(q, k, v, o, BH, S, causal, scale, st);
  if (dtype == 1) return launch_bf16<D>(q, k, v, o, BH, S, causal, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o (BH, S, D) row-major on the device, all of one dtype:
// 0 = float32, 1 = bfloat16 (16-byte aligned).  D: 16, 32, 64 or 128.
// causal: 0 or 1.  Returns a cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int BH, int S, int D, int dtype, int causal, float scale,
                                     void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (BH <= 0 || BH > 65535 || S <= 0 || (causal != 0 && causal != 1))
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return (int)launch<16>(q, k, v, o, BH, S, dtype, causal, scale, st);
    case 32: return (int)launch<32>(q, k, v, o, BH, S, dtype, causal, scale, st);
    case 64: return (int)launch<64>(q, k, v, o, BH, S, dtype, causal, scale, st);
    case 128: return (int)launch<128>(q, k, v, o, BH, S, dtype, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
