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
// What bounds it: operations.  The gradient is 2.5x the forward's products
// (q k^T, dO v^T, p^T dO, ds^T q, ds k against q k^T, p v); this design
// rebuilds p in both of its passes, so it does 4x the forward's.
//
// Three launches, no atomics, so a run gives the same bits every time:
//  * delta_kernel: delta = rowsum(dO o) in float32, one warp a row.
//  * dkdv: a block owns 64 kv rows of one (batch, head) and walks the q
//    tiles that see them (causal: from its own diagonal on), rebuilding p
//    and ds for each tile and summing dk and dv in registers.
//  * dq: a block owns 64 q rows and walks the kv tiles they see, rebuilding
//    p and ds and summing dq.  Blocks take q tiles in reverse order, so the
//    longest causal rows start first.
//
// bfloat16 (bwd_dkdv_mma_kernel, bwd_dq_mma_kernel): the tensor cores, with
// the fragments of K3's bf16 forward (csrc/mma.cuh): 4 warps, each 16 owned
// rows in the m16n8 accumulator layout.  The owned rows sit in shared
// memory, the walked tiles flow through a two-stage cp.async ring.
//  * q k^T and dO v^T: bf16 operands, so every product is exact and the f32
//    accumulator gives the float32 dot.  In dkdv the block computes the
//    transposed tiles k q^T and v dO^T, so that its kv rows are the MMA's
//    rows and p^T, ds^T are A fragments straight from the accumulators.
//  * p and ds are float32; as K3's forward does for p, each is split into
//    two bf16 terms (hi = bf16(x), lo = bf16(x - hi)), about 16 significant
//    bits, before p^T dO, ds^T q and ds k: two MMAs per product.
//  * The tensor cores' f32 accumulation truncates, so each walked tile's
//    product starts from zero and is added into the float32 sum with one
//    rounded add, as K3's forward folds each kv tile.
//  * Left for later: one pass for dk, dv and dq, wgmma, a TMA ring.
//
// float32 (bwd_dkdv_simt_kernel, bwd_dq_simt_kernel): plain float32 FMAs,
// 256 threads; the block's tiles in shared memory with rows padded to an
// odd stride, scores 64 x 32 at a time.  Slow and simple.
//
// Interface: a plain C function for ctypes.  It launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

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

constexpr int MMA_THREADS = 128;  // 4 warps, 16 owned rows each
constexpr int BR = 64;            // rows a block owns
constexpr int BC = 64;            // rows of a walked tile

template <int D>
struct BwdSmem {
  static constexpr int LD = D + 8;  // bf16 per row: 16 bytes of padding
  bf16 a[BR * LD];     // owned rows: k (dkdv) or q (dq)
  bf16 b[BR * LD];     // owned rows: v (dkdv) or dO (dq)
  bf16 c[2][BC * LD];  // walked tiles: q (dkdv) or k (dq), stage i % 2
  bf16 d[2][BC * LD];  // walked tiles: dO (dkdv) or v (dq)
  float lse[BC];       // dkdv: the walked q rows' lse (base 2) and delta
  float delta[BC];
};

// rows [row0, row0 + ROWS) of a (S, D) matrix into a padded shared tile;
// rows at or past S zero-fill
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int S, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  constexpr int LD = BwdSmem<D>::LD;
  static_assert(ROWS * CH % MMA_THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int j = 0; j < ROWS * CH / MMA_THREADS; ++j) {
    const int i = tid + j * MMA_THREADS;
    const int r = i / CH, ch = i % CH;
    const bool in = row0 + r < S;
    cp_async16(smem_addr(dst + r * LD + ch * 8), src + (size_t)(in ? row0 + r : 0) * D + ch * 8,
               in);
  }
}

// acc (16 x 8 n-tiles over D) = rows . tile^T for this warp's 16 owned
// rows (shared, row-major) against a walked tile of 64 rows: c[j] holds the
// 16 x 8 scores of tile rows 8j .. 8j + 7
template <int D>
__device__ __forceinline__ void scores(float (&c)[BC / 8][4], const bf16* own, const bf16* tile,
                                       int warp, int lane) {
  constexpr int LD = BwdSmem<D>::LD;
#pragma unroll
  for (int j = 0; j < BC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, smem_addr(&own[(warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8]));
#pragma unroll
    for (int jp = 0; jp < BC / 16; ++jp) {
      uint32_t b[4];
      ldmatrix_x4(b, smem_addr(&tile[(jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                                     ((lane >> 3) & 1) * 8]));
      mma_bf16(c[2 * jp], a, b[0], b[1]);
      mma_bf16(c[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// acc += x . tile, x (16 x 64) float32 in accumulator layout, split into
// bf16 hi + lo A fragments, tile (64 rows, D) row-major in shared memory;
// each 16 output columns start from zero and fold in with one rounded add
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4], const float (&x)[BC / 8][4],
                                           const bf16* tile, int lane) {
  constexpr int LD = BwdSmem<D>::LD;
  constexpr int KC = BC / 16;
  uint32_t xh[KC][4], xl[KC][4];
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    split_bf16(x[2 * c][0], x[2 * c][1], xh[c][0], xl[c][0]);
    split_bf16(x[2 * c][2], x[2 * c][3], xh[c][1], xl[c][1]);
    split_bf16(x[2 * c + 1][0], x[2 * c + 1][1], xh[c][2], xl[c][2]);
    split_bf16(x[2 * c + 1][2], x[2 * c + 1][3], xh[c][3], xl[c][3]);
  }
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    float t[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, smem_addr(&tile[(c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                           dp * 16 + (lane >> 4) * 8]));
      mma_bf16(t[0], xl[c], b[0], b[1]);
      mma_bf16(t[0], xh[c], b[0], b[1]);
      mma_bf16(t[1], xl[c], b[2], b[3]);
      mma_bf16(t[1], xh[c], b[2], b[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[2 * dp + h][e] += t[h][e];
  }
}

// this warp's 16 rows of acc * mul into out as bf16 (rows past S skipped)
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[D / 8][4], float mul,
                                           int row_a, int S, int lane) {
  const int col_t = 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(&out[(size_t)row * D + j * 8 + col_t]) =
          __floats2bfloat162_rn(acc[j][2 * r] * mul, acc[j][2 * r + 1] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dO,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int causal,
                        float scale, float scale_log2) {
  constexpr int NS = BC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<D>& sm = *reinterpret_cast<BwdSmem<D>*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int kv0 = blockIdx.x * BR;
  const size_t base = (size_t)blockIdx.y * (size_t)S * D;
  const float* lse_b = lse + (size_t)blockIdx.y * S;
  const float* delta_b = delta + (size_t)blockIdx.y * S;
  const bf16* qb = q + base;
  const bf16* dob = dO + base;
  const int first = causal ? kv0 / BC : 0;  // q tiles before it see none of these kv rows
  const int n_tiles = (S + BC - 1) / BC;

  // one copy group for the owned k and v rows, then one per walked tile
  load_tile<D, BR>(sm.a, k + base, kv0, S, tid);
  load_tile<D, BR>(sm.b, v + base, kv0, S, tid);
  cp_async_commit();
  load_tile<D, BC>(sm.c[0], qb, first * BC, S, tid);
  load_tile<D, BC>(sm.d[0], dob, first * BC, S, tid);
  cp_async_commit();

  // a thread's kv rows in the m16n8 layout: g and g + 8 of the warp's 16
  const int row_a = kv0 + warp * 16 + (lane >> 2);
  const int col_t = 2 * (lane & 3);
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int it = first; it < n_tiles; ++it) {
    const int st = (it - first) & 1;
    const int q0 = it * BC;
    if (it + 1 < n_tiles) {
      load_tile<D, BC>(sm.c[st ^ 1], qb, q0 + BC, S, tid);
      load_tile<D, BC>(sm.d[st ^ 1], dob, q0 + BC, S, tid);
    }
    cp_async_commit();
    if (tid < BC) {
      const int r = q0 + tid;
      sm.lse[tid] = r < S ? lse_b[r] * LOG2E : 0.f;
      sm.delta[tid] = r < S ? delta_b[r] : 0.f;
    }
    cp_async_wait<1>();  // tile it has landed; tile it + 1 may be in flight
    __syncthreads();

    // sT = k q^T and dpT = v dO^T: this warp's 16 kv rows by the tile's 64 q rows
    float sT[NS][4], dpT[NS][4];
    scores<D>(sT, sm.a, sm.c[st], warp, lane);
    scores<D>(dpT, sm.b, sm.d[st], warp, lane);

    // p^T and ds^T, masked
    const bool edge = q0 + BC > S || kv0 + BR > S || (causal && q0 < kv0 + BR);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + col_t + (e & 1);
        float p = ex2(sT[j][e] * scale_log2 - sm.lse[qc]);
        if (edge) {
          const int kv = row_a + (e >> 1) * 8, qr = q0 + qc;
          if (qr >= S || kv >= S || (causal && kv > qr)) p = 0.f;
        }
        sT[j][e] = p;
        dpT[j][e] = p * (dpT[j][e] - sm.delta[qc]);
      }

    // dv += p^T dO and dk += ds^T q
    accumulate<D>(dv_acc, sT, sm.d[st], lane);
    accumulate<D>(dk_acc, dpT, sm.c[st], lane);
    __syncthreads();  // stage st and lse / delta are refilled next
  }
  store_rows<D>(dk + base, dk_acc, scale, row_a, S, lane);
  store_rows<D>(dv + base, dv_acc, 1.f, row_a, S, lane);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dO,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dq, int S, int causal, float scale, float scale_log2) {
  constexpr int NS = BC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<D>& sm = *reinterpret_cast<BwdSmem<D>*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nq = (S + BR - 1) / BR;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BR;
  const size_t base = (size_t)blockIdx.y * (size_t)S * D;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  const int kv_end = causal ? min(S, q0 + BR) : S;
  const int n_tiles = (kv_end + BC - 1) / BC;

  load_tile<D, BR>(sm.a, q + base, q0, S, tid);
  load_tile<D, BR>(sm.b, dO + base, q0, S, tid);
  cp_async_commit();
  load_tile<D, BC>(sm.c[0], kb, 0, S, tid);
  load_tile<D, BC>(sm.d[0], vb, 0, S, tid);
  cp_async_commit();

  // a thread's q rows in the m16n8 layout, with their lse (base 2) and delta
  const int row_a = q0 + warp * 16 + (lane >> 2);
  const int col_t = 2 * (lane & 3);
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    lse2[r] = row < S ? lse[(size_t)blockIdx.y * S + row] * LOG2E : 0.f;
    dl[r] = row < S ? delta[(size_t)blockIdx.y * S + row] : 0.f;
  }
  float dq_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    const int k0 = it * BC;
    if (it + 1 < n_tiles) {
      load_tile<D, BC>(sm.c[st ^ 1], kb, k0 + BC, S, tid);
      load_tile<D, BC>(sm.d[st ^ 1], vb, k0 + BC, S, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // s = q k^T and dp = dO v^T: this warp's 16 q rows by the tile's 64 kv rows
    float s[NS][4], dp[NS][4];
    scores<D>(s, sm.a, sm.c[st], warp, lane);
    scores<D>(dp, sm.b, sm.d[st], warp, lane);

    const bool edge = k0 + BC > S || q0 + BR > S || (causal && k0 + BC - 1 > q0);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(s[j][e] * scale_log2 - lse2[e >> 1]);
        if (edge) {
          const int row = row_a + (e >> 1) * 8, col = k0 + j * 8 + col_t + (e & 1);
          if (col >= S || row >= S || (causal && col > row)) p = 0.f;
        }
        s[j][e] = p * (dp[j][e] - dl[e >> 1]);
      }

    // dq += ds k
    accumulate<D>(dq_acc, s, sm.c[st], lane);
    __syncthreads();  // stage st is refilled next
  }
  store_rows<D>(dq + base, dq_acc, scale, row_a, S, lane);
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
  float* delta;
  void *dq, *dk, *dv;
  int BH, S, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T>
cudaError_t launch_delta(const Args& a, int D) {
  const int rows = a.BH * a.S;
  delta_kernel<T><<<(rows + 7) / 8, 256, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dO), a.delta, rows, D);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Args& a) {
  cudaError_t e = launch_delta<bf16>(a, D);
  if (e != cudaSuccess) return e;
  const int smem = (int)sizeof(BwdSmem<D>);
  static bool kv_set = false, q_set = false;
  if ((e = allow_smem(bwd_dkdv_mma_kernel<D>, smem, kv_set)) != cudaSuccess) return e;
  if ((e = allow_smem(bwd_dq_mma_kernel<D>, smem, q_set)) != cudaSuccess) return e;
  const dim3 grid((a.S + BR - 1) / BR, a.BH);
  const float sl2 = a.scale * LOG2E;
  const bf16 *q = static_cast<const bf16*>(a.q), *k = static_cast<const bf16*>(a.k),
             *v = static_cast<const bf16*>(a.v), *dO = static_cast<const bf16*>(a.dO);
  bwd_dkdv_mma_kernel<D><<<grid, MMA_THREADS, smem, a.stream>>>(
      q, k, v, dO, a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.S,
      a.causal, a.scale, sl2);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  bwd_dq_mma_kernel<D><<<grid, MMA_THREADS, smem, a.stream>>>(
      q, k, v, dO, a.lse, a.delta, static_cast<bf16*>(a.dq), a.S, a.causal, a.scale, sl2);
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
      q, k, v, dO, a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.S,
      a.causal, a.scale, sl2);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  bwd_dq_simt_kernel<D><<<grid, SIMT_THREADS, smem, a.stream>>>(
      q, k, v, dO, a.lse, a.delta, static_cast<float*>(a.dq), a.S, a.causal, a.scale, sl2);
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
// from K3's forward (natural log of the scaled scores' row sums); delta
// (BH, S) float32 scratch.  D: 16, 32, 64 or 128.  causal: 0 or 1.
// Returns a cudaError_t.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dO, const void* lse,
                                         void* delta, void* dq, void* dk, void* dv, int BH,
                                         int S, int D, int dtype, int causal, float scale,
                                         void* stream) {
  if (BH <= 0 || BH > 65535 || S <= 0 || (causal != 0 && causal != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, dO, static_cast<const float*>(lse), static_cast<float*>(delta),
               dq, dk, dv, BH, S, causal, scale, reinterpret_cast<cudaStream_t>(stream)};
  switch (D) {
    case 16: return (int)launch<16>(a, dtype);
    case 32: return (int)launch<32>(a, dtype);
    case 64: return (int)launch<64>(a, dtype);
    case 128: return (int)launch<128>(a, dtype);
    default: return (int)cudaErrorInvalidValue;
  }
}
