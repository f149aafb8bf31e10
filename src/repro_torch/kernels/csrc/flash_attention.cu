// K3: attention forward with an online softmax for Hopper (sm_90a), fp32 SIMT.
//
// Replaces src/repro/kernels/flash_attention.py::_flash_fwd_kernel, the
// Pallas TPU kernel of the LM substrate's chunked attention.  For q, k, v of
// shape (BH, S, D), row-major, float32 or bfloat16, it writes
//   o[b, i] = sum_j softmax_j(scale * q[b, i] . k[b, j]) v[b, j]
// over j <= i (causal) or all j < S, in the input dtype.  All math is
// float32, as in the TPU kernel: q and k are widened before the dot, p
// stays float32 for the product with v, and (m, l, acc) are float32.
//
// What bounds it: operations.  A (64-row q tile, 64-row kv tile) pair does
// 4 * 64 * 64 * D flops against 2 * 64 * D loaded values, so the card's
// arithmetic rate, not HBM, is the limit.  This first version runs on the
// fp32 SIMT pipe (67 TFLOP/s), not on the bf16 tensor cores (989 TFLOP/s):
// keeping p in float32 for p @ v, as the TPU kernel does, rules out a bf16
// MMA for that product.  Short of the SIMT rate, what limits it is the
// shared-memory traffic per FMA, so every operand is read as float4.
//
// Design:
//  * The TPU kernel walks kv blocks along a sequential grid axis with
//    (m, l, acc) in VMEM scratch.  Here one block of 256 threads owns one
//    64-row q tile of one (batch, head) and walks the kv tiles in a loop,
//    carrying (m, l, acc) in registers.  Blocks take q tiles in reverse
//    order so that the longest causal rows start first.
//  * Thread t owns the 4 q rows 4 * (t / 16) to 4 * (t / 16) + 3 and,
//    within each 64-column score tile, the columns t % 16 + 16 j; in the
//    output, the columns t % 16 + 16 j of D.  The 16
//    threads that share rows form one half-warp, so row max and row sum are
//    shuffles and p goes through shared memory with only __syncwarp.
//  * q is staged once as float32 (rows padded to D + 4 floats), k and v per
//    kv tile (v transposed, rows padded to 68 floats), so every inner-loop
//    read is a conflict-free or broadcast float4.
//  * Causal: kv tiles wholly above the diagonal are never loaded.  Any S is
//    taken with no padding copy: q and kv rows at or past S load as zeros,
//    kv columns past S are masked to -inf, and rows past S are not written.
//  * The guards of the TPU kernel: m_safe = 0 for a fully masked row,
//    corr = 0 while m is -inf, l floored at 1e-30 in the final division.
//
// Interface: a plain C function for ctypes.  It launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // q rows per block
constexpr int BK = 64;       // kv rows per tile
constexpr int THREADS = 256;
constexpr int RPT = 4;       // q rows per thread
constexpr int PAD = 4;       // floats of padding per shared-memory row
static_assert(THREADS == 16 * (BQ / RPT) && BK == 4 * 16, "thread layout");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, int S, int causal, float scale) {
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
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    sm.q[r * QS + d] = q0 + r < S ? to_f32(qb[(size_t)(q0 + r) * D + d]) : 0.f;
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
      sm.k[r * QS + d] = in ? to_f32(kb[g]) : 0.f;
      sm.vt[d * VS + r] = in ? to_f32(vb[g]) : 0.f;
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

  T* ob = o + base;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + r0 + i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < CJ; ++j) ob[(size_t)row * D + c + 16 * j] = from_f32<T>(acc[i][j] / den);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int BH, int S,
                   int causal, float scale, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<D>);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, BH);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, int BH, int S, int D,
                     int causal, float scale, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, BH, S, causal, scale, st);
    case 32: return launch<T, 32>(q, k, v, o, BH, S, causal, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, BH, S, causal, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, BH, S, causal, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o (BH, S, D) row-major on the device, all of one dtype:
// 0 = float32, 1 = bfloat16.  D: 16, 32, 64 or 128.  causal: 0 or 1.
// Returns a cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int BH, int S, int D, int dtype, int causal, float scale,
                                     void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (BH <= 0 || BH > 65535 || S <= 0 || (causal != 0 && causal != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (dtype == 0)
    e = launch_d<float>(q, k, v, o, BH, S, D, causal, scale, st);
  else if (dtype == 1)
    e = launch_d<__nv_bfloat16>(q, k, v, o, BH, S, D, causal, scale, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
