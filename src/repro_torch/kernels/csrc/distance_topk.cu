// K1: fused distance + streaming top-k for Hopper (sm_90a), fp32 SIMT.
//
// Replaces src/repro/kernels/distance_topk.py::_distance_topk_kernel, the
// Pallas TPU kernel behind ops.distance_topk.  For each query row it returns
// the k_pad smallest scores over corpus rows < n_valid, ascending, padded
// with (inf, -1):
//   l2: ||x||^2 - 2 q.x   (the caller adds ||q||^2 back)
//   ip: -q.x               (cos is ip over rows the caller normalized)
//
// What bounds it: float32 operations.  Each (query, row) pair costs 2*D
// flops against 4*D bytes of a row that is shared by a whole tile of
// queries, so with more than a few queries per launch the card's fp32 rate
// (67 TFLOP/s without tensor cores) is the limit, not HBM.  Tensor cores are
// not used: TF32 rounds the inputs and breaks the parity contract with the
// reference (rtol = atol = 3e-4).  Short of that rate, what limits a SIMT
// kernel is the traffic from L2 into each SM: a block re-reads its corpus
// tile for every query tile, so the block takes TQ = 32 queries to do 8
// FMAs per byte it loads.
//
// Design:
//  * The TPU kernel carries its running top-k across a sequential grid axis.
//    Blocks here run in parallel and in no order, so each block owns a tile
//    of TQ queries and one contiguous chunk of corpus rows, walks that chunk
//    in tiles of TN = 128 rows with a loop, and writes a partial top-k_pad
//    list per (query, chunk).  Splitting N across blocks keeps the 132 SMs
//    busy when a routed batch has only a few hundred queries.  The second
//    kernel, merge_partials_kernel, merges the per-chunk lists.
//  * Scores: the x tile and the q tile are staged in shared memory one D
//    slice of TD = 32 columns at a time (x rows padded to 33 floats, q
//    columns to 36, so reads are conflict-free).  While a slice is being
//    used, each thread already holds its share of the next slice in
//    registers, so the global loads overlap the FMAs.  Each thread
//    accumulates 2 rows x 8 queries in registers with plain fp32 FMAs.
//    Scores go to shared memory only.
//  * Top-k: warp w owns queries 4w .. 4w+3.  Each query keeps a sorted
//    running list of k_pad (dist, id) pairs and a candidate buffer in shared
//    memory.  A tile score enters the buffer (by warp ballot) only if it
//    beats the query's current k-th best; a full buffer is sorted with a
//    bitonic network and merged into the running list (elementwise min
//    against the reversed buffer, then a bitonic merge).  Past the first few
//    tiles most scores cost one compare and one ballot per 32.
//  * n_valid is a runtime argument: rows >= n_valid are neither read nor
//    scored.  Queries past B are computed on zeros and never written.
//
// Interface: a plain C function for ctypes.  It launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TQ = 32;             // queries per block
constexpr int TN = 128;            // corpus rows per tile
constexpr int TD = 32;             // feature columns per shared-memory slice
constexpr int THREADS = 256;       // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int QPW = TQ / WARPS;    // queries per warp in the top-k phase
constexpr int XS_STRIDE = TD + 1;  // padded x row: conflict-free column reads
constexpr int QS_STRIDE = TQ + 4;  // padded q column, 16-byte aligned
constexpr int X_PER_THREAD = TN * TD / THREADS;
constexpr int Q_PER_THREAD = TQ * TD / THREADS;

static_assert(TD == 32, "one warp loads one 32-column row segment");
static_assert(THREADS == 4 * 64 && TN == 2 * 64 && TQ == 4 * 8,
              "thread t scores rows t%64 and t%64+64 for queries 8*(t/64) .. +7");

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

template <int K>
struct Smem {
  float xs[TN * XS_STRIDE];              // x tile, one D slice
  alignas(16) float qs[TD * QS_STRIDE];  // q tile, one D slice, [d][q]
  float tile[TQ * TN];                   // scores of the current tile
  float run_d[TQ * K];                   // running top-K per query, ascending
  int run_i[TQ * K];
  float buf_d[TQ * K];                   // candidates waiting to be merged
  int buf_i[TQ * K];
};

__device__ __forceinline__ void cmp_swap(float* d, int* id, int i, int j, bool asc) {
  float di = d[i], dj = d[j];
  if ((di > dj) == asc && di != dj) {
    d[i] = dj;
    d[j] = di;
    int t = id[i];
    id[i] = id[j];
    id[j] = t;
  }
}

// Ascending bitonic sort of K (dist, id) pairs by one warp.
template <int K>
__device__ void warp_sort(float* d, int* id, int lane) {
  for (int size = 2; size <= K; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < K / 2; t += 32) {
        int i = 2 * t - (t & (stride - 1));
        cmp_swap(d, id, i, i + stride, (i & size) == 0);
      }
      __syncwarp();
    }
  }
}

// run <- the K smallest of run U buf, ascending; both inputs ascending.
template <int K>
__device__ void warp_merge(float* rd, int* ri, const float* bd, const int* bi, int lane) {
  for (int i = lane; i < K; i += 32) {
    float b = bd[K - 1 - i];
    if (b < rd[i]) {
      rd[i] = b;
      ri[i] = bi[K - 1 - i];
    }
  }
  __syncwarp();
  // min(ascending, descending) is bitonic: one half-cleaner cascade sorts it
  for (int stride = K >> 1; stride > 0; stride >>= 1) {
    for (int t = lane; t < K / 2; t += 32) {
      int i = 2 * t - (t & (stride - 1));
      cmp_swap(rd, ri, i, i + stride, true);
    }
    __syncwarp();
  }
}

// Sort the first cnt buffered candidates and merge them into the running
// list; returns the new k-th best distance.
template <int K>
__device__ float warp_flush(float* rd, int* ri, float* bd, int* bi, int cnt, int lane) {
  __syncwarp();
  for (int i = cnt + lane; i < K; i += 32) {
    bd[i] = inf_f();
    bi[i] = -1;
  }
  __syncwarp();
  warp_sort<K>(bd, bi, lane);
  warp_merge<K>(rd, ri, bd, bi, lane);
  return rd[K - 1];
}

// This thread's share of one D slice: x rows of the tile, q rows of the block.
__device__ __forceinline__ void load_slice(const float* __restrict__ x, const float* __restrict__ q,
                                           int tile_start, int c_end, int d0, int D, int q0, int B,
                                           int tid, float (&xr)[X_PER_THREAD],
                                           float (&qr)[Q_PER_THREAD]) {
#pragma unroll
  for (int j = 0; j < X_PER_THREAD; ++j) {
    const int e = tid + j * THREADS;
    const int row = tile_start + e / TD, col = d0 + e % TD;
    xr[j] = (row < c_end && col < D) ? __ldg(x + (size_t)row * D + col) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < Q_PER_THREAD; ++j) {
    const int e = tid + j * THREADS;
    const int qrow = q0 + e / TD, col = d0 + e % TD;
    qr[j] = (qrow < B && col < D) ? __ldg(q + (size_t)qrow * D + col) : 0.f;
  }
}

template <int K>
__global__ void __launch_bounds__(THREADS, 2)
distance_topk_partial_kernel(const float* __restrict__ q, const float* __restrict__ x,
                             float* __restrict__ out_d, int* __restrict__ out_i,
                             int B, int D, int n_valid, int metric, int nsplit, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<K>& sm = *reinterpret_cast<Smem<K>*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int q0 = blockIdx.x * TQ;
  const int split = blockIdx.y;
  const int c_begin = split * chunk;
  const int c_end = min(c_begin + chunk, n_valid);

  for (int i = tid; i < TQ * K; i += THREADS) {
    sm.run_d[i] = inf_f();
    sm.run_i[i] = -1;
  }
  __syncthreads();
  float thresh[QPW];  // per query of this warp: k-th best so far (warp-uniform)
  int cnt[QPW];       // per query: buffered candidates (warp-uniform)
#pragma unroll
  for (int u = 0; u < QPW; ++u) {
    thresh[u] = inf_f();
    cnt[u] = 0;
  }

  const int rg = tid & 63;  // this thread scores rows rg and rg + 64
  const int qg = tid >> 6;  // ... for queries 8*qg .. 8*qg + 7
  float xr[X_PER_THREAD], qr[Q_PER_THREAD];
  if (c_begin < c_end) load_slice(x, q, c_begin, c_end, 0, D, q0, B, tid, xr, qr);

  for (int tile_start = c_begin; tile_start < c_end; tile_start += TN) {
    float acc[2][8];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[a][j] = 0.f;
    float nrm[2] = {0.f, 0.f};
    for (int d0 = 0; d0 < D; d0 += TD) {
      __syncthreads();  // every warp is done with the previous slice / tile
#pragma unroll
      for (int j = 0; j < X_PER_THREAD; ++j) {
        const int e = tid + j * THREADS;
        sm.xs[(e / TD) * XS_STRIDE + e % TD] = xr[j];
      }
#pragma unroll
      for (int j = 0; j < Q_PER_THREAD; ++j) {
        const int e = tid + j * THREADS;
        sm.qs[(e % TD) * QS_STRIDE + e / TD] = qr[j];
      }
      __syncthreads();
      // prefetch the next slice (or the next tile's first) while this one runs
      if (d0 + TD < D)
        load_slice(x, q, tile_start, c_end, d0 + TD, D, q0, B, tid, xr, qr);
      else if (tile_start + TN < c_end)
        load_slice(x, q, tile_start + TN, c_end, 0, D, q0, B, tid, xr, qr);
#pragma unroll 8
      for (int c = 0; c < TD; ++c) {
        const float xa = sm.xs[rg * XS_STRIDE + c];
        const float xb = sm.xs[(rg + 64) * XS_STRIDE + c];
        const float4 qv0 = *reinterpret_cast<const float4*>(sm.qs + c * QS_STRIDE + qg * 8);
        const float4 qv1 = *reinterpret_cast<const float4*>(sm.qs + c * QS_STRIDE + qg * 8 + 4);
        const float qv[8] = {qv0.x, qv0.y, qv0.z, qv0.w, qv1.x, qv1.y, qv1.z, qv1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[0][j] = fmaf(qv[j], xa, acc[0][j]);
          acc[1][j] = fmaf(qv[j], xb, acc[1][j]);
        }
        nrm[0] = fmaf(xa, xa, nrm[0]);
        nrm[1] = fmaf(xb, xb, nrm[1]);
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = rg + a * 64;
      const bool valid = tile_start + r < c_end;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float s = metric == 0 ? nrm[a] - 2.f * acc[a][j] : -acc[a][j];
        sm.tile[(qg * 8 + j) * TN + r] = valid ? s : inf_f();
      }
    }
    __syncthreads();

    // warp w: admit this tile's scores for its queries that beat the k-th best
#pragma unroll
    for (int u = 0; u < QPW; ++u) {
      const int qi = w * QPW + u;
      float* rd = sm.run_d + qi * K;
      int* ri = sm.run_i + qi * K;
      float* bd = sm.buf_d + qi * K;
      int* bi = sm.buf_i + qi * K;
      const float* trow = sm.tile + qi * TN;
      for (int j = 0; j < TN / 32; ++j) {
        const int r = j * 32 + lane;
        const float s = trow[r];
        bool take = s < thresh[u];
        unsigned m = __ballot_sync(0xffffffffu, take);
        if (m == 0) continue;
        if (cnt[u] + __popc(m) > K) {
          thresh[u] = warp_flush<K>(rd, ri, bd, bi, cnt[u], lane);
          cnt[u] = 0;
          take = s < thresh[u];
          m = __ballot_sync(0xffffffffu, take);
        }
        if (take) {
          const int pos = cnt[u] + __popc(m & ((1u << lane) - 1u));
          bd[pos] = s;
          bi[pos] = tile_start + r;
        }
        cnt[u] += __popc(m);
      }
    }
    // the next tile rewrites sm.tile only after the __syncthreads that opens
    // its first D slice, which every warp reaches after finishing this loop
  }

#pragma unroll
  for (int u = 0; u < QPW; ++u) {
    const int qi = w * QPW + u;
    float* rd = sm.run_d + qi * K;
    int* ri = sm.run_i + qi * K;
    if (cnt[u] > 0) warp_flush<K>(rd, ri, sm.buf_d + qi * K, sm.buf_i + qi * K, cnt[u], lane);
    __syncwarp();
    const int b = q0 + qi;
    if (b < B) {
      const size_t base = ((size_t)b * nsplit + split) * K;
      for (int i = lane; i < K; i += 32) {
        out_d[base + i] = rd[i];
        out_i[base + i] = ri[i];
      }
    }
  }
}

// Merge nsplit ascending top-K lists per query into one.  Warp w owns
// query blockIdx.x * WARPS + w.
template <int K>
__global__ void __launch_bounds__(THREADS)
merge_partials_kernel(const float* __restrict__ pd, const int* __restrict__ pi,
                      float* __restrict__ out_d, int* __restrict__ out_i, int B, int nsplit) {
  __shared__ float rd_s[WARPS][K];
  __shared__ int ri_s[WARPS][K];
  __shared__ float bd_s[WARPS][K];
  __shared__ int bi_s[WARPS][K];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + w;
  if (b >= B) return;  // only warp-level barriers below
  float* rd = rd_s[w];
  int* ri = ri_s[w];
  float* bd = bd_s[w];
  int* bi = bi_s[w];
  const float* src_d = pd + (size_t)b * nsplit * K;
  const int* src_i = pi + (size_t)b * nsplit * K;
  for (int i = lane; i < K; i += 32) {
    rd[i] = src_d[i];
    ri[i] = src_i[i];
  }
  __syncwarp();
  for (int s = 1; s < nsplit; ++s) {
    if (!(src_d[(size_t)s * K] < rd[K - 1])) continue;  // cannot improve
    for (int i = lane; i < K; i += 32) {
      bd[i] = src_d[(size_t)s * K + i];
      bi[i] = src_i[(size_t)s * K + i];
    }
    __syncwarp();
    warp_merge<K>(rd, ri, bd, bi, lane);
  }
  for (int i = lane; i < K; i += 32) {
    out_d[(size_t)b * K + i] = rd[i];
    out_i[(size_t)b * K + i] = ri[i];
  }
}

template <int K>
cudaError_t launch(const float* q, const float* x, float* part_d, int* part_i, float* out_d,
                   int* out_i, int B, int D, int n_valid, int metric, int nsplit, int chunk,
                   cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<K>);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(distance_topk_partial_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((B + TQ - 1) / TQ, nsplit);
  const bool direct = nsplit == 1;  // one chunk: its partial list is the answer
  distance_topk_partial_kernel<K><<<grid, THREADS, smem, stream>>>(
      q, x, direct ? out_d : part_d, direct ? out_i : part_i, B, D, n_valid, metric, nsplit,
      chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || direct) return e;
  merge_partials_kernel<K><<<(B + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
      part_d, part_i, out_d, out_i, B, nsplit);
  return cudaGetLastError();
}

}  // namespace

// q (B, D) and x (N, D) float32 row-major on the device; out_d/out_i (B,
// k_pad); part_d/part_i (B, nsplit, k_pad) scratch, unused when nsplit == 1.
// Corpus chunk s covers rows [s * chunk, min((s + 1) * chunk, n_valid)).
// metric: 0 = l2, 1 = ip.  Returns a cudaError_t.
extern "C" int repro_distance_topk(const float* q, const float* x, float* part_d, int* part_i,
                                   float* out_d, int* out_i, int B, int D, int n_valid,
                                   int k_pad, int metric, int nsplit, int chunk, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (B <= 0 || D <= 0 || n_valid <= 0 || nsplit <= 0 || chunk <= 0 || nsplit > 65535 ||
      (metric != 0 && metric != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (k_pad == 128)
    e = launch<128>(q, x, part_d, part_i, out_d, out_i, B, D, n_valid, metric, nsplit, chunk, st);
  else if (k_pad == 256)
    e = launch<256>(q, x, part_d, part_i, out_d, out_i, B, D, n_valid, metric, nsplit, chunk, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
