// The float32 block of K3 (flash_attention.cu) and K3-bwd
// (flash_attention_bwd.cu): 3xTF32 products (csrc/tf32.cuh) on warpgroup
// MMAs fed by TMA, with the split done by a producer warpgroup.
//
// tf32 wgmma reads shared memory K-major only.  A product whose K runs
// along a matrix's rows (p v in the forward; p^T dO, ds^T q and ds k in the
// backward) therefore reads a transposed copy of the walked tile.  TMA
// cannot split or transpose, so TMA lands each walked tile raw in a ring
// of RAWS stages, and the producer warpgroup's 128 threads split it into
// hi and lo planes as stored (the K-major B of the scores) and hi and lo
// planes of the transpose (the K-major B of the products that sum over the
// walked rows), stored in kpos order.  Each stage of the plane ring is
// handed on in two parts under two full / empty pairs: the planes as
// stored once the consumers' scores have read the previous tile's, the
// transposed planes once their products have.  So the split overlaps the
// consumers' scores, softmax and products.  The owned rows (q; k, v or
// q, dO) are loaded once and split in place: hi where they landed, lo
// beside it.
//
// A kernel describes its block by a tiles struct T (FwdTiles in
// flash_attention.cu, F32Tiles in flash_attention_bwd.cu): panels A and B
// of the walked pair (a, b), the rows a block owns (BR), walked rows a tile
// (BT), the byte offsets of its planes, and which planes the producer
// writes (STORED_B, TRANS_A, TRANS_B; the planes as stored of a are always
// written).
//
// Layout as csrc/wgmma.cuh: a float32 matrix of D columns is panels of one
// swizzle row (32 floats, 16 at D = 16), each on a 1024-byte boundary.  A
// transposed plane holds D rows of BT k positions, panels of KW positions.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32.cuh"
#include "wgmma.cuh"

namespace tf32 {

constexpr int WG = 128;                // threads of a warpgroup
constexpr int SMEM_LIMIT = 232448;     // dynamic shared memory a block may take
// K3-bwd's setmaxnreg with two consumers: 56 x 128 + 2 x 224 x 128 =
// 168 x 384 (K3's forward gives its producer 72: FwdTiles)
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;

// a float32 matrix of D columns as panels of one swizzle row each
template <int D>
struct F32Panels {
  static constexpr int CW = D < 32 ? D : 32;  // floats of a panel row
  static constexpr int NP = D / CW;           // panels
  static constexpr int RB = 4 * CW;           // bytes of a panel row (64 or 128)
};

// the N of one accumulating wgmma into a sum of D columns; 32 at D >= 128,
// where dk/dv's registers spill: fewer spills than at 64, and 4% faster
// when measured (D = 128)
template <int D>
__host__ __device__ constexpr int f32_nw() {
  return D < 64 ? D : D >= 128 ? 32 : 64;
}

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
  for (int i = 0; i < 4; ++i) split_tf32(__float_as_uint(xs[i]), h[i], l[i]);
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                   __uint_as_float(l[3]));
  return make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                     __uint_as_float(h[3]));
}

// the producer warpgroup's split of one walked matrix of D columns (panels
// P): the raw tile at src (BT rows, TMA's layout) into hi and lo planes of
// the same layout (STORED) or of its transpose (D rows of BT k positions in
// kpos order, panels of KW); thread t of 128.  A warp takes 32 rows of one
// 16-byte column chunk (at BT < 32, BT rows of 32 / BT chunks), so at
// BT = 32 its reads and writes hit distinct banks.
template <typename T, typename P, bool STORED>
__device__ __forceinline__ void split_walked(const unsigned char* src, unsigned char* hi,
                                             unsigned char* lo, int t) {
  constexpr int D = P::NP * P::CW;
  constexpr int CHUNKS = T::BT * D / 4;
  static_assert(CHUNKS % WG == 0, "whole passes");
#pragma unroll
  for (int it = 0; it < CHUNKS / WG; ++it) {
    const int e = t + it * WG;
    const int r = e % T::BT, cc = e / T::BT;  // row, 4-column chunk
    const int off =
        (cc / (P::CW / 4)) * T::BT * P::RB + swz<P::RB>(r * P::RB + (cc % (P::CW / 4)) * 16);
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
        const int o = (kp / T::KW) * D * T::RBT + swz<T::RBT>(n * T::RBT + (kp % T::KW) * 4);
        *reinterpret_cast<float*>(hi + o) = hs[i];
        *reinterpret_cast<float*>(lo + o) = ls[i];
      }
    }
  }
}

// s (64 x BT) = 64 owned rows . tile^T to float32 grade over the K = D
// columns of panels P: lo.hi, hi.lo, hi.hi over every k-step, small terms
// first.  Descriptors: the owned hi and lo planes (BR rows) at the
// warpgroup's first row, the walked tile's hi and lo planes, all K-major.
// Started with wgmma.fence, left uncommitted.
template <typename P, int BR, int BT>
__device__ __forceinline__ void scores_tf32(float (&s)[BT / 2], uint64_t a_hi, uint64_t a_lo,
                                            uint64_t b_hi, uint64_t b_lo) {
  constexpr int KS = P::NP * P::CW / 8, RB = P::RB;
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
template <typename P, int BR, int BT>
__device__ __forceinline__ void scores_tf32_rs(float (&s)[BT / 2],
                                               const uint32_t (&a_hi)[P::NP * P::CW / 8][4],
                                               uint64_t a_lo, uint64_t b_hi, uint64_t b_lo) {
  constexpr int KS = P::NP * P::CW / 8, RB = P::RB;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wg::mma_ss_tf32<BT>(s, a_lo + wg::k_off<RB, BR>(kk), b_hi + wg::k_off<RB, BT>(kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) wg::mma_rs_tf32<BT>(s, a_hi[kk], b_lo + wg::k_off<RB, BT>(kk));
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) wg::mma_rs_tf32<BT>(s, a_hi[kk], b_hi + wg::k_off<RB, BT>(kk));
}

// the tf32 A fragments of 64 rows from r0 of an owned plane (BR rows of
// panels P, TMA's layout, at generic address `plane`), this warp's 16 of
// them: for k-step kk, a[kk] = (row g, column t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4)
template <typename P, int BR>
__device__ __forceinline__ void load_a_tf32(uint32_t (&a)[P::NP * P::CW / 8][4],
                                            const unsigned char* plane, int r0, int warp,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < P::NP * P::CW / 8; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int row = r0 + 16 * warp + g + 8 * (f & 1), col = 8 * kk + t + 4 * (f >> 1);
      a[kk][f] = *reinterpret_cast<const uint32_t*>(
          plane + (col / P::CW) * BR * P::RB + swz<P::RB>(row * P::RB + (col % P::CW) * 4));
    }
}

// acc (64 x D) (+)= x tile (64 x BT, the accumulator layout) . the walked
// tile (BT rows, D columns), read from its transposed hi and lo planes
// (descriptors bt_hi, bt_lo).  x is split into tf32 hi and lo A fragments
// (c0, c2, c1, c3 of each 8 columns: kpos's order); each NW-column
// product starts from zero and is folded into acc with one rounding:
// acc[i] = fold(acc[i], t, i), i the index in acc (its row is i / 2 % 2).
template <typename T, int D, int NW, typename Fold>
__device__ __forceinline__ void accumulate_tf32(float (&acc)[D / 2], const float (&x)[T::BT / 2],
                                                uint64_t bt_hi, uint64_t bt_lo, Fold fold) {
  constexpr int KS = T::BT / 8, KP = T::KW / 8;
  uint32_t hi[KS][4], lo[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int f = 0; f < 4; ++f)
      split_tf32(__float_as_uint(x[4 * j + (f == 1 ? 2 : f == 2 ? 1 : f)]), hi[j][f], lo[j][f]);
#pragma unroll
  for (int nc = 0; nc < D / NW; ++nc) {
    float t[NW / 2];
    const auto at = [&](int c) -> uint64_t {
      return ((c / KP) * D * T::RBT + nc * NW * T::RBT + (c % KP) * 32) >> 4;
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
    for (int i = 0; i < NW / 2; ++i) acc[nc * NW / 2 + i] = fold(acc[nc * NW / 2 + i], t[i], i);
  }
}

// the block's shared memory, 1024-aligned, and its barriers: raw[r] (TMA's
// arrival, one expect_tx); for each stage of the plane ring two full /
// empty pairs, one for the planes as stored (the scores read them) and one
// for the transposed planes (the products that sum over the walked rows
// read them): full (the producer's split, one arrival), empty (one arrival
// per consumer warp); own_raw (the owned rows' TMA), own (the owned rows
// split)
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
  // the (lse2, delta) pairs of walked tile i beside the plane ring (K3-bwd)
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

// The producer warpgroup.  Its first thread loads the owned rows (a, and b
// where T::OWN_B: q; k, v or q, dO) into the owned hi planes and keeps RAWS
// walked tiles in flight in the raw ring; the 128 threads split the owned
// rows in place (hi) and into the lo planes once, then each walked tile
// into a stage of the plane ring in two parts, each handed on under its
// own full / empty pair: the planes as stored (a, and b where T::STORED_B)
// with the tile's (lse2, delta) pairs where T::ROWS_RIDE, as soon as the
// consumers' scores are done with the previous tile's, then the transposed
// planes (a where T::TRANS_A, b where T::TRANS_B), once their products
// are.  Walked tile i covers rows (first + i) * BT.
template <typename T>
__device__ __forceinline__ void f32_producer(const F32Ring<T>& ring, const CUtensorMap* ma,
                                             const CUtensorMap* mb, const CUtensorMap* wa,
                                             const CUtensorMap* wb, const float2* rows,
                                             int own0, int first, int n, int bh, int S_pad) {
  using PA = typename T::A;
  using PB = typename T::B;
  constexpr int BT = T::BT;
  const int t = threadIdx.x;
  const auto load_walked = [&](int i) {
    const int r = i % T::RAWS, w0 = (first + i) * BT;
    const uint32_t bar = ring.raw + 8 * r, dst = ring.base + T::RAW0 + r * T::RAW;
    wg::mbar_expect_tx(bar, T::RAW + (T::ROWS_RIDE ? T::ROWS : 0));
    wg::load_rows_tma<PA, BT>(dst, wa, bar, w0, BT, bh);
    wg::load_rows_tma<PB, BT>(dst + T::TILE_A, wb, bar, w0, BT, bh);
    if constexpr (T::ROWS_RIDE)
      wg::bulk_load(ring.base + T::ROWS0 + r * T::ROWS, rows + (size_t)bh * S_pad + w0, T::ROWS,
                    bar);
  };
  if (t == 0) {
    wg::mbar_expect_tx(ring.own_raw, T::OWN_A + T::OWN_B);
    wg::load_rows_tma<PA, BT>(ring.base, ma, ring.own_raw, own0, T::BR, bh);
    if constexpr (T::OWN_B > 0)
      wg::load_rows_tma<PB, BT>(ring.base + 2 * T::OWN_A, mb, ring.own_raw, own0, T::BR, bh);
    for (int i = 0; i < T::RAWS && i < n; ++i) load_walked(i);
  }
  unsigned char* const p = ring.ptr;
  wg::mbar_wait(ring.own_raw, 0);
  // the owned rows: hi in place, lo beside it
  for (int m = 0; m < (T::OWN_B > 0 ? 2 : 1); ++m) {
    const int at = m ? 2 * T::OWN_A : 0, size = m ? T::OWN_B : T::OWN_A;
    for (int off = 16 * t; off < size; off += 16 * WG) {
      float4* x = reinterpret_cast<float4*>(p + at + off);
      float4 l;
      *x = split4(*x, l);
      *reinterpret_cast<float4*>(p + at + size + off) = l;
    }
  }
  wg::fence_proxy_async();
  wg::bar_sync<1, WG>();
  if (t == 0) wg::mbar_arrive(ring.own);

  for (int i = 0; i < n; ++i) {
    const int r = i % T::RAWS, s = i % T::STAGES, ph = ((i / T::STAGES) & 1) ^ 1;
    const unsigned char* raw = p + T::RAW0 + r * T::RAW;
    unsigned char* pl = p + T::PLANE0 + s * T::PLANES;
    wg::mbar_wait(ring.raw + 8 * r, (i / T::RAWS) & 1);
    wg::mbar_wait(ring.empty + 8 * s, ph);
    split_walked<T, PA, true>(raw, pl, pl + T::A_LO, t);
    if constexpr (T::STORED_B)
      split_walked<T, PB, true>(raw + T::TILE_A, pl + T::B_HI, pl + T::B_LO, t);
    if constexpr (T::ROWS_RIDE)
      if (t < BT / 2)
        reinterpret_cast<float4*>(ring.rows(i))[t] =
            reinterpret_cast<const float4*>(p + T::ROWS0 + r * T::ROWS)[t];
    wg::fence_proxy_async();
    wg::bar_sync<1, WG>();
    if (t == 0) wg::mbar_arrive(ring.full + 8 * s);
    wg::mbar_wait(ring.empty_t + 8 * s, ph);
    if constexpr (T::TRANS_A) split_walked<T, PA, false>(raw, pl + T::TA_HI, pl + T::TA_LO, t);
    if constexpr (T::TRANS_B)
      split_walked<T, PB, false>(raw + T::TILE_A, pl + T::TB_HI, pl + T::TB_LO, t);
    wg::fence_proxy_async();
    wg::bar_sync<1, WG>();  // the raw stage is read, the planes written
    if (t == 0) {
      wg::mbar_arrive(ring.full_t + 8 * s);
      if (i + T::RAWS < n) load_walked(i + T::RAWS);
    }
  }
}

}  // namespace tf32
