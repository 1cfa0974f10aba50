// Split-TF32 products on Hopper's tensor cores (mma.sync m16n8k8), shared
// by the f32 flash forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu).
//
// One TF32 product keeps 11 of an f32's 24 significant bits. Each f32
// operand x is split into hi = rna(x) and lo = rna(x - hi), rna being
// cvt.rna.tf32.f32 (round to nearest, ties away, on the low 13 bits; done
// here as an integer add of 0x1000 and a mask, which is the same
// function), and a . b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi into
// one f32 accumulator, the two small terms first: hi + lo holds x to 2^-22
// of |x|, and the dropped a_lo b_lo is ~2^-22 of |a b|.
//
// f32 tiles lie in shared memory as rows of HD floats with their 16-byte
// chunks XOR-swizzled by row % 8; both ways the products read them (an 8 x 4
// block along the row, and rows 2t, 2t + 1 down a column) hit 32 distinct
// banks. cp.async copies them, 16 bytes a thread, rows past the end as zero
// fill.
//
// An accumulator holds columns 2t, 2t + 1 of its 8, where an A fragment
// wants t, t + 4. A contraction does not care in which order it sums its k,
// so a product that takes an accumulator as its A operand (`frag_acc`) reads
// its B operand in the accumulator's order (`frag_krows`: tile rows 2t and
// 2t + 1 as k = t and t + 4): no shuffle, no shared-memory round trip.
//
// The tensor cores round their f32 accumulator toward zero, so a sum over
// many products drifts: each tile's share starts at zero and joins the
// running sum by an f32 add, rounded to nearest (`add`).
//
// The chunkwise mLSTM (mlstm.cu) takes them too, and `frag_trows` for an A
// operand read down a tile's columns.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace repro {
namespace tf32 {

constexpr int STAGES = 2;                  // streamed tiles in flight

// cvt.rna.tf32.f32, as bits: round the low 13 bits to nearest, ties away
__device__ __forceinline__ uint32_t rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna(x);
  lo = rna(x - __uint_as_float(hi));
}

// An A operand (16 x 8) as hi and lo halves
struct Frag { uint32_t hi[4], lo[4]; };

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a b in split TF32: the two small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const Frag& a, const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d, a.lo, bh[0], bh[1]);
  mma(d, a.hi, bl[0], bl[1]);
  mma(d, a.hi, bh[0], bh[1]);
}

// A tile's share of a sum into its running sum, rounded to nearest
// (the tensor cores' accumulator rounds toward zero: see the note above).
__device__ __forceinline__ void add(float (&d)[4], const float (&t)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// Lane (g, t) = (lane / 4, lane % 4) of the mma fragments, and its two
// swizzle terms: xa for an 8 x 4 block along a row (rows g, columns t), xb
// for rows 2t, 2t + 1 down a column g. Tile element (r, c) lies at
// r * HD + (c ^ 4 (r % 8)).
struct Lane {
  int g, t, xa, xb;
};
__device__ __forceinline__ Lane lane_of(int lane) {
  const int g = lane / 4, t = lane % 4;
  return Lane{g, t, t ^ (g << 2), g ^ (t << 3)};
}

// A operand: rows r0 .. r0 + 15 (r0 % 8 == 0), columns kc .. kc + 7 of tile X
template <int HD>
__device__ __forceinline__ Frag frag_rows(const float* X, int r0, int kc, const Lane& l) {
  const float* p0 = X + (r0 + l.g) * HD + (kc & ~31);
  const float* p1 = p0 + 8 * HD;
  const int c0 = (kc & 31) ^ l.xa, c1 = ((kc & 31) + 4) ^ l.xa;
  Frag f;
  split(p0[c0], f.hi[0], f.lo[0]);
  split(p1[c0], f.hi[1], f.lo[1]);
  split(p0[c1], f.hi[2], f.lo[2]);
  split(p1[c1], f.hi[3], f.lo[3]);
  return f;
}

// B operand (k x n = 8 x 8) with n along rows n0 .. n0 + 7 of tile Y and k
// along its columns kc .. kc + 7: Y's rows as they are (k in s = q k^T)
template <int HD>
__device__ __forceinline__ void frag_cols(const float* Y, int n0, int kc, const Lane& l,
                                          uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  const float* p = Y + (n0 + l.g) * HD + (kc & ~31);
  split(p[(kc & 31) ^ l.xa], bh[0], bl[0]);
  split(p[((kc & 31) + 4) ^ l.xa], bh[1], bl[1]);
}

// B operand with k along rows k0 + 2t, k0 + 2t + 1 of tile Y (k = t, t + 4:
// an accumulator's column order, see frag_acc) and n along its columns
// n0 .. n0 + 7 (k0 % 8 == n0 % 8 == 0)
template <int HD>
__device__ __forceinline__ void frag_krows(const float* Y, int k0, int n0, const Lane& l,
                                           uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  const float* p = Y + (k0 + 2 * l.t) * HD + (n0 & ~31);
  const int c = (n0 & 31) ^ l.xb;
  split(p[c], bh[0], bl[0]);
  split(p[HD + (c ^ 4)], bh[1], bl[1]);
}

// An accumulator block (16 x 8) as the A operand of the next product: the
// lane's columns 2t, 2t + 1 stand for k = t, t + 4
__device__ __forceinline__ Frag frag_acc(const float (&c)[4]) {
  Frag f;
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
  return f;
}

// A operand with m along columns m0 .. m0 + 15 of tile X and k along its
// rows k0 + 2t, k0 + 2t + 1 (k = t, t + 4: an accumulator's order, to pair
// with frag_krows), row k scaled by scale[k] first (k0 % 8 == m0 % 16 == 0):
// a transposed tile times a diagonal, with no transposed copy
template <int HD>
__device__ __forceinline__ Frag frag_trows(const float* X, const float* scale, int k0, int m0,
                                           const Lane& l) {
  const float* p = X + (k0 + 2 * l.t) * HD + (m0 & ~31);
  const int c = (m0 & 31) ^ l.xb;
  const float s0 = scale[k0 + 2 * l.t], s1 = scale[k0 + 2 * l.t + 1];
  Frag f;
  split(p[c] * s0, f.hi[0], f.lo[0]);
  split(p[c ^ 8] * s0, f.hi[1], f.lo[1]);
  split(p[HD + (c ^ 4)] * s1, f.hi[2], f.lo[2]);
  split(p[HD + (c ^ 12)] * s1, f.hi[3], f.lo[3]);
  return f;
}

// Rows [row0, row0 + ROWS) of a strided (S, HD) f32 slab into a swizzled
// tile, 16 bytes a copy; rows at or past `limit` land as zeros.
template <int HD, int ROWS, int NT>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          long long stride, int row0, int limit) {
  constexpr int CH = HD / 4;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool ok = row0 + r < limit;
    repro::cp_async16_zfill(dst + r * HD + 4 * (c ^ (r & 7)),
                            src + (ok ? (row0 + r) * stride + 4 * c : 0), ok);
  }
}

}  // namespace tf32
}  // namespace repro
