// Paged decode attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_paged_kernel` / `paged_attention` in
// src/repro/kernels/paged_attention/kernel.py: one decode token per lane
// attends over that lane's positions of a shared (P, page_size, KVH, hd)
// page pool, resolved through its row of the block table.
//
// What bounds it: every cached k and v byte of the live positions is read
// once for O(G * hd) operations per position (G = H / KVH query heads share
// one kv head), far under the card's ~295 operations per byte, so it is
// bound by memory bandwidth.
//
// Design (flash-decoding: split over positions, then merge):
// * a split kernel: one block of 128 threads per (segment, kv head, lane).
//   A segment is SEG = 128 consecutive positions of the lane (8 whole
//   pages at page 16), so a lane of 2048 tokens spreads over 16 blocks
//   instead of one and the grid fills the card even with 8 lanes. The
//   number of segments comes from block_table's width and the page size,
//   which the host knows: the host never reads seq_lens, so the call can be
//   captured in a CUDA graph. A block whose segment starts at or past its
//   lane's length writes an empty partial (m = -1e30, l = 0, acc = 0) and
//   exits;
// * the block reads the block_table entries of the pages its segment
//   touches once each (clamped into [0, P) as the reference clamps -1 to
//   0; a page larger than SEG, or one that does not divide it, is shared
//   by the segments it spans) and streams 16-row tiles of its k rows, then
//   of its v rows, through an 8-stage shared-memory ring of 16-byte
//   cp.async copies, so the next 7 tiles are in flight while the current
//   one is used. Rows past the lane's length are never read;
// * the G query heads of the kv head are served together, so each k and v
//   row is read once for all of them. All of a segment's scores stay in
//   shared memory, so its softmax is exact (one max, one sum, no online
//   rescaling). The products come in two variants, by element type:
//   `paged_split_tc_kernel` (bf16) on tensor cores with mma.sync, p as
//   hi + lo bf16 halves; `paged_split_fma_kernel` (f32) on FMAs, p in f32;
// * the block writes its partial (m, l, acc[G][hd]) in f32 to a workspace.
//   `paged_merge_kernel`, one block per (query head, kv head, lane) and one
//   thread per column, merges the live segments' partials in segment order
//   (no atomics: the same bits every run) and writes the output in q's
//   type. A dead lane (seq_len 0) has no live segment and writes exact
//   zeros; no block reads another lane's data.
// Head dims 32, 64, 128 and 256 (at 256 the ring is 64 KB in bf16, 128 KB
// in f32, and the group size at most 4).
//
// The int8 variants (`repro_paged_attention_int8`; no Pallas site: the
// reference's jnp gather path, src/repro/models/layers.py:629-638) attend
// over a pool of int8 codes with one scale per (row, kv head) in q's type:
// k = bf16 or f32 of (f32(code) * f32(scale)), as `_dequantize_kv` rounds
// it, then the same exact attention. They read about half a bf16 pool's
// bytes (1 byte an element, 2 or 4 a row's scale), so they are bound by
// memory bandwidth as well. Only the tile loader differs from the kernels
// above (the template argument KV = int8_t): the ring stages each row's
// codes with 16-byte cp.async copies (hd / 16 of them), the segment's
// scales are read once a segment with plain loads (a scale is 2 or 4 bytes
// and the next row's is KVH elements away: no 16-byte copy covers two)
// right after the ring's first copies are started, and each tile is then
// dequantized by all threads in one extra pass through shared memory into
// the same bf16 (swizzled for ldmatrix) or f32 tile the products read.
// That pass costs a block barrier a tile, but it leaves the products, the
// softmax and the merge the very code of the kernels above, so an int8
// call gives the bits the bf16 or f32 kernel gives on the pool dequantized
// by `_dequantize_kv` (converting while the fragments load would need a
// second copy of the products, and the FMA kernel's loads, to hold that).
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using repro::NEG_INF;
using repro::FULL_MASK;

constexpr int THREADS = 128;
constexpr int TILE = 16;     // positions per ring stage
constexpr int STAGES = 8;    // ring depth: 7 tiles in flight a block
constexpr int SPLIT = 8;     // threads sharing a position in the score phase
constexpr int SEG = 128;     // positions per segment (kernels/paged_attention/ref.py
                             // SEGMENT_POSITIONS)

struct PagedArgs {
  const void* q; const void* k; const void* v;
  const int* table; const int* lens; void* out;
  float* ws_acc; float* ws_m; float* ws_l;   // partials, (B, KVH, NS, G[, hd])
  int B, H, KVH, P, ps, nb, NS;
  float sm_scale;
  const void* ks; const void* vs;            // int8 pools: scales (P, ps, KVH, 1) in q's type
};

// The head of a split kernel's shared memory, for products in T over a pool
// of KV (T, or int8 codes): the ring of KV tiles, then for int8 the
// dequantized tile and the segment's k and v scales (f32). The kernel's
// scores, m and l, pages and rows (and the FMA kernel's q) follow.
template <typename T, typename KV, int HD>
struct SmemRing {
  static constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  static constexpr int RING = STAGES * TILE * HD * int(sizeof(KV));
  static constexpr int DEQ = Q8 ? TILE * HD * int(sizeof(T)) : 0;
  static constexpr int SCALES = Q8 ? 2 * SEG * 4 : 0;
  static constexpr int HEAD = RING + DEQ + SCALES;
};

template <typename KV, int HD, int G>
struct SmemFma {
  using R = SmemRing<float, KV, HD>;
  static constexpr int QP = HD / SPLIT + 4;   // padded q piece: conflict-free float4 reads
  static constexpr int BYTES = R::HEAD + 4 * (G * SPLIT * QP + G * SEG + 2 * G + 2 * SEG);
};

template <typename KV, int HD, int G>
struct SmemTc {
  using R = SmemRing<__nv_bfloat16, KV, HD>;
  static constexpr int BYTES = R::HEAD + 4 * (G * SEG + 2 * G + 2 * SEG);
};

// Shared by both split kernels (all threads of the block call them).

// The live positions of segment `seg` of lane b: below the lane's length and
// the table's reach (<= 0: none, and the block writes an empty partial).
__device__ __forceinline__ int segment_len(const PagedArgs& a, int b, int seg) {
  return min(min(a.lens[b], a.nb * a.ps) - seg * SEG, SEG);
}

// Reads the block_table entries of the pages that the n live positions of
// the segment touch (pages p0 .. (start + n - 1) / ps: at most SEG, all
// inside the row) once each, clamped, and writes each position's pool row
// to rowoff.
__device__ __forceinline__ void segment_rows(const PagedArgs& a, int b, int seg, int n,
                                             int* pages, int* rowoff) {
  const int start = seg * SEG;
  const int p0 = start / a.ps;
  const int* trow = a.table + (long long)b * a.nb + p0;
  for (int i = threadIdx.x; i <= (start + n - 1) / a.ps - p0; i += THREADS)
    pages[i] = min(max(trow[i], 0), a.P - 1);
  __syncthreads();
  for (int pos = threadIdx.x; pos < n; pos += THREADS)
    rowoff[pos] = pages[(start + pos) / a.ps - p0] * a.ps + (start + pos) % a.ps;
  __syncthreads();
}

// The partial of a segment with no live position: m = -1e30, l = 0, acc = 0.
template <int HD, int G>
__device__ __forceinline__ void empty_partial(const PagedArgs& a, long long part) {
  for (int i = threadIdx.x; i < G * HD; i += THREADS) a.ws_acc[part * G * HD + i] = 0.f;
  if (threadIdx.x < G) {
    a.ws_m[part * G + threadIdx.x] = NEG_INF;
    a.ws_l[part * G + threadIdx.x] = 0.f;
  }
}

// int8 pools: the k and v scales of the segment's n live positions, as f32,
// 0 past them (their codes land as zeros: 0 * 0 = +0, as a zero-filled row).
// Plain loads; they land before the loop's first block barrier.
template <typename T>
__device__ __forceinline__ void segment_scales(const PagedArgs& a, int kvh, int n,
                                               const int* rowoff, float* ksc, float* vsc) {
  const T* ks = static_cast<const T*>(a.ks);
  const T* vs = static_cast<const T*>(a.vs);
  for (int pos = threadIdx.x; pos < SEG; pos += THREADS) {
    const long long at = pos < n ? (long long)rowoff[pos] * a.KVH + kvh : 0;
    ksc[pos] = pos < n ? repro::to_float(ks[at]) : 0.f;
    vsc[pos] = pos < n ? repro::to_float(vs[at]) : 0.f;
  }
}

// int8 pools: start the 16-byte copies of a tile's codes (rows t0 .. t0 + 15
// of the segment, [TILE][HD] int8, zeros past the n live positions).
template <int HD>
__device__ __forceinline__ void load_codes(const int8_t* pool, long long row, int kvh,
                                           const int* rowoff, int t0, int n, int8_t* dst) {
  constexpr int CPR = HD / 16;                      // 16-byte copies a row
  for (int c = threadIdx.x; c < TILE * CPR; c += THREADS) {
    const int t = c / CPR, piece = c % CPR, pos = t0 + t;
    const bool live = pos < n;
    repro::cp_async16_zfill(dst + t * HD + piece * 16,
                            pool + (live ? (long long)rowoff[pos] * row : 0) + kvh * HD + piece * 16,
                            live);
  }
}

// int8 pools: code i of the 16 in `raw` times its scale, in f32: the value
// `_dequantize_kv` rounds once to q's type (i is a constant once unrolled).
__device__ __forceinline__ float dequant(const uint4& raw, int i, float scale) {
  const unsigned w = i < 4 ? raw.x : i < 8 ? raw.y : i < 12 ? raw.z : raw.w;
  return __fmul_rn(float(int(w << (24 - 8 * (i & 3))) >> 24), scale);
}

// int8 pools: a landed tile of codes, 16 at a time: `store(t, piece, raw,
// scale)` puts row t's columns 16 piece .. 16 piece + 15, dequantized, where
// the products read them.
template <int HD, typename Store>
__device__ __forceinline__ void dequant_tile(const int8_t* codes, const float* scale,
                                             Store store) {
  constexpr int CPR = HD / 16;
  for (int c = threadIdx.x; c < TILE * CPR; c += THREADS) {
    const int t = c / CPR, piece = c % CPR;
    store(t, piece, *reinterpret_cast<const uint4*>(codes + t * HD + piece * 16), scale[t]);
  }
}

// Every score of the segment is in sc[g][0, n): its exact softmax, one warp
// per head; p replaces the scores, ml gets each head's max and sum.
template <int G>
__device__ __forceinline__ void segment_softmax(float* sc, float* ml, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int g = warp; g < G; g += THREADS / 32) {
    float* s = sc + g * SEG;
    float mx = NEG_INF;
    for (int t = lane; t < n; t += 32) mx = fmaxf(mx, s[t]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, off));
    float sum = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float p = expf(s[t] - mx);
      s[t] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL_MASK, sum, off);
    if (lane == 0) {
      ml[g] = mx;
      ml[G + g] = sum;
    }
  }
  __syncthreads();
}

// The split kernel for f32, on FMAs. Scores: 8 threads share a position,
// each dotting hd/8 columns, joined by shuffles. In P.V a thread owns 8
// output columns of one query head over a subset of the tile's positions
// (every thread works whatever G and hd are); the subsets join in a fixed
// order. KV: the pool's element (float, or int8 codes).
template <int HD, int G, typename KV>
__global__ void __launch_bounds__(THREADS) paged_split_fma_kernel(PagedArgs a) {
  using T = float;
  using S = SmemFma<KV, HD, G>;
  using R = typename S::R;
  constexpr bool Q8 = R::Q8;
  constexpr int EPC = 16 / int(sizeof(T));          // elements per 16-byte copy
  constexpr int ROW_CHUNKS = HD / EPC;
  constexpr int PIECE = HD / SPLIT;                 // columns per thread in the score phase
  constexpr int DC = HD / 8;                        // 8-column chunks of a row
  constexpr int OWNERS = G * DC;                    // PV phase: (head, 8 columns) pairs
  constexpr int PSPLIT = THREADS / OWNERS;          // threads sharing an owner's positions
  static_assert(OWNERS <= THREADS, "every (head, 8 columns) pair needs a thread");
  extern __shared__ __align__(16) uint8_t smem[];
  KV* ring = reinterpret_cast<KV*>(smem);           // [STAGES][TILE][HD]
  T* deq = reinterpret_cast<T*>(smem + R::RING);    // int8: [TILE][HD], dequantized
  float* ksc = reinterpret_cast<float*>(smem + R::RING + R::DEQ);   // int8: [SEG] k scales
  float* vsc = ksc + SEG;                           // int8: [SEG] v scales
  float* qs = reinterpret_cast<float*>(smem + R::HEAD);   // [G][SPLIT][QP], scaled
  float* sc = qs + G * SPLIT * S::QP;               // [G][SEG]: scores, then p
  float* ml = sc + G * SEG;                         // [G] m, [G] l
  int* pages = reinterpret_cast<int*>(ml + 2 * G);  // [SEG] the pages the segment touches
  int* rowoff = pages + SEG;                        // [SEG] pool row of each position

  const int seg = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const long long part = ((long long)b * a.KVH + kvh) * a.NS + seg;
  float* wacc = a.ws_acc + part * G * HD;
  const int n = segment_len(a, b, seg);
  if (n <= 0) {
    empty_partial<HD, G>(a, part);
    return;
  }
  const T* qb = static_cast<const T*>(a.q) + ((long long)b * a.H + kvh * G) * HD;
  for (int i = tid; i < G * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    qs[(g * SPLIT + d / PIECE) * S::QP + d % PIECE] = repro::to_float(qb[i]) * a.sm_scale;
  }
  segment_rows(a, b, seg, n, pages, rowoff);

  const long long row = (long long)a.KVH * HD;     // elements between positions in a page
  const int nt = (n + TILE - 1) / TILE;             // tiles of k, then as many of v
  auto load_tile = [&](int item) {
    const int t0 = (item < nt ? item : item - nt) * TILE;
    KV* dst = ring + (item % STAGES) * TILE * HD;
    if constexpr (Q8) {
      load_codes<HD>(static_cast<const int8_t*>(item < nt ? a.k : a.v), row, kvh, rowoff, t0,
                     n, dst);
    } else {
      const T* pool = static_cast<const T*>(item < nt ? a.k : a.v);
      for (int c = tid; c < TILE * ROW_CHUNKS; c += THREADS) {
        const int t = c / ROW_CHUNKS, piece = c % ROW_CHUNKS, pos = t0 + t;
        if (pos < n) {
          const T* src = pool + (long long)rowoff[pos] * row + kvh * HD + piece * EPC;
          repro::cp_async16(dst + t * HD + piece * EPC, src);
        }
      }
    }
  };

  const int tpos = tid / SPLIT, tpart = tid % SPLIT;   // score phase: position, piece
  const int owner = tid % OWNERS, psub = tid / OWNERS;   // PV phase: positions psub mod PSPLIT
  const int dc = owner % DC, g_own = owner / DC;         // of 8 columns of one head
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < 2 * nt) load_tile(i);
    repro::cp_async_commit();
  }
  if constexpr (Q8) segment_scales<T>(a, kvh, n, rowoff, ksc, vsc);
  for (int item = 0; item < 2 * nt; ++item) {
    repro::cp_async_wait<STAGES - 2>();
    __syncthreads();   // `item` landed for every thread; the stage refilled below is free
    if (item + STAGES - 1 < 2 * nt) load_tile(item + STAGES - 1);
    repro::cp_async_commit();
    const T* tile;
    if constexpr (Q8) {                             // codes -> the f32 tile, rows as in the pool
      const int t0 = (item < nt ? item : item - nt) * TILE;
      dequant_tile<HD>(ring + (item % STAGES) * TILE * HD, (item < nt ? ksc : vsc) + t0,
                       [&](int t, int piece, const uint4& raw, float sc) {
                         float4* d = reinterpret_cast<float4*>(deq + t * HD + piece * 16);
#pragma unroll
                         for (int i = 0; i < 4; ++i)
                           d[i] = make_float4(dequant(raw, 4 * i, sc), dequant(raw, 4 * i + 1, sc),
                                              dequant(raw, 4 * i + 2, sc),
                                              dequant(raw, 4 * i + 3, sc));
                       });
      __syncthreads();
      tile = deq;
    } else {
      tile = ring + (item % STAGES) * TILE * HD;
    }
    if (item == nt) segment_softmax<G>(sc, ml, n);   // every score is in
    if (item < nt) {
      const int pos = item * TILE + tpos;
      float kf[PIECE];
      repro::load_f32<T, PIECE>(tile + tpos * HD + tpart * PIECE, kf);
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float* qg = qs + (g * SPLIT + tpart) * S::QP;
        float x = 0.f;
#pragma unroll
        for (int d = 0; d < PIECE; ++d) x = fmaf(qg[d], kf[d], x);
        s[g] = x;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int off = 1; off < SPLIT; off <<= 1) s[g] += __shfl_xor_sync(FULL_MASK, s[g], off);
      }
      if (tpart == 0 && pos < n) {
#pragma unroll
        for (int g = 0; g < G; ++g) sc[g * SEG + pos] = s[g];
      }
    } else {
      const int t0 = (item - nt) * TILE;
      const int nv = min(TILE, n - t0);
      const float* p = sc + g_own * SEG + t0;
      for (int t = psub; t < nv; t += PSPLIT) {
        float vf[8];
        repro::load_f32<T, 8>(tile + t * HD + dc * 8, vf);
        const float pt = p[t];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = fmaf(pt, vf[e], acc[e]);
      }
    }
  }
  repro::cp_async_wait<0>();

  if (PSPLIT > 1) {                                 // join the position subsets, in order
    __syncthreads();                                // the ring is free
    float* red = reinterpret_cast<float*>(smem);    // [PSPLIT][OWNERS][8]
#pragma unroll
    for (int e = 0; e < 8; ++e) red[(psub * OWNERS + owner) * 8 + e] = acc[e];
    __syncthreads();
    if (psub == 0) {
      for (int ps2 = 1; ps2 < PSPLIT; ++ps2) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += red[(ps2 * OWNERS + owner) * 8 + e];
      }
    }
  }
  if (psub == 0) {
    float4* dst = reinterpret_cast<float4*>(wacc + g_own * HD + dc * 8);
    dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
  if (tid < G) {
    a.ws_m[part * G + tid] = ml[tid];
    a.ws_l[part * G + tid] = ml[G + tid];
  }
}

// ---- bf16 on tensor cores: warp-level mma.sync m16n8k16, f32 accumulation --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}
// d += a (16 x 16, rows 8..15 zero: a1 = a3 = 0) . b (16 x 8)
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The split kernel for bf16 with its products on tensor cores: the same
// grid, segments, ring and softmax as paged_split_fma_kernel, but the tile's 16-
// byte chunks are XOR-swizzled so that ldmatrix reads them without bank
// conflicts, rows past the lane's length land as zeros, and
// * scores: warps 0 and 1 each take 8 of the tile's 16 positions: S = Q K^T
//   with Q (the G query heads, rows padded to 16 with zeros) as A fragments
//   held in registers for the whole segment, K from the tile by ldmatrix;
//   the scale is applied to the f32 result;
// * P.V: each warp owns HD / 4 output columns for all G heads: O += P V
//   with P as hi + lo bf16 halves (two products: p is not rounded once) and
//   V from the tile by a transposing ldmatrix; O stays in registers.
// KV: the pool's element (bf16, or int8 codes).
template <int HD, int G, typename KV>
__global__ void __launch_bounds__(THREADS) paged_split_tc_kernel(PagedArgs a) {
  using T = __nv_bfloat16;
  using R = typename SmemTc<KV, HD, G>::R;
  constexpr bool Q8 = R::Q8;
  constexpr int CPR = HD / 8;                       // 16-byte chunks of a row
  constexpr int SW_M = CPR < 8 ? CPR : 8, SW_R = CPR < 8 ? 8 / CPR : 1;
  constexpr int KSTEPS = HD / 16;
  constexpr int NTW = HD / 32;                      // 8-column output tiles per warp
  static_assert(G <= 8, "the query heads fill at most the 8 live rows of an m16 tile");
  extern __shared__ __align__(16) uint8_t smem[];
  KV* ring = reinterpret_cast<KV*>(smem);           // [STAGES][TILE][HD], bf16 chunks swizzled
  T* deq = reinterpret_cast<T*>(smem + R::RING);    // int8: [TILE][HD] dequantized, swizzled
  float* ksc = reinterpret_cast<float*>(smem + R::RING + R::DEQ);   // int8: [SEG] k scales
  float* vsc = ksc + SEG;                           // int8: [SEG] v scales
  float* sc = reinterpret_cast<float*>(smem + R::HEAD);   // [G][SEG]
  float* ml = sc + G * SEG;                         // [G] m, [G] l
  int* pages = reinterpret_cast<int*>(ml + 2 * G);  // [SEG]
  int* rowoff = pages + SEG;                        // [SEG]
  auto chunk_at = [](int row, int c) { return row * HD + 8 * (c ^ ((row / SW_R) % SW_M)); };

  const int seg = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long part = ((long long)b * a.KVH + kvh) * a.NS + seg;
  float* wacc = a.ws_acc + part * G * HD;
  const int n = segment_len(a, b, seg);
  if (n <= 0) {
    empty_partial<HD, G>(a, part);
    return;
  }
  segment_rows(a, b, seg, n, pages, rowoff);

  // Q as m16k16 A fragments: row g = lane / 4 (zero past G), columns 2 (lane % 4) (+8)
  const int gq = lane >> 2, cq = 2 * (lane & 3);
  uint32_t qa[KSTEPS][2];
  const T* qb = static_cast<const T*>(a.q) + ((long long)b * a.H + kvh * G + gq) * HD;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    qa[ks][0] = gq < G ? *reinterpret_cast<const uint32_t*>(qb + ks * 16 + cq) : 0u;
    qa[ks][1] = gq < G ? *reinterpret_cast<const uint32_t*>(qb + ks * 16 + 8 + cq) : 0u;
  }

  const long long row = (long long)a.KVH * HD;
  const int nt = (n + TILE - 1) / TILE;
  auto load_tile = [&](int item) {
    const int t0 = (item < nt ? item : item - nt) * TILE;
    KV* dst = ring + (item % STAGES) * TILE * HD;
    if constexpr (Q8) {
      load_codes<HD>(static_cast<const int8_t*>(item < nt ? a.k : a.v), row, kvh, rowoff, t0,
                     n, dst);
    } else {
      const T* pool = static_cast<const T*>(item < nt ? a.k : a.v);
      for (int c = tid; c < TILE * CPR; c += THREADS) {
        const int t = c / CPR, piece = c % CPR, pos = t0 + t;
        const bool live = pos < n;
        repro::cp_async16_zfill(dst + chunk_at(t, piece),
                                pool + (live ? (long long)rowoff[pos] * row : 0) + kvh * HD + piece * 8, live);
      }
    }
  };

  float o[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < 2 * nt) load_tile(i);
    repro::cp_async_commit();
  }
  if constexpr (Q8) segment_scales<T>(a, kvh, n, rowoff, ksc, vsc);
  for (int item = 0; item < 2 * nt; ++item) {
    repro::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (item + STAGES - 1 < 2 * nt) load_tile(item + STAGES - 1);
    repro::cp_async_commit();
    const T* tile;
    if constexpr (Q8) {                             // codes -> the bf16 tile, in ldmatrix's swizzle
      const int t0 = (item < nt ? item : item - nt) * TILE;
      dequant_tile<HD>(ring + (item % STAGES) * TILE * HD, (item < nt ? ksc : vsc) + t0,
                       [&](int t, int piece, const uint4& raw, float sc) {
                         uint32_t w[8];                 // bf16 pairs, each rounded once
#pragma unroll
                         for (int i = 0; i < 8; ++i)
                           w[i] = pack2(dequant(raw, 2 * i, sc), dequant(raw, 2 * i + 1, sc));
                         *reinterpret_cast<uint4*>(deq + chunk_at(t, 2 * piece)) =
                             make_uint4(w[0], w[1], w[2], w[3]);
                         *reinterpret_cast<uint4*>(deq + chunk_at(t, 2 * piece + 1)) =
                             make_uint4(w[4], w[5], w[6], w[7]);
                       });
      __syncthreads();
      tile = deq;
    } else {
      tile = ring + (item % STAGES) * TILE * HD;
    }
    if (item == nt) segment_softmax<G>(sc, ml, n);
    if (item < nt) {
      if (warp < 2) {                                 // positions 8 warp .. 8 warp + 7
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        const int r = 8 * warp + (lane & 7);
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ks += 2) {
          uint32_t kb[4];                             // B fragments of k-steps ks, ks + 1
          ldsm_x4(kb, tile + chunk_at(r, 2 * ks + (lane >> 3)));
          mma16816(d, qa[ks][0], qa[ks][1], kb[0], kb[1]);
          mma16816(d, qa[ks + 1][0], qa[ks + 1][1], kb[2], kb[3]);
        }
        const int pos = item * TILE + 8 * warp + cq;
        if (gq < G) {
          sc[gq * SEG + pos] = d[0] * a.sm_scale;
          sc[gq * SEG + pos + 1] = d[1] * a.sm_scale;
        }
      }
    } else {
      const int t0 = (item - nt) * TILE;
      const float* pg = sc + gq * SEG + t0;           // p of this thread's head (rows < G)
      float p4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = cq + (e & 1) + 8 * (e >> 1);
        p4[e] = gq < G && t0 + t < n ? pg[t] : 0.f;
      }
      const uint32_t h0 = pack2(p4[0], p4[1]), h2 = pack2(p4[2], p4[3]);
      const __nv_bfloat162 hb0 = *reinterpret_cast<const __nv_bfloat162*>(&h0);
      const __nv_bfloat162 hb2 = *reinterpret_cast<const __nv_bfloat162*>(&h2);
      const uint32_t l0 = pack2(p4[0] - __low2float(hb0), p4[1] - __high2float(hb0));
      const uint32_t l2 = pack2(p4[2] - __low2float(hb2), p4[3] - __high2float(hb2));
      const int r = lane & 15;                        // ldmatrix rows: positions 0..15
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        uint32_t vb[2];
        ldsm_x2_trans(vb, tile + chunk_at(r, warp * NTW + j));
        mma16816(o[j], h0, h2, vb[0], vb[1]);
        mma16816(o[j], l0, l2, vb[0], vb[1]);
      }
    }
  }
  repro::cp_async_wait<0>();

  if (gq < G) {
#pragma unroll
    for (int j = 0; j < NTW; ++j)
      *reinterpret_cast<float2*>(wacc + gq * HD + (warp * NTW + j) * 8 + cq) =
          make_float2(o[j][0], o[j][1]);
  }
  if (tid < G) {
    a.ws_m[part * G + tid] = ml[tid];
    a.ws_l[part * G + tid] = ml[G + tid];
  }
}

// out[b, kvh*G + g, :] from the live segments' partials, in segment order:
// one block per (query head of the group, kv head, lane), one thread per column.
template <typename T, int HD, int G>
__global__ void __launch_bounds__(HD) paged_merge_kernel(PagedArgs a) {
  const int g = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int live = (min(a.lens[b], a.nb * a.ps) + SEG - 1) / SEG;   // 0: a dead lane
  const long long part0 = ((long long)b * a.KVH + kvh) * a.NS;
  const float* m = a.ws_m + part0 * G + g;          // segment s at m[s * G]
  const float* l = a.ws_l + part0 * G + g;
  const float* acc = a.ws_acc + (part0 * G + g) * HD + d;   // segment s at acc[s * G * HD]
  float M = NEG_INF;
  for (int s = 0; s < live; ++s) M = fmaxf(M, m[s * G]);
  float L = 0.f, O = 0.f;
#pragma unroll 4
  for (int s = 0; s < live; ++s) {
    const float w = expf(m[s * G] - M);
    L = fmaf(l[s * G], w, L);
    O = fmaf(acc[(long long)s * G * HD], w, O);
  }
  T* ob = static_cast<T*>(a.out) + ((long long)b * a.H + kvh * G + g) * HD;
  ob[d] = repro::from_float<T>(O / fmaxf(L, 1e-37f));   // dead lane: 0 / 1e-37 = 0
}

// T: q's type; KV: the pool's (T, or int8 codes).
template <typename T, typename KV, int HD, int G>
cudaError_t launch(const PagedArgs& a, cudaStream_t stream) {
  const dim3 grid(a.NS, a.KVH, a.B);
  cudaError_t err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr int smem = SmemTc<KV, HD, G>::BYTES;
    err = cudaFuncSetAttribute(paged_split_tc_kernel<HD, G, KV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    paged_split_tc_kernel<HD, G, KV><<<grid, THREADS, smem, stream>>>(a);
  } else {
    constexpr int smem = SmemFma<KV, HD, G>::BYTES;
    err = cudaFuncSetAttribute(paged_split_fma_kernel<HD, G, KV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    paged_split_fma_kernel<HD, G, KV><<<grid, THREADS, smem, stream>>>(a);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  paged_merge_kernel<T, HD, G><<<dim3(G, a.KVH, a.B), HD, 0, stream>>>(a);
  return cudaGetLastError();
}

// Group sizes 1, 2, 4 and 8; at hd 256 up to 4 (the FMA kernel's P.V phase
// gives each (head, 8 columns) pair a thread of its 128).
template <typename T, typename KV, int HD>
cudaError_t dispatch_g(const PagedArgs& a, cudaStream_t stream) {
  switch (a.H / a.KVH) {
    case 1: return launch<T, KV, HD, 1>(a, stream);
    case 2: return launch<T, KV, HD, 2>(a, stream);
    case 4: return launch<T, KV, HD, 4>(a, stream);
    case 8:
      if constexpr (HD <= 128) return launch<T, KV, HD, 8>(a, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename KV>
cudaError_t dispatch_hd(const PagedArgs& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return dispatch_g<T, KV, 32>(a, stream);
    case 64: return dispatch_g<T, KV, 64>(a, stream);
    case 128: return dispatch_g<T, KV, 128>(a, stream);
    case 256: return dispatch_g<T, KV, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Both entry points: the shapes checked, the workspace cut, the variant
// picked by q's type (and the pool's: Q8 for int8 codes with scales).
template <bool Q8>
cudaError_t paged_entry(const void* q, const void* k, const void* v, const void* ks,
                        const void* vs, const void* block_table, const void* seq_lens, void* out,
                        void* workspace, int dtype, int B, int H, int KVH, int hd, int P,
                        int page_size, int max_blocks, int n_seg, float sm_scale, void* stream) {
  if (B == 0) return cudaSuccess;
  if (KVH <= 0 || H % KVH != 0 || P <= 0 || page_size <= 0 || max_blocks <= 0 ||
      (long long)max_blocks * page_size > (1 << 30) || B > 65535)
    return cudaErrorInvalidValue;
  const int NS = (max_blocks * page_size + SEG - 1) / SEG;
  if (n_seg != NS) return cudaErrorInvalidValue;
  const long long parts = (long long)B * KVH * NS * (H / KVH);
  float* ws = static_cast<float*>(workspace);
  PagedArgs a{q, k, v, static_cast<const int*>(block_table),
              static_cast<const int*>(seq_lens), out, ws, ws + parts * hd,
              ws + parts * hd + parts, B, H, KVH, P, page_size, max_blocks, NS,
              sm_scale, ks, vs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using KVF = typename std::conditional<Q8, int8_t, float>::type;
  using KVB = typename std::conditional<Q8, int8_t, __nv_bfloat16>::type;
  switch (dtype) {
    case repro::kFloat32: return dispatch_hd<float, KVF>(a, hd, s);
    case repro::kBFloat16: return dispatch_hd<__nv_bfloat16, KVB>(a, hd, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// workspace: f32, B * KVH * n_seg * G * (hd + 2), 16-byte aligned, where
// n_seg = ceil(max_blocks * page_size / 128) is the number of segments the
// caller sized it for (any other value is refused).
extern "C" int repro_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* seq_lens, void* out, void* workspace,
    int dtype, int B, int H, int KVH, int hd, int P, int page_size, int max_blocks,
    int n_seg, float sm_scale, void* stream) {
  return paged_entry<false>(q, k_pages, v_pages, nullptr, nullptr, block_table, seq_lens, out,
                            workspace, dtype, B, H, KVH, hd, P, page_size, max_blocks, n_seg,
                            sm_scale, stream);
}

// The int8 pool: k_codes and v_codes int8 (P, page_size, KVH, hd), 16-byte
// aligned; k_scale and v_scale (P, page_size, KVH, 1) in q's type (dtype);
// the rest as repro_paged_attention.
extern "C" int repro_paged_attention_int8(
    const void* q, const void* k_codes, const void* v_codes, const void* k_scale,
    const void* v_scale, const void* block_table, const void* seq_lens, void* out,
    void* workspace, int dtype, int B, int H, int KVH, int hd, int P, int page_size,
    int max_blocks, int n_seg, float sm_scale, void* stream) {
  return paged_entry<true>(q, k_codes, v_codes, k_scale, v_scale, block_table, seq_lens, out,
                           workspace, dtype, B, H, KVH, hd, P, page_size, max_blocks, n_seg,
                           sm_scale, stream);
}
