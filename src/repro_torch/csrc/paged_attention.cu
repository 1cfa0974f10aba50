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
// Design:
// * one block of 8 warps per (kv head, lane): the G query heads of a kv
//   head are served together, so each k/v row is read once for all of them;
// * the block walks positions [0, seq_len) in chunks of 16, chunk c taken by
//   warp c % 8 (each warp keeps its own online-softmax state; the 8 states
//   merge at the end). Two threads share a position in the score phase,
//   each dotting half of hd with 16-byte loads; in the PV phase each thread
//   owns hd/32 output columns, so a v row is one coalesced warp read. A
//   chunk's 16 v rows are loaded before its scores are computed, so every
//   load of a chunk can be in flight at once;
// * the block reads block_table[b, pos / page_size] itself, only for
//   positions below seq_len, so entries past the live range (-1) are never
//   read; an entry is clamped into [0, P) as the reference clamps -1 to 0;
// * a dead lane (seq_len 0) runs no chunk and finalizes to exact zeros;
//   no block reads another lane's state.
// With 8 lanes x 8 kv heads the grid has 64 blocks for 132 SMs: splitting
// each lane's positions over several blocks (flash-decoding) is where the
// next gain is, for few lanes with long contexts.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::NEG_INF;
using repro::FULL_MASK;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CHUNK = 16;   // positions per warp iteration: two threads each

struct PagedArgs {
  const void* q; const void* k; const void* v;
  const int* table; const int* lens; void* out;
  int B, H, KVH, P, ps, nb;
  float sm_scale;
};

template <typename T, int HD, int G>
__global__ void __launch_bounds__(THREADS) paged_kernel(PagedArgs a) {
  constexpr int HALF = HD / 2;   // dims per thread in the score phase
  constexpr int DPL = HD / 32;   // output dims per thread in the PV phase
  __shared__ float qs[G][HD];
  __shared__ float sm_m[WARPS][G], sm_l[WARPS][G];
  __shared__ float sm_acc[WARPS][G][HD];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qb = static_cast<const T*>(a.q) + ((long long)b * a.H + kvh * G) * HD;
  for (int i = threadIdx.x; i < G * HD; i += THREADS) qs[i / HD][i % HD] = repro::to_float(qb[i]);
  __syncthreads();

  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  const int* table = a.table + (long long)b * a.nb;
  const long long row = (long long)a.KVH * HD;   // elements between positions in a page
  const int len = a.lens[b];
  const int t = lane >> 1, half = lane & 1;

  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[g][d] = 0.f;
  }

  const int n_chunks = (len + CHUNK - 1) / CHUNK;
  for (int ch = warp; ch < n_chunks; ch += WARPS) {
    // issue the chunk's v loads first, so their latency can overlap the k
    // loads and the score math
    const int n_valid = min(CHUNK, len - ch * CHUNK);
    float vf[CHUNK][DPL];
#pragma unroll
    for (int tt = 0; tt < CHUNK; ++tt) {
      if (tt < n_valid) {
        const int pos2 = ch * CHUNK + tt;
        const int page = min(max(table[pos2 / a.ps], 0), a.P - 1);
        repro::load_f32<T, DPL>(
            vp + ((long long)page * a.ps + pos2 % a.ps) * row + kvh * HD + lane * DPL, vf[tt]);
      } else {
#pragma unroll
        for (int d = 0; d < DPL; ++d) vf[tt][d] = 0.f;
      }
    }
    const int pos = ch * CHUNK + t;
    const bool valid = pos < len;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (valid) {
      const int page = min(max(table[pos / a.ps], 0), a.P - 1);
      float kf[HALF];
      repro::load_f32<T, HALF>(
          kp + ((long long)page * a.ps + pos % a.ps) * row + kvh * HD + half * HALF, kf);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int d = 0; d < HALF; ++d) s[g] = fmaf(qs[g][half * HALF + d], kf[d], s[g]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      s[g] += __shfl_xor_sync(FULL_MASK, s[g], 1);   // join the two halves of hd
      s[g] = valid ? s[g] * a.sm_scale : NEG_INF;
      // both threads of a position hold s: reduce over the 16 positions
      float mx = s[g];
#pragma unroll
      for (int off = 2; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, off));
      const float m_new = fmaxf(m[g], mx);
      const float corr = expf(m[g] - m_new);
      s[g] = expf(s[g] - m_new);
      float rs = s[g];
#pragma unroll
      for (int off = 2; off < 32; off <<= 1) rs += __shfl_xor_sync(FULL_MASK, rs, off);
      l[g] = l[g] * corr + rs;
      m[g] = m_new;
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[g][d] *= corr;
    }
    // masked positions have p == 0 and v == 0
#pragma unroll
    for (int tt = 0; tt < CHUNK; ++tt) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = __shfl_sync(FULL_MASK, s[g], 2 * tt);
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[g][d] = fmaf(p, vf[tt][d], acc[g][d]);
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int d = 0; d < DPL; ++d) sm_acc[warp][g][lane * DPL + d] = acc[g][d];
  __syncthreads();

  T* ob = static_cast<T*>(a.out) + ((long long)b * a.H + kvh * G) * HD;
  for (int i = threadIdx.x; i < G * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float sc = expf(sm_m[w][g] - M);   // 1 for every warp of a dead lane
      L += sm_l[w][g] * sc;
      O += sm_acc[w][g][d] * sc;
    }
    ob[i] = repro::from_float<T>(O / fmaxf(L, 1e-37f));   // dead lane: 0 / 1e-37 = 0
  }
}

template <typename T, int HD, int G>
cudaError_t launch(const PagedArgs& a, cudaStream_t stream) {
  paged_kernel<T, HD, G><<<dim3(a.KVH, a.B), THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_g(const PagedArgs& a, cudaStream_t stream) {
  switch (a.H / a.KVH) {
    case 1: return launch<T, HD, 1>(a, stream);
    case 2: return launch<T, HD, 2>(a, stream);
    case 4: return launch<T, HD, 4>(a, stream);
    case 8: return launch<T, HD, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_hd(const PagedArgs& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return dispatch_g<T, 32>(a, stream);
    case 64: return dispatch_g<T, 64>(a, stream);
    case 128: return dispatch_g<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int repro_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* seq_lens, void* out,
    int dtype, int B, int H, int KVH, int hd, int P, int page_size, int max_blocks,
    float sm_scale, void* stream) {
  if (B == 0) return cudaSuccess;
  if (KVH <= 0 || H % KVH != 0 || P <= 0 || page_size <= 0) return cudaErrorInvalidValue;
  PagedArgs a{q, k_pages, v_pages, static_cast<const int*>(block_table),
              static_cast<const int*>(seq_lens), out, B, H, KVH, P, page_size, max_blocks,
              sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32: return dispatch_hd<float>(a, hd, s);
    case repro::kBFloat16: return dispatch_hd<__nv_bfloat16>(a, hd, s);
    default: return cudaErrorInvalidValue;
  }
}
