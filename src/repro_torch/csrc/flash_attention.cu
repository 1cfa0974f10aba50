// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention/kernel.py: online-softmax attention with
// causal masking, a sliding window, a q offset and grouped-query attention,
// returning o (in the input type) and the f32 log-sum-exp per query row.
//
// What bounds it: at prefill shapes (S in the thousands, hd 128) the work is
// O(S^2 * hd) operations on O(S * hd) bytes, so it is bound by operations,
// not memory. This first version does them with plain f32 FMAs out of shared
// memory (no tensor cores yet: wgmma and TMA are later work), so its ceiling
// is the card's f32 FMA rate, not the bf16 tensor-core rate of the bound.
//
// Design:
// * one block of 128 threads per (batch, head, 64-row q tile); a loop inside
//   the block over 64-row kv tiles replaces the TPU's sequential grid axis;
// * q, k and v are read in the model's (B, S, H, hd) layout through strides,
//   converted to f32 once into shared memory (rows padded by one float so the
//   column reads are free of bank conflicts); no transpose or pad copies;
// * kv tiles that the causal mask or the window cover entirely are skipped;
//   the ragged tail of Skv is masked per column instead of padded;
// * each thread owns a 4 x 8 block of the score tile and a 4 x hd/8 block of
//   the output accumulator; row max and row sum reduce over the 8 threads of
//   a row with warp shuffles; p stays f32 for the PV product, as on the TPU
//   (whose v is already f32 there);
// * q tiles are issued last-first, so the longest causal rows start first.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::NEG_INF;
using repro::FULL_MASK;

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // kv rows per tile
constexpr int THREADS = 128;  // 16 row groups x 8 column threads

struct FlashArgs {
  const void* q; const void* k; const void* v; void* o; float* lse;
  int B, Sq, Skv, H, KVH;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int causal, window, q_offset;
  float sm_scale;
};

// ROWS x HD elements of rows [row0, row0 + ROWS) of a strided (S, hd) slab
// into f32 shared memory with row stride HD + 1; rows at or past `limit` are 0.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long row_stride, int row0, int limit) {
  constexpr int VEC = 16 / int(sizeof(T));
  constexpr int PER_ROW = HD / VEC;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    float vals[VEC];
    if (row0 + r < limit) {
      repro::load_f32<T, VEC>(src + (row0 + r) * row_stride + c, vals);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[r * (HD + 1) + c + e] = vals[e];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(FlashArgs a) {
  constexpr int LD = HD + 1;
  constexpr int LDP = BK + 1;
  constexpr int DJ = HD / 8;          // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                   // BQ x LD
  float* Ks = Qs + BQ * LD;           // BK x LD
  float* Vs = Ks + BK * LD;           // BK x LD
  float* Ps = Vs + BK * LD;           // BQ x LDP

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KVH);
  const int ty = threadIdx.x >> 3;    // rows ty*4 .. ty*4+3 of the tile
  const int tx = threadIdx.x & 7;     // columns tx + 8*j
  const int q0 = qt * BQ;
  const int qpos0 = a.q_offset + q0;  // absolute position of the tile's first row

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  load_tile<T, HD, BQ>(Qs, qb, a.q_ss, q0, a.Sq);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int n_kv = (a.Skv + BK - 1) / BK;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    if (a.causal && qpos0 + BQ - 1 < k0) break;             // this and later tiles masked
    if (a.window && k0 + BK - 1 <= qpos0 - a.window) continue;
    __syncthreads();                  // the previous tile's smem reads are done
    load_tile<T, HD, BK>(Ks, kb, a.k_ss, k0, a.Skv);
    load_tile<T, HD, BK>(Vs, vb, a.v_ss, k0, a.Skv);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[4], kk[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kk[j] = Ks[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qa[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = qpos0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = k0 + tx + 8 * j;
        bool ok = kp < a.Skv;
        if (a.causal) ok = ok && qp >= kp;
        if (a.window) ok = ok && qp - kp < a.window;
        s[i][j] = ok ? s[i][j] * a.sm_scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) rs += __shfl_xor_sync(FULL_MASK, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
#pragma unroll
      for (int j = 0; j < 8; ++j) Ps[(ty * 4 + i) * LDP + tx + 8 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * LD + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.Sq) continue;
    const float li = fmaxf(l[i], 1e-37f);
    T* orow = static_cast<T*>(a.o) + b * a.o_sb + row * a.o_ss + h * a.o_sh;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 8 * j] = repro::from_float<T>(acc[i][j] / li);
    if (tx == 0) a.lse[((long long)b * a.H + h) * a.Sq + row] = m[i] + logf(li);
  }
}

template <typename T, int HD>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  const int smem = int(sizeof(float)) * ((BQ + 2 * BK) * (HD + 1) + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const FlashArgs& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int B, int Sq, int Skv, int H, int KVH, int hd,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, int q_offset, float sm_scale, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return cudaSuccess;
  if (KVH <= 0 || H % KVH != 0) return cudaErrorInvalidValue;
  FlashArgs a{q, k, v, o, static_cast<float*>(lse), B, Sq, Skv, H, KVH,
              q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
              causal, window, q_offset, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32: return dispatch_hd<float>(a, hd, s);
    case repro::kBFloat16: return dispatch_hd<__nv_bfloat16>(a, hd, s);
    default: return cudaErrorInvalidValue;
  }
}
