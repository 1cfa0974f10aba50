// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the two Pallas TPU kernels of `flash_attention_bwd` in
// src/repro/kernels/flash_attention/kernel_bwd.py: `_dkdv_kernel` (dk, dv
// per kv head, summed over its G query heads and every q tile) and
// `_dq_kernel` (dq summed over kv tiles). With delta = sum(do * o) per row
// (computed by the wrapper, as the JAX package computes it outside both
// kernels) and lse from the forward:
//
//     p  = exp(q k^T * scale - lse)        masked to 0
//     dv = p^T do        dp = do v^T       ds = p * (dp - delta) * scale
//     dk = ds^T q        dq = ds k
//
// What bounds it: at training shapes (S 4096, hd 128) both kernels do
// O(S^2 * hd) operations on O(S * hd) bytes, so they are bound by
// operations. This first version does them with plain f32 FMAs out of shared
// memory, like the forward (no tensor cores yet: wgmma and TMA are later
// work), so its ceiling is the card's f32 FMA rate.
//
// Design:
// * on the TPU the grid runs in order and each kernel carries its sum in
//   VMEM scratch across a sequential grid axis; on the card blocks run in any
//   order, so each block OWNS its output tile and loops over that axis itself.
//   No atomics: the gradients are the same bits from run to run;
// * dkdv: one block of 256 threads per (batch, kv head, 64-row kv tile); it
//   loads its k and v tile once, then walks the G query heads of that kv head
//   and, for each, the live 64-row q tiles, accumulating dk and dv in
//   registers and writing each once;
// * dq: one block per (batch, head, 64-row q tile); it loads q, do, lse and
//   delta once and walks the live kv tiles, accumulating dq in registers;
// * tiles that the causal mask or the window cover entirely are skipped, as
//   `_tile_live` skips them; the ragged tails of Sq and Skv are masked per row
//   and column instead of padded; every tensor is read in the model's
//   (B, S, H, hd) layout through strides, so there are no transpose or pad
//   copies;
// * the scores and dp of a tile are computed together: each thread owns a
//   2 x 8 block of the 64 x 64 tile; p and ds go through shared memory (rows
//   padded by one float, as every f32 tile here, so column reads are free of
//   bank conflicts) into the products that accumulate the gradients.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;         // q rows per tile
constexpr int BK = 64;         // kv rows per tile
constexpr int THREADS = 256;   // 32 row pairs x 8 column threads
constexpr int LDP = BK + 1;    // row stride of the p / ds tiles

struct BwdArgs {
  const void* q; const void* k; const void* v; const void* dout;
  const float* lse; const float* delta;          // (B, H, Sq) f32
  void* dq; void* dk; void* dv;
  int B, Sq, Skv, H, KVH;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
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

// lse and delta of rows [row0, row0 + BQ) of one (b, h); rows past Sq read 0.
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s, const BwdArgs& a,
                                          int b, int h, int row0) {
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const int row = row0 + r;
    const long long idx = ((long long)b * a.H + h) * a.Sq + row;
    lse_s[r] = row < a.Sq ? a.lse[idx] : 0.f;
    delta_s[r] = row < a.Sq ? a.delta[idx] : 0.f;
  }
}

__device__ __forceinline__ bool tile_live(const BwdArgs& a, int qpos0, int k0) {
  if (a.causal && qpos0 + BQ - 1 < k0) return false;
  if (a.window && k0 + BK - 1 <= qpos0 - a.window) return false;
  return true;
}

// p and ds of one (q tile, kv tile) pair into shared memory. Thread (ty, tx)
// computes rows 2ty, 2ty+1 and columns tx + 8j of s = q k^T and dp = do v^T.
template <int HD>
__device__ __forceinline__ void p_and_ds(float* Ps, float* dSs, const float* Qs,
                                         const float* dOs, const float* Ks, const float* Vs,
                                         const float* lse_s, const float* delta_s,
                                         const BwdArgs& a, int q0, int k0) {
  constexpr int LD = HD + 1;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  float s[2][8], dp[2][8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qa[2], da[2], kk[8], vv[8];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      qa[i] = Qs[(ty * 2 + i) * LD + d];
      da[i] = dOs[(ty * 2 + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      kk[j] = Ks[(tx + 8 * j) * LD + d];
      vv[j] = Vs[(tx + 8 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = fmaf(qa[i], kk[j], s[i][j]);
        dp[i][j] = fmaf(da[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty * 2 + i;
    const int qrow = q0 + r;
    const int qp = a.q_offset + qrow;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tx + 8 * j;
      const int kp = k0 + c;
      bool ok = qrow < a.Sq && kp < a.Skv;
      if (a.causal) ok = ok && qp >= kp;
      if (a.window) ok = ok && qp - kp < a.window;
      const float p = ok ? expf(s[i][j] * a.sm_scale - lse_s[r]) : 0.f;
      Ps[r * LDP + c] = p;
      dSs[r * LDP + c] = p * (dp[i][j] - delta_s[r]) * a.sm_scale;
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_kernel(BwdArgs a) {
  constexpr int LD = HD + 1;
  constexpr int DJ = HD / 8;           // gradient columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;                    // BK x LD
  float* Vs = Ks + BK * LD;            // BK x LD
  float* Qs = Vs + BK * LD;            // BQ x LD
  float* dOs = Qs + BQ * LD;           // BQ x LD
  float* Ps = dOs + BQ * LD;           // BQ x LDP
  float* dSs = Ps + BQ * LDP;          // BQ x LDP
  float* lse_s = dSs + BQ * LDP;       // BQ
  float* delta_s = lse_s + BQ;         // BQ

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KVH;
  const int k0 = kt * BK;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;  // kv rows 2ty, 2ty+1; cols tx + 8j

  load_tile<T, HD, BK>(Ks, static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh,
                       a.k_ss, k0, a.Skv);
  load_tile<T, HD, BK>(Vs, static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh,
                       a.v_ss, k0, a.Skv);

  float dk[2][DJ], dv[2][DJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int n_q = (a.Sq + BQ - 1) / BQ;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* db = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
    for (int qt = 0; qt < n_q; ++qt) {
      const int q0 = qt * BQ;
      if (!tile_live(a, a.q_offset + q0, k0)) continue;
      __syncthreads();                 // the previous tile's smem reads are done
      load_tile<T, HD, BQ>(Qs, qb, a.q_ss, q0, a.Sq);
      load_tile<T, HD, BQ>(dOs, db, a.do_ss, q0, a.Sq);
      load_rows(lse_s, delta_s, a, b, h, q0);
      __syncthreads();
      p_and_ds<HD>(Ps, dSs, Qs, dOs, Ks, Vs, lse_s, delta_s, a, q0, k0);
      __syncthreads();
      // dv[c] += sum_r p[r][c] do[r];  dk[c] += sum_r ds[r][c] q[r]
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pa[2], sa[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          pa[i] = Ps[r * LDP + ty * 2 + i];
          sa[i] = dSs[r * LDP + ty * 2 + i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float dov = dOs[r * LD + tx + 8 * j];
          const float qv = Qs[r * LD + tx + 8 * j];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            dv[i][j] = fmaf(pa[i], dov, dv[i][j]);
            dk[i][j] = fmaf(sa[i], qv, dk[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + ty * 2 + i;
    if (row >= a.Skv) continue;
    T* dkrow = static_cast<T*>(a.dk) + b * a.dk_sb + row * a.dk_ss + kvh * a.dk_sh;
    T* dvrow = static_cast<T*>(a.dv) + b * a.dv_sb + row * a.dv_ss + kvh * a.dv_sh;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dkrow[tx + 8 * j] = repro::from_float<T>(dk[i][j]);
      dvrow[tx + 8 * j] = repro::from_float<T>(dv[i][j]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(BwdArgs a) {
  constexpr int LD = HD + 1;
  constexpr int DJ = HD / 8;
  extern __shared__ float smem[];
  float* Qs = smem;                    // BQ x LD
  float* dOs = Qs + BQ * LD;           // BQ x LD
  float* Ks = dOs + BQ * LD;           // BK x LD
  float* Vs = Ks + BK * LD;            // BK x LD
  float* Ps = Vs + BK * LD;            // BQ x LDP
  float* dSs = Ps + BQ * LDP;          // BQ x LDP
  float* lse_s = dSs + BQ * LDP;       // BQ
  float* delta_s = lse_s + BQ;         // BQ

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KVH);
  const int q0 = qt * BQ;
  const int qpos0 = a.q_offset + q0;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;  // q rows 2ty, 2ty+1; cols tx + 8j

  load_tile<T, HD, BQ>(Qs, static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh,
                       a.q_ss, q0, a.Sq);
  load_tile<T, HD, BQ>(dOs, static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh,
                       a.do_ss, q0, a.Sq);
  load_rows(lse_s, delta_s, a, b, h, q0);
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  float dq[2][DJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[i][j] = 0.f;

  const int n_kv = (a.Skv + BK - 1) / BK;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    if (a.causal && qpos0 + BQ - 1 < k0) break;              // this and later tiles masked
    if (!tile_live(a, qpos0, k0)) continue;
    __syncthreads();
    load_tile<T, HD, BK>(Ks, kb, a.k_ss, k0, a.Skv);
    load_tile<T, HD, BK>(Vs, vb, a.v_ss, k0, a.Skv);
    __syncthreads();
    p_and_ds<HD>(Ps, dSs, Qs, dOs, Ks, Vs, lse_s, delta_s, a, q0, k0);
    __syncthreads();
    // dq[r] += sum_c ds[r][c] k[c]
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float sa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) sa[i] = dSs[(ty * 2 + i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kv = Ks[c * LD + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i) dq[i][j] = fmaf(sa[i], kv, dq[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + ty * 2 + i;
    if (row >= a.Sq) continue;
    T* dqrow = static_cast<T*>(a.dq) + b * a.dq_sb + row * a.dq_ss + h * a.dq_sh;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dqrow[tx + 8 * j] = repro::from_float<T>(dq[i][j]);
  }
}

template <int HD>
constexpr int smem_bytes() {
  return int(sizeof(float)) * ((BQ + BK) * 2 * (HD + 1) + 2 * BQ * LDP + 2 * BQ);
}

template <typename T, int HD>
cudaError_t launch_dkdv(const BwdArgs& a, cudaStream_t stream) {
  constexpr int smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Skv + BK - 1) / BK, a.KVH, a.B);
  flash_bwd_dkdv_kernel<T, HD><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dq(const BwdArgs& a, cudaStream_t stream) {
  constexpr int smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  flash_bwd_dq_kernel<T, HD><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const BwdArgs& a, int hd, bool dkdv, cudaStream_t s) {
  switch (hd) {
    case 32: return dkdv ? launch_dkdv<T, 32>(a, s) : launch_dq<T, 32>(a, s);
    case 64: return dkdv ? launch_dkdv<T, 64>(a, s) : launch_dq<T, 64>(a, s);
    case 128: return dkdv ? launch_dkdv<T, 128>(a, s) : launch_dq<T, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(bool dkdv, const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dq, void* dk, void* dv,
        int dtype, int B, int Sq, int Skv, int H, int KVH, int hd,
        const long long* st, int causal, int window, int q_offset, float sm_scale,
        void* stream) {
  if (B == 0 || Sq == 0 || Skv == 0 || H == 0) return cudaSuccess;
  if (KVH <= 0 || H % KVH != 0) return cudaErrorInvalidValue;
  BwdArgs a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
            dq, dk, dv, B, Sq, Skv, H, KVH,
            st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
            st[9], st[10], st[11], st[12], st[13], st[14], st[15], st[16], st[17],
            st[18], st[19], st[20],
            causal, window, q_offset, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32: return dispatch<float>(a, hd, dkdv, s);
    case repro::kBFloat16: return dispatch<__nv_bfloat16>(a, hd, dkdv, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// `strides`: 21 element strides (batch, seq, head) of q, k, v, do, dq, dk, dv.
extern "C" int repro_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    int dtype, int B, int Sq, int Skv, int H, int KVH, int hd, const long long* strides,
    int causal, int window, int q_offset, float sm_scale, void* stream) {
  return run(true, q, k, v, dout, lse, delta, nullptr, dk, dv, dtype, B, Sq, Skv, H, KVH, hd,
             strides, causal, window, q_offset, sm_scale, stream);
}

extern "C" int repro_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq,
    int dtype, int B, int Sq, int Skv, int H, int KVH, int hd, const long long* strides,
    int causal, int window, int q_offset, float sm_scale, void* stream) {
  return run(false, q, k, v, dout, lse, delta, dq, nullptr, nullptr, dtype, B, Sq, Skv, H, KVH,
             hd, strides, causal, window, q_offset, sm_scale, stream);
}
