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
// operations: the bf16 tensor cores' rate.
//
// On the TPU the grid runs in order and each kernel carries its sum in VMEM
// scratch across a sequential grid axis; on the card blocks run in any
// order, so each block OWNS its output tile and loops over that axis
// itself. No atomics: the gradients are the same bits from run to run.
//
// dk/dv, bf16: `flash_bwd_dkdv_tc_kernel`, the tensor-core design (FA3's
// backward without its dq atomics):
// * one block per (kv head, 128-row kv tile, batch); two consumer
//   warpgroups own 64 kv rows each and keep K and V in shared memory for the
//   whole walk; a producer warp streams 64-row Q and dO tiles (TMA) with
//   their lse and delta rows through a 2-stage mbarrier ring, over the G
//   query heads of the kv head and their live q tiles;
// * s^T = K Q^T and dp^T = V dO^T are wgmma m64n64k16 with both operands in
//   shared memory, K-major; p^T = exp2(s^T scale log2e - lse log2e) and
//   ds^T = p^T (dp^T - delta) scale are computed in registers;
// * dv += p^T dO and dk += ds^T Q are wgmma m64n{hd}k16 with p^T and ds^T as
//   bf16 A operands from registers and dO, Q MN-major (the transpose bit).
//   Rounding p and ds to bf16 once misses FLASH_BWD_MAIN_BF16_TOL at
//   S = 4096 (measured on the CPU: ~1 element in 10^4 over it), so each is
//   split into hi + lo bf16 halves and multiplied twice: 6 products a tile
//   instead of 4, at f32-like accuracy;
// * setmaxnreg gives each consumer thread 240 registers (dk and dv are 128
//   f32 accumulators at hd 128) and the producer 24;
// * tiles that the causal mask or the window cover entirely are skipped;
//   the elementwise mask runs only on tiles that cross the diagonal, the
//   window's edge or a ragged end; rows past Sq and Skv read as TMA's zero
//   fill of 4-D maps over the (B, S, H, hd) strides.
//
// dk/dv, f32, and dq (both dtypes): `flash_bwd_dkdv_kernel` and
// `flash_bwd_dq_kernel`, plain f32 FMAs out of shared memory. f32 callers
// (the reduced models, whose card-equals-CPU checks hold 1e-4) need f32
// products, which TF32 tensor cores would not give; dq's redesign is queued.
// * dkdv: one block of 256 threads per (batch, kv head, 64-row kv tile); it
//   loads its k and v tile once, then walks the G query heads of that kv head
//   and, for each, the live 64-row q tiles, accumulating dk and dv in
//   registers and writing each once;
// * dq: one block per (batch, head, 64-row q tile); it loads q, do, lse and
//   delta once and walks the live kv tiles, accumulating dq in registers;
// * ragged tails of Sq and Skv are masked per row and column instead of
//   padded; every tensor is read in the model's (B, S, H, hd) layout through
//   strides, so there are no transpose or pad copies;
// * the scores and dp of a tile are computed together: each thread owns a
//   2 x 8 block of the 64 x 64 tile; p and ds go through shared memory (rows
//   padded by one float, as every f32 tile here, so column reads are free of
//   bank conflicts) into the products that accumulate the gradients.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

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

// ---- bf16 dk/dv: the tensor-core kernel -------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
namespace hw = repro::hopper;

constexpr int BKV = 128;                   // kv rows per block (two warpgroups of 64)
constexpr int BQT = 64;                    // q rows per streamed tile
constexpr int STAGES = 2;                  // Q/dO ring depth
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);
using hw::LOG2E;

struct Args {
  const float* lse; const float* delta;    // (B, H, Sq) f32
  bf16* dk; bf16* dv;
  int Sq, Skv, H, G, n_q;
  long long dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  int causal, window, q_offset;
  float sm_scale, scale_log2;              // scale_log2 = sm_scale * log2(e)
};

template <int HD>
struct Layout {
  static constexpr int SW = HD * 2 >= 128 ? 128 : 64;
  static constexpr int BOX = SW / 2;
  static constexpr int KV_BYTES = BKV * HD * 2;   // K, and V
  static constexpr int Q_BYTES = BQT * HD * 2;    // each stage's Q, and dO
  // K | V | Q[STAGES] | dO[STAGES] | lse[STAGES][BQT] | delta[STAGES][BQT] | barriers
  static constexpr int SMEM = 1024 + 2 * KV_BYTES + 2 * STAGES * Q_BYTES +
                              2 * STAGES * BQT * 4 + 8 * (1 + 2 * STAGES);
};

// Whether q rows [qlo, qlo + BQT) (absolute positions) see any of kv rows [klo, khi].
__device__ __forceinline__ bool live(const Args& a, int qlo, int klo, int khi) {
  if (a.causal && qlo + BQT - 1 < klo) return false;
  if (a.window && khi <= qlo - a.window) return false;
  return true;
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap mq,
                         const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv,
                         const __grid_constant__ CUtensorMap mdo, const Args a) {
  using L = Layout<HD>;
  constexpr int SW = L::SW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - hw::smem_u32(smem_raw) % 1024) % 1024);
  uint8_t* Ks = base;
  uint8_t* Vs = Ks + L::KV_BYTES;
  uint8_t* Qs = Vs + L::KV_BYTES;                        // stage s at Qs + s * Q_BYTES
  uint8_t* dOs = Qs + STAGES * L::Q_BYTES;
  float* lse_s = reinterpret_cast<float*>(dOs + STAGES * L::Q_BYTES);   // [STAGES][BQT]
  float* delta_s = lse_s + STAGES * BQT;
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(delta_s + STAGES * BQT);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + STAGES;

  const int kvh = blockIdx.x, b = blockIdx.z;
  const int k0 = blockIdx.y * BKV;                       // the longest causal columns first

  if (threadIdx.x == 0) {
    hw::mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&full[s], 32);                      // the producer warp's 32 lanes
      hw::mbar_init(&empty[s], CONSUMERS * 4);          // one arrival per consumer warp
    }
    hw::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS * 128) {
    // ---- producer warpgroup: its first warp streams (Q, dO, lse, delta) ----
    hw::regs_dealloc<24>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x < CONSUMERS * 128 + 32) {
      if (lane == 0) {
        hw::mbar_arrive_expect_tx(bar_kv, 2 * L::KV_BYTES);
        for (int c = 0; c < HD / L::BOX; ++c) {
          hw::tma_load_4d(Ks + c * BKV * SW, &mk, bar_kv, c * L::BOX, kvh, k0, b);
          hw::tma_load_4d(Vs + c * BKV * SW, &mv, bar_kv, c * L::BOX, kvh, k0, b);
        }
      }
      int stage = 0;
      uint32_t parity = 1;                               // the ring starts empty
      for (int g = 0; g < a.G; ++g) {
        const int h = kvh * a.G + g;
        for (int qt = 0; qt < a.n_q; ++qt) {
          const int q0 = qt * BQT;
          if (!live(a, a.q_offset + q0, k0, k0 + BKV - 1)) continue;
          hw::mbar_wait(&empty[stage], parity);
          for (int r = lane; r < BQT; r += 32) {
            const int row = q0 + r;
            const long long idx = ((long long)b * a.H + h) * a.Sq + row;
            lse_s[stage * BQT + r] = row < a.Sq ? a.lse[idx] * LOG2E : 0.f;
            delta_s[stage * BQT + r] = row < a.Sq ? a.delta[idx] : 0.f;
          }
          if (lane == 0) {
            hw::mbar_arrive_expect_tx(&full[stage], 2 * L::Q_BYTES);
            uint8_t* qd = Qs + stage * L::Q_BYTES;
            uint8_t* dd = dOs + stage * L::Q_BYTES;
            for (int c = 0; c < HD / L::BOX; ++c) {
              hw::tma_load_4d(qd + c * BQT * SW, &mq, &full[stage], c * L::BOX, h, q0, b);
              hw::tma_load_4d(dd + c * BQT * SW, &mdo, &full[stage], c * L::BOX, h, q0, b);
            }
          } else {
            hw::mbar_arrive(&full[stage]);
          }
          if (++stage == STAGES) { stage = 0; parity ^= 1; }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 kv rows each ----
    hw::regs_alloc<240>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int r0 = warp * 16 + lane / 4;                 // kv rows r0 and r0 + 8 of the 64
    const int cq = 2 * (lane % 4);                       // q columns cq, cq + 1 of each 8
    const int klo = k0 + wg * 64, khi = klo + 63;
    const uint8_t* k_wg = Ks + wg * 64 * SW;
    const uint8_t* v_wg = Vs + wg * 64 * SW;

    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;

    hw::mbar_wait(bar_kv, 0);
    int stage = 0;
    uint32_t parity = 0;
    for (int g = 0; g < a.G; ++g) {
      for (int qt = 0; qt < a.n_q; ++qt) {
        const int q0 = qt * BQT;
        const int qlo = a.q_offset + q0;
        if (!live(a, qlo, k0, k0 + BKV - 1)) continue;
        hw::mbar_wait(&full[stage], parity);
        if (live(a, qlo, klo, khi)) {
          const uint8_t* qd = Qs + stage * L::Q_BYTES;
          const uint8_t* dd = dOs + stage * L::Q_BYTES;
          const float* lse_t = lse_s + stage * BQT;
          const float* delta_t = delta_s + stage * BQT;
          float s[BQT / 2], dp[BQT / 2];
          hw::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {       // s^T = K Q^T
            const int col = (kk * 16 % L::BOX) * 2, box = kk * 16 / L::BOX;
            hw::wgmma_ss(s, hw::make_desc<SW>(k_wg + box * BKV * SW + col, 0, 8 * SW),
                         hw::make_desc<SW>(qd + box * BQT * SW + col, 0, 8 * SW), kk > 0);
          }
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {       // dp^T = V dO^T
            const int col = (kk * 16 % L::BOX) * 2, box = kk * 16 / L::BOX;
            hw::wgmma_ss(dp, hw::make_desc<SW>(v_wg + box * BKV * SW + col, 0, 8 * SW),
                         hw::make_desc<SW>(dd + box * BQT * SW + col, 0, 8 * SW), kk > 0);
          }
          hw::wgmma_commit();
          hw::wgmma_wait();
          hw::fence_regs(s);
          hw::fence_regs(dp);

          const bool edge = q0 + BQT > a.Sq || khi >= a.Skv || (a.causal && khi > qlo) ||
                            (a.window && qlo + BQT - 1 - klo >= a.window);
#pragma unroll
          for (int idx = 0; idx < BQT / 2; ++idx) {
            const int c = (idx / 4) * 8 + cq + idx % 2;  // q row within the tile
            float p = exp2f(s[idx] * a.scale_log2 - lse_t[c]);
            if (edge) {
              const int kp = klo + r0 + 8 * ((idx / 2) % 2);
              const int qp = qlo + c;
              bool ok = q0 + c < a.Sq && kp < a.Skv;
              if (a.causal) ok = ok && qp >= kp;
              if (a.window) ok = ok && qp - kp < a.window;
              p = ok ? p : 0.f;
            }
            s[idx] = p;
            dp[idx] = p * (dp[idx] - delta_t[c]) * a.sm_scale;
          }
          uint32_t p_hi[BQT / 16][4], p_lo[BQT / 16][4], ds_hi[BQT / 16][4], ds_lo[BQT / 16][4];
          hw::split_bf16(s, p_hi, p_lo);
          hw::split_bf16(dp, ds_hi, ds_lo);

          hw::fence_regs(dv);
          hw::fence_regs(dk);
          hw::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BQT / 16; ++kk) {      // dv += p^T dO, dk += ds^T Q
            const uint64_t d_do = hw::make_desc<SW>(dd + kk * 16 * SW, BQT * SW, 8 * SW);
            const uint64_t d_q = hw::make_desc<SW>(qd + kk * 16 * SW, BQT * SW, 8 * SW);
            hw::wgmma_rs_tb(dv, p_hi[kk], d_do, 1);
            hw::wgmma_rs_tb(dv, p_lo[kk], d_do, 1);
            hw::wgmma_rs_tb(dk, ds_hi[kk], d_q, 1);
            hw::wgmma_rs_tb(dk, ds_lo[kk], d_q, 1);
          }
          hw::wgmma_commit();
          hw::wgmma_wait();
          hw::fence_regs(dv);
          hw::fence_regs(dk);
        }
        __syncwarp();
        if (lane == 0) hw::mbar_arrive(&empty[stage]);
        if (++stage == STAGES) { stage = 0; parity ^= 1; }
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = klo + r0 + 8 * i;
      if (row >= a.Skv) continue;
      bf16* dkrow = a.dk + b * a.dk_sb + row * a.dk_ss + kvh * a.dk_sh;
      bf16* dvrow = a.dv + b * a.dv_sb + row * a.dv_ss + kvh * a.dv_sh;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<uint32_t*>(dkrow + 8 * n + cq) =
            hw::pack_bf16(dk[4 * n + 2 * i], dk[4 * n + 2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dvrow + 8 * n + cq) =
            hw::pack_bf16(dv[4 * n + 2 * i], dv[4 * n + 2 * i + 1]);
      }
    }
  }
}

template <int HD>
cudaError_t launch_dkdv(const BwdArgs& f, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err;
  if ((err = hw::make_map(&mq, f.q, f.B, f.Sq, f.H, HD, f.q_sb, f.q_ss, f.q_sh, BQT)) ||
      (err = hw::make_map(&mdo, f.dout, f.B, f.Sq, f.H, HD, f.do_sb, f.do_ss, f.do_sh, BQT)) ||
      (err = hw::make_map(&mk, f.k, f.B, f.Skv, f.KVH, HD, f.k_sb, f.k_ss, f.k_sh, BKV)) ||
      (err = hw::make_map(&mv, f.v, f.B, f.Skv, f.KVH, HD, f.v_sb, f.v_ss, f.v_sh, BKV)))
    return err;
  const Args a{f.lse, f.delta, static_cast<bf16*>(f.dk), static_cast<bf16*>(f.dv),
               f.Sq, f.Skv, f.H, f.H / f.KVH, (f.Sq + BQT - 1) / BQT,
               f.dk_sb, f.dk_ss, f.dk_sh, f.dv_sb, f.dv_ss, f.dv_sh,
               f.causal, f.window, f.q_offset, f.sm_scale, f.sm_scale * LOG2E};
  constexpr int smem = Layout<HD>::SMEM;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_tc_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(f.KVH, (f.Skv + BKV - 1) / BKV, f.B);
  flash_bwd_dkdv_tc_kernel<HD><<<grid, THREADS, smem, stream>>>(mq, mk, mv, mdo, a);
  return cudaGetLastError();
}

}  // namespace tc

template <typename T>
cudaError_t dispatch_dq(const BwdArgs& a, int hd, cudaStream_t s) {
  switch (hd) {
    case 32: return launch_dq<T, 32>(a, s);
    case 64: return launch_dq<T, 64>(a, s);
    case 128: return launch_dq<T, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// dk/dv by dtype: f32 on the FMA kernel, bf16 on the tensor-core kernel.
cudaError_t dispatch_dkdv(const BwdArgs& a, int dtype, int hd, cudaStream_t s) {
  const bool f32 = dtype == repro::kFloat32;
  switch (hd) {
    case 32: return f32 ? launch_dkdv<float, 32>(a, s) : tc::launch_dkdv<32>(a, s);
    case 64: return f32 ? launch_dkdv<float, 64>(a, s) : tc::launch_dkdv<64>(a, s);
    case 128: return f32 ? launch_dkdv<float, 128>(a, s) : tc::launch_dkdv<128>(a, s);
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
  if (dtype != repro::kFloat32 && dtype != repro::kBFloat16) return cudaErrorInvalidValue;
  if (dkdv) return dispatch_dkdv(a, dtype, hd, s);
  return dtype == repro::kFloat32 ? dispatch_dq<float>(a, hd, s)
                                  : dispatch_dq<__nv_bfloat16>(a, hd, s);
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
