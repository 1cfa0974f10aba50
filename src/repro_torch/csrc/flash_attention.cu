// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention/kernel.py: online-softmax attention with
// causal masking, a sliding window, a q offset and grouped-query attention,
// returning o (in the input type) and the f32 log-sum-exp per query row.
//
// What bounds it: at prefill shapes (S in the thousands, hd 128) the work is
// O(S^2 * hd) operations on O(S * hd) bytes, so it is bound by operations:
// the bf16 tensor cores' rate.
//
// Two kernels, chosen by the element type (a dispatch by dtype, not a
// fallback: each dtype has exactly one kernel):
//
// * bf16, `flash_fwd_tc_kernel`, the tensor-core design (FA3's forward):
//   - one block per (head, 128-row q tile, batch), heads fastest and q
//     tiles last-first, so every head's longest causal rows start in the
//     first wave;
//   - a producer warp keeps TMA loads of 128-row K and V tiles in flight
//     through a 2-stage mbarrier ring; two consumer warpgroups own 64 q rows
//     each (setmaxnreg moves registers from the producer to them);
//   - S = Q K^T is a wgmma m64n128k16 with both operands in shared memory,
//     K-major; the online softmax runs on the accumulator fragment in
//     registers (row max over the 4 threads of a row, exp2 with the scale
//     folded in, the row sum l from the f32 p); O += P V is a wgmma
//     m64n{hd}k16 with P as bf16 A operands from registers (two: see the
//     last point) and V MN-major (the transpose bit, no copy of V);
//   - kv tiles that the causal mask or the window cover entirely are
//     skipped (the Pallas kernel's `run` predicate), for the block and, in
//     compute, for each warpgroup's 64 rows; the elementwise mask runs only
//     on tiles that cross the diagonal, the window's edge or the ragged end
//     of Skv. Rows past Sq and Skv read as TMA's zero fill: each tensor is a
//     4-D map (hd, H, S, B) over its strides, so a ragged tail never reads
//     the next batch row;
//   - P stays f32-accurate, as on the TPU: it is split into hi + lo bf16
//     halves, each multiplied by V. Rounding P to bf16 once stayed within
//     FLASH_MAIN_BF16_TOL at S = 2000, but moved full-width qwen3-4b's
//     prefill logits off the plain masked path's enough to flip a near-tie
//     top-1 (correlation 0.999681, max abs diff 0.1094, on an H100), where
//     f32 P had kept it.
// * f32, `flash_fwd_kernel`, plain f32 FMAs out of shared memory: f32
//   callers (the reduced models, whose card-equals-CPU checks hold 1e-4)
//   need f32 products, which TF32 tensor cores would not give. One block of
//   128 threads per (batch, head, 64-row q tile); q, k and v converted to
//   f32 once into shared memory (rows padded by one float); each thread owns
//   a 4 x 8 block of the score tile and a 4 x hd/8 block of the output; row
//   max and row sum reduce over the 8 threads of a row with warp shuffles.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

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

// ---- bf16: the tensor-core kernel -------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
namespace hw = repro::hopper;

constexpr int BQ = 128;                    // q rows per block (two warpgroups of 64)
constexpr int BK = 128;                    // kv rows per tile
constexpr int STAGES = 2;                  // K/V ring depth
constexpr int CONSUMERS = 2;               // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);
using hw::LOG2E;
constexpr float LN2 = 0.6931471805599453f;

struct Args {
  bf16* o; float* lse;
  int Sq, Skv, H, G, n_kv;
  long long o_sb, o_ss, o_sh;
  int causal, window, q_offset;
  float scale_log2;                        // sm_scale * log2(e): p = exp2(s * this - m)
};

template <int HD>
struct Layout {
  static constexpr int SW = HD * 2 >= 128 ? 128 : 64;   // swizzle width, bytes
  static constexpr int BOX = SW / 2;                    // columns per TMA box
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;
  // Q | K[STAGES] | V[STAGES] | barriers, from a 1024-byte aligned base
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 2 * STAGES);
};

// Whether rows [qlo, qhi] (absolute positions) see any key of the kv tile at k0.
__device__ __forceinline__ bool live(const Args& a, int qlo, int qhi, int k0) {
  if (a.causal && qhi < k0) return false;
  if (a.window && k0 + BK - 1 <= qlo - a.window) return false;
  return true;
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv, const Args a) {
  using L = Layout<HD>;
  constexpr int SW = L::SW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - hw::smem_u32(smem_raw) % 1024) % 1024);
  uint8_t* Qs = base;
  uint8_t* Ks = Qs + L::Q_BYTES;                        // stage s at Ks + s * KV_BYTES
  uint8_t* Vs = Ks + STAGES * L::KV_BYTES;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(Vs + STAGES * L::KV_BYTES);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + STAGES;

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;     // longest causal rows first
  const int kvh = h / a.G;
  const int qpos0 = a.q_offset + q0;

  if (threadIdx.x == 0) {
    hw::mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], CONSUMERS * 4);          // one arrival per consumer warp
    }
    hw::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS * 128) {
    // ---- producer warpgroup: one thread starts every load ----
    hw::regs_dealloc<24>();
    if (threadIdx.x == CONSUMERS * 128) {
      hw::mbar_arrive_expect_tx(bar_q, L::Q_BYTES);
      for (int c = 0; c < HD / L::BOX; ++c)
        hw::tma_load_4d(Qs + c * BQ * SW, &mq, bar_q, c * L::BOX, h, q0, b);
      int stage = 0;
      uint32_t parity = 1;                               // the ring starts empty
      for (int kt = 0; kt < a.n_kv; ++kt) {
        const int k0 = kt * BK;
        if (!live(a, qpos0, qpos0 + BQ - 1, k0)) continue;
        hw::mbar_wait(&empty[stage], parity);
        hw::mbar_arrive_expect_tx(&full[stage], 2 * L::KV_BYTES);
        uint8_t* kd = Ks + stage * L::KV_BYTES;
        uint8_t* vd = Vs + stage * L::KV_BYTES;
        for (int c = 0; c < HD / L::BOX; ++c) {
          hw::tma_load_4d(kd + c * BK * SW, &mk, &full[stage], c * L::BOX, kvh, k0, b);
          hw::tma_load_4d(vd + c * BK * SW, &mv, &full[stage], c * L::BOX, kvh, k0, b);
        }
        if (++stage == STAGES) { stage = 0; parity ^= 1; }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each ----
    hw::regs_alloc<240>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int r0 = warp * 16 + lane / 4;                 // rows r0 and r0 + 8 of the 64
    const int cq = 2 * (lane % 4);                       // columns cq, cq + 1 of each 8
    const int qlo = qpos0 + wg * 64, qhi = qlo + 63;
    const uint8_t* q_wg = Qs + wg * 64 * SW;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {repro::NEG_INF, repro::NEG_INF}, l[2] = {0.f, 0.f};

    hw::mbar_wait(bar_q, 0);
    int stage = 0;
    uint32_t parity = 0;
    for (int kt = 0; kt < a.n_kv; ++kt) {
      const int k0 = kt * BK;
      if (!live(a, qpos0, qpos0 + BQ - 1, k0)) continue;
      hw::mbar_wait(&full[stage], parity);
      if (live(a, qlo, qhi, k0)) {
        const uint8_t* kd = Ks + stage * L::KV_BYTES;
        const uint8_t* vd = Vs + stage * L::KV_BYTES;
        float s[BK / 2];
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int off = (kk * 16 / L::BOX) * BQ * SW + (kk * 16 % L::BOX) * 2;
          const int koff = (kk * 16 / L::BOX) * BK * SW + (kk * 16 % L::BOX) * 2;
          hw::wgmma_ss(s, hw::make_desc<SW>(q_wg + off, 0, 8 * SW),
                       hw::make_desc<SW>(kd + koff, 0, 8 * SW), kk > 0);
        }
        hw::wgmma_commit();
        hw::wgmma_wait();
        hw::fence_regs(s);

        const bool edge = k0 + BK > a.Skv || (a.causal && k0 + BK - 1 > qlo) ||
                          (a.window && qhi - k0 >= a.window);
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int idx = 0; idx < BK / 2; ++idx) {
          const int i = (idx / 2) % 2;
          float x = s[idx] * a.scale_log2;
          if (edge) {
            const int kp = k0 + (idx / 4) * 8 + cq + idx % 2;
            const int qp = qlo + r0 + 8 * i;
            bool ok = kp < a.Skv;
            if (a.causal) ok = ok && qp >= kp;
            if (a.window) ok = ok && qp - kp < a.window;
            x = ok ? x : repro::NEG_INF;
          }
          s[idx] = x;
          mx[i] = fmaxf(mx[i], x);
        }
        float corr[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(repro::FULL_MASK, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(repro::FULL_MASK, mx[i], 2));
          corr[i] = exp2f(m[i] - mx[i]);
          m[i] = mx[i];
          l[i] *= corr[i];
        }
#pragma unroll
        for (int idx = 0; idx < BK / 2; ++idx) {
          s[idx] = exp2f(s[idx] - m[(idx / 2) % 2]);   // p, f32
          l[(idx / 2) % 2] += s[idx];
        }
        uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];   // P as the m64k16 A fragments
        hw::split_bf16(s, p_hi, p_lo);
#pragma unroll
        for (int idx = 0; idx < HD / 2; ++idx) o[idx] *= corr[(idx / 2) % 2];

        hw::fence_regs(o);
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t d_v = hw::make_desc<SW>(vd + kk * 16 * SW, BK * SW, 8 * SW);
          hw::wgmma_rs_tb(o, p_hi[kk], d_v, 1);
          hw::wgmma_rs_tb(o, p_lo[kk], d_v, 1);
        }
        hw::wgmma_commit();
        hw::wgmma_wait();
        hw::fence_regs(o);
      }
      __syncwarp();
      if (lane == 0) hw::mbar_arrive(&empty[stage]);
      if (++stage == STAGES) { stage = 0; parity ^= 1; }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(repro::FULL_MASK, l[i], 1);
      l[i] += __shfl_xor_sync(repro::FULL_MASK, l[i], 2);
      const int row = q0 + wg * 64 + r0 + 8 * i;
      if (row >= a.Sq) continue;
      const float li = fmaxf(l[i], 1e-37f), inv = 1.f / li;
      bf16* orow = a.o + b * a.o_sb + row * a.o_ss + h * a.o_sh;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n + cq) =
            hw::pack_bf16(o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
      if (lane % 4 == 0) a.lse[((long long)b * a.H + h) * a.Sq + row] = m[i] * LN2 + logf(li);
    }
  }
}

template <int HD>
cudaError_t launch(const FlashArgs& f, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = hw::make_map(&mq, f.q, f.B, f.Sq, f.H, HD, f.q_sb, f.q_ss, f.q_sh, BQ)) ||
      (err = hw::make_map(&mk, f.k, f.B, f.Skv, f.KVH, HD, f.k_sb, f.k_ss, f.k_sh, BK)) ||
      (err = hw::make_map(&mv, f.v, f.B, f.Skv, f.KVH, HD, f.v_sb, f.v_ss, f.v_sh, BK)))
    return err;
  const Args a{static_cast<bf16*>(f.o), f.lse, f.Sq, f.Skv, f.H, f.H / f.KVH,
               (f.Skv + BK - 1) / BK, f.o_sb, f.o_ss, f.o_sh, f.causal, f.window, f.q_offset,
               f.sm_scale * LOG2E};
  constexpr int smem = Layout<HD>::SMEM;
  err = cudaFuncSetAttribute(flash_fwd_tc_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(f.H, (f.Sq + BQ - 1) / BQ, f.B);
  flash_fwd_tc_kernel<HD><<<grid, THREADS, smem, stream>>>(mq, mk, mv, a);
  return cudaGetLastError();
}

cudaError_t dispatch_hd(const FlashArgs& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32>(a, stream);
    case 64: return launch<64>(a, stream);
    case 128: return launch<128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

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
    case repro::kBFloat16: return tc::dispatch_hd(a, hd, s);
    default: return cudaErrorInvalidValue;
  }
}
