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
//   - a producer warp keeps TMA loads of 128-row K and V tiles (64-row at
//     hd 256, where two stages of 128 rows would not fit beside Q) in flight
//     through a 2-stage mbarrier ring; two consumer warpgroups own 64 q rows
//     each (setmaxnreg moves registers from the producer to them: at hd 256
//     the O accumulator alone is 128 f32 registers a thread);
//   - S = Q K^T is a wgmma m64n128k16 (m64n64k16 at hd 256) with both operands in shared memory,
//     K-major; the online softmax runs on the accumulator fragment in
//     registers (row max over the 4 threads of a row, exp2 with the scale
//     folded in, the row sum l from the f32 p); O += P V is a wgmma
//     m64n{hd}k16 (up to m64n256k16) with P as bf16 A operands from registers (two: see the
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
// * f32, `flash_fwd_tf32_kernel`, both products (s = Q K^T and P V) on the
//   tensor cores as split TF32 (csrc/tf32.cuh: hi + lo halves of every
//   operand, three mma.sync m16n8k8 a product): f32 callers (the reduced
//   models, whose card-equals-CPU checks hold 1e-4) need products near
//   f32's, which one TF32 product would not give (emulated on the CPU in
//   tests/test_torch_flash_fwd_tf32.py). The f32 backward's dq kernel
//   turned into a forward:
//   - one block of WARPS warps per (q tile, head, batch), q tiles
//     last-first; each warp owns 16 q rows, held in swizzled shared
//     memory; K and V tiles stream through a 2-stage cp.async ring over the
//     live kv tiles only (up to the causal edge, from the window's);
//   - the online softmax runs on the accumulator fragment of s: the row
//     max over the 4 lanes of a row (xor 1 and 2), corr = exp(m - m_new),
//     p = exp(s scale - m_new), l rescaled and summed; the masking value
//     stays NEG_INF (-1e30), so a fully masked row stays finite;
//   - p feeds P V straight from its accumulator (`frag_acc`, V read in the
//     accumulator's k order, `frag_krows`); the tile's share of o starts
//     at zero and joins o by an f32 add (the tensor cores' accumulator
//     rounds toward zero);
//   - what bounds it: operations, at a third of the TF32 rate (three
//     products a product); sized for head dim 256, where the FMA design it
//     replaced lost most (`Layout`).
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using repro::NEG_INF;
using repro::FULL_MASK;

struct FlashArgs {
  const void* q; const void* k; const void* v; void* o; float* lse;
  int B, Sq, Skv, H, KVH;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int causal, window, q_offset;
  float sm_scale;
};

// ---- f32: split TF32 on the tensor cores -------------------------------------

namespace tf32 {

using namespace repro::tf32;

// 8 warps (128 q rows) from hd 128 up, with 16-row kv tiles at hd 256; 4
// warps (64 q rows) below. tools/flash_fwd_variants.py on the H100: at hd 256
// 4 warps with 32-row tiles took 0.5600 ms and 8 with 16-row ones 0.4914, at
// hd 128 4 warps 0.3421 and 8 0.3195, at hd 64 (hymba's shape) 4 warps 0.2331
// and 8 0.2396. At hd 256 o alone is 128 registers a thread: a tile's share
// of o runs over 2 column blocks at a time (4 spilled).
template <int HD>
struct Layout {
  static constexpr int WARPS = HD >= 128 ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * WARPS;              // q rows a block, 16 a warp
  static constexpr int BK = HD > 128 ? 16 : 64;      // kv rows a streamed tile
  static constexpr int NG = HD > 128 ? 2 : HD / 8;   // column blocks a tile's share of o runs over
  // Q | K[STAGES] | V[STAGES]: 192 KB at hd 128 and 256
  static constexpr int SMEM = 4 * (BQ * HD + 2 * STAGES * BK * HD);
};

template <int HD>
__global__ void __launch_bounds__(Layout<HD>::THREADS, 1)
flash_fwd_tf32_kernel(const FlashArgs a) {
  using L = Layout<HD>;
  constexpr int BQ = L::BQ, BK = L::BK, NT = L::THREADS, NG = L::NG;
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);
  float* Ks = Qs + BQ * HD;                      // stage s at Ks + s * BK * HD
  float* Vs = Ks + STAGES * BK * HD;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;     // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KVH);
  const int warp = threadIdx.x / 32;
  const Lane l = lane_of(threadIdx.x % 32);
  const int qr0 = warp * 16;                     // the warp's q rows in the block
  const int qpos0 = a.q_offset + q0, qlo = qpos0 + qr0, qhi = qlo + 15;

  load_tile<HD, BQ, NT>(Qs, static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh,
                        a.q_ss, q0, a.Sq);
  repro::cp_async_commit();

  // the live kv tiles [lo, hi]: up to the causal edge, from the window's
  int lo = 0, hi = (a.Skv + BK - 1) / BK - 1;
  if (a.causal) hi = min(hi, (qpos0 + BQ - 1) / BK);
  if (a.window && qpos0 - a.window + 1 > 0) lo = (qpos0 - a.window + 1) / BK;
  const int n_tiles = max(0, hi - lo + 1);
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  auto issue = [&](int i) {                      // tile i of the walk into stage i % STAGES
    if (i < n_tiles) {
      const int k0 = (lo + i) * BK, st = i % STAGES;
      load_tile<HD, BK, NT>(Ks + st * BK * HD, kb, a.k_ss, k0, a.Skv);
      load_tile<HD, BK, NT>(Vs + st * BK * HD, vb, a.v_ss, k0, a.Skv);
    }
    repro::cp_async_commit();
  };

  // the lane's rows qr0 + g (index 0) and qr0 + g + 8 (index 1): o's
  // columns 8n + 2t (+ 1), the running max and the lane's share of the sum
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, rsum[2] = {0.f, 0.f};

  issue(0);
  for (int i = 0; i < n_tiles; ++i) {
    issue(i + 1);
    repro::cp_async_wait<1>();                   // Q and tile i: this thread's copies
    __syncthreads();                             // and every thread's
    const int st = i % STAGES, k0 = (lo + i) * BK;
    const bool warp_live = q0 + qr0 < a.Sq && !(a.causal && qhi < k0) &&
                           !(a.window && k0 + BK - 1 <= qlo - a.window);
    if (warp_live) {
      const float* Kt = Ks + st * BK * HD;
      const float* Vt = Vs + st * BK * HD;
      float s[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll 2
      for (int kc = 0; kc < HD; kc += 8) {       // s = Q K^T
        const Frag fq = frag_rows<HD>(Qs, qr0, kc, l);
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          uint32_t bh[2], bl[2];
          frag_cols<HD>(Kt, n * 8, kc, l, bh, bl);
          mma3(s[n], fq, bh, bl);
        }
      }
      // the online softmax: kv columns k0 + n * 8 + 2t (+ 1)
      const bool edge = k0 + BK > a.Skv || (a.causal && k0 + BK - 1 > qlo) ||
                        (a.window && qhi - k0 >= a.window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * a.sm_scale;
          if (edge) {
            const int kp = k0 + n * 8 + 2 * l.t + (e & 1), qp = qlo + l.g + 8 * (e >> 1);
            bool ok = kp < a.Skv;
            if (a.causal) ok = ok && qp >= kp;
            if (a.window) ok = ok && qp - kp < a.window;
            x = ok ? x : NEG_INF;
          }
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], 2));
        corr[r] = expf(m[r] - mx[r]);
        m[r] = mx[r];
        rsum[r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = expf(s[n][e] - m[e >> 1]);   // p
          rsum[e >> 1] += s[n][e];
        }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
      // o += P V: the tile's share of NG column blocks at a time
#pragma unroll
      for (int n0 = 0; n0 < HD / 8; n0 += NG) {
        float t[NG][4];
#pragma unroll
        for (int j = 0; j < NG; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) t[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
          const Frag fp = frag_acc(s[kk]);
#pragma unroll
          for (int j = 0; j < NG; ++j) {
            uint32_t bh[2], bl[2];
            frag_krows<HD>(Vt, kk * 8, (n0 + j) * 8, l, bh, bl);
            mma3(t[j], fp, bh, bl);
          }
        }
#pragma unroll
        for (int j = 0; j < NG; ++j) add(o[n0 + j], t[j]);
      }
    }
    __syncthreads();                             // stage st is free for tile i + STAGES
  }
  repro::cp_async_wait<0>();                     // (Q, if no tile was live)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rsum[r] += __shfl_xor_sync(FULL_MASK, rsum[r], 1);
    rsum[r] += __shfl_xor_sync(FULL_MASK, rsum[r], 2);
    const int row = q0 + qr0 + l.g + 8 * r;
    if (row >= a.Sq) continue;
    // l >= 1 on a live row (its largest p is 1): an approximate reciprocal
    // (2 ulp) keeps the IEEE division's slow-path call, and the registers it
    // saves, out of the epilogue
    const float li = fmaxf(rsum[r], 1e-37f), inv = __fdividef(1.f, li);
    float* orow = static_cast<float*>(a.o) + b * a.o_sb + row * a.o_ss + h * a.o_sh + 2 * l.t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    if (l.t == 0) a.lse[((long long)b * a.H + h) * a.Sq + row] = m[r] + logf(li);
  }
}

template <int HD>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  using L = Layout<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + L::BQ - 1) / L::BQ, a.H, a.B);
  flash_fwd_tf32_kernel<HD><<<grid, L::THREADS, L::SMEM, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch_hd(const FlashArgs& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32>(a, stream);
    case 64: return launch<64>(a, stream);
    case 128: return launch<128>(a, stream);
    case 256: return launch<256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tf32

// ---- bf16: the tensor-core kernel -------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
namespace hw = repro::hopper;

constexpr int BQ = 128;                    // q rows per block (two warpgroups of 64)
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
  // kv rows per tile: 128, or 64 at hd 256, where two stages of 128-row K
  // and V tiles (256 KB) would not fit beside Q in 227 KB
  static constexpr int BK = HD > 128 ? 64 : 128;
  static constexpr int SW = HD * 2 >= 128 ? 128 : 64;   // swizzle width, bytes
  static constexpr int BOX = SW / 2;                    // columns per TMA box
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;
  // Q | K[STAGES] | V[STAGES] | barriers, from a 1024-byte aligned base
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 2 * STAGES);
};

// Whether rows [qlo, qhi] (absolute positions) see any key of the BK-row kv tile at k0.
template <int BK>
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
  constexpr int SW = L::SW, BK = L::BK;
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
        if (!live<BK>(a, qpos0, qpos0 + BQ - 1, k0)) continue;
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
    // ---- consumer warpgroups: 64 q rows each (at hd 256, o alone is 128
    // registers a thread) ----
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
      if (!live<BK>(a, qpos0, qpos0 + BQ - 1, k0)) continue;
      hw::mbar_wait(&full[stage], parity);
      if (live<BK>(a, qlo, qhi, k0)) {
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
  constexpr int BK = Layout<HD>::BK;
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
    case 256: return launch<256>(a, stream);
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
    case repro::kFloat32: return tf32::dispatch_hd(a, hd, s);
    case repro::kBFloat16: return tc::dispatch_hd(a, hd, s);
    default: return cudaErrorInvalidValue;
  }
}
