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
// * at hd 256 that would be 256 accumulators: there a block takes 64 kv
//   rows, both warpgroups compute the same s^T and dp^T for them, and each
//   owns half of dK's and dV's columns (m64n128k16 products; `Layout::SPLIT`);
// * tiles that the causal mask or the window cover entirely are skipped;
//   the elementwise mask runs only on tiles that cross the diagonal, the
//   window's edge or a ragged end; rows past Sq and Skv read as TMA's zero
//   fill of 4-D maps over the (B, S, H, hd) strides.
//
// dq, bf16: `flash_bwd_dq_tc_kernel`, the same design turned around (FA3
// computes dq with atomics inside its dk/dv kernel; here a block owns its dq
// tile and writes it once):
// * one block per (head, 128-row q tile, batch), q tiles last-first (the
//   longest causal rows first); two consumer warpgroups own 64 q rows each
//   and keep Q and dO (one TMA load each) in shared memory and lse log2e and
//   delta of their rows in registers; a producer warp streams 64-row K and
//   V tiles through a 2-stage mbarrier ring over the live kv tiles only
//   (it stops at the causal edge and skips tiles below the window);
// * s = Q K^T and dp = dO V^T are wgmma m64n64k16 with both operands in
//   shared memory, K-major; p and ds = p (dp - delta) scale in registers;
// * dq += ds K is a wgmma m64n{hd}k16 with ds as bf16 A operands from
//   registers (hi + lo halves, as in dk/dv: 4 products a tile where the
//   bound counts 1) and K MN-major from the tile that fed s (the transpose
//   bit); setmaxnreg as in dk/dv; the elementwise mask only on edge tiles;
// * at hd 256 (`DqLayout::SPLIT`) a block takes 64 q rows, both warpgroups
//   compute the same s and dp, and each owns half of dq's columns (dq alone
//   would be 128 accumulators a thread, and 128-row Q and dO tiles would not
//   fit beside the K and V ring).
//
// dk/dv and dq, f32: `flash_bwd_dkdv_tf32_kernel` and `flash_bwd_dq_tf32_kernel`,
// every product on the tensor cores as split TF32 (3xTF32), mma.sync m16n8k8.
// f32 callers (the reduced models, whose card-equals-CPU checks hold 1e-4)
// need products near f32's. One TF32 product keeps 11 of x's 24 significant
// bits and misses FLASH_BWD_F32_TOL; the split does not:
// * each f32 operand x, including p and ds in registers, is split into
//   hi and lo TF32 halves and a . b taken as three products (csrc/tf32.cuh,
//   shared with the f32 forward). Emulated on the CPU over the five
//   products (tests/test_torch_flash_bwd_tf32.py, against an f64
//   reference, as a fraction of FLASH_BWD_F32_TOL's limit): plain f32
//   0.014–0.049, the split 0.017–0.046, one TF32 product 20.5–32.9 (over
//   it);
// * mma.sync and not wgmma: wgmma takes .tf32 operands from shared memory
//   only K-major (the transpose bit is for 16-bit types; CUTLASS's
//   cute/arch/mma_sm90_gmma.hpp has TF32 wgmma only as _TN), and dv, dk and
//   dq contract over the rows of the stored dO, Q and K tiles; its B
//   operand would also need hi and lo tiles in shared memory. mma.sync
//   reads every fragment from registers, so each operand is loaded, split
//   and fed as it lies;
// * what bounds it: operations, a third of the TF32 rate for the 5
//   products (dq computes s and dp again); on the H100 dk/dv runs 58
//   TFLOP/s of TF32 products at hd 128, held by the three mma.sync a
//   product and the split's arithmetic with two warps a scheduler
//   (PERF.md §6, rows 3af and 3bf);
// * p and ds feed the next product straight from their accumulators
//   (tf32.cuh's `frag_acc` and `frag_krows`); f32 tiles lie swizzled in
//   shared memory and stream through a 2-stage cp.async ring: the next tile
//   is in flight while the block computes on this one;
// * the tensor cores round their f32 accumulator toward zero, so a sum over
//   many products drifts (tf32.cuh): summed in one accumulator, hymba's
//   dv (5 heads' q rows a kv row) came off by 1.9e-4 on the H100, dk and
//   dv at S1000 hd128 by 9.0e-5 and 1.7e-4 (tools/flash_bwd_variants.py, `one-sum`).
//   So each tile's share of dK, dV or dq starts at zero and joins the
//   running sum by an f32 add, rounded to nearest (`add`), a few column
//   blocks at a time so that the shares' registers fit: 1.8e-5, 2.0e-5
//   and 2.6e-5 there;
// * dkdv: one block of 8 warps per (kv tile of 64 rows, kv head, batch);
//   two warps to each 16 kv rows. K and V stay in shared memory; Q and dO
//   tiles of 64 rows (16 at hd 256) stream over the G query heads and each
//   head's live q tiles. Up to hd 128 the two warps take 32 q rows of each
//   tile apiece and their dK, dV (64 + 64 registers a thread at hd 128)
//   add up at the end through shared memory, in a fixed order; at hd 256
//   dK and dV would be 256 registers, so each takes half the columns and
//   both compute the same s^T and dp^T (`KvLayout::SPLIT`);
// * dq: one block of 4 warps per (q tile of 64 rows, head, batch), q tiles
//   last-first (the longest causal rows first); each warp owns 16 q rows
//   and their dq accumulators; Q and dO stay in shared memory, K and V
//   tiles of 64 rows (16 at hd 256) stream over the live kv tiles only;
// * each block owns its output tile and writes it once: no atomics, the
//   same bits on every call; tiles the causal mask or the window cover
//   entirely are never loaded; the elementwise mask runs only on tiles that
//   cross the diagonal, the window's edge or a ragged end.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "tf32.cuh"

namespace {

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

// ---- f32: split-TF32 products on the tensor cores ----------------------------

namespace tf32 {

using namespace repro::tf32;

// The (kv tile of BKV rows at k0) x (q tile of BQ rows) blocks that are live:
// q tiles [lo, hi] of every query head.
template <int BKV, int BQ>
__device__ __forceinline__ int2 live_q_tiles(const BwdArgs& a, int k0) {
  int lo = 0, hi = (a.Sq + BQ - 1) / BQ - 1;
  const int first = k0 - a.q_offset;                     // causal: q rows from here on
  if (a.causal && first > 0) lo = first / BQ;
  if (a.window) {
    const int last = k0 + BKV - 2 + a.window - a.q_offset;   // and up to here
    hi = last < 0 ? -1 : min(hi, last / BQ);
  }
  return make_int2(lo, hi);
}

template <int HD>
struct KvLayout {
  // Two warps to each 16 kv rows. Up to hd 128 each takes half of every q
  // tile's rows, and the pair's dK and dV add up at the end; at hd 256
  // (SPLIT) dK and dV alone would be 256 registers a thread, so each takes
  // half of their columns and both compute the same s^T and dp^T.
  static constexpr bool SPLIT = HD > 128;
  static constexpr int WARPS = 8;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BKV = 64;                     // kv rows a block, 16 a warp pair
  static constexpr int BQ = SPLIT ? 16 : 64;         // q rows a streamed tile
  static constexpr int QW = SPLIT ? BQ : BQ / 2;     // of which a warp takes
  static constexpr int NCOL = SPLIT ? HD / 2 : HD;   // dK, dV columns a warp
  static constexpr int NG = 2;                       // column blocks a tile's share runs over
  // K | V | Q[STAGES] | dO[STAGES] | lse[STAGES] | delta[STAGES]
  static constexpr int SMEM = 4 * (2 * BKV * HD + 2 * STAGES * BQ * HD + 2 * STAGES * BQ);
};

template <int HD>
__global__ void __launch_bounds__(KvLayout<HD>::THREADS, 1)
flash_bwd_dkdv_tf32_kernel(const BwdArgs a) {
  using L = KvLayout<HD>;
  constexpr int BKV = L::BKV, BQ = L::BQ, QW = L::QW, NCOL = L::NCOL, NT = L::THREADS;
  constexpr int NG = L::NG;
  extern __shared__ float4 smem_f4[];
  float* Ks = reinterpret_cast<float*>(smem_f4);
  float* Vs = Ks + BKV * HD;
  float* Qs = Vs + BKV * HD;                     // stage s at Qs + s * BQ * HD
  float* dOs = Qs + STAGES * BQ * HD;
  float* lse_s = dOs + STAGES * BQ * HD;         // [STAGES][BQ]
  float* delta_s = lse_s + STAGES * BQ;

  const int k0 = blockIdx.x * BKV, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KVH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Lane l = lane_of(lane);
  const int half = warp / 4;                     // the warp's half of q rows, or of columns
  const int kr0 = (warp % 4) * 16;               // its kv rows in the block
  const int qw0 = L::SPLIT ? 0 : half * QW;      // its q rows in each tile
  const int col0 = L::SPLIT ? half * NCOL : 0;   // its first dK, dV column
  const int klo = k0 + kr0, khi = klo + 15;

  const float* q = static_cast<const float*>(a.q) + b * a.q_sb;
  const float* dout = static_cast<const float*>(a.dout) + b * a.do_sb;
  load_tile<HD, BKV, NT>(Ks, static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh,
                         a.k_ss, k0, a.Skv);
  load_tile<HD, BKV, NT>(Vs, static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh,
                         a.v_ss, k0, a.Skv);
  repro::cp_async_commit();

  // the walk: query head g of the group, then its live q tiles
  const int2 live = live_q_tiles<BKV, BQ>(a, k0);
  const int per_head = max(0, live.y - live.x + 1), n_tiles = G * per_head;
  auto issue = [&](int i) {                      // tile i of the walk into stage i % STAGES
    if (i < n_tiles) {
      const int h = kvh * G + i / per_head, q0 = (live.x + i % per_head) * BQ;
      const int st = i % STAGES;
      load_tile<HD, BQ, NT>(Qs + st * BQ * HD, q + h * a.q_sh, a.q_ss, q0, a.Sq);
      load_tile<HD, BQ, NT>(dOs + st * BQ * HD, dout + h * a.do_sh, a.do_ss, q0, a.Sq);
      for (int r = threadIdx.x; r < BQ; r += NT) {
        const bool ok = q0 + r < a.Sq;
        const long long idx = ((long long)b * a.H + h) * a.Sq + (ok ? q0 + r : 0);
        repro::cp_async4_zfill(lse_s + st * BQ + r, a.lse + idx, ok);
        repro::cp_async4_zfill(delta_s + st * BQ + r, a.delta + idx, ok);
      }
    }
    repro::cp_async_commit();                    // an empty group past the end keeps the count
  };

  float dk[NCOL / 8][4], dv[NCOL / 8][4];
#pragma unroll
  for (int n = 0; n < NCOL / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  issue(0);
  for (int i = 0; i < n_tiles; ++i) {
    issue(i + 1);
    repro::cp_async_wait<1>();                   // K, V and tile i: this thread's copies
    __syncthreads();                             // and every thread's
    const int st = i % STAGES;
    const int q0 = (live.x + i % per_head) * BQ + qw0;    // the warp's first q row
    const int qlo = a.q_offset + q0;
    const bool warp_live = klo < a.Skv && q0 < a.Sq && !(a.causal && qlo + QW - 1 < klo) &&
                           !(a.window && khi <= qlo - a.window);
    if (warp_live) {
      const float* Qt = Qs + st * BQ * HD;
      const float* dOt = dOs + st * BQ * HD;
      const float* lse_t = lse_s + st * BQ + qw0;
      const float* delta_t = delta_s + st * BQ + qw0;
      float s[QW / 8][4], dp[QW / 8][4];
#pragma unroll
      for (int n = 0; n < QW / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll 2
      for (int kc = 0; kc < HD; kc += 8) {       // s^T = K Q^T, dp^T = V dO^T
        const Frag fk = frag_rows<HD>(Ks, kr0, kc, l);
        const Frag fv = frag_rows<HD>(Vs, kr0, kc, l);
#pragma unroll
        for (int n = 0; n < QW / 8; ++n) {
          uint32_t bh[2], bl[2];
          frag_cols<HD>(Qt, qw0 + n * 8, kc, l, bh, bl);
          mma3(s[n], fk, bh, bl);
          frag_cols<HD>(dOt, qw0 + n * 8, kc, l, bh, bl);
          mma3(dp[n], fv, bh, bl);
        }
      }
      // p^T and ds^T: the lane's kv rows klo + g (+ 8), q rows n * 8 + 2t (+ 1)
      const bool edge = q0 + QW > a.Sq || khi >= a.Skv || (a.causal && khi > qlo) ||
                        (a.window && qlo + QW - 1 - klo >= a.window);
#pragma unroll
      for (int n = 0; n < QW / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * l.t + (e & 1);
          float p = expf(s[n][e] * a.sm_scale - lse_t[c]);
          if (edge) {
            const int kp = klo + l.g + 8 * (e >> 1), qp = qlo + c;
            bool ok = q0 + c < a.Sq && kp < a.Skv;
            if (a.causal) ok = ok && qp >= kp;
            if (a.window) ok = ok && qp - kp < a.window;
            p = ok ? p : 0.f;
          }
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - delta_t[c]) * a.sm_scale;
        }
      // dv += p^T dO, dk += ds^T Q: the tile's share of NG column blocks at a time
#pragma unroll
      for (int n0 = 0; n0 < NCOL / 8; n0 += NG) {
        float tv[NG][4], tk[NG][4];
#pragma unroll
        for (int j = 0; j < NG; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) tv[j][e] = tk[j][e] = 0.f;
#pragma unroll
        for (int kq = 0; kq < QW / 8; ++kq) {
          const Frag fp = frag_acc(s[kq]), fs = frag_acc(dp[kq]);
#pragma unroll
          for (int j = 0; j < NG; ++j) {
            uint32_t bh[2], bl[2];
            frag_krows<HD>(dOt, qw0 + kq * 8, col0 + (n0 + j) * 8, l, bh, bl);
            mma3(tv[j], fp, bh, bl);
            frag_krows<HD>(Qt, qw0 + kq * 8, col0 + (n0 + j) * 8, l, bh, bl);
            mma3(tk[j], fs, bh, bl);
          }
        }
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          add(dv[n0 + j], tv[j]);
          add(dk[n0 + j], tk[j]);
        }
      }
    }
    __syncthreads();                             // stage st is free for tile i + STAGES
  }
  repro::cp_async_wait<0>();                     // (K and V, if no tile was live)

  if (!L::SPLIT) {
    // the pair's halves of the q rows: the second warp's dK and dV through
    // shared memory (the Q and dO stages, read by now) into the first's
    __syncthreads();
    float* red = Qs;                             // dK at r * HD + c, dV BKV * HD after
    if (half == 1) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = kr0 + l.g + 8 * i;
#pragma unroll
        for (int n = 0; n < NCOL / 8; ++n) {
          *reinterpret_cast<float2*>(red + r * HD + 8 * n + 2 * l.t) =
              make_float2(dk[n][2 * i], dk[n][2 * i + 1]);
          *reinterpret_cast<float2*>(red + (BKV + r) * HD + 8 * n + 2 * l.t) =
              make_float2(dv[n][2 * i], dv[n][2 * i + 1]);
        }
      }
    }
    __syncthreads();
    if (half == 1) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = kr0 + l.g + 8 * i;
#pragma unroll
      for (int n = 0; n < NCOL / 8; ++n) {
        const float2 k2 = *reinterpret_cast<const float2*>(red + r * HD + 8 * n + 2 * l.t);
        const float2 v2 =
            *reinterpret_cast<const float2*>(red + (BKV + r) * HD + 8 * n + 2 * l.t);
        dk[n][2 * i] += k2.x;
        dk[n][2 * i + 1] += k2.y;
        dv[n][2 * i] += v2.x;
        dv[n][2 * i + 1] += v2.y;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = klo + l.g + 8 * i;
    if (row >= a.Skv) continue;
    float* dkr = static_cast<float*>(a.dk) + b * a.dk_sb + row * a.dk_ss + kvh * a.dk_sh +
                 col0 + 2 * l.t;
    float* dvr = static_cast<float*>(a.dv) + b * a.dv_sb + row * a.dv_ss + kvh * a.dv_sh +
                 col0 + 2 * l.t;
#pragma unroll
    for (int n = 0; n < NCOL / 8; ++n) {
      *reinterpret_cast<float2*>(dkr + 8 * n) = make_float2(dk[n][2 * i], dk[n][2 * i + 1]);
      *reinterpret_cast<float2*>(dvr + 8 * n) = make_float2(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

template <int HD>
struct QLayout {
  static constexpr int WARPS = 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * WARPS;              // q rows a block, 16 a warp
  static constexpr int BK = HD > 128 ? 16 : 64;      // kv rows a streamed tile
  static constexpr int NG = HD > 128 ? 8 : HD / 8;   // column blocks a tile's share runs over
  // Q | dO | K[STAGES] | V[STAGES]
  static constexpr int SMEM = 4 * (2 * BQ * HD + 2 * STAGES * BK * HD);
};

template <int HD>
__global__ void __launch_bounds__(QLayout<HD>::THREADS, 1)
flash_bwd_dq_tf32_kernel(const BwdArgs a) {
  using L = QLayout<HD>;
  constexpr int BQ = L::BQ, BK = L::BK, NT = L::THREADS, NG = L::NG;
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);
  float* dOs = Qs + BQ * HD;
  float* Ks = dOs + BQ * HD;                     // stage s at Ks + s * BK * HD
  float* Vs = Ks + STAGES * BK * HD;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;     // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Lane l = lane_of(lane);
  const int qr0 = warp * 16;                     // the warp's q rows in the block
  const int qpos0 = a.q_offset + q0, qlo = qpos0 + qr0, qhi = qlo + 15;

  load_tile<HD, BQ, NT>(Qs, static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh,
                        a.q_ss, q0, a.Sq);
  load_tile<HD, BQ, NT>(dOs, static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh,
                        a.do_ss, q0, a.Sq);
  repro::cp_async_commit();
  float lse_r[2], dlt[2];                        // the lane's q rows qr0 + g (+ 8)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + qr0 + l.g + 8 * i;
    const long long idx = ((long long)b * a.H + h) * a.Sq + row;
    lse_r[i] = row < a.Sq ? a.lse[idx] : 0.f;
    dlt[i] = row < a.Sq ? a.delta[idx] : 0.f;
  }

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

  float dq[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  issue(0);
  for (int i = 0; i < n_tiles; ++i) {
    issue(i + 1);
    repro::cp_async_wait<1>();                   // Q, dO and tile i: this thread's copies
    __syncthreads();                             // and every thread's
    const int st = i % STAGES, k0 = (lo + i) * BK;
    const bool warp_live = q0 + qr0 < a.Sq && !(a.causal && qhi < k0) &&
                           !(a.window && k0 + BK - 1 <= qlo - a.window);
    if (warp_live) {
      const float* Kt = Ks + st * BK * HD;
      const float* Vt = Vs + st * BK * HD;
      float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll 2
      for (int kc = 0; kc < HD; kc += 8) {       // s = Q K^T, dp = dO V^T
        const Frag fq = frag_rows<HD>(Qs, qr0, kc, l);
        const Frag fo = frag_rows<HD>(dOs, qr0, kc, l);
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          uint32_t bh[2], bl[2];
          frag_cols<HD>(Kt, n * 8, kc, l, bh, bl);
          mma3(s[n], fq, bh, bl);
          frag_cols<HD>(Vt, n * 8, kc, l, bh, bl);
          mma3(dp[n], fo, bh, bl);
        }
      }
      // ds: the lane's q rows qr0 + g (+ 8), kv columns k0 + n * 8 + 2t (+ 1)
      const bool edge = k0 + BK > a.Skv || (a.causal && k0 + BK - 1 > qlo) ||
                        (a.window && qhi - k0 >= a.window);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i2 = e >> 1;
          float p = expf(s[n][e] * a.sm_scale - lse_r[i2]);
          if (edge) {
            const int kp = k0 + n * 8 + 2 * l.t + (e & 1), qp = qlo + l.g + 8 * i2;
            bool ok = kp < a.Skv;
            if (a.causal) ok = ok && qp >= kp;
            if (a.window) ok = ok && qp - kp < a.window;
            p = ok ? p : 0.f;
          }
          dp[n][e] = p * (dp[n][e] - dlt[i2]) * a.sm_scale;
        }
      // dq += ds K: the tile's share of NG column blocks at a time
#pragma unroll
      for (int n0 = 0; n0 < HD / 8; n0 += NG) {
        float t[NG][4];
#pragma unroll
        for (int j = 0; j < NG; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) t[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
          const Frag fs = frag_acc(dp[kk]);
#pragma unroll
          for (int j = 0; j < NG; ++j) {
            uint32_t bh[2], bl[2];
            frag_krows<HD>(Kt, kk * 8, (n0 + j) * 8, l, bh, bl);
            mma3(t[j], fs, bh, bl);
          }
        }
#pragma unroll
        for (int j = 0; j < NG; ++j) add(dq[n0 + j], t[j]);
      }
    }
    __syncthreads();                             // stage st is free for tile i + STAGES
  }
  repro::cp_async_wait<0>();                     // (Q and dO, if no tile was live)

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + qr0 + l.g + 8 * i;
    if (row >= a.Sq) continue;
    float* dqr = static_cast<float*>(a.dq) + b * a.dq_sb + row * a.dq_ss + h * a.dq_sh + 2 * l.t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(dqr + 8 * n) = make_float2(dq[n][2 * i], dq[n][2 * i + 1]);
  }
}

template <int HD>
cudaError_t launch_dkdv(const BwdArgs& a, cudaStream_t stream) {
  using L = KvLayout<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_tf32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Skv + L::BKV - 1) / L::BKV, a.KVH, a.B);
  flash_bwd_dkdv_tf32_kernel<HD><<<grid, L::THREADS, L::SMEM, stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq(const BwdArgs& a, cudaStream_t stream) {
  using L = QLayout<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tf32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + L::BQ - 1) / L::BQ, a.H, a.B);
  flash_bwd_dq_tf32_kernel<HD><<<grid, L::THREADS, L::SMEM, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tf32

// ---- bf16 dk/dv: the tensor-core kernel -------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
namespace hw = repro::hopper;

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

// Up to hd 128 the two consumer warpgroups own 64 kv rows each and all of
// their dK and dV columns (128 f32 accumulators a thread at hd 128). At hd
// 256 that would be 256: there the block takes 64 kv rows, both warpgroups
// compute the same s^T and dp^T for them, and each owns half of dK's and
// dV's columns (SPLIT).
template <int HD>
struct Layout {
  static constexpr bool SPLIT = HD > 128;
  static constexpr int BKV = SPLIT ? 64 : 128;    // kv rows per block
  static constexpr int NCOL = SPLIT ? HD / 2 : HD;   // dK, dV columns per warpgroup
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
  constexpr int SW = L::SW, BKV = L::BKV, NCOL = L::NCOL;
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
    // ---- consumer warpgroups: 64 kv rows each (SPLIT: the same 64, half the columns) ----
    hw::regs_alloc<240>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int r0 = warp * 16 + lane / 4;                 // kv rows r0 and r0 + 8 of the 64
    const int cq = 2 * (lane % 4);                       // q columns cq, cq + 1 of each 8
    const int rows0 = L::SPLIT ? 0 : wg * 64;            // the warpgroup's kv rows in the block
    const int col0 = L::SPLIT ? wg * NCOL : 0;           // and its first dK, dV column
    const int klo = k0 + rows0, khi = klo + 63;
    const uint8_t* k_wg = Ks + rows0 * SW;
    const uint8_t* v_wg = Vs + rows0 * SW;

    float dk[NCOL / 2], dv[NCOL / 2];
#pragma unroll
    for (int i = 0; i < NCOL / 2; ++i) dk[i] = dv[i] = 0.f;

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
            const int off = (col0 / L::BOX) * BQT * SW + kk * 16 * SW;   // the NCOL columns
            const uint64_t d_do = hw::make_desc<SW>(dd + off, BQT * SW, 8 * SW);
            const uint64_t d_q = hw::make_desc<SW>(qd + off, BQT * SW, 8 * SW);
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
      bf16* dkrow = a.dk + b * a.dk_sb + row * a.dk_ss + kvh * a.dk_sh + col0;
      bf16* dvrow = a.dv + b * a.dv_sb + row * a.dv_ss + kvh * a.dv_sh + col0;
#pragma unroll
      for (int n = 0; n < NCOL / 8; ++n) {
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
  constexpr int BKV = Layout<HD>::BKV;
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

// ---- bf16 dq: the tensor-core kernel ----------------------------------------

constexpr int DQ_BK = 64;                  // kv rows per streamed tile

struct DqArgs {
  const float* lse; const float* delta;    // (B, H, Sq) f32
  bf16* dq;
  int Sq, Skv, H, G, n_kv;
  long long dq_sb, dq_ss, dq_sh;
  int causal, window, q_offset;
  float sm_scale, scale_log2;              // scale_log2 = sm_scale * log2(e)
};

// As for dk/dv: two warpgroups of 64 q rows each, or at hd 256 (SPLIT)
// the same 64 q rows with half of dq's columns each (dq alone would be 128
// accumulators a thread, and 128-row Q and dO tiles would not fit beside
// the K and V ring).
template <int HD>
struct DqLayout {
  static constexpr bool SPLIT = HD > 128;
  static constexpr int BQ = SPLIT ? 64 : 128;      // q rows per block
  static constexpr int NCOL = SPLIT ? HD / 2 : HD; // dq columns per warpgroup
  static constexpr int SW = HD * 2 >= 128 ? 128 : 64;
  static constexpr int BOX = SW / 2;
  static constexpr int Q_BYTES = BQ * HD * 2;      // Q, and dO
  static constexpr int KV_BYTES = DQ_BK * HD * 2;  // each stage's K, and V
  // Q | dO | K[STAGES] | V[STAGES] | barriers
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 2 * STAGES);
};

// Whether q rows [qlo, qhi] (absolute positions) see any key of the kv tile at k0.
__device__ __forceinline__ bool live_kv(const DqArgs& a, int qlo, int qhi, int k0) {
  if (a.causal && qhi < k0) return false;
  if (a.window && k0 + DQ_BK - 1 <= qlo - a.window) return false;
  return true;
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv,
                       const __grid_constant__ CUtensorMap mdo, const DqArgs a) {
  using L = DqLayout<HD>;
  constexpr int SW = L::SW, BQ = L::BQ, NCOL = L::NCOL;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - hw::smem_u32(smem_raw) % 1024) % 1024);
  uint8_t* Qs = base;
  uint8_t* dOs = Qs + L::Q_BYTES;
  uint8_t* Ks = dOs + L::Q_BYTES;                        // stage s at Ks + s * KV_BYTES
  uint8_t* Vs = Ks + STAGES * L::KV_BYTES;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(Vs + STAGES * L::KV_BYTES);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + STAGES;

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;     // longest causal rows first
  const int kvh = h / a.G;
  const int qpos0 = a.q_offset + q0, qpos1 = qpos0 + BQ - 1;

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
      hw::mbar_arrive_expect_tx(bar_q, 2 * L::Q_BYTES);
      for (int c = 0; c < HD / L::BOX; ++c) {
        hw::tma_load_4d(Qs + c * BQ * SW, &mq, bar_q, c * L::BOX, h, q0, b);
        hw::tma_load_4d(dOs + c * BQ * SW, &mdo, bar_q, c * L::BOX, h, q0, b);
      }
      int stage = 0;
      uint32_t parity = 1;                               // the ring starts empty
      for (int kt = 0; kt < a.n_kv; ++kt) {
        const int k0 = kt * DQ_BK;
        if (a.causal && k0 > qpos1) break;               // this and later tiles masked
        if (!live_kv(a, qpos0, qpos1, k0)) continue;
        hw::mbar_wait(&empty[stage], parity);
        hw::mbar_arrive_expect_tx(&full[stage], 2 * L::KV_BYTES);
        uint8_t* kd = Ks + stage * L::KV_BYTES;
        uint8_t* vd = Vs + stage * L::KV_BYTES;
        for (int c = 0; c < HD / L::BOX; ++c) {
          hw::tma_load_4d(kd + c * DQ_BK * SW, &mk, &full[stage], c * L::BOX, kvh, k0, b);
          hw::tma_load_4d(vd + c * DQ_BK * SW, &mv, &full[stage], c * L::BOX, kvh, k0, b);
        }
        if (++stage == STAGES) { stage = 0; parity ^= 1; }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each (SPLIT: the same 64, half the columns) ----
    hw::regs_alloc<240>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int r0 = warp * 16 + lane / 4;                 // q rows r0 and r0 + 8 of the 64
    const int cq = 2 * (lane % 4);                       // columns cq, cq + 1 of each 8
    const int rows0 = L::SPLIT ? 0 : wg * 64;            // the warpgroup's q rows in the block
    const int col0 = L::SPLIT ? wg * NCOL : 0;           // and its first dq column
    const int qlo = qpos0 + rows0, qhi = qlo + 63;
    const uint8_t* q_wg = Qs + rows0 * SW;
    const uint8_t* do_wg = dOs + rows0 * SW;

    float lse2[2], dlt[2];                               // lse log2e and delta of both rows
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + rows0 + r0 + 8 * i;
      const long long idx = ((long long)b * a.H + h) * a.Sq + row;
      lse2[i] = row < a.Sq ? a.lse[idx] * LOG2E : 0.f;
      dlt[i] = row < a.Sq ? a.delta[idx] : 0.f;
    }
    float dq[NCOL / 2];
#pragma unroll
    for (int i = 0; i < NCOL / 2; ++i) dq[i] = 0.f;

    hw::mbar_wait(bar_q, 0);
    int stage = 0;
    uint32_t parity = 0;
    for (int kt = 0; kt < a.n_kv; ++kt) {
      const int k0 = kt * DQ_BK;
      if (a.causal && k0 > qpos1) break;
      if (!live_kv(a, qpos0, qpos1, k0)) continue;
      hw::mbar_wait(&full[stage], parity);
      if (live_kv(a, qlo, qhi, k0)) {
        const uint8_t* kd = Ks + stage * L::KV_BYTES;
        const uint8_t* vd = Vs + stage * L::KV_BYTES;
        float s[DQ_BK / 2], dp[DQ_BK / 2];
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {         // s = Q K^T
          const int col = (kk * 16 % L::BOX) * 2, box = kk * 16 / L::BOX;
          hw::wgmma_ss(s, hw::make_desc<SW>(q_wg + box * BQ * SW + col, 0, 8 * SW),
                       hw::make_desc<SW>(kd + box * DQ_BK * SW + col, 0, 8 * SW), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {         // dp = dO V^T
          const int col = (kk * 16 % L::BOX) * 2, box = kk * 16 / L::BOX;
          hw::wgmma_ss(dp, hw::make_desc<SW>(do_wg + box * BQ * SW + col, 0, 8 * SW),
                       hw::make_desc<SW>(vd + box * DQ_BK * SW + col, 0, 8 * SW), kk > 0);
        }
        hw::wgmma_commit();
        hw::wgmma_wait();
        hw::fence_regs(s);
        hw::fence_regs(dp);

        const bool edge = k0 + DQ_BK > a.Skv || (a.causal && k0 + DQ_BK - 1 > qlo) ||
                          (a.window && qhi - k0 >= a.window);
#pragma unroll
        for (int idx = 0; idx < DQ_BK / 2; ++idx) {
          const int i = (idx / 2) % 2;
          float p = exp2f(s[idx] * a.scale_log2 - lse2[i]);
          if (edge) {
            const int kp = k0 + (idx / 4) * 8 + cq + idx % 2;
            const int qp = qlo + r0 + 8 * i;
            bool ok = kp < a.Skv;
            if (a.causal) ok = ok && qp >= kp;
            if (a.window) ok = ok && qp - kp < a.window;
            p = ok ? p : 0.f;
          }
          dp[idx] = p * (dp[idx] - dlt[i]) * a.sm_scale;
        }
        uint32_t ds_hi[DQ_BK / 16][4], ds_lo[DQ_BK / 16][4];
        hw::split_bf16(dp, ds_hi, ds_lo);

        hw::fence_regs(dq);
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DQ_BK / 16; ++kk) {      // dq += ds K
          const uint64_t d_k = hw::make_desc<SW>(kd + (col0 / L::BOX) * DQ_BK * SW + kk * 16 * SW,
                                                 DQ_BK * SW, 8 * SW);
          hw::wgmma_rs_tb(dq, ds_hi[kk], d_k, 1);
          hw::wgmma_rs_tb(dq, ds_lo[kk], d_k, 1);
        }
        hw::wgmma_commit();
        hw::wgmma_wait();
        hw::fence_regs(dq);
      }
      __syncwarp();
      if (lane == 0) hw::mbar_arrive(&empty[stage]);
      if (++stage == STAGES) { stage = 0; parity ^= 1; }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + rows0 + r0 + 8 * i;
      if (row >= a.Sq) continue;
      bf16* dqrow = a.dq + b * a.dq_sb + row * a.dq_ss + h * a.dq_sh + col0;
#pragma unroll
      for (int n = 0; n < NCOL / 8; ++n)
        *reinterpret_cast<uint32_t*>(dqrow + 8 * n + cq) =
            hw::pack_bf16(dq[4 * n + 2 * i], dq[4 * n + 2 * i + 1]);
    }
  }
}

template <int HD>
cudaError_t launch_dq(const BwdArgs& f, cudaStream_t stream) {
  constexpr int BQ = DqLayout<HD>::BQ;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err;
  if ((err = hw::make_map(&mq, f.q, f.B, f.Sq, f.H, HD, f.q_sb, f.q_ss, f.q_sh, BQ)) ||
      (err = hw::make_map(&mdo, f.dout, f.B, f.Sq, f.H, HD, f.do_sb, f.do_ss, f.do_sh, BQ)) ||
      (err = hw::make_map(&mk, f.k, f.B, f.Skv, f.KVH, HD, f.k_sb, f.k_ss, f.k_sh, DQ_BK)) ||
      (err = hw::make_map(&mv, f.v, f.B, f.Skv, f.KVH, HD, f.v_sb, f.v_ss, f.v_sh, DQ_BK)))
    return err;
  const DqArgs a{f.lse, f.delta, static_cast<bf16*>(f.dq), f.Sq, f.Skv, f.H, f.H / f.KVH,
                 (f.Skv + DQ_BK - 1) / DQ_BK, f.dq_sb, f.dq_ss, f.dq_sh,
                 f.causal, f.window, f.q_offset, f.sm_scale, f.sm_scale * LOG2E};
  constexpr int smem = DqLayout<HD>::SMEM;
  err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(f.H, (f.Sq + BQ - 1) / BQ, f.B);
  flash_bwd_dq_tc_kernel<HD><<<grid, THREADS, smem, stream>>>(mq, mk, mv, mdo, a);
  return cudaGetLastError();
}

}  // namespace tc

// dq by dtype: f32 on the split-TF32 kernel, bf16 on the wgmma kernel.
cudaError_t dispatch_dq(const BwdArgs& a, int dtype, int hd, cudaStream_t s) {
  const bool f32 = dtype == repro::kFloat32;
  switch (hd) {
    case 32: return f32 ? tf32::launch_dq<32>(a, s) : tc::launch_dq<32>(a, s);
    case 64: return f32 ? tf32::launch_dq<64>(a, s) : tc::launch_dq<64>(a, s);
    case 128: return f32 ? tf32::launch_dq<128>(a, s) : tc::launch_dq<128>(a, s);
    case 256: return f32 ? tf32::launch_dq<256>(a, s) : tc::launch_dq<256>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// dk/dv by dtype: f32 on the split-TF32 kernel, bf16 on the wgmma kernel.
cudaError_t dispatch_dkdv(const BwdArgs& a, int dtype, int hd, cudaStream_t s) {
  const bool f32 = dtype == repro::kFloat32;
  switch (hd) {
    case 32: return f32 ? tf32::launch_dkdv<32>(a, s) : tc::launch_dkdv<32>(a, s);
    case 64: return f32 ? tf32::launch_dkdv<64>(a, s) : tc::launch_dkdv<64>(a, s);
    case 128: return f32 ? tf32::launch_dkdv<128>(a, s) : tc::launch_dkdv<128>(a, s);
    case 256: return f32 ? tf32::launch_dkdv<256>(a, s) : tc::launch_dkdv<256>(a, s);
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
  return dkdv ? dispatch_dkdv(a, dtype, hd, s) : dispatch_dq(a, dtype, hd, s);
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
