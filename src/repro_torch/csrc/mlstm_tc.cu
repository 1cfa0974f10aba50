// Chunkwise mLSTM prefill on Hopper's tensor cores (sm_90a), bf16 q/k/v.
//
// A variant of the Pallas TPU kernel `_mlstm_kernel` / `mlstm_chunkwise` in
// src/repro/kernels/mlstm/kernel.py for bf16 inputs; the function, the
// chunkwise regrouping and the outputs are those of mlstm.cu (h in bf16, the
// final C, n, m in f32). kernels/mlstm/kernel.py sends the model's bf16
// prefill calls here (head_dim a multiple of 64); f32 calls go to mlstm.cu.
//
// What bounds it: at xlstm-350m's prefill (B 8, S 4096, H 4, hd 512) the
// products of the chunkwise form are ~1.5e11 flop (0.15 ms at 989 TFLOP/s)
// against 0.57 GB of inputs and outputs (0.17 ms at 3.35 TB/s): both are
// close, and the C state (1 MB of f32 per (b, h)) is what a block must keep.
//
// Design:
// * one block per (64 value rows of C, (b, h)): grid (hd / 64, B * H). Its
//   tile C[v0:v0+64, :] stays in shared memory in f32 (its master copy,
//   133 KB at hd 512) for the whole sequence; the block walks the chunks of
//   64 timesteps in order. Nothing carries over between blocks;
// * a producer warp streams, per chunk, the V tile (64 timesteps x the 64
//   value columns, 128-byte swizzle, two buffers) and 32-column slices of q
//   and K (one 4 KB TMA box each, 64-byte swizzle) through a 4-stage
//   mbarrier ring. Two consumer warpgroups take alternate slices:
//   warpgroup w owns slices j = w mod 2, and with them those columns of C
//   and n;
// * per slice, on tensor cores with f32 accumulation: P += q K^T (bf16
//   inputs exact; 1/sqrt(hd) is applied in f32 afterwards); inter^T += C_in
//   q^T with C_in as A operands from registers; C = cscale C + (V w)^T K.
//   C_in and V w are f32, so each enters as hi + lo bf16 halves, two
//   products each: one rounding of either (2^-9 relative) breaks the
//   state's rtol 1e-3 (the CPU emulation, kernels/mlstm/ref.py). The C
//   slice goes shared -> registers (the update's accumulator, f32) ->
//   shared; n.q and n's update run on FMAs beside the products;
// * at the chunk's end warpgroup 1 hands its P and inter^T partials to
//   warpgroup 0 through shared memory (named barriers); warpgroup 0 forms P'
//   = P / sqrt(hd) . D in f32 (its row sums give the denominator), writes
//   P' as three bf16 terms (hi + mid + lo: f32's 24 bits, as h is a bf16
//   output whose roundings the random-weight xLSTM stack amplifies; two
//   terms moved end-to-end logits further from the plain path than two plain
//   orders are from each other), and adds intra^T = V^T P' on tensor cores
//   (V^T read from the V tile through the transpose bit) to cw . inter^T; h
//   goes out through a shared staging tile as coalesced 16-byte stores;
// * 32-column slices keep a consumer thread's live registers near 130 (P,
//   inter^T: 32 f32 each; the C slice and its halves: 32; V w halves: 32),
//   under the 168 that ptxas gives a 384-thread block; setmaxnreg moves
//   registers from the producer warpgroup to the consumers as in the flash
//   kernels. With KEEP (a template argument; serving's instantiation has
//   none of it) a warpgroup writes its C slice's values as each chunk
//   starts (C_in, for mlstm_bwd.cu), and block 0 n_in, m_in and each step's
//   n.q. Rows past S read as TMA's zero fill (4-D maps over the
//   strides), and a ragged last chunk is masked through its gates (w = 0,
//   no stored rows).
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace hw = repro::hopper;
using repro::NEG_INF;
using repro::FULL_MASK;

constexpr int CH = 64;                 // timesteps per chunk
constexpr int VT = 64;                 // value rows of C per block
constexpr int KS = 32;                 // key columns per slice: one 64-byte box row
constexpr int STAGES = 4;              // q/K slice ring depth
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int QBOX = CH * 64;          // a 64-row x 32-column bf16 box (q or K slice), bytes
constexpr int BOX = CH * 128;          // a 64-row x 64-column bf16 box (V, P'), bytes
constexpr int CPAD = 8;                // floats of padding of a C row (conflict-free float2)
// named barriers: warpgroup 1 -> 0 hand-off, 0 -> 1 release, each warpgroup's own, both
constexpr int BAR_X_FULL = 1, BAR_X_EMPTY = 2, BAR_WG = 3, BAR_ALL = 5;

struct Args {
  const float* g; const float* C0; const float* n0; const float* m0;
  bf16* h; float* C; float* n; float* m;
  float* kC; float* kn; float* km; float* knq;   // kept for the gradient, as in mlstm.cu
  int H, S, hd;
  long long h_b, h_s, h_h, g_b, g_s;
};

size_t smem_bytes(int hd) {
  return 1024 + size_t(STAGES) * 2 * QBOX + 6 * size_t(BOX) + size_t(VT) * (hd + CPAD) * 4 +
         size_t(hd) * 4 + size_t(2 * 4 * CH + 8 + 3 * CH) * 4 + (2 * STAGES + 4) * 8;
}

// f32 64 x 64 exchange tiles: chunk of 8 columns XOR (row % 8), so that the
// accumulator fragment's float2 stores and loads are free of bank conflicts
__device__ __forceinline__ int xoff(int row, int col) { return row * 64 + (col ^ ((row & 7) << 3)); }

// Keeps registers that an in-flight wgmma reads alive until after its wait.
template <int N>
__device__ __forceinline__ void keep_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
}

template <bool KEEP>   // keep what the gradient starts from (serving: false)
__global__ void __launch_bounds__(THREADS, 1)
mlstm_tc_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - hw::smem_u32(smem_raw) % 1024) % 1024);
  const int hd = a.hd, CS = hd + CPAD, NSL = hd / KS;
  uint8_t* ring = base;                                  // stage s: q slice, then K slice
  uint8_t* Vs = ring + STAGES * 2 * QBOX;                // two buffers of V[s][r]
  uint8_t* PX = Vs + 2 * BOX;                            // P partial (f32), then P' hi | mid
  uint8_t* Xs = PX + 2 * BOX;                            // inter^T partial (f32), then h | P' lo
  float* Cs = reinterpret_cast<float*>(Xs + 2 * BOX);    // [VT][CS] the C tile, f32
  float* ns = Cs + VT * CS;                              // [hd] n
  float* scal = ns + hd;                                 // [2][4][CH] per warpgroup
  float* misc = scal + 2 * 4 * CH;                       // [2][4] per warpgroup
  float* nqw = misc + 8;                                 // [2][CH] n_in . q_t partials
  float* den = nqw + 2 * CH;                             // [CH]
  uint64_t* full = reinterpret_cast<uint64_t*>(den + CH);
  uint64_t* empty = full + STAGES;
  uint64_t* vfull = empty + STAGES;                      // [2]
  uint64_t* vempty = vfull + 2;                          // [2]

  const int bh = blockIdx.y, b = bh / a.H, hh = bh % a.H;
  const int v0 = blockIdx.x * VT;
  const int n_chunks = (a.S + CH - 1) / CH;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], 4);                       // the owning warpgroup's 4 warps
    }
    for (int i = 0; i < 2; ++i) {
      hw::mbar_init(&vfull[i], 1);
      hw::mbar_init(&vempty[i], CONSUMERS * 4);          // every consumer warp
    }
    hw::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS * 128) {
    // ---- producer warpgroup: one thread starts every load ----
    hw::regs_dealloc<24>();
    if (threadIdx.x == CONSUMERS * 128) {
      int stage = 0;
      uint32_t parity = 1;                               // the ring starts empty
      for (int ci = 0; ci < n_chunks; ++ci) {
        const int t0 = ci * CH, vb = ci & 1;
        hw::mbar_wait(&vempty[vb], ((ci >> 1) & 1) ^ 1);
        hw::mbar_arrive_expect_tx(&vfull[vb], BOX);
        hw::tma_load_4d(Vs + vb * BOX, &mv, &vfull[vb], v0, hh, t0, b);
        for (int j = 0; j < NSL; ++j) {
          hw::mbar_wait(&empty[stage], parity);
          hw::mbar_arrive_expect_tx(&full[stage], 2 * QBOX);
          uint8_t* qd = ring + stage * 2 * QBOX;
          hw::tma_load_4d(qd, &mq, &full[stage], j * KS, hh, t0, b);
          hw::tma_load_4d(qd + QBOX, &mk, &full[stage], j * KS, hh, t0, b);
          if (++stage == STAGES) { stage = 0; parity ^= 1; }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  hw::regs_alloc<240>();
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;                   // fragment rows r0, r0 + 8
  const int cq = 2 * (lane % 4);                         // fragment columns cq, cq + 1 of each 8
  float* my_a = scal + wg * 4 * CH;                      // i~_s - b_s
  float* my_M = my_a + CH;                               // M_t
  float* my_cw = my_M + CH;                              // exp(m_in - M_t)
  float* my_w = my_cw + CH;                              // exp(a_s - M_c) / sqrt(hd), 0 past the end
  float* my_misc = misc + wg * 4;                        // m_in, cscale, next m
  const float inv_sqrt_hd = 1.f / sqrtf(float(hd));

  for (int e = threadIdx.x; e < VT * hd; e += CONSUMERS * 128) {
    const int r = e / hd, c = e % hd;
    Cs[r * CS + c] = a.C0 != nullptr ? a.C0[((long long)bh * hd + v0 + r) * hd + c] : 0.f;
  }
  for (int c = threadIdx.x; c < hd; c += CONSUMERS * 128)
    ns[c] = a.n0 != nullptr ? a.n0[(long long)bh * hd + c] : 0.f;
  if (tid == 0) my_misc[0] = a.m0 != nullptr ? a.m0[bh] : 0.f;
  hw::bar_sync(BAR_ALL, CONSUMERS * 128);

  int stage = 0;
  uint32_t parity = 0;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * CH, Lc = min(CH, a.S - t0), vb = ci & 1;
    const uint8_t* Vt = Vs + vb * BOX;
    hw::bar_sync(BAR_WG + wg, 128);                      // last chunk's readers of the scalars
    if (warp == 0) {
      // the chunk's scalars; lane holds timesteps 2 lane and 2 lane + 1
      const float m_in = my_misc[0];
      const float* gp = a.g + b * a.g_b;
      const int ta = 2 * lane, tb = ta + 1;
      float i0 = NEG_INF, i1 = NEG_INF, f0 = 0.f, f1 = 0.f;
      if (ta < Lc) { i0 = gp[(t0 + ta) * a.g_s + hh]; f0 = gp[(t0 + ta) * a.g_s + a.H + hh]; }
      if (tb < Lc) { i1 = gp[(t0 + tb) * a.g_s + hh]; f1 = gp[(t0 + tb) * a.g_s + a.H + hh]; }
      float incl = f0 + f1;                              // inclusive cumsum of f~ over lanes
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(FULL_MASK, incl, o);
        if (lane >= o) incl += y;
      }
      float excl = __shfl_up_sync(FULL_MASK, incl, 1);
      if (lane == 0) excl = 0.f;
      const float b0 = excl + f0, b1 = b0 + f1;
      const float a0 = i0 - b0, a1 = i1 - b1;
      float mx = fmaxf(a0, a1);                          // inclusive cummax over lanes
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(FULL_MASK, mx, o);
        if (lane >= o) mx = fmaxf(mx, y);
      }
      float prev = __shfl_up_sync(FULL_MASK, mx, 1);
      if (lane == 0) prev = NEG_INF;
      const float M0 = fmaxf(m_in, fmaxf(prev, a0));
      const float M1 = fmaxf(m_in, fmaxf(prev, fmaxf(a0, a1)));
      const int tl = Lc - 1;
      const float Mlo = __shfl_sync(FULL_MASK, M0, tl / 2), Mhi = __shfl_sync(FULL_MASK, M1, tl / 2);
      const float blo = __shfl_sync(FULL_MASK, b0, tl / 2), bhi = __shfl_sync(FULL_MASK, b1, tl / 2);
      const float M_c = (tl & 1) ? Mhi : Mlo, b_c = (tl & 1) ? bhi : blo;
      my_a[ta] = a0;
      my_a[tb] = a1;
      my_M[ta] = M0;
      my_M[tb] = M1;
      my_cw[ta] = expf(m_in - M0);
      my_cw[tb] = expf(m_in - M1);
      my_w[ta] = ta < Lc ? expf(a0 - M_c) * inv_sqrt_hd : 0.f;
      my_w[tb] = tb < Lc ? expf(a1 - M_c) * inv_sqrt_hd : 0.f;
      if (lane == 0) {
        my_misc[1] = expf(m_in - M_c);
        my_misc[2] = b_c + M_c;
        if (KEEP && blockIdx.x == 0 && wg == 0)
          a.km[(long long)bh * n_chunks + ci] = m_in;
      }
    }
    hw::bar_sync(BAR_WG + wg, 128);
    const float cscale = my_misc[1];

    // (V w / sqrt(hd))^T as m64k16 A fragments (rows r, columns s), hi + lo
    uint32_t vw_hi[4][4], vw_lo[4][4];
    hw::mbar_wait(&vfull[vb], (ci >> 1) & 1);
    {
      float x[32];
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) {
        const int r = r0 + 8 * ((idx / 2) % 2), s = 8 * (idx / 4) + cq + idx % 2;
        x[idx] = __bfloat162float(*reinterpret_cast<const bf16*>(Vt + hw::swz128(s, r))) * my_w[s];
      }
      hw::split_bf16(x, vw_hi, vw_lo);
    }
    if (wg == 1) {                                       // warpgroup 0 reads V again for intra
      __syncwarp();
      if (lane == 0) hw::mbar_arrive(&vempty[vb]);
    }

    float P[32], I[32];                                  // P[t, s] and inter^T[r, t] partials
#pragma unroll
    for (int i = 0; i < 32; ++i) P[i] = I[i] = 0.f;
    float nq = 0.f;                                      // n_in . q_t over this thread's columns
    for (int j = 0; j < NSL; ++j) {
      if ((j & 1) != wg) {                               // the other warpgroup's slice
        if (++stage == STAGES) { stage = 0; parity ^= 1; }
        continue;
      }
      hw::mbar_wait(&full[stage], parity);
      const uint8_t* qsl = ring + stage * 2 * QBOX;
      const uint8_t* ksl = qsl + QBOX;
      const int c0 = j * KS;
      float c[16];                                       // C[r, c0 + col] as an m64n32 accumulator
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          const float2 v2 = *reinterpret_cast<const float2*>(Cs + (r0 + 8 * i2) * CS + c0 + 8 * nn + cq);
          c[4 * nn + 2 * i2] = v2.x;
          c[4 * nn + 2 * i2 + 1] = v2.y;
        }
      if constexpr (KEEP) {                              // C_in, kept for the gradient
        float* kc = a.kC + (((long long)bh * n_chunks + ci) * hd + v0) * hd + c0;
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int i2 = 0; i2 < 2; ++i2)
            *reinterpret_cast<float2*>(kc + (long long)(r0 + 8 * i2) * hd + 8 * nn + cq) =
                make_float2(c[4 * nn + 2 * i2], c[4 * nn + 2 * i2 + 1]);
      }
      uint32_t c_hi[2][4], c_lo[2][4];
      hw::split_bf16(c, c_hi, c_lo);
#pragma unroll
      for (int i = 0; i < 16; ++i) c[i] *= cscale;
      hw::fence_regs(P);
      hw::fence_regs(I);
      hw::fence_regs(c);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)                     // P += q K^T
        hw::wgmma_ss(P, hw::make_desc<64>(qsl + kk * 32, 0, 512),
                     hw::make_desc<64>(ksl + kk * 32, 0, 512), 1);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {                   // inter^T += C_in q^T
        const uint64_t dq = hw::make_desc<64>(qsl + kk * 32, 0, 512);
        hw::wgmma_rs(I, c_hi[kk], dq, 1);
        hw::wgmma_rs(I, c_lo[kk], dq, 1);
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {                   // C = cscale C + (V w)^T K
        const uint64_t dk = hw::make_desc<64>(ksl + ks * 16 * 64, QBOX, 512);
        hw::wgmma_rs_tb(c, vw_hi[ks], dk, 1);
        hw::wgmma_rs_tb(c, vw_lo[ks], dk, 1);
      }
      hw::wgmma_commit();
      {                                                  // beside the products: n_in . q_t
        const int t = tid >> 1, half = tid & 1;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int chunk = half * 2 + u;
          const uint4 raw =
              *reinterpret_cast<const uint4*>(qsl + t * 64 + ((chunk ^ ((t >> 1) & 3)) << 4));
          const bf16* e8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e) nq = fmaf(__bfloat162float(e8[e]), ns[c0 + chunk * 8 + e], nq);
        }
      }
      hw::bar_sync(BAR_WG + wg, 128);                    // every reader of this slice's n_in is done
      {                                                  // n = cscale n + sum_s w_s K^_s
        const int col = tid >> 2, quarter = tid & 3;
        float acc = 0.f;
#pragma unroll
        for (int s = quarter * 16; s < quarter * 16 + 16; ++s)
          acc = fmaf(my_w[s], __bfloat162float(*reinterpret_cast<const bf16*>(ksl + hw::swz64(s, col))), acc);
        acc += __shfl_xor_sync(FULL_MASK, acc, 1);
        acc += __shfl_xor_sync(FULL_MASK, acc, 2);
        if (quarter == 0) {
          if (KEEP && blockIdx.x == 0)
            a.kn[((long long)bh * n_chunks + ci) * hd + c0 + col] = ns[c0 + col];
          ns[c0 + col] = fmaf(cscale, ns[c0 + col], acc);
        }
      }
      hw::wgmma_wait();
      hw::fence_regs(P);
      hw::fence_regs(I);
      hw::fence_regs(c);
      keep_regs(c_hi);
      keep_regs(c_lo);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2)
          *reinterpret_cast<float2*>(Cs + (r0 + 8 * i2) * CS + c0 + 8 * nn + cq) =
              make_float2(c[4 * nn + 2 * i2], c[4 * nn + 2 * i2 + 1]);
      __syncwarp();
      if (lane == 0) hw::mbar_arrive(&empty[stage]);
      if (++stage == STAGES) { stage = 0; parity ^= 1; }
    }
    keep_regs(vw_hi);
    keep_regs(vw_lo);
    nq += __shfl_xor_sync(FULL_MASK, nq, 1);

    float* PXf = reinterpret_cast<float*>(PX);
    float* Xf = reinterpret_cast<float*>(Xs);
    if (wg == 1) {
      // hand P and inter^T to warpgroup 0
      if (ci > 0) hw::bar_sync(BAR_X_EMPTY, CONSUMERS * 128);
#pragma unroll
      for (int idx = 0; idx < 32; idx += 2) {
        const int row = r0 + 8 * ((idx / 2) % 2), col = 8 * (idx / 4) + cq;
        *reinterpret_cast<float2*>(PXf + xoff(row, col)) = make_float2(P[idx], P[idx + 1]);
        *reinterpret_cast<float2*>(Xf + xoff(row, col)) = make_float2(I[idx], I[idx + 1]);
      }
      if ((tid & 1) == 0) nqw[CH + (tid >> 1)] = nq;
      hw::bar_arrive(BAR_X_FULL, CONSUMERS * 128);
    } else {
      if ((tid & 1) == 0) nqw[tid >> 1] = nq;
      hw::bar_sync(BAR_X_FULL, CONSUMERS * 128);
#pragma unroll
      for (int idx = 0; idx < 32; idx += 2) {
        const int row = r0 + 8 * ((idx / 2) % 2), col = 8 * (idx / 4) + cq;
        const float2 p2 = *reinterpret_cast<const float2*>(PXf + xoff(row, col));
        const float2 i2 = *reinterpret_cast<const float2*>(Xf + xoff(row, col));
        P[idx] += p2.x;
        P[idx + 1] += p2.y;
        I[idx] = (I[idx] + i2.x) * my_cw[col];           // inter^T[r, t] . exp(m_in - M_t)
        I[idx + 1] = (I[idx + 1] + i2.y) * my_cw[col + 1];
      }
      hw::bar_sync(BAR_WG, 128);                         // every read of the partials is done
      uint8_t* P3 = Xs + BOX;                            // P' lo: the exchange tile's upper half
      // P' = P / sqrt(hd) . D in f32: its row sums, and its hi + lo halves
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) {
        const int i = (idx / 2) % 2, t = r0 + 8 * i, s = 8 * (idx / 4) + cq + idx % 2;
        const float x = s <= t ? P[idx] * inv_sqrt_hd * expf(my_a[s] - my_M[t]) : 0.f;
        P[idx] = x;
        rs[i] += x;
      }
#pragma unroll
      for (int idx = 0; idx < 32; idx += 2) {           // P' = hi + mid + lo, three bf16 terms
        const int t = r0 + 8 * ((idx / 2) % 2), s = 8 * (idx / 4) + cq;
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(P[idx], P[idx + 1]);
        const float r_x = P[idx] - __low2float(h2), r_y = P[idx + 1] - __high2float(h2);
        const __nv_bfloat162 m2 = __floats2bfloat162_rn(r_x, r_y);
        *reinterpret_cast<__nv_bfloat162*>(PX + hw::swz128(t, s)) = h2;
        *reinterpret_cast<__nv_bfloat162*>(PX + BOX + hw::swz128(t, s)) = m2;
        *reinterpret_cast<uint32_t*>(P3 + hw::swz128(t, s)) =
            hw::pack_bf16(r_x - __low2float(m2), r_y - __high2float(m2));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(FULL_MASK, rs[i], 1);
        rs[i] += __shfl_xor_sync(FULL_MASK, rs[i], 2);
        const int t = r0 + 8 * i;
        if (lane % 4 == 0) {
          const float nqt = rs[i] + my_cw[t] * (nqw[t] + nqw[CH + t]);
          den[t] = fmaxf(fabsf(nqt), 1.f);
          if (KEEP && blockIdx.x == 0 && t < Lc)
            a.knq[((long long)b * a.S + t0 + t) * a.H + hh] = nqt;
        }
      }
      hw::fence_proxy_async();
      hw::bar_sync(BAR_WG, 128);                         // P' halves and den are written
      hw::fence_regs(I);
      hw::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {                   // h^T numerator += V^T P'
        const uint64_t dv = hw::make_desc<128>(Vt + ks * 16 * 128, BOX, 1024);
        hw::wgmma_ss_ta(I, dv, hw::make_desc<128>(PX + ks * 32, 0, 1024), 1);
        hw::wgmma_ss_ta(I, dv, hw::make_desc<128>(PX + BOX + ks * 32, 0, 1024), 1);
        hw::wgmma_ss_ta(I, dv, hw::make_desc<128>(P3 + ks * 32, 0, 1024), 1);
      }
      hw::wgmma_commit();
      hw::wgmma_wait();
      hw::fence_regs(I);
      __syncwarp();
      if (lane == 0) hw::mbar_arrive(&vempty[vb]);
      bf16* Xh = reinterpret_cast<bf16*>(Xs);            // h tile [t][r], bf16
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) {
        const int r = r0 + 8 * ((idx / 2) % 2), t = 8 * (idx / 4) + cq + idx % 2;
        Xh[t * VT + r] = __float2bfloat16(I[idx] / den[t]);
      }
      hw::bar_sync(BAR_WG, 128);
      for (int e = tid; e < Lc * (VT / 8); e += 128) {
        const int t = e / (VT / 8), piece = e % (VT / 8);
        *reinterpret_cast<uint4*>(a.h + b * a.h_b + (t0 + t) * a.h_s + hh * a.h_h + v0 + piece * 8) =
            *reinterpret_cast<const uint4*>(Xh + t * VT + piece * 8);
      }
      if (ci + 1 < n_chunks) hw::bar_arrive(BAR_X_EMPTY, CONSUMERS * 128);   // as often as 1 syncs
    }
    if (tid == 0) my_misc[0] = my_misc[2];
  }

  hw::bar_sync(BAR_ALL, CONSUMERS * 128);
  const int f4 = hd / 4;
  for (int e = threadIdx.x; e < VT * f4; e += CONSUMERS * 128) {
    const int r = e / f4, f = e % f4;
    reinterpret_cast<float4*>(a.C + ((long long)bh * hd + v0 + r) * hd)[f] =
        reinterpret_cast<const float4*>(Cs + r * CS)[f];
  }
  if (blockIdx.x == 0) {
    for (int c = threadIdx.x; c < hd; c += CONSUMERS * 128) a.n[(long long)bh * hd + c] = ns[c];
    if (threadIdx.x == 0) a.m[bh] = misc[0];
  }
}

}  // namespace

// bf16 q, k, v (B, S, H, hd) with the given (b, s, h) strides (16-byte
// multiples) and contiguous rows; h bf16 (B, S, H, hd) contiguous; gates,
// state, outputs and what is kept for the gradient as for repro_mlstm. hd:
// a multiple of 64 up to 512.
extern "C" int repro_mlstm_tc(
    const void* q, const void* k, const void* v, const void* gates, const void* C0,
    const void* n0, const void* m0, void* h, void* C, void* n, void* m, void* kC, void* kn,
    void* km, void* knq, int B, int S, int H, int hd,
    long long q_b, long long q_s, long long q_h, long long k_b, long long k_s, long long k_h,
    long long v_b, long long v_s, long long v_h, long long h_b, long long h_s, long long h_h,
    long long g_b, long long g_s, void* stream) {
  if (B == 0 || H == 0) return cudaSuccess;
  if (B < 0 || H < 0 || S < 0 || (long long)B * H > 65535 || hd < 64 || hd > 512 || hd % 64)
    return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  const int S_map = S > 0 ? S : 1;
  if ((err = hw::make_map(&mq, q, B, S_map, H, hd, q_b, q_s, q_h, CH, 2 * KS)) ||
      (err = hw::make_map(&mk, k, B, S_map, H, hd, k_b, k_s, k_h, CH, 2 * KS)) ||
      (err = hw::make_map(&mv, v, B, S_map, H, hd, v_b, v_s, v_h, CH, 2 * VT)))
    return err;
  const Args a{static_cast<const float*>(gates), static_cast<const float*>(C0),
               static_cast<const float*>(n0), static_cast<const float*>(m0),
               static_cast<bf16*>(h), static_cast<float*>(C), static_cast<float*>(n),
               static_cast<float*>(m), static_cast<float*>(kC), static_cast<float*>(kn),
               static_cast<float*>(km), static_cast<float*>(knq), H, S, hd, h_b, h_s, h_h, g_b,
               g_s};
  const int smem = int(smem_bytes(hd));
  const auto kern = kC != nullptr ? mlstm_tc_kernel<true> : mlstm_tc_kernel<false>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(hd / VT, B * H), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(mq, mk, mv, a);
  return cudaGetLastError();
}
