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
// The walk over the chunks is serial, so what holds a design is how many
// blocks walk at once: at training's B1 the single pass below has 32 blocks
// for 132 SMs.
//
// Two designs, one function (kernels/mlstm/kernel.py's `tc_design` picks by
// shape): the single pass, where its grid fills the card (serving's B8),
// and the split design (below the single pass) elsewhere: a carry pass over
// C's 64 x 64 tiles, (hd / 64)^2 blocks a (b, h), then an output pass
// parallel over (chunk, 64 value rows, b.h). The split writes C at every
// chunk's start and reads it back, which training keeps for the gradient
// anyway; both give the rounding below.
//
// The single pass:
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

// One warp's chunk scalars (lane holds timesteps 2 lane and 2 lane + 1; past
// Lc i~ = NEG_INF and f~ = 0): a_s = i~_s - b_s (b the inclusive cumsum of
// f~), M_t = max(m_in, cummax_{s<=t} a_s), and M_c, b_c at the chunk's last
// step (on every lane). Both designs work them out with this code.
struct Scalars {
  float a0, a1, M0, M1, M_c, b_c;
};

__device__ __forceinline__ Scalars chunk_scalars(const float (&g)[4], float m_in, int Lc,
                                                 int lane) {
  const float i0 = g[0], i1 = g[1], f0 = g[2], f1 = g[3];
  float incl = f0 + f1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl += y;
  }
  float excl = __shfl_up_sync(FULL_MASK, incl, 1);
  if (lane == 0) excl = 0.f;
  const float b0 = excl + f0, b1 = b0 + f1;
  Scalars sc;
  sc.a0 = i0 - b0;
  sc.a1 = i1 - b1;
  float mx = fmaxf(sc.a0, sc.a1);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(FULL_MASK, mx, o);
    if (lane >= o) mx = fmaxf(mx, y);
  }
  float prev = __shfl_up_sync(FULL_MASK, mx, 1);
  if (lane == 0) prev = NEG_INF;
  sc.M0 = fmaxf(m_in, fmaxf(prev, sc.a0));
  sc.M1 = fmaxf(m_in, fmaxf(prev, fmaxf(sc.a0, sc.a1)));
  const int tl = Lc - 1;
  const float Mlo = __shfl_sync(FULL_MASK, sc.M0, tl / 2), Mhi = __shfl_sync(FULL_MASK, sc.M1, tl / 2);
  const float blo = __shfl_sync(FULL_MASK, b0, tl / 2), bhi = __shfl_sync(FULL_MASK, b1, tl / 2);
  sc.M_c = (tl & 1) ? Mhi : Mlo;
  sc.b_c = (tl & 1) ? bhi : blo;
  return sc;
}

// A lane's gates of chunk ci: i~ and f~ at timesteps 2 lane and 2 lane + 1
__device__ __forceinline__ void load_gates(float (&g)[4], const Args& a, int b, int hh, int ci,
                                           int lane) {
  const float* gp = a.g + b * a.g_b;
  const int t0 = ci * CH, Lc = min(CH, a.S - t0), ta = 2 * lane, tb = ta + 1;
  g[0] = g[1] = NEG_INF;
  g[2] = g[3] = 0.f;
  if (ta < Lc) { g[0] = gp[(t0 + ta) * a.g_s + hh]; g[2] = gp[(t0 + ta) * a.g_s + a.H + hh]; }
  if (tb < Lc) { g[1] = gp[(t0 + tb) * a.g_s + hh]; g[3] = gp[(t0 + tb) * a.g_s + a.H + hh]; }
}

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
    if (warp == 0) {                                     // the chunk's scalars
      const float m_in = my_misc[0];
      float g[4];
      load_gates(g, a, b, hh, ci, lane);
      const Scalars sc = chunk_scalars(g, m_in, Lc, lane);
      const int ta = 2 * lane, tb = ta + 1;
      my_a[ta] = sc.a0;
      my_a[tb] = sc.a1;
      my_M[ta] = sc.M0;
      my_M[tb] = sc.M1;
      my_cw[ta] = expf(m_in - sc.M0);
      my_cw[tb] = expf(m_in - sc.M1);
      my_w[ta] = ta < Lc ? expf(sc.a0 - sc.M_c) * inv_sqrt_hd : 0.f;
      my_w[tb] = tb < Lc ? expf(sc.a1 - sc.M_c) * inv_sqrt_hd : 0.f;
      if (lane == 0) {
        my_misc[1] = expf(m_in - sc.M_c);
        my_misc[2] = sc.b_c + sc.M_c;
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


// ---- the split design: a carry pass over C's tiles, then a pass parallel over chunks ----
//
// The single pass above walks every chunk in each of hd / 64 blocks a (b, h),
// recomputing q K^T, n.q and the chunk's scalars in each. The split form
// carries C alone through the chunks (what has to be serial), as 64 x 64
// tiles, and leaves everything else to a pass over (chunk, value-row tile,
// b.h) that starts from the C_in the carry wrote: the C_in that training
// keeps for the gradient anyway.

constexpr int TILE = 64;               // rows and columns of a carried tile of C
constexpr int CSTAGES = 4;             // chunks in flight in the carry's ring (V and K tiles)
constexpr int OSTAGES = 3;             // 64-column slices of q, K and C_in in flight (output pass)

size_t carry_smem() { return 1024 + size_t(CSTAGES) * 2 * BOX + (2 * CH + 8) * 4 + CSTAGES * 8; }

size_t out_smem(int hd) {
  return 1024 + size_t(OSTAGES) * 4 * BOX + BOX + size_t(hd) * 4 + (5 * CH) * 4 + (OSTAGES + 1) * 8;
}

// The carry pass: a block per (64 x 64 tile of C, b.h), grid (hd / 64 x hd / 64,
// B * H). The tile stays in registers as a wgmma m64n64 accumulator (f32) for
// the whole sequence; per chunk the block writes it out as C_in, then takes C
// = cscale C + (V w / sqrt(hd))^T K with V w as hi + lo bf16 halves (the
// single pass's two products), its V and K tiles through a TMA ring of
// CSTAGES chunks. Warp 0 works out the next chunk's scalars from the gates
// while the products run; every block of a head computes the same ones. The
// tiles of value rows 0.. also carry n's columns (n = cscale n + sum_s w_s
// K_s on FMAs, in the single pass's order) and write n_in; tile (0, 0) writes
// m_in and the final m.
__global__ void __launch_bounds__(128, 3)
mlstm_tc_carry_kernel(const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                      const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - hw::smem_u32(smem_raw) % 1024) % 1024);   // stage: V, K
  float* wbuf = reinterpret_cast<float*>(ring + CSTAGES * 2 * BOX);   // [2][CH] w_s by chunk parity
  float* csc = wbuf + 2 * CH;                                         // [2] cscale by chunk parity
  uint64_t* full = reinterpret_cast<uint64_t*>(csc + 8);              // [CSTAGES]

  const int hd = a.hd, nt = hd / TILE;
  const int bh = blockIdx.y, b = bh / a.H, hh = bh % a.H;
  const int v0 = (blockIdx.x / nt) * TILE, c0 = (blockIdx.x % nt) * TILE;
  const int n_chunks = (a.S + CH - 1) / CH;
  const long long bhc = (long long)bh * n_chunks;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  const bool nrow = v0 == 0;             // the tile also carries n's columns c0..
  const float inv_sqrt_hd = 1.f / sqrtf(float(hd));

  if (tid == 0) {
    for (int s = 0; s < CSTAGES; ++s) hw::mbar_init(&full[s], 1);
    hw::mbar_init_fence();
  }
  __syncthreads();
  auto issue = [&](int ci) {             // chunk ci's V and K tiles into stage ci % CSTAGES
    if (ci >= n_chunks) return;
    uint8_t* st = ring + (ci % CSTAGES) * 2 * BOX;
    uint64_t* bar = &full[ci % CSTAGES];
    hw::mbar_arrive_expect_tx(bar, 2 * BOX);
    hw::tma_load_4d(st, &mv, bar, v0, hh, ci * CH, b);
    hw::tma_load_4d(st + BOX, &mk, bar, c0, hh, ci * CH, b);
  };
  if (tid == 0)
    for (int i = 0; i < CSTAGES; ++i) issue(i);

  float C[32];                           // C[v0 + r, c0 + c] in the accumulator layout
#pragma unroll
  for (int idx = 0; idx < 32; ++idx) {
    const int r = r0 + 8 * ((idx / 2) % 2), c = 8 * (idx / 4) + cq + idx % 2;
    C[idx] = a.C0 != nullptr ? a.C0[((long long)bh * hd + v0 + r) * hd + c0 + c] : 0.f;
  }
  const int ncol = tid >> 1, half = tid & 1;   // n's column c0 + ncol, timesteps 32 half..
  float n = nrow && a.n0 != nullptr ? a.n0[(long long)bh * hd + c0 + ncol] : 0.f;
  float m = a.m0 != nullptr ? a.m0[bh] : 0.f;  // warp 0: m_in of the next chunk to work out
  const bool mtile = nrow && c0 == 0;          // writes m_in and the final m

  // warp 0: chunk ci's scalars into buffer ci & 1, m on to the chunk's end
  float g[4];
  auto scalars = [&](int ci) {
    const int Lc = min(CH, a.S - ci * CH), ta = 2 * lane, tb = ta + 1;
    const Scalars sc = chunk_scalars(g, m, Lc, lane);
    float* w = wbuf + (ci & 1) * CH;
    w[ta] = ta < Lc ? expf(sc.a0 - sc.M_c) * inv_sqrt_hd : 0.f;
    w[tb] = tb < Lc ? expf(sc.a1 - sc.M_c) * inv_sqrt_hd : 0.f;
    if (lane == 0) {
      csc[ci & 1] = expf(m - sc.M_c);
      if (mtile) a.km[bhc + ci] = m;
    }
    m = sc.b_c + sc.M_c;
  };
  if (warp == 0 && n_chunks > 0) {
    load_gates(g, a, b, hh, 0, lane);
    scalars(0);
    if (n_chunks > 1) load_gates(g, a, b, hh, 1, lane);
  }
  __syncthreads();

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int stage = ci % CSTAGES;
    const float* w = wbuf + (ci & 1) * CH;
    const float cscale = csc[ci & 1];
    float* kc = a.kC + ((bhc + ci) * hd + v0) * hd + c0;   // C_in
#pragma unroll
    for (int idx = 0; idx < 32; idx += 2) {
      const int r = r0 + 8 * ((idx / 2) % 2), c = 8 * (idx / 4) + cq;
      *reinterpret_cast<float2*>(kc + (long long)r * hd + c) = make_float2(C[idx], C[idx + 1]);
    }
    if (nrow && half == 0) a.kn[(bhc + ci) * hd + c0 + ncol] = n;
    hw::mbar_wait(&full[stage], (ci / CSTAGES) & 1);
    const uint8_t* Vt = ring + stage * 2 * BOX;
    const uint8_t* Kt = Vt + BOX;
    uint32_t vw_hi[4][4], vw_lo[4][4];   // (V w / sqrt(hd))^T as m64k16 A fragments (rows r, columns s)
    {
      float x[32];
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) {
        const int r = r0 + 8 * ((idx / 2) % 2), s = 8 * (idx / 4) + cq + idx % 2;
        x[idx] = __bfloat162float(*reinterpret_cast<const bf16*>(Vt + hw::swz128(s, r))) * w[s];
      }
      hw::split_bf16(x, vw_hi, vw_lo);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) C[i] *= cscale;
    hw::fence_regs(C);
    hw::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {     // C = cscale C + (V w)^T K
      const uint64_t dk = hw::make_desc<128>(Kt + ks * 16 * 128, BOX, 1024);
      hw::wgmma_rs_tb(C, vw_hi[ks], dk, 1);
      hw::wgmma_rs_tb(C, vw_lo[ks], dk, 1);
    }
    hw::wgmma_commit();
    if (nrow) {                          // n = cscale n + sum_s w_s K^_s, quarters of 16 steps
      float acc = 0.f;
#pragma unroll
      for (int q4 = 0; q4 < 2; ++q4) {
        float part = 0.f;
#pragma unroll
        for (int s = (2 * half + q4) * 16; s < (2 * half + q4) * 16 + 16; ++s)
          part = fmaf(w[s], __bfloat162float(*reinterpret_cast<const bf16*>(Kt + hw::swz128(s, ncol))),
                      part);
        acc = q4 == 0 ? part : acc + part;
      }
      acc += __shfl_xor_sync(FULL_MASK, acc, 1);
      n = fmaf(cscale, n, acc);
    }
    if (warp == 0 && ci + 1 < n_chunks) {   // beside the products: the next chunk's scalars
      scalars(ci + 1);
      if (ci + 2 < n_chunks) load_gates(g, a, b, hh, ci + 2, lane);
    }
    hw::wgmma_wait();
    hw::fence_regs(C);
    keep_regs(vw_hi);
    keep_regs(vw_lo);
    __syncthreads();                     // stage ci and chunk ci's scalars are read
    if (tid == 0) issue(ci + CSTAGES);
  }

#pragma unroll
  for (int idx = 0; idx < 32; idx += 2) {
    const int r = r0 + 8 * ((idx / 2) % 2), c = 8 * (idx / 4) + cq;
    *reinterpret_cast<float2*>(a.C + ((long long)bh * hd + v0 + r) * hd + c0 + c) =
        make_float2(C[idx], C[idx + 1]);
  }
  if (nrow && half == 0) a.n[(long long)bh * hd + c0 + ncol] = n;
  if (mtile && tid == 0) a.m[bh] = m;
}

// The output pass: a block per (chunk, 64 value rows, b.h), grid (chunks x hd /
// 64, B * H), from the C_in, n_in and m_in the carry wrote. Per 64-column
// slice of the keys (q, K and the block's 64 x 64 f32 tile of C_in, as two
// 32-column boxes under the 128-byte swizzle, through a TMA ring of OSTAGES
// slices): P += q K^T, inter^T += C_in q^T (C_in read from shared memory in
// the accumulator layout, as hi + lo halves), n_in . q_t on FMAs; then the single pass's
// epilogue: P' = P / sqrt(hd) . D as three bf16 terms, inter^T scaled by
// exp(m_in - M_t), h^T += V^T P', h = that / max(|n.q|, 1) through a staging
// tile. Every block of a chunk computes the same P and n.q, so the
// denominators agree across tiles; tile 0 writes n.q (KEEP).
template <bool KEEP>
__global__ void __launch_bounds__(128, 2)
mlstm_tc_out_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mc,
                    const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - hw::smem_u32(smem_raw) % 1024) % 1024);   // q, K, C_in x2
  uint8_t* Vs = ring + OSTAGES * 4 * BOX;                // V[t][r]
  float* ns = reinterpret_cast<float*>(Vs + BOX);        // [hd] n_in
  float* a_s = ns + a.hd;                                // [CH] i~_s - b_s
  float* M_s = a_s + CH;                                 // [CH] M_t
  float* cw_s = M_s + CH;                                // [CH] exp(m_in - M_t)
  float* nqs = cw_s + CH;                                // [CH] n_in . q_t
  float* den = nqs + CH;                                 // [CH]
  uint64_t* full = reinterpret_cast<uint64_t*>(den + CH);   // [OSTAGES]
  uint64_t* vfull = full + OSTAGES;

  const int hd = a.hd, NSL = hd / TILE;   // 64-column slices, and value-row tiles
  const int ci = blockIdx.x / NSL, v0 = (blockIdx.x % NSL) * TILE;
  const int bh = blockIdx.y, b = bh / a.H, hh = bh % a.H;
  const int n_chunks = (a.S + CH - 1) / CH;
  const long long bhc = (long long)bh * n_chunks + ci;
  const int t0 = ci * CH, Lc = min(CH, a.S - t0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  const float inv_sqrt_hd = 1.f / sqrtf(float(hd));

  if (tid == 0) {
    for (int s = 0; s < OSTAGES; ++s) hw::mbar_init(&full[s], 1);
    hw::mbar_init(vfull, 1);
    hw::mbar_init_fence();
  }
  __syncthreads();
  auto issue = [&](int j) {              // columns 64 j.. of q, K and C_in into stage j % OSTAGES
    if (j >= NSL) return;
    uint8_t* st = ring + (j % OSTAGES) * 4 * BOX;
    uint64_t* bar = &full[j % OSTAGES];
    hw::mbar_arrive_expect_tx(bar, 4 * BOX);
    hw::tma_load_4d(st, &mq, bar, j * TILE, hh, t0, b);
    hw::tma_load_4d(st + BOX, &mk, bar, j * TILE, hh, t0, b);
    hw::tma_load_3d(st + 2 * BOX, &mc, bar, j * TILE, v0, int(bhc));
    hw::tma_load_3d(st + 3 * BOX, &mc, bar, j * TILE + TILE / 2, v0, int(bhc));
  };
  if (tid == 0) {
    hw::mbar_arrive_expect_tx(vfull, BOX);
    hw::tma_load_4d(Vs, &mv, vfull, v0, hh, t0, b);
    for (int j = 0; j < OSTAGES; ++j) issue(j);
  }
  for (int c = tid; c < hd; c += 128) ns[c] = a.kn[bhc * hd + c];
  if (warp == 0) {
    float g[4];
    load_gates(g, a, b, hh, ci, lane);
    const float m_in = a.km[bhc];
    const Scalars sc = chunk_scalars(g, m_in, Lc, lane);
    a_s[2 * lane] = sc.a0;
    a_s[2 * lane + 1] = sc.a1;
    M_s[2 * lane] = sc.M0;
    M_s[2 * lane + 1] = sc.M1;
    cw_s[2 * lane] = expf(m_in - sc.M0);
    cw_s[2 * lane + 1] = expf(m_in - sc.M1);
  }
  __syncthreads();

  float P[32], I[32];                    // P[t, s] and inter^T[r, t]
#pragma unroll
  for (int i = 0; i < 32; ++i) P[i] = I[i] = 0.f;
  float nq = 0.f;                        // n_in . q_t over this thread's columns
  const int tq = tid >> 1, half = tid & 1;
  for (int j = 0; j < NSL; ++j) {
    const int stage = j % OSTAGES;
    hw::mbar_wait(&full[stage], (j / OSTAGES) & 1);
    const uint8_t* qs = ring + stage * 4 * BOX;
    const uint8_t* ks = qs + BOX;
    uint32_t c_hi[4][4], c_lo[4][4];     // C_in[v0 + r, 64 j + c] as A fragments, hi + lo
    {
      float c[32];
#pragma unroll
      for (int nn = 0; nn < 8; ++nn)
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          const int row = r0 + 8 * i2, cb = 8 * (nn % 4) + cq;   // column in its 32-column box
          const float2 v2 = *reinterpret_cast<const float2*>(
              qs + (2 + nn / 4) * BOX + row * 128 + ((((cb >> 2) ^ (row & 7))) << 4) + (cb & 3) * 4);
          c[4 * nn + 2 * i2] = v2.x;
          c[4 * nn + 2 * i2 + 1] = v2.y;
        }
      hw::split_bf16(c, c_hi, c_lo);
    }
    hw::fence_regs(P);
    hw::fence_regs(I);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)       // P += q K^T
      hw::wgmma_ss(P, hw::make_desc<128>(qs + kk * 32, 0, 1024),
                   hw::make_desc<128>(ks + kk * 32, 0, 1024), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {     // inter^T += C_in q^T
      const uint64_t dq = hw::make_desc<128>(qs + kk * 32, 0, 1024);
      hw::wgmma_rs(I, c_hi[kk], dq, 1);
      hw::wgmma_rs(I, c_lo[kk], dq, 1);
    }
    hw::wgmma_commit();
#pragma unroll
    for (int u = 0; u < 4; ++u) {        // beside the products: n_in . q_t
      const int chunk = half * 4 + u;
      const uint4 raw = *reinterpret_cast<const uint4*>(qs + tq * 128 + ((chunk ^ (tq & 7)) << 4));
      const bf16* e8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) nq = fmaf(__bfloat162float(e8[e]), ns[j * TILE + chunk * 8 + e], nq);
    }
    hw::wgmma_wait();
    hw::fence_regs(P);
    hw::fence_regs(I);
    keep_regs(c_hi);
    keep_regs(c_lo);
    __syncthreads();                     // stage j is read
    if (tid == 0) issue(j + OSTAGES);
  }
  nq += __shfl_xor_sync(FULL_MASK, nq, 1);
  if (half == 0) nqs[tq] = nq;

  uint8_t* P1 = ring;                    // P' hi, mid, lo and the h tile: the drained ring
  uint8_t* P2 = ring + BOX;
  uint8_t* P3 = ring + 2 * BOX;
  float rs[2] = {0.f, 0.f};              // P' = P / sqrt(hd) . D in f32, and its row sums
#pragma unroll
  for (int idx = 0; idx < 32; ++idx) {
    const int i = (idx / 2) % 2, t = r0 + 8 * i, s = 8 * (idx / 4) + cq + idx % 2;
    const float x = s <= t ? P[idx] * inv_sqrt_hd * expf(a_s[s] - M_s[t]) : 0.f;
    P[idx] = x;
    rs[i] += x;
  }
#pragma unroll
  for (int idx = 0; idx < 32; idx += 2) {   // inter^T[r, t] . exp(m_in - M_t); P' as three terms
    const int col = 8 * (idx / 4) + cq;
    I[idx] *= cw_s[col];
    I[idx + 1] *= cw_s[col + 1];
    const int t = r0 + 8 * ((idx / 2) % 2), s = col;
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(P[idx], P[idx + 1]);
    const float r_x = P[idx] - __low2float(h2), r_y = P[idx + 1] - __high2float(h2);
    const __nv_bfloat162 m2 = __floats2bfloat162_rn(r_x, r_y);
    *reinterpret_cast<__nv_bfloat162*>(P1 + hw::swz128(t, s)) = h2;
    *reinterpret_cast<__nv_bfloat162*>(P2 + hw::swz128(t, s)) = m2;
    *reinterpret_cast<uint32_t*>(P3 + hw::swz128(t, s)) =
        hw::pack_bf16(r_x - __low2float(m2), r_y - __high2float(m2));
  }
  __syncthreads();                       // n_in . q_t is written
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rs[i] += __shfl_xor_sync(FULL_MASK, rs[i], 1);
    rs[i] += __shfl_xor_sync(FULL_MASK, rs[i], 2);
    const int t = r0 + 8 * i;
    if (lane % 4 == 0) {
      const float nqt = rs[i] + cw_s[t] * nqs[t];
      den[t] = fmaxf(fabsf(nqt), 1.f);
      if (KEEP && v0 == 0 && t < Lc) a.knq[((long long)b * a.S + t0 + t) * a.H + hh] = nqt;
    }
  }
  hw::fence_proxy_async();
  __syncthreads();                       // P' terms and den are written
  hw::mbar_wait(vfull, 0);
  hw::fence_regs(I);
  hw::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {       // h^T numerator += V^T P'
    const uint64_t dv = hw::make_desc<128>(Vs + ks * 16 * 128, BOX, 1024);
    hw::wgmma_ss_ta(I, dv, hw::make_desc<128>(P1 + ks * 32, 0, 1024), 1);
    hw::wgmma_ss_ta(I, dv, hw::make_desc<128>(P2 + ks * 32, 0, 1024), 1);
    hw::wgmma_ss_ta(I, dv, hw::make_desc<128>(P3 + ks * 32, 0, 1024), 1);
  }
  hw::wgmma_commit();
  hw::wgmma_wait();
  hw::fence_regs(I);
  bf16* Xh = reinterpret_cast<bf16*>(ring + 3 * BOX);   // h tile [t][r], bf16
#pragma unroll
  for (int idx = 0; idx < 32; ++idx) {
    const int r = r0 + 8 * ((idx / 2) % 2), t = 8 * (idx / 4) + cq + idx % 2;
    Xh[t * TILE + r] = __float2bfloat16(I[idx] / den[t]);
  }
  __syncthreads();
  for (int e = tid; e < Lc * (TILE / 8); e += 128) {
    const int t = e / (TILE / 8), piece = e % (TILE / 8);
    *reinterpret_cast<uint4*>(a.h + b * a.h_b + (t0 + t) * a.h_s + hh * a.h_h + v0 + piece * 8) =
        *reinterpret_cast<const uint4*>(Xh + t * TILE + piece * 8);
  }
}

// What both designs take: bf16 q, k, v (B, S, H, hd) with the given (b, s, h)
// strides (16-byte multiples) and contiguous rows; h bf16 (B, S, H, hd)
// contiguous; gates, state, outputs and what is kept for the gradient as for
// repro_mlstm. hd: a multiple of 64 up to 512.
cudaError_t check_args(int B, int S, int H, int hd) {
  if (B < 0 || H < 0 || S < 0 || (long long)B * H > 65535 || hd < 64 || hd > 512 || hd % 64)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// kC (B H NC planes of hd x hd f32) as a 3-D map read in 32-column x 64-row
// boxes under the 128-byte swizzle
cudaError_t make_cin_map(CUtensorMap* map, const void* kC, int hd, long long planes) {
  hw::EncodeTiledFn encode = hw::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {cuuint64_t(hd), cuuint64_t(hd), cuuint64_t(planes)};
  const cuuint64_t st[2] = {cuuint64_t(hd) * 4, cuuint64_t(hd) * hd * 4};
  const cuuint32_t box[3] = {TILE / 2, TILE, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(kC), dims, st, box,
                      estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

Args make_args(const void* gates, const void* C0, const void* n0, const void* m0, void* h,
               void* C, void* n, void* m, void* kC, void* kn, void* km, void* knq, int H, int S,
               int hd, long long h_b, long long h_s, long long h_h, long long g_b, long long g_s) {
  return Args{static_cast<const float*>(gates), static_cast<const float*>(C0),
              static_cast<const float*>(n0), static_cast<const float*>(m0),
              static_cast<bf16*>(h), static_cast<float*>(C), static_cast<float*>(n),
              static_cast<float*>(m), static_cast<float*>(kC), static_cast<float*>(kn),
              static_cast<float*>(km), static_cast<float*>(knq), H, S, hd, h_b, h_s, h_h, g_b,
              g_s};
}

}  // namespace

// The single pass: one block per (64 value rows, b.h) walking every chunk.
extern "C" int repro_mlstm_tc(
    const void* q, const void* k, const void* v, const void* gates, const void* C0,
    const void* n0, const void* m0, void* h, void* C, void* n, void* m, void* kC, void* kn,
    void* km, void* knq, int B, int S, int H, int hd,
    long long q_b, long long q_s, long long q_h, long long k_b, long long k_s, long long k_h,
    long long v_b, long long v_s, long long v_h, long long h_b, long long h_s, long long h_h,
    long long g_b, long long g_s, void* stream) {
  if (B == 0 || H == 0) return cudaSuccess;
  cudaError_t err = check_args(B, S, H, hd);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mk, mv;
  const int S_map = S > 0 ? S : 1;
  if ((err = hw::make_map(&mq, q, B, S_map, H, hd, q_b, q_s, q_h, CH, 2 * KS)) ||
      (err = hw::make_map(&mk, k, B, S_map, H, hd, k_b, k_s, k_h, CH, 2 * KS)) ||
      (err = hw::make_map(&mv, v, B, S_map, H, hd, v_b, v_s, v_h, CH, 2 * VT)))
    return err;
  const Args a = make_args(gates, C0, n0, m0, h, C, n, m, kC, kn, km, knq, H, S, hd, h_b, h_s,
                           h_h, g_b, g_s);
  const int smem = int(smem_bytes(hd));
  const auto kern = kC != nullptr ? mlstm_tc_kernel<true> : mlstm_tc_kernel<false>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(hd / VT, B * H), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(mq, mk, mv, a);
  return cudaGetLastError();
}

// The split design: the carry pass, then the output pass, on one stream. kC,
// kn and km are where the carry hands C, n and m at each chunk's start to the
// output pass (kept for the gradient, or a workspace): never NULL for S > 0;
// knq NULL: n.q is not kept.
extern "C" int repro_mlstm_tc_split(
    const void* q, const void* k, const void* v, const void* gates, const void* C0,
    const void* n0, const void* m0, void* h, void* C, void* n, void* m, void* kC, void* kn,
    void* km, void* knq, int B, int S, int H, int hd,
    long long q_b, long long q_s, long long q_h, long long k_b, long long k_s, long long k_h,
    long long v_b, long long v_s, long long v_h, long long h_b, long long h_s, long long h_h,
    long long g_b, long long g_s, void* stream) {
  if (B == 0 || H == 0) return cudaSuccess;
  cudaError_t err = check_args(B, S, H, hd);
  if (err != cudaSuccess) return err;
  if (S > 0 && (kC == nullptr || kn == nullptr || km == nullptr)) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  const int S_map = S > 0 ? S : 1;
  if ((err = hw::make_map(&mq, q, B, S_map, H, hd, q_b, q_s, q_h, CH, 128)) ||
      (err = hw::make_map(&mk, k, B, S_map, H, hd, k_b, k_s, k_h, CH, 128)) ||
      (err = hw::make_map(&mv, v, B, S_map, H, hd, v_b, v_s, v_h, CH, 128)))
    return err;
  const Args a = make_args(gates, C0, n0, m0, h, C, n, m, kC, kn, km, knq, H, S, hd, h_b, h_s,
                           h_h, g_b, g_s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = hd / TILE, n_chunks = (S + CH - 1) / CH;
  const int c_smem = int(carry_smem()), o_smem = int(out_smem(hd));
  const auto out = knq != nullptr ? mlstm_tc_out_kernel<true> : mlstm_tc_out_kernel<false>;
  if ((err = cudaFuncSetAttribute(mlstm_tc_carry_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, c_smem)) ||
      (err = cudaFuncSetAttribute(out, cudaFuncAttributeMaxDynamicSharedMemorySize, o_smem)))
    return err;
  mlstm_tc_carry_kernel<<<dim3(nt * nt, B * H), 128, c_smem, st>>>(mk, mv, a);
  if ((err = cudaGetLastError()) != cudaSuccess || n_chunks == 0) return err;
  CUtensorMap mc;
  if ((err = make_cin_map(&mc, kC, hd, (long long)B * H * n_chunks))) return err;
  out<<<dim3(n_chunks * nt, B * H), 128, o_smem, st>>>(mq, mk, mv, mc, a);
  return cudaGetLastError();
}
