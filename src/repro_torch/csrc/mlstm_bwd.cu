// The chunkwise mLSTM's gradient for Hopper (sm_90a), hand-written CUDA C++.
//
// The TPU path has no kernel for it: the reference takes jax.grad of its
// chunkwise scan (src/repro/models/xlstm.py:67, `_mlstm_scan`). This is
// the backward of the function mlstm.cu and mlstm_tc.cu compute; its plain
// version, in the same order, is kernels/mlstm/ref.py's
// `mlstm_chunkwise_bwd_ref`, whose docstring derives it:
//
// * h depends on the stabilizer m_t only where the clamp max(|n_t.q_t|, 1)
//   is 1, so the gradient is (a) the chunkwise form's with every m_t held
//   constant plus (b) a scalar reverse pass along the stabilizer's argmax
//   chain m_t = max(f~_t + m_{t-1}, i~_t), fed -(dh_t.h_t) at each clamped
//   step. No max or cummax is differentiated.
// * (a) treats n as one more value row of C (v' = [v, 1]) with gradient
//   phi_t = -sign(n_t.q_t) (dh_t.h_t) / den_t where |n_t.q_t| > 1, else 0;
//   the other rows take delta_t = dh_t / den_t.
//
// What the forward keeps (kernels/mlstm/kernel.py asks for it when a
// gradient is wanted): each 64-step chunk's start state C_in, n_in, m_in
// and each step's n_t.q_t. The chunk's other scalars (b = cumsum f~,
// a = i~ - b, M_t = max(m_in, cummax a)) are recomputed here with the
// forward's own code.
//
// Three launches, one call:
// * `mlstm_bwd_carry_kernel`, the reverse pass over chunks, grid (hd / VT +
//   1, B * H). Block x < hd / VT owns VT value rows of dC (VT x hd f32 in
//   shared memory, 132 KB at hd 512): per chunk, last to first, it writes
//   dC (the gradient of the chunk's end state) out and steps it back,
//   dC <- cscale dC + sum_t carry_t delta_t q_t^T, on the tensor cores.
//   The last block owns the n row: dh_t.h_t, phi_t, dn the same way on
//   FMAs, and the stabilizer chain (b), one thread, writing its share of
//   dgates and of the start state's dm.
// * `mlstm_bwd_kernel`, parallel over (chunk, value-row tile, b.h): from
//   C_in and the end state's dC of its chunk, P = q k^T and dP = delta_tile
//   V_tile^T (+ phi on tile 0), it computes the tile's share of dq and dk
//   and of the gate gradient (both linear in dP), and dv of its rows whole.
//   Per 32-column key slice: dq = G K + carry (delta C_in), dk = G^T Q +
//   w (V dC), U += K dC^T (for dv and the gates), G = dP . D.
// * `mlstm_bwd_sum_kernel`: dq and dk summed over the tiles in tile order,
//   and per (b, h, chunk) the gates': di~ = sum X, db_t = dh_t.h_t +
//   phi_t n_t.q_t - X_t (+ the end terms at the chunk's last step), df~ its
//   reverse cumsum, added to (b)'s share. No atomics: two calls give the
//   same bits.
//
// Every product is split TF32 on mma.sync (csrc/tf32.cuh: hi + lo halves,
// three products); bf16 inputs become f32 on load (exact), so one design
// serves both dtypes. Tiles lie in shared memory as rows padded by 4
// floats; a sum over more than one 32-column slice adds each slice's share,
// from zero, in f32 (the tensor cores' accumulator rounds toward zero).
// Loads are plain and synchronous: a right kernel first.
#include <stdint.h>

#include "common.cuh"
#include "tf32.cuh"

namespace {

using repro::FULL_MASK;
using repro::NEG_INF;
using repro::tf32::Frag;
using repro::tf32::mma3;
using repro::tf32::split;

constexpr int NT = 256;   // threads: 8 warps
constexpr int CH = 64;    // timesteps per chunk (the forward kernels')
constexpr int KS = 32;    // key columns per slice
constexpr int PAD = 4;    // floats of padding after a shared tile's row

struct Strides {
  long long b, s, h;
};

struct Ln {
  int g, t;
};

// A operand (16 x 8) from X stored [m][k] (leading dimension ld)
__device__ __forceinline__ Frag a_rm(const float* X, int ld, int m0, int k0, Ln l) {
  const float* p = X + (m0 + l.g) * ld + k0 + l.t;
  Frag f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[8 * ld], f.hi[1], f.lo[1]);
  split(p[4], f.hi[2], f.lo[2]);
  split(p[8 * ld + 4], f.hi[3], f.lo[3]);
  return f;
}
// A operand from X stored [k][m]
__device__ __forceinline__ Frag a_cm(const float* X, int ld, int m0, int k0, Ln l) {
  const float* p = X + (k0 + l.t) * ld + m0 + l.g;
  Frag f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[8], f.hi[1], f.lo[1]);
  split(p[4 * ld], f.hi[2], f.lo[2]);
  split(p[4 * ld + 8], f.hi[3], f.lo[3]);
  return f;
}
// B operand (8 x 8, k x n) from Y stored [k][n]
__device__ __forceinline__ void b_km(const float* Y, int ld, int k0, int n0, Ln l,
                                     uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  const float* p = Y + (k0 + l.t) * ld + n0 + l.g;
  split(p[0], bh[0], bl[0]);
  split(p[4 * ld], bh[1], bl[1]);
}
// B operand from Y stored [n][k]
__device__ __forceinline__ void b_nm(const float* Y, int ld, int k0, int n0, Ln l,
                                     uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  const float* p = Y + (n0 + l.g) * ld + k0 + l.t;
  split(p[0], bh[0], bl[0]);
  split(p[4], bh[1], bl[1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[n][e] = 0.f;
}

// Rows [0, CH) x columns [0, W) of a strided slab into a padded f32 tile,
// times `scale`; rows at or past `rows` land as zeros.
template <int W, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, long long stride,
                                          int rows, float scale) {
  for (int e = threadIdx.x; e < CH * W; e += NT) {
    const int r = e / W, c = e % W;
    dst[r * (W + PAD) + c] = r < rows ? repro::to_float(src[r * stride + c]) * scale : 0.f;
  }
}

// Warp 0: the chunk's a_s = i~_s - b_s and M_t = max(m_in, cummax_{s<=t} a_s)
// as the forward kernels compute them (a lane holds timesteps 2 lane and
// 2 lane + 1; past Lc i~ = NEG_INF and f~ = 0), and M at the chunk's last
// step into *ME.
__device__ __forceinline__ void chunk_scalars(const float* gp, long long gs, int H, int hh,
                                              int t0, int Lc, float m_in, float* a_s, float* M_s,
                                              float* ME) {
  const int lane = threadIdx.x & 31;
  const int ta = 2 * lane, tb = ta + 1;
  float i0 = NEG_INF, i1 = NEG_INF, f0 = 0.f, f1 = 0.f;
  if (ta < Lc) { i0 = gp[(t0 + ta) * gs + hh]; f0 = gp[(t0 + ta) * gs + H + hh]; }
  if (tb < Lc) { i1 = gp[(t0 + tb) * gs + hh]; f1 = gp[(t0 + tb) * gs + H + hh]; }
  float incl = f0 + f1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl += y;
  }
  float excl = __shfl_up_sync(FULL_MASK, incl, 1);
  if (lane == 0) excl = 0.f;
  const float b0 = excl + f0, b1 = b0 + f1;
  const float a0 = i0 - b0, a1 = i1 - b1;
  float mx = fmaxf(a0, a1);
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
  a_s[ta] = a0;
  a_s[tb] = a1;
  M_s[ta] = M0;
  M_s[tb] = M1;
  if (lane == 0) *ME = (tl & 1) ? Mhi : Mlo;
}

// A block's sum of one float per thread, in a fixed order; every thread gets it.
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL_MASK, x, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) s += red[w];
  return s;
}

// ---- the reverse pass over chunks ------------------------------------------------

template <typename T>
struct CarryArgs {
  const T* q; const T* h; const T* dh; const float* g;
  const float* nq;                     // (B, S, H) kept n_t . q_t
  const float* km;                     // (B, H, NC) kept m_in
  const float* dCf; const float* dnf; const float* dmf;   // the final state's gradient (NULL: 0)
  const float* Cf; const float* nf;    // the final state (read with dCf, dnf)
  float* dCk; float* dnk;              // (B, H, NC, hd, hd), (B, H, NC, hd): each chunk end's
  float* phi; float* dhh;              // (B, S, H)
  float* dg;                           // (B, S, 2H): the chain's share
  float* dC0; float* dn0; float* dm0;  // the start state's (NULL: not wanted)
  int H, S, hd, NC;
  Strides sq, sh, sdh;
  long long gb, gs;
};

template <int VT>
size_t carry_smem(int hd) {
  const size_t rows = size_t(VT) * (hd + PAD) + CH * (KS + PAD) + CH * (VT + PAD);
  const size_t nrow = size_t(hd) + CH;
  return 4 * (5 * CH + 16 + (rows > nrow ? rows : nrow));
}

template <typename T, int VT>
__global__ void __launch_bounds__(NT, 1) mlstm_bwd_carry_kernel(const CarryArgs<T> a) {
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);   // [CH] a_s
  float* M_s = a_s + CH;                          // [CH] M_t
  float* cw_s = M_s + CH;                         // [CH] carry_t = exp(m_in - M_t), 0 past Lc
  float* den_s = cw_s + CH;                       // [CH] den_t
  float* x_s = den_s + CH;                        // [CH] dh_t . h_t (the n row's block)
  float* misc = x_s + CH;                         // [0] M at the chunk's end
  float* red = misc + 8;                          // [8]
  float* big = red + 8;
  const int hd = a.hd, NSL = hd / KS, NTILE = hd / VT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Ln l{lane >> 2, lane & 3};
  const int bh = blockIdx.y, b = bh / a.H, hh = bh % a.H;
  const long long bhc = (long long)bh * a.NC;
  const float* gp = a.g + b * a.gb;
  const T* qb = a.q + b * a.sq.b + hh * a.sq.h;
  const auto o3 = [&](int t) { return ((long long)b * a.S + t) * a.H + hh; };

  if (int(blockIdx.x) < NTILE) {
    // ---- VT value rows of dC on the tensor cores ----
    constexpr int LD = KS + PAD, LDD = VT + PAD;
    constexpr int RG = VT / 16, WPR = 8 / RG, NB = 4 / WPR;
    const int LDC = hd + PAD, v0 = blockIdx.x * VT;
    float* dCs = big;                             // [VT][hd + PAD]
    float* Qs = dCs + VT * LDC;                   // [CH][KS + PAD] a q slice
    float* Ds = Qs + CH * LD;                     // [CH][VT + PAD] carry_t delta_t
    const int rg = warp / WPR, nb0 = (warp % WPR) * NB;
    const T* db = a.dh + b * a.sdh.b + hh * a.sdh.h + v0;
    for (int e = tid; e < VT * hd; e += NT) {
      const int r = e / hd, c = e % hd;
      dCs[r * LDC + c] =
          a.dCf != nullptr ? a.dCf[((long long)bh * hd + v0 + r) * hd + c] : 0.f;
    }
    for (int ci = a.NC - 1; ci >= 0; --ci) {
      const int t0 = ci * CH, Lc = min(CH, a.S - t0);
      const float m_in = a.km[bhc + ci];
      __syncthreads();                            // the last chunk's readers are done
      if (warp == 0) chunk_scalars(gp, a.gs, a.H, hh, t0, Lc, m_in, a_s, M_s, misc);
      __syncthreads();
      if (tid < CH) {
        const bool in = tid < Lc;
        cw_s[tid] = in ? expf(m_in - M_s[tid]) : 0.f;
        den_s[tid] = in ? fmaxf(fabsf(a.nq[o3(t0 + tid)]), 1.f) : 1.f;
      }
      __syncthreads();
      const float cscale = expf(m_in - misc[0]);
      for (int e = tid; e < CH * VT; e += NT) {
        const int t = e / VT, i = e % VT;
        Ds[t * LDD + i] =
            t < Lc ? repro::to_float(db[(t0 + t) * a.sdh.s + i]) * (cw_s[t] / den_s[t]) : 0.f;
      }
      for (int j = 0; j < NSL; ++j) {
        __syncthreads();                          // Ds written; the last slice's readers done
        load_tile<KS>(Qs, qb + t0 * a.sq.s + j * KS, a.sq.s, Lc, 1.f);
        __syncthreads();
        float d[NB][4];
        zero(d);
#pragma unroll
        for (int ks = 0; ks < CH / 8; ++ks) {     // (carry delta)^T Q over the chunk's steps
          const Frag fa = a_cm(Ds, LDD, 16 * rg, 8 * ks, l);
#pragma unroll
          for (int n = 0; n < NB; ++n) {
            uint32_t fh[2], fl[2];
            b_km(Qs, LD, 8 * ks, 8 * (nb0 + n), l, fh, fl);
            mma3(d[n], fa, fh, fl);
          }
        }
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int i2 = 0; i2 < 2; ++i2) {
            const int r = 16 * rg + l.g + 8 * i2, c = j * KS + 8 * (nb0 + n) + 2 * l.t;
            float2* cp = reinterpret_cast<float2*>(dCs + r * LDC + c);
            const float2 old = *cp;
            *reinterpret_cast<float2*>(a.dCk + ((bhc + ci) * hd + v0 + r) * hd + c) = old;
            *cp = make_float2(fmaf(cscale, old.x, d[n][2 * i2]),
                              fmaf(cscale, old.y, d[n][2 * i2 + 1]));
          }
      }
    }
    if (a.dC0 != nullptr) {
      __syncthreads();
      for (int e = tid; e < VT * hd; e += NT) {
        const int r = e / hd, c = e % hd;
        a.dC0[((long long)bh * hd + v0 + r) * hd + c] = dCs[r * LDC + c];
      }
    }
    return;
  }

  // ---- the n row, dh . h, phi and the stabilizer chain ----
  float* dn_s = big;                              // [hd]
  float* phi_s = dn_s + hd;                       // [CH] carry_t phi_t
  float e_last = 0.f;                             // the final state's term at step S - 1
  if (a.dCf != nullptr || a.dnf != nullptr || a.dmf != nullptr) {
    float part = 0.f;
    if (a.dCf != nullptr)
      for (long long e = tid; e < (long long)hd * hd; e += NT)
        part = fmaf(a.dCf[(long long)bh * hd * hd + e], a.Cf[(long long)bh * hd * hd + e], part);
    if (a.dnf != nullptr)
      for (int e = tid; e < hd; e += NT)
        part = fmaf(a.dnf[(long long)bh * hd + e], a.nf[(long long)bh * hd + e], part);
    e_last = (a.dmf != nullptr ? a.dmf[bh] : 0.f) - block_sum(part, red);
  }
  for (int c = tid; c < hd; c += NT) dn_s[c] = a.dnf != nullptr ? a.dnf[(long long)bh * hd + c] : 0.f;
  const T* hb = a.h + b * a.sh.b + hh * a.sh.h;
  const T* dhb = a.dh + b * a.sdh.b + hh * a.sdh.h;
  float g = 0.f;                                  // thread 0: the chain's carry
  for (int ci = a.NC - 1; ci >= 0; --ci) {
    const int t0 = ci * CH, Lc = min(CH, a.S - t0);
    const float m_in = a.km[bhc + ci];
    __syncthreads();
    if (warp == 0) chunk_scalars(gp, a.gs, a.H, hh, t0, Lc, m_in, a_s, M_s, misc);
    for (int t = warp; t < CH; t += NT / 32) {    // dh_t . h_t, a warp a step
      float s = 0.f;
      if (t < Lc)
        for (int c = lane; c < hd; c += 32)
          s = fmaf(repro::to_float(dhb[(t0 + t) * a.sdh.s + c]),
                   repro::to_float(hb[(t0 + t) * a.sh.s + c]), s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL_MASK, s, o);
      if (lane == 0) x_s[t] = s;
    }
    __syncthreads();
    if (tid < CH) {
      float ph = 0.f, cw = 0.f;
      if (tid < Lc) {
        const float nqv = a.nq[o3(t0 + tid)];
        if (fabsf(nqv) > 1.f) ph = -x_s[tid] / nqv;   // -sign(n.q) (dh.h) / den
        a.phi[o3(t0 + tid)] = ph;
        a.dhh[o3(t0 + tid)] = x_s[tid];
        cw = expf(m_in - M_s[tid]);
      }
      phi_s[tid] = cw * ph;
    }
    __syncthreads();
    const float cscale = expf(m_in - misc[0]);
    for (int c = tid; c < hd; c += NT) {          // dn <- cscale dn + sum_t carry_t phi_t q_t
      float acc = 0.f;
      for (int t = 0; t < Lc; ++t)
        acc = fmaf(phi_s[t], repro::to_float(qb[(t0 + t) * a.sq.s + c]), acc);
      const float old = dn_s[c];
      a.dnk[(bhc + ci) * hd + c] = old;
      dn_s[c] = fmaf(cscale, old, acc);
    }
    if (tid == 0) {
      for (int t = Lc - 1; t >= 0; --t) {         // (b): the argmax chain
        const float nqv = a.nq[o3(t0 + t)];
        g += (fabsf(nqv) > 1.f ? 0.f : -x_s[t]) + (t0 + t == a.S - 1 ? e_last : 0.f);
        const bool won = a_s[t] > (t > 0 ? M_s[t - 1] : m_in);
        const long long o = ((long long)b * a.S + t0 + t) * 2 * a.H + hh;
        a.dg[o] = won ? g : 0.f;
        a.dg[o + a.H] = won ? 0.f : g;
        if (won) g = 0.f;
      }
    }
  }
  __syncthreads();
  if (a.dn0 != nullptr)
    for (int c = tid; c < hd; c += NT) a.dn0[(long long)bh * hd + c] = dn_s[c];
  if (tid == 0 && a.dm0 != nullptr) a.dm0[bh] = g;
}

// ---- the parallel pass over (chunk, value-row tile, b.h) ---------------------------

template <typename T>
struct MainArgs {
  const T* q; const T* k; const T* v; const T* dh; const float* g;
  const float* Ck; const float* nk; const float* km; const float* nq;   // kept by the forward
  const float* dCk; const float* dnk; const float* phi;                 // the carry pass's
  T* dv;                               // (B, S, H, hd) contiguous
  float* dq_p; float* dk_p;            // (NTILE, B, S, H, hd) the tiles' shares
  float* x_p;                          // (NTILE, B, S, H): sum_t gD_ts + gw_s
  float* zw_p;                         // (NTILE, B, H, NC, 2): the chunk's end terms
  int B, H, S, hd, NC;
  Strides sq, sk, sv, sdh;
  long long gb, gs;
};

template <int VT>
size_t main_smem() {
  return 4 * (size_t(2 * CH + 2 * VT) * (KS + PAD) + 2 * CH * (VT + PAD) + 2 * CH * (CH + PAD) +
              13 * CH + 16);
}

template <typename T, int VT>
__global__ void __launch_bounds__(NT, 1) mlstm_bwd_kernel(const MainArgs<T> a) {
  constexpr int LD = KS + PAD, LDV = VT + PAD, LDP = CH + PAD;
  constexpr int NU = VT / 16;          // 8-column blocks of a warp's half of U and dv
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);    // [CH][LD] q slice
  float* Ks = Qs + CH * LD;                       // [CH][LD] k^ slice (k / sqrt(hd))
  float* Cs = Ks + CH * LD;                       // [VT][LD] C_in slice
  float* dCs = Cs + VT * LD;                      // [VT][LD] the end state's dC slice
  float* Ds = dCs + VT * LD;                      // [CH][LDV] delta = dh / den
  float* Vs = Ds + CH * LDV;                      // [CH][LDV] v
  float* Gs = Vs + CH * LDV;                      // [CH][LDP] G = dP . D
  float* PDs = Gs + CH * LDP;                     // [CH][LDP] P . D
  float* a_s = PDs + CH * LDP;                    // [CH]
  float* M_s = a_s + CH;                          // [CH]
  float* cw_s = M_s + CH;                         // [CH] carry_t, 0 past Lc
  float* w_s = cw_s + CH;                         // [CH] exp(a_s - M_end), 0 past Lc
  float* den_s = w_s + CH;                        // [CH]
  float* phi_s = den_s + CH;                      // [CH] phi_t on tile 0, else 0
  float* colp = phi_s + CH;                       // [4][CH] column sums of gD by row group
  float* gwp = colp + 4 * CH;                     // [2][CH] v_s . U_s by column half
  float* kdn = gwp + 2 * CH;                      // [CH] k^_s . dn (tile 0)
  float* red = kdn + CH;                          // [8]
  float* misc = red + 8;                          // [0] M_end, [1..2] sums

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Ln l{lane >> 2, lane & 3};
  const int hd = a.hd, NSL = hd / KS, NTILE = hd / VT;
  const int ci = blockIdx.x / NTILE, tile = blockIdx.x % NTILE, v0 = tile * VT;
  const int bh = blockIdx.y, b = bh / a.H, hh = bh % a.H;
  const int t0 = ci * CH, Lc = min(CH, a.S - t0);
  const long long bhc = (long long)bh * a.NC + ci;
  const float inv_sqrt_hd = 1.f / sqrtf(float(hd));
  const float m_in = a.km[bhc];
  const T* qb = a.q + b * a.sq.b + hh * a.sq.h + t0 * a.sq.s;
  const T* kb = a.k + b * a.sk.b + hh * a.sk.h + t0 * a.sk.s;
  const T* vb = a.v + b * a.sv.b + hh * a.sv.h + t0 * a.sv.s + v0;
  const T* dhb = a.dh + b * a.sdh.b + hh * a.sdh.h + t0 * a.sdh.s + v0;
  const float* Cin = a.Ck + (bhc * hd + v0) * hd;
  const float* dCo = a.dCk + (bhc * hd + v0) * hd;
  const float* nin = a.nk + bhc * hd;
  const float* dno = a.dnk + bhc * hd;
  const auto o3 = [&](int t) { return ((long long)b * a.S + t0 + t) * a.H + hh; };

  if (warp == 0) chunk_scalars(a.g + b * a.gb, a.gs, a.H, hh, t0, Lc, m_in, a_s, M_s, misc);
  __syncthreads();
  const float M_end = misc[0];
  const float cscale = expf(m_in - M_end);
  if (tid < CH) {
    const bool in = tid < Lc;
    cw_s[tid] = in ? expf(m_in - M_s[tid]) : 0.f;
    w_s[tid] = in ? expf(a_s[tid] - M_end) : 0.f;
    den_s[tid] = in ? fmaxf(fabsf(a.nq[o3(tid)]), 1.f) : 1.f;
    phi_s[tid] = in && tile == 0 ? a.phi[o3(tid)] : 0.f;
  }
  __syncthreads();
  for (int e = tid; e < CH * VT; e += NT) {
    const int t = e / VT, i = e % VT;
    const bool in = t < Lc;
    Ds[t * LDV + i] = in ? repro::to_float(dhb[t * a.sdh.s + i]) / den_s[t] : 0.f;
    Vs[t * LDV + i] = in ? repro::to_float(vb[t * a.sv.s + i]) : 0.f;
  }

  // P = Q K^T over the key slices; warp (rg, half): rows 16 rg.., columns 32 half..
  const int rg = warp >> 1, half = warp & 1;
  const bool p_live = 32 * half <= 16 * rg + 15;  // else the causal mask covers the block
  float P[4][4];
  zero(P);
  for (int j = 0; j < NSL; ++j) {
    __syncthreads();
    load_tile<KS>(Qs, qb + j * KS, a.sq.s, Lc, 1.f);
    load_tile<KS>(Ks, kb + j * KS, a.sk.s, Lc, inv_sqrt_hd);
    __syncthreads();
    if (p_live) {
      float Pt[4][4];
      zero(Pt);
#pragma unroll
      for (int kc = 0; kc < KS; kc += 8) {
        const Frag fq = a_rm(Qs, LD, 16 * rg, kc, l);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          uint32_t fh[2], fl[2];
          b_nm(Ks, LD, kc, 32 * half + 8 * n, l, fh, fl);
          mma3(Pt[n], fq, fh, fl);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) repro::tf32::add(P[n], Pt[n]);
    }
  }
  // dP = delta_tile V_tile^T (+ phi_t on tile 0); G = dP . D; P . D; gD's column sums
  float dP[4][4];
  zero(dP);
  if (p_live) {
#pragma unroll
    for (int kc = 0; kc < VT; kc += 8) {
      const Frag fd = a_rm(Ds, LDV, 16 * rg, kc, l);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        uint32_t fh[2], fl[2];
        b_nm(Vs, LDV, kc, 32 * half + 8 * n, l, fh, fl);
        mma3(dP[n], fd, fh, fl);
      }
    }
  }
  float cs[4][2];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    cs[n][0] = cs[n][1] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = 16 * rg + l.g + 8 * (e >> 1), s = 32 * half + 8 * n + 2 * l.t + (e & 1);
      const float D = s <= t && t < Lc ? expf(a_s[s] - M_s[t]) : 0.f;
      const float dp = dP[n][e] + phi_s[t];
      const float pd = P[n][e] * D;
      Gs[t * LDP + s] = dp * D;
      PDs[t * LDP + s] = pd;
      cs[n][e & 1] = fmaf(dp, pd, cs[n][e & 1]);
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float x = cs[n][c];
      x += __shfl_xor_sync(FULL_MASK, x, 4);
      x += __shfl_xor_sync(FULL_MASK, x, 8);
      x += __shfl_xor_sync(FULL_MASK, x, 16);
      if (l.g == 0) colp[rg * CH + 32 * half + 8 * n + 2 * l.t + c] = x;
    }

  // per key slice: dq and dk (rows 16 rq.., columns cq.. of the slice), U (rows
  // 16 rq.., columns cu.. of the tile)
  const int rq = warp >> 1, cq = (warp & 1) * 16, cu = (warp & 1) * (VT / 2);
  float U[NU][4];
  zero(U);
  float gcs = 0.f, kd = 0.f;
  const int ks_row = tid >> 2, ks_q = tid & 3;   // k^ . dn: row ks_row, columns 8 ks_q..
  for (int j = 0; j < NSL; ++j) {
    __syncthreads();                              // Gs, PDs, colp written; last slice's readers done
    load_tile<KS>(Qs, qb + j * KS, a.sq.s, Lc, 1.f);
    load_tile<KS>(Ks, kb + j * KS, a.sk.s, Lc, inv_sqrt_hd);
    for (int e = tid; e < VT * KS; e += NT) {
      const int r = e / KS, c = e % KS;
      Cs[r * LD + c] = Cin[(long long)r * hd + j * KS + c];
      dCs[r * LD + c] = dCo[(long long)r * hd + j * KS + c];
    }
    __syncthreads();
    for (int e = tid; e < VT * KS; e += NT) {
      const int r = e / KS, c = e % KS;
      gcs = fmaf(Cs[r * LD + c], dCs[r * LD + c], gcs);
    }
    if (tile == 0)
#pragma unroll
      for (int c = 8 * ks_q; c < 8 * ks_q + 8; ++c)
        kd = fmaf(Ks[ks_row * LD + c], dno[j * KS + c], kd);

    float x1[2][4], x2[2][4];                     // dq: G K^, delta C_in
    zero(x1);
    zero(x2);
    for (int kc = 0; kc < 16 * rq + 16; kc += 8) {   // G_ts = 0 for s > t
      const Frag fg = a_rm(Gs, LDP, 16 * rq, kc, l);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        uint32_t fh[2], fl[2];
        b_km(Ks, LD, kc, cq + 8 * n, l, fh, fl);
        mma3(x1[n], fg, fh, fl);
      }
    }
#pragma unroll
    for (int kc = 0; kc < VT; kc += 8) {
      const Frag fd = a_rm(Ds, LDV, 16 * rq, kc, l);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        uint32_t fh[2], fl[2];
        b_km(Cs, LD, kc, cq + 8 * n, l, fh, fl);
        mma3(x2[n], fd, fh, fl);
      }
    }
    float y1[2][4], y2[2][4];                     // dk^: G^T Q, V dC
    zero(y1);
    zero(y2);
    for (int kc = 16 * rq; kc < CH; kc += 8) {    // G_ts = 0 for t < s
      const Frag fg = a_cm(Gs, LDP, 16 * rq, kc, l);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        uint32_t fh[2], fl[2];
        b_km(Qs, LD, kc, cq + 8 * n, l, fh, fl);
        mma3(y1[n], fg, fh, fl);
      }
    }
#pragma unroll
    for (int kc = 0; kc < VT; kc += 8) {
      const Frag fv = a_rm(Vs, LDV, 16 * rq, kc, l);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        uint32_t fh[2], fl[2];
        b_km(dCs, LD, kc, cq + 8 * n, l, fh, fl);
        mma3(y2[n], fv, fh, fl);
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const int t = 16 * rq + l.g + 8 * i2, c = j * KS + cq + 8 * n + 2 * l.t;
        if (t >= Lc) continue;
        const long long o = ((((long long)tile * a.B + b) * a.S + t0 + t) * a.H + hh) * hd + c;
        float e0 = x2[n][2 * i2], e1 = x2[n][2 * i2 + 1];
        float f0 = y2[n][2 * i2], f1 = y2[n][2 * i2 + 1];
        if (tile == 0) {
          e0 = fmaf(phi_s[t], nin[c], e0);
          e1 = fmaf(phi_s[t], nin[c + 1], e1);
          f0 += dno[c];
          f1 += dno[c + 1];
        }
        const float cw = cw_s[t], w = w_s[t];
        *reinterpret_cast<float2*>(a.dq_p + o) =
            make_float2(fmaf(cw, e0, x1[n][2 * i2]), fmaf(cw, e1, x1[n][2 * i2 + 1]));
        *reinterpret_cast<float2*>(a.dk_p + o) =
            make_float2(fmaf(w, f0, y1[n][2 * i2]) * inv_sqrt_hd,
                        fmaf(w, f1, y1[n][2 * i2 + 1]) * inv_sqrt_hd);
      }
    float Ut[NU][4];                              // U += K^ dC^T
    zero(Ut);
#pragma unroll
    for (int kc = 0; kc < KS; kc += 8) {
      const Frag fk = a_rm(Ks, LD, 16 * rq, kc, l);
#pragma unroll
      for (int n = 0; n < NU; ++n) {
        uint32_t fh[2], fl[2];
        b_nm(dCs, LD, kc, cu + 8 * n, l, fh, fl);
        mma3(Ut[n], fk, fh, fl);
      }
    }
#pragma unroll
    for (int n = 0; n < NU; ++n) repro::tf32::add(U[n], Ut[n]);
  }

  // dv = (P . D)^T delta + w_s U_s, whole for the tile's rows; v_s . U_s
  float o[NU][4];
  zero(o);
  for (int kc = 16 * rq; kc < CH; kc += 8) {      // (P . D)_ts = 0 for t < s
    const Frag fp = a_cm(PDs, LDP, 16 * rq, kc, l);
#pragma unroll
    for (int n = 0; n < NU; ++n) {
      uint32_t fh[2], fl[2];
      b_km(Ds, LDV, kc, cu + 8 * n, l, fh, fl);
      mma3(o[n], fp, fh, fl);
    }
  }
  float vu[2] = {0.f, 0.f};
  T* dvb = a.dv + (((long long)b * a.S + t0) * a.H + hh) * hd + v0;
#pragma unroll
  for (int n = 0; n < NU; ++n)
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int s = 16 * rq + l.g + 8 * i2, i = cu + 8 * n + 2 * l.t;
      vu[i2] = fmaf(Vs[s * LDV + i], U[n][2 * i2], vu[i2]);
      vu[i2] = fmaf(Vs[s * LDV + i + 1], U[n][2 * i2 + 1], vu[i2]);
      const float x = fmaf(w_s[s], U[n][2 * i2], o[n][2 * i2]);
      const float y = fmaf(w_s[s], U[n][2 * i2 + 1], o[n][2 * i2 + 1]);
      if (s < Lc) {
        T* p = dvb + (long long)s * a.H * hd + i;
        if constexpr (sizeof(T) == 4) {
          *reinterpret_cast<float2*>(p) = make_float2(x, y);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
        }
      }
    }
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    float x = vu[i2];
    x += __shfl_xor_sync(FULL_MASK, x, 1);
    x += __shfl_xor_sync(FULL_MASK, x, 2);
    if (l.t == 0) gwp[(warp & 1) * CH + 16 * rq + l.g + 8 * i2] = x;
  }
  kd += __shfl_xor_sync(FULL_MASK, kd, 1);
  kd += __shfl_xor_sync(FULL_MASK, kd, 2);
  if (ks_q == 0) kdn[ks_row] = tile == 0 ? kd : 0.f;
  if (tile == 0)
    for (int c = tid; c < hd; c += NT) gcs = fmaf(nin[c], dno[c], gcs);
  const float gc = cscale * block_sum(gcs, red);  // syncs: gwp, kdn written
  float gw = 0.f, col = 0.f;
  if (tid < CH) {
    gw = w_s[tid] * (gwp[tid] + gwp[CH + tid] + kdn[tid]);
    col = colp[tid] + colp[CH + tid] + colp[2 * CH + tid] + colp[3 * CH + tid];
    if (tid < Lc) a.x_p[(long long)tile * a.B * a.S * a.H + o3(tid)] = col + gw;
  }
  const float sgw = block_sum(gw, red), scol = block_sum(col, red);
  if (tid == 0) {
    float* zw = a.zw_p + (((long long)tile * a.B * a.H + bh) * a.NC + ci) * 2;
    zw[0] = gc + sgw;
    zw[1] = gc - scol;
  }
}

// ---- the fixed-order sums ------------------------------------------------------------

template <typename T>
struct SumArgs {
  const float* dq_p; const float* dk_p; const float* x_p; const float* zw_p;
  const float* dhh; const float* phi; const float* nq;
  T* dq; T* dk; float* dg; float* dm0;
  int B, H, S, hd, NC, NTILE, a_blocks;
};

template <typename T>
__global__ void __launch_bounds__(NT) mlstm_bwd_sum_kernel(const SumArgs<T> a) {
  const long long per = (long long)a.B * a.S * a.H * a.hd;
  if (int(blockIdx.x) < a.a_blocks) {             // dq, dk: the tiles' shares in tile order
    const long long n4 = per / 4;
    for (long long e = (long long)blockIdx.x * NT + threadIdx.x; e < n4;
         e += (long long)a.a_blocks * NT) {
      float4 sq = make_float4(0.f, 0.f, 0.f, 0.f), sk = sq;
      for (int p = 0; p < a.NTILE; ++p) {
        const float4 x = reinterpret_cast<const float4*>(a.dq_p + p * per)[e];
        const float4 y = reinterpret_cast<const float4*>(a.dk_p + p * per)[e];
        sq.x += x.x; sq.y += x.y; sq.z += x.z; sq.w += x.w;
        sk.x += y.x; sk.y += y.y; sk.z += y.z; sk.w += y.w;
      }
      if constexpr (sizeof(T) == 4) {
        reinterpret_cast<float4*>(a.dq)[e] = sq;
        reinterpret_cast<float4*>(a.dk)[e] = sk;
      } else {
        __nv_bfloat162* q2 = reinterpret_cast<__nv_bfloat162*>(a.dq) + 2 * e;
        __nv_bfloat162* k2 = reinterpret_cast<__nv_bfloat162*>(a.dk) + 2 * e;
        q2[0] = __floats2bfloat162_rn(sq.x, sq.y);
        q2[1] = __floats2bfloat162_rn(sq.z, sq.w);
        k2[0] = __floats2bfloat162_rn(sk.x, sk.y);
        k2[1] = __floats2bfloat162_rn(sk.z, sk.w);
      }
    }
    return;
  }
  // the gates: a thread per (b, h, chunk)
  const long long idx = (long long)(blockIdx.x - a.a_blocks) * NT + threadIdx.x;
  if (idx >= (long long)a.B * a.H * a.NC) return;
  const int ci = int(idx % a.NC), bh = int(idx / a.NC), b = bh / a.H, hh = bh % a.H;
  const int t0 = ci * CH, Lc = min(CH, a.S - t0);
  const long long plane = (long long)a.B * a.S * a.H;
  float Z = 0.f, W = 0.f;
  for (int p = 0; p < a.NTILE; ++p) {
    const float* zw = a.zw_p + (((long long)p * a.B * a.H + bh) * a.NC + ci) * 2;
    Z += zw[0];
    W += zw[1];
  }
  float run = Z, c0sum = 0.f;                     // db's reverse cumsum from the chunk's end
  for (int t = Lc - 1; t >= 0; --t) {
    const long long o = ((long long)b * a.S + t0 + t) * a.H + hh;
    float X = 0.f;
    for (int p = 0; p < a.NTILE; ++p) X += a.x_p[p * plane + o];
    const float c0 = fmaf(a.phi[o], a.nq[o], a.dhh[o]);
    c0sum += c0;
    run += c0 - X;
    const long long og = ((long long)b * a.S + t0 + t) * 2 * a.H + hh;
    a.dg[og] += X;
    a.dg[og + a.H] += run;
  }
  if (ci == 0 && a.dm0 != nullptr) a.dm0[bh] += c0sum + W;
}

template <typename T, int VT>
cudaError_t launch_bwd(const CarryArgs<T>& ca, const MainArgs<T>& ma, SumArgs<T> sa, int B,
                       cudaStream_t stream) {
  const int hd = ca.hd, NTILE = hd / VT, BH = B * ca.H;
  const int c_smem = int(carry_smem<VT>(hd)), m_smem = int(main_smem<VT>());
  cudaError_t err = cudaFuncSetAttribute(mlstm_bwd_carry_kernel<T, VT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, c_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mlstm_bwd_kernel<T, VT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             m_smem);
  if (err != cudaSuccess) return err;
  mlstm_bwd_carry_kernel<T, VT><<<dim3(NTILE + 1, BH), NT, c_smem, stream>>>(ca);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_bwd_kernel<T, VT><<<dim3(ca.NC * NTILE, BH), NT, m_smem, stream>>>(ma);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n4 = (long long)B * ca.S * ca.H * hd / 4;
  sa.NTILE = NTILE;
  const long long a_blocks = (n4 + NT - 1) / NT;
  sa.a_blocks = int(a_blocks < 4096 ? a_blocks : 4096);
  const int g_blocks = int(((long long)BH * ca.NC + NT - 1) / NT);
  mlstm_bwd_sum_kernel<T><<<sa.a_blocks + g_blocks, NT, 0, stream>>>(sa);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_bwd(const void* const* in, void* const* out, float* const* ws, const long long* st,
                    int B, int S, int H, int hd, cudaStream_t stream) {
  const T* q = static_cast<const T*>(in[0]);
  const T* k = static_cast<const T*>(in[1]);
  const T* v = static_cast<const T*>(in[2]);
  const float* g = static_cast<const float*>(in[3]);
  const T* h = static_cast<const T*>(in[4]);
  const T* dh = static_cast<const T*>(in[5]);
  const auto f = [&](int i) { return static_cast<const float*>(in[i]); };
  const int NC = (S + CH - 1) / CH;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      sh{st[9], st[10], st[11]}, sdh{st[12], st[13], st[14]};
  const long long gb = st[15], gs = st[16];
  float* dg = static_cast<float*>(out[3]);
  float* dm0 = static_cast<float*>(out[6]);
  const CarryArgs<T> ca{q, h, dh, g, f(9), f(8), f(10), f(11), f(12), f(13), f(14),
                        ws[0], ws[1], ws[2], ws[3], dg, static_cast<float*>(out[4]),
                        static_cast<float*>(out[5]), dm0, H, S, hd, NC, sq, sh, sdh, gb, gs};
  const MainArgs<T> ma{q, k, v, dh, g, f(6), f(7), f(8), f(9), ws[0], ws[1], ws[2],
                       static_cast<T*>(out[2]), ws[4], ws[5], ws[6], ws[7], B, H, S, hd, NC,
                       sq, sk, sv, sdh, gb, gs};
  const SumArgs<T> sa{ws[4], ws[5], ws[6], ws[7], ws[3], ws[2], f(9), static_cast<T*>(out[0]),
                      static_cast<T*>(out[1]), dg, dm0, B, H, S, hd, NC, 0, 0};
  return hd % 64 == 0 ? launch_bwd<T, 64>(ca, ma, sa, B, stream)
                      : launch_bwd<T, 32>(ca, ma, sa, B, stream);
}

}  // namespace

// The chunkwise mLSTM's gradient: the carry pass, the parallel pass and the
// sums, on one stream.
// in (15): q, k, v (B, S, H, hd) in `dtype`, rows contiguous; gates (B, S, 2H)
//   f32; h, dh (B, S, H, hd) in `dtype`, rows contiguous; the forward's kept
//   C_in (B, H, NC, hd, hd), n_in (B, H, NC, hd), m_in (B, H, NC) and n.q
//   (B, S, H), f32 contiguous (NC = ceil(S / 64)); the final state's dC, dn,
//   dm and the final C, n (f32 contiguous; dC, dn, dm NULL for none).
// out (7): dq, dk, dv (B, S, H, hd) in `dtype` contiguous; dgates (B, S, 2H)
//   f32 contiguous; the start state's dC0, dn0, dm0 (NULL: not wanted).
// ws (8), f32: dC at each chunk's end (B, H, NC, hd, hd), dn (B, H, NC, hd),
//   phi (B, S, H), dh.h (B, S, H), the tiles' dq and dk (hd / VT, B, S, H,
//   hd), X (hd / VT, B, S, H) and the end terms (hd / VT, B, H, NC, 2), VT
//   = 64 where hd % 64 == 0, else 32.
// strides (17): (b, s, h) of q, k, v, h, dh; (b, s) of gates.
extern "C" int repro_mlstm_bwd(const void* const* in, void* const* out, void* const* ws,
                               const long long* strides, int dtype, int B, int S, int H, int hd,
                               void* stream) {
  if (B == 0 || H == 0 || S == 0) return cudaSuccess;
  if (B < 0 || H < 0 || S < 0 || (long long)B * H > 65535 || hd < 32 || hd > 512 || hd % 32)
    return cudaErrorInvalidValue;
  float* const* w = reinterpret_cast<float* const*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32: return run_bwd<float>(in, out, w, strides, B, S, H, hd, s);
    case repro::kBFloat16: return run_bwd<__nv_bfloat16>(in, out, w, strides, B, S, H, hd, s);
    default: return cudaErrorInvalidValue;
  }
}

// The columns VT of the value-row tiles the gradient splits C into (the
// caller sizes the tile workspaces with it).
extern "C" int repro_mlstm_bwd_tile(int hd) { return hd % 64 == 0 ? 64 : 32; }
