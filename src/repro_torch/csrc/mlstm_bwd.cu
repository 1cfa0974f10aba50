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
// What bounds it: its least work (the four hd^2 products a token and head)
// takes 0.04 ms at B1 S4096 H4 hd512 in bf16; what holds it is latency:
// the step back over chunks is serial, and the chunked form reads and
// writes each chunk's dC. Four launches, one call:
// * `mlstm_bwd_prep_kernel`, parallel over (chunk, b.h): the per-step
//   scalars everything after it reads: dh_t.h_t, phi_t, the carry's
//   coefficients carry_t / den_t and carry_t phi_t, the chain's inputs,
//   and each chunk's cscale.
// * `mlstm_bwd_carry_kernel`, the reverse pass over chunks, split over
//   dC's (value row, column) tiles: the step back dC <- cscale dC +
//   sum_t carry_t delta_t q_t^T is independent across dC's columns, so a
//   block owns a VT x VT tile of dC in registers (8 x 8 tiles a head at hd
//   512: 256 blocks for B1 H4, where one block a 64-row strip gave 36) and
//   walks the chunks last to first, writing each chunk end's dC, with the
//   chunk's q and dh tiles streamed through a 3-stage cp.async ring. The
//   tiles of value rows 0.. also step the n row's columns back (carry_t
//   phi_t in place of delta_t). One more block a head carries the
//   stabilizer chain (b) back, a chunk's inputs staged in shared memory.
// * `mlstm_bwd_kernel`, parallel over (chunk, value-row tile, b.h): from
//   C_in and the end state's dC of its chunk, dP = delta_tile V_tile^T
//   (+ phi on tile 0) and G = dP . D first; then one walk over 32-column
//   key slices (q, k, C_in, dC through a 3-stage cp.async ring) takes P =
//   q k^T and the tile's shares of dq = G k^ + carry (delta C_in), dk =
//   G^T q + w (V dC) and U = k^ dC^T; last P . D, the gates' terms and dv
//   of the tile's rows whole. k^ = k / sqrt(hd) is scaled after each
//   product, so k enters the products as loaded.
// * `mlstm_bwd_sum_kernel`: dq and dk summed over the tiles in tile order,
//   and per (b, h, chunk) the gates': di~ = sum X, db_t = dh_t.h_t +
//   phi_t n_t.q_t - X_t (+ the end terms at the chunk's last step), df~ its
//   reverse cumsum, added to (b)'s share. No atomics: two calls give the
//   same bits.
//
// Products are split TF32 on mma.sync (csrc/tf32.cuh: hi + lo halves):
// a_lo b_hi + a_hi b_lo + a_hi b_hi. A bf16 input as loaded (q, k, v) is
// TF32-exact, its lo half zero, so the product against that half adds
// exactly zero and is left out (`mmas`): the same bits with one or two
// products in place of three. Every f32 intermediate (delta, dC, G, P . D,
// C_in) keeps its lo half. Tiles lie in shared memory as rows padded by 16
// bytes; a sum over more than one 32-column slice adds each slice's share,
// from zero, in f32 (the tensor cores' accumulator rounds toward zero).
#include <stdint.h>

#include <initializer_list>

#include "common.cuh"
#include "tf32.cuh"

namespace {

using repro::FULL_MASK;
using repro::NEG_INF;
using repro::to_float;
using repro::tf32::Frag;
using repro::tf32::mma;
using repro::tf32::split;

constexpr int NT = 256;     // threads: 8 warps
constexpr int CH = 64;      // timesteps per chunk (the forward kernels')
constexpr int KS = 32;      // key columns per slice
constexpr int PAD = 4;      // floats of padding after an f32 tile's row
constexpr int STAGES = 3;   // tiles in flight: a stage is refilled a step after its last reader

// bf16 inputs as loaded are TF32-exact (their lo halves are zero)
template <typename T> constexpr bool kLoZero = sizeof(T) == 2;

struct Strides {
  long long b, s, h;
};

struct Ln {
  int g, t;
};

// d += a b in split TF32, leaving out a product against a lo half known to
// be zero (ALO, BLO false): it would add exactly zero.
template <bool ALO, bool BLO>
__device__ __forceinline__ void mmas(float (&d)[4], const Frag& a, const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if constexpr (ALO) mma(d, a.lo, bh[0], bh[1]);
  if constexpr (BLO) mma(d, a.hi, bl[0], bl[1]);
  mma(d, a.hi, bh[0], bh[1]);
}

// A operand (16 x 8) from X stored [m][k] (leading dimension ld)
template <typename X_t>
__device__ __forceinline__ Frag a_rm(const X_t* X, int ld, int m0, int k0, Ln l) {
  const X_t* p = X + (m0 + l.g) * ld + k0 + l.t;
  Frag f;
  split(to_float(p[0]), f.hi[0], f.lo[0]);
  split(to_float(p[8 * ld]), f.hi[1], f.lo[1]);
  split(to_float(p[4]), f.hi[2], f.lo[2]);
  split(to_float(p[8 * ld + 4]), f.hi[3], f.lo[3]);
  return f;
}
// A operand from X stored [k][m]
template <typename X_t>
__device__ __forceinline__ Frag a_cm(const X_t* X, int ld, int m0, int k0, Ln l) {
  const X_t* p = X + (k0 + l.t) * ld + m0 + l.g;
  Frag f;
  split(to_float(p[0]), f.hi[0], f.lo[0]);
  split(to_float(p[8]), f.hi[1], f.lo[1]);
  split(to_float(p[4 * ld]), f.hi[2], f.lo[2]);
  split(to_float(p[4 * ld + 8]), f.hi[3], f.lo[3]);
  return f;
}
// A operand from X stored [k][m], row k times s[k]
template <typename X_t>
__device__ __forceinline__ Frag a_cm_scaled(const X_t* X, int ld, int m0, int k0, Ln l,
                                            const float* s) {
  const X_t* p = X + (k0 + l.t) * ld + m0 + l.g;
  const float s0 = s[k0 + l.t], s1 = s[k0 + l.t + 4];
  Frag f;
  split(to_float(p[0]) * s0, f.hi[0], f.lo[0]);
  split(to_float(p[8]) * s0, f.hi[1], f.lo[1]);
  split(to_float(p[4 * ld]) * s1, f.hi[2], f.lo[2]);
  split(to_float(p[4 * ld + 8]) * s1, f.hi[3], f.lo[3]);
  return f;
}
// B operand (8 x 8, k x n) from Y stored [k][n]
template <typename Y_t>
__device__ __forceinline__ void b_km(const Y_t* Y, int ld, int k0, int n0, Ln l,
                                     uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  const Y_t* p = Y + (k0 + l.t) * ld + n0 + l.g;
  split(to_float(p[0]), bh[0], bl[0]);
  split(to_float(p[4 * ld]), bh[1], bl[1]);
}
// B operand from Y stored [n][k]
template <typename Y_t>
__device__ __forceinline__ void b_nm(const Y_t* Y, int ld, int k0, int n0, Ln l,
                                     uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  const Y_t* p = Y + (n0 + l.g) * ld + k0 + l.t;
  split(to_float(p[0]), bh[0], bl[0]);
  split(to_float(p[4]), bh[1], bl[1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[n][e] = 0.f;
}

// The padded row pitch of a streamed tile W elements wide: rows start on 16
// bytes, and consecutive rows shift by 16 bytes of banks
template <int W, typename T>
__host__ __device__ constexpr int pitch() { return W + 16 / int(sizeof(T)); }

// Rows [0, ROWS) x columns [0, W) of a strided slab into a tile of T with
// pitch<W, T>(), rows at or past `rows` as zeros: 16-byte cp.async copies
// when `vec` (the slab's base and row stride on 16 bytes), else plain loads.
template <int ROWS, int W, typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src, long long stride,
                                           int rows, bool vec) {
  constexpr int PER = 16 / int(sizeof(T)), LDT = pitch<W, T>();
  for (int e = threadIdx.x; e < ROWS * W / PER; e += NT) {
    const int r = e / (W / PER), c = (e % (W / PER)) * PER;
    T* d = dst + r * LDT + c;
    const bool ok = r < rows;
    if (vec) {
      repro::cp_async16_zfill(d, src + (ok ? r * stride + c : 0), ok);
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i) d[i] = ok ? src[r * stride + c + i] : repro::from_float<T>(0.f);
    }
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

// ---- the per-step scalars ------------------------------------------------------------

template <typename T>
struct PrepArgs {
  const T* h; const T* dh; const float* g;
  const float* nq;                     // (B, S, H) kept n_t . q_t
  const float* km;                     // (B, H, NC) kept m_in
  float* phi; float* dhh;              // (B, S, H)
  float* co;                           // (B H, 4, NC CH): carry_t / den_t, carry_t phi_t, the
                                       // chain's e_t and won_t, 0 past S
  float* cs;                           // (B H, NC): cscale
  int H, S, hd, NC;
  Strides sh, sdh;
  long long gb, gs;
};

template <typename T>
__global__ void __launch_bounds__(NT) mlstm_bwd_prep_kernel(const PrepArgs<T> a) {
  __shared__ float a_s[CH], M_s[CH], x_s[CH], misc[8];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ci = blockIdx.x, bh = blockIdx.y, b = bh / a.H, hh = bh % a.H;
  const int t0 = ci * CH, Lc = min(CH, a.S - t0);
  const float m_in = a.km[(long long)bh * a.NC + ci];
  if (warp == 0) chunk_scalars(a.g + b * a.gb, a.gs, a.H, hh, t0, Lc, m_in, a_s, M_s, misc);
  const T* hb = a.h + b * a.sh.b + hh * a.sh.h;
  const T* dhb = a.dh + b * a.sdh.b + hh * a.sdh.h;
  for (int t = warp; t < CH; t += NT / 32) {      // dh_t . h_t, a warp a step
    float s = 0.f;
    if (t < Lc)
      for (int c = lane; c < a.hd; c += 32)
        s = fmaf(to_float(dhb[(t0 + t) * a.sdh.s + c]), to_float(hb[(t0 + t) * a.sh.s + c]), s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL_MASK, s, o);
    if (lane == 0) x_s[t] = s;
  }
  __syncthreads();
  if (tid < CH) {
    const int t = tid;
    float cd = 0.f, cph = 0.f, e = 0.f, won = 0.f;
    if (t < Lc) {
      const long long o = ((long long)b * a.S + t0 + t) * a.H + hh;
      const float nqv = a.nq[o];
      float ph = 0.f;
      if (fabsf(nqv) > 1.f) ph = -x_s[t] / nqv;   // -sign(n.q) (dh.h) / den
      a.phi[o] = ph;
      a.dhh[o] = x_s[t];
      const float cw = expf(m_in - M_s[t]);
      cd = cw / fmaxf(fabsf(nqv), 1.f);
      cph = cw * ph;
      e = fabsf(nqv) > 1.f ? 0.f : -x_s[t];
      won = a_s[t] > (t > 0 ? M_s[t - 1] : m_in) ? 1.f : 0.f;
    }
    const long long NP = (long long)a.NC * CH;
    float* co = a.co + (long long)bh * 4 * NP + t0 + t;
    co[0] = cd;
    co[NP] = cph;
    co[2 * NP] = e;
    co[3 * NP] = won;
  }
  if (tid == 0) a.cs[(long long)bh * a.NC + ci] = expf(m_in - misc[0]);
}

// ---- the reverse pass over chunks ------------------------------------------------

template <typename T>
struct CarryArgs {
  const T* q; const T* dh;
  const float* co; const float* cs;    // the prep's
  const float* dCf; const float* dnf; const float* dmf;   // the final state's gradient (NULL: 0)
  const float* Cf; const float* nf;    // the final state (read with dCf, dnf)
  float* dCk; float* dnk;              // (B, H, NC, hd, hd), (B, H, NC, hd): each chunk end's
  float* dg;                           // (B, S, 2H): the chain's share
  float* dC0; float* dn0; float* dm0;  // the start state's (NULL: not wanted)
  int H, S, hd, NC;
  Strides sq, sdh;
  bool vec;                            // q, dh rows on 16 bytes: cp.async
};

template <typename T, int VT>
size_t carry_smem() {
  return STAGES * (2 * CH * pitch<VT, T>() * sizeof(T) + 2 * CH * sizeof(float));
}

template <typename T, int VT>
__global__ void __launch_bounds__(NT, 2) mlstm_bwd_carry_kernel(const CarryArgs<T> a) {
  extern __shared__ float4 smem4[];
  const int hd = a.hd, ntiles = (hd / VT) * (hd / VT);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / a.H, hh = bh % a.H;
  const long long bhc = (long long)bh * a.NC, NP = (long long)a.NC * CH;
  const float* co = a.co + bh * 4 * NP;

  if (int(blockIdx.x) < ntiles) {
    // ---- a VT x VT tile of dC (rows v0.., columns c0..) on the tensor cores ----
    constexpr int LDT = pitch<VT, T>();
    constexpr int RG = VT / 16, WPR = 8 / RG, NB = VT / 8 / WPR;
    const int v0 = (blockIdx.x / (hd / VT)) * VT, c0 = (blockIdx.x % (hd / VT)) * VT;
    const Ln l{lane >> 2, lane & 3};
    const int rg = warp / WPR, nb0 = (warp % WPR) * NB;
    const bool nrow = v0 == 0;                    // the tile also steps the n row's columns back
    T* ring = reinterpret_cast<T*>(smem4);        // stage s: q [CH][LDT], dh [CH][LDT]
    float* cring = reinterpret_cast<float*>(ring + STAGES * 2 * CH * LDT);   // [CH] x2 a stage
    const T* qb = a.q + b * a.sq.b + hh * a.sq.h + c0;
    const T* db = a.dh + b * a.sdh.b + hh * a.sdh.h + v0;
    auto issue = [&](int i) {                     // chunk NC - 1 - i into stage i % STAGES
      if (i < a.NC) {
        const int ci = a.NC - 1 - i, t0 = ci * CH, Lc = min(CH, a.S - t0);
        T* st = ring + (i % STAGES) * 2 * CH * LDT;
        stage_tile<CH, VT>(st, qb + t0 * a.sq.s, a.sq.s, Lc, a.vec);
        stage_tile<CH, VT>(st + CH * LDT, db + t0 * a.sdh.s, a.sdh.s, Lc, a.vec);
        float* cst = cring + (i % STAGES) * 2 * CH;
        if (tid < 2 * CH / 4)                     // carry_t / den_t, carry_t phi_t
          repro::cp_async16(cst + 4 * tid, co + (tid >= CH / 4 ? NP - CH : 0) + t0 + 4 * tid);
      }
      repro::cp_async_commit();
    };
    issue(0);
    float dC[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * rg + l.g + 8 * (e >> 1), c = 8 * (nb0 + n) + 2 * l.t + (e & 1);
        dC[n][e] = a.dCf != nullptr ? a.dCf[((long long)bh * hd + v0 + r) * hd + c0 + c] : 0.f;
      }
    float dn = nrow && tid < VT && a.dnf != nullptr ? a.dnf[(long long)bh * hd + c0 + tid] : 0.f;
    for (int i = 0; i < a.NC; ++i) {
      const int ci = a.NC - 1 - i, Lc = min(CH, a.S - ci * CH);
      const float cscale = a.cs[bhc + ci];
      issue(i + 1);
      repro::cp_async_wait<1>();                  // chunk i: this thread's copies
      __syncthreads();                            // and every thread's
      const T* Qs = ring + (i % STAGES) * 2 * CH * LDT;
      const T* Dh = Qs + CH * LDT;
      const float* cd_s = cring + (i % STAGES) * 2 * CH;
      float d[NB][4];
      zero(d);
#pragma unroll
      for (int ks = 0; ks < CH / 8; ++ks) {       // (carry delta)^T Q over the chunk's steps
        const Frag fa = a_cm_scaled(Dh, LDT, 16 * rg, 8 * ks, l, cd_s);
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          uint32_t fh[2], fl[2];
          b_km(Qs, LDT, 8 * ks, 8 * (nb0 + n), l, fh, fl);
          mmas<true, !kLoZero<T>>(d[n], fa, fh, fl);
        }
      }
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          const int r = 16 * rg + l.g + 8 * i2, c = 8 * (nb0 + n) + 2 * l.t;
          *reinterpret_cast<float2*>(a.dCk + ((bhc + ci) * hd + v0 + r) * hd + c0 + c) =
              make_float2(dC[n][2 * i2], dC[n][2 * i2 + 1]);
          dC[n][2 * i2] = fmaf(cscale, dC[n][2 * i2], d[n][2 * i2]);
          dC[n][2 * i2 + 1] = fmaf(cscale, dC[n][2 * i2 + 1], d[n][2 * i2 + 1]);
        }
      if (nrow && tid < VT) {                     // dn <- cscale dn + sum_t carry_t phi_t q_t
        const float* cph = cd_s + CH;
        float acc = 0.f;
        for (int t = 0; t < Lc; ++t) acc = fmaf(cph[t], to_float(Qs[t * LDT + tid]), acc);
        a.dnk[(bhc + ci) * hd + c0 + tid] = dn;
        dn = fmaf(cscale, dn, acc);
      }
    }
    repro::cp_async_wait<0>();
    if (a.dC0 != nullptr)
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          const int r = 16 * rg + l.g + 8 * i2, c = 8 * (nb0 + n) + 2 * l.t;
          *reinterpret_cast<float2*>(a.dC0 + ((long long)bh * hd + v0 + r) * hd + c0 + c) =
              make_float2(dC[n][2 * i2], dC[n][2 * i2 + 1]);
        }
    if (nrow && tid < VT && a.dn0 != nullptr) a.dn0[(long long)bh * hd + c0 + tid] = dn;
    return;
  }

  // ---- the stabilizer chain (b), from the prep's e_t and won_t ----
  float* e_s = reinterpret_cast<float*>(smem4);   // [CH]
  float* won_s = e_s + CH;                        // [CH]
  float* red = won_s + CH;                        // [8]
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
  float g = 0.f;                                  // thread 0: the chain's carry
  for (int ci = a.NC - 1; ci >= 0; --ci) {
    const int t0 = ci * CH, Lc = min(CH, a.S - t0);
    __syncthreads();                              // the last chunk's reads are done
    if (tid < CH) {
      e_s[tid] = co[2 * NP + t0 + tid];
      won_s[tid] = co[3 * NP + t0 + tid];
    }
    __syncthreads();
    if (tid == 0) {
      for (int t = Lc - 1; t >= 0; --t) {
        g += e_s[t] + (t0 + t == a.S - 1 ? e_last : 0.f);
        const bool won = won_s[t] != 0.f;
        const long long o = ((long long)b * a.S + t0 + t) * 2 * a.H + hh;
        a.dg[o] = won ? g : 0.f;
        a.dg[o + a.H] = won ? 0.f : g;
        if (won) g = 0.f;
      }
    }
  }
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
  bool vec;                            // q, k rows on 16 bytes: cp.async
};

template <typename T, int VT>
size_t main_smem() {
  const size_t stage = 2 * CH * pitch<KS, T>() * sizeof(T) + 2 * VT * (KS + PAD) * sizeof(float);
  return STAGES * stage +
         4 * (size_t(2 * CH * (VT + PAD)) + 2 * CH * (CH + PAD) + 13 * CH + 16);
}

template <typename T, int VT>
__global__ void __launch_bounds__(NT, 1) mlstm_bwd_kernel(const MainArgs<T> a) {
  constexpr int LD = KS + PAD, LDT = pitch<KS, T>(), LDV = VT + PAD, LDP = CH + PAD;
  constexpr int NU = VT / 16;          // 8-column blocks of a warp's half of U and dv
  constexpr bool QLO = !kLoZero<T>;    // a q, k or v operand's lo half can be nonzero
  constexpr size_t STAGE = 2 * CH * LDT * sizeof(T) + 2 * VT * LD * sizeof(float);
  extern __shared__ float4 smem4[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem4);   // stage s: q, k [CH][LDT]
                                                                   // (T), C_in, dC [VT][LD]
  float* Ds = reinterpret_cast<float*>(ring + STAGES * STAGE);     // [CH][LDV] delta = dh / den
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
  float* misc = red + 8;                          // [0] M_end

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
  auto issue = [&](int j) {                       // key slice j into stage j % STAGES
    if (j < NSL) {
      unsigned char* st = ring + (j % STAGES) * STAGE;
      T* qs = reinterpret_cast<T*>(st);
      float* cst = reinterpret_cast<float*>(st + 2 * CH * LDT * sizeof(T));
      stage_tile<CH, KS>(qs, qb + j * KS, a.sq.s, Lc, a.vec);
      stage_tile<CH, KS>(qs + CH * LDT, kb + j * KS, a.sk.s, Lc, a.vec);
      stage_tile<VT, KS>(cst, Cin + j * KS, hd, VT, true);
      stage_tile<VT, KS>(cst + VT * LD, dCo + j * KS, hd, VT, true);
    }
    repro::cp_async_commit();
  };
  issue(0);

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
    Ds[t * LDV + i] = in ? to_float(dhb[t * a.sdh.s + i]) / den_s[t] : 0.f;
    Vs[t * LDV + i] = in ? to_float(vb[t * a.sv.s + i]) : 0.f;
  }
  __syncthreads();

  // dP = delta_tile V_tile^T (+ phi_t on tile 0), G = dP . D; warp (rg, half):
  // rows 16 rg.., columns 32 half..
  const int rg = warp >> 1, half = warp & 1;
  const bool p_live = 32 * half <= 16 * rg + 15;  // else the causal mask covers the block
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
        mmas<true, QLO>(dP[n], fd, fh, fl);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = 16 * rg + l.g + 8 * (e >> 1), s = 32 * half + 8 * n + 2 * l.t + (e & 1);
      const float D = s <= t && t < Lc ? expf(a_s[s] - M_s[t]) : 0.f;
      dP[n][e] += phi_s[t];
      Gs[t * LDP + s] = dP[n][e] * D;
    }

  // one walk over the key slices: P (rows 16 rg.., columns 32 half..), dq
  // and dk (rows 16 rq.., columns cq.. of the slice), U (rows 16 rq..,
  // columns cu.. of the tile)
  const int rq = warp >> 1, cq = (warp & 1) * 16, cu = (warp & 1) * (VT / 2);
  float P[4][4], U[NU][4];
  zero(P);
  zero(U);
  float gcs = 0.f, kd = 0.f;
  const int ks_row = tid >> 2, ks_q = tid & 3;   // k . dn: row ks_row, columns 8 ks_q..
  for (int j = 0; j < NSL; ++j) {
    issue(j + 1);
    repro::cp_async_wait<1>();                    // slice j: this thread's copies
    __syncthreads();                              // and every thread's; Gs is written
    const unsigned char* st = ring + (j % STAGES) * STAGE;
    const T* Qs = reinterpret_cast<const T*>(st);
    const T* Ks = Qs + CH * LDT;
    const float* Cs = reinterpret_cast<const float*>(st + 2 * CH * LDT * sizeof(T));
    const float* dCs = Cs + VT * LD;
    for (int e = tid; e < VT * KS; e += NT) {
      const int r = e / KS, c = e % KS;
      gcs = fmaf(Cs[r * LD + c], dCs[r * LD + c], gcs);
    }
    if (tile == 0)
#pragma unroll
      for (int c = 8 * ks_q; c < 8 * ks_q + 8; ++c)
        kd = fmaf(to_float(Ks[ks_row * LDT + c]), dno[j * KS + c], kd);
    if (p_live) {                                 // P += q k^T over the slice
      float Pt[4][4];
      zero(Pt);
#pragma unroll
      for (int kc = 0; kc < KS; kc += 8) {
        const Frag fq = a_rm(Qs, LDT, 16 * rg, kc, l);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          uint32_t fh[2], fl[2];
          b_nm(Ks, LDT, kc, 32 * half + 8 * n, l, fh, fl);
          mmas<QLO, QLO>(Pt[n], fq, fh, fl);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) repro::tf32::add(P[n], Pt[n]);
    }

    float x1[2][4], x2[2][4];                     // dq: G k, delta C_in
    zero(x1);
    zero(x2);
    for (int kc = 0; kc < 16 * rq + 16; kc += 8) {   // G_ts = 0 for s > t
      const Frag fg = a_rm(Gs, LDP, 16 * rq, kc, l);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        uint32_t fh[2], fl[2];
        b_km(Ks, LDT, kc, cq + 8 * n, l, fh, fl);
        mmas<true, QLO>(x1[n], fg, fh, fl);
      }
    }
#pragma unroll
    for (int kc = 0; kc < VT; kc += 8) {
      const Frag fd = a_rm(Ds, LDV, 16 * rq, kc, l);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        uint32_t fh[2], fl[2];
        b_km(Cs, LD, kc, cq + 8 * n, l, fh, fl);
        mmas<true, true>(x2[n], fd, fh, fl);
      }
    }
    float y1[2][4], y2[2][4];                     // dk^: G^T q, V dC
    zero(y1);
    zero(y2);
    for (int kc = 16 * rq; kc < CH; kc += 8) {    // G_ts = 0 for t < s
      const Frag fg = a_cm(Gs, LDP, 16 * rq, kc, l);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        uint32_t fh[2], fl[2];
        b_km(Qs, LDT, kc, cq + 8 * n, l, fh, fl);
        mmas<true, QLO>(y1[n], fg, fh, fl);
      }
    }
#pragma unroll
    for (int kc = 0; kc < VT; kc += 8) {
      const Frag fv = a_rm(Vs, LDV, 16 * rq, kc, l);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        uint32_t fh[2], fl[2];
        b_km(dCs, LD, kc, cq + 8 * n, l, fh, fl);
        mmas<QLO, true>(y2[n], fv, fh, fl);
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
            make_float2(fmaf(cw, e0, x1[n][2 * i2] * inv_sqrt_hd),
                        fmaf(cw, e1, x1[n][2 * i2 + 1] * inv_sqrt_hd));
        *reinterpret_cast<float2*>(a.dk_p + o) =
            make_float2(fmaf(w, f0, y1[n][2 * i2]) * inv_sqrt_hd,
                        fmaf(w, f1, y1[n][2 * i2 + 1]) * inv_sqrt_hd);
      }
    float Ut[NU][4];                              // U += k dC^T
    zero(Ut);
#pragma unroll
    for (int kc = 0; kc < KS; kc += 8) {
      const Frag fk = a_rm(Ks, LDT, 16 * rq, kc, l);
#pragma unroll
      for (int n = 0; n < NU; ++n) {
        uint32_t fh[2], fl[2];
        b_nm(dCs, LD, kc, cu + 8 * n, l, fh, fl);
        mmas<QLO, true>(Ut[n], fk, fh, fl);
      }
    }
#pragma unroll
    for (int n = 0; n < NU; ++n) repro::tf32::add(U[n], Ut[n]);
  }
  repro::cp_async_wait<0>();

  // P . D and gD's column sums, now that P is whole (P^ = P / sqrt(hd))
  float cs[4][2];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    cs[n][0] = cs[n][1] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = 16 * rg + l.g + 8 * (e >> 1), s = 32 * half + 8 * n + 2 * l.t + (e & 1);
      const float D = s <= t && t < Lc ? expf(a_s[s] - M_s[t]) : 0.f;
      const float pd = P[n][e] * inv_sqrt_hd * D;
      PDs[t * LDP + s] = pd;
      cs[n][e & 1] = fmaf(dP[n][e], pd, cs[n][e & 1]);
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
#pragma unroll
  for (int n = 0; n < NU; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) U[n][e] *= inv_sqrt_hd;
  __syncthreads();                                // PDs written

  // dv = (P . D)^T delta + w_s U_s, whole for the tile's rows; v_s . U_s
  float o[NU][4];
  zero(o);
  for (int kc = 16 * rq; kc < CH; kc += 8) {      // (P . D)_ts = 0 for t < s
    const Frag fp = a_cm(PDs, LDP, 16 * rq, kc, l);
#pragma unroll
    for (int n = 0; n < NU; ++n) {
      uint32_t fh[2], fl[2];
      b_km(Ds, LDV, kc, cu + 8 * n, l, fh, fl);
      mmas<true, true>(o[n], fp, fh, fl);
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
  if (ks_q == 0) kdn[ks_row] = tile == 0 ? kd * inv_sqrt_hd : 0.f;
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
cudaError_t launch_bwd(const PrepArgs<T>& pa, const CarryArgs<T>& ca, const MainArgs<T>& ma,
                       SumArgs<T> sa, int B, cudaStream_t stream) {
  const int hd = ca.hd, NTILE = hd / VT, BH = B * ca.H;
  const int c_smem = int(carry_smem<T, VT>()), m_smem = int(main_smem<T, VT>());
  cudaError_t err = cudaFuncSetAttribute(mlstm_bwd_carry_kernel<T, VT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, c_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mlstm_bwd_kernel<T, VT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             m_smem);
  if (err != cudaSuccess) return err;
  mlstm_bwd_prep_kernel<T><<<dim3(ca.NC, BH), NT, 0, stream>>>(pa);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_bwd_carry_kernel<T, VT><<<dim3(NTILE * NTILE + 1, BH), NT, c_smem, stream>>>(ca);
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
bool on16(const void* p, std::initializer_list<long long> strides) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (long long s : strides)
    if (s % (16 / static_cast<long long>(sizeof(T)))) return false;
  return true;
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
  const bool vec = on16<T>(q, {sq.b, sq.s, sq.h}) && on16<T>(k, {sk.b, sk.s, sk.h}) &&
                   on16<T>(dh, {sdh.b, sdh.s, sdh.h});
  float* dg = static_cast<float*>(out[3]);
  float* dm0 = static_cast<float*>(out[6]);
  const PrepArgs<T> pa{h, dh, g, f(9), f(8), ws[2], ws[3], ws[8], ws[9], H, S, hd, NC, sh, sdh,
                       gb, gs};
  const CarryArgs<T> ca{q, dh, ws[8], ws[9], f(10), f(11), f(12), f(13), f(14), ws[0], ws[1], dg,
                        static_cast<float*>(out[4]), static_cast<float*>(out[5]), dm0, H, S, hd,
                        NC, sq, sdh, vec};
  const MainArgs<T> ma{q, k, v, dh, g, f(6), f(7), f(8), f(9), ws[0], ws[1], ws[2],
                       static_cast<T*>(out[2]), ws[4], ws[5], ws[6], ws[7], B, H, S, hd, NC,
                       sq, sk, sv, sdh, gb, gs, vec};
  const SumArgs<T> sa{ws[4], ws[5], ws[6], ws[7], ws[3], ws[2], f(9), static_cast<T*>(out[0]),
                      static_cast<T*>(out[1]), dg, dm0, B, H, S, hd, NC, 0, 0};
  return hd % 64 == 0 ? launch_bwd<T, 64>(pa, ca, ma, sa, B, stream)
                      : launch_bwd<T, 32>(pa, ca, ma, sa, B, stream);
}

}  // namespace

// The chunkwise mLSTM's gradient: the per-step scalars, the carry pass, the
// parallel pass and the sums, on one stream.
// in (15): q, k, v (B, S, H, hd) in `dtype`, rows contiguous; gates (B, S, 2H)
//   f32; h, dh (B, S, H, hd) in `dtype`, rows contiguous; the forward's kept
//   C_in (B, H, NC, hd, hd), n_in (B, H, NC, hd), m_in (B, H, NC) and n.q
//   (B, S, H), f32 contiguous (NC = ceil(S / 64)); the final state's dC, dn,
//   dm and the final C, n (f32 contiguous; dC, dn, dm NULL for none).
// out (7): dq, dk, dv (B, S, H, hd) in `dtype` contiguous; dgates (B, S, 2H)
//   f32 contiguous; the start state's dC0, dn0, dm0 (NULL: not wanted).
// ws (10), f32: dC at each chunk's end (B, H, NC, hd, hd), dn (B, H, NC, hd),
//   phi (B, S, H), dh.h (B, S, H), the tiles' dq and dk (hd / VT, B, S, H,
//   hd), X (hd / VT, B, S, H), the end terms (hd / VT, B, H, NC, 2), the
//   per-step coefficients (B, H, 4, NC * 64) and cscale (B, H, NC), VT = 64
//   where hd % 64 == 0, else 32.
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
