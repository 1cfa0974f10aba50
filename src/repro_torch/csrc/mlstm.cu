// Chunkwise mLSTM (xLSTM matrix memory) for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_mlstm_kernel` / `mlstm_chunkwise` in
// src/repro/kernels/mlstm/kernel.py. For each (batch b, head h), with the
// state (C[d_v, d_k], n[d_k], m) starting at (C0, n0, m0) (zeros when absent)
// and K^ = K / sqrt(hd), each chunk of timesteps computes (b_t = inclusive
// cumsum of f~ within the chunk):
//
//   M_t  = max(m_in, cummax_{s<=t}(i~_s - b_s)),  D_ts = exp(i~_s - b_s - M_t) [s <= t]
//   P    = (q K^T) . D                                    (chunk x chunk)
//   h_t  = (P V + exp(m_in - M_t) q C_in^T)_t / max(|sum_s P_ts + exp(m_in - M_t) n_in.q_t|, 1)
//   C    = exp(m_in - M_c) C_in + sum_s exp(i~_s - b_s - M_c) v_s k^_s^T,  n likewise,
//   m    = b_c + M_c
//
// which is the sequential recurrence of kernels/mlstm/ref.py regrouped. It
// returns h (B, S, H, hd) in q's type and the final (C, n, m) in f32.
//
// Two kernels here, chosen by the wrapper (kernels/mlstm/kernel.py):
// * `mlstm_tf32_kernel<T, VT, KEEP>`, the chunkwise form for f32 q/k/v and for the
//   bf16 calls csrc/mlstm_tc.cu does not take (its head dims are multiples
//   of 64 on TMA-aligned inputs), every product on the tensor cores as split
//   TF32 (csrc/tf32.cuh: hi + lo halves of every operand, three mma.sync
//   m16n8k8 a product): f32 callers (the reduced models, whose
//   card-equals-CPU checks hold 1e-4) need products near f32's, which one
//   TF32 product would not give (emulated on the CPU in
//   tests/test_torch_mlstm_tf32.py). bf16 inputs become f32 on load (exact);
//   the arithmetic is the same;
// * `mlstm_step_kernel`, the decode step (S of a few timesteps, either
//   dtype): one pass over C. At decode (S = 1) the state is the work, a read
//   and a write of C (67 MB at B 8, H 4, hd 512), so it is bound by bytes.
//
// What bounds the chunkwise form: at xlstm-350m's prefill shape (B 8, S
// 4096, H 4, hd 512) ~1.5e11 operations against ~1.1 GB in f32, so
// operations, at a third of the TF32 rate for split products.
//
// Design of the split-TF32 chunkwise kernel (the layout of mlstm_tc.cu):
// * The state does not fit an SM (C is 1 MB of f32 per (b, h) at hd 512), so
//   each block owns VT value rows of C, C[v0:v0+VT, :] (VT 64 where hd % 64
//   == 0, else 32; 128 KB at hd 512), in shared memory in f32 for the whole
//   sequence, its master copy: grid (hd / VT, B * H). The TPU kernel's
//   sequential chunk axis becomes a loop inside the block over chunks of 64
//   timesteps; nothing carries over between blocks, and each block owns its
//   outputs (the same bits every run).
// * C lies as hd / 32 column slices of VT x 32 floats, and q and K stream
//   per chunk as 64 x 32 slices through a cp.async ring (zero fill past S),
//   so every tile the products read has a row of 32 or 64 floats whatever
//   hd is (csrc/tf32.cuh's swizzle). The V tile (64 x VT) arrives once a
//   chunk; (V w)^T, with w_s = exp(a_s - M_c) / sqrt(hd), is read from it
//   as A fragments (`frag_trows`), no transposed copy.
// * 8 warps. Per 32-column slice j of the key dim: warp (g, half) owns the
//   chunk's rows 16 g .. 16 g + 15 and half of the columns of P += q_j K_j^T
//   (skipped where the causal mask covers them) and of inter += q_j C_j^T
//   (C's old values); n_in.q runs beside them on FMAs. Then, after a barrier,
//   C_j = cscale C_j + (V w)^T K_j, each warp 16 rows of C, and n_j on FMAs.
//   Each slice's share of P and inter starts at zero and joins its running
//   sum by an f32 add, and (V w)^T K_j, from zero over the chunk's 64 steps,
//   joins C by an f32 FMA: the tensor cores round their accumulator toward
//   zero. Every operand is split where a fragment reads it.
// * Choices measured on an H100 (tools/mlstm_variants.py, PERF.md): every
//   block recomputes q K^T, a third of its products: sharing it over a
//   thread-block cluster of the head's blocks through distributed shared
//   memory was slower, as were 32 rows of C a block (twice the blocks),
//   (V w)^T kept in registers for the chunk (spills), K split once a slice
//   (a barrier more) and each slice's C update moved into the next slice.
// * Epilogue: P' = P / sqrt(hd) . D in f32 goes to shared memory (its
//   columns in the accumulator's k order, so that P' V reads it with
//   `frag_rows` beside `frag_krows` on V); the row sums of P' (two warps a
//   row) give the denominator; intra = P' V from zero; h = (intra + cw
//   inter) / den is stored from the fragments, a row's 8-byte pieces side by
//   side.
// * What the gradient (mlstm_bwd.cu) starts from, with KEEP (a template
//   argument, so serving's instantiation has none of it): each block writes
//   its rows of C as each chunk starts (C_in, the update's old values), and
//   the block of tile 0 n_in, m_in and each step's n.q (the denominator
//   before its clamp).
// * Every block keeps its own copy of n (updated identically); the block of
//   tile 0 writes n and m out. Ragged S: rows past S load as zeros, and a
//   ragged last chunk is masked through its gates (i~ = NEG_INF, so w = 0);
//   q/k/v are read through their (B, S, H, hd) strides (cp.async of 16 bytes
//   where f32 base and strides allow, else plain loads) and the gates from
//   (B, S, 2H); the outputs are fresh buffers (n0 and m0 are read
//   by every tile, so they may not alias).
#include <stdint.h>

#include "common.cuh"
#include "tf32.cuh"

namespace {

using namespace repro::tf32;
using repro::NEG_INF;
using repro::FULL_MASK;

constexpr int NT = 256;                 // threads: 8 warps
constexpr int CH = 64;                  // timesteps per chunk
constexpr int KS = 32;                  // key columns per streamed slice
// q/K slice stages in flight: with 3, a stage is refilled a slice after its
// last reader with no barrier between (2 took a third barrier a slice)
constexpr int RING = 3;

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename T>
struct Args {
  const T* q; const T* k; const T* v; const float* g;
  const float* C0; const float* n0; const float* m0;
  T* h; float* C; float* n; float* m;
  // kept for the gradient (NULL: not kept): each chunk's start C (B, H, NC,
  // hd, hd), n (B, H, NC, hd) and m (B, H, NC), and each step's n.q (B, S, H)
  float* kC; float* kn; float* km; float* knq;
  int H, S, hd;
  Strides sq, sk, sv, sh;
  long long gb, gs;
  int vec;                              // f32 q/k/v: base and strides in 16-byte units
};

template <int VT>
size_t smem_bytes(int hd) {
  // C | ring of (q, K) slices | V | P' | n | scalars
  return 4 * (size_t(VT) * hd + RING * 2 * CH * KS + CH * VT + CH * CH + hd + 8 * CH + 4);
}

// Rows [row0, row0 + CH) of a strided (S, W) slab into a swizzled f32 tile
// (csrc/tf32.cuh's layout); rows at or past `limit` land as zeros. 16-byte
// copies for aligned f32, else plain converting loads (the ring's barriers
// make their stores visible as they do the copies').
template <int W, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, long long stride,
                                          int row0, int limit, int vec) {
  if constexpr (sizeof(T) == 4) {
    if (vec) {
      load_tile<W, CH, NT>(dst, src, stride, row0, limit);
      return;
    }
  }
  for (int i = threadIdx.x; i < CH * W; i += NT) {
    const int r = i / W, c = i % W;
    dst[r * W + (c ^ 4 * (r & 7))] =
        row0 + r < limit ? repro::to_float(src[(row0 + r) * stride + c]) : 0.f;
  }
}

template <typename T, int VT, bool KEEP>
__global__ void __launch_bounds__(NT, 1) mlstm_tf32_kernel(const Args<T> a) {
  constexpr int NI = VT / 16;           // 8-column blocks of a warp's half of inter and intra
  constexpr int WPR = 128 / VT;         // warps on 16 rows of C in the update
  constexpr int NB = 4 / WPR;           // its 8-column blocks of a slice
  extern __shared__ float4 smem_f4[];
  const int hd = a.hd, NSL = hd / KS;
  float* Cs = reinterpret_cast<float*>(smem_f4);   // NSL slices of [VT][KS]
  float* ring = Cs + VT * hd;                      // stage s: q slice [CH][KS], then K slice
  float* Vs = ring + RING * 2 * CH * KS;           // [CH][VT] v tile
  float* Ps = Vs + CH * VT;                        // [CH][CH] P', columns in k order
  float* ns = Ps + CH * CH;                        // [hd] n
  float* a_s = ns + hd;                            // [CH] i~_s - b_s
  float* M_s = a_s + CH;                           // [CH] M_t
  float* cw_s = M_s + CH;                          // [CH] exp(m_in - M_t)
  float* w_s = cw_s + CH;                          // [CH] exp(a_s - M_c) / sqrt(hd), 0 past the end
  float* rs_s = w_s + CH;                          // [2][CH] P' row sums by half
  float* nq_s = rs_s + 2 * CH;                     // [CH] n_in . q_t
  float* misc = nq_s + CH;                         // [0] m, [1] exp(m_in - M_c), [2] next m

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Lane l = lane_of(lane);
  const int bh = blockIdx.y, b = bh / a.H, hh = bh % a.H;
  const int v0 = blockIdx.x * VT;
  const int n_chunks = (a.S + CH - 1) / CH;
  const float inv_sqrt_hd = 1.f / sqrtf(float(hd));
  const int rg = warp / 2, half = warp % 2;        // products: rows 16 rg.., half the columns
  const int rc = warp / WPR, nb0 = (warp % WPR) * NB;   // C's update: rows 16 rc.., blocks nb0..
  const int nc = 4 * warp + (lane & 3), np = lane >> 2;  // n's: column nc, rows np + 8 u

  // C[v0 + r, 4 c4 .. 4 c4 + 3] in the tile, and in C0 and C
  const auto ctile = [&](int r, int c4) {
    return reinterpret_cast<float4*>(Cs + (c4 / 8) * VT * KS + r * KS + 4 * ((c4 % 8) ^ (r & 7)));
  };
  const auto crow = [&](int r) { return ((long long)bh * hd + v0 + r) * hd; };
  for (int e = tid; e < VT * hd / 4; e += NT) {
    const int r = e / (hd / 4), c4 = e % (hd / 4);
    *ctile(r, c4) = a.C0 != nullptr ? reinterpret_cast<const float4*>(a.C0 + crow(r))[c4]
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int c = tid; c < hd; c += NT) ns[c] = a.n0 != nullptr ? a.n0[(long long)bh * hd + c] : 0.f;
  if (tid == 0) misc[0] = a.m0 != nullptr ? a.m0[bh] : 0.f;

  const T* qb = a.q + b * a.sq.b + hh * a.sq.h;
  const T* kb = a.k + b * a.sk.b + hh * a.sk.h;
  const T* vb = a.v + b * a.sv.b + hh * a.sv.h + v0;
  T* hb = a.h + b * a.sh.b + hh * a.sh.h + v0;
  const float* gp = a.g + b * a.gb;
  const int n_slices = n_chunks * NSL;
  auto issue = [&](int i) {             // slice i of the walk (chunk i / NSL) into stage i % RING
    if (i < n_slices) {
      const int t0 = (i / NSL) * CH, c0 = (i % NSL) * KS;
      float* dst = ring + (i % RING) * 2 * CH * KS;
      load_rows<KS>(dst, qb + c0, a.sq.s, t0, a.S, a.vec);
      load_rows<KS>(dst + CH * KS, kb + c0, a.sk.s, t0, a.S, a.vec);
    }
    repro::cp_async_commit();
  };

  issue(0);
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * CH, Lc = min(CH, a.S - t0);
    __syncthreads();                    // the last chunk's readers are done; the state is loaded
    load_rows<VT>(Vs, vb, a.sv.s, t0, a.S, a.vec);
    repro::cp_async_commit();
    if (warp == 0) {
      // the chunk's scalars; lane holds timesteps 2 lane and 2 lane + 1
      const float m_in = misc[0];
      const int ta = 2 * lane, tb = ta + 1;
      float i0 = NEG_INF, i1 = NEG_INF, f0 = 0.f, f1 = 0.f;
      if (ta < Lc) { i0 = gp[(t0 + ta) * a.gs + hh]; f0 = gp[(t0 + ta) * a.gs + a.H + hh]; }
      if (tb < Lc) { i1 = gp[(t0 + tb) * a.gs + hh]; f1 = gp[(t0 + tb) * a.gs + a.H + hh]; }
      float incl = f0 + f1;             // inclusive cumsum of f~ over lanes
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(FULL_MASK, incl, o);
        if (lane >= o) incl += y;
      }
      float excl = __shfl_up_sync(FULL_MASK, incl, 1);
      if (lane == 0) excl = 0.f;
      const float b0 = excl + f0, b1 = b0 + f1;
      const float a0 = i0 - b0, a1 = i1 - b1;
      float mx = fmaxf(a0, a1);         // inclusive cummax over lanes
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
      const float M_c = __shfl_sync(FULL_MASK, (tl & 1) ? M1 : M0, tl / 2);
      const float b_c = __shfl_sync(FULL_MASK, (tl & 1) ? b1 : b0, tl / 2);
      a_s[ta] = a0;
      a_s[tb] = a1;
      M_s[ta] = M0;
      M_s[tb] = M1;
      cw_s[ta] = expf(m_in - M0);
      cw_s[tb] = expf(m_in - M1);
      w_s[ta] = ta < Lc ? expf(a0 - M_c) * inv_sqrt_hd : 0.f;
      w_s[tb] = tb < Lc ? expf(a1 - M_c) * inv_sqrt_hd : 0.f;
      if (lane == 0) {
        misc[1] = expf(m_in - M_c);
        misc[2] = b_c + M_c;
        if (KEEP && blockIdx.x == 0) a.km[(long long)bh * n_chunks + ci] = m_in;
      }
    }

    // the lane's rows 16 rg + g (+ 8): P's columns 32 half + 8 n + 2t (+ 1),
    // inter's VT / 2 half + 8 n + 2t (+ 1); running sums and the share
    float P[4][4], I[NI][4], Pt[4][4], It[NI][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int n = 0; n < 4; ++n) P[n][e] = Pt[n][e] = 0.f;
#pragma unroll
      for (int n = 0; n < NI; ++n) I[n][e] = It[n][e] = 0.f;
    }
    // a slice's share of P and inter joins the running sums by an f32 add
    const auto join_shares = [&]() {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        add(P[n], Pt[n]);
#pragma unroll
        for (int e = 0; e < 4; ++e) Pt[n][e] = 0.f;
      }
#pragma unroll
      for (int n = 0; n < NI; ++n) {
        add(I[n], It[n]);
#pragma unroll
        for (int e = 0; e < 4; ++e) It[n][e] = 0.f;
      }
    };
    float nq = 0.f;                     // n_in . q_t over this thread's columns
    const bool p_live = 32 * half <= 16 * rg + 15;
    float cscale = 0.f;
    // C_jj = cscale C_jj + (V w)^T K_jj and n_jj = cscale n_jj + nsum_jj,
    // with K_jj from slice ii of the walk
    const auto update = [&](int jj, int ii, float nsum_jj) {
      const float* Kt = ring + (ii % RING) * 2 * CH * KS + CH * KS;
      float* Ct = Cs + jj * VT * KS;
      float d[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < CH / 8; ++ks) {
        const Frag fa = frag_trows<VT>(Vs, w_s, ks * 8, 16 * rc, l);   // (V w)^T
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          uint32_t fh[2], fl[2];
          frag_krows<KS>(Kt, ks * 8, 8 * (nb0 + n), l, fh, fl);
          mma3(d[n], fa, fh, fl);
        }
      }
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          const int r = 16 * rc + l.g + 8 * i2, c = 8 * (nb0 + n) + 2 * l.t;
          float2* cp = reinterpret_cast<float2*>(Ct + r * KS + (c ^ 4 * (r & 7)));
          const float2 old = *cp;
          if constexpr (KEEP)
            *reinterpret_cast<float2*>(
                a.kC + (((long long)bh * n_chunks + ci) * hd + v0 + r) * hd + jj * KS + c) = old;
          *cp = make_float2(fmaf(cscale, old.x, d[n][2 * i2]),
                            fmaf(cscale, old.y, d[n][2 * i2 + 1]));
        }
      if (np == 0) {
        if (KEEP && blockIdx.x == 0)
          a.kn[((long long)bh * n_chunks + ci) * hd + jj * KS + nc] = ns[jj * KS + nc];
        ns[jj * KS + nc] = fmaf(cscale, ns[jj * KS + nc], nsum_jj);
      }
    };
    for (int j = 0; j < NSL; ++j) {
      const int i = ci * NSL + j;
      issue(i + 1);
      repro::cp_async_wait<1>();        // slice i (and V): this thread's copies
      __syncthreads();                  // and every thread's; the scalars are written
      if (j == 0) cscale = misc[1];
      const float* Qs = ring + (i % RING) * 2 * CH * KS;
      const float* Ks = Qs + CH * KS;
      float* Cj = Cs + j * VT * KS;
      float nacc = 0.f;                 // n's share sum_s w_s K_s, for column nc
#pragma unroll
      for (int u = 0; u < CH / 8; ++u) {
        const int s = np + 8 * u;
        nacc = fmaf(w_s[s], Ks[s * KS + (nc ^ 4 * (s & 7))], nacc);
      }
      nacc += __shfl_xor_sync(FULL_MASK, nacc, 4);
      nacc += __shfl_xor_sync(FULL_MASK, nacc, 8);
      nacc += __shfl_xor_sync(FULL_MASK, nacc, 16);
#pragma unroll
      for (int kc = 0; kc < KS; kc += 8) {        // P += q K^T, inter += q C_in^T
        const Frag fq = frag_rows<KS>(Qs, 16 * rg, kc, l);
        if (p_live) {
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            uint32_t fh[2], fl[2];
            frag_cols<KS>(Ks, 32 * half + 8 * n, kc, l, fh, fl);
            mma3(Pt[n], fq, fh, fl);
          }
        }
#pragma unroll
        for (int n = 0; n < NI; ++n) {
          uint32_t fh[2], fl[2];
          frag_cols<KS>(Cj, (VT / 2) * half + 8 * n, kc, l, fh, fl);
          mma3(It[n], fq, fh, fl);
        }
      }
      join_shares();
      {                                 // beside the products: n_in . q_t
        const int t = tid >> 2, qt = tid & 3;
        const float* qrow = Qs + t * KS;
        const float4 x0 = *reinterpret_cast<const float4*>(qrow + 4 * ((2 * qt) ^ (t & 7)));
        const float4 x1 = *reinterpret_cast<const float4*>(qrow + 4 * ((2 * qt + 1) ^ (t & 7)));
        const float* nn = ns + j * KS + 8 * qt;
        nq = dot4(x0, *reinterpret_cast<const float4*>(nn), nq);
        nq = dot4(x1, *reinterpret_cast<const float4*>(nn + 4), nq);
      }
      __syncthreads();                  // every reader of this slice's C_in and n_in is done
      update(j, i, nacc);
    }

    // P' = P / sqrt(hd) . D in f32 into Ps, column s at the position that
    // frag_rows reads as the k of frag_krows' row s; its row sums
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 16 * rg + l.g + 8 * (e >> 1), s = 32 * half + 8 * n + 2 * l.t + (e & 1);
        const float x = s <= t ? P[n][e] * inv_sqrt_hd * expf(a_s[s] - M_s[t]) : 0.f;
        rsum[e >> 1] += x;
        const int col = 32 * half + 8 * n + l.t + 4 * (e & 1);
        Ps[t * CH + (col & 32) + ((col & 31) ^ 4 * (t & 7))] = x;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(FULL_MASK, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(FULL_MASK, rsum[r], 2);
      if (l.t == 0) rs_s[half * CH + 16 * rg + l.g + 8 * r] = rsum[r];
    }
    nq += __shfl_xor_sync(FULL_MASK, nq, 1);
    nq += __shfl_xor_sync(FULL_MASK, nq, 2);
    if ((tid & 3) == 0) nq_s[tid >> 2] = nq;
    __syncthreads();                    // P', its row sums and n_in . q are written

    // intra = P' V from zero (s past the rows' causal edge skipped); h
    float o[NI][4];
#pragma unroll
    for (int n = 0; n < NI; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    for (int kc = 0; kc < 16 * (rg + 1); kc += 8) {
      const Frag fp = frag_rows<CH>(Ps, 16 * rg, kc, l);
#pragma unroll
      for (int n = 0; n < NI; ++n) {
        uint32_t fh[2], fl[2];
        frag_krows<VT>(Vs, kc, (VT / 2) * half + 8 * n, l, fh, fl);
        mma3(o[n], fp, fh, fl);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = 16 * rg + l.g + 8 * r;
      if (t >= Lc) continue;
      const float cw = cw_s[t];
      // den >= 1: an approximate reciprocal (2 ulp) keeps the IEEE
      // division's slow-path call out of the epilogue
      const float nqt = rs_s[t] + rs_s[CH + t] + cw * nq_s[t];
      const float inv = __fdividef(1.f, fmaxf(fabsf(nqt), 1.f));
      if (KEEP && blockIdx.x == 0 && half == 0 && l.t == 0)
        a.knq[((long long)b * a.S + t0 + t) * a.H + hh] = nqt;
      T* hrow = hb + (t0 + t) * a.sh.s + (VT / 2) * half + 2 * l.t;
#pragma unroll
      for (int n = 0; n < NI; ++n) {
        const float x = (o[n][2 * r] + cw * I[n][2 * r]) * inv;
        const float y = (o[n][2 * r + 1] + cw * I[n][2 * r + 1]) * inv;
        if constexpr (sizeof(T) == 4) {
          *reinterpret_cast<float2*>(hrow + 8 * n) = make_float2(x, y);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(hrow + 8 * n) = __floats2bfloat162_rn(x, y);
        }
      }
    }
    if (tid == 0) misc[0] = misc[2];
  }
  repro::cp_async_wait<0>();

  __syncthreads();
  for (int e = tid; e < VT * hd / 4; e += NT) {
    const int r = e / (hd / 4), c4 = e % (hd / 4);
    reinterpret_cast<float4*>(a.C + crow(r))[c4] = *ctile(r, c4);
  }
  if (blockIdx.x == 0) {
    for (int c = tid; c < hd; c += NT) a.n[(long long)bh * hd + c] = ns[c];
    if (tid == 0) a.m[bh] = misc[0];
  }
}

template <typename T, int VT, bool KEEP>
cudaError_t launch(const Args<T>& a, int B, cudaStream_t stream) {
  const int smem = int(smem_bytes<VT>(a.hd));
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_tf32_kernel<T, VT, KEEP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  mlstm_tf32_kernel<T, VT, KEEP><<<dim3(a.hd / VT, B * a.H), NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, const float* g,
                        const float* C0, const float* n0, const float* m0, void* h, float* C,
                        float* n, float* m, float* const* keep, int B, int S, int H, int hd,
                        Strides sq, Strides sk, Strides sv, Strides sh, long long gb,
                        long long gs, cudaStream_t stream) {
  const auto units = [](const void* p, const Strides& st) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 4 == 0 && st.s % 4 == 0 &&
           st.h % 4 == 0;
  };
  const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                  g, C0, n0, m0, static_cast<T*>(h), C, n, m, keep[0], keep[1], keep[2], keep[3],
                  H, S, hd, sq, sk, sv, sh, gb, gs,
                  sizeof(T) == 4 && units(q, sq) && units(k, sk) && units(v, sv)};
  // keeping is a template argument: serving's instantiation has none of its code
  if (a.kC != nullptr)
    return hd % 64 == 0 ? launch<T, 64, true>(a, B, stream) : launch<T, 32, true>(a, B, stream);
  return hd % 64 == 0 ? launch<T, 64, false>(a, B, stream) : launch<T, 32, false>(a, B, stream);
}

// ---- the decode step: one pass over C ----------------------------------------

constexpr int STEP_THREADS = 256;                 // 8 warps
constexpr int STEP_ROWS = 16;                     // rows of C per block: 2 a warp
constexpr int STEP_F4 = 4;                        // float4s of a row a lane holds (hd <= 512)

// For each (b, h) and each of the S (a few) timesteps, in order:
//   m' = max(f~ + m, i~),  i' = exp(i~ - m'),  f' = exp(f~ + m - m'),  k^ = k / sqrt(hd)
//   n' = f' n + i' k^,  C'[i, :] = f' C[i, :] + i' v_i k^,
//   h_i = C'[i, :] . q / max(|n' . q|, 1)
// A block owns STEP_ROWS rows of C, read once into registers with 16-byte
// loads, updated and used in the same pass, and written once; every block
// recomputes n' and n'.q (hd FMAs a step), so blocks never talk to each other.
template <typename T>
__global__ void __launch_bounds__(STEP_THREADS) mlstm_step_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ g, const float* __restrict__ C0, const float* __restrict__ n0,
    const float* __restrict__ m0, T* __restrict__ hout, float* __restrict__ Cout,
    float* __restrict__ nout, float* __restrict__ mout, int H, int S, int hd,
    Strides sq, Strides sk, Strides sv, Strides sh, long long gb, long long gs) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                     // [hd] q_t
  float* ks = qs + hd;                  // [hd] k^_t
  float* ns = ks + hd;                  // [hd] n
  float* red = ns + hd;                 // [8] per-warp partial sums of n'.q

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / H, hh = bh % H;
  const int nf = hd / 4;                // float4s of a row
  const float inv_sqrt_hd = 1.f / sqrtf(float(hd));

  float4 c[2][STEP_F4];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const long long row = (long long)bh * hd + blockIdx.x * STEP_ROWS + warp * 2 + rr;
#pragma unroll
    for (int j = 0; j < STEP_F4; ++j) {
      const int f = lane + 32 * j;
      c[rr][j] = (C0 != nullptr && f < nf)
                     ? reinterpret_cast<const float4*>(C0 + row * hd)[f]
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  for (int i = tid; i < hd; i += STEP_THREADS) ns[i] = n0 != nullptr ? n0[(long long)bh * hd + i] : 0.f;
  float m = m0 != nullptr ? m0[bh] : 0.f;

  const T* qb = q + b * sq.b + hh * sq.h;
  const T* kb = k + b * sk.b + hh * sk.h;
  const T* vb = v + b * sv.b + hh * sv.h;
  T* hb = hout + b * sh.b + hh * sh.h;
  const float* gp = g + b * gb;
  for (int t = 0; t < S; ++t) {
    const float ig = gp[t * gs + hh], fg = gp[t * gs + H + hh];
    const float m_new = fmaxf(fg + m, ig);
    const float ip = expf(ig - m_new), fp = expf(fg + m - m_new);
    __syncthreads();                    // the previous step's readers of qs, ks, red are done
    float part = 0.f;
    for (int i = tid; i < hd; i += STEP_THREADS) {
      const float qx = repro::to_float(qb[t * sq.s + i]);
      const float kx = repro::to_float(kb[t * sk.s + i]) * inv_sqrt_hd;
      const float nx = fmaf(fp, ns[i], ip * kx);
      qs[i] = qx;
      ks[i] = kx;
      ns[i] = nx;
      part = fmaf(nx, qx, part);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(repro::FULL_MASK, part, off);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    float nq = 0.f;
#pragma unroll
    for (int w = 0; w < STEP_THREADS / 32; ++w) nq += red[w];
    const float inv_den = 1.f / fmaxf(fabsf(nq), 1.f);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = blockIdx.x * STEP_ROWS + warp * 2 + rr;
      const float iv = ip * repro::to_float(vb[t * sv.s + r]);
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < STEP_F4; ++j) {
        const int f = lane + 32 * j;
        if (f < nf) {
          const float4 k4 = reinterpret_cast<const float4*>(ks)[f];
          const float4 q4 = reinterpret_cast<const float4*>(qs)[f];
          float4& x = c[rr][j];
          x.x = fmaf(fp, x.x, iv * k4.x);
          x.y = fmaf(fp, x.y, iv * k4.y);
          x.z = fmaf(fp, x.z, iv * k4.z);
          x.w = fmaf(fp, x.w, iv * k4.w);
          dot = dot4(x, q4, dot);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(repro::FULL_MASK, dot, off);
      if (lane == 0) hb[t * sh.s + r] = repro::from_float<T>(dot * inv_den);
    }
    m = m_new;
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const long long row = (long long)bh * hd + blockIdx.x * STEP_ROWS + warp * 2 + rr;
#pragma unroll
    for (int j = 0; j < STEP_F4; ++j) {
      const int f = lane + 32 * j;
      if (f < nf) reinterpret_cast<float4*>(Cout + row * hd)[f] = c[rr][j];
    }
  }
  if (blockIdx.x == 0) {
    __syncthreads();
    for (int i = tid; i < hd; i += STEP_THREADS) nout[(long long)bh * hd + i] = ns[i];
    if (tid == 0) mout[bh] = m;
  }
}

template <typename T>
cudaError_t launch_step(const void* q, const void* k, const void* v, const float* g,
                        const float* C0, const float* n0, const float* m0, void* h, float* C,
                        float* n, float* m, int B, int S, int H, int hd, Strides sq,
                        Strides sk, Strides sv, Strides sh, long long gb, long long gs,
                        cudaStream_t stream) {
  const size_t smem = (3 * size_t(hd) + STEP_THREADS / 32) * sizeof(float);
  const dim3 grid(hd / STEP_ROWS, B * H);
  mlstm_step_kernel<T><<<grid, STEP_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), g, C0, n0,
      m0, static_cast<T*>(h), C, n, m, H, S, hd, sq, sk, sv, sh, gb, gs);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, h: (B, S, H, hd) in `dtype` with the given (b, s, h) strides and
// contiguous rows; gates: (B, S, 2H) f32 (i~ at [.., h], f~ at [.., H + h])
// with the given (b, s) strides; C0 (B, H, hd, hd), n0 (B, H, hd), m0 (B, H):
// f32 contiguous, all three NULL for a zero state; C, n, m: outputs of the same
// shapes, not aliasing the inputs. hd: a multiple of 32 up to 512. kC, kn,
// km, knq: what the gradient (mlstm_bwd.cu) starts from, f32 contiguous
// (B, H, NC, hd, hd), (B, H, NC, hd), (B, H, NC) and (B, S, H), NC =
// ceil(S / 64): each chunk's start state and each step's n.q; all four NULL
// for none (serving).
extern "C" int repro_mlstm(
    const void* q, const void* k, const void* v, const void* gates, const void* C0,
    const void* n0, const void* m0, void* h, void* C, void* n, void* m, void* kC, void* kn,
    void* km, void* knq, int dtype, int B, int S, int H, int hd,
    long long q_b, long long q_s, long long q_h, long long k_b, long long k_s, long long k_h,
    long long v_b, long long v_s, long long v_h, long long h_b, long long h_s, long long h_h,
    long long g_b, long long g_s, void* stream) {
  if (B == 0 || H == 0) return cudaSuccess;
  if (B < 0 || H < 0 || S < 0 || (long long)B * H > 65535 || hd < 32 || hd > 512 || hd % 32)
    return cudaErrorInvalidValue;
  const Strides sq{q_b, q_s, q_h}, sk{k_b, k_s, k_h}, sv{v_b, v_s, v_h}, sh{h_b, h_s, h_h};
  const float* f_g = static_cast<const float*>(gates);
  const float* f_C0 = static_cast<const float*>(C0);
  const float* f_n0 = static_cast<const float*>(n0);
  const float* f_m0 = static_cast<const float*>(m0);
  float* f_C = static_cast<float*>(C);
  float* f_n = static_cast<float*>(n);
  float* f_m = static_cast<float*>(m);
  float* const keep[4] = {static_cast<float*>(kC), static_cast<float*>(kn),
                          static_cast<float*>(km), static_cast<float*>(knq)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return launch_tf32<float>(q, k, v, f_g, f_C0, f_n0, f_m0, h, f_C, f_n, f_m, keep, B, S,
                                H, hd, sq, sk, sv, sh, g_b, g_s, s);
    case repro::kBFloat16:
      return launch_tf32<__nv_bfloat16>(q, k, v, f_g, f_C0, f_n0, f_m0, h, f_C, f_n, f_m, keep,
                                        B, S, H, hd, sq, sk, sv, sh, g_b, g_s, s);
    default: return cudaErrorInvalidValue;
  }
}

// The decode step (a few timesteps, one pass over C): the same arguments and
// layouts as repro_mlstm.
extern "C" int repro_mlstm_step(
    const void* q, const void* k, const void* v, const void* gates, const void* C0,
    const void* n0, const void* m0, void* h, void* C, void* n, void* m,
    int dtype, int B, int S, int H, int hd,
    long long q_b, long long q_s, long long q_h, long long k_b, long long k_s, long long k_h,
    long long v_b, long long v_s, long long v_h, long long h_b, long long h_s, long long h_h,
    long long g_b, long long g_s, void* stream) {
  if (B == 0 || H == 0) return cudaSuccess;
  if (B < 0 || H < 0 || S < 0 || (long long)B * H > 65535 || hd < 32 || hd > 512 || hd % 32)
    return cudaErrorInvalidValue;
  const Strides sq{q_b, q_s, q_h}, sk{k_b, k_s, k_h}, sv{v_b, v_s, v_h}, sh{h_b, h_s, h_h};
  const float* f_g = static_cast<const float*>(gates);
  const float* f_C0 = static_cast<const float*>(C0);
  const float* f_n0 = static_cast<const float*>(n0);
  const float* f_m0 = static_cast<const float*>(m0);
  float* f_C = static_cast<float*>(C);
  float* f_n = static_cast<float*>(n);
  float* f_m = static_cast<float*>(m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return launch_step<float>(q, k, v, f_g, f_C0, f_n0, f_m0, h, f_C, f_n, f_m, B, S, H, hd,
                                sq, sk, sv, sh, g_b, g_s, s);
    case repro::kBFloat16:
      return launch_step<__nv_bfloat16>(q, k, v, f_g, f_C0, f_n0, f_m0, h, f_C, f_n, f_m, B, S,
                                        H, hd, sq, sk, sv, sh, g_b, g_s, s);
    default: return cudaErrorInvalidValue;
  }
}
