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
// * `mlstm_kernel<T>`, the chunkwise form on f32 FMAs for f32 and bf16 q/k/v
//   (bf16 calls whose head_dim is a multiple of 64 go to csrc/mlstm_tc.cu,
//   on tensor cores, instead); f32 callers (the reduced models, whose
//   card-equals-CPU checks hold 1e-4) need f32 products, which TF32 tensor
//   cores would not give;
// * `mlstm_step_kernel`, the decode step (S of a few timesteps, either
//   dtype): one pass over C. At decode (S = 1) the state is the work, a read
//   and a write of C (67 MB at B 8, H 4, hd 512), so it is bound by bytes.
//
// Design of the chunkwise FMA kernel:
// * The state does not fit an SM (C is 1 MB of f32 per (b, h) at hd 512), so
//   each block owns a 32-row tile of C's value rows, C[v0:v0+32, :] (64 KB at
//   hd 512), in shared memory for the whole sequence: grid (hd / 32, B * H).
//   The TPU kernel's sequential chunk axis becomes a loop inside the block;
//   nothing carries over between blocks.
// * The kernel's own chunk is 32 timesteps, one per lane: the per-chunk
//   scalars (cumsum, cummax, the stabiliser) are warp scans. Every v-tile
//   block of a head recomputes them and q K^T, which cost a third of the C
//   products at this chunk.
// * q and K^ are staged in 64-column slices of d_k; per slice each thread
//   accumulates 4 entries of q K^T, 4 of q C_in^T and (warp 0) n_in.q, then
//   the slice's columns of C and n are updated in place. The denominator
//   needs no n_t matrix: n_t.q_t is the row sum of P plus the carried term.
// * Every block keeps its own copy of n (updated identically); the block of
//   tile 0 writes n and m out. h goes through shared memory to coalesced stores.
// * Ragged S and S = 1 bound the loops (no padding); q/k/v are read through
//   their (B, S, H, hd) strides and the gates from (B, S, 2H); the outputs
//   are fresh buffers (n0 and m0 are read by every tile, so they may not alias).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;        // threads: 8 warps
constexpr int L = 32;          // timesteps per chunk, one per lane
constexpr int VT = 32;         // value rows of C per block (8 warps x 4)
constexpr int KS = 64;         // key columns staged per slice
constexpr int QS = KS + 4;     // padded row of the q / K^ slices (float4-aligned, conflict-free)
constexpr int PS = L + 1;      // padded row of P and of the h tile

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

size_t smem_floats(int hd) {
  return size_t(VT) * (hd + 4) + 2 * L * QS + 2 * L * VT + 2 * L * PS + hd + 5 * L + 4;
}

template <typename T>
__global__ void __launch_bounds__(NT) mlstm_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ g, const float* __restrict__ C0, const float* __restrict__ n0,
    const float* __restrict__ m0, T* __restrict__ hout, float* __restrict__ Cout,
    float* __restrict__ nout, float* __restrict__ mout, int H, int S, int hd,
    Strides sq, Strides sk, Strides sv, Strides sh, long long gb, long long gs) {
  extern __shared__ __align__(16) float smem[];
  const int CS = hd + 4;               // padded row of the C tile
  float* Cs = smem;                    // [VT][CS]  C[v0 + r, :]
  float* Qs = Cs + VT * CS;            // [L][QS]   q slice
  float* Ks = Qs + L * QS;             // [L][QS]   K^ slice
  float* Vs = Ks + L * QS;             // [L][VT]   v tile
  float* VWs = Vs + L * VT;            // [L][VT]   v tile x w_s
  float* Ps = VWs + L * VT;            // [L][PS]   P
  float* Hs = Ps + L * PS;             // [L][PS]   h tile
  float* ns = Hs + L * PS;             // [hd]      n
  float* a_s = ns + hd;                // [L] i~_s - b_s
  float* M_s = a_s + L;                // [L] M_t
  float* cw_s = M_s + L;               // [L] exp(m_in - M_t)
  float* w_s = cw_s + L;               // [L] exp(a_s - M_c), 0 past the chunk's end
  float* den_s = w_s + L;              // [L]
  float* misc = den_s + L;             // [0] m, [1] exp(m_in - M_c), [2] next m

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / H, hh = bh % H;
  const int v0 = blockIdx.x * VT;
  const float sqrt_hd = sqrtf(float(hd));

  for (int e = tid; e < VT * hd; e += NT) {
    const int r = e / hd, c = e % hd;
    Cs[r * CS + c] = C0 != nullptr ? C0[((long long)bh * hd + v0 + r) * hd + c] : 0.f;
  }
  for (int c = tid; c < hd; c += NT) ns[c] = n0 != nullptr ? n0[(long long)bh * hd + c] : 0.f;
  if (tid == 0) misc[0] = m0 != nullptr ? m0[bh] : 0.f;

  const T* qb = q + b * sq.b + hh * sq.h;
  const T* kb = k + b * sk.b + hh * sk.h;
  const T* vb = v + b * sv.b + hh * sv.h + v0;
  T* hb = hout + b * sh.b + hh * sh.h + v0;
  const float* gp = g + b * gb;

  for (int t0 = 0; t0 < S; t0 += L) {
    const int Lc = min(L, S - t0);
    __syncthreads();  // the previous chunk's readers are done; the state is loaded
    if (warp == 0) {  // the chunk's scalars, lane = timestep
      const float m_in = misc[0];
      float ig = repro::NEG_INF, bsum = 0.f;
      if (lane < Lc) {
        ig = gp[(t0 + lane) * gs + hh];
        bsum = gp[(t0 + lane) * gs + H + hh];
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(repro::FULL_MASK, bsum, o);
        if (lane >= o) bsum += y;
      }
      const float a = ig - bsum;
      float M = a;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(repro::FULL_MASK, M, o);
        if (lane >= o) M = fmaxf(M, y);
      }
      M = fmaxf(m_in, M);
      const float M_c = __shfl_sync(repro::FULL_MASK, M, Lc - 1);
      const float b_c = __shfl_sync(repro::FULL_MASK, bsum, Lc - 1);
      a_s[lane] = a;
      M_s[lane] = M;
      cw_s[lane] = expf(m_in - M);
      w_s[lane] = lane < Lc ? expf(a - M_c) : 0.f;
      if (lane == 0) {
        misc[1] = expf(m_in - M_c);
        misc[2] = b_c + M_c;
      }
    }
    __syncthreads();
    for (int e = tid; e < L * VT; e += NT) {
      const int s = e / VT, c = e % VT;
      const float x = s < Lc ? repro::to_float(vb[(t0 + s) * sv.s + c]) : 0.f;
      Vs[e] = x;
      VWs[e] = x * w_s[s];
    }
    const float cscale = misc[1];

    // lane = timestep t; warp w owns s = 4w..4w+3 of P and v = 4w..4w+3 of q C^T
    float accP[4] = {0.f, 0.f, 0.f, 0.f}, accN[4] = {0.f, 0.f, 0.f, 0.f}, qn = 0.f;
    for (int k0 = 0; k0 < hd; k0 += KS) {
      const int kw = min(KS, hd - k0);
      __syncthreads();  // the previous slice's readers are done
      for (int e = tid; e < L * kw; e += NT) {
        const int t = e / kw, c = e % kw;
        float qx = 0.f, kx = 0.f;
        if (t < Lc) {
          qx = repro::to_float(qb[(t0 + t) * sq.s + k0 + c]);
          kx = repro::to_float(kb[(t0 + t) * sk.s + k0 + c]) / sqrt_hd;
        }
        Qs[t * QS + c] = qx;
        Ks[t * QS + c] = kx;
      }
      __syncthreads();
      const float* qrow = Qs + lane * QS;
      for (int c = 0; c < kw; c += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(qrow + c);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = warp * 4 + j;
          accP[j] = dot4(q4, *reinterpret_cast<const float4*>(Ks + r * QS + c), accP[j]);
          accN[j] = dot4(q4, *reinterpret_cast<const float4*>(Cs + r * CS + k0 + c), accN[j]);
        }
        if (warp == 0) qn = dot4(q4, *reinterpret_cast<const float4*>(ns + k0 + c), qn);
      }
      __syncthreads();  // every reader of this slice's old C and n is done
      const int kq = kw / 4;
      for (int e = tid; e < VT * kq; e += NT) {
        const int r = e / kq, c = (e % kq) * 4;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int s = 0; s < Lc; ++s) {
          const float x = VWs[s * VT + r];
          const float4 k4 = *reinterpret_cast<const float4*>(Ks + s * QS + c);
          acc.x = fmaf(x, k4.x, acc.x);
          acc.y = fmaf(x, k4.y, acc.y);
          acc.z = fmaf(x, k4.z, acc.z);
          acc.w = fmaf(x, k4.w, acc.w);
        }
        float4* cp = reinterpret_cast<float4*>(Cs + r * CS + k0 + c);
        float4 cur = *cp;
        cur.x = fmaf(cscale, cur.x, acc.x);
        cur.y = fmaf(cscale, cur.y, acc.y);
        cur.z = fmaf(cscale, cur.z, acc.z);
        cur.w = fmaf(cscale, cur.w, acc.w);
        *cp = cur;
      }
      for (int c = tid; c < kw; c += NT) {
        float acc = 0.f;
        for (int s = 0; s < Lc; ++s) acc = fmaf(w_s[s], Ks[s * QS + c], acc);
        ns[k0 + c] = fmaf(cscale, ns[k0 + c], acc);
      }
    }

    const int t = lane;
    const float M_t = M_s[t];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = warp * 4 + j;
      Ps[t * PS + s] = (s <= t && t < Lc) ? accP[j] * expf(a_s[s] - M_t) : 0.f;
    }
    __syncthreads();
    if (warp == 0) {
      float rs = 0.f;
      for (int s = 0; s < L; ++s) rs += Ps[t * PS + s];
      den_s[t] = fmaxf(fabsf(rs + cw_s[t] * qn), 1.f);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = warp * 4 + j;
      float intra = 0.f;
      for (int s = 0; s < L; ++s) intra = fmaf(Ps[t * PS + s], Vs[s * VT + r], intra);
      Hs[t * PS + r] = (intra + cw_s[t] * accN[j]) / den_s[t];
    }
    __syncthreads();
    for (int e = tid; e < Lc * VT; e += NT) {
      const int tt = e / VT, c = e % VT;
      hb[(t0 + tt) * sh.s + c] = repro::from_float<T>(Hs[tt * PS + c]);
    }
    if (tid == 0) misc[0] = misc[2];
  }

  __syncthreads();
  for (int e = tid; e < VT * hd; e += NT) {
    const int r = e / hd, c = e % hd;
    Cout[((long long)bh * hd + v0 + r) * hd + c] = Cs[r * CS + c];
  }
  if (blockIdx.x == 0) {
    for (int c = tid; c < hd; c += NT) nout[(long long)bh * hd + c] = ns[c];
    if (tid == 0) mout[bh] = misc[0];
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* g,
                   const float* C0, const float* n0, const float* m0, void* h, float* C,
                   float* n, float* m, int B, int S, int H, int hd, Strides sq, Strides sk,
                   Strides sv, Strides sh, long long gb, long long gs, cudaStream_t stream) {
  const size_t smem = smem_floats(hd) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(hd / VT, B * H);
  mlstm_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), g, C0, n0,
      m0, static_cast<T*>(h), C, n, m, H, S, hd, sq, sk, sv, sh, gb, gs);
  return cudaGetLastError();
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
// shapes, not aliasing the inputs. hd: a multiple of 32 up to 512.
extern "C" int repro_mlstm(
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
      return launch<float>(q, k, v, f_g, f_C0, f_n0, f_m0, h, f_C, f_n, f_m, B, S, H, hd, sq,
                           sk, sv, sh, g_b, g_s, s);
    case repro::kBFloat16:
      return launch<__nv_bfloat16>(q, k, v, f_g, f_C0, f_n0, f_m0, h, f_C, f_n, f_m, B, S, H,
                                   hd, sq, sk, sv, sh, g_b, g_s, s);
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
