// The sLSTM recurrence for Hopper (sm_90a), hand-written CUDA C++: a
// forward kernel (prefill, every decode step, training's forward and its
// recompute) and a backward kernel (training).
//
// It replaces no Pallas kernel: the reference runs the recurrence as a
// two-level jax.lax.scan (src/repro/models/xlstm.py:226-239), which XLA
// compiles into one loop on the device. The plain versions, in the same
// order, are kernels/slstm/ref.py's `slstm_ref` and `slstm_bwd_ref`. Per
// step t, batch row b and hidden unit j, with pre = wx_t + h_{t-1} r (r is
// (d, 4d), gate columns z, i, f, o at offsets 0, d, 2d, 3d):
//   z = tanh(z~), o = sigmoid(o~), m_t = max(f~ + m, i~),
//   i' = exp(i~ - m_t), f' = exp(f~ + m - m_t),
//   c = f' c + i' z, n = f' n + i', h = o c / max(n, 1).
//
// What bounds it on this card: the recurrence is serial in t, and all of
// h_{t-1} feeds every unit's four gates, so a whole step has to cross the
// grid before the next one starts. Its work is 2 B d 4d f32 flops a step
// (0.51 ms at B1 S4096 d1024 at the f32 FMA rate, 4.1 ms at B8); its bytes
// (wx, hs, r once) take less. The S grid exchanges, ~1-2 us each, are in no
// bound, and at small B they are most of the time.
//
// Design (right and simple first):
// * A persistent grid of one block per U = 8 hidden units (128 blocks at
//   d = 1024), all resident at once: cudaLaunchCooperativeKernel refuses a
//   grid that cannot be, where a plain launch would deadlock. Each block
//   loads its slice of r once into shared memory (the forward: the 4U
//   columns of its units, one per lane; the backward: the U rows of its
//   units, 4d floats each; 128 KB at d = 1024) and keeps it for all S steps,
//   so r is read from device memory once a launch.
// * Per step only h (forward) or dpre (backward) crosses the grid, through
//   L2: each block writes its units' share, then one thread fences
//   (__threadfence) and adds one to a counter; readers spin on an acquire
//   load of it (ld.acquire.gpu) and read the shared vector with
//   L1-bypassing loads (__ldcg: L1 is not coherent between SMs). The counter
//   only grows within a launch (zeroed by the wrapper on the stream): the
//   k-th exchange is done at k * gridDim.x. No exchange after the last step,
//   so a decode step (S = 1) crosses none. Every block runs every step.
// * Products are f32 FMAs in a fixed order (the reference computes them in
//   f32, not TF32): k ascending within a warp's slice of h, then the warps'
//   sums in warp order. No atomics in any sum: the same inputs give the
//   same bits every run.
// * The forward keeps, when asked (the wrapper's `keep`, a null pointer
//   otherwise), each step's pre-activations and c, n, m: 7 (B, S, d) f32,
//   117 MB at B1 S4096 d1024. The backward recomputes the gates from them.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;       // threads: 8 warps
constexpr int NW = NT / 32;
constexpr int U = 8;          // hidden units a block owns
constexpr int G = 4;          // gates z, i, f, o
constexpr int C = G * U;      // the forward's columns of r a block owns: one a lane
constexpr int BT = 8;         // batch rows one forward pass over r takes
constexpr int BTB = 2;        // batch rows one backward pass over r takes

static_assert(C == 32, "the forward maps one column of r to one lane");

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The grid barrier: a block's arrival publishes every write its threads
// made before it; the wait returns once `target` arrivals have been made.
__device__ __forceinline__ void grid_arrive(unsigned* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
  }
}

// A wait that outlasts STALL_CYCLES (~10 s) traps: a grid whose blocks were
// not all resident fails the launch with an error instead of hanging.
constexpr long long STALL_CYCLES = 20000000000LL;

__device__ __forceinline__ void grid_wait(const unsigned* counter, unsigned target) {
  if (threadIdx.x == 0) {
    const long long t0 = clock64();
    while (ld_acquire(counter) < target) {
      if (clock64() - t0 > STALL_CYCLES) __trap();
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

struct Fwd {
  const float* wx;                                  // (B, S, 4d)
  const float* r;                                   // (d, 4d)
  const float *c0, *n0, *h0, *m0;                   // (B, d) each, or null: zeros
  float* hs;                                        // (B, S, d)
  float *c, *n, *h, *m;                             // the final state (B, d)
  float *kpre, *kc, *kn, *km;                       // kept (B, S, 4d), (B, S, d) x3, or null
  unsigned* counter;
  int B, S, d;
};

// Shared memory: R [d][C], the staged h [BT][d], the warps' partial sums
// [NW][BT][C], the state [4][B][U] (c, n, h, m).
size_t fwd_smem(int B, int d) {
  return sizeof(float) * (size_t(d) * C + size_t(BT) * d + NW * BT * C + 4 * size_t(B) * U);
}

__global__ void __launch_bounds__(NT, 1) slstm_fwd_kernel(const Fwd a) {
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, S = a.S, d = a.d, d4 = 4 * d;
  float* R = smem;
  float* Hs = R + d * C;
  float* part = Hs + BT * d;
  float* st = part + NW * BT * C;
  const int BU = B * U;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int u0 = blockIdx.x * U;
  const int nu = min(U, d - u0);

  // r's columns of this block's units: lane g U + u holds column g d + u0 + u
  for (int i = tid; i < d * C; i += NT) {
    const int k = i / C, g = (i % C) / U, u = i % U;
    R[i] = u < nu ? a.r[(long long)k * d4 + g * d + u0 + u] : 0.f;
  }
  for (int i = tid; i < BU; i += NT) {
    const int b = i / U, u = i % U;
    const long long at = (long long)b * d + u0 + u;
    const bool ok = u < nu;
    st[i] = ok && a.c0 ? a.c0[at] : 0.f;
    st[BU + i] = ok && a.n0 ? a.n0[at] : 0.f;
    st[2 * BU + i] = ok && a.h0 ? a.h0[at] : 0.f;
    st[3 * BU + i] = ok && a.m0 ? a.m0[at] : 0.f;
  }

  const int ks = d / NW;            // a warp's slice of h (a multiple of 4)
  const int kb = warp * ks;
  const int cj = tid / U, cu = tid % U;   // a cell thread's batch row in the tile, unit
  const bool cell0 = tid < min(BT, B) * U && cu < nu;
  unsigned phase = 0;
  for (int t = 0; t < S; ++t) {
    // the first tile's cell threads fetch their wx ahead of the barrier
    float w0[G] = {0.f, 0.f, 0.f, 0.f};
    if (cell0) {
      const float* p = a.wx + ((long long)cj * S + t) * d4 + u0 + cu;
#pragma unroll
      for (int g = 0; g < G; ++g) w0[g] = p[g * d];
    }
    if (t > 0) grid_wait(a.counter, phase * gridDim.x);
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int nb = min(BT, B - b0);
      if (t == 0) {
        for (int i = tid; i < nb * d; i += NT)
          Hs[i] = a.h0 ? __ldcg(a.h0 + (long long)b0 * d + i) : 0.f;
      } else {
        const int dq = d / 4;
        for (int i = tid; i < nb * dq; i += NT) {
          const int j = i / dq, q = i % dq;
          const float4* src = reinterpret_cast<const float4*>(
              a.hs + ((long long)(b0 + j) * S + t - 1) * d);
          reinterpret_cast<float4*>(Hs)[i] = __ldcg(src + q);
        }
      }
      __syncthreads();

      float acc[BT];
#pragma unroll
      for (int j = 0; j < BT; ++j) acc[j] = 0.f;
      for (int k = kb; k < kb + ks; k += 4) {
        const float r0 = R[(k + 0) * C + lane], r1 = R[(k + 1) * C + lane];
        const float r2 = R[(k + 2) * C + lane], r3 = R[(k + 3) * C + lane];
#pragma unroll
        for (int j = 0; j < BT; ++j) {
          if (j < nb) {
            const float4 hv = *reinterpret_cast<const float4*>(Hs + j * d + k);
            acc[j] = fmaf(hv.x, r0, acc[j]);
            acc[j] = fmaf(hv.y, r1, acc[j]);
            acc[j] = fmaf(hv.z, r2, acc[j]);
            acc[j] = fmaf(hv.w, r3, acc[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < BT; ++j)
        if (j < nb) part[(warp * BT + j) * C + lane] = acc[j];
      __syncthreads();

      if (tid < nb * U && cu < nu) {
        const int b = b0 + cj;
        const long long row = (long long)b * S + t;
        float pre[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int col = g * U + cu;
          float s = part[cj * C + col];
#pragma unroll
          for (int w = 1; w < NW; ++w) s += part[(w * BT + cj) * C + col];
          const float x = b0 == 0 ? w0[g] : a.wx[row * d4 + g * d + u0 + cu];
          pre[g] = x + s;
        }
        const int si = b * U + cu;
        float c = st[si], n = st[BU + si], m = st[3 * BU + si];
        const float z = tanhf(pre[0]);
        const float o = sigmoid(pre[3]);
        const float fm = pre[2] + m;
        const float mn = fmaxf(fm, pre[1]);
        const float i_ = expf(pre[1] - mn);
        const float f_ = expf(fm - mn);
        c = f_ * c + i_ * z;
        n = f_ * n + i_;
        const float h = o * c / fmaxf(n, 1.f);
        st[si] = c;
        st[BU + si] = n;
        st[2 * BU + si] = h;
        st[3 * BU + si] = mn;
        const long long at = row * d + u0 + cu;
        a.hs[at] = h;
        if (a.kpre) {
#pragma unroll
          for (int g = 0; g < G; ++g) a.kpre[row * d4 + g * d + u0 + cu] = pre[g];
          a.kc[at] = c;
          a.kn[at] = n;
          a.km[at] = mn;
        }
      }
      __syncthreads();   // the staged h, the partial sums and the state are the next tile's
    }
    if (t + 1 < S) {
      grid_arrive(a.counter);
      ++phase;
    }
  }
  for (int i = tid; i < BU; i += NT) {
    const int b = i / U, u = i % U;
    if (u < nu) {
      const long long at = (long long)b * d + u0 + u;
      a.c[at] = st[i];
      a.n[at] = st[BU + i];
      a.h[at] = st[2 * BU + i];
      a.m[at] = st[3 * BU + i];
    }
  }
}

struct Bwd {
  const float* r;                                   // (d, 4d)
  const float* hs;                                  // (B, S, d)
  const float *kpre, *kc, *kn, *km;                 // what the forward kept
  const float *c0, *n0, *m0;                        // the start state, or null: zeros
  const float* dhs;                                 // (B, S, d), or null: zeros
  const float *dcT, *dnT, *dhT, *dmT;               // the final state's gradient, or null
  float* dpre;                                      // (B, S, 4d): dwx
  float *dc0, *dn0, *dh0, *dm0;                     // the start state's gradient, or null
  unsigned* counter;
  int B, S, d;
};

// Shared memory: RT [U][4d] (the rows of r of the block's units), the
// staged dpre [BTB][4d], the warps' sums [NW][BTB][U], the carries [3][B][U]
// (dc, dn, dm).
size_t bwd_smem(int B, int d) {
  return sizeof(float) * (size_t(U) * 4 * d + size_t(BTB) * 4 * d + NW * BTB * U +
                          3 * size_t(B) * U);
}

// What one unit's step of the backward reads of the forward.
struct CellIn {
  float pre[G], c, n, m, cp, np, mp, h, dh;
};

__device__ __forceinline__ CellIn load_cell(const Bwd& a, int b, int t, int unit) {
  const int d = a.d, S = a.S;
  const long long row = (long long)b * S + t, at = row * d + unit;
  CellIn x;
#pragma unroll
  for (int g = 0; g < G; ++g) x.pre[g] = a.kpre[row * 4 * d + g * d + unit];
  x.c = a.kc[at];
  x.n = a.kn[at];
  x.m = a.km[at];
  if (t > 0) {
    x.cp = a.kc[at - d];
    x.np = a.kn[at - d];
    x.mp = a.km[at - d];
  } else {
    const long long s0 = (long long)b * d + unit;
    x.cp = a.c0 ? a.c0[s0] : 0.f;
    x.np = a.n0 ? a.n0[s0] : 0.f;
    x.mp = a.m0 ? a.m0[s0] : 0.f;
  }
  x.h = a.hs[at];
  x.dh = a.dhs ? a.dhs[at] : 0.f;
  return x;
}

// dh of the block's units from the staged dpre (rows b0.. of the tile):
// each thread sums its float4 columns in order, the warp by a fixed
// butterfly, lane 0 writes the warp's sum.
__device__ __forceinline__ void dot_rows(const float* RT, const float* DP, float* part, int nb,
                                         int d) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float acc[BTB][U];
#pragma unroll
  for (int j = 0; j < BTB; ++j)
#pragma unroll
    for (int u = 0; u < U; ++u) acc[j][u] = 0.f;
  const float4* RT4 = reinterpret_cast<const float4*>(RT);
  const float4* DP4 = reinterpret_cast<const float4*>(DP);
  for (int q = tid; q < d; q += NT) {      // 4d columns = d float4s
    float4 dp[BTB];
#pragma unroll
    for (int j = 0; j < BTB; ++j) dp[j] = j < nb ? DP4[j * d + q] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float4 rr = RT4[u * d + q];
#pragma unroll
      for (int j = 0; j < BTB; ++j) {
        acc[j][u] = fmaf(dp[j].x, rr.x, acc[j][u]);
        acc[j][u] = fmaf(dp[j].y, rr.y, acc[j][u]);
        acc[j][u] = fmaf(dp[j].z, rr.z, acc[j][u]);
        acc[j][u] = fmaf(dp[j].w, rr.w, acc[j][u]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < BTB; ++j)
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float v = acc[j][u];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(repro::FULL_MASK, v, off);
      if (lane == 0) part[(warp * BTB + j) * U + u] = v;
    }
}

__device__ __forceinline__ void stage_dpre(const Bwd& a, float* DP, int b0, int nb, int t) {
  const int d = a.d, S = a.S;
  for (int i = threadIdx.x; i < nb * d; i += NT) {     // d float4s a row
    const int j = i / d, q = i % d;
    const float4* src = reinterpret_cast<const float4*>(
        a.dpre + ((long long)(b0 + j) * S + t) * 4 * d);
    reinterpret_cast<float4*>(DP)[i] = __ldcg(src + q);
  }
}

__device__ __forceinline__ float warp_sums(const float* part, int j, int u) {
  float s = part[j * U + u];
#pragma unroll
  for (int w = 1; w < NW; ++w) s += part[(w * BTB + j) * U + u];
  return s;
}

__global__ void __launch_bounds__(NT, 1) slstm_bwd_kernel(const Bwd a) {
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, S = a.S, d = a.d, d4 = 4 * d;
  float* RT = smem;
  float* DP = RT + U * d4;
  float* part = DP + BTB * d4;
  float* st = part + NW * BTB * U;
  const int BU = B * U;
  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * U;
  const int nu = min(U, d - u0);
  const bool has_state = a.dc0 != nullptr;

  for (int i = tid; i < U * d4; i += NT) {
    const int u = i / d4, col = i % d4;
    RT[i] = u < nu ? a.r[(long long)(u0 + u) * d4 + col] : 0.f;
  }
  for (int i = tid; i < BU; i += NT) {
    const int b = i / U, u = i % U;
    const long long at = (long long)b * d + u0 + u;
    const bool ok = u < nu;
    st[i] = ok && a.dcT ? a.dcT[at] : 0.f;
    st[BU + i] = ok && a.dnT ? a.dnT[at] : 0.f;
    st[2 * BU + i] = ok && a.dmT ? a.dmT[at] : 0.f;
  }
  __syncthreads();

  const int cj = tid / U, cu = tid % U;
  const bool cell0 = tid < min(BTB, B) * U && cu < nu;
  unsigned phase = 0;
  for (int t = S - 1; t >= 0; --t) {
    CellIn x0;
    if (cell0) x0 = load_cell(a, cj, t, u0 + cu);
    if (t < S - 1) grid_wait(a.counter, phase * gridDim.x);
    for (int b0 = 0; b0 < B; b0 += BTB) {
      const int nb = min(BTB, B - b0);
      if (t < S - 1) {
        stage_dpre(a, DP, b0, nb, t + 1);
        __syncthreads();
        dot_rows(RT, DP, part, nb, d);
        __syncthreads();
      }
      if (tid < nb * U && cu < nu) {
        const int b = b0 + cj, unit = u0 + cu;
        const CellIn x = b0 == 0 ? x0 : load_cell(a, b, t, unit);
        const float rec = t < S - 1 ? warp_sums(part, cj, cu)
                                    : (a.dhT ? a.dhT[(long long)b * d + unit] : 0.f);
        const int si = b * U + cu;
        float dc = st[si], dn = st[BU + si], dm = st[2 * BU + si];
        const float z = tanhf(x.pre[0]);
        const float o = sigmoid(x.pre[3]);
        const float fm = x.pre[2] + x.mp;
        const float i_ = expf(x.pre[1] - x.m);
        const float f_ = expf(fm - x.m);
        const float nc = fmaxf(x.n, 1.f);
        const float dh = x.dh + rec;
        // h = (o c) / nc
        const float gq = dh / nc;
        const float d_o = gq * x.c;
        dc = dc + gq * o;
        dn = dn + (x.n >= 1.f ? -dh * (x.h / nc) : 0.f);
        const float dz = dc * i_ * (1.f - z * z);
        const float dot = d_o * (1.f - o) * o;
        const float di = dc * z + dn;
        const float df = dc * x.cp + dn * x.np;
        dm = dm - di * i_ - df * f_;
        // m = max(f~ + m_prev, i~): half of dm to each side at a tie
        float da = fm == x.pre[1] ? dm / 2.f : (fm > x.pre[1] ? dm : 0.f);
        const float dit = di * i_ + (dm - da);
        da = df * f_ + da;
        float* out = a.dpre + ((long long)b * S + t) * d4 + unit;
        out[0] = dz;
        out[d] = dit;
        out[2 * d] = da;
        out[3 * d] = dot;
        st[si] = dc * f_;
        st[BU + si] = dn * f_;
        st[2 * BU + si] = da;
      }
      __syncthreads();   // the staged dpre, the sums and the carries are the next tile's
    }
    if (t > 0 || has_state) {
      grid_arrive(a.counter);
      ++phase;
    }
  }
  if (!has_state) return;
  // the start state's gradient: dh0 = dpre_0 r^T, and the carries
  grid_wait(a.counter, phase * gridDim.x);
  for (int b0 = 0; b0 < B; b0 += BTB) {
    const int nb = min(BTB, B - b0);
    stage_dpre(a, DP, b0, nb, 0);
    __syncthreads();
    dot_rows(RT, DP, part, nb, d);
    __syncthreads();
    if (tid < nb * U && cu < nu) {
      const int b = b0 + cj;
      const long long at = (long long)b * d + u0 + cu;
      const int si = b * U + cu;
      a.dh0[at] = warp_sums(part, cj, cu);
      a.dc0[at] = st[si];
      a.dn0[at] = st[BU + si];
      a.dm0[at] = st[2 * BU + si];
    }
    __syncthreads();
  }
}

template <typename A>
cudaError_t launch_coop(void (*kernel)(const A), const A& args, int blocks, size_t smem,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err == cudaSuccess) {
    A copy = args;
    void* params[] = {&copy};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                      dim3(NT), params, smem, stream);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();   // a refused launch leaves no error behind for the next one
    return err;
  }
  return cudaGetLastError();
}

bool bad_shape(int B, int S, int d) { return B < 1 || S < 1 || d < 32 || d % 32; }

}  // namespace

extern "C" int repro_slstm_fwd(const float* wx, const float* r, const float* c0, const float* n0,
                               const float* h0, const float* m0, float* hs, float* c, float* n,
                               float* h, float* m, float* kpre, float* kc, float* kn, float* km,
                               void* counter, int B, int S, int d, void* stream) {
  if (bad_shape(B, S, d)) return cudaErrorInvalidValue;
  const Fwd a{wx, r, c0, n0, h0, m0, hs, c, n, h, m, kpre, kc, kn, km,
              static_cast<unsigned*>(counter), B, S, d};
  return launch_coop(slstm_fwd_kernel, a, (d + U - 1) / U, fwd_smem(B, d),
                     static_cast<cudaStream_t>(stream));
}

extern "C" int repro_slstm_bwd(const float* r, const float* hs, const float* kpre,
                               const float* kc, const float* kn, const float* km,
                               const float* c0, const float* n0, const float* m0,
                               const float* dhs, const float* dcT, const float* dnT,
                               const float* dhT, const float* dmT, float* dpre, float* dc0,
                               float* dn0, float* dh0, float* dm0, void* counter, int B, int S,
                               int d, void* stream) {
  if (bad_shape(B, S, d)) return cudaErrorInvalidValue;
  const Bwd a{r, hs, kpre, kc, kn, km, c0, n0, m0, dhs, dcT, dnT, dhT, dmT, dpre,
              dc0, dn0, dh0, dm0, static_cast<unsigned*>(counter), B, S, d};
  return launch_coop(slstm_bwd_kernel, a, (d + U - 1) / U, bwd_smem(B, d),
                     static_cast<cudaStream_t>(stream));
}
