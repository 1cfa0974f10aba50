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
// (wx, hs, r once) take less. The S exchanges of h between blocks, each a
// trip through L2, are in no bound, and at small B they are most of the
// time.
//
// Both kernels are persistent grids of one block per U = 8 hidden units
// (128 blocks at d = 1024), all resident at once: cudaLaunchCooperativeKernel
// refuses a grid that cannot be, where a plain launch would deadlock. A
// wait that outlasts ~10 s traps. Products are f32 FMAs in a fixed order
// (the reference computes them in f32, not TF32), with no atomics in any
// sum: the same inputs give the same bits every run.
//
// The forward (`slstm_fwd_kernel`):
// * Lane l of warp w owns column l of the block's 32 (gate l / 8, unit
//   l % 8) over rows k of its warp's slice of r (d / 8 rows), and keeps
//   them in registers for all S steps (128 floats at d = 1024; a slice
//   longer than the largest power of two <= 128 in it keeps the rest in
//   shared memory), so r is read from device memory once a launch.
// * h crosses the grid step-tagged: each cell thread stores (step + 1,
//   h) as one 64-bit word (single-copy atomic) into one of two slots by the
//   step's parity; a warp reads the words of its slice of h_{t-1} with
//   64-bit relaxed loads, reloading only those whose tag is not its step's
//   yet, until all are. So
//   the wait and the staging are one L2 trip, with no counter, no fence
//   and no block barrier before the product, and each warp waits only on
//   the 16 blocks whose units it reads. Two slots suffice: a block writes
//   step t + 1 into step t - 1's slot only after reading all of h_t, which
//   every block wrote after reading all of h_{t-1}. The buffer is zeroed by
//   the wrapper (tag 0 is no step); a decode step (S = 1) crosses none.
// * A batch row's product sums k mod 4 in four independent partial sums
//   (at B1 a chain of 128 FMAs is the product's latency), then the four
//   in a fixed order, then the warps' sums in warp order; rows go one at a
//   time, so a tile of fewer than 8 issues no work for the missing ones.
//   One block barrier a tile of 8 batch rows, the warps' sums
//   double-buffered.
// * Each tile's cell threads fetch their wx before the wait.
// * It keeps, when asked (the wrapper's `keep`, a null pointer otherwise),
//   each step's pre-activations and c, n, m: 7 (B, S, d) f32, 117 MB at B1
//   S4096 d1024. The backward recomputes the gates from them.
//
// The backward (`slstm_bwd_kernel`): the rows of r of a block's units in
// shared memory; per step dpre crosses the grid behind a barrier (a counter
// one thread per block adds to after a fence, an acquire spin) and is read
// with L1-bypassing loads (__ldcg: L1 is not coherent between SMs).
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
constexpr int NP = 4;         // the forward's partial sums a batch row (k mod NP)

static_assert(C == 32, "the forward maps one column of r to one lane");

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The backward's grid barrier: a block's arrival publishes every write its
// threads made before it; the wait returns once `target` arrivals have been
// made.
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

// The forward's exchange: (tag, h) as one 64-bit word, tag in the high half
__device__ __forceinline__ void put_tagged(unsigned long long* p, float h, unsigned tag) {
  const unsigned long long v = (static_cast<unsigned long long>(tag) << 32) | __float_as_uint(h);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" :: "l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ ulonglong2 get_tagged2(const unsigned long long* p) {
  ulonglong2 v;
  asm volatile("ld.relaxed.gpu.global.v2.b64 {%0, %1}, [%2];\n"
               : "=l"(v.x), "=l"(v.y) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

struct Fwd {
  const float* wx;                                  // (B, S, 4d)
  const float* r;                                   // (d, 4d)
  const float *c0, *n0, *h0, *m0;                   // (B, d) each, or null: zeros
  float* hs;                                        // (B, S, d)
  float *c, *n, *h, *m;                             // the final state (B, d)
  float *kpre, *kc, *kn, *km;                       // kept (B, S, 4d), (B, S, d) x3, or null
  unsigned long long* x;                            // the exchange (2, B, d), zeroed
  int B, S, d;
};

// Shared memory: the warps' rows of r past the registers' KR [NW][ks - KR][C],
// the warps' staged h [NW][BT][ks], the warps' sums [2][NW][BT][C], the
// state [4][B][U] (c, n, h, m).
size_t fwd_smem(int B, int d, int kr) {
  const size_t ks = d / NW;
  return sizeof(float) *
         (NW * (ks - kr) * C + NW * BT * ks + 2 * NW * BT * C + 4 * size_t(B) * U);
}

// The largest power of two <= min(ks, 128) (ks = d / 8 is a multiple of 4):
// the rows of a warp's slice of r each lane keeps in registers.
int pick_kr(int ks) {
  int kr = 4;
  while (kr < 128 && 2 * kr <= ks) kr *= 2;
  return kr;
}

// The exchange words of a warp's slice of h_{t-1}, rows b0 .. b0 + nb: a
// lane's LB lines (16 bytes, two units each) of a round. A line's row and
// pair of units are stepped from the round's first (r0, c0), with no
// division a line (a division a line cost ~1.7 us a step at B8 on an H100).
template <int LB>
struct Lines {
  ulonglong2 v[LB];
};

__device__ __forceinline__ void next_line(int& r, int& c, int per_row) {
  c += 32;
  while (c >= per_row) {
    c -= per_row;
    ++r;
  }
}

template <int LB>
__device__ __forceinline__ void load_lines(Lines<LB>& L, const unsigned long long* src, int d,
                                           int r0, int c0, int per_row, unsigned pending) {
  int r = r0, c = c0;
#pragma unroll
  for (int i = 0; i < LB; ++i) {
    if (pending >> i & 1u) L.v[i] = get_tagged2(src + (long long)r * d + 2 * c);
    next_line(r, c, per_row);
  }
}

__device__ __forceinline__ bool tagged(const ulonglong2& v, unsigned long long want) {
  return (v.x >> 32) == want && (v.y >> 32) == want;
}

// The lines of `pending` whose two words do not carry step `want`'s tag yet
template <int LB>
__device__ __forceinline__ unsigned untagged(const Lines<LB>& L, unsigned pending,
                                             unsigned long long want) {
#pragma unroll
  for (int i = 0; i < LB; ++i)
    if ((pending >> i & 1u) && tagged(L.v[i], want)) pending &= ~(1u << i);
  return pending;
}

template <int KR, int LB>
__global__ void __launch_bounds__(NT, 1) slstm_fwd_kernel(const Fwd a) {
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, S = a.S, d = a.d, d4 = 4 * d, ks = d / NW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* Ro = smem;                                 // [NW][ks - KR][C]
  float* Hs = Ro + NW * (ks - KR) * C;              // [NW][BT][ks]
  float* part = Hs + NW * BT * ks;                  // [2][NW][BT][C]
  float* st = part + 2 * NW * BT * C;               // [4][B][U]
  float* Rw = Ro + warp * (ks - KR) * C;
  float* Hw = Hs + warp * BT * ks;
  const int BU = B * U;
  const int u0 = blockIdx.x * U;
  const int kb = warp * ks;                         // the warp's rows of r, of h
  const int col = (lane / U) * d + u0 + lane % U;   // the lane's column of r

  // r's columns of this block's units over the warp's rows: registers, then
  // shared memory past KR
  float rr[KR];
#pragma unroll
  for (int i = 0; i < KR; ++i) rr[i] = a.r[(long long)(kb + i) * d4 + col];
  for (int i = KR; i < ks; ++i) Rw[(i - KR) * C + lane] = a.r[(long long)(kb + i) * d4 + col];
  for (int i = tid; i < BU; i += NT) {
    const int b = i / U, u = i % U;
    const long long at = (long long)b * d + u0 + u;
    st[i] = a.c0 ? a.c0[at] : 0.f;
    st[BU + i] = a.n0 ? a.n0[at] : 0.f;
    st[2 * BU + i] = a.h0 ? a.h0[at] : 0.f;
    st[3 * BU + i] = a.m0 ? a.m0[at] : 0.f;
  }

  const int cj = tid / U, cu = tid % U;             // a cell thread's batch row in the tile, unit
  const int per_row = ks / 2;                       // exchange lines of a row of the warp's slice
  int buf = 0;
  for (int t = 0; t < S; ++t) {
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int nb = min(BT, B - b0);
      const bool cell = tid < nb * U;
      const long long row = (long long)(b0 + cj) * S + t;
      // the cell thread's wx, fetched before the wait
      float w[G];
      if (cell) {
#pragma unroll
        for (int g = 0; g < G; ++g) w[g] = a.wx[row * d4 + g * d + u0 + cu];
      }
      // the warp's slice of h_{t-1}, rows b0 .. b0 + nb, into Hw [nb][ks]
      if (t == 0) {
        for (int e = lane; e < nb * ks; e += 32) {
          const int j = e / ks, k = e % ks;
          Hw[j * ks + k] = a.h0 ? a.h0[(long long)(b0 + j) * d + kb + k] : 0.f;
        }
      } else {
        const unsigned long long* src = a.x + ((long long)((t - 1) & 1) * B + b0) * d + kb;
        const unsigned long long want = unsigned(t);   // h_{t-1} carries tag t
        const int total = nb * per_row;
        for (int base = 0; base < total; base += 32 * LB) {
          // load the round's lines, then reload only those not yet tagged
          Lines<LB> lines;
          const int r0 = (base + lane) / per_row, c0 = base + lane - r0 * per_row;
          unsigned pending = 0;
#pragma unroll
          for (int i = 0; i < LB; ++i)
            if (base + i * 32 + lane < total) pending |= 1u << i;
          const unsigned mine = pending;
          const long long t0 = clock64();
          while (pending) {
            load_lines(lines, src, d, r0, c0, per_row, pending);
            pending = untagged(lines, pending, want);
            if (pending && clock64() - t0 > STALL_CYCLES) __trap();
          }
          int r = r0, c = c0;
#pragma unroll
          for (int i = 0; i < LB; ++i) {
            if (mine >> i & 1u)
              *reinterpret_cast<float2*>(Hw + r * ks + 2 * c) =
                  make_float2(__uint_as_float(unsigned(lines.v[i].x)),
                              __uint_as_float(unsigned(lines.v[i].y)));
            next_line(r, c, per_row);
          }
        }
      }
      __syncwarp();

      // the warp's share of h r for the lane's column, a batch row at a time
      // (no predicated work for rows past nb): NP partial sums, k mod NP
      float* pw = part + buf * NW * BT * C;
      for (int j = 0; j < nb; ++j) {
        const float* hj = Hw + j * ks;
        float acc[NP];
#pragma unroll
        for (int p = 0; p < NP; ++p) acc[p] = 0.f;
#pragma unroll
        for (int i = 0; i < KR; i += 4) {
          const float4 hv = *reinterpret_cast<const float4*>(hj + i);
          acc[0 % NP] = fmaf(hv.x, rr[i], acc[0 % NP]);
          acc[1 % NP] = fmaf(hv.y, rr[i + 1], acc[1 % NP]);
          acc[2 % NP] = fmaf(hv.z, rr[i + 2], acc[2 % NP]);
          acc[3 % NP] = fmaf(hv.w, rr[i + 3], acc[3 % NP]);
        }
        for (int k = KR; k < ks; k += 4) {
          const float* rk = Rw + (k - KR) * C + lane;
          const float4 hv = *reinterpret_cast<const float4*>(hj + k);
          acc[0 % NP] = fmaf(hv.x, rk[0], acc[0 % NP]);
          acc[1 % NP] = fmaf(hv.y, rk[C], acc[1 % NP]);
          acc[2 % NP] = fmaf(hv.z, rk[2 * C], acc[2 % NP]);
          acc[3 % NP] = fmaf(hv.w, rk[3 * C], acc[3 % NP]);
        }
        float s = acc[0];
#pragma unroll
        for (int p = 1; p < NP; ++p) s += acc[p];
        pw[(warp * BT + j) * C + lane] = s;
      }
      __syncthreads();   // the warps' sums are written

      if (cell) {
        const int b = b0 + cj;
        float pre[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int cc = g * U + cu;
          float s = pw[cj * C + cc];
#pragma unroll
          for (int w2 = 1; w2 < NW; ++w2) s += pw[(w2 * BT + cj) * C + cc];
          pre[g] = w[g] + s;
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
        if (t + 1 < S) put_tagged(a.x + ((long long)(t & 1) * B + b) * d + u0 + cu, h, t + 1);
        a.hs[at] = h;
        if (a.kpre) {
#pragma unroll
          for (int g = 0; g < G; ++g) a.kpre[row * d4 + g * d + u0 + cu] = pre[g];
          a.kc[at] = c;
          a.kn[at] = n;
          a.km[at] = mn;
        }
      }
      buf ^= 1;
    }
  }
  __syncthreads();   // every cell thread's state is written
  for (int i = tid; i < BU; i += NT) {
    const int b = i / U, u = i % U;
    const long long at = (long long)b * d + u0 + u;
    a.c[at] = st[i];
    a.n[at] = st[BU + i];
    a.h[at] = st[2 * BU + i];
    a.m[at] = st[3 * BU + i];
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


// The exchange loads a lane keeps in flight (a round): enough for a tile's
// lines (min(B, 8) rows of the warp's d / 8 units, two a line), at most 16.
int pick_lb(int B, int d) {
  const int lines = ((B < BT ? B : BT) * (d / NW / 2) + 31) / 32;
  return lines <= 2 ? 2 : lines <= 4 ? 4 : lines <= 8 ? 8 : 16;
}

template <int KR, int LB>
cudaError_t launch_fwd(const Fwd& a, cudaStream_t stream) {
  return launch_coop(slstm_fwd_kernel<KR, LB>, a, a.d / U, fwd_smem(a.B, a.d, KR), stream);
}

template <int KR>
cudaError_t launch_lb(const Fwd& a, cudaStream_t stream) {
  switch (pick_lb(a.B, a.d)) {
    case 2: return launch_fwd<KR, 2>(a, stream);
    case 4: return launch_fwd<KR, 4>(a, stream);
    case 8: return launch_fwd<KR, 8>(a, stream);
    default: return launch_fwd<KR, 16>(a, stream);
  }
}

}  // namespace

// `exchange`: the forward's (2, B, d) 64-bit words, zeroed (unread at S = 1)
extern "C" int repro_slstm_fwd(const float* wx, const float* r, const float* c0, const float* n0,
                               const float* h0, const float* m0, float* hs, float* c, float* n,
                               float* h, float* m, float* kpre, float* kc, float* kn, float* km,
                               void* exchange, int B, int S, int d, void* stream) {
  if (bad_shape(B, S, d)) return cudaErrorInvalidValue;
  const Fwd a{wx, r, c0, n0, h0, m0, hs, c, n, h, m, kpre, kc, kn, km,
              static_cast<unsigned long long*>(exchange), B, S, d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pick_kr(d / NW)) {
    case 4: return launch_lb<4>(a, s);
    case 8: return launch_lb<8>(a, s);
    case 16: return launch_lb<16>(a, s);
    case 32: return launch_lb<32>(a, s);
    case 64: return launch_lb<64>(a, s);
    default: return launch_lb<128>(a, s);
  }
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
