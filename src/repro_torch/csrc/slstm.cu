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
// The backward (`slstm_bwd_kernel<JM>`): per step t from S - 1 down to 0,
// dh = dhs_t + dpre_{t+1} r^T, then the cell stepped back with dc, dn, dm
// carried, writing dpre_t (= dwx); with a start state, dh0 = dpre_0 r^T
// and the carries last. dh's product is a dot 4d long for each unit, so
// the 4d dpre values that every block would read each step are four
// times the forward's h (at B1 S4096 d1024 on an H100, gathering them as
// step-tagged words took 3.5 us a step: 32 KB a block through L2). So each
// block instead scatters its own 32 columns' share of the product:
// * Thread tid owns units j = tid + 256 m of the whole d and keeps r's
//   values of the block's 32 columns (4 gates x its 8 units) for them in
//   registers for m < JM (4 units at d = 1024: 128 floats; further units
//   in shared memory), so r is read from device memory once a launch.
//   After a step's cell it adds up its units' partial sums over the 32
//   columns, p_P[j] = sum_c dpre_t[c] r[j, c] (two sums over alternate
//   groups of 4 columns, each in column order, then added), and stores
//   them for every j: a block writes d words a batch row a step.
// * The partial sums cross the grid step-tagged as the forward's h does:
//   (S - s, p_P[j]) as 64-bit words into slot s & 1 of a (2, B, d / 8, d)
//   buffer the wrapper zeroes (tag 0 is no step); a block reads, for its 8
//   units, the d / 8 producers' words of a row (d words, 8 KB at d 1024,
//   each word read by one block only), reloading those not tagged yet; no
//   counter, no fence, no block barrier before the sum. Two slots suffice
//   in reverse time: a block overwrites step s + 2's words with step s's
//   only after reading step s + 1's words of every block, each written
//   after its block read step s + 2's. A tag that is not yet the step's is
//   read again, never used. The dh0 pass reads step 0's words the same
//   way; one step without a start state crosses nothing and gets no buffer.
// * Thread tid reads 4 units' words of one producer (a chunk; two at d
//   above 1024), the warp sums its 16 producers' chunks a unit (xor 16
//   and 8 each hand over the half of the units a lane does not keep, xor
//   4 and 2 finish: 5 shuffles), and the warps' sums go through shared
//   memory behind the step's one block barrier. Every warp then steps all
//   of the block's cells itself (lane = batch row % 4, unit), so that it
//   holds the 32 dpre values its products need with no second barrier;
//   warp 0 writes the outputs. Every sum has a fixed order: the same inputs
//   give the same bits.
// * A cell lane fetches step t - 1's 11 inputs before step t's wait.
#include <stdint.h>

#include <mutex>

#include "common.cuh"

namespace {

constexpr int NT = 256;       // threads: 8 warps
constexpr int NW = NT / 32;
constexpr int U = 8;          // hidden units a block owns
constexpr int G = 4;          // gates z, i, f, o
constexpr int C = G * U;      // columns of r a block's units own (the forward: one a lane)
constexpr int BT = 8;         // batch rows one forward pass over r takes
constexpr int BTB = 32 / U;   // batch rows a backward tile takes: a lane a (row, unit)
constexpr int NP = 4;         // the forward's partial sums a batch row (k mod NP)
constexpr int NPB = 2;        // the backward's sums a unit's share (4-column groups mod NPB)

static_assert(C == 32, "the forward maps one column of r to one lane");

// A wait that outlasts STALL_CYCLES (~10 s) traps: a grid whose blocks were
// not all resident fails the launch with an error instead of hanging.
constexpr long long STALL_CYCLES = 20000000000LL;

// The exchange: (tag, value) as one 64-bit word, tag in the high half
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
  unsigned long long* x;                            // the exchange (2, B, d / U, d) or null
  int B, S, d;
  const float* rT;                                  // r^T (4d, d): the wide path only
};

// A thread's units of the whole d (fewer than one a thread at d < 256)
int unit_slots(int d) { return (d + NT - 1) / NT; }

// The units a thread keeps r's values of in registers: the largest power
// of two <= min(its units, 4)
int pick_jm(int d) {
  const int js = unit_slots(d);
  int jm = 1;
  while (jm < 4 && 2 * jm <= js) jm *= 2;
  return jm;
}

// Shared memory: r's values of a thread's units past the registers' JM
// [js - JM][G U][NT], the warps' sums [2][BTB][NW][U], each warp's dpre
// [NW][BTB][G U] and carries [NW][3][B][U] (dc, dn, dm).
size_t bwd_smem(int B, int d, int jm) {
  return sizeof(float) * (size_t(unit_slots(d) - jm) * C * NT + 2 * BTB * NW * U +
                          NW * BTB * C + NW * 3 * size_t(B) * U);
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

// The warps' sums of step s's partial sums for rows b0 .. b0 + nb of the
// block's units (dpre_s r^T), into pw [BTB][NW][U]: thread tid's chunks
// ch = tid + NT i (producer ch / 2, units 4 (ch % 2) ..), waited for
__device__ __forceinline__ void gather_tile(const Bwd& a, float* pw, int b0, int nb, int s) {
  const int d = a.d, nch = d / 4, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int u0 = blockIdx.x * U;
  const unsigned long long want = unsigned(a.S - s);   // step s's words carry tag S - s
  for (int j = 0; j < nb; ++j) {
    const unsigned long long* row = a.x + ((long long)(s & 1) * a.B + b0 + j) * (d / U) * d;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ch = tid; ch < nch; ch += NT) {
      const unsigned long long* src = row + (long long)(ch >> 1) * d + u0 + 4 * (ch & 1);
      Lines<2> L;
      unsigned pending = 3;
      const long long t0 = clock64();
      while (pending) {
        if (pending & 1u) L.v[0] = get_tagged2(src);
        if (pending & 2u) L.v[1] = get_tagged2(src + 2);
        pending = untagged(L, pending, want);
        if (pending && clock64() - t0 > STALL_CYCLES) __trap();
      }
      acc[0] += __uint_as_float(unsigned(L.v[0].x));
      acc[1] += __uint_as_float(unsigned(L.v[0].y));
      acc[2] += __uint_as_float(unsigned(L.v[1].x));
      acc[3] += __uint_as_float(unsigned(L.v[1].y));
    }
    // over the 16 lanes of the same unit half (lane bit 0): xor 16 and 8
    // hand over half of the units a lane does not keep, xor 4 and 2 finish;
    // lane l ends with unit 4 (l & 1) + 2 (l >> 4 & 1) + (l >> 3 & 1)
    const bool b4 = lane & 16, b3 = lane & 8;
    float h2[2];
#pragma unroll
    for (int k = 0; k < 2; ++k)
      h2[k] = (b4 ? acc[k + 2] : acc[k]) +
              __shfl_xor_sync(repro::FULL_MASK, b4 ? acc[k] : acc[k + 2], 16);
    float v = (b3 ? h2[1] : h2[0]) + __shfl_xor_sync(repro::FULL_MASK, b3 ? h2[0] : h2[1], 8);
    v += __shfl_xor_sync(repro::FULL_MASK, v, 4);
    v += __shfl_xor_sync(repro::FULL_MASK, v, 2);
    if ((lane & 6) == 0)
      pw[(j * NW + warp) * U + 4 * (lane & 1) + 2 * (lane >> 4 & 1) + (lane >> 3 & 1)] = v;
  }
}

__device__ __forceinline__ float warp_sums(const float* pw, int j, int u) {
  float s = pw[j * NW * U + u];
#pragma unroll
  for (int w = 1; w < NW; ++w) s += pw[(j * NW + w) * U + u];
  return s;
}

template <int JM>
__global__ void __launch_bounds__(NT, 1) slstm_bwd_kernel(const Bwd a) {
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, S = a.S, d = a.d, d4 = 4 * d;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int js = (d + NT - 1) / NT;
  float* Rs = smem;                                 // [js - JM][C][NT]
  float* part = Rs + (js - JM) * C * NT;            // [2][BTB][NW][U]
  float* Dw = part + 2 * BTB * NW * U + warp * BTB * C;             // this warp's [BTB][C]
  float* stw = part + 2 * BTB * NW * U + NW * BTB * C + warp * 3 * B * U;   // [3][B][U]
  const int BU = B * U;
  const int u0 = blockIdx.x * U;
  const bool has_state = a.dc0 != nullptr;

  // r's values of the block's 32 columns (c = 8 g + u: column g d + u0 + u)
  // for the thread's units j = tid + NT m: registers, then shared memory
  // past JM. Only this thread reads them: no barrier.
  float rr[JM][C];
#pragma unroll
  for (int m = 0; m < JM; ++m) {
    const int j = tid + NT * m;
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      const float4 v = j < d ? *reinterpret_cast<const float4*>(a.r + (long long)j * d4 +
                                                                (c / U) * d + u0 + c % U)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      rr[m][c] = v.x;
      rr[m][c + 1] = v.y;
      rr[m][c + 2] = v.z;
      rr[m][c + 3] = v.w;
    }
  }
  for (int m = JM; m < js; ++m) {
    const int j = tid + NT * m;
    for (int c = 0; c < C; ++c)
      Rs[((m - JM) * C + c) * NT + tid] = j < d ? a.r[(long long)j * d4 + (c / U) * d + u0 + c % U]
                                                : 0.f;
  }
  // each warp's carries; a lane reads and writes only those of its (row, unit)
  const int cj = lane / U, cu = lane % U;           // a cell lane's batch row in the tile, unit
  const int unit = u0 + cu;
  for (int b = cj; b < B; b += BTB) {
    const long long at = (long long)b * d + unit;
    stw[b * U + cu] = a.dcT ? a.dcT[at] : 0.f;
    stw[BU + b * U + cu] = a.dnT ? a.dnT[at] : 0.f;
    stw[2 * BU + b * U + cu] = a.dmT ? a.dmT[at] : 0.f;
  }

  CellIn nx;                                        // the first tile's inputs of the next step
  if (cj < B) nx = load_cell(a, cj, S - 1, unit);
  int buf = 0;
  for (int t = S - 1; t >= 0; --t) {
    for (int b0 = 0; b0 < B; b0 += BTB) {
      const int nb = min(BTB, B - b0);
      const bool cell = cj < nb;
      const int b = b0 + cj;
      CellIn x;
      if (cell) {
        if (b0 == 0) {
          x = nx;
          if (t > 0) nx = load_cell(a, cj, t - 1, unit);   // step t - 1's, before step t's wait
        } else {
          x = load_cell(a, b, t, unit);
        }
      }
      float* pw = part + buf * BTB * NW * U;
      if (t < S - 1) {
        gather_tile(a, pw, b0, nb, t + 1);
        __syncthreads();   // the warps' sums are written
      }
      __syncwarp();        // this warp's products of the last tile have read Dw
      if (cell) {
        const float rec = t < S - 1 ? warp_sums(pw, cj, cu)
                                    : (a.dhT ? a.dhT[(long long)b * d + unit] : 0.f);
        const int si = b * U + cu;
        float dc = stw[si], dn = stw[BU + si], dm = stw[2 * BU + si];
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
        const float g4[G] = {dz, dit, da, dot};
#pragma unroll
        for (int g = 0; g < G; ++g) Dw[cj * C + g * U + cu] = g4[g];
        if (warp == 0) {
          float* out = a.dpre + ((long long)b * S + t) * d4 + unit;
#pragma unroll
          for (int g = 0; g < G; ++g) out[g * d] = g4[g];
        }
        stw[si] = dc * f_;
        stw[BU + si] = dn * f_;
        stw[2 * BU + si] = da;
      }
      __syncwarp();        // this warp's dpre of the tile is in Dw
      buf ^= 1;
      if (t == 0 && !has_state) continue;
      // this block's share of dpre_t r^T for each of the thread's units:
      // the 32 columns in order, step-tagged
      for (int j = 0; j < nb; ++j) {
        const float* D = Dw + j * C;
        unsigned long long* xo =
            a.x + (((long long)(t & 1) * B + b0 + j) * (d / U) + blockIdx.x) * d + tid;
        float p[NPB][JM];
#pragma unroll
        for (int k = 0; k < NPB; ++k)
#pragma unroll
          for (int m = 0; m < JM; ++m) p[k][m] = 0.f;
#pragma unroll
        for (int c = 0; c < C; c += 4 * NPB)
#pragma unroll
          for (int k = 0; k < NPB; ++k) {
            const int e = c + 4 * k;
            const float4 dv = *reinterpret_cast<const float4*>(D + e);
#pragma unroll
            for (int m = 0; m < JM; ++m) {
              p[k][m] = fmaf(dv.x, rr[m][e], p[k][m]);
              p[k][m] = fmaf(dv.y, rr[m][e + 1], p[k][m]);
              p[k][m] = fmaf(dv.z, rr[m][e + 2], p[k][m]);
              p[k][m] = fmaf(dv.w, rr[m][e + 3], p[k][m]);
            }
          }
#pragma unroll
        for (int m = 0; m < JM; ++m) {
          float v = p[0][m];
#pragma unroll
          for (int k = 1; k < NPB; ++k) v += p[k][m];
          if (tid + NT * m < d) put_tagged(xo + NT * m, v, S - t);
        }
        for (int m = JM; m < js; ++m) {
          if (tid + NT * m >= d) continue;
          const float* rs = Rs + (m - JM) * C * NT + tid;
          float q = 0.f;
          for (int c = 0; c < C; ++c) q = fmaf(D[c], rs[c * NT], q);
          put_tagged(xo + NT * m, q, S - t);
        }
      }
    }
  }
  if (!has_state) return;
  // the start state's gradient: dh0 = dpre_0 r^T, and warp 0's carries
  for (int b0 = 0; b0 < B; b0 += BTB) {
    const int nb = min(BTB, B - b0);
    float* pw = part + buf * BTB * NW * U;
    gather_tile(a, pw, b0, nb, 0);
    __syncthreads();   // the warps' sums are written
    if (warp == 0 && cj < nb) {
      const int b = b0 + cj;
      const long long at = (long long)b * d + unit;
      const int si = b * U + cu;
      a.dh0[at] = warp_sums(pw, cj, cu);
      a.dc0[at] = stw[si];
      a.dn0[at] = stw[BU + si];
      a.dm0[at] = stw[2 * BU + si];
    }
    buf ^= 1;
  }
}

// ---------------------------------------------------------------------------
// The wide path: UW = 16, 32 or 64 units a block, for a d whose d / 8 blocks
// cannot all be resident. A block's share of r is 4 UW d f32 (288 KB at d
// 1152, UW 16; 2 MB at d 4096, UW 32): registers take KRW rows a thread,
// shared memory what it has room for, and the rest is read from device
// memory (L2 where it fits) every step, inside the same kernel.
// ---------------------------------------------------------------------------

constexpr int KRW = 128;                // the forward's rows of r a thread keeps in registers
constexpr int HS_MAX = 16384;           // the forward's staged h, floats (64 KB)
constexpr size_t SMEM_MAX = 232448;     // dynamic shared memory a block may have

__host__ __device__ constexpr int wide_tile(int uw) { return uw >= 32 ? NT / uw : 8; }
__host__ __device__ constexpr int wide_jm(int uw) { return 128 / (G * uw); }

// The forward (`slstm_fwd_wide_kernel<UW>`): thread tid owns column c = tid
// % (4 UW) of the block's (gate c / UW, unit c % UW) over rows g rg .. (g +
// 1) rg of r (g = tid / (4 UW), rg = d / KG, KG = NT / (4 UW) groups), KRW of
// them in registers, `nsm` in shared memory, the rest from device memory.
// A tile of `bt` batch rows at a time: the block stages all of h_{t-1}'s
// rows (step-tagged words, reloaded until tagged), each thread sums its
// rows in 4 partial sums (k mod 4), the KG groups' sums in group order.
template <int UW>
__global__ void __launch_bounds__(NT, 1) slstm_fwd_wide_kernel(const Fwd a, int bt, int nsm) {
  constexpr int CW = G * UW, KG = NT / CW;
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, S = a.S, d = a.d, d4 = 4 * d, rg = d / KG, ng = rg - KRW - nsm;
  const int tid = threadIdx.x, c = tid % CW, g = tid / CW;
  float* Rs = smem;                                 // [nsm][NT]
  float* Hs = Rs + nsm * NT;                        // [bt][d]
  float* part = Hs + bt * d;                        // [KG][bt][CW]
  float* st = part + KG * bt * CW;                  // [4][B][UW]
  const int BU = B * UW;
  const int u0 = blockIdx.x * UW;
  const int kb = g * rg;
  const long long col = (long long)(c / UW) * d + u0 + c % UW;
  const float* rg_ = a.r + (long long)(kb + KRW + nsm) * d4 + col;   // the rows read each step

  float rr[KRW];
#pragma unroll
  for (int i = 0; i < KRW; ++i) rr[i] = a.r[(long long)(kb + i) * d4 + col];
  for (int i = 0; i < nsm; ++i) Rs[i * NT + tid] = a.r[(long long)(kb + KRW + i) * d4 + col];
  for (int i = tid; i < BU; i += NT) {
    const int b = i / UW, u = i % UW;
    const long long at = (long long)b * d + u0 + u;
    st[i] = a.c0 ? a.c0[at] : 0.f;
    st[BU + i] = a.n0 ? a.n0[at] : 0.f;
    st[2 * BU + i] = a.h0 ? a.h0[at] : 0.f;
    st[3 * BU + i] = a.m0 ? a.m0[at] : 0.f;
  }

  const int cj = tid / UW, cu = tid % UW;           // a cell thread's batch row in the tile, unit
  const int per_row = d / 2;                        // exchange lines of a row
  for (int t = 0; t < S; ++t) {
    for (int b0 = 0; b0 < B; b0 += bt) {
      const int nb = min(bt, B - b0);
      const bool cell = tid < nb * UW;
      const long long row = (long long)(b0 + cj) * S + t;
      float w[G];
      if (cell) {
#pragma unroll
        for (int q = 0; q < G; ++q) w[q] = a.wx[row * d4 + q * d + u0 + cu];
      }
      // h_{t-1}, rows b0 .. b0 + nb, into Hs [nb][d]
      if (t == 0) {
        for (int e = tid; e < nb * d; e += NT) {
          const int j = e / d, k = e % d;
          Hs[e] = a.h0 ? a.h0[(long long)(b0 + j) * d + k] : 0.f;
        }
      } else {
        const unsigned long long* src = a.x + ((long long)((t - 1) & 1) * B + b0) * d;
        const unsigned long long want = unsigned(t);
        const int total = nb * per_row;
        for (int base = 0; base < total; base += 4 * NT) {
          Lines<4> L;
          unsigned pending = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (base + i * NT + tid < total) pending |= 1u << i;
          const unsigned mine = pending;
          const long long t0 = clock64();
          while (pending) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (pending >> i & 1u) {
                const int e = base + i * NT + tid, j = e / per_row;
                L.v[i] = get_tagged2(src + (long long)j * d + 2 * (e - j * per_row));
              }
            pending = untagged(L, pending, want);
            if (pending && clock64() - t0 > STALL_CYCLES) __trap();
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (mine >> i & 1u) {
              const int e = base + i * NT + tid, j = e / per_row;
              *reinterpret_cast<float2*>(Hs + j * d + 2 * (e - j * per_row)) =
                  make_float2(__uint_as_float(unsigned(L.v[i].x)),
                              __uint_as_float(unsigned(L.v[i].y)));
            }
        }
      }
      __syncthreads();   // h_{t-1} is staged

      for (int j = 0; j < nb; ++j) {
        const float* hj = Hs + j * d + kb;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < KRW; i += 4) {
          const float4 hv = *reinterpret_cast<const float4*>(hj + i);
          acc[0] = fmaf(hv.x, rr[i], acc[0]);
          acc[1] = fmaf(hv.y, rr[i + 1], acc[1]);
          acc[2] = fmaf(hv.z, rr[i + 2], acc[2]);
          acc[3] = fmaf(hv.w, rr[i + 3], acc[3]);
        }
        for (int i = 0; i < nsm; i += 4) {
          const float4 hv = *reinterpret_cast<const float4*>(hj + KRW + i);
          const float* rs = Rs + i * NT + tid;
          acc[0] = fmaf(hv.x, rs[0], acc[0]);
          acc[1] = fmaf(hv.y, rs[NT], acc[1]);
          acc[2] = fmaf(hv.z, rs[2 * NT], acc[2]);
          acc[3] = fmaf(hv.w, rs[3 * NT], acc[3]);
        }
#pragma unroll 2
        for (int i = 0; i < ng; i += 4) {
          const float4 hv = *reinterpret_cast<const float4*>(hj + KRW + nsm + i);
          const float* rk = rg_ + (long long)i * d4;
          acc[0] = fmaf(hv.x, __ldg(rk), acc[0]);
          acc[1] = fmaf(hv.y, __ldg(rk + d4), acc[1]);
          acc[2] = fmaf(hv.z, __ldg(rk + 2 * d4), acc[2]);
          acc[3] = fmaf(hv.w, __ldg(rk + 3 * (long long)d4), acc[3]);
        }
        part[(g * bt + j) * CW + c] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      }
      __syncthreads();   // the groups' sums are written, Hs is read

      if (cell) {
        const int b = b0 + cj;
        float pre[G];
#pragma unroll
        for (int q = 0; q < G; ++q) {
          const int cc = q * UW + cu;
          float s = part[cj * CW + cc];
#pragma unroll
          for (int g2 = 1; g2 < KG; ++g2) s += part[(g2 * bt + cj) * CW + cc];
          pre[q] = w[q] + s;
        }
        const int si = b * UW + cu;
        float cs = st[si], n = st[BU + si], m = st[3 * BU + si];
        const float z = tanhf(pre[0]);
        const float o = sigmoid(pre[3]);
        const float fm = pre[2] + m;
        const float mn = fmaxf(fm, pre[1]);
        const float i_ = expf(pre[1] - mn);
        const float f_ = expf(fm - mn);
        cs = f_ * cs + i_ * z;
        n = f_ * n + i_;
        const float h = o * cs / fmaxf(n, 1.f);
        st[si] = cs;
        st[BU + si] = n;
        st[2 * BU + si] = h;
        st[3 * BU + si] = mn;
        const long long at = row * d + u0 + cu;
        if (t + 1 < S) put_tagged(a.x + ((long long)(t & 1) * B + b) * d + u0 + cu, h, t + 1);
        a.hs[at] = h;
        if (a.kpre) {
#pragma unroll
          for (int q = 0; q < G; ++q) a.kpre[row * d4 + q * d + u0 + cu] = pre[q];
          a.kc[at] = cs;
          a.kn[at] = n;
          a.km[at] = mn;
        }
      }
    }
  }
  __syncthreads();   // every cell thread's state is written
  for (int i = tid; i < BU; i += NT) {
    const int b = i / UW, u = i % UW;
    const long long at = (long long)b * d + u0 + u;
    a.c[at] = st[i];
    a.n[at] = st[BU + i];
    a.h[at] = st[2 * BU + i];
    a.m[at] = st[3 * BU + i];
  }
}

// The backward's gather on the wide path: step s's partial sums of the
// block's UW units over the d / UW producers, rows b0 .. b0 + nb, into pw
// [bt][NW][UW]. Thread tid takes chunks ch = tid + NT i of 4 units
// (producer ch / (UW / 4), units 4 (ch % (UW / 4)) ..); the lanes that hold
// the same units sum by xor shuffles, then the warps' sums in warp order.
template <int UW>
__device__ __forceinline__ void gather_wide(const Bwd& a, float* pw, int b0, int nb, int s) {
  constexpr int QB = UW / 4;
  const int d = a.d, nch = d / 4, P = d / UW, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  const int u0 = blockIdx.x * UW;
  const unsigned long long want = unsigned(a.S - s);
  for (int j = 0; j < nb; ++j) {
    const unsigned long long* row = a.x + ((long long)(s & 1) * a.B + b0 + j) * P * d;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ch = tid; ch < nch; ch += NT) {
      const unsigned long long* src = row + (long long)(ch / QB) * d + u0 + 4 * (ch % QB);
      Lines<2> L;
      unsigned pending = 3;
      const long long t0 = clock64();
      while (pending) {
        if (pending & 1u) L.v[0] = get_tagged2(src);
        if (pending & 2u) L.v[1] = get_tagged2(src + 2);
        pending = untagged(L, pending, want);
        if (pending && clock64() - t0 > STALL_CYCLES) __trap();
      }
      acc[0] += __uint_as_float(unsigned(L.v[0].x));
      acc[1] += __uint_as_float(unsigned(L.v[0].y));
      acc[2] += __uint_as_float(unsigned(L.v[1].x));
      acc[3] += __uint_as_float(unsigned(L.v[1].y));
    }
#pragma unroll
    for (int m = QB; m < 32; m <<= 1)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] += __shfl_xor_sync(repro::FULL_MASK, acc[k], m);
    if (lane < QB) {
#pragma unroll
      for (int k = 0; k < 4; ++k) pw[(j * NW + warp) * UW + 4 * lane + k] = acc[k];
    }
  }
}

// The backward (`slstm_bwd_wide_kernel<UW>`): thread tid owns units j = tid
// + NT m of the whole d and r's values of the block's 4 UW columns for them,
// read from r^T (4d, d) so that neighbouring threads read neighbouring
// words: wide_jm(UW) units in registers, `nsm` in shared memory, the rest
// from device memory each step. Per step and tile of batch rows: the
// gather, one block barrier, the cells (a thread a (row, unit)), a second
// barrier, then each thread's share of dpre r^T for its units, stored
// step-tagged as on the 8-unit path.
template <int UW>
__global__ void __launch_bounds__(NT, 1) slstm_bwd_wide_kernel(const Bwd a, int nsm) {
  constexpr int CW = G * UW, BTW = wide_tile(UW), JMW = wide_jm(UW), JR = JMW > 0 ? JMW : 1;
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, S = a.S, d = a.d, d4 = 4 * d, P = d / UW;
  const int tid = threadIdx.x;
  const int js = (d + NT - 1) / NT;
  float* Rs = smem;                                 // [nsm][CW][NT]
  float* pw = Rs + nsm * CW * NT;                   // [BTW][NW][UW]
  float* Dp = pw + BTW * NW * UW;                   // [BTW][CW]
  float* st = Dp + BTW * CW;                        // [3][B][UW]
  const int BU = B * UW;
  const int u0 = blockIdx.x * UW;
  const bool has_state = a.dc0 != nullptr;
  const float* rT = a.rT;
  auto rcol = [&](int c) { return (long long)((c / UW) * d + u0 + c % UW) * d; };

  float rr[JR][CW];
#pragma unroll
  for (int m = 0; m < JMW; ++m) {
    const int j = tid + NT * m;
#pragma unroll
    for (int c = 0; c < CW; ++c) rr[m][c] = j < d ? rT[rcol(c) + j] : 0.f;
  }
  for (int m = 0; m < nsm; ++m) {
    const int j = tid + NT * (JMW + m);
    for (int c = 0; c < CW; ++c) Rs[(m * CW + c) * NT + tid] = j < d ? rT[rcol(c) + j] : 0.f;
  }
  for (int i = tid; i < BU; i += NT) {
    const int b = i / UW, u = i % UW;
    const long long at = (long long)b * d + u0 + u;
    st[i] = a.dcT ? a.dcT[at] : 0.f;
    st[BU + i] = a.dnT ? a.dnT[at] : 0.f;
    st[2 * BU + i] = a.dmT ? a.dmT[at] : 0.f;
  }
  const int cj = tid / UW, cu = tid % UW;
  const int unit = u0 + cu;
  __syncthreads();   // the carries are in place

  for (int t = S - 1; t >= 0; --t) {
    for (int b0 = 0; b0 < B; b0 += BTW) {
      const int nb = min(BTW, B - b0);
      const bool cell = cj < nb;
      const int b = b0 + cj;
      CellIn x;
      if (cell) x = load_cell(a, b, t, unit);
      if (t < S - 1) gather_wide<UW>(a, pw, b0, nb, t + 1);
      __syncthreads();   // the warps' sums are written; the last tile's products read Dp
      if (cell) {
        float rec;
        if (t < S - 1) {
          rec = pw[cj * NW * UW + cu];
#pragma unroll
          for (int w = 1; w < NW; ++w) rec += pw[(cj * NW + w) * UW + cu];
        } else {
          rec = a.dhT ? a.dhT[(long long)b * d + unit] : 0.f;
        }
        const int si = b * UW + cu;
        float dc = st[si], dn = st[BU + si], dm = st[2 * BU + si];
        const float z = tanhf(x.pre[0]);
        const float o = sigmoid(x.pre[3]);
        const float fm = x.pre[2] + x.mp;
        const float i_ = expf(x.pre[1] - x.m);
        const float f_ = expf(fm - x.m);
        const float nc = fmaxf(x.n, 1.f);
        const float dh = x.dh + rec;
        const float gq = dh / nc;
        const float d_o = gq * x.c;
        dc = dc + gq * o;
        dn = dn + (x.n >= 1.f ? -dh * (x.h / nc) : 0.f);
        const float dz = dc * i_ * (1.f - z * z);
        const float dot = d_o * (1.f - o) * o;
        const float di = dc * z + dn;
        const float df = dc * x.cp + dn * x.np;
        dm = dm - di * i_ - df * f_;
        float da = fm == x.pre[1] ? dm / 2.f : (fm > x.pre[1] ? dm : 0.f);
        const float dit = di * i_ + (dm - da);
        da = df * f_ + da;
        const float g4[G] = {dz, dit, da, dot};
        float* out = a.dpre + ((long long)b * S + t) * d4 + unit;
#pragma unroll
        for (int q = 0; q < G; ++q) {
          Dp[cj * CW + q * UW + cu] = g4[q];
          out[q * d] = g4[q];
        }
        st[si] = dc * f_;
        st[BU + si] = dn * f_;
        st[2 * BU + si] = da;
      }
      __syncthreads();   // the tile's dpre is in Dp; the cells have read pw
      if (t == 0 && !has_state) continue;
      for (int j = 0; j < nb; ++j) {
        const float* D = Dp + j * CW;
        unsigned long long* xo =
            a.x + (((long long)(t & 1) * B + b0 + j) * P + blockIdx.x) * d;
#pragma unroll
        for (int m = 0; m < JMW; ++m) {
          float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int c = 0; c < CW; c += 4) {
            const float4 dv = *reinterpret_cast<const float4*>(D + c);
            p[0] = fmaf(dv.x, rr[m][c], p[0]);
            p[1] = fmaf(dv.y, rr[m][c + 1], p[1]);
            p[2] = fmaf(dv.z, rr[m][c + 2], p[2]);
            p[3] = fmaf(dv.w, rr[m][c + 3], p[3]);
          }
          const int jj = tid + NT * m;
          if (jj < d) put_tagged(xo + jj, (p[0] + p[1]) + (p[2] + p[3]), S - t);
        }
        for (int m = JMW; m < js; ++m) {
          const int jj = tid + NT * m;
          if (jj >= d) continue;
          float p[4] = {0.f, 0.f, 0.f, 0.f};
          if (m < JMW + nsm) {
            const float* rs = Rs + (m - JMW) * CW * NT + tid;
            for (int c = 0; c < CW; c += 4) {
              const float4 dv = *reinterpret_cast<const float4*>(D + c);
              p[0] = fmaf(dv.x, rs[c * NT], p[0]);
              p[1] = fmaf(dv.y, rs[(c + 1) * NT], p[1]);
              p[2] = fmaf(dv.z, rs[(c + 2) * NT], p[2]);
              p[3] = fmaf(dv.w, rs[(c + 3) * NT], p[3]);
            }
          } else {
#pragma unroll 4
            for (int c = 0; c < CW; c += 4) {
              const float4 dv = *reinterpret_cast<const float4*>(D + c);
              p[0] = fmaf(dv.x, __ldg(rT + rcol(c) + jj), p[0]);
              p[1] = fmaf(dv.y, __ldg(rT + rcol(c + 1) + jj), p[1]);
              p[2] = fmaf(dv.z, __ldg(rT + rcol(c + 2) + jj), p[2]);
              p[3] = fmaf(dv.w, __ldg(rT + rcol(c + 3) + jj), p[3]);
            }
          }
          put_tagged(xo + jj, (p[0] + p[1]) + (p[2] + p[3]), S - t);
        }
      }
    }
  }
  if (!has_state) return;
  // the start state's gradient: dh0 = dpre_0 r^T, and the carries
  for (int b0 = 0; b0 < B; b0 += BTW) {
    const int nb = min(BTW, B - b0);
    gather_wide<UW>(a, pw, b0, nb, 0);
    __syncthreads();   // the warps' sums are written
    if (cj < nb) {
      const int b = b0 + cj;
      const long long at = (long long)b * d + unit;
      const int si = b * UW + cu;
      float s = pw[cj * NW * UW + cu];
#pragma unroll
      for (int w = 1; w < NW; ++w) s += pw[(cj * NW + w) * UW + cu];
      a.dh0[at] = s;
      a.dc0[at] = st[si];
      a.dn0[at] = st[BU + si];
      a.dm0[at] = st[2 * BU + si];
    }
    __syncthreads();   // pw is read before the next tile's gather
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

// The 8-unit forward's instantiation for (B, d)
template <int KR>
const void* fwd_lb(int B, int d) {
  switch (pick_lb(B, d)) {
    case 2: return reinterpret_cast<const void*>(slstm_fwd_kernel<KR, 2>);
    case 4: return reinterpret_cast<const void*>(slstm_fwd_kernel<KR, 4>);
    case 8: return reinterpret_cast<const void*>(slstm_fwd_kernel<KR, 8>);
    default: return reinterpret_cast<const void*>(slstm_fwd_kernel<KR, 16>);
  }
}
const void* fwd_kernel8(int B, int d) {
  switch (pick_kr(d / NW)) {
    case 4: return fwd_lb<4>(B, d);
    case 8: return fwd_lb<8>(B, d);
    case 16: return fwd_lb<16>(B, d);
    case 32: return fwd_lb<32>(B, d);
    case 64: return fwd_lb<64>(B, d);
    default: return fwd_lb<128>(B, d);
  }
}
const void* bwd_kernel8(int d) {
  switch (pick_jm(d)) {
    case 1: return reinterpret_cast<const void*>(slstm_bwd_kernel<1>);
    case 2: return reinterpret_cast<const void*>(slstm_bwd_kernel<2>);
    default: return reinterpret_cast<const void*>(slstm_bwd_kernel<4>);
  }
}

// What a launch at (B, d) with U units a block needs: the instantiation,
// its dynamic shared memory, and on the wide path the forward's tile of
// batch rows and either kernel's rows or units of r in shared memory. False
// where U does not divide d or the block's fixed share does not fit.
struct Plan {
  const void* fn;
  size_t smem;
  int bt, nsm;
};

template <int UW>
bool wide_plan(int B, int d, bool bwd, Plan* p) {
  constexpr int CW = G * UW;
  if (bwd) {
    const int js = (d + NT - 1) / NT;
    const size_t fixed =
        sizeof(float) * (size_t(wide_tile(UW)) * NW * UW + size_t(wide_tile(UW)) * CW +
                         3 * size_t(B) * UW);
    if (fixed > SMEM_MAX) return false;
    const int room = int((SMEM_MAX - fixed) / (sizeof(float) * CW * NT));
    const int nsm = max(0, min(js - wide_jm(UW), room));
    *p = {reinterpret_cast<const void*>(slstm_bwd_wide_kernel<UW>),
          fixed + sizeof(float) * size_t(nsm) * CW * NT, 0, nsm};
    return true;
  }
  const int rg = d / (NT / CW);
  if (rg < KRW) return false;
  int bt = min(min(8, NT / UW), B);
  while (bt > 1 && bt * d > HS_MAX) --bt;
  const size_t fixed =
      sizeof(float) * (size_t(bt) * d + size_t(NT) * bt + 4 * size_t(B) * UW);
  if (fixed > SMEM_MAX) return false;
  const int nsm = min(rg - KRW, int((SMEM_MAX - fixed) / (sizeof(float) * NT))) & ~3;
  *p = {reinterpret_cast<const void*>(slstm_fwd_wide_kernel<UW>),
        fixed + sizeof(float) * size_t(nsm) * NT, bt, nsm};
  return true;
}

bool plan(int B, int d, int u, bool bwd, Plan* p) {
  if (d % u) return false;
  switch (u) {
    case 8:
      *p = bwd ? Plan{bwd_kernel8(d), bwd_smem(B, d, pick_jm(d)), 0, 0}
               : Plan{fwd_kernel8(B, d), fwd_smem(B, d, pick_kr(d / NW)), 0, 0};
      return p->smem <= SMEM_MAX;
    case 16: return wide_plan<16>(B, d, bwd, p);
    case 32: return wide_plan<32>(B, d, bwd, p);
    case 64: return wide_plan<64>(B, d, bwd, p);
    default: return false;
  }
}

// The fewest units a block (8, 16, 32, 64) whose d / U blocks are all
// resident at once on the current device, by the SM count and the
// instantiation's occupancy at its shared memory; 0 if none. Chosen from
// the shape before any launch, and kept for the next call at the same
// (device, B, d, direction): a decode step asks every token.
struct Picked {
  int dev, B, d, bwd, u;
  Plan p;
};
constexpr int PICKS = 32;
Picked picks[PICKS];
int n_picks = 0, next_pick = 0;
std::mutex picks_mu;

int pick_units_uncached(int dev, int B, int d, bool bwd, Plan* chosen) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  for (int u = 8; u <= 64; u *= 2) {
    Plan p;
    if (!plan(B, d, u, bwd, &p)) continue;
    int per_sm = 0;
    if (cudaFuncSetAttribute(p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(p.smem)) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p.fn, NT, p.smem) != cudaSuccess) {
      cudaGetLastError();
      continue;
    }
    if ((long long)per_sm * sms >= d / u) {
      *chosen = p;
      return u;
    }
  }
  return 0;
}

int pick_units(int B, int d, bool bwd, Plan* chosen) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  std::lock_guard<std::mutex> lock(picks_mu);
  for (int i = 0; i < n_picks; ++i) {
    const Picked& k = picks[i];
    if (k.dev == dev && k.B == B && k.d == d && k.bwd == int(bwd)) {
      *chosen = k.p;
      return k.u;
    }
  }
  Plan p{};
  const int u = pick_units_uncached(dev, B, d, bwd, &p);
  picks[next_pick] = Picked{dev, B, d, int(bwd), u, p};
  next_pick = (next_pick + 1) % PICKS;
  n_picks = n_picks < PICKS ? n_picks + 1 : PICKS;
  *chosen = p;
  return u;
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

template <int JM>
cudaError_t launch_bwd(const Bwd& a, cudaStream_t stream) {
  return launch_coop(slstm_bwd_kernel<JM>, a, a.d / U, bwd_smem(a.B, a.d, JM), stream);
}

// A wide kernel's cooperative launch: the arguments struct, then ints
template <typename A, typename... I>
cudaError_t launch_wide(const Plan& p, const A& args, int blocks, cudaStream_t stream,
                        I... ints) {
  A copy = args;
  void* params[] = {&copy, &ints...};
  // the kernel's shared-memory limit is the function's, and another (B, d)
  // may have set it lower since this plan was made
  cudaError_t err = cudaFuncSetAttribute(p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(p.smem));
  if (err == cudaSuccess)
    err = cudaLaunchCooperativeKernel(p.fn, dim3(blocks), dim3(NT), params, p.smem, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return cudaGetLastError();
}

}  // namespace

// Units a block for the forward (backward = 0) or the backward at (B, d):
// 8 (one 8-unit block an SM, d <= 8 x the SM count on one a block), 16,
// 32 or 64; 0 where no grid fits. The backward's exchange is (2, B, d / U,
// d) words.
extern "C" int repro_slstm_units(int B, int d, int backward) {
  if (bad_shape(B, 1, d)) return 0;
  Plan p;
  return pick_units(B, d, backward != 0, &p);
}

// `exchange`: the forward's (2, B, d) 64-bit words, zeroed (unread at S = 1)
extern "C" int repro_slstm_fwd(const float* wx, const float* r, const float* c0, const float* n0,
                               const float* h0, const float* m0, float* hs, float* c, float* n,
                               float* h, float* m, float* kpre, float* kc, float* kn, float* km,
                               void* exchange, int B, int S, int d, void* stream) {
  if (bad_shape(B, S, d)) return cudaErrorInvalidValue;
  const Fwd a{wx, r, c0, n0, h0, m0, hs, c, n, h, m, kpre, kc, kn, km,
              static_cast<unsigned long long*>(exchange), B, S, d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan p;
  const int u = pick_units(B, d, false, &p);
  if (u == 0) return cudaErrorCooperativeLaunchTooLarge;
  if (u > 8) return launch_wide(p, a, d / u, s, p.bt, p.nsm);
  switch (pick_kr(d / NW)) {
    case 4: return launch_lb<4>(a, s);
    case 8: return launch_lb<8>(a, s);
    case 16: return launch_lb<16>(a, s);
    case 32: return launch_lb<32>(a, s);
    case 64: return launch_lb<64>(a, s);
    default: return launch_lb<128>(a, s);
  }
}

// `exchange`: the backward's (2, B, d / U, d) 64-bit words, zeroed; null
// only at S = 1 without a start state (nothing crosses the grid). `rT`:
// r^T (4d, d), read on the wide path (U > 8) only; last, so that a library
// built before it ignores it.
extern "C" int repro_slstm_bwd(const float* r, const float* hs, const float* kpre,
                               const float* kc, const float* kn, const float* km,
                               const float* c0, const float* n0, const float* m0,
                               const float* dhs, const float* dcT, const float* dnT,
                               const float* dhT, const float* dmT, float* dpre, float* dc0,
                               float* dn0, float* dh0, float* dm0, void* exchange, int B, int S,
                               int d, void* stream, const float* rT) {
  if (bad_shape(B, S, d) || (!exchange && (S > 1 || dc0))) return cudaErrorInvalidValue;
  const Bwd a{r, hs, kpre, kc, kn, km, c0, n0, m0, dhs, dcT, dnT, dhT, dmT, dpre,
              dc0, dn0, dh0, dm0, static_cast<unsigned long long*>(exchange), B, S, d, rT};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan p;
  const int u = pick_units(B, d, true, &p);
  if (u == 0) return cudaErrorCooperativeLaunchTooLarge;
  if (u > 8) {
    if (!rT) return cudaErrorInvalidValue;
    return launch_wide(p, a, d / u, s, p.nsm);
  }
  switch (pick_jm(d)) {
    case 1: return launch_bwd<1>(a, s);
    case 2: return launch_bwd<2>(a, s);
    default: return launch_bwd<4>(a, s);
  }
}
