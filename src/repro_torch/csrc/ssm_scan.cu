// Mamba selective scan for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_ssm_kernel` / `ssm_scan` in
// src/repro/kernels/ssm_scan/kernel.py. For each batch row b and inner
// channel i, with an f32 state h[N] that starts at h0 (zeros when absent):
//
//   h <- exp(dt_t * A[i]) * h + (dt_t * B_t) * u_t
//   y_t = sum_n h[n] * C_t[n] + D[i] * u_t
//
// It returns y (B, S, inner) in u's type, rounded once from the f32 sum, and
// h_final (B, inner, N) in f32.
//
// What bounds it: each input is read once and each output written once, so
// the bytes are those of u, dt, y (B*S*inner each) and the far smaller B_,
// C_, A, D, h0 and h_final: ~0.25 ms at the serving prefill shape (B 8,
// S 4096, inner 3200, N 16) at 3.35 TB/s. Close behind come the
// exponentials, one per (b, t, i, n), 1.68e9 there: at the SFU's 16 a clock
// per SM they take ~0.4 ms. Four f32 operations go with each (dt*A, B*dtu,
// the state's FMA, y's FMA), so issue and the SFU are both nearly full.
//
// Design: `ssm_scan_kernel` (S > STEP_MAX):
// * parallel over the states, not over time: a channel's N states are split
//   over N / SPL lanes of SPL states, and each thread holds its lane's
//   states of CPT = 2 neighbouring channels, which share its loads of B_
//   and C_; each walks its states' recurrence in order. That is 51,200
//   threads at the prefill shape, 12 warps an SM. A chunked scan over time
//   would add parallelism at the cost of the exponentials twice; the state
//   split already fills the SMs, and the exponentials are the floor;
// * y in a fixed order, no atomics, the same bits every call: summed over
//   a lane's states in order, then over the lanes by xor shuffles;
// * no step waits on device memory: tiles of TS timesteps of dt, u (a
//   block's CH channels) and B_, C_ (rows shared by every channel) go
//   through a ring of STAGES tiles in shared memory by 16-byte cp.async,
//   STAGES - 1 tiles ahead of the compute; one barrier a tile. A tile is
//   walked twice: the recurrence of all its steps with no branch between
//   them, so that later steps' loads issue early, then y's reductions. y
//   goes to a shared tile and leaves in 16-byte rows;
// * less work per element: dt*u once per (b, t, i); A pre-scaled by log2(e)
//   once per thread, so each decay is one multiply and one `ex2.approx`
//   (h within 3e-6 of the f32 reference at the prefill shape; `expf` took
//   1.6x as long);
// * no padding: a ragged S bounds the last tile; a ragged or misaligned
//   `inner` copies the affected chunks element by element, zero-filled.
//
// * for training, an optional output `h_chunks`: the state after each tile
//   but the last, which the backward (`ssm_scan_bwd_kernel`, below) starts
//   its recomputes from; null on the serving paths.
//
// `ssm_step_kernel` (S <= STEP_MAX, a decode step): the same split and
// order with one channel a thread and no staging, so that every load is in
// flight at once: at the decode shape (B 8, inner 3200, N 16) it moves
// ~3.7 MB, a round trip of device memory.
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int THREADS = 64;       // threads of a scan block
constexpr int SPL = 4;            // states a lane holds, of each of its channels
constexpr int CPT = 2;            // channels a scan thread holds
constexpr int TS = 16;            // timesteps of a staged tile
constexpr int STAGES = 4;         // tiles in the ring (STAGES - 1 in flight)
constexpr int STEP_THREADS = 128; // threads of a step block
constexpr int STEP_MAX = 4;       // up to this many timesteps go to the step kernel
constexpr float LOG2E = 1.4426950408889634f;
static_assert(SPL == 4, "a lane's states are stored as one float4");

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Sum x over the LANES consecutive threads of a group (a power of two up to
// 32), xor offsets LANES/2 down to 1; every lane of the group gets it.
template <int LANES>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off /= 2) x += __shfl_xor_sync(repro::FULL_MASK, x, off);
  return x;
}

// Stage `rows` rows of `cols` (<= W) elements from global memory (row
// stride `ld` elements) into shared rows of W elements: 16-byte cp.async
// for chunks that are whole and aligned, the rest element by element with
// zeros past `cols`.
template <typename E, int W>
__device__ __forceinline__ void stage_rows(E (*dst)[W], const E* __restrict__ src, long long ld,
                                           int rows, int cols, bool aligned) {
  constexpr int PER = 16 / int(sizeof(E));
  constexpr int CHUNKS = W / PER;
  for (int e = threadIdx.x; e < rows * CHUNKS; e += blockDim.x) {
    const int r = e / CHUNKS, c = (e % CHUNKS) * PER;
    const E* s = src + r * ld + c;
    if (aligned && c + PER <= cols) {
      repro::cp_async16(&dst[r][c], s);
    } else {
#pragma unroll
      for (int j = 0; j < PER; ++j)
        dst[r][c + j] = c + j < cols ? s[j] : repro::from_float<E>(0.f);
    }
  }
}

// Write `rows` shared rows (W elements, the first `cols` live) to global
// memory (row stride `ld`): 16-byte stores where whole and aligned.
template <typename E, int W>
__device__ __forceinline__ void store_rows(E* __restrict__ dst, E (*src)[W], long long ld,
                                           int rows, int cols, bool aligned) {
  constexpr int PER = 16 / int(sizeof(E));
  constexpr int CHUNKS = W / PER;
  for (int e = threadIdx.x; e < rows * CHUNKS; e += blockDim.x) {
    const int r = e / CHUNKS, c = (e % CHUNKS) * PER;
    E* d = dst + r * ld + c;
    if (aligned && c + PER <= cols) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<uint4*>(&src[r][c]);
    } else {
      for (int j = 0; j < PER && c + j < cols; ++j) d[j] = src[r][c + j];
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int N>
struct Stage {
  static constexpr int CH = THREADS / (N / SPL) * CPT;   // channels of a block
  float dt[TS][CH];
  T u[TS][CH];
  float B[TS][N];
  float C[TS][N];
};

// Thread (q, lane) holds states lane*SPL .. +SPL of channels c0 + 2q and
// c0 + 2q + 1. A tile is walked twice: first the recurrence of every step,
// keeping each step's partial sums of y in registers (no shuffle waits in
// the state's chain), then y's reduction over the LANES lanes for every
// step, by halves: the xor LANES/2 exchange leaves the lower half with
// channel 2q's sum and the upper half with 2q + 1's, then each half sums
// on (xor LANES/4 .. 1). Each channel's order is that of group_sum over its
// lanes' partial sums.
template <typename T, int N>
__global__ void __launch_bounds__(THREADS, 8) ssm_scan_kernel(
    const T* __restrict__ u, const float* __restrict__ dt, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ A, const float* __restrict__ D,
    const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ h_out,
    float* __restrict__ h_chunks, int S, int inner) {
  constexpr int LANES = N / SPL, HALF = LANES / 2, CH = Stage<T, N>::CH;
  static_assert(CPT == 2, "the lanes reduce a thread's two channels by halves");
  __shared__ __align__(16) Stage<T, N> ring[STAGES];
  __shared__ __align__(16) T ys[2][TS][CH];

  const int b = blockIdx.y, c0 = blockIdx.x * CH;
  const int q = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  // which of its two channels this lane's reduction ends with; one lane of
  // each half writes that channel's y
  const int mine = (lane & HALF) ? 1 : 0;
  const bool writer = (lane & (HALF - 1)) == 0;
  const int cols = min(CH, inner - c0);
  // 16-byte copies need every row of u, dt and y (and B_, C_) to start aligned
  const bool vec_u = inner % (16 / int(sizeof(T))) == 0 && aligned16(u) && aligned16(y);
  const bool vec_dt = inner % 4 == 0 && aligned16(dt);
  const bool vec_bc = aligned16(Bm) && aligned16(Cm);

  float h[CPT][SPL], a[CPT][SPL];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = c0 + CPT * q + k;
    const bool live = c < inner;
    const long long state = ((long long)b * inner + c) * N + lane * SPL;
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      h[k][j] = live && h0 != nullptr ? h0[state + j] : 0.f;
      a[k][j] = live ? A[(long long)c * N + lane * SPL + j] * LOG2E : 0.f;
    }
  }
  const int c_mine = c0 + CPT * q + mine;
  const float d = c_mine < inner ? D[c_mine] : 0.f;

  const long long row0 = (long long)b * S;   // (b, t = 0) row of u, dt, B_, C_, y
  const int tiles = (S + TS - 1) / TS;
  auto issue = [&](int k) {
    if (k < tiles) {
      Stage<T, N>& st = ring[k % STAGES];
      const int rows = min(TS, S - k * TS);
      const long long row = row0 + (long long)k * TS;
      stage_rows<float, CH>(st.dt, dt + row * inner + c0, inner, rows, cols, vec_dt);
      stage_rows<T, CH>(st.u, u + row * inner + c0, inner, rows, cols, vec_u);
      stage_rows<float, N>(st.B, Bm + row * N, N, rows, N, vec_bc);
      stage_rows<float, N>(st.C, Cm + row * N, N, rows, N, vec_bc);
    }
    repro::cp_async_commit();   // an empty group past the end keeps the count
  };
  auto flush_y = [&](int k) {
    store_rows<T, CH>(y + (row0 + (long long)k * TS) * inner + c0, ys[k % 2], inner,
                      min(TS, S - k * TS), cols, vec_u);
  };

#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) issue(k);
  for (int k = 0; k < tiles; ++k) {
    repro::cp_async_wait<STAGES - 2>();   // this thread's copies of tile k landed
    __syncthreads();   // everyone's have; tile k - 1 and ys[(k - 1) % 2] are done with
    issue(k + STAGES - 1);                // into tile k - 1's slot
    if (k > 0) flush_y(k - 1);
    const Stage<T, N>& st = ring[k % STAGES];
    T (*yt)[CH] = ys[k % 2];
    float p[TS][CPT], um[TS];   // each step's partial sums of y, and u of `mine`
    auto advance = [&](int t) {   // the recurrence of step t
      float dtt[CPT], ut[CPT], bb[SPL], cc[SPL];
      repro::load_f32<float, CPT>(&st.dt[t][CPT * q], dtt);
      repro::load_f32<T, CPT>(&st.u[t][CPT * q], ut);
      repro::load_f32<float, SPL>(&st.B[t][lane * SPL], bb);
      repro::load_f32<float, SPL>(&st.C[t][lane * SPL], cc);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float dtu = dtt[c] * ut[c];
        p[t][c] = 0.f;
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          h[c][j] = fmaf(exp2_approx(dtt[c] * a[c][j]), h[c][j], bb[j] * dtu);
          p[t][c] = fmaf(h[c][j], cc[j], p[t][c]);
        }
      }
      um[t] = mine ? ut[1] : ut[0];
    };
    auto reduce = [&](int t) {    // y of step t
      float sum = mine ? p[t][1] : p[t][0];
      sum += __shfl_xor_sync(repro::FULL_MASK, mine ? p[t][0] : p[t][1], HALF);
      sum = group_sum<HALF>(sum);
      if (writer) yt[t][CPT * q + mine] = repro::from_float<T>(sum + d * um[t]);
    };
    // a whole tile runs without a branch between steps, so the loads of
    // later steps are issued ahead; only the last tile of a ragged S checks
    const int steps = min(TS, S - k * TS);
    if (steps == TS) {
#pragma unroll
      for (int t = 0; t < TS; ++t) advance(t);
#pragma unroll
      for (int t = 0; t < TS; ++t) reduce(t);
      if (h_chunks != nullptr && k + 1 < tiles) {   // the state after this tile, for the backward
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = c0 + CPT * q + j;
          if (c < inner) {
            float* dst = h_chunks + (((long long)b * (tiles - 1) + k) * inner + c) * N + lane * SPL;
            *reinterpret_cast<float4*>(dst) = make_float4(h[j][0], h[j][1], h[j][2], h[j][3]);
          }
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < TS; ++t)
        if (t < steps) advance(t);
#pragma unroll
      for (int t = 0; t < TS; ++t)
        if (t < steps) reduce(t);
    }
  }
  __syncthreads();
  if (tiles > 0) flush_y(tiles - 1);

#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = c0 + CPT * q + k;
    const long long state = ((long long)b * inner + c) * N + lane * SPL;
    if (c < inner) {
#pragma unroll
      for (int j = 0; j < SPL; ++j) h_out[state + j] = h[k][j];
    }
  }
}

// Thread (channel, lane) holds states lane*SPL .. +SPL of one channel, as
// the scan kernel does (y in the same order); no staging: each of its loads
// is one request, all in flight together.
template <typename T, int N>
__global__ void __launch_bounds__(STEP_THREADS) ssm_step_kernel(
    const T* __restrict__ u, const float* __restrict__ dt, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ A, const float* __restrict__ D,
    const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ h_out,
    int S, int inner) {
  constexpr int LANES = N / SPL, CHS = STEP_THREADS / LANES;
  const int b = blockIdx.y, lane = threadIdx.x % LANES;
  const int c = blockIdx.x * CHS + threadIdx.x / LANES;
  // a dead channel's lanes compute on channel 0 (so the shuffles see every
  // lane of the warp) and store nothing
  const bool live = c < inner;
  const int cc = live ? c : 0;
  const long long state = ((long long)b * inner + cc) * N + lane * SPL;
  float h[SPL], a[SPL];
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    h[j] = h0 != nullptr ? h0[state + j] : 0.f;
    a[j] = A[(long long)cc * N + lane * SPL + j] * LOG2E;
  }
  const float d = D[cc];
  for (int t = 0; t < S; ++t) {
    const long long row = (long long)b * S + t;
    const float dtt = dt[row * inner + cc];
    const float ut = repro::to_float(u[row * inner + cc]);
    const float dtu = dtt * ut;
    float p = 0.f;
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      h[j] = fmaf(exp2_approx(dtt * a[j]), h[j], Bm[row * N + lane * SPL + j] * dtu);
      p = fmaf(h[j], Cm[row * N + lane * SPL + j], p);
    }
    p = group_sum<LANES>(p);
    if (live && lane == 0) y[row * inner + cc] = repro::from_float<T>(p + d * ut);
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < SPL; ++j) h_out[state + j] = h[j];
  }
}

// ---------------------------------------------------------------------------
// The scan's gradient (no Pallas counterpart: the reference differentiates a
// jnp scan, src/repro/models/ssm.py:124-160, under jax.checkpoint per chunk).
//
// With da_t = exp(dt_t A) and g_t the gradient of the loss by h_t (b, i, n),
// run in reverse, the term da_{S+1} g_{S+1} past the last step read as dh
// (the final state's gradient, zeros when absent):
//
//   g_t   = C_t dy_t + da_{t+1} g_{t+1}
//   du_t  = D dy_t + sum_n g_t dt_t B_t           ddt_t = sum_n g_t (A da_t h_{t-1} + B_t u_t)
//   dB_t  = sum_i g_t dt_t u_t                    dC_t  = sum_i h_t dy_t
//   dA    = sum_{b,t} g_t dt_t da_t h_{t-1}        dD    = sum_{b,t} dy_t u_t
//   dh0   = da_1 g_1 (the g carried past the first step)
//
// The recurrence is never run backwards by dividing by da (it underflows).
// The forward kernel keeps the state after every TS-step tile but the last
// (`h_chunks`, (B, tiles - 1, inner, N) f32); the backward walks tiles last
// to first, recomputes a tile's TS states from its start state into
// registers (TS x SPL floats a thread, indices static in unrolled loops),
// then runs the adjoint over them. Each thread owns BSPL states of one
// channel, so du and ddt (sums over n) reduce over a channel's N / BSPL
// lanes by xor shuffles in a fixed order, written by one lane. dB_ and dC_
// (sums over the inner channels) reduce over a half warp's channels by xor
// shuffles, then over the block's half warps in order, into per-block
// partials; dA and dD (sums over batch rows and time) are summed over time
// in registers into per-(row, segment) partials. A last kernel sums the
// partials in order: no float atomics, the same bits every call.
//
// Time is split into segments of `seg` steps (whole tiles), so that many
// blocks walk a row at once. The adjoint is linear in the carried gradient:
// over a segment [t_a, t_b) the carry out (da_{t_a} g_{t_a}) is
// g_loc + P c, c being the carry in (da_{t_b} g_{t_b}, or dh past the last
// step), g_loc the segment run from c = 0, and P the product of its da_t
// per (b, i, n). g_loc needs only dt, A, C_ and dy: no state. Three steps,
// in a fixed order:
// 1. `ssm_scan_bwd_carry_kernel`, one block per (channel block, segment but
//    the first, batch row): g_loc and P of its segment into `carry`
//    ((2, B, segments - 1, inner, N) f32; one exponential and a few FMAs per
//    (t, i, n), no shuffle);
// 2. each block of the main pass folds the later segments' (g_loc, P) into
//    its carry, last segment first, from dh (or zeros);
// 3. `ssm_scan_bwd_kernel`, one block per (channel block, segment, batch
//    row): the tile walk above over its segment, from that carry and the
//    kept state at its first tile; segment 0 writes dh0.
//
// What bounds it: at hymba's training microbatch (B 1, S 4096, inner 3200,
// N 16, u bf16) it reads u, dt, dy and writes du, ddt (14 B an element,
// 13.1 M elements), reads the boundaries and writes and reads the partials;
// and takes three exponentials per (b, t, i, n), one in the carry pass (but
// for the first segment), one in the recompute and one in the adjoint. One
// block walking a row's 4096 steps in order (100 blocks there) is bound by
// each step's latency: 1.2 ms on the H100. Segments of 384 steps give 1100
// blocks of the main pass, 8 an SM's worth; then the main pass is bound by
// issue (shuffles, shared-memory loads, exponentials and FMAs a step: 0.53
// ms of the 0.64, tools/scan_variants.py --backward). Within a segment tiles
// are staged by cp.async one ahead, and whole tiles run with no branch
// between steps so that the steps' independent loads and shuffles overlap.
// ---------------------------------------------------------------------------

constexpr int BWD_THREADS = 256;   // threads of a backward block
constexpr int BSPL = 2;            // states a backward lane holds
constexpr int SUM_THREADS = 256;   // threads of a partials-summing block

template <typename T, int N>
struct BwdStage {
  static constexpr int CH = BWD_THREADS / (N / BSPL);   // channels of a block
  float dt[TS][CH];
  T u[TS][CH];
  T dy[TS][CH];
  float B[TS][N];
  float C[TS][N];
};

template <typename T, int N>
struct BwdShared {
  static constexpr int WARPS = BWD_THREADS / 32;
  BwdStage<T, N> ring[2];       // tile k computed while tile k - 1 lands
  float red[2][2 * WARPS][TS][N];   // each half warp's channel sums of dB_ (0) and dC_ (1)
};

template <typename T, int N>
struct CarryStage {
  static constexpr int CH = BwdStage<T, N>::CH;
  float dt[TS][CH];
  T dy[TS][CH];
  float C[TS][N];
};

// Thread (col, lane) holds states lane*BSPL .. +BSPL of channel c0 + col, as
// in the main pass. Segment blockIdx.y + 1's tiles go last to first from
// g = 0 and P = 1, staged by cp.async one ahead; its (g_loc, P) land in
// carry[0] and carry[1] at (b, segment - 1, channel, state).
template <typename T, int N>
__global__ void __launch_bounds__(BWD_THREADS) ssm_scan_bwd_carry_kernel(
    const float* __restrict__ dt, const float* __restrict__ Cm, const float* __restrict__ A,
    const T* __restrict__ dy, float* __restrict__ carry, int S, int inner, int seg_tiles) {
  constexpr int LANES = N / BSPL, CH = CarryStage<T, N>::CH;
  __shared__ __align__(16) CarryStage<T, N> ring[2];

  const int seg = blockIdx.y + 1, b = blockIdx.z, c0 = blockIdx.x * CH;
  const int col = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int c = c0 + col;
  const bool live = c < inner;
  const int tiles = (S + TS - 1) / TS, ka = seg * seg_tiles, kb = min(tiles, ka + seg_tiles);
  const int cols = min(CH, inner - c0);
  const bool vec_dy = inner % (16 / int(sizeof(T))) == 0 && aligned16(dy);
  const bool vec_dt = inner % 4 == 0 && aligned16(dt);
  const bool vec_c = aligned16(Cm);

  float a[BSPL], g[BSPL], P[BSPL];
#pragma unroll
  for (int j = 0; j < BSPL; ++j) {
    a[j] = live ? A[(long long)c * N + lane * BSPL + j] * LOG2E : 0.f;
    g[j] = 0.f;
    P[j] = 1.f;
  }
  auto issue = [&](int k) {
    if (k >= ka) {
      CarryStage<T, N>& st = ring[k % 2];
      const int rows = min(TS, S - k * TS);
      const long long row = (long long)b * S + (long long)k * TS;
      stage_rows<float, CH>(st.dt, dt + row * inner + c0, inner, rows, cols, vec_dt);
      stage_rows<T, CH>(st.dy, dy + row * inner + c0, inner, rows, cols, vec_dy);
      stage_rows<float, N>(st.C, Cm + row * N, N, rows, N, vec_c);
    }
    repro::cp_async_commit();
  };

  issue(kb - 1);
  for (int k = kb - 1; k >= ka; --k) {
    repro::cp_async_wait<0>();   // this thread's copies of tile k landed
    __syncthreads();             // everyone's have; tile k + 1's slot is free
    issue(k - 1);
    const CarryStage<T, N>& st = ring[k % 2];
    auto step = [&](int t) {     // the adjoint's carry through step t
      const float dtt = st.dt[t][col], dyt = repro::to_float(st.dy[t][col]);
#pragma unroll
      for (int j = 0; j < BSPL; ++j) {
        const float da = exp2_approx(dtt * a[j]);
        g[j] = fmaf(st.C[t][lane * BSPL + j], dyt, g[j]) * da;
        P[j] *= da;
      }
    };
    const int steps = min(TS, S - k * TS);
    if (steps == TS) {
#pragma unroll
      for (int t = TS - 1; t >= 0; --t) step(t);
    } else {
#pragma unroll
      for (int t = TS - 1; t >= 0; --t)
        if (t < steps) step(t);
    }
  }
  if (live) {
    const int NS1 = gridDim.y;
    const long long at = (((long long)b * NS1 + seg - 1) * inner + c) * N + lane * BSPL;
    const long long half = (long long)gridDim.z * NS1 * inner * N;
#pragma unroll
    for (int j = 0; j < BSPL; ++j) {
      carry[at + j] = g[j];
      carry[half + at + j] = P[j];
    }
  }
}

// Thread (col, lane) holds states lane*BSPL .. +BSPL of channel c0 + col.
// Segment blockIdx.y's tiles go last to first, from the carry folded out of
// the later segments' (g_loc, P); each is staged by cp.async while the tile
// after it (in time) is computed, with the start state it needs loaded into
// registers at the same time. A whole tile runs with no branch between its
// steps (only a ragged last tile checks), so that later steps' loads and
// reductions issue early.
// Registers capped for 3 blocks an SM (80, no spill; ptxas took 128 and 2
// blocks uncapped): 0.5491 ms of main pass against 0.5824 at the training
// shape (tools/scan_variants.py --backward, H100).
template <typename T, int N>
__global__ void __launch_bounds__(BWD_THREADS, 3) ssm_scan_bwd_kernel(
    const T* __restrict__ u, const float* __restrict__ dt, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ A, const float* __restrict__ D,
    const float* __restrict__ h0, const float* __restrict__ h_chunks, const T* __restrict__ dy,
    const float* __restrict__ dh, const float* __restrict__ carry, T* __restrict__ du,
    float* __restrict__ ddt, float* __restrict__ part_bc, float* __restrict__ part_ad,
    float* __restrict__ dh0, int S, int inner, int seg_tiles) {
  constexpr int LANES = N / BSPL, CH = BwdStage<T, N>::CH, WARPS = BwdShared<T, N>::WARPS;
  __shared__ __align__(16) BwdShared<T, N> sm;

  const int seg = blockIdx.y, NS = gridDim.y, b = blockIdx.z, Bb = gridDim.z;
  const int c0 = blockIdx.x * CH;
  const int col = threadIdx.x / LANES, lane = threadIdx.x % LANES, warp = threadIdx.x / 32;
  const int c = c0 + col;
  const bool live = c < inner;
  // a dead channel's threads run on zeros (its inputs are staged as zeros,
  // so its g, states and partials stay 0) and take part in every shuffle
  const long long state = ((long long)b * inner + (live ? c : 0)) * N + lane * BSPL;
  const int tiles = (S + TS - 1) / TS;
  const int ka = seg * seg_tiles, kb = min(tiles, ka + seg_tiles);   // the segment's tiles
  const int cols = min(CH, inner - c0);
  const bool vec_u = inner % (16 / int(sizeof(T))) == 0 && aligned16(u) && aligned16(dy);
  const bool vec_dt = inner % 4 == 0 && aligned16(dt);
  const bool vec_bc = aligned16(Bm) && aligned16(Cm);

  float an[BSPL], a[BSPL], g[BSPL], gA[BSPL];
#pragma unroll
  for (int j = 0; j < BSPL; ++j) {
    an[j] = live ? A[(long long)c * N + lane * BSPL + j] : 0.f;
    a[j] = an[j] * LOG2E;
    g[j] = live && dh != nullptr ? dh[state + j] : 0.f;
    gA[j] = 0.f;
  }
  // the carry into this segment: the later segments' (g_loc, P) folded in,
  // the last first
  if (live) {
    const long long half = (long long)Bb * (NS - 1) * inner * N;
    for (int s2 = NS - 1; s2 > seg; --s2) {
      const long long at = (((long long)b * (NS - 1) + s2 - 1) * inner + c) * N + lane * BSPL;
#pragma unroll
      for (int j = 0; j < BSPL; ++j) g[j] = fmaf(carry[half + at + j], g[j], carry[at + j]);
    }
  }
  const float d = live ? D[c] : 0.f;
  float gD = 0.f;

  // tile k's inputs into ring slot k % 2 (cp.async, one group a tile), and
  // the state before its first step into `start` (registers)
  auto issue = [&](int k, float* start) {
    if (k >= ka) {
      BwdStage<T, N>& st = sm.ring[k % 2];
      const int rows = min(TS, S - k * TS);
      const long long row = (long long)b * S + (long long)k * TS;
      stage_rows<float, CH>(st.dt, dt + row * inner + c0, inner, rows, cols, vec_dt);
      stage_rows<T, CH>(st.u, u + row * inner + c0, inner, rows, cols, vec_u);
      stage_rows<T, CH>(st.dy, dy + row * inner + c0, inner, rows, cols, vec_u);
      stage_rows<float, N>(st.B, Bm + row * N, N, rows, N, vec_bc);
      stage_rows<float, N>(st.C, Cm + row * N, N, rows, N, vec_bc);
      const float* src = k == 0 ? h0
          : h_chunks + ((long long)b * (tiles - 1) + k - 1) * inner * N;
      const long long at = k == 0 ? state : (long long)(live ? c : 0) * N + lane * BSPL;
#pragma unroll
      for (int j = 0; j < BSPL; ++j) start[j] = live && src != nullptr ? src[at + j] : 0.f;
    }
    repro::cp_async_commit();
  };

  float h_next[BSPL];
  issue(kb - 1, h_next);
  for (int k = kb - 1; k >= ka; --k) {
    const int t0 = k * TS, steps = min(TS, S - t0);
    const long long row0 = (long long)b * S + t0;
    float h_in[BSPL];
#pragma unroll
    for (int j = 0; j < BSPL; ++j) h_in[j] = h_next[j];
    repro::cp_async_wait<0>();   // this thread's copies of tile k landed
    __syncthreads();             // everyone's have; tile k + 1's slot and red are free
    issue(k - 1, h_next);
    const BwdStage<T, N>& st = sm.ring[k % 2];

    float hs[TS][BSPL];   // the tile's states, recomputed as the forward computes them
    auto recompute = [&](int t) {
      const float dtt = st.dt[t][col], dtu = dtt * repro::to_float(st.u[t][col]);
#pragma unroll
      for (int j = 0; j < BSPL; ++j) {
        const float prev = t > 0 ? hs[t > 0 ? t - 1 : 0][j] : h_in[j];
        hs[t][j] = fmaf(exp2_approx(dtt * a[j]), prev, st.B[t][lane * BSPL + j] * dtu);
      }
    };
    auto adjoint = [&](int t) {   // step t of the adjoint
      const float dtt = st.dt[t][col], ut = repro::to_float(st.u[t][col]);
      const float dyt = repro::to_float(st.dy[t][col]);
      float s_du = 0.f, s_ddt = 0.f, pb[BSPL], pc[BSPL];
#pragma unroll
      for (int j = 0; j < BSPL; ++j) {
        const float bb = st.B[t][lane * BSPL + j], cc = st.C[t][lane * BSPL + j];
        const float prev = t > 0 ? hs[t > 0 ? t - 1 : 0][j] : h_in[j];
        const float da = exp2_approx(dtt * a[j]);
        g[j] = fmaf(cc, dyt, g[j]);
        pc[j] = hs[t][j] * dyt;
        pb[j] = g[j] * (dtt * ut);
        s_du = fmaf(g[j], dtt * bb, s_du);
        s_ddt = fmaf(g[j], fmaf(an[j] * da, prev, bb * ut), s_ddt);
        gA[j] = fmaf(g[j] * dtt, da * prev, gA[j]);
        g[j] *= da;
      }
      s_du = group_sum<LANES>(s_du);
      s_ddt = group_sum<LANES>(s_ddt);
      gD = fmaf(dyt, ut, gD);
      if (live && lane == 0) {
        const long long idx = (row0 + t) * inner + c;
        du[idx] = repro::from_float<T>(fmaf(d, dyt, s_du));
        ddt[idx] = s_ddt;
      }
      // over the half warp's channels (the lanes of one state index differ
      // in the bits at and above LANES); the two halves' sums meet in
      // shared memory after the tile, with every warp's (2.7% faster than
      // shuffles over the whole warp at the training shape on the H100:
      // tools/scan_variants.py --backward, `bc-shuffle`)
#pragma unroll
      for (int off = LANES; off < 16; off *= 2) {
#pragma unroll
        for (int j = 0; j < BSPL; ++j) {
          pb[j] += __shfl_xor_sync(repro::FULL_MASK, pb[j], off);
          pc[j] += __shfl_xor_sync(repro::FULL_MASK, pc[j], off);
        }
      }
      if (threadIdx.x % 16 < LANES) {
#pragma unroll
        for (int j = 0; j < BSPL; ++j) {
          sm.red[0][2 * warp + threadIdx.x % 32 / 16][t][lane * BSPL + j] = pb[j];
          sm.red[1][2 * warp + threadIdx.x % 32 / 16][t][lane * BSPL + j] = pc[j];
        }
      }
    };
    if (steps == TS) {
#pragma unroll
      for (int t = 0; t < TS; ++t) recompute(t);
#pragma unroll
      for (int t = TS - 1; t >= 0; --t) adjoint(t);
    } else {
#pragma unroll
      for (int t = 0; t < TS; ++t)
        if (t < steps) recompute(t);
#pragma unroll
      for (int t = TS - 1; t >= 0; --t)
        if (t < steps) adjoint(t);
    }
    __syncthreads();
    // this block's partial sums of dB_ and dC_ over its channels, half warps in order
    for (int e = threadIdx.x; e < 2 * TS * N; e += BWD_THREADS) {
      const int which = e / (TS * N), r = (e / N) % TS, n = e % N;
      if (r < steps) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 2 * WARPS; ++w) s += sm.red[which][w][r][n];
        part_bc[((((long long)blockIdx.x * 2 + which) * Bb + b) * S + t0 + r) * N + n] = s;
      }
    }
  }

  if (live) {
    const long long row = ((long long)b * NS + seg) * (inner * N + inner);
#pragma unroll
    for (int j = 0; j < BSPL; ++j) {
      if (dh0 != nullptr && seg == 0) dh0[state + j] = g[j];
      part_ad[row + (long long)c * N + lane * BSPL + j] = gA[j];
    }
    if (lane == 0) part_ad[row + (long long)inner * N + c] = gD;
  }
}

// out[e] = sum over p of parts[p * n + e], p in order.
__global__ void __launch_bounds__(SUM_THREADS) ssm_sum_parts_kernel(
    const float* __restrict__ parts, float* __restrict__ out, int n_parts, long long n) {
  for (long long e = (long long)blockIdx.x * SUM_THREADS + threadIdx.x; e < n;
       e += (long long)gridDim.x * SUM_THREADS) {
    float s = 0.f;
    for (int p = 0; p < n_parts; ++p) s += parts[(long long)p * n + e];
    out[e] = s;
  }
}

void sum_parts(const float* parts, float* out, int n_parts, long long n, cudaStream_t stream) {
  if (n <= 0) return;
  const long long blocks = std::min<long long>((n + SUM_THREADS - 1) / SUM_THREADS, 132 * 8);
  ssm_sum_parts_kernel<<<(int)blocks, SUM_THREADS, 0, stream>>>(parts, out, n_parts, n);
}

template <typename T, int N>
cudaError_t launch(const void* u, const float* dt, const float* Bm, const float* Cm,
                   const float* A, const float* D, const float* h0, void* y, float* h_out,
                   float* h_chunks, int Bb, int S, int inner, cudaStream_t stream) {
  const T* tu = static_cast<const T*>(u);
  T* ty = static_cast<T*>(y);
  if (S <= STEP_MAX) {   // one tile: no boundary to keep
    constexpr int CHS = STEP_THREADS / (N / SPL);
    ssm_step_kernel<T, N><<<dim3((inner + CHS - 1) / CHS, Bb), STEP_THREADS, 0, stream>>>(
        tu, dt, Bm, Cm, A, D, h0, ty, h_out, S, inner);
  } else {
    constexpr int CH = Stage<T, N>::CH;
    ssm_scan_kernel<T, N><<<dim3((inner + CH - 1) / CH, Bb), THREADS, 0, stream>>>(
        tu, dt, Bm, Cm, A, D, h0, ty, h_out, h_chunks, S, inner);
  }
  return cudaGetLastError();
}

// Segments of `seg` steps over S (at least one, also for S = 0).
int segments(int S, int seg) { return std::max(1, (S + seg - 1) / seg); }

template <typename T, int N>
cudaError_t launch_bwd(const void* u, const float* dt, const float* Bm, const float* Cm,
                       const float* A, const float* D, const float* h0, const float* h_chunks,
                       const void* dy, const float* dh, float* carry, void* du, float* ddt,
                       float* dBC, float* dAD, float* dh0, float* part_bc, float* part_ad,
                       int Bb, int S, int inner, int seg, cudaStream_t stream) {
  constexpr int CH = BwdStage<T, N>::CH;
  const int blocks = (inner + CH - 1) / CH;
  const int seg_tiles = seg / TS, NS = segments(S, seg);
  if (NS > 1) {
    ssm_scan_bwd_carry_kernel<T, N><<<dim3(blocks, NS - 1, Bb), BWD_THREADS, 0, stream>>>(
        dt, Cm, A, static_cast<const T*>(dy), carry, S, inner, seg_tiles);
  }
  ssm_scan_bwd_kernel<T, N><<<dim3(blocks, NS, Bb), BWD_THREADS, 0, stream>>>(
      static_cast<const T*>(u), dt, Bm, Cm, A, D, h0, h_chunks, static_cast<const T*>(dy), dh,
      carry, static_cast<T*>(du), ddt, part_bc, part_ad, dh0, S, inner, seg_tiles);
  sum_parts(part_bc, dBC, blocks, 2LL * Bb * S * N, stream);
  sum_parts(part_ad, dAD, Bb * NS, (long long)inner * N + inner, stream);
  return cudaGetLastError();
}

}  // namespace

// u, y: (B, S, inner) in `dtype`; dt: (B, S, inner) f32; B_, C_: (B, S, N)
// f32; A: (inner, N) f32; D: (inner,) f32; h0 (nullable), h_out: (B, inner, N)
// f32; h_chunks (nullable): (B, ceil(S / 16) - 1, inner, N) f32, the state
// after each 16-step tile but the last (written by the S > 4 kernel only;
// for S <= 4 there is none). All contiguous.
extern "C" int repro_ssm_scan(
    const void* u, const void* dt, const void* B_, const void* C_, const void* A,
    const void* D, const void* h0, void* y, void* h_out, void* h_chunks,
    int dtype, int Bb, int S, int inner, int N, void* stream) {
  if (Bb == 0 || inner == 0) return cudaSuccess;
  if (Bb < 0 || Bb > 65535 || S < 0 || inner < 0) return cudaErrorInvalidValue;
  const float* f_dt = static_cast<const float*>(dt);
  const float* f_B = static_cast<const float*>(B_);
  const float* f_C = static_cast<const float*>(C_);
  const float* f_A = static_cast<const float*>(A);
  const float* f_D = static_cast<const float*>(D);
  const float* f_h0 = static_cast<const float*>(h0);
  float* f_hout = static_cast<float*>(h_out);
  float* f_chunks = static_cast<float*>(h_chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SCAN(T, NN) \
  launch<T, NN>(u, f_dt, f_B, f_C, f_A, f_D, f_h0, y, f_hout, f_chunks, Bb, S, inner, s)
  if (dtype == repro::kFloat32 && N == 8) return REPRO_SCAN(float, 8);
  if (dtype == repro::kFloat32 && N == 16) return REPRO_SCAN(float, 16);
  if (dtype == repro::kBFloat16 && N == 8) return REPRO_SCAN(__nv_bfloat16, 8);
  if (dtype == repro::kBFloat16 && N == 16) return REPRO_SCAN(__nv_bfloat16, 16);
#undef REPRO_SCAN
  return cudaErrorInvalidValue;
}

// The gradient of repro_ssm_scan. Inputs as there, plus h_chunks (from the
// forward; unread when S <= 16), dy (B, S, inner) in `dtype` and dh
// (nullable: zeros) (B, inner, N) f32. Outputs: du (B, S, inner) in `dtype`,
// ddt (B, S, inner) f32, dBC (2, B, S, N) f32 (dB_ then dC_), dAD
// (inner * N + inner) f32 (dA then dD), dh0 (nullable: not written)
// (B, inner, N) f32. `seg`: timesteps of a segment, a multiple of 16;
// NS = max(1, ceil(S / seg)) segments. Scratch: carry (2, B, NS - 1, inner,
// N) f32 (nullable when NS is 1), part_bc (ceil(inner / CH), 2, B, S, N) and
// part_ad (B, NS, inner * N + inner) f32, CH = 32 at N 16 and 64 at N 8.
extern "C" int repro_ssm_scan_bwd(
    const void* u, const void* dt, const void* B_, const void* C_, const void* A,
    const void* D, const void* h0, const void* h_chunks, const void* dy, const void* dh,
    void* du, void* ddt, void* dBC, void* dAD, void* dh0, void* carry, void* part_bc,
    void* part_ad, int dtype, int Bb, int S, int inner, int N, int seg, void* stream) {
  if (Bb == 0 || inner == 0) return cudaSuccess;
  if (Bb < 0 || Bb > 65535 || S < 0 || inner < 0 || seg <= 0 || seg % TS != 0 ||
      segments(S, seg) > 65535 || (segments(S, seg) > 1 && carry == nullptr))
    return cudaErrorInvalidValue;
  const float* f_dt = static_cast<const float*>(dt);
  const float* f_B = static_cast<const float*>(B_);
  const float* f_C = static_cast<const float*>(C_);
  const float* f_A = static_cast<const float*>(A);
  const float* f_D = static_cast<const float*>(D);
  const float* f_h0 = static_cast<const float*>(h0);
  const float* f_chunks = static_cast<const float*>(h_chunks);
  const float* f_dh = static_cast<const float*>(dh);
  float* f_ddt = static_cast<float*>(ddt);
  float* f_dBC = static_cast<float*>(dBC);
  float* f_dAD = static_cast<float*>(dAD);
  float* f_dh0 = static_cast<float*>(dh0);
  float* f_carry = static_cast<float*>(carry);
  float* f_pbc = static_cast<float*>(part_bc);
  float* f_pad = static_cast<float*>(part_ad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SCAN_BWD(T, NN)                                                               \
  launch_bwd<T, NN>(u, f_dt, f_B, f_C, f_A, f_D, f_h0, f_chunks, dy, f_dh, f_carry, du, f_ddt, \
                    f_dBC, f_dAD, f_dh0, f_pbc, f_pad, Bb, S, inner, seg, s)
  if (dtype == repro::kFloat32 && N == 8) return REPRO_SCAN_BWD(float, 8);
  if (dtype == repro::kFloat32 && N == 16) return REPRO_SCAN_BWD(float, 16);
  if (dtype == repro::kBFloat16 && N == 8) return REPRO_SCAN_BWD(__nv_bfloat16, 8);
  if (dtype == repro::kBFloat16 && N == 16) return REPRO_SCAN_BWD(__nv_bfloat16, 16);
#undef REPRO_SCAN_BWD
  return cudaErrorInvalidValue;
}
