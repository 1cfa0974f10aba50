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
// `ssm_step_kernel` (S <= STEP_MAX, a decode step): the same split and
// order with one channel a thread and no staging, so that every load is in
// flight at once: at the decode shape (B 8, inner 3200, N 16) it moves
// ~3.7 MB, a round trip of device memory.
#include <stdint.h>

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
    int S, int inner) {
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

template <typename T, int N>
cudaError_t launch(const void* u, const float* dt, const float* Bm, const float* Cm,
                   const float* A, const float* D, const float* h0, void* y, float* h_out,
                   int Bb, int S, int inner, cudaStream_t stream) {
  const T* tu = static_cast<const T*>(u);
  T* ty = static_cast<T*>(y);
  if (S <= STEP_MAX) {
    constexpr int CHS = STEP_THREADS / (N / SPL);
    ssm_step_kernel<T, N><<<dim3((inner + CHS - 1) / CHS, Bb), STEP_THREADS, 0, stream>>>(
        tu, dt, Bm, Cm, A, D, h0, ty, h_out, S, inner);
  } else {
    constexpr int CH = Stage<T, N>::CH;
    ssm_scan_kernel<T, N><<<dim3((inner + CH - 1) / CH, Bb), THREADS, 0, stream>>>(
        tu, dt, Bm, Cm, A, D, h0, ty, h_out, S, inner);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(const void* u, const float* dt, const float* Bm, const float* Cm,
                       const float* A, const float* D, const float* h0, void* y,
                       float* h_out, int Bb, int S, int inner, int N, cudaStream_t stream) {
  switch (N) {
    case 8: return launch<T, 8>(u, dt, Bm, Cm, A, D, h0, y, h_out, Bb, S, inner, stream);
    case 16: return launch<T, 16>(u, dt, Bm, Cm, A, D, h0, y, h_out, Bb, S, inner, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// u, y: (B, S, inner) in `dtype`; dt: (B, S, inner) f32; B_, C_: (B, S, N)
// f32; A: (inner, N) f32; D: (inner,) f32; h0 (nullable), h_out: (B, inner, N)
// f32. All contiguous.
extern "C" int repro_ssm_scan(
    const void* u, const void* dt, const void* B_, const void* C_, const void* A,
    const void* D, const void* h0, void* y, void* h_out,
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return dispatch_n<float>(u, f_dt, f_B, f_C, f_A, f_D, f_h0, y, f_hout, Bb, S, inner, N, s);
    case repro::kBFloat16:
      return dispatch_n<__nv_bfloat16>(u, f_dt, f_B, f_C, f_A, f_D, f_h0, y, f_hout, Bb, S,
                                       inner, N, s);
    default: return cudaErrorInvalidValue;
  }
}
