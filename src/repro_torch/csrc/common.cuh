// Helpers shared by the port's hand-written Hopper kernels (sm_90a).
//
// Element types are float (dtype code 0) and __nv_bfloat16 (dtype code 1);
// every kernel does its arithmetic in f32 and converts on load and store.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr float NEG_INF = -1e30f;   // the reference kernels' masking value
constexpr unsigned FULL_MASK = 0xffffffffu;

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch and XLA do
}

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned; };
template <> struct Raw<2> { using type = unsigned short; };

// Load N contiguous elements starting at p (aligned to min(16, N*sizeof(T))
// bytes) as f32, in loads of up to 16 bytes each.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float* out) {
  constexpr int BYTES = N * int(sizeof(T));
  constexpr int CHUNK = BYTES >= 16 ? 16 : BYTES;
  using R = typename Raw<CHUNK>::type;
  constexpr int PER = CHUNK / int(sizeof(T));
#pragma unroll
  for (int c = 0; c < N / PER; ++c) {
    R raw = reinterpret_cast<const R*>(p)[c];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < PER; ++i) out[c * PER + i] = to_float(e[i]);
  }
}

// 16-byte asynchronous copies from global into shared memory (cp.async, L2
// only): started, grouped by commit, waited for with all but N groups landed.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(smem))), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// The same copy of 16 bytes, or 16 zero bytes when `valid` is false (src
// unread); and of 4 bytes (cp.async.ca: 4- and 8-byte copies go through L1).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(smem))), "l"(gmem),
                  "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(smem))), "l"(gmem),
                  "r"(valid ? 4 : 0)
               : "memory");
}

}  // namespace repro
