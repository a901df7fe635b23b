// Shared helpers for the port's Hopper kernels: dtype codes (kept in
// step with ops/kernels.py DTYPE_CODES), conversions to and from f32,
// and warp reductions. Every kernel accumulates in f32 and stores in the
// caller's dtype; the bf16 tensor-core kernels (wgmma.cuh) multiply bf16
// operands, the others compute in f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace port {

enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

// The TPU kernels mask with a large finite negative, not -inf, so that
// exp(NEG_INF - NEG_INF) stays finite on rows with no live key.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// Round an f32 value through dtype T and back (the ``.astype(q.dtype)``
// the reference applies after dequantizing an int8 page).
template <typename T> __device__ __forceinline__ float round_through(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace port
