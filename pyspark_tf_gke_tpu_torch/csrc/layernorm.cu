// K3: fused LayerNorm forward, y = LN(x) or y = LN(x + r).
//
// Replaces pyspark_tf_gke_tpu/ops/pallas/layernorm.py::_ln_kernel (:37)
// and ::_ln_add_kernel (:48), launched from _ln_forward (:79).
//
// Bound on the H100: memory. Each row is read once (twice with the
// residual) and written once; the arithmetic is ~10 f32 operations per
// element, far below the ~20 operations per byte at which the card's
// f32 rate would take over. Design: one warp per row. Each lane keeps
// its D/32 elements in registers (D <= 1024), so x (and r) are read
// from device memory exactly once; mean and variance are two warp
// shuffle reductions in f32 (the centred two-pass form the TPU kernel
// uses), and y is written in x's dtype. Four warps (four rows) per
// block; no shared memory, no block-wide barrier.

#include "common.cuh"

using namespace port;

namespace {

constexpr int kWarps = 4;
constexpr int kMaxPerLane = 32;  // D <= 32 * 32 = 1024

template <typename T, bool kResidual>
__global__ void __launch_bounds__(kWarps * 32)
ln_kernel(const T* __restrict__ x, const T* __restrict__ r,
          const float* __restrict__ scale, const float* __restrict__ bias,
          T* __restrict__ y, int rows, int d, float eps) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= rows) return;  // whole warp leaves together
  const T* xr = x + row * d;
  const T* rr = kResidual ? r + row * d : nullptr;
  float v[kMaxPerLane];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k) {
    const int i = lane + 32 * k;
    float a = 0.f;
    if (i < d) {
      a = to_f32(xr[i]);
      if (kResidual) a += to_f32(rr[i]);
    }
    v[k] = a;
    sum += a;
  }
  const float mean = warp_sum(sum) / static_cast<float>(d);
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k) {
    const int i = lane + 32 * k;
    if (i < d) {
      const float c = v[k] - mean;
      v[k] = c;
      sq += c * c;
    }
  }
  const float inv = rsqrtf(warp_sum(sq) / static_cast<float>(d) + eps);
  T* yr = y + row * d;
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k) {
    const int i = lane + 32 * k;
    if (i < d) yr[i] = from_f32<T>(v[k] * inv * scale[i] + bias[i]);
  }
}

template <typename T>
void launch(const void* x, const void* r, const void* scale, const void* bias,
            void* y, int rows, int d, float eps, cudaStream_t stream) {
  const dim3 grid((rows + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  if (r != nullptr) {
    ln_kernel<T, true><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(r),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<T*>(y), rows, d, eps);
  } else {
    ln_kernel<T, false><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), nullptr,
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<T*>(y), rows, d, eps);
  }
}

}  // namespace

extern "C" int port_layernorm(const void* x, const void* r, const void* scale,
                              const void* bias, void* y, int rows, int d,
                              float eps, int dtype, int device, void* stream) {
  // this library links its own CUDA runtime: select the caller's
  // device in it before launching on the caller's stream
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  if (rows <= 0) return 0;
  if (d <= 0 || d > 32 * kMaxPerLane) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: launch<float>(x, r, scale, bias, y, rows, d, eps, s); break;
    case kBF16: launch<__nv_bfloat16>(x, r, scale, bias, y, rows, d, eps, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
