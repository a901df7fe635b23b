// K3b: LayerNorm backward, the closed-form gradient of y = LN(x) and of
// y = LN(x + r): dx (which is also d-residual), dscale and dbias.
//
// Replaces pyspark_tf_gke_tpu/ops/pallas/layernorm.py::_ln_bwd (:98) and
// ::_ln_res_bwd (:128), the custom_vjp backwards of the K3 forward. They
// are plain JAX there (XLA fuses them); here they are one kernel.
//
// Per row, with f32 statistics recomputed from x (for the residual form,
// from x + r rounded to x's dtype, the point at which the TPU version
// rounds it):
//   xhat = (x - mean) * inv,  inv = rsqrt(var + eps),  gs = g * scale
//   dx   = inv / D * (D * gs - sum(gs) - xhat * sum(gs * xhat))
//   dscale = sum over rows of g * xhat,  dbias = sum over rows of g.
//
// Bound on the H100: memory. x (and r), g are read once and dx written
// once; ~20 f32 operations per element. The variant comes from
// ops/layernorm.py ln_plan (its bwd_* fields), which the wrapper passes
// and the entry point checks; both variants take D up to 8192.
//
// Narrow (D <= 1024): one warp per row, as the narrow forward: each lane
// keeps its D/32 values of x and g in registers, and the row sums are
// warp shuffles. A fixed grid of at most 256 blocks of 8 warps walks the
// rows, and each lane also keeps its columns' running g * xhat and g
// sums. The column sums need a reduction across rows, and blocks run in
// no order, so: the 8 warps of a block add their partial sums into
// shared memory in warp order, and each block writes one partial row.
//
// Wide (D > 1024): one CTA of 256 threads per row, a fixed grid of at
// most 256 CTAs walking the rows. Thread t owns columns t + 256 k (k <
// kPer, kPer = 8, 16 or 32 as D needs): it keeps that slice of the
// row's x and g and of the running g * xhat and g sums in registers, and
// the row sums meet in shared memory in warp order. Each thread owns its
// columns for every row, so the CTA's partial row needs no shared
// memory: each thread writes its own columns of it.
//
// Either way a second kernel sums the partial rows of each column in
// block order. No atomics: the result does not depend on scheduling, and
// the grid does not depend on the card.

#include "common.cuh"

using namespace port;

namespace {

constexpr int kWarps = 8;
constexpr int kMaxPerLane = 32;  // narrow: D <= 32 * 32 = 1024
constexpr int kNarrowD = 32 * kMaxPerLane;
constexpr int kWideThreads = 256;  // wide: a CTA per row
constexpr int kMaxD = 8192;        // wide: 32 columns a thread
constexpr int kMaxBlocks = 256;  // kept in step with ops/layernorm.py

template <typename T, bool kResidual>
__global__ void __launch_bounds__(kWarps * 32)
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
              const T* __restrict__ g, const float* __restrict__ scale,
              T* __restrict__ dx, float* __restrict__ part_scale,
              float* __restrict__ part_bias, int rows, int d, float eps) {
  __shared__ float blk_scale[kNarrowD];
  __shared__ float blk_bias[kNarrowD];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < d; i += kWarps * 32) {
    blk_scale[i] = 0.f;
    blk_bias[i] = 0.f;
  }
  float ds[kMaxPerLane], db[kMaxPerLane];
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k) {
    ds[k] = 0.f;
    db[k] = 0.f;
  }
  const float fd = static_cast<float>(d);
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + warp; row < rows;
       row += stride) {
    const T* xr = x + row * d;
    const T* gr = g + row * d;
    float xv[kMaxPerLane], gv[kMaxPerLane];
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxPerLane; ++k) {
      const int i = lane + 32 * k;
      float a = 0.f, gg = 0.f;
      if (i < d) {
        a = to_f32(xr[i]);
        if (kResidual) a = round_through<T>(a + to_f32(r[row * d + i]));
        gg = to_f32(gr[i]);
      }
      xv[k] = a;
      gv[k] = gg;
      sum += a;
    }
    const float mean = warp_sum(sum) / fd;
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxPerLane; ++k) {
      if (lane + 32 * k < d) {
        const float c = xv[k] - mean;
        xv[k] = c;
        sq += c * c;
      }
    }
    const float inv = rsqrtf(warp_sum(sq) / fd + eps);
    float sum_gs = 0.f, sum_gsx = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxPerLane; ++k) {
      const int i = lane + 32 * k;
      if (i < d) {
        const float xhat = xv[k] * inv;
        const float gs = gv[k] * scale[i];
        xv[k] = xhat;
        sum_gs += gs;
        sum_gsx += gs * xhat;
        ds[k] += gv[k] * xhat;
        db[k] += gv[k];
      }
    }
    sum_gs = warp_sum(sum_gs);
    sum_gsx = warp_sum(sum_gsx);
    const float f = inv / fd;
    T* dxr = dx + row * d;
#pragma unroll
    for (int k = 0; k < kMaxPerLane; ++k) {
      const int i = lane + 32 * k;
      if (i < d) {
        const float gs = gv[k] * scale[i];
        dxr[i] = from_f32<T>(f * (fd * gs - sum_gs - xv[k] * sum_gsx));
      }
    }
  }
  __syncthreads();  // the zeroed block sums are visible
  for (int w = 0; w < kWarps; ++w) {  // warp order: deterministic
    if (warp == w) {
#pragma unroll
      for (int k = 0; k < kMaxPerLane; ++k) {
        const int i = lane + 32 * k;
        if (i < d) {
          blk_scale[i] += ds[k];
          blk_bias[i] += db[k];
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < d; i += kWarps * 32) {
    part_scale[static_cast<long long>(blockIdx.x) * d + i] = blk_scale[i];
    part_bias[static_cast<long long>(blockIdx.x) * d + i] = blk_bias[i];
  }
}

// Sum of v over the CTA's threads (the wide variant: one row a CTA),
// through `red` in warp order. Every thread calls it the same number of
// times.
__device__ __forceinline__ float cta_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWideThreads / 32; ++w) s += red[w];
  return s;
}

template <typename T, bool kResidual, int kPer>
__global__ void __launch_bounds__(kWideThreads)
ln_bwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ r,
                   const T* __restrict__ g, const float* __restrict__ scale,
                   T* __restrict__ dx, float* __restrict__ part_scale,
                   float* __restrict__ part_bias, int rows, int d, float eps) {
  // four row sums a row, each its own buffer: a buffer is written again
  // only after a later barrier that every reader of it has passed
  __shared__ float red[4][kWideThreads / 32];
  const int t = threadIdx.x;
  float ds[kPer], db[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    ds[k] = 0.f;
    db[k] = 0.f;
  }
  const float fd = static_cast<float>(d);
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * d;
    const T* gr = g + row * d;
    float xv[kPer], gv[kPer];
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = t + kWideThreads * k;
      float a = 0.f, gg = 0.f;
      if (i < d) {
        a = to_f32(xr[i]);
        if (kResidual) a = round_through<T>(a + to_f32(r[row * d + i]));
        gg = to_f32(gr[i]);
      }
      xv[k] = a;
      gv[k] = gg;
      sum += a;
    }
    const float mean = cta_sum(sum, red[0]) / fd;
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (t + kWideThreads * k < d) {
        const float c = xv[k] - mean;
        xv[k] = c;
        sq += c * c;
      }
    }
    const float inv = rsqrtf(cta_sum(sq, red[1]) / fd + eps);
    float sum_gs = 0.f, sum_gsx = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = t + kWideThreads * k;
      if (i < d) {
        const float xhat = xv[k] * inv;
        const float gs = gv[k] * scale[i];
        xv[k] = xhat;
        sum_gs += gs;
        sum_gsx += gs * xhat;
        ds[k] += gv[k] * xhat;
        db[k] += gv[k];
      }
    }
    sum_gs = cta_sum(sum_gs, red[2]);
    sum_gsx = cta_sum(sum_gsx, red[3]);
    const float f = inv / fd;
    T* dxr = dx + row * d;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = t + kWideThreads * k;
      if (i < d) dxr[i] = from_f32<T>(f * (fd * (gv[k] * scale[i]) - sum_gs - xv[k] * sum_gsx));
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = t + kWideThreads * k;
    if (i < d) {
      part_scale[static_cast<long long>(blockIdx.x) * d + i] = ds[k];
      part_bias[static_cast<long long>(blockIdx.x) * d + i] = db[k];
    }
  }
}

// Column sums of the [nparts, d] partial rows, in row order.
__global__ void ln_bwd_reduce(const float* __restrict__ part_scale,
                              const float* __restrict__ part_bias, int nparts,
                              int d, float* __restrict__ dscale,
                              float* __restrict__ dbias) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= d) return;
  float s = 0.f, b = 0.f;
  for (int p = 0; p < nparts; ++p) {
    s += part_scale[static_cast<long long>(p) * d + i];
    b += part_bias[static_cast<long long>(p) * d + i];
  }
  dscale[i] = s;
  dbias[i] = b;
}

template <typename T, bool kResidual>
void launch_rows(const T* x, const T* r, const T* g, const float* scale, T* dx,
                 float* part_scale, float* part_bias, int rows, int d, int nparts,
                 int per, float eps, cudaStream_t stream) {
  switch (per) {
    case 8: ln_bwd_wide_kernel<T, kResidual, 8><<<nparts, kWideThreads, 0, stream>>>(
        x, r, g, scale, dx, part_scale, part_bias, rows, d, eps); break;
    case 16: ln_bwd_wide_kernel<T, kResidual, 16><<<nparts, kWideThreads, 0, stream>>>(
        x, r, g, scale, dx, part_scale, part_bias, rows, d, eps); break;
    case 32: ln_bwd_wide_kernel<T, kResidual, 32><<<nparts, kWideThreads, 0, stream>>>(
        x, r, g, scale, dx, part_scale, part_bias, rows, d, eps); break;
    default:  // the narrow variant (check_plan: per 32 a lane)
      ln_bwd_kernel<T, kResidual><<<nparts, kWarps * 32, 0, stream>>>(
          x, r, g, scale, dx, part_scale, part_bias, rows, d, eps);
  }
}

// per: the wide variant's columns a thread, or 0 for the narrow variant
template <typename T>
void launch(const void* x, const void* r, const void* g, const void* scale, void* dx,
            void* part_scale, void* part_bias, void* dscale, void* dbias, int rows,
            int d, int nparts, int per, float eps, cudaStream_t stream) {
  if (r != nullptr) {
    launch_rows<T, true>(static_cast<const T*>(x), static_cast<const T*>(r),
                         static_cast<const T*>(g), static_cast<const float*>(scale),
                         static_cast<T*>(dx), static_cast<float*>(part_scale),
                         static_cast<float*>(part_bias), rows, d, nparts, per, eps, stream);
  } else {
    launch_rows<T, false>(static_cast<const T*>(x), nullptr, static_cast<const T*>(g),
                          static_cast<const float*>(scale), static_cast<T*>(dx),
                          static_cast<float*>(part_scale), static_cast<float*>(part_bias),
                          rows, d, nparts, per, eps, stream);
  }
  ln_bwd_reduce<<<(d + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part_scale), static_cast<const float*>(part_bias),
      nparts, d, static_cast<float*>(dscale), static_cast<float*>(dbias));
}

// ln_plan's backward fields (ops/layernorm.py): 32 values a lane and a
// warp a row up to D 1024, else 8, 16 or 32 columns a thread of a
// 256-thread CTA a row. Returns the wide variant's columns a thread (0:
// the narrow variant), or -1 if (per, row_threads) is not the plan.
int check_plan(int d, int per, int row_threads) {
  if (d <= kNarrowD) return per == kMaxPerLane && row_threads == 32 ? 0 : -1;
  const int want = d <= 8 * kWideThreads ? 8 : d <= 16 * kWideThreads ? 16 : 32;
  return per == want && row_threads == kWideThreads ? want : -1;
}

}  // namespace

// part_scale/part_bias: f32 scratch [nparts, d]; per and row_threads:
// ln_plan's bwd_per and bwd_row_threads; nparts must be min(256,
// ceil(rows / (256 / row_threads))): 8 rows a part narrow, 1 wide (the
// wrapper's figure).
extern "C" int port_layernorm_bwd(const void* x, const void* r, const void* g,
                                  const void* scale, void* dx, void* part_scale,
                                  void* part_bias, void* dscale, void* dbias,
                                  int rows, int d, int nparts, int per, int row_threads,
                                  float eps, int dtype, int device, void* stream) {
  // this library links its own CUDA runtime: select the caller's
  // device in it before launching on the caller's stream
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  if (rows <= 0) return 0;
  if (d <= 0 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const int wide = check_plan(d, per, row_threads);
  if (wide < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int rows_a_part = wide ? 1 : kWarps;
  const int want = (rows + rows_a_part - 1) / rows_a_part;
  if (nparts != (want < kMaxBlocks ? want : kMaxBlocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: launch<float>(x, r, g, scale, dx, part_scale, part_bias, dscale, dbias, rows, d, nparts, wide, eps, s); break;
    case kBF16: launch<__nv_bfloat16>(x, r, g, scale, dx, part_scale, part_bias, dscale, dbias, rows, d, nparts, wide, eps, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
