// K3: fused LayerNorm forward, y = LN(x) or y = LN(x + r), for any row
// width D from 1 to 8192.
//
// Replaces pyspark_tf_gke_tpu/ops/pallas/layernorm.py::_ln_kernel (:37)
// and ::_ln_add_kernel (:48), launched from _ln_forward (:79).
//
// Bound on the H100: memory. Each row is read once (twice with the
// residual) and written once; the arithmetic is ~10 f32 operations per
// element, far below the ~20 operations per byte at which the card's
// f32 rate would take over. At the LM's [8192, 768] bf16 that is 25 MB,
// 0.0075 ms at 3.35 TB/s.
//
// Both variants keep the TPU kernel's statistics: f32, the mean first,
// then the variance of the centred values (layernorm.py:37-56); the row
// is read from device memory once and lives in registers between the
// passes; y is rounded once to x's dtype. The variant and launch shape
// come from ops/layernorm.py ln_plan, which the wrapper passes and
// check_plan below recomputes. Each row is computed by one warp or one
// row group, whatever the grid: the result does not depend on the card.
//
// Narrow (D <= 1024), the first design: one warp per row, each lane
// keeping its D/32 elements in registers (32 predicated scalar loads a
// lane), the row sums two warp shuffles; four warps (four rows) a block,
// a block a row group. Replayed from a CUDA graph at [8192, 768] bf16 on
// an H100 it takes 0.0109 ms against a 0.0075 ms bound and
// F.layer_norm's 0.0187 (PERF.md, `kernel_probe.py ln-widths`), so it
// stays as it is.
//
// Wide (D > 1024):
//  - 16-byte loads and stores (8 bf16 or 4 f32 a chunk) where D is a
//    multiple of the chunk and every pointer is 16-byte aligned; else the
//    scalar variant, one element a load. Each thread holds `kPer` chunks
//    of a row, chunk c of its row at column c * kVec, c = place + k *
//    row_threads, so neighbouring threads touch neighbouring 16 bytes;
//    kPer is a template constant.
//  - A row belongs to `row_threads` threads, the fewest warps (2-32, a
//    power of two) at which a thread holds at most 4 chunks (3 or 4) or
//    8 elements; their row sums meet in shared memory in warp order (a
//    block reduction).
//  - A persistent grid (as many CTAs as fit on the card's SMs, at most
//    one a row group) walks the rows.
//  - A row's loads (x, and r) are all issued before its first reduction,
//    so the whole row is in flight at once.
//  - The f32 scale and bias are read again for each row, 16 bytes at a
//    time, as the row is written: they stay in L1. Kept in registers
//    across rows instead, they took the bf16 kernel at 4 chunks a thread
//    to 177 registers (one 256-thread CTA an SM), and it was 1.3x slower
//    at 1600 and 1.37x at 4096 (replayed from a CUDA graph on an H100;
//    PERF.md).

#include "common.cuh"
#include "wgmma.cuh"

using namespace port;

namespace {

constexpr int kMaxD = 8192;

// -- narrow: D <= 1024 ------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kMaxPerLane = 32;  // D <= 32 * 32 = 1024
constexpr int kNarrowD = 32 * kMaxPerLane;

template <typename T, bool kResidual>
__global__ void __launch_bounds__(kWarps * 32)
ln_narrow_kernel(const T* __restrict__ x, const T* __restrict__ r,
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

// -- wide: 1024 < D <= 8192 ----------------------------------------------------------

constexpr int kCtaThreads = 256;  // threads a CTA, or a row's threads if more
constexpr int kMaxVecPer = 4;     // 16-byte chunks a thread a row (3 or 4 when D > 1024)
constexpr int kScalarPer = 8;     // elements a thread a row, the scalar variant

// the most threads a CTA of each variant takes (ln_plan stays within
// them at D <= kMaxD): bf16 chunks 256, f32 chunks 512, scalar 1024
__host__ __device__ constexpr int max_threads(int vec) { return vec == 1 ? 1024 : 2048 / vec; }

template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Chunk {
  T e[kVec];
};

// Sum of v over the threads of a row: a warp shuffle, then the row's
// warps through `red` in warp order. Every thread of the CTA calls it
// the same number of times (a barrier inside).
__device__ __forceinline__ float row_sum(float v, float* red, int warps_per_row) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  const int first = warp - warp % warps_per_row;
  float s = 0.f;
  for (int i = 0; i < warps_per_row; ++i) s += red[first + i];
  return s;
}

template <typename T, int kVec, int kPer, bool kResidual>
__global__ void __launch_bounds__(max_threads(kVec))
ln_wide_kernel(const T* __restrict__ x, const T* __restrict__ r, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ y, int rows, int d,
               int row_threads, float eps) {
  using C = Chunk<T, kVec>;
  constexpr int kN = kPer * kVec;
  __shared__ float red[2][32];  // the two row sums of the block reduction
  const int place = threadIdx.x % row_threads;
  const int groups = blockDim.x / row_threads;  // rows a CTA has in flight
  const int warps_per_row = row_threads >> 5;
  const float fd = static_cast<float>(d);

  // every thread of the CTA walks the same row groups, so the block
  // reduction's barriers line up; a group past the last row only takes
  // part in them
  for (long long base = static_cast<long long>(blockIdx.x) * groups; base < rows;
       base += static_cast<long long>(gridDim.x) * groups) {
    const long long row = base + threadIdx.x / row_threads;
    const bool live = row < rows;
    C cx[kPer], cr[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {  // the whole row in flight
      const int col = (place + k * row_threads) * kVec;
      if (live && col < d) {
        cx[k] = *reinterpret_cast<const C*>(x + row * d + col);
        if (kResidual) cr[k] = *reinterpret_cast<const C*>(r + row * d + col);
      }
    }
    float v[kN];
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const bool in = live && (place + k * row_threads) * kVec < d;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        float a = 0.f;
        if (in) {
          a = to_f32(cx[k].e[e]);
          if (kResidual) a += to_f32(cr[k].e[e]);
        }
        v[k * kVec + e] = a;
        sum += a;
      }
    }
    const float mean = row_sum(sum, red[0], warps_per_row) / fd;
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if ((place + k * row_threads) * kVec < d) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float c = v[k * kVec + e] - mean;
          v[k * kVec + e] = c;
          sq += c * c;
        }
      }
    }
    const float inv = rsqrtf(row_sum(sq, red[1], warps_per_row) / fd + eps);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int col = (place + k * row_threads) * kVec;
      if (live && col < d) {
        float sc[kVec], bi[kVec];  // this chunk's scale and bias, from L1
        if constexpr (kVec == 1) {
          sc[0] = __ldg(scale + col);
          bi[0] = __ldg(bias + col);
        } else {
#pragma unroll
          for (int i = 0; i < kVec / 4; ++i) {
            const float4 a = __ldg(reinterpret_cast<const float4*>(scale + col) + i);
            const float4 b = __ldg(reinterpret_cast<const float4*>(bias + col) + i);
            sc[4 * i] = a.x;
            sc[4 * i + 1] = a.y;
            sc[4 * i + 2] = a.z;
            sc[4 * i + 3] = a.w;
            bi[4 * i] = b.x;
            bi[4 * i + 1] = b.y;
            bi[4 * i + 2] = b.z;
            bi[4 * i + 3] = b.w;
          }
        }
        C out;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          out.e[e] = from_f32<T>(v[k * kVec + e] * inv * sc[e] + bi[e]);
        }
        *reinterpret_cast<C*>(y + row * d + col) = out;
      }
    }
  }
}

// ln_plan (ops/layernorm.py): the launch shape of width d with chunks of
// vec elements. Returns 0 if (vec, per, row_threads, threads) is that
// plan.
int check_plan(int d, int vec, int per, int row_threads, int threads) {
  if (d <= kNarrowD) {
    const bool ok = vec == 1 && per == kMaxPerLane && row_threads == 32 && threads == kWarps * 32;
    return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
  }
  const int max_per = vec == 1 ? kScalarPer : kMaxVecPer;
  const int n = (d + vec - 1) / vec;  // chunks a row
  int rt = 32;
  while (rt * max_per < n) rt *= 2;
  const int want = vec == 1 ? kScalarPer : (n + rt - 1) / rt;
  const int cta = rt > kCtaThreads ? rt : kCtaThreads;
  const bool ok = per == want && row_threads == rt && threads == cta &&
                  threads <= max_threads(vec);
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// CTAs of the persistent grid: those that fit on the card at once, at
// most one a row group. `fit` caches the kernel's CTAs an SM.
template <typename Kernel>
int grid_for(Kernel kernel, int& fit, int threads, int rows, int groups) {
  if (fit == 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, threads, 0) !=
                      cudaSuccess) {
    fit = 0;
  }
  const long long need = (static_cast<long long>(rows) + groups - 1) / groups;
  const long long room = static_cast<long long>(hopper::sm_count()) * (fit > 0 ? fit : 1);
  return static_cast<int>(room > 0 && room < need ? room : need);
}

template <typename T, int kVec, int kPer>
int launch_wide(const void* x, const void* r, const void* scale, const void* bias, void* y,
                int rows, int d, int row_threads, int threads, float eps, cudaStream_t stream) {
  const int groups = threads / row_threads;
  // CTAs an SM of each kernel at each CTA size (256, 512 or 1024 threads)
  static int fit[2][3] = {};
  const int size = threads <= 256 ? 0 : threads <= 512 ? 1 : 2;
  if (r != nullptr) {
    auto kernel = ln_wide_kernel<T, kVec, kPer, true>;
    kernel<<<grid_for(kernel, fit[1][size], threads, rows, groups), threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<T*>(y), rows, d, row_threads, eps);
  } else {
    auto kernel = ln_wide_kernel<T, kVec, kPer, false>;
    kernel<<<grid_for(kernel, fit[0][size], threads, rows, groups), threads, 0, stream>>>(
        static_cast<const T*>(x), nullptr, static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<T*>(y), rows, d, row_threads, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_narrow(const void* x, const void* r, const void* scale, const void* bias, void* y,
                  int rows, int d, float eps, cudaStream_t stream) {
  const dim3 grid((rows + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  if (r != nullptr) {
    ln_narrow_kernel<T, true><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(r),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<T*>(y), rows, d, eps);
  } else {
    ln_narrow_kernel<T, false><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), nullptr,
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<T*>(y), rows, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* r, const void* scale, const void* bias, void* y, int rows,
             int d, int vec, int per, int row_threads, int threads, float eps,
             cudaStream_t stream) {
  constexpr int kChunk = 16 / sizeof(T);
  if (d <= kNarrowD) return launch_narrow<T>(x, r, scale, bias, y, rows, d, eps, stream);
  if (vec == kChunk && per == 3) {
    return launch_wide<T, kChunk, 3>(x, r, scale, bias, y, rows, d, row_threads, threads, eps,
                                     stream);
  }
  if (vec == kChunk && per == 4) {
    return launch_wide<T, kChunk, 4>(x, r, scale, bias, y, rows, d, row_threads, threads, eps,
                                     stream);
  }
  if (vec == 1 && per == kScalarPer) {
    return launch_wide<T, 1, kScalarPer>(x, r, scale, bias, y, rows, d, row_threads, threads,
                                         eps, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// vec, per, row_threads, threads: the plan of ops/layernorm.py ln_plan,
// checked here. The wide chunked variant (vec > 1) needs d a multiple of
// vec and x, r, scale, bias and y 16-byte aligned.
extern "C" int port_layernorm(const void* x, const void* r, const void* scale,
                              const void* bias, void* y, int rows, int d,
                              float eps, int vec, int per, int row_threads,
                              int threads, int dtype, int device, void* stream) {
  // this library links its own CUDA runtime: select the caller's
  // device in it before launching on the caller's stream
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  if (rows <= 0) return 0;
  if (d <= 0 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  if (int rc = check_plan(d, vec, per, row_threads, threads)) return rc;
  if (vec > 1 && (d % vec != 0 || !aligned16(x) || !aligned16(scale) || !aligned16(bias) ||
                  !aligned16(y) || (r != nullptr && !aligned16(r)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return dispatch<float>(x, r, scale, bias, y, rows, d, vec, per, row_threads, threads, eps, s);
    case kBF16:
      return dispatch<__nv_bfloat16>(x, r, scale, bias, y, rows, d, vec, per, row_threads, threads,
                                     eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
