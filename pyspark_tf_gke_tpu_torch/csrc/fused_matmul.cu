// K4: the fused 1x1-conv matmul of ResNet's bottleneck blocks, with a
// BatchNorm input transform and statistics epilogue, and its backward.
//
//   K4f  (port_k4_fwd): y = relu(x*a + b) @ w (transform and relu optional),
//        plus per-column sum and sum of squares of the ROUNDED y.
//   K4dx (port_k4_dx):  u = dy @ w^T, masked by x*a + b > 0 (relu),
//        dx = u*a, plus per-column sums of u*x and u (d a, d b).
//   K4dw (port_k4_dw):  dw = relu(x*a + b)^T @ dy, summed over all M rows.
//
// Replaces pyspark_tf_gke_tpu/ops/pallas/fused_matmul.py::_fwd_kernel (:91),
// ::_dx_kernel (:178) and ::_dw_kernel (:246). Rounding points are the TPU
// kernels': the transformed input is rounded to x's dtype before the
// product (:106-109), products accumulate in f32, y / dx / dw are rounded
// once at the end, and the statistics are sums of the rounded y (:127).
// The transform is x*a then + b, each rounded (no fused multiply-add), as
// the plain versions compute it, so the relu mask agrees with them bit for
// bit.
//
// Bound on the H100: most of ResNet-50's calls move more bytes than their
// tensor-core time (M = 200,704 rows at K, N = 64..256); the K = 1024..2048
// calls are bound by operations. This first version computes the product
// on the CUDA cores in f32 (for bf16 inputs too), so it is bound by f32
// FMA throughput well above either bound; moving the product onto wgmma
// with TMA loads is later work.
//
// Design: one shared-memory GEMM mainloop for all three (tile_gemm.cuh,
// shared with K5's fused 3x3 conv in fused_conv3.cu). A block owns a
// 128 x 64 output tile (256 threads, 8 x 4 outputs each) and walks the
// reduction in steps of 16: both operand tiles are staged in shared memory
// as f32, reduction-major, and the input transform (and its rounding) is
// applied while staging, so the product reads normalised values. Ragged
// edges are masked at the loads (zero AFTER the transform: relu(b) is not
// zero) and at the stores. The TPU kernels carry an accumulator across a
// sequential grid axis; blocks here run in no order, so
//   * K4f and K4dx loop over the whole reduction inside the block and
//     write one row of column partials per 128-row tile ([tiles, 2, C]),
//     summed afterwards in tile order by colsum_kernel;
//   * K4dw splits M across blocks (grid z): each writes an f32 partial
//     [splits, K, N], and splitsum_kernel adds the splits in order and
//     rounds to dy's dtype.
// No atomics anywhere: every result is independent of scheduling.

#include "tile_gemm.cuh"

using namespace port;
using namespace port::tile;

namespace {

template <typename T, bool kTransform, bool kRelu, bool kStats>
__global__ void __launch_bounds__(kThreads)
k4_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ a,
              const float* __restrict__ b, T* __restrict__ y, float* __restrict__ part, int m,
              int kdim, int n) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];
  __shared__ float red[2 * (kBM / kTM)][kBN];
  const int tx = threadIdx.x % (kBN / kTN), ty = threadIdx.x / (kBN / kTN);
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  float acc[kTM][kTN] = {};
  for (int k0 = 0; k0 < kdim; k0 += kBK) {
    // A = transform(x) [m, k]: reduction k contiguous, channel = k
    stage<T, kBM, true, kTransform ? kChanIsRed : kNoTransform, kRelu>(
        As, x, kdim, m0, m, k0, kdim, a, b);
    // B = w [k, n]: tile rows are n (contiguous)
    stage<T, kBN, false, kNoTransform, false>(Bs, w, n, n0, n, k0, kdim, nullptr, nullptr);
    __syncthreads();
    tile_product(As, Bs, acc, ty, tx);
    __syncthreads();
  }
  float s0[kTN] = {}, s1[kTN] = {};
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = m0 + ty * kTM + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + tx * kTN + j;
      if (col >= n) continue;
      const T v = from_f32<T>(acc[i][j]);
      y[static_cast<long long>(row) * n + col] = v;
      const float vr = to_f32(v);  // statistics of the rounded output
      s0[j] += vr;
      s1[j] += vr * vr;
    }
  }
  if (kStats) write_col_partials(red, s0, s1, ty, tx, part, blockIdx.x, n0, n);
}

template <typename T, bool kTransform, bool kRelu>
__global__ void __launch_bounds__(kThreads)
k4_dx_kernel(const T* __restrict__ dy, const T* __restrict__ w, const T* __restrict__ x,
             const float* __restrict__ a, const float* __restrict__ b, T* __restrict__ dx,
             float* __restrict__ part, int m, int kdim, int n) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];
  __shared__ float red[2 * (kBM / kTM)][kBN];
  const int tx = threadIdx.x % (kBN / kTN), ty = threadIdx.x / (kBN / kTN);
  const int m0 = blockIdx.x * kBM, c0 = blockIdx.y * kBN;  // c: the K axis
  float acc[kTM][kTN] = {};
  for (int n0 = 0; n0 < n; n0 += kBK) {
    // A = dy [m, n]: reduction n contiguous
    stage<T, kBM, true, kNoTransform, false>(As, dy, n, m0, m, n0, n, nullptr, nullptr);
    // B = w^T: tile rows are k, reduction n contiguous (w [k, n])
    stage<T, kBN, true, kNoTransform, false>(Bs, w, n, c0, kdim, n0, n, nullptr, nullptr);
    __syncthreads();
    tile_product(As, Bs, acc, ty, tx);
    __syncthreads();
  }
  float s0[kTN] = {}, s1[kTN] = {};
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = m0 + ty * kTM + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = c0 + tx * kTN + j;
      if (col >= kdim) continue;
      const long long off = static_cast<long long>(row) * kdim + col;
      float u = acc[i][j];  // d xn
      if (kTransform) {
        const float xf = to_f32(x[off]);
        if (kRelu && !(__fadd_rn(__fmul_rn(xf, a[col]), b[col]) > 0.f)) u = 0.f;
        dx[off] = from_f32<T>(u * a[col]);
        s0[j] += u * xf;
        s1[j] += u;
      } else {
        dx[off] = from_f32<T>(u);
      }
    }
  }
  if (kTransform) write_col_partials(red, s0, s1, ty, tx, part, blockIdx.x, c0, kdim);
}

template <typename T, bool kTransform, bool kRelu>
__global__ void __launch_bounds__(kThreads)
k4_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ a,
             const float* __restrict__ b, float* __restrict__ part, int m, int kdim, int n,
             int chunk) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];
  const int tx = threadIdx.x % (kBN / kTN), ty = threadIdx.x / (kBN / kTN);
  const int c0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;  // c: the K axis
  const int mbeg = blockIdx.z * chunk;
  const int mend = min(mbeg + chunk, m);
  float acc[kTM][kTN] = {};
  for (int r0 = mbeg; r0 < mend; r0 += kBK) {
    // A = transform(x)^T: tile rows are k (contiguous in x [m, k]),
    // reduction m, channel = the tile row
    stage<T, kBM, false, kTransform ? kChanIsRow : kNoTransform, kRelu>(
        As, x, kdim, c0, kdim, r0, mend, a, b);
    // B = dy [m, n]: tile rows are n (contiguous)
    stage<T, kBN, false, kNoTransform, false>(Bs, dy, n, n0, n, r0, mend, nullptr, nullptr);
    __syncthreads();
    tile_product(As, Bs, acc, ty, tx);
    __syncthreads();
  }
  float* out = part + static_cast<long long>(blockIdx.z) * kdim * n;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = c0 + ty * kTM + i;
    if (row >= kdim) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + tx * kTN + j;
      if (col < n) out[static_cast<long long>(row) * n + col] = acc[i][j];
    }
  }
}

template <typename T, bool kTransform, bool kRelu, bool kStats>
void fwd(const void* x, const void* w, const void* a, const void* b, void* y, void* part,
         void* stats, int m, int kdim, int n, cudaStream_t s) {
  const dim3 grid = tiles(m, n);
  k4_fwd_kernel<T, kTransform, kRelu, kStats><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<T*>(y), static_cast<float*>(part), m, kdim, n);
  if (kStats) colsum(part, grid.x, 2 * n, stats, s);
}

template <typename T, bool kTransform, bool kRelu>
void dx_launch(const void* dy, const void* w, const void* x, const void* a, const void* b,
               void* dx, void* part, void* dstats, int m, int kdim, int n, cudaStream_t s) {
  const dim3 grid = tiles(m, kdim);
  k4_dx_kernel<T, kTransform, kRelu><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(dy), static_cast<const T*>(w), static_cast<const T*>(x),
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<T*>(dx),
      static_cast<float*>(part), m, kdim, n);
  if (kTransform) colsum(part, grid.x, 2 * kdim, dstats, s);
}

template <typename T, bool kTransform, bool kRelu>
void dw_launch(const void* x, const void* dy, const void* a, const void* b, void* part,
               void* dw, int m, int kdim, int n, int splits, int chunk, cudaStream_t s) {
  k4_dw_kernel<T, kTransform, kRelu><<<tiles(kdim, n, splits), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<float*>(part), m, kdim, n, chunk);
  splitsum<T>(part, splits, static_cast<long long>(kdim) * n, dw, s);
}

// transform: 0 none, 1 x*a+b, 2 relu(x*a+b)
template <typename T>
void fwd_dispatch(int transform, int want_stats, const void* x, const void* w, const void* a,
                  const void* b, void* y, void* part, void* stats, int m, int kdim, int n,
                  cudaStream_t s) {
#define K4_FWD(TR, RE)                                                              \
  (want_stats ? fwd<T, TR, RE, true>(x, w, a, b, y, part, stats, m, kdim, n, s)     \
              : fwd<T, TR, RE, false>(x, w, a, b, y, part, stats, m, kdim, n, s))
  if (transform == 0) K4_FWD(false, false);
  else if (transform == 1) K4_FWD(true, false);
  else K4_FWD(true, true);
#undef K4_FWD
}

bool shape_ok(int m, int kdim, int n) { return m > 0 && kdim > 0 && n > 0; }

}  // namespace

// part: f32 scratch [ceil(m / 128), 2, n] (want_stats), stats: f32 [2, n].
extern "C" int port_k4_fwd(const void* x, const void* w, const void* a, const void* b, void* y,
                           void* part, void* stats, int m, int kdim, int n, int transform,
                           int want_stats, int dtype, int device, void* stream) {
  // this library links its own CUDA runtime: select the caller's device
  // in it before launching on the caller's stream
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  if (!shape_ok(m, kdim, n) || transform < 0 || transform > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: fwd_dispatch<float>(transform, want_stats, x, w, a, b, y, part, stats, m, kdim, n, s); break;
    case kBF16: fwd_dispatch<__nv_bfloat16>(transform, want_stats, x, w, a, b, y, part, stats, m, kdim, n, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// part: f32 scratch [ceil(m / 128), 2, kdim] (transform), dstats: f32 [2, kdim].
extern "C" int port_k4_dx(const void* dy, const void* w, const void* x, const void* a,
                          const void* b, void* dx, void* part, void* dstats, int m, int kdim,
                          int n, int transform, int dtype, int device, void* stream) {
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  if (!shape_ok(m, kdim, n) || transform < 0 || transform > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K4_DX(T)                                                                             \
  (transform == 0   ? dx_launch<T, false, false>(dy, w, x, a, b, dx, part, dstats, m, kdim, n, s) \
   : transform == 1 ? dx_launch<T, true, false>(dy, w, x, a, b, dx, part, dstats, m, kdim, n, s)  \
                    : dx_launch<T, true, true>(dy, w, x, a, b, dx, part, dstats, m, kdim, n, s))
  switch (dtype) {
    case kF32: K4_DX(float); break;
    case kBF16: K4_DX(__nv_bfloat16); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K4_DX
  return static_cast<int>(cudaGetLastError());
}

// part: f32 scratch [splits, kdim, n]; split z sums rows [z*chunk, (z+1)*chunk).
extern "C" int port_k4_dw(const void* x, const void* dy, const void* a, const void* b,
                          void* part, void* dw, int m, int kdim, int n, int transform,
                          int splits, int chunk, int dtype, int device, void* stream) {
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  if (!shape_ok(m, kdim, n) || transform < 0 || transform > 2 || splits <= 0 ||
      chunk <= 0 || chunk % kBK != 0 || static_cast<long long>(splits) * chunk < m ||
      static_cast<long long>(splits - 1) * chunk >= m || splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K4_DW(T)                                                                             \
  (transform == 0   ? dw_launch<T, false, false>(x, dy, a, b, part, dw, m, kdim, n, splits, chunk, s) \
   : transform == 1 ? dw_launch<T, true, false>(x, dy, a, b, part, dw, m, kdim, n, splits, chunk, s)  \
                    : dw_launch<T, true, true>(x, dy, a, b, part, dw, m, kdim, n, splits, chunk, s))
  switch (dtype) {
    case kF32: K4_DW(float); break;
    case kBF16: K4_DW(__nv_bfloat16); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K4_DW
  return static_cast<int>(cudaGetLastError());
}
