// K5: the fused 3x3 conv (stride 1, SAME) of ResNet's bottleneck blocks,
// with a BatchNorm input transform and statistics epilogue, and its
// backward. NHWC activations, HWIO weights, pixels p = (b, i, j) flattened.
//
//   K5f  (port_k5_fwd): y[p] = sum over taps (dh, dw) of
//        xn[b, i+dh-1, j+dw-1, :] @ w[dh, dw], xn = relu(x*a + b)
//        (transform and relu optional), plus per-channel sum and sum of
//        squares of the ROUNDED y.
//   K5dx (port_k5_dx):  u[p] = sum over taps of dy[b, i-dh+1, j-dw+1, :]
//        @ w[dh, dw]^T (the flipped taps), masked by x*a + b > 0 (relu),
//        dx = u*a, plus per-channel sums of u*x and u (d a, d b).
//   K5dw (port_k5_dw):  dw[dh, dw] = sum over all pixels of
//        xn[b, i+dh-1, j+dw-1, :]^T dy[p, :].
// A tap that falls outside its own image contributes 0: the zero padding
// comes AFTER the transform (relu(b) is not 0), whether the flattened
// index would land in the next row, the next image or off the tensor.
//
// Replaces pyspark_tf_gke_tpu/ops/pallas/fused_conv3.py::_fwd_kernel
// (:55), ::_dx_kernel (:116) and ::_dw_kernel (:179). Rounding points are
// the TPU kernels': the transformed input is rounded to x's dtype before
// the products (:43-52), the nine tap products accumulate in f32, y / dx
// are rounded once at the end, the statistics are sums of the rounded y
// (:71-72), and dw is summed in f32 and rounded to w's dtype once. The
// transform is x*a then + b, each rounded (no fused multiply-add), so the
// relu mask agrees with the plain versions bit for bit.
//
// Bound on the H100: 2*M*9*K*N operations, 14.8 GFLOP for each of
// ResNet-50's stride-1 3x3 convs at batch 64 (15.0 us at 989 TFLOP/s
// bf16), against 11-51 MB of bytes (stage 4 to stage 1; 15.3 us at 3.35
// TB/s for stage 1's forward): ~15 us a call, operations and bytes about
// even at stage 1, operations beyond it. This first version computes the
// products on the CUDA cores in f32, as K4 does, so it runs at f32 FMA
// throughput far above that bound; wgmma with TMA loads is later work.
//
// Design: an implicit GEMM over output pixels on K4's tiled mainloop
// (tile_gemm.cuh). The TPU kernels keep one whole zero-padded image in
// VMEM (grid = (B,)); at stage 1 that is 58x58x64 bf16, more than an SM's
// shared memory, so here a block owns a tile of 128 output pixels x 64
// channels, which may cross image rows and images. For each of the nine
// taps the block stages the shifted input pixels of its tile (the
// transform applied while staging, out-of-image taps set to 0) and that
// tap's weights, and accumulates; each row's image coordinates are
// computed once per block. K5f and K5dx write one row of per-channel
// partials per tile, summed in tile order by colsum_kernel. K5dw owns a
// K x N tile of one tap and a split of the pixels (grid z = split * 9 +
// tap): f32 partials [splits, 3, 3, K, N] summed in order and rounded by
// splitsum_kernel. No atomics: every result is independent of scheduling.

#include <climits>

#include "tile_gemm.cuh"

using namespace port;
using namespace port::tile;

namespace {

constexpr int kTaps = 9;
constexpr int kFar = -(1 << 28);  // image row of a tile row past the last pixel

// Image coordinates (i, j) of the tile's rows m0..m0+kBM-1; kFar past m,
// so that every tap of such a row falls outside the image.
__device__ __forceinline__ void pixel_rows(int* ri, int* rj, int m0, int m, int h, int wd) {
  for (int r = threadIdx.x; r < kBM; r += kThreads) {
    const int p = m0 + r;
    if (p < m) {
      const int q = p % (h * wd);
      ri[r] = q / wd;
      rj[r] = q % wd;
    } else {
      ri[r] = kFar;
      rj[r] = kFar;
    }
  }
  __syncthreads();
}

// Stage dst[kk][r] = transform(src[pixel r shifted by (di, dj), c0 + kk])
// (reduction-major, f32) for the tile's kBM pixel rows and channels
// [c0, c0 + kBK) of src [pixels, c]; 0 where the shifted pixel leaves its
// image or the channel is past c.
template <typename T, bool kTransform, bool kRelu>
__device__ __forceinline__ void stage_pixels(float (*dst)[kBM + kPad], const T* __restrict__ src,
                                             int c, const int* ri, const int* rj, int m0, int h,
                                             int wd, int di, int dj, int c0,
                                             const float* __restrict__ a,
                                             const float* __restrict__ b) {
#pragma unroll
  for (int i = 0; i < kBM * kBK / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kBK, kk = idx % kBK;
    const int ii = ri[r] + di, jj = rj[r] + dj, gc = c0 + kk;
    float v = 0.f;
    if (gc < c && ii >= 0 && ii < h && jj >= 0 && jj < wd) {
      const long long pix = static_cast<long long>(m0 + r) + di * wd + dj;
      v = to_f32(src[pix * c + gc]);
      if (kTransform) v = norm_transform<T, kRelu>(v, a[gc], b[gc]);
    }
    dst[kk][r] = v;
  }
}

template <typename T, bool kTransform, bool kRelu, bool kStats>
__global__ void __launch_bounds__(kThreads)
k5_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ a,
              const float* __restrict__ b, T* __restrict__ y, float* __restrict__ part, int m,
              int h, int wd, int kdim, int n) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];
  __shared__ float red[2 * (kBM / kTM)][kBN];
  __shared__ int ri[kBM], rj[kBM];
  const int tx = threadIdx.x % (kBN / kTN), ty = threadIdx.x / (kBN / kTN);
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  pixel_rows(ri, rj, m0, m, h, wd);
  float acc[kTM][kTN] = {};
  for (int tap = 0; tap < kTaps; ++tap) {
    const int di = tap / 3 - 1, dj = tap % 3 - 1;
    const T* wt = w + static_cast<long long>(tap) * kdim * n;
    for (int k0 = 0; k0 < kdim; k0 += kBK) {
      // A = transform(x) at the tap's neighbour of each output pixel
      stage_pixels<T, kTransform, kRelu>(As, x, kdim, ri, rj, m0, h, wd, di, dj, k0, a, b);
      // B = w[tap] [k, n]: tile rows are n (contiguous)
      stage<T, kBN, false, kNoTransform, false>(Bs, wt, n, n0, n, k0, kdim, nullptr, nullptr);
      __syncthreads();
      tile_product(As, Bs, acc, ty, tx);
      __syncthreads();
    }
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
k5_dx_kernel(const T* __restrict__ dy, const T* __restrict__ w, const T* __restrict__ x,
             const float* __restrict__ a, const float* __restrict__ b, T* __restrict__ dx,
             float* __restrict__ part, int m, int h, int wd, int kdim, int n) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];
  __shared__ float red[2 * (kBM / kTM)][kBN];
  __shared__ int ri[kBM], rj[kBM];
  const int tx = threadIdx.x % (kBN / kTN), ty = threadIdx.x / (kBN / kTN);
  const int m0 = blockIdx.x * kBM, c0 = blockIdx.y * kBN;  // c: the K axis
  pixel_rows(ri, rj, m0, m, h, wd);
  float acc[kTM][kTN] = {};
  for (int tap = 0; tap < kTaps; ++tap) {
    // the adjoint of tap (dh, dw) gathers dy[b, i-dh+1, j-dw+1]
    const int di = 1 - tap / 3, dj = 1 - tap % 3;
    const T* wt = w + static_cast<long long>(tap) * kdim * n;
    for (int n0 = 0; n0 < n; n0 += kBK) {
      // A = dy at the flipped tap's neighbour: reduction n contiguous
      stage_pixels<T, false, false>(As, dy, n, ri, rj, m0, h, wd, di, dj, n0, nullptr, nullptr);
      // B = w[tap]^T: tile rows are k, reduction n contiguous (w [k, n])
      stage<T, kBN, true, kNoTransform, false>(Bs, wt, n, c0, kdim, n0, n, nullptr, nullptr);
      __syncthreads();
      tile_product(As, Bs, acc, ty, tx);
      __syncthreads();
    }
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
k5_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ a,
             const float* __restrict__ b, float* __restrict__ part, int m, int h, int wd,
             int kdim, int n, int chunk) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];
  __shared__ int src_pix[kBK];
  const int tx = threadIdx.x % (kBN / kTN), ty = threadIdx.x / (kBN / kTN);
  const int c0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;  // c: the K axis
  const int tap = blockIdx.z % kTaps;
  const int di = tap / 3 - 1, dj = tap % 3 - 1;
  const int mbeg = (blockIdx.z / kTaps) * chunk;
  const int mend = min(mbeg + chunk, m);
  float acc[kTM][kTN] = {};
  for (int r0 = mbeg; r0 < mend; r0 += kBK) {
    // the input pixel each of this step's output pixels reads at the
    // tap, or -1 where it leaves the image
    if (threadIdx.x < kBK) {
      const int p = r0 + threadIdx.x;
      int src = -1;
      if (p < mend) {
        const int q = p % (h * wd);
        const int ii = q / wd + di, jj = q % wd + dj;
        if (ii >= 0 && ii < h && jj >= 0 && jj < wd) src = p + di * wd + dj;
      }
      src_pix[threadIdx.x] = src;
    }
    __syncthreads();
    // A = transform(x shifted)^T: tile rows are k (contiguous in x [m, k]),
    // reduction over pixels, channel = the tile row
#pragma unroll
    for (int i = 0; i < kBM * kBK / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx % kBM, kk = idx / kBM;
      const int gc = c0 + r, sp = src_pix[kk];
      float v = 0.f;
      if (gc < kdim && sp >= 0) {
        v = to_f32(x[static_cast<long long>(sp) * kdim + gc]);
        if (kTransform) v = norm_transform<T, kRelu>(v, a[gc], b[gc]);
      }
      As[kk][r] = v;
    }
    // B = dy [m, n]: tile rows are n (contiguous), reduction over pixels
    stage<T, kBN, false, kNoTransform, false>(Bs, dy, n, n0, n, r0, mend, nullptr, nullptr);
    __syncthreads();
    tile_product(As, Bs, acc, ty, tx);
    __syncthreads();
  }
  // partial [split, tap, k, n]: blockIdx.z = split * 9 + tap
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
         void* stats, int m, int h, int wd, int kdim, int n, cudaStream_t s) {
  const dim3 grid = tiles(m, n);
  k5_fwd_kernel<T, kTransform, kRelu, kStats><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<T*>(y), static_cast<float*>(part), m, h, wd,
      kdim, n);
  if (kStats) colsum(part, grid.x, 2 * n, stats, s);
}

template <typename T, bool kTransform, bool kRelu>
void dx_launch(const void* dy, const void* w, const void* x, const void* a, const void* b,
               void* dx, void* part, void* dstats, int m, int h, int wd, int kdim, int n,
               cudaStream_t s) {
  const dim3 grid = tiles(m, kdim);
  k5_dx_kernel<T, kTransform, kRelu><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(dy), static_cast<const T*>(w), static_cast<const T*>(x),
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<T*>(dx),
      static_cast<float*>(part), m, h, wd, kdim, n);
  if (kTransform) colsum(part, grid.x, 2 * kdim, dstats, s);
}

template <typename T, bool kTransform, bool kRelu>
void dw_launch(const void* x, const void* dy, const void* a, const void* b, void* part,
               void* dw, int m, int h, int wd, int kdim, int n, int splits, int chunk,
               cudaStream_t s) {
  k5_dw_kernel<T, kTransform, kRelu><<<tiles(kdim, n, kTaps * splits), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<float*>(part), m, h, wd, kdim, n, chunk);
  splitsum<T>(part, splits, static_cast<long long>(kTaps) * kdim * n, dw, s);
}

// transform: 0 none, 1 x*a+b, 2 relu(x*a+b)
template <typename T>
void fwd_dispatch(int transform, int want_stats, const void* x, const void* w, const void* a,
                  const void* b, void* y, void* part, void* stats, int m, int h, int wd,
                  int kdim, int n, cudaStream_t s) {
#define K5_FWD(TR, RE)                                                                   \
  (want_stats ? fwd<T, TR, RE, true>(x, w, a, b, y, part, stats, m, h, wd, kdim, n, s)   \
              : fwd<T, TR, RE, false>(x, w, a, b, y, part, stats, m, h, wd, kdim, n, s))
  if (transform == 0) K5_FWD(false, false);
  else if (transform == 1) K5_FWD(true, false);
  else K5_FWD(true, true);
#undef K5_FWD
}

// The pixel count M = bsz * h * wd, or -1 when a dimension is not
// positive or M does not fit an int.
int pixels(int bsz, int h, int wd, int kdim, int n) {
  if (bsz <= 0 || h <= 0 || wd <= 0 || kdim <= 0 || n <= 0) return -1;
  const long long m = static_cast<long long>(bsz) * h * wd;
  return m > INT_MAX ? -1 : static_cast<int>(m);
}

}  // namespace

// x [bsz, h, wd, kdim], w [3, 3, kdim, n], y [bsz, h, wd, n];
// part: f32 scratch [ceil(M / 128), 2, n] (want_stats), stats: f32 [2, n].
extern "C" int port_k5_fwd(const void* x, const void* w, const void* a, const void* b, void* y,
                           void* part, void* stats, int bsz, int h, int wd, int kdim, int n,
                           int transform, int want_stats, int dtype, int device, void* stream) {
  // this library links its own CUDA runtime: select the caller's device
  // in it before launching on the caller's stream
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  const int m = pixels(bsz, h, wd, kdim, n);
  if (m < 0 || transform < 0 || transform > 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: fwd_dispatch<float>(transform, want_stats, x, w, a, b, y, part, stats, m, h, wd, kdim, n, s); break;
    case kBF16: fwd_dispatch<__nv_bfloat16>(transform, want_stats, x, w, a, b, y, part, stats, m, h, wd, kdim, n, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dy [bsz, h, wd, n], dx and x [bsz, h, wd, kdim];
// part: f32 scratch [ceil(M / 128), 2, kdim] (transform), dstats: f32 [2, kdim].
extern "C" int port_k5_dx(const void* dy, const void* w, const void* x, const void* a,
                          const void* b, void* dx, void* part, void* dstats, int bsz, int h,
                          int wd, int kdim, int n, int transform, int dtype, int device,
                          void* stream) {
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  const int m = pixels(bsz, h, wd, kdim, n);
  if (m < 0 || transform < 0 || transform > 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K5_DX(T)                                                                                      \
  (transform == 0   ? dx_launch<T, false, false>(dy, w, x, a, b, dx, part, dstats, m, h, wd, kdim, n, s) \
   : transform == 1 ? dx_launch<T, true, false>(dy, w, x, a, b, dx, part, dstats, m, h, wd, kdim, n, s)  \
                    : dx_launch<T, true, true>(dy, w, x, a, b, dx, part, dstats, m, h, wd, kdim, n, s))
  switch (dtype) {
    case kF32: K5_DX(float); break;
    case kBF16: K5_DX(__nv_bfloat16); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K5_DX
  return static_cast<int>(cudaGetLastError());
}

// part: f32 scratch [splits, 3, 3, kdim, n]; split z sums pixels
// [z*chunk, (z+1)*chunk); dw [3, 3, kdim, n] in the operands' dtype.
extern "C" int port_k5_dw(const void* x, const void* dy, const void* a, const void* b,
                          void* part, void* dw, int bsz, int h, int wd, int kdim, int n,
                          int transform, int splits, int chunk, int dtype, int device,
                          void* stream) {
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  const int m = pixels(bsz, h, wd, kdim, n);
  if (m < 0 || transform < 0 || transform > 2 || splits <= 0 || chunk <= 0 ||
      chunk % kBK != 0 || static_cast<long long>(splits) * chunk < m ||
      static_cast<long long>(splits - 1) * chunk >= m || kTaps * splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K5_DW(T)                                                                                       \
  (transform == 0   ? dw_launch<T, false, false>(x, dy, a, b, part, dw, m, h, wd, kdim, n, splits, chunk, s) \
   : transform == 1 ? dw_launch<T, true, false>(x, dy, a, b, part, dw, m, h, wd, kdim, n, splits, chunk, s)  \
                    : dw_launch<T, true, true>(x, dy, a, b, part, dw, m, h, wd, kdim, n, splits, chunk, s))
  switch (dtype) {
    case kF32: K5_DW(float); break;
    case kBF16: K5_DW(__nv_bfloat16); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K5_DW
  return static_cast<int>(cudaGetLastError());
}
