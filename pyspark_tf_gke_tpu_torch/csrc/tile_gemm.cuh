// The tiled f32 GEMM pieces shared by the fused conv+BN kernels, K4
// (fused_matmul.cu, the 1x1 convs) and K5 (fused_conv3.cu, the 3x3 conv):
// a block owns a kBM x kBN output tile (256 threads, kTM x kTN outputs
// each) and walks the reduction in steps of kBK, both operand tiles staged
// in shared memory as f32, reduction-major. Column partials go out as one
// row per tile and are summed in order by colsum_kernel; reductions split
// across blocks go out as f32 partials summed in order by splitsum_kernel.
// No atomics: every result is independent of scheduling. The kernels and
// their launchers are static, so each source that includes this gets its
// own copy.
#pragma once

#include "common.cuh"

namespace port {
namespace tile {

constexpr int kBM = 128;  // output tile rows (kept in step with ops/fused_matmul.py)
constexpr int kBN = 64;   // output tile columns
constexpr int kBK = 16;   // reduction step
constexpr int kTM = 8;    // outputs per thread: rows
constexpr int kTN = 4;    //                     columns
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kPad = 4;   // keeps rows 16-byte aligned for float4 reads

static_assert(kThreads == 256, "tile shape");

enum Chan { kNoTransform = 0, kChanIsRed = 1, kChanIsRow = 2 };

// The BatchNorm input transform relu(v*a + b) (relu optional), x*a then
// + b each rounded (no fused multiply-add, as the plain versions compute
// it, so the relu mask agrees with them bit for bit), rounded to T.
template <typename T, bool kRelu>
__device__ __forceinline__ float norm_transform(float v, float a, float b) {
  float t = __fadd_rn(__fmul_rn(v, a), b);
  if (kRelu) t = fmaxf(t, 0.f);
  return round_through<T>(t);
}

// Stage one operand tile as dst[kk][r] (reduction-major, f32) from a
// row-major global matrix. The tile covers tile rows [row0, row0 + ROWS)
// and reduction indices [red0, red0 + kBK). kRedContig: the reduction
// index is the global matrix's contiguous axis (src[row * ld + red]),
// else the tile-row index is (src[red * ld + row]). kChan says which of
// the two indexes the transform's channel (a, b); out-of-range elements
// are 0.
template <typename T, int ROWS, bool kRedContig, int kChan, bool kRelu>
__device__ __forceinline__ void stage(float (*dst)[ROWS + kPad], const T* __restrict__ src,
                                      long long ld, int row0, int nrows, int red0,
                                      int nred, const float* __restrict__ a,
                                      const float* __restrict__ b) {
#pragma unroll
  for (int i = 0; i < ROWS * kBK / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = kRedContig ? idx / kBK : idx % ROWS;
    const int kk = kRedContig ? idx % kBK : idx / ROWS;
    const int gr = row0 + r, gk = red0 + kk;
    float v = 0.f;
    if (gr < nrows && gk < nred) {
      const long long off = kRedContig ? static_cast<long long>(gr) * ld + gk
                                       : static_cast<long long>(gk) * ld + gr;
      v = to_f32(src[off]);
      if (kChan != kNoTransform) {
        const int c = kChan == kChanIsRed ? gk : gr;
        v = norm_transform<T, kRelu>(v, a[c], b[c]);
      }
    }
    dst[kk][r] = v;
  }
}

// acc[i][j] += sum_kk As[kk][ty*kTM + i] * Bs[kk][tx*kTN + j]
__device__ __forceinline__ void tile_product(float (*As)[kBM + kPad],
                                             float (*Bs)[kBN + kPad],
                                             float (&acc)[kTM][kTN], int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * kTM]);
    const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * kTM + 4]);
    const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * kTN]);
    const float av[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bw[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
  }
}

// Column partials of one tile: s0/s1 hold each thread's sums over its kTM
// rows; add the 16 row-groups in order and write row `tile` of the
// [tiles, 2, ncols] partials.
__device__ __forceinline__ void write_col_partials(float (*red)[kBN], const float (&s0)[kTN],
                                                   const float (&s1)[kTN], int ty, int tx,
                                                   float* __restrict__ part, int tile,
                                                   int col0, int ncols) {
  constexpr int kGroups = kBM / kTM;  // 16
  float(*r0)[kBN] = red;
  float(*r1)[kBN] = red + kGroups;
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    r0[ty][tx * kTN + j] = s0[j];
    r1[ty][tx * kTN + j] = s1[j];
  }
  __syncthreads();
  if (threadIdx.x < kBN) {
    const int c = threadIdx.x;
    float t0 = 0.f, t1 = 0.f;
    for (int g = 0; g < kGroups; ++g) {
      t0 += r0[g][c];
      t1 += r1[g][c];
    }
    if (col0 + c < ncols) {
      float* row = part + static_cast<long long>(tile) * 2 * ncols;
      row[col0 + c] = t0;
      row[ncols + col0 + c] = t1;
    }
  }
}

// out[c] = sum over rows r of in[r, c], rows in order per thread and a
// fixed tree across the block: one block per column.
static __global__ void __launch_bounds__(256)
colsum_kernel(const float* __restrict__ in, int rows, int cols, float* __restrict__ out) {
  __shared__ float buf[256];
  const int c = blockIdx.x;
  float s = 0.f;
  for (int r = threadIdx.x; r < rows; r += 256) s += in[static_cast<long long>(r) * cols + c];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int half = 128; half > 0; half >>= 1) {
    if (threadIdx.x < half) buf[threadIdx.x] += buf[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[c] = buf[0];
}

// out[i] = round_T(sum over splits s, in order, of part[s, i])
template <typename T>
static __global__ void __launch_bounds__(256)
splitsum_kernel(const float* __restrict__ part, int splits, long long count, T* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[z * count + i];
  out[i] = from_f32<T>(s);
}

static inline dim3 tiles(int rows, int cols, int z = 1) {
  return dim3((rows + kBM - 1) / kBM, (cols + kBN - 1) / kBN, z);
}

// Launch colsum_kernel over [rows, cols] partials (rows = tiles).
static inline void colsum(const void* part, int rows, int cols, void* out, cudaStream_t s) {
  colsum_kernel<<<cols, 256, 0, s>>>(static_cast<const float*>(part), rows, cols,
                                     static_cast<float*>(out));
}

// Launch splitsum_kernel: out[i] = round_T(sum_s part[s, i]), i < count.
template <typename T>
static void splitsum(const void* part, int splits, long long count, void* out, cudaStream_t s) {
  splitsum_kernel<T><<<static_cast<unsigned>((count + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part), splits, count, static_cast<T*>(out));
}

}  // namespace tile
}  // namespace port
