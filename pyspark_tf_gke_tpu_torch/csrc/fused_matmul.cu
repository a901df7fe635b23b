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
// calls are bound by operations.
//
// K4dw's entry point chooses the design by dtype and nothing else. bf16
// K4dw (k4_dw_wgmma, the tensor-core design) runs the weight-gradient
// mainloop of wgmma_dw.cuh: a CTA owns a (64 a) x (64 b) tile of dw, a,
// b in {1, 2} (64 wide where K or N is at most 64: no half-empty tile at
// stage 1), one warpgroup per 64 x 64 part, and a split of the M rows;
// x [M, K] and dy [M, N] arrive by 2-D TMA, 64 rows a step, into a
// 4-slot mbarrier ring (zeros past M and past K, N), the transform runs
// in place on the x tiles, and both operands feed wgmma MN-major. The
// splits write f32 partials [splits, K, N], summed in split order by
// splitsum_kernel. K or N not a multiple of 8, or a pointer off 16
// bytes, takes a masked edge path of the same kernel that copies
// element by element.
//
// K4f, K4dx, and K4dw in f32 (the first, CUDA-core design; f32 K4dw is
// kept as the reference the model-parity gates stand on) compute the
// product on the CUDA cores in f32, bound by f32 FMA throughput well
// above either bound.
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

#include <climits>

#include "tile_gemm.cuh"
#include "wgmma_dw.cuh"

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

// -- K4dw, bf16: the tensor-core design -----------------------------------------

namespace wgdw {

using namespace port::hopper;

constexpr int kTile = 64;  // a warpgroup's dw tile, K x N (ops/fused_matmul.py DW_WG_TILE)

// CTAs an SM holds for 1, 2 or 4 warpgroups a CTA: what the ring's 4
// slots of 16, 24 or 32 KB and the registers allow (ops/fused_matmul.py
// DW_RESIDENT, which sizes the plan's waves by them)
constexpr int kResident1 = 3;
constexpr int kResident2 = 2;
constexpr int kResident4 = 1;

// CTA tile (64 * kA) x (64 * kB) of dw, warpgroup g = (g / kB, g % kB);
// kA and kB are the plan's (ops/fused_matmul.py dw_plan).
// kVec: K and N multiples of 8 and x, dy 16-byte aligned: both operands
// by TMA; else the edge path copies element by element.
template <int kA, int kB, bool kTransform, bool kRelu, bool kVec>
__global__ void __launch_bounds__(128 * kA * kB, kA * kB == 1   ? kResident1
                                                 : kA * kB == 2 ? kResident2
                                                                : kResident4)
k4_dw_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
            const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
            const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ part,
            int m, int kdim, int n, int chunk) {
  using R = dw::Ring<kA, kB>;
  extern __shared__ uint8_t smem_raw[];
  const R ring(smem_raw);
  const int ntk = (kdim + kTile * kA - 1) / (kTile * kA);
  const int ntn = (n + kTile * kB - 1) / (kTile * kB);
  const int tile = blockIdx.x % (ntk * ntn), split = blockIdx.x / (ntk * ntn);
  const int k0 = (tile / ntn) * kTile * kA, n0 = (tile % ntn) * kTile * kB;
  const int mbeg = split * chunk, mend = min(mbeg + chunk, m);
  const int nsteps = (mend - mbeg + dw::kPix - 1) / dw::kPix;
  const int g = threadIdx.x >> 7, ai = g / kB, bj = g % kB;
  dw::setup(ring, a, b, k0, kdim, kTransform);

  auto issue = [&](int s) {
    if (s >= nsteps) return;
    uint8_t* stage = ring.slot(s);
    const int row0 = mbeg + s * dw::kPix;
    if (kVec) {
      if (threadIdx.x == 0) {
        uint64_t* bar = ring.bar(s);
        mbar_arrive_expect_tx(bar, R::kStageBytes);
#pragma unroll
        for (int i = 0; i < kA; ++i)
          tma_load_2d(stage + i * dw::kTileBytes, &tx, bar, k0 + kTile * i, row0);
#pragma unroll
        for (int j = 0; j < kB; ++j)
          tma_load_2d(stage + (kA + j) * dw::kTileBytes, &tdy, bar, n0 + kTile * j, row0);
      }
    } else {
      for (int idx = threadIdx.x; idx < R::kTiles * dw::kChunks; idx += blockDim.x) {
        const int t = idx / dw::kChunks, r = (idx % dw::kChunks) >> 3, c = idx & 7;
        const bool is_x = t < kA;
        const int col = is_x ? k0 + kTile * t + 8 * c : n0 + kTile * (t - kA) + 8 * c;
        dw::copy_chunk_elems(stage + t * dw::kTileBytes + sw128(r, c), is_x ? x : dy, row0 + r,
                             row0 + r < mend, col, is_x ? kdim : n, is_x ? kdim : n);
      }
    }
  };
  auto landed = [&](int s) {
    if (kVec) mbar_wait(ring.bar(s), ring.phase(s));
  };
  auto prepare = [&](uint8_t* stage) {
    if (kTransform) dw::transform<kRelu>(stage, ring);
  };
  float sum[32];
  dw::mainloop(sum, ring, nsteps, ai, bj, issue, landed, prepare);
  dw::store(sum, part + static_cast<long long>(split) * kdim * n, k0 + kTile * ai, kdim,
            n0 + kTile * bj, n);
}

template <int kA, int kB, bool kTransform, bool kRelu, bool kVec>
cudaError_t launch(const CUtensorMap& tx, const CUtensorMap& tdy, const void* x, const void* dy,
                   const void* a, const void* b, void* part, int m, int kdim, int n, int splits,
                   int chunk, cudaStream_t s) {
  auto kernel = k4_dw_wgmma<kA, kB, kTransform, kRelu, kVec>;
  constexpr int kSmem = dw::Ring<kA, kB>::kSmem;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>((kdim + kTile * kA - 1) / (kTile * kA)) *
                          ((n + kTile * kB - 1) / (kTile * kB));
  if (tiles * splits > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(tiles * splits), 128 * kA * kB, kSmem, s>>>(
      tx, tdy, static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(part), m,
      kdim, n, chunk);
  return cudaGetLastError();
}

template <int kA, int kB, bool kVec>
cudaError_t dispatch_modes(int transform, const CUtensorMap& tx, const CUtensorMap& tdy,
                           const void* x, const void* dy, const void* a, const void* b,
                           void* part, int m, int kdim, int n, int splits, int chunk,
                           cudaStream_t s) {
#define K4_WG(TR, RE) \
  launch<kA, kB, TR, RE, kVec>(tx, tdy, x, dy, a, b, part, m, kdim, n, splits, chunk, s)
  if (transform == 0) return K4_WG(false, false);
  if (transform == 1) return K4_WG(true, false);
  return K4_WG(true, true);
#undef K4_WG
}

// tk, tn: the CTA tile in warpgroup tiles along K and N, 1 or 2 each
template <bool kVec>
cudaError_t dispatch_tiles(int tk, int tn, int transform, const CUtensorMap& tx,
                           const CUtensorMap& tdy, const void* x, const void* dy, const void* a,
                           const void* b, void* part, int m, int kdim, int n, int splits,
                           int chunk, cudaStream_t s) {
#define K4_TILE(A, B) \
  dispatch_modes<A, B, kVec>(transform, tx, tdy, x, dy, a, b, part, m, kdim, n, splits, chunk, s)
  if (tk == 2) return tn == 2 ? K4_TILE(2, 2) : K4_TILE(2, 1);
  return tn == 2 ? K4_TILE(1, 2) : K4_TILE(1, 1);
#undef K4_TILE
}

// part: f32 [splits, kdim, n]; the result rounded to bf16 by splitsum
cudaError_t run(int tk, int tn, int transform, const void* x, const void* dy, const void* a,
                const void* b, void* part, void* out, int m, int kdim, int n, int splits,
                int chunk, cudaStream_t s) {
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool vec = kdim % 8 == 0 && n % 8 == 0 && aligned(x) && aligned(dy);
  CUtensorMap tx{}, tdy{};
  if (vec) {
    const EncodeTiled encode = tensor_map_encoder();
    if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
    if (!tensor_map_2d(encode, &tx, x, m, kdim, dw::kPix) ||
        !tensor_map_2d(encode, &tdy, dy, m, n, dw::kPix)) {
      return cudaErrorInvalidValue;
    }
  }
  const cudaError_t err =
      vec ? dispatch_tiles<true>(tk, tn, transform, tx, tdy, x, dy, a, b, part, m, kdim, n,
                                 splits, chunk, s)
          : dispatch_tiles<false>(tk, tn, transform, tx, tdy, x, dy, a, b, part, m, kdim, n,
                                  splits, chunk, s);
  if (err != cudaSuccess) return err;
  splitsum<__nv_bfloat16>(part, splits, static_cast<long long>(kdim) * n, out, s);
  return cudaGetLastError();
}

}  // namespace wgdw

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

// part: f32 scratch [splits, kdim, n]; split z sums rows [z*chunk, (z+1)*chunk),
// chunk a multiple of 16 rows (f32) or of 64 (bf16); tk, tn: bf16's CTA
// tile in 64 x 64 warpgroup tiles along K and N, 1 or 2 each, unused in
// f32 (both from ops/fused_matmul.py dw_plan).
extern "C" int port_k4_dw(const void* x, const void* dy, const void* a, const void* b,
                          void* part, void* dw, int m, int kdim, int n, int transform,
                          int splits, int chunk, int tk, int tn, int dtype, int device,
                          void* stream) {
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  const int step = dtype == kBF16 ? port::dw::kPix : kBK;
  if (!shape_ok(m, kdim, n) || transform < 0 || transform > 2 || splits <= 0 ||
      chunk <= 0 || chunk % step != 0 || static_cast<long long>(splits) * chunk < m ||
      static_cast<long long>(splits - 1) * chunk >= m ||
      (dtype == kBF16 ? tk < 1 || tk > 2 || tn < 1 || tn > 2 : splits > 65535)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      if (transform == 0) dw_launch<float, false, false>(x, dy, a, b, part, dw, m, kdim, n, splits, chunk, s);
      else if (transform == 1) dw_launch<float, true, false>(x, dy, a, b, part, dw, m, kdim, n, splits, chunk, s);
      else dw_launch<float, true, true>(x, dy, a, b, part, dw, m, kdim, n, splits, chunk, s);
      break;
    case kBF16:
      return static_cast<int>(wgdw::run(tk, tn, transform, x, dy, a, b, part, dw, m, kdim, n,
                                        splits, chunk, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
