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
// even at stage 1, operations beyond it.
//
// K5f's entry point chooses the design by dtype and nothing else.
//
// K5f bf16 (wg::k5_fwd_wgmma, the tensor-core design): an implicit GEMM
// over output pixels on two warpgroups (m64n64 each), a CTA owning 128
// pixels x 64 output channels where N <= 64 and 64 pixels x 128 channels
// beyond (ResNet-50's stages 2-4: every A element is transformed once for
// 128 outputs; stage 4 still gets 196 CTAs). The reduction walks 9 taps x K in steps of 64
// channels through a 4-stage shared-memory ring, the copies two steps
// ahead of the products. A (pixels x channels, K-major) and B (w[tap]
// rows, N contiguous: MN-major, read through the transpose bit) arrive
// by cp.async into 128-byte swizzled tiles; a tap-shifted pixel off its
// image (the next row, the next image, past M) or a channel past K is
// filled with zeros. Each thread then applies the transform in place to
// the A chunks it copied (bf16 -> f32, x*a then + b each rounded, relu,
// rounded to bf16), leaving the off-image chunks 0 — the padding comes
// after the transform, so TMA alone cannot do this — and fences the
// async proxy before the barrier that hands the stage to wgmma (four
// m64n64k16 steps, f32 accumulators). Each tap's products accumulate in
// a fresh wgmma accumulator and the nine tap sums are added in tap order
// in f32 registers, the structure of the plain version (nine products,
// summed in order): chained through all 9*K/16 steps, the tensor core's
// accumulation left 3-10x more y elements a bf16 rounding away from an
// f64 reference than the plain version does (PERF.md), at no gain
// in time. Each row's image coordinates are
// computed once a block. The epilogue rounds y to bf16 once and writes
// one row of per-channel partials of the rounded y and y^2 per tile
// (quad shuffles, then the 8 warps in order), summed in tile order by
// colsum_kernel. K and N not multiples of 8, or unaligned tensors, take
// a masked edge path of the same kernel that loads element by element.
//
// K5dx's entry point chooses the design by dtype too. K5dx bf16
// (wgdx::k5_dx_wgmma, the tensor-core design) is K4dx's design (PR 7,
// fused_matmul.cu wg::) with the taps added: persistent CTAs, one an SM,
// of two consumer warpgroups and a producer warpgroup that gives them
// its registers (setmaxnreg); its first thread brings each step's
// operands by TMA into a 3-slot mbarrier ring. A step is one tap's 64
// channels of N: A is dy at the flipped tap, brought as ONE 4-D box over
// [B, H, W, N] at the tap's offset — the pixel tile is whole image rows
// (nb images x rows x wc columns, at most 128 pixels: two rows at W =
// 56, four at 28, nine at 14, two images at 7; ops/fused_conv3.py
// k5dx_plan), so the
// box's out-of-bounds zeros are exactly the SAME padding and no thread
// computes an address (dy is not transformed, unlike K5f's A). B is
// w[tap] rows k, N contiguous: K-major, a 3-D box over [9, K, N]. Each
// step's products go into a fresh wgmma accumulator added to the f32
// sum in step order, the structure of the plain version's nine f32
// products summed in order, one step finer.
// The epilogue is K4dx's: x arrives by TMA into the output tile a tile
// ahead (three output buffers), the relu mask x*a + b > 0, dx = u*a
// rounded once and written over x by a 4-D TMA store (rows off the
// image dropped), one row of d a / d b partials a pixel tile, summed in
// order by colsum_kernel. A tile of whole rows leaves 16 of 128 rows
// idle at W = 56 and 28 and 30 at 14 and 7. K or N not a multiple of 8,
// or a pointer off 16 bytes, takes a masked edge path of the same
// kernel: the producer warpgroup gathers element by element.
//
// K5dw's entry point chooses the design by dtype too. K5dw bf16
// (wgdw::k5_dw_wgmma, the tensor-core design) moves the tap shift onto
// dy: dw[tap] = sum over x pixels q of xn[q]^T dy[q - shift(tap)], a
// term counting only where that dy pixel lies in q's image at the tap's
// offset. A CTA owns one 64 x 64 (K x N) tile of the three taps of one
// kernel row and a split of the pixels, on three warpgroups, one a tap
// (wgmma_dw.cuh's mainloop): each step brings 64 consecutive pixels of x
// by TMA, transforms them in place once for the three taps, and gathers
// each tap's 64 dy rows by cp.async, zero-filling rows whose pixel is
// off the image or past the split (src_bytes 0; each thread keeps its
// rows' image coordinates and steps them, no divisions in the loop). x
// is transformed 3 times in all (once a kernel row) instead of 9, and a
// 64-wide tile leaves no half of it empty at K = 64. f32 partials
// [splits, 3, 3, K, N] summed in split order by splitsum_kernel. K or N
// not a multiple of 8, or a pointer off 16 bytes, takes a masked edge
// path of the same kernel that copies element by element.
//
// K5f, K5dx and K5dw f32 (the first, CUDA-core design, kept for f32
// as the reference the model-parity gates stand on): an implicit GEMM on
// K4's tiled f32 CUDA-core mainloop (tile_gemm.cuh). The TPU kernels keep one whole
// zero-padded image in VMEM (grid = (B,)); at stage 1 that is 58x58x64
// bf16, more than an SM's shared memory, so here a block owns a tile of
// 128 output pixels x 64 channels, which may cross image rows and
// images. For each of the nine taps the block stages the shifted input
// pixels of its tile (the transform applied while staging, out-of-image
// taps set to 0) and that tap's weights, and accumulates; each row's
// image coordinates are computed once per block. K5f and K5dx write one
// row of per-channel partials per tile, summed in tile order by
// colsum_kernel. K5dw owns a K x N tile of one tap and a split of the
// pixels (grid z = split * 9 + tap): f32 partials [splits, 3, 3, K, N]
// summed in order and rounded by splitsum_kernel. No atomics: every
// result is independent of scheduling.

#include <climits>

#include "tile_gemm.cuh"
#include "wgmma.cuh"
#include "wgmma_dw.cuh"

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

// -- K5f, bf16: the tensor-core design ----------------------------------------

namespace wg {

using namespace port::hopper;

// Two CTA tiles on two warpgroups (kept in step with ops/fused_conv3.py
// K5F_TILES): N <= 64 takes 128 pixels x 64 channels (a warpgroup a
// 64-pixel half, one B tile); wider N takes 64 pixels x 128 channels (a
// warpgroup a 64-channel half of B, one A tile), which transforms and
// reads each A element once for 128 output channels instead of 64.
constexpr int kBM = 128;     // narrow: N <= 64
constexpr int kBN = 64;
constexpr int kWideBM = 64;  // wide: N > 64
constexpr int kWideBN = 128;
constexpr int kBK = 64;     // input channels per reduction step: one 128-byte swizzle row
constexpr int kStages = 4;  // ring depth
constexpr int kAhead = 2;   // steps whose copies are in flight ahead of the products
constexpr int kThreads = 256;
constexpr int kStageBytes = kBM * 128 + kBK * kBN * 2;  // A + B, the same for both tiles
static_assert(kStageBytes == kWideBM * 128 + kBK * kWideBN * 2, "tile bytes");
constexpr int kRedOffset = kStages * kStageBytes;
// 1024 of slack to align the swizzled tiles, the ring, then the
// statistics' per-warp column sums [2][8 warps][64]
constexpr int kSmem = 1024 + kRedOffset + 2 * 8 * 64 * 4;

static_assert(kStages >= kAhead + 2, "a stage is refilled only after its products finished");

// kVec: K and N are multiples of 8 and x, w, y (a, b) 16-byte aligned, so that
// every 16-byte chunk of a row is wholly in or out and moves by cp.async;
// else the masked edge path loads element by element.
template <bool kWide, bool kTransform, bool kRelu, bool kStats, bool kVec>
__global__ void __launch_bounds__(kThreads)
k5_fwd_wgmma(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
             const float* __restrict__ a, const float* __restrict__ b,
             __nv_bfloat16* __restrict__ y, float* __restrict__ part, int m, int h, int wd,
             int kdim, int n) {
  constexpr int BM = kWide ? kWideBM : kBM, BN = kWide ? kWideBN : kBN;
  constexpr int kARows = BM / 32;        // A rows a thread copies
  constexpr int kBChunks = BN / 32;      // B chunks a thread copies (64 k rows x BN/8)
  constexpr int kABytes = BM * 128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* red = reinterpret_cast<float*>(smem + kRedOffset);

  const int t = threadIdx.x, g = t >> 7, warp = t >> 5, lane = t & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // copy assignment: A rows ar + 32i and B rows ar + 32(i%2) of 64-column
  // atom i/2, each at the 16-byte chunk ac (8 channels)
  const int ar = t >> 3, ac = t & 7;
  // image coordinates of the thread's A rows, once a block; kFar past m,
  // so that every tap of such a row falls outside the image
  int ri[kARows], rj[kARows];
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    const int p = m0 + ar + 32 * i;
    const int q = p % (h * wd);
    ri[i] = p < m ? q / wd : kFar;
    rj[i] = p < m ? q % wd : kFar;
  }
  const int kchunks = (kdim + kBK - 1) / kBK;
  const int nsteps = kTaps * kchunks;

  auto in_image = [&](int i, int di, int dj) {
    const int ii = ri[i] + di, jj = rj[i] + dj;
    return ii >= 0 && ii < h && jj >= 0 && jj < wd;
  };
  // step s = (tap, 64-channel chunk): raw x at the tap-shifted pixels
  // into A (zeros off the image), w[tap] rows into B (zeros past K, N)
  auto copy_step = [&](int s) {
    const int tap = s / kchunks, k0 = (s % kchunks) * kBK;
    const int di = tap / 3 - 1, dj = tap % 3 - 1;
    uint8_t* A = smem + (s % kStages) * kStageBytes;
    uint8_t* B = A + kABytes;
    const int c = k0 + ac * 8;
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      const int row = ar + 32 * i;
      const bool ok = c < kdim && in_image(i, di, dj);
      const __nv_bfloat16* src = x + (static_cast<long long>(m0 + row) + di * wd + dj) * kdim + c;
      if (kVec) {
        cp_async16(smem_u32(A) + sw128(row, ac), ok ? src : x, ok ? 16 : 0);
      } else {
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = (ok && c + e < kdim) ? src[e] : __float2bfloat16(0.f);
        *reinterpret_cast<uint4*>(A + sw128(row, ac)) = *reinterpret_cast<const uint4*>(v);
      }
    }
#pragma unroll
    for (int i = 0; i < kBChunks; ++i) {
      const int kr = ar + 32 * (i % 2), atom = i / 2;
      const int col = n0 + atom * 64 + ac * 8;
      const bool ok = k0 + kr < kdim && col < n;
      const __nv_bfloat16* src = w + (static_cast<long long>(tap) * kdim + k0 + kr) * n + col;
      uint8_t* dst = B + atom * kBK * 128 + sw128(kr, ac);
      if (kVec) {
        cp_async16(smem_u32(dst), ok ? src : w, ok ? 16 : 0);
      } else {
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = (ok && col + e < n) ? src[e] : __float2bfloat16(0.f);
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
      }
    }
  };
  // a, b of the thread's 8 channels of step s, loaded a step ahead of
  // the transform that reads them
  float av[8], bv[8];
  auto load_ab = [&](int s) {
    const int c = (s % kchunks) * kBK + ac * 8;
    if (kVec && c < kdim) {
      const float4* pa = reinterpret_cast<const float4*>(a + c);
      const float4* pb = reinterpret_cast<const float4*>(b + c);
      const float4 a0 = pa[0], a1 = pa[1], b0 = pb[0], b1 = pb[1];
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool in = c + e < kdim;
        av[e] = in ? a[c + e] : 0.f;
        bv[e] = in ? b[c + e] : 0.f;
      }
    }
  };
  // the input transform, in place on the thread's own A chunks of step
  // s; chunks off the image stay 0 (the padding comes after the transform)
  auto transform = [&](int s) {
    const int tap = s / kchunks, k0 = (s % kchunks) * kBK;
    const int di = tap / 3 - 1, dj = tap % 3 - 1;
    const int c = k0 + ac * 8;
    if (c >= kdim) return;
    uint8_t* A = smem + (s % kStages) * kStageBytes;
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      if (!in_image(i, di, dj)) continue;
      uint4* chunk = reinterpret_cast<uint4*>(A + sw128(ar + 32 * i, ac));
      uint4 raw = *chunk;
      __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // norm_transform's arithmetic (x*a, + b, each rounded; relu),
        // rounded to bf16 once, two channels a conversion
        const float2 xf = __bfloat1622float2(v[e]);
        float t0 = __fadd_rn(__fmul_rn(xf.x, av[2 * e]), bv[2 * e]);
        float t1 = __fadd_rn(__fmul_rn(xf.y, av[2 * e + 1]), bv[2 * e + 1]);
        if (kRelu) {
          t0 = fmaxf(t0, 0.f);
          t1 = fmaxf(t1, 0.f);
        }
        if (!kVec) {  // channels past K stay 0
          t0 = c + 2 * e < kdim ? t0 : 0.f;
          t1 = c + 2 * e + 1 < kdim ? t1 : 0.f;
        }
        v[e] = __floats2bfloat162_rn(t0, t1);
      }
      *chunk = raw;
    }
  };

  // acc: the current tap's products; sum: the taps' sums in tap order
  float acc[32], sum[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = sum[i] = 0.f;
  auto add_tap = [&] {
    wgmma_wait<0>();
    fence_operand(acc);
#pragma unroll
    for (int i = 0; i < 32; ++i) sum[i] += acc[i];
  };
  if (kTransform) load_ab(0);
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < nsteps) copy_step(s);
    cp_async_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<kAhead - 1>();  // this thread's copies of step s have landed
    if (kTransform) transform(s);  // while step s-1's products run
    if (s > 0 && s % kchunks == 0) add_tap();  // step s-1 ended a tap
    fence_proxy_async();  // this thread's shared-memory writes before the products' reads
    __syncthreads();      // every thread's; and step s-2's products are done
    if (s + kAhead < nsteps) copy_step(s + kAhead);
    cp_async_commit();
    if (kTransform && s + 1 < nsteps) load_ab(s + 1);
    // narrow: the warpgroup's 64 pixels, all of B; wide: all of A, the
    // warpgroup's 64-column atom of B
    const uint8_t* stage = smem + (s % kStages) * kStageBytes;
    const uint32_t a_addr = smem_u32(stage) + (kWide ? 0 : g * 64 * 128);
    const uint32_t b_addr = smem_u32(stage + kABytes) + (kWide ? g * kBK * 128 : 0);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_ss<1>(acc, desc_kmajor(a_addr + kk * 32), desc_mnmajor(b_addr + kk * 2048),
                            (s % kchunks == 0 && kk == 0) ? 0 : 1);  // a tap starts at 0
    wgmma_commit();
    wgmma_wait<1>();  // step s-1's products are done
  }
  add_tap();  // the last tap

  // epilogue: y rounded once; statistics of the rounded y
  const int row_a = m0 + (kWide ? 0 : 64 * g) + 16 * (warp & 3) + (lane >> 2);
  const int col0 = n0 + (kWide ? 64 * g : 0);
  float s0[16], s1[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) s0[j] = s1[j] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= m) continue;
    __nv_bfloat16* yrow = y + static_cast<long long>(row) * n;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + j * 8 + 2 * (lane & 3);
      const __nv_bfloat162 v = __floats2bfloat162_rn(sum[j * 4 + 2 * r], sum[j * 4 + 2 * r + 1]);
      if (kVec) {
        if (col < n) *reinterpret_cast<__nv_bfloat162*>(yrow + col) = v;
      } else {
        if (col < n) yrow[col] = v.x;
        if (col + 1 < n) yrow[col + 1] = v.y;
      }
      const float v0 = __bfloat162float(v.x), v1 = __bfloat162float(v.y);
      s0[2 * j] += v0;
      s1[2 * j] += v0 * v0;
      s0[2 * j + 1] += v1;
      s1[2 * j + 1] += v1 * v1;
    }
  }
  if (kStats) {
    // over the 8 row groups of the warp (lanes of one lane % 4), then
    // over the warps that hold the column, in order: one row of partials
    // per tile of BM pixels
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0[j] += __shfl_xor_sync(0xffffffffu, s0[j], o);
        s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], o);
      }
    }
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = (j / 2) * 8 + 2 * lane + (j % 2);  // the warpgroup's column
        red[warp * 64 + c] = s0[j];
        red[(8 + warp) * 64 + c] = s1[j];
      }
    }
    __syncthreads();
    if (t < BN && n0 + t < n) {
      const int c = t % 64, v0 = kWide ? 4 * (t / 64) : 0, v1 = kWide ? v0 + 4 : 8;
      float t0 = 0.f, t1 = 0.f;
      for (int v = v0; v < v1; ++v) {
        t0 += red[v * 64 + c];
        t1 += red[(8 + v) * 64 + c];
      }
      float* prow = part + static_cast<long long>(blockIdx.x) * 2 * n;
      prow[n0 + t] = t0;
      prow[n + n0 + t] = t1;
    }
  }
}

template <bool kWide, bool kTransform, bool kRelu, bool kStats, bool kVec>
cudaError_t launch(const void* x, const void* w, const void* a, const void* b, void* y,
                   void* part, void* stats, int m, int h, int wd, int kdim, int n,
                   cudaStream_t s) {
  constexpr int BM = kWide ? kWideBM : kBM, BN = kWide ? kWideBN : kBN;
  auto kernel = k5_fwd_wgmma<kWide, kTransform, kRelu, kStats, kVec>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  kernel<<<grid, kThreads, kSmem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(part), m, h, wd, kdim, n);
  if (kStats) colsum(part, grid.x, 2 * n, stats, s);
  return cudaGetLastError();
}

template <bool kWide, bool kVec>
cudaError_t dispatch_modes(int transform, int want_stats, const void* x, const void* w,
                           const void* a, const void* b, void* y, void* part, void* stats,
                           int m, int h, int wd, int kdim, int n, cudaStream_t s) {
#define K5_WG(TR, RE)                                                                           \
  (want_stats                                                                                   \
       ? launch<kWide, TR, RE, true, kVec>(x, w, a, b, y, part, stats, m, h, wd, kdim, n, s)  \
       : launch<kWide, TR, RE, false, kVec>(x, w, a, b, y, part, stats, m, h, wd, kdim, n, s))
  if (transform == 0) return K5_WG(false, false);
  if (transform == 1) return K5_WG(true, false);
  return K5_WG(true, true);
#undef K5_WG
}

// part: [ceil(M / BM), 2, n] for the tile that N selects (kBM for N <=
// kBN, else kWideBM)
cudaError_t dispatch(int transform, int want_stats, const void* x, const void* w, const void* a,
                     const void* b, void* y, void* part, void* stats, int m, int h, int wd,
                     int kdim, int n, cudaStream_t s) {
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool vec = kdim % 8 == 0 && n % 8 == 0 && aligned(x) && aligned(w) && aligned(y) &&
                   (transform == 0 || (aligned(a) && aligned(b)));
#define K5_WG_TILE(WIDE)                                                                     \
  (vec ? dispatch_modes<WIDE, true>(transform, want_stats, x, w, a, b, y, part, stats, m, h, \
                                    wd, kdim, n, s)                                          \
       : dispatch_modes<WIDE, false>(transform, want_stats, x, w, a, b, y, part, stats, m, h, \
                                     wd, kdim, n, s))
  return n > kBN ? K5_WG_TILE(true) : K5_WG_TILE(false);
#undef K5_WG_TILE
}

}  // namespace wg

// -- K5dx, bf16: the tensor-core design ----------------------------------------

namespace wgdx {

using namespace port::hopper;

constexpr int kBM = 128;         // pixel rows of a CTA tile (two warpgroups of 64), at most
constexpr int kBK = 64;          // reduction (N) a step: one 128-byte swizzle row
constexpr int kConsumers = 256;  // two warpgroups, 64 rows each
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
// registers a thread after the move (launched at 65536 / 384 = 168)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(kProducerRegs * 128 + kConsumerRegs * kConsumers <= 65536, "register file");
constexpr int kABytes = kBM * 128;     // A tile: 128 pixel rows x 64 bf16
constexpr int kAtomBytes = kBM * 128;  // an output tile's 64-column atom
constexpr int kStages = 3;             // ring slots (A and B a step)
constexpr int kOuts = 3;               // output tiles: x lands a tile ahead, dx stored over it

// The accumulator granularity: a fresh wgmma accumulator every 64-wide
// step, added to the f32 sum in step order. One a tap (4-8 steps chained
// at stages 3-4) left up to 1.8x as many dx elements a bf16 rounding away
// from an f64 reference as the plain version, at the same time; a fresh
// one every step leaves fewer than the plain version at every ResNet-50
// stage (PERF.md; kernel_probe.py k5dx-accuracy).

// Shared memory of a CTA with output tiles BN wide (as K4dx's): the ring
// (A [128 x 64], B = w[tap] rows k [BN x 64 n], K-major), kOuts output
// tiles [128 x BN], the statistics' per-warp column sums [2][8][BN], the
// barriers.
template <int BN>
struct Smem {
  static constexpr int kStageBytes = kABytes + BN * 128;
  static constexpr int kOutBytes = (BN / 64) * kAtomBytes;
  static constexpr int kOut = kStages * kStageBytes;
  static constexpr int kRed = kOut + kOuts * kOutBytes;
  static constexpr int kBars = kRed + 2 * 8 * BN * 4;
  // full and empty a slot; xfull and xempty an output tile
  static constexpr int kBytes = 1024 + kBars + (2 * kStages + 2 * kOuts) * 8;
};

// A pixel tile is nb images x rows image rows x wc columns (<= kBM
// pixels), so that one 4-D TMA box over [B, H, W, C] brings it, and a
// tap's shifted box is its dy window with the zero padding filled in by
// the box's out-of-bounds zeros. The tile is the caller's plan
// (ops/fused_conv3.py k5dx_plan, which sizes the partials by it).
struct Geo {
  int nb, rows, wc;  // the tile
  int tb, ti, tj;    // tiles along the batch, the image rows, the columns
};

// The geometry of the tile (nb, rows, wc), or false where it is not a
// tile of at most kBM pixels within the tensor's dimensions.
inline bool geometry(int bsz, int h, int wd, int nb, int rows, int wc, Geo* g) {
  if (nb < 1 || rows < 1 || wc < 1 || nb > bsz || rows > h || wc > wd ||
      nb * rows * wc > kBM) {
    return false;
  }
  *g = Geo{nb, rows, wc, (bsz + nb - 1) / nb, (h + rows - 1) / rows, (wd + wc - 1) / wc};
  return true;
}

template <int N>
__device__ __forceinline__ void add_to(float (&sum)[N], float (&acc)[N]) {
  fence_operand(acc);
#pragma unroll
  for (int e = 0; e < N; ++e) sum[e] += acc[e];
}

struct Args {
  const __nv_bfloat16* dy;  // [B, H, W, N]
  const __nv_bfloat16* w;   // [3, 3, K, N]
  const __nv_bfloat16* x;   // [B, H, W, K]
  const float* a;
  const float* b;
  __nv_bfloat16* dx;  // [B, H, W, K]
  float* part;        // [pixel tiles, 2, K]
  int bsz, h, wd, kdim, n;
  Geo geo;
};

// Pixel tile pt's origin (b0, i0, j0) and the image coordinates of its
// row r (-1 in `b` where the row is past the tile or off the tensor).
struct TileOrigin {
  int b0, i0, j0;
};
__device__ __forceinline__ TileOrigin origin(const Geo& g, int pt) {
  return {(pt / (g.ti * g.tj)) * g.nb, ((pt / g.tj) % g.ti) * g.rows, (pt % g.tj) * g.wc};
}
__device__ __forceinline__ void row_pixel(const Args& a, const TileOrigin& o, int r, int& b,
                                          int& i, int& j) {
  const Geo& g = a.geo;
  j = o.j0 + r % g.wc;
  i = o.i0 + (r / g.wc) % g.rows;
  b = o.b0 + r / (g.wc * g.rows);
  if (r >= g.nb * g.rows * g.wc || b >= a.bsz || i >= a.h || j >= a.wd) b = -1;
}

// One CTA walks output tiles blockIdx.x, + gridDim.x, ... (persistent),
// tile t = (pixel tile t / tiles_n, channel tile t % tiles_n). Warps 8-11
// are the producer warpgroup: its first thread issues the TMA loads of
// each step (the tap-shifted dy box, w[tap]'s rows) into the ring, and
// after a tile's last step the x box into the tile's output buffer (on
// the edge path the whole warpgroup copies element by element). Warps
// 0-7 consume: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile.
// kVec: K and N multiples of 8 and every pointer 16-byte aligned.
template <int BN, bool kTransform, bool kRelu, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
k5_dx_wgmma(const __grid_constant__ CUtensorMap tdy, const __grid_constant__ CUtensorMap tw,
            const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdx,
            const Args g) {
  using S = Smem<BN>;
  constexpr int kNA = BN / 2;  // accumulators a thread: 64 rows x BN over 128 threads
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;
  float* red = reinterpret_cast<float*>(smem + S::kRed);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* xfull = empty + kStages;
  uint64_t* xempty = xfull + kOuts;

  const Geo& geo = g.geo;
  const int kdim = g.kdim, n = g.n;
  const int tiles_n = (kdim + BN - 1) / BN;
  const int ntiles = geo.tb * geo.ti * geo.tj * tiles_n;
  const int nchunks = (n + kBK - 1) / kBK;
  const int nsteps = kTaps * nchunks;
  const int pix = geo.nb * geo.rows * geo.wc;  // the tile's rows in use
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;

  if (t == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], kVec ? 1 : 128);
      mbar_init(&empty[i], kConsumers / 32);
    }
    for (int i = 0; i < kOuts; ++i) {
      mbar_init(&xfull[i], 1);
      mbar_init(&xempty[i], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // -- the producer warpgroup --------------------------
    setmaxnreg_dec<kProducerRegs>();
    const int p = t - kConsumers;
    if (kVec && p != 0) return;
    const int total = ((ntiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1) * nsteps;
    for (int q = 0; q < total; ++q) {
      const int tile = blockIdx.x + (q / nsteps) * gridDim.x;
      const TileOrigin o = origin(geo, tile / tiles_n);
      const int c0 = (tile % tiles_n) * BN;
      const int s = q % nsteps, tap = s / nchunks, n0 = (s % nchunks) * kBK;
      // the adjoint of tap (dh, dw) reads dy[b, i - dh + 1, j - dw + 1]
      const int di = 1 - tap / 3, dj = 1 - tap % 3;
      const int slot = q % kStages;
      if (q >= kStages) mbar_wait(&empty[slot], ((q / kStages) - 1) & 1);
      uint8_t* sa = ring + slot * S::kStageBytes;
      uint8_t* sb = sa + kABytes;
      if constexpr (kVec) {
        mbar_arrive_expect_tx(&full[slot], pix * 128 + BN * 128);
        tma_load_4d(sa, &tdy, &full[slot], n0, o.j0 + dj, o.i0 + di, o.b0);
        tma_load_3d(sb, &tw, &full[slot], n0, c0, tap);
        if (kTransform && s == nsteps - 1) {  // the tile's x, into its output buffer
          const int i = q / nsteps, buf = i % kOuts;
          if (i >= kOuts) mbar_wait(&xempty[buf], ((i / kOuts) - 1) & 1);
          uint8_t* xt = smem + S::kOut + buf * S::kOutBytes;
          mbar_arrive_expect_tx(&xfull[buf], (BN / 64) * pix * 128);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_4d(xt + j * kAtomBytes, &tx, &xfull[buf], c0 + 64 * j, o.j0, o.i0, o.b0);
        }
      } else {  // the edge path: element by element, zeros off the image
        for (int idx = p; idx < kBM * 8; idx += 128) {
          const int r = idx >> 3, c = idx & 7;
          int bb, ii, jj;
          row_pixel(g, o, r, bb, ii, jj);
          ii += di;
          jj += dj;
          const bool ok = bb >= 0 && ii >= 0 && ii < g.h && jj >= 0 && jj < g.wd;
          const long long pixel = ok ? (static_cast<long long>(bb) * g.h + ii) * g.wd + jj : 0;
          dw::copy_chunk_elems(sa + sw128(r, c), g.dy, pixel, ok, n0 + 8 * c, n, n);
        }
        const __nv_bfloat16* wt = g.w + static_cast<long long>(tap) * kdim * n;
        for (int idx = p; idx < BN * 8; idx += 128) {  // row r of B: output channel c0 + r
          const int r = idx >> 3, c = idx & 7;
          dw::copy_chunk_elems(sb + sw128(r, c), wt, c0 + r, c0 + r < kdim, n0 + 8 * c, n, n);
        }
        fence_proxy_async();
        mbar_arrive(&full[slot]);
      }
    }
    return;
  }

  // -- the consumer warpgroups ---------------------------------------------------
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2;
  float sum[kNA], acc[kNA];
#pragma unroll
  for (int e = 0; e < kNA; ++e) acc[e] = 0.f;

  int it = 0, i = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++i) {
    const int pt = tile / tiles_n, c0 = (tile % tiles_n) * BN;
    const TileOrigin o = origin(geo, pt);

    // mainloop: the f32 sum of the accumulators' products, in step order
#pragma unroll
    for (int e = 0; e < kNA; ++e) sum[e] = 0.f;
    for (int s = 0; s < nsteps; ++s, ++it) {
      const int slot = it % kStages;
      uint8_t* sa = ring + slot * S::kStageBytes;
      mbar_wait(&full[slot], (it / kStages) & 1);
      const uint32_t a_addr = smem_u32(sa) + wg * 64 * 128;
      const uint32_t b_addr = smem_u32(sa + kABytes);
      if (s > 0) {  // the previous step's products are done before these overwrite them
        wgmma_wait<0>();
        add_to(sum, acc);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // a fresh accumulator a step
        const uint64_t da = desc_kmajor(a_addr + kk * 32);
        const uint64_t db = desc_kmajor(b_addr + kk * 32);
        if constexpr (BN == 128) {
          if (kk == 0) wgmma_m64n128k16_ss_first<0>(acc, da, db);
          else wgmma_m64n128k16_ss<0>(acc, da, db, 1);
        } else {
          if (kk == 0) wgmma_m64n64k16_ss_first<0>(acc, da, db);
          else wgmma_m64n64k16_ss<0>(acc, da, db, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (s > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);  // step s-1's slot
    }
    wgmma_wait<0>();
    add_to(sum, acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);

    // epilogue (K4dx's): u = d xn, the relu mask from x, dx = u*a rounded
    // once and staged for the TMA store, the d a / d b partials of the tile
    const int buf = i % kOuts;
    uint8_t* ot = smem + S::kOut + buf * S::kOutBytes;
    if (kTransform && kVec) mbar_wait(&xfull[buf], (i / kOuts) & 1);
    const int row_a = 64 * wg + 16 * (warp & 3) + (lane >> 2);
    long long orow[2];
    bool in[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int bb, ii, jj;
      row_pixel(g, o, row_a + 8 * r, bb, ii, jj);
      in[r] = bb >= 0;
      orow[r] = in[r] ? ((static_cast<long long>(bb) * g.h + ii) * g.wd + jj) * kdim : 0;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = c0 + 8 * j + 2 * (lane & 3);
      float p0[2] = {0.f, 0.f}, p1[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int lr = row_a + 8 * r;
        __nv_bfloat162* sp = reinterpret_cast<__nv_bfloat162*>(
            ot + (j >> 3) * kAtomBytes + sw128(lr, j & 7) + 4 * (lane & 3));
        float v0 = sum[4 * j + 2 * r], v1 = sum[4 * j + 2 * r + 1];
        __nv_bfloat162 out;
        if (kTransform) {
          float x0 = 0.f, x1 = 0.f, a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
          if (kVec) {
            const float2 xf = __bfloat1622float2(*sp);
            x0 = xf.x;
            x1 = xf.y;
            if (col < kdim) {
              const float2 av = *reinterpret_cast<const float2*>(g.a + col);
              const float2 bv = *reinterpret_cast<const float2*>(g.b + col);
              a0 = av.x; a1 = av.y; b0 = bv.x; b1 = bv.y;
            }
          } else {
            if (col < kdim) {
              a0 = g.a[col];
              b0 = g.b[col];
              if (in[r]) x0 = __bfloat162float(g.x[orow[r] + col]);
            }
            if (col + 1 < kdim) {
              a1 = g.a[col + 1];
              b1 = g.b[col + 1];
              if (in[r]) x1 = __bfloat162float(g.x[orow[r] + col + 1]);
            }
          }
          if (kRelu) {
            if (!(__fadd_rn(__fmul_rn(x0, a0), b0) > 0.f)) v0 = 0.f;
            if (!(__fadd_rn(__fmul_rn(x1, a1), b1) > 0.f)) v1 = 0.f;
          }
          out = __floats2bfloat162_rn(v0 * a0, v1 * a1);
          if (in[r]) {
            p0[0] += v0 * x0;
            p1[0] += v0;
            p0[1] += v1 * x1;
            p1[1] += v1;
          }
        } else {
          out = __floats2bfloat162_rn(v0, v1);
        }
        if (kVec) {
          *sp = out;
        } else if (in[r]) {
          if (col < kdim) g.dx[orow[r] + col] = out.x;
          if (col + 1 < kdim) g.dx[orow[r] + col + 1] = out.y;
        }
      }
      if (kTransform) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int sh = 4; sh < 32; sh <<= 1) {
            p0[e] += __shfl_xor_sync(0xffffffffu, p0[e], sh);
            p1[e] += __shfl_xor_sync(0xffffffffu, p1[e], sh);
          }
          if (lane < 4) {
            red[warp * BN + 8 * j + 2 * lane + e] = p0[e];
            red[(8 + warp) * BN + 8 * j + 2 * lane + e] = p1[e];
          }
        }
      }
    }
    if (kVec) fence_proxy_async();  // the staged tile before the TMA store's reads
    named_barrier(1, kConsumers);
    if (kVec && t == 0) {
#pragma unroll
      for (int j = 0; j < BN / 64; ++j)
        tma_store_4d(&tdx, ot + j * kAtomBytes, c0 + 64 * j, o.j0, o.i0, o.b0);
      bulk_commit();
      bulk_wait_read<1>();  // the previous tile's store has read its buffer
      if (kTransform && i > 0) mbar_arrive(&xempty[(i - 1) % kOuts]);
    }
    if (kTransform && t < BN && c0 + t < kdim) {
      float t0 = 0.f, t1 = 0.f;
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        t0 += red[v * BN + t];
        t1 += red[(8 + v) * BN + t];
      }
      float* prow = g.part + static_cast<long long>(pt) * 2 * kdim;
      prow[c0 + t] = t0;
      prow[kdim + c0 + t] = t1;
    }
    named_barrier(1, kConsumers);  // red, and the other output tile, free for the next tile
  }
  if (kVec && t == 0) bulk_wait_read<0>();  // shared memory outlives the last store's reads
}

// A 4-D map over an NHWC bf16 tensor [bsz, h, wd, c] (c a multiple of 8,
// the base 16-byte aligned), dimensions innermost first (c, wd, h, bsz),
// boxes of 64 channels x the pixel tile, 128-byte swizzle, zeros off the
// tensor: a tap-shifted box reads the zero padding there.
inline bool tensor_map_nhwc(EncodeTiled encode, CUtensorMap* map, const void* base, int bsz,
                            int h, int wd, int c, const Geo& g) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(wd),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(bsz)};
  const cuuint64_t row = static_cast<cuuint64_t>(c) * 2;
  const cuuint64_t strides[3] = {row, row * wd, row * wd * h};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(g.wc), static_cast<cuuint32_t>(g.rows),
                             static_cast<cuuint32_t>(g.nb)};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 3-D map over w [3, 3, K, N] as [9 taps, K, N], boxes of 64 n x rows
// k of one tap, zeros past K and N (not the next tap's rows).
inline bool tensor_map_taps(EncodeTiled encode, CUtensorMap* map, const void* base, int kdim,
                            int n, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(kdim), kTaps};
  const cuuint64_t row = static_cast<cuuint64_t>(n) * 2;
  const cuuint64_t strides[2] = {row, row * kdim};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, bool kTransform, bool kRelu, bool kVec>
cudaError_t launch(const CUtensorMap& tdy, const CUtensorMap& tw, const CUtensorMap& tx,
                   const CUtensorMap& tdx, const Args& g, cudaStream_t s) {
  auto kernel = k5_dx_wgmma<BN, kTransform, kRelu, kVec>;
  constexpr int kSmem = Smem<BN>::kBytes;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  // one persistent CTA an SM, no more than the tiles; each tile is one
  // CTA's whatever the grid, so the result does not depend on the card
  const long long tiles = static_cast<long long>(g.geo.tb) * g.geo.ti * g.geo.tj *
                          ((g.kdim + BN - 1) / BN);
  const int ctas = sm_count();
  if (ctas == 0) return cudaErrorInvalidDevice;
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(tiles < ctas ? tiles : ctas), kThreads, kSmem, s>>>(
      tdy, tw, tx, tdx, g);
  return cudaGetLastError();
}

template <int BN, bool kVec>
cudaError_t modes(int transform, const CUtensorMap& tdy, const CUtensorMap& tw,
                  const CUtensorMap& tx, const CUtensorMap& tdx, const Args& g, cudaStream_t s) {
  if (transform == 0) return launch<BN, false, false, kVec>(tdy, tw, tx, tdx, g, s);
  if (transform == 1) return launch<BN, true, false, kVec>(tdy, tw, tx, tdx, g, s);
  return launch<BN, true, true, kVec>(tdy, tw, tx, tdx, g, s);
}

// part: [pixel tiles of geo, 2, kdim] (transform); the output tile is
// 64 channels wide where K <= 64, else 128
cudaError_t run(int transform, const void* dy, const void* w, const void* x, const void* a,
                const void* b, void* dxp, void* part, void* dstats, int bsz, int h, int wd,
                int kdim, int n, const Geo& geo, cudaStream_t s) {
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool vec = kdim % 8 == 0 && n % 8 == 0 && aligned(dy) && aligned(w) && aligned(x) &&
                   aligned(dxp) && (transform == 0 || (aligned(a) && aligned(b)));
  const int bn = kdim <= 64 ? 64 : 128;
  CUtensorMap tdy{}, tw{}, tx{}, tdx{};
  if (vec) {
    const EncodeTiled encode = tensor_map_encoder();
    if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
    if (!tensor_map_nhwc(encode, &tdy, dy, bsz, h, wd, n, geo) ||
        !tensor_map_taps(encode, &tw, w, kdim, n, bn) ||
        !tensor_map_nhwc(encode, &tx, x, bsz, h, wd, kdim, geo) ||
        !tensor_map_nhwc(encode, &tdx, dxp, bsz, h, wd, kdim, geo)) {
      return cudaErrorInvalidValue;
    }
  }
  const Args g{static_cast<const __nv_bfloat16*>(dy), static_cast<const __nv_bfloat16*>(w),
               static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(a),
               static_cast<const float*>(b), static_cast<__nv_bfloat16*>(dxp),
               static_cast<float*>(part), bsz, h, wd, kdim, n, geo};
#define K5DX_TILE(BN) \
  (vec ? modes<BN, true>(transform, tdy, tw, tx, tdx, g, s) \
       : modes<BN, false>(transform, tdy, tw, tx, tdx, g, s))
  const cudaError_t err = bn == 128 ? K5DX_TILE(128) : K5DX_TILE(64);
#undef K5DX_TILE
  if (err != cudaSuccess) return err;
  if (transform != 0) colsum(part, geo.tb * geo.ti * geo.tj, 2 * kdim, dstats, s);
  return cudaGetLastError();
}

}  // namespace wgdx

// -- K5dw, bf16: the tensor-core design ----------------------------------------

namespace wgdw {

using namespace port::hopper;

constexpr int kTile = 64;      // a warpgroup's dw tile, K x N (ops/fused_matmul.py DW_WG_TILE)
constexpr int kThreads = 384;  // three warpgroups: the taps of one kernel row
// a step's tiles in the ring: x, then dy at each of the three taps
using Ring = dw::Ring<1, 3>;

// kVec: K and N multiples of 8 and x, dy 16-byte aligned: x by TMA, dy
// rows by cp.async; else the edge path copies element by element.
template <bool kTransform, bool kRelu, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
k5_dw_wgmma(const __grid_constant__ CUtensorMap tx, const __nv_bfloat16* __restrict__ x,
            const __nv_bfloat16* __restrict__ dy, const float* __restrict__ a,
            const float* __restrict__ b, float* __restrict__ part, int m, int h, int wd,
            int kdim, int n, int chunk) {
  extern __shared__ uint8_t smem_raw[];
  const Ring ring(smem_raw);
  // blockIdx.x = ((split * K tiles + k tile) * N tiles + n tile) * 3 + kernel row
  const int ntk = (kdim + kTile - 1) / kTile, ntn = (n + kTile - 1) / kTile;
  int rest = blockIdx.x;
  const int dh = rest % 3;
  rest /= 3;
  const int n0 = (rest % ntn) * kTile;
  rest /= ntn;
  const int k0 = (rest % ntk) * kTile, split = rest / ntk;
  const int mbeg = split * chunk, mend = min(mbeg + chunk, m);
  const int nsteps = (mend - mbeg + dw::kPix - 1) / dw::kPix;
  // warpgroup g: tap (dh, g), whose dy pixel is the x pixel minus shift
  const int g = threadIdx.x >> 7, shift = (dh - 1) * wd + (g - 1);
  // the thread's dy rows r0 + 16k (k < 4) of its tap's tile, chunk c
  const int l = threadIdx.x & 127, c = l & 7, r0 = l >> 3;
  dw::setup(ring, a, b, k0, kdim, kTransform);

  // image coordinates (i, j) of the thread's rows at the next step to
  // issue, stepped by 64 pixels a step
  int ri[4], rj[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int q = (mbeg + r0 + 16 * k) % (h * wd);
    ri[k] = q / wd;
    rj[k] = q % wd;
  }
  const int di = dw::kPix / wd, dj = dw::kPix % wd;

  auto issue = [&](int s) {
    if (s < nsteps) {
      uint8_t* stage = ring.slot(s);
      const int row0 = mbeg + s * dw::kPix;
      if (kVec) {
        if (threadIdx.x == 0) {
          uint64_t* bar = ring.bar(s);
          mbar_arrive_expect_tx(bar, dw::kTileBytes);
          tma_load_2d(stage, &tx, bar, k0, row0);
        }
      } else {
        for (int idx = threadIdx.x; idx < dw::kChunks; idx += kThreads) {
          const int r = idx >> 3, cc = idx & 7;
          dw::copy_chunk_elems(stage + sw128(r, cc), x, row0 + r, row0 + r < mend,
                               k0 + 8 * cc, kdim, kdim);
        }
      }
      uint8_t* tile = stage + (1 + g) * dw::kTileBytes;
      const int col = n0 + 8 * c;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = r0 + 16 * k, q = row0 + r;
        const int ii = ri[k] - (dh - 1), jj = rj[k] - (g - 1);
        const bool ok = q < mend && ii >= 0 && ii < h && jj >= 0 && jj < wd;
        const long long p = static_cast<long long>(q) - shift;
        if (kVec) {
          const bool in = ok && col < n;
          cp_async16(smem_u32(tile + sw128(r, c)), in ? dy + p * n + col : dy, in ? 16 : 0);
        } else {
          dw::copy_chunk_elems(tile + sw128(r, c), dy, p, ok, col, n, n);
        }
        rj[k] += dj;
        ri[k] += di;
        if (rj[k] >= wd) {
          rj[k] -= wd;
          ++ri[k];
        }
        while (ri[k] >= h) ri[k] -= h;
      }
    }
    if (kVec) cp_async_commit();
  };
  auto landed = [&](int s) {
    if (kVec) {
      cp_async_wait<dw::kAhead - 1>();  // this thread's dy rows of step s
      mbar_wait(ring.bar(s), ring.phase(s));  // x
    }
  };
  auto prepare = [&](uint8_t* stage) {
    if (kTransform) dw::transform<kRelu>(stage, ring);
  };
  float sum[32];
  dw::mainloop(sum, ring, nsteps, 0, g, issue, landed, prepare);
  const int tap = 3 * dh + g;
  dw::store(sum, part + (static_cast<long long>(split) * kTaps + tap) * kdim * n, k0, kdim, n0,
            n);
}

template <bool kTransform, bool kRelu, bool kVec>
cudaError_t launch(const CUtensorMap& tx, const void* x, const void* dy, const void* a,
                   const void* b, void* part, int m, int h, int wd, int kdim, int n, int splits,
                   int chunk, cudaStream_t s) {
  auto kernel = k5_dw_wgmma<kTransform, kRelu, kVec>;
  constexpr int kSmem = Ring::kSmem;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const long long ctas = 3LL * ((kdim + kTile - 1) / kTile) * ((n + kTile - 1) / kTile) * splits;
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(ctas), kThreads, kSmem, s>>>(
      tx, static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(part), m, h,
      wd, kdim, n, chunk);
  return cudaGetLastError();
}

// part: f32 [splits, 3, 3, kdim, n]; the result rounded to bf16 by splitsum
cudaError_t run(int transform, const void* x, const void* dy, const void* a, const void* b,
                void* part, void* out, int m, int h, int wd, int kdim, int n, int splits,
                int chunk, cudaStream_t s) {
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool vec = kdim % 8 == 0 && n % 8 == 0 && aligned(x) && aligned(dy);
  CUtensorMap tx{};
  if (vec) {
    const EncodeTiled encode = tensor_map_encoder();
    if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
    if (!tensor_map_2d(encode, &tx, x, m, kdim, dw::kPix)) return cudaErrorInvalidValue;
  }
#define K5_DW_WG(TR, RE)                                                                 \
  (vec ? launch<TR, RE, true>(tx, x, dy, a, b, part, m, h, wd, kdim, n, splits, chunk, s) \
       : launch<TR, RE, false>(tx, x, dy, a, b, part, m, h, wd, kdim, n, splits, chunk, s))
  const cudaError_t err = transform == 0   ? K5_DW_WG(false, false)
                          : transform == 1 ? K5_DW_WG(true, false)
                                           : K5_DW_WG(true, true);
#undef K5_DW_WG
  if (err != cudaSuccess) return err;
  splitsum<__nv_bfloat16>(part, splits, static_cast<long long>(kTaps) * kdim * n, out, s);
  return cudaGetLastError();
}

}  // namespace wgdw

// The pixel count M = bsz * h * wd, or -1 when a dimension is not
// positive or M does not fit an int.
int pixels(int bsz, int h, int wd, int kdim, int n) {
  if (bsz <= 0 || h <= 0 || wd <= 0 || kdim <= 0 || n <= 0) return -1;
  const long long m = static_cast<long long>(bsz) * h * wd;
  return m > INT_MAX ? -1 : static_cast<int>(m);
}

}  // namespace

// x [bsz, h, wd, kdim], w [3, 3, kdim, n], y [bsz, h, wd, n];
// part: f32 scratch [pixel tiles, 2, n] (want_stats): tiles of 128 pixels,
// or of 64 for bf16 with n > 64 (ops/fused_conv3.py k5f_plan); stats: f32 [2, n].
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
    case kBF16: return static_cast<int>(wg::dispatch(transform, want_stats, x, w, a, b, y, part, stats, m, h, wd, kdim, n, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dy [bsz, h, wd, n], dx and x [bsz, h, wd, kdim]; part: f32 scratch
// [pixel tiles, 2, kdim] (transform), dstats: f32 [2, kdim]. f32: tiles
// of 128 flattened pixels; bf16: tiles of tile_nb images x tile_rows
// image rows x tile_cols columns (ops/fused_conv3.py k5dx_plan; unused
// in f32).
extern "C" int port_k5_dx(const void* dy, const void* w, const void* x, const void* a,
                          const void* b, void* dx, void* part, void* dstats, int bsz, int h,
                          int wd, int kdim, int n, int transform, int tile_nb, int tile_rows,
                          int tile_cols, int dtype, int device, void* stream) {
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  const int m = pixels(bsz, h, wd, kdim, n);
  if (m < 0 || transform < 0 || transform > 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      if (transform == 0) dx_launch<float, false, false>(dy, w, x, a, b, dx, part, dstats, m, h, wd, kdim, n, s);
      else if (transform == 1) dx_launch<float, true, false>(dy, w, x, a, b, dx, part, dstats, m, h, wd, kdim, n, s);
      else dx_launch<float, true, true>(dy, w, x, a, b, dx, part, dstats, m, h, wd, kdim, n, s);
      break;
    case kBF16: {
      wgdx::Geo geo;
      if (!wgdx::geometry(bsz, h, wd, tile_nb, tile_rows, tile_cols, &geo)) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      return static_cast<int>(wgdx::run(transform, dy, w, x, a, b, dx, part, dstats, bsz, h, wd,
                                        kdim, n, geo, s));
    }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// part: f32 scratch [splits, 3, 3, kdim, n]; split z sums pixels
// [z*chunk, (z+1)*chunk), chunk a multiple of 16 pixels (f32) or of 64
// (bf16: ops/fused_matmul.py dw_plan); dw [3, 3, kdim, n] in the
// operands' dtype.
extern "C" int port_k5_dw(const void* x, const void* dy, const void* a, const void* b,
                          void* part, void* dw, int bsz, int h, int wd, int kdim, int n,
                          int transform, int splits, int chunk, int dtype, int device,
                          void* stream) {
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  const int m = pixels(bsz, h, wd, kdim, n);
  const int step = dtype == kBF16 ? port::dw::kPix : kBK;
  if (m < 0 || transform < 0 || transform > 2 || splits <= 0 || chunk <= 0 ||
      chunk % step != 0 || static_cast<long long>(splits) * chunk < m ||
      static_cast<long long>(splits - 1) * chunk >= m ||
      (dtype != kBF16 && kTaps * splits > 65535)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      if (transform == 0) dw_launch<float, false, false>(x, dy, a, b, part, dw, m, h, wd, kdim, n, splits, chunk, s);
      else if (transform == 1) dw_launch<float, true, false>(x, dy, a, b, part, dw, m, h, wd, kdim, n, splits, chunk, s);
      else dw_launch<float, true, true>(x, dy, a, b, part, dw, m, h, wd, kdim, n, splits, chunk, s);
      break;
    case kBF16:
      return static_cast<int>(wgdw::run(transform, x, dy, a, b, part, dw, m, h, wd, kdim, n,
                                        splits, chunk, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
