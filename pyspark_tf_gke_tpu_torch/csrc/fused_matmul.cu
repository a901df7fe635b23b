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
// Bound on the H100: ResNet-50's stage 1-2 calls (M = 200,704 or 50,176
// rows at K, N = 64..512) move more bytes than their tensor-core time —
// [200704, 64] @ [64, 256] writes 103 MB of y against 6.6 GFLOP; the K =
// 1024..2048 calls of stages 3-4 are bound by operations.
//
// Every entry point chooses the design by dtype and nothing else: bf16
// runs the tensor-core kernels, f32 the CUDA-core ones.
//
// K4f and K4dx, bf16 (wg::k4_fwd_wgmma, wg::k4_dx_wgmma): the product A
// [M, R] @ B on wgmma — K4f x [M, K] @ w [K, N], K4dx dy [M, N] @ w^T,
// whose B is w read K-major (its rows are the output channels, n
// contiguous) — in 128-row output tiles, 64 columns wide where the
// output is at most 64 wide (stage 1's K4f at N = 64, K4dx at K = 64: no
// half-empty tile) and 128 beyond (ops/fused_matmul.py k4_plan).
// Persistent CTAs (one an SM) walk the tiles; a CTA is two consumer
// warpgroups (64 rows each, m64n64k16 or m64n128k16 from 128-byte
// swizzled shared memory) and a producer warpgroup that gives its
// registers to them and whose first thread brings A and B by 2-D TMA,
// 64 reduction indices a step, into a ring of mbarrier-guarded slots
// (full: the bytes landed; empty: both warpgroups' products are done).
// At K = 64 a tile is one step, so the overlap is across tiles: the
// loads of the next tiles run while the consumers finish one tile's
// epilogue (persistent CTAs took 17-25% less time over a step's calls
// than one CTA a tile: PERF.md). K4f's transform runs in place on the
// landed A tile, each warpgroup on its own 64 rows (a and b of the
// thread's 8 channels by two 16-byte loads; 0 past K, where TMA filled
// x with zeros), then fence.proxy.async and the warpgroup's named
// barrier hand it to wgmma. Every 64-wide step starts a fresh wgmma
// accumulator, added to the f32 sum in step order (kGroup = 1): chaining
// the whole reduction left up to 5x as many y elements a bf16 rounding
// away from an f64 reference as the plain version, a fresh one every
// step fewer than it at every ResNet-50 shape measured (kernel_probe.py
// k4-accuracy). One accumulator: a second one, alternating so that an
// add waits only for its own products, spilled at 128 columns within the
// 168 registers a thread of a 384-thread CTA gets, and was no faster at
// 64 columns, nor as the two 64-column halves of a 128-column tile
// (PERF.md).
// Epilogue: the output rounded once into shared memory (the
// accumulator's layout, 4-byte pairs, conflict-free in the 128-byte
// swizzle) and written by one TMA store a 64-column atom, which drops
// rows past M — K4f's rows there are relu(b) @ w, not 0 — and columns past
// N; the statistics (K4f: the rounded y and y^2; K4dx: u*x and u) are
// summed over a thread's two rows, then by quad shuffles over the warp's
// 16 rows, then over the 8 warps in order: one row of partials [tiles, 2,
// C] per 128-row tile, summed in tile order by colsum_kernel (rows past M
// excluded). K4dx's epilogue reads x[row, k] from a tile that TMA
// brought into the output buffer (the mask __fadd_rn(__fmul_rn(x, a), b)
// > 0, then dx = u*a rounded once, written over x in place); three
// output buffers let that load run a tile ahead. K or N not a multiple
// of 8, or a pointer off 16 bytes, takes a masked edge path of the same
// kernels: the producer warpgroup copies element by element and the
// epilogue stores element by element.
//
// K4dw, bf16 (wgdw::k4_dw_wgmma): the weight-gradient mainloop of
// wgmma_dw.cuh: a CTA owns a (64 a) x (64 b) tile of dw, a, b in {1, 2}
// (64 wide where K or N is at most 64: no half-empty tile at stage 1),
// one warpgroup per 64 x 64 part, and a split of the M rows; x [M, K]
// and dy [M, N] arrive by 2-D TMA, 64 rows a step, into a 4-slot
// mbarrier ring (zeros past M and past K, N), the transform runs in
// place on the x tiles, and both operands feed wgmma MN-major. The
// splits write f32 partials [splits, K, N], summed in split order by
// splitsum_kernel. K or N not a multiple of 8, or a pointer off 16
// bytes, takes a masked edge path of the same kernel that copies
// element by element.
//
// K4f, K4dx and K4dw, f32 (the first, CUDA-core design, kept as the
// reference the model-parity gates stand on): the product on the CUDA
// cores in f32, bound by f32 FMA throughput well above either bound. One
// shared-memory GEMM mainloop for all three (tile_gemm.cuh, shared with
// K5's fused 3x3 conv in fused_conv3.cu): a block owns a 128 x 64 output
// tile (256 threads, 8 x 4 outputs each) and walks the reduction in steps
// of 16: both operand tiles are staged in shared memory as f32,
// reduction-major, and the input transform (and its rounding) is applied
// while staging, so the product reads normalised values. Ragged edges are
// masked at the loads (zero AFTER the transform: relu(b) is not zero) and
// at the stores. The TPU kernels carry an accumulator across a
// sequential grid axis; blocks here run in no order, so
//   * K4f and K4dx loop over the whole reduction inside the block and
//     write one row of column partials per 128-row tile ([tiles, 2, C]),
//     summed afterwards in tile order by colsum_kernel;
//   * K4dw splits M across blocks (grid z): each writes an f32 partial
//     [splits, K, N], and splitsum_kernel adds the splits in order and
//     rounds to dy's dtype.
// No atomics in any kernel: every result is independent of scheduling.

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

// -- K4f and K4dx, bf16: the tensor-core design ---------------------------------

namespace wg {

using namespace port::hopper;

constexpr int kBM = 128;         // rows a CTA tile (ops/fused_matmul.py K4_BLOCK_M)
constexpr int kBK = 64;          // reduction a step: one 128-byte swizzle row
constexpr int kConsumers = 256;  // two warpgroups, 64 rows each
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
// registers a thread after the move (launched at 65536 / 384 = 168):
// the producer warpgroup needs few, a consumer holds the f32 sum and the
// accumulator
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(kProducerRegs * 128 + kConsumerRegs * kConsumers <= 65536, "register file");
constexpr int kABytes = kBM * 128;     // A tile: 128 rows x 64 bf16
constexpr int kAtomBytes = kBM * 128;  // an output tile's 64-column atom: 128 rows x 64 bf16

// The accumulator granularity (kernel_probe.py k4-accuracy): kGroup
// 64-wide steps chain into one wgmma accumulator, which is then added to
// the f32 sum. A fresh accumulator every step is the most accurate and
// costs 1-3% (PERF.md).
constexpr int kGroup = 1;
static_assert(kGroup >= 1, "accumulator groups");

// Dynamic shared memory of a CTA with output tiles BN wide: the ring
// (kStages slots of A [128 x 64] and B: fwd w [64 k x BN n] as BN/64
// MN-major atoms, dx w [BN k x 64 n] K-major), kOuts output tiles [128 x
// BN] (y / dx staged for the TMA store), the statistics' per-warp column
// sums [2][8 warps][BN], the barriers. K4dx's x tile lands in its output
// tile first; with three of them the producer loads tile i's x while the
// consumers work on tile i-1 (with two, tile i-2's store frees the
// buffer only during tile i-1's epilogue, and the load's latency shows at
// every tile of one reduction step), which leaves room for three slots.
template <int BN, bool kDx>
struct Smem {
  static constexpr int kStages = kDx ? 3 : 4;
  static constexpr int kOuts = kDx ? 3 : 2;
  static constexpr int kStageBytes = kABytes + BN * 128;
  static constexpr int kOutBytes = (BN / 64) * kAtomBytes;
  static constexpr int kOut = kStages * kStageBytes;
  static constexpr int kRed = kOut + kOuts * kOutBytes;
  static constexpr int kBars = kRed + 2 * 8 * BN * 4;
  // full and empty a slot; xfull and xempty an output tile
  static constexpr int kBytes = 1024 + kBars + (2 * kStages + 2 * kOuts) * 8;
};

// The operands of one call: the product A [M, R] @ B with R the
// reduction — K4f: x [M, K] @ w [K, N]; K4dx: dy [M, N] @ w^T — and its
// output [M, C] (C = N, or K for K4dx).
struct Args {
  const __nv_bfloat16* A;
  const __nv_bfloat16* w;
  const __nv_bfloat16* x;  // K4dx's epilogue
  const float* a;
  const float* b;
  __nv_bfloat16* out;
  float* part;  // [tiles of 128 rows, 2, C]
  int m, kdim, n;
};

// One 16-deep reduction step kk of a slot: warpgroup wg's 64 rows of A
// (K-major) times all of B — K4f's w rows k (MN-major: BN/64 atoms 8 KB
// apart), K4dx's w rows = output channels (K-major: the reduction n
// contiguous). start: the accumulator restarts (d = A B, its old value
// dead), else d += A B.
template <int BN, bool kDx>
__device__ __forceinline__ void mma_step(float (&acc)[BN / 2], uint32_t a_addr, uint32_t b_addr,
                                         int kk, bool start) {
  constexpr int kTransB = kDx ? 0 : 1;
  const uint64_t da = desc_kmajor(a_addr + kk * 32);
  const uint64_t db =
      kDx ? desc_kmajor(b_addr + kk * 32) : desc_mnmajor(b_addr + kk * 2048, 64 * 128);
  if constexpr (BN == 128) {
    if (start) wgmma_m64n128k16_ss_first<kTransB>(acc, da, db);
    else wgmma_m64n128k16_ss<kTransB>(acc, da, db, 1);
  } else {
    if (start) wgmma_m64n64k16_ss_first<kTransB>(acc, da, db);
    else wgmma_m64n64k16_ss<kTransB>(acc, da, db, 1);
  }
}

template <int N>
__device__ __forceinline__ void add_to(float (&sum)[N], float (&acc)[N]) {
  fence_operand(acc);
#pragma unroll
  for (int e = 0; e < N; ++e) sum[e] += acc[e];
}

// One CTA walks output tiles blockIdx.x, + gridDim.x, ... (persistent),
// tile t = (row tile t / tiles_n, column tile t % tiles_n). Warps 8-11
// are the producer warpgroup, which gives most of its registers to the
// consumers: its first thread issues the TMA loads of the CTA's steps
// through the ring (on the edge path the whole warpgroup copies), so
// the next tile's loads run while the consumers finish the previous
// tile's epilogue. Warps 0-7 consume: warpgroup wg owns rows 64 wg ..
// 64 wg + 63 of the tile, and transforms them in place (K4f).
// kDx: K4dx (mask, dx = u*a, statistics of u*x and u when kTransform);
// else K4f (the transform on A, statistics of the rounded y when kStats).
// kVec: K and N multiples of 8 and every pointer 16-byte aligned: TMA
// loads and stores; else the edge path copies and stores element by
// element.
template <int BN, bool kDx, bool kTransform, bool kRelu, bool kStats, bool kVec>
__device__ __forceinline__ void k4_body(const CUtensorMap& ta, const CUtensorMap& tw,
                                        const CUtensorMap& tx, const CUtensorMap& tout,
                                        const Args& g) {
  using S = Smem<BN, kDx>;
  constexpr int kStages = S::kStages, kOuts = S::kOuts;
  constexpr int kNA = BN / 2;  // accumulators a thread: 64 rows x BN over 128 threads
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;
  float* red = reinterpret_cast<float*>(smem + S::kRed);
  // a slot is full: its TMA loads landed (kVec) or the producer
  // warpgroup's copies are written (128 arrivals); empty: its products
  // are done
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* xfull = empty + kStages;  // K4dx: the output tile's x landed
  uint64_t* xempty = xfull + kOuts;   // K4dx: the output tile's store has read it

  const int m = g.m, kdim = g.kdim, n = g.n;
  const int rdim = kDx ? n : kdim;  // the reduction
  const int cols = kDx ? kdim : n;  // the output's columns
  const int tiles_n = (cols + BN - 1) / BN;
  const int ntiles = ((m + kBM - 1) / kBM) * tiles_n;
  const int nsteps = (rdim + kBK - 1) / kBK;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;

  if (t == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], kVec ? 1 : 128);
      mbar_init(&empty[i], kConsumers / 32);  // one arrival a consumer warp
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
    if (kVec && p != 0) return;  // thread 0 issues the TMA loads
    // this CTA's steps q: its tile q / nsteps, reduction step q % nsteps
    const int total = ((ntiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1) * nsteps;
    auto coords = [&](int q, int& m0, int& c0, int& r0) {
      const int tile = blockIdx.x + (q / nsteps) * gridDim.x;
      m0 = (tile / tiles_n) * kBM;
      c0 = (tile % tiles_n) * BN;
      r0 = (q % nsteps) * kBK;
    };
    // thread 0, vector path: step q's TMA loads into its slot, and after
    // a tile's last step K4dx's x tile into the tile's output buffer
    auto issue = [&](int q) {
      int m0, c0, r0;
      coords(q, m0, c0, r0);
      const int slot = q % kStages;
      if (q >= kStages) mbar_wait(&empty[slot], ((q / kStages) - 1) & 1);
      uint8_t* sa = ring + slot * S::kStageBytes;
      uint8_t* sb = sa + kABytes;
      mbar_arrive_expect_tx(&full[slot], S::kStageBytes);
      tma_load_2d(sa, &ta, &full[slot], r0, m0);
#pragma unroll
      for (int j = 0; j < BN / 64; ++j) {
        if (kDx) tma_load_2d(sb + j * 64 * 128, &tw, &full[slot], r0, c0 + 64 * j);
        else tma_load_2d(sb + j * 64 * 128, &tw, &full[slot], c0 + 64 * j, r0);
      }
      if (kDx && kTransform && q % nsteps == nsteps - 1) {
        const int i = q / nsteps, buf = i % kOuts;
        if (i >= kOuts) mbar_wait(&xempty[buf], ((i / kOuts) - 1) & 1);
        uint8_t* xt = smem + S::kOut + buf * S::kOutBytes;
        mbar_arrive_expect_tx(&xfull[buf], S::kOutBytes);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(xt + j * kAtomBytes, &tx, &xfull[buf], c0 + 64 * j, m0);
      }
    };
    if constexpr (kVec) {
      for (int q = 0; q < total; ++q) issue(q);
    } else {  // the edge path: element by element
      for (int q = 0; q < total; ++q) {
        int m0, c0, r0;
        coords(q, m0, c0, r0);
        const int slot = q % kStages;
        if (q >= kStages) mbar_wait(&empty[slot], ((q / kStages) - 1) & 1);
        uint8_t* sa = ring + slot * S::kStageBytes;
        uint8_t* sb = sa + kABytes;
        for (int idx = p; idx < kBM * 8; idx += 128) {
          const int r = idx >> 3, c = idx & 7;
          dw::copy_chunk_elems(sa + sw128(r, c), g.A, m0 + r, m0 + r < m, r0 + 8 * c, rdim,
                               rdim);
        }
        for (int idx = p; idx < BN * 8; idx += 128) {
          if (kDx) {  // row r of B: output channel c0 + r
            const int r = idx >> 3, c = idx & 7;
            dw::copy_chunk_elems(sb + sw128(r, c), g.w, c0 + r, c0 + r < kdim, r0 + 8 * c, n, n);
          } else {  // atom j, row kr of B: reduction index r0 + kr
            const int j = idx >> 9, kr = (idx >> 3) & 63, c = idx & 7;
            dw::copy_chunk_elems(sb + j * 64 * 128 + sw128(kr, c), g.w, r0 + kr,
                                 r0 + kr < kdim, c0 + 64 * j + 8 * c, n, n);
          }
        }
        fence_proxy_async();  // these writes before the products' reads
        mbar_arrive(&full[slot]);
      }
    }
    return;
  }

  // -- the consumer warpgroups ---------------------------------------------------
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2, l = t & 127;
  // the f32 sum of the tile's BN columns, and one accumulator: a second
  // one, alternating with it so that an add waits only for its own
  // products, spilled at 128 columns, and at 64 (or as two 64-column
  // halves at 128) it was no faster (PERF.md)
  float sum[kNA], acc[kNA];
#pragma unroll
  for (int e = 0; e < kNA; ++e) acc[e] = 0.f;

  // K4f's transform, in place on the warpgroup's 64 rows of a landed A
  // tile: the thread's 16-byte chunk c = l % 8 (channels r0 + 8c ..) of
  // rows l / 8 + 16 q, with a and b of those channels (0 past K, where x
  // is 0 too); norm_transform's arithmetic (x*a, + b, each rounded;
  // relu), rounded to bf16 once, two channels a conversion. (By the
  // producer warpgroup instead, one warp to a scheduler, it took 37%
  // longer over a step's calls: PERF.md.)
  auto transform = [&](uint8_t* sa, const float (&av)[8], const float (&bv)[8], int ch) {
    if (ch >= kdim) return;  // zeros past K stay zero
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint4* chunk = reinterpret_cast<uint4*>(sa + sw128(64 * wg + (l >> 3) + 16 * q, l & 7));
      uint4 raw = *chunk;
      __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xf = __bfloat1622float2(v[e]);
        float t0 = __fadd_rn(__fmul_rn(xf.x, av[2 * e]), bv[2 * e]);
        float t1 = __fadd_rn(__fmul_rn(xf.y, av[2 * e + 1]), bv[2 * e + 1]);
        if (kRelu) {
          t0 = fmaxf(t0, 0.f);
          t1 = fmaxf(t1, 0.f);
        }
        v[e] = __floats2bfloat162_rn(t0, t1);
      }
      *chunk = raw;
    }
  };
  auto load_ab = [&](float (&av)[8], float (&bv)[8], int ch) {
    if (kVec && ch < kdim) {
      const float4* pa = reinterpret_cast<const float4*>(g.a + ch);
      const float4* pb = reinterpret_cast<const float4*>(g.b + ch);
      const float4 a0 = pa[0], a1 = pa[1], b0 = pb[0], b1 = pb[1];
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool in = ch + e < kdim;
        av[e] = in ? g.a[ch + e] : 0.f;
        bv[e] = in ? g.b[ch + e] : 0.f;
      }
    }
  };

  int it = 0, i = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++i) {
    const int m0 = (tile / tiles_n) * kBM, c0 = (tile % tiles_n) * BN;

    // mainloop: the f32 sum of the groups' products, in group order
#pragma unroll
    for (int e = 0; e < kNA; ++e) sum[e] = 0.f;
    for (int s = 0; s < nsteps; ++s, ++it) {
      const int slot = it % kStages;
      uint8_t* sa = ring + slot * S::kStageBytes;
      if (kTransform && !kDx) {
        float av[8], bv[8];
        const int ch = s * kBK + 8 * (l & 7);
        load_ab(av, bv, ch);
        mbar_wait(&full[slot], (it / kStages) & 1);
        transform(sa, av, bv, ch);
        fence_proxy_async();         // this thread's writes before the products' reads
        named_barrier(2 + wg, 128);  // the warpgroup's: it reads only its own rows of A
      } else {
        mbar_wait(&full[slot], (it / kStages) & 1);
      }
      const uint32_t a_addr = smem_u32(sa) + wg * 64 * 128;
      const uint32_t b_addr = smem_u32(sa + kABytes);
      const bool first = s % kGroup == 0;  // a group starts from 0
      if (first && s > 0) {  // the previous group is done before this one overwrites it
        wgmma_wait<0>();
        add_to(sum, acc);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_step<BN, kDx>(acc, a_addr, b_addr, kk, first && kk == 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (s > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);  // step s-1's slot
    }
    wgmma_wait<0>();
    add_to(sum, acc);  // the last group
    if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);

    // epilogue: the output rounded once (staged in shared memory for the
    // TMA store), the statistics' per-column partials of the tile
    constexpr bool kSums = kDx ? kTransform : kStats;
    const int buf = i % kOuts;
    uint8_t* ot = smem + S::kOut + buf * S::kOutBytes;
    if (kDx && kTransform && kVec) mbar_wait(&xfull[buf], (i / kOuts) & 1);
    // the tile's row of sum[4j] and sum[4j + 1]; of sum[4j + 2], sum[4j + 3] 8 below
    const int row_a = 64 * wg + 16 * (warp & 3) + (lane >> 2);
    // 8 columns at a time: the thread's column pair in its two rows, then
    // the column sums over the warp's 16 rows (the 8 lanes of one lane %
    // 4), written per warp; the 8 warps are added in order below: one
    // row of partials per tile of 128 rows
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = c0 + 8 * j + 2 * (lane & 3);
      float p0[2] = {0.f, 0.f}, p1[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int lr = row_a + 8 * r, row = m0 + lr;
        // rows past M (K4f's: relu(b) @ w, not 0) are neither stored nor summed
        const bool in = row < m;
        const long long orow = static_cast<long long>(row) * cols;
        __nv_bfloat162* sp = reinterpret_cast<__nv_bfloat162*>(
            ot + (j >> 3) * kAtomBytes + sw128(lr, j & 7) + 4 * (lane & 3));
        float v0 = sum[4 * j + 2 * r], v1 = sum[4 * j + 2 * r + 1];
        __nv_bfloat162 o;
        if constexpr (kDx) {
          if (kTransform) {  // u = d xn: the relu mask, dx = u*a, sums of u*x and u
            float x0 = 0.f, x1 = 0.f, a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
            if (kVec) {
              const float2 xf = __bfloat1622float2(*sp);
              x0 = xf.x;
              x1 = xf.y;
              if (col < cols) {
                const float2 av = *reinterpret_cast<const float2*>(g.a + col);
                const float2 bv = *reinterpret_cast<const float2*>(g.b + col);
                a0 = av.x; a1 = av.y; b0 = bv.x; b1 = bv.y;
              }
            } else {
              if (col < cols) {
                a0 = g.a[col];
                b0 = g.b[col];
                if (in) x0 = __bfloat162float(g.x[orow + col]);
              }
              if (col + 1 < cols) {
                a1 = g.a[col + 1];
                b1 = g.b[col + 1];
                if (in) x1 = __bfloat162float(g.x[orow + col + 1]);
              }
            }
            if (kRelu) {
              if (!(__fadd_rn(__fmul_rn(x0, a0), b0) > 0.f)) v0 = 0.f;
              if (!(__fadd_rn(__fmul_rn(x1, a1), b1) > 0.f)) v1 = 0.f;
            }
            o = __floats2bfloat162_rn(v0 * a0, v1 * a1);
            if (in) {
              p0[0] += v0 * x0;
              p1[0] += v0;
              p0[1] += v1 * x1;
              p1[1] += v1;
            }
          } else {
            o = __floats2bfloat162_rn(v0, v1);
          }
        } else {
          o = __floats2bfloat162_rn(v0, v1);
          if (kStats && in) {  // statistics of the rounded y
            const float y0 = __bfloat162float(o.x), y1 = __bfloat162float(o.y);
            p0[0] += y0;
            p1[0] += y0 * y0;
            p0[1] += y1;
            p1[1] += y1 * y1;
          }
        }
        if (kVec) {
          *sp = o;
        } else if (in) {
          if (col < cols) g.out[orow + col] = o.x;
          if (col + 1 < cols) g.out[orow + col + 1] = o.y;
        }
      }
      if (kSums) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            p0[e] += __shfl_xor_sync(0xffffffffu, p0[e], o);
            p1[e] += __shfl_xor_sync(0xffffffffu, p1[e], o);
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
      for (int j = 0; j < BN / 64; ++j) tma_store_2d(&tout, ot + j * kAtomBytes, c0 + 64 * j, m0);
      bulk_commit();
      bulk_wait_read<1>();  // the previous tile's store has read its buffer
      if (kDx && kTransform && i > 0) mbar_arrive(&xempty[(i - 1) % kOuts]);
    }
    if (kSums && t < BN && c0 + t < cols) {
      float t0 = 0.f, t1 = 0.f;
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        t0 += red[v * BN + t];
        t1 += red[(8 + v) * BN + t];
      }
      float* prow = g.part + static_cast<long long>(m0 / kBM) * 2 * cols;
      prow[c0 + t] = t0;
      prow[cols + c0 + t] = t1;
    }
    named_barrier(1, kConsumers);  // red, and the other output tile, free for the next tile
  }
  if (kVec && t == 0) bulk_wait_read<0>();  // shared memory outlives the last store's reads
}

template <int BN, bool kTransform, bool kRelu, bool kStats, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
k4_fwd_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
             const __grid_constant__ CUtensorMap ty, const Args g) {
  k4_body<BN, false, kTransform, kRelu, kStats, kVec>(tx, tw, tw, ty, g);
}

template <int BN, bool kTransform, bool kRelu, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
k4_dx_wgmma(const __grid_constant__ CUtensorMap tdy, const __grid_constant__ CUtensorMap tw,
            const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdx,
            const Args g) {
  k4_body<BN, true, kTransform, kRelu, kTransform, kVec>(tdy, tw, tx, tdx, g);
}

// grid: one persistent CTA an SM (a CTA takes most of an SM's shared
// memory), no more than the output tiles; each tile is computed by one
// CTA whatever the grid, so the result does not depend on the card
inline unsigned persistent_grid(const Args& g, bool dx, int bn) {
  const long long tiles = static_cast<long long>((g.m + kBM - 1) / kBM) *
                          (((dx ? g.kdim : g.n) + bn - 1) / bn);
  const int ctas = sm_count();
  return static_cast<unsigned>(tiles < ctas ? tiles : ctas);
}

template <int BN, bool kTransform, bool kRelu, bool kStats, bool kVec>
cudaError_t launch_fwd(const CUtensorMap& tx, const CUtensorMap& tw, const CUtensorMap& ty,
                       const Args& g, cudaStream_t s) {
  auto kernel = k4_fwd_wgmma<BN, kTransform, kRelu, kStats, kVec>;
  constexpr int kSmem = Smem<BN, false>::kBytes;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const unsigned grid = persistent_grid(g, false, BN);
  if (grid == 0) return cudaErrorInvalidDevice;
  kernel<<<grid, kThreads, kSmem, s>>>(tx, tw, ty, g);
  return cudaGetLastError();
}

template <int BN, bool kTransform, bool kRelu, bool kVec>
cudaError_t launch_dx(const CUtensorMap& tdy, const CUtensorMap& tw, const CUtensorMap& tx,
                      const CUtensorMap& tdx, const Args& g, cudaStream_t s) {
  auto kernel = k4_dx_wgmma<BN, kTransform, kRelu, kVec>;
  constexpr int kSmem = Smem<BN, true>::kBytes;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const unsigned grid = persistent_grid(g, true, BN);
  if (grid == 0) return cudaErrorInvalidDevice;
  kernel<<<grid, kThreads, kSmem, s>>>(tdy, tw, tx, tdx, g);
  return cudaGetLastError();
}

template <int BN, bool kVec>
cudaError_t fwd_modes(int transform, int want_stats, const CUtensorMap& tx,
                      const CUtensorMap& tw, const CUtensorMap& ty, const Args& g,
                      cudaStream_t s) {
#define K4F_WG(TR, RE)                                              \
  (want_stats ? launch_fwd<BN, TR, RE, true, kVec>(tx, tw, ty, g, s) \
              : launch_fwd<BN, TR, RE, false, kVec>(tx, tw, ty, g, s))
  if (transform == 0) return K4F_WG(false, false);
  if (transform == 1) return K4F_WG(true, false);
  return K4F_WG(true, true);
#undef K4F_WG
}

template <int BN, bool kVec>
cudaError_t dx_modes(int transform, const CUtensorMap& tdy, const CUtensorMap& tw,
                     const CUtensorMap& tx, const CUtensorMap& tdx, const Args& g,
                     cudaStream_t s) {
  if (transform == 0) return launch_dx<BN, false, false, kVec>(tdy, tw, tx, tdx, g, s);
  if (transform == 1) return launch_dx<BN, true, false, kVec>(tdy, tw, tx, tdx, g, s);
  return launch_dx<BN, true, true, kVec>(tdy, tw, tx, tdx, g, s);
}

inline bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// bn: the output tile's width, 64 or 128 (ops/fused_matmul.py k4_plan);
// part: [ceil(m / 128), 2, n] (want_stats)
cudaError_t fwd(int bn, int transform, int want_stats, const void* x, const void* w,
                const void* a, const void* b, void* y, void* part, void* stats, int m, int kdim,
                int n, cudaStream_t s) {
  const bool vec = kdim % 8 == 0 && n % 8 == 0 && aligned(x) && aligned(w) && aligned(y) &&
                   (transform == 0 || (aligned(a) && aligned(b)));
  CUtensorMap tx{}, tw{}, ty{};
  if (vec) {
    const EncodeTiled encode = tensor_map_encoder();
    if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
    if (!tensor_map_2d(encode, &tx, x, m, kdim, kBM) ||
        !tensor_map_2d(encode, &tw, w, kdim, n, 64) ||
        !tensor_map_2d(encode, &ty, y, m, n, kBM)) {
      return cudaErrorInvalidValue;
    }
  }
  const Args g{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
               nullptr, static_cast<const float*>(a), static_cast<const float*>(b),
               static_cast<__nv_bfloat16*>(y), static_cast<float*>(part), m, kdim, n};
#define K4F_TILE(BN)                                                         \
  (vec ? fwd_modes<BN, true>(transform, want_stats, tx, tw, ty, g, s)       \
       : fwd_modes<BN, false>(transform, want_stats, tx, tw, ty, g, s))
  const cudaError_t err = bn == 128 ? K4F_TILE(128) : K4F_TILE(64);
#undef K4F_TILE
  if (err != cudaSuccess) return err;
  if (want_stats) colsum(part, (m + kBM - 1) / kBM, 2 * n, stats, s);
  return cudaGetLastError();
}

// bn: the output tile's width along K (k4_plan of the product dy @ w^T);
// part: [ceil(m / 128), 2, kdim] (transform)
cudaError_t dx(int bn, int transform, const void* dy, const void* w, const void* x,
               const void* a, const void* b, void* dxp, void* part, void* dstats, int m,
               int kdim, int n, cudaStream_t s) {
  const bool vec = kdim % 8 == 0 && n % 8 == 0 && aligned(dy) && aligned(w) && aligned(x) &&
                   aligned(dxp) && (transform == 0 || (aligned(a) && aligned(b)));
  CUtensorMap tdy{}, tw{}, tx{}, tdx{};
  if (vec) {
    const EncodeTiled encode = tensor_map_encoder();
    if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
    if (!tensor_map_2d(encode, &tdy, dy, m, n, kBM) ||
        !tensor_map_2d(encode, &tw, w, kdim, n, 64) ||
        !tensor_map_2d(encode, &tx, x, m, kdim, kBM) ||
        !tensor_map_2d(encode, &tdx, dxp, m, kdim, kBM)) {
      return cudaErrorInvalidValue;
    }
  }
  const Args g{static_cast<const __nv_bfloat16*>(dy), static_cast<const __nv_bfloat16*>(w),
               static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(a),
               static_cast<const float*>(b), static_cast<__nv_bfloat16*>(dxp),
               static_cast<float*>(part), m, kdim, n};
#define K4DX_TILE(BN)                                            \
  (vec ? dx_modes<BN, true>(transform, tdy, tw, tx, tdx, g, s)  \
       : dx_modes<BN, false>(transform, tdy, tw, tx, tdx, g, s))
  const cudaError_t err = bn == 128 ? K4DX_TILE(128) : K4DX_TILE(64);
#undef K4DX_TILE
  if (err != cudaSuccess) return err;
  if (transform != 0) colsum(part, (m + kBM - 1) / kBM, 2 * kdim, dstats, s);
  return cudaGetLastError();
}

}  // namespace wg

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

// f32 K4f (the CUDA-core kernel); transform: 0 none, 1 x*a+b, 2 relu(x*a+b)
void fwd_dispatch(int transform, int want_stats, const void* x, const void* w, const void* a,
                  const void* b, void* y, void* part, void* stats, int m, int kdim, int n,
                  cudaStream_t s) {
#define K4_FWD(TR, RE)                                                                  \
  (want_stats ? fwd<float, TR, RE, true>(x, w, a, b, y, part, stats, m, kdim, n, s)     \
              : fwd<float, TR, RE, false>(x, w, a, b, y, part, stats, m, kdim, n, s))
  if (transform == 0) K4_FWD(false, false);
  else if (transform == 1) K4_FWD(true, false);
  else K4_FWD(true, true);
#undef K4_FWD
}

bool shape_ok(int m, int kdim, int n) { return m > 0 && kdim > 0 && n > 0; }

// the tile k4_plan gives each design
bool tile_ok(int dtype, int block_n) {
  return dtype == kBF16 ? block_n == 64 || block_n == 128 : block_n == kBN;
}

}  // namespace

// part: f32 scratch [ceil(m / 128), 2, n] (want_stats), stats: f32 [2, n].
// block_n: the output tile's width from ops/fused_matmul.py k4_plan (bf16:
// 64 or 128; f32: 64).
extern "C" int port_k4_fwd(const void* x, const void* w, const void* a, const void* b, void* y,
                           void* part, void* stats, int m, int kdim, int n, int transform,
                           int want_stats, int block_n, int dtype, int device, void* stream) {
  // this library links its own CUDA runtime: select the caller's device
  // in it before launching on the caller's stream
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  if (!shape_ok(m, kdim, n) || transform < 0 || transform > 2 || !tile_ok(dtype, block_n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: fwd_dispatch(transform, want_stats, x, w, a, b, y, part, stats, m, kdim, n, s); break;
    case kBF16:
      return static_cast<int>(wg::fwd(block_n, transform, want_stats, x, w, a, b, y, part, stats,
                                       m, kdim, n, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// part: f32 scratch [ceil(m / 128), 2, kdim] (transform), dstats: f32 [2, kdim].
// block_n: as port_k4_fwd's, along K (k4_plan of dy @ w^T).
extern "C" int port_k4_dx(const void* dy, const void* w, const void* x, const void* a,
                          const void* b, void* dx, void* part, void* dstats, int m, int kdim,
                          int n, int transform, int block_n, int dtype, int device,
                          void* stream) {
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  if (!shape_ok(m, kdim, n) || transform < 0 || transform > 2 || !tile_ok(dtype, block_n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      if (transform == 0) dx_launch<float, false, false>(dy, w, x, a, b, dx, part, dstats, m, kdim, n, s);
      else if (transform == 1) dx_launch<float, true, false>(dy, w, x, a, b, dx, part, dstats, m, kdim, n, s);
      else dx_launch<float, true, true>(dy, w, x, a, b, dx, part, dstats, m, kdim, n, s);
      break;
    case kBF16:
      return static_cast<int>(wg::dx(block_n, transform, dy, w, x, a, b, dx, part, dstats, m,
                                      kdim, n, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
