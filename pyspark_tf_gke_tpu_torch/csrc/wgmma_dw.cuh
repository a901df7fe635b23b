// The tensor-core mainloop of the bf16 weight gradients, K4dw
// (fused_matmul.cu, the 1x1 convs) and K5dw (fused_conv3.cu, the 3x3
// conv): dw = xn^T dy summed over pixels, xn = relu(x*a + b) rounded to
// bf16, the products summed in f32 and dw rounded once.
//
// The output is a weight tile [64 input channels, 64 output channels]
// per warpgroup; the reduction runs over pixels, 64 a step. A step
// stages, in 128-byte swizzled shared memory, kATiles tiles of x
// [64 pixels, 64 channels] and kBTiles tiles of dy [64 pixels, 64
// channels]. Both are MN-major operands of wgmma (the channels
// contiguous): A = x^T through the transpose-A bit, B = dy through the
// transpose-B bit, a k16 step advancing 16 pixel rows (2048 bytes).
// Warpgroup g multiplies A tile `ai` by B tile `bj` (its own choice):
// K4dw's CTA is a kATiles x kBTiles grid of warpgroups over one staged x
// and dy; K5dw's three warpgroups share one x tile and each gathers the
// dy rows of its own tap.
//
// The ring has kStages slots; the copies of step s + 2 are issued after
// the barrier of step s, into the slot of step s - 2, whose products
// every warpgroup has finished. The input transform runs in place on the
// landed x tiles (each thread a fixed set of 16-byte chunks, a and b of
// the CTA's channels read from shared memory), then the proxy fence and
// the barrier hand the step to wgmma. Off-tensor rows and channels are
// zero: a channel past K has x = a = b = 0 and stays 0; a pixel row past
// the split has a zero dy row, so its product is 0 whatever relu(b)
// gives.
//
// Accumulation: kFresh steps chain into one wgmma accumulator, which is
// then added to an f32 sum. One step, from the measured accuracy against
// an f64 reference (PERF.md; kernel_probe.py dw-accuracy): chaining a
// whole split put 4-8x as many dw elements a bf16 rounding away.
#pragma once

#include "common.cuh"
#include "wgmma.cuh"

namespace port {
namespace dw {

using namespace port::hopper;

constexpr int kPix = 64;                // pixels a step: one TMA box of rows, four k16 steps
constexpr int kTileBytes = kPix * 128;  // one [64 pixels, 64 channels] bf16 tile
constexpr int kChunks = kTileBytes / 16;  // 16-byte chunks a tile: 64 rows x 8
// Ring depth. 6 slots (four steps in flight) measured the same as 4
// (PERF.md): a step is bound by its barrier and issue, not by the
// copies' latency.
constexpr int kStages = 4;
constexpr int kAhead = kStages - 2;  // a slot is refilled only after its products finished
constexpr int kFresh = 1;  // steps a wgmma accumulator chains before its f32 add

// The shared memory of a CTA: a kStages-slot ring of kATiles x tiles
// and kBTiles dy tiles a step, a barrier a slot, a and b of the CTA's
// kATiles*64 channels.
template <int kATiles_, int kBTiles_>
struct Ring {
  static constexpr int kATiles = kATiles_, kBTiles = kBTiles_;
  static constexpr int kTiles = kATiles + kBTiles;
  static constexpr int kStageBytes = kTiles * kTileBytes;
  // dynamic shared memory, with 1024 of slack to align the swizzled tiles
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 8 * kStages + 2 * kATiles * 64 * 4;

  uint8_t* ring;   // [kStages][kTiles]
  uint64_t* bars;  // [kStages]: the TMA loads of a step
  float* a;        // [kATiles * 64]
  float* b;

  __device__ __forceinline__ explicit Ring(uint8_t* raw) {
    ring = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
    bars = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
    a = reinterpret_cast<float*>(bars + kStages);
    b = a + kATiles * 64;
  }
  // step s's slot and its barrier, and the barrier's phase at step s
  __device__ __forceinline__ uint8_t* slot(int s) const { return ring + (s % kStages) * kStageBytes; }
  __device__ __forceinline__ uint64_t* bar(int s) const { return &bars[s % kStages]; }
  __device__ __forceinline__ uint32_t phase(int s) const { return (s / kStages) & 1; }
};

// Before any copy: the slot barriers (thread 0) and a, b of channels
// [c0, c0 + 64 * kATiles), 0 past K (never read from a or b there).
template <class R>
__device__ __forceinline__ void setup(const R& ring, const float* __restrict__ a,
                                      const float* __restrict__ b, int c0, int kdim,
                                      bool transform) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&ring.bars[i], 1);
    mbar_init_fence();
  }
  if (transform) {
    for (int i = threadIdx.x; i < R::kATiles * 64; i += blockDim.x) {
      const bool in = c0 + i < kdim;
      ring.a[i] = in ? a[c0 + i] : 0.f;
      ring.b[i] = in ? b[c0 + i] : 0.f;
    }
  }
  __syncthreads();
}

// One 16-byte chunk (8 channels) of a tile, element by element from a
// row-major bf16 matrix: row `row` (valid or zero), columns col..col+7
// (those < ncols). The edge path's copy, for shapes or pointers that
// 16-byte copies cannot take.
__device__ __forceinline__ void copy_chunk_elems(uint8_t* dst, const __nv_bfloat16* __restrict__ src,
                                                 long long row, bool valid, int col, int ncols,
                                                 int ld) {
  __align__(16) __nv_bfloat16 v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = (valid && col + e < ncols) ? src[row * ld + col + e] : __float2bfloat16(0.f);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

// The input transform in place on the x tiles of a landed step: chunk
// idx = t + nthreads*k of the kATiles tiles (tile idx / 512, row (idx %
// 512) / 8, chunk idx % 8), x*a then + b each rounded, relu, rounded to
// bf16 once (norm_transform's arithmetic, two channels a conversion).
template <bool kRelu, class R>
__device__ __forceinline__ void transform(uint8_t* stage, const R& ring) {
  for (int idx = threadIdx.x; idx < R::kATiles * kChunks; idx += blockDim.x) {
    const int tile = idx / kChunks, row = (idx % kChunks) >> 3, c = idx & 7;
    uint4* chunk = reinterpret_cast<uint4*>(stage + tile * kTileBytes + sw128(row, c));
    const float* av = ring.a + tile * 64 + c * 8;
    const float* bv = ring.b + tile * 64 + c * 8;
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
}

// The mainloop. issue(s): start the copies of step s (or, for s >=
// nsteps, only what keeps the cp.async group count in step); landed(s):
// wait for step s's copies; prepare(stage): the transform. Warpgroup
// multiplies x tile ai by dy tile bj; sum: its f32 result [64 x 64] in
// the accumulator layout of wgmma.cuh.
template <class R, class Issue, class Landed, class Prepare>
__device__ __forceinline__ void mainloop(float (&sum)[32], const R& ring, int nsteps, int ai,
                                         int bj, Issue issue, Landed landed, Prepare prepare) {
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = sum[i] = 0.f;
  auto add = [&] {
    wgmma_wait<0>();
    fence_operand(acc);
#pragma unroll
    for (int i = 0; i < 32; ++i) sum[i] += acc[i];
  };
#pragma unroll
  for (int s = 0; s < kAhead; ++s) issue(s);
  for (int s = 0; s < nsteps; ++s) {
    uint8_t* stage = ring.slot(s);
    landed(s);
    prepare(stage);                      // while step s-1's products run
    if (s > 0 && s % kFresh == 0) add();  // step s-1 ended a group
    fence_proxy_async();  // this thread's shared-memory writes before the products' reads
    __syncthreads();      // every thread's; and every warpgroup's step s-2 products are done
    issue(s + kAhead);
    const uint32_t a_addr = smem_u32(stage) + ai * kTileBytes;
    const uint32_t b_addr = smem_u32(stage) + (R::kATiles + bj) * kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_ss<1, 1>(acc, desc_mnmajor(a_addr + kk * 2048),
                               desc_mnmajor(b_addr + kk * 2048),
                               (s % kFresh == 0 && kk == 0) ? 0 : 1);  // a group starts at 0
    wgmma_commit();
    wgmma_wait<1>();  // step s-1's products are done
  }
  add();  // the last group
}

// Write this warpgroup's sum to out[row, col] (row-major, ld columns)
// for the tile's rows r0 + [0, 64) < nrows and columns c0 + [0, 64) <
// ncols: f32 partials, summed over the splits in order afterwards.
__device__ __forceinline__ void store(const float (&sum)[32], float* __restrict__ out, int r0,
                                      int nrows, int c0, int ncols) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const bool pairs = (ncols & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 16 * warp + (lane >> 2) + 8 * h;
    if (row >= nrows) continue;
    float* orow = out + static_cast<long long>(row) * ncols;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + 8 * j + 2 * (lane & 3);
      const float v0 = sum[4 * j + 2 * h], v1 = sum[4 * j + 2 * h + 1];
      if (pairs && col + 1 < ncols) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
      } else {
        if (col < ncols) orow[col] = v0;
        if (col + 1 < ncols) orow[col + 1] = v1;
      }
    }
  }
}

}  // namespace dw
}  // namespace port
