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
// once; ~17 f32 operations per element. At the LM's [8192, 768] bf16
// that is 37.8 MB, 0.0113 ms at 3.35 TB/s.
//
// One design for every width D from 1 to 8192 (the plan of
// ops/layernorm.py ln_plan, its bwd_* fields, which the wrapper passes
// and check_plan below recomputes):
//  - 16-byte loads and stores (8 bf16 or 4 f32 a chunk) where D is a
//    multiple of the chunk and every pointer is 16-byte aligned; else
//    one element a load (the scalar variant).
//  - A row belongs to `row_threads` threads: one warp while a lane holds
//    at most 3 chunks in bf16 (D 768), 4 in f32 (D 512) or 8 elements
//    scalar (D 256), else the fewest warps (a power of two) within those
//    limits; a warp's row sums are shuffles, a row of several warps
//    meets in shared memory in warp order. Each thread holds `kPer`
//    chunks of its row, chunk c at column c * kVec, c = place + k *
//    row_threads: the values a thread holds are sized by D (768 in bf16:
//    3 chunks, 24 values a lane), a template constant. The limits keep a
//    thread within 128 registers (at 4 bf16 chunks ptxas gave it 177, one
//    256-thread CTA an SM, and it was 1.35x slower at D 1600; PERF.md).
//  - x and g stay in registers as loaded (bf16 pairs) and xhat is
//    recomputed from them in each pass; the f32 scale is re-read for each
//    row from L1, 16 bytes at a time. Each thread keeps the running g *
//    xhat and g sums of its columns in f32 registers across the rows it
//    walks.
//  - A row's loads (x, r, g) are all issued before its first reduction.
//    A row of several warps (D > 768 in bf16) also has the next row in
//    flight: each thread copies its chunks of the next row by cp.async
//    into its own slots of a 2-row shared-memory stage while it computes
//    this one (no registers, no barrier: a thread reads back only its
//    own copies). Replayed from a CUDA graph on an H100 it was 6-15%
//    faster at D 1280-4096 and 9-25% with the residual, and 12% slower
//    at 768 (a row a warp), which loads directly (PERF.md).
//  - A fixed grid of at most 256 CTAs (256 threads, or a row's threads
//    if more) walks the rows: one wave on the card at two CTAs an SM
//    (128 registers a thread).
//
// The column sums need a reduction across rows, and blocks run in no
// order, so each CTA writes one partial row (its row groups' sums added
// in group order through shared memory, or from registers when a CTA
// holds one row at a time), and a second kernel sums the partial rows of
// each column in block order (sixteen strided runs a column, then those
// sixteen in order). No atomics: the result does not depend on
// scheduling, and the grid does not depend on the card.

#include "common.cuh"
#include "wgmma.cuh"

using namespace port;

namespace {

constexpr int kMaxD = 8192;
constexpr int kCtaThreads = 256;  // threads a CTA, or a row's threads if more
constexpr int kMaxChunksBf16 = 3;  // 16-byte chunks a thread a row, bf16
constexpr int kMaxChunksF32 = 4;   // and f32
constexpr int kScalarPer = 8;      // elements a thread a row, the scalar variant
constexpr int kMaxBlocks = 256;   // the fixed grid: one partial row a CTA
constexpr int kReduceRuns = 16;   // strided runs a column in ln_bwd_reduce

// the most threads a CTA of each variant takes (ln_plan stays within
// them at D <= kMaxD): chunks 512 (128 registers a thread), scalar 1024
__host__ __device__ constexpr int max_threads(int vec) { return vec == 1 ? 1024 : 512; }

template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Chunk {
  T e[kVec];
};

// Sum of v over the threads of a row: a warp shuffle, then, for a row
// of several warps, the row's warps through `red` in warp order. Every
// thread of the CTA calls it the same number of times (a barrier inside
// when a row spans warps; warps_per_row is the same for the whole CTA).
__device__ __forceinline__ float row_sum(float v, float* red, int warps_per_row) {
  v = warp_sum(v);
  if (warps_per_row == 1) return v;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  const int first = warp - warp % warps_per_row;
  float s = 0.f;
  for (int i = 0; i < warps_per_row; ++i) s += red[first + i];
  return s;
}

// kVec f32 scale values of the chunk at column col, from L1
template <int kVec>
__device__ __forceinline__ void load_scale(const float* scale, int col, float (&sc)[kVec]) {
  if constexpr (kVec == 1) {
    sc[0] = __ldg(scale + col);
  } else {
#pragma unroll
    for (int i = 0; i < kVec / 4; ++i) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(scale + col) + i);
      sc[4 * i] = a.x;
      sc[4 * i + 1] = a.y;
      sc[4 * i + 2] = a.z;
      sc[4 * i + 3] = a.w;
    }
  }
}

// One row's 16-byte chunks of x, g (and r) for this thread, by cp.async
// into its slots of staging buffer `buf`; chunks past the row or past
// the last row arrive as zeros.
template <typename T, int kVec, int kPer, int kStreams>
__device__ __forceinline__ void stage_row(uint4* stage, int buf, const T* __restrict__ x,
                                          const T* __restrict__ g, const T* __restrict__ r,
                                          long long row, bool live, int place, int row_threads,
                                          int d) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int col = (place + k * row_threads) * kVec;
    const bool ok = live && col < d;
#pragma unroll
    for (int s = 0; s < kStreams; ++s) {
      const T* base = s == 0 ? x : (s == 1 ? g : r);
      uint4* dst = stage + ((buf * kStreams + s) * kPer + k) * blockDim.x + threadIdx.x;
      hopper::cp_async16(hopper::smem_u32(dst), ok ? base + row * d + col : base, ok ? 16 : 0);
    }
  }
}

template <typename T, int kVec, int kPer, bool kResidual, bool kStaged>
__global__ void __launch_bounds__(max_threads(kVec))
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ g,
              const float* __restrict__ scale, T* __restrict__ dx,
              float* __restrict__ part_scale, float* __restrict__ part_bias, int rows, int d,
              int row_threads, float eps) {
  using C = Chunk<T, kVec>;
  constexpr int kN = kPer * kVec;
  // four row sums a row, each its own buffer: a buffer is written again
  // only after a later barrier that every reader of it has passed
  __shared__ float red[4][32];
  static_assert(!kStaged || kVec > 1, "staging copies 16-byte chunks");
  constexpr int kStreams = kResidual ? 3 : 2;
  extern __shared__ __align__(16) unsigned char dyn[];
  uint4* stage = reinterpret_cast<uint4*>(dyn);  // [2][kStreams][kPer][threads]
  float* blk = reinterpret_cast<float*>(           // [2][d]: the partial row
      dyn + (kStaged ? 2 * kStreams * kPer * blockDim.x * 16 : 0));
  const int place = threadIdx.x % row_threads;
  const int group = threadIdx.x / row_threads;
  const int groups = blockDim.x / row_threads;  // rows a CTA has in flight
  const int warps_per_row = row_threads >> 5;
  const float fd = static_cast<float>(d);

  float ds[kN], db[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    ds[i] = 0.f;
    db[i] = 0.f;
  }
  // every thread of the CTA walks the same row groups, so the row
  // reductions' barriers line up; a group past the last row only takes
  // part in them
  const long long first = static_cast<long long>(blockIdx.x) * groups;
  const long long stride = static_cast<long long>(gridDim.x) * groups;
  if constexpr (kStaged) {
    if (first < rows) {
      stage_row<T, kVec, kPer, kStreams>(stage, 0, x, g, r, first + group,
                                         first + group < rows, place, row_threads, d);
    }
    hopper::cp_async_commit();
  }
  int it = 0;
  for (long long base = first; base < rows; base += stride, ++it) {
    const long long row = base + group;
    const bool live = row < rows;
    C cx[kPer], cg[kPer];
    if constexpr (kStaged) {  // the next row in flight while this one is computed
      const long long next = base + stride;
      if (next < rows) {
        stage_row<T, kVec, kPer, kStreams>(stage, (it + 1) & 1, x, g, r, next + group,
                                           next + group < rows, place, row_threads, d);
      }
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();  // this thread's copies of this row have landed
      const int buf = it & 1;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const uint4* slot = stage + ((buf * kStreams) * kPer + k) * blockDim.x + threadIdx.x;
        cx[k] = *reinterpret_cast<const C*>(slot);
        cg[k] = *reinterpret_cast<const C*>(slot + kPer * blockDim.x);
        if constexpr (kResidual) {
          const C cr = *reinterpret_cast<const C*>(slot + 2 * kPer * blockDim.x);
#pragma unroll
          for (int e = 0; e < kVec; ++e)  // x + r rounded to x's dtype
            cx[k].e[e] = from_f32<T>(to_f32(cx[k].e[e]) + to_f32(cr.e[e]));
        }
      }
    } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {  // the whole row in flight
      const int col = (place + k * row_threads) * kVec;
      if (live && col < d) {
        cx[k] = *reinterpret_cast<const C*>(x + row * d + col);
        cg[k] = *reinterpret_cast<const C*>(g + row * d + col);
        if constexpr (kResidual) {
          const C cr = *reinterpret_cast<const C*>(r + row * d + col);
#pragma unroll
          for (int e = 0; e < kVec; ++e)  // x + r rounded to x's dtype
            cx[k].e[e] = from_f32<T>(to_f32(cx[k].e[e]) + to_f32(cr.e[e]));
        }
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          cx[k].e[e] = from_f32<T>(0.f);
          cg[k].e[e] = from_f32<T>(0.f);
        }
      }
    }
    }
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) sum += to_f32(cx[k].e[e]);
    }
    const float mean = row_sum(sum, red[0], warps_per_row) / fd;
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if ((place + k * row_threads) * kVec < d) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float c = to_f32(cx[k].e[e]) - mean;
          sq += c * c;
        }
      }
    }
    const float inv = rsqrtf(row_sum(sq, red[1], warps_per_row) / fd + eps);
    float sum_gs = 0.f, sum_gsx = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int col = (place + k * row_threads) * kVec;
      if (col < d) {
        float sc[kVec];
        load_scale<kVec>(scale, col, sc);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float xhat = (to_f32(cx[k].e[e]) - mean) * inv;
          const float gg = to_f32(cg[k].e[e]);
          const float gs = gg * sc[e];
          sum_gs += gs;
          sum_gsx += gs * xhat;
          ds[k * kVec + e] += gg * xhat;
          db[k * kVec + e] += gg;
        }
      }
    }
    sum_gs = row_sum(sum_gs, red[2], warps_per_row);
    sum_gsx = row_sum(sum_gsx, red[3], warps_per_row);
    const float f = inv / fd;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int col = (place + k * row_threads) * kVec;
      if (live && col < d) {
        float sc[kVec];
        load_scale<kVec>(scale, col, sc);
        C out;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float xhat = (to_f32(cx[k].e[e]) - mean) * inv;
          const float gs = to_f32(cg[k].e[e]) * sc[e];
          out.e[e] = from_f32<T>(f * (fd * gs - sum_gs - xhat * sum_gsx));
        }
        *reinterpret_cast<C*>(dx + row * d + col) = out;
      }
    }
  }

  if constexpr (kStaged) hopper::cp_async_wait<0>();
  float* ps = part_scale + static_cast<long long>(blockIdx.x) * d;
  float* pb = part_bias + static_cast<long long>(blockIdx.x) * d;
  if (groups == 1) {  // one row at a time: each thread writes its own columns
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int col = (place + k * row_threads) * kVec + e;
        if (col < d) {
          ps[col] = ds[k * kVec + e];
          pb[col] = db[k * kVec + e];
        }
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < 2 * d; i += blockDim.x) blk[i] = 0.f;
  __syncthreads();
  for (int gi = 0; gi < groups; ++gi) {  // group order: deterministic
    if (group == gi) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int col = (place + k * row_threads) * kVec + e;
          if (col < d) {
            blk[col] += ds[k * kVec + e];
            blk[d + col] += db[k * kVec + e];
          }
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    ps[i] = blk[i];
    pb[i] = blk[d + i];
  }
}

// Column sums of the [nparts, d] partial rows: a CTA takes 32 columns;
// its warp k sums the rows k, k + 16, ... in order, then the sixteen
// runs are added in run order. Coalesced, and the same order on any
// card.
__global__ void __launch_bounds__(32 * kReduceRuns)
ln_bwd_reduce(const float* __restrict__ part_scale, const float* __restrict__ part_bias,
              int nparts, int d, float* __restrict__ dscale, float* __restrict__ dbias) {
  __shared__ float red[2][kReduceRuns][32];
  const int c = threadIdx.x & 31, k = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + c;
  float s = 0.f, b = 0.f;
  if (col < d) {
#pragma unroll 4
    for (int p = k; p < nparts; p += kReduceRuns) {
      s += part_scale[static_cast<long long>(p) * d + col];
      b += part_bias[static_cast<long long>(p) * d + col];
    }
  }
  red[0][k][c] = s;
  red[1][k][c] = b;
  __syncthreads();
  if (k == 0 && col < d) {
    float ts = 0.f, tb = 0.f;
#pragma unroll
    for (int i = 0; i < kReduceRuns; ++i) {
      ts += red[0][i][c];
      tb += red[1][i][c];
    }
    dscale[col] = ts;
    dbias[col] = tb;
  }
}

template <typename T, int kVec, int kPer, bool kStaged>
void launch_rows(const void* x, const void* r, const void* g, const void* scale, void* dx,
                 float* part_scale, float* part_bias, int rows, int d, int nparts,
                 int row_threads, int threads, float eps, cudaStream_t stream) {
  // the staging buffers, then the partial row when a CTA holds several
  // rows (row_threads <= 128)
  const size_t staged = kStaged ? 2 * (r != nullptr ? 3 : 2) * kPer * threads * 16 : 0;
  const size_t smem = staged + (threads > row_threads ? 2 * sizeof(float) * d : 0);
  if (r != nullptr) {
    cudaFuncSetAttribute(ln_bwd_kernel<T, kVec, kPer, true, kStaged>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    ln_bwd_kernel<T, kVec, kPer, true, kStaged><<<nparts, threads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const T*>(g),
        static_cast<const float*>(scale), static_cast<T*>(dx), part_scale, part_bias, rows, d,
        row_threads, eps);
  } else {
    cudaFuncSetAttribute(ln_bwd_kernel<T, kVec, kPer, false, kStaged>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    ln_bwd_kernel<T, kVec, kPer, false, kStaged><<<nparts, threads, smem, stream>>>(
        static_cast<const T*>(x), nullptr, static_cast<const T*>(g),
        static_cast<const float*>(scale), static_cast<T*>(dx), part_scale, part_bias, rows, d,
        row_threads, eps);
  }
}

template <typename T>
int launch(const void* x, const void* r, const void* g, const void* scale, void* dx,
           void* part_scale, void* part_bias, void* dscale, void* dbias, int rows, int d,
           int nparts, int vec, int per, int row_threads, int threads, float eps,
           cudaStream_t stream) {
  constexpr int kChunk = 16 / sizeof(T);
  float* ps = static_cast<float*>(part_scale);
  float* pb = static_cast<float*>(part_bias);
  // a row of one warp loads directly; a row of several warps brings the
  // next row by cp.async while it computes this one
  const bool staged = row_threads > 32;
#define PORT_ROWS(V, P, ST) \
  launch_rows<T, V, P, ST>(x, r, g, scale, dx, ps, pb, rows, d, nparts, row_threads, threads, eps, stream)
  if (vec == 1) {
    PORT_ROWS(1, kScalarPer, false);
  } else {
    switch (per) {
      case 1: PORT_ROWS(kChunk, 1, false); break;  // one warp a row (ln_plan)
      case 2: staged ? PORT_ROWS(kChunk, 2, true) : PORT_ROWS(kChunk, 2, false); break;
      case 3: staged ? PORT_ROWS(kChunk, 3, true) : PORT_ROWS(kChunk, 3, false); break;
      case 4:  // f32 only (bf16 takes at most 3 chunks a thread)
        if constexpr (kChunk == 4) {
          staged ? PORT_ROWS(kChunk, 4, true) : PORT_ROWS(kChunk, 4, false);
          break;
        }
        return static_cast<int>(cudaErrorInvalidValue);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef PORT_ROWS
  ln_bwd_reduce<<<(d + 31) / 32, 32 * kReduceRuns, 0, stream>>>(
      ps, pb, nparts, d, static_cast<float*>(dscale), static_cast<float*>(dbias));
  return 0;
}

// ln_plan's backward fields (ops/layernorm.py) for width d with chunks of
// vec elements (chunk: the dtype's 16-byte chunk). Returns 0 if (vec,
// per, row_threads, threads) is that plan.
int check_plan(int d, int vec, int per, int row_threads, int threads, int chunk) {
  if (vec != 1 && vec != chunk) return static_cast<int>(cudaErrorInvalidValue);
  const int max_per = vec == 1 ? kScalarPer : vec == 8 ? kMaxChunksBf16 : kMaxChunksF32;
  const int n = (d + vec - 1) / vec;  // chunks a row
  int rt = 32;
  while (rt * max_per < n) rt *= 2;
  const int want = vec == 1 ? kScalarPer : (n + rt - 1) / rt;
  const int cta = rt > kCtaThreads ? rt : kCtaThreads;
  const bool ok = per == want && row_threads == rt && threads == cta &&
                  threads <= max_threads(vec);
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// part_scale/part_bias: f32 scratch [nparts, d]; vec, per, row_threads,
// threads: ln_plan's bwd_vec, bwd_per, bwd_row_threads, bwd_threads;
// nparts must be min(256, ceil(rows / (threads / row_threads))) (the
// wrapper's figure). The chunked variant (vec > 1) needs d a multiple of
// vec and x, r, g, scale and dx 16-byte aligned.
extern "C" int port_layernorm_bwd(const void* x, const void* r, const void* g,
                                  const void* scale, void* dx, void* part_scale,
                                  void* part_bias, void* dscale, void* dbias,
                                  int rows, int d, int nparts, int vec, int per,
                                  int row_threads, int threads, float eps, int dtype,
                                  int device, void* stream) {
  // this library links its own CUDA runtime: select the caller's
  // device in it before launching on the caller's stream
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  if (rows <= 0) return 0;
  if (d <= 0 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = dtype == kF32 ? 4 : 8;
  if (int rc = check_plan(d, vec, per, row_threads, threads, chunk)) return rc;
  if (vec > 1 && (d % vec != 0 || !aligned16(x) || !aligned16(g) || !aligned16(scale) ||
                  !aligned16(dx) || (r != nullptr && !aligned16(r)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = threads / row_threads;
  const int want = (rows + groups - 1) / groups;
  if (nparts != (want < kMaxBlocks ? want : kMaxBlocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case kF32: rc = launch<float>(x, r, g, scale, dx, part_scale, part_bias, dscale, dbias, rows, d, nparts, vec, per, row_threads, threads, eps, s); break;
    case kBF16: rc = launch<__nv_bfloat16>(x, r, g, scale, dx, part_scale, part_bias, dscale, dbias, rows, d, nparts, vec, per, row_threads, threads, eps, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
