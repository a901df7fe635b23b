// K6: the int8-weight matmul, y = x @ W with W[k, n] = T(f32(q[k, n]) *
// scale[n]): x [M, K] in T (bf16 or f32), q [K, N] int8 in the flax
// kernel's layout (N contiguous), one f32 scale a column, y [M, N] in T.
// Each weight is dequantized and rounded to T before its product, the
// products are summed in f32 and y is rounded once to T: the rounding
// points of the JAX QTensor.dequantize followed by nn.Dense(dtype=T).
//
// Replaces no TPU kernel. The JAX package keeps int8 weights at rest and
// dequantizes them inside its decode loops (pyspark_tf_gke_tpu/ops/
// quant.py:136 inloop_dequantize), where XLA fuses the convert and the
// scale into the matmul's weight operand, so that every step streams
// int8 from device memory. This kernel is that fusion on Hopper: done
// with tensor ops, the dequantization would write and read back a T copy
// of every weight at every step (5 bytes of traffic an element instead
// of 1).
//
// Bound on the H100: memory. At decode (M = 1-40 rows) a weight byte
// takes 2 M operations, far below the ~290 operations a byte at which
// the tensor cores would take over. GPT-small's 12 layers and lm_head
// stream 110 MB of int8 a step, 0.033 ms at 3.35 TB/s.
//
// First design, on the CUDA cores (SIMT):
//  - A CTA of 256 threads owns a tile of 128 columns, a range of K rows
//    (a split) and up to 8 rows of x (kRows, a template constant). A
//    thread owns 16 columns: lane & 7 picks the 16-column group, lane >>
//    3 one of the warp's 4 K rows, the warp one of 8 row quads, so that a
//    CTA step covers 32 K rows and each quarter warp reads 128
//    consecutive bytes of one K row (16-byte loads where N is a multiple
//    of 16; byte loads, masked, otherwise).
//  - The CTA's rows of x, for its K range, sit in shared memory as f32
//    (zeros past M and past K); a thread keeps its 16 column scales and
//    one f32 accumulator a (row, column) in registers.
//  - The thread's partial sums meet their warp's other K rows by two
//    shuffles, then the 8 warps' sums in shared memory, in warp order.
//  - Split-K: with few column tiles (N = 768 gives 6) the CTAs of one
//    split would leave the card idle, so K is cut into ranges until the
//    grid has about one CTA an SM. One split writes y itself; more write
//    f32 partials that int8_mm_reduce sums in split order. No atomics:
//    the result does not depend on scheduling.
// The launch shape comes from ops/int8_matmul.py int8_plan, from the
// shape alone, and check_plan below recomputes it. Nothing is allocated
// here and nothing synchronises, so the call can be captured in a CUDA
// graph (the wrapper allocates y and the partials).

#include "common.cuh"

using namespace port;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 128;                  // columns a CTA
constexpr int kColsThread = 16;              // columns a thread
constexpr int kKStep = kWarps * 4;           // K rows a CTA step
constexpr int kMaxRows = 8;                  // rows of x a CTA
constexpr int kSmemFloats = 12288;           // 48 KB of shared memory
constexpr int kTargetCtas = 132;             // about one CTA an SM
constexpr int kMaxGridYZ = 65535;

int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// ops/int8_matmul.py int8_plan: rows of x a CTA, K rows a split,
// splits, and the load width. Returns 0 if the caller's plan is it.
int check_plan(int m, int k, int n, int vec, int rows, int splits, int kps) {
  const int want_rows = m <= 1 ? 1 : m <= 2 ? 2 : m <= 4 ? 4 : kMaxRows;
  const int base = cdiv(n, kTileN) * cdiv(m, want_rows);
  const int ksteps = cdiv(k, kKStep);
  int want_splits = cdiv(kTargetCtas, base);
  if (want_splits > ksteps) want_splits = ksteps;
  if (want_splits < 1) want_splits = 1;
  int want_kps = cdiv(cdiv(k, want_splits), kKStep) * kKStep;
  const int kmax = (kSmemFloats / want_rows) / kKStep * kKStep;
  if (want_kps > kmax) want_kps = kmax;
  want_splits = cdiv(k, want_kps);
  const int want_vec = n % kColsThread == 0 ? kColsThread : 1;
  const bool ok = rows == want_rows && splits == want_splits && kps == want_kps &&
                  vec == want_vec && splits <= kMaxGridYZ &&
                  cdiv(m, rows) <= kMaxGridYZ;
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int smem_bytes(int rows, int kps) {
  const int red = kWarps * kTileN;  // the cross-warp sums, per row
  return rows * (kps > red ? kps : red) * static_cast<int>(sizeof(float));
}

template <typename T, int kRows, bool kVec>
__global__ void __launch_bounds__(kThreads)
int8_mm_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ scale, T* __restrict__ y, float* __restrict__ part,
               int m, int k, int n, int kps) {
  extern __shared__ float smem[];
  const int n0 = blockIdx.x * kTileN;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * kRows;
  const int k0 = split * kps;
  const int klen = min(k, k0 + kps) - k0;

  // this CTA's rows of x over its K range, as f32; zeros past M and K
  for (int idx = threadIdx.x; idx < kRows * kps; idx += kThreads) {
    const int r = idx / kps;
    const int i = idx - r * kps;
    float v = 0.f;
    if (m0 + r < m && i < klen) v = to_f32(x[static_cast<long long>(m0 + r) * k + k0 + i]);
    smem[idx] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = lane & 7;
  const int col = n0 + group * kColsThread;
  float acc[kRows][kColsThread];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < kColsThread; ++j) acc[r][j] = 0.f;
  }
  if (col < n) {
    float s[kColsThread];
#pragma unroll
    for (int j = 0; j < kColsThread; ++j) s[j] = (kVec || col + j < n) ? scale[col + j] : 0.f;
#pragma unroll 4
    for (int i = warp * 4 + (lane >> 3); i < klen; i += kKStep) {
      const int8_t* row = q + static_cast<long long>(k0 + i) * n + col;
      int8_t w8[kColsThread];
      if (kVec) {
        const int4 chunk = __ldg(reinterpret_cast<const int4*>(row));
        const int words[4] = {chunk.x, chunk.y, chunk.z, chunk.w};
#pragma unroll
        for (int j = 0; j < kColsThread; ++j) {
          w8[j] = static_cast<int8_t>((words[j >> 2] >> (8 * (j & 3))) & 0xff);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kColsThread; ++j) w8[j] = col + j < n ? row[j] : int8_t{0};
      }
#pragma unroll
      for (int j = 0; j < kColsThread; ++j) {
        // the weight in T, as QTensor.dequantize and the Dense cast give it
        const float w = round_through<T>(static_cast<float>(w8[j]) * s[j]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][j] = fmaf(smem[r * kps + i], w, acc[r][j]);
      }
    }
  }
  // the warp's 4 K rows: lanes 8 and 16 apart hold the same columns
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < kColsThread; ++j) {
      acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], 8);
      acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], 16);
    }
  }
  __syncthreads();  // every read of x is done: the buffer takes the sums
  if (lane < 8) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < kColsThread; ++j) {
        smem[(warp * kRows + r) * kTileN + group * kColsThread + j] = acc[r][j];
      }
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < kRows * kTileN; o += kThreads) {
    const int r = o / kTileN;
    const int c = o - r * kTileN;
    if (m0 + r >= m || n0 + c >= n) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += smem[(w * kRows + r) * kTileN + c];
    const long long out = static_cast<long long>(m0 + r) * n + n0 + c;
    if (part == nullptr) {
      y[out] = from_f32<T>(sum);
    } else {
      part[static_cast<long long>(split) * m * n + out] = sum;
    }
  }
}

// y = T(sum of the splits' partials), in split order
template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_mm_reduce(const float* __restrict__ part, T* __restrict__ y, int splits, long long mn) {
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < mn;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += part[s * mn + i];
    y[i] = from_f32<T>(sum);
  }
}

template <typename T, int kRows, bool kVec>
int launch_rows(const void* x, const void* q, const void* scale, void* y, void* part, int m, int k,
                int n, int splits, int kps, cudaStream_t stream) {
  const dim3 grid(cdiv(n, kTileN), splits, cdiv(m, kRows));
  int8_mm_kernel<T, kRows, kVec><<<grid, kThreads, smem_bytes(kRows, kps), stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<T*>(y), splits > 1 ? static_cast<float*>(part) : nullptr, m, k, n, kps);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  if (splits > 1) {
    const long long mn = static_cast<long long>(m) * n;
    const long long need = (mn + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(need < 4096 ? need : 4096);
    int8_mm_reduce<T><<<blocks, kThreads, 0, stream>>>(static_cast<const float*>(part),
                                                       static_cast<T*>(y), splits, mn);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kVec>
int launch_vec(const void* x, const void* q, const void* scale, void* y, void* part, int m, int k,
               int n, int rows, int splits, int kps, cudaStream_t stream) {
  switch (rows) {
    case 1: return launch_rows<T, 1, kVec>(x, q, scale, y, part, m, k, n, splits, kps, stream);
    case 2: return launch_rows<T, 2, kVec>(x, q, scale, y, part, m, k, n, splits, kps, stream);
    case 4: return launch_rows<T, 4, kVec>(x, q, scale, y, part, m, k, n, splits, kps, stream);
    case 8: return launch_rows<T, 8, kVec>(x, q, scale, y, part, m, k, n, splits, kps, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(const void* x, const void* q, const void* scale, void* y, void* part, int m, int k,
             int n, int vec, int rows, int splits, int kps, cudaStream_t stream) {
  if (vec == kColsThread) {
    return launch_vec<T, true>(x, q, scale, y, part, m, k, n, rows, splits, kps, stream);
  }
  return launch_vec<T, false>(x, q, scale, y, part, m, k, n, rows, splits, kps, stream);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x [m, k] (dtype), q [k, n] int8, scale [n] f32, y [m, n] (dtype); part
// [splits, m, n] f32 when splits > 1 (else unused). vec, rows, splits,
// kps: the plan of ops/int8_matmul.py int8_plan, checked here; 16-byte
// loads (vec 16) need n a multiple of 16 and q 16-byte aligned.
extern "C" int port_int8_matmul(const void* x, const void* q, const void* scale, void* y,
                                void* part, int m, int k, int n, int vec, int rows, int splits,
                                int kps, int dtype, int device, void* stream) {
  // this library links its own CUDA runtime: select the caller's device
  // in it before launching on the caller's stream
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (int rc = check_plan(m, k, n, vec, rows, splits, kps)) return rc;
  if ((vec == kColsThread && !aligned16(q)) || (splits > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return dispatch<float>(x, q, scale, y, part, m, k, n, vec, rows, splits, kps, s);
    case kBF16:
      return dispatch<__nv_bfloat16>(x, q, scale, y, part, m, k, n, vec, rows, splits, kps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
