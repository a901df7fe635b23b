// K2 backward: flash attention gradients on [B, S, H, D] with the same
// causal, key-padding (kv_mask) and segment-id masks as the forward.
// Two kernels, as in the TPU split: K2dq walks key tiles and writes dQ;
// K2dkv walks query tiles and writes dK and dV. Neither uses atomics, so
// the results do not depend on the order in which blocks run.
//
// Replaces pyspark_tf_gke_tpu/ops/pallas/flash_attention.py::_dq_kernel
// (:162, launched :304) and ::_dkv_kernel (:215, launched :324), driven
// by _flash_bwd_bh (:275).
//
// Both recompute the probabilities from the forward's logsumexp instead
// of storing them: p = exp(s - lse), dp = dO.v, ds = p * (dp - delta) *
// scale with delta = rowsum(dO * O) (computed by the caller, as the TPU
// version computes it outside Pallas). Rows with lse = +inf (no unmasked
// key) get p = 0 and contribute nothing. The rounding points are the TPU
// kernels': for bf16, P is rounded to bf16 before dV += P^T dO (:255)
// and dS before dK += dS^T Q (:262) and dQ += dS K (:202); f32 keeps
// both in f32.
//
// Bound on the H100: at the training shapes (B=16 S=512 H=12 D=64,
// causal) K2dkv does 8*D operations a visible (query, key) pair (S, dP,
// dV, dK) against q, k, v, dO, dK, dV and the f32 row vectors once:
// 0.0228 ms of bytes against 0.0130 ms of bf16 tensor-core operations,
// so bound by bytes, and in practice by how fast the products are fed.
//
// Each entry point chooses the design by dtype and nothing else: bf16
// runs the tensor-core kernels below, f32 the CUDA-core ones.
//
// K2dkv bf16 (wg::flash_dkv_wgmma, the tensor-core design): a CTA owns
// 128 keys of one (b, h) on two consumer warpgroups of 64 keys, and a
// producer warpgroup that gives its registers to them. K and V arrive
// once by TMA from the 4-D maps over the strided [B, S, H, D] views
// (wgmma.cuh tensor_map_bshd); 64-row Q and dO tiles, with their lse,
// delta and segment ids, come through a 3-stage ring (full: TMA bytes
// and the producer warp's 32 arrivals; empty: the 8 consumer warps).
// Per tile, each warpgroup computes S^T = K Q^T and dP^T = V dO^T as
// wgmma products from shared memory (every operand K-major, head_dim
// contiguous), applies the scale, the key's bias (constant in the CTA),
// the segment ids (per query column) and the causal compare (diagonal
// tiles only; tiles wholly before the warpgroup's keys are skipped),
// forms P = exp(S - lse) and dS = P (dP - delta) scale in f32 on the
// accumulator fragments, rounds both to bf16 in registers as A
// fragments, and runs dV += P^T dO and dK += dS^T Q with A from
// registers and dO, Q read MN-major through the transpose bit. Each
// tile's two products go into fresh accumulators that are added to the
// f32 sums in tile order (the TPU kernel also adds one f32 product a
// block). Keys and query rows past S arrive as zeros from TMA
// and padded query rows take lse = +inf, so they contribute nothing;
// dK and dV are rounded once and stored from the fragments. Causal CTAs
// are launched longest first: the key block is the slow grid axis, so
// the first wave takes the blocks that see every query tile.
//
// K2dq bf16 (wgdq::flash_dq_wgmma, the tensor-core design): K2dkv's
// design with the roles turned. A CTA owns 128 query rows of one (b, h)
// on two consumer warpgroups of 64 rows, and a producer warpgroup that
// gives its registers to them (setmaxnreg 40 / 232, as wg::). Q and dO
// of the CTA's rows arrive once by TMA from the 4-D maps over the
// strided [B, S, H, D] views; each thread keeps its two rows' lse (+inf
// past S), delta and segment ids in registers. 64-key K and V tiles,
// with the keys' bias (NEG_INF for padding and for keys past S) and
// segment ids, come through a 3-stage ring (full: TMA bytes and the
// producer warp's 32 arrivals; empty: the 8 consumer warps). Per tile,
// each warpgroup computes S = Q K^T and dP = dO V^T as wgmma products
// from shared memory (every operand K-major, head_dim contiguous),
// applies the scale, the key's bias, the segment compare and the causal
// compare (diagonal tiles only) in the TPU kernel's order, forms P =
// exp(S - lse) (expf: exp2f left ~20% more K2dkv elements off f64) and
// dS = P (dP - delta) scale in f32 on the accumulator fragments, rounds
// dS to bf16 once in registers as the RS A-fragment (:202), and runs
// dQ_t = dS K with K read MN-major through the transpose bit into a
// fresh accumulator, added to the f32 sum in tile order. Causal CTAs
// walk key tiles up to their last row, a warpgroup skips (and still
// releases) a tile wholly after its rows, and the query block is the
// slow grid axis taken from the last block down, so the longest CTAs
// launch first; dQ is rounded once and stored from the fragments, rows
// past S not stored.
//
// Bound of K2dq at the training shape (B=16 S=512 H=12 D=64, causal):
// q, k, v, dO and dq once plus lse and delta, 0.0190 ms of bytes,
// against 6*D operations a visible pair (S, dP, dQ), ~0.0098 ms of bf16
// tensor-core work: bytes-bound on paper. What holds the design back:
// each tile's three products and the elementwise pass between them run
// in series within a warpgroup (only the other warpgroup and the TMA
// ring overlap them), and each CTA re-reads the K/V tiles that the
// other query blocks of its (b, h) also read (from L2).
//
// K2dq f32 and K2dkv f32 (the first, CUDA-core design, kept as the f32
// reference the model-parity gates stand on): one CTA per
// (b*h, 64-row block): 64 query rows for K2dq, 64 keys for K2dkv. Each
// row belongs to a PAIR of neighbouring threads and each thread holds
// half of head_dim in registers: K2dq keeps q, dO and the dQ accumulator
// (3 x 32 floats a thread), K2dkv keeps k, v and the dK and dV
// accumulators (4 x 32 floats). One thread per row, as in the forward,
// would need 192 or 256 floats a thread and spill; with the split, a dot
// product over D is two half-sums and one shuffle between the pair. The
// thread with `half` = h holds the float4 chunks 2c + h (c < D/8), so
// the two threads of a pair read neighbouring 16-byte words of a
// shared-memory row, and every thread of a warp reads the same row (a
// broadcast, no bank conflicts). The walked tiles (K/V for K2dq, Q/dO
// plus lse/delta for K2dkv) are staged in shared memory as f32. Causal
// K2dq blocks stop at the block's last query row; causal K2dkv blocks
// start at the first query row that can see the block. Query rows and
// keys past S are masked, so S need not be a multiple of 64.

#include "common.cuh"
#include "wgmma.cuh"

using namespace port;

namespace {

constexpr int kRows = 64;             // rows (K2dq) or keys (K2dkv) per CTA
constexpr int kThreads = 2 * kRows;   // a pair of threads per row
constexpr int kTile = 64;             // keys (K2dq) or rows (K2dkv) per tile

__device__ __forceinline__ float pair_sum(float v) {
  return v + __shfl_xor_sync(0xffffffffu, v, 1);
}

// This thread's half of a row: float4 chunks 2c + half, c < D/8.
template <typename T, int D>
__device__ __forceinline__ void load_half(const T* row, int half, bool ok,
                                          float* out) {
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      out[4 * c + e] = ok ? to_f32(row[8 * c + 4 * half + e]) : 0.f;
    }
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_half(T* row, int half, const float* v) {
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) row[8 * c + 4 * half + e] = from_f32<T>(v[4 * c + e]);
  }
}

// Half of the dot product of a register half-row with shared row `t`.
template <int D>
__device__ __forceinline__ float half_dot(const float* a, const float4* t, int half) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const float4 w = t[2 * c + half];
    s = fmaf(a[4 * c], w.x, s);
    s = fmaf(a[4 * c + 1], w.y, s);
    s = fmaf(a[4 * c + 2], w.z, s);
    s = fmaf(a[4 * c + 3], w.w, s);
  }
  return s;
}

// acc += f * shared row `t` (this thread's half).
template <int D>
__device__ __forceinline__ void half_axpy(float* acc, float f, const float4* t, int half) {
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const float4 w = t[2 * c + half];
    acc[4 * c] = fmaf(f, w.x, acc[4 * c]);
    acc[4 * c + 1] = fmaf(f, w.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(f, w.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(f, w.w, acc[4 * c + 3]);
  }
}

// Stage rows [r0, r0 + n) of a [B, S, H, D] tensor (head h of batch b,
// strides in elements) into a shared f32 tile of float4 chunks.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float4 (*tile)[D / 4], const T* base,
                                           long long ss, int r0, int n) {
  for (int idx = threadIdx.x; idx < n * (D / 4); idx += kThreads) {
    const int j = idx / (D / 4);
    const int m = idx % (D / 4);
    const T* src = base + static_cast<long long>(r0 + j) * ss + 4 * m;
    tile[j][m] = make_float4(to_f32(src[0]), to_f32(src[1]), to_f32(src[2]),
                             to_f32(src[3]));
  }
}

struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const uint8_t* __restrict__ kv_mask, const int* __restrict__ segs,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int S, int H, Strides st, int causal,
                float scale) {
  __shared__ float4 k_tile[kTile][D / 4];
  __shared__ float4 v_tile[kTile][D / 4];
  __shared__ float k_bias[kTile];
  __shared__ int k_seg[kTile];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kRows;
  const int half = threadIdx.x & 1;
  const int qi = q0 + (threadIdx.x >> 1);
  const bool row_ok = qi < S;

  float qv[D / 2], dov[D / 2], acc[D / 2];
  load_half<T, D>(q + b * st.qb + static_cast<long long>(qi) * st.qs + h * st.qh, half, row_ok, qv);
  load_half<T, D>(dout + b * st.ob + static_cast<long long>(qi) * st.os + h * st.oh, half, row_ok, dov);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const long long rv = (static_cast<long long>(b) * H + h) * S + qi;
  // rows past S take lse = +inf: p = 0, so they stay in the shuffles
  // of their warp without contributing
  const float lse_i = row_ok ? lse[rv] : INFINITY;
  const float delta_i = row_ok ? delta[rv] : 0.f;
  const int seg_q = (segs != nullptr && row_ok) ? segs[static_cast<long long>(b) * S + qi] : 0;

  const int q_last = min(q0 + kRows, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    const int nk = min(kTile, k_end - k0);
    __syncthreads();  // the previous tile's readers are done
    stage_rows<T, D>(k_tile, k + b * st.kb + h * st.kh, st.ks, k0, nk);
    stage_rows<T, D>(v_tile, v + b * st.vb + h * st.vh, st.vs, k0, nk);
    for (int j = threadIdx.x; j < nk; j += kThreads) {
      const long long key = static_cast<long long>(b) * S + k0 + j;
      k_bias[j] = (kv_mask != nullptr && !kv_mask[key]) ? kNegInf : 0.f;
      k_seg[j] = segs != nullptr ? segs[key] : 0;
    }
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float s_dot = pair_sum(half_dot<D>(qv, k_tile[j], half));
      const float dp = pair_sum(half_dot<D>(dov, v_tile[j], half));
      // the forward's order: scale, additive bias, then the segment and
      // causal masks replace the score
      float s = s_dot * scale + k_bias[j];
      if (segs != nullptr && k_seg[j] != seg_q) s = kNegInf;
      if (causal && k0 + j > qi) s = kNegInf;
      const float p = expf(s - lse_i);
      const float ds = p * (dp - delta_i) * scale;
      half_axpy<D>(acc, ds, k_tile[j], half);
    }
  }
  if (!row_ok) return;
  store_half<T, D>(dq + ((static_cast<long long>(b) * S + qi) * H + h) * D, half, acc);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const uint8_t* __restrict__ kv_mask, const int* __restrict__ segs,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, int S, int H, Strides st,
                 int causal, float scale) {
  __shared__ float4 q_tile[kTile][D / 4];
  __shared__ float4 do_tile[kTile][D / 4];
  __shared__ float q_lse[kTile];
  __shared__ float q_delta[kTile];
  __shared__ int q_seg[kTile];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * kRows;
  const int half = threadIdx.x & 1;
  const int kj = k0 + (threadIdx.x >> 1);
  const bool key_ok = kj < S;

  float kv[D / 2], vv[D / 2], dka[D / 2], dva[D / 2];
  load_half<T, D>(k + b * st.kb + static_cast<long long>(kj) * st.ks + h * st.kh, half, key_ok, kv);
  load_half<T, D>(v + b * st.vb + static_cast<long long>(kj) * st.vs + h * st.vh, half, key_ok, vv);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dka[i] = 0.f;
    dva[i] = 0.f;
  }
  const long long key = static_cast<long long>(b) * S + kj;
  const float k_bias = (key_ok && kv_mask != nullptr && !kv_mask[key]) ? kNegInf : 0.f;
  const int seg_k = (segs != nullptr && key_ok) ? segs[key] : 0;
  const long long rv0 = (static_cast<long long>(b) * H + h) * S;

  // causal: query rows before this block's first key never see it
  const int q_begin = causal ? k0 : 0;
  for (int r0 = q_begin; r0 < S; r0 += kTile) {
    const int nq = min(kTile, S - r0);
    __syncthreads();  // the previous tile's readers are done
    stage_rows<T, D>(q_tile, q + b * st.qb + h * st.qh, st.qs, r0, nq);
    stage_rows<T, D>(do_tile, dout + b * st.ob + h * st.oh, st.os, r0, nq);
    for (int i = threadIdx.x; i < nq; i += kThreads) {
      q_lse[i] = lse[rv0 + r0 + i];
      q_delta[i] = delta[rv0 + r0 + i];
      q_seg[i] = segs != nullptr ? segs[static_cast<long long>(b) * S + r0 + i] : 0;
    }
    __syncthreads();
    for (int i = 0; i < nq; ++i) {
      const float s_dot = pair_sum(half_dot<D>(kv, q_tile[i], half));
      const float dp = pair_sum(half_dot<D>(vv, do_tile[i], half));
      float s = s_dot * scale + k_bias;
      if (segs != nullptr && q_seg[i] != seg_k) s = kNegInf;
      if (causal && kj > r0 + i) s = kNegInf;
      if (!key_ok) s = kNegInf;
      const float p = expf(s - q_lse[i]);
      const float ds = p * (dp - q_delta[i]) * scale;
      half_axpy<D>(dva, p, do_tile[i], half);
      half_axpy<D>(dka, ds, q_tile[i], half);
    }
  }
  if (!key_ok) return;
  const long long out = ((static_cast<long long>(b) * S + kj) * H + h) * D;
  store_half<T, D>(dk + out, half, dka);
  store_half<T, D>(dv + out, half, dva);
}

template <typename T>
void launch_dq(const void* q, const void* k, const void* v, const void* dout,
               const void* kv_mask, const void* segs, const void* lse,
               const void* delta, void* dq, int B, int S, int H, const Strides& st,
               int causal, float scale, cudaStream_t stream) {
  const dim3 grid((S + kRows - 1) / kRows, B * H);
  flash_dq_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const uint8_t*>(kv_mask),
      static_cast<const int*>(segs), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), S, H, st, causal, scale);
}

template <typename T>
void launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                const void* kv_mask, const void* segs, const void* lse,
                const void* delta, void* dk, void* dv, int B, int S, int H,
                const Strides& st, int causal, float scale, cudaStream_t stream) {
  const dim3 grid((S + kRows - 1) / kRows, B * H);
  flash_dkv_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const uint8_t*>(kv_mask),
      static_cast<const int*>(segs), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
      S, H, st, causal, scale);
}

// The 4-D TMA maps (q, k, v, dout) of a bf16 backward kernel over the
// strided [B, S, H, D] views, q and dout in boxes of q_rows positions,
// k and v of kv_rows. Returns 0 or a CUDA error code.
int bwd_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
             const void* dout, int B, int S, int H, const Strides& st, int q_rows,
             int kv_rows) {
  using namespace port::hopper;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const bool ok = tensor_map_bshd(encode, &m[0], q, B, S, H, st.qb, st.qs, st.qh, q_rows) &&
                  tensor_map_bshd(encode, &m[1], k, B, S, H, st.kb, st.ks, st.kh, kv_rows) &&
                  tensor_map_bshd(encode, &m[2], v, B, S, H, st.vb, st.vs, st.vh, kv_rows) &&
                  tensor_map_bshd(encode, &m[3], dout, B, S, H, st.ob, st.os, st.oh, q_rows);
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// -- K2dkv, bf16: the tensor-core design ----------------------------------------

namespace wg {

using namespace port::hopper;

constexpr int kBK = 128;    // keys a CTA: two consumer warpgroups of 64
constexpr int kBQ = 64;     // query rows a tile
constexpr int kStages = 3;  // Q / dO ring depth
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
// registers a thread after the move (launched at 65536 / 384 = 168): the
// producer warpgroup needs few; a consumer holds the dK and dV sums, a
// tile's S and dP (or its two fresh products) and the bf16 fragments
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(kProducerRegs * 128 + kConsumerRegs * kConsumers <= 65536, "register file");
constexpr int kRowBytes = 128;             // 64 bf16 of head_dim: one swizzle row
constexpr int kKVBytes = kBK * kRowBytes;  // K or V of the CTA's keys
constexpr int kTileBytes = kBQ * kRowBytes;
constexpr int kStageBytes = 2 * kTileBytes;  // Q, then dO
constexpr int kVecs = 3 * kBQ;               // a stage's lse, delta (f32) and segment ids
constexpr int kVecOffset = 2 * kKVBytes + kStages * kStageBytes;
constexpr int kBarOffset = kVecOffset + kStages * kVecs * 4;
// 1024 of slack to align the swizzled tiles; full and empty a stage, K/V
constexpr int kSmem = 1024 + kBarOffset + 8 * (2 * kStages + 1);

// The accumulator granularity: each query tile's dV and dK products go
// into fresh wgmma accumulators, added to f32 sums in tile order, as the
// TPU kernel adds one f32 product a block. Chaining every tile (up to 8
// at S = 512) into the two accumulators left up to 14% more dK and dV
// elements a bf16 rounding away from an f64 reference (causal; as many
// with segments) and was 3-6% faster (PERF.md).

__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_wgmma(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
                __grid_constant__ const CUtensorMap tv, __grid_constant__ const CUtensorMap tdo,
                const uint8_t* __restrict__ kv_mask, const int* __restrict__ segs,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int H,
                int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = smem;
  uint8_t* v_s = smem + kKVBytes;
  uint8_t* ring = smem + 2 * kKVBytes;
  float* vecs = reinterpret_cast<float*>(smem + kVecOffset);  // [kStages][3][kBQ]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = blockIdx.y * kBK;  // the slow axis: block 0, the longest causal one, first
  const int qt0 = causal ? k0 / kBQ : 0;  // causal: earlier query rows never see the block
  const int ntiles = (S + kBQ - 1) / kBQ - qt0;
  const long long brow = static_cast<long long>(b) * S;
  const long long rv0 = (static_cast<long long>(b) * H + h) * S;

  if (t == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 32);                  // the producer warp's lanes
      mbar_init(&empty[i], kConsumers / 32);    // one arrival a consumer warp
    }
    mbar_init(kvbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // -- the producer warpgroup --------------------------
    setmaxnreg_dec<kProducerRegs>();
    if (warp != kConsumers / 32) return;  // its first warp loads
    if (lane == 0) {
      mbar_arrive_expect_tx(kvbar, 2 * kKVBytes);
      tma_load_4d(k_s, &tk, kvbar, 0, h, k0, b);
      tma_load_4d(v_s, &tv, kvbar, 0, h, k0, b);
    }
    for (int it = 0; it < ntiles; ++it) {
      const int slot = it % kStages, q0 = (qt0 + it) * kBQ;
      if (it >= kStages) mbar_wait(&empty[slot], ((it / kStages) - 1) & 1);
      // lse (+inf past S: p = 0), delta and segment ids of the tile's rows
      float* vl = vecs + slot * kVecs;
      for (int i = lane; i < kBQ; i += 32) {
        const int q = q0 + i;
        const bool in = q < S;
        vl[i] = in ? lse[rv0 + q] : INFINITY;
        vl[kBQ + i] = in ? delta[rv0 + q] : 0.f;
        reinterpret_cast<int*>(vl)[2 * kBQ + i] = (in && segs != nullptr) ? segs[brow + q] : 0;
      }
      if (lane == 0) {
        uint8_t* st = ring + slot * kStageBytes;
        mbar_arrive_expect_tx(&full[slot], kStageBytes);
        tma_load_4d(st, &tq, &full[slot], 0, h, q0, b);
        tma_load_4d(st + kTileBytes, &tdo, &full[slot], 0, h, q0, b);
      } else {
        mbar_arrive(&full[slot]);
      }
    }
    return;
  }

  // -- the consumer warpgroups: warpgroup g owns keys k0 + 64 g .. + 63 ----------
  setmaxnreg_inc<kConsumerRegs>();
  const int g = warp >> 2;
  const int wk0 = k0 + 64 * g;
  const int key_a = wk0 + 16 * (warp & 3) + (lane >> 2);  // the thread's two rows
  const int key_b = key_a + 8;
  const float bias_a =
      (kv_mask != nullptr && key_a < S && !kv_mask[brow + key_a]) ? kNegInf : 0.f;
  const float bias_b =
      (kv_mask != nullptr && key_b < S && !kv_mask[brow + key_b]) ? kNegInf : 0.f;
  const int seg_a = (segs != nullptr && key_a < S) ? segs[brow + key_a] : 0;
  const int seg_b = (segs != nullptr && key_b < S) ? segs[brow + key_b] : 0;
  const int kq = 2 * (lane & 3);  // the thread's first column in each 8
  const uint32_t k_addr = smem_u32(k_s) + g * 64 * kRowBytes;
  const uint32_t v_addr = smem_u32(v_s) + g * 64 * kRowBytes;

  float dks[32], dvs[32];  // the f32 sums of the tiles' products
#pragma unroll
  for (int i = 0; i < 32; ++i) dks[i] = dvs[i] = 0.f;
  mbar_wait(kvbar, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int slot = it % kStages, q0 = (qt0 + it) * kBQ;
    mbar_wait(&full[slot], (it / kStages) & 1);
    // causal: a tile wholly before the warpgroup's keys sees none of them
    if (!causal || q0 + kBQ - 1 >= wk0) {
      const uint32_t q_addr = smem_u32(ring + slot * kStageBytes);
      const uint32_t do_addr = q_addr + kTileBytes;
      const float* vl = vecs + slot * kVecs;
      const float* vd = vl + kBQ;
      const int* vs = reinterpret_cast<const int*>(vl + 2 * kBQ);
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // S^T = K Q^T
        if (kk == 0) wgmma_m64n64k16_ss_first<0>(s, desc_kmajor(k_addr), desc_kmajor(q_addr));
        else wgmma_m64n64k16_ss<0>(s, desc_kmajor(k_addr + kk * 32),
                                   desc_kmajor(q_addr + kk * 32), 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // dP^T = V dO^T
        if (kk == 0) wgmma_m64n64k16_ss_first<0>(dp, desc_kmajor(v_addr), desc_kmajor(do_addr));
        else wgmma_m64n64k16_ss<0>(dp, desc_kmajor(v_addr + kk * 32),
                                   desc_kmajor(do_addr + kk * 32), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(s);
      fence_operand(dp);

      // the TPU kernel's order: scale, the key's bias, then the segment
      // and causal masks replace the score; P = exp(S - lse) and dS =
      // P (dP - delta) scale in f32, each rounded to bf16 once, as the A
      // fragments of the four k16 steps (rows: keys; columns: queries)
      const bool diag = causal && q0 < wk0 + 64;
      uint32_t pf[4][4], df[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float pv[4], dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + kq + (e & 1);
          const bool ra = e < 2;
          float sv = s[j * 4 + e] * scale + (ra ? bias_a : bias_b);
          if (segs != nullptr && vs[col] != (ra ? seg_a : seg_b)) sv = kNegInf;
          if (diag && q0 + col < (ra ? key_a : key_b)) sv = kNegInf;
          pv[e] = expf(sv - vl[col]);
          dsv[e] = pv[e] * (dp[j * 4 + e] - vd[col]) * scale;
        }
        pf[j / 2][(j % 2) * 2 + 0] = pack_bf16(pv[0], pv[1]);
        pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(pv[2], pv[3]);
        df[j / 2][(j % 2) * 2 + 0] = pack_bf16(dsv[0], dsv[1]);
        df[j / 2][(j % 2) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
      }

      // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major (head_dim
      // contiguous) through the transpose bit, a k16 step 16 query rows
      float dvt[32], dkt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = desc_mnmajor(do_addr + kk * 16 * kRowBytes);
        if (kk == 0) wgmma_m64n64k16_rs_first<1>(dvt, pf[kk], db);
        else wgmma_m64n64k16_rs<1>(dvt, pf[kk], db, 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = desc_mnmajor(q_addr + kk * 16 * kRowBytes);
        if (kk == 0) wgmma_m64n64k16_rs_first<1>(dkt, df[kk], db);
        else wgmma_m64n64k16_rs<1>(dkt, df[kk], db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(dvt);
      fence_operand(dkt);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        dvs[i] += dvt[i];
        dks[i] += dkt[i];
      }
    }
    if (lane == 0) mbar_arrive(&empty[slot]);  // this warp is done with the stage
  }

  // dK and dV rounded once; rows past S are not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r == 0 ? key_a : key_b;
    if (key >= S) continue;
    const long long off = ((brow + key) * H + h) * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j * 8 + kq;
      *reinterpret_cast<__nv_bfloat162*>(dk + off + col) =
          __floats2bfloat162_rn(dks[j * 4 + 2 * r], dks[j * 4 + 2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
          __floats2bfloat162_rn(dvs[j * 4 + 2 * r], dvs[j * 4 + 2 * r + 1]);
    }
  }
}

// st: q, k, v, dout strides (batch, seq, head) in elements; every
// operand TMA-addressable (ops/flash_attention.py tma_compatible)
int launch(const void* q, const void* k, const void* v, const void* dout, const void* kv_mask,
           const void* segs, const void* lse, const void* delta, void* dk, void* dv, int B, int S,
           int H, const Strides& st, int causal, float scale, cudaStream_t stream) {
  CUtensorMap m[4];
  if (int rc = bwd_maps(m, q, k, v, dout, B, S, H, st, kBQ, kBK)) return rc;
  const cudaError_t err =
      cudaFuncSetAttribute(flash_dkv_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // x: (b, h); y: the key block, the slow axis (longest causal blocks first)
  const dim3 grid(B * H, (S + kBK - 1) / kBK);
  flash_dkv_wgmma<<<grid, kThreads, kSmem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const uint8_t*>(kv_mask),
      static_cast<const int*>(segs),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// -- K2dq, bf16: the tensor-core design ----------------------------------------

namespace wgdq {

using namespace port::hopper;
using wg::kConsumerRegs;
using wg::kConsumers;
using wg::kProducerRegs;
using wg::kRowBytes;
using wg::kStages;
using wg::kThreads;

constexpr int kBQ = 128;  // query rows a CTA: two consumer warpgroups of 64
constexpr int kBK = 64;   // keys a tile
constexpr int kQBytes = kBQ * kRowBytes;  // Q or dO of the CTA's rows
constexpr int kTileBytes = kBK * kRowBytes;
constexpr int kStageBytes = 2 * kTileBytes;  // K, then V
constexpr int kVecs = 2 * kBK;               // a stage's key bias (f32) and segment ids
constexpr int kVecOffset = 2 * kQBytes + kStages * kStageBytes;
constexpr int kBarOffset = kVecOffset + kStages * kVecs * 4;
// 1024 of slack to align the swizzled tiles; full and empty a stage, Q/dO
constexpr int kSmem = 1024 + kBarOffset + 8 * (2 * kStages + 1);

// The accumulator granularity is K2dkv's: each key tile's dQ product
// goes into a fresh wgmma accumulator, added to the f32 sum in tile
// order.

__global__ void __launch_bounds__(kThreads, 1)
flash_dq_wgmma(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
               __grid_constant__ const CUtensorMap tv, __grid_constant__ const CUtensorMap tdo,
               const uint8_t* __restrict__ kv_mask, const int* __restrict__ segs,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dq, int S, int H, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;
  uint8_t* do_s = smem + kQBytes;
  uint8_t* ring = smem + 2 * kQBytes;
  float* vecs = reinterpret_cast<float*>(smem + kVecOffset);  // [kStages][2][kBK]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  // the slow axis, from the last query block down: the longest causal
  // CTAs (those that see the most key tiles) launch first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int q_last = min(q0 + kBQ, S) - 1;  // the CTA's last row
  const int ntiles = (causal ? q_last : S - 1) / kBK + 1;
  const long long brow = static_cast<long long>(b) * S;
  const long long rv0 = (static_cast<long long>(b) * H + h) * S;

  if (t == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 32);                  // the producer warp's lanes
      mbar_init(&empty[i], kConsumers / 32);    // one arrival a consumer warp
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // -- the producer warpgroup --------------------------
    setmaxnreg_dec<kProducerRegs>();
    if (warp != kConsumers / 32) return;  // its first warp loads
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, 2 * kQBytes);
      tma_load_4d(q_s, &tq, qbar, 0, h, q0, b);
      tma_load_4d(do_s, &tdo, qbar, 0, h, q0, b);
    }
    for (int it = 0; it < ntiles; ++it) {
      const int slot = it % kStages, k0 = it * kBK;
      if (it >= kStages) mbar_wait(&empty[slot], ((it / kStages) - 1) & 1);
      // the tile's key bias (NEG_INF for padding and for keys past S,
      // whose K and V rows TMA fills with zeros) and segment ids
      float* vk = vecs + slot * kVecs;
      for (int j = lane; j < kBK; j += 32) {
        const int key = k0 + j;
        const bool in = key < S;
        vk[j] = (!in || (kv_mask != nullptr && !kv_mask[brow + key])) ? kNegInf : 0.f;
        reinterpret_cast<int*>(vk)[kBK + j] = (in && segs != nullptr) ? segs[brow + key] : 0;
      }
      if (lane == 0) {
        uint8_t* st = ring + slot * kStageBytes;
        mbar_arrive_expect_tx(&full[slot], kStageBytes);
        tma_load_4d(st, &tk, &full[slot], 0, h, k0, b);
        tma_load_4d(st + kTileBytes, &tv, &full[slot], 0, h, k0, b);
      } else {
        mbar_arrive(&full[slot]);
      }
    }
    return;
  }

  // -- the consumer warpgroups: warpgroup g owns rows q0 + 64 g .. + 63 ----------
  setmaxnreg_inc<kConsumerRegs>();
  const int g = warp >> 2;
  const int wq0 = q0 + 64 * g;
  const int wq_last = min(wq0 + 63, S - 1);  // below wq0 when the warpgroup has no row
  const int row_a = wq0 + 16 * (warp & 3) + (lane >> 2);  // the thread's two rows
  const int row_b = row_a + 8;
  // rows past S take lse = +inf: p = 0, so they contribute nothing
  const float lse_a = row_a < S ? lse[rv0 + row_a] : INFINITY;
  const float lse_b = row_b < S ? lse[rv0 + row_b] : INFINITY;
  const float delta_a = row_a < S ? delta[rv0 + row_a] : 0.f;
  const float delta_b = row_b < S ? delta[rv0 + row_b] : 0.f;
  const int seg_a = (segs != nullptr && row_a < S) ? segs[brow + row_a] : 0;
  const int seg_b = (segs != nullptr && row_b < S) ? segs[brow + row_b] : 0;
  const int kq = 2 * (lane & 3);  // the thread's first column in each 8
  const uint32_t q_addr = smem_u32(q_s) + g * 64 * kRowBytes;
  const uint32_t do_addr = smem_u32(do_s) + g * 64 * kRowBytes;

  float dqs[32];  // the f32 sum of the tiles' products
#pragma unroll
  for (int i = 0; i < 32; ++i) dqs[i] = 0.f;
  mbar_wait(qbar, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int slot = it % kStages, k0 = it * kBK;
    mbar_wait(&full[slot], (it / kStages) & 1);
    // causal: a tile wholly after the warpgroup's rows is none of its
    // business (nor is any tile of a warpgroup past S)
    if (wq0 < S && (!causal || k0 <= wq_last)) {
      const uint32_t k_addr = smem_u32(ring + slot * kStageBytes);
      const uint32_t v_addr = k_addr + kTileBytes;
      const float* vk = vecs + slot * kVecs;
      const int* vs = reinterpret_cast<const int*>(vk + kBK);
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // S = Q K^T
        if (kk == 0) wgmma_m64n64k16_ss_first<0>(s, desc_kmajor(q_addr), desc_kmajor(k_addr));
        else wgmma_m64n64k16_ss<0>(s, desc_kmajor(q_addr + kk * 32),
                                   desc_kmajor(k_addr + kk * 32), 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // dP = dO V^T
        if (kk == 0) wgmma_m64n64k16_ss_first<0>(dp, desc_kmajor(do_addr), desc_kmajor(v_addr));
        else wgmma_m64n64k16_ss<0>(dp, desc_kmajor(do_addr + kk * 32),
                                   desc_kmajor(v_addr + kk * 32), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(s);
      fence_operand(dp);

      // the TPU kernel's order (flash_attention.py:186-195): scale, the
      // key's bias, then the segment and causal masks replace the score;
      // P = exp(S - lse) and dS = P (dP - delta) scale in f32, rounded to
      // bf16 once (:202), as the A fragments of the four k16 steps (rows:
      // queries; columns: keys)
      const bool diag = causal && k0 + kBK - 1 > wq0;
      uint32_t df[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + kq + (e & 1);
          const bool ra = e < 2;
          float sv = s[j * 4 + e] * scale + vk[col];
          if (segs != nullptr && vs[col] != (ra ? seg_a : seg_b)) sv = kNegInf;
          if (diag && k0 + col > (ra ? row_a : row_b)) sv = kNegInf;
          const float p = expf(sv - (ra ? lse_a : lse_b));
          dsv[e] = p * (dp[j * 4 + e] - (ra ? delta_a : delta_b)) * scale;
        }
        df[j / 2][(j % 2) * 2 + 0] = pack_bf16(dsv[0], dsv[1]);
        df[j / 2][(j % 2) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
      }

      // dQ_t = dS K into a fresh accumulator, K read MN-major (head_dim
      // contiguous) through the transpose bit, a k16 step 16 keys
      float dqt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = desc_mnmajor(k_addr + kk * 16 * kRowBytes);
        if (kk == 0) wgmma_m64n64k16_rs_first<1>(dqt, df[kk], db);
        else wgmma_m64n64k16_rs<1>(dqt, df[kk], db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(dqt);
#pragma unroll
      for (int i = 0; i < 32; ++i) dqs[i] += dqt[i];
    }
    if (lane == 0) mbar_arrive(&empty[slot]);  // this warp is done with the stage
  }

  // dQ rounded once; rows past S are not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? row_a : row_b;
    if (row >= S) continue;
    const long long off = ((brow + row) * H + h) * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dq + off + j * 8 + kq) =
          __floats2bfloat162_rn(dqs[j * 4 + 2 * r], dqs[j * 4 + 2 * r + 1]);
    }
  }
}

// st: q, k, v, dout strides (batch, seq, head) in elements; every
// operand TMA-addressable (ops/flash_attention.py tma_compatible)
int launch(const void* q, const void* k, const void* v, const void* dout, const void* kv_mask,
           const void* segs, const void* lse, const void* delta, void* dq, int B, int S, int H,
           const Strides& st, int causal, float scale, cudaStream_t stream) {
  CUtensorMap m[4];
  if (int rc = bwd_maps(m, q, k, v, dout, B, S, H, st, kBQ, kBK)) return rc;
  const cudaError_t err =
      cudaFuncSetAttribute(flash_dq_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // x: (b, h); y: the query block, the slow axis (longest causal blocks first)
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_dq_wgmma<<<grid, kThreads, kSmem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const uint8_t*>(kv_mask),
      static_cast<const int*>(segs),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), S, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgdq

int check_shape(int B, int S, int H, int D) {
  if (B * H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // head_dim 64 only, as the forward (csrc/flash_attention.cu)
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// strides: q, k, v, dout (batch, seq, head), in elements; the head_dim
// axis of each must be contiguous. dq/dk/dv are written contiguous
// [B, S, H, D]; lse and delta are f32 [B, H, S]. bf16 K2dkv (the
// tensor-core design, through TMA) also needs 16-byte aligned bases and
// strides of size>1 dimensions that are multiples of 8 elements, or it
// returns cudaErrorInvalidValue.
extern "C" int port_flash_attention_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* kv_mask, const void* segs, const void* lse, const void* delta,
    void* dq, int B, int S, int H, int D,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh,
    int causal, float scale, int dtype, int device, void* stream) {
  // this library links its own CUDA runtime: select the caller's
  // device in it before launching on the caller's stream
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (int rc = check_shape(B, S, H, D)) return rc;
  const Strides st{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: launch_dq<float>(q, k, v, dout, kv_mask, segs, lse, delta, dq, B, S, H, st, causal, scale, s); break;
    case kBF16: return wgdq::launch(q, k, v, dout, kv_mask, segs, lse, delta, dq, B, S, H, st, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int port_flash_attention_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* kv_mask, const void* segs, const void* lse, const void* delta,
    void* dk, void* dv, int B, int S, int H, int D,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh,
    int causal, float scale, int dtype, int device, void* stream) {
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (int rc = check_shape(B, S, H, D)) return rc;
  const Strides st{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: launch_dkv<float>(q, k, v, dout, kv_mask, segs, lse, delta, dk, dv, B, S, H, st, causal, scale, s); break;
    case kBF16: return wg::launch(q, k, v, dout, kv_mask, segs, lse, delta, dk, dv, B, S, H, st, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
