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
// key) get p = 0 and contribute nothing.
//
// Bound on the H100: at the training shapes (S = 512, D = 64) the causal
// backward does ~5 * 2 * S*S/2 * D operations per (batch, head) against
// ~10 * S * D bytes (q, k, v, dO, dQ, dK, dV and the f32 row vectors), so
// on the tensor cores it would sit near the memory bound; this first
// version computes in f32 on the CUDA cores and is bound by them.
//
// Design. One CTA per (b*h, 64-row block): 64 query rows for K2dq, 64
// keys for K2dkv. Each row belongs to a PAIR of neighbouring threads and
// each thread holds half of head_dim in registers: K2dq keeps q, dO and
// the dQ accumulator (3 x 32 floats a thread), K2dkv keeps k, v and the
// dK and dV accumulators (4 x 32 floats). One thread per row, as in the
// forward, would need 192 or 256 floats a thread and spill; with the
// split, a dot product over D is two half-sums and one shuffle between
// the pair. The thread with `half` = h holds the float4 chunks 2c + h
// (c < D/8), so the two threads of a pair read neighbouring 16-byte words
// of a shared-memory row, and every thread of a warp reads the same row
// (a broadcast, no bank conflicts). The walked tiles (K/V for K2dq, Q/dO
// plus lse/delta for K2dkv) are staged in shared memory as f32. Causal
// K2dq blocks stop at the block's last query row; causal K2dkv blocks
// start at the first query row that can see the block. Query rows and
// keys past S are masked, so S need not be a multiple of 64. Tensor cores
// (wgmma), TMA and pipelined tiles are later work.

#include "common.cuh"

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

int check_shape(int B, int S, int H, int D) {
  if (B * H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // head_dim 64 only, as the forward (csrc/flash_attention.cu)
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// strides: q, k, v, dout (batch, seq, head), in elements; the head_dim
// axis of each must be contiguous. dq/dk/dv are written contiguous
// [B, S, H, D]; lse and delta are f32 [B, H, S].
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
    case kBF16: launch_dq<__nv_bfloat16>(q, k, v, dout, kv_mask, segs, lse, delta, dq, B, S, H, st, causal, scale, s); break;
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
    case kBF16: launch_dkv<__nv_bfloat16>(q, k, v, dout, kv_mask, segs, lse, delta, dk, dv, B, S, H, st, causal, scale, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
