// K2 on the CUDA cores: the forward (K2f), K2dq and K2dkv at every head
// width and dtype that the tensor-core designs (flash_attention.cu,
// flash_attention_bwd.cu, bf16 at head_dim 64 and 128) do not take: f32
// at every width, bf16 at every width but 64 and 128. Same masks,
// outputs and rounding points as those designs and as the TPU kernels
// they replace (pyspark_tf_gke_tpu/ops/pallas/flash_attention.py
// ::_fwd_kernel :49, ::_dq_kernel :162, ::_dkv_kernel :215).
//
// Each kernel is instantiated at the widths W of flash_attention.cuh
// (16, 32, 64, 128, 256) in f32 and bf16; a head_dim d runs the
// smallest W >= d. Loads are masked to the true d (the padded columns
// hold 0, so they add nothing to a score or an output), the scale is
// the caller's d ** -0.5 of the true d, and only the true d columns are
// written. Rounding points for bf16 (none in f32): P is rounded to bf16
// before O += P V (:97) and before dV += P^T dO (:255), dS before dK +=
// dS^T Q (:262) and dQ += dS K (:202); the row sums and every
// accumulator stay f32.
//
// Bound on the H100: the same bytes as the tensor-core designs, against
// f32 operations on the CUDA cores (67 TFLOP/s); at the shapes the port
// runs (a few heads of D <= 256) these kernels are bound by the rate at
// which they read shared memory, one operand a multiply-add.
//
// K2f (PR 1's design, widened): one CTA per (b*h, 64-row query block),
// a query row on kSplit threads (one up to W 64, W/64 beyond), each
// holding W/kSplit of the row's q and O values in registers (value
// i*kSplit + part, so the threads of a row read neighbouring words of a
// shared row). K/V tiles (64 keys up to W 64, 32 KB of f32 beyond) are
// staged in shared memory as f32; a score's partial dot products meet
// in kSplit-1 shuffles; the online softmax updates every 16 keys.
//
// K2dq and K2dkv (PR 2's design, widened): one CTA per (b*h, block of
// rows) — query rows for K2dq, keys for K2dkv, 64 a CTA (32 at W 256) —
// a row on kSplit = max(2, W/32) neighbouring threads, each holding
// W/kSplit of each of the row's vectors as float4 chunks kSplit*c +
// part (K2dq: q, dO and the dQ sum; K2dkv: k, v and the dK and dV sums).
// The walked tiles (K/V for K2dq, Q/dO with their lse, delta and segment
// ids for K2dkv; 64 rows up to W 64, 32 KB of f32 beyond) are staged in
// shared memory as f32. Causal K2dq blocks stop at their last query row,
// causal K2dkv blocks start at the first query row that sees them; rows
// and keys past S are masked, so S need not be a multiple of anything.

#include "flash_attention.cuh"

using namespace port;
using port::flash::Strides;

namespace {

constexpr int kBQ = 64;   // query rows a K2f CTA
constexpr int kSub = 16;  // keys an online-softmax update (K2f)

// a sum over the kSplit neighbouring lanes that hold one row
template <int kSplit>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < kSplit; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// -- K2f ----------------------------------------------------------------------

template <int W>
struct Fwd {
  static constexpr int kSplit = W > 64 ? W / 64 : 1;  // threads a query row
  static constexpr int kPer = W / kSplit;             // values a thread holds
  static constexpr int kThreads = kBQ * kSplit;
  static constexpr int kBK = W > 64 ? 64 * 64 / W : 64;  // keys a staged tile
};

template <typename T, int W>
__global__ void __launch_bounds__(Fwd<W>::kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const uint8_t* __restrict__ kv_mask, const int* __restrict__ segs,
                 T* __restrict__ out, float* __restrict__ lse, int S, int H, int D, Strides st,
                 int causal, float scale) {
  using C = Fwd<W>;
  constexpr int kSplit = C::kSplit, kPer = C::kPer, kBK = C::kBK;
  __shared__ float k_tile[kBK][W];
  __shared__ float v_tile[kBK][W];
  __shared__ float k_bias[kBK];
  __shared__ int k_seg[kBK];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * kBQ;
  const int part = threadIdx.x % kSplit;
  const int qi = q0 + threadIdx.x / kSplit;
  const bool row_ok = qi < S;

  float qv[kPer], acc[kPer];
  const T* qrow = q + b * st.qb + static_cast<long long>(qi) * st.qs + h * st.qh;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int dd = i * kSplit + part;
    qv[i] = (row_ok && dd < D) ? to_f32(qrow[dd]) : 0.f;
    acc[i] = 0.f;
  }
  const int seg_q = (segs != nullptr && row_ok) ? segs[static_cast<long long>(b) * S + qi] : 0;
  float m = kNegInf;
  float l = 0.f;

  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    const int nk = min(kBK, k_end - k0);
    __syncthreads();  // the previous tile's readers are done
    for (int idx = threadIdx.x; idx < nk * W; idx += C::kThreads) {
      const int j = idx / W;
      const int dd = idx % W;
      const long long key = k0 + j;
      const bool in = dd < D;
      k_tile[j][dd] = in ? to_f32(k[b * st.kb + key * st.ks + h * st.kh + dd]) : 0.f;
      v_tile[j][dd] = in ? to_f32(v[b * st.vb + key * st.vs + h * st.vh + dd]) : 0.f;
    }
    for (int j = threadIdx.x; j < nk; j += C::kThreads) {
      const long long key = static_cast<long long>(b) * S + k0 + j;
      k_bias[j] = (kv_mask != nullptr && !kv_mask[key]) ? kNegInf : 0.f;
      k_seg[j] = segs != nullptr ? segs[key] : 0;
    }
    __syncthreads();
    // rows past S compute along (their q is 0): the threads of a warp
    // stay converged for the shuffles
    for (int j0 = 0; j0 < nk; j0 += kSub) {
      float sc[kSub];
      float mx = m;
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        const int j = j0 + t;
        float s = kNegInf;
        if (j < nk) {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < kPer; ++i) dot = fmaf(qv[i], k_tile[j][i * kSplit + part], dot);
          dot = group_sum<kSplit>(dot);
          // same order as the TPU kernel: scale, additive bias, then
          // the segment and causal masks replace the score
          s = dot * scale + k_bias[j];
          if (segs != nullptr && k_seg[j] != seg_q) s = kNegInf;
          if (causal && k0 + j > qi) s = kNegInf;
          mx = fmaxf(mx, s);
        }
        sc[t] = s;
      }
      const float alpha = expf(m - mx);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] *= alpha;
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        const int j = j0 + t;
        if (j < nk) {
          const float p = expf(sc[t] - mx);
          l += p;  // l sums the unrounded P (:93-95)
          const float pr = round_through<T>(p);  // P in V's dtype (:97)
#pragma unroll
          for (int i = 0; i < kPer; ++i) acc[i] = fmaf(pr, v_tile[j][i * kSplit + part], acc[i]);
        }
      }
      m = mx;
    }
  }
  if (!row_ok) return;
  const bool valid = m > kNegInf * 0.5f;  // at least one unmasked key
  const float denom = (l == 0.f) ? 1.f : l;
  T* orow = out + ((static_cast<long long>(b) * S + qi) * H + h) * D;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int dd = i * kSplit + part;
    if (dd < D) orow[dd] = from_f32<T>(valid ? acc[i] / denom : 0.f);
  }
  if (part == 0) {
    lse[(static_cast<long long>(b) * H + h) * S + qi] = valid ? m + logf(denom) : INFINITY;
  }
}

// -- K2dq and K2dkv -------------------------------------------------------------

template <int W>
struct Bwd {
  static constexpr int kSplit = W > 64 ? W / 32 : 2;   // threads a row
  static constexpr int kChunks = W / kSplit / 4;        // float4 chunks a thread
  static constexpr int kRows = W > 128 ? 32 : 64;       // rows a CTA
  static constexpr int kThreads = kRows * kSplit;       // at most 256
  static constexpr int kTile = W > 64 ? 64 * 64 / W : 64;  // rows a staged tile
};

// This thread's part of a row: float4 chunks kSplit*c + part, c <
// kChunks, zeros past the true D.
template <typename T, int W>
__device__ __forceinline__ void load_part(const T* row, int part, bool ok, int D, float* out) {
  using C = Bwd<W>;
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dd = 4 * (C::kSplit * c + part) + e;
      out[4 * c + e] = (ok && dd < D) ? to_f32(row[dd]) : 0.f;
    }
  }
}

template <typename T, int W>
__device__ __forceinline__ void store_part(T* row, int part, int D, const float* v) {
  using C = Bwd<W>;
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dd = 4 * (C::kSplit * c + part) + e;
      if (dd < D) row[dd] = from_f32<T>(v[4 * c + e]);
    }
  }
}

// This thread's part of the dot product of a register row with shared row `t`.
template <int W>
__device__ __forceinline__ float part_dot(const float* a, const float4* t, int part) {
  using C = Bwd<W>;
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c) {
    const float4 w = t[C::kSplit * c + part];
    s = fmaf(a[4 * c], w.x, s);
    s = fmaf(a[4 * c + 1], w.y, s);
    s = fmaf(a[4 * c + 2], w.z, s);
    s = fmaf(a[4 * c + 3], w.w, s);
  }
  return s;
}

// acc += f * shared row `t` (this thread's part).
template <int W>
__device__ __forceinline__ void part_axpy(float* acc, float f, const float4* t, int part) {
  using C = Bwd<W>;
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c) {
    const float4 w = t[C::kSplit * c + part];
    acc[4 * c] = fmaf(f, w.x, acc[4 * c]);
    acc[4 * c + 1] = fmaf(f, w.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(f, w.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(f, w.w, acc[4 * c + 3]);
  }
}

// Stage rows [r0, r0 + n) of a [B, S, H, D] tensor (head h of batch b,
// strides in elements) into a shared f32 tile of float4 chunks, zeros
// past the true D.
template <typename T, int W>
__device__ __forceinline__ void stage_rows(float4 (*tile)[W / 4], const T* base, long long ss,
                                           int r0, int n, int D) {
  for (int idx = threadIdx.x; idx < n * (W / 4); idx += Bwd<W>::kThreads) {
    const int j = idx / (W / 4);
    const int c = idx % (W / 4);
    const T* src = base + static_cast<long long>(r0 + j) * ss + 4 * c;
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = 4 * c + e < D ? to_f32(src[e]) : 0.f;
    tile[j][c] = make_float4(x[0], x[1], x[2], x[3]);
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(Bwd<W>::kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const uint8_t* __restrict__ kv_mask,
                const int* __restrict__ segs, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int S, int H, int D,
                Strides st, int causal, float scale) {
  using C = Bwd<W>;
  constexpr int kSplit = C::kSplit, kPer = 4 * C::kChunks, kTile = C::kTile;
  __shared__ float4 k_tile[kTile][W / 4];
  __shared__ float4 v_tile[kTile][W / 4];
  __shared__ float k_bias[kTile];
  __shared__ int k_seg[kTile];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * C::kRows;
  const int part = threadIdx.x % kSplit;
  const int qi = q0 + threadIdx.x / kSplit;
  const bool row_ok = qi < S;

  float qv[kPer], dov[kPer], acc[kPer];
  load_part<T, W>(q + b * st.qb + static_cast<long long>(qi) * st.qs + h * st.qh, part, row_ok,
                  D, qv);
  load_part<T, W>(dout + b * st.ob + static_cast<long long>(qi) * st.os + h * st.oh, part,
                  row_ok, D, dov);
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  const long long rv = (static_cast<long long>(b) * H + h) * S + qi;
  // rows past S take lse = +inf: p = 0, so they stay in the shuffles
  // of their warp without contributing
  const float lse_i = row_ok ? lse[rv] : INFINITY;
  const float delta_i = row_ok ? delta[rv] : 0.f;
  const int seg_q = (segs != nullptr && row_ok) ? segs[static_cast<long long>(b) * S + qi] : 0;

  const int q_last = min(q0 + C::kRows, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    const int nk = min(kTile, k_end - k0);
    __syncthreads();  // the previous tile's readers are done
    stage_rows<T, W>(k_tile, k + b * st.kb + h * st.kh, st.ks, k0, nk, D);
    stage_rows<T, W>(v_tile, v + b * st.vb + h * st.vh, st.vs, k0, nk, D);
    for (int j = threadIdx.x; j < nk; j += C::kThreads) {
      const long long key = static_cast<long long>(b) * S + k0 + j;
      k_bias[j] = (kv_mask != nullptr && !kv_mask[key]) ? kNegInf : 0.f;
      k_seg[j] = segs != nullptr ? segs[key] : 0;
    }
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float s_dot = group_sum<kSplit>(part_dot<W>(qv, k_tile[j], part));
      const float dp = group_sum<kSplit>(part_dot<W>(dov, v_tile[j], part));
      // the forward's order: scale, additive bias, then the segment and
      // causal masks replace the score
      float s = s_dot * scale + k_bias[j];
      if (segs != nullptr && k_seg[j] != seg_q) s = kNegInf;
      if (causal && k0 + j > qi) s = kNegInf;
      const float p = expf(s - lse_i);
      const float ds = round_through<T>(p * (dp - delta_i) * scale);  // (:202)
      part_axpy<W>(acc, ds, k_tile[j], part);
    }
  }
  if (!row_ok) return;
  store_part<T, W>(dq + ((static_cast<long long>(b) * S + qi) * H + h) * D, part, D, acc);
}

template <typename T, int W>
__global__ void __launch_bounds__(Bwd<W>::kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const uint8_t* __restrict__ kv_mask,
                 const int* __restrict__ segs, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int S,
                 int H, int D, Strides st, int causal, float scale) {
  using C = Bwd<W>;
  constexpr int kSplit = C::kSplit, kPer = 4 * C::kChunks, kTile = C::kTile;
  __shared__ float4 q_tile[kTile][W / 4];
  __shared__ float4 do_tile[kTile][W / 4];
  __shared__ float q_lse[kTile];
  __shared__ float q_delta[kTile];
  __shared__ int q_seg[kTile];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int k0 = blockIdx.x * C::kRows;
  const int part = threadIdx.x % kSplit;
  const int kj = k0 + threadIdx.x / kSplit;
  const bool key_ok = kj < S;

  float kv[kPer], vv[kPer], dka[kPer], dva[kPer];
  load_part<T, W>(k + b * st.kb + static_cast<long long>(kj) * st.ks + h * st.kh, part, key_ok,
                  D, kv);
  load_part<T, W>(v + b * st.vb + static_cast<long long>(kj) * st.vs + h * st.vh, part, key_ok,
                  D, vv);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
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
    stage_rows<T, W>(q_tile, q + b * st.qb + h * st.qh, st.qs, r0, nq, D);
    stage_rows<T, W>(do_tile, dout + b * st.ob + h * st.oh, st.os, r0, nq, D);
    for (int i = threadIdx.x; i < nq; i += C::kThreads) {
      q_lse[i] = lse[rv0 + r0 + i];
      q_delta[i] = delta[rv0 + r0 + i];
      q_seg[i] = segs != nullptr ? segs[static_cast<long long>(b) * S + r0 + i] : 0;
    }
    __syncthreads();
    for (int i = 0; i < nq; ++i) {
      const float s_dot = group_sum<kSplit>(part_dot<W>(kv, q_tile[i], part));
      const float dp = group_sum<kSplit>(part_dot<W>(vv, do_tile[i], part));
      float s = s_dot * scale + k_bias;
      if (segs != nullptr && q_seg[i] != seg_k) s = kNegInf;
      if (causal && kj > r0 + i) s = kNegInf;
      if (!key_ok) s = kNegInf;
      const float p = expf(s - q_lse[i]);
      const float ds = p * (dp - q_delta[i]) * scale;
      part_axpy<W>(dva, round_through<T>(p), do_tile[i], part);   // (:255)
      part_axpy<W>(dka, round_through<T>(ds), q_tile[i], part);   // (:262)
    }
  }
  if (!key_ok) return;
  const long long out = ((static_cast<long long>(b) * S + kj) * H + h) * D;
  store_part<T, W>(dk + out, part, D, dka);
  store_part<T, W>(dv + out, part, D, dva);
}

// l.run<T, W>() at the CUDA-core width W of d and the dtype; returns
// cudaGetLastError() after it, or cudaErrorInvalidValue
template <typename T, typename L>
int at_width(int d, const L& l) {
  switch (flash::simt_width(d)) {
    case 16: l.template run<T, 16>(); break;
    case 32: l.template run<T, 32>(); break;
    case 64: l.template run<T, 64>(); break;
    case 128: l.template run<T, 128>(); break;
    case 256: l.template run<T, 256>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename L>
int dispatch(int dtype, int d, const L& l) {
  if (d < 1 || d > flash::kMaxHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case kF32: return at_width<float>(d, l);
    case kBF16: return at_width<__nv_bfloat16>(d, l);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the launches, one functor a kernel (the arguments of the C call)
struct FwdLaunch {
  const void *q, *k, *v, *kv_mask, *segs;
  void *out, *lse;
  int B, S, H, d;
  Strides st;
  int causal;
  float scale;
  cudaStream_t stream;
  template <typename T, int W>
  void run() const {
    const dim3 grid((S + kBQ - 1) / kBQ, B * H);
    flash_fwd_kernel<T, W><<<grid, Fwd<W>::kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const uint8_t*>(kv_mask), static_cast<const int*>(segs), static_cast<T*>(out),
        static_cast<float*>(lse), S, H, d, st, causal, scale);
  }
};

struct BwdLaunch {
  const void *q, *k, *v, *dout, *kv_mask, *segs, *lse, *delta;
  void *d0, *d1;  // dq (K2dq), or dk and dv (K2dkv)
  int B, S, H, d;
  Strides st;
  int causal;
  float scale;
  cudaStream_t stream;
  template <typename T, int W>
  void run() const {
    const dim3 grid((S + Bwd<W>::kRows - 1) / Bwd<W>::kRows, B * H);
    const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
            *tv = static_cast<const T*>(v), *tdo = static_cast<const T*>(dout);
    const uint8_t* mask = static_cast<const uint8_t*>(kv_mask);
    const int* sg = static_cast<const int*>(segs);
    const float *fl = static_cast<const float*>(lse), *fd = static_cast<const float*>(delta);
    if (d1 == nullptr) {
      flash_dq_kernel<T, W><<<grid, Bwd<W>::kThreads, 0, stream>>>(
          tq, tk, tv, tdo, mask, sg, fl, fd, static_cast<T*>(d0), S, H, d, st, causal, scale);
    } else {
      flash_dkv_kernel<T, W><<<grid, Bwd<W>::kThreads, 0, stream>>>(
          tq, tk, tv, tdo, mask, sg, fl, fd, static_cast<T*>(d0), static_cast<T*>(d1), S, H, d,
          st, causal, scale);
    }
  }
};

}  // namespace

namespace port {
namespace flash {

int simt_fwd(const void* q, const void* k, const void* v, const void* kv_mask, const void* segs,
             void* out, void* lse, int B, int S, int H, int d, const Strides& st, int causal,
             float scale, int dtype, cudaStream_t stream) {
  return dispatch(dtype, d, FwdLaunch{q, k, v, kv_mask, segs, out, lse, B, S, H, d, st, causal,
                                      scale, stream});
}

int simt_dq(const void* q, const void* k, const void* v, const void* dout, const void* kv_mask,
            const void* segs, const void* lse, const void* delta, void* dq, int B, int S, int H,
            int d, const Strides& st, int causal, float scale, int dtype, cudaStream_t stream) {
  return dispatch(dtype, d, BwdLaunch{q, k, v, dout, kv_mask, segs, lse, delta, dq, nullptr, B,
                                      S, H, d, st, causal, scale, stream});
}

int simt_dkv(const void* q, const void* k, const void* v, const void* dout, const void* kv_mask,
             const void* segs, const void* lse, const void* delta, void* dk, void* dv, int B,
             int S, int H, int d, const Strides& st, int causal, float scale, int dtype,
             cudaStream_t stream) {
  return dispatch(dtype, d, BwdLaunch{q, k, v, dout, kv_mask, segs, lse, delta, dk, dv, B, S, H,
                                      d, st, causal, scale, stream});
}

}  // namespace flash
}  // namespace port
