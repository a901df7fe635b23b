// K2 forward: flash attention on [B, S, H, D] with causal, key-padding
// (kv_mask) and segment-id masks; writes out [B, S, H, D] and the
// per-row logsumexp lse [B, H, S] (+inf on rows with no unmasked key).
//
// Replaces pyspark_tf_gke_tpu/ops/pallas/flash_attention.py::_fwd_kernel
// (:49), launched from _flash_fwd_bh (:146).
//
// Bound on the H100: at the serving shapes (S <= 1024, D = 64) the
// causal forward does 4*S*S/2*D operations per (batch, head) against
// 4*S*D*2 bytes of q/k/v/out, so bf16 work on the tensor cores would be
// close to the memory bound; this first kernel computes on the f32
// units instead and is bound by them. Design: one CTA per (b*h, 64-row
// query block) and one thread per query row. Each thread keeps its
// query row and f32 accumulator in registers; K/V tiles of 64 keys are
// staged in shared memory as f32 and read by every thread at the same
// address (a broadcast, no bank conflicts). The online softmax
// (running max m, normaliser l) updates once per 16 keys. Causal
// blocks stop at the block's last query row, so key tiles wholly in
// the future are never loaded. The kernel reads [B, S, H, D] through
// strides, so no transposed copy of q/k/v is made (the TPU version
// transposes to [B*H, S, D]). S need not be a multiple of the tile:
// query rows and keys past S are masked. Tensor cores (wgmma), TMA and
// a pipelined K/V ring are later work.

#include "common.cuh"

using namespace port;

namespace {

constexpr int kBQ = 64;   // query rows per CTA == threads per CTA
constexpr int kBK = 64;   // keys per shared-memory tile
constexpr int kSub = 16;  // keys per online-softmax update

template <typename T, int D>
__global__ void __launch_bounds__(kBQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ kv_mask,
                 const int* __restrict__ segs, T* __restrict__ out,
                 float* __restrict__ lse, int S, int H,
                 long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh,
                 int causal, float scale) {
  __shared__ float k_tile[kBK][D];
  __shared__ float v_tile[kBK][D];
  __shared__ float k_bias[kBK];
  __shared__ int k_seg[kBK];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int qi = q0 + threadIdx.x;
  const bool row_ok = qi < S;

  float qv[D];
  float acc[D];
  const T* qrow = q + b * qsb + static_cast<long long>(qi) * qss + h * qsh;
#pragma unroll
  for (int dd = 0; dd < D; ++dd) {
    qv[dd] = row_ok ? to_f32(qrow[dd]) : 0.f;
    acc[dd] = 0.f;
  }
  const int seg_q = (segs != nullptr && row_ok) ? segs[static_cast<long long>(b) * S + qi] : 0;
  float m = kNegInf;
  float l = 0.f;

  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    const int nk = min(kBK, k_end - k0);
    __syncthreads();  // the previous tile's readers are done
    for (int idx = threadIdx.x; idx < nk * D; idx += kBQ) {
      const int j = idx / D;
      const int dd = idx % D;
      const long long key = k0 + j;
      k_tile[j][dd] = to_f32(k[b * ksb + key * kss + h * ksh + dd]);
      v_tile[j][dd] = to_f32(v[b * vsb + key * vss + h * vsh + dd]);
    }
    for (int j = threadIdx.x; j < nk; j += kBQ) {
      const long long key = static_cast<long long>(b) * S + k0 + j;
      k_bias[j] = (kv_mask != nullptr && !kv_mask[key]) ? kNegInf : 0.f;
      k_seg[j] = segs != nullptr ? segs[key] : 0;
    }
    __syncthreads();
    if (!row_ok) continue;
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
          for (int dd = 0; dd < D; ++dd) dot = fmaf(qv[dd], k_tile[j][dd], dot);
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
      for (int dd = 0; dd < D; ++dd) acc[dd] *= alpha;
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        const int j = j0 + t;
        if (j < nk) {
          const float p = expf(sc[t] - mx);
          l += p;
#pragma unroll
          for (int dd = 0; dd < D; ++dd) acc[dd] = fmaf(p, v_tile[j][dd], acc[dd]);
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
  for (int dd = 0; dd < D; ++dd) orow[dd] = from_f32<T>(valid ? acc[dd] / denom : 0.f);
  lse[(static_cast<long long>(b) * H + h) * S + qi] = valid ? m + logf(denom) : INFINITY;
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const void* kv_mask,
            const void* segs, void* out, void* lse, int B, int S, int H,
            const long long* st, int causal, float scale, cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, D><<<grid, kBQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(kv_mask), static_cast<const int*>(segs),
      static_cast<T*>(out), static_cast<float*>(lse), S, H,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, scale);
}

}  // namespace

// strides: q (batch, seq, head), k (batch, seq, head), v (batch, seq,
// head), in elements; the head_dim axis must be contiguous.
extern "C" int port_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* kv_mask,
    const void* segs, void* out, void* lse, int B, int S, int H, int D,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    int causal, float scale, int dtype, int device, void* stream) {
  // this library links its own CUDA runtime: select the caller's
  // device in it before launching on the caller's stream
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (B * H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // head_dim 64 is the only width a ported model uses (GPT-small); a
  // new width is a new instantiation, checked on the card before use
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: launch<float, 64>(q, k, v, kv_mask, segs, out, lse, B, S, H, st, causal, scale, s); break;
    case kBF16: launch<__nv_bfloat16, 64>(q, k, v, kv_mask, segs, out, lse, B, S, H, st, causal, scale, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
