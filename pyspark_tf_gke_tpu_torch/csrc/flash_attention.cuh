// K2's plan and the CUDA-core designs' entry points, shared by the three
// flash sources: flash_attention.cu (K2f), flash_attention_bwd.cu (K2dq,
// K2dkv) and flash_attention_simt.cu (the CUDA-core designs of all
// three).
//
// The plan is ops/flash_attention.py flash_plan, recomputed here from
// the head width d and the dtype alone: every d in 1..kMaxHeadDim has a
// kernel. bf16 at d 64 and 128 runs the tensor-core designs (wgmma,
// operands by TMA) instantiated at that width; every other (d, dtype)
// runs the CUDA-core design instantiated at the smallest of 16, 32, 64,
// 128 and 256 that holds d, its loads masked to the true d (the padded columns
// are 0, so they add nothing to a score or an output) and its outputs
// written for the true d alone. The wrappers pass the plan's width, and
// the entry points refuse a call whose width is not the plan's.
#pragma once

#include "common.cuh"

namespace port {
namespace flash {

constexpr int kMaxHeadDim = 256;  // the widest head of the public model families (Gemma)

// q, k, v and dout element strides (batch, seq, head); head_dim contiguous
struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

inline bool tensor_core(int d, int dtype) { return dtype == kBF16 && (d == 64 || d == 128); }

// the CUDA-core design's instantiated widths: 16, 32, 64, 128, 256
inline int simt_width(int d) {
  int w = 16;
  while (w < d) w *= 2;
  return w;
}

// the plan's width of (d, dtype), or 0 outside the kernels' limits
inline int plan_width(int d, int dtype) {
  if (d < 1 || d > kMaxHeadDim || (dtype != kF32 && dtype != kBF16)) return 0;
  return tensor_core(d, dtype) ? d : simt_width(d);
}

// The CUDA-core designs (flash_attention_simt.cu), at the plan's width
// for (d, dtype): 0 or a CUDA error code. Outputs are contiguous
// [B, S, H, d]; lse and delta f32 [B, H, S].
int simt_fwd(const void* q, const void* k, const void* v, const void* kv_mask, const void* segs,
             void* out, void* lse, int B, int S, int H, int d, const Strides& st, int causal,
             float scale, int dtype, cudaStream_t stream);
int simt_dq(const void* q, const void* k, const void* v, const void* dout, const void* kv_mask,
            const void* segs, const void* lse, const void* delta, void* dq, int B, int S, int H,
            int d, const Strides& st, int causal, float scale, int dtype, cudaStream_t stream);
int simt_dkv(const void* q, const void* k, const void* v, const void* dout, const void* kv_mask,
             const void* segs, const void* lse, const void* delta, void* dk, void* dv, int B,
             int S, int H, int d, const Strides& st, int causal, float scale, int dtype,
             cudaStream_t stream);

}  // namespace flash
}  // namespace port
