// K2 forward: flash attention on [B, S, H, D] with causal, key-padding
// (kv_mask) and segment-id masks; writes out [B, S, H, D] and the
// per-row logsumexp lse [B, H, S] (+inf on rows with no unmasked key).
//
// Replaces pyspark_tf_gke_tpu/ops/pallas/flash_attention.py::_fwd_kernel
// (:49), launched from _flash_fwd_bh (:146).
//
// Bound on the H100: the causal forward does 4*S*S/2*D operations per
// (batch, head) against 4*S*D*2 bytes of q/k/v/out; at B=8 S=1024 H=12
// D=64 that is 0.0151 ms of bytes against 0.0130 ms of bf16 tensor-core
// operations, so the kernel is bound by bytes, and by the rate it can
// feed the tensor cores from shared memory once the bytes are in.
//
// The port's entry point chooses the design by dtype and nothing else:
//
// bf16 (flash_fwd_wgmma, the tensor-core design): a CTA owns 128 query
// rows of one (b, h) on two warpgroups of 64 rows. Q is loaded once and
// 64-key K/V tiles stream through a 2-stage shared-memory ring, all by
// TMA from 4-D tensor maps over the strided [B, S, H, D] views (no
// transposed copy; rows past S arrive as zeros), each stage guarded by
// an mbarrier. S = Q K^T is four wgmma k16 steps from shared memory
// (bf16 operands, f32 accumulators); the scale, the kv bias, the segment
// and causal masks are applied to the accumulator fragments (the causal
// compare on diagonal tiles only; key tiles wholly in a warpgroup's
// future are skipped; the tile's bias and segment ids are staged in
// shared memory); the row max and sum use the quad shuffles of the
// fragment. The rounding points are the TPU kernel's: l sums the
// unrounded f32 P (:93-95), P is rounded to bf16 in registers (:97) and
// O += P V is a wgmma with A from registers and V read through the
// transpose bit (V is key-major, head_dim contiguous); the f32
// accumulator is divided by l once at the end, rows with no unmasked key
// give 0 and lse +inf (:108-114). Causal CTAs start with the last query
// block (the longest) so the tail of the grid is short. Warp
// specialisation, persistent CTAs and pingpong scheduling are later
// work; each tile's two products wait for each other here.
//
// f32 (flash_fwd_kernel, the first, CUDA-core design, kept as the f32
// reference that the model-parity gates stand on): one CTA per (b*h,
// 64-row query block) and one thread per query row on the CUDA cores;
// K/V tiles of 64 keys staged in shared memory as f32; P stays f32 for
// P V.


#include "common.cuh"
#include "wgmma.cuh"

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

// -- bf16: the tensor-core design ---------------------------------------------

namespace wg {

using namespace port::hopper;

constexpr int kBQ = 128;    // query rows per CTA: two warpgroups of 64
constexpr int kBKV = 64;    // keys per K/V tile
constexpr int kStages = 2;  // K/V ring depth
constexpr int kThreads = 256;
constexpr int kRowBytes = 128;  // 64 bf16 of head_dim: one swizzle row
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kQBytes = kBQ * kRowBytes;
constexpr int kTileBytes = kBKV * kRowBytes;
constexpr int kStageBytes = 2 * kTileBytes;  // K then V
constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
// 1024 of slack to align the swizzled tiles, the tiles, the stage and Q
// barriers, then each stage's kv bias (f32) and segment ids
constexpr int kSmem = 1024 + kBarOffset + 8 * (kStages + 1) + 2 * kStages * kBKV * 4;

__global__ void __launch_bounds__(kThreads)
flash_fwd_wgmma(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
                __grid_constant__ const CUtensorMap tv, const uint8_t* __restrict__ kv_mask,
                const int* __restrict__ segs, __nv_bfloat16* __restrict__ out,
                float* __restrict__ lse, int S, int H, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;
  uint8_t* kv_s = smem + kQBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBarOffset);  // stages, then Q
  float* bias_s = reinterpret_cast<float*>(bars + kStages + 1);      // [kStages][kBKV]
  int* seg_s = reinterpret_cast<int*>(bias_s + kStages * kBKV);      // [kStages][kBKV]

  const int t = threadIdx.x, g = t >> 7, warp = (t >> 5) & 3, lane = t & 31;
  // causal: the last query block (the most keys) first
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kBQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int wg_row0 = q0 + 64 * g;                       // the warpgroup's first row
  const int row_a = wg_row0 + 16 * warp + (lane >> 2);  // the thread's two rows
  const int row_b = row_a + 8;
  const int k_end = causal ? min(q0 + kBQ, S) : S;
  const int ntiles = (k_end + kBKV - 1) / kBKV;
  const bool masks = kv_mask != nullptr || segs != nullptr;
  const long long brow = static_cast<long long>(b) * S;

  auto load_kv = [&](int tile, int st) {  // one thread
    mbar_arrive_expect_tx(&bars[st], kStageBytes);
    tma_load_4d(kv_s + st * kStageBytes, &tk, &bars[st], 0, h, tile * kBKV, b);
    tma_load_4d(kv_s + st * kStageBytes + kTileBytes, &tv, &bars[st], 0, h, tile * kBKV, b);
  };
  auto stage_masks = [&](int tile, int st) {  // threads 0..kBKV-1
    const int key = tile * kBKV + t;
    const bool in = key < S;
    bias_s[st * kBKV + t] = (in && kv_mask != nullptr && !kv_mask[brow + key]) ? kNegInf : 0.f;
    seg_s[st * kBKV + t] = (in && segs != nullptr) ? segs[brow + key] : 0;
  };

  if (t == 0) {
    for (int st = 0; st <= kStages; ++st) mbar_init(&bars[st], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (t == 0) {
    mbar_arrive_expect_tx(&bars[kStages], kQBytes);
    tma_load_4d(q_s, &tq, &bars[kStages], 0, h, q0, b);
    for (int i = 0; i < kStages && i < ntiles; ++i) load_kv(i, i);
  }
  if (masks && t < kBKV) stage_masks(0, 0);
  const int seg_a = (segs != nullptr && row_a < S) ? segs[brow + row_a] : 0;
  const int seg_b = (segs != nullptr && row_b < S) ? segs[brow + row_b] : 0;
  __syncthreads();

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;  // l: this thread's columns
  const uint32_t q_addr = smem_u32(q_s) + g * 64 * kRowBytes;
  mbar_wait(&bars[kStages], 0);

  for (int it = 0; it < ntiles; ++it) {
    const int st = it % kStages;
    const int k0 = it * kBKV;
    mbar_wait(&bars[st], (it / kStages) & 1);
    // a tile wholly in the future of every row of the warpgroup is skipped
    if (!causal || k0 <= wg_row0 + 63) {
      const uint32_t k_addr = smem_u32(kv_s + st * kStageBytes);
      const uint32_t v_addr = k_addr + kTileBytes;
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_ss<0>(s, desc_kmajor(q_addr + kk * 32), desc_kmajor(k_addr + kk * 32), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(s);

      // scale, kv bias, then the segment and causal masks replace the
      // score (the TPU kernel's order); keys past S take no part. Each
      // mask runs only on the tiles that need it.
      const int kq = 2 * (lane & 3);  // the thread's first column in each 8
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= scale;
      if (masks) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kc = j * 8 + kq + (e & 1);
            float v = s[j * 4 + e] + bias_s[st * kBKV + kc];
            if (segs != nullptr && seg_s[st * kBKV + kc] != (e < 2 ? seg_a : seg_b)) v = kNegInf;
            s[j * 4 + e] = v;
          }
        }
      }
      if (causal && k0 + kBKV - 1 > wg_row0) {  // a diagonal tile
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (k0 + j * 8 + kq + (e & 1) > (e < 2 ? row_a : row_b)) s[j * 4 + e] = kNegInf;
          }
        }
      }
      if (k0 + kBKV > S) {  // the last tile of a ragged S
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (k0 + j * 8 + kq + (e & 1) >= S) s[j * 4 + e] = -INFINITY;
          }
        }
      }
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(s[j * 4 + 0], s[j * 4 + 1]));
        mx_b = fmaxf(mx_b, fmaxf(s[j * 4 + 2], s[j * 4 + 3]));
      }
      // the four threads of a quad hold one row's 64 columns
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      // exp(v - m) as exp2((v - m) * log2 e): one multiply and MUFU.EX2
      const float alpha_a = exp2f((m_a - mx_a) * kLog2e), alpha_b = exp2f((m_b - mx_b) * kLog2e);
      m_a = mx_a;
      m_b = mx_b;
      uint32_t p[4][4];  // bf16 P as the A fragments of the four k16 steps
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pa0 = exp2f((s[j * 4 + 0] - m_a) * kLog2e);
        const float pa1 = exp2f((s[j * 4 + 1] - m_a) * kLog2e);
        const float pb0 = exp2f((s[j * 4 + 2] - m_b) * kLog2e);
        const float pb1 = exp2f((s[j * 4 + 3] - m_b) * kLog2e);
        sum_a += pa0 + pa1;  // l sums the unrounded P
        sum_b += pb0 + pb1;
        p[j / 2][(j % 2) * 2 + 0] = pack_bf16(pa0, pa1);
        p[j / 2][(j % 2) * 2 + 1] = pack_bf16(pb0, pb1);
      }
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[j * 4 + 0] *= alpha_a;
        o[j * 4 + 1] *= alpha_a;
        o[j * 4 + 2] *= alpha_b;
        o[j * 4 + 3] *= alpha_b;
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_rs<1>(o, p[kk], desc_mnmajor(v_addr + kk * 16 * kRowBytes), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(o);
    }
    if (masks && it + 1 < ntiles && t < kBKV) stage_masks(it + 1, (it + 1) % kStages);
    __syncthreads();  // stage st is free for the tile kStages on
    if (t == 0 && it + kStages < ntiles) load_kv(it + kStages, st);
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? row_a : row_b;
    if (row >= S) continue;
    const float m = r == 0 ? m_a : m_b;
    const float l = r == 0 ? l_a : l_b;
    const bool valid = m > kNegInf * 0.5f;  // at least one unmasked key
    const float denom = (l == 0.f) ? 1.f : l;
    __nv_bfloat16* orow = out + ((brow + row) * H + h) * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v0 = valid ? o[j * 4 + 2 * r] / denom : 0.f;
      const float v1 = valid ? o[j * 4 + 2 * r + 1] / denom : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * (lane & 3)) =
          __floats2bfloat162_rn(v0, v1);
    }
    if ((lane & 3) == 0)
      lse[(static_cast<long long>(b) * H + h) * S + row] = valid ? m + logf(denom) : INFINITY;
  }
}

int launch(const void* q, const void* k, const void* v, const void* kv_mask, const void* segs,
           void* out, void* lse, int B, int S, int H, const long long* st, int causal,
           float scale, cudaStream_t stream) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  CUtensorMap mq, mk, mv;
  if (!tensor_map_bshd(encode, &mq, q, B, S, H, st[0], st[1], st[2], kBQ) ||
      !tensor_map_bshd(encode, &mk, k, B, S, H, st[3], st[4], st[5], kBKV) ||
      !tensor_map_bshd(encode, &mv, v, B, S, H, st[6], st[7], st[8], kBKV)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_fwd_wgmma<<<grid, kThreads, kSmem, stream>>>(
      mq, mk, mv, static_cast<const uint8_t*>(kv_mask), static_cast<const int*>(segs),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), S, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

}  // namespace

// strides: q (batch, seq, head), k (batch, seq, head), v (batch, seq,
// head), in elements; the head_dim axis must be contiguous. bf16 (the
// tensor-core design, through TMA) also needs 16-byte aligned bases and
// strides of size>1 dimensions that are multiples of 8 elements, or it
// returns cudaErrorInvalidValue; f32 runs the CUDA-core design.
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
    case kBF16: return wg::launch(q, k, v, kv_mask, segs, out, lse, B, S, H, st, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
