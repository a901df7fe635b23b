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
// The entry point runs the design of the plan (flash_attention.cuh,
// ops/flash_attention.py flash_plan), from the head width and dtype
// alone: bf16 at head_dim 64 and 128 takes the tensor-core design below,
// every other width and f32 at every width the CUDA-core design
// (flash_attention_simt.cu).
//
// bf16 (flash_fwd_wgmma<D>, the tensor-core design, D 64 or 128): a CTA
// owns 128 query rows of one (b, h) on two warpgroups of 64 rows. Q is
// loaded once and 64-key K/V tiles stream through a 2-stage shared-memory
// ring, all by TMA from 4-D tensor maps over the strided [B, S, H, D]
// views (no transposed copy; rows past S arrive as zeros), each stage
// guarded by an mbarrier. A tile row of D bf16 is D/64 128-byte swizzle
// atoms: each tile is D/64 column blocks of 64 head_dim values, one TMA
// box each (a 128B-swizzled box is at most 128 bytes wide). S = Q K^T is
// D/16 wgmma k16 steps from shared memory (bf16 operands, f32
// accumulators), the descriptors stepping 32 bytes inside an atom and
// then to the next column block; the scale, the kv bias, the segment
// and causal masks are applied to the accumulator fragments (the causal
// compare on diagonal tiles only; key tiles wholly in a warpgroup's
// future are skipped; the tile's bias and segment ids are staged in
// shared memory); the row max and sum use the quad shuffles of the
// fragment. The rounding points are the TPU kernel's: l sums the
// unrounded f32 P (:93-95), P is rounded to bf16 in registers (:97) and
// O += P V is a wgmma with A from registers and V read through the
// transpose bit (V is key-major, head_dim contiguous; at D 128 an n128
// product over the two column blocks, 8 KB apart); the f32 accumulator
// is divided by l once at the end, rows with no unmasked key give 0 and
// lse +inf (:108-114). Causal CTAs start with the last query block (the
// longest) so the tail of the grid is short. Warp specialisation,
// persistent CTAs and pingpong scheduling are later work; each tile's
// two products wait for each other here. Shared memory: 48 KB at D 64,
// 96 KB at D 128.


#include "flash_attention.cuh"
#include "wgmma.cuh"

using namespace port;

namespace {

// -- bf16: the tensor-core design ---------------------------------------------

namespace wg {

using namespace port::hopper;

constexpr int kBQ = 128;    // query rows per CTA: two warpgroups of 64
constexpr int kBKV = 64;    // keys per K/V tile
constexpr int kStages = 2;  // K/V ring depth
constexpr int kThreads = 256;
constexpr int kAtomRow = 128;  // a swizzle-atom row: 64 bf16 of head_dim
constexpr float kLog2e = 1.4426950408889634f;

// The shared-memory plan at head width D: every tile is D/64 column
// blocks ([rows][64 bf16], 128B-swizzled), block a at a * rows * 128.
template <int D>
struct Layout {
  static constexpr int kAtoms = D / 64;
  static constexpr int kQBlock = kBQ * kAtomRow;    // Q's column-block stride
  static constexpr int kKVBlock = kBKV * kAtomRow;  // a K or V tile's
  static constexpr int kQBytes = kAtoms * kQBlock;
  static constexpr int kTileBytes = kAtoms * kKVBlock;
  static constexpr int kStageBytes = 2 * kTileBytes;  // K then V
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  // 1024 of slack to align the swizzled tiles, the tiles, the stage and
  // Q barriers, then each stage's kv bias (f32) and segment ids
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (kStages + 1) + 2 * kStages * kBKV * 4;
};
static_assert(Layout<128>::kSmem <= 232448, "shared memory");

// O (+)= P V over one 64-key tile: four k16 steps, A (bf16 P) from
// registers, V read MN-major through the transpose bit; at D 128 one
// n128 product whose B spans the tile's two column blocks (LBO apart)
template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2], const uint32_t (&p)[4][4],
                                           uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = desc_mnmajor(v_addr + kk * 16 * kAtomRow, Layout<D>::kKVBlock);
    if constexpr (D == 64) wgmma_m64n64k16_rs<1>(o, p[kk], db, 1);
    else wgmma_m64n128k16_rs<1>(o, p[kk], db, 1);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wgmma(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
                __grid_constant__ const CUtensorMap tv, const uint8_t* __restrict__ kv_mask,
                const int* __restrict__ segs, __nv_bfloat16* __restrict__ out,
                float* __restrict__ lse, int S, int H, int causal, float scale) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;
  uint8_t* kv_s = smem + L::kQBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);  // stages, then Q
  float* bias_s = reinterpret_cast<float*>(bars + kStages + 1);         // [kStages][kBKV]
  int* seg_s = reinterpret_cast<int*>(bias_s + kStages * kBKV);         // [kStages][kBKV]

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
    uint8_t* dst = kv_s + st * L::kStageBytes;
    mbar_arrive_expect_tx(&bars[st], L::kStageBytes);
#pragma unroll
    for (int a = 0; a < L::kAtoms; ++a) {
      tma_load_4d(dst + a * L::kKVBlock, &tk, &bars[st], 64 * a, h, tile * kBKV, b);
      tma_load_4d(dst + L::kTileBytes + a * L::kKVBlock, &tv, &bars[st], 64 * a, h,
                  tile * kBKV, b);
    }
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
    mbar_arrive_expect_tx(&bars[kStages], L::kQBytes);
#pragma unroll
    for (int a = 0; a < L::kAtoms; ++a)
      tma_load_4d(q_s + a * L::kQBlock, &tq, &bars[kStages], 64 * a, h, q0, b);
    for (int i = 0; i < kStages && i < ntiles; ++i) load_kv(i, i);
  }
  if (masks && t < kBKV) stage_masks(0, 0);
  const int seg_a = (segs != nullptr && row_a < S) ? segs[brow + row_a] : 0;
  const int seg_b = (segs != nullptr && row_b < S) ? segs[brow + row_b] : 0;
  __syncthreads();

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;  // l: this thread's columns
  const uint32_t q_addr = smem_u32(q_s) + g * 64 * kAtomRow;
  mbar_wait(&bars[kStages], 0);

  for (int it = 0; it < ntiles; ++it) {
    const int st = it % kStages;
    const int k0 = it * kBKV;
    mbar_wait(&bars[st], (it / kStages) & 1);
    // a tile wholly in the future of every row of the warpgroup is skipped
    if (!causal || k0 <= wg_row0 + 63) {
      const uint32_t k_addr = smem_u32(kv_s + st * L::kStageBytes);
      const uint32_t v_addr = k_addr + L::kTileBytes;
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      wgmma_fence();
      // D/16 k16 steps: 32 bytes on inside a column block, then the next block
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t step = (kk & 3) * 32;
        wgmma_m64n64k16_ss<0>(s, desc_kmajor(q_addr + (kk >> 2) * L::kQBlock + step),
                              desc_kmajor(k_addr + (kk >> 2) * L::kKVBlock + step), kk);
      }
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
      for (int j = 0; j < D / 8; ++j) {
        o[j * 4 + 0] *= alpha_a;
        o[j * 4 + 1] *= alpha_a;
        o[j * 4 + 2] *= alpha_b;
        o[j * 4 + 3] *= alpha_b;
      }
      wgmma_fence();
      pv_product<D>(o, p, v_addr);
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
    __nv_bfloat16* orow = out + ((brow + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float v0 = valid ? o[j * 4 + 2 * r] / denom : 0.f;
      const float v1 = valid ? o[j * 4 + 2 * r + 1] / denom : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * (lane & 3)) =
          __floats2bfloat162_rn(v0, v1);
    }
    if ((lane & 3) == 0)
      lse[(static_cast<long long>(b) * H + h) * S + row] = valid ? m + logf(denom) : INFINITY;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* kv_mask, const void* segs,
           void* out, void* lse, int B, int S, int H, const flash::Strides& st, int causal,
           float scale, cudaStream_t stream) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  CUtensorMap mq, mk, mv;
  if (!tensor_map_bshd(encode, &mq, q, B, S, H, st.qb, st.qs, st.qh, kBQ, D) ||
      !tensor_map_bshd(encode, &mk, k, B, S, H, st.kb, st.ks, st.kh, kBKV, D) ||
      !tensor_map_bshd(encode, &mv, v, B, S, H, st.vb, st.vs, st.vh, kBKV, D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<D>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_fwd_wgmma<D><<<grid, kThreads, Layout<D>::kSmem, stream>>>(
      mq, mk, mv, static_cast<const uint8_t*>(kv_mask), static_cast<const int*>(segs),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), S, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

}  // namespace

// strides: q (batch, seq, head), k (batch, seq, head), v (batch, seq,
// head), in elements; the head_dim axis must be contiguous. width: the
// plan's (ops/flash_attention.py flash_plan), checked against
// flash::plan_width; D outside 1..256 returns cudaErrorInvalidValue. The
// tensor-core design (bf16 at D 64 and 128, through TMA) also needs
// 16-byte aligned bases and strides of size>1 dimensions that are
// multiples of 8 elements, or it returns cudaErrorInvalidValue.
extern "C" int port_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* kv_mask,
    const void* segs, void* out, void* lse, int B, int S, int H, int D,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    int causal, float scale, int dtype, int width, int device, void* stream) {
  // this library links its own CUDA runtime: select the caller's
  // device in it before launching on the caller's stream
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  const int w = flash::plan_width(D, dtype);
  if (w == 0 || w != width) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (B * H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const flash::Strides st{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!flash::tensor_core(D, dtype)) {
    return flash::simt_fwd(q, k, v, kv_mask, segs, out, lse, B, S, H, D, st, causal, scale,
                           dtype, s);
  }
  return D == 64 ? wg::launch<64>(q, k, v, kv_mask, segs, out, lse, B, S, H, st, causal, scale, s)
                 : wg::launch<128>(q, k, v, kv_mask, segs, out, lse, B, S, H, st, causal, scale,
                                   s);
}
