// K1: paged attention. For each slot b, S query tokens attend through
// the slot's block-table row over a global K/V page pool. Query i sits
// at absolute position fill[b] - S + i and sees keys at positions <=
// that; rows with no live key (fill - S + i < 0, or fill <= 0) are 0.
// GQA: each KV head serves G = H / Hkv query heads. int8 pages are
// dequantized with f32 per-(position, head) scale pages.
//
// Replaces pyspark_tf_gke_tpu/ops/pallas/paged_attention.py::_paged_kernel
// (:124), launched from _paged_pallas (:254). One body serves the S = 1
// decode step and S > 1 chunks, as on the TPU.
//
// Bound on the H100: memory. A decode step reads every live K/V byte
// of every slot once and does ~4 operations per element read. The TPU
// kernel walks a sequential (slot, page) grid carrying m/l/acc in VMEM
// and clamps dead pages in its index map so their DMA is skipped. On
// Hopper blocks run in no order, so the design is one CTA per (slot,
// KV head): the CTA reads its own fill level and table row and loops
// over only ceil(fill / P) live pages, clamping sentinel entries (>= N)
// into the pool as the reference does. Each page's K and V tile for
// this KV head is staged in shared memory (dequantized on load for
// int8, then rounded through the query dtype as the reference does);
// the G*S query rows of the head group live in shared memory, so each
// KV head is read once for its whole query group. Scores, the online
// softmax (one warp per row, f32) and the P.V update run out of shared
// memory. Pages are loaded one at a time with a barrier between
// (no cp.async/TMA double buffering yet); splitting a long sequence
// across CTAs (flash-decoding) is later work.

#include "common.cuh"

using namespace port;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename T, typename KV, bool kQuant>
__global__ void __launch_bounds__(kThreads)
paged_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
             const KV* __restrict__ vp, const float* __restrict__ ks,
             const float* __restrict__ vs, const int* __restrict__ table,
             const int* __restrict__ fills, T* __restrict__ out,
             int S, int H, int Hkv, int D, int N, int P, int MP, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int hk = blockIdx.y;
  const int G = H / Hkv;
  const int R = S * G;  // query rows of this CTA: r = s * G + g
  float* k_t = smem;                 // [P][D + 1] (padded: conflict-free)
  float* v_t = k_t + P * (D + 1);    // [P][D]
  float* q_s = v_t + P * D;          // [R][D]
  float* sc = q_s + R * D;           // [R][P] scores, then probabilities
  float* acc = sc + R * P;           // [R][D]
  float* m_r = acc + R * D;          // [R] running max
  float* l_r = m_r + R;              // [R] running normaliser
  float* a_r = l_r + R;              // [R] this page's rescale factor
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int fill = fills[b];

  for (int idx = tid; idx < R * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int s = r / G, g = r % G;
    q_s[idx] = to_f32(q[((static_cast<long long>(b) * S + s) * H + hk * G + g) * D + d]);
    acc[idx] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_r[r] = kNegInf;
    l_r[r] = 0.f;
  }

  int live_pages = fill > 0 ? (fill + P - 1) / P : 0;
  if (live_pages > MP) live_pages = MP;
  for (int j = 0; j < live_pages; ++j) {
    int page = table[static_cast<long long>(b) * MP + j];
    page = page < 0 ? 0 : (page >= N ? N - 1 : page);  // sentinel clamp
    __syncthreads();  // previous page fully consumed
    for (int idx = tid; idx < P * D; idx += kThreads) {
      const int t = idx / D, d = idx % D;
      const long long row = (static_cast<long long>(page) * P + t) * Hkv + hk;
      float kk = to_f32(kp[row * D + d]);
      float vv = to_f32(vp[row * D + d]);
      if (kQuant) {
        kk = round_through<T>(kk * ks[row]);
        vv = round_through<T>(vv * vs[row]);
      }
      k_t[t * (D + 1) + d] = kk;
      v_t[t * D + d] = vv;
    }
    __syncthreads();
    for (int idx = tid; idx < R * P; idx += kThreads) {
      const int r = idx / P, t = idx % P;
      const int q_abs = fill - S + r / G;
      const float* qr = q_s + r * D;
      const float* kr = k_t + t * (D + 1);
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      sc[idx] = (j * P + t <= q_abs) ? dot * scale : kNegInf;
    }
    __syncthreads();
    for (int r = warp; r < R; r += kWarps) {
      float* row = sc + r * P;
      float mx = kNegInf;
      for (int t = lane; t < P; t += 32) mx = fmaxf(mx, row[t]);
      mx = warp_max(mx);
      const float m_prev = m_r[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < P; t += 32) {
        const float p = expf(row[t] - m_new);
        row[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_r[r] = alpha;
        l_r[r] = l_r[r] * alpha + sum;
        m_r[r] = m_new;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < R * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const float* pr = sc + r * P;
      float a = acc[idx] * a_r[r];
      for (int t = 0; t < P; ++t) a = fmaf(pr[t], v_t[t * D + d], a);
      acc[idx] = a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < R * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int s = r / G, g = r % G;
    const bool valid = m_r[r] > kNegInf * 0.5f;
    const float l = l_r[r] == 0.f ? 1.f : l_r[r];
    out[((static_cast<long long>(b) * S + s) * H + hk * G + g) * D + d] =
        from_f32<T>(valid ? acc[idx] / l : 0.f);
  }
}

template <typename T, typename KV, bool kQuant>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const void* table, const void* fills, void* out,
           int B, int S, int H, int Hkv, int D, int N, int P, int MP,
           float scale, size_t smem, cudaStream_t stream) {
  auto kernel = paged_kernel<T, KV, kQuant>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(B, Hkv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kp), static_cast<const KV*>(vp),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(table), static_cast<const int*>(fills),
      static_cast<T*>(out), S, H, Hkv, D, N, P, MP, scale);
  return 0;
}

}  // namespace

// Shared memory the kernel needs, in bytes (ops/paged_attention.py
// computes the same figure to refuse shapes before launching).
static long long smem_bytes(int S, int H, int Hkv, int D, int P) {
  const long long R = static_cast<long long>(S) * (H / Hkv);
  return 4LL * (P * (D + 1LL) + P * D + R * D + R * P + R * D + 3 * R);
}

extern "C" int port_paged_attention(
    const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
    const void* table, const void* fills, void* out, int B, int S, int H, int Hkv,
    int D, int N, int P, int MP, float scale, int qdtype, int kvdtype, int device, void* stream) {
  // this library links its own CUDA runtime: select the caller's
  // device in it before launching on the caller's stream
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  if (B <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || N <= 0 || P <= 0 || MP <= 0 || B > 2147483647 || Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = smem_bytes(S, H, Hkv, D, P);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  int rc;
  if (qdtype == kF32 && kvdtype == kF32) {
    rc = launch<float, float, false>(q, kp, vp, ks, vs, table, fills, out, B, S, H, Hkv, D, N, P, MP, scale, sm, s);
  } else if (qdtype == kBF16 && kvdtype == kBF16) {
    rc = launch<__nv_bfloat16, __nv_bfloat16, false>(q, kp, vp, ks, vs, table, fills, out, B, S, H, Hkv, D, N, P, MP, scale, sm, s);
  } else if (qdtype == kF32 && kvdtype == kI8) {
    rc = launch<float, int8_t, true>(q, kp, vp, ks, vs, table, fills, out, B, S, H, Hkv, D, N, P, MP, scale, sm, s);
  } else if (qdtype == kBF16 && kvdtype == kI8) {
    rc = launch<__nv_bfloat16, int8_t, true>(q, kp, vp, ks, vs, table, fills, out, B, S, H, Hkv, D, N, P, MP, scale, sm, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
