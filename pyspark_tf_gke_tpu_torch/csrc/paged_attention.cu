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
// the query rows of the head group live in shared memory, so each KV
// head is read once for a whole block of its query group. Scores, the
// online softmax (one warp per row, f32) and the P.V update run out of
// shared memory. Pages are loaded one at a time with a barrier between
// (no cp.async/TMA double buffering yet); splitting a long sequence
// across CTAs (flash-decoding) is later work.
//
// Row blocks. The R = S*G query rows of a head group need 4*(P(D+1) +
// PD + R(2D + P + 3)) bytes of shared memory; the TPU kernel keeps its
// (S*H, D) scratch in VMEM and takes any S. So the grid is (slot, KV
// head, row block): a CTA holds `rows` consecutive query rows (r = s*G +
// g), all R of them whenever they fit (every decode step and verify
// chunk: one block, as before), else the R rows split into equal blocks
// that fit (ops/paged_attention.py row_plan computes the split; this file
// only checks it). Rows are independent (one online softmax each), and a
// CTA walks only the pages up to the key position of its last row: the
// pages after it are masked for every row of the block, so skipping them
// changes no result, and a block of rows wholly before the slot's first
// key walks none and writes zeros.

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
             int S, int H, int Hkv, int D, int N, int P, int MP, float scale, int rows) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int hk = blockIdx.y;
  const int G = H / Hkv;
  // this CTA's query rows of the group: r0 + r, r < R, with r0 + r =
  // s * G + g (query s, head hk * G + g)
  const int r0 = blockIdx.z * rows;
  const int R = min(rows, S * G - r0);
  float* k_t = smem;                 // [P][D + 1] (padded: conflict-free)
  float* v_t = k_t + P * (D + 1);    // [P][D]
  float* q_s = v_t + P * D;          // [rows][D]
  float* sc = q_s + rows * D;        // [rows][P] scores, then probabilities
  float* acc = sc + rows * P;        // [rows][D]
  float* m_r = acc + rows * D;       // [rows] running max
  float* l_r = m_r + rows;           // [rows] running normaliser
  float* a_r = l_r + rows;           // [rows] this page's rescale factor
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int fill = fills[b];

  for (int idx = tid; idx < R * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int s = (r0 + r) / G, g = (r0 + r) % G;
    q_s[idx] = to_f32(q[((static_cast<long long>(b) * S + s) * H + hk * G + g) * D + d]);
    acc[idx] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_r[r] = kNegInf;
    l_r[r] = 0.f;
  }

  int live_pages = fill > 0 ? (fill + P - 1) / P : 0;
  if (live_pages > MP) live_pages = MP;
  // no page past the one holding the last row's own key position
  const int last_key = fill - S + (r0 + R - 1) / G;
  const int block_pages = last_key >= 0 ? last_key / P + 1 : 0;
  if (live_pages > block_pages) live_pages = block_pages;
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
      const int q_abs = fill - S + (r0 + r) / G;
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
    const int s = (r0 + r) / G, g = (r0 + r) % G;
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
           float scale, int rows, int blocks, size_t smem, cudaStream_t stream) {
  auto kernel = paged_kernel<T, KV, kQuant>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(B, Hkv, blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kp), static_cast<const KV*>(vp),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(table), static_cast<const int*>(fills),
      static_cast<T*>(out), S, H, Hkv, D, N, P, MP, scale, rows);
  return 0;
}

}  // namespace

constexpr long long kMaxSmem = 232448;  // bytes of shared memory a block may use

// Shared memory a CTA of `rows` query rows needs, in bytes (the figure
// ops/paged_attention.py row_plan fits to kMaxSmem).
static long long smem_bytes(long long rows, int D, int P) {
  return 4LL * (P * (D + 1LL) + P * D + rows * D + rows * P + rows * D + 3 * rows);
}

// rows: query rows a CTA holds (ops/paged_attention.py row_plan), every
// CTA but the last of a head group holding exactly that many.
extern "C" int port_paged_attention(
    const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
    const void* table, const void* fills, void* out, int B, int S, int H, int Hkv,
    int D, int N, int P, int MP, int rows, float scale, int qdtype, int kvdtype, int device,
    void* stream) {
  // this library links its own CUDA runtime: select the caller's
  // device in it before launching on the caller's stream
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  if (B <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || N <= 0 || P <= 0 || MP <= 0 || B > 2147483647 || Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long R = static_cast<long long>(S) * (H / Hkv);
  const long long blocks = rows > 0 ? (R + rows - 1) / rows : 0;
  const long long smem = smem_bytes(rows, D, P);
  if (rows <= 0 || rows > R || blocks > 65535 || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  const int nb = static_cast<int>(blocks);
  int rc;
  if (qdtype == kF32 && kvdtype == kF32) {
    rc = launch<float, float, false>(q, kp, vp, ks, vs, table, fills, out, B, S, H, Hkv, D, N, P, MP, scale, rows, nb, sm, s);
  } else if (qdtype == kBF16 && kvdtype == kBF16) {
    rc = launch<__nv_bfloat16, __nv_bfloat16, false>(q, kp, vp, ks, vs, table, fills, out, B, S, H, Hkv, D, N, P, MP, scale, rows, nb, sm, s);
  } else if (qdtype == kF32 && kvdtype == kI8) {
    rc = launch<float, int8_t, true>(q, kp, vp, ks, vs, table, fills, out, B, S, H, Hkv, D, N, P, MP, scale, rows, nb, sm, s);
  } else if (qdtype == kBF16 && kvdtype == kI8) {
    rc = launch<__nv_bfloat16, int8_t, true>(q, kp, vp, ks, vs, table, fills, out, B, S, H, Hkv, D, N, P, MP, scale, rows, nb, sm, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
