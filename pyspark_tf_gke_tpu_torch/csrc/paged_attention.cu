// K1: paged attention. For each slot b, S query tokens attend through
// the slot's block-table row over a global K/V page pool. Query i sits
// at absolute position fill[b] - S + i and sees keys at positions <=
// that; rows with no live key (fill - S + i < 0, or fill <= 0) are 0.
// GQA: each KV head serves G = H / Hkv query heads; a head group's R =
// S*G query rows are r = s*G + g. int8 pages are dequantized with f32
// per-(position, head) scale pages and rounded through the query dtype.
//
// Replaces pyspark_tf_gke_tpu/ops/pallas/paged_attention.py::_paged_kernel
// (:124), launched from _paged_pallas (:254). The TPU kernel walks a
// sequential (slot, page) grid carrying m/l/acc in VMEM; on Hopper
// blocks run in no order, so each variant below carries its online
// softmax inside a CTA (or a warp) and, where it splits a sequence,
// merges the pieces in a second pass in a fixed order.
//
// Bound on the H100: memory. A decode step reads every live K/V byte
// of every slot once and does 4 operations per (query row, key, head_dim
// element); at 8 slots x ~716 tokens x 12 KV heads that is 17.6 MB,
// 0.0053 ms at 3.35 TB/s. A 256-token chunked-prefill piece reads about
// as much and does ~1.7 GFLOP, still bound by bytes on the tensor cores.
//
// Three variants; ops/paged_attention.py paged_plan picks one and its
// launch shape from the shape and dtypes alone (never from the fills,
// so a decode step can be captured in a CUDA graph, and never from the
// card), and the entry point below checks what it is given:
//
// decode (dec::, split-KV, "flash-decoding"), for every decode step and
// the narrowest verify chunks (S <= 4 with a bf16 query, S <= 8 with an
// f32 one; 1-8 query rows a CTA), float or int8 pages,
// head_dim 64 or 128 (a template on D), pages of a multiple
// of 16 tokens. The
// grid is (slot, KV head, split x row block): a split walks a fixed
// range of `pages_per_split` table entries, only those before its slot's
// last live page and its rows' last key (a split past them writes an
// empty partial: m = NEG_INF, l = 0). A CTA holds `rows` (1-8) query
// rows of the group in shared memory (f32) and has four warps; each
// warp takes 16 of a page's keys (a key group) and runs its own online
// softmax over its key groups, so no barrier is needed between pages
// (at 16 rows a CTA ptxas spilled; 8 rows keep every instantiation
// under 128 registers).
// A warp brings its key groups' K and V rows (and scales) in 16-byte
// cp.async copies through its own ring of `stages` slots, kept in the
// pages' dtype (K's 16-byte chunks swizzled by row, so that the lanes
// reading a half row each do not collide on banks). A lane pair scores
// one key (each lane half of head_dim, then a shuffle); max and sum are
// shuffles over the warp's 16 keys; p is rounded to V's dtype before P
// V, as _paged_kernel rounds it (:184), and l sums the unrounded p
// (:189); in P V each lane owns D / 32 head_dim columns (pairs 64
// apart), p arriving by shuffle. At D 128 a ring slot is twice D 64's,
// so the plan's ring budget holds fewer stages. The four warps' states meet in shared memory in warp order.
// One split writes the output itself; more write their partial (m, l,
// acc) in f32 to scratch that the wrapper allocates, and paged_merge
// combines them in split order (no atomics: the result does not depend
// on scheduling) and writes zeros for rows with no live key, as the TPU
// kernel's finalise does (:193-200). Replayed from a CUDA graph on an
// H100, 8 slots x 716 tokens x 12 heads take 0.0103 ms (PERF.md).
//
// chunk (wgc::, tensor cores), for larger R with a bf16 query (bf16 or
// int8 pages, head_dim 64 or 128, 64-token pages): K2f's design
// (flash_attention.cu wg::) moved onto pages. A CTA holds 128 query rows
// of a head group on two warpgroups of 64; the rows of a group are not
// one stride (r = s*G + g), so they are gathered by 16-byte loads into
// the 128B-swizzled Q tile. K and V page tiles [64 tokens, D] of one KV
// head come from the table's page (sentinels clamped) as 16-byte loads
// into registers, one page ahead of the products, and are stored into a
// 2-slot ring of swizzled tiles; int8 pages are dequantized with their
// scales and rounded to bf16 on the way (a TMA copy could not convert
// them). S = Q K^T and P V are wgmma products from shared memory (V read
// MN-major through the transpose bit), each into a fresh accumulator
// that is added to the f32 sums (chained sums drifted further from f64
// in the other tensor-core kernels; PERF.md); the causal
// mask is applied per row at its absolute position fill - S + s; p is
// rounded to bf16 in registers where _paged_kernel rounds it; a
// warpgroup skips a page wholly past its rows; a CTA walks pages only up
// to its last row's key, and CTAs of later rows (more pages) start
// first. At D 128 every tile is two 64-column blocks laid out as K2f's
// D-128 tiles (a 256-byte row is two 128-byte swizzle rows): S = Q K^T
// takes 8 k16 steps over both blocks, P V one fresh n64 product a
// block, and the output accumulator is 64 x 128 f32 a warpgroup; Q is
// 32 KB and the two K/V stages 64 KB. Replayed from a CUDA graph on an
// H100, the 256-token piece at 8 slots x 12 heads takes 0.0375 ms
// (PERF.md).
//
// rows (the first design), for f32 queries with large R
// and shapes the others do not take (head_dim other than 64 and 128): one CTA per (slot, KV head, row
// block) of 128 threads, each page's K and V staged in shared memory as
// f32, scores and P V on the CUDA cores (p kept in f32), an online
// softmax a row on one warp. The R rows of a group split into blocks
// that fit shared memory (ops/paged_attention.py row_plan; this file
// checks the split), so any S launches; a CTA walks only the pages up
// to its last row's key.

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

using namespace port;

namespace {

constexpr long long kMaxSmem = 232448;  // bytes of shared memory a block may use

// -- rows: the first design (simt::) ---------------------------------------------

namespace simt {

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

}  // namespace simt

// -- decode: split-KV on the CUDA cores ------------------------------------------

namespace dec {

using namespace port::hopper;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 16;       // keys of a key group: one warp's share of a page
constexpr int kMaxStages = 4;
// head_dim D: 64 or 128 (ops/paged_attention.py DECODE_DS); a lane
// owns D / 32 columns of P V, in pairs 64 columns apart

// a partial row: acc[D], m, l (f32)
__host__ __device__ constexpr int part_stride(int d) { return d + 2; }

template <typename KV, int D>
__host__ __device__ constexpr int stage_bytes() {
  // a key group's K and V rows, and for int8 their 16 + 16 scales
  return 2 * kKeys * D * static_cast<int>(sizeof(KV)) +
         (std::is_same<KV, int8_t>::value ? 2 * kKeys * 4 : 0);
}

// Shared memory of a CTA holding `rows` query rows of head_dim `d` with
// a ring of `stages` slots a warp (ops/paged_attention.py decode_smem):
// the f32 query rows, then the rings, which the warps' final states
// reuse.
inline long long smem_bytes(int rows, int stages, int kv_size, int d) {
  const long long stage = 2LL * kKeys * d * kv_size + (kv_size == 1 ? 2 * kKeys * 4 : 0);
  const long long ring = kWarps * stages * stage;
  const long long merge = 4LL * kWarps * rows * part_stride(d);
  return 4LL * rows * d + (ring > merge ? ring : merge);
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// wait until at most n of this thread's cp.async groups are in flight
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// 16 bytes of a page row as f32: 8 bf16, 4 f32 or 16 int8
__device__ __forceinline__ void unpack(const uint4& u, float* f, const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float* f, const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f, const int8_t*) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(c[i]);
}

// two neighbouring head_dim elements of a V row in shared memory as f32
__device__ __forceinline__ float2 pair(const uint8_t* row, int lane, const __nv_bfloat16*) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + 4 * lane));
}
__device__ __forceinline__ float2 pair(const uint8_t* row, int lane, const float*) {
  return *reinterpret_cast<const float2*>(row + 8 * lane);
}
__device__ __forceinline__ float2 pair(const uint8_t* row, int lane, const int8_t*) {
  const char2 c = *reinterpret_cast<const char2*>(row + 2 * lane);
  return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
}

// The first token of key group `grp` of table entry j of slot b: the
// page it names, sentinels (>= N) clamped into the pool.
__device__ __forceinline__ long long group_token(const int* __restrict__ table, int b, int MP,
                                                 int N, int P, int j, int grp) {
  int page = table[static_cast<long long>(b) * MP + j];
  page = page < 0 ? 0 : (page >= N ? N - 1 : page);
  return static_cast<long long>(page) * P + grp * kKeys;
}

// One warp's cp.async copies of a key group (16 tokens from tok0) of KV
// head hk into its ring slot: K rows (16-byte chunks swizzled by row),
// V rows, and for int8 pages the 16 + 16 scales.
template <typename KV, int D>
__device__ __forceinline__ void load_group(uint8_t* kt, const KV* __restrict__ kp,
                                           const KV* __restrict__ vp,
                                           const float* __restrict__ ks,
                                           const float* __restrict__ vs, long long tok0, int Hkv,
                                           int hk, int lane) {
  constexpr int kRowBytes = D * static_cast<int>(sizeof(KV));
  constexpr int kCpr = kRowBytes / 16;
  constexpr int kSw = kCpr < 8 ? kCpr : 8;
  uint8_t* vt = kt + kKeys * kRowBytes;
#pragma unroll
  for (int c = lane; c < kKeys * kCpr; c += 32) {
    const int row = c / kCpr, ch = c % kCpr;
    const long long src = ((tok0 + row) * Hkv + hk) * kRowBytes + ch * 16;
    cp_async16(smem_u32(kt + row * kRowBytes + ((ch ^ (row % kSw)) << 4)),
               reinterpret_cast<const uint8_t*>(kp) + src, 16);
    cp_async16(smem_u32(vt + row * kRowBytes + (ch << 4)),
               reinterpret_cast<const uint8_t*>(vp) + src, 16);
  }
  if constexpr (std::is_same<KV, int8_t>::value) {  // K's scales for lanes 0-15, V's for 16-31
    float* sc = reinterpret_cast<float*>(vt + kKeys * kRowBytes);
    cp_async4(smem_u32(sc + lane), (lane < kKeys ? ks : vs) + (tok0 + lane % kKeys) * Hkv + hk);
  }
}

// An explicit target of four CTAs an SM (at most 128 registers, above
// what any D-64 instantiation needs): with the thread count alone ptxas
// chose 56-96 registers for some and spilled a few bytes. Three at D
// 128, whose bf16 8-row instantiation spilled 8 bytes under 128.
template <typename T, typename KV, int kRows, int kD>
__global__ void __launch_bounds__(kThreads, kD > 64 ? 3 : 4)
paged_decode(const T* __restrict__ q, const KV* __restrict__ kp, const KV* __restrict__ vp,
             const float* __restrict__ ks, const float* __restrict__ vs,
             const int* __restrict__ table, const int* __restrict__ fills, T* __restrict__ out,
             float* __restrict__ part, int S, int H, int Hkv, int N, int P, int MP, int pps,
             int splits, int stages, float scale) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int kRowBytes = kD * static_cast<int>(sizeof(KV));  // D 64: 128 bf16, 256 f32, 64 int8
  constexpr int kCpr = kRowBytes / 16;                           // 16-byte chunks a row
  constexpr int kSw = kCpr < 8 ? kCpr : 8;                       // K's swizzle period (rows)
  constexpr int kTileBytes = kKeys * kRowBytes;
  constexpr int kStage = stage_bytes<KV, kD>();
  constexpr int kPairs = kD / 64;           // a lane's column pairs of P V
  constexpr int kPartStride = part_stride(kD);
  constexpr int kPer = 16 / static_cast<int>(sizeof(KV));  // elements a chunk
  extern __shared__ __align__(16) uint8_t smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [kRows][kD]
  uint8_t* ring = smem + kRows * kD * 4;        // [warp][stage] K rows, V rows, scales

  const int b = blockIdx.x, hk = blockIdx.y;
  const int split = blockIdx.z % splits, rb = blockIdx.z / splits;
  const int G = H / Hkv, R = S * G, r0 = rb * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int fill = fills[b];

  for (int idx = tid; idx < kRows * kD; idx += kThreads) {
    const int r = r0 + idx / kD;
    float v = 0.f;
    if (r < R) {
      v = to_f32(q[((static_cast<long long>(b) * S + r / G) * H + hk * G + r % G) * kD +
                   idx % kD]);
    }
    q_s[idx] = v;
  }

  // the table entries this split walks: live pages only (capped at MP),
  // and none past the page of its last row's own key
  int live = fill > 0 ? (fill + P - 1) / P : 0;
  live = min(live, MP);
  const int last_key = fill - S + (min(r0 + kRows, R) - 1) / G;
  live = min(live, last_key >= 0 ? last_key / P + 1 : 0);
  const int j0 = split * pps;
  const int j1 = min(j0 + pps, live);
  const int groups = P / kKeys;
  // warp w takes key groups w, w + 4, ... of every page
  const int mine = warp < groups ? (groups - warp + kWarps - 1) / kWarps : 0;
  const int items = j1 > j0 ? (j1 - j0) * mine : 0;
  uint8_t* wring = ring + warp * stages * kStage;

  float m[kRows], l[kRows], acc[kRows][2 * kPairs];  // m, l: the same in every lane
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 2 * kPairs; ++c) acc[r][c] = 0.f;
  }
  __syncthreads();  // q_s
  for (int st = 0; st < stages; ++st) {
    if (st < items) {
      load_group<KV, kD>(wring + st * kStage, kp, vp, ks, vs,
                         group_token(table, b, MP, N, P, j0 + st / mine,
                                     warp + kWarps * (st % mine)),
                         Hkv, hk, lane);
    }
    cp_async_commit();  // one group a slot, empty or not: the count stays even
  }
  const int key = lane >> 1, half = lane & 1;
  for (int it = 0; it < items; ++it) {
    const int st = it % stages;
    cp_async_wait_n(stages - 1);
    __syncwarp();  // every lane's copies of this slot are visible
    const uint8_t* kt = wring + st * kStage;
    const uint8_t* vt = kt + kTileBytes;
    const float* sc = reinterpret_cast<const float*>(vt + kTileBytes);
    const int kpos = (j0 + it / mine) * P + (warp + kWarps * (it % mine)) * kKeys + key;

    // this lane's half of its key's row, a 16-byte chunk at a time,
    // against each query row (p holds the partial dot products)
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) p[r] = 0.f;
#pragma unroll
    for (int cc = 0; cc < kCpr / 2; ++cc) {
      const int ch = half * (kCpr / 2) + cc;
      float kc[kPer];
      unpack(*reinterpret_cast<const uint4*>(kt + key * kRowBytes + ((ch ^ (key % kSw)) << 4)),
             kc, static_cast<const KV*>(nullptr));
      if constexpr (kQuant) {
        const float s = sc[key];
#pragma unroll
        for (int e = 0; e < kPer; ++e) kc[e] = round_through<T>(kc[e] * s);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float* qr = q_s + r * kD + half * (kD / 2) + cc * kPer;
#pragma unroll
        for (int e = 0; e < kPer; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + e);
          p[r] = fmaf(qv.x, kc[e], p[r]);
          p[r] = fmaf(qv.y, kc[e + 1], p[r]);
          p[r] = fmaf(qv.z, kc[e + 2], p[r]);
          p[r] = fmaf(qv.w, kc[e + 3], p[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float dot = p[r] + __shfl_xor_sync(0xffffffffu, p[r], 1);
      const bool seen = r0 + r < R && kpos <= fill - S + (r0 + r) / G;
      p[r] = seen ? dot * scale : kNegInf;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float mx = p[r];  // the max over the warp's 16 keys (lane pairs agree)
#pragma unroll
      for (int o = 2; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      const float e = expf(p[r] - m_new);
      float sum = e;
#pragma unroll
      for (int o = 2; o < 32; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[r] = l[r] * alpha + sum;  // l sums the unrounded p
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 2 * kPairs; ++c) acc[r][c] *= alpha;
      p[r] = round_through<T>(e);  // p in V's dtype for P V
    }
    // a few keys at a time past 2 rows: the loads a full unroll hoists
    // made ptxas spill the f32-query instantiations over int8 pages
    constexpr int kUnroll = kRows > 2 ? 4 : kKeys;
#pragma unroll kUnroll
    for (int k = 0; k < kKeys; ++k) {
      float2 v[kPairs];
#pragma unroll
      for (int h = 0; h < kPairs; ++h) {
        v[h] = pair(vt + k * kRowBytes + h * 64 * static_cast<int>(sizeof(KV)), lane,
                    static_cast<const KV*>(nullptr));
        if constexpr (kQuant) {
          const float s = sc[kKeys + k];
          v[h].x = round_through<T>(v[h].x * s);
          v[h].y = round_through<T>(v[h].y * s);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pk = __shfl_sync(0xffffffffu, p[r], 2 * k);
#pragma unroll
        for (int h = 0; h < kPairs; ++h) {
          acc[r][2 * h] = fmaf(pk, v[h].x, acc[r][2 * h]);
          acc[r][2 * h + 1] = fmaf(pk, v[h].y, acc[r][2 * h + 1]);
        }
      }
    }
    __syncwarp();  // every lane is done with slot st
    const int next = it + stages;
    if (next < items) {
      load_group<KV, kD>(wring + st * kStage, kp, vp, ks, vs,
                         group_token(table, b, MP, N, P, j0 + next / mine,
                                     warp + kWarps * (next % mine)),
                         Hkv, hk, lane);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();  // the rings are free: the warps' states go there

  float* mw = reinterpret_cast<float*>(ring);  // [warp][row]
  float* lw = mw + kWarps * kRows;             // [warp][row]
  float* aw = lw + kWarps * kRows;             // [warp][row][kD]
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (lane == 0) {
      mw[warp * kRows + r] = m[r];
      lw[warp * kRows + r] = l[r];
    }
#pragma unroll
    for (int h = 0; h < kPairs; ++h) {
      *reinterpret_cast<float2*>(aw + (warp * kRows + r) * kD + 64 * h + 2 * lane) =
          make_float2(acc[r][2 * h], acc[r][2 * h + 1]);
    }
  }
  __syncthreads();
  const int rpad = (gridDim.z / splits) * kRows;
  for (int idx = tid; idx < kRows * kD; idx += kThreads) {
    const int r = idx / kD, d = idx % kD;
    if (r0 + r >= R) continue;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, mw[w * kRows + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {  // warp order; a warp that saw no key adds nothing
      const float mv = mw[w * kRows + r];
      if (mv > kNegInf * 0.5f) {
        const float f = expf(mv - M);
        L += lw[w * kRows + r] * f;
        A += aw[(w * kRows + r) * kD + d] * f;
      }
    }
    if (splits == 1) {
      const int row = r0 + r;
      const bool valid = M > kNegInf * 0.5f;
      out[((static_cast<long long>(b) * S + row / G) * H + hk * G + row % G) * kD + d] =
          from_f32<T>(valid ? A / (L == 0.f ? 1.f : L) : 0.f);
    } else {
      float* pr = part + ((static_cast<long long>(b) * Hkv + hk) * splits + split) * rpad *
                             kPartStride +
                  static_cast<long long>(r0 + r) * kPartStride;
      pr[d] = A;
      if (d == 0) {
        pr[kD] = M;
        pr[kD + 1] = L;
      }
    }
  }
}

// The splits' partials of each query row combined in split order: grid
// (row, KV head, slot), a thread a head_dim column.
template <typename T, int kD>
__global__ void __launch_bounds__(kD)
paged_merge(const float* __restrict__ part, T* __restrict__ out, int S, int H, int Hkv,
            int splits, int rpad) {
  constexpr int kPartStride = part_stride(kD);
  const int r = blockIdx.x, hk = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int G = H / Hkv;
  const long long split_stride = static_cast<long long>(rpad) * kPartStride;
  const float* base = part + (static_cast<long long>(b) * Hkv + hk) * splits * split_stride +
                      static_cast<long long>(r) * kPartStride;
  float M = kNegInf;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, base[s * split_stride + kD]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* ps = base + s * split_stride;
    const float mv = ps[kD];
    if (mv > kNegInf * 0.5f) {  // an empty split, or one past the row's keys, adds nothing
      const float f = expf(mv - M);
      L += ps[kD + 1] * f;
      A += ps[d] * f;
    }
  }
  const bool valid = M > kNegInf * 0.5f;
  out[((static_cast<long long>(b) * S + r / G) * H + hk * G + r % G) * kD + d] =
      from_f32<T>(valid ? A / (L == 0.f ? 1.f : L) : 0.f);
}

template <typename T, typename KV, int kRows, int kD>
int launch_rows(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
                const void* table, const void* fills, void* out, void* part, int B, int S, int H,
                int Hkv, int N, int P, int MP, int pps, int splits, int stages, int blocks,
                float scale, cudaStream_t stream) {
  auto kernel = paged_decode<T, KV, kRows, kD>;
  const long long smem = smem_bytes(kRows, stages, sizeof(KV), kD);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(B, Hkv, splits * blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kp), static_cast<const KV*>(vp),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(table), static_cast<const int*>(fills), static_cast<T*>(out),
      static_cast<float*>(part), S, H, Hkv, N, P, MP, pps, splits, stages, scale);
  if (splits > 1) {
    paged_merge<T, kD><<<dim3(S * (H / Hkv), Hkv, B), kD, 0, stream>>>(
        static_cast<const float*>(part), static_cast<T*>(out), S, H, Hkv, splits,
        blocks * kRows);
  }
  return 0;
}

template <typename T, typename KV, int kD>
int launch_d(int rows, const void* q, const void* kp, const void* vp, const void* ks,
             const void* vs, const void* table, const void* fills, void* out, void* part, int B,
             int S, int H, int Hkv, int N, int P, int MP, int pps, int splits, int stages,
             int blocks, float scale, cudaStream_t stream) {
#define PORT_DEC(R)                                                                            \
  case R:                                                                                      \
    return launch_rows<T, KV, R, kD>(q, kp, vp, ks, vs, table, fills, out, part, B, S, H, Hkv, \
                                     N, P, MP, pps, splits, stages, blocks, scale, stream);
  switch (rows) {
    PORT_DEC(1)
    PORT_DEC(2)
    PORT_DEC(4)
    PORT_DEC(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PORT_DEC
}

template <typename T, typename KV>
int launch(int D, int rows, const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const void* table, const void* fills, void* out, void* part, int B,
           int S, int H, int Hkv, int N, int P, int MP, int pps, int splits, int stages,
           int blocks, float scale, cudaStream_t stream) {
  if (D == 64) {
    return launch_d<T, KV, 64>(rows, q, kp, vp, ks, vs, table, fills, out, part, B, S, H, Hkv,
                               N, P, MP, pps, splits, stages, blocks, scale, stream);
  }
  return launch_d<T, KV, 128>(rows, q, kp, vp, ks, vs, table, fills, out, part, B, S, H, Hkv,
                              N, P, MP, pps, splits, stages, blocks, scale, stream);
}

}  // namespace dec

// -- chunk: the tensor-core design ------------------------------------------------

namespace wgc {

using namespace port::hopper;

constexpr int kThreads = 256;      // two warpgroups of 64 query rows
constexpr int kRows = 128;         // query rows a CTA
constexpr int kTok = 64;           // tokens a page: a K/V tile
constexpr int kRowBytes = 128;     // a swizzle-atom row: 64 bf16 of head_dim

// The shared-memory plan at head_dim D (64 or 128), as K2f's
// (flash_attention.cu wg::Layout): every tile is D/64 column blocks
// ([rows][64 bf16], 128B-swizzled), block a at a * rows * 128.
template <int D>
struct Layout {
  static constexpr int kAtoms = D / 64;
  static constexpr int kQBlock = kRows * kRowBytes;     // Q's column-block stride
  static constexpr int kKVBlock = kTok * kRowBytes;     // a K or V tile's
  static constexpr int kQBytes = kAtoms * kQBlock;
  static constexpr int kTileBytes = kAtoms * kKVBlock;
  static constexpr int kStageBytes = 2 * kTileBytes;    // K then V
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStageBytes;
};
static_assert(Layout<128>::kSmem <= 232448, "shared memory");

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// 16 int8 values times `s`, each rounded to bf16, as two 16-byte chunks
__device__ __forceinline__ void dequant16(const uint4& u, float s, uint4& lo, uint4& hi) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    w[i] = pack_bf16(static_cast<float>(c[2 * i]) * s, static_cast<float>(c[2 * i + 1]) * s);
  }
  lo = make_uint4(w[0], w[1], w[2], w[3]);
  hi = make_uint4(w[4], w[5], w[6], w[7]);
}

template <typename KV, int D>
__global__ void __launch_bounds__(kThreads)
paged_chunk_wgmma(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ kp,
                  const KV* __restrict__ vp, const float* __restrict__ ks,
                  const float* __restrict__ vs, const int* __restrict__ table,
                  const int* __restrict__ fills, __nv_bfloat16* __restrict__ out, int S, int H,
                  int Hkv, int N, int MP, float scale) {
  using L = Layout<D>;
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int kCpr = D / 8;  // 16-byte bf16 chunks a row
  // 16-byte loads a thread makes of a page's K (and of its V): a row is
  // D / 8 bf16 chunks, or D / 16 int8 ones
  constexpr int kLoads = kTok * (kQuant ? D / 16 : kCpr) / kThreads;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;
  uint8_t* kv_s = smem + L::kQBytes;

  const int t = threadIdx.x, wg = t >> 7, warp = (t >> 5) & 3, lane = t & 31;
  const int b = blockIdx.x, hk = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * kRows;  // later rows (more pages) first
  const int G = H / Hkv, R = S * G;
  const int fill = fills[b];

#pragma unroll
  for (int i = 0; i < kRows * kCpr / kThreads; ++i) {  // the group's rows, gathered
    const int c = t + kThreads * i;
    const int row = c / kCpr, ch = c % kCpr, r = r0 + row;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < R) v = ld16(q + ((static_cast<long long>(b) * S + r / G) * H + hk * G + r % G) * D + ch * 8);
    *reinterpret_cast<uint4*>(q_s + (ch >> 3) * L::kQBlock + sw128(row, ch & 7)) = v;
  }

  int live = fill > 0 ? (fill + kTok - 1) / kTok : 0;
  live = min(live, MP);
  const int last_key = fill - S + (min(r0 + kRows, R) - 1) / G;
  const int ntiles = min(live, last_key >= 0 ? last_key / kTok + 1 : 0);
  // the thread's two rows (the accumulator layout) and their last keys;
  // a row past R sees none
  const int row_a = r0 + 64 * wg + 16 * warp + (lane >> 2), row_b = row_a + 8;
  const int qa = row_a < R ? fill - S + row_a / G : -1;
  const int qb = row_b < R ? fill - S + row_b / G : -1;
  const int wg_first = r0 + 64 * wg;
  const int wg_key = wg_first < R ? fill - S + (min(wg_first + 63, R - 1)) / G : -1;

  uint4 kr[kLoads], vr[kLoads];
  float ksc[kLoads], vsc[kLoads];
  auto fetch = [&](int j) {  // page j's K and V of head hk into registers
    int page = table[static_cast<long long>(b) * MP + j];
    page = page < 0 ? 0 : (page >= N ? N - 1 : page);  // sentinel clamp
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int c = t + kThreads * i;
      const int tok = kQuant ? c / (D / 16) : c / kCpr;
      const int col = kQuant ? (c % (D / 16)) * 16 : (c % kCpr) * 8;
      const long long row = (static_cast<long long>(page) * kTok + tok) * Hkv + hk;
      kr[i] = ld16(kp + row * D + col);
      vr[i] = ld16(vp + row * D + col);
      if constexpr (kQuant) {
        ksc[i] = __ldg(ks + row);
        vsc[i] = __ldg(vs + row);
      }
    }
  };
  auto stash = [&](int st) {  // the registers into slot st, swizzled
    uint8_t* kt = kv_s + st * L::kStageBytes;
    uint8_t* vt = kt + L::kTileBytes;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int c = t + kThreads * i;
      if constexpr (kQuant) {
        const int tok = c / (D / 16), ch = 2 * (c % (D / 16));  // its first bf16 chunk
        const int off = (ch >> 3) * L::kKVBlock;
        uint4 lo, hi;
        dequant16(kr[i], ksc[i], lo, hi);
        *reinterpret_cast<uint4*>(kt + off + sw128(tok, ch & 7)) = lo;
        *reinterpret_cast<uint4*>(kt + off + sw128(tok, (ch & 7) + 1)) = hi;
        dequant16(vr[i], vsc[i], lo, hi);
        *reinterpret_cast<uint4*>(vt + off + sw128(tok, ch & 7)) = lo;
        *reinterpret_cast<uint4*>(vt + off + sw128(tok, (ch & 7) + 1)) = hi;
      } else {
        const int tok = c / kCpr, ch = c % kCpr;
        const int off = (ch >> 3) * L::kKVBlock + sw128(tok, ch & 7);
        *reinterpret_cast<uint4*>(kt + off) = kr[i];
        *reinterpret_cast<uint4*>(vt + off) = vr[i];
      }
    }
  };

  float o[D / 2];  // the accumulator layout of an n = D product
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;  // l: this thread's columns
  const uint32_t q_addr = smem_u32(q_s) + wg * 64 * kRowBytes;
  if (ntiles > 0) fetch(0);
  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    stash(st);
    fence_proxy_async();  // the stores (and Q's) before the products read them
    __syncthreads();      // slot st is written; slot st ^ 1 was read last tile
    if (it + 1 < ntiles) fetch(it + 1);
    const int k0 = it * kTok;
    if (k0 > wg_key) continue;  // a page wholly past the warpgroup's rows
    const uint32_t k_addr = smem_u32(kv_s + st * L::kStageBytes);
    const uint32_t v_addr = k_addr + L::kTileBytes;
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {  // 4 k16 steps in each column block
      wgmma_m64n64k16_ss<0>(s, desc_kmajor(q_addr + (kk >> 2) * L::kQBlock + (kk & 3) * 32),
                            desc_kmajor(k_addr + (kk >> 2) * L::kKVBlock + (kk & 3) * 32), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(s);

    // scale, then the causal mask per row at its absolute position
    const int kq = k0 + 2 * (lane & 3);  // the thread's first key in each 8
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= scale;
    if (k0 + kTok - 1 > qa || k0 + kTok - 1 > qb) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kq + j * 8 + (e & 1) > (e < 2 ? qa : qb)) s[j * 4 + e] = kNegInf;
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
    const float alpha_a = expf(m_a - mx_a), alpha_b = expf(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    uint32_t p[4][4];  // bf16 p as the A fragments of the four k16 steps
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float pa0 = expf(s[j * 4 + 0] - m_a);
      const float pa1 = expf(s[j * 4 + 1] - m_a);
      const float pb0 = expf(s[j * 4 + 2] - m_b);
      const float pb1 = expf(s[j * 4 + 3] - m_b);
      sum_a += pa0 + pa1;  // l sums the unrounded p
      sum_b += pb0 + pb1;
      p[j / 2][(j % 2) * 2 + 0] = pack_bf16(pa0, pa1);
      p[j / 2][(j % 2) * 2 + 1] = pack_bf16(pb0, pb1);
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
    // P V, a column block at a time, into a fresh accumulator (s is
    // dead), then added in f32
#pragma unroll
    for (int a = 0; a < L::kAtoms; ++a) {
      const uint32_t va = v_addr + a * L::kKVBlock;
      wgmma_fence();
      wgmma_m64n64k16_rs_first<1>(s, p[0], desc_mnmajor(va));
#pragma unroll
      for (int kk = 1; kk < 4; ++kk)
        wgmma_m64n64k16_rs<1>(s, p[kk], desc_mnmajor(va + kk * 16 * kRowBytes), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(s);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int oj = 32 * a + 4 * j;  // column 64 a + 8 j + ... of the n = D layout
        o[oj + 0] = o[oj + 0] * alpha_a + s[j * 4 + 0];
        o[oj + 1] = o[oj + 1] * alpha_a + s[j * 4 + 1];
        o[oj + 2] = o[oj + 2] * alpha_b + s[j * 4 + 2];
        o[oj + 3] = o[oj + 3] * alpha_b + s[j * 4 + 3];
      }
    }
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? row_a : row_b;
    if (row >= R) continue;
    const float mm = r == 0 ? m_a : m_b;
    const float l = r == 0 ? l_a : l_b;
    const bool valid = mm > kNegInf * 0.5f;  // at least one live key
    const float denom = (l == 0.f) ? 1.f : l;
    __nv_bfloat16* orow =
        out + ((static_cast<long long>(b) * S + row / G) * H + hk * G + row % G) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float v0 = valid ? o[j * 4 + 2 * r] / denom : 0.f;
      const float v1 = valid ? o[j * 4 + 2 * r + 1] / denom : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * (lane & 3)) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

template <typename KV, int D>
int launch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
           const void* table, const void* fills, void* out, int B, int S, int H, int Hkv, int N,
           int MP, int blocks, float scale, cudaStream_t stream) {
  auto kernel = paged_chunk_wgmma<KV, D>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<D>::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(B, Hkv, blocks), kThreads, Layout<D>::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(kp),
      static_cast<const KV*>(vp), static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(table), static_cast<const int*>(fills),
      static_cast<__nv_bfloat16*>(out), S, H, Hkv, N, MP, scale);
  return 0;
}

template <typename KV>
int launch(int D, const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
           const void* table, const void* fills, void* out, int B, int S, int H, int Hkv, int N,
           int MP, int blocks, float scale, cudaStream_t stream) {
  return D == 64 ? launch<KV, 64>(q, kp, vp, ks, vs, table, fills, out, B, S, H, Hkv, N, MP,
                                  blocks, scale, stream)
                 : launch<KV, 128>(q, kp, vp, ks, vs, table, fills, out, B, S, H, Hkv, N, MP,
                                   blocks, scale, stream);
}

}  // namespace wgc

}  // namespace

// The plan's variants (ops/paged_attention.py VARIANTS)
enum Variant : int { kRowsVariant = 0, kDecode = 1, kChunk = 2 };

// Shared memory a first-design CTA of `rows` query rows needs, in bytes
// (the figure ops/paged_attention.py row_plan fits to kMaxSmem).
static long long smem_bytes(long long rows, int D, int P) {
  return 4LL * (P * (D + 1LL) + P * D + rows * D + rows * P + rows * D + 3 * rows);
}

// The plan (ops/paged_attention.py paged_plan): variant, rows a CTA,
// splits and pages_per_split (decode: splits = ceil(MP /
// pages_per_split); otherwise 1 and MP), stages (decode: cp.async slots
// a warp; chunk 2; rows 1). part: f32 scratch [B, Hkv, splits, row
// blocks x rows, 66] when splits > 1. Each variant takes only the
// shapes and dtypes it was built for; anything else returns
// cudaErrorInvalidValue.
extern "C" int port_paged_attention(
    const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
    const void* table, const void* fills, void* out, void* part, int B, int S, int H, int Hkv,
    int D, int N, int P, int MP, int variant, int rows, int splits, int pages_per_split,
    int stages, float scale, int qdtype, int kvdtype, int device, void* stream) {
  // this library links its own CUDA runtime: select the caller's
  // device in it before launching on the caller's stream
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  if (B <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || N <= 0 || P <= 0 || MP <= 0 || B > 65535 || Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long R = static_cast<long long>(S) * (H / Hkv);
  if (rows <= 0 || R > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (R + rows - 1) / rows;
  const bool quant = kvdtype == kI8;
  if (!(qdtype == kF32 || qdtype == kBF16) || !(kvdtype == qdtype || quant))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  if (variant == kDecode) {
    const int kv_size = quant ? 1 : (kvdtype == kF32 ? 4 : 2);
    const bool ok = (D == 64 || D == 128) && P % dec::kKeys == 0 && pages_per_split > 0 &&
                    splits == (MP + pages_per_split - 1) / pages_per_split &&
                    splits * blocks <= 65535 && stages >= 1 && stages <= dec::kMaxStages &&
                    (rows == 1 || rows == 2 || rows == 4 || rows == 8) &&
                    dec::smem_bytes(rows, stages, kv_size, D) <= kMaxSmem &&
                    (splits == 1 || part != nullptr);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    const int nb = static_cast<int>(blocks);
    if (qdtype == kF32 && kvdtype == kF32) {
      rc = dec::launch<float, float>(D, rows, q, kp, vp, ks, vs, table, fills, out, part, B, S, H, Hkv, N, P, MP, pages_per_split, splits, stages, nb, scale, s);
    } else if (qdtype == kBF16 && kvdtype == kBF16) {
      rc = dec::launch<__nv_bfloat16, __nv_bfloat16>(D, rows, q, kp, vp, ks, vs, table, fills, out, part, B, S, H, Hkv, N, P, MP, pages_per_split, splits, stages, nb, scale, s);
    } else if (qdtype == kF32) {
      rc = dec::launch<float, int8_t>(D, rows, q, kp, vp, ks, vs, table, fills, out, part, B, S, H, Hkv, N, P, MP, pages_per_split, splits, stages, nb, scale, s);
    } else {
      rc = dec::launch<__nv_bfloat16, int8_t>(D, rows, q, kp, vp, ks, vs, table, fills, out, part, B, S, H, Hkv, N, P, MP, pages_per_split, splits, stages, nb, scale, s);
    }
  } else if (variant == kChunk) {
    const bool ok = qdtype == kBF16 && (D == 64 || D == 128) && P == wgc::kTok && rows == wgc::kRows &&
                    splits == 1 && pages_per_split == MP && stages == 2 && blocks <= 65535;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    const int nb = static_cast<int>(blocks);
    rc = quant ? wgc::launch<int8_t>(D, q, kp, vp, ks, vs, table, fills, out, B, S, H, Hkv, N, MP, nb, scale, s)
               : wgc::launch<__nv_bfloat16>(D, q, kp, vp, ks, vs, table, fills, out, B, S, H, Hkv, N, MP, nb, scale, s);
  } else if (variant == kRowsVariant) {
    const long long smem = smem_bytes(rows, D, P);
    if (rows > R || blocks > 65535 || smem > kMaxSmem || splits != 1 ||
        pages_per_split != MP || stages != 1)
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t sm = static_cast<size_t>(smem);
    const int nb = static_cast<int>(blocks);
    if (qdtype == kF32 && kvdtype == kF32) {
      rc = simt::launch<float, float, false>(q, kp, vp, ks, vs, table, fills, out, B, S, H, Hkv, D, N, P, MP, scale, rows, nb, sm, s);
    } else if (qdtype == kBF16 && kvdtype == kBF16) {
      rc = simt::launch<__nv_bfloat16, __nv_bfloat16, false>(q, kp, vp, ks, vs, table, fills, out, B, S, H, Hkv, D, N, P, MP, scale, rows, nb, sm, s);
    } else if (qdtype == kF32) {
      rc = simt::launch<float, int8_t, true>(q, kp, vp, ks, vs, table, fills, out, B, S, H, Hkv, D, N, P, MP, scale, rows, nb, sm, s);
    } else {
      rc = simt::launch<__nv_bfloat16, int8_t, true>(q, kp, vp, ks, vs, table, fills, out, B, S, H, Hkv, D, N, P, MP, scale, rows, nb, sm, s);
    }
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
