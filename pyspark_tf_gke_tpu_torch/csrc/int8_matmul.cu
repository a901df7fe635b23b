// K6: the int8-weight matmul, y = x @ W with W[k, n] = T(f32(q[k, n]) *
// scale[n]): x [M, K] in T (bf16 or f32), q [K, N] int8 in the flax
// kernel's layout (N contiguous), one f32 scale a column, y [M, N] in T.
// Each weight is dequantized and rounded to T before its product, the
// products are summed in f32 and y is rounded once to T: the rounding
// points of the JAX QTensor.dequantize followed by nn.Dense(dtype=T).
// One call may take up to three weights that share x (a layer's query,
// key and value; SwiGLU's gate and input), each with its own scales and
// output, in one launch.
//
// Replaces no TPU kernel. The JAX package keeps int8 weights at rest and
// dequantizes them inside its decode loops (pyspark_tf_gke_tpu/ops/
// quant.py:136 inloop_dequantize), where XLA fuses the convert and the
// scale into the matmul's weight operand, so that every step streams
// int8 from device memory. This kernel is that fusion on Hopper: done
// with tensor ops, the dequantization would write and read back a T copy
// of every weight at every step (5 bytes of traffic an element instead
// of 1).
//
// Bound on the H100: memory. At decode (M = 1-40 rows) a weight byte
// takes 2 M operations, far below the ~290 operations a byte at which
// the tensor cores would take over. GPT-small's 12 layers and lm_head
// stream 110 MB of int8 a step, 0.033 ms at 3.35 TB/s. At that size a
// call is latency more than bytes (a 768x768 weight is 590 KB, a few
// microseconds of the card's bandwidth), so the design aims at one
// launch a call, every CTA's weight bytes in flight at once, and no
// second pass.
//
// The design (hop::): a CTA of four warps owns 64 columns of one
// weight, up to 32 rows of x (rows, 8, 16 or 32) and a range of K (a
// split). Its weight tile streams through an 8-slot ring of 64 K rows
// (4 KB a slot) by 16-byte cp.async copies, all slots in flight before
// the first product; its rows of x over a window of its K range sit in
// shared memory as T, loaded while the first slots are in flight.
//  - bf16: mma.sync m16n8k16 on the tensor cores with the weights as A
//    and x as B (y^T = W^T x^T): a weight tile fills the 16-row side and
//    up to 8 decode rows the 8-column side. Each warp takes one k16 step
//    of a slot. The flax layout gives no 8-bit ldmatrix, and none is
//    needed: the order of k inside a k16 step and of the 16 A rows is
//    free as long as A and B agree, so lane (g, t) reads 8 bytes (8
//    neighbouring columns) of 4 K rows t, t+4, t+8, t+12, conflict-free,
//    dequantizes them in registers (f32(q) * scale rounded to bf16, the
//    JAX rounding point: the bf16 products are exact in f32, so only the
//    order of the sums changes; int8 to f32 by a byte permute and an
//    exact subtraction, as the quarter-rate I2F bounded lm_head) and
//    packs 4 m16 tiles' A fragments; x is
//    stored permuted to the same k order, so B is one 8-byte read a
//    tile of 8 rows. The accumulators are 16 f32 a tile of 8 rows.
//  - f32: on the CUDA cores (TF32 would lose the f32 parity): a thread
//    owns one column and half of each slot's K rows, the weight in f32
//    exactly as the plain version has it.
//  - The warps' (f32: the halves') sums meet in shared memory in warp
//    order. Where K is split (few column tiles: N = 768 gives 12), the
//    splits of a column tile are one thread-block cluster along K (at
//    most 8): each CTA leaves its f32 partial tile in its shared memory,
//    and after a cluster barrier CTA r sums every r-th element of the
//    tile over the cluster's partials in rank order through distributed
//    shared memory and writes y. No second kernel, no atomics, nothing
//    in device memory but x, the weights and y: the result does not
//    depend on scheduling, and a CUDA graph captures the one launch.
//  - Launched with programmatic dependent launch: the weight copies and
//    scales are issued before griddepcontrol.wait, x after it, so a
//    call's trip to memory overlaps the end of the kernel before it.
// The plan comes from ops/int8_matmul.py int8_plan, from the shape
// alone, and the entry point recomputes it (plan_for). Nothing is
// allocated here
// and nothing synchronises.

#include <atomic>
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

using namespace port;

namespace {

int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }
bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }
constexpr int kMaxGridYZ = 65535;

// -- the Hopper design ------------------------------------------------------------

namespace hop {

using namespace port::hopper;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 64;                       // columns a CTA
constexpr int kStageK = 64;                      // K rows a ring slot: a k16 step a warp
constexpr int kStages = 8;                       // ring slots
constexpr int kSlotBytes = kStageK * kTileN;     // 4 KB
constexpr int kKAlign = 16;                      // a split's K rows: a multiple of k16
constexpr int kMaxCluster = 8;                   // the portable cluster size
constexpr int kTargetCtas = 132;                 // split K until about one CTA an SM
constexpr int kXBytes = 48 * 1024;               // x's window in shared memory
constexpr int kXPad = 16;                        // elements past a row of x (32 bytes in bf16)
constexpr int kMaxGroups = 3;

// the weights of one call: each its int8 q [K, n], f32 scales and y [M, n]
struct Groups {
  const int8_t* q[kMaxGroups];
  const float* scale[kMaxGroups];
  void* y[kMaxGroups];
  int n[kMaxGroups];
  int tiles[kMaxGroups];  // column tiles of each weight
  int groups;
};

struct Plan {
  int rows, splits, kps, xw, vec;
  long long smem;
};

// ops/int8_matmul.py int8_plan: rows of x a CTA, the
// K split (a cluster), x's window and the load width, from the shape
Plan plan_for(int m, int k, const int* ns, int groups, int size) {
  Plan p;
  p.rows = m <= 8 ? 8 : m <= 16 ? 16 : 32;
  long long tiles = 0;
  bool vec = true;
  for (int g = 0; g < groups; ++g) {
    tiles += cdiv(ns[g], kTileN);
    vec = vec && ns[g] % 16 == 0;
  }
  const long long base = tiles * cdiv(m, p.rows);
  long long want = (kTargetCtas + base - 1) / base;
  if (want > kMaxCluster) want = kMaxCluster;
  if (want > k / kStageK) want = k / kStageK;
  if (want < 1) want = 1;
  p.kps = cdiv(cdiv(k, want), kKAlign) * kKAlign;
  p.splits = cdiv(k, p.kps);
  const int xw_cap = (kXBytes / (p.rows * size) - kXPad) / kStageK * kStageK;
  p.xw = cdiv(p.kps, kStageK) * kStageK;
  if (p.xw > xw_cap) p.xw = xw_cap;
  p.vec = vec ? 16 : 1;
  const long long ring = kStages * kSlotBytes;
  const long long sums = (kWarps + 1) * 4LL * p.rows * kTileN;  // the warps' sums, the partial
  p.smem = 1LL * p.rows * (p.xw + kXPad) * size + (ring > sums ? ring : sums);
  return p;
}

template <typename P>
__device__ __forceinline__ P pick(const P (&a)[kMaxGroups], int g) {
  return g == 0 ? a[0] : g == 1 ? a[1] : a[2];  // no dynamic index: no local memory
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the f32 at `p` in the shared memory of the cluster's CTA `rank`
__device__ __forceinline__ float ld_cluster(const float* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 operands, f32 accumulators
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x's position inside a k16 step as the bf16 design stores it: K row
// t + 4 j (t < 4) at 4 t + j, so that lane t's four rows are one 8-byte
// read in the order of its A fragment
__device__ __forceinline__ int xperm(int p) {
  const int kk = p & 15;
  return (p & ~15) + 4 * (kk & 3) + (kk >> 2);
}

// element i of 16 bytes of x
template <typename T> __device__ __forceinline__ T elem(const uint4& v, int i);
template <> __device__ __forceinline__ float elem<float>(const uint4& v, int i) {
  return __uint_as_float(i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w);
}
template <> __device__ __forceinline__ __nv_bfloat16 elem<__nv_bfloat16>(const uint4& v, int i) {
  const uint32_t w = (i >> 1) == 0 ? v.x : (i >> 1) == 1 ? v.y : (i >> 1) == 2 ? v.z : v.w;
  __nv_bfloat16_raw raw;
  raw.x = static_cast<unsigned short>(w >> (16 * (i & 1)));
  return __nv_bfloat16(raw);
}

// int8 byte `byte` of a word whose bytes were flipped (word ^
// 0x80808080: b + 128) as an exact f32, without the conversion unit (a
// quarter-rate I2F an element was lm_head's limit): 2^23 + (b + 128)
// built by a byte permute, then 2^23 + 128 taken away
__device__ __forceinline__ float i8(uint32_t flipped, int byte) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7650 + byte)) - 8388736.f;
}

// Grid (splits, column tiles of every weight, row blocks), a cluster of
// `splits` CTAs along x.
// Four CTAs an SM (at most 128 registers a thread); two at 32 rows of
// x, whose 64 accumulators a thread would spill under 128.
template <typename T, int kRows, bool kVec>
__global__ void __launch_bounds__(kThreads, kRows > 16 ? 2 : 4)
int8_mm_hopper(const T* __restrict__ x, const Groups gr, int m, int k, int kps, int xw) {
  constexpr bool kBF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kNT = kRows / 8;                 // tiles of 8 rows of x
  constexpr int kParts = kBF16 ? kWarps : 2;     // the sums that meet in shared memory
  constexpr int kE = 16 / static_cast<int>(sizeof(T));  // elements of x a 16-byte load
  extern __shared__ __align__(16) uint8_t smem[];
  const int xstride = xw + kXPad;
  T* x_s = reinterpret_cast<T*>(smem);           // [kRows][xstride]
  uint8_t* ring = smem + static_cast<long long>(kRows) * xstride * sizeof(T);
  float* red = reinterpret_cast<float*>(ring);   // after the ring: [kParts][kRows][kTileN]
  float* part = red + kWarps * kRows * kTileN;   // the CTA's partial [kRows][kTileN]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x, splits = gridDim.x;
  int tile = blockIdx.y, grp = 0;
  while (grp + 1 < gr.groups && tile >= pick(gr.tiles, grp)) tile -= pick(gr.tiles, grp++);
  const int8_t* __restrict__ q = pick(gr.q, grp);
  const float* __restrict__ scale = pick(gr.scale, grp);
  T* __restrict__ y = static_cast<T*>(pick(gr.y, grp));
  const int n = pick(gr.n, grp);
  const int n0 = tile * kTileN, m0 = blockIdx.z * kRows;
  const int k0 = split * kps, klen = min(k - k0, kps);
  const int stages = (klen + kStageK - 1) / kStageK;

  // slot s % kStages <- K rows [s * 64, s * 64 + 64) of the CTA's range;
  // zeros past it and past N
  auto load_stage = [&](int s) {
    uint8_t* slot = ring + (s % kStages) * kSlotBytes;
#pragma unroll
    for (int i = 0; i < kSlotBytes / 16 / kThreads; ++i) {
      const int c = tid + kThreads * i, row = c >> 2, col = n0 + (c & 3) * 16;
      const int kr = s * kStageK + row;
      const int8_t* src = q + static_cast<long long>(k0 + kr) * n + col;
      uint8_t* dst = slot + row * kTileN + (c & 3) * 16;
      if constexpr (kVec) {
        const bool ok = kr < klen && col < n;
        cp_async16(smem_u32(dst), ok ? src : q, ok ? 16 : 0);
      } else {  // N not a multiple of 16: byte loads, masked
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (kr < klen) {
#pragma unroll
          for (int b = 0; b < 16; ++b) {
            if (col + b < n) w[b >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(src[b])) << (8 * (b & 3));
          }
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  };

  // x's rows m0.. over the window of relative K rows [w0, w0 + xw), as T
  // (bf16 permuted by xperm); zeros past M and past the CTA's range
  const bool xvec = k % kE == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  auto load_x = [&](int w0) {
    const int len = min(xw, klen - w0);
    if (xvec) {
      const int cpr = xw / kE;  // 16-byte chunks a row
      for (int c0 = 0; c0 < kRows * cpr; c0 += 8 * kThreads) {
        uint4 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {  // eight loads in flight, then the stores
          const int c = c0 + u * kThreads + tid, r = c / cpr, e = (c % cpr) * kE;
          v[u] = make_uint4(0u, 0u, 0u, 0u);
          if (c < kRows * cpr && m0 + r < m && e < len) {
            v[u] = __ldg(reinterpret_cast<const uint4*>(x + static_cast<long long>(m0 + r) * k + k0 + w0 + e));
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int c = c0 + u * kThreads + tid, r = c / cpr, e = (c % cpr) * kE;
          if (c >= kRows * cpr) continue;
#pragma unroll
          for (int i = 0; i < kE; ++i) x_s[r * xstride + (kBF16 ? xperm(e + i) : e + i)] = elem<T>(v[u], i);
        }
      }
    } else {
#pragma unroll 4
      for (int idx = tid; idx < kRows * xw; idx += kThreads) {
        const int r = idx / xw, p = idx - r * xw;
        T v = from_f32<T>(0.f);
        if (m0 + r < m && p < len) v = x[static_cast<long long>(m0 + r) * k + k0 + w0 + p];
        x_s[r * xstride + (kBF16 ? xperm(p) : p)] = v;
      }
    }
  };

  for (int s = 0; s < kStages - 1; ++s) {  // every slot in flight before the first product
    if (s < stages) load_stage(s);
    cp_async_commit();
  }
  // the columns' scales: bf16, lane g's 8 columns; f32, the thread's one
  float sc[kBF16 ? 8 : 1];
#pragma unroll
  for (int c = 0; c < (kBF16 ? 8 : 1); ++c) {
    const int col = n0 + (kBF16 ? 8 * g + c : (tid & (kTileN - 1)));
    sc[c] = col < n ? __ldg(scale + col) : 0.f;
  }
  // x is the kernel before's output: wait for it (weights and scales
  // are never written, so their copies may start first)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  load_x(0);

  float acc[kBF16 ? kNT : 1][kBF16 ? 4 : 1][4];   // bf16: [row tile][m16 tile][fragment]
  float facc[kBF16 ? 1 : kRows];                  // f32: a row each
#pragma unroll
  for (int a = 0; a < (kBF16 ? kNT : 1); ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;
    }
  }
#pragma unroll
  for (int r = 0; r < (kBF16 ? 1 : kRows); ++r) facc[r] = 0.f;

  for (int s = 0; s < stages; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slot s landed; every warp is done with slot s - 1 (and x's window)
    const int kr0 = s * kStageK, w0 = kr0 / xw * xw;
    if (s > 0 && kr0 == w0) {  // the next window of x
      load_x(w0);
      __syncthreads();
    }
    if (s + kStages - 1 < stages) load_stage(s + kStages - 1);
    cp_async_commit();
    const uint8_t* slot = ring + (s % kStages) * kSlotBytes;
    if constexpr (kBF16) {
      if (kr0 + 16 * warp < klen) {  // this warp's k16 step
        const uint8_t* wrow = slot + (16 * warp + t) * kTileN + 8 * g;
        uint2 w8[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          w8[j] = *reinterpret_cast<const uint2*>(wrow + 4 * j * kTileN);
          w8[j].x ^= 0x80808080u;
          w8[j].y ^= 0x80808080u;
        }
        uint2 xb[kNT];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          xb[nt] = *reinterpret_cast<const uint2*>(x_s + (8 * nt + g) * xstride + (kr0 - w0) +
                                                   16 * warp + 4 * t);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // m16 tile i: columns 8 g + 2 i (rows g) and + 1 (rows g + 8)
          float wv[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c = 2 * i + h;
              wv[j][h] = i8(c < 4 ? w8[j].x : w8[j].y, c & 3) * sc[c];
            }
          }
          const uint32_t a[4] = {pack_bf16(wv[0][0], wv[1][0]), pack_bf16(wv[0][1], wv[1][1]),
                                 pack_bf16(wv[2][0], wv[3][0]), pack_bf16(wv[2][1], wv[3][1])};
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) mma16816(acc[nt][i], a, xb[nt].x, xb[nt].y);
        }
      }
    } else {
      const int half = tid >> 6, kb = kr0 + 32 * half;
      if (kb < klen) {
        const uint8_t* wcol = slot + 32 * half * kTileN + (tid & (kTileN - 1));
        const float* xr = reinterpret_cast<const float*>(x_s) + (kb - w0);
#pragma unroll 2
        for (int u = 0; u < 32; u += 4) {
          float w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) w[e] = i8(wcol[(u + e) * kTileN] ^ 0x80u, 0) * sc[0];
#pragma unroll
          for (int r = 0; r < (kBF16 ? 1 : kRows); ++r) {
            const float4 xv = *reinterpret_cast<const float4*>(xr + r * xstride + u);
            facc[r] = fmaf(xv.x, w[0], facc[r]);
            facc[r] = fmaf(xv.y, w[1], facc[r]);
            facc[r] = fmaf(xv.z, w[2], facc[r]);
            facc[r] = fmaf(xv.w, w[3], facc[r]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the sums go there
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // the next call may start

  if constexpr (kBF16) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // c0 (row 2t, column 8g+2i), c1 (row 2t+1), c2 (row 2t, column +1), c3
        float* base = red + (warp * kRows + 8 * nt + 2 * t) * kTileN + 8 * g + 2 * i;
        base[0] = acc[nt][i][0];
        base[kTileN] = acc[nt][i][1];
        base[1] = acc[nt][i][2];
        base[kTileN + 1] = acc[nt][i][3];
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < (kBF16 ? 1 : kRows); ++r) {
      red[((tid >> 6) * kRows + r) * kTileN + (tid & (kTileN - 1))] = facc[r];
    }
  }
  __syncthreads();
  auto store = [&](int e, float v) {
    const int r = e / kTileN, c = e - r * kTileN;
    if (m0 + r < m && n0 + c < n) y[static_cast<long long>(m0 + r) * n + n0 + c] = from_f32<T>(v);
  };
  for (int e = tid; e < kRows * kTileN; e += kThreads) {
    float v = red[e];
#pragma unroll
    for (int p = 1; p < kParts; ++p) v += red[p * kRows * kTileN + e];  // in warp order
    if (splits == 1) {
      store(e, v);
    } else {
      part[e] = v;
    }
  }
  if (splits > 1) {
    cluster_sync();  // every split's partial is in its CTA's shared memory
    for (int e = split + splits * tid; e < kRows * kTileN; e += splits * kThreads) {
      float vals[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {  // every remote read in flight at once
        vals[r] = r < splits ? ld_cluster(part + e, r) : 0.f;
      }
      float v = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) v += vals[r];  // in split order
      store(e, v);
    }
    cluster_sync();  // no CTA leaves while another reads its partial
  }
}

// the most dynamic shared memory a plan at kRows rows of T can ask for
// (plan_for at x's widest window)
template <typename T, int kRows>
constexpr int max_smem() {
  constexpr int size = static_cast<int>(sizeof(T));
  constexpr int ring = kStages * kSlotBytes;
  constexpr int sums = (kWarps + 1) * 4 * kRows * kTileN;
  return kRows * ((kXBytes / (kRows * size) - kXPad) / kStageK * kStageK + kXPad) * size +
         (ring > sums ? ring : sums);
}

constexpr int kMaxDevices = 64;

template <typename T, int kRows, bool kVec>
int launch(const void* x, const Groups& gr, int m, int k, const Plan& p, int device,
           cudaStream_t stream) {
  auto kernel = int8_mm_hopper<T, kRows, kVec>;
  if (device < 0 || device >= kMaxDevices || p.smem > max_smem<T, kRows>()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // once a device for this instantiation, not at every call (eager
  // decode loops launch K6 ~50 times a step): the most shared memory an
  // SM can give, so that lm_head's 500 CTAs of ~45 KB are resident
  // together (4 an SM), and the dynamic shared memory of its largest
  // plan. Two threads that race here both set the same values.
  static std::atomic<bool> ready[kMaxDevices];
  if (!ready[device].load(std::memory_order_acquire)) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               max_smem<T, kRows>());
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[device].store(true, std::memory_order_release);
  }
  int tiles = 0;
  for (int g = 0; g < gr.groups; ++g) tiles += gr.tiles[g];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, tiles, cdiv(m, kRows));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // programmatic dependent launch: the call's weight copies and scales
  // are issued while the kernel before it drains (x is read after
  // griddepcontrol.wait)
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), gr, m, k, p.kps, p.xw));
}

template <typename T, bool kVec>
int launch_vec(const void* x, const Groups& gr, int m, int k, const Plan& p, int device,
               cudaStream_t s) {
  switch (p.rows) {
    case 8: return launch<T, 8, kVec>(x, gr, m, k, p, device, s);
    case 16: return launch<T, 16, kVec>(x, gr, m, k, p, device, s);
    case 32: return launch<T, 32, kVec>(x, gr, m, k, p, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(const void* x, const Groups& gr, int m, int k, const Plan& p, int device,
             cudaStream_t s) {
  return p.vec == 16 ? launch_vec<T, true>(x, gr, m, k, p, device, s)
                     : launch_vec<T, false>(x, gr, m, k, p, device, s);
}

}  // namespace hop

}  // namespace

// x [m, k] (dtype); for each of `groups` (1-3) weights g: q_g [k, n_g]
// int8, scale_g [n_g] f32, y_g [m, n_g] (dtype). vec, rows, splits, kps,
// xw: the plan of ops/int8_matmul.py int8_plan, checked here; 16-byte
// weight copies (vec 16) need every n_g a multiple of 16 and every q_g
// 16-byte aligned.
extern "C" int port_int8_matmul(const void* x, const void* q0, const void* q1, const void* q2,
                                const void* s0, const void* s1, const void* s2, void* y0,
                                void* y1, void* y2, int n0, int n1, int n2, int groups, int m,
                                int k, int vec, int rows, int splits, int kps, int xw, int dtype,
                                int device, void* stream) {
  // this library links its own CUDA runtime: select the caller's device
  // in it before launching on the caller's stream
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  if (m <= 0) return 0;
  const int ns[3] = {n0, n1, n2};
  const void* qs[3] = {q0, q1, q2};
  if (k <= 0 || groups < 1 || groups > hop::kMaxGroups || (dtype != kF32 && dtype != kBF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  hop::Groups gr = {};
  gr.groups = groups;
  long long tiles = 0;
  for (int g = 0; g < groups; ++g) {
    if (ns[g] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    if (vec == 16 && !aligned16(qs[g])) return static_cast<int>(cudaErrorInvalidValue);
    gr.q[g] = static_cast<const int8_t*>(qs[g]);
    gr.n[g] = ns[g];
    gr.tiles[g] = cdiv(ns[g], hop::kTileN);
    tiles += gr.tiles[g];
  }
  gr.scale[0] = static_cast<const float*>(s0);
  gr.scale[1] = static_cast<const float*>(s1);
  gr.scale[2] = static_cast<const float*>(s2);
  gr.y[0] = y0;
  gr.y[1] = y1;
  gr.y[2] = y2;
  const hop::Plan p = hop::plan_for(m, k, ns, groups, dtype == kF32 ? 4 : 2);
  if (p.rows != rows || p.splits != splits || p.kps != kps || p.xw != xw || p.vec != vec ||
      tiles > kMaxGridYZ || cdiv(m, p.rows) > kMaxGridYZ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = dtype == kF32 ? hop::dispatch<float>(x, gr, m, k, p, device, s)
                               : hop::dispatch<__nv_bfloat16>(x, gr, m, k, p, device, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
