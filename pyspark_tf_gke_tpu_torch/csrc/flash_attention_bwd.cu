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
// key) get p = 0 and contribute nothing. The rounding points are the TPU
// kernels': for bf16, P is rounded to bf16 before dV += P^T dO (:255)
// and dS before dK += dS^T Q (:262) and dQ += dS K (:202); f32 keeps
// both in f32.
//
// Bound on the H100: at the training shapes (B=16 S=512 H=12 D=64,
// causal) K2dkv does 8*D operations a visible (query, key) pair (S, dP,
// dV, dK) against q, k, v, dO, dK, dV and the f32 row vectors once:
// 0.0228 ms of bytes against 0.0130 ms of bf16 tensor-core operations,
// so bound by bytes, and in practice by how fast the products are fed.
//
// Each entry point runs the design of the plan (flash_attention.cuh,
// ops/flash_attention.py flash_plan), from the head width and dtype
// alone: bf16 at head_dim 64 and 128 takes the tensor-core kernels
// below, every other width and f32 at every width the CUDA-core ones
// (flash_attention_simt.cu).
//
// K2dkv bf16 (wg::flash_dkv_wgmma<D>, the tensor-core design, D 64 or
// 128): a CTA owns
// 128 keys of one (b, h) on two consumer warpgroups of 64 keys, and a
// producer warpgroup that gives its registers to them. K and V arrive
// once by TMA from the 4-D maps over the strided [B, S, H, D] views
// (wgmma.cuh tensor_map_bshd); 64-row Q and dO tiles, with their lse,
// delta and segment ids, come through a 3-stage ring (full: TMA bytes
// and the producer warp's 32 arrivals; empty: the 8 consumer warps).
// Per tile, each warpgroup computes S^T = K Q^T and dP^T = V dO^T as
// wgmma products from shared memory (every operand K-major, head_dim
// contiguous), applies the scale, the key's bias (constant in the CTA),
// the segment ids (per query column) and the causal compare (diagonal
// tiles only; tiles wholly before the warpgroup's keys are skipped),
// forms P = exp(S - lse) and dS = P (dP - delta) scale in f32 on the
// accumulator fragments, rounds both to bf16 in registers as A
// fragments, and runs dV += P^T dO and dK += dS^T Q with A from
// registers and dO, Q read MN-major through the transpose bit. At D 64
// each tile's two products go into fresh accumulators that are added to
// the f32 sums in tile order (the TPU kernel also adds one f32 product a
// block); at D 128 the dK and dV sums alone are 128 registers a thread,
// so the products accumulate into them directly (the wgmma's own f32
// accumulation). Keys and query rows past S arrive as zeros from TMA
// and padded query rows take lse = +inf, so they contribute nothing;
// dK and dV are rounded once and stored from the fragments. Causal CTAs
// are launched longest first: the key block is the slow grid axis, so
// the first wave takes the blocks that see every query tile.
//
// K2dq bf16 (wgdq::flash_dq_wgmma<D>, the tensor-core design): K2dkv's
// design with the roles turned. A CTA owns 128 query rows of one (b, h)
// on two consumer warpgroups of 64 rows, and a producer warpgroup that
// gives its registers to them (setmaxnreg 40 / 232, as wg::). Q and dO
// of the CTA's rows arrive once by TMA from the 4-D maps over the
// strided [B, S, H, D] views; each thread keeps its two rows' lse (+inf
// past S), delta and segment ids in registers. 64-key K and V tiles,
// with the keys' bias (NEG_INF for padding and for keys past S) and
// segment ids, come through a 3-stage ring (full: TMA bytes and the
// producer warp's 32 arrivals; empty: the 8 consumer warps). Per tile,
// each warpgroup computes S = Q K^T and dP = dO V^T as wgmma products
// from shared memory (every operand K-major, head_dim contiguous),
// applies the scale, the key's bias, the segment compare and the causal
// compare (diagonal tiles only) in the TPU kernel's order, forms P =
// exp(S - lse) (expf: exp2f left ~20% more K2dkv elements off f64) and
// dS = P (dP - delta) scale in f32 on the accumulator fragments, rounds
// dS to bf16 once in registers as the RS A-fragment (:202), and runs
// dQ_t = dS K with K read MN-major through the transpose bit into a
// fresh accumulator, added to the f32 sum in tile order. Causal CTAs
// walk key tiles up to their last row, a warpgroup skips (and still
// releases) a tile wholly after its rows, and the query block is the
// slow grid axis taken from the last block down, so the longest CTAs
// launch first; dQ is rounded once and stored from the fragments, rows
// past S not stored.
//
// Bound of K2dq at the training shape (B=16 S=512 H=12 D=64, causal):
// q, k, v, dO and dq once plus lse and delta, 0.0190 ms of bytes,
// against 6*D operations a visible pair (S, dP, dQ), ~0.0098 ms of bf16
// tensor-core work: bytes-bound on paper. What holds the design back:
// each tile's three products and the elementwise pass between them run
// in series within a warpgroup (only the other warpgroup and the TMA
// ring overlap them), and each CTA re-reads the K/V tiles that the
// other query blocks of its (b, h) also read (from L2).
//
#include "flash_attention.cuh"
#include "wgmma.cuh"

using namespace port;

namespace {

using flash::Strides;

// The 4-D TMA maps (q, k, v, dout) of a bf16 backward kernel over the
// strided [B, S, H, d] views, q and dout in boxes of q_rows positions,
// k and v of kv_rows, 64 head_dim values a box. Returns 0 or a CUDA
// error code.
int bwd_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
             const void* dout, int B, int S, int H, const Strides& st, int q_rows,
             int kv_rows, int d) {
  using namespace port::hopper;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const bool ok =
      tensor_map_bshd(encode, &m[0], q, B, S, H, st.qb, st.qs, st.qh, q_rows, d) &&
      tensor_map_bshd(encode, &m[1], k, B, S, H, st.kb, st.ks, st.kh, kv_rows, d) &&
      tensor_map_bshd(encode, &m[2], v, B, S, H, st.vb, st.vs, st.vh, kv_rows, d) &&
      tensor_map_bshd(encode, &m[3], dout, B, S, H, st.ob, st.os, st.oh, q_rows, d);
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// -- K2dkv, bf16: the tensor-core design ----------------------------------------

namespace wg {

using namespace port::hopper;

constexpr int kBK = 128;    // keys a CTA: two consumer warpgroups of 64
constexpr int kBQ = 64;     // query rows a tile
constexpr int kStages = 3;  // Q / dO ring depth
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
// registers a thread after the move (launched at 65536 / 384 = 168): the
// producer warpgroup needs few; a consumer holds the dK and dV sums, a
// tile's S and dP (or its two fresh products) and the bf16 fragments
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(kProducerRegs * 128 + kConsumerRegs * kConsumers <= 65536, "register file");
constexpr int kAtomRow = 128;  // a swizzle-atom row: 64 bf16 of head_dim

// The shared-memory plan at head width D: every tile is D/64 column
// blocks ([rows][64 bf16], 128B-swizzled), block a at a * rows * 128.
template <int D>
struct Layout {
  static constexpr int kAtoms = D / 64;
  static constexpr int kKVBlock = kBK * kAtomRow;   // K's or V's column-block stride
  static constexpr int kTileBlock = kBQ * kAtomRow;  // a Q or dO tile's
  static constexpr int kKVBytes = kAtoms * kKVBlock;  // K or V of the CTA's keys
  static constexpr int kTileBytes = kAtoms * kTileBlock;
  static constexpr int kStageBytes = 2 * kTileBytes;  // Q, then dO
  static constexpr int kVecs = 3 * kBQ;               // a stage's lse, delta (f32) and segment ids
  static constexpr int kVecOffset = 2 * kKVBytes + kStages * kStageBytes;
  static constexpr int kBarOffset = kVecOffset + kStages * kVecs * 4;
  // 1024 of slack to align the swizzled tiles; full and empty a stage, K/V
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (2 * kStages + 1);
};
static_assert(Layout<128>::kSmem <= 232448, "shared memory");

// The accumulator granularity at D 64: each query tile's dV and dK
// products go into fresh wgmma accumulators, added to f32 sums in tile
// order, as the TPU kernel adds one f32 product a block. Chaining every
// tile (up to 8 at S = 512) into the two accumulators left up to 14%
// more dK and dV elements a bf16 rounding away from an f64 reference
// (causal; as many with segments) and was 3-6% faster (PERF.md). At D
// 128 the two sums are 128 registers a thread and fresh products would
// need 128 more: the products accumulate into the sums.

// acc (+)= A B over one 64-row query tile (four k16 steps): A (bf16 P or
// dS, rows: keys) from registers, B (dO or Q) read MN-major through the
// transpose bit, N = D (at D 128 an n128 product over both column blocks)
template <int D>
__device__ __forceinline__ void tile_product(float (&acc)[D / 2], const uint32_t (&a)[4][4],
                                             uint32_t b_addr, bool fresh) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = desc_mnmajor(b_addr + kk * 16 * kAtomRow, Layout<D>::kTileBlock);
    if constexpr (D == 64) {
      if (kk == 0 && fresh) wgmma_m64n64k16_rs_first<1>(acc, a[kk], db);
      else wgmma_m64n64k16_rs<1>(acc, a[kk], db, 1);
    } else {
      if (kk == 0 && fresh) wgmma_m64n128k16_rs_first<1>(acc, a[kk], db);
      else wgmma_m64n128k16_rs<1>(acc, a[kk], db, 1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_wgmma(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
                __grid_constant__ const CUtensorMap tv, __grid_constant__ const CUtensorMap tdo,
                const uint8_t* __restrict__ kv_mask, const int* __restrict__ segs,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int H,
                int causal, float scale) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = smem;
  uint8_t* v_s = smem + L::kKVBytes;
  uint8_t* ring = smem + 2 * L::kKVBytes;
  float* vecs = reinterpret_cast<float*>(smem + L::kVecOffset);  // [kStages][3][kBQ]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = blockIdx.y * kBK;  // the slow axis: block 0, the longest causal one, first
  const int qt0 = causal ? k0 / kBQ : 0;  // causal: earlier query rows never see the block
  const int ntiles = (S + kBQ - 1) / kBQ - qt0;
  const long long brow = static_cast<long long>(b) * S;
  const long long rv0 = (static_cast<long long>(b) * H + h) * S;

  if (t == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 32);                  // the producer warp's lanes
      mbar_init(&empty[i], kConsumers / 32);    // one arrival a consumer warp
    }
    mbar_init(kvbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // -- the producer warpgroup --------------------------
    setmaxnreg_dec<kProducerRegs>();
    if (warp != kConsumers / 32) return;  // its first warp loads
    if (lane == 0) {
      mbar_arrive_expect_tx(kvbar, 2 * L::kKVBytes);
      for (int a = 0; a < L::kAtoms; ++a) {
        tma_load_4d(k_s + a * L::kKVBlock, &tk, kvbar, 64 * a, h, k0, b);
        tma_load_4d(v_s + a * L::kKVBlock, &tv, kvbar, 64 * a, h, k0, b);
      }
    }
    for (int it = 0; it < ntiles; ++it) {
      const int slot = it % kStages, q0 = (qt0 + it) * kBQ;
      if (it >= kStages) mbar_wait(&empty[slot], ((it / kStages) - 1) & 1);
      // lse (+inf past S: p = 0), delta and segment ids of the tile's rows
      float* vl = vecs + slot * L::kVecs;
      for (int i = lane; i < kBQ; i += 32) {
        const int q = q0 + i;
        const bool in = q < S;
        vl[i] = in ? lse[rv0 + q] : INFINITY;
        vl[kBQ + i] = in ? delta[rv0 + q] : 0.f;
        reinterpret_cast<int*>(vl)[2 * kBQ + i] = (in && segs != nullptr) ? segs[brow + q] : 0;
      }
      if (lane == 0) {
        uint8_t* st = ring + slot * L::kStageBytes;
        mbar_arrive_expect_tx(&full[slot], L::kStageBytes);
        for (int a = 0; a < L::kAtoms; ++a) {
          tma_load_4d(st + a * L::kTileBlock, &tq, &full[slot], 64 * a, h, q0, b);
          tma_load_4d(st + L::kTileBytes + a * L::kTileBlock, &tdo, &full[slot], 64 * a, h, q0,
                      b);
        }
      } else {
        mbar_arrive(&full[slot]);
      }
    }
    return;
  }

  // -- the consumer warpgroups: warpgroup g owns keys k0 + 64 g .. + 63 ----------
  setmaxnreg_inc<kConsumerRegs>();
  const int g = warp >> 2;
  const int wk0 = k0 + 64 * g;
  const int key_a = wk0 + 16 * (warp & 3) + (lane >> 2);  // the thread's two rows
  const int key_b = key_a + 8;
  const float bias_a =
      (kv_mask != nullptr && key_a < S && !kv_mask[brow + key_a]) ? kNegInf : 0.f;
  const float bias_b =
      (kv_mask != nullptr && key_b < S && !kv_mask[brow + key_b]) ? kNegInf : 0.f;
  const int seg_a = (segs != nullptr && key_a < S) ? segs[brow + key_a] : 0;
  const int seg_b = (segs != nullptr && key_b < S) ? segs[brow + key_b] : 0;
  const int kq = 2 * (lane & 3);  // the thread's first column in each 8
  const uint32_t k_addr = smem_u32(k_s) + g * 64 * kAtomRow;
  const uint32_t v_addr = smem_u32(v_s) + g * 64 * kAtomRow;

  float dks[D / 2], dvs[D / 2];  // the f32 sums of the tiles' products
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dks[i] = dvs[i] = 0.f;
  mbar_wait(kvbar, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int slot = it % kStages, q0 = (qt0 + it) * kBQ;
    mbar_wait(&full[slot], (it / kStages) & 1);
    // causal: a tile wholly before the warpgroup's keys sees none of them
    if (!causal || q0 + kBQ - 1 >= wk0) {
      const uint32_t q_addr = smem_u32(ring + slot * L::kStageBytes);
      const uint32_t do_addr = q_addr + L::kTileBytes;
      const float* vl = vecs + slot * L::kVecs;
      const float* vd = vl + kBQ;
      const int* vs = reinterpret_cast<const int*>(vl + 2 * kBQ);
      float s[32], dp[32];
      wgmma_fence();
      // S^T = K Q^T and dP^T = V dO^T: D/16 k16 steps each, 32 bytes on
      // inside a column block, then the next block
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a_off = (kk >> 2) * L::kKVBlock + (kk & 3) * 32;
        const uint32_t b_off = (kk >> 2) * L::kTileBlock + (kk & 3) * 32;
        if (kk == 0) wgmma_m64n64k16_ss_first<0>(s, desc_kmajor(k_addr), desc_kmajor(q_addr));
        else wgmma_m64n64k16_ss<0>(s, desc_kmajor(k_addr + a_off), desc_kmajor(q_addr + b_off), 1);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a_off = (kk >> 2) * L::kKVBlock + (kk & 3) * 32;
        const uint32_t b_off = (kk >> 2) * L::kTileBlock + (kk & 3) * 32;
        if (kk == 0) wgmma_m64n64k16_ss_first<0>(dp, desc_kmajor(v_addr), desc_kmajor(do_addr));
        else wgmma_m64n64k16_ss<0>(dp, desc_kmajor(v_addr + a_off), desc_kmajor(do_addr + b_off),
                                   1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(s);
      fence_operand(dp);

      // the TPU kernel's order: scale, the key's bias, then the segment
      // and causal masks replace the score; P = exp(S - lse) and dS =
      // P (dP - delta) scale in f32, each rounded to bf16 once, as the A
      // fragments of the four k16 steps (rows: keys; columns: queries)
      const bool diag = causal && q0 < wk0 + 64;
      uint32_t pf[4][4], df[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float pv[4], dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + kq + (e & 1);
          const bool ra = e < 2;
          float sv = s[j * 4 + e] * scale + (ra ? bias_a : bias_b);
          if (segs != nullptr && vs[col] != (ra ? seg_a : seg_b)) sv = kNegInf;
          if (diag && q0 + col < (ra ? key_a : key_b)) sv = kNegInf;
          pv[e] = expf(sv - vl[col]);
          dsv[e] = pv[e] * (dp[j * 4 + e] - vd[col]) * scale;
        }
        pf[j / 2][(j % 2) * 2 + 0] = pack_bf16(pv[0], pv[1]);
        pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(pv[2], pv[3]);
        df[j / 2][(j % 2) * 2 + 0] = pack_bf16(dsv[0], dsv[1]);
        df[j / 2][(j % 2) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
      }

      // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major (head_dim
      // contiguous) through the transpose bit, a k16 step 16 query rows
      if constexpr (D == 64) {
        float dvt[32], dkt[32];
        wgmma_fence();
        tile_product<D>(dvt, pf, do_addr, true);
        tile_product<D>(dkt, df, q_addr, true);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(dvt);
        fence_operand(dkt);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          dvs[i] += dvt[i];
          dks[i] += dkt[i];
        }
      } else {
        wgmma_fence();
        tile_product<D>(dvs, pf, do_addr, false);
        tile_product<D>(dks, df, q_addr, false);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(dvs);
        fence_operand(dks);
      }
    }
    if (lane == 0) mbar_arrive(&empty[slot]);  // this warp is done with the stage
  }

  // dK and dV rounded once; rows past S are not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r == 0 ? key_a : key_b;
    if (key >= S) continue;
    const long long off = ((brow + key) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + kq;
      *reinterpret_cast<__nv_bfloat162*>(dk + off + col) =
          __floats2bfloat162_rn(dks[j * 4 + 2 * r], dks[j * 4 + 2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
          __floats2bfloat162_rn(dvs[j * 4 + 2 * r], dvs[j * 4 + 2 * r + 1]);
    }
  }
}

// st: q, k, v, dout strides (batch, seq, head) in elements; every
// operand TMA-addressable (ops/flash_attention.py tma_compatible)
template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* kv_mask,
           const void* segs, const void* lse, const void* delta, void* dk, void* dv, int B, int S,
           int H, const Strides& st, int causal, float scale, cudaStream_t stream) {
  CUtensorMap m[4];
  if (int rc = bwd_maps(m, q, k, v, dout, B, S, H, st, kBQ, kBK, D)) return rc;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<D>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // x: (b, h); y: the key block, the slow axis (longest causal blocks first)
  const dim3 grid(B * H, (S + kBK - 1) / kBK);
  flash_dkv_wgmma<D><<<grid, kThreads, Layout<D>::kSmem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const uint8_t*>(kv_mask),
      static_cast<const int*>(segs),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// -- K2dq, bf16: the tensor-core design ----------------------------------------

namespace wgdq {

using namespace port::hopper;
using wg::kAtomRow;
using wg::kConsumerRegs;
using wg::kConsumers;
using wg::kProducerRegs;
using wg::kStages;
using wg::kThreads;

constexpr int kBQ = 128;  // query rows a CTA: two consumer warpgroups of 64
constexpr int kBK = 64;   // keys a tile

template <int D>
struct Layout {
  static constexpr int kAtoms = D / 64;
  static constexpr int kQBlock = kBQ * kAtomRow;     // Q's or dO's column-block stride
  static constexpr int kTileBlock = kBK * kAtomRow;  // a K or V tile's
  static constexpr int kQBytes = kAtoms * kQBlock;   // Q or dO of the CTA's rows
  static constexpr int kTileBytes = kAtoms * kTileBlock;
  static constexpr int kStageBytes = 2 * kTileBytes;  // K, then V
  static constexpr int kVecs = 2 * kBK;               // a stage's key bias (f32) and segment ids
  static constexpr int kVecOffset = 2 * kQBytes + kStages * kStageBytes;
  static constexpr int kBarOffset = kVecOffset + kStages * kVecs * 4;
  // 1024 of slack to align the swizzled tiles; full and empty a stage, Q/dO
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (2 * kStages + 1);
};
static_assert(Layout<128>::kSmem <= 232448, "shared memory");

// The accumulator granularity is K2dkv's at D 64: each key tile's dQ
// product goes into a fresh wgmma accumulator, added to the f32 sum in
// tile order (at D 128 too: dQ's sum and product are 128 registers).

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_wgmma(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
               __grid_constant__ const CUtensorMap tv, __grid_constant__ const CUtensorMap tdo,
               const uint8_t* __restrict__ kv_mask, const int* __restrict__ segs,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dq, int S, int H, int causal, float scale) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;
  uint8_t* do_s = smem + L::kQBytes;
  uint8_t* ring = smem + 2 * L::kQBytes;
  float* vecs = reinterpret_cast<float*>(smem + L::kVecOffset);  // [kStages][2][kBK]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  // the slow axis, from the last query block down: the longest causal
  // CTAs (those that see the most key tiles) launch first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int q_last = min(q0 + kBQ, S) - 1;  // the CTA's last row
  const int ntiles = (causal ? q_last : S - 1) / kBK + 1;
  const long long brow = static_cast<long long>(b) * S;
  const long long rv0 = (static_cast<long long>(b) * H + h) * S;

  if (t == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 32);                  // the producer warp's lanes
      mbar_init(&empty[i], kConsumers / 32);    // one arrival a consumer warp
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // -- the producer warpgroup --------------------------
    setmaxnreg_dec<kProducerRegs>();
    if (warp != kConsumers / 32) return;  // its first warp loads
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, 2 * L::kQBytes);
      for (int a = 0; a < L::kAtoms; ++a) {
        tma_load_4d(q_s + a * L::kQBlock, &tq, qbar, 64 * a, h, q0, b);
        tma_load_4d(do_s + a * L::kQBlock, &tdo, qbar, 64 * a, h, q0, b);
      }
    }
    for (int it = 0; it < ntiles; ++it) {
      const int slot = it % kStages, k0 = it * kBK;
      if (it >= kStages) mbar_wait(&empty[slot], ((it / kStages) - 1) & 1);
      // the tile's key bias (NEG_INF for padding and for keys past S,
      // whose K and V rows TMA fills with zeros) and segment ids
      float* vk = vecs + slot * L::kVecs;
      for (int j = lane; j < kBK; j += 32) {
        const int key = k0 + j;
        const bool in = key < S;
        vk[j] = (!in || (kv_mask != nullptr && !kv_mask[brow + key])) ? kNegInf : 0.f;
        reinterpret_cast<int*>(vk)[kBK + j] = (in && segs != nullptr) ? segs[brow + key] : 0;
      }
      if (lane == 0) {
        uint8_t* st = ring + slot * L::kStageBytes;
        mbar_arrive_expect_tx(&full[slot], L::kStageBytes);
        for (int a = 0; a < L::kAtoms; ++a) {
          tma_load_4d(st + a * L::kTileBlock, &tk, &full[slot], 64 * a, h, k0, b);
          tma_load_4d(st + L::kTileBytes + a * L::kTileBlock, &tv, &full[slot], 64 * a, h, k0,
                      b);
        }
      } else {
        mbar_arrive(&full[slot]);
      }
    }
    return;
  }

  // -- the consumer warpgroups: warpgroup g owns rows q0 + 64 g .. + 63 ----------
  setmaxnreg_inc<kConsumerRegs>();
  const int g = warp >> 2;
  const int wq0 = q0 + 64 * g;
  const int wq_last = min(wq0 + 63, S - 1);  // below wq0 when the warpgroup has no row
  const int row_a = wq0 + 16 * (warp & 3) + (lane >> 2);  // the thread's two rows
  const int row_b = row_a + 8;
  // rows past S take lse = +inf: p = 0, so they contribute nothing
  const float lse_a = row_a < S ? lse[rv0 + row_a] : INFINITY;
  const float lse_b = row_b < S ? lse[rv0 + row_b] : INFINITY;
  const float delta_a = row_a < S ? delta[rv0 + row_a] : 0.f;
  const float delta_b = row_b < S ? delta[rv0 + row_b] : 0.f;
  const int seg_a = (segs != nullptr && row_a < S) ? segs[brow + row_a] : 0;
  const int seg_b = (segs != nullptr && row_b < S) ? segs[brow + row_b] : 0;
  const int kq = 2 * (lane & 3);  // the thread's first column in each 8
  const uint32_t q_addr = smem_u32(q_s) + g * 64 * kAtomRow;
  const uint32_t do_addr = smem_u32(do_s) + g * 64 * kAtomRow;

  float dqs[D / 2];  // the f32 sum of the tiles' products
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqs[i] = 0.f;
  mbar_wait(qbar, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int slot = it % kStages, k0 = it * kBK;
    mbar_wait(&full[slot], (it / kStages) & 1);
    // causal: a tile wholly after the warpgroup's rows is none of its
    // business (nor is any tile of a warpgroup past S)
    if (wq0 < S && (!causal || k0 <= wq_last)) {
      const uint32_t k_addr = smem_u32(ring + slot * L::kStageBytes);
      const uint32_t v_addr = k_addr + L::kTileBytes;
      const float* vk = vecs + slot * L::kVecs;
      const int* vs = reinterpret_cast<const int*>(vk + kBK);
      float s[32], dp[32];
      wgmma_fence();
      // S = Q K^T and dP = dO V^T: D/16 k16 steps each, 32 bytes on
      // inside a column block, then the next block
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a_off = (kk >> 2) * L::kQBlock + (kk & 3) * 32;
        const uint32_t b_off = (kk >> 2) * L::kTileBlock + (kk & 3) * 32;
        if (kk == 0) wgmma_m64n64k16_ss_first<0>(s, desc_kmajor(q_addr), desc_kmajor(k_addr));
        else wgmma_m64n64k16_ss<0>(s, desc_kmajor(q_addr + a_off), desc_kmajor(k_addr + b_off), 1);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a_off = (kk >> 2) * L::kQBlock + (kk & 3) * 32;
        const uint32_t b_off = (kk >> 2) * L::kTileBlock + (kk & 3) * 32;
        if (kk == 0) wgmma_m64n64k16_ss_first<0>(dp, desc_kmajor(do_addr), desc_kmajor(v_addr));
        else wgmma_m64n64k16_ss<0>(dp, desc_kmajor(do_addr + a_off), desc_kmajor(v_addr + b_off),
                                   1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(s);
      fence_operand(dp);

      // the TPU kernel's order (flash_attention.py:186-195): scale, the
      // key's bias, then the segment and causal masks replace the score;
      // P = exp(S - lse) and dS = P (dP - delta) scale in f32, rounded to
      // bf16 once (:202), as the A fragments of the four k16 steps (rows:
      // queries; columns: keys)
      const bool diag = causal && k0 + kBK - 1 > wq0;
      uint32_t df[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + kq + (e & 1);
          const bool ra = e < 2;
          float sv = s[j * 4 + e] * scale + vk[col];
          if (segs != nullptr && vs[col] != (ra ? seg_a : seg_b)) sv = kNegInf;
          if (diag && k0 + col > (ra ? row_a : row_b)) sv = kNegInf;
          const float p = expf(sv - (ra ? lse_a : lse_b));
          dsv[e] = p * (dp[j * 4 + e] - (ra ? delta_a : delta_b)) * scale;
        }
        df[j / 2][(j % 2) * 2 + 0] = pack_bf16(dsv[0], dsv[1]);
        df[j / 2][(j % 2) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
      }

      // dQ_t = dS K into a fresh accumulator, K read MN-major (head_dim
      // contiguous) through the transpose bit, a k16 step 16 keys
      float dqt[D / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = desc_mnmajor(k_addr + kk * 16 * kAtomRow, L::kTileBlock);
        if constexpr (D == 64) {
          if (kk == 0) wgmma_m64n64k16_rs_first<1>(dqt, df[kk], db);
          else wgmma_m64n64k16_rs<1>(dqt, df[kk], db, 1);
        } else {
          if (kk == 0) wgmma_m64n128k16_rs_first<1>(dqt, df[kk], db);
          else wgmma_m64n128k16_rs<1>(dqt, df[kk], db, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(dqt);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dqs[i] += dqt[i];
    }
    if (lane == 0) mbar_arrive(&empty[slot]);  // this warp is done with the stage
  }

  // dQ rounded once; rows past S are not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? row_a : row_b;
    if (row >= S) continue;
    const long long off = ((brow + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dq + off + j * 8 + kq) =
          __floats2bfloat162_rn(dqs[j * 4 + 2 * r], dqs[j * 4 + 2 * r + 1]);
    }
  }
}

// st: q, k, v, dout strides (batch, seq, head) in elements; every
// operand TMA-addressable (ops/flash_attention.py tma_compatible)
template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* kv_mask,
           const void* segs, const void* lse, const void* delta, void* dq, int B, int S, int H,
           const Strides& st, int causal, float scale, cudaStream_t stream) {
  CUtensorMap m[4];
  if (int rc = bwd_maps(m, q, k, v, dout, B, S, H, st, kBQ, kBK, D)) return rc;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<D>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // x: (b, h); y: the query block, the slow axis (longest causal blocks first)
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_dq_wgmma<D><<<grid, kThreads, Layout<D>::kSmem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const uint8_t*>(kv_mask),
      static_cast<const int*>(segs),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), S, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgdq

// the plan's width (flash_attention.cuh), checked, and the grid limit
int check_shape(int B, int H, int D, int dtype, int width) {
  const int w = flash::plan_width(D, dtype);
  if (w == 0 || w != width) return static_cast<int>(cudaErrorInvalidValue);
  if (B * H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// strides: q, k, v, dout (batch, seq, head), in elements; the head_dim
// axis of each must be contiguous. dq/dk/dv are written contiguous
// [B, S, H, D]; lse and delta are f32 [B, H, S]. width: the plan's
// (ops/flash_attention.py flash_plan), checked; D outside 1..256 returns
// cudaErrorInvalidValue. The tensor-core designs (bf16 at D 64 and 128,
// through TMA) also need 16-byte aligned bases and strides of size>1
// dimensions that are multiples of 8 elements, or return
// cudaErrorInvalidValue.
extern "C" int port_flash_attention_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* kv_mask, const void* segs, const void* lse, const void* delta,
    void* dq, int B, int S, int H, int D,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh,
    int causal, float scale, int dtype, int width, int device, void* stream) {
  // this library links its own CUDA runtime: select the caller's
  // device in it before launching on the caller's stream
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  if (int rc = check_shape(B, H, D, dtype, width)) return rc;
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  const Strides st{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!flash::tensor_core(D, dtype)) {
    return flash::simt_dq(q, k, v, dout, kv_mask, segs, lse, delta, dq, B, S, H, D, st, causal,
                          scale, dtype, s);
  }
  return D == 64 ? wgdq::launch<64>(q, k, v, dout, kv_mask, segs, lse, delta, dq, B, S, H, st,
                                    causal, scale, s)
                 : wgdq::launch<128>(q, k, v, dout, kv_mask, segs, lse, delta, dq, B, S, H, st,
                                     causal, scale, s);
}

extern "C" int port_flash_attention_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* kv_mask, const void* segs, const void* lse, const void* delta,
    void* dk, void* dv, int B, int S, int H, int D,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh,
    int causal, float scale, int dtype, int width, int device, void* stream) {
  if (cudaSetDevice(device) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  if (int rc = check_shape(B, H, D, dtype, width)) return rc;
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  const Strides st{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!flash::tensor_core(D, dtype)) {
    return flash::simt_dkv(q, k, v, dout, kv_mask, segs, lse, delta, dk, dv, B, S, H, D, st,
                           causal, scale, dtype, s);
  }
  return D == 64 ? wg::launch<64>(q, k, v, dout, kv_mask, segs, lse, delta, dk, dv, B, S, H, st,
                                  causal, scale, s)
                 : wg::launch<128>(q, k, v, dout, kv_mask, segs, lse, delta, dk, dv, B, S, H, st,
                                   causal, scale, s);
}
