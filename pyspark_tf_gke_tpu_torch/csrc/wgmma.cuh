// Hopper building blocks of the port's tensor-core kernels (sm_90a): the
// 128-byte swizzled shared-memory layout and its wgmma matrix
// descriptors, the bf16 m64n64k16 and m64n128k16 warpgroup products (A
// from shared memory, K- or MN-major, or from registers), mbarriers,
// named barriers, register moves between warpgroups, the proxy fence,
// TMA tensor loads and stores and their tensor maps, and cp.async. Only what the bf16 flash forward
// at head_dim 64 and 128 (flash_attention.cu), the bf16 fused 3x3 conv forward (fused_conv3.cu),
// the bf16 fused 1x1 conv forward and input gradient (fused_matmul.cu),
// the bf16 fused 3x3 conv input gradient (fused_conv3.cu), the bf16
// flash dK/dV (flash_attention_bwd.cu) and the bf16 weight gradients
// (wgmma_dw.cuh) use; PTX as in the PTX
// ISA's wgmma, mbarrier, bar, cp.async, cp.async.bulk and
// cp.async.bulk.tensor sections.
//
// Layout. A tile row of 64 bf16 is 128 bytes, one row of the 128-byte
// swizzle atom (8 rows, 1024 bytes): the 16-byte chunk c of row r lives
// at r*128 + ((c ^ (r % 8)) * 16) from a 1024-byte aligned tile base,
// which is what TMA's CU_TENSOR_MAP_SWIZZLE_128B writes and what a
// descriptor of layout type 1 (128B) reads.
//  - K-major operand (the reduction axis contiguous: Q and K rows of
//    head_dim, pixels x channels): rows at 128 bytes, 8-row groups at
//    SBO = 1024 bytes; a k16 step advances the start address by 32
//    bytes inside the atom.
//  - MN-major operand (the output axis contiguous: V [keys, head_dim],
//    weights [K, N]; for the weight gradients both A = x^T and B = dy,
//    pixels x channels), read with the transpose bit: one row of 64
//    output columns per reduction index, 8 reduction rows per atom, so a
//    k16 step advances 2048 bytes. The stride between 8-row groups
//    along the reduction (SBO) is 1024; the stride between 64-column
//    atoms along the output axis (LBO) is used only by an n128 product
//    over two atoms (K4f's B: the atoms 8 KB apart), and set to 1024 where
//    the tile is one atom wide.
#pragma once

#include <atomic>

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <stdint.h>

namespace port {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` of row `row` in a 128B-swizzled tile
__device__ __forceinline__ uint32_t sw128(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t saddr) { return desc_sw128(saddr, 16, 1024); }
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t saddr, uint32_t atom_stride = 1024) {
  return desc_sw128(saddr, atom_stride, 1024);
}

// -- warpgroup products -------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the accumulator
// registers across the asynchronous product (launch ... wait).
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define PORT_D32                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),     \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define PORT_D32_OUT                                                                      \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),     \
      "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]),          \
      "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]),       \
      "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),       \
      "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]),       \
      "=f"(d[31])
#define PORT_DREGS                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "               \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], bf16 operands from shared
// memory, f32 accumulators; kTransB: B is MN-major; kTransA: A is
// MN-major (the PTX imm-trans-a, legal for bf16 with A in shared
// memory). scale_d 0: d = A B.
// Accumulator layout (thread t of the warpgroup, warp w = t / 32, lane
// l): d[4j + e] is row 16w + l/4 + 8*(e/2), column 8j + 2*(l%4) + e%2.
template <int kTransB, int kTransA = 0>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PORT_DREGS
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : PORT_D32
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// d = A B (scale_d 0) as above with B from shared memory and A K-major,
// the outputs write-only: the old accumulator is dead before the product
// (the "+f" form keeps it live), so a restarted accumulator costs no
// registers while the other one's products run.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_ss_first(float (&d)[32], uint64_t da,
                                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PORT_DREGS
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : PORT_D32_OUT
      : "l"(da), "l"(db), "r"(0), "n"(kTransB));
}

// As above with A from registers: a[4] holds the thread's bf16 pairs of
// the 64 x 16 A tile in mma.sync's m16n8k16 A-fragment order (warp w
// rows 16w..16w+15): a[0] (row l/4, cols 2(l%4)+{0,1}), a[1] (row
// l/4+8, same cols), a[2] (row l/4, cols 8+2(l%4)+{0,1}), a[3] (row
// l/4+8, those cols) — which is the accumulator layout above, so an f32
// result can be fed back as bf16 without moving between threads.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PORT_DREGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : PORT_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTransB));
}

// d = A B with A from registers (as wgmma_m64n64k16_rs), the outputs
// write-only: a fresh accumulator whose old value is dead
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs_first(float (&d)[32], const uint32_t (&a)[4],
                                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PORT_DREGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : PORT_D32_OUT
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0), "n"(kTransB));
}

#undef PORT_D32
#undef PORT_D32_OUT
#undef PORT_DREGS

#define PORT_D64                                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),            \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),      \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),  \
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),  \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),  \
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),  \
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),  \
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define PORT_D64_OUT                                                                    \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),            \
      "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),      \
      "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),  \
      "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),  \
      "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),  \
      "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),  \
      "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]),  \
      "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),  \
      "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]),  \
      "=f"(d[54]), "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),  \
      "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
#define PORT_DREGS64                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "     \
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "  \
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], both from shared memory (A
// K-major), f32 accumulators; kTransB: B is MN-major (two 64-column
// atoms, LBO apart). Accumulator layout as the n64 product's, for
// 8-column groups j < 16: d[4j + e] is row 16w + l/4 + 8*(e/2), column
// 8j + 2*(l%4) + e%2.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PORT_DREGS64
      ", %64, %65, p, 1, 1, 0, %67;\n}\n"
      : PORT_D64
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
}

// d = A B, the outputs write-only (as wgmma_m64n64k16_ss_first)
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_ss_first(float (&d)[64], uint64_t da,
                                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PORT_DREGS64
      ", %64, %65, p, 1, 1, 0, %67;\n}\n"
      : PORT_D64_OUT
      : "l"(da), "l"(db), "r"(0), "n"(kTransB));
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128] with A from registers (the
// fragment order of wgmma_m64n64k16_rs) and B from shared memory
// (kTransB: MN-major, two 64-column atoms LBO apart): the flash kernels'
// P V, P^T dO, dS^T Q and dS K at head_dim 128.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PORT_DREGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : PORT_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTransB));
}

// d = A B with A from registers (as wgmma_m64n128k16_rs), the outputs
// write-only: a fresh accumulator whose old value is dead
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_rs_first(float (&d)[64], const uint32_t (&a)[4],
                                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PORT_DREGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : PORT_D64_OUT
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0), "n"(kTransB));
}

#undef PORT_D64
#undef PORT_D64_OUT
#undef PORT_DREGS64

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// -- mbarriers, fences, asynchronous copies -----------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// make initialised barriers visible to the other threads and to TMA
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// spin until the barrier's phase with parity `phase` has completed; a
// wait of more than ~2^34 cycles (seconds: a lost copy, a wrong byte
// count) traps, so that a fault surfaces as a launch error, not a hang
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(phase)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// a plain arrival (no transaction bytes): a count of arrivals, or
// copies made by threads, completes the phase
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// barrier `id` (1-15; 0 is __syncthreads) over `count` threads, a
// multiple of 32: the warps that name it wait for each other only
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Move registers between the warpgroups of a warp-specialised CTA: the
// warpgroup that executes dec gives its registers above N back, inc
// waits until N a thread are free; every warp of the warpgroup executes
// it. ptxas allocates the code that follows within N.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// order this thread's generic-proxy shared-memory writes (st.shared,
// cp.async) before later async-proxy accesses (wgmma operands, TMA
// stores; and TMA loads into the same bytes)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// TMA: the box at coordinates (c0, c1, c2, c3) of a 4-D tensor map into
// shared memory at dst; completion counts `bytes` on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// TMA: the box at coordinates (c0, c1, c2) of a 3-D tensor map into
// shared memory at dst; completion counts the box's bytes on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// TMA store: shared memory at src to the box at coordinates (c0, c1,
// c2, c3) of a 4-D tensor map; the parts of the box outside the tensor
// are not written. Tracked by this thread's bulk groups.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// TMA: the box at coordinates (c0, c1) of a 2-D tensor map (c0 the
// contiguous axis) into shared memory at dst; completion counts the
// box's bytes on `bar`, zeros included where the box leaves the tensor
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// TMA store: shared memory at src to the box at coordinates (c0, c1) of
// a 2-D tensor map; the parts of the box outside the tensor are not
// written. Tracked by this thread's bulk groups.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// wait until at most N of this thread's committed bulk groups still read
// shared memory (their global writes may still be in flight)
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// cuTensorMapEncodeTiled from libcuda, which the process has loaded (the
// CUDA runtime linked into this library has no tensor-map call)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A 2-D map over a row-major bf16 matrix [rows, cols] (cols contiguous,
// a multiple of 8, the base 16-byte aligned), boxes of 64 columns x
// box_rows rows in the 128-byte swizzle, zeros past either edge.
inline bool tensor_map_2d(EncodeTiled encode, CUtensorMap* map, const void* base,
                          long long rows, long long cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 4-D map over a [B, S, H, d] bf16 view (d a multiple of 64) with
// element strides (sb, ss, sh, 1), dimensions innermost first as
// (head_dim, head, seq, batch), boxes of 64 head_dim values (one swizzle
// atom: a 128B-swizzled box is at most 128 bytes wide) by `rows`
// positions of one (batch, head), 128-byte swizzle, zeros past S; a
// wider row is d/64 boxes at head_dim coordinates 0, 64, ... The stride
// of a size-1 dimension is never followed and is replaced by a valid
// one. The flash kernels' Q, K, V and dO.
inline bool tensor_map_bshd(EncodeTiled encode, CUtensorMap* map, const void* base, int B, int S,
                            int H, long long sb, long long ss, long long sh, int rows,
                            int d = 64) {
  const cuuint64_t st_h = static_cast<cuuint64_t>(H > 1 ? sh : d) * 2;
  const cuuint64_t st_s = S > 1 ? static_cast<cuuint64_t>(ss) * 2 : st_h * H;
  const cuuint64_t st_b = B > 1 ? static_cast<cuuint64_t>(sb) * 2 : st_s * S;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {st_h, st_s, st_b};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The current device's SMs, looked up once a device; 0 if the lookup
// fails. The persistent kernels launch one CTA an SM.
inline int sm_count() {
  constexpr int kDevices = 64;
  static std::atomic<int> counts[kDevices];
  int device = 0, count = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  if (device < kDevices && (count = counts[device].load(std::memory_order_relaxed)) > 0) {
    return count;
  }
  if (cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    return 0;
  }
  if (device < kDevices) counts[device].store(count, std::memory_order_relaxed);
  return count;
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros
// (src must still be a valid address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace hopper
}  // namespace port
