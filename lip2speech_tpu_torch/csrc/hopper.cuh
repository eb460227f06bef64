// Hopper (sm_90a) building blocks of the kernels on wgmma (the two
// key-major backwards rel_attention_bwd.cu and rel_attention_bias_bwd.cu,
// the forward of flash_fwd_hopper.cuh that attention.cu, rel_attention.cu
// and rel_attention_bias.cu launch, and the resblock trio of
// fused_tail.cu): warpgroup matrix products (wgmma) with their
// shared-memory descriptors, TMA tile loads, bulk copies and bulk
// reductions, mbarriers, named barriers, the async-proxy fence and the
// register reallocation of warp-specialised blocks (setmaxnreg), written in
// inline PTX, the host-side encoding of TMA tensor maps, and the tile
// helpers the attention kernels share (swizzled f32 tiles, the TF32 split
// of a tile, the dropout keep words). Not compiled on its own.
//
// Shared-memory operand tiles are 128-byte-swizzled, as TMA writes them with
// CU_TENSOR_MAP_SWIZZLE_128B: rows of 128 bytes (64 bf16, or 32 floats)
// whose 16-byte chunks are XOR-ed with the row's index mod 8, in atoms of 8
// rows (1024 bytes); every tile starts on a 1024-byte boundary. A bf16 tile
// of 64 rows x 64 channels is 64 such rows (8 KB); an f32 one is two 8 KB
// halves, channels 0..31 and 32..63 (`sw32`).
//
// wgmma reads an operand tile through a 64-bit descriptor: start address,
// the stride between 8-row atoms (SBO, 1024 bytes here), and the swizzle
// mode. K-major: the product's reduction runs along the 128-byte rows; a
// k-step (16 bf16 or 8 floats, 32 bytes) advances the start by 32 bytes
// inside the atom. MN-major (bf16 only: tf32 wgmma has no transpose): the
// reduction runs across rows; a k16 step advances by 16 rows (2048 bytes).
// Accumulators are m64nN f32: warp w of the warpgroup holds rows 16w + g and
// 16w + g + 8 (g = lane / 4) in the m16n8 layout of mma_tile.cuh, c[n][0..1]
// row g columns 8n + 2q, 8n + 2q + 1 (q = lane % 4), c[n][2..3] row g + 8.
// A from registers takes the same per-warp fragment as mma.sync (m16k16
// bf16, m16k8 tf32).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---------------------------------------------------------------------------
// mbarriers, named barriers, fences
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// True once the barrier's phase of the given parity has completed (the
// thread may be suspended a while inside).
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
// Waits for that phase. A wait that outlasts ~2^35 clocks (some 20 s; every
// wait of these kernels lasts microseconds) traps, so that a fault in the
// barrier protocol ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// barrier `id` (1..15) among `threads` threads (a multiple of 32)
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Orders this thread's generic shared-memory accesses before later
// async-proxy ones (wgmma operand reads, TMA writes), and the reverse.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// Box (c0, c1, c2) of a 3-D tensor map into shared memory; completion adds
// the box's bytes to the barrier's transaction count. Elements outside the
// tensor arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Adds an f32 box of shared memory into a 3-D tensor map's box (c0, c1,
// c2), elementwise, in the L2: a bulk reduction. Elements outside the tensor
// are skipped. Tracked by the issuing thread's bulk groups.
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map, const void* src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until at most N of this thread's bulk groups are still reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// until at most N of them are incomplete
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// `bytes` contiguous bytes (a multiple of 16; both addresses 16-byte
// aligned) from global memory into shared memory, one TMA bulk copy;
// completion adds them to the barrier's transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// Register reallocation between the warpgroups of a block
// ---------------------------------------------------------------------------

// The calling warpgroup's registers a thread become N (a multiple of 8, 24
// .. 256): dec gives registers back to the block's pool, inc waits until
// the pool holds enough.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand at `p` (8-row atoms 1024 bytes
// apart). The same form serves K-major and MN-major tiles of one atom's
// width; the instruction's transpose flag tells them apart.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// The same for a 64-byte-swizzled K-major operand: rows of 64 bytes whose
// 16-byte chunks are XOR-ed with (row / 2) mod 4, 8-row atoms of 512 bytes.
__device__ __forceinline__ uint64_t desc_sw64(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of an accumulator (or of A
// registers) across a wgmma fence or wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[e])::"memory");
}

#define L2S_ACC32(d)                                                                        \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), \
      "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]),            \
      "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),            \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]),            \
      "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]),            \
      "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
#define L2S_D32                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64, f32) += A (64 x 16) B (16 x 64), bf16, both from shared memory;
// TA / TB = 1: that operand's tile is MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[8][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " L2S_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : L2S_ACC32(d)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 64, f32) += A (64 x 8) B (8 x 64), TF32: A (m16k8 fragments of the
// warp's rows) in registers, B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " L2S_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : L2S_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same for a 64 x 32 accumulator (m64n32k8).
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[4][4], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16) B (16 x 64), bf16: A (m16k16 fragments of
// the warp's rows, as mma.sync takes them) in registers, B from shared
// memory; TB = 1: B's tile is MN-major.
template <int TB>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " L2S_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : L2S_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

#define L2S_ACC16(d)                                                                        \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), \
      "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]),            \
      "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
#define L2S_D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// d (64 x 32, f32) += A (64 x 8) B (8 x 32), TF32, both K-major in shared
// memory (m64n32k8).
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[4][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " L2S_D16
      ", %16, %17, p, 1, 1;\n}\n"
      : L2S_ACC16(d)
      : "l"(da), "l"(db), "r"(1));
}

// The same for a 64 x 64 accumulator (m64n64k8).
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[8][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " L2S_D32
      ", %32, %33, p, 1, 1;\n}\n"
      : L2S_ACC32(d)
      : "l"(da), "l"(db), "r"(1));
}

// The register-A products of the resblock trio (fused_tail.cu) at its
// other widths: bf16 m64nNk16, N = 16, 32, 128, and TF32 m64nNk8, N = 16,
// 128 (the n64 ones and TF32 n32 above). B K-major (TB = 0) or MN-major (TB
// = 1, bf16 only).
#define L2S_F4(d, n) "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])
#define L2S_ACC8(d) L2S_F4(d, 0), L2S_F4(d, 1)
#define L2S_ACC64(d)                                                                          \
  L2S_F4(d, 0), L2S_F4(d, 1), L2S_F4(d, 2), L2S_F4(d, 3), L2S_F4(d, 4), L2S_F4(d, 5),          \
      L2S_F4(d, 6), L2S_F4(d, 7), L2S_F4(d, 8), L2S_F4(d, 9), L2S_F4(d, 10), L2S_F4(d, 11),    \
      L2S_F4(d, 12), L2S_F4(d, 13), L2S_F4(d, 14), L2S_F4(d, 15)
#define L2S_D8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define L2S_D64                                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

template <int TB>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[2][4], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " L2S_D8
      ", {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : L2S_ACC8(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[4][4], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " L2S_D16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : L2S_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[16][4], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " L2S_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : L2S_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[2][4], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 " L2S_D8
      ", {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : L2S_ACC8(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16][4], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " L2S_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : L2S_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


#undef L2S_F4
#undef L2S_ACC8
#undef L2S_ACC64
#undef L2S_D8
#undef L2S_D64
#undef L2S_ACC16
#undef L2S_D16
#undef L2S_ACC32
#undef L2S_D32

// ---------------------------------------------------------------------------
// Tiles of the attention kernels
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

// The warp's index, as a value the compiler knows to be the same across
// the warp (wgmma in code it takes for divergent is serialized).
__device__ __forceinline__ int warp_index() {
  return __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 5), 0);
}

// element offset of (row, col) in a swizzled f32 64 x 64 tile (two halves
// of 32 channels)
__device__ __forceinline__ int sw32(int r, int c) {
  return ((c >> 5) << 11) + (r << 5) + ((((c >> 2) & 7) ^ (r & 7)) << 2) + (c & 3);
}

// descriptor of k8 step ks of a K-major swizzled f32 tile
__device__ __forceinline__ uint64_t dsc32(const float* tile, int ks) {
  return desc_sw128(tile + ((ks >> 2) << 11) + ((ks & 3) << 3));
}

// Rows row .. row+63 of slice `slice` of a map into a swizzled tile
template <typename T>
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map, uint64_t* bar, int row,
                                         int slice) {
  tma_load_3d(dst, map, bar, 0, row, slice);
  if constexpr (sizeof(T) == 4)
    tma_load_3d(static_cast<unsigned char*>(dst) + 8192, map, bar, 32, row, slice);
}

// The dropout keep bits of query rows i0 .. i0+63 against keys j0 .. j0+63
// as 128 words, one per consumer thread of a 64 x 64 tile in the
// accumulator layout: word 32w + 4g + q holds, for rows 16w + g (bits
// 0..15) and 16w + g + 8 (bits 16..31), keys 8n + 2q + e at bit 2n + e.
// philox.cuh's counter (i, j / 4, b*h) gives the four keys of a group of
// four: keys 0, 1 belong to an even q, 2, 3 to the odd one. A producer
// warpgroup draws them, thread pt taking one row (pt % 2 selects
// g or g + 8) of the words of q = 2 qp, 2 qp + 1 for pair pt / 2 = (w, g,
// qp): eight Philox calls a tile.
__device__ __forceinline__ void keep_half(uint32_t& even, uint32_t& odd, const philox::Dropout& d,
                                          int bh, int i0, int j0, int pt) {
  const int p = pt >> 1, w = p >> 4, g = (p >> 1) & 7, qp = p & 1, rh = pt & 1;
  even = 0u;
  odd = 0u;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const uint4 r = philox::philox4x32_10(
        make_uint4((uint32_t)(i0 + 16 * w + g + 8 * rh), (uint32_t)((j0 >> 2) + 2 * n + qp),
                   (uint32_t)bh, 0u),
        d.k0, d.k1);
    even |= ((uint32_t)(r.x >= d.thresh) | ((uint32_t)(r.y >= d.thresh) << 1)) << (2 * n);
    odd |= ((uint32_t)(r.z >= d.thresh) | ((uint32_t)(r.w >= d.thresh) << 1)) << (2 * n);
  }
}

// hi in place, lo = v - hi into `lo`, over a whole f32 tile (by NTHREADS
// threads, tid 0 ..)
template <int NTHREADS = 256>
__device__ __forceinline__ void split_tile(float* hi, float* lo, int tid) {
  float4* h4 = reinterpret_cast<float4*>(hi);
  float4* l4 = reinterpret_cast<float4*>(lo);
  for (int e = tid; e < mma::kB * mma::kD / 4; e += NTHREADS) {
    float4 x = h4[e], y;
    uint32_t a, b;
    mma::split(x.x, a, b); x.x = __uint_as_float(a); y.x = __uint_as_float(b);
    mma::split(x.y, a, b); x.y = __uint_as_float(a); y.y = __uint_as_float(b);
    mma::split(x.z, a, b); x.z = __uint_as_float(a); y.z = __uint_as_float(b);
    mma::split(x.w, a, b); x.w = __uint_as_float(a); y.w = __uint_as_float(b);
    h4[e] = x;
    l4[e] = y;
  }
}

// acc (64 x 8 NT) += A B^T in 3xTF32 on wgmma: A the 64 rows of a swizzled
// tile (the warp's 16 as register fragments, split), B 8 NT rows of a tile
// split into b_hi (in place) and b_lo; four k8 steps at a time.
template <int NT>
__device__ __forceinline__ void wgmma_nt32(float (&acc)[NT][4], const float* a_tile,
                                           const float* b_hi, const float* b_lo, int w, int lane) {
  const int gq = lane >> 2, q = lane & 3, r = 16 * w + gq;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k0 = 8 * (4 * half + kk) + q;
      const uint32_t av[4] = {__float_as_uint(a_tile[sw32(r, k0)]),
                              __float_as_uint(a_tile[sw32(r + 8, k0)]),
                              __float_as_uint(a_tile[sw32(r, k0 + 4)]),
                              __float_as_uint(a_tile[sw32(r + 8, k0 + 4)])};
      mma::split4(av, ah[kk], al[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int ks = 4 * half + kk;
      wgmma_tf32_rs(acc, al[kk], dsc32(b_hi, ks));
      wgmma_tf32_rs(acc, ah[kk], dsc32(b_lo, ks));
      wgmma_tf32_rs(acc, ah[kk], dsc32(b_hi, ks));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(ah[kk]);
      fence_regs(al[kk]);
    }
  }
}

// The position term of a warpgroup's 64 query rows (Q_v: a swizzled bf16
// tile) against the 128 window rows their diagonals touch (w0: rows 0..63,
// w1: rows 64..127), G = Q_v Win^T on wgmma; warp w keeps the columns rb ..
// rb+79 (rb = 48 - 16w) that its 16 rows touch in its scratch sG (16 rows
// of kGld floats), from which mma::add_diagonal adds BD[a][j] =
// G[a][63-a+j] to the scores (q = lane % 4). Waits for every wgmma group of
// the warpgroup.
__device__ __forceinline__ void position_band(float* sG, const mma::bf16* sQv,
                                              const mma::bf16* w0, const mma::bf16* w1, int rb,
                                              int q, int lane) {
  float g0[8][4], g1[8][4];
  mma::zero<8>(g0);
  mma::zero<8>(g1);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_bf16_ss<0, 0>(g0, desc_sw128(sQv + 16 * ks), desc_sw128(w0 + 16 * ks));
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_bf16_ss<0, 0>(g1, desc_sw128(sQv + 16 * ks), desc_sw128(w1 + 16 * ks));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(g0);
  fence_acc(g1);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (8 * n >= rb) mma::store_g<mma::kGld>(sG, g0[n], 8 * n - rb + 2 * q, lane);
    if (8 * n < rb + 16) mma::store_g<mma::kGld>(sG, g1[n], 64 + 8 * n - rb + 2 * q, lane);
  }
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, reached through the runtime (the
// libraries link no libcuda); nullptr if the driver lacks it.
__host__ inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A map over `slices` stacked (rows, 64) matrices of bf16 (es = 2) or f32
// (es = 4) at `base`, read in boxes of 64 rows x 128 bytes, swizzled as
// the wgmma descriptors above expect. Rows outside [0, rows) of a slice
// read as zeros. False if the driver refuses it.
__host__ inline bool encode_rows64(CUtensorMap* map, const void* base, int es, int rows,
                                   int slices) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {64, (cuuint64_t)rows, (cuuint64_t)slices};
  const cuuint64_t strides[2] = {(cuuint64_t)64 * es, (cuuint64_t)rows * 64 * es};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / es), 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
            const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
