// Tensor-core building blocks of the bf16 attention kernels
// (rel_attention.cu, rel_attention_bwd.cu, attention.cu); fused_tail.cu
// uses the primitives (cp.async, ldmatrix, mma, packing). Not compiled on
// its own.
//
// Products run on mma.sync.m16n8k16 (bf16 in, f32 accumulate), written in
// inline PTX; operands come from shared memory by ldmatrix, or straight from
// an accumulator (the probabilities and dS as the A operand of the next
// product). Tiles arrive by 16-byte cp.async.
//
// Layouts. A block has 4 warps; warp w owns the 16 query rows 16w.. of the
// block's 64. Lane l has g = l / 4 and q = l % 4; an m16n8 f32 accumulator
// c[4] holds (row g, cols 2q, 2q+1) in c[0..1] and (row g+8, same cols) in
// c[2..3]. A bf16 tile of 64 rows x 64 channels has 128-byte rows whose
// 16-byte chunks are XOR-swizzled by the row (chunk c of row r sits at
// c ^ (r % 8)), so that ldmatrix's eight row reads and cp.async's writes hit
// distinct banks. The position-table window is a ring of three such tiles
// of 64 table rows (`Ring`): consecutive key tiles' windows overlap in 64
// rows, so each tile loads only the next 64. Key-mask flags and scores come
// from flash_tile.cuh (`load_mask`, `mask_score`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "flash_tile.cuh"

namespace mma {

constexpr int kB = 64;                 // query rows per block = keys per tile
constexpr int kD = 64;                 // head dim
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = kB * kD;         // elements of one bf16 tile
constexpr int kGld = 88;               // row stride (floats) of a warp's G scratch
constexpr int kGRows = 80;             // window rows one warp's 16 query rows touch

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// element offset of (row, col) in a swizzled 64-channel tile
__device__ __forceinline__ int swz(int row, int col) {
  return row * kD + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
}

// 16 bytes global -> shared; zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows row0 .. row0+63 of a (n_rows, 64) bf16 matrix into a swizzled tile;
// rows outside [0, n_rows) are zero.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int row0,
                                          int n_rows) {
  for (int e = threadIdx.x; e < kB * 8; e += kThreads) {
    const int r = e >> 3, c = e & 7, g = row0 + r;
    const bool ok = g >= 0 && g < n_rows;
    cp_async16(dst + r * kD + ((c ^ r) & 7) * 8, src + (size_t)(ok ? g : 0) * kD + c * 8, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a b: A 16x16 row-major, B 16x8 column-major, bf16; C f32
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Lane addresses for ldmatrix.x4 (lane = threadIdx.x % 32). A tile "[m][k]"
// has the product's rows m as its rows; "[k][m]" has them as its columns.
//   a_rows:  A fragment (rows m0.., k0..) of a [m][k] tile      (non-trans)
//   a_cols:  A fragment (rows m0.., k0..) of a [k][m] tile      (trans)
//   b_rows:  B fragments of n-tiles n0, n0+8 (k0..) of a [n][k] tile (non-trans)
//   b_cols:  B fragments of n-tiles n0, n0+8 (k0..) of a [k][n] tile (trans)
// Each returns (row, col) of the tile that the lane points at.
struct RC {
  int r, c;
};
__device__ __forceinline__ RC a_rows(int lane, int m0, int k0) {
  return {m0 + (lane & 15), k0 + ((lane >> 4) << 3)};
}
__device__ __forceinline__ RC a_cols(int lane, int m0, int k0) {
  return {k0 + (lane & 7) + ((lane >> 4) << 3), m0 + (((lane >> 3) & 1) << 3)};
}
__device__ __forceinline__ RC b_rows(int lane, int n0, int k0) {
  return {n0 + (lane & 7) + ((lane >> 4) << 3), k0 + (((lane >> 3) & 1) << 3)};
}
__device__ __forceinline__ RC b_cols(int lane, int n0, int k0) {
  return {k0 + (lane & 7) + (((lane >> 3) & 1) << 3), n0 + ((lane >> 4) << 3)};
}

__device__ __forceinline__ uint32_t tile_addr(const bf16* tile, RC rc) {
  return smem_u32(tile + swz(rc.r, rc.c));
}

// The window ring: three swizzled 64-row tiles. Window row r (0..127) of a
// tile whose window begins with chunk m lives in chunk m + r / 64 (chunk m
// holds table rows base + 64 m ..), slot (m + r / 64) mod 3.
struct Ring {
  bf16* s;
  __device__ __forceinline__ bf16* chunk(int m) const {
    return s + (((m % 3) + 3) % 3) * kTile;
  }
  __device__ __forceinline__ uint32_t addr(int m, RC rc) const {
    return smem_u32(chunk(m + (rc.r >> 6)) + swz(rc.r & 63, rc.c));
  }
};

// 16 x 64 A fragments (4 k-steps) of rows m0.. of a swizzled [m][k] tile
__device__ __forceinline__ void load_a(uint32_t a[4][4], const bf16* tile, int m0, int lane) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) ldsm_x4(a[ks], tile_addr(tile, a_rows(lane, m0, 16 * ks)));
}

// acc[n] (16 x 64) += A (16 x 64, in registers) . X^T for a [n][k] tile X
__device__ __forceinline__ void product_nt(float acc[8][4], const uint32_t a[4][4],
                                           const bf16* x, int lane) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, tile_addr(x, b_rows(lane, 16 * np, 16 * ks)));
      mma16816(acc[2 * np], a[ks], b[0], b[1]);
      mma16816(acc[2 * np + 1], a[ks], b[2], b[3]);
    }
}

// acc[n] (16 x 64) += A (16 x 16 keys, k-step kk) . X[16kk.., :] for a [k][n] tile X
__device__ __forceinline__ void product_nn_step(float acc[8][4], const uint32_t a[4],
                                                const bf16* x, int kk, int lane) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t b[4];
    ldsm_x4_t(b, tile_addr(x, b_cols(lane, 16 * np, 16 * kk)));
    mma16816(acc[2 * np], a, b[0], b[1]);
    mma16816(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// The k-step kk (keys 16kk..16kk+15) of a 16 x 64 accumulator as a bf16 A
// fragment: the m16n8 C layout of two n-tiles is the m16k16 A layout.
__device__ __forceinline__ void to_a(uint32_t a[4], const float s[8][4], int kk) {
  a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

__device__ __forceinline__ void zero(float acc[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// Position term of the warp's 16 query rows against a key tile. With window
// rows rb = 48 - 16w .. rb + 79 (the only ones its rows touch),
//   G[a][r] = q_v[16w+a] . window[rb + r]    (16 x 80, tensor cores)
// goes through the warp's f32 scratch sG (16 x kGld), and
//   BD[a][j] = q_v[16w+a] . window[63 - (16w+a) + j] = G[a][15 - a + j]
// is added to the score accumulator s straight in its m16n8 layout.
__device__ __forceinline__ void add_position_term(float s[8][4], const uint32_t qv[4][4],
                                                  const Ring& win, int m, int warp, int lane,
                                                  float* sG) {
  const int rb = 48 - 16 * warp, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int np = 0; np < kGRows / 16; ++np) {
    float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t b[4];
      ldsm_x4(b, win.addr(m, b_rows(lane, rb + 16 * np, 16 * ks)));
      mma16816(c[0], qv[ks], b[0], b[1]);
      mma16816(c[1], qv[ks], b[2], b[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 16 * np + 8 * h + 2 * q;
      *reinterpret_cast<float2*>(sG + g * kGld + col) = make_float2(c[h][0], c[h][1]);
      *reinterpret_cast<float2*>(sG + (g + 8) * kGld + col) = make_float2(c[h][2], c[h][3]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 8 * n + 2 * q + e;
      s[n][e] += sG[g * kGld + 15 - g + j];
      s[n][2 + e] += sG[(g + 8) * kGld + 7 - g + j];
    }
  __syncwarp();
}

// Dropout scales (0 or 1 / (1 - rate)) of the lane's accumulator elements
// of n-tile n: keep[0..1] row i_g (keys kj, kj+1), keep[2..3] row i_g + 8,
// with kj = j0 + 8n + 2q. philox.cuh's counter (i, j / 4, b*h) gives the
// four keys of a group of four; lanes q and q^1 hold its two halves for rows
// i_g and i_g + 8, so the even lane draws for row i_g, the odd one for row
// i_g + 8, and each passes the other the half it needs. All lanes call.
__device__ __forceinline__ void keep_frag(const philox::Dropout& d, uint32_t bh, int i_g,
                                          int kj, int q, float keep[4]) {
  const bool odd = q & 1;
  const uint4 r = philox::philox4x32_10(
      make_uint4((uint32_t)(odd ? i_g + 8 : i_g), (uint32_t)(kj >> 2), bh, 0u), d.k0, d.k1);
  const uint32_t own = odd ? ((r.z >= d.thresh) | ((r.w >= d.thresh) << 1))
                           : ((r.x >= d.thresh) | ((r.y >= d.thresh) << 1));
  const uint32_t send = odd ? ((r.x >= d.thresh) | ((r.y >= d.thresh) << 1))
                            : ((r.z >= d.thresh) | ((r.w >= d.thresh) << 1));
  const uint32_t recv = __shfl_xor_sync(0xffffffffu, send, 1);
  const uint32_t lo = odd ? recv : own, hi = odd ? own : recv;   // rows i_g, i_g + 8
  keep[0] = (lo & 1) ? d.inv_keep : 0.f;
  keep[1] = (lo & 2) ? d.inv_keep : 0.f;
  keep[2] = (hi & 1) ? d.inv_keep : 0.f;
  keep[3] = (hi & 2) ? d.inv_keep : 0.f;
}

// The lane's share of a warp's 16 x 64 accumulator as rows `row` (its g)
// and row + 8 of a (n_rows, 64) bf16 output, times mul[0] and mul[1].
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float acc[8][4],
                                           int row, int n_rows, const float mul[2], int q) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= n_rows) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + (size_t)r * kD + 8 * n + 2 * q) =
          pack_bf16(acc[n][2 * h] * mul[h], acc[n][2 * h + 1] * mul[h]);
  }
}

// True where every pointer is 16-byte aligned, as cp.async needs.
__host__ inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

}  // namespace mma
