// Warp-level building blocks of the kernels on wgmma (hopper.cuh includes
// this): the m16n8 accumulator layout that a wgmma accumulator shares warp
// by warp, the bf16 packing of an accumulator as an A operand, stores and
// reductions from it, the bias route's f32 (T, T) tiles read and written in
// that layout, and the f32 path of the two key-major backward kernels
// (rel_attention_bwd.cu, rel_attention_bias_bwd.cu), whose products that
// reduce over queries or keys stay on mma.sync m16n8k8 in 3xTF32;
// fused_tail.cu takes ldmatrix and the bf16 packing. Not compiled on its own.
//
// Layouts. Warp w owns the 16 rows 16w.. of a 64-row tile. Lane l has g =
// l / 4 and q = l % 4; an m16n8 f32 accumulator c[4] holds (row g, cols 2q,
// 2q+1) in c[0..1] and (row g+8, same cols) in c[2..3]. A bf16 tile of 64
// rows x 64 channels has 128-byte rows whose 16-byte chunks are XOR-swizzled
// by the row (chunk c of row r sits at c ^ (r % 8)), as TMA's 128-byte
// swizzle writes them.
//
// f32 products in 3xTF32 on mma.sync.m16n8k8: each operand is split into hi
// (TF32, rounded to nearest) and lo = v - hi, and a product is lo_a hi_b +
// hi_a lo_b + hi_a hi_b (`mma3_tiles`), f32 accumulate; what is dropped is
// ~2^-21 of |a b|. The m16n8k8 TF32 fragments of lane (g, q): A a0 (g, q),
// a1 (g+8, q), a2 (g, q+4), a3 (g+8, q+4); B b0 (k q, n g), b1 (k q+4, n
// g); C as m16n8k16's. When its A operand is an accumulator (P, dS), lane
// (g, q) holds columns 2q and 2q+1, not q and q+4; so a k8 step takes its
// columns in the order 0, 2, 4, 6, 1, 3, 5, 7 (A column t is k 2t, column
// t + 4 is k 2t + 1) and B's rows in the same order: lane (g, q) reads B
// rows 2q and 2q + 1. The f32 helpers take a warp's share of a tile's keys
// as NT n8 tiles.

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
constexpr int kTile = kB * kD;         // elements of one bf16 tile
constexpr int kGld = 88;               // row stride (floats) of a warp's G scratch
constexpr int kGRows = 80;             // window rows one warp's 16 query rows touch

using bf16 = __nv_bfloat16;

// element offset of (row, col) in a swizzled 64-channel tile
__device__ __forceinline__ int swz(int row, int col) {
  return row * kD + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The k-step kk (keys 16kk..16kk+15) of a 16 x 64 accumulator as a bf16 A
// fragment: the m16n8 C layout of two n-tiles is the m16k16 A layout.
__device__ __forceinline__ void to_a(uint32_t a[4], const float s[8][4], int kk) {
  a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

template <int NT = 8>
__device__ __forceinline__ void zero(float acc[][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// Position term of a warp's 16 query rows (16w..) against its keys of a key
// tile (kw.., 8 NT of them: the whole tile, or half of it where two warps
// share the rows). With window rows rb = 48 - 16w + kw .. rb + 15 + 8 NT
// (the only ones they touch),
//   G[a][r] = q_v[16w+a] . window[rb + r]    (16 x (16 + 8 NT), tensor cores)
// goes through the warp's f32 scratch sG (16 rows of LD floats), and
//   BD[a][j] = q_v[16w+a] . window[63 - (16w+a) + kw + j] = G[a][15 - a + j]
// is added to the score accumulator s straight in its m16n8 layout.
template <int LD = kGld>
__device__ __forceinline__ void store_g(float* sG, const float c[4], int col, int lane) {
  const int g = lane >> 2;
  *reinterpret_cast<float2*>(sG + g * LD + col) = make_float2(c[0], c[1]);
  *reinterpret_cast<float2*>(sG + (g + 8) * LD + col) = make_float2(c[2], c[3]);
}

template <int NT = 8, int LD = kGld>
__device__ __forceinline__ void add_diagonal(float s[][4], const float* sG, int lane) {
  const int g = lane >> 2, q = lane & 3;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 8 * n + 2 * q + e;
      s[n][e] += sG[g * LD + 15 - g + j];
      s[n][2 + e] += sG[(g + 8) * LD + 7 - g + j];
    }
  __syncwarp();
}

// The lane's share of a warp's 16 x 64 accumulator as rows `row` (its g)
// and row + 8 of a (n_rows, 64) bf16 output, times mul[0] and mul[1].
template <int NT = 8>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float acc[][4],
                                           int row, int n_rows, const float mul[2], int q) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= n_rows) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(dst + (size_t)r * kD + 8 * n + 2 * q) =
          pack_bf16(acc[n][2 * h] * mul[h], acc[n][2 * h + 1] * mul[h]);
  }
}

// An f32 (n_rows, n_cols) matrix of row stride ld (the bias or dbias of one
// (batch, head)) read or written straight in the m16n8 accumulator layout of
// a warp's 16 x 8 NT tile: lane (g, q) holds row i_g (its g) in c[n][0..1] and
// row i_g + 8 in c[n][2..3], columns j0 + 8n + 2q and + 1. A quad of lanes
// covers 8 adjacent floats of a row, one 32-byte sector. kVec2: float2
// accesses, which need an even ld and 8-byte aligned rows; else single
// floats, twice the instructions for the same sectors (10-16% slower in the
// bias kernels on mma.sync on an H100). Elements outside the matrix read 0
// and are not written. The accesses are streaming (evict-first): each
// element is touched once.
template <bool kVec2, int NT = 8>
__device__ __forceinline__ void load_frag_f32(float c[][4], const float* __restrict__ src, int ld,
                                              int i_g, int j0, int n_rows, int n_cols, int q) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = i_g + 8 * h;
    const float* row = src + (size_t)(r < n_rows ? r : 0) * ld;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int j = j0 + 8 * n + 2 * q;
      if (kVec2) {
        float2 x = make_float2(0.f, 0.f);
        if (r < n_rows && j < n_cols) x = __ldcs(reinterpret_cast<const float2*>(row + j));
        c[n][2 * h] = x.x;
        c[n][2 * h + 1] = x.y;
      } else {
        c[n][2 * h] = r < n_rows && j < n_cols ? __ldcs(row + j) : 0.f;
        c[n][2 * h + 1] = r < n_rows && j + 1 < n_cols ? __ldcs(row + j + 1) : 0.f;
      }
    }
  }
}

template <bool kVec2, int NT = 8>
__device__ __forceinline__ void store_frag_f32(float* __restrict__ dst, const float c[][4], int ld,
                                               int i_g, int j0, int n_rows, int n_cols, int q) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = i_g + 8 * h;
    if (r >= n_rows) continue;
    float* row = dst + (size_t)r * ld;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int j = j0 + 8 * n + 2 * q;
      if (kVec2) {
        if (j < n_cols)
          __stcs(reinterpret_cast<float2*>(row + j), make_float2(c[n][2 * h], c[n][2 * h + 1]));
      } else {
        if (j < n_cols) __stcs(row + j, c[n][2 * h]);
        if (j + 1 < n_cols) __stcs(row + j + 1, c[n][2 * h + 1]);
      }
    }
  }
}

// Adds a warp's 16 x 64 f32 accumulator to rows row0 + g and row0 + g + 8
// of an (n_rows, 64) f32 matrix, four floats per atomic: lanes q and q^1
// swap halves so that the even one holds four consecutive floats of row g
// and the odd one of row g + 8. Rows outside [0, n_rows) are skipped.
template <int NT = 8>
__device__ __forceinline__ void red_add_rows(const float c[][4], float* __restrict__ dst,
                                             int row0, int n_rows, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const bool odd = q & 1;
  const int row = row0 + g + (odd ? 8 : 0);
  const bool ok = row >= 0 && row < n_rows;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float r0 = __shfl_xor_sync(0xffffffffu, odd ? c[n][0] : c[n][2], 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, odd ? c[n][1] : c[n][3], 1);
    const float4 val = odd ? make_float4(r0, r1, c[n][2], c[n][3])
                           : make_float4(c[n][0], c[n][1], r0, r1);
    if (ok) atomicAdd(reinterpret_cast<float4*>(dst + (size_t)row * kD + 8 * n + 2 * (q & 2)), val);
  }
}

// ---------------------------------------------------------------------------
// f32 operands: 3xTF32 on mma.sync m16n8k8 (layouts in the header comment)
// ---------------------------------------------------------------------------

// v = hi + lo exactly: hi is v rounded to TF32 (to nearest, ties away, as
// cvt.rna.tf32.f32 rounds: an integer add of half a TF32 ulp and a mask,
// 2 instructions where the cvt compiles to 4 with its NaN guard), lo = v -
// hi is an f32 value of at most 2^-11 |v|, which the tensor core reads
// truncated to TF32 (~2^-21 |v| lost).
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(const uint32_t v[4], uint32_t hi[4], uint32_t lo[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(__uint_as_float(v[e]), hi[e], lo[e]);
}

// c += a b: A 16x8 row-major, B 8x8 column-major, TF32; C f32. Not volatile,
// so that the compiler may interleave the products of independent tiles.
__device__ __forceinline__ void mma1688(float c[4], const uint32_t a[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragment (b0, b1) from two floats, split
__device__ __forceinline__ void split_b(float b0, float b1, uint32_t bh[2], uint32_t bl[2]) {
  split(b0, bh[0], bl[0]);
  split(b1, bh[1], bl[1]);
}

// c[n] += A B_n for the N n8 tiles of a k8 step in 3xTF32, the small terms
// first (lo_a hi_b, hi_a lo_b, then hi_a hi_b), term by term over the tiles
// so that consecutive mma.sync write different accumulators
template <int N>
__device__ __forceinline__ void mma3_tiles(float c[][4], const uint32_t ah[4],
                                           const uint32_t al[4], const uint32_t bh[][2],
                                           const uint32_t bl[][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma1688(c[n], al, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma1688(c[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma1688(c[n], ah, bh[n][0], bh[n][1]);
}

// The lane's share of a warp's 16 x 8 NT accumulator as rows `row` (its g)
// and row + 8 of a (n_rows, 64) f32 output (dst: the first column), times
// mul[0] and mul[1].
template <int NT = 8>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float acc[][4],
                                           int row, int n_rows, const float mul[2], int q) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= n_rows) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(dst + (size_t)r * kD + 8 * n + 2 * q) =
          make_float2(acc[n][2 * h] * mul[h], acc[n][2 * h + 1] * mul[h]);
  }
}

// The key-major backwards' pair tiles: P~ and dS of a query tile against
// the block's 64 keys, bf16 as [query][key] swizzled tiles (wgmma operands),
// f32 transposed, [key][query] at a row stride of kPtLd, from which the
// warps of keys 16w.. take dV += P~^T dO and dK += dS^T Q_u on mma.sync.
constexpr int kPtLd = 72;    // row stride of the f32 P~^T and dS^T tiles

// n8 tile n of the warp's P~ or dS (rows 16w.., keys kw..) into the pair's
// tile: bf16 [query][key] (swizzled), f32 transposed, [key][query] at a row
// stride of kPtLd.
__device__ __forceinline__ void store_pair_tile(bf16* dst, const float c[4], int w, int, int n,
                                                int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
    *reinterpret_cast<uint32_t*>(dst + swz(16 * w + (lane >> 2) + 8 * h, 8 * n + 2 * (lane & 3))) =
        pack_bf16(c[2 * h], c[2 * h + 1]);
}

__device__ __forceinline__ void store_pair_tile(float* dst, const float c[4], int w, int kw, int n,
                                                int lane) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    dst[(kw + 8 * n + 2 * (lane & 3) + (e & 1)) * kPtLd + 16 * w + (lane >> 2) + 8 * (e >> 1)] = c[e];
}

// P~ and dS of the warp's rows and keys (NT n8 tiles) into the pair's tiles
template <int NT, typename T>
__device__ __forceinline__ void store_pair(T* sPd, T* sdS, const float pd[][4], const float ds[][4],
                                           int w, int kw, int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    store_pair_tile(sPd, pd[n], w, kw, n, lane);
    store_pair_tile(sdS, ds[n], w, kw, n, lane);
  }
}

// The A of the warp's 16 keys x queries k0 + 2q, k0 + 2q + 1 (k8 order) of
// a transposed f32 tile, split.
__device__ __forceinline__ void key_rows_a(const float* tile, int w, int k0, int lane,
                                           uint32_t ah[4], uint32_t al[4]) {
  const float* r = tile + (16 * w + (lane >> 2)) * kPtLd + k0 + 2 * (lane & 3);
  const float2 x0 = *reinterpret_cast<const float2*>(r);
  const float2 x1 = *reinterpret_cast<const float2*>(r + 8 * kPtLd);
  const uint32_t av[4] = {__float_as_uint(x0.x), __float_as_uint(x1.x), __float_as_uint(x0.y),
                          __float_as_uint(x1.y)};
  split4(av, ah, al);
}

// True where every pointer is 16-byte aligned, as TMA needs.
__host__ inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

}  // namespace mma
