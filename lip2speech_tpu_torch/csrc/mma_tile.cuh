// Tensor-core building blocks of the bias route's attention kernels
// (rel_attention_bias.cu, rel_attention_bias_bwd.cu); fused_tail.cu, on
// wgmma, takes ldmatrix, the bf16 packing and the accumulator helpers from
// here. Not compiled on its own.
//
// bf16 products run on mma.sync.m16n8k16 (bf16 in, f32 accumulate), written
// in inline PTX; operands come from shared memory by ldmatrix, or straight
// from an accumulator (the probabilities and dS as the A operand of the
// next product). Tiles arrive by 16-byte cp.async. (The kernels on wgmma,
// rel_attention_bwd.cu and flash_fwd_hopper.cuh's forward, run their
// products through hopper.cuh; they take the accumulator-layout helpers and
// the TF32 split from here, the backward also its f32 path's mma.sync.)
//
// Layouts. A block has 4 warps; warp w owns the 16 query rows 16w.. of the
// block's 64. Lane l has g = l / 4 and q = l % 4; an m16n8 f32 accumulator
// c[4] holds (row g, cols 2q, 2q+1) in c[0..1] and (row g+8, same cols) in
// c[2..3]. A bf16 tile of 64 rows x 64 channels has 128-byte rows whose
// 16-byte chunks are XOR-swizzled by the row (chunk c of row r sits at
// c ^ (r % 8)), so that ldmatrix's eight row reads and cp.async's writes hit
// distinct banks. Key-mask flags and scores come from flash_tile.cuh
// (`load_mask`, `mask_score`).
//
// f32 products (the bias route's f32 paths, and the f32 products of the
// wgmma kernels that stay on mma.sync) run in 3xTF32 on mma.sync.m16n8k8: each operand is split
// into hi (TF32, rounded to nearest) and lo = v - hi, and a product is
// lo_a hi_b + hi_a lo_b +
// hi_a hi_b (`mma3_tiles`), f32 accumulate; what is dropped is ~2^-21 of
// |a b|. The m16n8k8 TF32 fragments of lane (g, q): A a0 (g, q), a1 (g+8,
// q), a2 (g, q+4), a3 (g+8, q+4); B b0 (k q, n g), b1 (k q+4, n g); C as
// m16n8k16's. An f32 tile holds 64 rows of 64 floats at a row stride of
// kLd32 = 68 floats: ldmatrix (b16, an 8 x 8 of it is 8 rows x 4 floats,
// lane l receiving row l / 4, float l % 4) then reads A fragments of a
// [m][k] tile and B fragments of a [n][k] tile, its eight rows on distinct
// banks (row r starts at bank 4r mod 32). There is no ldmatrix .trans for
// 32-bit elements, so a [k][n] tile as B is read by single floats. When
// its A operand is an accumulator (P, dS), lane (g, q) holds columns 2q
// and 2q+1, not q and q+4; so a k8 step takes its columns in the order 0,
// 2, 4, 6, 1, 3, 5, 7 (A column t is k 2t, column t + 4 is k 2t + 1) and
// B's rows in the same order: lane (g, q) reads B rows 2q and 2q + 1,
// which at the stride of 68 lie on banks 8q + g, all distinct. Tiles the
// kernels write themselves use the same order where it suits their
// readers. The f32 helpers take a warp's share of a tile's keys as NT n8
// tiles: all 64 keys (NT = 8) or half of them where two warps share 16
// rows (the f32 backward kernels' 8 warps).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

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
template <int NTHREADS = kThreads>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int row0,
                                          int n_rows) {
  for (int e = threadIdx.x; e < kB * 8; e += NTHREADS) {
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

// An operand tile of 64 rows: its size in elements and the element offset
// of (row, col). bf16: swizzled 64-channel rows; f32: rows of kLd32 floats.
constexpr int kLd32 = 68;
template <typename T>
struct Tile;
template <>
struct Tile<bf16> {
  static constexpr int kElems = kTile;
  static __device__ __forceinline__ int at(int r, int c) { return swz(r, c); }
};
template <>
struct Tile<float> {
  static constexpr int kElems = kB * kLd32;
  static __device__ __forceinline__ int at(int r, int c) { return r * kLd32 + c; }
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
// bias kernels on an H100). Elements outside the matrix read 0 and are not written. The
// accesses are streaming (evict-first): each element is touched once.
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

// The B fragments of n8 tiles 2np and 2np + 1 from one ldmatrix.x4, split
__device__ __forceinline__ void split_b4(const uint32_t b[4], int np, uint32_t bh[][2],
                                         uint32_t bl[][2]) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    split(__uint_as_float(b[e]), bh[2 * np + (e >> 1)][e & 1], bl[2 * np + (e >> 1)][e & 1]);
}

// The B fragments of N n8 tiles (columns 8n + g of `row`, rows 2q and 2q + 1
// of the k8 step) of a [k][n] tile by single floats, split
template <int N>
__device__ __forceinline__ void load_b_cols(uint32_t bh[][2], uint32_t bl[][2], const float* row) {
#pragma unroll
  for (int n = 0; n < N; ++n) split_b(row[8 * n], row[kLd32 + 8 * n], bh[n], bl[n]);
}

// Rows row0 .. row0+ROWS-1 of a (n_rows, 64) f32 matrix into an f32 tile;
// rows outside [0, n_rows) are zero.
template <int NTHREADS = kThreads, int ROWS = kB>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int row0,
                                          int n_rows) {
  for (int e = threadIdx.x; e < ROWS * 16; e += NTHREADS) {
    const int r = e >> 4, c = e & 15, g = row0 + r;
    const bool ok = g >= 0 && g < n_rows;
    cp_async16(dst + r * kLd32 + 4 * c, src + (size_t)(ok ? g : 0) * kD + 4 * c, ok);
  }
}

// ldmatrix lane addresses in an f32 tile: the A fragment (rows m0.., k0..k0+7)
// of a [m][k] tile; the B fragments of n-tiles n0 and n0 + 8 (k0..k0+7) of a
// [n][k] tile, b0 b1 of n0 in r[0..1] and of n0 + 8 in r[2..3].
__device__ __forceinline__ RC a32_rows(int lane, int m0, int k0) {
  return {m0 + (lane & 15), k0 + ((lane >> 4) << 2)};
}
__device__ __forceinline__ RC b32_rows(int lane, int n0, int k0) {
  return {n0 + (lane & 7) + ((lane >> 4) << 3), k0 + (((lane >> 3) & 1) << 2)};
}

// The warp's 16 rows (m0..) of a 64-wide [m][k] operand tile as the A of
// products, held in registers: bf16 fragments (16 registers); f32 values (32
// registers), split at each use (hi and lo held would take 64).
template <typename T>
struct RowsA;
template <>
struct RowsA<bf16> {
  uint32_t a[4][4];
  __device__ __forceinline__ void init(const bf16* tile, int m0, int lane) {
    load_a(a, tile, m0, lane);
  }
};
template <>
struct RowsA<float> {
  uint32_t a[8][4];
  __device__ __forceinline__ void init(const float* tile, int m0, int lane) {
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const RC rc = a32_rows(lane, m0, 8 * ks);
      ldsm_x4(a[ks], smem_u32(tile + Tile<float>::at(rc.r, rc.c)));
    }
  }
  // k8 step ks, split
  __device__ __forceinline__ void frag(int ks, int, uint32_t ah[4], uint32_t al[4]) const {
    split4(a[ks], ah, al);
  }
};

// The same f32 rows read from their tile and split at each use, where the
// registers are short (the backward passes).
struct TileRowsA {
  const float* tile;
  int m0;
  __device__ __forceinline__ void init(const float* t, int m, int) {
    tile = t;
    m0 = m;
  }
  __device__ __forceinline__ void frag(int ks, int lane, uint32_t ah[4], uint32_t al[4]) const {
    const RC rc = a32_rows(lane, m0, 8 * ks);
    uint32_t a[4];
    ldsm_x4(a, smem_u32(tile + Tile<float>::at(rc.r, rc.c)));
    split4(a, ah, al);
  }
};

// Rows as the backward passes take them: bf16 held, f32 read from the tile.
template <typename T>
using PassRowsA = std::conditional_t<sizeof(T) == 2, RowsA<bf16>, TileRowsA>;

template <int NT = 8>
__device__ __forceinline__ void product_nt(float acc[][4], const RowsA<bf16>& a, const bf16* x,
                                           int lane) {
  static_assert(NT == 8, "bf16: a warp's rows against the whole tile");
  product_nt(acc, a.a, x, lane);
}

// acc[n] (16 x 8 NT) += A (16 x 64: RowsA<float> or TileRowsA) . X^T for
// the 8 NT rows of a [n][k] f32 tile at X
template <int NT = 8, class A>
__device__ __forceinline__ void product_nt(float acc[][4], const A& a, const float* x, int lane) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
    a.frag(ks, lane, ah, al);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      const RC rc = b32_rows(lane, 16 * np, 8 * ks);
      uint32_t b[4];
      ldsm_x4(b, smem_u32(x + Tile<float>::at(rc.r, rc.c)));
      split_b4(b, np, bh, bl);
    }
    mma3_tiles<NT>(acc, ah, al, bh, bl);
  }
}

// acc (16 x 64) += P . X: P the warp's 16 x 8 NK accumulator (its columns
// the k of the product), X the NK k8 steps of a [k][n] tile from its row x.
__device__ __forceinline__ void product_acc_nn(float acc[8][4], const float p[8][4],
                                               const bf16* x, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    to_a(a, p, kk);
    product_nn_step(acc, a, x, kk, lane);
  }
}

template <int NK = 8>
__device__ __forceinline__ void product_acc_nn(float acc[8][4], const float p[][4],
                                               const float* x, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const uint32_t av[4] = {__float_as_uint(p[kk][0]), __float_as_uint(p[kk][2]),
                            __float_as_uint(p[kk][1]), __float_as_uint(p[kk][3])};
    uint32_t ah[4], al[4], bh[8][2], bl[8][2];
    split4(av, ah, al);
    load_b_cols<8>(bh, bl, x + (8 * kk + 2 * q) * kLd32 + g);   // k rows 2q, 2q + 1 of the step
    mma3_tiles<8>(acc, ah, al, bh, bl);
  }
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

// The key-major backward's transposed products (rel_attention_bias_bwd.cu;
// rel_attention_bwd.cu's f32 path): P~ and dS of a query tile against the
// block's 64 keys go to tiles, and the warps of keys 16w.. then take dV +=
// P~^T dO and dK += dS^T Q_u over the tile's 64 query rows (f32: channels
// 32 cc ..).
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

// dV += P~^T dO, dK += dS^T Q_u over the 64 query rows, for keys 16w ..
// (f32: and channels 32 cc ..)
__device__ __forceinline__ void key_products(float dv[8][4], float dk[8][4], const bf16* sPd,
                                             const bf16* sdS, const bf16* sdO, const bf16* sQu,
                                             int w, int, int lane) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t a[4];
    ldsm_x4_t(a, tile_addr(sPd, a_cols(lane, 16 * w, 16 * ks)));
    product_nn_step(dv, a, sdO, ks, lane);
    ldsm_x4_t(a, tile_addr(sdS, a_cols(lane, 16 * w, 16 * ks)));
    product_nn_step(dk, a, sQu, ks, lane);
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

__device__ __forceinline__ void key_products(float dv[4][4], float dk[4][4], const float* sPd,
                                             const float* sdS, const float* sdO,
                                             const float* sQu, int w, int cc, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll 2
  for (int ks = 0; ks < 8; ++ks) {
    // query rows 2q, 2q + 1 of the step, channels 32 cc ..
    const int row = (8 * ks + 2 * q) * kLd32 + 32 * cc + g;
    uint32_t ah[4], al[4], bh[4][2], bl[4][2];
    key_rows_a(sPd, w, 8 * ks, lane, ah, al);
    load_b_cols<4>(bh, bl, sdO + row);
    mma3_tiles<4>(dv, ah, al, bh, bl);
    key_rows_a(sdS, w, 8 * ks, lane, ah, al);
    load_b_cols<4>(bh, bl, sQu + row);
    mma3_tiles<4>(dk, ah, al, bh, bl);
  }
}

// True where every pointer is 16-byte aligned, as cp.async needs.
__host__ inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

}  // namespace mma
