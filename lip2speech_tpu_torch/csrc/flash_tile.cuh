// Building blocks of the FMA flash-attention kernels (the f32 paths of
// attention.cu and rel_attention_bias.cu and, through flash_bwd_tile.cuh, of
// rel_attention_bias_bwd.cu); the tensor-core kernels (mma_tile.cuh) take
// the key-mask flags and scores from here. Not compiled on its own.
//
// A block of 256 threads owns 64 query rows of one (batch, head) and walks
// over key tiles of 64. Thread (ty, tx) = (tid / 16, tid % 16) owns the 4x4
// score tile of rows 4ty.. and keys 4tx.., and the 4x4 output tile of rows
// 4ty.. and channels 4tx... The 16 threads that share a row group are half a
// warp, so row maxima and row sums are four xor-shuffles. Shared tiles are
// f32 with a padded stride (65); inputs, outputs and all arithmetic are f32
// (the other paths run on the tensor cores, mma_tile.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace flash {

constexpr int kB = 64;        // query rows per block = keys per tile
constexpr int kD = 64;        // head dim
constexpr int kS = kD + 1;    // padded shared-memory row stride
constexpr int kThreads = 256;
constexpr float kMasked = -1e30f;
// Q, K (then the probabilities), V tiles and the key tile's mask flags
constexpr size_t kSmemBytes = ((size_t)3 * kB * kS + kB) * sizeof(float);

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// Running softmax state of a thread's four rows and its 4x4 output tile.
struct State {
  float m[4], l[4], acc[4][4];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      m[a] = -INFINITY;
      l[a] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
    }
  }
};

// Rows row0 .. row0+63 of a (n_rows, 64) matrix into a shared tile; rows
// past n_rows are zero.
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int row0,
                                          int n_rows) {
  for (int e = threadIdx.x; e < kB * kD; e += kThreads) {
    const int r = e / kD, c = e % kD, g = row0 + r;
    dst[r * kS + c] = g < n_rows ? src[(size_t)g * kD + c] : 0.f;
  }
}

// Mask flags of keys j0 .. j0+63: 1 valid, 0 masked, -1 past the sequence.
// mask_row is the batch row's (T,) uint8 key mask, or nullptr for all valid.
__device__ __forceinline__ void load_mask(float* sM, const uint8_t* __restrict__ mask_row,
                                          int j0, int T_len) {
  if (threadIdx.x < kB) {
    const int j = j0 + threadIdx.x;
    sM[threadIdx.x] =
        j < T_len ? ((mask_row == nullptr || mask_row[j]) ? 1.f : 0.f) : -1.f;
  }
}

// s[a][j] = sQ[4ty+a] . sK[4tx+j]
__device__ __forceinline__ void qk_product(const float* sQ, const float* sK, int ty, int tx,
                                           float s[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[a][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kD; ++d) {
    float qq[4], kk[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) qq[a] = sQ[(4 * ty + a) * kS + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) kk[j] = sK[(4 * tx + j) * kS + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] = fmaf(qq[a], kk[j], s[a][j]);
  }
}

// Masked keys score -1e30 (finite: a row with no valid key becomes a uniform
// average of V), keys past the sequence -inf (weight exactly 0).
__device__ __forceinline__ float mask_score(float score, float flag) {
  return flag > 0.f ? score : (flag == 0.f ? kMasked : -INFINITY);
}

// One online-softmax step over a key tile: s holds the tile's masked scores
// on entry and its unnormalised probabilities exp(s - m_new) on exit; the
// running maximum, sum and accumulator are rescaled. Every key tile holds at
// least one key inside the sequence, so m_new is finite.
__device__ __forceinline__ void softmax_step(float s[4][4], State& st) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float mx = fmaxf(fmaxf(s[a][0], s[a][1]), fmaxf(s[a][2], s[a][3]));
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(st.m[a], mx);
    const float alpha = expf(st.m[a] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[a][j] = expf(s[a][j] - m_new);
      rs += s[a][j];
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
    st.l[a] = st.l[a] * alpha + rs;
    st.m[a] = m_new;
#pragma unroll
    for (int c = 0; c < 4; ++c) st.acc[a][c] *= alpha;
  }
}

// The thread's 4x4 tile into a shared 64x64 tile (rows 4ty.., columns 4tx..).
__device__ __forceinline__ void store_tile(float* sS, int ty, int tx, const float s[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) sS[(4 * ty + a) * kS + 4 * tx + j] = s[a][j];
}

// acc[a][c] += sum_j sS[4ty+a][j] * sX[j][4tx+c]
__device__ __forceinline__ void rows_product(const float* sS, const float* sX, int ty, int tx,
                                             float acc[4][4]) {
#pragma unroll 4
  for (int j = 0; j < kB; ++j) {
    float pa[4], vv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) pa[a] = sS[(4 * ty + a) * kS + j];
#pragma unroll
    for (int c = 0; c < 4; ++c) vv[c] = sX[j * kS + 4 * tx + c];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(pa[a], vv[c], acc[a][c]);
  }
}

// Dropout scale (0 or 1 / (1 - rate); 1 without dropout) of the thread's 4x4
// tile of query rows i0+4ty.. and keys j0+4tx.. in slice bh; j0 is a
// multiple of 4.
__device__ __forceinline__ void keep_tile(const philox::Dropout& drop, int bh, int i0, int j0,
                                          int ty, int tx, float keep[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
    philox::keep_scale4(drop, (uint32_t)bh, (uint32_t)(i0 + 4 * ty + a),
                        (uint32_t)((j0 + 4 * tx) >> 2), keep[a]);
}

// acc += P V for one key tile. The probabilities go through the key tile's
// shared buffer (sK), so every thread must have finished reading the keys:
// the function synchronises the block before and after writing them.
__device__ __forceinline__ void pv_product(float* sK, const float* sV, int ty, int tx,
                                           const float s[4][4], State& st) {
  __syncthreads();
  store_tile(sK, ty, tx, s);
  __syncthreads();
  rows_product(sK, sV, ty, tx, st.acc);
}

// The same under dropout: the running sum has seen the undropped
// probabilities; only the product with V sees keep / (1 - rate).
__device__ __forceinline__ void pv_product_dropout(float* sK, const float* sV, int ty, int tx,
                                                   float s[4][4], State& st,
                                                   const philox::Dropout& drop, int bh, int i0,
                                                   int j0) {
  if (drop.thresh != 0u) {
    float keep[4][4];
    keep_tile(drop, bh, i0, j0, ty, tx, keep);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] *= keep[a][j];
  }
  pv_product(sK, sV, ty, tx, s, st);
}

// O = acc / max(l, 1e-20) for the thread's rows inside the sequence; with
// lse != nullptr also the row's log-sum-exp m + log(max(l, 1e-20)).
__device__ __forceinline__ void write_out(float* __restrict__ out, float* __restrict__ lse,
                                          int i0, int T_len, int ty, int tx, const State& st) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + 4 * ty + a;
    if (i >= T_len) continue;
    const float l = fmaxf(st.l[a], 1e-20f);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      out[(size_t)i * kD + 4 * tx + c] = st.acc[a][c] / l;
    if (lse != nullptr && tx == 0) lse[i] = st.m[a] + logf(l);
  }
}

}  // namespace flash
