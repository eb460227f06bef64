// Building blocks of the flash-attention backward kernels: the row-dot
// pre-pass of rel_attention_bwd.cu and rel_attention_bias_bwd.cu, and the
// FMA blocks of rel_attention_bias_bwd.cu's f32 path. Not compiled on its
// own.
//
// The TPU backward kernels are one sequential program per (batch, head) that
// carries dK, dV (and dP) across query blocks in fast memory. On the card
// blocks run in parallel and share nothing, so the backward is two passes
// over the same (query tile, key tile) pairs, each recomputing the pair's
// probabilities from the forward's log-sum-exp:
//
//   query pass  one block per (b*h, query tile), loop over key tiles:
//               dQ_u (and, in the shear route, dQ_v and dP; in the bias
//               route, dbias) accumulate in registers;
//   key pass    one block per (b*h, key tile), loop over query tiles:
//               dK and dV accumulate in registers.
//
// Before both, row_dot_kernel writes D[i] = sum_c dO[i, c] O[i, c]. Per pair
//
//   P    = exp(S - lse)            (0 on masked keys and on rows with no key)
//   dPr  = dO V^T  (times keep / (1 - rate) under dropout)
//   dS   = P o (dPr - D)
//   P~   = P times keep / (1 - rate)       (what multiplied V in the forward)
//
// Threads keep the forward's layout: thread (ty, tx) owns query rows 4ty..
// and keys 4tx.. of the pair. dS and P~ go through shared tiles for the
// products that follow. All arithmetic is f32.

#pragma once

#include "flash_tile.cuh"

namespace flash {

// delta[r] = sum_c d_o[r, c] * o[r, c] over rows of 64; half a warp per row.
// T is the input type, float or bf16.
template <typename T>
__global__ void __launch_bounds__(kThreads)
row_dot_kernel(const T* __restrict__ o, const T* __restrict__ d_o, float* __restrict__ delta,
               size_t n_rows) {
  const size_t r = (size_t)blockIdx.x * (kThreads / 16) + (threadIdx.x >> 4);
  const int tx = threadIdx.x & 15;
  float acc = 0.f;
  if (r < n_rows) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      acc += to_f(o[r * kD + 4 * tx + c]) * to_f(d_o[r * kD + 4 * tx + c]);
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < n_rows && tx == 0) delta[r] = acc;
}

template <typename T>
cudaError_t launch_row_dot(const void* o, const void* d_o, float* delta, size_t n_rows,
                           cudaStream_t stream) {
  const size_t rows_per_block = kThreads / 16;
  row_dot_kernel<T><<<(unsigned)((n_rows + rows_per_block - 1) / rows_per_block), kThreads, 0,
                      stream>>>(static_cast<const T*>(o), static_cast<const T*>(d_o), delta,
                                n_rows);
  return cudaGetLastError();
}

// Log-sum-exp and D of the thread's four query rows; rows past the sequence
// get lse = -inf, which makes their probabilities 0.
__device__ __forceinline__ void load_row_stats(const float* __restrict__ lse_bh,
                                               const float* __restrict__ delta_bh, int i0,
                                               int T_len, int ty, float lse[4],
                                               float delta[4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + 4 * ty + a;
    lse[a] = i < T_len ? lse_bh[i] : -INFINITY;
    delta[a] = i < T_len ? delta_bh[i] : 0.f;
  }
}

// From the pair's scaled scores s (mask not applied), dpr = dO V^T and the
// dropout scale: ds = P o (dpr * keep - D), unscaled, and pd = P * keep.
// Rows whose lse is below -1e30 / 2 had no valid key in the forward and get
// no gradient, as in the TPU kernel.
__device__ __forceinline__ void backward_tile(const float s[4][4], const float* sM, int tx,
                                              const float lse[4], const float delta[4],
                                              const float keep[4][4], const float dpr[4][4],
                                              float ds[4][4], float pd[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const bool row_ok = lse[a] > 0.5f * kMasked;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float prob = (row_ok && sM[4 * tx + j] > 0.f) ? expf(s[a][j] - lse[a]) : 0.f;
      pd[a][j] = prob * keep[a][j];
      ds[a][j] = prob * (dpr[a][j] * keep[a][j] - delta[a]);
    }
  }
}

// acc[j][c] += sum_a sS[a][4ty+j] * sX[a][4tx+c]: the transposed tile times
// the query-side rows; the thread owns keys 4ty.. and channels 4tx...
__device__ __forceinline__ void cols_product(const float* sS, const float* sX, int ty, int tx,
                                             float acc[4][4]) {
#pragma unroll 4
  for (int a = 0; a < kB; ++a) {
    float sj[4], xx[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) sj[j] = sS[a * kS + 4 * ty + j];
#pragma unroll
    for (int c = 0; c < 4; ++c) xx[c] = sX[a * kS + 4 * tx + c];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = fmaf(sj[j], xx[c], acc[j][c]);
  }
}

__device__ __forceinline__ void zero_tile(float acc[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
}

// Rows r0+4ty.. and channels 4tx.. of a (n_rows, 64) gradient.
__device__ __forceinline__ void write_grad(float* __restrict__ dst, int r0, int n_rows, int ty,
                                           int tx, const float acc[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + 4 * ty + a;
    if (r >= n_rows) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) dst[(size_t)r * kD + 4 * tx + c] = acc[a][c];
  }
}

}  // namespace flash
