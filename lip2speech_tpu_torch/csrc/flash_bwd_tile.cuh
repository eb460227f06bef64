// The row-dot pre-pass of the flash-attention backward kernels
// (rel_attention_bwd.cu, rel_attention_bias_bwd.cu). Not compiled on its own.
//
// The TPU backward kernels are one sequential program per (batch, head) that
// carries dK, dV (and dP) across query blocks in fast memory. On the card
// blocks run in parallel and share nothing, so each backward recomputes a
// pair's probabilities from the forward's log-sum-exp:
//
//   P    = exp(S - lse)            (0 on masked keys and on rows with no key)
//   dPr  = dO V^T  (times keep / (1 - rate) under dropout)
//   dS   = P o (dPr - D)
//   P~   = P times keep / (1 - rate)       (what multiplied V in the forward)
//
// with D[i] = sum_c dO[i, c] O[i, c], which row_dot_kernel writes first.

#pragma once

#include <cuda_bf16.h>

#include "flash_tile.cuh"

namespace flash {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

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

}  // namespace flash
