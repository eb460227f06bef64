// Key-mask flags and scores of the flash-attention kernels (mma_tile.cuh and
// the kernels that include it), the constants they share, and the dropout
// generator (philox.cuh). Not compiled on its own.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace flash {

constexpr int kB = 64;        // query rows per block = keys per tile
constexpr int kD = 64;        // head dim
constexpr float kMasked = -1e30f;

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

// Masked keys score -1e30 (finite: a row with no valid key becomes a uniform
// average of V), keys past the sequence -inf (weight exactly 0).
__device__ __forceinline__ float mask_score(float score, float flag) {
  return flag > 0.f ? score : (flag == 0.f ? kMasked : -INFINITY);
}

}  // namespace flash
