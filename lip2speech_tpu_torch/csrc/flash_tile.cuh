// The constants that the flash-attention kernels share (tile sizes, a
// masked key's score) and the dropout generator (philox.cuh). Not compiled
// on its own.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace flash {

constexpr int kB = 64;        // query rows per block = keys per tile
constexpr int kD = 64;        // head dim
// Masked keys score -1e30 (finite: a row with no valid key becomes a uniform
// average of V), keys past the sequence -inf (weight exactly 0).
constexpr float kMasked = -1e30f;

}  // namespace flash
