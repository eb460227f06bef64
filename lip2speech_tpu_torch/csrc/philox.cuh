// Counter-based random bits for attention dropout, shared by the forward and
// backward kernels of both rel-position attention routes. Not compiled on
// its own.
//
// The TPU kernels seed a stateful generator per (batch*head, query block) and
// rely on the order in which they draw, which ties the mask to the tiling.
// Here the bits of element (i, j) of slice b*h are a pure function of
// (seed, b*h, i, j): Philox4x32-10 with key = the 64-bit seed and counter
// (i, j / 4, b*h, 0); word j % 4 of the result belongs to key j (hopper.cuh's
// `keep_half` maps the calls onto the accumulator fragments). Forward and
// backward agree whatever their tiles, and ops/dropout_mask.py recomputes the
// same mask with integer tensor ops.
//
// keep iff bits >= thresh, thresh = min(uint32(rate * 2^32), 2^32 - 1);
// kept probabilities are scaled by 1 / (1 - rate). thresh == 0 turns dropout
// off.

#pragma once

#include <stdint.h>

namespace philox {

struct Dropout {
  uint32_t k0, k1;     // low and high word of the seed
  uint32_t thresh;     // 0: no dropout
  float inv_keep;      // 1 / (1 - rate)
};

__host__ inline Dropout make_dropout(float rate, unsigned long long seed) {
  Dropout d;
  d.k0 = (uint32_t)(seed & 0xffffffffull);
  d.k1 = (uint32_t)(seed >> 32);
  d.thresh = 0;
  d.inv_keep = 1.f;
  if (rate > 0.f) {
    double t = (double)rate * 4294967296.0;
    d.thresh = t >= 4294967295.0 ? 0xffffffffu : (uint32_t)t;
    d.inv_keep = 1.f / (1.f - rate);
  }
  return d;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

}  // namespace philox
