// The Transformer-XL position term of the shear route, shared by
// rel_attention.cu and rel_attention_bwd.cu. Not compiled on its own.
//
// For the tile of query rows i0 .. i0+63 and keys j0 .. j0+63, element
// (a, j) reads row T-1-(i0+a)+(j0+j) of the head's (2T-1, 64) position
// table. Those are the 127 rows p0 .. p0+126 with p0 = T-1-(i0+63)+j0, and
// the element's row inside that window is 63-a+j. The window is staged in
// shared memory (rows outside the table as zeros), so the position term and
// its gradients are products read off the window, with no shear.

#pragma once

#include "flash_tile.cuh"

namespace flash {

constexpr int kWin = 2 * kB - 1;   // position-table rows one tile touches

__device__ __forceinline__ int window_start(int T_len, int i0, int j0) {
  return T_len - 1 - (i0 + kB - 1) + j0;
}

template <typename T>
__device__ __forceinline__ void load_window(float* sP, const T* __restrict__ ph, int p0,
                                            int T_len) {
  for (int e = threadIdx.x; e < kWin * kD; e += kThreads) {
    const int r = e / kD, c = e % kD, g = p0 + r;
    sP[r * kS + c] = (g >= 0 && g < 2 * T_len - 1) ? to_f(ph[(size_t)g * kD + c]) : 0.f;
  }
}

// s[a][j] = (sQu[4ty+a].sK[4tx+j] + sQv[4ty+a].sP[63-(4ty+a)+(4tx+j)]) * scale
__device__ __forceinline__ void rel_scores(const float* sQu, const float* sQv, const float* sK,
                                           const float* sP, int ty, int tx, float scale,
                                           float s[4][4]) {
  float sac[4][4], sbd[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) sac[a][j] = sbd[a][j] = 0.f;
  // window row of (row 4ty+a, key 4tx+j) is wb + (j-a+3): 7 rows for 16 diagonals
  const int wb = kB - 4 - 4 * ty + 4 * tx;
#pragma unroll 4
  for (int d = 0; d < kD; ++d) {
    float q1[4], q2[4], kk[4], pw[7];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      q1[a] = sQu[(4 * ty + a) * kS + d];
      q2[a] = sQv[(4 * ty + a) * kS + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) kk[j] = sK[(4 * tx + j) * kS + d];
#pragma unroll
    for (int w = 0; w < 7; ++w) pw[w] = sP[(wb + w) * kS + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sac[a][j] = fmaf(q1[a], kk[j], sac[a][j]);
        sbd[a][j] = fmaf(q2[a], pw[j - a + 3], sbd[a][j]);
      }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[a][j] = (sac[a][j] + sbd[a][j]) * scale;
}

// Gradient of q_v: acc[a][c] += sum_j sS[4ty+a][j] * sP[63-(4ty+a)+j][4tx+c].
// The loop runs over the diagonal w = j - a, so the four rows of a thread
// share one window row per step.
__device__ __forceinline__ void band_rows_product(const float* sS, const float* sP, int ty,
                                                  int tx, float acc[4][4]) {
  const int r0 = kB - 1 - 4 * ty;
#pragma unroll 4
  for (int w = -3; w < kB; ++w) {
    float pw[4], ds[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) pw[c] = sP[(r0 + w) * kS + 4 * tx + c];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = w + a;
      ds[a] = (j >= 0 && j < kB) ? sS[(4 * ty + a) * kS + j] : 0.f;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(ds[a], pw[c], acc[a][c]);
  }
}

// Gradient of the position table from one tile:
//   dP[p0 + r][c] += sum_a sS[a][r-63+a] * sQv[a][c],  r in [0, 127)
// Thread (ty, tx) owns window rows 8ty .. 8ty+7 and channels 4tx .. 4tx+3 and
// adds its sums into the head's f32 (2T-1, 64) gradient with atomics: other
// tiles and other batch rows add to the same table rows.
__device__ __forceinline__ void band_scatter(const float* sS, const float* sQv, int ty, int tx,
                                             float* __restrict__ dp_h, int p0, int T_len) {
  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  const int jb = 8 * ty - (kB - 1);           // key of window row 8ty at query row 0
#pragma unroll 2
  for (int a = 0; a < kB; ++a) {
    float qv[4], ds[8];
#pragma unroll
    for (int c = 0; c < 4; ++c) qv[c] = sQv[a * kS + 4 * tx + c];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = jb + r + a;
      ds[r] = (j >= 0 && j < kB) ? sS[a * kS + j] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ds[r], qv[c], acc[r][c]);
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int w = 8 * ty + r, g = p0 + w;
    if (w >= kWin || g < 0 || g >= 2 * T_len - 1) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) atomicAdd(dp_h + (size_t)g * kD + 4 * tx + c, acc[r][c]);
  }
}

}  // namespace flash
