// Fused HiFi-GAN resblock trio, forward, for Hopper (sm_90a).
//
// Replaces: lip2speech_tpu/ops/pallas_fused_tail.py, `_fused_forward`'s
// inner `kernel` (entry `fused_resblock_trio`).
//
// Computes, for x (B, C, M) in PyTorch's conv layout, the mean over n_res
// ResBlock1 modules of the chain
//     xb = x; per dilation d: xb += conv2(lrelu(conv1_d(lrelu(xb))))
// with every conv output outside the true sequence [0, M) set to zero, the
// bias added after the cast to the activation dtype, and the sum divided by
// n_res. One thread block owns one (row tile, batch item): it loads the tile
// plus a halo of H rows on each side (H = the largest sum of a resblock's
// conv paddings, 60 at kernels 3/7/11 x dilations 1/3/5, passed in from
// branch_paddings) and runs all convs out of shared memory; only the tile is
// written back.
//
// What bounds it: the 126 C^2 multiply-adds per row of a default trio (about
// 594 GFLOP for the four stages of a batch of 4 x 240 frames) against a few
// bytes per row of traffic: operations, far above the card's ridge point.
//
// What the design does about it:
//  * Shared memory holds just two activation buffers: the running residual
//    xb and the activated conv1 output xt = lrelu(conv1(lrelu(xb))). The
//    weights stay in global memory (L2-resident, (K, Cin, Cout) per conv)
//    and the cross-resblock sum accumulates in the output tile itself, so
//    the tile can be a few hundred rows and the 2H-row halo costs little.
//  * Each conv computes only the rows the rest of its chain still needs:
//    the region shrinks by the conv's padding at every step.
//  * bf16: tensor cores through WMMA (16x16x16 bf16 -> f32). Activations sit
//    row-major in shared memory with a row stride of C+16 elements, so any
//    row shift of a dilated tap is a legal 32-byte-aligned fragment load and
//    rows fall on different banks. Each warp keeps 8 accumulator fragments
//    (up to 2 x 4 16x16 tiles), reusing each weight fragment across its row
//    tiles; lrelu is applied to the loaded fragments.
//  * f32: exact FP32 FMAs on the CUDA cores (tensor cores would round to
//    TF32). Activations sit channel-major ([C][rows]) so a warp reads 32
//    consecutive rows without bank conflicts at any tap shift; each thread
//    holds a 4-row x 16-channel register tile fed by warp-uniform weight
//    reads.
// Staging weights in shared memory (TMA) and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kMaxRes = 4;
constexpr int kMaxDil = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kSlope = 0.1f;

struct TrioGeom {
  int n_res, n_dil, halo;
  int k[kMaxRes];
  int dil[kMaxRes * kMaxDil];
  int pad1[kMaxRes * kMaxDil];
  int pad2[kMaxRes * kMaxDil];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// value rounded to the activation dtype, as a float
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}

// leaky ReLU in the activation dtype (the negative branch is rounded to T)
template <typename T> __device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : round_t<T>(kSlope * v);
}

// Conv epilogue for one output element: round the f32 sum to T, add the
// bias in T, zero rows outside [0, M); FIRST stores lrelu(y) (conv2's
// input), otherwise y is added into the residual.
template <typename T, bool FIRST>
__device__ __forceinline__ void epilogue(T* p, float acc, float bias, bool in_seq) {
  float y = in_seq ? round_t<T>(round_t<T>(acc) + bias) : 0.f;
  *p = FIRST ? from_f<T>(lrelu<T>(y)) : from_f<T>(to_f(*p) + y);
}

// ---------------------------------------------------------------------------
// f32: FMA on the CUDA cores, buffers channel-major [C][BR]
// ---------------------------------------------------------------------------
template <int C>
struct FmaConv {
  using T = float;
  static constexpr int kCN = 16;  // output channels per thread
  static constexpr int kRM = 4;   // rows per thread per pass

  __device__ static int buf_elems(int BR) { return C * BR; }
  __device__ static int at(int c, int l, int BR) { return c * BR + l; }
  static size_t smem_bytes(int tile, int halo) {
    return (size_t)2 * C * (tile + 2 * halo) * sizeof(float);
  }

  // dst rows [olo, ohi) <- conv(in) with taps at r - pad + k*d
  template <bool FIRST>
  __device__ static void conv(const float* __restrict__ in, float* __restrict__ dst,
                              const float* __restrict__ w, const float* __restrict__ bias,
                              int K, int d, int pad, int olo, int ohi, int BR, int row0,
                              int M, float*) {
    constexpr int kNCG = C / kCN;               // channel groups: 1, 2, 4, 8
    constexpr int kNRG = kWarps / kNCG;         // warps sharing a channel group
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int o0 = (warp % kNCG) * kCN;
    const int rg = warp / kNCG;
    const int span = kNRG * 32 * kRM;
    for (int base = olo; base < ohi; base += span) {
      int src[kRM];
#pragma unroll
      for (int j = 0; j < kRM; ++j)
        src[j] = min(base + (rg * kRM + j) * 32 + lane, ohi - 1) - pad;
      float acc[kRM][kCN];
#pragma unroll
      for (int j = 0; j < kRM; ++j)
#pragma unroll
        for (int c = 0; c < kCN; ++c) acc[j][c] = 0.f;
      for (int k = 0; k < K; ++k) {
        const float* wk = w + (size_t)k * C * C + o0;
        const float* ink = in + k * d;
#pragma unroll 4
        for (int i = 0; i < C; ++i) {
          float a[kRM];
#pragma unroll
          for (int j = 0; j < kRM; ++j) {
            const float v = ink[i * BR + src[j]];
            a[j] = FIRST ? lrelu<float>(v) : v;
          }
          const float4* wp = reinterpret_cast<const float4*>(wk + (size_t)i * C);
          float wv[kCN];
#pragma unroll
          for (int q = 0; q < kCN / 4; ++q) {
            const float4 t = __ldg(wp + q);
            wv[4 * q] = t.x; wv[4 * q + 1] = t.y; wv[4 * q + 2] = t.z; wv[4 * q + 3] = t.w;
          }
#pragma unroll
          for (int j = 0; j < kRM; ++j)
#pragma unroll
            for (int c = 0; c < kCN; ++c) acc[j][c] = fmaf(a[j], wv[c], acc[j][c]);
        }
      }
#pragma unroll
      for (int j = 0; j < kRM; ++j) {
        const int r = base + (rg * kRM + j) * 32 + lane;
        if (r >= ohi) continue;
        const int g = row0 + r;
#pragma unroll
        for (int c = 0; c < kCN; ++c)
          epilogue<float, FIRST>(dst + (o0 + c) * BR + r, acc[j][c], bias[o0 + c],
                                 g >= 0 && g < M);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// bf16: WMMA on the tensor cores, buffers row-major [BR + 16][C + 16]
// ---------------------------------------------------------------------------
template <int C>
struct MmaConv {
  using T = bf16;
  static constexpr int kLD = C + 16;                 // row stride, elements
  static constexpr int kNT = C / 16;                 // 16-channel output tiles
  static constexpr int kFN = kNT < 4 ? kNT : 4;      // output tiles per warp
  static constexpr int kFM = 8 / kFN;                // 16-row tiles per warp
  static constexpr int kWN = kNT / kFN;              // warps across channels
  static constexpr int kWM = kWarps / kWN;           // warps across rows
  static constexpr int kSlack = 16;                  // rows a last 16-row tile may overrun

  __device__ static int buf_elems(int BR) { return (BR + kSlack) * kLD; }
  __device__ static int at(int c, int l, int) { return l * kLD + c; }
  static size_t smem_bytes(int tile, int halo) {
    return (size_t)2 * (tile + 2 * halo + kSlack) * kLD * sizeof(bf16) +
           (size_t)kWarps * 256 * sizeof(float);
  }

  template <bool FIRST>
  __device__ static void conv(const bf16* __restrict__ in, bf16* __restrict__ dst,
                              const bf16* __restrict__ w, const bf16* __restrict__ bias,
                              int K, int d, int pad, int olo, int ohi, int BR, int row0,
                              int M, float* scratch) {
    using namespace nvcuda;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n0 = (warp % kWN) * kFN * 16;
    const int wm = warp / kWN;
    float* stage = scratch + warp * 256;   // this warp's 16x16 f32 staging tile
    for (int base = olo + wm * kFM * 16; base < ohi; base += kWM * kFM * 16) {
      const int n_act = min(kFM, (ohi - base + 15) / 16);   // warp-uniform
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFM][kFN];
#pragma unroll
      for (int fm = 0; fm < kFM; ++fm)
#pragma unroll
        for (int fn = 0; fn < kFN; ++fn) wmma::fill_fragment(acc[fm][fn], 0.f);
      for (int k = 0; k < K; ++k) {
        const bf16* a_rows = in + (base - pad + k * d) * kLD;
        for (int i0 = 0; i0 < C; i0 += 16) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw[kFN];
#pragma unroll
          for (int fn = 0; fn < kFN; ++fn)
            wmma::load_matrix_sync(bw[fn], w + ((size_t)k * C + i0) * C + n0 + fn * 16, C);
#pragma unroll
          for (int fm = 0; fm < kFM; ++fm) {
            if (fm >= n_act) break;
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
            wmma::load_matrix_sync(a, a_rows + fm * 16 * kLD + i0, kLD);
            if (FIRST) {
#pragma unroll
              for (int t = 0; t < a.num_elements; ++t)
                a.x[t] = from_f<bf16>(lrelu<bf16>(to_f(a.x[t])));
            }
#pragma unroll
            for (int fn = 0; fn < kFN; ++fn) wmma::mma_sync(acc[fm][fn], a, bw[fn], acc[fm][fn]);
          }
        }
      }
#pragma unroll
      for (int fm = 0; fm < kFM; ++fm) {
        if (fm >= n_act) break;
#pragma unroll
        for (int fn = 0; fn < kFN; ++fn) {
          wmma::store_matrix_sync(stage, acc[fm][fn], 16, wmma::mem_row_major);
          __syncwarp();
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int e = q * 32 + lane;
            const int r = base + fm * 16 + (e >> 4);
            const int ch = n0 + fn * 16 + (e & 15);
            if (r < ohi) {
              const int g = row0 + r;
              epilogue<bf16, FIRST>(dst + r * kLD + ch, stage[e], to_f(bias[ch]),
                                    g >= 0 && g < M);
            }
          }
          __syncwarp();
        }
      }
    }
  }
};

template <class Conv, int C>
__global__ void __launch_bounds__(kThreads)
trio_kernel(const typename Conv::T* __restrict__ x, const typename Conv::T* __restrict__ w,
            const typename Conv::T* __restrict__ bias, typename Conv::T* __restrict__ out,
            int M, int tile, TrioGeom g) {
  using T = typename Conv::T;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int H = g.halo;
  const int BR = tile + 2 * H;
  T* xb = reinterpret_cast<T*>(smem_raw);   // running residual of a resblock
  T* xt = xb + Conv::buf_elems(BR);         // activated conv1 output
  float* scratch = reinterpret_cast<float*>(xt + Conv::buf_elems(BR));
  const int t0 = blockIdx.x * tile;
  const T* xg = x + (size_t)blockIdx.y * C * M;
  T* og = out + (size_t)blockIdx.y * C * M;
  const int row0 = t0 - H;

  size_t woff = 0;
  int conv = 0;
  for (int r = 0; r < g.n_res; ++r) {
    const int K = g.k[r];
    int hr = 0;
    for (int i = 0; i < g.n_dil; ++i) hr += g.pad1[r * kMaxDil + i] + g.pad2[r * kMaxDil + i];
    int lo = H - hr, hi = H + tile + hr;
    const int len = hi - lo;
    for (int e = threadIdx.x; e < C * len; e += kThreads) {
      const int c = e / len, l = lo + e % len;
      const int gr = row0 + l;
      xb[Conv::at(c, l, BR)] = (gr >= 0 && gr < M) ? xg[(size_t)c * M + gr] : from_f<T>(0.f);
    }
    __syncthreads();
    for (int i = 0; i < g.n_dil; ++i) {
      const int d = g.dil[r * kMaxDil + i];
      const int p1 = g.pad1[r * kMaxDil + i], p2 = g.pad2[r * kMaxDil + i];
      Conv::template conv<true>(xb, xt, w + woff, bias + conv * C, K, d, p1, lo + p1,
                                hi - p1, BR, row0, M, scratch);
      woff += (size_t)K * C * C;
      ++conv;
      __syncthreads();
      Conv::template conv<false>(xt, xb, w + woff, bias + conv * C, K, 1, p2, lo + p1 + p2,
                                 hi - p1 - p2, BR, row0, M, scratch);
      woff += (size_t)K * C * C;
      ++conv;
      __syncthreads();
      lo += p1 + p2;
      hi -= p1 + p2;
    }
    // rows [H, H + tile) now hold this resblock's output: fold it into the
    // output tile (each element is read and written by the same thread)
    for (int e = threadIdx.x; e < C * tile; e += kThreads) {
      const int c = e / tile, l = e % tile;
      const int gr = t0 + l;
      if (gr >= M) continue;
      const size_t gi = (size_t)c * M + gr;
      const float v = to_f(xb[Conv::at(c, H + l, BR)]);
      float s = r == 0 ? v : round_t<T>(to_f(og[gi]) + v);
      if (r == g.n_res - 1) s = s / (float)g.n_res;
      og[gi] = from_f<T>(s);
    }
    __syncthreads();
  }
}

template <class Conv, int C>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out, int B,
                   int M, int tile, const TrioGeom& g, cudaStream_t stream) {
  using T = typename Conv::T;
  const size_t smem = Conv::smem_bytes(tile, g.halo);
  auto kern = trio_kernel<Conv, C>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((M + tile - 1) / tile, B);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                         static_cast<const T*>(bias), static_cast<T*>(out),
                                         M, tile, g);
  return cudaGetLastError();
}

template <template <int> class Conv>
cudaError_t dispatch_c(const void* x, const void* w, const void* bias, void* out, int B,
                       int C, int M, int tile, const TrioGeom& g, cudaStream_t s) {
  switch (C) {
    case 16: return launch<Conv<16>, 16>(x, w, bias, out, B, M, tile, g, s);
    case 32: return launch<Conv<32>, 32>(x, w, bias, out, B, M, tile, g, s);
    case 64: return launch<Conv<64>, 64>(x, w, bias, out, B, M, tile, g, s);
    case 128: return launch<Conv<128>, 128>(x, w, bias, out, B, M, tile, g, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out (B, C, M); w: every conv's (K, Cin, Cout) weights back to back, in
// x's dtype; bias (n_convs, C). geom: [n_res, n_dil, halo, k[4], dil[4*4],
// pad1[4*4], pad2[4*4]] in host memory, read before the launch. dtype:
// 0 = float32, 1 = bfloat16. tile: output rows per block; the caller sizes
// it to the shared memory (fused_tail.py: tile_rows). Returns
// cudaGetLastError() after the launch.
extern "C" int l2s_resblock_trio(const void* x, const void* w, const void* bias,
                                 void* out, int B, int C, int M, int dtype, int tile,
                                 const int* geom, void* stream) {
  TrioGeom g;
  g.n_res = geom[0];
  g.n_dil = geom[1];
  g.halo = geom[2];
  const int* q = geom + 3;
  for (int i = 0; i < kMaxRes; ++i) g.k[i] = *q++;
  for (int i = 0; i < kMaxRes * kMaxDil; ++i) g.dil[i] = *q++;
  for (int i = 0; i < kMaxRes * kMaxDil; ++i) g.pad1[i] = *q++;
  for (int i = 0; i < kMaxRes * kMaxDil; ++i) g.pad2[i] = *q++;
  if (g.n_res < 1 || g.n_res > kMaxRes || g.n_dil < 1 || g.n_dil > kMaxDil || tile < 1 ||
      M < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0   ? dispatch_c<FmaConv>(x, w, bias, out, B, C, M, tile, g, s)
                  : dtype == 1 ? dispatch_c<MmaConv>(x, w, bias, out, B, C, M, tile, g, s)
                               : cudaErrorInvalidValue;
  return (int)e;
}
