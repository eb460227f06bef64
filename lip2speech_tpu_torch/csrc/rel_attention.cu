// Transformer-XL relative-position flash attention, forward, for Hopper
// (sm_90a).
//
// Replaces: lip2speech_tpu/ops/pallas_rel_attention.py, `_kernel` (entry
// `rel_flash_attention` -> `_rel_flash_impl`).
//
// Computes, per (batch, head), with q_u, q_v, k, v (T, 64), p (2T-1, 64):
//     S[i, j] = (q_u[i].k[j] + q_v[i].p[T-1-i+j]) / sqrt(64)
// keys with mask 0 score -1e30, then O = softmax_j(S) V and the per-row
// log-sum-exp. Rows whose keys are all masked stay finite (a uniform average
// of V over the sequence); callers slice them off.
//
// What bounds it: three (T x T x 64) products per (batch, head) against
// O(T) bytes: operations. This first version runs them as FP32 FMAs, so the
// FP32 CUDA-core rate, not the tensor cores, is its ceiling.
//
// What the design does about it: the TPU kernel's whole-row score residency
// and its log2 roll shear were Mosaic workarounds and are gone. One block of
// 256 threads owns 64 query rows of one (batch, head) and loops over key
// tiles of 64 with an online softmax (running max, running sum, f32
// accumulator in registers); nothing quadratic reaches device memory. For
// each key tile it stages K, V and the 127-row window of the position table
// that the tile's diagonals touch, p[T-1-(i0+63)+j0 ...], in shared memory;
// BD[a, j] = q_v[a].window[63-a+j] is read off that window directly, so the
// position term costs one product like the content term. Each thread owns a
// 4x4 score tile whose 16 diagonals need only 7 window rows. Shared tiles are
// f32 with a padded stride (65) against bank conflicts; inputs may be f32 or
// bf16 and all arithmetic is f32. Bounds are checked, so T need not be a
// multiple of 64. Tensor-core products (mma / wgmma) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;            // query rows per block = keys per tile
constexpr int kD = 64;            // head dim
constexpr int kS = kD + 1;        // padded shared-memory row stride
constexpr int kWin = 2 * kB - 1;  // position-table rows one key tile touches
constexpr int kThreads = 256;
constexpr float kMasked = -1e30f;
constexpr size_t kSmemFloats = (size_t)(4 * kB + kWin) * kS + kB;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rel_attention_kernel(const T* __restrict__ qu, const T* __restrict__ qv,
                     const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ p, const uint8_t* __restrict__ mask,
                     T* __restrict__ out, float* __restrict__ lse, int H, int T_len,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQu = reinterpret_cast<float*>(smem_raw);
  float* sQv = sQu + kB * kS;
  float* sK = sQv + kB * kS;     // key tile, then that tile's probabilities
  float* sV = sK + kB * kS;
  float* sP = sV + kB * kS;      // position-table window
  float* sM = sP + kWin * kS;    // 1 valid, 0 masked, -1 past the sequence

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int i0 = blockIdx.x * kB;
  const size_t base = (size_t)bh * T_len * kD;
  const T* ph = p + (size_t)h * (2 * T_len - 1) * kD;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  for (int e = tid; e < kB * kD; e += kThreads) {
    const int r = e / kD, c = e % kD, i = i0 + r;
    const bool ok = i < T_len;
    sQu[r * kS + c] = ok ? to_f(qu[base + (size_t)i * kD + c]) : 0.f;
    sQv[r * kS + c] = ok ? to_f(qv[base + (size_t)i * kD + c]) : 0.f;
  }

  float m_i[4], l_i[4], acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_i[a] = -INFINITY;
    l_i[a] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
  }
  // window row of (row 4ty+a, key 4tx+j) is 63-(4ty+a)+(4tx+j) = wb + (j-a+3)
  const int wb = kB - 4 - 4 * ty + 4 * tx;

  for (int j0 = 0; j0 < T_len; j0 += kB) {
    __syncthreads();  // the previous tile's probabilities and V are consumed
    for (int e = tid; e < kB * kD; e += kThreads) {
      const int r = e / kD, c = e % kD, j = j0 + r;
      const bool ok = j < T_len;
      sK[r * kS + c] = ok ? to_f(k[base + (size_t)j * kD + c]) : 0.f;
      sV[r * kS + c] = ok ? to_f(v[base + (size_t)j * kD + c]) : 0.f;
    }
    const int p0 = T_len - 1 - (i0 + kB - 1) + j0;
    for (int e = tid; e < kWin * kD; e += kThreads) {
      const int r = e / kD, c = e % kD, g = p0 + r;
      sP[r * kS + c] = (g >= 0 && g < 2 * T_len - 1) ? to_f(ph[(size_t)g * kD + c]) : 0.f;
    }
    if (tid < kB) {
      const int j = j0 + tid;
      sM[tid] = j < T_len ? (mask[(size_t)b * T_len + j] ? 1.f : 0.f) : -1.f;
    }
    __syncthreads();

    float sac[4][4], sbd[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) sac[a][j] = sbd[a][j] = 0.f;
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

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float f = sM[4 * tx + j];
        float val = (sac[a][j] + sbd[a][j]) * scale;
        val = f > 0.f ? val : (f == 0.f ? kMasked : -INFINITY);
        s[a][j] = val;
        mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // every key tile holds at least one key inside the sequence, so m_new
      // is finite and exp(-inf - m_new) = 0 for keys past the sequence
      const float m_new = fmaxf(m_i[a], mx);
      const float alpha = expf(m_i[a] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[a][j] = expf(s[a][j] - m_new);
        rs += s[a][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[a] = l_i[a] * alpha + rs;
      m_i[a] = m_new;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();  // all score reads of sK are done
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) sK[(4 * ty + a) * kS + 4 * tx + j] = s[a][j];
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kB; ++j) {
      float pa[4], vv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = sK[(4 * ty + a) * kS + j];
#pragma unroll
      for (int c = 0; c < 4; ++c) vv[c] = sV[j * kS + 4 * tx + c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(pa[a], vv[c], acc[a][c]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + 4 * ty + a;
    if (i >= T_len) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      out[base + (size_t)i * kD + 4 * tx + c] = from_f<T>(acc[a][c] / l_i[a]);
    if (tx == 0) lse[(size_t)bh * T_len + i] = m_i[a] + logf(l_i[a]);
  }
}

template <typename T>
cudaError_t launch(const void* qu, const void* qv, const void* k, const void* v,
                   const void* p, const uint8_t* mask, void* out, float* lse, int B, int H,
                   int T_len, cudaStream_t stream) {
  const size_t smem = kSmemFloats * sizeof(float);
  auto kern = rel_attention_kernel<T>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((T_len + kB - 1) / kB, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qu), static_cast<const T*>(qv), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(p), mask, static_cast<T*>(out), lse,
      H, T_len, 1.0f / sqrtf((float)kD));
  return cudaGetLastError();
}

}  // namespace

// All tensors contiguous: q_u, q_v, k, v, out (B, H, T, dk); p (H, 2T-1, dk);
// mask (B, T) uint8; lse (B, H, T) float32. dtype: 0 = float32, 1 = bfloat16.
// Only dk = 64. Returns cudaGetLastError() after the launch.
extern "C" int l2s_rel_attention(const void* qu, const void* qv, const void* k,
                                 const void* v, const void* p, const void* mask, void* out,
                                 void* lse, int B, int H, int T_len, int dk, int dtype,
                                 void* stream) {
  if (dk != kD || B < 1 || H < 1 || T_len < 1) return (int)cudaErrorInvalidValue;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(qu, qv, k, v, p, m, out, l, B, H, T_len, s);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(qu, qv, k, v, p, m, out, l, B, H, T_len, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
