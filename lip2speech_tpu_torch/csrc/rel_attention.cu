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
// of V over the sequence); callers slice them off. With dropout (`_keep_mask`
// in the TPU kernel) the product with V sees the probabilities times
// keep / (1 - rate), while the softmax sum and the log-sum-exp come from the
// undropped ones; the mask is philox.cuh's, a function of (seed, b*h, i, j),
// so rel_attention_bwd.cu replays it whatever its tiling.
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
// multiple of 64. The loop's pieces live in flash_tile.cuh (online softmax,
// P V) and rel_tile.cuh (window, position term). Tensor-core products
// (mma / wgmma) and TMA are later work.

#include "rel_tile.cuh"

namespace {

using namespace flash;

// Q_u, Q_v, K (then the probabilities), V tiles, the window, the mask flags
constexpr size_t kRelSmemBytes = ((size_t)(4 * kB + kWin) * kS + kB) * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(kThreads)
rel_attention_kernel(const T* __restrict__ qu, const T* __restrict__ qv,
                     const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ p, const uint8_t* __restrict__ mask,
                     T* __restrict__ out, float* __restrict__ lse, int H, int T_len,
                     float scale, philox::Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQu = reinterpret_cast<float*>(smem_raw);
  float* sQv = sQu + kB * kS;
  float* sK = sQv + kB * kS;     // key tile, then that tile's probabilities
  float* sV = sK + kB * kS;
  float* sP = sV + kB * kS;      // position-table window
  float* sM = sP + kWin * kS;    // 1 valid, 0 masked, -1 past the sequence

  const int bh = blockIdx.y;
  const int h = bh % H;
  const int i0 = blockIdx.x * kB;
  const size_t base = (size_t)bh * T_len * kD;
  const T* ph = p + (size_t)h * (2 * T_len - 1) * kD;
  const uint8_t* mask_row = mask + (size_t)(bh / H) * T_len;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile(sQu, qu + base, i0, T_len);
  load_tile(sQv, qv + base, i0, T_len);
  State st;
  st.init();

  for (int j0 = 0; j0 < T_len; j0 += kB) {
    __syncthreads();  // the previous tile's probabilities and V are consumed
    load_tile(sK, k + base, j0, T_len);
    load_tile(sV, v + base, j0, T_len);
    load_window(sP, ph, window_start(T_len, i0, j0), T_len);
    load_mask(sM, mask_row, j0, T_len);
    __syncthreads();

    float s[4][4];
    rel_scores(sQu, sQv, sK, sP, ty, tx, scale, s);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] = mask_score(s[a][j], sM[4 * tx + j]);
    softmax_step(s, st);
    pv_product_dropout(sK, sV, ty, tx, s, st, drop, bh, i0, j0);
  }
  write_out<T>(out + base, lse + (size_t)bh * T_len, i0, T_len, ty, tx, st);
}

template <typename T>
cudaError_t launch(const void* qu, const void* qv, const void* k, const void* v,
                   const void* p, const uint8_t* mask, void* out, float* lse, int B, int H,
                   int T_len, philox::Dropout drop, cudaStream_t stream) {
  auto kern = rel_attention_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kRelSmemBytes);
  if (e != cudaSuccess) return e;
  dim3 grid((T_len + kB - 1) / kB, B * H);
  kern<<<grid, kThreads, kRelSmemBytes, stream>>>(
      static_cast<const T*>(qu), static_cast<const T*>(qv), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(p), mask, static_cast<T*>(out), lse,
      H, T_len, 1.0f / sqrtf((float)kD), drop);
  return cudaGetLastError();
}

}  // namespace

// All tensors contiguous: q_u, q_v, k, v, out (B, H, T, dk); p (H, 2T-1, dk);
// mask (B, T) uint8; lse (B, H, T) float32. dtype: 0 = float32, 1 = bfloat16.
// Only dk = 64. rate in [0, 1) and seed select the dropout mask (rate 0: no
// dropout). Returns cudaGetLastError() after the launch.
extern "C" int l2s_rel_attention(const void* qu, const void* qv, const void* k,
                                 const void* v, const void* p, const void* mask, void* out,
                                 void* lse, int B, int H, int T_len, int dk, int dtype,
                                 float rate, unsigned long long seed, void* stream) {
  if (dk != kD || B < 1 || H < 1 || T_len < 1 || rate < 0.f || rate >= 1.f)
    return (int)cudaErrorInvalidValue;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const philox::Dropout drop = philox::make_dropout(rate, seed);
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(qu, qv, k, v, p, m, out, l, B, H, T_len, drop, s);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(qu, qv, k, v, p, m, out, l, B, H, T_len, drop, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
