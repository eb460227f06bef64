// Relative-position flash attention with the position term as an additive
// bias, forward, for Hopper (sm_90a).
//
// Replaces: lip2speech_tpu/ops/pallas_rel_attention.py, `_bias_kernel`
// (entry `_rel_flash_bias` -> `_flash_bias_impl`), forward, with its optional
// probability dropout (philox.cuh's mask, as in rel_attention.cu).
//
// Computes, per (batch, head), with q_u, k, v (T, 64) and bias (T, T) f32:
//     S[i, j] = q_u[i].k[j] / sqrt(64) + bias[i, j]
// keys with mask 0 score -1e30, then O = softmax_j(S) V and the per-row
// log-sum-exp m + log(max(l, 1e-20)). The caller builds the bias,
// rel_shift(q_v p^T) / sqrt(64), outside the kernel. Rows whose keys are all
// masked stay finite.
//
// What bounds it: the f32 bias is 4 T^2 bytes per (batch, head), read once,
// against two (T x T x 64) products: 64 operations per byte, below the card's
// balance point, so on tensor cores it is bound by bytes. This first version
// runs the products as FP32 FMAs, which are its ceiling for now.
//
// What the design does about it: the TPU kernel wants the bias re-tiled to
// (key block, row, 128 lanes) because a dynamic slice along lanes costs
// shuffles there. Here the bias stays (T, T) rows: the 16 threads of a row
// group read 64 consecutive floats of one bias row, a coalesced 256-byte
// segment, straight into registers; it never passes through shared memory.
// Everything else is attention.cu's loop (flash_tile.cuh): 64 query rows per
// block, key tiles of 64, online softmax, bounds checks instead of padding.

#include "flash_tile.cuh"

namespace {

using namespace flash;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rel_attention_bias_kernel(const T* __restrict__ qu, const T* __restrict__ k,
                          const T* __restrict__ v, const float* __restrict__ bias,
                          const uint8_t* __restrict__ mask, T* __restrict__ out,
                          float* __restrict__ lse, int H, int T_len, float scale,
                          philox::Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + kB * kS;     // key tile, then that tile's probabilities
  float* sV = sK + kB * kS;
  float* sM = sV + kB * kS;

  const int bh = blockIdx.y;
  const int i0 = blockIdx.x * kB;
  const size_t base = (size_t)bh * T_len * kD;
  const float* bias_bh = bias + (size_t)bh * T_len * T_len;
  const uint8_t* mask_row = mask + (size_t)(bh / H) * T_len;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile(sQ, qu + base, i0, T_len);
  State st;
  st.init();

  for (int j0 = 0; j0 < T_len; j0 += kB) {
    __syncthreads();  // the previous tile's probabilities and V are consumed
    load_tile(sK, k + base, j0, T_len);
    load_tile(sV, v + base, j0, T_len);
    load_mask(sM, mask_row, j0, T_len);
    // this thread's 4x4 bias tile, in flight while the products run
    float bt[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + 4 * ty + a;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jj = j0 + 4 * tx + j;
        bt[a][j] = (i < T_len && jj < T_len) ? bias_bh[(size_t)i * T_len + jj] : 0.f;
      }
    }
    __syncthreads();

    float s[4][4];
    qk_product(sQ, sK, ty, tx, s);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[a][j] = mask_score(fmaf(s[a][j], scale, bt[a][j]), sM[4 * tx + j]);
    softmax_step(s, st);
    pv_product_dropout(sK, sV, ty, tx, s, st, drop, bh, i0, j0);
  }
  write_out<T>(out + base, lse + (size_t)bh * T_len, i0, T_len, ty, tx, st);
}

template <typename T>
cudaError_t launch(const void* qu, const void* k, const void* v, const float* bias,
                   const uint8_t* mask, void* out, float* lse, int B, int H, int T_len,
                   philox::Dropout drop, cudaStream_t stream) {
  auto kern = rel_attention_bias_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kSmemBytes);
  if (e != cudaSuccess) return e;
  dim3 grid((T_len + kB - 1) / kB, B * H);
  kern<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(qu), static_cast<const T*>(k), static_cast<const T*>(v), bias, mask,
      static_cast<T*>(out), lse, H, T_len, 1.0f / sqrtf((float)kD), drop);
  return cudaGetLastError();
}

}  // namespace

// All tensors contiguous: q_u, k, v, out (B, H, T, dk); bias (B, H, T, T)
// float32; mask (B, T) uint8; lse (B, H, T) float32. dtype (of q_u, k, v,
// out): 0 = float32, 1 = bfloat16. Only dk = 64. rate in [0, 1) and seed
// select the dropout mask (rate 0: no dropout). Returns cudaGetLastError()
// after the launch.
extern "C" int l2s_rel_attention_bias(const void* qu, const void* k, const void* v,
                                      const void* bias, const void* mask, void* out, void* lse,
                                      int B, int H, int T_len, int dk, int dtype, float rate,
                                      unsigned long long seed, void* stream) {
  if (dk != kD || B < 1 || H < 1 || T_len < 1 || rate < 0.f || rate >= 1.f)
    return (int)cudaErrorInvalidValue;
  const philox::Dropout drop = philox::make_dropout(rate, seed);
  const float* bi = static_cast<const float*>(bias);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(qu, k, v, bi, m, out, l, B, H, T_len, drop, s);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(qu, k, v, bi, m, out, l, B, H, T_len, drop, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
