// Key-masked flash attention, forward, for Hopper (sm_90a).
//
// Replaces: lip2speech_tpu/ops/pallas_attention.py, `_attn_kernel` (entry
// `flash_attention` -> `attention`), the attention of the AV-HuBERT trunk and
// of the HuBERT unit extractor.
//
// Computes, per (batch, head), with q, k, v (T, 64):
//     S[i, j] = q[i].k[j] / sqrt(64)
// keys with mask 0 score -1e30, then O = softmax_j(S) V, normalised by
// max(l, 1e-20). Rows whose keys are all masked stay finite (a uniform
// average of V over the sequence); callers slice them off.
//
// What bounds it: two (T x T x 64) products per (batch, head) against O(T)
// bytes: operations. This first version runs them as FP32 FMAs, so the FP32
// CUDA-core rate, not the tensor cores, is its ceiling.
//
// What the design does about it: the TPU kernel holds a head's whole K and V
// in VMEM and pads T to a block multiple; here one block of 256 threads owns
// 64 query rows and loops over key tiles of 64 with an online softmax
// (flash_tile.cuh), so shared memory does not grow with T (the unit extractor
// calls it at T = 5000) and nothing quadratic reaches device memory. Bounds
// are checked, so T needs no padded copy. The key mask is read as the (B, T)
// bytes it is, shared by the heads of a batch row; a null mask means every
// key is valid. Tensor-core products (mma / wgmma) and TMA are later work.

#include "flash_tile.cuh"

namespace {

using namespace flash;

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const uint8_t* __restrict__ mask, T* __restrict__ out, int H, int T_len,
                 float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + kB * kS;     // key tile, then that tile's probabilities
  float* sV = sK + kB * kS;
  float* sM = sV + kB * kS;

  const int bh = blockIdx.y;
  const int i0 = blockIdx.x * kB;
  const size_t base = (size_t)bh * T_len * kD;
  const uint8_t* mask_row = mask == nullptr ? nullptr : mask + (size_t)(bh / H) * T_len;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile(sQ, q + base, i0, T_len);
  State st;
  st.init();

  for (int j0 = 0; j0 < T_len; j0 += kB) {
    __syncthreads();  // the previous tile's probabilities and V are consumed
    load_tile(sK, k + base, j0, T_len);
    load_tile(sV, v + base, j0, T_len);
    load_mask(sM, mask_row, j0, T_len);
    __syncthreads();

    float s[4][4];
    qk_product(sQ, sK, ty, tx, s);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] = mask_score(s[a][j] * scale, sM[4 * tx + j]);
    softmax_step(s, st);
    pv_product(sK, sV, ty, tx, s, st);
  }
  write_out<T>(out + base, nullptr, i0, T_len, ty, tx, st);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const uint8_t* mask, void* out,
                   int B, int H, int T_len, cudaStream_t stream) {
  auto kern = attention_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kSmemBytes);
  if (e != cudaSuccess) return e;
  dim3 grid((T_len + kB - 1) / kB, B * H);
  kern<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(out), H, T_len, 1.0f / sqrtf((float)kD));
  return cudaGetLastError();
}

}  // namespace

// All tensors contiguous: q, k, v, out (B, H, T, dk); mask (B, T) uint8 or
// null (every key valid). dtype: 0 = float32, 1 = bfloat16. Only dk = 64.
// Returns cudaGetLastError() after the launch.
extern "C" int l2s_attention(const void* q, const void* k, const void* v, const void* mask,
                             void* out, int B, int H, int T_len, int dk, int dtype,
                             void* stream) {
  if (dk != kD || B < 1 || H < 1 || T_len < 1) return (int)cudaErrorInvalidValue;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(q, k, v, m, out, B, H, T_len, s);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(q, k, v, m, out, B, H, T_len, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
