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
// bytes, so operations at long T; at the serving shapes (B4 H16 T240: 256
// blocks of 4 key tiles each) the card is not full and the time is one
// block's latency: its loads, its four tile steps and the launch.
//
// Design. The TPU kernel holds a head's whole K and V in VMEM and pads T to
// a block multiple; here one block owns 64 query rows of one (batch, head)
// and loops over key tiles of 64 with an online softmax, so shared memory
// does not grow with T (the unit extractor calls it at T = 5000) and nothing
// quadratic reaches device memory. Bounds are checked, so T needs no padded
// copy. The key mask is read as the (B, T) bytes it is, shared by the heads
// of a batch row; a null mask means every key is valid.
//
// bf16 (dtype 1), `attention_mma`: rel_attention.cu's tensor-core forward
// without the position term (mma_tile.cuh). 4 warps x 16 query rows; the Q
// fragments stay in registers; K and V tiles arrive by 16-byte cp.async into
// swizzled tiles, double-buffered, so tile j+1 loads while tile j computes;
// S = Q K^T and O += P V on mma.sync m16n8k16 (bf16 in, f32 accumulate); the
// mask and the online softmax run on the accumulator fragments, P is rounded
// to bf16 in registers as the A operand of P V. 41.5 KB of shared memory and
// at most 128 registers: four blocks (16 warps) per SM.
//
// f32 (dtype 0), `attention_kernel`: the first version, unchanged on
// the CUDA cores (FP32 FMAs on f32 shared tiles, flash_tile.cuh), because
// the f32 path is held to 1e-4 against the CPU and TF32 cannot meet that.

#include "mma_tile.cuh"

namespace {

namespace mma_path {

using namespace mma;

// Q, two stages of K and of V, two stages of mask flags
constexpr size_t kSmem = (size_t)5 * kTile * sizeof(bf16) + (size_t)2 * kB * sizeof(float);

__global__ void __launch_bounds__(kThreads, 4)
attention_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const uint8_t* __restrict__ mask, bf16* __restrict__ out, int H, int T_len,
              float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kTile;         // two stages
  bf16* sV = sK + 2 * kTile;     // two stages
  float* sM = reinterpret_cast<float*>(sV + 2 * kTile);   // two stages

  const int bh = blockIdx.y, i0 = blockIdx.x * kB;
  const size_t base = (size_t)bh * T_len * kD;
  const uint8_t* mask_row = mask == nullptr ? nullptr : mask + (size_t)(bh / H) * T_len;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q4 = lane & 3;
  const int i_g = i0 + 16 * warp + (lane >> 2);   // the lane's first row
  const int n_tiles = (T_len + kB - 1) / kB;

  load_tile(sQ, q + base, i0, T_len);
  load_tile(sK, k + base, 0, T_len);
  load_tile(sV, v + base, 0, T_len);
  flash::load_mask(sM, mask_row, 0, T_len);
  cp_async_commit();

  uint32_t aq[4][4];
  float o[8][4];
  zero(o);
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {       // stage t+1 was last read in tile t-1
      const int j1 = (t + 1) * kB;
      load_tile(sK + (st ^ 1) * kTile, k + base, j1, T_len);
      load_tile(sV + (st ^ 1) * kTile, v + base, j1, T_len);
      flash::load_mask(sM + (st ^ 1) * kB, mask_row, j1, T_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) load_a(aq, sQ, 16 * warp, lane);
    const bf16* kt = sK + st * kTile;
    const bf16* vt = sV + st * kTile;
    const float* mt = sM + st * kB;

    float s[8][4];
    zero(s);
    product_nt(s, aq, kt, lane);

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = flash::mask_score(s[n][e] * scale, mt[8 * n + 2 * q4 + (e & 1)]);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);   // finite: key j0 lies in the sequence
      alpha[r] = __expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = __expf(s[n][e] - m_run[e >> 1]);
        rs[e >> 1] += s[n][e];
        o[n][e] *= alpha[e >> 1];
      }
    // the lane's share of the row sums; the quad adds them up at the end
    l_run[0] = l_run[0] * alpha[0] + rs[0];
    l_run[1] = l_run[1] * alpha[1] + rs[1];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      to_a(a, s, kk);
      product_nn_step(o, a, vt, kk, lane);
    }
    __syncthreads();   // stage st is consumed
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / fmaxf(l, 1e-20f);
  }
  store_rows(out + base, o, i_g, T_len, inv, q4);
}

cudaError_t launch(const void* q, const void* k, const void* v, const uint8_t* mask, void* out,
                   int B, int H, int T_len, cudaStream_t stream) {
  if (!aligned16({q, k, v, out})) return cudaErrorMisalignedAddress;
  cudaError_t e = cudaFuncSetAttribute(attention_mma,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid((T_len + kB - 1) / kB, B * H);
  attention_mma<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      mask, static_cast<bf16*>(out), H, T_len, 1.0f / sqrtf((float)kD));
  return cudaGetLastError();
}

}  // namespace mma_path

namespace fma_path {

using namespace flash;

// One block of 256 threads owns 64 query rows; thread (ty, tx) owns a 4x4
// score tile and a 4x4 output tile; f32 shared tiles with a padded stride.
__global__ void __launch_bounds__(kThreads)
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ mask,
                 float* __restrict__ out, int H, int T_len, float scale) {
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
  write_out(out + base, nullptr, i0, T_len, ty, tx, st);
}

cudaError_t launch(const void* q, const void* k, const void* v, const uint8_t* mask, void* out,
                   int B, int H, int T_len, cudaStream_t stream) {
  auto kern = attention_kernel;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kSmemBytes);
  if (e != cudaSuccess) return e;
  dim3 grid((T_len + kB - 1) / kB, B * H);
  kern<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      mask, static_cast<float*>(out), H, T_len, 1.0f / sqrtf((float)kD));
  return cudaGetLastError();
}

}  // namespace fma_path

}  // namespace

// All tensors contiguous: q, k, v, out (B, H, T, dk); mask (B, T) uint8 or
// null (every key valid). dtype: 0 = float32 (FMA kernel), 1 = bfloat16
// (tensor-core kernel; pointers 16-byte aligned). Only dk = 64. Returns
// cudaGetLastError() after the launch.
extern "C" int l2s_attention(const void* q, const void* k, const void* v, const void* mask,
                             void* out, int B, int H, int T_len, int dk, int dtype,
                             void* stream) {
  if (dk != flash::kD || B < 1 || H < 1 || T_len < 1) return (int)cudaErrorInvalidValue;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = fma_path::launch(q, k, v, m, out, B, H, T_len, s);
  else if (dtype == 1)
    e = mma_path::launch(q, k, v, m, out, B, H, T_len, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
