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
// masked stay finite (a uniform average of V).
//
// What bounds it: the f32 bias is 4 T^2 bytes per (batch, head), read once,
// against two (T x T x 64) products, 256 T^2 operations: 64 operations a
// byte, far below the bf16 tensor cores' balance of ~295, so it is bound by
// the bytes of the bias.
//
// Design. The TPU kernel wants the bias re-tiled to (key block, row, 128
// lanes) because a dynamic slice along lanes costs shuffles there. Here the
// bias stays (T, T) rows. One block owns 64 query rows of one (batch, head)
// and loops over key tiles of 64 with an online softmax; bounds are checked,
// so T needs no padding.
//
// bf16 (dtype 1), `rel_attention_bias_mma`: attention.cu's `attention_mma`
// plus one additive f32 tile per key tile (mma_tile.cuh). 4 warps x 16
// query rows; the Q_u fragments stay in registers; K and V arrive by 16-byte
// cp.async into swizzled tiles, double-buffered; S = Q_u K^T and O += P V on
// mma.sync m16n8k16 with f32 accumulation. The score is acc * scale + bias
// in f32 (JAX: `ac * scale + b_blk`); the bias is never rounded. Then the
// mask, the online softmax on the fragments, the dropout keep factors
// (philox.cuh's counter mapped onto the fragment layout, `keep_frag`); P is
// rounded to bf16 as the A operand of P V, the row sums and the LSE stay f32.
//   The tile loop is a copy of attention_mma's, with rel_attention_mma's
// keep-factor and LSE code, not a template shared with them: one template
// with a per-tile score hook would recompile those two kernels, whose
// checks and times were to stay as measured. A fix to the shared staging,
// softmax or epilogue has to be made in all three.
//   The bias is streamed one key tile ahead, straight from device memory
// into the accumulator layout (`load_frag_f32`): each lane loads its 16
// pairs of adjacent floats as float2, so a quad reads one 32-byte sector,
// and the next tile's loads are issued as soon as the current tile's bias
// has been added, to land during the softmax, P V and the next Q_u K^T.
// This was chosen over a double-buffered 16 KB cp.async stage in shared
// memory because it needs no shared memory and no barrier, its reads need
// no padding against bank conflicts, and a narrower load for odd T is only a
// template switch; the cost is 32 registers. 16 KB in flight a block and
// three blocks per SM (41.5 KB of shared memory each, at most 168 registers)
// keep ~48 KB in flight per SM, above the ~30 KB that the card's bandwidth
// times its latency asks for.
//   Alignment: a bias row is 4T bytes. For even T the rows are 8-byte
// aligned and the float2 loads are used; for odd T the launcher picks the
// single-float instantiation. That one serves every T, but the float2 one,
// with half the load instructions, is 10% faster at B8 H8 T1200 and B4 H8
// T480 on an H100, so both are built. No padded copy of the bias is made.
// Q_u, K, V and the output must be 16-byte aligned (cp.async), the bias
// 4-byte; a pointer that is not returns cudaErrorMisalignedAddress.
//
// f32 (dtype 0), `rel_attention_bias_kernel`: the first version,
// unchanged on the CUDA cores (FP32 FMAs on f32 shared tiles, flash_tile.cuh;
// the bias read by each thread as its 4x4 tile), because the f32 path is
// held to 1e-4 against the CPU and TF32 cannot meet that.

#include "mma_tile.cuh"

namespace {

namespace mma_path {

using namespace mma;

// Q_u, two stages of K and of V, two stages of mask flags
constexpr size_t kSmem = (size_t)5 * kTile * sizeof(bf16) + (size_t)2 * kB * sizeof(float);

template <bool kVec2>
__global__ void __launch_bounds__(kThreads, 3)
rel_attention_bias_mma(const bf16* __restrict__ qu, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ bias,
                       const uint8_t* __restrict__ mask, bf16* __restrict__ out,
                       float* __restrict__ lse, int H, int T_len, float scale,
                       philox::Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kTile;         // two stages
  bf16* sV = sK + 2 * kTile;     // two stages
  float* sM = reinterpret_cast<float*>(sV + 2 * kTile);   // two stages

  const int bh = blockIdx.y, i0 = blockIdx.x * kB;
  const size_t base = (size_t)bh * T_len * kD;
  const float* bias_bh = bias + (size_t)bh * T_len * T_len;
  const uint8_t* mask_row = mask + (size_t)(bh / H) * T_len;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q4 = lane & 3;
  const int i_g = i0 + 16 * warp + (lane >> 2);   // the lane's first row
  const int n_tiles = (T_len + kB - 1) / kB;

  load_tile(sQ, qu + base, i0, T_len);
  load_tile(sK, k + base, 0, T_len);
  load_tile(sV, v + base, 0, T_len);
  flash::load_mask(sM, mask_row, 0, T_len);
  cp_async_commit();
  float bt[8][4];                // the bias of the lane's score elements, a tile ahead
  load_frag_f32<kVec2>(bt, bias_bh, T_len, i_g, 0, T_len, T_len, q4);

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
        s[n][e] = flash::mask_score(fmaf(s[n][e], scale, bt[n][e]), mt[8 * n + 2 * q4 + (e & 1)]);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    if (t + 1 < n_tiles)         // lands during the rest of this tile
      load_frag_f32<kVec2>(bt, bias_bh, T_len, i_g, (t + 1) * kB, T_len, T_len, q4);
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
    if (drop.thresh != 0u) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float kf[4];
        keep_frag(drop, (uint32_t)bh, i_g, t * kB + 8 * n + 2 * q4, q4, kf);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= kf[e];
      }
    }
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
    l = fmaxf(l, 1e-20f);
    inv[r] = 1.f / l;
    const int i = i_g + 8 * r;
    if (q4 == 0 && i < T_len) lse[(size_t)bh * T_len + i] = m_run[r] + logf(l);
  }
  store_rows(out + base, o, i_g, T_len, inv, q4);
}

template <bool kVec2>
cudaError_t launch_as(const void* qu, const void* k, const void* v, const float* bias,
                      const uint8_t* mask, void* out, float* lse, int B, int H, int T_len,
                      philox::Dropout drop, cudaStream_t stream) {
  auto kern = rel_attention_bias_mma<kVec2>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid((T_len + kB - 1) / kB, B * H);
  kern<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(qu), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, mask, static_cast<bf16*>(out), lse, H, T_len, 1.0f / sqrtf((float)kD), drop);
  return cudaGetLastError();
}

cudaError_t launch(const void* qu, const void* k, const void* v, const float* bias,
                   const uint8_t* mask, void* out, float* lse, int B, int H, int T_len,
                   philox::Dropout drop, cudaStream_t stream) {
  if (!aligned16({qu, k, v, out}) || reinterpret_cast<uintptr_t>(bias) % 4 != 0)
    return cudaErrorMisalignedAddress;
  if (T_len % 2 == 0 && reinterpret_cast<uintptr_t>(bias) % 8 == 0)
    return launch_as<true>(qu, k, v, bias, mask, out, lse, B, H, T_len, drop, stream);
  return launch_as<false>(qu, k, v, bias, mask, out, lse, B, H, T_len, drop, stream);
}

}  // namespace mma_path

namespace fma_path {

using namespace flash;

__global__ void __launch_bounds__(kThreads)
rel_attention_bias_kernel(const float* __restrict__ qu, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ bias,
                          const uint8_t* __restrict__ mask, float* __restrict__ out,
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
  write_out(out + base, lse + (size_t)bh * T_len, i0, T_len, ty, tx, st);
}

cudaError_t launch(const void* qu, const void* k, const void* v, const float* bias,
                   const uint8_t* mask, void* out, float* lse, int B, int H, int T_len,
                   philox::Dropout drop, cudaStream_t stream) {
  auto kern = rel_attention_bias_kernel;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kSmemBytes);
  if (e != cudaSuccess) return e;
  dim3 grid((T_len + kB - 1) / kB, B * H);
  kern<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(qu), static_cast<const float*>(k), static_cast<const float*>(v),
      bias, mask, static_cast<float*>(out), lse, H, T_len, 1.0f / sqrtf((float)kD), drop);
  return cudaGetLastError();
}

}  // namespace fma_path

}  // namespace

// All tensors contiguous: q_u, k, v, out (B, H, T, dk); bias (B, H, T, T)
// float32; mask (B, T) uint8; lse (B, H, T) float32. dtype (of q_u, k, v,
// out): 0 = float32 (FMA kernel), 1 = bfloat16 (tensor-core kernel; q_u, k,
// v, out 16-byte aligned, bias 4-byte). Only dk = 64. rate in [0, 1) and seed
// select the dropout mask (rate 0: no dropout). Returns cudaGetLastError()
// after the launch.
extern "C" int l2s_rel_attention_bias(const void* qu, const void* k, const void* v,
                                      const void* bias, const void* mask, void* out, void* lse,
                                      int B, int H, int T_len, int dk, int dtype, float rate,
                                      unsigned long long seed, void* stream) {
  if (dk != flash::kD || B < 1 || H < 1 || T_len < 1 || rate < 0.f || rate >= 1.f)
    return (int)cudaErrorInvalidValue;
  const philox::Dropout drop = philox::make_dropout(rate, seed);
  const float* bi = static_cast<const float*>(bias);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = fma_path::launch(qu, k, v, bi, m, out, l, B, H, T_len, drop, s);
  else if (dtype == 1)
    e = mma_path::launch(qu, k, v, bi, m, out, l, B, H, T_len, drop, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
