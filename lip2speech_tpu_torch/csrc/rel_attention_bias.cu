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
// byte, far below the bf16 tensor cores' balance of ~295, so bf16 is bound
// by the bytes of the bias; in f32, 3xTF32 triples the products (768 T^2 at
// the TF32 rate), which puts operations and bytes about level (B8 H8 T1200:
// 0.143 ms either way on an H100).
//
// Design. The TPU kernel wants the bias re-tiled to (key block, row, 128
// lanes) because a dynamic slice along lanes costs shuffles there. Here the
// bias stays (T, T) rows. One block owns 64 query rows of one (batch, head)
// and loops over key tiles of 64 with an online softmax; bounds are checked,
// so T needs no padding.
//
// One kernel for both input types, `rel_attention_bias_mma<T>`: attention.cu's
// `attention_mma` loop plus one additive f32 tile per key tile (mma_tile.cuh);
// the type picks the tiles, the products and the epilogue's stores. 4 warps
// x 16 query rows; the Q_u fragments stay in registers; K and V arrive by
// 16-byte cp.async, double-buffered. The score is acc * scale + bias in f32
// (JAX: `ac * scale + b_blk`); the bias is never rounded. Then the mask, the
// online softmax on the fragments, the dropout keep factors (philox.cuh's
// counter mapped onto the fragment layout, `keep_frag`); P is the A operand
// of P V straight from its accumulator, the row sums and the LSE stay f32.
//   bf16 (dtype 1): S = Q_u K^T and O += P V on mma.sync m16n8k16 from
// swizzled tiles; P is rounded to bf16. 41.5 KB of shared memory and at most
// 168 registers: three blocks per SM.
//   f32 (dtype 0): the same loop in 3xTF32 on mma.sync m16n8k8 (each operand
// split into a TF32 hi, rounded as cvt.rna rounds, and an f32 lo = v - hi;
// lo_a hi_b + hi_a lo_b + hi_a hi_b with f32 accumulation, ~2^-21 of |a b|
// dropped), so the path is held to 1e-4 against the plain version, which
// one TF32 product (~3e-4 to 1e-3 off) does not meet. f32 tiles of 64 x 68
// floats; Q_u is staged through the second V stage and held unsplit in
// registers; P stays in registers as the A of P V (a k8 step takes its keys
// in the order 0, 2, 4, 6, 1, 3, 5, 7, where the m16n8 accumulator holds
// them, and V's rows are read in that order by single floats). 68.5 KB of
// shared memory and at most 255 registers (240 used): two blocks per SM.
// Three blocks (168 registers) spill ~250 bytes and took 0.862 ms at B8 H8
// T1200 against 0.525; the bias staged through shared memory by cp.async
// (double-buffered with K and V, 104.5 KB, 210 registers) took 0.571 (NVIDIA
// H100 80GB HBM3, 700 W).
//   The bias is streamed one key tile ahead, straight from device memory
// into the accumulator layout (`load_frag_f32`): each lane loads its 16
// pairs of adjacent floats as float2, so a quad reads one 32-byte sector,
// and the next tile's loads are issued as soon as the current tile's bias
// has been added, to land during the softmax, P V and the next Q_u K^T. It
// needs no shared memory and no barrier, its reads need no padding against
// bank conflicts, and a narrower load for odd T is only a template switch;
// the cost is 32 registers.
//   Alignment: a bias row is 4T bytes. For even T the rows are 8-byte
// aligned and the float2 loads are used; for odd T the launcher picks the
// single-float instantiation. That one serves every T, but the float2 one,
// with half the load instructions, is 10% faster in bf16 at B8 H8 T1200 and
// B4 H8 T480 on an H100, so both are built. No padded copy of the bias is
// made. Q_u, K, V and the output must be 16-byte aligned (cp.async), the
// bias 4-byte; a pointer that is not returns cudaErrorMisalignedAddress.

#include "mma_tile.cuh"

namespace {

using namespace mma;

template <typename T>
struct Fwd {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kMinBlocks = kBf16 ? 3 : 2;
  // bf16: a Q_u tile of its own; f32: Q_u staged through the second V stage
  static constexpr int kQTiles = kBf16 ? 1 : 0;
  // the Q_u tile, two stages of K and of V, two stages of mask flags
  static constexpr size_t kSmem =
      (size_t)(kQTiles + 4) * Tile<T>::kElems * sizeof(T) + (size_t)2 * kB * sizeof(float);
};

template <typename T, bool kVec2>
__global__ void __launch_bounds__(kThreads, Fwd<T>::kMinBlocks)
rel_attention_bias_mma(const T* __restrict__ qu, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ bias,
                       const uint8_t* __restrict__ mask, T* __restrict__ out,
                       float* __restrict__ lse, int H, int T_len, float scale,
                       philox::Dropout drop) {
  using F = Fwd<T>;
  constexpr int E = Tile<T>::kElems;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw) + F::kQTiles * E;   // two stages
  T* sV = sK + 2 * E;                                         // two stages
  float* sM = reinterpret_cast<float*>(sV + 2 * E);           // two stages
  T* sQ = F::kBf16 ? reinterpret_cast<T*>(smem_raw) : sV + E;

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

  RowsA<T> aq;
  if constexpr (!F::kBf16) {     // Q_u into registers before the second V stage is written
    cp_async_wait<0>();
    __syncthreads();
    aq.init(sQ, 16 * warp, lane);
    __syncthreads();
  }
  float o[8][4];
  zero(o);
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {       // stage t+1 was last read in tile t-1
      const int j1 = (t + 1) * kB;
      load_tile(sK + (st ^ 1) * E, k + base, j1, T_len);
      load_tile(sV + (st ^ 1) * E, v + base, j1, T_len);
      flash::load_mask(sM + (st ^ 1) * kB, mask_row, j1, T_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (F::kBf16) {
      if (t == 0) aq.init(sQ, 16 * warp, lane);
    }
    const T* kt = sK + st * E;
    const T* vt = sV + st * E;
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
    product_acc_nn(o, s, vt, lane);
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

template <typename T, bool kVec2>
cudaError_t launch_as(const void* qu, const void* k, const void* v, const float* bias,
                      const uint8_t* mask, void* out, float* lse, int B, int H, int T_len,
                      philox::Dropout drop, cudaStream_t stream) {
  auto kern = rel_attention_bias_mma<T, kVec2>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)Fwd<T>::kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid((T_len + kB - 1) / kB, B * H);
  kern<<<grid, kThreads, Fwd<T>::kSmem, stream>>>(
      static_cast<const T*>(qu), static_cast<const T*>(k), static_cast<const T*>(v), bias, mask,
      static_cast<T*>(out), lse, H, T_len, 1.0f / sqrtf((float)kD), drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* qu, const void* k, const void* v, const float* bias,
                   const uint8_t* mask, void* out, float* lse, int B, int H, int T_len,
                   philox::Dropout drop, cudaStream_t stream) {
  if (!aligned16({qu, k, v, out}) || reinterpret_cast<uintptr_t>(bias) % 4 != 0)
    return cudaErrorMisalignedAddress;
  if (T_len % 2 == 0 && reinterpret_cast<uintptr_t>(bias) % 8 == 0)
    return launch_as<T, true>(qu, k, v, bias, mask, out, lse, B, H, T_len, drop, stream);
  return launch_as<T, false>(qu, k, v, bias, mask, out, lse, B, H, T_len, drop, stream);
}

}  // namespace

// All tensors contiguous: q_u, k, v, out (B, H, T, dk); bias (B, H, T, T)
// float32; mask (B, T) uint8; lse (B, H, T) float32. dtype (of q_u, k, v,
// out): 0 = float32 (3xTF32), 1 = bfloat16; q_u, k, v, out 16-byte aligned,
// bias 4-byte. Only dk = 64. rate in [0, 1) and seed
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
    e = launch<float>(qu, k, v, bi, m, out, l, B, H, T_len, drop, s);
  else if (dtype == 1)
    e = launch<bf16>(qu, k, v, bi, m, out, l, B, H, T_len, drop, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
