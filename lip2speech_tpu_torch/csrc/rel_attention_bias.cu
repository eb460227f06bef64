// Relative-position flash attention with the position term as an additive
// bias, forward, for Hopper (sm_90a).
//
// Replaces: lip2speech_tpu/ops/pallas_rel_attention.py, `_bias_kernel`
// (entry `_rel_flash_bias` -> `_flash_bias_impl`), forward, with its optional
// probability dropout (philox.cuh's mask, as in rel_attention.cu).
//
// Computes, per (batch, head), with q_u, k, v (T, 64) and bias (T, T) f32:
//     S[i, j] = q_u[i].k[j] / sqrt(64) + bias[i, j]
// keys with mask 0 score -1e30, keys past T -inf, then O = softmax_j(S) V and
// the per-row natural-log log-sum-exp. The caller builds the bias,
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
// bias stays (T, T) rows, and the loop is flash_fwd_hopper.cuh's forward
// with its bias variant (kBias; its note gives the design): a producer
// warpgroup feeds Q_u once and per key tile of 64 K and V by TMA into rings
// of stages, with the key flags and the dropout keep bits; two consumer
// warpgroups run every product on wgmma with an online softmax in log2
// units, S = acc scale log2(e) + bias log2(e) (one fma, the f32 bias never
// rounded before it).
//   The bias stream. In bf16 the f32 bias is ~90% of the bytes at T1200.
// Each consumer thread loads the bias of its own score elements straight
// from device memory into the wgmma accumulator layout one tile ahead
// (mma_tile.cuh `load_frag_f32`, streaming loads; a quad reads one 32-byte
// sector of a row), the choice (a) of the two designs weighed: it works at
// any T, where a TMA box of the bias needs a row stride that is a multiple
// of 16 bytes (T % 4 == 0; the main paths also run T 470 and 235), needs no
// shared memory and no barrier, and costs 32 registers a thread, which
// setmaxnreg moves from the producer warpgroup to the consumers. On
// mma.sync the same loads beat the bias staged through shared memory
// (0.525 against 0.571 ms in f32 at B8 H8 T1200, NVIDIA H100 80GB HBM3,
// 700 W). For even T and an 8-byte aligned bias the loads are float2
// (kBias 2), else single floats (kBias 1); both are built.
//
// bf16 (dtype 1): 128 query rows a block, 64 for each consumer warpgroup
// against every key of a tile; S = Q_u K^T and P V on wgmma m64n64k16, f32
// accumulation, P rounded to bf16 in registers. Four stages of K and V:
// 86.1 KB of shared memory, 168 registers, no spill.
//
// f32 (dtype 0): 3xTF32, held to 1e-4 against the plain version, where one
// TF32 product (~1e-3 off) would not pass. 64 query rows a block; the two
// consumer warpgroups take alternate whole key tiles with their own online
// softmax and merge at the end. The producer splits K once a tile, writes
// V^T split, and under dropout draws the keep bits beside K. S on wgmma
// m64n64k8 with Q's fragments split in registers, P V on m64n64k8. Three
// stages of K, two of V^T: 179.4 KB, 168 registers, no spill.
//   ptxas reports no wgmma serialization (C7510-C7515) in any
// instantiation. Read against the mma.sync kernel it replaces, in one
// process (NVIDIA H100 80GB HBM3, 700 W): bf16 0.0193 / 0.177 ms at B4 H8
// T480 ragged / B8 H8 T1200 against 0.0235 / 0.220, f32 0.0379 / 0.395
// against 0.0500 / 0.520. SDPA with the same bias in bf16 stays faster
// (0.0159 / 0.158): it reads the bias in bf16, half the bytes that bind
// this kernel.
//
// Bounds are checked, so T need not be a multiple of 64 or of 4.

#include "flash_fwd_hopper.cuh"

namespace {

template <typename T, int kBias>
__global__ void __launch_bounds__(flash_fwd::kThreads, 1)
rel_attention_bias_wgmma(const __grid_constant__ CUtensorMap tm_qu,
                         const __grid_constant__ CUtensorMap,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap, const flash_fwd::Args g) {
  flash_fwd::forward<T, false, kBias>(&tm_qu, &tm_qu, &tm_k, &tm_v, &tm_qu, g);
}

template <typename T>
cudaError_t launch(const void* qu, const void* k, const void* v, const flash_fwd::Args& g, int B,
                   cudaStream_t stream) {
  if (g.T_len % 2 == 0 && reinterpret_cast<uintptr_t>(g.bias) % 8 == 0)
    return flash_fwd::launch<T, false, 2>(rel_attention_bias_wgmma<T, 2>, qu, qu, k, v, qu, g, B,
                                          stream);
  return flash_fwd::launch<T, false, 1>(rel_attention_bias_wgmma<T, 1>, qu, qu, k, v, qu, g, B,
                                        stream);
}

}  // namespace

// All tensors contiguous: q_u, k, v, out (B, H, T, dk); bias (B, H, T, T)
// float32; mask (B, T) uint8; lse (B, H, T) float32. dtype (of q_u, k, v,
// out): 0 = float32 (3xTF32), 1 = bfloat16; q_u, k, v, out 16-byte aligned,
// bias 4-byte. Only dk = 64, B * H <= 65535. rate in [0, 1) and seed
// select the dropout mask (rate 0: no dropout). Returns cudaGetLastError()
// after the launch.
extern "C" int l2s_rel_attention_bias(const void* qu, const void* k, const void* v,
                                      const void* bias, const void* mask, void* out, void* lse,
                                      int B, int H, int T_len, int dk, int dtype, float rate,
                                      unsigned long long seed, void* stream) {
  if (dk != flash::kD || B < 1 || H < 1 || T_len < 1 || B * H > 65535 || rate < 0.f ||
      rate >= 1.f)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(bias) % 4 != 0) return (int)cudaErrorMisalignedAddress;
  flash_fwd::Args g;
  g.mask = static_cast<const uint8_t*>(mask);
  g.bias = static_cast<const float*>(bias);
  g.out = out;
  g.lse = static_cast<float*>(lse);
  g.H = H;
  g.T_len = T_len;
  g.scale = 1.0f / sqrtf((float)flash::kD);
  g.drop = philox::make_dropout(rate, seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(qu, k, v, g, B, s);
  if (dtype == 1) return (int)launch<mma::bf16>(qu, k, v, g, B, s);
  return (int)cudaErrorInvalidValue;
}
