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
// O(T) bytes: operations, on the tensor cores (bf16; f32 in 3xTF32, three
// TF32 products for each f32 one). In bf16 the position term costs one
// more product than that: each tile's G is computed over the 128 window
// rows its diagonals touch (two 64 x 64 x 64 products for 64 x 64 scores);
// f32 computes each 64-row window chunk once.
//
// Design. The TPU kernel's whole-row score residency and its log2 roll shear
// were Mosaic workarounds and are gone. The loop is flash_fwd_hopper.cuh's
// forward with the position term (its note gives the design): a producer
// warpgroup feeds Q_u, Q_v, and per key tile of 64 K, V and one 64-row
// chunk of the position table by TMA, and draws the dropout bits; two
// consumer warpgroups run every product on
// wgmma, the position term as G over the window rows the tile's diagonals
// touch, read back along the diagonal into the score accumulators.
//
// bf16 (dtype 1): 128 query rows a block, 64 for each consumer warpgroup
// against every key; S, G (hopper.cuh `position_band`, as the backward)
// and P V on wgmma m64n64k16, f32 accumulation, P rounded to bf16 in
// registers. Four stages, a six-chunk window ring, the warps' G bands:
// 194.1 KB of shared memory, 154 registers, one block (384 threads) an SM.
//
// f32 (dtype 0): 3xTF32, held to 1e-4 against the plain version, where one
// TF32 product (~1e-3 off) would not pass. 64 query rows a block: the
// consumer warpgroups take 32 keys of every tile each and merge at the
// end. The producer splits Q_u and Q_v once a block and K once a tile, and
// writes V^T split; S on wgmma m64n32k8, G^T = Win Q_v^T on m64n32k8 (each
// warpgroup its 32 query rows against window chunk t + 1, the window split
// in registers as A; each chunk once, its two halves exchanged sheared
// through shared memory), P V on m64n64k8. Two stages of K with their
// window chunk, one of V^T: 210.6 KB, 168 registers (a 24-byte spill), one
// block an SM.
//
// Bounds are checked, so T need not be a multiple of 64.

#include "flash_fwd_hopper.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(flash_fwd::kThreads, 1)
rel_attention_wgmma(const __grid_constant__ CUtensorMap tm_qu,
                    const __grid_constant__ CUtensorMap tm_qv,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_p, const flash_fwd::Args g) {
  flash_fwd::forward<T, true>(&tm_qu, &tm_qv, &tm_k, &tm_v, &tm_p, g);
}

}  // namespace

// All tensors contiguous: q_u, q_v, k, v, out (B, H, T, dk); p (H, 2T-1, dk);
// mask (B, T) uint8; lse (B, H, T) float32. dtype: 0 = float32 (3xTF32), 1 =
// bfloat16; pointers 16-byte aligned. Only dk = 64.
// rate in [0, 1) and seed select the dropout mask (rate 0: no dropout).
// Returns cudaGetLastError() after the launch.
extern "C" int l2s_rel_attention(const void* qu, const void* qv, const void* k,
                                 const void* v, const void* p, const void* mask, void* out,
                                 void* lse, int B, int H, int T_len, int dk, int dtype,
                                 float rate, unsigned long long seed, void* stream) {
  if (dk != flash::kD || B < 1 || H < 1 || T_len < 1 || B * H > 65535 || rate < 0.f ||
      rate >= 1.f)
    return (int)cudaErrorInvalidValue;
  flash_fwd::Args g;
  g.mask = static_cast<const uint8_t*>(mask);
  g.out = out;
  g.lse = static_cast<float*>(lse);
  g.H = H;
  g.T_len = T_len;
  g.scale = 1.0f / sqrtf((float)flash::kD);
  g.drop = philox::make_dropout(rate, seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)flash_fwd::launch<float, true>(rel_attention_wgmma<float>, qu, qv, k, v,
                                                      p, g, B, s);
  if (dtype == 1)
    return (int)flash_fwd::launch<mma::bf16, true>(rel_attention_wgmma<mma::bf16>, qu, qv,
                                                          k, v, p, g, B, s);
  return (int)cudaErrorInvalidValue;
}
