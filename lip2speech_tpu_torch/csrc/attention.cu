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
// bytes, so operations at long T (bf16 on the tensor cores; f32 in 3xTF32,
// three TF32 products for each f32 one); at the serving shapes (B4 H16
// T240: 128 bf16 blocks of 4 key tiles) the card is not full and the time
// is one block's latency: its loads, its key tiles and the launch.
//
// Design. The TPU kernel holds a head's whole K and V in VMEM and pads T to
// a block multiple; here a block owns a run of query rows of one (batch,
// head) and loops over key tiles of 64 with an online softmax, so shared
// memory does not grow with T (the unit extractor calls it at T = 5000) and
// nothing quadratic reaches device memory. The key mask is read as the (B,
// T) bytes it is, shared by the heads of a batch row; a null mask means
// every key is valid. The loop is flash_fwd_hopper.cuh's forward without
// the position term (its note gives the design): a producer warpgroup
// feeds Q, K and V by TMA into rings of stages on mbarriers, two consumer
// warpgroups run every product on wgmma.
//
// bf16 (dtype 1): 128 query rows a block, 64 for each consumer warpgroup
// against every key; S and P V on wgmma m64n64k16, P in registers. Four
// stages: 86.1 KB of shared memory, 142 registers, one block (384 threads)
// an SM.
//
// f32 (dtype 0): 3xTF32, held to 3e-5 against the plain version, which one
// TF32 product (~1e-4 to 1e-3 off) does not meet. 64 query rows a block;
// the two consumer warpgroups take alternate whole key tiles, each with its
// own online softmax, and merge at the end, so a block's serial path is
// half the tiles: the flagship's f32 request (B1 H16 T96) has 32 blocks on
// 132 SMs, unit extraction's B1 H12 T500 96. S on wgmma m64n64k8 with Q's
// fragments split in registers (m64n32k8 for a last tile of at most 32
// keys), K split by the producer once a tile, V^T written split by it; P V
// on m64n64k8. Three stages of K and two of V: 177.9 KB of shared memory,
// 128 registers, one block an SM.

#include "flash_fwd_hopper.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(flash_fwd::kThreads, 1)
attention_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap,
                const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap, const flash_fwd::Args g) {
  flash_fwd::forward<T, false>(&tm_q, &tm_q, &tm_k, &tm_v, &tm_q, g);
}

}  // namespace

// All tensors contiguous: q, k, v, out (B, H, T, dk); mask (B, T) uint8 or
// null (every key valid). dtype: 0 = float32 (3xTF32), 1 = bfloat16;
// pointers 16-byte aligned. Only dk = 64. Returns cudaGetLastError() after
// the launch.
extern "C" int l2s_attention(const void* q, const void* k, const void* v, const void* mask,
                             void* out, int B, int H, int T_len, int dk, int dtype,
                             void* stream) {
  if (dk != flash::kD || B < 1 || H < 1 || T_len < 1 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  flash_fwd::Args g;
  g.mask = static_cast<const uint8_t*>(mask);
  g.out = out;
  g.lse = nullptr;
  g.H = H;
  g.T_len = T_len;
  g.scale = 1.0f / sqrtf((float)flash::kD);
  g.drop = philox::make_dropout(0.f, 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)flash_fwd::launch<float, false>(attention_wgmma<float>, q, q, k, v, q, g, B, s);
  if (dtype == 1)
    return (int)flash_fwd::launch<mma::bf16, false>(attention_wgmma<mma::bf16>, q, q, k, v, q, g,
                                                    B, s);
  return (int)cudaErrorInvalidValue;
}
