// Relative-position flash attention with the position term as an additive
// bias, backward, for Hopper (sm_90a).
//
// Replaces: lip2speech_tpu/ops/pallas_rel_attention.py, `_bias_bwd_kernel`
// (entry `_flash_bias_bwd_impl`), with its replay of the forward's dropout
// mask.
//
// Computes, per (batch, head), from the forward's inputs, its output O, its
// log-sum-exp and the upstream gradient dO, with S as in
// rel_attention_bias.cu:
//     P = exp(S - lse),  D = rowsum(dO o O),  dPr = dO V^T (o keep / (1-rate))
//     dbias = P o (dPr - D)                    (B, H, T, T) f32, unscaled
//     dQ_u = dbias K / sqrt(64)    dK = dbias^T Q_u / sqrt(64)    dV = P~^T dO
// Rows that had no valid key (lse below -1e30 / 2) get zero gradient. The
// gradients of q_v and of the position table flow through the caller's
// construction of the bias, outside the kernel.
//
// What bounds it: the f32 bias read and dbias written, 8 T^2 bytes per
// (batch, head), against five (T x T x 64) products, 640 T^2 operations:
// 80 operations a byte, below the bf16 tensor cores' balance of ~295, so
// bf16 is bound by bytes, as long as the bias is read once; f32 in 3xTF32
// does three TF32 products for each, 1920 T^2 at the TF32 rate: operations
// (B8 H8 T1200: 0.358 ms against 0.267 of bytes on an H100).
//
// Design. The TPU kernel is one sequential program per (batch, head) that
// carries dK and dV across query blocks and wants bias and dbias re-tiled to
// (key block, row, 128 lanes). Here bias and dbias stay (T, T) rows, and a
// row-dot pre-pass (flash_bwd_tile.cuh) writes D from the forward's output.
// Then one key-major pass, `rel_bias_bwd_wgmma<T, kVec2>`, built like
// rel_attention_bwd.cu without the position term: a block owns 64 keys of
// one (batch, head) and walks over the query tiles of 64 with a producer
// warpgroup and consumer warpgroups (hopper.cuh): two in f32, three in
// bf16.
//   The producer's first thread TMA-loads K and V once, then per query tile
// Q_u and dO into a ring of kS stages on full / empty mbarriers; under
// dropout all 128 producer threads draw the tile's keep bits (philox.cuh:
// the forward's mask, `keep_half`) before the stage is free and leave one
// word per consumer thread in it.
//   The bias stream. Each consumer thread loads the bias of its own score
// elements straight from device memory into the accumulator layout one
// tile ahead (mma_tile.cuh `load_frag_f32`, streaming loads, a quad one
// 32-byte sector of a row) and writes dbias, the f32 dS before the scale
// and any rounding, straight from the accumulators (`store_frag_f32`):
// float2 for even T and 8-byte aligned bias and dbias, single floats else
// (both built), at any T, where a TMA box needs a row stride that is a
// multiple of 16 bytes. Every (i, j) is written by exactly one block and
// tile, so dbias needs no zeroing and nothing past T is written; the bias
// is read once and dbias written once, the byte floor. P = exp2(S scale
// log2(e) + bias log2(e) - lse log2(e)), the score in the forward's own log2
// units (one fma on the unrounded f32 bias).
//   dK, dV and dbias are deterministic. dQ_u is a sum over the key blocks
// in a zeroed f32 buffer, so its last bits may differ between runs (in bf16
// then rounded).
//   bf16 (dtype 1): 512 threads, every product on wgmma m64n64k16 with f32
// accumulators, the work split by role:
//     score warpgroups 0 and 1, on alternate query tiles: S = Q_u K^T and
//       dPr = dO V^T (K-major operands, as TMA lays them out); P, dbias, dS
//       and P~ on the accumulators (the tile's bias and its rows' LSE and
//       D loaded two tiles ahead, the warpgroup's next tile); dbias to
//       device memory; P~ and dS rounded to bf16 into the warpgroup's pair
//       buffer ([query][key] tiles) on pair_full / pair_empty mbarriers.
//     the gradient warpgroup 2, over every tile in order: dV += P~^T dO,
//       dK += dS^T Q_u (both operands MN-major) and dQ_u = dS K (K
//       MN-major) as one wgmma group; dQ_u staged as a swizzled f32 tile
//       and added to the buffer by a TMA bulk reduction (cp.reduce.async.
//       bulk .add.f32, which skips rows past T).
// The bias stream and the dbias stores bound it (one part switched off at
// a time, B8 H8 T1200: without the dbias stores 0.451 ms, without the bias
// loads 0.525, without the gradient products 0.609, without the dQ_u
// reduction 0.625, against 0.630 with one score warpgroup), so two
// warpgroups carry it: 0.482 ms. A score warpgroup holds the scores and
// the bias (96 accumulator registers), the gradient warpgroup dK, dV and
// dQ_u (96), under ptxas's 128-register cap of 512 threads (a 20-52 byte
// spill). Each of two warpgroups taking whole alternate tiles with all
// five products (dK and dV in both, added at the end) spilled 368-676
// bytes under the 168-register cap of 384 threads and read 0.81 ms; the
// bias loaded two tiles ahead by one score warpgroup 0.66 (NVIDIA H100
// 80GB HBM3, 700 W). Four stages: 131.4 KB of shared memory. ptxas
// injects a warpgroup.arrive (C7519) at four points of the bf16
// instantiations, and no wait and no serialization (C7510-C7515).
//   f32 (dtype 0): 3xTF32 (mma_tile.cuh: hi = v rounded to TF32, lo = v -
// hi, lo hi + hi lo + hi hi, f32 sums; held to 1e-4 of the plain version
// and DBIAS_TOL, where one TF32 product, ~1e-3 off, fails). Both
// warpgroups work on each tile, each on 32 of the keys: S = Q_u K^T and
// dPr = dO V^T on wgmma m64n32k8, A split in registers from the stage and
// B split once a block in shared memory (hi in place, lo beside); its part
// of dQ_u = dS K on wgmma m64n64k8, dS split in registers as A (the keys of
// a k8 step in the order 0, 2, 4, 6, 1, 3, 5, 7, where the accumulator
// holds them) and K^T split once a block as B (keys in that order; TF32
// wgmma reads B only K-major), the two parts added in a fixed order
// through shared memory and to the buffer by four-float reductions. dK +=
// dS^T Q_u and dV += P~^T dO reduce over the tile's queries: on wgmma they
// would need transposed split copies of Q_u and dO each tile (TF32 wgmma
// reads both shared operands K-major only), and the shear backward's A/B
// of that design (rel_attention_bwd.cu's note) read them slower there than
// on mma.sync. So these two stay on mma.sync m16n8k8,
// each warpgroup on 32 of the channels, from P~ and dS stored transposed
// ([key][query], row stride 72) and read as A by float2 in the k8 order.
// dQ_u on mma.sync read 1.49 / 1.50 ms at B8 H8 T1200 against 1.28 / 1.29 on
// wgmma (0.141 against 0.125 at B4 H8 T480; NVIDIA H100 80GB HBM3, 700 W).
// Two stages: 214.3 KB, 168 registers, a 28-168 byte spill (the dQ_u
// accumulators), no serialization.
//   Every shared pointer derives from the dynamic shared array by offsets
// (LDS / STS, no generic accesses). The producer warpgroup gives up
// registers (setmaxnreg 40; the consumers 152 in bf16, 232 in f32).
//
// Bounds are checked: any T, B * H up to 65,535.

#include "flash_bwd_tile.cuh"
#include "flash_fwd_hopper.cuh"

namespace {

using namespace mma;
namespace hp = hopper;
using hp::kLog2e;
using hp::warp_index;

// Shared memory, byte offsets from a 1024-aligned base.
template <typename T>
struct Layout;

// bf16: K, V; stages of (Q_u, dO); each score warpgroup's pair buffer (P~,
// dS); the gradient warpgroup's dQ_u staging tile
template <>
struct Layout<bf16> {
  static constexpr int kThreads = 512;
  static constexpr int kS = 4;
  static constexpr int TB = kTile * 2;                 // a 64 x 64 bf16 tile
  static constexpr int kStageBytes = 2 * TB;
  static constexpr int kK = 0, kV = TB;
  static constexpr int kStage = 2 * TB;                // [kS] x (Q_u, dO)
  static constexpr int kPair = kStage + kS * kStageBytes;   // [2] x (P~, dS)
  static constexpr int kStaging = kPair + 2 * 2 * TB;       // f32 64 x 64
  static constexpr int kFlags = kStaging + kB * kD * 4;
  static constexpr int kKeep = kFlags + kB * 4;             // [kS] x 128 dropout words
  // full[kS] empty[kS] kv pair_full[2] pair_empty[2]
  static constexpr int kBars = kKeep + kS * 512;
  static constexpr int kSmem = kBars + (2 * kS + 5) * 8 + 1024;   // + alignment slack
  static_assert(kSmem <= 232448, "shared memory of one block");
};

// f32: K, V split once (hi in place, lo beside); stages of (Q_u, dO) as they
// landed; P~^T and dS^T [key][query]
template <>
struct Layout<float> {
  static constexpr int kThreads = 384;
  static constexpr int kS = 2;
  static constexpr int TB = kB * kD * 4;               // two swizzled halves of 32 channels
  static constexpr int kStageBytes = 2 * TB;
  static constexpr int kK = 0, kV = TB, kKlo = 2 * TB, kVlo = 3 * TB;
  static constexpr int kKT = 4 * TB;                   // K^T hi, lo (keys in k8 order)
  static constexpr int kStage = 6 * TB;                // [kS] x (Q_u, dO)
  static constexpr int kPair = kStage + kS * kStageBytes;
  static constexpr int kStaging = kPair + 2 * kB * kPtLd * 4;   // warpgroup 1's dQ_u part
  static constexpr int kFlags = kStaging + kB * kD * 4;
  static constexpr int kKeep = kFlags + kB * 4;
  static constexpr int kBars = kKeep + kS * 512;
  static constexpr int kSmem = kBars + (2 * kS + 1) * 8 + 1024;
  static_assert(kSmem <= 232448, "shared memory of one block");
};

struct Bars {
  uint64_t *full, *empty, *kv, *pfull, *pempty;
};

template <typename T>
struct Args {
  const float* bias;
  float* dbias;
  const uint8_t* mask;
  const float *lse, *delta;
  float* dqu;   // f32 sums, zeroed by the caller
  T *dk, *dv;
  int H, T_len;
  float scale;
  philox::Dropout drop;
};

// ---------------------------------------------------------------------------
// producer
// ---------------------------------------------------------------------------

// The producer warpgroup: its first thread issues the TMA loads; under
// dropout all its threads draw the tile's keep bits before the stage is
// free and write them into it after. A stage's full barrier takes two
// arrivals (the loads' and the bits') and the loads' bytes.
template <typename T>
__device__ __forceinline__ void produce(const CUtensorMap* tm_qu, const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, const CUtensorMap* tm_do,
                                        unsigned char* sm, const Bars& br, const Args<T>& g,
                                        int bh, int j0) {
  using L = Layout<T>;
  const int pt = threadIdx.x - (L::kThreads - 128), n_tiles = (g.T_len + kB - 1) / kB;
  const bool drop = g.drop.thresh != 0u;
  if (pt == 0) {
    hp::mbar_expect_tx(br.kv, 2 * L::TB);
    hp::tma_tile<T>(sm + L::kK, tm_k, br.kv, j0, bh);
    hp::tma_tile<T>(sm + L::kV, tm_v, br.kv, j0, bh);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % L::kS;
    uint32_t even = 0u, odd = 0u;
    if (drop) hp::keep_half(even, odd, g.drop, bh, kB * t, j0, pt);
    if (t >= L::kS) hp::mbar_wait(&br.empty[s], ((t / L::kS) - 1) & 1);
    if (pt == 0) {
      unsigned char* st = sm + L::kStage + s * L::kStageBytes;
      hp::mbar_expect_tx(&br.full[s], 2 * L::TB);
      hp::tma_tile<T>(st, tm_qu, &br.full[s], kB * t, bh);
      hp::tma_tile<T>(st + L::TB, tm_do, &br.full[s], kB * t, bh);
    }
    if (drop) {   // rows g + 8 into the high halves
      const uint32_t e8 = __shfl_xor_sync(0xffffffffu, even, 1);
      const uint32_t o8 = __shfl_xor_sync(0xffffffffu, odd, 1);
      if ((pt & 1) == 0) {
        const int p = pt >> 1;
        uint32_t* words = reinterpret_cast<uint32_t*>(sm + L::kKeep + s * 512) +
                          32 * (p >> 4) + 4 * ((p >> 1) & 7) + 2 * (p & 1);
        words[0] = even | (e8 << 16);
        words[1] = odd | (o8 << 16);
      }
    }
    hp::named_barrier(3, 128);
    if (pt == 0) hp::mbar_arrive(&br.full[s]);
  }
}

// ---------------------------------------------------------------------------
// consumers: what both types share
// ---------------------------------------------------------------------------

// The lane's two rows' log-sum-exp times log2(e), +inf for rows that had no
// valid key (lse below -1e30 / 2) or lie past the sequence (probabilities
// 0), and D.
template <typename T>
__device__ __forceinline__ void row_stats(const Args<T>& g, int bh, int i_g, float lse2[2],
                                          float delta[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i_g + 8 * r;
    const float l = i < g.T_len ? g.lse[(size_t)bh * g.T_len + i] : -INFINITY;
    lse2[r] = l > 0.5f * flash::kMasked ? l * kLog2e : INFINITY;
    delta[r] = i < g.T_len ? g.delta[(size_t)bh * g.T_len + i] : 0.f;
  }
}

// Bit 2n + e set where the lane's key 8n + 2q + e of the tile's columns is
// valid (sM: their flags).
template <int NT>
__device__ __forceinline__ uint32_t key_bits(const float* sM, int q) {
  uint32_t bits = 0;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (sM[8 * n + 2 * q + e] > 0.f) bits |= 1u << (2 * n + e);
  return bits;
}

// From the unscaled scores s, the bias bt and dpr = dO V^T of the warp's 16
// x 8 NT pair tile: s becomes dbias = P o (dpr * keep - D), f32 and
// unscaled, and dpr P~ = P * keep, with P = exp2(s scale log2(e) + bias
// log2(e) - lse2), 0 on invalid keys. Under dropout keep comes from the
// lane's keep word (`keep_half`), whose n-tiles n0 .. are the tile's columns.
template <int NT, typename T>
__device__ __forceinline__ void bias_grads(float (&s)[NT][4], float (&dpr)[NT][4],
                                           const float (&bt)[NT][4], uint32_t kbits, uint32_t keep,
                                           int n0, const Args<T>& g, const float lse2[2],
                                           const float delta[2]) {
  const float sl2 = g.scale * kLog2e;
  const bool drop = g.drop.thresh != 0u;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float kf =
          drop ? ((keep >> (16 * r + 2 * (n0 + n) + (e & 1))) & 1u ? g.drop.inv_keep : 0.f) : 1.f;
      const float prob = (kbits >> (2 * n + (e & 1))) & 1u
                             ? exp2f(fmaf(s[n][e], sl2, bt[n][e] * kLog2e) - lse2[r]) : 0.f;
      s[n][e] = prob * (dpr[n][e] * kf - delta[r]);
      dpr[n][e] = prob * kf;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: every product on wgmma; score warpgroup c takes query tiles c, c +
// 2, .. and hands P~ and dS to the gradient warpgroup through pair buffer c
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t dsc(const bf16* p) { return hp::desc_sw128(p); }

// A warp's share of a 64 x 64 f32 accumulator into a swizzled f32 tile
__device__ __forceinline__ void stage_tile(float* st, const float (&acc)[8][4], int w, int lane) {
  const int r = 16 * w + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<float2*>(st + hp::sw32(r, 8 * n + c)) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(st + hp::sw32(r + 8, 8 * n + c)) = make_float2(acc[n][2], acc[n][3]);
  }
}

// Score warpgroup c: S, dPr, dbias, P~ and dS of tiles c, c + 2, ..
template <bool kVec2>
__device__ __forceinline__ void consume_scores(const Args<bf16>& g, unsigned char* sm,
                                               const Bars& br, int bh, int j0) {
  using L = Layout<bf16>;
  const int ct = threadIdx.x & 127, w = warp_index() & 3, c = warp_index() >> 2;
  const int lane = ct & 31, q = lane & 3, gq = lane >> 2;
  const int T_len = g.T_len, n_tiles = (T_len + kB - 1) / kB;
  const float* bias_bh = g.bias + (size_t)bh * T_len * T_len;
  float* dbias_bh = g.dbias + (size_t)bh * T_len * T_len;
  const bf16* sK = reinterpret_cast<const bf16*>(sm + L::kK);
  const bf16* sV = reinterpret_cast<const bf16*>(sm + L::kV);
  const uint32_t kbits = key_bits<8>(reinterpret_cast<const float*>(sm + L::kFlags), q);

  float bt[8][4], lse2[2], delta[2];   // the tile's bias and row statistics, loaded ahead
  if (c < n_tiles) {
    load_frag_f32<kVec2, 8>(bt, bias_bh, T_len, kB * c + 16 * w + gq, j0, T_len, T_len, q);
    row_stats(g, bh, kB * c + 16 * w + gq, lse2, delta);
  }
  hp::mbar_wait(br.kv, 0);
  for (int t = c; t < n_tiles; t += 2) {
    const int s = t % L::kS, b = t & 1, i_g = kB * t + 16 * w + gq;
    hp::mbar_wait(&br.full[s], (t / L::kS) & 1);
    const bf16* sQu = reinterpret_cast<const bf16*>(sm + L::kStage + s * L::kStageBytes);
    const bf16* sdO = sQu + kTile;
    float sc[8][4], dpr[8][4];
    zero<8>(sc);
    zero<8>(dpr);
    hp::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) hp::wgmma_bf16_ss<0, 0>(sc, dsc(sQu + 16 * ks), dsc(sK + 16 * ks));
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) hp::wgmma_bf16_ss<0, 0>(dpr, dsc(sdO + 16 * ks), dsc(sV + 16 * ks));
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_acc(sc);
    hp::fence_acc(dpr);
    hp::mbar_arrive(&br.empty[s]);   // this warpgroup's reads of the stage are done
    const uint32_t keep = g.drop.thresh != 0u
        ? reinterpret_cast<const uint32_t*>(sm + L::kKeep + s * 512)[ct] : 0u;
    bias_grads<8>(sc, dpr, bt, kbits, keep, 0, g, lse2, delta);   // sc: dbias; dpr: P~
    store_frag_f32<kVec2, 8>(dbias_bh, sc, T_len, i_g, j0, T_len, T_len, q);
    if (t + 2 < n_tiles) {   // the warpgroup's next tile's: land during this one
      load_frag_f32<kVec2, 8>(bt, bias_bh, T_len, i_g + 2 * kB, j0, T_len, T_len, q);
      row_stats(g, bh, i_g + 2 * kB, lse2, delta);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] *= g.scale;   // dS
    // P~ and dS to pair buffer b (= c), once the gradient warpgroup has read it (tile t - 2)
    if (t >= 2) hp::mbar_wait(&br.pempty[b], ((t >> 1) - 1) & 1);
    bf16* pPd = reinterpret_cast<bf16*>(sm + L::kPair + b * 2 * L::TB);
    store_pair<8>(pPd, pPd + kTile, dpr, sc, w, 0, lane);
    hp::fence_proxy_async();
    hp::named_barrier(1 + c, 128);
    hp::mbar_arrive(&br.pfull[b]);
  }
}

// The gradient warpgroup, over every tile in order: dV, dK and the tile's
// dQ_u, added to the f32 buffer
__device__ __forceinline__ void consume_grads(const Args<bf16>& g, const CUtensorMap* tm_dqu,
                                              unsigned char* sm, const Bars& br, int bh, int j0) {
  using L = Layout<bf16>;
  const int ct = threadIdx.x & 127, w = warp_index() & 3;
  const int lane = ct & 31, q = lane & 3, gq = lane >> 2;
  const bool lead = ct == 0;   // issues the reductions
  const int T_len = g.T_len, n_tiles = (T_len + kB - 1) / kB;
  const bf16* sK = reinterpret_cast<const bf16*>(sm + L::kK);
  float* stq = reinterpret_cast<float*>(sm + L::kStaging);
  float dk[8][4], dv[8][4];
  zero<8>(dk);
  zero<8>(dv);
  hp::mbar_wait(br.kv, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % L::kS, b = t & 1;
    hp::mbar_wait(&br.full[s], (t / L::kS) & 1);
    hp::mbar_wait(&br.pfull[b], (t >> 1) & 1);
    const bf16* sQu = reinterpret_cast<const bf16*>(sm + L::kStage + s * L::kStageBytes);
    const bf16* sdO = sQu + kTile;
    const bf16* pPd = reinterpret_cast<const bf16*>(sm + L::kPair + b * 2 * L::TB);
    const bf16* pdS = pPd + kTile;
    // dV += P~^T dO, dK += dS^T Q_u, dQ_u = dS K
    float dq[8][4];
    zero<8>(dq);
    hp::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      hp::wgmma_bf16_ss<1, 1>(dv, dsc(pPd + ks * 16 * kD), dsc(sdO + ks * 16 * kD));
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      hp::wgmma_bf16_ss<1, 1>(dk, dsc(pdS + ks * 16 * kD), dsc(sQu + ks * 16 * kD));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hp::wgmma_bf16_ss<0, 1>(dq, dsc(pdS + 16 * kk), dsc(sK + kk * 16 * kD));
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_acc(dv);
    hp::fence_acc(dk);
    hp::fence_acc(dq);
    hp::mbar_arrive(&br.pempty[b]);
    hp::mbar_arrive(&br.empty[s]);
    // dQ_u to its f32 sum, once the staging tile's last reduction has read it
    if (lead) hp::bulk_wait_read<0>();
    hp::named_barrier(4, 128);
    stage_tile(stq, dq, w, lane);
    hp::fence_proxy_async();
    hp::named_barrier(4, 128);
    if (lead) {
      hp::tma_reduce_add_3d(tm_dqu, stq, 0, kB * t, bh);
      hp::tma_reduce_add_3d(tm_dqu, stq + 2048, 32, kB * t, bh);
      hp::bulk_commit();
    }
  }
  const float one[2] = {1.f, 1.f};
  const size_t base = (size_t)bh * T_len * kD;
  store_rows<8>(g.dk + base, dk, j0 + 16 * w + gq, T_len, one, q);
  store_rows<8>(g.dv + base, dv, j0 + 16 * w + gq, T_len, one, q);
  if (lead) hp::bulk_wait<0>();
}

// ---------------------------------------------------------------------------
// f32: 3xTF32. Both warpgroups work on each tile: the scores of half the
// keys each on wgmma, then the mma.sync products on half the channels each.
// ---------------------------------------------------------------------------

// B fragments of 4 n-tiles (columns c0 + 8n, rows r0 and r0 + 1 of a k8
// step in the order 0, 2, 4, 6, 1, 3, 5, 7) of a swizzled tile, split
__device__ __forceinline__ void b_rows_split(uint32_t bh[4][2], uint32_t bl[4][2],
                                             const float* tile, int r0, int c0) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
    split_b(tile[hp::sw32(r0, c0 + 8 * n)], tile[hp::sw32(r0 + 1, c0 + 8 * n)], bh[n], bl[n]);
}

template <bool kVec2>
__device__ __forceinline__ void consume_f32(const Args<float>& g, unsigned char* sm, const Bars& br,
                                            int bh, int j0) {
  using L = Layout<float>;
  const int tid = threadIdx.x, c = warp_index() >> 2, w = warp_index() & 3, lane = tid & 31;
  const int q = lane & 3, gq = lane >> 2, kw = 32 * c;
  const int T_len = g.T_len, n_tiles = (T_len + kB - 1) / kB;
  const size_t base = (size_t)bh * T_len * kD;
  const float* bias_bh = g.bias + (size_t)bh * T_len * T_len;
  float* dbias_bh = g.dbias + (size_t)bh * T_len * T_len;
  float* sKh = reinterpret_cast<float*>(sm + L::kK);
  float* sVh = reinterpret_cast<float*>(sm + L::kV);
  float* sKl = reinterpret_cast<float*>(sm + L::kKlo);
  float* sVl = reinterpret_cast<float*>(sm + L::kVlo);
  float* sPdT = reinterpret_cast<float*>(sm + L::kPair);
  float* sdST = sPdT + kB * kPtLd;
  const uint32_t kbits = key_bits<4>(reinterpret_cast<const float*>(sm + L::kFlags) + kw, q);

  float dk[4][4], dv[4][4], bt[4][4];
  zero<4>(dk);
  zero<4>(dv);
  load_frag_f32<kVec2, 4>(bt, bias_bh, T_len, 16 * w + gq, j0 + kw, T_len, T_len, q);
  float* sKT = reinterpret_cast<float*>(sm + L::kKT);
  float* stq = reinterpret_cast<float*>(sm + L::kStaging);
  hp::mbar_wait(br.kv, 0);
  if (tid < 128) {   // K^T split, the keys of each k8 step in the order 0, 2, 4, 6, 1, 3, 5, 7
    float x[32];
    flash_fwd::load_v(x, sKh, tid);
    flash_fwd::store_vt(x, sKT, sKT + kB * kD, tid);
  }
  hp::named_barrier(1, 256);   // K is read before it is split in place
  hp::split_tile(sKh, sKl, tid);
  hp::split_tile(sVh, sVl, tid);
  hp::fence_proxy_async();
  hp::named_barrier(1, 256);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % L::kS, i_g = kB * t + 16 * w + gq;
    hp::mbar_wait(&br.full[s], (t / L::kS) & 1);
    const float* sQu = reinterpret_cast<const float*>(sm + L::kStage + s * L::kStageBytes);
    const float* sdO = sQu + kB * kD;
    float lse2[2], delta[2];
    row_stats(g, bh, i_g, lse2, delta);
    float sc[4][4], dpr[4][4];
    zero<4>(sc);
    zero<4>(dpr);
    hp::wgmma_nt32(sc, sQu, sKh + kw * 32, sKl + kw * 32, w, lane);
    hp::wgmma_nt32(dpr, sdO, sVh + kw * 32, sVl + kw * 32, w, lane);
    const uint32_t keep = g.drop.thresh != 0u
        ? reinterpret_cast<const uint32_t*>(sm + L::kKeep + s * 512)[tid & 127] : 0u;
    bias_grads<4>(sc, dpr, bt, kbits, keep, 4 * c, g, lse2, delta);   // sc: dbias; dpr: P~
    store_frag_f32<kVec2, 4>(dbias_bh, sc, T_len, i_g, j0 + kw, T_len, T_len, q);
    if (t + 1 < n_tiles)
      load_frag_f32<kVec2, 4>(bt, bias_bh, T_len, i_g + kB, j0 + kw, T_len, T_len, q);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] *= g.scale;   // dS
    // the warpgroup's part of dQ_u = dS K over its 32 keys, on wgmma: dS
    // split in registers as A, K^T split as B
    float dq[8][4];
    zero<8>(dq);
    flash_fwd::pv<4>(dq, sc, sKT, 4 * c);
    hp::named_barrier(1, 256);   // the last tile's reads of the pair and staging tiles are done
    store_pair<4>(sPdT, sdST, dpr, sc, w, kw, lane);
    const int ct = tid & 127;
    if (c == 1) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) stq[(4 * n + e) * 128 + ct] = dq[n][e];
    }
    hp::named_barrier(1, 256);
    if (c == 0) {   // the two parts, in a fixed order, to the f32 sum
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[n][e] += stq[(4 * n + e) * 128 + ct];
      red_add_rows<8>(dq, g.dqu + base, kB * t + 16 * w, T_len, lane);
    }
    // dK += dS^T Q_u, dV += P~^T dO (keys 16w.., channels kw ..)
#pragma unroll 2
    for (int ks = 0; ks < 8; ++ks) {
      uint32_t ah[4], al[4], bh[4][2], bl[4][2];
      key_rows_a(sdST, w, 8 * ks, lane, ah, al);
      b_rows_split(bh, bl, sQu, 8 * ks + 2 * q, kw + gq);
      mma3_tiles<4>(dk, ah, al, bh, bl);
      key_rows_a(sPdT, w, 8 * ks, lane, ah, al);
      b_rows_split(bh, bl, sdO, 8 * ks + 2 * q, kw + gq);
      mma3_tiles<4>(dv, ah, al, bh, bl);
    }
    hp::fence_proxy_async();
    hp::mbar_arrive(&br.empty[s]);
  }
  const float one[2] = {1.f, 1.f};
  store_rows<4>(g.dk + base + kw, dk, j0 + 16 * w + gq, T_len, one, q);
  store_rows<4>(g.dv + base + kw, dv, j0 + 16 * w + gq, T_len, one, q);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <typename T, bool kVec2>
__global__ void __launch_bounds__(Layout<T>::kThreads, 1)
rel_bias_bwd_wgmma(const __grid_constant__ CUtensorMap tm_qu,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_dqu, const Args<T> g) {
  using L = Layout<T>;
  extern __shared__ unsigned char smem_raw[];
  // the 1024-aligned base, offset from smem_raw so that the compiler keeps
  // every access derived from it in the shared space (LDS / STS)
  unsigned char* sm = smem_raw + ((1024u - (hp::smem_addr(smem_raw) & 1023u)) & 1023u);
  const int T_len = g.T_len, bh = blockIdx.y, j0 = blockIdx.x * kB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBars);
  const Bars br{bars, bars + L::kS, bars + 2 * L::kS, bars + 2 * L::kS + 1, bars + 2 * L::kS + 3};
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kS; ++s) {
      hp::mbar_init(&br.full[s], 2);
      hp::mbar_init(&br.empty[s], 256);
    }
    hp::mbar_init(br.kv, 1);
    if constexpr (sizeof(T) == 2)
      for (int b = 0; b < 2; ++b) {
        hp::mbar_init(&br.pfull[b], 128);
        hp::mbar_init(&br.pempty[b], 128);
      }
    hp::fence_mbar_init();
  }
  // key flags of the block's keys: 1 valid, 0 masked, -1 past the sequence
  const uint8_t* mask_row = g.mask + (size_t)(bh / g.H) * T_len;
  float* sM = reinterpret_cast<float*>(sm + L::kFlags);
  for (int e = threadIdx.x; e < kB; e += L::kThreads) {
    const int j = j0 + e;
    sM[e] = j < T_len ? (mask_row[j] ? 1.f : 0.f) : -1.f;
  }
  __syncthreads();

  if (warp_index() >= L::kThreads / 32 - 4) {   // the producer warpgroup
    hp::setmaxnreg_dec<40>();
    produce<T>(&tm_qu, &tm_k, &tm_v, &tm_do, sm, br, g, bh, j0);
    return;
  }
  if constexpr (sizeof(T) == 2)
    hp::setmaxnreg_inc<152>();
  else
    hp::setmaxnreg_inc<232>();
  if constexpr (sizeof(T) == 2) {
    if (warp_index() < 8)
      consume_scores<kVec2>(g, sm, br, bh, j0);
    else
      consume_grads(g, &tm_dqu, sm, br, bh, j0);
  } else
    consume_f32<kVec2>(g, sm, br, bh, j0);
}

template <typename T, bool kVec2>
cudaError_t launch_as(const CUtensorMap (&m)[5], const Args<T>& g, int B, int H,
                      cudaStream_t stream) {
  using L = Layout<T>;
  auto kern = rel_bias_bwd_wgmma<T, kVec2>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid((g.T_len + kB - 1) / kB, B * H);
  kern<<<grid, L::kThreads, L::kSmem, stream>>>(m[0], m[1], m[2], m[3], m[4], g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* qu, const void* k, const void* v, const float* bias,
                   const uint8_t* mask, const float* lse, const void* out, const void* d_o,
                   float* dqu, void* dk, void* dv, float* dbias, float* delta, int B, int H,
                   int T_len, philox::Dropout drop, cudaStream_t stream) {
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  if (!aligned16({qu, k, v, d_o, dqu, dk, dv}) || addr(bias) % 4 != 0 || addr(dbias) % 4 != 0)
    return cudaErrorMisalignedAddress;
  cudaError_t e = flash::launch_row_dot<T>(out, d_o, delta, (size_t)B * H * T_len, stream);
  if (e != cudaSuccess) return e;
  // loads: q_u, k, v, dO over (B H, T, 64) in the input type; the bulk
  // reductions: dq_u, f32
  CUtensorMap m[5];
  const int es = (int)sizeof(T), bhn = B * H;
  if (!(hp::encode_rows64(&m[0], qu, es, T_len, bhn) && hp::encode_rows64(&m[1], k, es, T_len, bhn) &&
        hp::encode_rows64(&m[2], v, es, T_len, bhn) &&
        hp::encode_rows64(&m[3], d_o, es, T_len, bhn) &&
        hp::encode_rows64(&m[4], dqu, 4, T_len, bhn)))
    return cudaErrorInvalidValue;
  Args<T> g;
  g.bias = bias;
  g.dbias = dbias;
  g.mask = mask;
  g.lse = lse;
  g.delta = delta;
  g.dqu = dqu;
  g.dk = static_cast<T*>(dk);
  g.dv = static_cast<T*>(dv);
  g.H = H;
  g.T_len = T_len;
  g.scale = 1.0f / sqrtf((float)kD);
  g.drop = drop;
  if (T_len % 2 == 0 && addr(bias) % 8 == 0 && addr(dbias) % 8 == 0)
    return launch_as<T, true>(m, g, B, H, stream);
  return launch_as<T, false>(m, g, B, H, stream);
}

}  // namespace

// All tensors contiguous. q_u, k, v, out, d_out and the gradients dk, dv:
// (B, H, T, dk) of the input type; bias and dbias (B, H, T, T) float32
// (dbias need not be zeroed); mask (B, T) uint8; lse (B, H, T) float32 from
// the forward; delta: float32 (B, H, T) scratch. dq_u: a float32 (B, H, T,
// dk) buffer, zeroed by the caller, that receives dq_u by reductions (for
// bf16 the caller rounds it). dtype: 0 = float32 (3xTF32), 1 = bfloat16.
// q_u, k, v, d_out, dk, dv and dq_u 16-byte aligned, bias and dbias 4-byte.
// Only dk = 64, B * H <= 65535. rate and seed as given to the forward.
// Returns cudaGetLastError() after the launches.
extern "C" int l2s_rel_attention_bias_bwd(const void* qu, const void* k, const void* v,
                                          const void* bias, const void* mask, const void* lse,
                                          const void* out, const void* d_out, void* dqu,
                                          void* dk_out, void* dv_out, void* dbias, void* delta,
                                          int B, int H, int T_len, int dk, int dtype,
                                          float rate, unsigned long long seed, void* stream) {
  if (dk != flash::kD || B < 1 || H < 1 || T_len < 1 || B * H > 65535 || rate < 0.f ||
      rate >= 1.f)
    return (int)cudaErrorInvalidValue;
  const float* bi = static_cast<const float*>(bias);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* l = static_cast<const float*>(lse);
  float* db = static_cast<float*>(dbias);
  float* dl = static_cast<float*>(delta);
  float* dq = static_cast<float*>(dqu);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const philox::Dropout drop = philox::make_dropout(rate, seed);
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(qu, k, v, bi, m, l, out, d_out, dq, dk_out, dv_out, db, dl, B, H, T_len,
                      drop, s);
  else if (dtype == 1)
    e = launch<bf16>(qu, k, v, bi, m, l, out, d_out, dq, dk_out, dv_out, db, dl, B, H, T_len,
                     drop, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
