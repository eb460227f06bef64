// Transformer-XL relative-position flash attention, backward, for Hopper
// (sm_90a).
//
// Replaces: lip2speech_tpu/ops/pallas_rel_attention.py, `_bwd_kernel` (entry
// `_rel_flash_bwd_impl`), with its replay of the forward's dropout mask.
//
// Computes, per (batch, head), from the forward's inputs, its output O, its
// log-sum-exp and the upstream gradient dO, with S as in rel_attention.cu:
//     P = exp(S - lse),  D = rowsum(dO o O),  dPr = dO V^T (o keep / (1-rate))
//     dS = P o (dPr - D) / sqrt(64)
//     dQ_u = dS K        dK = dS^T Q_u       dV = P~^T dO   (P~ = dropped P)
//     dQ_v[i] = sum_j dS[i, j] p[T-1-i+j]
//     dP[h, T-1-i+j] += dS[i, j] q_v[i]      summed over i, j and the batch
// Rows that had no valid key (lse below -1e30 / 2) get zero gradient.
//
// What bounds it: eight (T x T x 64) products per (batch, head) against O(T)
// bytes: operations, on the tensor cores (bf16; f32 in 3xTF32, three TF32
// products for each).
//
// Design. The TPU kernel is one sequential program per (batch, head) that
// carries dK, dV and dP in fast memory across query blocks and un-shears dS
// with log2 rolls. Here a row-dot pre-pass (flash_bwd_tile.cuh) writes D,
// then one key-major pass, `rel_bwd_wgmma<T>`, computes every product of a
// tile pair once. A block owns 64 keys of one (batch, head) and walks over
// the query tiles of 64, with 384 threads: a producer warpgroup and two
// consumer warpgroups (hopper.cuh holds the Hopper primitives).
//   The producer's first thread issues TMA loads: K and V once, then per
// query tile Q_u, Q_v, dO and the one 64-row chunk of the position table
// that the tile's window adds, into a ring of kS stages on full / empty
// mbarriers. The window ring holds kS + 1 chunks: chunk m is window rows
// 0..63 of tile m and 64..127 of tile m + 1, so a slot is refilled only
// after the stage that last read it was released. TMA zero-fills rows past
// the sequence and the table's ends. Under dropout all 128 producer threads
// draw the tile's keep bits (philox.cuh: the forward's mask) before the
// stage is free, eight Philox calls each, and leave one word per consumer
// thread in the stage (`keep_half`).
//   dK and dV stay in registers and are written once. dQ_u and dQ_v (over
// key blocks) and dP (over key blocks, query tiles and the batch) are sums
// in zeroed f32 buffers in device memory, so their last bits may differ
// between runs. The position gradients go through dG, the 64 x 128 window
// tile holding dS un-sheared, dG[a, 63-a+j] = dS[a, j] (zero off the band):
// dQ_v = dG Win, dWin = dG^T Q_v, whose window rows 64..127 (with rows
// 0..63 of the previous tile, carried in registers) receive nothing more
// after this tile and go to dP, while rows 0..63 are the next tile's
// 64..127: each block sends each table row to memory once.
//   bf16 (dtype 1): every product on wgmma m64n64k16 with f32 accumulators,
// the work split between the warpgroups, which run a tile apart through two
// pair buffers (P~, dS, dG) on pair_full / pair_empty mbarriers:
//     warpgroup 0: G = Q_v Win^T (the warps' band of G through an f32
//       scratch, read back along the diagonal), S = Q_u K^T, dPr = dO V^T
//       (K-major operands, as TMA lays them out), P (exp2 with the scale
//       folded in; the rows' LSE and D loaded while the products run), dS
//       and P~, stored as bf16 [query][key] tiles; dV += P~^T dO (both
//       operands MN-major).
//     warpgroup 1: dQ_u = dS K and dK += dS^T Q_u, while it un-shears dS
//       into the dG band; dQ_v = dG Win; dWin = dG^T Q_v. dQ_u, dQ_v and
//       each dP block are staged as swizzled f32 tiles and added by TMA
//       bulk reductions (cp.reduce.async.bulk .add.f32), which skip rows
//       outside the tensors.
//   dS and P~ are rounded to bf16 as operands, every sum is f32. 224.3 KB
// of shared memory: one block per SM. Twelve warps cap a thread at 168
// registers (a 128-byte spill); warpgroup 0 holds only dV and warpgroup 1
// dK, the carried dP block and its products' accumulators.
//   f32 (dtype 0): 3xTF32 (mma_tile.cuh: hi = v rounded to TF32, lo = v -
// hi, lo hi + hi lo + hi hi, f32 sums; held to 1e-4 of the plain version,
// where one TF32 product, ~1e-3 off, fails). TF32 wgmma reads both shared
// operands K-major only, and a split tile takes twice the space, so the
// products whose operands arrive K-major run on wgmma with A split in
// registers and B split once a tile into shared memory (hi in place, lo
// beside it): S = Q_u K^T and dPr = dO V^T (K and V split once a block;
// each warpgroup 32 of the keys, m64n32k8) and G^T = Win Q_v^T (each
// warpgroup one 64-row window half, m64n64k8; G^T through a 128 x 64 f32
// scratch). The products that reduce over queries, keys or window rows,
// dK, dV, dQ_u, dQ_v and dWin, would need transposed split copies of Q_u,
// dO, K, the window and dG, five more 32 KB tiles beyond the 227 KB; with
// transposed split P~ and dS tiles, which do fit, dK and dV on wgmma read
// slower on the card than on mma.sync. So these five stay on mma.sync
// m16n8k8 in this kernel, each warpgroup on 32 of the channels: P~ and dS
// stored transposed ([key][query], row stride 72) and read as A by float2
// in the k8 order 0, 2, 4, 6, 1, 3, 5, 7; dQ_v's and dWin's A read dG out
// of the dS tile along the shear (no dG tile); B rows from the swizzled
// tiles, conflict-free in that order; dQ_u, dQ_v and dP by four-float
// reductions. One stage: 197.8 KB.
//
// Bounds are checked: any T.

#include "flash_bwd_tile.cuh"
#include "hopper.cuh"
#include "mma_tile.cuh"

namespace {

using namespace mma;
namespace hp = hopper;
using hp::dsc32;
using hp::keep_half;
using hp::kLog2e;
using hp::split_tile;
using hp::sw32;
using hp::tma_tile;
using hp::warp_index;
using hp::wgmma_nt32;

constexpr int kThreads = 384;   // two consumer warpgroups and the producer warpgroup

// Shared memory, byte offsets from a 1024-aligned base.
template <typename T>
struct Layout;

template <>
struct Layout<bf16> {
  static constexpr int kS = 2;                      // stages of Q_u, Q_v, dO
  static constexpr int kRing = kS + 1;              // window chunks
  static constexpr int TB = kTile * 2;              // a 64 x 64 bf16 tile
  static constexpr int kPairBytes = 4 * TB;         // P~, dS, dG (two 64-column halves)
  static constexpr int kK = 0, kV = TB;
  static constexpr int kStage = 2 * TB;                          // [kS] x (Q_u, Q_v, dO)
  static constexpr int kRingOff = kStage + kS * 3 * TB;
  static constexpr int kPair = kRingOff + kRing * TB;            // [2]
  static constexpr int kGScr = kPair + 2 * kPairBytes;           // warpgroup 0's G scratch
  static constexpr int kStaging = kGScr + 4 * 16 * kGld * 4;     // dQ_u, dQ_v, dWin: f32 tiles
  static constexpr int kFlags = kStaging + 3 * kB * kD * 4;
  static constexpr int kKeep = kFlags + kB * 4;   // [kS] x 128 dropout words
  static constexpr int kBars = kKeep + kS * 512;   // full[kS] empty[kS] kv pair_full[2] pair_empty[2]
  static constexpr int kSmem = kBars + (2 * kS + 5) * 8 + 1024;   // + alignment slack
  static_assert(kSmem <= 232448, "shared memory of one block");
};

template <>
struct Layout<float> {
  static constexpr int kS = 1;
  static constexpr int kRing = kS + 1;
  static constexpr int TB = kB * kD * 4;            // two swizzled halves of 32 channels
  static constexpr int kK = 0, kV = TB, kKlo = 2 * TB, kVlo = 3 * TB;   // hi in place
  static constexpr int kStage = 4 * TB;             // Q_u, Q_v (hi in place), dO
  static constexpr int kQvLo = kStage + 3 * TB;
  static constexpr int kRingOff = kQvLo + TB;
  static constexpr int kPair = kRingOff + kRing * TB;   // P~^T, dS^T [key][query]; G^T over them
  static constexpr int kGtLd = 68;
  static constexpr int kFlags = kPair + 2 * kB * kPtLd * 4;
  static constexpr int kKeep = kFlags + kB * 4;    // 128 dropout words
  static constexpr int kBars = kKeep + kS * 512;   // full, empty, kv
  static constexpr int kSmem = kBars + 3 * 8 + 1024;
  static_assert(2 * kB * kGtLd <= 2 * kB * kPtLd, "G^T scratch fits the pair tiles");
  static_assert(kSmem <= 232448, "shared memory of one block");
};

struct Bars {
  uint64_t *full, *empty, *kv, *pfull, *pempty;
};

template <typename T>
struct Args {
  const uint8_t* mask;
  const float *lse, *delta;
  float *dqu, *dqv;   // f32 sums, zeroed by the caller
  T *dk, *dv;
  float* dp;
  int H, T_len;
  float scale;
  philox::Dropout drop;
};

// window chunk m (table rows T-64+j0-64m ..): window rows 0..63 of query
// tile m, rows 64..127 of tile m + 1
template <typename T>
__device__ __forceinline__ T* ring_chunk(unsigned char* sm, int m) {
  using L = Layout<T>;
  return reinterpret_cast<T*>(sm + L::kRingOff + (((m % L::kRing) + L::kRing) % L::kRing) * L::TB);
}

// ---------------------------------------------------------------------------
// producer
// ---------------------------------------------------------------------------

// The producer warpgroup: its first thread issues the TMA loads; under
// dropout all its threads draw the tile's keep bits before the stage is
// free and write them into it after. A stage's full barrier takes two
// arrivals (the loads' and the bits') and the loads' bytes.
template <typename T>
__device__ __forceinline__ void produce(const CUtensorMap* tm_qu, const CUtensorMap* tm_qv,
                                        const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                        const CUtensorMap* tm_do, const CUtensorMap* tm_p,
                                        unsigned char* sm, const Bars& br, const Args<T>& g,
                                        int bh, int h, int j0) {
  using L = Layout<T>;
  const int pt = threadIdx.x - 256, T_len = g.T_len;
  const bool drop = g.drop.thresh != 0u;
  if (pt == 0) {
    hp::mbar_expect_tx(br.kv, 2 * L::TB);
    tma_tile<T>(sm + L::kK, tm_k, br.kv, j0, bh);
    tma_tile<T>(sm + L::kV, tm_v, br.kv, j0, bh);
  }
  const int n_tiles = (T_len + kB - 1) / kB;
  const int base0 = T_len - kB + j0;   // table row of window chunk 0
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % L::kS;
    uint32_t even = 0u, odd = 0u;
    if (drop) keep_half(even, odd, g.drop, bh, kB * t, j0, pt);
    if (t >= L::kS) hp::mbar_wait(&br.empty[s], ((t / L::kS) - 1) & 1);
    if (pt == 0) {
      hp::mbar_expect_tx(&br.full[s], (t == 0 ? 5 : 4) * L::TB);
      unsigned char* st = sm + L::kStage + s * 3 * L::TB;
      tma_tile<T>(st, tm_qu, &br.full[s], kB * t, bh);
      tma_tile<T>(st + L::TB, tm_qv, &br.full[s], kB * t, bh);
      tma_tile<T>(st + 2 * L::TB, tm_do, &br.full[s], kB * t, bh);
      tma_tile<T>(ring_chunk<T>(sm, t), tm_p, &br.full[s], base0 - kB * t, h);
      if (t == 0) tma_tile<T>(ring_chunk<T>(sm, -1), tm_p, &br.full[s], base0 + kB, h);
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

// From the unscaled scores s and dpr = dO V^T of the warp's 16 x 8 NT pair
// tile: s becomes dS = P o (dpr * keep - D) * scale, and dpr P~ = P * keep,
// with P = exp2(s * scale * log2(e) - lse2), 0 on invalid keys. Under
// dropout, keep comes from the lane's keep word (`keep_half`), whose
// n-tiles n0 .. are the tile's columns.
template <int NT, typename T>
__device__ __forceinline__ void pair_grads(float s[][4], float dpr[][4], uint32_t kbits,
                                           uint32_t keep, int n0, const Args<T>& g,
                                           const float lse2[2], const float delta[2]) {
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
                             ? exp2f(fmaf(s[n][e], sl2, -lse2[r])) : 0.f;
      s[n][e] = prob * (dpr[n][e] * kf - delta[r]) * g.scale;
      dpr[n][e] = prob * kf;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: every product on wgmma. Warpgroup 0 computes the pair's scores,
// dS and P~ and holds dV; warpgroup 1, a tile behind, holds dK and takes
// dQ_u, dQ_v and dWin from the pair tiles warpgroup 0 leaves.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t dsc(const bf16* p) { return hp::desc_sw128(p); }

__device__ __forceinline__ bf16* pair_tiles(unsigned char* sm, int b) {
  return reinterpret_cast<bf16*>(sm + Layout<bf16>::kPair + b * Layout<bf16>::kPairBytes);
}

// A warp's share of a 64 x 64 f32 accumulator into a swizzled f32 tile
__device__ __forceinline__ void stage_tile(float* st, const float (&acc)[8][4], int w, int lane) {
  const int r = 16 * w + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<float2*>(st + sw32(r, 8 * n + c)) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(st + sw32(r + 8, 8 * n + c)) = make_float2(acc[n][2], acc[n][3]);
  }
}

// A staged f32 tile added to rows row .. row+63 of slice `slice` of a map
__device__ __forceinline__ void reduce_tile(const CUtensorMap* map, const float* st, int row,
                                            int slice) {
  hp::tma_reduce_add_3d(map, st, 0, row, slice);
  hp::tma_reduce_add_3d(map, st + 2048, 32, row, slice);
}

// Warpgroup 0: G, S, dPr, P~ and dS of each tile pair, then dV += P~^T dO
__device__ __forceinline__ void consume_scores(const Args<bf16>& g, unsigned char* sm,
                                               const Bars& br, int bh, int j0) {
  using L = Layout<bf16>;
  const int w = warp_index() & 3, lane = threadIdx.x & 31, q = lane & 3, gq = lane >> 2;
  const int T_len = g.T_len, n_tiles = (T_len + kB - 1) / kB, rb = 48 - 16 * w;
  const bf16* sK = reinterpret_cast<const bf16*>(sm + L::kK);
  const bf16* sV = reinterpret_cast<const bf16*>(sm + L::kV);
  float* sG = reinterpret_cast<float*>(sm + L::kGScr) + w * 16 * kGld;
  const uint32_t kbits = key_bits<8>(reinterpret_cast<const float*>(sm + L::kFlags), q);

  float dv[8][4];
  zero<8>(dv);
  hp::mbar_wait(br.kv, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % L::kS, b = t & 1;
    hp::mbar_wait(&br.full[s], (t / L::kS) & 1);
    const bf16* sQu = reinterpret_cast<const bf16*>(sm + L::kStage + s * 3 * L::TB);
    const bf16* sQv = sQu + kTile;
    const bf16* sdO = sQv + kTile;
    const bf16* w0 = ring_chunk<bf16>(sm, t);        // window rows 0..63
    const bf16* w1 = ring_chunk<bf16>(sm, t - 1);    // 64..127
    const int i_g = kB * t + 16 * w + gq;
    float lse2[2], delta[2];
    row_stats(g, bh, i_g, lse2, delta);   // in flight while the products run

    hp::position_band(sG, sQv, w0, w1, rb, q, lane);   // G: the warp's window columns to its scratch
    // S = Q_u K^T (+ the position term), dPr = dO V^T
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
    add_diagonal<8, kGld>(sc, sG, lane);
    const uint32_t keep = g.drop.thresh != 0u
        ? reinterpret_cast<const uint32_t*>(sm + L::kKeep + s * 512)[threadIdx.x] : 0u;
    pair_grads<8>(sc, dpr, kbits, keep, 0, g, lse2, delta);   // dpr is now P~

    // P~ and dS to pair buffer b, once warpgroup 1 has read it (tile t-2)
    if (t >= 2) hp::mbar_wait(&br.pempty[b], ((t >> 1) - 1) & 1);
    bf16* pPd = pair_tiles(sm, b);
    bf16* pdS = pPd + kTile;
    store_pair<8>(pPd, pdS, dpr, sc, w, 0, lane);
    hp::fence_proxy_async();
    hp::named_barrier(1, 128);
    hp::mbar_arrive(&br.pfull[b]);

    // dV += P~^T dO
    hp::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      hp::wgmma_bf16_ss<1, 1>(dv, dsc(pPd + ks * 16 * kD), dsc(sdO + ks * 16 * kD));
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_acc(dv);
    hp::mbar_arrive(&br.empty[s]);
  }
  const float one[2] = {1.f, 1.f};
  store_rows<8>(g.dv + (size_t)bh * T_len * kD, dv, j0 + 16 * w + gq, T_len, one, q);
}

// Warpgroup 1, a tile behind: dQ_u = dS K and dK += dS^T Q_u; dG from the
// pair's dS; dQ_v = dG Win; dWin = dG^T Q_v, whose window rows 64..127 (+
// the carry) go to dP
__device__ __forceinline__ void consume_query(const Args<bf16>& g, const CUtensorMap* tm_dqu,
                                              const CUtensorMap* tm_dqv, const CUtensorMap* tm_dp,
                                              unsigned char* sm, const Bars& br, int bh, int h,
                                              int j0) {
  using L = Layout<bf16>;
  const int ct = threadIdx.x - 128, w = warp_index() & 3, lane = ct & 31;
  const bool lead = ct == 0;   // issues the reductions
  const int T_len = g.T_len, n_tiles = (T_len + kB - 1) / kB, n_table = 2 * T_len - 1;
  const bf16* sK = reinterpret_cast<const bf16*>(sm + L::kK);
  float* stq = reinterpret_cast<float*>(sm + L::kStaging);
  float* stv = stq + kB * kD;
  float* stw = stv + kB * kD;

  float dk[8][4], carry[8][4];
  zero<8>(dk);
  zero<8>(carry);
  hp::mbar_wait(br.kv, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % L::kS, b = t & 1;
    hp::mbar_wait(&br.full[s], (t / L::kS) & 1);
    hp::mbar_wait(&br.pfull[b], (t >> 1) & 1);
    const bf16* sQu = reinterpret_cast<const bf16*>(sm + L::kStage + s * 3 * L::TB);
    const bf16* sQv = sQu + kTile;
    const bf16* w0 = ring_chunk<bf16>(sm, t);
    const bf16* w1 = ring_chunk<bf16>(sm, t - 1);
    const bf16* pdS = pair_tiles(sm, b) + kTile;
    bf16* pDg = pair_tiles(sm, b) + 2 * kTile;   // [query][window col], two halves
    const int win = T_len - kB + j0 - kB * t;   // table row of window row 0

    {   // dQ_u = dS K and dK += dS^T Q_u (running while dG is built), dQ_v = dG Win
      float dqu[8][4], dqv[8][4];
      zero<8>(dqu);
      zero<8>(dqv);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::wgmma_bf16_ss<0, 1>(dqu, dsc(pdS + 16 * kk), dsc(sK + kk * 16 * kD));
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        hp::wgmma_bf16_ss<1, 1>(dk, dsc(pdS + ks * 16 * kD), dsc(sQu + ks * 16 * kD));
      hp::wgmma_commit();
      {   // dG[a][63 - a + j] = dS[a][j]: thread ct takes row ct / 2, keys 32 (ct % 2) ..
        const int a = ct >> 1, j1 = 32 * (ct & 1);
#pragma unroll
        for (int c8 = 0; c8 < 4; ++c8) {
          const int j = j1 + 8 * c8;
          const uint4 v = *reinterpret_cast<const uint4*>(pdS + swz(a, j));
          const bf16* x = reinterpret_cast<const bf16*>(&v);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int col = kB - 1 - a + j + e;
            pDg[(col >> 6) * kTile + swz(a, col & 63)] = x[e];
          }
        }
      }
      hp::fence_proxy_async();
      hp::named_barrier(2, 128);
      hp::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
        hp::wgmma_bf16_ss<0, 1>(dqv, dsc(pDg + (ks >> 2) * kTile + 16 * (ks & 3)),
                                dsc((ks < 4 ? w0 : w1) + (ks & 3) * 16 * kD));
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_acc(dqu);
      hp::fence_acc(dqv);
      if (lead) hp::bulk_wait_read<0>();   // the staging tiles are free again
      hp::named_barrier(2, 128);
      stage_tile(stq, dqu, w, lane);
      stage_tile(stv, dqv, w, lane);
      hp::fence_proxy_async();
      hp::named_barrier(2, 128);
      if (lead) {
        reduce_tile(tm_dqu, stq, kB * t, bh);
        reduce_tile(tm_dqv, stv, kB * t, bh);
        hp::bulk_commit();
      }
    }
    // dWin = dG^T Q_v, window rows 0..63 and 64..127
    float dw0[8][4], dw1[8][4];
    zero<8>(dw0);
    zero<8>(dw1);
    hp::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      hp::wgmma_bf16_ss<1, 1>(dw0, dsc(pDg + ks * 16 * kD), dsc(sQv + ks * 16 * kD));
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      hp::wgmma_bf16_ss<1, 1>(dw1, dsc(pDg + kTile + ks * 16 * kD), dsc(sQv + ks * 16 * kD));
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_acc(dk);
    hp::fence_acc(dw0);
    hp::fence_acc(dw1);
    hp::mbar_arrive(&br.pempty[b]);   // pair buffer b, the stage and chunk t-1 are consumed
    hp::mbar_arrive(&br.empty[s]);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dw1[n][e] += carry[n][e];
        carry[n][e] = dw0[n][e];
      }
    stage_tile(stw, dw1, w, lane);
    hp::fence_proxy_async();
    hp::named_barrier(2, 128);
    if (lead) {
      reduce_tile(tm_dp, stw, win + kB, h);
      hp::bulk_commit();
    }
  }
  red_add_rows<8>(carry, g.dp + (size_t)h * n_table * kD,
                  T_len - kB + j0 - kB * (n_tiles - 1) + 16 * w, n_table, lane);
  const float one[2] = {1.f, 1.f};
  store_rows<8>(g.dk + (size_t)bh * T_len * kD, dk, j0 + 16 * w + (lane >> 2), T_len, one,
                lane & 3);
  if (lead) hp::bulk_wait<0>();
}

// ---------------------------------------------------------------------------
// f32: 3xTF32. Both warpgroups work on each tile: the scores of half the
// keys each on wgmma, then the mma.sync products on half the channels each.
// ---------------------------------------------------------------------------

// B fragments of 4 n-tiles (columns c0 + 8n, rows r0 and r0 + 1 of a k8
// step in the order 0, 2, 4, 6, 1, 3, 5, 7) of a swizzled tile: split, or
// from its hi and lo tiles
__device__ __forceinline__ void b_rows_split(uint32_t bh[4][2], uint32_t bl[4][2],
                                             const float* tile, int r0, int c0) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
    split_b(tile[sw32(r0, c0 + 8 * n)], tile[sw32(r0 + 1, c0 + 8 * n)], bh[n], bl[n]);
}
__device__ __forceinline__ void b_rows_hl(uint32_t bh[4][2], uint32_t bl[4][2], const float* hi,
                                          const float* lo, int r0, int c0) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int o0 = sw32(r0, c0 + 8 * n), o1 = sw32(r0 + 1, c0 + 8 * n);
    bh[n][0] = __float_as_uint(hi[o0]);
    bh[n][1] = __float_as_uint(hi[o1]);
    bl[n][0] = __float_as_uint(lo[o0]);
    bl[n][1] = __float_as_uint(lo[o1]);
  }
}

__device__ __forceinline__ uint32_t ds_at(const float* sdST, int jj, int a) {
  return __float_as_uint(jj >= 0 && jj < kB ? sdST[jj * kPtLd + a] : 0.f);
}

__device__ __forceinline__ void consume(const Args<float>& g, unsigned char* sm, const Bars& br,
                                        int bh, int h, int j0) {
  using L = Layout<float>;
  const int tid = threadIdx.x, c = warp_index() >> 2, w = warp_index() & 3, lane = tid & 31;
  const int q = lane & 3, gq = lane >> 2;
  const int kw = 32 * c;
  const int T_len = g.T_len, n_tiles = (T_len + kB - 1) / kB;
  const int n_table = 2 * T_len - 1, rb = 48 - 16 * w;
  const size_t base = (size_t)bh * T_len * kD;
  float* dp_h = g.dp + (size_t)h * n_table * kD + kw;
  float* sKh = reinterpret_cast<float*>(sm + L::kK);
  float* sVh = reinterpret_cast<float*>(sm + L::kV);
  float* sKl = reinterpret_cast<float*>(sm + L::kKlo);
  float* sVl = reinterpret_cast<float*>(sm + L::kVlo);
  float* sQvLo = reinterpret_cast<float*>(sm + L::kQvLo);
  float* sPdT = reinterpret_cast<float*>(sm + L::kPair);
  float* sdST = sPdT + kB * kPtLd;
  float* sGt = sPdT;
  const uint32_t kbits = key_bits<4>(reinterpret_cast<const float*>(sm + L::kFlags) + kw, q);

  hp::mbar_wait(br.kv, 0);
  split_tile(sKh, sKl, tid);
  split_tile(sVh, sVl, tid);
  float dk[4][4], dv[4][4], carry[4][4], acc[4][4];
  zero<4>(dk);
  zero<4>(dv);
  zero<4>(carry);

  for (int t = 0; t < n_tiles; ++t) {
    hp::mbar_wait(&br.full[0], t & 1);
    float* sQu = reinterpret_cast<float*>(sm + L::kStage);
    float* sQv = sQu + kB * kD;
    float* sdO = sQv + kB * kD;
    const float* w0 = ring_chunk<float>(sm, t);
    const float* w1 = ring_chunk<float>(sm, t - 1);
    const int win = T_len - kB + j0 - kB * t;
    const int i_g = kB * t + 16 * w + gq;
    float lse2[2], delta[2];
    row_stats(g, bh, i_g, lse2, delta);
    split_tile(sQv, sQvLo, tid);
    hp::fence_proxy_async();
    hp::named_barrier(1, 256);
    {
      float gt[8][4];
      zero<8>(gt);
      wgmma_nt32(gt, c ? w1 : w0, sQv, sQvLo, w, lane);
      float* row = sGt + (kB * c + 16 * w + gq) * L::kGtLd + 2 * q;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        *reinterpret_cast<float2*>(row + 8 * n) = make_float2(gt[n][0], gt[n][1]);
        *reinterpret_cast<float2*>(row + 8 * L::kGtLd + 8 * n) = make_float2(gt[n][2], gt[n][3]);
      }
    }
    float sc[4][4], dpr[4][4];
    zero<4>(sc);
    zero<4>(dpr);
    wgmma_nt32(sc, sQu, sKh + kw * 32, sKl + kw * 32, w, lane);
    wgmma_nt32(dpr, sdO, sVh + kw * 32, sVl + kw * 32, w, lane);
    hp::named_barrier(1, 256);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int a = 16 * w + gq + 8 * (e >> 1), j = kw + 8 * n + 2 * q + (e & 1);
        sc[n][e] += sGt[(kB - 1 - a + j) * L::kGtLd + a];
      }
    const uint32_t keep = g.drop.thresh != 0u
        ? reinterpret_cast<const uint32_t*>(sm + L::kKeep)[tid & 127] : 0u;
    pair_grads<4>(sc, dpr, kbits, keep, 4 * c, g, lse2, delta);
    hp::named_barrier(1, 256);
    store_pair<4>(sPdT, sdST, dpr, sc, w, kw, lane);
    hp::named_barrier(1, 256);
    {
      zero<4>(acc);
      const int a = 16 * w + gq;
#pragma unroll 2
      for (int kk = 0; kk < 8; ++kk) {
        const int r = 8 * kk + 2 * q;
        const uint32_t av[4] = {ds_at(sdST, r, a), ds_at(sdST, r, a + 8), ds_at(sdST, r + 1, a),
                                ds_at(sdST, r + 1, a + 8)};
        uint32_t ah[4], al[4], bh[4][2], bl[4][2];
        split4(av, ah, al);
        b_rows_hl(bh, bl, sKh, sKl, r, kw + gq);
        mma3_tiles<4>(acc, ah, al, bh, bl);
      }
      red_add_rows<4>(acc, g.dqu + base + kw, kB * t + 16 * w, T_len, lane);
    }
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
    {
      zero<4>(acc);
      const int a = 16 * w + gq;
#pragma unroll 2
      for (int ks = 0; ks < kGRows / 8; ++ks) {
        const int jj = 8 * ks + 2 * q + gq - 15;
        const uint32_t av[4] = {ds_at(sdST, jj, a), ds_at(sdST, jj + 8, a + 8),
                                ds_at(sdST, jj + 1, a), ds_at(sdST, jj + 9, a + 8)};
        uint32_t ah[4], al[4], bh[4][2], bl[4][2];
        split4(av, ah, al);
        const int r0 = rb + 8 * ks + 2 * q;
        b_rows_split(bh, bl, r0 < kB ? w0 : w1, r0 & (kB - 1), kw + gq);
        mma3_tiles<4>(acc, ah, al, bh, bl);
      }
      red_add_rows<4>(acc, g.dqv + base + kw, kB * t + 16 * w, T_len, lane);
    }
#pragma unroll
    for (int half = 1; half >= 0; --half) {
      const int b = w + 4 * half;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = half ? carry[n][e] : 0.f;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const int s16 = ks >> 1;
        if (b + s16 < 3 || b + s16 > 7) continue;
        const int a0 = 8 * ks + 2 * q, jj = 16 * b + gq - (kB - 1) + a0;
        const uint32_t av[4] = {ds_at(sdST, jj, a0), ds_at(sdST, jj + 8, a0),
                                ds_at(sdST, jj + 1, a0 + 1), ds_at(sdST, jj + 9, a0 + 1)};
        uint32_t ah[4], al[4], bh[4][2], bl[4][2];
        split4(av, ah, al);
        b_rows_hl(bh, bl, sQv, sQvLo, a0, kw + gq);
        mma3_tiles<4>(acc, ah, al, bh, bl);
      }
      if (half) {
        red_add_rows<4>(acc, dp_h, win + kB + 16 * w, n_table, lane);
      } else {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) carry[n][e] = acc[n][e];
      }
    }
    hp::fence_proxy_async();
    hp::mbar_arrive(&br.empty[0]);
  }
  red_add_rows<4>(carry, dp_h, T_len - kB + j0 - kB * (n_tiles - 1) + 16 * w, n_table, lane);
  const float one[2] = {1.f, 1.f};
  store_rows<4>(g.dk + base + kw, dk, j0 + 16 * w + gq, T_len, one, q);
  store_rows<4>(g.dv + base + kw, dv, j0 + 16 * w + gq, T_len, one, q);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
rel_bwd_wgmma(const __grid_constant__ CUtensorMap tm_qu, const __grid_constant__ CUtensorMap tm_qv,
              const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
              const __grid_constant__ CUtensorMap tm_do, const __grid_constant__ CUtensorMap tm_p,
              const __grid_constant__ CUtensorMap tm_dqu, const __grid_constant__ CUtensorMap tm_dqv,
              const __grid_constant__ CUtensorMap tm_dp, const Args<T> g) {
  using L = Layout<T>;
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int T_len = g.T_len, bh = blockIdx.y, h = bh % g.H, j0 = blockIdx.x * kB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBars);
  const Bars br{bars, bars + L::kS, bars + 2 * L::kS, bars + 2 * L::kS + 1,
                bars + 2 * L::kS + 3};
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kS; ++s) {
      hp::mbar_init(&br.full[s], 2);
      hp::mbar_init(&br.empty[s], 256);
    }
    hp::mbar_init(br.kv, 1);
    if constexpr (kBf16)
      for (int b = 0; b < 2; ++b) {
        hp::mbar_init(&br.pfull[b], 128);
        hp::mbar_init(&br.pempty[b], 128);
      }
    hp::fence_mbar_init();
  }
  // key flags of the block's keys: 1 valid, 0 masked, -1 past the sequence
  const uint8_t* mask_row = g.mask + (size_t)(bh / g.H) * T_len;
  float* sM = reinterpret_cast<float*>(sm + L::kFlags);
  for (int e = threadIdx.x; e < kB; e += kThreads) {
    const int j = j0 + e;
    sM[e] = j < T_len ? (mask_row[j] ? 1.f : 0.f) : -1.f;
  }
  if constexpr (kBf16) {   // dG is zero off the band, which no tile writes
    for (int b = 0; b < 2; ++b) {
      uint4* dg = reinterpret_cast<uint4*>(pair_tiles(sm, b) + 2 * kTile);
      for (int e = threadIdx.x; e < 4 * kTile / 16; e += kThreads) dg[e] = make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();

  if (warp_index() >= 8) {   // the producer warpgroup
    produce<T>(&tm_qu, &tm_qv, &tm_k, &tm_v, &tm_do, &tm_p, sm, br, g, bh, h, j0);
    return;
  }
  if constexpr (kBf16) {
    if (warp_index() < 4)
      consume_scores(g, sm, br, bh, j0);
    else
      consume_query(g, &tm_dqu, &tm_dqv, &tm_dp, sm, br, bh, h, j0);
  } else {
    consume(g, sm, br, bh, h, j0);
  }
}

template <typename T>
cudaError_t launch(const void* qu, const void* qv, const void* k, const void* v, const void* p,
                   const uint8_t* mask, const float* lse, const void* out, const void* d_o,
                   float* dqu, float* dqv, void* dk, void* dv, float* dp, float* delta, int B,
                   int H, int T_len, philox::Dropout drop, cudaStream_t stream) {
  using L = Layout<T>;
  if (!aligned16({qu, qv, k, v, p, d_o, dp, dqu, dqv, dk, dv})) return cudaErrorMisalignedAddress;
  cudaError_t e = flash::launch_row_dot<T>(out, d_o, delta, (size_t)B * H * T_len, stream);
  if (e != cudaSuccess) return e;
  // loads: q_u, q_v, k, v, dO over (B H, T, 64), the table over (H, 2T-1,
  // 64), in the input type; reductions: dq_u, dq_v and dp, f32
  CUtensorMap m[9];
  const int es = (int)sizeof(T), bhn = B * H;
  const void* src[5] = {qu, qv, k, v, d_o};
  bool ok = true;
  for (int i = 0; i < 5; ++i) ok = ok && hp::encode_rows64(&m[i], src[i], es, T_len, bhn);
  ok = ok && hp::encode_rows64(&m[5], p, es, 2 * T_len - 1, H) &&
       hp::encode_rows64(&m[6], dqu, 4, T_len, bhn) &&
       hp::encode_rows64(&m[7], dqv, 4, T_len, bhn) &&
       hp::encode_rows64(&m[8], dp, 4, 2 * T_len - 1, H);
  if (!ok) return cudaErrorInvalidValue;
  Args<T> g;
  g.mask = mask;
  g.lse = lse;
  g.delta = delta;
  g.dqu = dqu;
  g.dqv = dqv;
  g.dk = static_cast<T*>(dk);
  g.dv = static_cast<T*>(dv);
  g.dp = dp;
  g.H = H;
  g.T_len = T_len;
  g.scale = 1.0f / sqrtf((float)kD);
  g.drop = drop;
  dim3 grid((T_len + kB - 1) / kB, bhn);
  auto kern = rel_bwd_wgmma<T>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, L::kSmem, stream>>>(m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7],
                                              m[8], g);
  return cudaGetLastError();
}

}  // namespace

// All tensors contiguous. q_u, q_v, k, v, out, d_out and the gradients dk,
// dv: (B, H, T, dk) of the input type; p (H, 2T-1, dk); mask (B, T) uint8;
// lse (B, H, T) float32 from the forward. dq_u, dq_v: float32 (B, H, T, dk),
// zeroed by the caller, receive the sums of the gradients; dp: float32 (H,
// 2T-1, dk), zeroed by the caller, receives the position table's gradient.
// delta: float32 (B, H, T) scratch. dtype: 0 = float32 (3xTF32), 1 =
// bfloat16; pointers 16-byte aligned. Only dk = 64. rate and seed as given
// to the forward. Returns cudaGetLastError() after the launches.
extern "C" int l2s_rel_attention_bwd(const void* qu, const void* qv, const void* k,
                                     const void* v, const void* p, const void* mask,
                                     const void* lse, const void* out, const void* d_out,
                                     void* dqu, void* dqv, void* dk_out, void* dv_out, void* dp,
                                     void* delta, int B, int H, int T_len, int dk, int dtype,
                                     float rate, unsigned long long seed, void* stream) {
  if (dk != flash::kD || B < 1 || H < 1 || T_len < 1 || rate < 0.f || rate >= 1.f ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* l = static_cast<const float*>(lse);
  float* dqf = static_cast<float*>(dqu);
  float* dvf = static_cast<float*>(dqv);
  float* dpf = static_cast<float*>(dp);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const philox::Dropout drop = philox::make_dropout(rate, seed);
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(qu, qv, k, v, p, m, l, out, d_out, dqf, dvf, dk_out, dv_out, dpf, dl, B, H,
                      T_len, drop, s);
  else if (dtype == 1)
    e = launch<bf16>(qu, qv, k, v, p, m, l, out, d_out, dqf, dvf, dk_out, dv_out, dpf, dl, B, H,
                     T_len, drop, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
