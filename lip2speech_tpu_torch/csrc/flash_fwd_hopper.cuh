// The flash-attention forward on Hopper (sm_90a), written once for its three
// callers and both input types: attention.cu launches it without the
// position term, rel_attention.cu with it (kPos), rel_attention_bias.cu
// with an additive f32 bias instead (kBias). Not compiled on its own.
//
// Computes, per (batch, head), with q_u, k, v (T, 64) and, with kPos, q_v
// (T, 64) and the position table p (2T-1, 64), with kBias the bias (T, T):
//     S[i, j] = (q_u[i].k[j] (+ q_v[i].p[T-1-i+j])) / sqrt(64) (+ bias[i, j])
// keys with mask 0 score -1e30, keys past the sequence -inf, then O =
// softmax_j(S) V and, where asked, the per-row natural-log log-sum-exp.
// Under dropout the product with V sees the probabilities times keep / (1 -
// rate), the sum and the log-sum-exp the undropped ones; keep is
// philox.cuh's function of (seed, b*h, i, j).
//
// The block: 384 threads, two consumer warpgroups and a producer warpgroup
// (hopper.cuh), one block an SM. The producer issues TMA loads: Q_u (and
// Q_v) once, then per key tile of 64 K, V and, with kPos, the one 64-row
// chunk of the position table that the tile's window adds (bf16: the
// window is a ring of chunks, refilled only after every tile that reads a
// chunk released its stage), into rings of stages on loaded / ready /
// empty mbarriers. TMA zero-fills rows past the sequence and the table's
// ends (negative rows included); the key flags the producer writes (1
// valid, 0 masked, -1 past the sequence, the mask read a tile ahead) keep
// zero-filled keys out of the softmax. Under dropout the producer draws
// the tile's keep bits (hopper.cuh `keep_half`, eight Philox calls a thread
// for 64 rows) into the stage before it is ready. The consumers' online
// softmax runs on the accumulator in log2 units (exp2, the scale and
// log2(e) folded into one multiply; a masked key scores -1e30 log2(e), so
// the log-sum-exp m ln 2 + ln l is the natural one), and P stays in
// registers as the A operand of O += P V. Every shared-memory pointer
// derives from the dynamic shared array by offsets, so the compiler emits
// shared loads and stores (LDS / STS, 32-bit addresses); a base rounded
// through an integer turns every access into a generic 64-bit one, 10-13%
// slower here.
//   bf16: a block owns 128 query rows, consumer warpgroup c rows 64c ..
// 64c+63 against every key of each tile; every product on wgmma with f32
// accumulation: S = Q_u K^T m64n64k16 from shared memory, P V m64n64k16
// with P rounded to bf16 in registers and V MN-major, and the position term
// as the shear backward computes it (hopper.cuh `position_band`: G = Q_v
// Win^T over the warpgroup's 128 window rows, each warp's band through its
// f32 scratch, read back along the diagonal into S's accumulator: two
// products for 64 x 64 scores). Four stages of K and V; 142 (154 with the
// position term) registers, no spill.
//   f32: 3xTF32 (hi = v rounded to TF32, lo = v - hi, lo hi + hi lo + hi hi
// with f32 sums; mma_tile.cuh). A block owns 64 query rows, and each
// consumer warpgroup runs its own online softmax; the two parts merge (max,
// sum, O) through shared memory at the end. The producer splits tiles in
// shared memory (hi in place, lo beside) and writes V as V^T split in hi
// and lo, its keys in each k8 step in the order 0, 2, 4, 6, 1, 3, 5, 7
// (where P's accumulator holds them: TF32 wgmma reads B only K-major).
// Every product on wgmma, P V m64n64k8 with P split in registers as A.
//   Without the position term the warpgroups take alternate whole tiles,
// so each one's serial path is half the tiles. S = Q K^T m64n64k8 takes
// Q's fragments split in registers (hopper.cuh wgmma_nt32; no split pass
// over Q), and a last tile whose keys past 31 all lie past the sequence
// (the flagship's f32 request at T 96) runs as m64n32k8 and four k-steps
// of P V. K and V are loaded by two of the producer's warps, so that the
// TMA issues overlap. Three stages of K and two of V^T: 177.9 KB, 128
// registers, no spill. At T 96 (32 blocks on 132 SMs) the block's time is
// its chain: TMA, the producer's passes over K and V, S, the softmax, P V,
// the merge.
//   With the position term warpgroup c takes keys 32c .. 32c+31 of every
// tile (S m64n32k8 from the split Q_u) and the position term as G^T = Win
// Q_v^T m64n32k8 of its 32 query rows against window chunk t + 1 (A split
// in registers). Chunk t + 1 holds tile t's G where j > a and tile t + 1's
// where j <= a, so each chunk is computed once; both warpgroups store their
// parts sheared, Gs[a][j] = G[a][63-a+j] (the second part once the tile's
// reads are done), and read back their scores' own places. The producer
// splits Q_u, Q_v once and K once a tile, and writes V^T. Two stages of K
// with their window chunk, one of V^T: 210.6 KB, 168 registers, a 24-byte
// spill.
//
//   With the bias (kBias, no position term; the layouts above, f32 with a
// stage of keep bits beside each K stage) each consumer thread loads the
// bias of its own score elements straight from device memory into the
// accumulator layout (mma_tile.cuh `load_frag_f32`: a quad reads one 32-byte
// sector of a row; float2 for even T, kBias 2, single floats else, kBias
// 1), one tile ahead: issued as soon as the tile's bias is added, they land
// during the softmax, P V and the next S. This works at any T, where a TMA
// box of the bias needs a row stride of 16 bytes (T % 4 == 0), and needs no
// shared memory; the cost is 32 registers a thread, which setmaxnreg takes
// from the producer warpgroup (64 registers) for the consumers (216). The
// score in log2 units is acc scale log2(e) + bias log2(e), one fma on the
// f32 bias, never rounded before it. Under dropout the producer draws the
// keep bits (`keep_half`) for the f32 path too.
//
// Bounds are checked: any T.

#pragma once

#include "hopper.cuh"

namespace flash_fwd {

using namespace mma;
namespace hp = hopper;

constexpr int kThreads = 384;   // two consumer warpgroups, then the producer warpgroup
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMasked2 = flash::kMasked * hp::kLog2e;   // a masked key's score, log2 units

// Shared memory, byte offsets from a 1024-aligned base. kDrop: the f32
// path without the position term keeps a stage of dropout words beside each
// K stage (the bias route); bf16 always has them.
template <typename T, bool kPos, bool kDrop = false>
struct Layout;

// bf16: 128 query rows; a stage holds a tile's K and V.
template <bool kPos, bool kDrop>
struct Layout<bf16, kPos, kDrop> {
  static constexpr bool kBf16 = true;
  static constexpr int kQT = 2;                  // 64-row query tiles a block
  static constexpr int kRows = 64 * kQT;
  static constexpr int TB = kB * kD * 2;         // a 64 x 64 tile
  static constexpr int kS = 4;                   // stages
  static constexpr int kSK = kS, kSV = 0;        // the stages' barriers: K's
  static constexpr int kStageBytes = 2 * TB;     // K, V
  static constexpr int kChunks = kQT + 1;        // window chunks a tile reads
  static constexpr int kRing = kPos ? kS + kChunks - 1 : 0;
  static constexpr int kKeepBytes = kQT * 512;   // dropout words of a stage
  static constexpr int kQu = 0, kQv = kQT * TB;
  static constexpr int kStage = kQv + (kPos ? kQT * TB : 0);
  static constexpr int kRingOff = kStage + kS * kStageBytes;
  static constexpr int kScr = kRingOff + kRing * TB;               // the warps' G bands
  static constexpr int kFlags = kScr + (kPos ? 8 * 16 * kGld * 4 : 0);   // [kS] x 64 key flags
  static constexpr int kKeep = kFlags + kS * kB * 4;               // [kS] x kKeepBytes
  static constexpr int kBars = kKeep + kS * kKeepBytes;   // q, (qs), loaded, ready, empty [kS]
  static constexpr int kSmem = kBars + (2 + 3 * kS) * 8 + 1024;   // + alignment slack
  static_assert(kSmem <= 232448, "shared memory of one block");
};

// f32 without the position term: 64 query rows (Q as it landed: the
// consumers split its fragments in registers); rings of K (hi, lo) and V^T
// (hi, lo; V lands in lo).
template <bool kDrop>
struct Layout<float, false, kDrop> {
  static constexpr bool kBf16 = false;
  static constexpr int kQT = 1;
  static constexpr int kRows = 64;
  static constexpr int TB = kB * kD * 4;         // a 64 x 64 tile: two halves of 32 channels
  static constexpr int kSK = 3, kSV = 2;         // K stages, V stages
  static constexpr int kQu = 0;
  static constexpr int kK = TB;                          // [kSK] x (hi, lo)
  static constexpr int kVT = kK + kSK * 2 * TB;          // [kSV] x (V^T hi, V^T lo)
  static constexpr int kFlags = kVT + kSV * 2 * TB;      // [kSK] x 64 key flags
  static constexpr int kKeep = kFlags + kSK * kB * 4;    // kDrop: [kSK] x 128 words
  // q, (qs), K loaded, ready, empty [kSK], V loaded, ready, empty [kSV]
  static constexpr int kBars = kKeep + (kDrop ? kSK * 512 : 0);
  static constexpr int kSmem = kBars + (2 + 3 * kSK + 3 * kSV) * 8 + 1024;
  static_assert(kSmem <= 232448, "shared memory of one block");
};

// f32 with the position term: 64 query rows (Q_u, Q_v: hi in place, lo
// beside); a K stage holds the tile's K (hi, lo) and window chunk t + 1;
// one stage of V^T (hi, lo); the sheared Gs, where window chunk 0 lands.
template <>
struct Layout<float, true, false> {
  static constexpr bool kBf16 = false;
  static constexpr int kQT = 1;
  static constexpr int kRows = 64;
  static constexpr int TB = kB * kD * 4;
  static constexpr int kSK = 2, kSV = 1;         // K stages, V stages
  static constexpr int kStageBytes = 3 * TB;
  static constexpr int kQu = 0, kQv = 2 * TB;
  static constexpr int kStage = 4 * TB;                    // [kSK] x (K hi, K lo, chunk)
  static constexpr int kVT = kStage + kSK * kStageBytes;   // V^T hi, V^T lo (V lands in lo)
  static constexpr int kScr = kVT + 2 * TB;
  static constexpr int kFlags = kScr + TB;                 // [kSK] x 64 key flags
  static constexpr int kKeep = kFlags + kSK * kB * 4;      // [kSK] x 128 words
  static constexpr int kBars = kKeep + kSK * 512;
  // q, qs, K loaded, ready, empty [kSK], V loaded, ready, empty
  static constexpr int kSmem = kBars + (2 + 3 * kSK + 3 * kSV) * 8 + 1024;
  static_assert(kSmem <= 232448, "shared memory of one block");
};

// bf16 uses the K barriers for its stages of K and V.
struct Bars {
  uint64_t *q, *qs, *kl, *kr, *ke, *vl, *vr, *ve;
};

struct Args {
  const uint8_t* mask;   // (B, T) key mask, or null: every key valid
  const float* bias;     // kBias: (B, H, T, T) f32
  void* out;             // (B, H, T, 64) of the input type
  float* lse;            // (B, H, T), or null
  int H, T_len;
  float scale;
  philox::Dropout drop;
};

// Element (a, j) of the sheared position scratch: row a holds BD[a][0..63],
// its 8-float groups XOR-ed with a % 8.
__device__ __forceinline__ int gs_at(int a, int j) { return (a << 6) + (j ^ ((a & 7) << 3)); }

// window chunk m (table rows T-64-i0+64m ..)
template <typename T, bool kPos>
__device__ __forceinline__ T* ring_chunk(unsigned char* sm, int m) {
  using L = Layout<T, kPos>;
  return reinterpret_cast<T*>(sm + L::kRingOff + (m % L::kRing) * L::TB);
}

__device__ __forceinline__ uint64_t dsc(const bf16* p) { return hp::desc_sw128(p); }

// f32 V: thread pt (of 128) reads key row pt / 2, channels 32 (pt % 2) ..
// +31, of a landed tile into x; store_vt writes them as V^T split in hi and
// lo, the keys of each k8 step in the order 0, 2, 4, 6, 1, 3, 5, 7 (where
// P's accumulator holds them: TF32 wgmma reads B only K-major).
__device__ __forceinline__ void load_v(float (&x)[32], const float* v, int pt) {
  const int r = pt >> 1, c0 = 32 * (pt & 1);
#pragma unroll
  for (int c4 = 0; c4 < 8; ++c4) {
    const float4 y = *reinterpret_cast<const float4*>(v + hp::sw32(r, c0 + 4 * c4));
    x[4 * c4] = y.x;
    x[4 * c4 + 1] = y.y;
    x[4 * c4 + 2] = y.z;
    x[4 * c4 + 3] = y.w;
  }
}
__device__ __forceinline__ void store_vt(const float (&x)[32], float* vth, float* vtl, int pt) {
  const int r = pt >> 1, c0 = 32 * (pt & 1);
  const int kp = 8 * (r >> 3) + ((r & 7) >> 1) + 4 * (r & 1);   // key r's place in its k8 step
#pragma unroll
  for (int cc = 0; cc < 32; ++cc) {
    uint32_t hi, lo;
    split(x[cc], hi, lo);
    const int at = hp::sw32(c0 + cc, kp);
    vth[at] = __uint_as_float(hi);
    vtl[at] = __uint_as_float(lo);
  }
}

// hi in place, lo = v - hi into `lo`, over a whole f32 tile by 128 threads
// (tid 0 ..): every load first, then the splits and stores (hopper.cuh
// split_tile's loop, whose loads wait on the stores before them)
__device__ __forceinline__ void split_tile128(float* hi, float* lo, int tid) {
  constexpr int kIt = kB * kD / 4 / 128;
  float4* h4 = reinterpret_cast<float4*>(hi);
  float4* l4 = reinterpret_cast<float4*>(lo);
  float4 x[kIt];
#pragma unroll
  for (int i = 0; i < kIt; ++i) x[i] = h4[tid + 128 * i];
#pragma unroll
  for (int i = 0; i < kIt; ++i) {
    float4 y;
    uint32_t a, b;
    split(x[i].x, a, b); x[i].x = __uint_as_float(a); y.x = __uint_as_float(b);
    split(x[i].y, a, b); x[i].y = __uint_as_float(a); y.y = __uint_as_float(b);
    split(x[i].z, a, b); x[i].z = __uint_as_float(a); y.z = __uint_as_float(b);
    split(x[i].w, a, b); x[i].w = __uint_as_float(a); y.w = __uint_as_float(b);
    h4[tid + 128 * i] = x[i];
    l4[tid + 128 * i] = y;
  }
}

// ---------------------------------------------------------------------------
// producer
// ---------------------------------------------------------------------------

// The producer warpgroup, bf16: tile t's K, V (and window chunk) into its
// stage once the consumers released it, then its key flags and keep bits,
// and the stage is ready.
template <bool kPos>
__device__ __forceinline__ void produce_bf16(const CUtensorMap* tm_qu, const CUtensorMap* tm_qv,
                                             const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                             const CUtensorMap* tm_p, unsigned char* sm,
                                             const Bars& br, const Args& g, int bh, int i0) {
  using T = bf16;
  using L = Layout<T, kPos>;
  const int pt = threadIdx.x - 256, T_len = g.T_len, n_tiles = (T_len + kB - 1) / kB;
  const int h = bh % g.H, wbase = T_len - L::kRows - i0;   // table row of window chunk 0
  const uint8_t* mask_row = g.mask == nullptr ? nullptr : g.mask + (size_t)(bh / g.H) * T_len;
  const bool drop = g.drop.thresh != 0u;
  if (pt == 0) {
    hp::mbar_expect_tx(br.q, (kPos ? 2 : 1) * L::kQT * L::TB);
#pragma unroll
    for (int qt = 0; qt < L::kQT; ++qt) {
      hp::tma_tile<T>(sm + L::kQu + qt * L::TB, tm_qu, br.q, i0 + kB * qt, bh);
      if constexpr (kPos) hp::tma_tile<T>(sm + L::kQv + qt * L::TB, tm_qv, br.q, i0 + kB * qt, bh);
    }
  }
  // the key mask byte of thread pt's key in the next tile, read a tile ahead
  auto mask_at = [&](int j) -> int {
    return j < T_len ? ((mask_row == nullptr || mask_row[j]) ? 1 : 0) : -1;
  };
  int m_next = pt < kB ? mask_at(pt) : 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % L::kS;
    if (t >= L::kS) hp::mbar_wait(&br.ke[s], ((t / L::kS) - 1) & 1);
    if (pt == 0) {
      unsigned char* st = sm + L::kStage + s * L::kStageBytes;
      hp::mbar_expect_tx(&br.kl[s], (kPos ? (t == 0 ? 2 + L::kChunks : 3) : 2) * L::TB);
      hp::tma_tile<T>(st, tm_k, &br.kl[s], kB * t, bh);
      hp::tma_tile<T>(st + L::TB, tm_v, &br.kl[s], kB * t, bh);
      if constexpr (kPos) {
        for (int m = t == 0 ? 0 : t + L::kChunks - 1; m < t + L::kChunks; ++m)
          hp::tma_tile<T>(ring_chunk<T, kPos>(sm, m), tm_p, &br.kl[s], wbase + kB * m, h);
      }
    }
    if (pt < kB) {   // 1 valid, 0 masked, -1 past the sequence
      reinterpret_cast<float*>(sm + L::kFlags)[s * kB + pt] = (float)m_next;
      if (t + 1 < n_tiles) m_next = mask_at(kB * (t + 1) + pt);
    }
    if (drop) {   // rows g + 8 into the high halves
#pragma unroll
      for (int qt = 0; qt < L::kQT; ++qt) {
        uint32_t even, odd;
        hp::keep_half(even, odd, g.drop, bh, i0 + kB * qt, kB * t, pt);
        const uint32_t e8 = __shfl_xor_sync(0xffffffffu, even, 1);
        const uint32_t o8 = __shfl_xor_sync(0xffffffffu, odd, 1);
        if ((pt & 1) == 0) {
          const int p = pt >> 1;
          uint32_t* words = reinterpret_cast<uint32_t*>(sm + L::kKeep + s * L::kKeepBytes) +
                            128 * qt + 32 * (p >> 4) + 4 * ((p >> 1) & 7) + 2 * (p & 1);
          words[0] = even | (e8 << 16);
          words[1] = odd | (o8 << 16);
        }
      }
    }
    hp::named_barrier(3, 128);
    if (pt == 0) hp::mbar_arrive(&br.kr[s]);
  }
}

// The producer warpgroup, f32 without the position term: Q lands once (the
// consumers split its fragments in registers). K and V have rings of their
// own, loaded by two of the producer's warps so that the issues overlap:
// process_k(t) writes the tile's key flags and splits K once it landed;
// process_v(t) writes V^T split. The consumer warpgroups take alternate
// tiles, so K is readied two tiles ahead. kDrop: under dropout process_k
// also draws the tile's keep bits into the stage.
template <bool kDrop>
__device__ __forceinline__ void produce_keys(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                             const CUtensorMap* tm_v, unsigned char* sm,
                                             const Bars& br, const Args& g, int bh, int i0) {
  using L = Layout<float, false, kDrop>;
  const int pt = threadIdx.x - 256, T_len = g.T_len, n_tiles = (T_len + kB - 1) / kB;
  const uint8_t* mask_row = g.mask == nullptr ? nullptr : g.mask + (size_t)(bh / g.H) * T_len;
  const bool drop = kDrop && g.drop.thresh != 0u;
  if (pt == 0) {
    hp::mbar_expect_tx(br.q, L::TB);
    hp::tma_tile<float>(sm + L::kQu, tm_q, br.q, i0, bh);
  }
  auto issue_k = [&](int t) {
    const int s = t % L::kSK;
    if (t >= L::kSK) hp::mbar_wait(&br.ke[s], ((t / L::kSK) - 1) & 1);
    if (pt == 32) {
      hp::mbar_expect_tx(&br.kl[s], L::TB);
      hp::tma_tile<float>(sm + L::kK + s * 2 * L::TB, tm_k, &br.kl[s], kB * t, bh);
    }
  };
  auto issue_v = [&](int t) {   // into V^T lo
    const int v = t % L::kSV;
    if (t >= L::kSV) hp::mbar_wait(&br.ve[v], ((t / L::kSV) - 1) & 1);
    if (pt == 64) {
      hp::mbar_expect_tx(&br.vl[v], L::TB);
      hp::tma_tile<float>(sm + L::kVT + v * 2 * L::TB + L::TB, tm_v, &br.vl[v], kB * t, bh);
    }
  };
  // the key mask byte of thread pt's key in the next tile, read a tile ahead
  auto mask_at = [&](int j) -> int {
    return j < T_len ? ((mask_row == nullptr || mask_row[j]) ? 1 : 0) : -1;
  };
  int m_next = pt < kB ? mask_at(pt) : 0;
  auto process_k = [&](int t) {
    const int s = t % L::kSK;
    if (pt < kB) {   // 1 valid, 0 masked, -1 past the sequence
      reinterpret_cast<float*>(sm + L::kFlags)[s * kB + pt] = (float)m_next;
      if (t + 1 < n_tiles) m_next = mask_at(kB * (t + 1) + pt);
    }
    if (drop) {   // rows g + 8 into the high halves
      uint32_t even, odd;
      hp::keep_half(even, odd, g.drop, bh, i0, kB * t, pt);
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
    hp::mbar_wait(&br.kl[s], (t / L::kSK) & 1);
    float* kh = reinterpret_cast<float*>(sm + L::kK + s * 2 * L::TB);
    split_tile128(kh, kh + kB * kD, pt);
    hp::fence_proxy_async();
    hp::named_barrier(3, 128);
    if (pt == 0) hp::mbar_arrive(&br.kr[s]);
  };
  auto process_v = [&](int t) {
    const int v = t % L::kSV;
    float* vth = reinterpret_cast<float*>(sm + L::kVT + v * 2 * L::TB);
    float x[32];
    hp::mbar_wait(&br.vl[v], (t / L::kSV) & 1);
    load_v(x, vth + kB * kD, pt);
    hp::named_barrier(3, 128);   // V is read before V^T lo overwrites it
    store_vt(x, vth, vth + kB * kD, pt);
    hp::fence_proxy_async();
    hp::named_barrier(3, 128);
    if (pt == 0) hp::mbar_arrive(&br.vr[v]);
  };

  for (int t = 0; t < n_tiles && t < L::kSK; ++t) issue_k(t);
  for (int t = 0; t < n_tiles && t < L::kSV; ++t) issue_v(t);
  for (int t = 0; t < 2 && t < n_tiles; ++t) process_k(t);
  for (int t = 0; t < n_tiles; ++t) {
    process_v(t);
    if (t + 2 < n_tiles) process_k(t + 2);
    if (t + L::kSK < n_tiles) issue_k(t + L::kSK);
    if (t + L::kSV < n_tiles) issue_v(t + L::kSV);
  }
}

// The producer warpgroup, f32 with the position term. Q_u and Q_v are
// split once a block. Tile t's stage holds K and window chunk t + 1 (chunk
// 0 lands in the scratch); process_k(t) writes the tile's key flags and
// keep bits and splits K once it landed; process_v(t) writes V^T split from
// V, which lands in V^T lo once the consumers finished P V of tile t - 1.
// Each tile's K is ready before the consumers start it, and its V while
// they compute its scores.
__device__ __forceinline__ void produce_f32(const CUtensorMap* tm_qu, const CUtensorMap* tm_qv,
                                            const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                            const CUtensorMap* tm_p, unsigned char* sm,
                                            const Bars& br, const Args& g, int bh, int i0) {
  using L = Layout<float, true>;
  const int pt = threadIdx.x - 256, T_len = g.T_len, n_tiles = (T_len + kB - 1) / kB;
  const int h = bh % g.H, wbase = T_len - kB - i0;   // table row of window chunk 0
  const uint8_t* mask_row = g.mask == nullptr ? nullptr : g.mask + (size_t)(bh / g.H) * T_len;
  const bool drop = g.drop.thresh != 0u;
  if (pt == 0) {
    hp::mbar_expect_tx(br.q, 2 * L::TB);
    hp::tma_tile<float>(sm + L::kQu, tm_qu, br.q, i0, bh);
    hp::tma_tile<float>(sm + L::kQv, tm_qv, br.q, i0, bh);
  }
  auto stage = [&](int s) { return reinterpret_cast<float*>(sm + L::kStage + s * L::kStageBytes); };
  auto issue_k = [&](int t) {
    const int s = t % L::kSK;
    if (t >= L::kSK) hp::mbar_wait(&br.ke[s], ((t / L::kSK) - 1) & 1);
    if (pt == 0) {
      hp::mbar_expect_tx(&br.kl[s], (t == 0 ? 3 : 2) * L::TB);
      hp::tma_tile<float>(stage(s), tm_k, &br.kl[s], kB * t, bh);
      hp::tma_tile<float>(stage(s) + 2 * kB * kD, tm_p, &br.kl[s], wbase + kB * (t + 1), h);
      if (t == 0) hp::tma_tile<float>(sm + L::kScr, tm_p, &br.kl[s], wbase, h);
    }
  };
  auto issue_v = [&](int t) {   // into V^T lo, once P V of tile t - 1 is done
    if (t > 0) hp::mbar_wait(br.ve, (t - 1) & 1);
    if (pt == 0) {
      hp::mbar_expect_tx(br.vl, L::TB);
      hp::tma_tile<float>(sm + L::kVT + L::TB, tm_v, br.vl, kB * t, bh);
    }
  };
  // the key mask byte of thread pt's key in the next tile, read a tile ahead
  auto mask_at = [&](int j) -> int {
    return j < T_len ? ((mask_row == nullptr || mask_row[j]) ? 1 : 0) : -1;
  };
  int m_next = pt < kB ? mask_at(pt) : 0;
  auto process_k = [&](int t) {
    const int s = t % L::kSK;
    if (pt < kB) {   // 1 valid, 0 masked, -1 past the sequence
      reinterpret_cast<float*>(sm + L::kFlags)[s * kB + pt] = (float)m_next;
      if (t + 1 < n_tiles) m_next = mask_at(kB * (t + 1) + pt);
    }
    if (drop) {   // rows g + 8 into the high halves
      uint32_t even, odd;
      hp::keep_half(even, odd, g.drop, bh, i0, kB * t, pt);
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
    hp::mbar_wait(&br.kl[s], (t / L::kSK) & 1);
    hp::split_tile<128>(stage(s), stage(s) + kB * kD, pt);
    hp::fence_proxy_async();
    hp::named_barrier(3, 128);
    if (pt == 0) hp::mbar_arrive(&br.kr[s]);
  };
  auto process_v = [&](int t) {
    float* vth = reinterpret_cast<float*>(sm + L::kVT);
    float x[32];
    hp::mbar_wait(br.vl, t & 1);
    load_v(x, vth + kB * kD, pt);
    hp::named_barrier(3, 128);   // V is read before V^T lo overwrites it
    store_vt(x, vth, vth + kB * kD, pt);
    hp::fence_proxy_async();
    hp::named_barrier(3, 128);
    if (pt == 0) hp::mbar_arrive(br.vr);
  };

  issue_k(0);
  if (n_tiles > 1) issue_k(1);
  issue_v(0);
  hp::mbar_wait(br.q, 0);   // Q_u and Q_v split once a block
  float* qu = reinterpret_cast<float*>(sm + L::kQu);
  hp::split_tile<128>(qu, qu + kB * kD, pt);
  float* qv = reinterpret_cast<float*>(sm + L::kQv);
  hp::split_tile<128>(qv, qv + kB * kD, pt);
  hp::fence_proxy_async();
  hp::named_barrier(3, 128);
  if (pt == 0) hp::mbar_arrive(br.qs);
  process_k(0);
  for (int t = 0; t < n_tiles; ++t) {
    process_v(t);
    if (t + 1 < n_tiles) process_k(t + 1);
    if (t + 2 < n_tiles) issue_k(t + 2);
    if (t + 1 < n_tiles) issue_v(t + 1);
  }
}

// ---------------------------------------------------------------------------
// consumers
// ---------------------------------------------------------------------------

// The online softmax step of a warpgroup's NT n8 columns of a tile (flags:
// theirs): the unscaled scores sc become P = exp2(S scale log2(e) - m) at
// the new running maximum m (log2 units), O and the lane's share of the
// row sums l are rescaled and l takes P's sum; under dropout P is then
// scaled by keep / (1 - rate) for P V, the bits of n-tile n at bit 2 (n0 +
// n) + e of the row's half of the lane's keep word.
template <int NT>
__device__ __forceinline__ void softmax_step(float (&sc)[NT][4], float (&o)[8][4], float m_run[2],
                                             float l_run[2], const float* flags, float sl2,
                                             const philox::Dropout& drop, uint32_t keep, int n0,
                                             int q) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float f = flags[8 * n + 2 * q + (e & 1)];
      sc[n][e] = f > 0.f ? sc[n][e] * sl2 : (f == 0.f ? kMasked2 : -INFINITY);
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
    }
  float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r]);
    alpha[r] = exp2f(m_run[r] - m_new);
    m_run[r] = m_new;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[n][e] = exp2f(sc[n][e] - m_run[e >> 1]);
      rs[e >> 1] += sc[n][e];
    }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
  // the lane's share of the row sums; the quad adds them up at the end
  l_run[0] = l_run[0] * alpha[0] + rs[0];
  l_run[1] = l_run[1] * alpha[1] + rs[1];
  if (drop.thresh != 0u) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[n][e] *= (keep >> (16 * (e >> 1) + 2 * (n0 + n) + (e & 1))) & 1u ? drop.inv_keep : 0.f;
  }
}

// The rows' sums over the quad, and their inverses; with lse, the rows'
// natural-log log-sum-exp m ln 2 + ln l to lse[i] for rows i < T.
__device__ __forceinline__ void finish_rows(const float m_run[2], float l[2], float inv[2],
                                            float* lse, int i_g, int T_len, int q) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = fmaxf(l[r], 1e-20f);
    inv[r] = 1.f / l[r];
    const int i = i_g + 8 * r;
    if (lse != nullptr && q == 0 && i < T_len) lse[i] = m_run[r] * kLn2 + logf(l[r]);
  }
}

// kBias: the bias of the lane's score elements (rows i_g, i_g + 8) of key
// tile j0 .. j0+63 in the accumulator layout, float2 (2) or single floats (1)
template <int kBias>
__device__ __forceinline__ void load_bias(float (&bt)[8][4], const Args& g, int bh, int i_g, int j0,
                                          int q) {
  const int T_len = g.T_len;
  mma::load_frag_f32<kBias == 2, 8>(bt, g.bias + (size_t)bh * T_len * T_len, T_len, i_g, j0, T_len,
                                    T_len, q);
}

// The scores in log2 units with the bias: acc scale log2(e) + bias log2(e)
template <int NT>
__device__ __forceinline__ void add_bias(float (&sc)[NT][4], const float (&bt)[8][4], float sl2) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[n][e] = fmaf(sc[n][e], sl2, bt[n][e] * hp::kLog2e);
}

// bf16: warpgroup c owns query rows 64c .. 64c+63 of the block's 128 and
// every key of each tile; every product on wgmma.
template <bool kPos, int kBias>
__device__ __forceinline__ void consume_rows(unsigned char* sm, const Bars& br, const Args& g,
                                             int bh, int i0) {
  using L = Layout<bf16, kPos>;
  const int tid = threadIdx.x, c = hp::warp_index() >> 2, w = hp::warp_index() & 3;
  const int lane = tid & 31, q = lane & 3, gq = lane >> 2, ct = tid & 127;
  const int T_len = g.T_len, n_tiles = (T_len + kB - 1) / kB;
  const float sl2 = g.scale * hp::kLog2e;
  const bf16* sQu = reinterpret_cast<const bf16*>(sm + L::kQu) + c * kTile;
  const bf16* sQv = reinterpret_cast<const bf16*>(sm + L::kQv) + c * kTile;
  float* sG = reinterpret_cast<float*>(sm + L::kScr) + (4 * c + w) * 16 * kGld;
  const int i_g = i0 + 64 * c + 16 * w + gq;

  float o[8][4];
  zero<8>(o);
  float m_run[2] = {kMasked2, kMasked2}, l_run[2] = {0.f, 0.f};
  [[maybe_unused]] float bt[8][4];   // kBias: the next tile's bias
  if constexpr (kBias != 0) load_bias<kBias>(bt, g, bh, i_g, 0, q);
  hp::mbar_wait(br.q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % L::kS;
    const uint32_t ph = (t / L::kS) & 1;
    hp::mbar_wait(&br.kl[s], ph);
    hp::mbar_wait(&br.kr[s], ph);
    const unsigned char* st = sm + L::kStage + s * L::kStageBytes;
    const bf16* sK = reinterpret_cast<const bf16*>(st);
    const bf16* sV = reinterpret_cast<const bf16*>(st + L::TB);

    float sc[8][4];
    zero<8>(sc);
    hp::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      hp::wgmma_bf16_ss<0, 0>(sc, dsc(sQu + 16 * ks), dsc(sK + 16 * ks));
    hp::wgmma_commit();
    if constexpr (kPos) {
      // this warpgroup's window rows 0..63 and 64..127: chunks t + 1 - c, t + 2 - c;
      // position_band waits for S too
      hp::position_band(sG, sQv, ring_chunk<bf16, kPos>(sm, t + 1 - c),
                        ring_chunk<bf16, kPos>(sm, t + 2 - c), 48 - 16 * w, q, lane);
      hp::fence_acc(sc);
      add_diagonal<8, kGld>(sc, sG, lane);
    } else {
      hp::wgmma_wait<0>();
      hp::fence_acc(sc);
    }
    float scl = sl2;   // the scores' scale into log2 units
    if constexpr (kBias != 0) {
      add_bias<8>(sc, bt, sl2);
      scl = 1.f;
      if (t + 1 < n_tiles) load_bias<kBias>(bt, g, bh, i_g, kB * (t + 1), q);
    }
    const uint32_t keep = g.drop.thresh != 0u
        ? reinterpret_cast<const uint32_t*>(sm + L::kKeep + s * L::kKeepBytes)[128 * c + ct] : 0u;
    softmax_step<8>(sc, o, m_run, l_run, reinterpret_cast<const float*>(sm + L::kFlags) + s * kB,
                    scl, g.drop, keep, 0, q);
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) to_a(a[kk], sc, kk);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hp::wgmma_bf16_rs<1>(o, a[kk], dsc(sV + 16 * kk * kD));
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_acc(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hp::fence_regs(a[kk]);
    hp::mbar_arrive(&br.ke[s]);
  }
  float l[2], inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l_run[r];
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  finish_rows(m_run, l, inv, g.lse == nullptr ? nullptr : g.lse + (size_t)bh * T_len, i_g, T_len,
              q);
  store_rows(static_cast<bf16*>(g.out) + (size_t)bh * T_len * kD, o, i_g, T_len, inv, q);
}

// S of the 8 NT keys key0 .. of the tile: Q_u K^T from the split tiles,
// issued (the caller waits)
template <int NT>
__device__ __forceinline__ void scores(float (&sc)[NT][4], const float* sQu, const float* sK,
                                       int key0) {
  const float* qh = sQu;
  const float* ql = sQu + kB * kD;
  const float* kh = sK + 32 * key0;   // rows key0 .. of each 32-channel half
  const float* kl = kh + kB * kD;
  hp::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    hp::wgmma_tf32_ss(sc, hp::dsc32(ql, ks), hp::dsc32(kh, ks));
    hp::wgmma_tf32_ss(sc, hp::dsc32(qh, ks), hp::dsc32(kl, ks));
    hp::wgmma_tf32_ss(sc, hp::dsc32(qh, ks), hp::dsc32(kh, ks));
  }
  hp::wgmma_commit();
}

// O += P V over the 8 NK keys 8 ks0 .. of the tile on wgmma m64n64k8: P
// split in registers as A (its k8 steps' keys in the order 0, 2, 4, 6, 1,
// 3, 5, 7), B the split V^T, whose keys the producer placed in that order.
template <int NK>
__device__ __forceinline__ void pv(float (&o)[8][4], const float (&p)[NK][4], const float* vth,
                                   int ks0) {
  const float* vtl = vth + kB * kD;
  uint32_t ah[NK][4], al[NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const uint32_t av[4] = {__float_as_uint(p[kk][0]), __float_as_uint(p[kk][2]),
                            __float_as_uint(p[kk][1]), __float_as_uint(p[kk][3])};
    split4(av, ah[kk], al[kk]);
  }
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const int ks = ks0 + kk;
    hp::wgmma_tf32_rs(o, al[kk], hp::dsc32(vth, ks));
    hp::wgmma_tf32_rs(o, ah[kk], hp::dsc32(vtl, ks));
    hp::wgmma_tf32_rs(o, ah[kk], hp::dsc32(vth, ks));
  }
  hp::wgmma_commit();
  hp::wgmma_wait<0>();
  hp::fence_acc(o);
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    hp::fence_regs(ah[kk]);
    hp::fence_regs(al[kk]);
  }
}

// f32: each consumer warpgroup runs an online softmax of its own over the
// block's 64 query rows, without the position term on alternate whole
// tiles, with it on keys 32c .. 32c+31 of every tile; the parts are
// combined at the end.

// A part (O, max, sum) of thread ct's rows as 36 x 128 floats at x.
__device__ __forceinline__ void put_part(const float (&o)[8][4], const float m_run[2],
                                         const float l[2], float* x, int ct) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[(4 * n + e) * 128 + ct] = o[n][e];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    x[(32 + r) * 128 + ct] = m_run[r];
    x[(34 + r) * 128 + ct] = l[r];
  }
}
// merges the part at x into (o, m_run, l)
__device__ __forceinline__ void merge_part(float (&o)[8][4], float m_run[2], float l[2],
                                           const float* x, int ct) {
  float a[2], b[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = x[(32 + r) * 128 + ct], l1 = x[(34 + r) * 128 + ct];
    const float m_new = fmaxf(m_run[r], m1);
    a[r] = exp2f(m_run[r] - m_new);
    b[r] = exp2f(m1 - m_new);
    l[r] = l[r] * a[r] + l1 * b[r];
    m_run[r] = m_new;
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[n][e] = o[n][e] * a[e >> 1] + x[(4 * n + e) * 128 + ct] * b[e >> 1];
}

// The rows' sums over the quad (l), then warpgroup 1 hands its part to
// warpgroup 0 through x, which both consumers are done with and the async
// proxy (TMA, wgmma) last wrote or read. True in warpgroup 0, which then
// holds the block's part.
__device__ __forceinline__ bool merge_warpgroups(float (&o)[8][4], float m_run[2], float l[2],
                                                 const float l_run[2], float* x) {
  const int c = hp::warp_index() >> 2, ct = threadIdx.x & 127;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l_run[r];
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  hp::fence_proxy_async();
  hp::named_barrier(1, 256);
  if (c == 1) put_part(o, m_run, l, x, ct);
  hp::named_barrier(1, 256);
  if (c == 1) return false;
  merge_part(o, m_run, l, x, ct);
  return true;
}

// Warpgroup 0's rows (and their log-sum-exp) to the output.
__device__ __forceinline__ void store_part(float (&o)[8][4], const float m_run[2], float l[2],
                                           const Args& g, int bh, int i0) {
  const int w = hp::warp_index() & 3, lane = threadIdx.x & 31, q = lane & 3, gq = lane >> 2;
  const int i_g = i0 + 16 * w + gq;
  float inv[2];
  finish_rows(m_run, l, inv, g.lse == nullptr ? nullptr : g.lse + (size_t)bh * g.T_len, i_g,
              g.T_len, q);
  store_rows(static_cast<float*>(g.out) + (size_t)bh * g.T_len * kD, o, i_g, g.T_len, inv, q);
}

// One tile of consume_tiles over its first 8 NT keys (NT 4: the rest lie
// past the sequence): S = Q K^T with Q's fragments split in registers
// (hopper.cuh wgmma_nt32; it waits), kBias: the bias added and the
// warpgroup's next tile's (t + 2) loaded into bt, the softmax step, then P V.
template <int NT, int kBias>
__device__ __forceinline__ void tile_step(float (&o)[8][4], float m_run[2], float l_run[2],
                                          float (&bt)[8][4], unsigned char* sm, const Bars& br,
                                          const Args& g, int bh, int i_g, int t) {
  using L = Layout<float, false, kBias != 0>;
  const int s = t % L::kSK, v = t % L::kSV, lane = threadIdx.x & 31;
  const float* kh = reinterpret_cast<const float*>(sm + L::kK + s * 2 * L::TB);
  float sc[NT][4];
  zero<NT>(sc);
  hp::wgmma_nt32<NT>(sc, reinterpret_cast<const float*>(sm + L::kQu), kh, kh + kB * kD,
                     hp::warp_index() & 3, lane);
  float scl = g.scale * hp::kLog2e;   // the scores' scale into log2 units
  uint32_t keep = 0u;
  if constexpr (kBias != 0) {
    add_bias<NT>(sc, bt, scl);
    scl = 1.f;
    if (kB * (t + 2) < g.T_len) load_bias<kBias>(bt, g, bh, i_g, kB * (t + 2), lane & 3);
    if (g.drop.thresh != 0u)
      keep = reinterpret_cast<const uint32_t*>(sm + L::kKeep + s * 512)[threadIdx.x & 127];
  }
  softmax_step<NT>(sc, o, m_run, l_run, reinterpret_cast<const float*>(sm + L::kFlags) + s * kB,
                   scl, g.drop, keep, 0, lane & 3);
  hp::mbar_arrive(&br.ke[s]);
  hp::mbar_wait(&br.vl[v], (t / L::kSV) & 1);
  hp::mbar_wait(&br.vr[v], (t / L::kSV) & 1);
  pv(o, sc, reinterpret_cast<const float*>(sm + L::kVT + v * 2 * L::TB), 0);
  hp::mbar_arrive(&br.ve[v]);
}

// f32 without the position term: warpgroup c takes tiles c, c + 2, ..
// whole; the two parts are merged at the end.
template <int kBias>
__device__ __forceinline__ void consume_tiles(unsigned char* sm, const Bars& br, const Args& g,
                                              int bh, int i0) {
  using L = Layout<float, false, kBias != 0>;
  const int n_tiles = (g.T_len + kB - 1) / kB, c = hp::warp_index() >> 2;
  const int i_g = i0 + 16 * (hp::warp_index() & 3) + ((threadIdx.x & 31) >> 2);
  float o[8][4];
  zero<8>(o);
  // a warpgroup may get no tile, or only keys past the sequence (scores
  // -inf): its running maximum starts at the masked score, so it stays finite
  float m_run[2] = {kMasked2, kMasked2}, l_run[2] = {0.f, 0.f};
  [[maybe_unused]] float bt[8][4];   // kBias: the bias of the warpgroup's next tile
  if constexpr (kBias != 0)
    if (c < n_tiles) load_bias<kBias>(bt, g, bh, i_g, kB * c, threadIdx.x & 3);
  hp::mbar_wait(br.q, 0);
  for (int t = c; t < n_tiles; t += 2) {
    hp::mbar_wait(&br.kl[t % L::kSK], (t / L::kSK) & 1);
    hp::mbar_wait(&br.kr[t % L::kSK], (t / L::kSK) & 1);
    if (g.T_len - kB * t <= kB / 2)
      tile_step<4, kBias>(o, m_run, l_run, bt, sm, br, g, bh, i_g, t);
    else
      tile_step<8, kBias>(o, m_run, l_run, bt, sm, br, g, bh, i_g, t);
  }
  float l[2];
  if (merge_warpgroups(o, m_run, l, l_run, reinterpret_cast<float*>(sm + L::kK)))
    store_part(o, m_run, l, g, bh, i0);
}

// f32 with the position term: warpgroup c takes keys 32c .. 32c+31 of every
// tile and computes G^T = Win Q_v^T of window chunk t + 1 for query rows
// 32c .. 32c+31 (m64n32k8, the chunk split in registers as A): chunk t + 1
// holds tile t's G where j > a and tile t + 1's where j <= a, so each chunk
// is computed once. Both warpgroups store their parts sheared, Gs[a][j] =
// G[a][63-a+j]: tile t's before the exchange, tile t + 1's once Gs is read
// (the two parts are disjoint), and read back their scores' own places.
__device__ __forceinline__ void consume_keys(unsigned char* sm, const Bars& br, const Args& g,
                                             int bh, int i0) {
  using L = Layout<float, true>;
  const int tid = threadIdx.x, c = hp::warp_index() >> 2, w = hp::warp_index() & 3;
  const int lane = tid & 31, q = lane & 3, gq = lane >> 2, ct = tid & 127;
  const int n_tiles = (g.T_len + kB - 1) / kB;
  const float sl2 = g.scale * hp::kLog2e;
  const float* sQu = reinterpret_cast<const float*>(sm + L::kQu);
  const float* qvh = reinterpret_cast<const float*>(sm + L::kQv) + 32 * 32 * c;   // rows 32c ..
  const float* qvl = qvh + kB * kD;
  float* Gs = reinterpret_cast<float*>(sm + L::kScr);
  const float* vt = reinterpret_cast<const float*>(sm + L::kVT);

  float o[8][4];
  zero<8>(o);
  // a warpgroup's keys of a tile may all lie past the sequence (scores
  // -inf): its running maximum starts at the masked score, so it stays finite
  float m_run[2] = {kMasked2, kMasked2}, l_run[2] = {0.f, 0.f};
  // element (n, e) of a warpgroup's G^T: window row 16w + gq + 8(e/2) of
  // its chunk, query row a; its key is j - 64 in the next tile if j >= 64
  auto part = [&](const float (&gt)[4][4], bool next) {
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int a = 32 * c + 8 * n + 2 * q + (e & 1), j = 16 * w + gq + 8 * (e >> 1) + 1 + a;
        if ((j >= kB) == next) Gs[gs_at(a, j & 63)] = gt[n][e];
      }
  };
  hp::mbar_wait(br.qs, 0);
  hp::mbar_wait(&br.kl[0], 0);
  {
    float g0[4][4];   // chunk 0, landed in the scratch: tile 0's G where j <= a
    zero<4>(g0);
    hp::wgmma_nt32<4>(g0, Gs, qvh, qvl, w, lane);
    hp::named_barrier(1, 256);   // both warpgroups read chunk 0
    part(g0, true);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % L::kSK;
    const uint32_t ph = (t / L::kSK) & 1;
    hp::mbar_wait(&br.kl[s], ph);
    hp::mbar_wait(&br.kr[s], ph);
    const float* st = reinterpret_cast<const float*>(sm + L::kStage + s * L::kStageBytes);
    float sc[4][4];
    zero<4>(sc);
    scores(sc, sQu, st, 32 * c);
    float gt[4][4];
    zero<4>(gt);
    hp::wgmma_nt32<4>(gt, st + 2 * kB * kD, qvh, qvl, w, lane);   // waits for S too
    hp::fence_acc(sc);
    part(gt, false);   // where j > a: the last tile's reads of these are done
    hp::named_barrier(1, 256);   // Gs holds tile t's G
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a = 16 * w + gq + 8 * h;
        const float2 x = *reinterpret_cast<const float2*>(Gs + gs_at(a, 32 * c + 8 * n + 2 * q));
        sc[n][2 * h] += x.x;
        sc[n][2 * h + 1] += x.y;
      }
    hp::named_barrier(1, 256);   // Gs is read
    part(gt, true);              // tile t + 1's G where j <= a
    const uint32_t keep = g.drop.thresh != 0u
        ? reinterpret_cast<const uint32_t*>(sm + L::kKeep + s * 512)[ct] : 0u;
    softmax_step<4>(sc, o, m_run, l_run,
                    reinterpret_cast<const float*>(sm + L::kFlags) + s * kB + 32 * c, sl2, g.drop,
                    keep, 4 * c, q);
    hp::mbar_arrive(&br.ke[s]);   // K, its flags and keep bits, window chunk t + 1
    hp::mbar_wait(br.vr, t & 1);
    pv(o, sc, vt, 4 * c);
    hp::mbar_arrive(br.ve);
  }
  float l[2];
  if (merge_warpgroups(o, m_run, l, l_run, reinterpret_cast<float*>(sm + L::kStage)))
    store_part(o, m_run, l, g, bh, i0);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// The body of a forward kernel: attention.cu, rel_attention.cu and
// rel_attention_bias.cu wrap it in kernels of their own names, so that
// profiles tell the three apart. kBias (no position term): 0 none, 1 the
// bias read by single floats, 2 by float2 (even T).
template <typename T, bool kPos, int kBias = 0>
__device__ __forceinline__ void forward(const CUtensorMap* tm_qu, const CUtensorMap* tm_qv,
                                        const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                        const CUtensorMap* tm_p, const Args& g) {
  static_assert(!(kPos && kBias), "the bias replaces the position term");
  using L = Layout<T, kPos, kBias != 0>;
  extern __shared__ unsigned char smem_raw[];
  // the 1024-aligned base, offset from smem_raw so that the compiler keeps
  // every access derived from it in the shared space (LDS / STS, 32-bit
  // addresses) instead of generic loads and stores
  unsigned char* sm = smem_raw + ((1024u - (hp::smem_addr(smem_raw) & 1023u)) & 1023u);
  const int bh = blockIdx.y, i0 = blockIdx.x * L::kRows;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBars);
  constexpr int kSK = L::kSK, kSV = L::kSV;
  // releases: both consumer warpgroups, or the one that took the tile
  constexpr int kUsers = L::kBf16 || kPos ? 256 : 128;
  const Bars br{bars, bars + 1, bars + 2, bars + 2 + kSK, bars + 2 + 2 * kSK,
                bars + 2 + 3 * kSK, bars + 2 + 3 * kSK + kSV, bars + 2 + 3 * kSK + 2 * kSV};
  if (threadIdx.x == 0) {
    hp::mbar_init(br.q, 1);
    hp::mbar_init(br.qs, 1);
    for (int s = 0; s < kSK; ++s) {
      hp::mbar_init(&br.kl[s], 1);
      hp::mbar_init(&br.kr[s], 1);
      hp::mbar_init(&br.ke[s], kUsers);
    }
    for (int v = 0; v < kSV; ++v) {
      hp::mbar_init(&br.vl[v], 1);
      hp::mbar_init(&br.vr[v], 1);
      hp::mbar_init(&br.ve[v], kUsers);
    }
    hp::fence_mbar_init();
  }
  __syncthreads();
  if (hp::warp_index() >= 8) {   // the producer warpgroup
    if constexpr (kBias != 0) hp::setmaxnreg_dec<64>();
    if constexpr (L::kBf16)
      produce_bf16<kPos>(tm_qu, tm_qv, tm_k, tm_v, tm_p, sm, br, g, bh, i0);
    else if constexpr (kPos)
      produce_f32(tm_qu, tm_qv, tm_k, tm_v, tm_p, sm, br, g, bh, i0);
    else
      produce_keys<kBias != 0>(tm_qu, tm_k, tm_v, sm, br, g, bh, i0);
    return;
  }
  if constexpr (kBias != 0) hp::setmaxnreg_inc<216>();   // the bias tile's 32 registers
  if constexpr (L::kBf16)
    consume_rows<kPos, kBias>(sm, br, g, bh, i0);
  else if constexpr (kPos)
    consume_keys(sm, br, g, bh, i0);
  else
    consume_tiles<kBias>(sm, br, g, bh, i0);
}

// Launches `kern`, a kernel that runs forward<T, kPos, kBias> on its five
// tensor maps (q_u, q_v, k, v, p) and g. q_u, k, v, out (B, H, T, 64) and,
// with kPos, q_v (B, H, T, 64) and p (H, 2T-1, 64), all of type T,
// contiguous, 16-byte aligned; g.H, g.T_len (and with kBias g.bias) set.
template <typename T, bool kPos, int kBias = 0, class Kernel>
cudaError_t launch(Kernel kern, const void* qu, const void* qv, const void* k, const void* v,
                   const void* p, const Args& g, int B, cudaStream_t stream) {
  using L = Layout<T, kPos, kBias != 0>;
  if (!aligned16({qu, k, v, g.out}) || (kPos && !aligned16({qv, p})))
    return cudaErrorMisalignedAddress;
  const int es = (int)sizeof(T), bhn = B * g.H, T_len = g.T_len;
  CUtensorMap m[5];
  bool ok = hp::encode_rows64(&m[0], qu, es, T_len, bhn) &&
            hp::encode_rows64(&m[2], k, es, T_len, bhn) &&
            hp::encode_rows64(&m[3], v, es, T_len, bhn);
  if constexpr (kPos) {
    ok = ok && hp::encode_rows64(&m[1], qv, es, T_len, bhn) &&
         hp::encode_rows64(&m[4], p, es, 2 * T_len - 1, g.H);
  } else {
    m[1] = m[0];
    m[4] = m[0];
  }
  if (!ok) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid((T_len + L::kRows - 1) / L::kRows, bhn);
  kern<<<grid, kThreads, L::kSmem, stream>>>(m[0], m[1], m[2], m[3], m[4], g);
  return cudaGetLastError();
}

}  // namespace flash_fwd
