// Fused HiFi-GAN resblock trio, forward, for Hopper (sm_90a).
//
// Replaces: lip2speech_tpu/ops/pallas_fused_tail.py, `_fused_forward`'s
// inner `kernel` (entry `fused_resblock_trio`).
//
// Computes, for x (B, C, M) in PyTorch's conv layout, the mean over n_res
// ResBlock1 modules of the chain
//     xb = x; per dilation d: xb += conv2(lrelu(conv1_d(lrelu(xb))))
// with every conv output outside the true sequence [0, M) set to zero, the
// bias added after the cast to the activation dtype, and the sum divided by
// n_res. One thread block owns one (row tile, batch item): it loads the tile
// plus a halo of H rows on each side (H = the largest sum of a resblock's
// conv paddings, 60 at kernels 3/7/11 x dilations 1/3/5, passed in from
// branch_paddings) and runs all convs out of shared memory; only the tile is
// written back. Each conv computes only the rows the rest of its chain still
// needs: the region shrinks by the conv's padding at every step.
//
// What bounds it: the 126 C^2 multiply-adds per row of a default trio (about
// 594 GFLOP for the four stages of a batch of 4 x 240 frames) against a few
// bytes per row of traffic: operations, far above the card's ridge point, in
// both dtypes (f32 as 3xTF32: three TF32 products a multiply-add). Inside a
// block the narrow stages are bound by the rate of wgmma instructions
// instead: on the H100 an m64nNk8 TF32 product with A from registers takes
// about as long at N = 16 or 32 as at N = 64, so at C = 16 and 32 the
// products cost their count, not their width, and the epilogues and the
// copies in and out of the tile are a fifth to a third of the time.
//
// Each conv is a GEMM, rows x C_out, reduced over taps x C_in, on wgmma with
// f32 accumulation: m64nNk16 in bf16, m64nNk8 (TF32) for f32, N = C_out.
//  * Operand A, the activations, from registers. A conv reads its input at
//    a row offset that changes with every tap (k*d - pad, any dilation),
//    which breaks the 8-row core matrices of a shared-memory descriptor.
//    wgmma also takes A from registers, as the per-warp m16k16 (bf16) or
//    m16k8 (TF32) fragment of mma.sync, and ldmatrix builds that fragment at
//    any row: the tap shift is a row offset of the lanes' addresses. The
//    activation buffers are row-major ([rows][C]), their 16-byte chunks
//    XOR-ed by the row (`swz`) so that an ldmatrix's eight rows hit distinct
//    banks at any shift. bf16 applies conv1's lrelu on the fragments
//    (max(v, bf16(0.1 v))); f32 applies it and splits v into hi (v with the
//    13 low bits cleared, the TF32 value the tensor core reads from v) and
//    lo = v - hi. A step's fragments are loaded during the step before: the
//    lrelu and split of one step and the loads of the next overlap the
//    products in flight.
//  * Operand B, the weights, from shared memory by descriptor: they sit at
//    fixed, aligned places. The wrapper (fused_tail.py: pack_weights) packs
//    each conv K-major, as panels of rows of kRB bytes of k = tap * C_in +
//    c_in (zero past K C_in), one row an output, each row's 16-byte chunks
//    XOR-ed as the 128-byte (64-byte for f32 at C = 128, whose 64-byte rows
//    keep a 16 KB chunk at N = 128) swizzle does: a swizzled wgmma operand,
//    copied as it is. TF32 wgmma has no transpose, so B is K-major in both
//    types; a k-step advances the descriptor by 32 bytes inside the row. The
//    wrapper also splits f32 weights into hi = tf32(w) and lo = w - hi, and a
//    k-step is the three products lo_a hi_b, hi_a lo_b, hi_a hi_b: at C = 16
//    a panel's rows are the hi rows, then the lo rows, and the step is two
//    instructions, lo_a against the hi rows (n16, an accumulator of its
//    own) and hi_a against both (n32); above, lo comes as a panel of its own
//    behind hi, and the step is three instructions. Splitting the weights in
//    shared memory instead (by the producer, once a block) left the
//    consumers waiting on the ring.
//  * The weight ring. The convs' panels form one stream of 16 KB chunks
//    (kPPS panels, never across a conv) through kStages slots on full /
//    empty mbarriers. A producer thread issues each chunk as TMA bulk copies
//    as soon as its slot is empty, across conv, round and resblock
//    boundaries, so the next conv's weights arrive during this conv's
//    epilogue.
//  * Warp specialisation: 384 threads, two consumer warpgroups and a
//    producer warpgroup, which gives up registers (setmaxnreg: without it
//    ptxas lacks the registers to keep the f32 products at C = 16 and 64 in
//    flight and serializes them, 1.4x slower). A conv's output region is cut
//    into m64 row tiles; a round is the kMT tiles each consumer warpgroup
//    holds in its accumulators at once (the tiles alternate between the
//    warpgroups), and a longer region takes more rounds, each streaming the
//    conv's weights again. f32 at C = 128 holds one tile (64 accumulators a
//    thread), f32 at C = 16 two: with more, ptxas lacks the registers to
//    keep a group in flight and serializes every wgmma. A k-step issues its
//    tiles' products as one wgmma group on one of two register sets and
//    waits for the group before it. The tile count of a round is a
//    compile-time value (`with_count`): no wgmma sits in a branch. Each
//    chunk ends by waiting for all its products and releasing its slot, so
//    no product is in flight across the next chunk's barrier wait: ptxas
//    serializes every wgmma of a kernel that waits on an mbarrier with one
//    in flight, and every wgmma of a kernel in which a register an earlier
//    product still reads is written (C7513: so hi is not the loaded
//    register). ptxas still serializes the bf16 instantiations (C7513); what
//    triggers it there is open. Between convs a named barrier among the
//    consumers: the next conv reads rows that the other warpgroup wrote.
//  * Epilogue straight from the accumulators (their m64nN layout is per
//    warp the m16n8 layout of mma.sync), without branches: each lane owns
//    two adjacent columns of two rows; rows past the region are read at the
//    region's last row and their stores predicated off, rows outside [0, M)
//    are zeroed; a tile's loads of the residual come before its stores. The
//    bias is read once a conv (the L1 the shared memory leaves is too small
//    to keep it). bf16 rounds the pair to bf16 and adds the bias in one
//    bf16x2 add (rounding once, as the f32 add and cast do); conv1 stores
//    lrelu(y) into the other buffer, conv2 adds y into the residual. The
//    cross-resblock sum and the division by n_res stay in the output tile.
//  * Shared memory: the ring, the residual buffer xb of tile + 2H rows and
//    the conv1 output buffer xt, which holds only the rows a conv1 writes
//    (xt_off fewer on each side). Every pointer into it is offset from the
//    dynamic shared array, so that the accesses compile to LDS / STS. The
//    wrapper (fused_tail.py: tile_rows) picks the tile from these sizes.
//    The tile comes in and goes out a 16-byte chunk of a row at a time
//    (`Copy`), 32 global accesses in flight a lane.
//  * A last m64 tile reads up to 63 rows past its input region: those
//    lanes' rows are clamped to the buffer, and the products they feed are
//    rows past the region, never stored.

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace hp = hopper;

constexpr int kMaxRes = 4;
constexpr int kMaxDil = 4;
constexpr int kMaxConvs = 2 * kMaxRes * kMaxDil;
constexpr float kSlope = 0.1f;
constexpr int kSlotBytes = 16384;             // one slot of the weight ring
constexpr int kBarBytes = 256;                // the ring's mbarriers
constexpr int kConsumers = 2;                 // consumer warpgroups
constexpr int kCThreads = 128 * kConsumers;
constexpr int kThreads = kCThreads + 128;     // and the producer warpgroup
constexpr int kAlign = 1024;                  // room to align the base to 1024 bytes

// Per activation type and width: the ring's chunks and the warpgroups' tiles.
template <typename T, int C>
struct Cfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kE = 16 / sizeof(T);            // elements of a 16-byte chunk
  static constexpr int kRB = kF32 && C == 128 ? 64 : 128;   // bytes of a panel row (its swizzle)
  static constexpr int kPW = kRB / sizeof(T);          // k of a panel row
  static constexpr int kKS = kF32 ? 8 : 16;            // k of one wgmma
  static constexpr int kSPP = kPW / kKS;               // k-steps a panel
  // f32 at C = 16: a panel's rows are the outputs' hi parts, then their lo
  // parts (kNS = 2C), so a k-step takes two products of width 2C; else the
  // lo parts come in a panel of their own (kParts), a k-step three products
  static constexpr bool kStack = kF32 && C == 16;
  static constexpr int kNS = kStack ? 2 * C : C;       // rows of a panel: a wgmma's N
  static constexpr int kParts = kF32 && !kStack ? 2 : 1;
  static constexpr int kPanel = kNS * kRB;             // bytes of a panel
  static constexpr int kPPS = kSlotBytes / (kParts * kPanel);   // panels a chunk
  // m64 tiles a warpgroup holds: f32 at C = 128 one, as more leave ptxas too
  // few registers to keep a step's products in flight
  static constexpr int kMT = kF32 && C == 128 ? 1 : kF32 || C == 128 ? 2 : 4;
  static constexpr int kStages = kF32 ? 3 : 4;         // ring slots
  static constexpr int kRoundTiles = kConsumers * kMT;
};

// descriptor of a K-major weight panel at p (Cfg::kRB-byte rows)
template <int RB>
__device__ __forceinline__ uint64_t panel_desc(const unsigned char* p) {
  return RB == 64 ? hp::desc_sw64(p) : hp::desc_sw128(p);
}

struct TrioGeom {
  int n_res, n_dil, halo;
  int k[kMaxRes];
  int dil[kMaxRes * kMaxDil];
  int pad1[kMaxRes * kMaxDil];
  int pad2[kMaxRes * kMaxDil];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// value rounded to the activation dtype, as a float
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}

// leaky ReLU in the activation dtype (the negative branch is rounded to T)
template <typename T> __device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : round_t<T>(kSlope * v);
}

// lrelu on both bf16 halves of an A-fragment register, the same values as
// the epilogue's lrelu: max(v, bf16(0.1 v)) is v for v >= 0 and the rounded
// negative branch below 0 (rounding is monotone and v is a bf16 value)
__device__ __forceinline__ uint32_t lrelu2(uint32_t r) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&r);
  const float2 f = __bfloat1622float2(v);
  const __nv_bfloat162 m = __hmax2(v, __floats2bfloat162_rn(kSlope * f.x, kSlope * f.y));
  return *reinterpret_cast<const uint32_t*>(&m);
}

// The epilogue's shared-memory accesses at a shared address: the loads, and
// stores predicated on p.
__device__ __forceinline__ float2 lds_f2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ uint32_t lds_u32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ void sts_f2_if(bool p, uint32_t a, float2 v) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %0, 0;\n@q st.shared.v2.f32 [%1], {%2, %3};\n}\n" ::"r"(
          (int)p),
      "r"(a), "f"(v.x), "f"(v.y)
      : "memory");
}
__device__ __forceinline__ void sts_u32_if(bool p, uint32_t a, uint32_t v) {
  asm volatile("{\n.reg .pred q;\nsetp.ne.b32 q, %0, 0;\n@q st.shared.b32 [%1], %2;\n}\n" ::"r"(
                   (int)p),
               "r"(a), "r"(v)
               : "memory");
}

// element offset of (row, col) in a swizzled [rows][C] activation buffer:
// 16-byte chunk c of a row sits at c ^ f(row), f chosen so that any 8
// consecutive rows at one chunk cover the 8 bank groups of a 128-byte line
template <typename T, int C>
__device__ __forceinline__ int swz(int row, int col) {
  constexpr unsigned E = 16 / sizeof(T), kCPR = C / E;
  const unsigned r = row, k = col;   // both >= 0: unsigned divisions are shifts
  const unsigned f = kCPR >= 8 ? (r & 7) : kCPR == 4 ? ((r >> 1) & 3) : ((r >> 2) & 1);
  return (int)(r * C + (((k / E) ^ f) * E) + (k % E));
}

// ---------------------------------------------------------------------------
// The conv table and the weight stream
// ---------------------------------------------------------------------------

// Every conv of the trio in launch order: taps, dilation, padding, its output
// rows [olo, ohi) in buffer coordinates (block-independent), its rounds, its
// weight panels and the first of them in the stream. xt_off: the first row any
// conv1 writes (xt holds rows xt_off .. BR - xt_off). n_chunks: the stream's
// length.
struct ConvTab {
  int n_res, n_dil, n_convs, xt_off, n_chunks;
  int k[kMaxConvs], d[kMaxConvs], pad[kMaxConvs], olo[kMaxConvs], ohi[kMaxConvs];
  int rounds[kMaxConvs], panels[kMaxConvs], wpanel[kMaxConvs];
};

ConvTab conv_table(const TrioGeom& g, int tile, int C, int per_round, int pw, int pps) {
  ConvTab tb{};
  tb.n_res = g.n_res;
  tb.n_dil = g.n_dil;
  const int H = g.halo;
  int j = 0, wpanel = 0;
  tb.xt_off = H;
  auto add = [&](int k, int d, int pad, int olo, int ohi) {
    tb.k[j] = k;
    tb.d[j] = d;
    tb.pad[j] = pad;
    tb.olo[j] = olo;
    tb.ohi[j] = ohi;
    tb.rounds[j] = ((ohi - olo + 63) / 64 + per_round - 1) / per_round;
    tb.panels[j] = (k * C + pw - 1) / pw;
    tb.wpanel[j] = wpanel;
    wpanel += tb.panels[j];
    tb.n_chunks += tb.rounds[j] * ((tb.panels[j] + pps - 1) / pps);
    ++j;
  };
  for (int r = 0; r < g.n_res; ++r) {
    const int K = g.k[r];
    int hr = 0;
    for (int i = 0; i < g.n_dil; ++i) hr += g.pad1[r * kMaxDil + i] + g.pad2[r * kMaxDil + i];
    int lo = H - hr, hi = H + tile + hr;
    for (int i = 0; i < g.n_dil; ++i) {
      const int p1 = g.pad1[r * kMaxDil + i], p2 = g.pad2[r * kMaxDil + i];
      tb.xt_off = tb.xt_off < lo + p1 ? tb.xt_off : lo + p1;
      add(K, g.dil[r * kMaxDil + i], p1, lo + p1, hi - p1);
      add(K, 1, p2, lo + p1 + p2, hi - p1 - p2);
      lo += p1 + p2;
      hi -= p1 + p2;
    }
  }
  tb.n_convs = j;
  return tb;
}

// The position of a chunk in the weight stream: conv j, round r, chunk c of
// the conv's panels.
struct Cursor {
  int j, r, c;
};

template <typename T, int C>
__device__ __forceinline__ int n_chunks(const ConvTab& tb, int j) {
  return (tb.panels[j] + Cfg<T, C>::kPPS - 1) / Cfg<T, C>::kPPS;
}

template <typename T, int C>
__device__ __forceinline__ void advance(Cursor& cu, const ConvTab& tb) {
  if (++cu.c < n_chunks<T, C>(tb, cu.j)) return;
  cu.c = 0;
  if (++cu.r < tb.rounds[cu.j]) return;
  cu.r = 0;
  ++cu.j;
}

// panels of the cursor's chunk
template <typename T, int C>
__device__ __forceinline__ int chunk_panels(const Cursor& cu, const ConvTab& tb) {
  const int left = tb.panels[cu.j] - cu.c * Cfg<T, C>::kPPS;
  return left < Cfg<T, C>::kPPS ? left : Cfg<T, C>::kPPS;
}

// ---------------------------------------------------------------------------
// The block's shared memory, its tile's load and fold
// ---------------------------------------------------------------------------

// Bytes of dynamic shared memory a block takes: the ring, xb (tile + 2 halo
// rows), xt (2 trim rows fewer) and the barriers, plus the alignment slack.
template <typename T, int C>
size_t smem_bytes(int tile, int halo, int trim) {
  return (size_t)kAlign + (size_t)Cfg<T, C>::kStages * kSlotBytes + kBarBytes +
         (size_t)(2 * (tile + 2 * halo) - 2 * trim) * C * sizeof(T);
}

__device__ __forceinline__ void consumer_sync() { hp::named_barrier(1, kCThreads); }

// The copies between global memory and the activation buffer. A consumer
// lane takes rows of one or more 16-byte chunks (kE channels) of the
// buffer: each chunk's kE channels come from, or go to, global memory as
// kE loads or stores of 32 consecutive rows a warp, and the chunk to or from
// shared memory as one 16-byte access. Warp w takes chunk w % kCPR (and w +
// 8 i, ..: kCW chunks), and of each pass's rows the group w / kCPR (kRG
// groups of 32) in kRW batches: 32 values in flight a lane.
template <typename T, int C>
struct Copy {
  static constexpr int kE = 16 / sizeof(T);
  static constexpr int kCPR = C / kE;                        // chunks a row
  static constexpr int kWarps = kCThreads / 32;
  static constexpr int kCW = kCPR > kWarps ? kCPR / kWarps : 1;
  static constexpr int kRG = kCPR < kWarps ? kWarps / kCPR : 1;
  static constexpr int kRW = kCW * kE >= 32 ? 1 : 32 / (kCW * kE);
  static constexpr int kPass = 32 * kRG * kRW;               // rows a pass
};

template <typename T>
__device__ __forceinline__ uint4 pack16(const T (&v)[16 / sizeof(T)]) {
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (sizeof(T) == 4) {
      w[e] = __float_as_uint(to_f(v[e]));
    } else {
      const __nv_bfloat162 h = __halves2bfloat162(v[2 * e], v[2 * e + 1]);
      w[e] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__device__ __forceinline__ void unpack16(float (&v)[16 / sizeof(T)], uint4 q) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (sizeof(T) == 4) {
      v[e] = __uint_as_float(w[e]);
    } else {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  }
}

// x rows [lo, hi) of a batch item (xg: (C, M)) into the activation buffer
// xb; rows outside [0, M) are zero.
template <typename T, int C>
__device__ __forceinline__ void load_rows(const T* __restrict__ xg, T* xb, int lo, int hi,
                                          int row0, int M) {
  using K = Copy<T, C>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = warp % (K::kCPR < K::kWarps ? K::kCPR : K::kWarps);
  const int rg = K::kRG > 1 ? warp / K::kCPR : 0;
  for (int l0 = lo + lane + 32 * rg; l0 < hi; l0 += K::kPass) {
    T v[K::kCW][K::kRW][K::kE];
#pragma unroll
    for (int i = 0; i < K::kCW; ++i)
#pragma unroll
      for (int u = 0; u < K::kRW; ++u) {
        const int l = l0 + 32 * K::kRG * u, gr = row0 + l;
        const bool ok = l < hi && gr >= 0 && gr < M;
#pragma unroll
        for (int e = 0; e < K::kE; ++e)
          v[i][u][e] = ok ? xg[(size_t)((k0 + K::kWarps * i) * K::kE + e) * M + gr]
                          : from_f<T>(0.f);
      }
#pragma unroll
    for (int i = 0; i < K::kCW; ++i)
#pragma unroll
      for (int u = 0; u < K::kRW; ++u) {
        const int l = l0 + 32 * K::kRG * u;
        if (l < hi)
          *reinterpret_cast<uint4*>(xb + swz<T, C>(l, (k0 + K::kWarps * i) * K::kE)) =
              pack16<T>(v[i][u]);
      }
  }
}

// Rows [halo, halo + tile) of xb hold resblock r's output: fold them into
// the output tile (og: (C, M), rows t0..), rounding the running sum to T
// and dividing by n_res after the last. Each element is read and written
// by the same thread.
template <typename T, int C>
__device__ __forceinline__ void fold_rows(const T* xb, T* __restrict__ og, int r, int n_res,
                                          int t0, int tile, int halo, int M) {
  using K = Copy<T, C>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = warp % (K::kCPR < K::kWarps ? K::kCPR : K::kWarps);
  const int rg = K::kRG > 1 ? warp / K::kCPR : 0;
  const int end = tile < M - t0 ? tile : M - t0;   // the tile's rows inside the sequence
  for (int l0 = lane + 32 * rg; l0 < end; l0 += K::kPass) {
    float prev[K::kCW][K::kRW][K::kE];
#pragma unroll
    for (int i = 0; i < K::kCW; ++i)
#pragma unroll
      for (int u = 0; u < K::kRW; ++u) {
        const int l = l0 + 32 * K::kRG * u;
#pragma unroll
        for (int e = 0; e < K::kE; ++e)
          prev[i][u][e] = (r > 0 && l < end)
              ? to_f(og[(size_t)((k0 + K::kWarps * i) * K::kE + e) * M + t0 + l]) : 0.f;
      }
#pragma unroll
    for (int i = 0; i < K::kCW; ++i)
#pragma unroll
      for (int u = 0; u < K::kRW; ++u) {
        const int l = l0 + 32 * K::kRG * u;
        if (l >= end) continue;
        float v[K::kE];
        unpack16<T>(v, *reinterpret_cast<const uint4*>(
                           xb + swz<T, C>(halo + l, (k0 + K::kWarps * i) * K::kE)));
#pragma unroll
        for (int e = 0; e < K::kE; ++e) {
          float s = r == 0 ? v[e] : round_t<T>(prev[i][u][e] + v[e]);
          if (r == n_res - 1) s = s / (float)n_res;
          og[(size_t)((k0 + K::kWarps * i) * K::kE + e) * M + t0 + l] = from_f<T>(s);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// The producer warpgroup
// ---------------------------------------------------------------------------

// Thread 0 issues every chunk of the stream as bulk copies into its slot
// once the consumers released the slot (full[s]: the copies landed). f32:
// w holds the stream twice, as the wrapper split it, hi then lo; a chunk's
// lo part lands behind its hi part.
template <typename T, int C>
__device__ __forceinline__ void produce(unsigned char* ring, const T* __restrict__ w,
                                        const ConvTab& tb, uint64_t* full, uint64_t* empty) {
  using Q = Cfg<T, C>;
  if (threadIdx.x != kCThreads) return;
  const unsigned char* wb = reinterpret_cast<const unsigned char*>(w);
  const size_t lo = (size_t)(tb.wpanel[tb.n_convs - 1] + tb.panels[tb.n_convs - 1]) * Q::kPanel;
  Cursor cu{0, 0, 0};
  for (int i = 0; i < tb.n_chunks; ++i) {
    const int s = i % Q::kStages;
    if (i >= Q::kStages) hp::mbar_wait(&empty[s], ((i / Q::kStages) - 1) & 1);
    const uint32_t bytes = chunk_panels<T, C>(cu, tb) * Q::kPanel;
    const size_t at = ((size_t)tb.wpanel[cu.j] + cu.c * Q::kPPS) * Q::kPanel;
    unsigned char* slot = ring + s * kSlotBytes;
    hp::mbar_expect_tx(&full[s], Q::kParts * bytes);
    hp::bulk_load(slot, wb + at, bytes, &full[s]);
    if constexpr (Q::kParts == 2)
      hp::bulk_load(slot + Q::kPPS * Q::kPanel, wb + lo + at, bytes, &full[s]);
    advance<T, C>(cu, tb);
  }
}

// ---------------------------------------------------------------------------
// The consumer warpgroups
// ---------------------------------------------------------------------------

// An A fragment as the products take it, from its loaded registers: conv1
// (FIRST) applies lrelu, to both bf16 halves of each register or to the f32
// value; f32 then splits v into hi = v with the 13 low bits cleared (the
// TF32 value the tensor core reads from v) and lo = v - hi. hi is a value
// of its own, not the loaded register: a register that a load writes while
// an earlier product still reads it makes ptxas serialize every wgmma.
template <bool FIRST>
__device__ __forceinline__ void prep_a(uint32_t (&a)[4], const uint32_t (&raw)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) a[e] = FIRST ? lrelu2(raw[e]) : raw[e];
}
template <bool FIRST>
__device__ __forceinline__ void prep_a(uint32_t (&ah)[4], uint32_t (&al)[4],
                                       const uint32_t (&raw)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float v = __uint_as_float(raw[e]);
    if (FIRST) v = fmaxf(v, kSlope * v);
    ah[e] = __float_as_uint(v) & 0xffffe000u;
    al[e] = __float_as_uint(v - __uint_as_float(ah[e]));
  }
}

// f(std::integral_constant<int, n>) for n in 1 .. N
template <int N, class F>
__device__ __forceinline__ void with_count(int n, F&& f) {
  if constexpr (N > 1) {
    if (n == N) {
      f(std::integral_constant<int, N>{});
      return;
    }
    with_count<N - 1>(n, f);
  } else {
    f(std::integral_constant<int, 1>{});
  }
}

// dst rows [olo, ohi) of conv j <- conv(in); FIRST: conv1 (lrelu on its
// input, lrelu(y) stored), else conv2 (y added into dst). in_last: the last
// row of `in`. ring: the chunks the thread consumed so far.
template <typename T, int C, bool FIRST>
__device__ __forceinline__ void conv(const T* in, int in_last, T* dst, const T* __restrict__ bias,
                                     const ConvTab& tb, int j, unsigned char* ring_s,
                                     uint64_t* full, uint64_t* empty, int& ring, int row0, int M) {
  using Q = Cfg<T, C>;
  constexpr int NT = Q::kNS / 8;
  constexpr int kChunkSteps = Q::kPPS * Q::kSPP;
  static_assert(kChunkSteps % 2 == 0, "a full chunk ends on register set 1");
  const int wg = hp::warp_index() >> 2, w = hp::warp_index() & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int d = tb.d[j], kc = tb.k[j] * C;
  const int olo = tb.olo[j], ohi = tb.ohi[j];
  const int nch = n_chunks<T, C>(tb, j);
  // the bias of the lane's output columns 8 n + 2 q, read once a conv (the
  // L1 that the shared memory leaves is too small to keep it across rounds)
  using B2 = std::conditional_t<Q::kF32, float2, __nv_bfloat162>;
  B2 bv[C / 8];
#pragma unroll
  for (int n = 0; n < C / 8; ++n)
    bv[n] = __ldg(reinterpret_cast<const B2*>(bias + j * C + 8 * n + 2 * (threadIdx.x & 3)));
  const unsigned a_col = (lane >> 4) * Q::kE;
  const uint32_t in_s = hp::smem_addr(in), dst_s = hp::smem_addr(dst);

  for (int rd = 0; rd < tb.rounds[j]; ++rd) {
    // the warpgroup's tiles: rd kRoundTiles + wg + kConsumers t, at row olo + 64 tile
    const int first = olo + 64 * (rd * Q::kRoundTiles + wg);
    int nt = 0;   // of them in the region, as a value the compiler knows to be uniform
#pragma unroll
    for (int t = 0; t < Q::kMT; ++t) nt += first + 64 * kConsumers * t < ohi ? 1 : 0;
    nt = __shfl_sync(0xffffffffu, nt, 0);
    if (nt == 0) {   // nothing to compute: release the round's chunks
      for (int c = 0; c < nch; ++c, ++ring) {
        hp::mbar_wait(&full[ring % Q::kStages], (ring / Q::kStages) & 1);
        hp::mbar_arrive(&empty[ring % Q::kStages]);
      }
      continue;
    }
    // the lane's A row at tap 0 (the warp's 16 rows from 16 w)
    const int a_row = first + 16 * w + (lane & 15) - tb.pad[j];
    float acc[Q::kMT][NT][4];
    float acc_l[Q::kMT][Q::kStack ? 2 : 1][4];   // stacked panels: lo_a hi_b
#pragma unroll
    for (int t = 0; t < Q::kMT; ++t) {
      mma::zero<NT>(acc[t]);
      mma::zero<Q::kStack ? 2 : 1>(acc_l[t]);
    }

    // The round's k-steps for the warpgroup's first NTT tiles (a compile-time
    // count: no wgmma sits in a branch).
    with_count<Q::kMT>(nt, [&](auto NTT_) {
      constexpr int NTT = decltype(NTT_)::value;
      // A fragments as loaded (a step ahead), and as multiplied:
      // two sets, bf16 a; f32 hi, lo
      uint32_t raw[2][NTT][4], ah[2][NTT][4], al[2][Q::kF32 ? NTT : 1][4];
      // ldmatrix of the raw A fragments of conv step s (k = s kKS): tap
      // s kKS / C at row shift tap d, channels (s kKS) % C; rows clamped to
      // the buffer
      auto load = [&](uint32_t (&r)[NTT][4], int s) {
        const unsigned kr = (unsigned)s * Q::kKS, tap = kr / C, ci = kr % C;
        const int row = a_row + (int)tap * d;
#pragma unroll
        for (int t = 0; t < NTT; ++t)
          mma::ldsm_x4(r[t], in_s + (uint32_t)sizeof(T) * swz<T, C>(
                                        min(row + 64 * kConsumers * t, in_last), ci + a_col));
      };
      load(raw[0], 0);

      for (int c = 0; c < nch; ++c) {
        const int k_end = (c + 1) * Q::kPPS * Q::kPW < kc ? (c + 1) * Q::kPPS * Q::kPW : kc;
        const int n_steps = (k_end - c * Q::kPPS * Q::kPW) / Q::kKS;
        const int s = ring % Q::kStages;
        hp::mbar_wait(&full[s], (ring / Q::kStages) & 1);
        ++ring;
        const unsigned char* wt = ring_s + s * kSlotBytes;
        // k-step st of the chunk (conv step c kChunkSteps + st) on register set B
        auto step = [&](auto B_, int st) {
          constexpr int B = decltype(B_)::value;
          const int gs = c * kChunkSteps + st;
          load(raw[B ^ 1], gs + 1);   // the next step's loads, in flight over this one
#pragma unroll
          for (int t = 0; t < NTT; ++t) {
            if constexpr (Q::kF32)
              prep_a<FIRST>(ah[B][t], al[B][t], raw[B][t]);
            else
              prep_a<FIRST>(ah[B][t], raw[B][t]);
          }
          const unsigned char* bp = wt + (st / Q::kSPP) * Q::kPanel + (st % Q::kSPP) * 32;
          const uint64_t bh = panel_desc<Q::kRB>(bp);
          const uint64_t bl = Q::kParts == 2 ? panel_desc<Q::kRB>(bp + Q::kPPS * Q::kPanel) : 0;
          // every A register of the step written, the accumulators settled,
          // before the arrive: else the compiler moves a tile's lrelu or split
          // past it and has to wait for each product before the next one
#pragma unroll
          for (int t = 0; t < NTT; ++t) {
            hp::fence_regs(ah[B][t]);
            if constexpr (Q::kF32) hp::fence_regs(al[B][t]);
            hp::fence_acc(acc[t]);
            if constexpr (Q::kStack) hp::fence_acc(acc_l[t]);
          }
          hp::wgmma_fence();
          if constexpr (Q::kStack) {
            // lo_a hi_b (n16: the stacked panel's first C rows), then hi_a
            // against (hi_b; lo_b) (n32)
#pragma unroll
            for (int t = 0; t < NTT; ++t) hp::wgmma_tf32_rs(acc_l[t], al[B][t], bh);
#pragma unroll
            for (int t = 0; t < NTT; ++t) hp::wgmma_tf32_rs(acc[t], ah[B][t], bh);
          } else if constexpr (Q::kF32) {
            // the small terms first, lo_a hi_b and hi_a lo_b, then hi_a hi_b
#pragma unroll
            for (int t = 0; t < NTT; ++t) hp::wgmma_tf32_rs(acc[t], al[B][t], bh);
#pragma unroll
            for (int t = 0; t < NTT; ++t) hp::wgmma_tf32_rs(acc[t], ah[B][t], bl);
#pragma unroll
            for (int t = 0; t < NTT; ++t) hp::wgmma_tf32_rs(acc[t], ah[B][t], bh);
          } else {
#pragma unroll
            for (int t = 0; t < NTT; ++t) hp::wgmma_bf16_rs<0>(acc[t], ah[B][t], bh);
          }
          hp::wgmma_commit();
          hp::wgmma_wait<1>();   // the step before this one is done: its registers are free
#pragma unroll
          for (int t = 0; t < NTT; ++t) {
            hp::fence_acc(acc[t]);
            if constexpr (Q::kStack) hp::fence_acc(acc_l[t]);
            hp::fence_regs(ah[B ^ 1][t]);
            if constexpr (Q::kF32) hp::fence_regs(al[B ^ 1][t]);
          }
        };
        // an odd count only in a conv's last chunk, which ends the round:
        // each chunk starts on set 0
        for (int st = 0; st < n_steps; st += 2) {
          step(std::integral_constant<int, 0>{}, st);
          if (st + 1 < n_steps) step(std::integral_constant<int, 1>{}, st + 1);
        }
        hp::wgmma_wait<0>();
#pragma unroll
        for (int t = 0; t < NTT; ++t) {
          hp::fence_acc(acc[t]);
          if constexpr (Q::kStack) hp::fence_acc(acc_l[t]);
          hp::fence_regs(ah[0][t]);
          hp::fence_regs(ah[1][t]);
          if constexpr (Q::kF32) {
            hp::fence_regs(al[0][t]);
            hp::fence_regs(al[1][t]);
          }
        }
        hp::mbar_arrive(&empty[s]);   // every product of the chunk has completed
      }

      // The epilogue, without branches: a lane's rows past the region are
      // read at the region's last row and not stored (predicated stores). A
      // batch of kHB of a tile's two row halves loads all its old values
      // before it stores.
      constexpr int kHB = C <= 32 ? 2 : 1;
      using V = std::conditional_t<Q::kF32, float2, uint32_t>;
#pragma unroll
      for (int t = 0; t < NTT; ++t) {
#pragma unroll
        for (int h0 = 0; h0 < 2; h0 += kHB) {
          uint32_t pa[kHB][C / 8];
          bool keep[kHB], in_seq[kHB];
          V old[kHB][C / 8];
#pragma unroll
          for (int i = 0; i < kHB; ++i) {
            const int row = first + 64 * kConsumers * t + 16 * w + g + 8 * (h0 + i);
            keep[i] = row < ohi;
            in_seq[i] = row0 + row >= 0 && row0 + row < M;
#pragma unroll
            for (int n = 0; n < C / 8; ++n) {
              pa[i][n] = dst_s + (uint32_t)sizeof(T) * swz<T, C>(keep[i] ? row : ohi - 1,
                                                                  8 * n + 2 * q);
              if (!FIRST) {
                if constexpr (Q::kF32)
                  old[i][n] = lds_f2(pa[i][n]);
                else
                  old[i][n] = lds_u32(pa[i][n]);
              }
            }
          }
#pragma unroll
          for (int i = 0; i < kHB; ++i) {
            const int hh = h0 + i;
#pragma unroll
            for (int n = 0; n < C / 8; ++n) {
              float a0 = acc[t][n][2 * hh], a1 = acc[t][n][2 * hh + 1];
              if constexpr (Q::kStack) {   // hi_a hi_b, hi_a lo_b, lo_a hi_b
                a0 += acc[t][n + C / 8][2 * hh] + acc_l[t][n][2 * hh];
                a1 += acc[t][n + C / 8][2 * hh + 1] + acc_l[t][n][2 * hh + 1];
              }
              if constexpr (Q::kF32) {
                const float y0 = in_seq[i] ? a0 + bv[n].x : 0.f;
                const float y1 = in_seq[i] ? a1 + bv[n].y : 0.f;
                const float2 v = FIRST ? make_float2(fmaxf(y0, kSlope * y0), fmaxf(y1, kSlope * y1))
                                       : make_float2(old[i][n].x + y0, old[i][n].y + y1);
                sts_f2_if(keep[i], pa[i][n], v);
              } else {
                // round(round(acc) + bias) in bf16: the pair rounded, then one
                // bf16x2 add, which rounds once as the f32 add and cast would
                const uint32_t yr = mma::pack_bf16(a0, a1);
                const __nv_bfloat162 y =
                    __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&yr), bv[n]);
                uint32_t v = in_seq[i] ? *reinterpret_cast<const uint32_t*>(&y) : 0u;
                if (FIRST) {
                  v = lrelu2(v);
                } else {
                  const __nv_bfloat162 s2 =
                      __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&old[i][n]),
                              *reinterpret_cast<const __nv_bfloat162*>(&v));
                  v = *reinterpret_cast<const uint32_t*>(&s2);
                }
                sts_u32_if(keep[i], pa[i][n], v);
              }
            }
          }
        }
      }
    });
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 1)
trio_wgmma(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
           T* __restrict__ out, int M, int tile, int halo, const __grid_constant__ ConvTab tb) {
  using Q = Cfg<T, C>;
  extern __shared__ unsigned char smem_raw[];
  // the 1024-aligned base, offset from smem_raw so that the compiler keeps
  // every access derived from it in the shared space (LDS / STS)
  unsigned char* sm = smem_raw + ((1024u - (hp::smem_addr(smem_raw) & 1023u)) & 1023u);
  const int BR = tile + 2 * halo;
  unsigned char* ring_s = sm;
  T* xb = reinterpret_cast<T*>(sm + Q::kStages * kSlotBytes);   // running residual
  T* xt = xb + (BR - tb.xt_off) * C;                             // conv1 output, rows xt_off ..
  uint64_t* bars = reinterpret_cast<uint64_t*>(xb + (2 * BR - 2 * tb.xt_off) * C);
  uint64_t* full = bars;
  uint64_t* empty = bars + Q::kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Q::kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], kCThreads);
    }
    hp::fence_mbar_init();
  }
  __syncthreads();
  if (hp::warp_index() >= 4 * kConsumers) {   // the producer warpgroup
    hp::setmaxnreg_dec<40>();
    produce<T, C>(ring_s, w, tb, full, empty);
    return;
  }
  hp::setmaxnreg_inc<232>();
  const int t0 = blockIdx.x * tile;
  const int row0 = t0 - halo;
  const T* xg = x + (size_t)blockIdx.y * C * M;
  T* og = out + (size_t)blockIdx.y * C * M;
  int ring = 0;
  for (int r = 0; r < tb.n_res; ++r) {
    const int j0 = 2 * r * tb.n_dil;
    load_rows<T, C>(xg, xb, tb.olo[j0] - tb.pad[j0], tb.ohi[j0] + tb.pad[j0], row0, M);
    consumer_sync();
    for (int i = 0; i < tb.n_dil; ++i) {
      conv<T, C, true>(xb, BR - 1, xt, bias, tb, j0 + 2 * i, ring_s, full, empty, ring, row0, M);
      consumer_sync();
      conv<T, C, false>(xt, BR - 1 - tb.xt_off, xb, bias, tb, j0 + 2 * i + 1, ring_s, full,
                        empty, ring, row0, M);
      consumer_sync();
    }
    fold_rows<T, C>(xb, og, r, tb.n_res, t0, tile, halo, M);
    consumer_sync();   // before the next resblock's load overwrites xb
  }
}

template <typename T, int C>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out, int B, int M,
                   int tile, const TrioGeom& g, cudaStream_t stream) {
  using Q = Cfg<T, C>;
  if (!mma::aligned16({w})) return cudaErrorMisalignedAddress;
  const ConvTab tb = conv_table(g, tile, C, Q::kRoundTiles, Q::kPW, Q::kPPS);
  const size_t smem = smem_bytes<T, C>(tile, g.halo, tb.xt_off);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t e =
      cudaFuncSetAttribute(trio_wgmma<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((M + tile - 1) / tile, B);
  trio_wgmma<T, C><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(out), M, tile, g.halo, tb);
  return cudaGetLastError();
}

cudaError_t dispatch_c(int dtype, const void* x, const void* w, const void* bias, void* out,
                       int B, int C, int M, int tile, const TrioGeom& g, cudaStream_t s) {
#define L2S_TRIO_CASE(CC)                                                    \
  case CC:                                                                    \
    return dtype == 0 ? launch<float, CC>(x, w, bias, out, B, M, tile, g, s) \
                      : launch<bf16, CC>(x, w, bias, out, B, M, tile, g, s);
  switch (C) {
    L2S_TRIO_CASE(16)
    L2S_TRIO_CASE(32)
    L2S_TRIO_CASE(64)
    L2S_TRIO_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef L2S_TRIO_CASE
}

}  // namespace

// x, out (B, C, M); w: every conv's weights in x's dtype as
// fused_tail.py's pack_weights lays them out (K-major swizzled panels,
// 16-byte aligned); bias (n_convs, C). geom: [n_res, n_dil, halo, k[4],
// dil[4*4], pad1[4*4], pad2[4*4]] in host memory, read before the launch.
// dtype: 0 = float32 (3xTF32), 1 = bfloat16; both on wgmma. tile: output
// rows per block; the caller sizes it to the shared memory (fused_tail.py:
// tile_rows). Returns cudaGetLastError() after the launch.
extern "C" int l2s_resblock_trio(const void* x, const void* w, const void* bias,
                                 void* out, int B, int C, int M, int dtype, int tile,
                                 const int* geom, void* stream) {
  TrioGeom g;
  g.n_res = geom[0];
  g.n_dil = geom[1];
  g.halo = geom[2];
  const int* q = geom + 3;
  for (int i = 0; i < kMaxRes; ++i) g.k[i] = *q++;
  for (int i = 0; i < kMaxRes * kMaxDil; ++i) g.dil[i] = *q++;
  for (int i = 0; i < kMaxRes * kMaxDil; ++i) g.pad1[i] = *q++;
  for (int i = 0; i < kMaxRes * kMaxDil; ++i) g.pad2[i] = *q++;
  if (g.n_res < 1 || g.n_res > kMaxRes || g.n_dil < 1 || g.n_dil > kMaxDil || tile < 1 ||
      M < 1 || B < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_c(dtype, x, w, bias, out, B, C, M, tile, g,
                         static_cast<cudaStream_t>(stream));
}
